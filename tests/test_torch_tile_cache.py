"""The tile engine's cross-file batch cache on the CPU
(``cerberus_tpu_torch/infer/tile.py`` ``cached_canvases``) against the JAX
engine's (``cerberus_tpu/infer/tile.py`` ``process_file_list`` /
``_run_cached``).

The model is resnet18 at 144->48 (seeded by the port's init, crossed to
the JAX side as a JAX-layout tree), its INST heads scaled 0.3x with bias
[0, 2.5, -1] so the image drives several nuclei per image. (At 0.1x, with
bias [0, 1, -1], the probabilities lie so flat around the thresholds that
the f32 forwards' ~2e-4 differences moved up to 1 % of one image's nuclei
pixels through the watershed; on the same canvas the families of both
packages are byte-equal.) Batch composition
and the ``.mat`` payloads are first compared under one deterministic numpy
step on both sides (``tests/test_torch_wsi.py``'s ``stub_outputs``), then
under the real f32 forwards with ``tests/test_torch_tile.py``'s bounds.
"""
import functools
import os

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

import conftest  # noqa: F401  (CPU pinning)

import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_DECODER_KWARGS, DEFAULT_TARGET_CODE
from cerberus_tpu.infer.tile import InferManager as JaxTileManager
from cerberus_tpu.models.convert import save_checkpoint
from cerberus_tpu_torch import run_infer_tile
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.infer import tile as port_tile
from cerberus_tpu_torch.models.convert import jax_params_from_state_dict
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from test_torch_tile import _assert_agrees, _image
from test_torch_wsi import stub_outputs

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
IN_SHAPE, OUT_SHAPE = 144, 48
TASKS = ("gland", "lumen", "nuclei")
# windows at 144->48: 25, 49, 100, 36, 81 (291 > 256: the first cache
# ends after the fifth image), then 9 and 4
CACHE_SIZES = ((200, 240), (330, 300), (480, 470), (250, 250), (400, 390),
               (100, 120), (90, 60))


@functools.lru_cache(maxsize=None)
def model_params(seed=5):
    """The resnet18 model as a JAX-layout tree of numpy arrays (one tree per
    seed and process, shared by the test files that import it; not to be
    modified)."""
    model = init_weights(NetDesc(ModelConfig.from_kwargs(MODEL_KWARGS)),
                         torch.Generator().manual_seed(seed))
    params = jax_params_from_state_dict(model.state_dict())
    for task in ("Gland", "Lumen", "Nuclei"):
        leaf = params["output_head.%s.INST.x.1.conv" % task]
        leaf["kernel"] = leaf["kernel"] * np.float32(0.3)
        leaf["bias"] = np.array([0.0, 2.5, -1.0], np.float32)
    return params


def write_model_dir(path, params, native=False):
    """A model directory; ``native``: its ``weights.tar`` written by the JAX
    package's ``save_checkpoint`` (msgpack), else a torch checkpoint."""
    os.makedirs(path, exist_ok=True)
    from cerberus_tpu_torch.models.convert import state_dict_from_jax_params

    if native:
        save_checkpoint(os.path.join(path, "weights.tar"), params)
    else:
        torch.save({"desc": state_dict_from_jax_params(params)},
                   os.path.join(path, "weights.tar"))
    with open(os.path.join(path, "settings.yml"), "w") as f:
        yaml.safe_dump({
            "dataset_kwargs": {"req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": MODEL_KWARGS}, f)
    return path


def write_images(input_dir, sizes, seed=0):
    os.makedirs(input_dir, exist_ok=True)
    images = {}
    for i, hw in enumerate(sizes):
        name = "img%02d" % i
        images[name] = _image(seed + i, hw)
        cv2.imwrite(os.path.join(input_dir, name + ".png"),
                    cv2.cvtColor(images[name], cv2.COLOR_RGB2BGR))
    return images


def run_args(input_dir, output_dir, backend, batch_size=4, **extra):
    return {"input_dir": str(input_dir), "output_dir": str(output_dir),
            "batch_size": batch_size, "patch_input_shape": IN_SHAPE,
            "patch_output_shape": OUT_SHAPE, "postproc_backend": backend,
            "nr_post_proc_workers": 0, **extra}


def port_manager(params, **kwargs):
    kwargs = {"batch_size": 4, "patch_input_shape": IN_SHAPE,
              "patch_output_shape": OUT_SHAPE, **kwargs}
    return port_tile.InferManager(
        model_args=MODEL_KWARGS, decoder_dict=dict(DEFAULT_TARGET_CODE),
        params=params, device="cpu", **kwargs)


def load_mats(output_dir, names):
    out = {}
    for name in names:
        for task in TASKS + ("pclass",):
            path = os.path.join(output_dir, "%s_mat" % task, name + ".mat")
            out[(name, task)] = {k: v for k, v in sio.loadmat(path).items()
                                 if not k.startswith("__")}
    return out


def assert_mats_equal(got, ref):
    assert set(got) == set(ref)
    for key, mat in ref.items():
        assert set(got[key]) == set(mat), key
        for field, value in mat.items():
            np.testing.assert_array_equal(got[key][field], value,
                                          err_msg=str((key, field)))


@pytest.fixture(scope="module")
def params():
    return model_params()


def test_batch_composition_and_mats_equal_jax_cache(params, tmp_path,
                                                    monkeypatch):
    """A stub step records every batch on both sides: the port's batches
    are the JAX ``_run_cached`` batches, window for window, across a cache
    boundary (only each cache's last batch is zero-padded), and the
    ``cpu`` backend's ``.mat`` files are equal."""
    input_dir = tmp_path / "input"
    images = write_images(input_dir, CACHE_SIZES)
    seen = {"jax": [], "port": []}

    def jax_stub(self, batch, out_sz):
        seen["jax"].append(np.array(batch))
        return stub_outputs(batch, out_sz)

    def port_stub(self, batch, out_sz):
        seen["port"].append(batch.numpy().copy())
        return torch.from_numpy(stub_outputs(batch.numpy(), out_sz))

    monkeypatch.setattr(JaxTileManager, "run_step", jax_stub)
    monkeypatch.setattr(port_tile.InferManager, "run_step", port_stub)
    JaxTileManager(model_args=MODEL_KWARGS, params={},
                   decoder_dict=dict(DEFAULT_TARGET_CODE)).process_file_list(
        run_args(input_dir, tmp_path / "jax", "cpu"))
    port_manager(params).process_file_list(
        run_args(input_dir, tmp_path / "port", "cpu"))

    counts = [len(port_tile.prepare_patching(img, IN_SHAPE, OUT_SHAPE)[1])
              for img in images.values()]
    assert sum(counts[:5]) > port_tile.CACHE_WINDOWS >= sum(counts[:4])
    n_batches = -(-sum(counts[:5]) // 4) + -(-sum(counts[5:]) // 4)
    assert len(seen["port"]) == len(seen["jax"]) == n_batches
    for got, ref in zip(seen["port"], seen["jax"]):
        assert got.shape == ref.shape == (4, IN_SHAPE, IN_SHAPE, 3)
        np.testing.assert_array_equal(got, ref)
    # zero rows only at the end of each cache (291 = 72 * 4 + 3, 13 = 3 * 4
    # + 1)
    padded = [i for i, b in enumerate(seen["port"])
              if not b.reshape(4, -1).any(axis=1).all()]
    assert padded == [72, n_batches - 1]
    assert_mats_equal(load_mats(tmp_path / "port", images),
                      load_mats(tmp_path / "jax", images))


@pytest.fixture(scope="module")
def forward_runs(params, tmp_path_factory):
    """The real forwards on a three-image directory (27 windows: batches of
    4 span files): the JAX engine at f32
    with ``tpu`` and ``cpu`` post-processing, the port's cache with ``gpu``
    and ``cpu``. The port's second run meets the first run's batches again
    and reuses their outputs (the CPU forward is deterministic)."""
    root = tmp_path_factory.mktemp("tile_cache")
    input_dir = root / "input"
    # one image size: the JAX tpu families compile once per canvas shape
    images = write_images(input_dir, ((100, 120),) * 3, 3)
    jax_manager = JaxTileManager(model_args=MODEL_KWARGS, params=params,
                                 decoder_dict=dict(DEFAULT_TARGET_CODE),
                                 compute_dtype=jnp.float32)
    manager = port_manager(params)
    step, outputs = manager.run_step, {}

    def run_step(batch, out_sz):
        key = (batch.numpy().tobytes(), out_sz)
        if key not in outputs:
            outputs[key] = step(batch, out_sz)
        return outputs[key]

    manager.run_step = run_step
    out = {}
    for jax_backend, backend in (("tpu", "gpu"), ("cpu", "cpu")):
        jax_manager.process_file_list(
            run_args(input_dir, root / ("jax_" + jax_backend), jax_backend))
        manager.process_file_list(
            run_args(input_dir, root / ("port_" + backend), backend))
        out[backend] = (load_mats(root / ("port_" + backend), images),
                        load_mats(root / ("jax_" + jax_backend), images))
    assert len(outputs) == -(-27 // 4)
    return images, out


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_cache_mats_agree_with_jax_engine(forward_runs, backend):
    images, runs = forward_runs
    got, ref = runs[backend]
    for name in images:
        def as_tuple(mats):
            inst = {t.capitalize(): mats[(name, t)]["inst_map"]
                    for t in TASKS}
            types = {t.capitalize(): mats[(name, t)].get("type_map")
                     for t in TASKS}
            return inst, types, mats[(name, "pclass")]["pclass"]

        inst, types, pclass = as_tuple(got)
        ref_inst, ref_types, ref_pclass = as_tuple(ref)
        _assert_agrees((None, (None, None, ref_inst, None, ref_types,
                               ref_pclass), (inst, types, pclass)))
    assert max(int(m["inst_map"].max()) for (n, t), m in got.items()
               if t == "nuclei") > 3


def test_cache_at_batch_one_is_byte_equal_to_per_image(params):
    """At batch 1 every window runs alone on both paths: the canvases, and
    so the label maps, are byte-equal."""
    manager = port_manager(params, batch_size=1)
    images = [_image(20 + i, hw) for i, hw in
              enumerate(((60, 50), (50, 70)))]
    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)
    for (i, img, canvas) in manager.cached_canvases(enumerate(images)):
        assert img is images[i]
        ref_canvas = manager.infer_canvas(img)
        assert torch.equal(canvas, ref_canvas)
        inst, types, pclass = port_tile.post_process_canvas(canvas, *args)
        ref_inst, ref_types, ref_pclass = port_tile.post_process_canvas(
            ref_canvas, *args)
        for task, ref in ref_inst.items():
            np.testing.assert_array_equal(inst[task], ref)
            if ref_types[task] is not None:
                np.testing.assert_array_equal(types[task], ref_types[task])
        np.testing.assert_array_equal(pclass, ref_pclass)


@pytest.mark.parametrize("native", [False, True])
def test_cli_cache_skips_done_files(params, tmp_path, monkeypatch, native):
    """Skip-if-done: a second run finds nothing to do; with one image's
    outputs removed, only that image runs. The model directory's
    ``weights.tar`` is a torch checkpoint or a JAX-written native one."""
    model_dir = write_model_dir(str(tmp_path / "model"), params, native)
    input_dir = tmp_path / "input"
    images = write_images(input_dir, ((60, 50), (50, 70), (40, 40)), 7)
    seen = []

    def stub(self, batch, out_sz):
        seen.append(batch.shape[0])
        return torch.from_numpy(stub_outputs(batch.numpy(), out_sz))

    monkeypatch.setattr(port_tile.InferManager, "run_step", stub)
    argv = ["--model=%s" % model_dir, "--input_dir=%s" % input_dir,
            "--output_dir=%s" % (tmp_path / "out"), "--batch_size=4",
            "--patch_input_shape=%d" % IN_SHAPE,
            "--patch_output_shape=%d" % OUT_SHAPE]
    run_infer_tile.main(argv, device="cpu")
    first = load_mats(tmp_path / "out", images)
    n_first = len(seen)
    with pytest.raises(AssertionError):
        run_infer_tile.main(argv, device="cpu")
    assert len(seen) == n_first
    os.remove(tmp_path / "out" / "nuclei_mat" / "img01.mat")
    run_infer_tile.main(argv, device="cpu")
    n_windows = len(port_tile.prepare_patching(images["img01"], IN_SHAPE,
                                                OUT_SHAPE)[1])
    assert len(seen) == n_first + -(-n_windows // 4)
    assert_mats_equal(load_mats(tmp_path / "out", images), first)


def test_process_images_equals_process_image(params, monkeypatch):
    """The cache on in-memory images, post-processed, gives each image the
    label maps ``process_image`` gives it, under a per-window step."""
    monkeypatch.setattr(
        port_tile.InferManager, "run_step",
        lambda self, batch, out_sz: torch.from_numpy(
            stub_outputs(batch.numpy(), out_sz)))
    manager = port_manager(params)
    images = [_image(30 + i, hw) for i, hw in
              enumerate(((100, 120), (60, 50), (130, 90)))]
    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)
    cached = [port_tile.post_process_canvas(canvas, *args) for _, _, canvas
              in manager.cached_canvases(enumerate(images))]
    assert len(cached) == len(images)
    for got, img in zip(cached, images):
        ref = manager.process_image(img)
        for part, ref_part in zip(got, ref):
            if isinstance(ref_part, dict):
                assert set(part) == set(ref_part)
                for task, value in ref_part.items():
                    np.testing.assert_array_equal(part[task], value)
            else:
                np.testing.assert_array_equal(part, ref_part)
