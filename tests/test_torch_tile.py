"""The slice as a whole on the CPU: the port's tile path against the JAX
tile path on the same synthetic checkpoint and image (f32).

The model is ``tests/test_tile_pipeline.py::model_dir``'s (resnet34, the six
default heads, ``init_net_params(PRNGKey(42))``, 144->48 windows, whose
bottom features are 9x9 like the production 448->144), with the INST heads
biased so that instances appear (the synthetic-model recipe of the verify
skill). It crosses to torch as a reference-style ``weights.tar``.
"""
import os

import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

import jax
import jax.numpy as jnp

from cerberus_tpu.config import (
    DEFAULT_DECODER_KWARGS,
    DEFAULT_TARGET_CODE,
    DEFAULT_TARGET_LIST,
)
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.data.patching import prepare_patching as jax_prepare
from cerberus_tpu.infer.steps import fused_infer_outputs
from cerberus_tpu.infer.tile import post_process_tile
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.ops.stitch import stitch_canvas as jax_stitch
from cerberus_tpu_torch.infer import tile as port_tile
from cerberus_tpu_torch.infer.tile import (
    InferManager,
    _host_postproc_and_info,
    instance_info,
    post_process_canvas,
    post_process_host,
)
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.ops.inst_stats import inst_stats_plain, split_tables
from cerberus_tpu_torch.predictor import CerberusPredictor
from cerberus_tpu_torch.run_infer_tile import main
from test_torch_wsi import stub_outputs

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet34",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
IN_SHAPE, OUT_SHAPE = 144, 48


def _synthetic_params():
    cfg = JaxModelConfig.from_kwargs(MODEL_KWARGS)
    params = jax.tree.map(np.asarray,
                          init_net_params(jax.random.PRNGKey(42), cfg))
    for task in ("Gland", "Lumen", "Nuclei"):
        leaf = dict(params["output_head.%s.INST.x.1.conv" % task])
        leaf["kernel"] = leaf["kernel"] * np.float32(0.003)
        leaf["bias"] = np.array([-2.0, 2.0, -1.5], np.float32)
        params["output_head.%s.INST.x.1.conv" % task] = leaf
    return params


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_model")
    params = _synthetic_params()
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(d / "weights.tar"))
    with open(d / "settings.yml", "w") as f:
        yaml.safe_dump({
            "dataset_kwargs": {"req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": MODEL_KWARGS}, f)
    return d, params


def _image(seed=0, hw=(150, 170)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for _ in range(12):
        cy, cx, r = rng.integers(0, hw[0]), rng.integers(0, hw[1]), \
            rng.integers(6, 30)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 255, 3)
    return img


def _jax_tile(params, img, in_shape=IN_SHAPE, out_shape=OUT_SHAPE):
    """The JAX tile path at f32: patch grid, forward, host stitch, crop,
    ``post_process_tile(backend="tpu")``. Returns (canvas, results)."""
    cfg = JaxModelConfig.from_kwargs(MODEL_KWARGS)
    padded, info, src_pos = jax_prepare(img, in_shape, out_shape)
    wins = np.stack([padded[y:y + in_shape, x:x + in_shape]
                     for y, x in info[:, 0, 0]])
    with jax.default_matmul_precision("highest"):
        outs = np.asarray(fused_infer_outputs(
            params, jnp.asarray(wins), cfg, out_shape,
            compute_dtype=jnp.float32, out_dtype=jnp.float32))
    canvas = jax_stitch(list(outs), info[:, 1, 0], padded.shape[:2])
    canvas = canvas[src_pos[0]:src_pos[0] + img.shape[0],
                    src_pos[1]:src_pos[1] + img.shape[1]]
    image_info = {"name": "x", "src_image": img}
    results = post_process_tile(canvas, image_info, dict(DEFAULT_TARGET_CODE),
                                list(DEFAULT_TARGET_LIST),
                                cfg.active_decoder_kwargs, backend="tpu")
    return canvas, results


def _manager(model_dir, in_shape=IN_SHAPE, out_shape=OUT_SHAPE):
    d, _ = model_dir
    return InferManager(checkpoint_path=str(d / "weights.tar"),
                        decoder_dict=dict(DEFAULT_TARGET_CODE),
                        model_args=MODEL_KWARGS, device="cpu", batch_size=4,
                        patch_input_shape=in_shape,
                        patch_output_shape=out_shape)


@pytest.fixture(scope="module")
def both_paths(model_dir):
    _, params = model_dir
    img = _image()
    canvas, jax_results = _jax_tile(params, img)
    port = _manager(model_dir).process_image(img)
    return canvas, jax_results, port


@pytest.fixture(scope="module")
def both_paths_cpu(model_dir, both_paths):
    """The ``cpu`` backend on both sides: the JAX ``post_process_tile``
    with ``backend="cpu"`` on its canvas, the port's ``post_process_host``
    on the canvas its manager stitched."""
    canvas = both_paths[0]
    img = _image()
    cfg = JaxModelConfig.from_kwargs(MODEL_KWARGS)
    jax_results = post_process_tile(
        canvas, {"name": "x", "src_image": img}, dict(DEFAULT_TARGET_CODE),
        list(DEFAULT_TARGET_LIST), cfg.active_decoder_kwargs, backend="cpu")
    port = post_process_host(
        _manager(model_dir).infer_canvas(img).numpy(),
        dict(DEFAULT_TARGET_CODE), list(DEFAULT_TARGET_LIST),
        DEFAULT_DECODER_KWARGS)
    return canvas, jax_results, port


@pytest.fixture(scope="module")
def both_paths_valid(model_dir):
    """224->72, where valid-region decoding engages on both sides."""
    _, params = model_dir
    img = _image()
    canvas, jax_results = _jax_tile(params, img, 224, 72)
    port = _manager(model_dir, 224, 72).process_image(img)
    return canvas, jax_results, port


def test_process_image_agrees_with_jax_tile_path(both_paths):
    _assert_agrees(both_paths)


def test_process_image_valid_region_agrees_with_jax_tile_path(
        both_paths_valid):
    _assert_agrees(both_paths_valid)


def test_cpu_backend_agrees_with_jax_cpu_backend(both_paths_cpu):
    _assert_agrees(both_paths_cpu)


def test_jax_canvas_through_port_cpu_backend_is_byte_equal(both_paths_cpu):
    """The port's ``cpu`` backend on the JAX canvas gives the JAX ``cpu``
    backend's maps and instance dictionaries, byte for byte."""
    canvas, (_, _, ref_inst, ref_info, ref_type, ref_pclass), _ = \
        both_paths_cpu
    inst, types, pclass = post_process_host(
        canvas, dict(DEFAULT_TARGET_CODE), list(DEFAULT_TARGET_LIST),
        DEFAULT_DECODER_KWARGS)
    info = instance_info(inst, types, list(DEFAULT_TARGET_LIST))
    assert set(inst) == set(ref_inst) and ref_inst["Nuclei"].max() > 0
    for task, ref in ref_inst.items():
        assert inst[task].dtype == ref.dtype
        np.testing.assert_array_equal(inst[task], ref, err_msg=task)
        if ref_type[task] is None:
            assert types[task] is None
        else:
            assert types[task].dtype == ref_type[task].dtype
            np.testing.assert_array_equal(types[task], ref_type[task])
        assert list(info[task]) == list(ref_info[task])
        for k, entry in ref_info[task].items():
            assert set(info[task][k]) == set(entry)
            for field, value in entry.items():
                np.testing.assert_array_equal(info[task][k][field], value)
    assert pclass.dtype == ref_pclass.dtype
    np.testing.assert_array_equal(pclass, ref_pclass)


def _assert_agrees(paths):
    _, (_, _, ref_inst, _, ref_type, ref_pclass), (inst, types, pclass) = \
        paths
    assert set(inst) == set(ref_inst) == {"Gland", "Lumen", "Nuclei"}
    assert ref_inst["Gland"].max() > 0 and ref_inst["Nuclei"].max() > 0
    for task, ref in ref_inst.items():
        got = inst[task]
        assert got.shape == ref.shape and got.dtype == ref.dtype
        # only threshold flips of probabilities agreeing to 2e-4 may differ
        assert (got == ref).mean() >= 0.999, task
        assert len(np.unique(got)) == len(np.unique(ref)), task
        if ref_type[task] is None:
            assert types[task] is None
        else:
            np.testing.assert_array_equal(types[task], ref_type[task])
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_jax_canvas_through_port_postproc_is_byte_equal(both_paths):
    canvas, (_, _, ref_inst, _, ref_type, ref_pclass), _ = both_paths
    inst, types, pclass = post_process_canvas(
        torch.from_numpy(canvas), dict(DEFAULT_TARGET_CODE),
        list(DEFAULT_TARGET_LIST), DEFAULT_DECODER_KWARGS)
    for task, ref in ref_inst.items():
        np.testing.assert_array_equal(inst[task], ref, err_msg=task)
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_cli_main_writes_reference_outputs(model_dir, tmp_path):
    import cv2

    d, _ = model_dir
    input_dir, output_dir = tmp_path / "input", tmp_path / "output"
    os.makedirs(input_dir)
    for name, seed in (("t1", 1), ("t2", 2)):
        cv2.imwrite(str(input_dir / ("%s.png" % name)),
                    cv2.cvtColor(_image(seed, (100, 120)), cv2.COLOR_RGB2BGR))
    argv = ["--model=%s" % d, "--input_dir=%s" % input_dir,
            "--output_dir=%s" % output_dir, "--batch_size=4",
            "--patch_input_shape=%d" % IN_SHAPE,
            "--patch_output_shape=%d" % OUT_SHAPE]
    main(argv, device="cpu")
    for name in ("t1", "t2"):
        assert (output_dir / "overlay" / ("%s.jpg" % name)).exists()
        for task in ("gland", "lumen", "nuclei"):
            mat = sio.loadmat(str(output_dir / ("%s_mat" % task)
                                  / ("%s.mat" % name)))
            assert mat["inst_map"].shape == (100, 120)
            assert {"inst_map", "type", "id"} <= set(mat)
            assert ("type_map" in mat) == (task != "lumen")
        pclass = sio.loadmat(str(output_dir / "pclass_mat"
                                 / ("%s.mat" % name)))
        assert pclass["pclass"].shape == (100, 120)
        assert 0 <= pclass["pclass"].min() <= pclass["pclass"].max() <= 8
    with pytest.raises(AssertionError):  # skip-if-done: nothing left to do
        main(argv, device="cpu")
    # the cpu backend in two spawned workers (numpy only) writes what the
    # host families give in this process on the manager's canvas
    cpu_dir = tmp_path / "output_cpu"
    main([a.replace(str(output_dir), str(cpu_dir)) for a in argv]
         + ["--postproc_backend=cpu", "--nr_post_proc_workers=2"],
         device="cpu")
    manager = _manager(model_dir)
    for name, seed in (("t1", 1), ("t2", 2)):
        inst, _, types, pclass = _host_postproc_and_info(
            manager.infer_canvas(_image(seed, (100, 120))).numpy(),
            dict(DEFAULT_TARGET_CODE), list(DEFAULT_TARGET_LIST),
            DEFAULT_DECODER_KWARGS)
        for task in ("gland", "lumen", "nuclei"):
            mat = sio.loadmat(str(cpu_dir / ("%s_mat" % task)
                                  / ("%s.mat" % name)))
            np.testing.assert_array_equal(mat["inst_map"],
                                          inst[task.capitalize()])
            if task != "lumen":
                np.testing.assert_array_equal(mat["type_map"],
                                              types[task.capitalize()])
        np.testing.assert_array_equal(
            sio.loadmat(str(cpu_dir / "pclass_mat" / ("%s.mat" % name)))[
                "pclass"], pclass)


def test_cli_dense_selects_1168_to_864(model_dir, tmp_path, monkeypatch):
    """``--dense`` overrides the shape flags with 1168->864; the step is
    stubbed (zeros), so no 1168^2 forward runs on the CPU."""
    import cv2

    d, _ = model_dir
    input_dir, output_dir = tmp_path / "input", tmp_path / "output"
    os.makedirs(input_dir)
    cv2.imwrite(str(input_dir / "t.png"), _image(1, (100, 120)))
    seen = []

    def stub(self, batch, output_shape):
        seen.append((tuple(batch.shape), output_shape))
        return torch.zeros((batch.shape[0], output_shape, output_shape, 9))

    monkeypatch.setattr(InferManager, "run_step", stub)
    main(["--model=%s" % d, "--input_dir=%s" % input_dir,
          "--output_dir=%s" % output_dir, "--batch_size=2",
          "--patch_input_shape=%d" % IN_SHAPE,
          "--patch_output_shape=%d" % OUT_SHAPE, "--dense"], device="cpu")
    assert seen == [((2, 1168, 1168, 3), 864)]
    mat = sio.loadmat(str(output_dir / "nuclei_mat" / "t.mat"))
    assert mat["inst_map"].shape == (100, 120)


# ---------------------------------------------------------------------------
# the records from the card's per-instance tables (``ops/inst_stats``)
# against ``get_inst_info_dict`` on the 2x-upscaled maps
# ---------------------------------------------------------------------------


def _discs(hw, n, seed, rmax):
    """Seeded discs, ids compacted to 1..k, as float64."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(hw, np.int64)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for k in range(n):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        r = rng.integers(1, rmax)
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = k + 1
    ids = np.unique(lab)
    ids = ids[ids > 0]
    lut = np.zeros(n + 1, np.float64)
    lut[ids] = np.arange(1, len(ids) + 1)
    return lut[lab]


def _assert_records_equal(got, ref):
    """Keys (their type, dtype and order) and every field, exactly."""
    assert list(got) == list(ref)
    for task in ref:
        assert list(got[task]) == list(ref[task]), task
        for k_got, k_ref in zip(got[task], ref[task]):
            assert type(k_got) is type(k_ref)
        for key, entry in ref[task].items():
            assert list(got[task][key]) == list(entry)
            for field, value in entry.items():
                mine = got[task][key][field]
                assert type(mine) is type(value), (task, key, field)
                if isinstance(value, np.ndarray):
                    assert mine.dtype == value.dtype, (task, key, field)
                np.testing.assert_array_equal(mine, value,
                                              err_msg="%s %s" % (task, field))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_fed_records_equal_upscaled_map_records(seed):
    """Seeded gland, lumen (gated by the glands, ids with gaps) and nuclei
    maps with their type maps: ``instance_info`` from the tables equals
    ``get_inst_info_dict`` on the ``_upscale2x`` maps, task by task, to the
    last bit of every centroid and type share."""
    hw = (150 + 7 * seed, 170 - 5 * seed)
    rng = np.random.default_rng(100 + seed)
    gland = _discs(hw, 6, seed, 45)
    inst_maps = {"Gland": gland,
                 "Lumen": _discs(hw, 30, 10 + seed, 9) * (gland > 0),
                 "Nuclei": _discs(hw, 120, 20 + seed, 7)}
    type_maps = {"Gland": rng.integers(0, 3, hw).astype(np.float32),
                 "Lumen": None,
                 "Nuclei": rng.integers(0, 7, hw).astype(np.float32)}
    labels = torch.from_numpy(np.stack(list(inst_maps.values())).astype(
        np.int32))
    types = torch.from_numpy(np.stack([type_maps["Gland"],
                                       type_maps["Nuclei"]]).astype(np.int32))
    table = inst_stats_plain(labels, types,
                             [int(m.max()) for m in inst_maps.values()],
                             [0, 0, 1], [3, 7])
    stats = dict(zip(inst_maps, split_tables(
        table.layout, table.ints.numpy(), table.sums.numpy())))
    tasks = list(DEFAULT_TARGET_LIST)
    got = instance_info(inst_maps, type_maps, tasks, stats)
    ref = instance_info(inst_maps, type_maps, tasks)
    assert all(len(ref[t]) > 3 for t in ref)
    _assert_records_equal(got, ref)


def _stub_step(self, batch, out_sz):
    return torch.from_numpy(stub_outputs(batch.numpy(), out_sz))


def _stub_manager():
    return InferManager(model_args=MODEL_KWARGS,
                        decoder_dict=dict(DEFAULT_TARGET_CODE), device="cpu",
                        batch_size=4, patch_input_shape=IN_SHAPE,
                        patch_output_shape=OUT_SHAPE)


def _job(tmp_path, out, **extra):
    _stub_manager().process_file_list(dict(
        input_dir=str(tmp_path / "input"), output_dir=str(tmp_path / out),
        batch_size=4, patch_input_shape=IN_SHAPE,
        patch_output_shape=OUT_SHAPE, nr_inference_workers=0,
        nr_post_proc_workers=0, **extra))


def _write_inputs(tmp_path):
    import cv2

    os.makedirs(tmp_path / "input")
    sizes = {"a": (100, 120), "b": (130, 90), "c": (70, 70)}
    for k, (name, hw) in enumerate(sizes.items()):
        cv2.imwrite(str(tmp_path / "input" / ("%s.png" % name)),
                    cv2.cvtColor(_image(40 + k, hw), cv2.COLOR_RGB2BGR))
    return sizes


def _assert_outputs_equal(got_dir, ref_dir, names):
    for name in names:
        for task in ("gland", "lumen", "nuclei", "pclass"):
            got = sio.loadmat(str(got_dir / ("%s_mat" % task)
                                  / ("%s.mat" % name)))
            ref = sio.loadmat(str(ref_dir / ("%s_mat" % task)
                                  / ("%s.mat" % name)))
            keys = [k for k in ref if not k.startswith("__")]
            assert sorted(k for k in got if not k.startswith("__")) == \
                sorted(keys)
            for key in keys:
                assert got[key].dtype == ref[key].dtype, (name, task, key)
                np.testing.assert_array_equal(got[key], ref[key])
        with open(got_dir / "overlay" / ("%s.jpg" % name), "rb") as a, \
                open(ref_dir / "overlay" / ("%s.jpg" % name), "rb") as b:
            assert a.read() == b.read(), name


def test_process_file_list_tables_write_the_upscaled_map_records(
        tmp_path, monkeypatch):
    """The ``gpu`` backend on the CPU (the plain ``inst_stats``): the job
    calls the module-global ``post_process_canvas`` once a file with the
    canvas first (the seam the tile benchmark observes), and writes the
    ``.mat`` files and overlays that the records of ``get_inst_info_dict``
    on the 2x-upscaled maps give (the same job with the tables withheld)."""
    monkeypatch.setattr(InferManager, "run_step", _stub_step)
    sizes = _write_inputs(tmp_path)
    made = port_tile.post_process_canvas
    calls = []

    def observed(canvas, *args, **kwargs):
        calls.append((tuple(canvas.shape), sorted(kwargs)))
        return made(canvas, *args, **kwargs)

    monkeypatch.setattr(port_tile, "post_process_canvas", observed)
    _job(tmp_path, "tables")
    assert calls == [((*sizes[n], 9), ["stats"]) for n in sorted(sizes)]

    def withheld(canvas, *args, stats=None, **kwargs):
        return made(canvas, *args, **kwargs)

    monkeypatch.setattr(port_tile, "post_process_canvas", withheld)
    _job(tmp_path, "upscaled")
    mat = sio.loadmat(str(tmp_path / "tables" / "nuclei_mat" / "a.mat"))
    assert mat["id"].size > 3 and mat["id"].dtype == np.float64
    _assert_outputs_equal(tmp_path / "tables", tmp_path / "upscaled",
                          sorted(sizes))


def test_cpu_backend_and_predictor_records_are_unchanged(tmp_path,
                                                         monkeypatch):
    """``--postproc_backend=cpu`` has no table: its job writes what
    ``_host_postproc_and_info`` gives; the predictor's records, on either
    backend, are ``get_inst_info_dict``'s on the 2x-upscaled maps."""
    monkeypatch.setattr(InferManager, "run_step", _stub_step)
    sizes = _write_inputs(tmp_path)
    _job(tmp_path, "cpu", postproc_backend="cpu")
    manager = _stub_manager()
    for k, (name, hw) in enumerate(sizes.items()):
        inst, info, types, _ = _host_postproc_and_info(
            manager.infer_canvas(_image(40 + k, hw)).numpy(),
            dict(DEFAULT_TARGET_CODE), list(DEFAULT_TARGET_LIST),
            DEFAULT_DECODER_KWARGS)
        for task in ("Gland", "Lumen", "Nuclei"):
            mat = sio.loadmat(str(tmp_path / "cpu" / ("%s_mat" % task.lower())
                                  / ("%s.mat" % name)))
            np.testing.assert_array_equal(mat["inst_map"], inst[task])
            np.testing.assert_array_equal(
                np.ravel(mat["id"]), np.array(list(info[task]), np.float64))
            np.testing.assert_array_equal(
                np.ravel(mat["type"]),
                [d.get("type", -1) for d in info[task].values()])
    img = _image(40, sizes["a"])
    for backend in ("gpu", "cpu"):
        predictor = CerberusPredictor(
            checkpoint_path=None, model_args=MODEL_KWARGS,
            decoder_dict=dict(DEFAULT_TARGET_CODE), batch_size=4,
            patch_input_shape=IN_SHAPE, patch_output_shape=OUT_SHAPE,
            postproc_backend=backend, device="cpu")
        got = predictor.predict_tile(img)
        inst = {t: got[t]["inst_map"] for t in ("Gland", "Lumen", "Nuclei")}
        types = {t: got[t]["type_map"] for t in inst}
        ref = instance_info(inst, types, list(DEFAULT_TARGET_LIST))
        assert len(ref["Nuclei"]) > 3
        _assert_records_equal({t: got[t]["inst_info"] for t in inst}, ref)
