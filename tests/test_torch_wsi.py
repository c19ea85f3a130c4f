"""The WSI slice as a whole on the CPU: the port's whole-slide engine
(``cerberus_tpu_torch.infer.wsi``) against the JAX package's WSI engine:
the port's resident loop against the JAX resident ``postproc_backend="tpu"``
mode and its legacy host-canvas mode; the port's legacy loop
(``CERBERUS_RESIDENT=0`` with ``gpu``, and ``cpu``) against the JAX legacy
loop with the matching backend; an ``.svs`` slide against its
``convert_slide`` pyramid.

Fixture geometry of ``tests/test_resident_wsi.py``: a 400x504 npy-pyramid
slide of 8x8 random colour blocks, 144->48 windows, post-processing tiles of
192 with an ambiguous margin of 16, batch 8; the resnet18 model with biased
INST heads, crossed to torch by ``state_dict_from_jax_params``. ``.dat``
payloads are compared by content (instance keys are uuid4 per run).

Most cases replace the forward by one deterministic numpy ``run_step``
(each window's centre crop through a fixed per-pixel channel mix and a
softmax), so both engines write the same f16 canvas and every difference
would be the engines'. The JAX runs happen once per module.
"""
import os
import pathlib
import pickle

import joblib
import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

import conftest  # noqa: F401  (CPU pinning)

import jax
import jax.numpy as jnp

from cerberus_tpu.config import (
    DEFAULT_DECODER_KWARGS,
    DEFAULT_TARGET_CODE,
    DEFAULT_TARGET_LIST,
    ModelConfig,
)
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu_torch import run_infer_wsi
from cerberus_tpu_torch.infer import resident_wsi
from cerberus_tpu_torch.infer import wsi as port_wsi
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.ops import gpu_postproc
from cerberus_tpu_torch.wsi import merge as port_merge

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
IN_SHAPE, OUT_SHAPE = 144, 48
TASKS = ("Nuclei", "Gland", "Lumen")


def _biased_params(seed=5, params=None):
    """``tests/test_resident_wsi.py``'s model: INST heads scaled 0.01x,
    bias [-1.5, 1.5, -1.0], on ``params`` (default: the JAX init)."""
    if params is None:
        cfg = ModelConfig.from_kwargs(MODEL_KWARGS)
        params = init_net_params(jax.random.PRNGKey(seed), cfg)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in params.items()}
    for head in ("Gland", "Nuclei", "Lumen"):
        leaf = params[f"output_head.{head}.INST.x.1.conv"]
        leaf["kernel"] = leaf["kernel"] * 0.01
        b = np.zeros_like(leaf["bias"])
        b[0], b[1], b[2] = -1.5, 1.5, -1.0
        leaf["bias"] = b
    return params


def _sig(x):
    if isinstance(x, dict):
        return tuple(sorted((repr(k), _sig(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return repr(x)


def _payload(dat):
    per = {}
    for k, v in dat.items():
        if k in TASKS:
            per[k] = tuple(sorted(_sig(iv) for iv in v.values()))
        else:
            per[k] = _sig(v)
    return per


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def stub_outputs(batch, out_sz):
    """(N, in, in, 3) uint8 windows -> (N, out, out, 9) f32 canvas rows in
    the default channel order (Lumen, Gland, Nuclei INST pairs; Nuclei and
    Gland TYPE ids; the Patch-Class id): red drives glands, green lumens,
    blue nuclei and their types."""
    batch = np.asarray(batch)
    m = (batch.shape[1] - out_sz) // 2
    crop = batch[:, m:m + out_sz, m:m + out_sz].astype(np.float32) / 255.0
    r, g, b = crop[..., 0], crop[..., 1], crop[..., 2]

    def inst(x, centre):  # (bg, inner, contour) softmax without bg
        logits = np.stack([np.zeros_like(x), 12 * (x - centre),
                           np.full_like(x, -2.0)], -1)
        return _softmax(logits)[..., 1:]

    ntype = np.minimum(np.floor(b * 7), 6)[..., None]
    gtype = np.minimum(np.floor(r * 3), 2)[..., None]
    pclass = np.minimum(np.floor(batch[..., 2].mean(axis=(1, 2)) / 255 * 9), 8)
    pclass = np.broadcast_to(pclass[:, None, None, None], ntype.shape)
    return np.concatenate([inst(g, 0.5), inst(r, 0.4), inst(b, 0.55), ntype,
                           gtype, pclass], -1).astype(np.float32)


def _torch_stub(_self, batch, out_sz):
    return torch.from_numpy(stub_outputs(batch.cpu().numpy(), out_sz))


def _run_args(root, tag, slide, backend, geometry=(IN_SHAPE, OUT_SHAPE),
              tile_shape=192, workers=0):
    return {
        "nr_inference_workers": 2,
        "nr_post_proc_workers": workers,
        "batch_size": 8,
        "input_list": [str(slide)],
        "mask_list": [None],
        "output_dir": str(root / f"out_{tag}"),
        "patch_input_shape": geometry[0],
        "patch_output_shape": geometry[1],
        "save_thumb": False,
        "save_mask": False,
        "postproc_list": list(DEFAULT_TARGET_LIST),
        "tile_shape": tile_shape,
        "chunk_shape": 480,
        "ambiguous_size": 16,
        "cache_path": str(root / f"cache_{tag}"),
        "logging_dir": str(root / f"logging_{tag}"),
        "wsi_proc_mag": 0.5,
        "postproc_backend": backend,
    }


def _outputs(root, tag, slide):
    stem = pathlib.Path(str(slide)).stem
    # joblib.load reads both the JAX engine's joblib files and the port's
    # plain pickles
    dat = joblib.load(str(root / f"out_{tag}" / "dat" / f"{stem}.dat"))
    pclass = sio.loadmat(str(root / f"out_{tag}" / "tissue"
                             / f"{stem}.mat"))["pclass"]
    return dat, pclass


def _jax_run(root, tag, slide, resident, params=None, backend="tpu",
             **geometry):
    """The JAX WSI engine; ``params=None`` runs the numpy stub forward,
    otherwise the model at f32."""
    from cerberus_tpu.infer.wsi import InferManager

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CERBERUS_RESIDENT", "1" if resident else "0")
        if params is None:
            infer = InferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                                 model_args=MODEL_KWARGS)
            infer.run_step = stub_outputs
        else:
            infer = InferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                                 model_args=MODEL_KWARGS, params=params,
                                 compute_dtype=jnp.float32)
        infer.process_wsi_list(_run_args(root, tag, slide, backend,
                                         **geometry))
    return _outputs(root, tag, slide)


def _port_manager(checkpoint=None):
    return port_wsi.InferManager(checkpoint_path=checkpoint,
                                 decoder_dict=dict(DEFAULT_TARGET_CODE),
                                 model_args=MODEL_KWARGS, device="cpu")


def _port_run(root, tag, slide, checkpoint=None, backend="gpu",
              resident=True, **geometry):
    infer = _port_manager(checkpoint)
    if checkpoint is None:
        infer.run_step = _torch_stub.__get__(infer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CERBERUS_RESIDENT", "1" if resident else "0")
        infer.process_wsi_list(_run_args(root, tag, slide, backend,
                                         **geometry))
    return _outputs(root, tag, slide)


def _write_slide(slide_dir, seed, blocks=(50, 63)):
    os.makedirs(slide_dir)
    rng = np.random.default_rng(seed)
    plane = np.clip(np.kron(rng.random((*blocks, 3)), np.ones((8, 8, 1)))
                    * 255, 0, 255).astype(np.uint8)
    np.save(slide_dir / "level_0.npy", plane)
    with open(slide_dir / "meta.yml", "w") as f:
        yaml.safe_dump({"mpp": 0.5}, f)


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_wsi")
    _write_slide(root / "input" / "s", 3)
    return root / "input" / "s"


@pytest.fixture(scope="module")
def jax_stub(slide, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_stub")
    return (_jax_run(root, "resident", slide, True),
            _jax_run(root, "legacy", slide, False))


@pytest.fixture(scope="module")
def port_stub(slide, tmp_path_factory):
    return _port_run(tmp_path_factory.mktemp("port_stub"), "port", slide)


@pytest.fixture(scope="module")
def port_legacy_gpu(slide, tmp_path_factory):
    return _port_run(tmp_path_factory.mktemp("port_legacy"), "legacy", slide,
                     resident=False)


@pytest.fixture(scope="module")
def jax_legacy_cpu(slide, tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_cpu"), "legacy_cpu", slide,
                    False, backend="cpu")


def test_stub_forward_dat_matches_both_jax_paths(jax_stub, port_stub):
    (res_dat, res_pclass), (leg_dat, leg_pclass) = jax_stub
    dat, pclass = port_stub
    assert all(len(dat[t]) > 0 for t in TASKS), \
        "fixture produced no instances of some type: the test is vacuous"
    assert _payload(dat) == _payload(res_dat)
    assert _payload(dat) == _payload(leg_dat)
    for ref in (res_pclass, leg_pclass):
        assert pclass.dtype == ref.dtype and pclass.shape == ref.shape
        assert pclass.tobytes() == ref.tobytes()


def test_legacy_loop_gpu_dat_matches_jax_legacy(jax_stub, port_legacy_gpu):
    """``CERBERUS_RESIDENT=0`` with the ``gpu`` backend: the legacy
    host-canvas loop and the CUDA families (their plain versions here)
    equal the JAX legacy loop with its ``tpu`` families."""
    _, (leg_dat, leg_pclass) = jax_stub
    dat, pclass = port_legacy_gpu
    assert all(len(dat[t]) > 0 for t in TASKS)
    assert _payload(dat) == _payload(leg_dat)
    np.testing.assert_array_equal(pclass, leg_pclass)


@pytest.mark.parametrize("workers", [0, 2])
def test_legacy_loop_cpu_dat_matches_jax_legacy(slide, jax_legacy_cpu,
                                                tmp_path, workers):
    """``postproc_backend="cpu"`` (the reference's default run): the legacy
    loop and the scipy/cv2 families, in process and in two spawned
    workers, equal the JAX legacy loop with its ``cpu`` families."""
    ref_dat, ref_pclass = jax_legacy_cpu
    dat, pclass = _port_run(tmp_path, "cpu", slide, backend="cpu",
                            workers=workers)
    assert all(len(dat[t]) > 0 for t in TASKS)
    assert _payload(dat) == _payload(ref_dat)
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_legacy_resume_after_interrupt(slide, port_legacy_gpu, tmp_path,
                                       monkeypatch):
    """``tests/test_wsi_resume.py``'s recipe on the port's legacy loop:
    preempted at its second inference tile, the job records the first in
    ``progress.json``; the rerun skips it and its payload equals an
    uninterrupted run's."""
    import json

    orig = port_wsi.InferManager._run_tile_pipelined
    calls = {"n": 0}

    def interrupting(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated preemption")
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(port_wsi.InferManager, "_run_tile_pipelined",
                        interrupting)
    with pytest.raises(KeyboardInterrupt):
        _port_run(tmp_path, "resume", slide, resident=False)
    with open(tmp_path / "cache_resume" / "progress.json") as f:
        meta = json.load(f)
    assert meta["slide"] == "s" and len(meta["done_tiles"]) == 1
    assert meta["grid"][4] == 0  # the legacy loop's mark

    counted = {"n": 0}

    def counting(self, *args, **kwargs):
        counted["n"] += 1
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(port_wsi.InferManager, "_run_tile_pipelined",
                        counting)
    dat, pclass = _port_run(tmp_path, "resume", slide, resident=False)
    assert counted["n"] == 1  # 2 inference tiles (chunk 480, 504 px wide)
    assert _payload(dat) == _payload(port_legacy_gpu[0])
    np.testing.assert_array_equal(pclass, port_legacy_gpu[1])


def test_svs_dat_matches_its_converted_pyramid(slide, port_stub, tmp_path,
                                               monkeypatch):
    """The stub slide written as a deflate-coded Aperio ``.svs`` (256 px
    tiles, two levels) through the WSI CLI with its default
    ``--wsi_file_ext``: its ``.dat`` payload equals the original pyramid's
    by content (the codec is lossless), and the ``.npy`` pyramid ``python
    -m cerberus_tpu_torch.convert_slide`` makes of it holds the slide's
    pixels at every level, so a run on it reads what the original's does.
    ``chip_smoke.py`` runs a JPEG-coded one and its converted pyramid."""
    from cerberus_tpu_torch import convert_slide

    from tests.test_tiff_reader import _write_tiff

    plane = np.load(slide / "level_0.npy")
    svs_dir, npy_dir = tmp_path / "svs", tmp_path / "npy"
    os.makedirs(svs_dir)
    _write_tiff(str(svs_dir / "s.svs"), [plane, plane[::2, ::2]],
                compression=8, tile=256, description="Aperio |MPP = 0.5|")
    assert convert_slide.main([str(svs_dir / "s.svs"),
                               str(npy_dir / "s")]) == 0
    assert sorted(os.listdir(npy_dir / "s")) == [
        "level_0.npy", "level_1.npy", "level_2.npy", "meta.yml"]
    for lvl in range(3):
        np.testing.assert_array_equal(
            np.load(npy_dir / "s" / ("level_%d.npy" % lvl)),
            plane[::2 ** lvl, ::2 ** lvl][:400 >> lvl, :504 >> lvl])
    with open(npy_dir / "s" / "meta.yml") as f:
        assert yaml.safe_load(f)["mpp"] == 0.5
    monkeypatch.setattr(port_wsi.InferManager, "run_step", _torch_stub)
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    # the stub forward ignores the weights: the port's own seeded ones
    torch.save({"desc": _port_manager().model.state_dict()},
               str(model_dir / "weights.tar"))
    with open(model_dir / "settings.yml", "w") as f:
        # the stub forward writes the default head order
        yaml.safe_dump({"dataset_kwargs":
                        {"req_target_code": dict(DEFAULT_TARGET_CODE)},
                        "model_kwargs": MODEL_KWARGS}, f, sort_keys=False)
    out = tmp_path / "out"
    run_infer_wsi.main(
        ["--model=%s" % model_dir, "--input_dir=%s" % svs_dir,
         "--output_dir=%s" % out, "--cache_path=%s/" % (tmp_path / "c"),
         "--logging_dir=%s" % (tmp_path / "log"), "--batch_size=8",
         "--patch_input_shape=%d" % IN_SHAPE,
         "--patch_output_shape=%d" % OUT_SHAPE, "--tile_shape=192",
         "--ambiguous_size=16"], device="cpu")
    with open(out / "dat" / "s.dat", "rb") as f:
        dat = pickle.load(f)
    assert all(len(dat[t]) > 0 for t in TASKS)
    assert _payload(dat) == _payload(port_stub[0])


@pytest.mark.parametrize("tile_shape", [576, 432])
def test_stub_forward_dense_ratio_dat_matches_jax(slide, tmp_path,
                                                  tile_shape):
    """592->288 windows (the dense margin of 304 px at a CPU size) with the
    stub forward. Tile 576 is a multiple of the output window: the port
    equals both JAX engines. Tile 432 is not (as 2016 px tiles are for 864
    px dense windows): patches reach into the next tile row, and the port
    equals the JAX legacy engine, which writes every patch to the disk
    canvas."""
    geometry = {"geometry": (592, 288), "tile_shape": tile_shape}
    dat, pclass = _port_run(tmp_path, "port", slide, **geometry)
    assert all(len(dat[t]) > 0 for t in TASKS)
    engines = [False] + ([True] if tile_shape % 288 == 0 else [])
    for resident in engines:
        ref_dat, ref_pclass = _jax_run(tmp_path, "jax%d" % resident, slide,
                                       resident, **geometry)
        assert _payload(dat) == _payload(ref_dat), resident
        np.testing.assert_array_equal(pclass, ref_pclass)


def test_stub_forward_masked_dat_matches_jax(slide, tmp_path, monkeypatch):
    """A tissue mask that leaves the right and bottom of the slide empty:
    grid tiles and boundary strips that no patch output reaches and that
    hold no tissue are skipped (the tissue test runs once, for the tiles
    that ask), and the port equals both JAX engines but in one band. The
    windows with outputs at y in [240, 288) reach tissue (y < 248), so they
    run, and they reach into the horizontal strips over y = 288 (y in
    [256, 320)), where no top-left lies and the mask holds no tissue: the
    port post-processes those strips and keeps their nuclei, the JAX
    package skips them (ROADMAP section 3; ``tests/test_torch_wsi_boundary
    .py``). Nuclei centred above y = 256 and every other payload are
    equal; in the band the port has more nuclei."""
    import cv2

    mask = np.zeros((100, 126), np.uint8)
    mask[:62, :50] = 255  # tissue in x < 200, y < 248 of the 400x504 slide
    cv2.imwrite(str(tmp_path / "s.png"), mask)

    def run(engine, tag):
        args = _run_args(tmp_path, tag, slide, "gpu")
        args["mask_list"] = [str(tmp_path / "s.png")]
        engine(args)
        return _outputs(tmp_path, tag, slide)

    def port(args):
        infer = _port_manager()
        infer.run_step = _torch_stub.__get__(infer)
        infer.process_wsi_list(args)

    def jax_engine(resident):
        from cerberus_tpu.infer.wsi import InferManager

        def go(args):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("CERBERUS_RESIDENT", "1" if resident else "0")
                infer = InferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                                     model_args=MODEL_KWARGS)
                infer.run_step = stub_outputs
                infer.process_wsi_list(dict(args, postproc_backend="tpu"))
        return go

    calls = []

    def counting(module):
        orig = module.filter_coordinates

        def call(mask, bounds, shape):
            calls.append((module.__name__, len(bounds)))
            return orig(mask, bounds, shape)
        monkeypatch.setattr(module, "filter_coordinates", call)

    counting(resident_wsi)
    counting(port_wsi)
    dat, pclass = run(port, "port")
    # placement, one test for the grid tiles without patches, one for the
    # tiles of the nuclei pass that no patch output reaches (all sets)
    assert [name.split(".")[-1] for name, _ in calls] == [
        "wsi", "resident_wsi", "wsi"], calls
    assert 0 < len(dat["Nuclei"]) and all(
        v["centroid"][0] < 260 and v["centroid"][1] < 300
        for v in dat["Nuclei"].values())
    band = 256

    def nuclei(d, above):
        return {_sig(v) for v in d["Nuclei"].values()
                if (v["centroid"][1] < band) == above}

    for resident in (True, False):
        ref_dat, ref_pclass = run(jax_engine(resident), "jax%d" % resident)
        got, want = _payload(dat), _payload(ref_dat)
        assert {k: v for k, v in got.items() if k != "Nuclei"} == \
            {k: v for k, v in want.items() if k != "Nuclei"}, resident
        assert nuclei(dat, True) == nuclei(ref_dat, True), resident
        assert len(nuclei(dat, False)) > len(nuclei(ref_dat, False)), \
            resident
        np.testing.assert_array_equal(pclass, ref_pclass)


def test_real_forward_counts_and_tissue_map_match_jax(tmp_path):
    """The resnet18 forward on both sides (JAX at f32, the port on the CPU)
    on a 288x360 slide of the same kind: the per-task instance counts and
    the tissue map agree. The slide is smaller than the stub cases' to keep
    two CPU forwards inside the test budget."""
    root = tmp_path
    slide = root / "input" / "s"
    _write_slide(slide, 3, blocks=(36, 45))
    params = _biased_params()
    ref_dat, ref_pclass = _jax_run(root, "jax", slide, True, params=params)
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(root / "weights.tar"))
    dat, pclass = _port_run(root, "port", slide, str(root / "weights.tar"))
    assert sum(len(ref_dat[t]) for t in TASKS) > 0
    assert {t: len(dat[t]) for t in TASKS} == \
        {t: len(ref_dat[t]) for t in TASKS}
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_resume_after_interrupted_landing(slide, port_stub, tmp_path,
                                          monkeypatch):
    """Preemption at the second disk-canvas landing: the tiles already
    landed are deferred to the disk-canvas path on resume, and the payload
    equals an uninterrupted run's."""
    orig = port_merge.CanvasSet.write_region
    calls = {"n": 0}

    def crashing(self, bounds, values):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated preemption mid-landing")
        return orig(self, bounds, values)

    monkeypatch.setattr(port_merge.CanvasSet, "write_region", crashing)
    with pytest.raises(KeyboardInterrupt):
        _port_run(tmp_path, "resume", slide)
    monkeypatch.setattr(port_merge.CanvasSet, "write_region", orig)
    import json

    with open(tmp_path / "cache_resume" / "progress.json") as f:
        assert len(json.load(f)["done_tiles"]) >= 1

    deferred = []
    orig_run = resident_wsi.ResidentWSIProcessor.run

    def spy(self, *args, **kwargs):
        deferred.extend(orig_run(self, *args, **kwargs))
        return deferred

    monkeypatch.setattr(resident_wsi.ResidentWSIProcessor, "run", spy)
    dat, pclass = _port_run(tmp_path, "resume", slide)
    assert deferred, "no landed tile was deferred on resume"
    assert _payload(dat) == _payload(port_stub[0])
    np.testing.assert_array_equal(pclass, port_stub[1])


def test_u16_overflow_takes_the_fallback_paths(slide, jax_stub, tmp_path,
                                               monkeypatch):
    """With the uint16 limit lowered in the port only, grid tiles defer to
    the disk-canvas path and tissue regions to the plain-family path; the
    payload still equals the JAX engine's unlowered resident run."""
    monkeypatch.setattr(resident_wsi, "_U16_LIMIT", 5)
    deferred, fallbacks = [], []
    orig_run = resident_wsi.ResidentWSIProcessor.run
    family = gpu_postproc.GPUPostProcInstErodedContourMap
    orig_pp = family.post_process.__func__

    def spy_run(self, *args, **kwargs):
        deferred.extend(orig_run(self, *args, **kwargs))
        return list(deferred)

    def spy_pp(cls, raw_map, idx_dict, tissue_mode, *args, **kwargs):
        fallbacks.append(tissue_mode)
        return orig_pp(cls, raw_map, idx_dict, tissue_mode, *args, **kwargs)

    monkeypatch.setattr(resident_wsi.ResidentWSIProcessor, "run", spy_run)
    monkeypatch.setattr(family, "post_process", classmethod(spy_pp))
    dat, pclass = _port_run(tmp_path, "u16", slide)
    assert deferred, "no grid tile was deferred"
    assert {"Gland", "Lumen"} <= set(fallbacks), fallbacks
    (res_dat, res_pclass), _ = jax_stub
    assert _payload(dat) == _payload(res_dat)
    np.testing.assert_array_equal(pclass, res_pclass)


def test_cli_discovers_shards_writes_and_skips(tmp_path, monkeypatch):
    """``run_infer_wsi.main``: pyramid directories are slides, the bulk
    index and step pick the slice of the sorted list, ``dat/``, ``tissue/``
    and ``json/`` are written, and a second call skips the done slide."""
    input_dir = tmp_path / "input"
    for name, seed in (("a", 1), ("b", 2)):
        _write_slide(input_dir / name, seed, blocks=(18, 20))
    (input_dir / "notes.txt").write_text("not a slide")
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    params = _biased_params()
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(model_dir / "weights.tar"))
    with open(model_dir / "settings.yml", "w") as f:
        yaml.safe_dump({"dataset_kwargs":
                        {"req_target_code": dict(DEFAULT_TARGET_CODE)},
                        "model_kwargs": MODEL_KWARGS}, f)
    monkeypatch.setattr(port_wsi.InferManager, "run_step", _torch_stub)
    out = tmp_path / "out"
    argv = ["--model=%s" % model_dir, "--input_dir=%s" % input_dir,
            "--output_dir=%s" % out, "--cache_path=%s/" % (tmp_path / "c"),
            "--logging_dir=%s" % (tmp_path / "log"), "--wsi_file_ext=.npy",
            "--batch_size=8", "--patch_input_shape=%d" % IN_SHAPE,
            "--patch_output_shape=%d" % OUT_SHAPE, "--tile_shape=192",
            "--ambiguous_size=16", "--wsi_bulk_idx=2", "--wsi_proc_step=1",
            "--save_json"]
    run_infer_wsi.main(argv, device="cpu")
    assert sorted(os.listdir(out / "dat")) == ["b.dat"]
    with open(out / "dat" / "b.dat", "rb") as f:
        dat = pickle.load(f)  # a plain pickle
    assert tuple(dat["proc_dimensions"]) == (144, 160)
    assert (out / "tissue" / "b.mat").exists()
    assert (out / "json" / "b.json").exists()
    assert os.listdir(tmp_path / "c" / "2") == []  # cache wiped at the end

    def fail(*args, **kwargs):
        raise AssertionError("a done slide was processed again")

    monkeypatch.setattr(port_wsi.InferManager, "process_single_file", fail)
    run_infer_wsi.main(argv, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(port_wsi.InferManager, "run_step", _torch_stub)
    cpu_out = tmp_path / "out_cpu"
    run_infer_wsi.main([a.replace(str(out), str(cpu_out)) for a in argv]
                       + ["--postproc_backend=cpu"], device="cpu")
    assert sorted(os.listdir(cpu_out / "dat")) == ["b.dat"]


def test_cli_dense_selects_1168_to_864(tmp_path, monkeypatch):
    """``--dense`` overrides the shape flags: the stub forward sees 1168^2
    windows and returns 864^2 outputs, and the slide's ``.dat`` is
    written."""
    input_dir = tmp_path / "input"
    _write_slide(input_dir / "a", 1, blocks=(18, 20))
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    torch.save({"desc": state_dict_from_jax_params(_biased_params())},
               str(model_dir / "weights.tar"))
    with open(model_dir / "settings.yml", "w") as f:
        yaml.safe_dump({"dataset_kwargs":
                        {"req_target_code": dict(DEFAULT_TARGET_CODE)},
                        "model_kwargs": MODEL_KWARGS}, f)
    seen = []

    def stub(self, batch, out_sz):
        seen.append((tuple(batch.shape), out_sz))
        return _torch_stub(self, batch, out_sz)

    monkeypatch.setattr(port_wsi.InferManager, "run_step", stub)
    out = tmp_path / "out"
    run_infer_wsi.main(
        ["--model=%s" % model_dir, "--input_dir=%s" % input_dir,
         "--output_dir=%s" % out, "--cache_path=%s/" % (tmp_path / "c"),
         "--logging_dir=%s" % (tmp_path / "log"), "--wsi_file_ext=.npy",
         "--batch_size=2", "--tile_shape=192", "--ambiguous_size=16",
         "--dense"], device="cpu")
    assert seen and set(seen) == {((2, 1168, 1168, 3), 864)}
    with open(out / "dat" / "a.dat", "rb") as f:
        assert tuple(pickle.load(f)["proc_dimensions"]) == (144, 160)
