"""The fused tile backend on the CPU
(``cerberus_tpu_torch/infer/fused_tile.py``, ``--tile_backend=fused``): its canvas against the host path's and against
JAX ``run_fused_tile``; the CLI's ``.mat`` files against the host backend's.
The model and images are ``tests/test_torch_tile_cache.py``'s."""
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (CPU pinning)

import jax.numpy as jnp

from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.infer.fused_tile import run_fused_tile as jax_fused_tile
from cerberus_tpu_torch import run_infer_tile
from cerberus_tpu_torch.infer import tile as port_tile
from cerberus_tpu_torch.infer.fused_tile import run_fused_tile
from test_torch_tile import _image
from test_torch_tile_cache import (
    IN_SHAPE,
    MODEL_KWARGS,
    OUT_SHAPE,
    assert_mats_equal,
    load_mats,
    model_params,
    port_manager,
    write_images,
    write_model_dir,
)
from test_torch_wsi import stub_outputs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return model_params()


def test_fused_canvas_is_byte_equal_to_host_path(params):
    """Zero-padded short batch (9 windows, batch 4), real rows written: at
    one batch size the fused canvas is the host path's, byte for byte."""
    manager = port_manager(params)
    img = _image(40, (100, 120))
    fused = run_fused_tile(manager, img)
    assert fused.shape == (100, 120, 9) and fused.dtype == torch.float32
    assert torch.equal(fused, manager.infer_canvas(img))


def test_fused_canvas_agrees_with_jax_fused_tile(params):
    """Against the JAX fused program at f32 (2e-4 relative, the forward
    tolerance); the JAX program pads with copies of the last window, which
    on the CPU give the same values."""
    img = _image(42, (100, 120))
    ref = np.asarray(jax_fused_tile(
        params, img, JaxModelConfig.from_kwargs(MODEL_KWARGS), IN_SHAPE,
        OUT_SHAPE, 4, jnp.float32))
    got = run_fused_tile(port_manager(params), img).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max()))
    assert err <= 2e-4, err


def test_overlap_is_refused(params, tmp_path):
    manager = port_manager(params, patch_output_overlap=8)
    with pytest.raises(ValueError, match="overlap"):
        run_fused_tile(manager, _image(1, (60, 50)))
    input_dir = tmp_path / "input"
    write_images(input_dir, ((60, 50),))
    with pytest.raises(ValueError, match="overlap"):
        manager.process_file_list({
            "input_dir": str(input_dir), "output_dir": str(tmp_path / "out"),
            "tile_backend": "fused"})
    with pytest.raises(ValueError, match="tile_backend"):
        port_manager(params).process_file_list({
            "input_dir": str(input_dir), "output_dir": str(tmp_path / "out"),
            "tile_backend": "mesh"})


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_cli_fused_mats_equal_host_backend(params, tmp_path, monkeypatch,
                                           backend):
    """``--tile_backend=fused`` against ``host`` (the batch cache) on a
    directory, under a per-window step: equal ``.mat`` files."""
    monkeypatch.setattr(
        port_tile.InferManager, "run_step",
        lambda self, batch, out_sz: torch.from_numpy(
            stub_outputs(batch.numpy(), out_sz)))
    model_dir = write_model_dir(str(tmp_path / "model"), params)
    input_dir = tmp_path / "input"
    images = write_images(input_dir, ((100, 120), (60, 50), (130, 90)), 9)
    mats = {}
    for tile_backend in ("host", "fused"):
        out = tmp_path / tile_backend
        run_infer_tile.main([
            "--model=%s" % model_dir, "--input_dir=%s" % input_dir,
            "--output_dir=%s" % out, "--batch_size=4",
            "--patch_input_shape=%d" % IN_SHAPE,
            "--patch_output_shape=%d" % OUT_SHAPE,
            "--postproc_backend=%s" % backend,
            "--tile_backend=%s" % tile_backend], device="cpu")
        assert os.path.exists(out / "overlay" / "img00.jpg")
        mats[tile_backend] = load_mats(out, images)
    assert_mats_equal(mats["fused"], mats["host"])
    assert max(int(m["inst_map"].max()) for (_, t), m in
               mats["fused"].items() if t != "pclass") > 0
