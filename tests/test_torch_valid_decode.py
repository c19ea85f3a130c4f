"""Valid-region decoding and the dense Patch-Class grid in the port, on the
CPU, against the port's own full towers and against the JAX package.

* the window plans equal ``cerberus_tpu.models.valid_decode.solve_windows``;
* valid-region heads equal the port's full towers + centre crop within 1e-5
  relative (f32; torch's CPU convolutions sum in another order on the
  cropped shapes, so the bit equality the JAX package asserts does not
  hold here);
* the grid head equals the single-window head on each cell's 28^2 bottom
  window (2e-5) and the JAX grid head (2e-4, PARITY.md §2.3's bar);
* the step at 592->288, the smallest geometry with valid-region and the
  2-cell grid, matches JAX ``fused_infer_outputs``: INST probabilities
  within 2e-4, the Patch-Class grid equal, TYPE argmax equal but at ties
  within that tolerance, and the grid
  is the same on the full-tower path (``CERBERUS_VALID_REGION=0``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.infer.steps import fused_infer_outputs
from cerberus_tpu.models import net_desc as jax_net_desc
from cerberus_tpu.models import valid_decode as jax_vd
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.data.patching import make_channel_index_map
from cerberus_tpu_torch.infer.steps import (
    head_outputs,
    infer_outputs,
    make_infer_step,
)
from cerberus_tpu_torch.models import net_desc
from cerberus_tpu_torch.models.layers import center_crop
from cerberus_tpu_torch.models.valid_decode import (
    solve_windows,
    supports_valid_region,
    valid_head_outputs,
)
from test_torch_model import _model_kwargs, _rel_err, _torch_shared

torch.set_num_threads(2)

GEOMETRIES = [(448, 144), (224, 72), (592, 288), (736, 432), (1168, 864),
              (320, 176), (144, 48), (240, 144), (128, 32), (96, 32),
              (160, 16), (448, 448)]


@pytest.mark.parametrize("in_size,out_size", GEOMETRIES)
def test_solve_windows_matches_jax(in_size, out_size):
    got = solve_windows(in_size, out_size)
    ref = jax_vd.solve_windows(in_size, out_size)
    if ref is None:
        assert got is None
    else:
        assert got is not None
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    for arch in ("resnet18", "dsf_cnn_8"):
        kwargs = _model_kwargs(arch)
        got_s = supports_valid_region(ModelConfig.from_kwargs(kwargs),
                                      in_size, out_size)
        ref_s = jax_vd.supports_valid_region(
            JaxModelConfig.from_kwargs(kwargs), in_size, out_size)
        assert (got_s is None) == (ref_s is None), arch


def test_production_plan_and_cpu_sized_geometries():
    plan = solve_windows(448, 144)
    assert plan.bottom_win == (5, 23)
    assert [lvl.skip_win for lvl in plan.levels] == [
        (13, 43), (33, 79), (72, 152), (150, 298)]
    assert [(lvl.up_lo, lvl.up_hi) for lvl in plan.levels] == [
        (3, 3), (3, 3), (2, 2), (2, 2)]
    for geometry in ((224, 72), (592, 288), (1168, 864)):
        assert solve_windows(*geometry) is not None, geometry
    for geometry in ((144, 48), (240, 144), (128, 32)):
        assert solve_windows(*geometry) is None, geometry


def _imgs(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)
                                                ).astype(np.uint8)


def _x(imgs):
    return torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0


def test_valid_region_equals_full_towers_and_crop():
    _, model = _torch_shared("resnet18")
    x = _x(_imgs(1, 2, 224))
    plan = supports_valid_region(model.cfg, 224, 72)
    with torch.no_grad():
        full = model(x)
        valid = valid_head_outputs(model, x, plan)
    assert set(valid) == set(full)
    for head, got in valid.items():
        ref = full[head] if head == "Patch-Class" else center_crop(
            full[head], 72, 72)
        assert got.shape == ref.shape, head
        assert _rel_err(got.numpy(), ref.numpy()) < 1e-5, head


def test_patch_class_grid_equals_single_window_head():
    _, model = _torch_shared("resnet18")
    head = model.decoder_head["Patch-Class"]
    n = 3
    bottom = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 512, 9 * n + 19, 9 * n + 19)).astype(np.float32))
    with torch.no_grad():
        grid = net_desc.pclass_for_cells(head, bottom, n)
        assert grid.shape == (2, 9, n, n)
        for ky in range(n):
            for kx in range(n):
                win = bottom[..., 9 * ky:9 * ky + 28, 9 * kx:9 * kx + 28]
                ref = net_desc.patch_class_head(head, win)
                np.testing.assert_allclose(grid[..., ky, kx].numpy(),
                                           ref[..., 0, 0].numpy(),
                                           rtol=2e-5, atol=2e-5)


def test_patch_class_grid_matches_jax():
    params, model = _torch_shared("resnet18")
    bottom = np.random.default_rng(4).normal(size=(2, 46, 46, 512)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_net_desc.patch_class_head_grid(
            params, jnp.asarray(bottom), 3))
    with torch.no_grad():
        got = net_desc.patch_class_head_grid(
            model.decoder_head["Patch-Class"],
            torch.from_numpy(bottom).permute(0, 3, 1, 2), 3)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 3, 3, 9)
    assert _rel_err(got, ref) < 2e-4


@pytest.fixture(scope="module")
def dense_step():
    """JAX ``fused_infer_outputs`` and the port's ``infer_outputs`` at
    592->288 on one image, f32, and the port's TYPE probabilities."""
    params, model = _torch_shared("resnet18")
    cfg = JaxModelConfig.from_kwargs(_model_kwargs("resnet18"))
    imgs = _imgs(1, 1, 592)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, x: fused_infer_outputs(
            p, x, cfg, 288, compute_dtype=jnp.float32,
            out_dtype=jnp.float32))(params, jnp.asarray(imgs)))
    got = infer_outputs(model, torch.from_numpy(imgs), model.cfg, 288)
    with torch.no_grad():
        pred = head_outputs(model, _x(imgs), 288)
    type_prob = {code: torch.softmax(v, dim=1).permute(0, 2, 3, 1).numpy()
                 for code, v in pred.items() if code.endswith("-TYPE")}
    return model, imgs, ref, got.numpy(), type_prob


def test_dense_step_matches_jax_fused_infer_outputs(dense_step):
    """INST within 2e-4 and the Patch-Class grid equal; a TYPE argmax may
    differ only where its two best probabilities lie within 4e-4 (a tie
    inside the 2e-4 tolerance)."""
    model, _, ref, got, type_prob = dense_step
    assert got.shape == ref.shape == (1, 288, 288, 9)
    idx_dict, _ = make_channel_index_map(model.cfg.active_decoder_kwargs)
    for code, (s, e) in idx_dict.items():
        if code.endswith("-INST"):
            assert np.abs(got[..., s:e] - ref[..., s:e]).max() < 2e-4, code
        elif code.endswith("-TYPE"):
            differ = got[..., s] != ref[..., s]
            assert differ.mean() < 1e-4, code
            top2 = np.sort(type_prob[code][differ], axis=-1)[:, -2:]
            assert np.all(top2[:, 1] - top2[:, 0] < 4e-4), code
        else:
            np.testing.assert_array_equal(got[..., s:e], ref[..., s:e],
                                          err_msg=code)


def test_dense_pclass_grid_survives_full_tower_path(dense_step, monkeypatch):
    model, imgs, _, got, _ = dense_step
    monkeypatch.setenv("CERBERUS_VALID_REGION", "0")
    full = make_infer_step(model, model.cfg, 288, torch.float32,
                           torch.float32)(torch.from_numpy(imgs)).numpy()
    idx_dict, _ = make_channel_index_map(model.cfg.active_decoder_kwargs)
    s, _ = idx_dict["Patch-Class"]
    np.testing.assert_array_equal(full[0, ..., s], got[0, ..., s])
    for cy in range(2):
        for cx in range(2):
            cell = full[0, cy * 144:(cy + 1) * 144, cx * 144:(cx + 1) * 144, s]
            assert len(np.unique(cell)) == 1
    assert set(np.unique(full[..., s])) <= set(float(v) for v in range(9))
    # the probabilities agree as valid-region and full towers do
    for code, (s, e) in idx_dict.items():
        if code.endswith("-INST"):
            assert np.abs(full[..., s:e] - got[..., s:e]).max() < 1e-5, code


def test_forward_flops_follow_the_plan():
    """``utils/flops`` on the meta device: valid-region towers cost less
    than full towers where a plan exists and the same where it does not;
    the encoder is the same on both paths."""
    from cerberus_tpu_torch.utils.flops import default_config, forward_flops

    cfg = default_config("resnet18")
    full = forward_flops(224, 72, False, cfg)
    valid = forward_flops(224, 72, True, cfg)
    assert valid["encoder_flops"] == full["encoder_flops"] > 0
    assert full["encoder_flops"] < valid["flops"] < full["flops"]
    assert forward_flops(144, 48, True, cfg) == forward_flops(144, 48, False,
                                                              cfg)
