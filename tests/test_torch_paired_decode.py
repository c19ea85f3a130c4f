"""The port's width-paired valid-region towers
(``cerberus_tpu_torch/models/paired_decode.py``) against the JAX package's
(``cerberus_tpu/models/paired_decode.py``) on the CPU.

* ``pair_w`` / ``unpair_w``, the repacked kernels and ``_crop_w_paired``
  equal JAX's outputs, transposed to NCHW / OIHW, exactly; the paired
  upsample (one ``upsample2x`` paired by a view) equals JAX's two passes
  within 1e-6;
* ``supports_paired`` and the paired-front gate ``use_paired_front`` give
  JAX's answers over a grid of geometries and arguments;
* the paired heads at 224->72 (even bottom window) and 592->288 (the dense
  plan's odd bottom window, widened; the 2-cell Patch-Class grid) agree
  with JAX ``paired_head_outputs`` within 2e-5 of each head's largest
  logit, and so does a mobilenet_v2 net (unpaired front, paired towers);
* ``CERBERUS_PAIRED=0`` (the default) gives the unpaired step's canvas
  byte for byte, ``1`` agrees with it within 1e-4;
* on a 4-entry mesh each chunk's paired-front gate sees the per-device
  batch that JAX's ``data_parallel`` gives it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.models import paired_decode as jax_pd
from cerberus_tpu.models import paired_encoder as jax_pe
from cerberus_tpu.models import valid_decode as jax_vd
from cerberus_tpu_torch.infer import steps
from cerberus_tpu_torch.models import paired_decode as pd
from cerberus_tpu_torch.models import paired_encoder as pe
from cerberus_tpu_torch.models.valid_decode import (
    solve_windows,
    supports_valid_region,
    valid_head_outputs,
)
from test_torch_model import _model_kwargs, _torch_shared
from test_torch_valid_decode import GEOMETRIES

torch.set_num_threads(2)

TOWER_TOL = 2e-5  # of each head's largest |logit| (JAX's own bar)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_pair_unpair_equal_jax():
    x = _rand(0, (2, 6, 8, 5))  # NHWC
    got = pd.pair_w(_nchw(x))
    assert tuple(got.shape) == (2, 10, 6, 4)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_pd.pair_w(x)))
    # the convention: channel p*C + c of block j holds column 2j + p
    np.testing.assert_array_equal(got[:, 5:, :, 1].numpy(),
                                  _nchw(x)[:, :, :, 3].numpy())
    np.testing.assert_array_equal(pd.unpair_w(got).numpy(),
                                  _nchw(x).numpy())
    # channels-last: both directions are views of the same storage
    cl = _nchw(x).contiguous(memory_format=torch.channels_last)
    assert pd.pair_w(cl).data_ptr() == cl.data_ptr()
    assert pd.unpair_w(pd.pair_w(cl)).data_ptr() == cl.data_ptr()


REPACKS = [
    ("pair_conv_kernel", pd.pair_conv_kernel, jax_pd.pair_conv_kernel,
     (3, 3, 4, 6)),
    ("pair_conv1x1_kernel", pd.pair_conv1x1_kernel,
     jax_pd.pair_conv1x1_kernel, (1, 1, 5, 3)),
    ("pair_stem_kernel", pe.pair_stem_kernel, jax_pe.pair_stem_kernel,
     (7, 7, 3, 8)),
    ("pair_same3_kernel", pe.pair_same3_kernel, jax_pe.pair_same3_kernel,
     (3, 3, 4, 4)),
    ("pair_s2_exit_kernel", pe.pair_s2_exit_kernel,
     jax_pe.pair_s2_exit_kernel, (3, 3, 4, 6)),
]


@pytest.mark.parametrize("name,port,ref,shape", REPACKS,
                         ids=[r[0] for r in REPACKS])
def test_repack_equals_jax_transposed(name, port, ref, shape):
    """Each repacked OIHW kernel is JAX's HWIO one transposed, exactly, and
    gradients reach the unpaired kernel (built out of place)."""
    hwio = _rand(1, shape)
    w = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = port(w)
    want = np.asarray(ref(jnp.asarray(hwio))).transpose(3, 2, 0, 1)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_array_equal(got.detach().numpy(), want, err_msg=name)
    got.sum().backward()
    # every tap appears once per output parity
    assert torch.equal(w.grad, torch.full_like(w, got.shape[0] // w.shape[0]))


@pytest.mark.parametrize("lo,hi", [(2, 8), (3, 9), (4, 12), (5, 11)])
def test_crop_w_paired_equals_jax(lo, hi):
    x = _rand(2, (1, 14, 14, 4))
    xp = jax_pd.pair_w(jnp.asarray(x))
    want = np.asarray(jax_pd._crop_w_paired(xp, (lo, hi)))
    got = pd._crop_w_paired(_nchw(np.asarray(xp)), (lo, hi))
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(_nhwc(got),
                                  np.asarray(jax_pd.pair_w(
                                      x[:, lo:hi, lo:hi])))


@pytest.mark.parametrize("paired_in,lo,hi", [
    (True, 3, 3), (True, 2, 2), (True, 2, 4), (False, 0, 0), (True, 0, 0)])
def test_upsample_crop_pair_equals_jax(paired_in, lo, hi):
    """The port's one-pass paired upsample against JAX's two passes as its
    towers compose them (``_upsample_h_crop``, then ``_upsample_w_crop_pair``
    of the unpaired result), odd and even crop starts; 1e-6 (the two
    associate the bilinear weights differently)."""
    x = _rand(3, (2, 9, 10, 8))  # NHWC; paired: 10 blocks of 2 x 4 ch
    xj = jnp.asarray(x)
    up_h = jax_pd._upsample_h_crop(xj, lo, hi)
    length = 2 * x.shape[1] - hi - lo if (lo or hi) else None
    xu = jax_pd.unpair_w(up_h) if paired_in else up_h
    want = np.asarray(jax_pd._upsample_w_crop_pair(
        xu, lo, length if length is not None else 2 * xu.shape[2]))
    got = pd._upsample_crop_pair(_nchw(x), paired_in, lo, hi, length)
    assert _nhwc(got).shape == want.shape
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)
    cl = _nchw(x).contiguous(memory_format=torch.channels_last)
    up = pd._upsample_crop_pair(cl, paired_in, lo, hi, length)
    assert up.is_contiguous(memory_format=torch.channels_last) or lo
    np.testing.assert_array_equal(up.numpy(), got.numpy())


def test_supports_paired_matches_jax():
    for in_size, out_size in GEOMETRIES:
        plan = solve_windows(in_size, out_size)
        if plan is None:
            continue
        want = jax_pd.supports_paired(jax_vd.solve_windows(in_size,
                                                           out_size),
                                      in_size)
        assert pd.supports_paired(plan, in_size) == want, (in_size,
                                                          out_size)
    assert pd.supports_paired(solve_windows(592, 288), 592)
    assert pd.supports_paired(solve_windows(1168, 864), 1168)


def test_use_paired_front_matches_jax():
    for arch in ("resnet18", "resnet34", "resnet50", "densenet121",
                 "dsf_cnn_4"):
        for width in (446, 448, 592, 1168):
            assert pe.supports_paired_encoder(arch, width) == \
                jax_pe.supports_paired_encoder(arch, width)
            for batch in (1, 8, 32, 47, 48, 64, 128, 512):
                for dp in (1, 4, 8):
                    for env in (None, "0", "1", "auto"):
                        args = (arch, width, batch, dp, env)
                        assert pe.use_paired_front(*args) == \
                            jax_pe.use_paired_front(*args), args


def _jax_paired(arch, imgs, in_size, out_size, cells):
    params, _ = _torch_shared(arch)
    cfg = JaxModelConfig.from_kwargs(_model_kwargs(arch))
    plan = jax_vd.supports_valid_region(cfg, in_size, out_size)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda p, x: jax_pd.paired_head_outputs(
            p, x, cfg, plan, jnp.float32, cells))(params, jnp.asarray(imgs))
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_heads(got, want, tol=TOWER_TOL):
    assert set(got) == set(want)
    for head, ref in want.items():
        port = _nhwc(got[head])
        assert port.shape == ref.shape, head
        scale = np.abs(ref).max() + 1e-9
        assert np.abs(port - ref).max() / scale < tol, head


@pytest.mark.parametrize("arch,in_size,out_size,cells", [
    ("resnet18", 224, 72, 1),   # windowed: even bottom window
    ("resnet18", 592, 288, 2),  # dense margin 304: odd bottom, widened
    ("mobilenet_v2", 224, 72, 1),  # unpaired front, paired towers
])
def test_paired_heads_match_jax(arch, in_size, out_size, cells):
    _, model = _torch_shared(arch)
    imgs = np.random.default_rng(1).integers(
        0, 256, (1, in_size, in_size, 3)).astype(np.uint8)
    plan = supports_valid_region(model.cfg, in_size, out_size)
    assert plan is not None and pd.supports_paired(plan, in_size)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        got = pd.paired_head_outputs(model, x, plan, cells)
        valid = valid_head_outputs(model, x, plan, cells)
    _assert_heads(got, _jax_paired(arch, imgs, in_size, out_size, cells))
    # and the port's own unpaired valid-region heads
    _assert_heads(got, {k: _nhwc(v) for k, v in valid.items()})


def test_cerberus_paired_gate(monkeypatch):
    """Unset and ``0``: the unpaired step (valid-region heads and the
    canvas) byte for byte; ``1``: the paired towers, within 1e-4."""
    _, model = _torch_shared("resnet18")
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 224, 224, 3)).astype(np.uint8))
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        parent = steps.canvas_from_logits(
            valid_head_outputs(model, x, supports_valid_region(
                model.cfg, 224, 72)), model.cfg, 72, torch.float32)
    monkeypatch.delenv("CERBERUS_PAIRED", raising=False)
    unset = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                                  torch.float32)(imgs)
    monkeypatch.setenv("CERBERUS_PAIRED", "0")
    off = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                                torch.float32)(imgs)
    calls = []
    paired = steps.paired_head_outputs
    monkeypatch.setattr(steps, "paired_head_outputs",
                        lambda *a: calls.append(1) or paired(*a))
    monkeypatch.setenv("CERBERUS_PAIRED", "1")
    on = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                               torch.float32)(imgs)
    assert torch.equal(unset, parent) and torch.equal(off, parent)
    assert calls == [1] and on.shape == off.shape
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mesh_chunks_see_the_per_device_batch(monkeypatch):
    """Batch 5 on a 4-entry mesh pads to 8: each chunk's gate sees batch 2,
    as JAX's ``use_paired_front(..., 8, data_parallel=4)`` does; the
    sharded canvas equals the single-device one."""
    from cerberus_tpu_torch.parallel.mesh import (
        make_mesh,
        make_sharded_infer_step,
    )

    _, model = _torch_shared("resnet18")
    seen = []
    gate = pe.use_paired_front

    def spy(arch, width, batch, data_parallel=1, env=None):
        seen.append((batch, data_parallel))
        return gate(arch, width, batch, data_parallel, env)

    monkeypatch.setattr(pe, "use_paired_front", spy)
    monkeypatch.setenv("CERBERUS_PAIRED", "1")
    monkeypatch.setenv("CERBERUS_PAIRED_ENCODER", "1")
    imgs = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (5, 224, 224, 3)).astype(np.uint8))
    run = make_sharded_infer_step(model, model.cfg, make_mesh(["cpu"] * 4),
                                  72, torch.float32, torch.float32)
    sharded = run(imgs)
    assert seen == [(2, 1)] * 4
    assert jax_pe.use_paired_front("resnet18", 224, 8, 4) == \
        pe.use_paired_front("resnet18", 224, 2)
    single = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                                   torch.float32)(imgs)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)
