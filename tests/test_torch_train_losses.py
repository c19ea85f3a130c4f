"""The port's losses (``train/losses.py``, NCHW) against the JAX package's
(NHWC) on the same seeded inputs, within 1e-6 (absolute, x max(1, |ref|))."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cerberus_tpu.train import losses as jax_losses
from cerberus_tpu_torch.train import losses

TOL = 1e-6


def _close(got, ref):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max(initial=0)) <= TOL * max(
        1.0, float(np.abs(ref).max(initial=0)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _inputs(seed=0, n=2, hw=12, c=5):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, hw, hw, c)) * 3).astype(np.float32)
    true = rng.integers(0, c, (n, hw, hw)).astype(np.int32)
    return rng, logits, true


def test_xentropy_loss():
    _, logits, true = _inputs()
    _close(losses.xentropy_loss(torch.from_numpy(true), _nchw(logits)),
           jax_losses.xentropy_loss(jnp.asarray(true), jnp.asarray(logits)))


@pytest.mark.parametrize("masked", [False, True])
def test_dice_loss(masked):
    rng, logits, true = _inputs(1)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    onehot = np.eye(5, dtype=np.float32)[true]
    mask = (true > 0).astype(np.float32)[..., None] if masked else None
    got = losses.dice_loss(_nchw(onehot[..., 1:]), _nchw(prob[..., 1:]),
                           mask=None if mask is None else _nchw(mask))
    ref = jax_losses.dice_loss(jnp.asarray(onehot[..., 1:]),
                               jnp.asarray(prob[..., 1:]),
                               mask=None if mask is None else jnp.asarray(
                                   mask))
    _close(got, ref)


@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_focal_loss(gamma):
    _, logits, true = _inputs(2)
    _close(losses.focal_loss(torch.from_numpy(true), _nchw(logits), gamma),
           jax_losses.focal_loss(jnp.asarray(true), jnp.asarray(logits),
                                 gamma))


def test_mse_loss():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 4, 6, 6)).astype(np.float32)
    _close(losses.mse_loss(torch.from_numpy(a), torch.from_numpy(b)),
           jax_losses.mse_loss(jnp.asarray(a), jnp.asarray(b)))


def test_hv_sobel_kernels():
    for got, ref in zip(losses.hv_sobel_kernels(5),
                        jax_losses._hv_sobel_kernels(5)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_msge_loss():
    rng = np.random.default_rng(4)
    true = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    pred = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    focus = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)
    _close(losses.msge_loss(_nchw(true), _nchw(pred),
                            torch.from_numpy(focus)),
           jax_losses.msge_loss(jnp.asarray(true), jnp.asarray(pred),
                                jnp.asarray(focus)))


@pytest.mark.parametrize("mode", ["all", "one"])
def test_simclr_loss(mode):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(6, 2, 8)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    _close(losses.simclr_loss(torch.from_numpy(feats), contrast_mode=mode),
           jax_losses.simclr_loss(jnp.asarray(feats), contrast_mode=mode))
    with pytest.raises(ValueError):
        losses.simclr_loss(torch.from_numpy(feats), contrast_mode="none")


def test_class_weight_map():
    true = np.random.default_rng(6).integers(0, 7, (2, 9, 9)).astype(np.int32)
    table = {1: 12, 2: 1, 3: 2, 4: 6, 5: 12}  # 6 keeps its label value
    _close(losses.class_weight_map(torch.from_numpy(true), table, 7),
           jax_losses.class_weight_map(jnp.asarray(true), table, 7))


def test_losses_are_differentiable():
    _, logits, true = _inputs(7)
    x = _nchw(logits).requires_grad_(True)
    losses.xentropy_loss(torch.from_numpy(true), x).mean().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
