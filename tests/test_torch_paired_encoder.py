"""The port's width-paired ResNet front
(``cerberus_tpu_torch/models/paired_encoder.py``) against the JAX
package's (``cerberus_tpu/models/paired_encoder.py``) on the CPU, in eval
mode (the training side is ``tests/test_torch_paired_train.py``).

* ``max_pool_paired`` equals JAX's and the port's plain
  ``MaxPool2d(3, 2, 1)`` exactly (max is order-free);
* ``resnet_forward_paired`` with randomised BN statistics gives JAX's
  paired pyramid, and the port's unpaired one, within 2e-5 of each
  level's largest value (JAX's own bar), for resnet18 and resnet34;
* ``paired_bn`` in eval equals ``BatchNorm2d`` on the unpaired tensor.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cerberus_tpu.models import paired_decode as jax_pd
from cerberus_tpu.models import paired_encoder as jax_pe
from cerberus_tpu_torch.models import paired_decode as pd
from cerberus_tpu_torch.models import paired_encoder as pe
from cerberus_tpu_torch.models.layers import max_pool_3x3_s2
from test_torch_model import _torch_shared

torch.set_num_threads(2)

LEVEL_TOL = 2e-5


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_max_pool_paired_exact():
    x = np.random.default_rng(3).normal(size=(2, 14, 16, 5)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = pe.max_pool_paired(pd.pair_w(xt))
    want = np.asarray(jax_pe.max_pool_paired(jax_pd.pair_w(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(pd.unpair_w(got).numpy(),
                                  max_pool_3x3_s2()(xt).numpy())


def test_paired_bn_eval_equals_unpaired_bn():
    _, model = _torch_shared("resnet18")
    bn = model.backbone.bn1
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 64, 6, 8)).astype(np.float32))
    with torch.no_grad():
        got = pd.unpair_w(pe.paired_bn(bn, pd.pair_w(x)))
        np.testing.assert_allclose(got.numpy(), bn(x).numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_paired_pyramid_matches_jax(arch):
    params, model = _torch_shared(arch)
    x = np.random.default_rng(1).random((2, 48, 48, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, v: jax_pe.resnet_forward_paired(
            p, v, arch))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = pe.resnet_forward_paired(model.backbone, xt)
        plain = model.backbone(xt)
    assert len(got) == len(want) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape, level
        scale = np.abs(w).max() + 1e-9
        assert np.abs(_nhwc(g) - w).max() / scale < LEVEL_TOL, level
    flat = [pd.unpair_w(got[0]), pd.unpair_w(got[1])] + got[2:]
    for level, (g, p) in enumerate(zip(flat, plain)):
        scale = float(p.abs().max()) + 1e-9
        assert float((g - p).abs().max()) / scale < LEVEL_TOL, level
