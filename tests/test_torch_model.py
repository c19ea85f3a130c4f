"""Port forward vs the JAX forward on shared random weights (CPU, f32).

The JAX tree from ``init_net_params`` (BN statistics and biases randomised
so BN and bias paths are exercised) crosses to torch through
``state_dict_from_jax_params``; the port's ``NetDesc`` loads it with
``strict=True``. Heads must agree within 2e-4 relative (the tolerance the
JAX package met against the reference torch model, PARITY.md §2.3), and the
canvas from ``infer/steps`` must match ``fused_infer_outputs``: INST
probabilities within 2e-4, argmax channels exactly. The densenet121,
mobilenet_v2 and unet_encoder encoders match the JAX encoders level by level
within 5e-4 relative at 96^2 (``tests/test_backbones.py``'s bar), and every
encoder's valid-region heads at 224->72 match JAX ``valid_head_outputs``
within 2e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_DECODER_KWARGS
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.infer.steps import fused_infer_outputs
from cerberus_tpu.models import valid_decode as jax_vd
from cerberus_tpu.models.backbones import get_backbone as jax_get_backbone
from cerberus_tpu.models.convert import convert_torch_state_dict
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.models.net_desc import net_forward as jax_net_forward
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.data.patching import make_channel_index_map
from cerberus_tpu_torch.infer.steps import infer_outputs
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights, net_forward
from cerberus_tpu_torch.models.valid_decode import (
    supports_valid_region,
    valid_head_outputs,
)

torch.set_num_threads(2)

REL_TOL = 2e-4


def _model_kwargs(arch):
    return {"encoder_backbone_name": arch,
            "decoder_kwargs": DEFAULT_DECODER_KWARGS,
            "considered_tasks": list(DEFAULT_DECODER_KWARGS)}


def _random_params(arch, seed=0):
    """JAX init with randomised BN stats/affines and conv biases (numpy)."""
    cfg = JaxModelConfig.from_kwargs(_model_kwargs(arch))
    params = jax.tree.map(np.asarray,
                          init_net_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    out = {}
    for name, leaf in params.items():
        leaf = dict(leaf)
        if "mean" in leaf:
            c = leaf["mean"].shape
            leaf["mean"] = (rng.normal(size=c) * 0.1).astype(np.float32)
            leaf["var"] = (rng.random(c) + 0.5).astype(np.float32)
            leaf["scale"] = (1 + rng.normal(size=c) * 0.1).astype(np.float32)
            leaf["bias"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        elif "bias" in leaf:
            leaf["bias"] = (rng.normal(size=leaf["bias"].shape) * 0.05
                            ).astype(np.float32)
        out[name] = leaf
    return out


_CACHE = {}


def _shared(arch):
    if arch not in _CACHE:
        params = _random_params(arch)
        model = NetDesc(ModelConfig.from_kwargs(_model_kwargs(arch)))
        model.load_state_dict(state_dict_from_jax_params(params), strict=True)
        _CACHE[arch] = (params, model.eval())
    return _CACHE[arch]


def _torch_shared(arch, seed=0):
    """(JAX params, port model) from the port's seeded init with BN
    statistics, affines and conv biases randomised as ``_random_params``
    does, crossed to JAX by ``convert_torch_state_dict`` (cheaper on the CPU
    than ``init_net_params`` for the deep encoders)."""
    key = ("torch", arch, seed)
    if key not in _CACHE:
        gen = torch.Generator().manual_seed(seed)
        model = init_weights(NetDesc(ModelConfig.from_kwargs(
            _model_kwargs(arch))), gen)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    c = mod.running_mean.shape
                    mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                    mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
                    mod.weight.copy_(1 + torch.randn(c, generator=gen) * 0.1)
                    mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                elif isinstance(mod, torch.nn.Conv2d) and mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen)
                                   * 0.05)
        params = convert_torch_state_dict(model.state_dict())
        _CACHE[key] = (params, model.eval())
    return _CACHE[key]


def _rel_err(got, ref):
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def test_state_dict_round_trip_is_identity():
    params = _random_params("resnet18")
    back = convert_torch_state_dict(state_dict_from_jax_params(params))
    assert set(back) == set(params)
    for name, leaf in params.items():
        assert set(back[name]) == set(leaf), name
        for attr, value in leaf.items():
            np.testing.assert_array_equal(back[name][attr], value)


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_state_dict_loads_strict(arch):
    params, model = _shared(arch)
    names = set(model.state_dict())
    assert "decoder_head.Nuclei#TYPE.0.block.1.bn.running_var" in names
    assert "output_head.Gland.INST.x.1.conv.weight" in names
    assert "decoder_head.Patch-Class.conv2.weight" in names
    np.testing.assert_array_equal(
        model.backbone.conv1.weight.detach().numpy(),
        np.transpose(params["backbone.conv1"]["kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("arch,hw", [
    ("resnet18", 144),
    ("resnet34", 144),
    pytest.param("resnet34", 448, marks=pytest.mark.slow),
])
def test_heads_match_jax(arch, hw):
    params, model = _shared(arch)
    cfg = JaxModelConfig.from_kwargs(_model_kwargs(arch))
    imgs = np.random.default_rng(7).integers(0, 256, (2, hw, hw, 3)).astype(
        np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = jax_net_forward(params, jnp.asarray(imgs), cfg)
    with torch.no_grad():
        got = net_forward(model, torch.from_numpy(imgs))
    assert set(got) == set(ref)
    for head, ref_out in ref.items():
        ref_np = np.asarray(ref_out)
        got_np = got[head].numpy()
        assert got_np.shape == ref_np.shape, head
        assert _rel_err(got_np, ref_np) < REL_TOL, head


def test_canvas_matches_fused_infer_outputs():
    params, model = _shared("resnet34")
    cfg = JaxModelConfig.from_kwargs(_model_kwargs("resnet34"))
    imgs = np.random.default_rng(3).integers(0, 256, (2, 144, 144, 3)).astype(
        np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fused_infer_outputs(
            params, jnp.asarray(imgs), cfg, 48, compute_dtype=jnp.float32,
            out_dtype=jnp.float32))
    got = infer_outputs(model, torch.from_numpy(imgs), model.cfg, 48).numpy()
    assert got.shape == ref.shape == (2, 48, 48, 9)
    idx_dict, _ = make_channel_index_map(model.cfg.active_decoder_kwargs)
    for code, (s, e) in idx_dict.items():
        if code.endswith("-INST"):
            assert np.abs(got[..., s:e] - ref[..., s:e]).max() < REL_TOL, code
        else:  # argmax channels are exact
            np.testing.assert_array_equal(got[..., s:e], ref[..., s:e],
                                          err_msg=code)


NEW_ENCODERS = ["densenet121", "mobilenet_v2", "unet_encoder"]


@pytest.mark.parametrize("arch", NEW_ENCODERS)
def test_encoder_state_dict_round_trip_and_names(arch):
    params, model = _torch_shared(arch)
    state = model.state_dict()
    back = state_dict_from_jax_params(params)
    assert set(back) == set(state)
    for name, value in state.items():
        np.testing.assert_array_equal(back[name].numpy(), value.numpy(),
                                      err_msg=name)
    names = set(state)
    expect = {"densenet121": "backbone.features.denseblock4.denselayer16."
                             "conv2.weight",
              "mobilenet_v2": "backbone.features.18.0.weight",
              "unet_encoder": "backbone.module5.conv2.bias"}[arch]
    assert expect in names


@pytest.mark.parametrize("arch", NEW_ENCODERS)
def test_backbone_pyramid_matches_jax(arch):
    params, model = _torch_shared(arch)
    _init, fwd, filters = jax_get_backbone(arch)
    x = np.random.default_rng(3).standard_normal((1, 96, 96, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, v: fwd(p, v, "backbone", None))(
            params, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for level, (g, r) in enumerate(zip(got, ref)):
        g, r = g.permute(0, 2, 3, 1).numpy(), np.asarray(r)
        assert g.shape == r.shape and g.shape[-1] == filters[level], level
        assert _rel_err(g, r) < 5e-4, level


@pytest.mark.parametrize("arch", ["resnet18"] + NEW_ENCODERS)
def test_valid_heads_match_jax(arch):
    params, model = _torch_shared(arch)
    cfg = JaxModelConfig.from_kwargs(_model_kwargs(arch))
    imgs = np.random.default_rng(9).integers(0, 256, (1, 224, 224, 3)).astype(
        np.uint8)
    plan = supports_valid_region(model.cfg, 224, 72)
    assert plan is not None
    jax_plan = jax_vd.supports_valid_region(cfg, 224, 72)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, v: jax_vd.valid_head_outputs(
            p, v, cfg, jax_plan, jnp.float32))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = valid_head_outputs(
            model, torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0,
            plan)
    assert set(got) == set(ref)
    for head, ref_out in ref.items():
        ref_np = np.asarray(ref_out)
        got_np = got[head].permute(0, 2, 3, 1).numpy()
        assert got_np.shape == ref_np.shape, head
        assert _rel_err(got_np, ref_np) < REL_TOL, head
