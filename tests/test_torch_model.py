"""Port forward vs the JAX forward on shared random weights (CPU, f32).

The JAX tree from ``init_net_params`` (BN statistics and biases randomised
so BN and bias paths are exercised) crosses to torch through
``state_dict_from_jax_params``; the port's ``NetDesc`` loads it with
``strict=True``. Heads must agree within 2e-4 relative (the tolerance the
JAX package met against the reference torch model, PARITY.md §2.3), and the
canvas from ``infer/steps`` must match ``fused_infer_outputs``: INST
probabilities within 2e-4, argmax channels exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_DECODER_KWARGS
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.infer.steps import fused_infer_outputs
from cerberus_tpu.models.convert import convert_torch_state_dict
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.models.net_desc import net_forward as jax_net_forward
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.data.patching import make_channel_index_map
from cerberus_tpu_torch.infer.steps import infer_outputs
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.models.net_desc import NetDesc, net_forward

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
