"""The port's grouped decoder bank (``cerberus_tpu_torch/models/
fused_decoder.py``) against the JAX package's (``cerberus_tpu/models/
fused_decoder.py``) and the port's own sequential towers, on the CPU.

* the bank's heads equal JAX ``model_head_outputs`` with the bank and the
  port's sequential full towers within 1e-3 of each head's largest logit
  (``tests/test_fused_decoder.py``'s bar), a partial-task net's too;
* ``make_infer_step(fuse_decoders=True)`` runs the bank with full towers:
  INST probabilities within 1e-3 of the unfused full-tower step, argmax
  channels differing on < 1 % of pixels;
* both packages make the same choice where a net has no bank (JAX's
  ``build_fused_decoder`` raises ``KeyError`` for DSF-CNN towers and the
  step runs them one after another): a partial-task net is fused, a DSF
  net is not, and its fused step equals its unfused one byte for byte.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_train_helpers import jax_layout_params, model_kwargs
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.infer.steps import model_head_outputs
from cerberus_tpu.models import fused_decoder as jax_fd
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.infer import steps
from cerberus_tpu_torch.models import convert
from cerberus_tpu_torch.models import fused_decoder as fd
from cerberus_tpu_torch.models.net_desc import NetDesc
from test_torch_model import _torch_shared

torch.set_num_threads(2)

BANK_TOL = 1e-3


def _imgs(seed, n=2, hw=48):
    return np.random.default_rng(seed).integers(0, 255, (n, hw, hw, 3)
                                                ).astype(np.uint8)


def _x(imgs):
    return torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0


def _close(got, ref, tol=BANK_TOL):
    scale = max(1.0, float(np.abs(ref).max()))
    return float(np.abs(got - ref).max()) / scale < tol


PARTIAL = model_kwargs(decoder_kwargs={
    "Nuclei": {"INST": 3}, "Nuclei#TYPE": {"TYPE": 7},
    "Patch-Class": {"OUT": 9}},
    considered_tasks=["Nuclei", "Nuclei#TYPE"])


@pytest.mark.parametrize("case", ["six_heads", "partial"])
def test_bank_matches_jax_and_sequential(case):
    if case == "six_heads":
        params, model = _torch_shared("resnet18")
        cfg = JaxModelConfig.from_kwargs(model_kwargs())
    else:
        params = jax_layout_params(PARTIAL, seed=1)
        model = NetDesc(ModelConfig.from_kwargs(PARTIAL))
        model.load_state_dict(convert.state_dict_from_jax_params(params))
        model.eval()
        cfg = JaxModelConfig.from_kwargs(PARTIAL)
    imgs = _imgs(0)
    bank, specs = jax_fd.build_fused_decoder(params, cfg)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, b, x: model_head_outputs(
            p, x, cfg, jnp.float32, b, specs))(params, bank,
                                               jnp.asarray(imgs))
    port_bank = fd.build_fused_decoder(model)
    assert port_bank[1] == specs
    with torch.no_grad():
        got = fd.fused_head_outputs(model, *port_bank, _x(imgs))
        seq = model(_x(imgs))
    assert set(got) == set(want) == set(seq)
    for head, ref in want.items():
        port = got[head].permute(0, 2, 3, 1).numpy()
        assert port.shape == np.asarray(ref).shape, head
        assert _close(port, np.asarray(ref)), head
        assert _close(got[head].numpy(), seq[head].numpy()), head


def test_fused_step_runs_the_bank_with_full_towers(monkeypatch):
    _, model = _torch_shared("resnet18")
    imgs = torch.from_numpy(_imgs(1, hw=224))
    calls = []
    forward = fd.fused_decoder_forward

    def spy(*args):
        calls.append(args[2][0].shape[-1])
        return forward(*args)

    monkeypatch.setattr(fd, "fused_decoder_forward", spy)
    fused = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                                  torch.float32, fuse_decoders=True)(imgs)
    assert calls == [224]  # the whole window: no valid-region plan
    monkeypatch.setenv("CERBERUS_VALID_REGION", "0")
    full = steps.make_infer_step(model, model.cfg, 72, torch.float32,
                                 torch.float32)(imgs)
    assert fused.shape == full.shape
    np.testing.assert_allclose(fused[..., :6].numpy(), full[..., :6].numpy(),
                               atol=1e-3)
    assert (fused[..., 6:] != full[..., 6:]).float().mean() < 0.01


@pytest.mark.parametrize("arch,fused", [("resnet18", True),
                                       ("dsf_cnn_4", False)])
def test_same_choice_as_jax_where_there_is_no_bank(arch, fused, caplog):
    """A partial-task resnet18 net and a DSF net (coefficients x0.01 so
    random weights stay finite, ``tests/_torch_dsf_helpers.py``)."""
    from _torch_dsf_helpers import GSCALE_SERVED, dsf_model

    if arch == "resnet18":
        kwargs = PARTIAL
        model = NetDesc(ModelConfig.from_kwargs(kwargs))
    else:
        model, kwargs = dsf_model(arch, gscale=GSCALE_SERVED)
    params = convert.jax_params_from_state_dict(model.state_dict())
    try:
        jax_fd.build_fused_decoder(params, JaxModelConfig.from_kwargs(
            kwargs))
        jax_fused = True
    except KeyError:
        jax_fused = False
    model.eval()
    with caplog.at_level(logging.INFO, logger=steps.__name__):
        bank = steps.bank_or_none(model)
        steps.bank_or_none(model)
    assert (bank is not None) == jax_fused == fused
    if fused:
        return
    assert len([r for r in caplog.records
                if "no grouped bank" in r.getMessage()]) <= 1
    imgs = torch.from_numpy(_imgs(2, n=1, hw=64))
    on = steps.make_infer_step(model, model.cfg, 32, torch.float32,
                               torch.float32, fuse_decoders=True)(imgs)
    off = steps.make_infer_step(model, model.cfg, 32, torch.float32,
                                torch.float32)(imgs)
    assert torch.isfinite(on).all() and torch.equal(on, off)
