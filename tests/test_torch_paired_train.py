"""The port's width-paired training forward (``NetDesc.forward_train(...,
paired=True)``: ``models/paired_encoder.py`` and ``models/paired_tower.py``)
against the JAX package's (``net_forward(..., paired=True)``) on the CPU,
resnet18 at 48^2 with tamed heads.

* f32 training forward: logits within 2e-3 and the BN batch statistics the
  port folds within 5e-3 / 1e-3 (absolute / relative) of JAX's sink
  (``tests/test_paired_train.py``'s bars);
* loss and gradients of the masked multi-task loss at JAX's scale-aware
  tolerance (loss 1e-3 relative; each gradient within
  ``max(1e-3, 5e-3 x its largest magnitude)`` + 5e-2 relative), or four
  times JAX's own f32 error against the exact (float64) gradient where
  that is larger;
* ``remat=True`` gives the paired step's results without it;
* float64: the paired step equals the unpaired one (both compute the same
  sums) with ``grad_accum=2`` and ``remat``, and under subtype freezing
  (frozen BN statistics untouched), within ``PARITY_F64_TOLS``; the
  data-parallel paired step on two gloo ranks equals the single-device
  one (``tests/test_torch_dp_train.py``'s scheme);
* ``paired=True`` raises ``ValueError`` where JAX raises (bottleneck and
  DSF encoders, W % 4 != 0), and ``run_train --paired`` trains.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_train_helpers import (
    LOSS_KWARGS,
    LOSS_KWARGS_CLASS_WEIGHTS,
    PARITY_F64_TOLS,
    make_batch,
    model_kwargs,
    step_on,
    worst_errors,
)
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.models.net_desc import net_forward as jax_net_forward
from cerberus_tpu.train import steps as jax_steps
from cerberus_tpu_torch import run_train
from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS, ModelConfig
from cerberus_tpu_torch.models import convert
from cerberus_tpu_torch.models.layers import BN_MOMENTUM
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from cerberus_tpu_torch.train import steps
from cerberus_tpu_torch.train.utils import tame_head_logits
from test_torch_dp_train import _assert_f64_parity, _case, _dp_f64, _single
from test_torch_run_train import settings  # noqa: F401 (fixture)

torch.set_num_threads(2)

KWARGS = model_kwargs()
CFG = ModelConfig.from_kwargs(KWARGS)
JCFG = JaxModelConfig.from_kwargs(KWARGS)
NOISE_FACTOR = 4


def _state(seed=0):
    model = init_weights(NetDesc(CFG), torch.Generator().manual_seed(seed))
    return tame_head_logits(model.state_dict())


def _model(state, dtype=torch.float32):
    model = NetDesc(CFG)
    model.load_state_dict(state)
    return model.to(dtype).train()


def _imgs(seed, n=2, hw=48):
    return np.random.default_rng(seed).integers(0, 255, (n, hw, hw, 3)
                                                ).astype(np.uint8)


def test_paired_train_forward_and_bn_stats_match_jax():
    state = _state()
    params = convert.jax_params_from_state_dict(state)
    imgs = _imgs(0)

    def fwd(p, x):
        sink = {}
        out = jax_net_forward(p, x, JCFG,
                              train_decoder_list=tuple(
                                  JCFG.active_decoders()),
                              bn_sink=sink, paired=True)
        return out, sink

    want, sink = jax.jit(fwd)(params, jnp.asarray(imgs))
    model = _model(state)
    x = steps.images_to_input(torch.from_numpy(imgs))
    got = model.forward_train(x, paired=True)
    assert set(got) == set(want)
    for head, ref in want.items():
        port = got[head].detach().permute(0, 2, 3, 1).numpy()
        assert port.shape == ref.shape, head
        np.testing.assert_allclose(port, np.asarray(ref), atol=2e-3, rtol=0,
                                   err_msg=head)
    after = model.state_dict()
    folded = {name for name in sink}
    assert folded == {k[:-len(".running_mean")] for k in after
                      if k.endswith(".running_mean")}
    for name, (mean, var) in sink.items():
        for what, ref in (("running_mean", mean), ("running_var", var)):
            before = state["%s.%s" % (name, what)].double()
            batch = (after["%s.%s" % (name, what)].double()
                     - (1 - BN_MOMENTUM) * before) / BN_MOMENTUM
            np.testing.assert_allclose(batch.numpy(), np.asarray(ref),
                                       atol=5e-3, rtol=1e-3,
                                       err_msg="%s %s" % (name, what))
        assert int(after[name + ".num_batches_tracked"]) == 0


def test_paired_train_loss_and_grads_match_jax():
    """JAX's bars (loss 1e-3 relative; gradients ``max(1e-3, 5e-3 x
    max|g|)`` + 5e-2 relative), or, where larger, four times JAX's own f32
    error against the exact gradients (the port's paired step in float64,
    which equals the unpaired one: ``test_paired_float64_*``): at random
    init each package's f32 gradient of ``backbone.conv1`` is ~3 % of its
    largest value from the exact one, and the two packages' convolution
    backends round differently."""
    state = _state(1)
    params = convert.jax_params_from_state_dict(state)
    batch = make_batch(np.random.default_rng(1))
    tables = jax_steps._loss_table_static(LOSS_KWARGS, JCFG)

    def loss_fn(p, b):
        total, metrics = jax_steps.multitask_loss(p, b, JCFG, tables, {},
                                                  None, paired=True)
        return total, metrics

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    port = {}
    for dtype in (torch.float32, torch.float64):
        step = steps.make_train_step(CFG, LOSS_KWARGS, {"lr": 1e-3},
                                     return_grads=True,
                                     model=_model(state, dtype), paired=True)
        metrics, port_grads = step(batch)
        port[dtype] = (float(metrics["overall_loss"]),
                       convert.jax_params_from_state_dict(port_grads))
    np.testing.assert_allclose(port[torch.float32][0], float(loss),
                               rtol=1e-3)
    exact = port[torch.float64][1]
    for name, leaf in port[torch.float32][1].items():
        for attr, got in leaf.items():
            ref = np.asarray(grads[name][attr])
            jax_err = float(np.abs(ref - exact[name][attr]).max())
            atol = max(1e-3, 5e-3 * float(np.abs(ref).max()),
                       NOISE_FACTOR * jax_err)
            np.testing.assert_allclose(got, ref, atol=atol, rtol=5e-2,
                                       err_msg="%s.%s" % (name, attr))


def test_paired_remat_equals_paired():
    state = _state(2)
    batch = make_batch(np.random.default_rng(2))
    keep = torch.rand((2, 512, 1, 1),
                      generator=torch.Generator().manual_seed(2)) < 0.7
    plain = step_on("cpu", KWARGS, state, batch, keep, paired=True)
    remat = step_on("cpu", KWARGS, state, batch, keep, paired=True,
                    remat=True)
    assert plain[0] == remat[0]
    for name, grad in plain[1].items():
        torch.testing.assert_close(remat[1][name], grad, rtol=1e-6,
                                   atol=1e-9, msg=name)
    for key, value in plain[2].items():
        torch.testing.assert_close(remat[2][key], value, rtol=0, atol=0,
                                   msg=key)


def _assert_f64_equal(got, ref):
    errs = worst_errors(got, ref)
    assert errs["zero_grad"] <= 1, errs
    for key, tol in PARITY_F64_TOLS.items():
        assert errs[key] <= tol, errs


def test_paired_float64_equals_unpaired_with_accum_and_remat():
    """grad_accum=2 (each microbatch folds its own paired statistics) and
    ``remat=True``: in float64 the paired step is the unpaired one."""
    state = _state(3)
    batch = make_batch(np.random.default_rng(3), n=4)
    keep = torch.rand((4, 512, 1, 1),
                      generator=torch.Generator().manual_seed(3)) < 0.7
    runs = [step_on("cpu", KWARGS, state, batch, keep,
                    loss_kwargs=LOSS_KWARGS_CLASS_WEIGHTS,
                    dtype=torch.float64, grad_accum=2, remat=True,
                    paired=paired) for paired in (False, True)]
    _assert_f64_equal(runs[1], runs[0])


def test_paired_float64_subtype_freezing():
    """Subtype fine-tuning: the frozen encoder and towers run paired with
    their stored statistics (eval BN) and fold nothing; the step equals
    the unpaired one in float64."""
    kwargs = model_kwargs(subtype_nuclei=True)
    model = init_weights(NetDesc(ModelConfig.from_kwargs(kwargs)),
                         torch.Generator().manual_seed(4))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_var.uniform_(0.5, 1.5)
    state = tame_head_logits(model.state_dict())
    batch = make_batch(np.random.default_rng(4))
    keep = torch.ones((2, 512, 1, 1), dtype=torch.bool)
    runs = [step_on("cpu", kwargs, state, batch, keep,
                    loss_kwargs=LOSS_KWARGS_CLASS_WEIGHTS,
                    dtype=torch.float64, paired=paired)
            for paired in (False, True)]
    _assert_f64_equal(runs[1], runs[0])
    after = runs[1][2]
    for key in ("backbone.bn1.running_var",
                "backbone.layer1.0.bn2.running_mean",
                "decoder_head.Gland.3.block.1.bn.running_var"):
        torch.testing.assert_close(after[key], state[key].double(), rtol=0,
                                   atol=0, msg=key)
    moved = "decoder_head.Nuclei#TYPE.3.block.1.bn.running_var"
    assert not torch.equal(after[moved], state[moved].double())


def test_dp_paired_float64_equals_single_device():
    """Two gloo ranks: the paired BN statistics span the ranks
    (``layers.allsum``) as the unpaired ones do."""
    case = _case(2)
    ranks = _dp_f64(case, 1, paired=True)
    ref = _single(*case, 1, threads=2, paired=True)
    _assert_f64_parity(ranks[0], ref, _single(*case, 1, threads=1,
                                              paired=True))


def _dsf_kwargs():
    decoders = {k: v for k, v in DEFAULT_DECODER_KWARGS.items()
                if k != "Patch-Class"}
    return model_kwargs("dsf_cnn_4", decoder_kwargs=decoders,
                        considered_tasks=list(decoders))


@pytest.mark.parametrize("kwargs,hw", [
    (model_kwargs("resnet50"), 48),
    (model_kwargs("resnet18"), 46),
    (_dsf_kwargs(), 48),
], ids=["resnet50", "w46", "dsf_cnn_4"])
def test_paired_raises_where_jax_raises(kwargs, hw):
    imgs = np.zeros((1, hw, hw, 3), np.uint8)
    with pytest.raises(ValueError, match="basic-block"):
        jax_net_forward({}, jnp.asarray(imgs), JaxModelConfig.from_kwargs(
            kwargs), bn_sink={}, paired=True)
    model = NetDesc(ModelConfig.from_kwargs(kwargs)).train()
    with pytest.raises(ValueError, match="basic-block"):
        model.forward_train(steps.images_to_input(torch.from_numpy(imgs)),
                            paired=True)


def test_cli_paired_trains(tmp_path, settings):  # noqa: F811
    """``run_train --paired`` (resnet18 at 48^2) takes its steps and
    writes its checkpoint; the loss is finite."""
    net = run_train.main(["--settings=%s" % settings,
                          "--log_dir=%s" % (tmp_path / "logs"),
                          "--nr_epochs=1", "--batch_size=4",
                          "--per_n_steps=2", "--paired"])
    assert net.step == 3 and net.train_step.paired
    assert (tmp_path / "logs" / "net_step-000002.tar").exists()
