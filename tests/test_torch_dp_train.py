"""The data-parallel train step (``parallel.mesh.make_sharded_train_step``
on a process mesh) on the CPU: two gloo ranks (``run_ranks``), resnet18 at
48^2, global batch 4.

float64: the step equals the port's single-device ``TrainStep`` on the
global batch: loss scalars and BN running statistics within 1e-10
relative; every gradient and Adam moment within 1e-10 of its tensor's
largest magnitude, or within 4x the single-device step's own float64
rounding spread where that is larger (measured as the change between 2
and 1 CPU threads: at grad_accum=2 each rank holds one image of a
microbatch, and a few BN weight gradients cancel down to ~1e-10 of their
summands there); parameters within 1e-10 plus twice what the gradient's
own difference moves Adam's first update by (``lr * eps * dg / (|g| +
eps)^2``: up to 1e5 dg where |g| is near eps).

f32: against the JAX package's ``make_sharded_train_step`` on a 2-device
CPU mesh, under ``tests/test_torch_train_step.py``'s scheme (each side
rerun from weights moved by 2^-21, its change the side's noise). JAX's
sharded step returns no gradients; they are read from its first Adam
moment (``mu = 0.1 g`` after one step).
"""
import numpy as np
import pytest
import torch

import conftest

import jax
import jax.numpy as jnp
from flax.serialization import to_state_dict

from _torch_train_helpers import (
    LOSS_KWARGS_CLASS_WEIGHTS,
    jax_layout_params,
    make_batch,
    model_kwargs,
)
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cerberus_tpu.parallel.mesh import (
    make_sharded_train_step as jax_sharded_train_step,
)
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from cerberus_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
)
from cerberus_tpu_torch.train import opt, steps
from cerberus_tpu_torch.train.utils import tame_head_logits

import _torch_dist_workers as W
from _torch_ranks import run_ranks
import test_torch_train_step as T

LR = 1e-3
HW, N = 48, 4
TOL = 1e-10
EPS = 1e-8  # Adam's


def _case(seed=0):
    """Seeded resnet18 weights with randomised BN statistics, tamed heads;
    a 48^2 batch of 4 with random INST weight maps; a dropout keep-mask."""
    kwargs = model_kwargs()
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(NetDesc(ModelConfig.from_kwargs(kwargs)), gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.running_mean.shape
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    state = tame_head_logits(model.state_dict())
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, n=N, hw=HW)
    for key in batch:
        if key.endswith("#WEIGHT-MAP"):
            batch[key] = rng.uniform(1, 5, batch[key].shape).astype(
                np.float32)
    keep = torch.rand((N, 512, 1, 1), generator=gen) < 0.7
    return kwargs, state, batch, keep


def _single(kwargs, state, batch, keep, grad_accum, threads, paired=False):
    """The single-device float64 step on the global batch (width-paired
    with ``paired``), in the layout of
    ``_torch_dist_workers.dp_train_step``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        cfg = ModelConfig.from_kwargs(kwargs)
        model = NetDesc(cfg)
        model.load_state_dict(state)
        model.to(torch.float64)
        step = steps.make_train_step(cfg, LOSS_KWARGS_CLASS_WEIGHTS,
                                     {"lr": LR}, grad_accum=grad_accum,
                                     return_grads=True, model=model,
                                     paired=paired)
        metrics, grads = step(batch, keep=keep)
        opt_state = {step.param_names[i]: {k: v.numpy().copy()
                                           for k, v in st.items()
                                           if v.dim() > 0}
                     for i, st in step.optimizer.state_dict()[
                         "state"].items()}
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.numpy().copy() for k, v in grads.items()},
                {k: v.numpy().copy() for k, v in model.state_dict().items()},
                opt_state)
    finally:
        torch.set_num_threads(saved)


def _assert_f64_parity(got, ref, ref_other):
    metrics, grads, state, opt_state = got[:4]
    assert set(metrics) == set(ref[0])
    for key, value in ref[0].items():
        assert abs(metrics[key] - value) <= TOL * max(abs(value), 1e-6), key
    for name, want in ref[1].items():
        scale = np.abs(want).max()
        noise = np.abs(want - ref_other[1][name]).max()
        tol = max(TOL * scale, 4 * noise, 1e-300)
        assert np.abs(grads[name] - want).max() <= tol, (name, tol)
        for moment in ("exp_avg", "exp_avg_sq"):
            want_m = ref[3][name][moment]
            m_noise = np.abs(want_m - ref_other[3][name][moment]).max()
            m_tol = max(TOL * np.abs(want_m).max(), 4 * m_noise, 1e-300)
            assert np.abs(opt_state[name][moment] - want_m).max() <= m_tol, \
                (name, moment)
    for key, want in ref[2].items():
        err = np.abs(state[key].astype(np.float64) - want)
        if "running_" in key:
            assert (err <= TOL * np.maximum(1, np.abs(want))).all(), key
        elif key in ref[1]:
            # Adam's first update is lr * g / (|g| + eps): a gradient
            # difference dg moves it by up to lr * eps * dg / (|g| + eps)^2
            g, dg = np.abs(ref[1][key]), np.abs(grads[key] - ref[1][key])
            bound = TOL + 2 * LR * EPS * dg / (g + EPS) ** 2
            assert (err <= bound).all(), key
        else:
            assert (err <= TOL).all(), key


def _dp_f64(case, grad_accum, extra=(), remat=False, paired=False):
    kwargs, state, batch, keep = case
    return run_ranks(W.dp_train_step, 2, (
        kwargs, state, batch, keep, "float64", grad_accum,
        LOSS_KWARGS_CLASS_WEIGHTS, {"lr": LR}, extra, remat, paired),
        timeout_s=300)


def test_dp_step_float64_equals_single_device_step():
    """Plain: the loss, every gradient, the parameters, the Adam moments
    and the BN statistics; both ranks hold the same state after; a batch
    of 3 does not divide over 2 ranks and raises."""
    case = _case(0)
    bad = {k: v[:3] for k, v in case[2].items()}
    ranks = _dp_f64(case, 1, (bad,))
    ref = _single(*case, 1, threads=2)
    _assert_f64_parity(ranks[0], ref, _single(*case, 1, threads=1))
    for key, value in ranks[0][2].items():
        np.testing.assert_array_equal(ranks[1][2][key], value, err_msg=key)
    for errors in (ranks[0][4], ranks[1][4]):
        assert len(errors) == 1 and "divisible" in errors[0]


def test_dp_step_float64_grad_accum_with_a_head_missing_on_one_rank():
    """grad_accum=2 (microbatches of 2, one image a rank) with Nuclei-INST
    missing from every row rank 1 holds: the per-head flag sums must be
    global for the loss to equal the single-device one's. The ranks run
    with ``remat=True`` (their BN all-reduces again while a checkpointed
    region recomputes in the backward), the reference without it: remat
    changes no value."""
    kwargs, state, batch, keep = _case(1)
    head = steps.head_order(ModelConfig.from_kwargs(kwargs)).index(
        "Nuclei-INST")
    batch["has_target"][[1, 3], head] = 0  # rank 1's rows of both micros
    case = (kwargs, state, batch, keep)
    ranks = _dp_f64(case, 2, remat=True)
    ref = _single(*case, 2, threads=2)
    _assert_f64_parity(ranks[0], ref, _single(*case, 2, threads=1))
    assert ref[0]["Nuclei-INST_loss"] > 0


def test_single_controller_mesh_of_two_raises():
    cfg = ModelConfig.from_kwargs(model_kwargs())
    mesh = make_mesh([torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="process mesh"):
        make_sharded_train_step(cfg, mesh, model=NetDesc(cfg))
    with pytest.raises(NotImplementedError, match="item 7"):
        opt.check_supported(cfg, mesh=mesh)
    one = make_sharded_train_step(cfg, make_mesh(["cpu"]), model=NetDesc(cfg))
    assert one.world == 1 and one.group is None


class _Held:
    """A finished rank's train state where the scheme expects a step."""

    def __init__(self, state):
        self.state = state

    def jax_train_state(self):
        return self.state


def _grads_from_mu(params, opt_state):
    """JAX's gradient after one step from its first moment (``mu = (1 -
    b1) g``); zeros for the frozen BN statistics."""
    mu = T._jax_moments(opt_state)["mu"]
    return {name: {attr: (np.asarray(mu[name][attr]) / np.float32(0.1)
                          if not isinstance(mu[name][attr], dict)
                          else np.zeros_like(value))
                   for attr, value in leaf.items()}
            for name, leaf in params.items()}


def test_dp_step_f32_matches_jax_sharded_step():
    """f32, plain: loss scalars, gradients, parameters, Adam moments and
    BN statistics against JAX's data-parallel step on a 2-device CPU mesh,
    each within the tolerances of ``test_torch_train_step.py``."""
    kwargs = model_kwargs()
    cfg = JaxModelConfig.from_kwargs(kwargs)
    params = T._make_params(cfg, 0, jax_layout_params(kwargs, 0))
    batch = T._batch(5, n=N)
    rng = jax.random.PRNGKey(9)
    keep = torch.from_numpy(T._keep(rng, N))
    jmesh = jax_make_mesh(conftest.cpu_mesh_devices()[:2])
    run, init_state, tx = jax_sharded_train_step(
        cfg, jmesh, LOSS_KWARGS_CLASS_WEIGHTS, {"lr": LR},
        compute_dtype=jnp.float32)
    param_sets = [params, T._perturb(params, 123), T._perturb(params, 321)]
    ports = run_ranks(W.dp_jax_layout_steps, 2, (
        kwargs, param_sets, batch, keep, LOSS_KWARGS_CLASS_WEIGHTS,
        {"lr": LR}), timeout_s=300)[0]
    results = []
    for p, (port_metrics, port_grads, port_state) in zip(param_sets, ports):
        state = init_state(jax.tree.map(jnp.asarray, p))
        new_state, metrics = run(state, batch, rng)
        new_params = T._np(new_state.params)
        results.append({
            "new_state": new_state, "new_params": new_params,
            "grads": _grads_from_mu(new_params, new_state.opt_state),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "port": _Held(port_state), "port_new_params": port_state[0],
            "port_metrics": port_metrics, "port_grads": port_grads})
    scheme = {"ref": results[0], "pert": results[1:]}
    assert int(scheme["ref"]["new_state"].step) == 1
    assert to_state_dict(scheme["ref"]["new_state"].opt_state)
    T._assert_metrics(scheme)
    T._assert_grads(scheme)
    T._assert_state(scheme)


def test_build_trainer_on_a_process_mesh(tmp_path):
    """``build_trainer(mesh=...)`` under two gloo ranks: the data-parallel
    step over both, logs and checkpoints from rank 0 only, and one step
    on a 48^2 batch of 4 (dropout masks drawn from the seeded generator,
    the same on both ranks) gives both ranks the same loss."""
    batch = make_batch(np.random.default_rng(2), n=N, hw=HW)
    ranks = run_ranks(W.dp_build_trainer, 2, (str(tmp_path), batch),
                      timeout_s=300)
    assert [r[0] for r in ranks] == [2, 2]
    assert ranks[0][1] == str(tmp_path) and ranks[1][1] is None
    assert ranks[0][2] == ranks[1][2]
    assert np.isfinite(ranks[0][2]["overall_loss"])
