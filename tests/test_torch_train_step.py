"""The port's train step against the JAX package's (CPU, f32).

Shared weights: the JAX ``init_net_params`` tree (BN statistics, affines and
conv biases randomised, head logits tamed 0.05x so the softmax is not
saturated) crosses to the port through ``load_jax_train_state``. The 6-head
resnet18 at 48^2, batch 2, the LOSS_KWARGS table of
``tests/_train_helpers.py`` with the TYPE class weights; dropout on, the
port given the keep-mask ``jax.random.bernoulli(rng, 0.7, (N, 1, 1, 512))``
of the rng the JAX step passes (NHWC -> NCHW). One compiled JAX step per
configuration.

f32 rounding floor. With batch statistics over two random-noise images,
BN normalises differences that are small against its epsilon (the
Patch-Class MLP sees two pooled vectors) or that cancel (the backward's
mean subtraction), so some results carry a rounding error far above 1e-5:
each side's f32 gradient is up to ~1e-2 of its tensor's largest magnitude
from the same computation in float64 (the Lumen tower here). Each
comparison therefore measures that floor: both sides run the step again
with every weight moved by one part in 2^23 (``_perturb``), and the change
that causes on each side is its noise.

Tolerances:
  * loss scalars within 1e-5 relative, or 4x the two sides' summed noise
    where that is larger (the Patch-Class term);
  * gradients within 1e-4 of each tensor's largest JAX magnitude plus 4x
    the summed noise; the conv biases ahead of a batch-statistics BN have
    an exact gradient of zero, and both sides must keep them below 1e-6 of
    the largest gradient in the tree;
  * parameters after the update within 2e-6 + lr * min(2, 4 tol / |g|),
    with ``g`` the JAX gradient and ``tol`` its tensor's tolerance: Adam's
    first update is about ``lr * sign(g)``, so where ``g`` is not resolved
    by the gradients' agreement the two sides may move by ``lr`` in
    opposite directions;
  * Adam moments: ``mu`` within 0.1 tol, ``nu`` within
    0.001 (2 |g| tol + tol^2) (their updates' own bounds);
  * BN running statistics within 1e-5 (absolute, x max(1, |value|)), or
    4x their summed noise.
The optimizer alone (AdamW, StepLR) is held to optax on the same gradient
tree within 1e-6. ``remat`` in each form equals ``remat=False`` exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.serialization import to_state_dict

from _torch_train_helpers import (
    LOSS_KWARGS_CLASS_WEIGHTS,
    make_batch,
    model_kwargs,
)
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.models import convert as jax_convert
from cerberus_tpu.models.layers import batch_norm as jax_batch_norm
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.train import steps as jax_steps
from cerberus_tpu.train.utils import tame_head_logits
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.models import convert
from cerberus_tpu_torch.models.layers import BN_EPS, BatchNorm2d
from cerberus_tpu_torch.models.net_desc import NetDesc
from cerberus_tpu_torch.train import steps

torch.set_num_threads(2)

LR = 1e-3
KEEP_SHAPE = (1, 1, 512)  # the JAX dropout mask's trailing dims (NHWC)
NOISE_FACTOR = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_PARAMS = {}


def _random_params(cfg, seed=0):
    """The JAX init with randomised BN and biases, tamed heads (cached:
    callers do not modify it)."""
    if (cfg, seed) not in _PARAMS:
        _PARAMS[cfg, seed] = _make_params(cfg, seed)
    return _PARAMS[cfg, seed]


def _make_params(cfg, seed):
    params = _np(init_net_params(jax.random.PRNGKey(seed), cfg))
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
    return _np(tame_head_logits(out))


def _perturb(params, seed=123):
    """Every trained leaf times (1 +- 2^-21), elementwise random signs."""
    rng = np.random.default_rng(seed)
    return {name: {attr: value if attr in ("mean", "var") else
                   (value * (1 + rng.choice([-1.0, 1.0], value.shape)
                             * 2.0 ** -21)).astype(np.float32)
                   for attr, value in leaf.items()}
            for name, leaf in params.items()}


def _batch(seed, n=2, missing=()):
    """``make_batch`` with random INST weight maps."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, n=n)
    for head in batch:
        if head.endswith("#WEIGHT-MAP"):
            batch[head] = rng.uniform(1, 5, batch[head].shape).astype(
                np.float32)
    for head in missing:
        batch.pop(head)
    return batch


def _keep(rng, n):
    """The JAX step's dropout mask for ``rng`` -> the port's NCHW mask."""
    mask = np.asarray(jax.random.bernoulli(rng, 0.7, (n,) + KEEP_SHAPE))
    return mask.transpose(0, 3, 1, 2).copy()


def _port_step(kwargs, params, opt_kwargs, opt_state=None, step=0,
               grad_accum=1, remat=False):
    """A port ``TrainStep`` holding a JAX-layout train state."""
    cfg = ModelConfig.from_kwargs(kwargs)
    port = steps.make_train_step(cfg, LOSS_KWARGS_CLASS_WEIGHTS, opt_kwargs,
                                 remat=remat, grad_accum=grad_accum,
                                 return_grads=True, model=NetDesc(cfg))
    port.load_jax_train_state(params, opt_state, step)
    return port


def _compare(kwargs, opt_kwargs, jstep, state, batch, rng, grad_accum=1,
             path=None):
    """The JAX step and the port's from ``state`` (the port's read from
    ``path`` when given), and both again from the perturbed weights."""
    n = batch["img"].shape[0]
    if grad_accum == 1:
        keep = _keep(rng, n)
    else:
        keep = np.concatenate([_keep(r, n // grad_accum)
                               for r in jax.random.split(rng, grad_accum)])
    keep = torch.from_numpy(keep)
    out = {"params": _np(state.params), "pert": []}
    for tag, params in (("ref", out["params"]),
                        ("pert", _perturb(out["params"], 123)),
                        ("pert", _perturb(out["params"], 321))):
        st = jax_steps.TrainState(params=params, opt_state=state.opt_state,
                                  step=state.step)
        new_state, metrics, grads = jstep(st, batch, rng)
        if tag == "ref" and path is not None:
            port = _port_step(kwargs, params, opt_kwargs,
                              grad_accum=grad_accum)
            port.load_jax_train_state(*convert.load_train_state(path))
        else:
            port = _port_step(kwargs, params, opt_kwargs,
                              _np(to_state_dict(state.opt_state)),
                              int(state.step), grad_accum)
        port_metrics, port_grads = port(batch, keep=keep)
        result = {"new_state": new_state, "grads": _np(grads),
                  "new_params": _np(new_state.params),
                  "port_new_params": port.jax_train_state()[0],
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "port": port,
                    "port_metrics": {k: float(v)
                                     for k, v in port_metrics.items()},
                    "port_grads": convert.jax_params_from_state_dict(
                        port_grads)}
        if tag == "ref":
            out["ref"] = result
        else:
            out["pert"].append(result)
    return out


def _run(kwargs, opt_kwargs, batch, rng_seed, grad_accum=1, seed=0):
    """One JAX step and one port step from the same fresh state."""
    cfg = JaxModelConfig.from_kwargs(kwargs)
    params = _random_params(cfg, seed)
    jstep, tx = jax_steps.make_train_step(
        cfg, LOSS_KWARGS_CLASS_WEIGHTS, opt_kwargs, donate=False,
        return_grads=True, grad_accum=grad_accum)
    state = jax_steps.TrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros((), jnp.int32))
    out = _compare(kwargs, opt_kwargs, jstep, state, batch,
                   jax.random.PRNGKey(rng_seed), grad_accum)
    out.update(jax_step=jstep, state=state)
    return out


def _plain():
    """Adam, dummy masking (sample 0 lacks Nuclei-INST, sample 1 lacks
    Gland-TYPE and Patch-Class), dropout on."""
    batch = _batch(0)
    heads = jax_steps.head_order(JaxModelConfig.from_kwargs(model_kwargs()))
    batch["has_target"][0, heads.index("Nuclei-INST")] = 0
    batch["has_target"][1, heads.index("Gland-TYPE")] = 0
    batch["has_target"][1, heads.index("Patch-Class")] = 0
    return _run(model_kwargs(), {"lr": LR}, batch, 7)


def _noise(run, get):
    """The larger of the two perturbed runs' summed JAX + port change of
    ``get(result, side)`` (side "" for JAX, "port_")."""
    ref = run["ref"]
    return max(float(np.max(np.abs(get(p, "") - get(ref, ""))
                            + np.max(np.abs(get(p, "port_")
                                            - get(ref, "port_")))))
               for p in run["pert"])


def _assert_metrics(run):
    ref = run["ref"]
    assert set(ref["port_metrics"]) == set(ref["metrics"])
    for key, value in ref["metrics"].items():
        noise = _noise(run, lambda r, side: r[side + "metrics"][key])
        tol = max(1e-5 * max(abs(value), 1e-6), NOISE_FACTOR * noise)
        got = ref["port_metrics"][key]
        assert abs(got - value) <= tol, (key, got, value, tol)


def _tolerances(run):
    """{(name, attr): (gradient tolerance, exact-zero gradient)} for every
    tensor the port trains."""
    grads, port = run["ref"]["grads"], run["ref"]["port_grads"]
    top = max(float(np.abs(v).max()) for leaf in grads.values()
              for v in leaf.values())
    tols = {}
    for name, leaf in port.items():
        for attr, got in leaf.items():
            g = grads[name][attr]
            noise = _noise(run, lambda r, side: r[side + "grads"][name][attr])
            zero = float(np.abs(g).max()) < 1e-6 * top
            tol = (float(np.abs(g).max()) + float(np.abs(got).max())
                   if zero else
                   1e-4 * float(np.abs(g).max()) + NOISE_FACTOR * noise)
            tols[(name, attr)] = (tol, zero, top)
    return tols


def _assert_grads(run):
    grads, port = run["ref"]["grads"], run["ref"]["port_grads"]
    tols = _tolerances(run)
    for name, leaf in grads.items():
        for attr, ref in leaf.items():
            if (name, attr) not in tols:
                # BN statistics and frozen modules: JAX's gradient is zero
                # and the port has none
                assert not np.any(ref), (name, attr)
                continue
            tol, zero, top = tols[(name, attr)]
            got = port[name][attr]
            if zero:
                assert float(np.abs(got).max()) < 1e-6 * top, (name, attr)
                continue
            err = float(np.abs(got - ref).max())
            assert err <= tol, (name, attr, err, tol)


def _jax_moments(opt_state):
    inner = to_state_dict(opt_state)["inner_states"]["train"]["inner_state"]
    return inner["0"]


def _assert_state(run, lr=LR):
    """Parameters, BN statistics and Adam moments of the port after its
    step against JAX's new state."""
    ref = run["ref"]
    tols = _tolerances(run)
    params, opt_state, step = ref["port"].jax_train_state()
    new_state = ref["new_state"]
    assert step == int(new_state.step)
    ref_params = ref["new_params"]
    assert set(params) == set(ref_params)
    for name, leaf in ref_params.items():
        for attr, want in leaf.items():
            err = np.abs(params[name][attr] - want)
            if (name, attr) not in tols:  # BN statistics, frozen leaves
                noise = _noise(run, lambda r, side: r[side + "new_params"]
                               [name][attr])
                assert np.all(err <= np.maximum(
                    1e-5 * np.maximum(1, np.abs(want)),
                    NOISE_FACTOR * noise)), (name, attr)
                continue
            tol, zero, _ = tols[(name, attr)]
            g = np.abs(ref["grads"][name][attr])
            bound = 2 * lr if zero else lr * np.minimum(
                2.0, NOISE_FACTOR * tol / np.maximum(g, 1e-30))
            assert np.all(err <= bound + 2e-6), (name, attr,
                                                 float(err.max()))
    want_m = _np(_jax_moments(new_state.opt_state))
    got_m = opt_state["inner_states"]["train"]["inner_state"]["0"]
    assert int(got_m["count"]) == int(want_m["count"])
    for name, leaf in want_m["mu"].items():
        for attr, mu in leaf.items():
            if isinstance(mu, dict):  # masked: not trained
                assert got_m["mu"][name][attr] == {}, (name, attr)
                continue
            tol = tols[(name, attr)][0] * 1.01
            g = np.abs(ref["grads"][name][attr])
            assert float(np.abs(got_m["mu"][name][attr] - mu).max()) \
                <= 0.1 * tol + 1e-12, ("mu", name, attr)
            nu = want_m["nu"][name][attr]
            assert np.all(np.abs(got_m["nu"][name][attr] - nu)
                          <= 0.001 * (2 * g * tol + tol * tol) + 1e-20), \
                ("nu", name, attr)


def test_train_step_matches_jax(tmp_path):
    """Loss scalars, gradients (``jax.value_and_grad``), parameters, Adam
    moments and BN statistics after one step; then the train state in both
    directions: JAX's state after step 1 -> file -> the port's step 2
    equals JAX's step 2, and the port's state after it -> file -> JAX
    ``load_train_state`` gives the port's values."""
    plain = _plain()
    _assert_metrics(plain)
    _assert_grads(plain)
    _assert_state(plain)

    state1 = plain["ref"]["new_state"]
    path = str(tmp_path / "jax_state.tar")
    jax_convert.save_train_state(path, state1.params, state1.opt_state,
                                 step=int(state1.step))
    run = _compare(model_kwargs(), {"lr": LR}, plain["jax_step"], state1,
                   _batch(3), jax.random.PRNGKey(17), path=path)
    port = run["ref"]["port"]
    assert port.count == 2
    _assert_metrics(run)
    _assert_grads(run)
    _assert_state(run)

    back = str(tmp_path / "port_state.tar")
    convert.save_train_state(back, *port.jax_train_state())
    params, opt_state, step = jax_convert.load_train_state(
        back, plain["state"].opt_state)
    assert step == 2
    ref_params, ref_opt, _ = port.jax_train_state()
    for name, leaf in ref_params.items():
        for attr, value in leaf.items():
            np.testing.assert_array_equal(np.asarray(params[name][attr]),
                                          value)
    assert jax.tree.structure(opt_state) == jax.tree.structure(
        plain["state"].opt_state)
    moments = _jax_moments(opt_state)
    ref = ref_opt["inner_states"]["train"]["inner_state"]["0"]
    assert int(moments["count"]) == int(ref["count"]) == 2
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(
            np.asarray(moments[key]["backbone.conv1"]["kernel"]),
            ref[key]["backbone.conv1"]["kernel"])


def test_grad_accum_missing_head_and_batch1_bn_match_jax():
    """grad_accum=2 on batch 2 (microbatches of 1: the Patch-Class MLP's BN
    sees one value per channel), Nuclei-TYPE missing from the batch."""
    accum = _run(model_kwargs(), {"lr": LR},
                 _batch(1, missing=("Nuclei-TYPE",)), 11, grad_accum=2)
    _assert_metrics(accum)
    assert "Nuclei-TYPE_loss" not in accum["ref"]["port_metrics"]
    _assert_grads(accum)
    for name, leaf in accum["ref"]["port_grads"].items():
        if name.startswith(("decoder_head.Nuclei#TYPE.",
                            "output_head.Nuclei#TYPE.")):
            assert not any(np.any(v) for v in leaf.values()), name
    _assert_state(accum)


def test_subtype_freezing_matches_jax():
    """Subtype fine-tuning of Gland#TYPE with AdamW."""
    subtype = _run(model_kwargs(subtype_gland=True),
                   {"lr": LR, "weight_decay": 1e-2}, _batch(2), 13)
    _assert_metrics(subtype)
    _assert_grads(subtype)
    port = subtype["ref"]["port"]
    assert all(name.startswith(("decoder_head.Gland#TYPE.",
                                "output_head.Gland#TYPE."))
               for name in port.param_names)
    _assert_state(subtype)
    # frozen: no update (AdamW decay included), eval BN (stats unchanged)
    before = subtype["params"]
    after, _, _ = port.jax_train_state()
    for name in ("backbone.conv1", "backbone.bn1", "conv_map",
                 "decoder_head.Gland.0.block.0.bn",
                 "decoder_head.Patch-Class.bn1"):
        for attr, value in before[name].items():
            np.testing.assert_array_equal(after[name][attr], value)
    assert not np.array_equal(
        after["decoder_head.Gland#TYPE.0.block.0.bn"]["mean"],
        before["decoder_head.Gland#TYPE.0.block.0.bn"]["mean"])


def test_optimizer_update_matches_optax_on_the_same_gradients():
    """AdamW with StepLR(decay 2) for three updates, one head's gradient
    zero (as when it has no targets: decay and moments still apply) and one
    module frozen: the port's optimizer against optax ``tx.update``."""
    cfg = JaxModelConfig.from_kwargs(model_kwargs())
    params = _random_params(cfg)
    frozen = lambda name: name.startswith("decoder_head.Lumen.")  # noqa: E731
    opt_kwargs = {"lr": LR, "weight_decay": 1e-2, "lr_decay_steps": 2}
    tx, _ = jax_steps.make_optimizer(opt_kwargs, frozen_pred=frozen)
    opt_state = tx.init(params)
    model = NetDesc(ModelConfig.from_kwargs(model_kwargs()))
    model.load_state_dict(convert.state_dict_from_jax_params(params))
    named = [(n, p) for n, p in model.named_parameters()
             if not frozen(n)]
    optimizer, schedule = steps.make_optimizer([p for _, p in named],
                                               opt_kwargs)
    rng = np.random.default_rng(5)
    jparams = params
    for count in range(3):
        grads = {}
        for name, leaf in params.items():
            zero = name.startswith("output_head.Nuclei#TYPE.")
            grads[name] = {a: np.zeros_like(v) if zero or a in ("mean", "var")
                           else rng.normal(size=v.shape).astype(np.float32)
                           * 1e-2 for a, v in leaf.items()}
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree.map(np.asarray,
                               optax.apply_updates(jparams, updates))
        torch_grads = convert.state_dict_from_jax_params(grads)
        for name, param in named:
            param.grad = torch_grads[name].clone()
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)
        optimizer.step()
    got = convert.jax_params_from_state_dict(model.state_dict())
    for name, leaf in jparams.items():
        for attr, ref in leaf.items():
            np.testing.assert_allclose(got[name][attr], ref, atol=1e-6,
                                       err_msg="%s.%s" % (name, attr))
    assert np.array_equal(got["decoder_head.Lumen.0.block.0.conv"]["kernel"],
                          params["decoder_head.Lumen.0.block.0.conv"]
                          ["kernel"])


def test_lr_schedule_matches_jax():
    port = steps.make_lr_schedule(2e-3, 3, 0.5)
    ref = jax_steps.make_lr_schedule(2e-3, 3, 0.5)
    assert [port(c) for c in range(10)] == [float(ref(c)) for c in range(10)]
    assert port(0) == 2e-3 and port(3) == 1e-3


@pytest.mark.parametrize("remat", [True, "backbone", "towers"])
def test_remat_equals_plain(remat):
    """One step with ``remat`` gives the plain step's loss, gradients,
    parameters and BN statistics (folded once, not again on the
    recompute)."""
    cfg = JaxModelConfig.from_kwargs(model_kwargs())
    params = _random_params(cfg)
    batch = _batch(4)
    keep = torch.from_numpy(_keep(jax.random.PRNGKey(3), 2))
    results = []
    for mode in (False, remat):
        port = _port_step(model_kwargs(), params, {"lr": LR}, remat=mode)
        metrics, grads = port(batch, keep=keep)
        results.append((metrics, grads, port.model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert not torch.equal(s0["backbone.bn1.running_mean"],
                           torch.from_numpy(params["backbone.bn1"]["mean"]))


def test_remat_rejects_unknown_mode():
    with pytest.raises(ValueError, match="remat"):
        _port_step(model_kwargs(), _random_params(
            JaxModelConfig.from_kwargs(model_kwargs())), {"lr": LR},
            remat="decoder")


def test_batch_one_bn_keeps_the_jax_guard():
    """BN with one value per channel (the Patch-Class MLP at batch 1):
    ``nn.BatchNorm2d`` raises; the port's layer and JAX's both output the
    bias (the normalised value is 0) within the rounding of ``x * inv``
    (inv = scale / sqrt(eps): both evaluate ``x * inv + (bias - mean *
    inv)``), and the port folds JAX's statistics (unbiased variance over
    max(n - 1, 1) = 0)."""
    rng = np.random.default_rng(0)
    c = 16
    x = rng.normal(size=(1, 1, 1, c)).astype(np.float32)
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32),
         "mean": rng.normal(size=c).astype(np.float32),
         "var": (rng.random(c) + 0.5).astype(np.float32)}
    ref, mean, var = jax_batch_norm(p, jnp.asarray(x), train=True)
    state = convert.state_dict_from_jax_params({"l": p})
    layer = BatchNorm2d(c, eps=BN_EPS)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    layer.train()
    out = layer(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    out = out.detach().numpy().transpose(0, 2, 3, 1)
    ulp = np.spacing(np.abs(x[0, 0, 0] * p["scale"]
                            / np.sqrt(BN_EPS)).astype(np.float32))
    for got in (out, np.asarray(ref)):
        assert np.all(np.abs(got[0, 0, 0] - p["bias"]) <= 4 * ulp)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               0.9 * p["mean"] + 0.1 * np.asarray(mean),
                               atol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               0.9 * p["var"] + 0.1 * np.asarray(var),
                               atol=1e-6)
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(c).train()(torch.zeros(1, c, 1, 1))


def test_bf16_step_is_finite_and_near_f32():
    """bf16 autocast is not JAX's ``compute_dtype``: held only to finite
    losses, BN statistics that move, and the f32 loss within 5 %."""
    cfg = JaxModelConfig.from_kwargs(model_kwargs())
    params = _random_params(cfg)
    batch = _batch(5)
    keep = torch.from_numpy(_keep(jax.random.PRNGKey(5), 2))
    losses = []
    for dtype in (torch.float32, torch.bfloat16):
        model = NetDesc(ModelConfig.from_kwargs(model_kwargs()))
        model.load_state_dict(convert.state_dict_from_jax_params(params))
        port = steps.make_train_step(
            ModelConfig.from_kwargs(model_kwargs()),
            LOSS_KWARGS_CLASS_WEIGHTS, {"lr": LR}, compute_dtype=dtype,
            model=model)
        metrics = port(batch, keep=keep)
        assert all(torch.isfinite(v) for v in metrics.values())
        assert not torch.equal(model.backbone.bn1.running_var,
                               torch.from_numpy(params["backbone.bn1"]["var"]))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        losses.append(float(metrics["overall_loss"]))
    assert abs(losses[1] - losses[0]) <= 0.05 * losses[0]


def test_valid_step_matches_jax():
    cfg = JaxModelConfig.from_kwargs(model_kwargs())
    params = _random_params(cfg)
    imgs = _batch(6)["img"]
    ref = jax_steps.make_valid_step(cfg)(params, imgs)
    model = NetDesc(ModelConfig.from_kwargs(model_kwargs()))
    model.load_state_dict(convert.state_dict_from_jax_params(params))
    got = steps.make_valid_step(model)(imgs)
    assert set(got) == set(ref)
    for head, value in ref.items():
        value = np.asarray(value)
        if head == "Patch-Class":
            np.testing.assert_array_equal(got[head].numpy(), value)
        else:
            np.testing.assert_allclose(got[head].numpy(), value, atol=2e-5)


def test_debug_mode_names_a_non_finite_loss(monkeypatch):
    """``CERBERUS_DEBUG=1``: a NaN in a head's logits raises naming that
    head's loss."""
    monkeypatch.setenv("CERBERUS_DEBUG", "1")
    params = _random_params(JaxModelConfig.from_kwargs(model_kwargs()))
    port = _port_step(model_kwargs(), params, {"lr": LR})
    with torch.no_grad():
        port.model.output_head["Gland#TYPE"]["TYPE"].x[1].conv.bias.fill_(
            float("nan"))
    with pytest.raises(FloatingPointError, match="Gland-TYPE_loss"):
        port(_batch(8))
