"""Train fixtures for the port's tests and ``chip_smoke.py``: the 6-head
model config, the loss table of ``tests/_train_helpers.py`` and its
synthetic batch, built on the port's ``head_order`` (numpy and the port
only; no JAX)."""
import numpy as np

from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS, ModelConfig
from cerberus_tpu_torch.models.convert import jax_params_from_state_dict
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from cerberus_tpu_torch.train.steps import head_order


def model_kwargs(arch="resnet18", **flags):
    return {"encoder_backbone_name": arch,
            "decoder_kwargs": DEFAULT_DECODER_KWARGS,
            "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()), **flags}


MODEL_KWARGS = model_kwargs()
CFG = ModelConfig.from_kwargs(MODEL_KWARGS)


def jax_layout_params(kwargs=MODEL_KWARGS, seed=0):
    """The port's seeded init (``init_weights``) as a JAX-layout tree of
    numpy arrays: weights that both packages load, made without tracing
    JAX's init."""
    import torch

    model = init_weights(NetDesc(ModelConfig.from_kwargs(kwargs)),
                         torch.Generator().manual_seed(seed))
    return jax_params_from_state_dict(model.state_dict())

LOSS_KWARGS = {
    "loss_info": {
        "Lumen-INST": {"weight": 1.5, "loss": {"ce": 1}},
        "Gland-INST": {"weight": 1.4, "loss": {"ce": 1}},
        "Nuclei-INST": {"weight": 1, "loss": {"ce": 1}},
        "Nuclei-TYPE": {"weight": 0, "loss": {"ce": 1, "dice": 1}},
        "Gland-TYPE": {"weight": 1, "loss": {"ce": 1, "dice": 1}},
        "Patch-Class": {"weight": 0.4, "loss": {"ce": 1}},
    },
}

# LOSS_KWARGS with every head weighted and the TYPE class-weight maps of
# tests/test_train_step.py, so each term of the loss moves a gradient
LOSS_KWARGS_CLASS_WEIGHTS = {
    "loss_info": dict(LOSS_KWARGS["loss_info"],
                      **{"Nuclei-TYPE": {"weight": 0.5,
                                         "loss": {"ce": 1, "dice": 1}}}),
    "class_weight": {
        "Gland-TYPE": {1: 1, 2: 1},
        "Nuclei-TYPE": {1: 12, 2: 1, 3: 2, 4: 6, 5: 12, 6: 2},
    },
}

HEAD_CHANNELS = {"Lumen-INST": 3, "Gland-INST": 3, "Nuclei-INST": 3,
                 "Nuclei-TYPE": 7, "Gland-TYPE": 3}


def make_batch(rng, n=2, hw=48, cfg=CFG):
    """``tests/_train_helpers._make_batch``: uniform random labels for every
    head, unit INST weight maps, all targets present."""
    heads = head_order(cfg)
    batch = {
        "img": rng.integers(0, 255, (n, hw, hw, 3)).astype(np.uint8),
        "has_target": np.ones((n, len(heads)), np.float32),
    }
    for head, n_cls in HEAD_CHANNELS.items():
        batch[head] = rng.integers(0, n_cls, (n, hw, hw, 1)).astype(np.int32)
        if head.endswith("-INST"):
            batch[head + "#WEIGHT-MAP"] = np.ones((n, hw, hw, 1), np.float32)
    batch["Patch-Class"] = rng.integers(0, 9, (n, 1, 1, 1)).astype(np.int32)
    return batch


# -- one train step on a device, for the card-against-CPU checks ------------

PARITY_HW, PARITY_N = 96, 4
# float64, the card against the CPU: loss scalars (relative), gradients (of
# each tensor's largest magnitude), BN running statistics (absolute x
# max(1, |value|))
PARITY_F64_TOLS = {"loss_rel": 1e-8, "grad_rel": 1e-6, "bn_rel": 1e-8}
# f32, the card against the CPU: loss scalars and BN statistics; gradients
# by their error against the float64 ones, the median tensor's on the card
# against PARITY_F32_GRAD_FACTOR x the CPU's
PARITY_LOSS_TOL, PARITY_BN_TOL = 1e-4, 1e-4
PARITY_F32_GRAD_FACTOR = 4


def parity_case(seed=0, **flags):
    """(model kwargs, state_dict, batch, keep) for ``step_on``: the 6-head
    resnet18 with seeded weights, randomised BN statistics and head logits
    tamed 0.05x; a ``make_batch`` batch at 96^2, batch 4; the Patch-Class
    dropout keep-mask drawn from a seeded generator."""
    import torch

    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
    from cerberus_tpu_torch.train.utils import tame_head_logits

    kwargs = model_kwargs(**flags)
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(NetDesc(ModelConfig.from_kwargs(kwargs)), gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.running_mean.shape
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    state = tame_head_logits(model.state_dict())
    batch = make_batch(np.random.default_rng(seed), n=PARITY_N, hw=PARITY_HW)
    keep = torch.rand((PARITY_N, 512, 1, 1), generator=gen) < 0.7
    return kwargs, state, batch, keep


def step_on(device, kwargs, state, batch, keep, loss_kwargs=None,
            opt_kwargs=None, compute_dtype=None, dtype=None, **step_kwargs):
    """One port train step on ``device`` from ``state`` -> (metrics,
    gradients, state after), all floats / CPU tensors. ``dtype``
    (``torch.float64``): the model, and so the whole step, in that
    precision."""
    import torch

    from cerberus_tpu_torch.models.net_desc import NetDesc
    from cerberus_tpu_torch.train.steps import make_train_step

    cfg = ModelConfig.from_kwargs(kwargs)
    model = NetDesc(cfg)
    model.load_state_dict(state)
    model.to(device, dtype or torch.float32)
    step = make_train_step(cfg, loss_kwargs or LOSS_KWARGS_CLASS_WEIGHTS,
                           opt_kwargs or {"lr": 1e-3},
                           compute_dtype=compute_dtype or torch.float32,
                           return_grads=True, model=model, **step_kwargs)
    metrics, grads = step(batch, keep=keep.to(device))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.cpu() for k, v in grads.items()},
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()})


def worst_errors(got, ref):
    """Worst errors of one step's results (``step_on``) against another's:
    loss scalars (relative), gradients (of each tensor's largest
    magnitude; the conv biases ahead of a batch-statistics BN, whose exact
    gradient is zero and whose computed one stays below 1e-6 of the
    largest gradient, are reported apart as ``zero_grad``, in units of
    that bound) and BN running statistics (absolute x max(1, |value|))."""
    out = {"loss_rel": max(abs(got[0][k] - v) / max(abs(v), 1e-6)
                           for k, v in ref[0].items()),
           "grad_rel": 0.0, "grad_worst": None, "zero_grad": 0.0}
    top = max(float(v.abs().max()) for v in ref[1].values())
    for name, want in ref[1].items():
        scale = float(want.abs().max())
        if scale < 1e-6 * top:
            out["zero_grad"] = max(out["zero_grad"], float(
                got[1][name].abs().max()) / (1e-6 * top))
            continue
        err = float((got[1][name].double() - want).abs().max()) / scale
        if err > out["grad_rel"]:
            out["grad_rel"], out["grad_worst"] = err, name
    out["bn_rel"] = max(float(((got[2][k].double() - v).abs()
                               / v.abs().clamp(min=1)).max())
                        for k, v in ref[2].items() if "running_" in k)
    return out


def _errors_vs(got, truth):
    """Each non-zero gradient tensor's error against ``truth``, over its
    largest magnitude."""
    top = max(float(v.abs().max()) for v in truth.values())
    return {name: float((got[name].double() - want).abs().max())
            / float(want.abs().max())
            for name, want in truth.items()
            if float(want.abs().max()) >= 1e-6 * top}


def card_parity(device, kwargs, state, batch, keep):
    """The train step on ``device`` against the CPU's, in float64 and in
    f32 (the caller turns TF32 off). Float64 must agree within
    ``PARITY_F64_TOLS``: the same function. In f32 the loss scalars and
    BN statistics must agree within 1e-4. f32 gradients are not held to a
    bound against each other: with batch statistics at random init, the
    CPU's own f32 gradients are 1.8e-3 (median tensor) to 8e-2 (worst) of
    their largest magnitude from the float64 ones at this setting. The
    card's median tensor error against float64 must stay within
    ``PARITY_F32_GRAD_FACTOR`` x the CPU's (a precision loss such as TF32
    would multiply it a thousandfold). Returns the report with ``ok``."""
    import statistics

    import torch

    runs = {(where, name): step_on(device if where == "card" else "cpu",
                                   kwargs, state, batch, keep, dtype=dtype)
            for where in ("card", "cpu")
            for name, dtype in (("f32", torch.float32),
                                ("f64", torch.float64))}
    f64 = worst_errors(runs["card", "f64"], runs["cpu", "f64"])
    f32 = worst_errors(runs["card", "f32"], runs["cpu", "f32"])
    truth = runs["cpu", "f64"][1]
    for where in ("card", "cpu"):
        errs = _errors_vs(runs[where, "f32"][1], truth)
        f32["%s_vs_f64_median" % where] = statistics.median(errs.values())
        f32["%s_vs_f64_max" % where] = max(errs.values())
    ok = (all(f64[k] <= v for k, v in PARITY_F64_TOLS.items())
          and f64["zero_grad"] <= 1 and f32["zero_grad"] <= 1
          and f32["loss_rel"] <= PARITY_LOSS_TOL
          and f32["bn_rel"] <= PARITY_BN_TOL
          and f32["card_vs_f64_median"]
          <= PARITY_F32_GRAD_FACTOR * f32["cpu_vs_f64_median"])
    return {"f64": f64, "f32": f32, "ok": ok,
            "card_f32": runs["card", "f32"]}
