"""Training configuration factory and the runnable trainer.

Counterpart of ``cerberus_tpu/train/opt.py`` (reference ``models/opt.py``):
a single-phase config (Adam lr 1e-3, betas (0.9, 0.999), StepLR(75000),
140 epochs), and the engine graph: a ``train`` engine whose STEP_COMPLETED
callbacks are [ScalarMovingAverage, TrackLr, PeriodicSaver, LoggingOutput,
TriggerEngine('infer'), ScheduleLr] and an ``infer`` engine accumulating
validation statistics into epoch metrics (``cerberus_tpu/train/opt.py:
205-240``). ``run_training`` runs the phases in order (``pretrained: -1``
carries the previous phase's weights; one log directory per phase).

The model is the port's ``NetDesc`` on one device (``cuda`` unless the
caller or ``CERBERUS_DEFAULT_DEVICE`` says otherwise). Not ported: the
mesh (data-parallel) path, ROADMAP queue 1 item 7; the width-paired
lowerings (``paired``), item 9; DSF-CNN encoders, item 6. Each raises
``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..infer.manager import resolve_device
from ..models.convert import load_checkpoint, load_train_state, \
    overlay_pretrained
from ..models.net_desc import NetDesc, head_output_channels, init_weights
from ..utils.profiling import trace_span
from .callbacks import (
    ConditionalSaver,
    LoggingOutput,
    PeriodicSaver,
    ProcessAccumulatedEpochOutput,
    ScalarMovingAverage,
    ScheduleLr,
    TrackLr,
    TriggerEngine,
)
from .engine import Events, NetHolder, RunEngine
from .metrics import ProcStepRawOutput
from .steps import head_order, make_train_step, make_valid_step

PER_N_STEPS = 2000  # mtl cadence (models/opt.py:23)


def get_config(model_kwargs: Dict, loss_kwargs: Dict,
               optimizer_kwargs: Optional[Dict] = None,
               nr_epochs: int = 140, per_n_steps: int = PER_N_STEPS) -> Dict:
    """Single-phase training config (the reference's phase_list schema)."""
    return {
        "phase_list": [{
            "run_info": {
                "net": {
                    "model_kwargs": model_kwargs,
                    "optimizer_kwargs": optimizer_kwargs or
                        {"lr": 1.0e-3, "betas": (0.9, 0.999)},
                    "lr_decay_steps": 75000,
                    "extra_info": {"loss": loss_kwargs},
                    "pretrained": None,
                },
            },
            "nr_epochs": nr_epochs,
        }],
        "per_n_steps": per_n_steps,
    }


def check_supported(cfg: ModelConfig, mesh=None, paired: bool = False
                    ) -> None:
    """Raise ``NotImplementedError`` for what the port does not train yet,
    naming its ROADMAP queue 1 item."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP queue 1 "
            "item 7, multi-GPU)")
    if paired:
        raise NotImplementedError(
            "--paired is not ported (ROADMAP queue 1 item 9, the TPU-only "
            "paired lowerings)")
    if cfg.encoder_backbone_name.startswith("dsf"):
        raise NotImplementedError(
            "%s is not ported yet (ROADMAP queue 1 item 6, DSF-CNN)"
            % cfg.encoder_backbone_name)


def build_trainer(config: Dict, train_loaders: Dict, valid_loaders: Dict,
                  log_dir: Optional[str] = None, seed: int = 0,
                  pretrained_params: Optional[Dict] = None,
                  best_metric: Optional[str] = None, mesh=None, remat=False,
                  compute_dtype=None, grad_accum: int = 1,
                  paired: bool = False, device=None):
    """Chained train/infer engines for phase 0 -> (train_engine,
    infer_engine, net_holder).

    ``pretrained_params``: a (possibly partial) NetDesc state_dict laid
    over the seeded fresh init; ``remat``, ``grad_accum`` and
    ``compute_dtype`` (``torch.bfloat16``: autocast over f32 masters) go
    to ``make_train_step``. A ``resume_from`` entry in the phase's net
    config restores a train state (weights, Adam moments, update count)
    and the engine's step counter."""
    phase = config["phase_list"][0]
    net_cfg = phase["run_info"]["net"]
    cfg = ModelConfig.from_kwargs(net_cfg["model_kwargs"])
    check_supported(cfg, mesh, paired)
    device = resolve_device(device)
    loss_kwargs = net_cfg["extra_info"]["loss"]
    per_n = config.get("per_n_steps", PER_N_STEPS)
    dtype = compute_dtype if compute_dtype is not None else torch.float32

    model = init_weights(NetDesc(cfg), torch.Generator().manual_seed(seed))
    if pretrained_params is not None:
        model.load_state_dict(overlay_pretrained(model.state_dict(),
                                                 pretrained_params),
                              strict=True)
    model.to(device)
    opt_kwargs = dict(net_cfg["optimizer_kwargs"],
                      lr_decay_steps=int(net_cfg.get("lr_decay_steps",
                                                     75000)))
    train_step = make_train_step(cfg, loss_kwargs, opt_kwargs,
                                 compute_dtype=dtype, remat=remat,
                                 grad_accum=grad_accum, model=model)
    resume_from = net_cfg.get("resume_from")
    if resume_from:
        train_step.load_jax_train_state(*load_train_state(resume_from))
    net = NetHolder(train_step,
                    generator=torch.Generator(device=device).manual_seed(
                        seed + 1),
                    cfg=cfg, extra_info=net_cfg["extra_info"])
    valid_step = make_valid_step(model, compute_dtype=dtype)
    heads = head_order(cfg)
    n_ch = head_output_channels(cfg)

    def train_run_step(batch, step_run_info):
        run_info, _ = step_run_info
        holder = run_info["net"]
        with trace_span("train_step"):
            metrics = holder.train_step(batch, generator=holder.generator)
            ema = {k: float(v) for k, v in metrics.items()}
        return {"EMA": ema, "raw": {"img": batch["img"][:2]}}

    def valid_run_step(batch, step_run_info):
        act = valid_step(batch["img"])
        pred_labels, true_labels = {}, {}
        for head in heads:
            if head not in batch:
                continue
            out = act[head].cpu().numpy()
            if head == "Patch-Class":
                pred_labels[head] = out
                true_labels[head] = np.asarray(batch[head]).reshape(-1)
            elif head.endswith("-INST"):
                # fg prob -> class map: argmax over [bg=1-sum(fg), fg...]
                bg = 1.0 - out.sum(-1, keepdims=True)
                pred_labels[head] = np.argmax(
                    np.concatenate([bg, out], -1), -1)
                true_labels[head] = np.asarray(batch[head])[..., 0]
            else:
                pred_labels[head] = np.argmax(out, -1)
                true_labels[head] = np.asarray(batch[head])[..., 0]
        return {"raw": {"pred": pred_labels, "true": true_labels,
                        "dummy": batch["has_target"]}}

    run_info = {"net": net}
    train_engine = RunEngine("train", train_loaders, train_run_step, run_info)
    infer_engine = RunEngine("infer", valid_loaders, valid_run_step, run_info)
    if resume_from:
        # logging cadence and checkpoint names continue from the restored
        # update count
        train_engine.state.curr_global_step = train_step.count

    proc = ProcStepRawOutput(n_ch, heads)
    infer_engine.add_event_handler(Events.STEP_COMPLETED, proc)
    infer_engine.add_event_handler(
        Events.EPOCH_COMPLETED,
        ProcessAccumulatedEpochOutput(proc.proc_cum_epoch))
    infer_engine.add_event_handler(
        Events.EPOCH_COMPLETED, LoggingOutput(per_n_epoch=1))

    train_engine.add_event_handler(Events.STEP_COMPLETED,
                                   ScalarMovingAverage(alpha=0.95))
    train_engine.add_event_handler(Events.STEP_COMPLETED, TrackLr())
    if log_dir is not None:
        train_engine.state.logging = True
        train_engine.state.log_dir = log_dir
        train_engine.state.log_info = {"yaml_file": f"{log_dir}/stats.yml"}
        infer_engine.state.logging = True
        infer_engine.state.log_dir = log_dir
        infer_engine.state.log_info = train_engine.state.log_info
        train_engine.add_event_handler(
            Events.STEP_COMPLETED,
            PeriodicSaver(per_n_epoch=None, per_n_step=per_n))
        train_engine.add_event_handler(
            Events.STEP_COMPLETED,
            LoggingOutput(per_n_epoch=None, per_n_step=per_n))
    trigger = TriggerEngine("infer", per_n_epoch=None, per_n_step=per_n)
    trigger.triggered_engine = infer_engine
    train_engine.add_event_handler(Events.STEP_COMPLETED, trigger)
    train_engine.add_event_handler(Events.STEP_COMPLETED, ScheduleLr())
    if best_metric is not None and log_dir is not None:
        # fires after the epoch's LoggingOutput has flushed stats.yml;
        # metric names are the flushed keys, e.g. "valid-Gland-INST-dice-1"
        infer_engine.add_event_handler(Events.EPOCH_COMPLETED,
                                       ConditionalSaver(best_metric))
    return train_engine, infer_engine, net


def run_training(config: Dict, train_loaders: Dict, valid_loaders: Dict,
                 log_dir: Optional[str] = None, seed: int = 0,
                 pretrained_params=None, best_metric=None, mesh=None,
                 remat=False, compute_dtype=None, grad_accum: int = 1,
                 paired: bool = False, device=None) -> NetHolder:
    """Run every phase of ``config["phase_list"]`` in order.

    ``pretrained: -1`` (the default after phase 0) carries the previous
    phase's weights, ``None`` starts from scratch, a string loads that
    checkpoint. With more than one phase each logs and checkpoints under
    ``<log_dir>/<idx>``. Returns the last phase's net holder, whose
    ``timing`` sums every phase's loader wait, step and wall seconds."""
    phases = config["phase_list"]
    carry = pretrained_params
    net = None
    timing = {"loader_wait_s": 0.0, "step_s": 0.0, "wall_s": 0.0}
    for idx, phase in enumerate(phases):
        spec = phase["run_info"]["net"].get("pretrained", -1 if idx else None)
        if isinstance(spec, str):  # explicit checkpoint path
            pre = load_checkpoint(spec)
        else:
            pre = carry if (idx == 0 or spec == -1) else None
        phase_dir = (log_dir if len(phases) == 1 or log_dir is None
                     else os.path.join(log_dir, "%02d" % idx))
        if phase_dir and not os.path.isdir(phase_dir):
            os.makedirs(phase_dir, exist_ok=True)
        train_engine, _infer_engine, net = build_trainer(
            dict(config, phase_list=[phase]), train_loaders, valid_loaders,
            phase_dir, seed, pre, best_metric=best_metric, mesh=mesh,
            remat=remat, compute_dtype=compute_dtype, grad_accum=grad_accum,
            paired=paired, device=device)
        start = time.perf_counter()
        try:
            train_engine.run(nr_epoch=phase["nr_epochs"])
        finally:
            # an exception mid-run must not orphan scheduled checkpoint
            # writes, and a failed write must not mask that exception
            unwinding = sys.exc_info()[0] is not None
            try:
                net.writer.flush()
            except Exception:  # noqa: BLE001 — logged, the original raises
                if not unwinding:
                    raise
                logging.exception("checkpoint flush failed while "
                                  "unwinding")
        timing["wall_s"] += time.perf_counter() - start
        timing["loader_wait_s"] += train_engine.state.wait_seconds
        timing["step_s"] += train_engine.state.step_seconds
        carry = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}
    net.timing = timing
    return net
