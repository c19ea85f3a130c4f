"""Engine callbacks.

Behavioral spec: ``run_utils/callbacks/base.py`` and ``logging.py`` —
TrackLr (:25-38), ScheduleLr (:41-51), TriggerEngine (:54-82), PeriodicSaver
(:85-129), ConditionalSaver (:132-180, including fixing its missing ``json``
import — SURVEY.md §7 bug list), AccumulateRawOutput (:183-188),
ScalarMovingAverage EMA alpha 0.95 (:191-217), ProcessAccumulatedEpochOutput
(:220-235), VisualizeOutput (:238-277), LoggingOutput (logging.py:78-173:
console scalars + YAML stats file read-modify-write; tensorboard gated).

Counterpart of ``cerberus_tpu/train/callbacks.py``: the same callbacks,
console lines and stats-file keys. Checkpoints are the JAX package's
native msgpack trees (``models/convert.py``), saved as
``<log_dir>/<net_name>_step-NNNNNN.tar`` to keep the reference's filename
contract (loadable back through ``load_checkpoint``, and by the JAX
package). PyYAML is imported where the stats file is read or written.
"""
from __future__ import annotations

import json
import operator
import os
from typing import Callable

import numpy as np

from ..models.convert import jax_params_from_state_dict, save_native_checkpoint


def _read_stats(stat_file: str) -> dict:
    with open(stat_file) as handle:
        if stat_file.endswith(".json"):
            return json.load(handle) or {}
        import yaml

        return yaml.safe_load(handle) or {}


class BaseCallbacks:
    def __init__(self):
        self.engine_trigger = False

    def reset(self):
        pass

    def run(self, state, event):
        pass


def _period_gate(obj, global_state) -> bool:
    """Shared per-N-epoch / per-N-step gating logic."""
    if obj.per_n_epoch is not None:
        if global_state.curr_epoch % obj.per_n_epoch != 0:
            return False
    if obj.per_n_step is not None:
        if (global_state.curr_global_step % obj.per_n_step != 0
                or global_state.curr_global_step == 0):
            return False
    return True


class TrackLr(BaseCallbacks):
    def __init__(self, per_n_epoch=1, per_n_step=None):
        super().__init__()
        self.per_n_epoch = per_n_epoch
        self.per_n_step = per_n_step

    def run(self, state, event):
        for net_name, net in state.run_info.items():
            state.tracked_step_output["scalar"]["lr-%s" % net_name] = net.lr


class ScheduleLr(BaseCallbacks):
    """No-op by design: the train step sets the scheduled LR before each
    update (train/steps.make_lr_schedule). Kept so config graphs mirroring
    the reference (models/opt.py:98) stay valid."""

    def run(self, state, event):
        return


class TriggerEngine(BaseCallbacks):
    def __init__(self, triggered_engine_name, nr_epoch=1, per_n_epoch=1,
                 per_n_step=None):
        super().__init__()
        assert (per_n_epoch is None) != (per_n_step is None)
        self.per_n_step = per_n_step
        self.per_n_epoch = per_n_epoch
        self.nr_epoch = nr_epoch
        self.engine_trigger = True
        self.triggered_engine_name = triggered_engine_name
        self.triggered_engine = None

    def run(self, state, event):
        if not _period_gate(self, state.get_top_parent_state()):
            return
        self.triggered_engine.run(chained=True, nr_epoch=self.nr_epoch,
                                  shared_state=state)


class PeriodicSaver(BaseCallbacks):
    def __init__(self, per_n_epoch=1, per_n_step=None):
        super().__init__()
        assert (per_n_epoch is None) != (per_n_step is None)
        self.per_n_step = per_n_step
        self.per_n_epoch = per_n_epoch

    def run(self, state, event):
        global_state = state.get_top_parent_state()
        if not global_state.logging:
            return
        if not _period_gate(self, global_state):
            return
        # step filenames use the engine counter (reference naming cadence);
        # build_trainer seeds curr_global_step from the restored step on
        # --resume so post-resume checkpoints never overwrite earlier ones
        tracker = ("epoch-%06d" % global_state.curr_epoch
                   if self.per_n_epoch is not None
                   else "step-%06d" % global_state.curr_global_step)
        for net_name, net in state.run_info.items():
            # full payload like the reference ({desc, optimizer, scheduler},
            # run_utils/callbacks/base.py:122-128); still loadable as a
            # params-only checkpoint through load_checkpoint. The step
            # loop pays the host snapshot; encoding and the write overlap
            # the following steps (RunEngine.run flushes before returning)
            net.writer.submit("%s/%s_%s.tar" % (state.log_dir, net_name,
                                                tracker),
                              *net.train_step.jax_train_state())


class ConditionalSaver(BaseCallbacks):
    """Best-metric checkpointing against the run's stats file."""

    def __init__(self, metric_name, comparator=">="):
        super().__init__()
        self.metric_name = metric_name
        self.comparator = comparator
        # best value actually SAVED this run: with per-step validation the
        # stats file holds one value per epoch key, so a later (worse)
        # flush inside the same epoch would otherwise overwrite a better
        # checkpoint saved earlier in that epoch
        self._saved_best = None

    def run(self, state, event):
        if not state.logging:
            return
        ops = {">": operator.gt, "<": operator.lt,
               ">=": operator.ge, "<=": operator.le}
        op_func = ops[self.comparator]
        best = -float("inf") if self.comparator in (">", ">=") else float("inf")

        log_info = state.log_info or {}
        stat_file = log_info.get("json_file") or log_info.get("yaml_file")
        if not stat_file or not os.path.exists(stat_file):
            return
        stats = _read_stats(stat_file)
        epoch_key = str(state.get_top_parent_state().curr_epoch)
        if epoch_key not in stats or self.metric_name not in stats[epoch_key]:
            return
        # best over PRIOR epochs only — including the current epoch would
        # make strict comparators ('>'/'<') unsatisfiable (current > best
        # where best already includes current is impossible)
        for epoch, epoch_stat in stats.items():
            if str(epoch) == epoch_key:
                continue
            if self.metric_name in epoch_stat and \
                    op_func(epoch_stat[self.metric_name], best):
                best = epoch_stat[self.metric_name]
        current = stats[epoch_key][self.metric_name]
        if self._saved_best is not None and \
                op_func(self._saved_best, best):
            best = self._saved_best
        if not op_func(current, best):
            return
        self._saved_best = current
        for net_name, net in state.run_info.items():
            save_native_checkpoint(
                "%s/%s_best=[%s].tar" % (state.log_dir, net_name,
                                         self.metric_name),
                jax_params_from_state_dict(net.model.state_dict()),
                step=net.step)


class AccumulateRawOutput(BaseCallbacks):
    def run(self, state, event):
        state.epoch_accumulated_output.append(state.step_output["raw"])


class ScalarMovingAverage(BaseCallbacks):
    def __init__(self, alpha=0.95):
        super().__init__()
        self.alpha = alpha
        self.tracking_dict = {}

    def run(self, state, event):
        for key, value in state.step_output["EMA"].items():
            value = float(value)
            if key in self.tracking_dict:
                self.tracking_dict[key] = (self.tracking_dict[key] * self.alpha
                                           + (1.0 - self.alpha) * value)
            else:
                self.tracking_dict[key] = value
        state.tracked_step_output["scalar"] = dict(self.tracking_dict)


class ProcessAccumulatedEpochOutput(BaseCallbacks):
    def __init__(self, proc_func: Callable, per_n_epoch=1):
        super().__init__()
        self.per_n_epoch = per_n_epoch
        self.proc_func = proc_func

    def run(self, state, event):
        state.tracked_step_output = self.proc_func(
            state.loader_name, state.epoch_accumulated_output)


class VisualizeOutput(BaseCallbacks):
    def __init__(self, proc_func: Callable, per_n_epoch=1, per_n_step=None):
        super().__init__()
        assert (per_n_epoch is None) != (per_n_step is None)
        self.per_n_epoch = per_n_epoch
        self.per_n_step = per_n_step
        self.proc_func = proc_func

    def run(self, state, event):
        if not _period_gate(self, state.get_top_parent_state()):
            return
        viz_image = self.proc_func(state.step_output["raw"])
        if viz_image is not None:
            state.tracked_step_output["image"]["output"] = viz_image


class LoggingGradient(BaseCallbacks):
    """Sampled gradient/parameter histograms -> tensorboard (reference
    run_utils/callbacks/logging.py:16-75; 5% step sampling). Expects the
    step_output to carry the step's ``grads`` ({parameter name: tensor},
    from ``make_train_step(..., return_grads=True)``); histograms are
    named by the JAX tree's keys (``grad/<module>.<kernel|scale|bias>``)."""

    def __init__(self, sample_rate: float = 0.05, seed: int = 0):
        super().__init__()
        self.sample_rate = sample_rate
        self._rng = np.random.default_rng(seed)

    def run(self, state, event):
        if self._rng.random() > self.sample_rate:
            return
        tfwriter = (state.log_info or {}).get("tfwriter")
        grads = (state.step_output or {}).get("grads")
        if tfwriter is None or grads is None:
            return
        step = state.get_top_parent_state().curr_global_step
        trees = (("grad", jax_params_from_state_dict(grads)),
                 ("param", jax_params_from_state_dict(
                     state.run_info["net"].model.state_dict())))
        for kind, tree in trees:
            for name, leaf in tree.items():
                for key, value in leaf.items():
                    tfwriter.add_histogram(f"{kind}/{name}.{key}",
                                           np.asarray(value), step)


class LoggingOutput(BaseCallbacks):
    """Console + YAML stats file (+ tensorboard when a writer is supplied).

    The YAML file is read-modify-written per flush keyed by epoch, like the
    reference (run_utils/callbacks/logging.py:112-172)."""

    def __init__(self, per_n_epoch=1, per_n_step=None):
        super().__init__()
        assert (per_n_epoch is None) != (per_n_step is None)
        self.per_n_epoch = per_n_epoch
        self.per_n_step = per_n_step

    def run(self, state, event):
        import logging as _logging

        global_state = state.get_top_parent_state()
        if not _period_gate(self, global_state):
            return
        scalars = {k: float(v)
                   for k, v in state.tracked_step_output["scalar"].items()}
        prefix = state.loader_name or state.attached_engine_name
        _logging.info("[%s][step %d] %s", prefix,
                      global_state.curr_global_step,
                      " ".join(f"{k}={v:.5f}" for k, v in scalars.items()))

        log_info = state.log_info or {}
        stat_file = log_info.get("yaml_file") or log_info.get("json_file")
        if state.logging and stat_file:
            stats = _read_stats(stat_file) if os.path.exists(stat_file) else {}
            epoch_key = str(global_state.curr_epoch)
            epoch_stats = stats.get(epoch_key, {})
            epoch_stats.update({f"{prefix}-{k}": v for k, v in scalars.items()})
            stats[epoch_key] = epoch_stats
            with open(stat_file, "w") as handle:
                if stat_file.endswith(".json"):
                    json.dump(stats, handle)
                else:
                    import yaml

                    yaml.safe_dump(stats, handle)

        tfwriter = (state.log_info or {}).get("tfwriter")
        if tfwriter is not None:
            for key, value in scalars.items():
                tfwriter.add_scalar(f"{prefix}-{key}", value,
                                    global_state.curr_global_step)
            for key, img in state.tracked_step_output["image"].items():
                tfwriter.add_image(f"{prefix}-{key}", np.asarray(img),
                                   global_state.curr_global_step,
                                   dataformats="HWC")
