"""Validation metric accumulation.

Behavioral spec: ``ProcStepRawOutput`` + ``proc_cum_epoch_step_output``
(``models/run_desc.py:505-747``) — accumulate per-class pixel statistics
(intersection / denominators for dice, correct / total for accuracy) across
an epoch, honoring dummy-target flags, then emit scalars per head.

Accumulation is a handful of bincounts per batch instead of the reference's
per-class python loops. A copy of ``cerberus_tpu/train/metrics.py``
(numpy on the host).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class StepStatsAccumulator:
    """Accumulates {head: per-class [intersection, pred_count, true_count,
    correct, total]} over validation batches."""

    def __init__(self, head_channels: Dict[str, int]):
        self.head_channels = dict(head_channels)
        self.reset()

    def reset(self):
        self.stats = {
            head: np.zeros((5, n_cls), np.int64)
            for head, n_cls in self.head_channels.items()
        }

    def update(self, true_dict: Dict[str, np.ndarray],
               pred_label_dict: Dict[str, np.ndarray],
               has_target: np.ndarray, head_order) -> None:
        """true/pred: per-head integer label arrays (N, ...); has_target:
        (N, n_heads) mask in ``head_order``."""
        for h_idx, head in enumerate(head_order):
            if head not in true_dict or head not in pred_label_dict:
                continue
            n_cls = self.head_channels[head]
            flag = np.asarray(has_target[:, h_idx]) > 0
            if not flag.any():
                continue
            true = np.asarray(true_dict[head])[flag].astype(np.int64).ravel()
            pred = np.asarray(pred_label_dict[head])[flag].astype(np.int64).ravel()
            joint = np.bincount(true * n_cls + pred,
                                minlength=n_cls * n_cls).reshape(n_cls, n_cls)
            stats = self.stats[head]
            stats[0] += np.diag(joint)              # intersection per class
            stats[1] += joint.sum(axis=0)           # predicted count
            stats[2] += joint.sum(axis=1)           # true count
            stats[3] += np.diag(joint).sum()        # correct (same for all)
            stats[4] += joint.sum()                 # total

    def compute(self) -> Dict[str, float]:
        out = {}
        for head, stats in self.stats.items():
            inter, pred_n, true_n, correct, total = stats
            if total.max() == 0:
                continue
            out[f"{head}-acc"] = float(correct[0]) / float(total[0])
            n_cls = stats.shape[1]
            for cls in range(1, n_cls):  # foreground classes
                denom = pred_n[cls] + true_n[cls]
                if true_n[cls] > 0:
                    out[f"{head}-dice-{cls}"] = float(
                        2.0 * inter[cls] / max(denom, 1))
        return out


class ProcStepRawOutput:
    """Engine callback: accumulate raw valid_step outputs per batch
    (the ``ProcStepRawOutput`` callback, models/run_desc.py:606-747)."""

    engine_trigger = False

    def __init__(self, head_channels: Dict[str, int], head_order):
        self.acc = StepStatsAccumulator(head_channels)
        self.head_order = list(head_order)

    def reset(self):
        self.acc.reset()

    def run(self, state, event):
        raw = state.step_output["raw"]
        self.acc.update(raw["true"], raw["pred"], raw["dummy"],
                        self.head_order)
        state.epoch_accumulated_output.append(1)  # count batches

    def proc_cum_epoch(self, _loader_name, _raw_data):
        track = {"scalar": self.acc.compute(), "image": {}}
        self.acc.reset()
        return track
