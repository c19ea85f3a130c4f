"""Training-step visualization.

Parity target: ``viz_step_output`` (models/run_desc.py:233-329) — build a
grid image of (input, per-head true, per-head pred) rows for a couple of
samples, colorized per head type. A copy of ``cerberus_tpu/train/viz.py``.
"""
from __future__ import annotations

import numpy as np

from ..utils.viz import colorize


def viz_step_output(raw_output, n_classes_by_head=None) -> np.ndarray:
    """raw_output: {"img": (N,H,W,3) uint8, "true": {head: (N,...)},
    "pred": {head: (N,...)}} -> one HWC uint8 canvas."""
    imgs = np.asarray(raw_output["img"])
    true_dict = raw_output.get("true", {})
    pred_dict = raw_output.get("pred", {})
    n = imgs.shape[0]
    hw = imgs.shape[1:3]

    rows = []
    for i in range(n):
        cols = [imgs[i]]
        for head in sorted(set(true_dict) | set(pred_dict)):
            n_cls = (n_classes_by_head or {}).get(head, None)
            for source in (true_dict, pred_dict):
                if head not in source:
                    continue
                arr = np.asarray(source[head])[i]
                arr = np.squeeze(arr).astype(np.float32)
                if arr.ndim == 0:  # patch-class scalar -> constant map
                    arr = np.full(hw, float(arr))
                if arr.ndim == 3:  # probability channels -> argmax
                    arr = arr.argmax(-1)
                vmax = float(n_cls - 1) if n_cls else max(float(arr.max()), 1.0)
                if arr.shape != tuple(hw):
                    import cv2

                    arr = cv2.resize(arr, (hw[1], hw[0]),
                                     interpolation=cv2.INTER_NEAREST)
                cols.append(colorize(arr, 0, vmax))
        rows.append(np.concatenate(cols, axis=1))
    width = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)))
            for r in rows]
    return np.concatenate(rows, axis=0)
