"""Array geometry helpers (numpy; shape contracts identical to the reference's
``misc/utils.py:82-104,133-192`` and ``models/utils/misc_utils.py:6-25``)."""
from __future__ import annotations

import numpy as np


def get_bounding_box(img: np.ndarray):
    """Tight [rmin, rmax, cmin, cmax] box of the nonzero region; max indices
    are exclusive (+1) so slicing with them covers the object."""
    rows = np.any(img, axis=1)
    cols = np.any(img, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [rmin, rmax + 1, cmin, cmax + 1]


def cropping_center(x: np.ndarray, crop_shape, batch: bool = False) -> np.ndarray:
    """Center-crop leading-HW (or N,HW) array. The offset uses
    ``int((orig - crop) * 0.5)`` — i.e. floor for the non-negative sizes seen
    in practice — matching the reference exactly."""
    orig_shape = x.shape
    if not batch:
        h0 = int((orig_shape[0] - crop_shape[0]) * 0.5)
        w0 = int((orig_shape[1] - crop_shape[1]) * 0.5)
        return x[h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]
    h0 = int((orig_shape[1] - crop_shape[0]) * 0.5)
    w0 = int((orig_shape[2] - crop_shape[1]) * 0.5)
    return x[:, h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]


def center_pad_to_shape(img: np.ndarray, size, cval=255) -> np.ndarray:
    pad_h = size[0] - img.shape[0]
    pad_w = size[1] - img.shape[1]
    pad_h = (pad_h // 2, pad_h - pad_h // 2)
    pad_w = (pad_w // 2, pad_w - pad_w // 2)
    if len(img.shape) == 2:
        pad_shape = (pad_h, pad_w)
    else:
        pad_shape = (pad_h, pad_w, (0, 0))
    return np.pad(img, pad_shape, "constant", constant_values=cval)


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Relabel instance ids to be contiguous [1..N]; optionally order by
    descending size. Vectorized (no per-instance python loop) — the reference
    loops per id (``misc/utils.py:133-164``)."""
    pred_id = np.unique(pred)
    pred_id = pred_id[pred_id != 0]
    if len(pred_id) == 0:
        return pred
    if by_size:
        sizes = np.bincount(pred.ravel().astype(np.int64))[pred_id]
        order = np.argsort(-sizes, kind="stable")
        pred_id = pred_id[order]
    lut = np.zeros(int(pred.max()) + 1, dtype=np.int32)
    lut[pred_id] = np.arange(1, len(pred_id) + 1, dtype=np.int32)
    return lut[pred.astype(np.int64)]


def get_overlap(bb1, bb2) -> float:
    """IoU of two [rmin, rmax, cmin, cmax] boxes (reference
    ``misc/utils.py:25-75``)."""
    a = {"x1": bb1[2], "y1": bb1[0], "x2": bb1[3], "y2": bb1[1]}
    b = {"x1": bb2[2], "y1": bb2[0], "x2": bb2[3], "y2": bb2[1]}
    x_left = max(a["x1"], b["x1"])
    y_top = max(a["y1"], b["y1"])
    x_right = min(a["x2"], b["x2"])
    y_bottom = min(a["y2"], b["y2"])
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bottom - y_top)
    area_a = (a["x2"] - a["x1"]) * (a["y2"] - a["y1"])
    area_b = (b["x2"] - b["x1"]) * (b["y2"] - b["y1"])
    return inter / float(area_a + area_b - inter)


def pairwise_iou(true: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """(n_true, n_pred) IoU matrix between two instance label maps.

    The eval-side pairwise-IoU machinery the reference exposes around
    ``get_overlap`` (misc/utils.py:25-75) generalized to instance masks: one
    joint bincount over the flattened pair instead of per-pair mask loops.
    Labels are assumed 1..N (use ``remap_label`` first); background 0 is
    excluded. Standard matcher input for dice/PQ-style instance metrics.
    """
    true = np.asarray(true).astype(np.int64).ravel()
    pred = np.asarray(pred).astype(np.int64).ravel()
    n_true = int(true.max())
    n_pred = int(pred.max())
    if n_true == 0 or n_pred == 0:
        return np.zeros((n_true, n_pred), np.float64)
    inter = np.bincount(true * (n_pred + 1) + pred,
                        minlength=(n_true + 1) * (n_pred + 1))
    inter = inter.reshape(n_true + 1, n_pred + 1).astype(np.float64)
    area_t = inter.sum(1, keepdims=True)  # true areas incl. bg column
    area_p = inter.sum(0, keepdims=True)
    inter = inter[1:, 1:]
    union = area_t[1:] + area_p[:, 1:] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def match_instances(true: np.ndarray, pred: np.ndarray,
                    iou_thresh: float = 0.5):
    """Greedy IoU matching: returns (pairs [(true_id, pred_id, iou)],
    unmatched_true_ids, unmatched_pred_ids). With iou_thresh >= 0.5 the
    greedy matching is provably optimal (IoU>0.5 pairs are unique)."""
    iou = pairwise_iou(true, pred)
    pairs = []
    used_t, used_p = set(), set()
    order = np.argsort(iou, axis=None)[::-1]
    for flat in order:
        ti, pi = np.unravel_index(flat, iou.shape)
        if iou[ti, pi] < iou_thresh:
            break
        if ti in used_t or pi in used_p:
            continue
        pairs.append((int(ti) + 1, int(pi) + 1, float(iou[ti, pi])))
        used_t.add(ti)
        used_p.add(pi)
    un_t = [t + 1 for t in range(iou.shape[0]) if t not in used_t]
    un_p = [p + 1 for p in range(iou.shape[1]) if p not in used_p]
    return pairs, un_t, un_p
