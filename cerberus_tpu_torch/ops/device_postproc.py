"""Instance post-processing primitives on torch tensors, on the device.

Counterpart of ``cerberus_tpu/ops/lax_postproc.py``, with the same
contracts so label maps are byte-equal:

  * ``connected_components``: 4-connected, id = min flat index + 1
    (``cc_label`` kernel);
  * ``remove_small_objects``: compaction by root-rank cumsum, sizes from
    the ``hist16384`` kernel when there are fewer than 16384 components
    (told that only bins 0..n are live)
    (``torch.bincount`` over the flat-index id space otherwise); returns
    COMPACTED ids;
  * ``fill_holes`` / ``fill_label_holes``: one ring-padded background
    labelling; the contested multi-instance path floods with the
    watershed kernel's propagate entry;
  * ``watershed`` (``watershed`` kernel), ``dilate_labels`` (max over the
    elliptical SE, even-ksize anchor kept), cv2-compatible
    ``binary_erode``.

Every function takes an ``impl`` (``KERNELS`` by default): the kernel
wrappers, which run the CUDA kernels on CUDA tensors and their plain
versions on CPU tensors. ``PLAIN`` forces the plain versions everywhere,
so the two can be held against each other on the card. ``Impl.stats`` is
the per-instance table (``inst_stats``) behind the tile engine's records.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cc_label, hist16384, inst_stats, watershed as ws

N_LEVELS = ws.N_LEVELS
HIST_CAP = hist16384.N_BINS


class Impl(NamedTuple):
    cc: Callable
    hist: Callable
    watershed: Callable
    propagate: Callable
    stats: Callable


KERNELS = Impl(cc_label.connected_components, hist16384.hist16384,
               ws.watershed, ws.propagate_labels, inst_stats.inst_stats)
PLAIN = Impl(cc_label.connected_components_plain, hist16384.hist16384_plain,
             ws.watershed_plain, ws.propagate_labels_plain,
             inst_stats.inst_stats_plain)


def disk_kernel(ksize: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))`` as f32, by
    OpenCV's own construction (row half-widths rounded half to even)."""
    k = int(ksize)
    se = np.zeros((k, k), np.float32)
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            se[i, max(c - dx, 0):min(c + dx + 1, k)] = 1.0
    return se


def _se_offsets(se: np.ndarray):
    anchor = np.array([se.shape[0] // 2, se.shape[1] // 2])
    return [tuple(int(v) for v in off)
            for off in (np.argwhere(np.asarray(se) > 0) - anchor)]


def binary_erode(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2-compatible erosion: out-of-image neighbours count as foreground."""
    offs = _se_offsets(se)
    r = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    h, w = x.shape
    xp = F.pad(x.to(torch.uint8)[None], (r, r, r, r), value=1)[0].bool()
    out = torch.ones_like(x, dtype=torch.bool)
    for dy, dx in offs:
        out &= xp[r + dy:r + dy + h, r + dx:r + dx + w]
    return out


def dilate_labels(lab: torch.Tensor, ksize: int) -> torch.Tensor:
    """Grayscale max-dilation by the elliptical SE (cv2.dilate anchor
    ``k // 2``, kept for even ``ksize``); out-of-image reads are 0."""
    if ksize <= 0:
        return lab
    se = disk_kernel(ksize)
    offs = np.array([se.shape[0] // 2, se.shape[1] // 2]) - np.argwhere(se > 0)
    r = int(np.abs(offs).max())
    h, w = lab.shape
    lp = F.pad(lab[None], (r, r, r, r), value=0)[0]
    out = lab
    for dy, dx in offs:
        dy, dx = int(dy), int(dx)
        out = torch.maximum(out, lp[r - dy:r - dy + h, r - dx:r - dx + w])
    return out


def _neighbor_max(lab: torch.Tensor) -> torch.Tensor:
    p = F.pad(lab[None], (1, 1, 1, 1), value=0)[0]
    return torch.maximum(torch.maximum(p[:-2, 1:-1], p[2:, 1:-1]),
                         torch.maximum(p[1:-1, :-2], p[1:-1, 2:]))


def connected_components(mask: torch.Tensor, impl: Impl = KERNELS
                         ) -> torch.Tensor:
    return impl.cc(mask.contiguous())


def compact_labels(lab: torch.Tensor):
    """Scatter-free compaction of min-flat-index labels: a component's
    root is the pixel at flat index ``id - 1``, a raster cumsum of the root
    indicator ranks roots 1..n, and one gather relabels every pixel.
    Returns (compact int32 labels, n)."""
    h, w = lab.shape
    flat = lab.reshape(-1)
    idx1 = torch.arange(1, h * w + 1, dtype=torch.int32, device=lab.device)
    rank = torch.cumsum((flat == idx1).to(torch.int32), 0, dtype=torch.int32)
    n = int(rank[-1]) if rank.numel() else 0
    root_rank = rank[(flat - 1).clamp(0, h * w - 1).long()]
    lab_k = torch.where(flat > 0, root_rank, torch.zeros_like(root_rank))
    return lab_k.view(h, w), n


def remove_small_objects(lab: torch.Tensor, min_size: int,
                         impl: Impl = KERNELS) -> torch.Tensor:
    """Zero components with fewer than ``min_size`` pixels; returns
    COMPACTED ids (1..n in raster order of component roots)."""
    h, w = lab.shape
    lab_k, n = compact_labels(lab)
    zero = torch.zeros_like(lab_k)
    if n < HIST_CAP:
        keep = impl.hist(lab_k, n + 1) >= min_size  # ids are 0..n
        keep[0] = False
        return torch.where(keep[lab_k.clamp(0, HIST_CAP - 1).long()], lab_k,
                           zero)
    sizes = torch.bincount(lab.reshape(-1).long(), minlength=h * w + 1)
    keep = sizes >= min_size
    keep[0] = False
    return torch.where(keep[lab.long()], lab_k, zero)


def _ring_bg_cc(is_bg: torch.Tensor, impl: Impl) -> torch.Tensor:
    """Labels of the background padded with a 1 px background ring: every
    border-touching background component merges into the ring's
    component, whose id is exactly 1. Returns the (h+2, w+2) plane."""
    padded = F.pad(is_bg.to(torch.uint8)[None], (1, 1, 1, 1), value=1)[0]
    return impl.cc(padded.bool())


def fill_holes(mask: torch.Tensor, impl: Impl = KERNELS) -> torch.Tensor:
    """Binary fill: holes are background components not touching the
    border."""
    mask = mask.bool()
    bg_lab = _ring_bg_cc(~mask, impl)[1:-1, 1:-1]
    return mask | (~mask & (bg_lab != 1))


def fill_label_holes(lab: torch.Tensor, impl: Impl = KERNELS) -> torch.Tensor:
    """Fill background enclosed by instances. A hole bounded by exactly one
    instance adopts it through one gather at the pixel above the hole's
    root (which is always a pixel of the enclosing instance); when any hole
    touches two or more instances, a synchronous flood (min id wins the
    meeting line) partitions the holes instead — as
    ``lax_postproc.fill_label_holes``."""
    h, w = lab.shape
    big = h * w + 2
    is_bg = lab == 0
    bg_lab = _ring_bg_cc(is_bg, impl)[1:-1, 1:-1]
    holes = is_bg & (bg_lab != 1)
    wp = w + 2
    lab_pad_flat = F.pad(lab[None], (1, 1, 1, 1), value=0)[0].reshape(-1)
    above_root = (bg_lab - 1 - wp).clamp(0, (h + 2) * wp - 1).long()
    zero = torch.zeros_like(lab)
    fill = torch.where(holes, lab_pad_flat[above_root], zero)
    fg = lab > 0
    nbr_min = cc_label.neighbor_min(
        torch.where(fg, lab, torch.full_like(lab, big)), big)
    nbr_max = _neighbor_max(torch.where(fg, lab, zero))
    contested = bool((holes & (((nbr_max > 0) & (nbr_max != fill))
                               | ((nbr_min < big) & (nbr_min != fill)))).any())
    if contested:
        return impl.propagate(lab.contiguous(), (holes | fg).contiguous())
    return torch.where(holes, fill, lab)


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              impl: Impl = KERNELS) -> torch.Tensor:
    return impl.watershed(image.float().contiguous(),
                          markers.int().contiguous(),
                          mask.bool().contiguous())
