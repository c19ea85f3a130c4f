"""Marker watershed and one-level label propagation: CUDA kernel wrappers
and plain versions.

Contract (``cerberus_tpu.ops.lax_postproc.watershed``): elevations inside
the mask are bucketed into ``n_levels`` levels, ``level = clip(int((img -
lo) / span * (n_levels - 1)))`` with lo/hi over the mask and ``span =
max(hi - lo, 1e-6)``; at each level, unlabelled pixels with ``mask & level
<= L`` take the minimum 4-neighbour label, synchronously, until nothing
changes. Labels are never overwritten; the output is 0 outside the mask.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .cc_label import foreground_box, neighbor_min

N_LEVELS = 64
SOURCE = "cerberus_tpu_torch/csrc/watershed.cu"
REPLACES = "cerberus_tpu/ops/pallas_watershed.py:32"
# sweeps of the plain versions per convergence test; sweeps past the fixed
# point change nothing, so this is exact
K_SWEEPS = 8
# each entry's last CUDA scratch buffer; its first three int32 words are
# the call's stats (see flood_stats)
last_flood_stats: dict = {}


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded ``watershed`` library with its entries' C types set."""
    lib = cuda_build.load("watershed")
    lib.watershed_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.propagate_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.watershed_launch.restype = lib.propagate_launch.restype = ctypes.c_int
    lib.flood_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.flood_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _scratch(lib, h, w, device) -> torch.Tensor:
    """One byte buffer for the call: keys, levels, per-tile state."""
    return torch.empty((lib.flood_scratch_bytes(h, w),), dtype=torch.uint8,
                       device=device)


def flood_stats(name: str) -> dict:
    """Levels visited, passes and tile passes of the last CUDA call of
    entry ``name`` (``watershed`` or ``propagate_labels``), read back from
    its device counters (synchronises)."""
    levels, passes, tile_passes = last_flood_stats[name][:12].view(
        torch.int32).tolist()
    return {"levels_visited": levels, "passes": passes,
            "tile_passes": tile_passes}


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              n_levels: int = N_LEVELS) -> torch.Tensor:
    """Marker watershed of f32 ``image`` from int32 ``markers`` inside the
    bool ``mask``, all (H, W); returns int32 labels.

    On CUDA tensors this launches ``csrc/watershed.cu``, which replaces the
    TPU kernel ``ops/pallas_watershed.py:_ws_kernel`` (VMEM-resident, <= 1M
    px) with no size cap: an init, then every level of the flood in one
    cooperative launch that relaxes (distance, label) keys in place in
    shared-memory tiles, then the label plane. It enqueues on the current
    stream and does not synchronise. Its bytes bound on an H100 is 9 B/px
    read and 4 B/px written. On CPU tensors it runs the plain version.
    """
    if image.device.type == "cpu":
        return watershed_plain(image, markers, mask, n_levels)
    cuda_build.require_cuda(image, "image", torch.float32, ndim=2)
    cuda_build.require_cuda(markers, "markers", torch.int32, ndim=2)
    cuda_build.require_cuda(mask, "mask", torch.bool, ndim=2)
    if not image.shape == markers.shape == mask.shape:
        raise ValueError("image, markers and mask shapes differ")
    h, w = image.shape
    dev = image.device
    lib = _library()
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, h, w, dev)
    with cuda_build.device_guard(image):
        cuda_build.launch_counts["watershed"] += 1
        err = lib.watershed_launch(
            image.data_ptr(), markers.data_ptr(), mask.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), h, w, n_levels,
            cuda_build.stream_handle(image))
    cuda_build.check(err, "watershed")
    last_flood_stats["watershed"] = scratch
    return out


def propagate_labels(lab: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Spread int32 labels (0 = unlabelled) by neighbour minimum into
    unlabelled ``allowed`` pixels to the fixed point — one level of the
    watershed flood (``lax_postproc._propagate_labels``).

    On CUDA tensors this launches ``csrc/watershed.cu``'s
    ``propagate_launch`` (its own init, then the watershed's cooperative
    flood at one level; no synchronisation), counted under
    ``propagate_labels``; on CPU tensors the plain version.
    """
    if lab.device.type == "cpu":
        return propagate_labels_plain(lab, allowed)
    cuda_build.require_cuda(lab, "lab", torch.int32, ndim=2)
    cuda_build.require_cuda(allowed, "allowed", torch.bool, ndim=2)
    if lab.shape != allowed.shape:
        raise ValueError("lab and allowed shapes differ")
    h, w = lab.shape
    dev = lab.device
    lib = _library()
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, h, w, dev)
    with cuda_build.device_guard(lab):
        cuda_build.launch_counts["propagate_labels"] += 1
        err = lib.propagate_launch(
            lab.data_ptr(), allowed.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), h, w, cuda_build.stream_handle(lab))
    cuda_build.check(err, "propagate_labels")
    last_flood_stats["propagate_labels"] = scratch
    return out


def _flood(work: torch.Tensor, allowed: torch.Tensor, big: int):
    """Synchronous neighbour-min flood of ``big`` (unlabelled) pixels in
    ``allowed`` to the fixed point, testing convergence every K_SWEEPS."""
    while True:
        prev = work
        for _ in range(K_SWEEPS):
            cand = neighbor_min(work, big)
            work = torch.where(allowed & (work == big), cand, work)
        if torch.equal(work, prev):
            return work


def propagate_labels_plain(lab: torch.Tensor,
                           allowed: torch.Tensor) -> torch.Tensor:
    # above every int32 label: a row strip of a plane holds the plane's
    # global ids, which exceed the strip's own pixel count
    big = torch.iinfo(torch.int32).max
    lab = lab.int()
    work = torch.where(lab == 0, torch.full_like(lab, big), lab)
    work = _flood(work, allowed.bool(), big)
    return torch.where(work == big, torch.zeros_like(work), work)


def watershed_plain(image: torch.Tensor, markers: torch.Tensor,
                    mask: torch.Tensor,
                    n_levels: int = N_LEVELS) -> torch.Tensor:
    """Plain PyTorch version: the level loop of ``lax_postproc.watershed``
    with the synchronous flood run to each level's fixed point, on the box
    around the mask (nothing outside it floods or is read)."""
    h, w = image.shape
    mask = mask.bool()
    out = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    box = foreground_box(mask) if mask.numel() else None
    if box is None:
        return out
    y0, y1, x0, x1 = box
    big = h * w + 2  # above every label of the whole plane
    image = image[y0:y1, x0:x1].float()
    mask = mask[y0:y1, x0:x1]
    zero = torch.zeros_like(mask, dtype=torch.int32)
    work = torch.where(mask, markers[y0:y1, x0:x1].int(), zero)
    work = torch.where(work == 0, torch.full_like(work, big), work)
    lo = image[mask].min()
    hi = image[mask].max()
    span = torch.clamp(hi - lo, min=1e-6)
    level = ((image - lo) / span * (n_levels - 1)).to(torch.int32)
    level = level.clamp(0, n_levels - 1)
    for lvl in range(n_levels):
        work = _flood(work, mask & (level <= lvl), big)
    out[y0:y1, x0:x1] = torch.where(mask & (work != big), work, zero)
    return out
