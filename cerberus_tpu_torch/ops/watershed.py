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

import torch

from . import cuda_build
from .cc_label import neighbor_min

N_LEVELS = 64
SOURCE = "cerberus_tpu_torch/csrc/watershed.cu"
REPLACES = "cerberus_tpu/ops/pallas_watershed.py:32"
# sweeps per read of the device-side "changed" flag (must be even); sweeps
# past the fixed point change nothing, so this is exact
K_SWEEPS = 8


def _bind(lib):
    ws = lib.watershed_launch
    ws.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    ws.restype = ctypes.c_int
    prop = lib.propagate_launch
    prop.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    prop.restype = ctypes.c_int
    return ws, prop


def _scratch(h, w, device):
    return (torch.empty((h, w), dtype=torch.int32, device=device),
            torch.empty((h, w), dtype=torch.int32, device=device),
            torch.empty((h, w), dtype=torch.uint8, device=device),
            torch.empty((K_SWEEPS,), dtype=torch.int32, device=device))


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              n_levels: int = N_LEVELS) -> torch.Tensor:
    """Marker watershed of f32 ``image`` from int32 ``markers`` inside the
    bool ``mask``, all (H, W); returns int32 labels.

    On CUDA tensors this launches ``csrc/watershed.cu``, which replaces the
    TPU kernel ``ops/pallas_watershed.py:_ws_kernel`` (VMEM-resident, <= 1M
    px) with no size cap. Its bytes bound on an H100 is 9 B/px read and
    4 B/px written; in practice it is bound by launches, one per sweep over
    the plane, and it synchronises the stream once every ``K_SWEEPS``
    sweeps to read the convergence flag. On CPU tensors it runs the plain
    version.
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
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    work_a, work_b, level, flags = _scratch(h, w, dev)
    lohi = torch.empty((2,), dtype=torch.int32, device=dev)
    ws, _ = _bind(cuda_build.load("watershed"))
    with torch.cuda.device(dev):
        cuda_build.launch_counts["watershed"] += 1
        err = ws(image.data_ptr(), markers.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), work_a.data_ptr(), work_b.data_ptr(),
                 level.data_ptr(), flags.data_ptr(), lohi.data_ptr(), h, w,
                 n_levels, K_SWEEPS, cuda_build.stream_handle(image))
    cuda_build.check(err, "watershed")
    return out


def propagate_labels(lab: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Spread int32 labels (0 = unlabelled) by neighbour minimum into
    unlabelled ``allowed`` pixels to the fixed point — one level of the
    watershed flood (``lax_postproc._propagate_labels``).

    On CUDA tensors this launches ``csrc/watershed.cu``'s
    ``propagate_launch`` (its own init, then the watershed's flood at one
    level), counted under ``propagate_labels``; on CPU tensors the plain
    version.
    """
    if lab.device.type == "cpu":
        return propagate_labels_plain(lab, allowed)
    cuda_build.require_cuda(lab, "lab", torch.int32, ndim=2)
    cuda_build.require_cuda(allowed, "allowed", torch.bool, ndim=2)
    if lab.shape != allowed.shape:
        raise ValueError("lab and allowed shapes differ")
    h, w = lab.shape
    dev = lab.device
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    work_a, work_b, level, flags = _scratch(h, w, dev)
    _, prop = _bind(cuda_build.load("watershed"))
    with torch.cuda.device(dev):
        cuda_build.launch_counts["propagate_labels"] += 1
        err = prop(lab.data_ptr(), allowed.data_ptr(), out.data_ptr(),
                   work_a.data_ptr(), work_b.data_ptr(), level.data_ptr(),
                   flags.data_ptr(), h, w, K_SWEEPS,
                   cuda_build.stream_handle(lab))
    cuda_build.check(err, "propagate_labels")
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
    h, w = lab.shape
    big = h * w + 2
    lab = lab.int()
    work = torch.where(lab == 0, torch.full_like(lab, big), lab)
    work = _flood(work, allowed.bool(), big)
    return torch.where(work == big, torch.zeros_like(work), work)


def watershed_plain(image: torch.Tensor, markers: torch.Tensor,
                    mask: torch.Tensor,
                    n_levels: int = N_LEVELS) -> torch.Tensor:
    """Plain PyTorch version: the level loop of ``lax_postproc.watershed``
    with the synchronous flood run to each level's fixed point."""
    h, w = image.shape
    mask = mask.bool()
    big = h * w + 2
    image = image.float()
    zero = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    work = torch.where(mask, markers.int(), zero)
    work = torch.where(work == 0, torch.full_like(work, big), work)
    if not bool(mask.any()):
        return zero
    lo = image[mask].min()
    hi = image[mask].max()
    span = torch.clamp(hi - lo, min=1e-6)
    level = ((image - lo) / span * (n_levels - 1)).to(torch.int32)
    level = level.clamp(0, n_levels - 1)
    for lvl in range(n_levels):
        work = _flood(work, mask & (level <= lvl), big)
    return torch.where(mask & (work != big), work, zero)
