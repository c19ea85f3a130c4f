"""4-connected component labelling: CUDA kernel wrapper and plain version.

Contract: ``out[p] = (min flat index of p's component) + 1`` on foreground,
0 on background, int32, in the unpadded (H, W) grid — the same as
``cerberus_tpu.ops.lax_postproc.connected_components`` and its Pallas
kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "cerberus_tpu_torch/csrc/cc_label.cu"
REPLACES = ("cerberus_tpu/ops/pallas_cc.py:88; "
            "cerberus_tpu/ops/pallas_cc_blocked.py:48")

_JUMP_EVERY = 8  # sweeps per convergence test in the plain version


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded ``cc_label`` library with its entries' C types set."""
    lib = cuda_build.load("cc_label")
    lib.cc_label_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.launch_floor_launch.argtypes = [ctypes.c_void_p]
    lib.cc_label_launch.restype = lib.launch_floor_launch.restype = \
        ctypes.c_int
    return lib


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label a (H, W) bool mask.

    On a CUDA tensor this launches ``csrc/cc_label.cu``, which replaces the
    TPU kernels ``ops/pallas_cc.py:_cc_kernel`` (VMEM-resident, <= 400k px)
    and ``ops/pallas_cc_blocked.py:_strip_kernel`` (row strips, larger
    canvases) at any size below 2^31 - 1 pixels: 32 x 128 tiles labelled in
    shared memory, united across tile borders by union-find in the output
    plane itself, then flattened, in one cooperative launch. It is bound by
    bytes on an H100: the mask read once and the labels written once
    (5 B/px). On a CPU tensor it runs the plain version.
    """
    if mask.device.type == "cpu":
        return connected_components_plain(mask)
    cuda_build.require_cuda(mask, "mask", torch.bool, ndim=2)
    h, w = mask.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError("mask has %d pixels: labels are int32" % (h * w))
    lib = _library()
    out = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    with cuda_build.device_guard(mask):
        cuda_build.launch_counts["cc_label"] += 1
        err = lib.cc_label_launch(mask.data_ptr(), out.data_ptr(), h, w,
                                  cuda_build.stream_handle(mask))
    cuda_build.check(err, "cc_label")
    return out


def launch_floor(like: torch.Tensor) -> None:
    """Launch an empty kernel on the current stream of ``like``'s device
    through the same route as the kernels (a yardstick; counted nowhere)."""
    lib = _library()
    with cuda_build.device_guard(like):
        err = lib.launch_floor_launch(cuda_build.stream_handle(like))
    cuda_build.check(err, "launch_floor")


def neighbor_min(lab: torch.Tensor, big: int) -> torch.Tensor:
    """Min over the 4-neighbourhood, out-of-image reads as ``big``."""
    h, w = lab.shape
    p = F.pad(lab[None], (1, 1, 1, 1), value=big)[0]
    return torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                         torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))


def foreground_box(mask: torch.Tensor):
    """(y0, y1, x0, x1) of the smallest box holding every True pixel of a
    2-D mask, or None when there is none."""
    rows = torch.nonzero(mask.any(1)).view(-1)
    if rows.numel() == 0:
        return None
    cols = torch.nonzero(mask.any(0)).view(-1)
    return (int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1)


def connected_components_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same contract: 4-neighbour min-label
    propagation with pointer jumping (labels are flat indices + 1, so
    ``lab <- lab[lab - 1]`` follows a label to the pixel it names), run to
    the fixed point with one convergence test every few sweeps, on the box
    around the foreground (row-major order is the same in the box and the
    plane, so its minimum flat indices map to the plane's)."""
    if mask.dim() != 2:
        raise ValueError("mask must be 2-D, got shape %s"
                         % (tuple(mask.shape),))
    mask = mask.bool()
    h, w = mask.shape
    box = foreground_box(mask) if mask.numel() else None
    if box is None:
        return torch.zeros((h, w), dtype=torch.int32, device=mask.device)
    y0, y1, x0, x1 = box
    if (y1 - y0, x1 - x0) != (h, w):
        sub = connected_components_plain(mask[y0:y1, x0:x1])
        root = (sub.long() - 1).clamp_(min=0)
        full = (root // (x1 - x0) + y0) * w + root % (x1 - x0) + x0 + 1
        out = torch.zeros((h, w), dtype=torch.int32, device=mask.device)
        out[y0:y1, x0:x1] = torch.where(sub > 0, full.int(), sub)
        return out
    n = h * w
    big = n + 2
    idx = torch.arange(1, n + 1, dtype=torch.int32,
                       device=mask.device).view(h, w)
    big_t = torch.full_like(idx, big)
    lab = torch.where(mask, idx, big_t)
    while True:
        prev = lab
        for _ in range(_JUMP_EVERY):
            lab = torch.where(mask, torch.minimum(lab, neighbor_min(lab, big)),
                              big_t)
            flat = torch.where(mask, lab, idx).view(-1)
            jumped = flat[(flat - 1).clamp_(0, n - 1).long()].view(h, w)
            lab = torch.where(mask, torch.minimum(lab, jumped), big_t)
        if torch.equal(lab, prev):
            break
    return torch.where(mask, lab, torch.zeros_like(lab))
