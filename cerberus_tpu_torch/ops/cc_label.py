"""4-connected component labelling: CUDA kernel wrapper and plain version.

Contract: ``out[p] = (min flat index of p's component) + 1`` on foreground,
0 on background, int32, in the unpadded (H, W) grid — the same as
``cerberus_tpu.ops.lax_postproc.connected_components`` and its Pallas
kernels.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "cerberus_tpu_torch/csrc/cc_label.cu"
REPLACES = ("cerberus_tpu/ops/pallas_cc.py:88; "
            "cerberus_tpu/ops/pallas_cc_blocked.py:48")

_JUMP_EVERY = 8  # sweeps per convergence test in the plain version


def _bind(lib):
    fn = lib.cc_label_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label a (H, W) bool mask.

    On a CUDA tensor this launches ``csrc/cc_label.cu``, the union-find
    kernel that replaces the TPU kernels ``ops/pallas_cc.py:_cc_kernel``
    (VMEM-resident, <= 400k px) and ``ops/pallas_cc_blocked.py:
    _strip_kernel`` (row strips, larger canvases) at any size. It is bound
    by bytes on an H100: the mask read once and the labels written once
    (5 B/px), plus a 4 B/px parent scratch plane. On a CPU tensor it runs
    the plain version.
    """
    if mask.device.type == "cpu":
        return connected_components_plain(mask)
    cuda_build.require_cuda(mask, "mask", torch.bool, ndim=2)
    h, w = mask.shape
    out = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    parent = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    fn = _bind(cuda_build.load("cc_label"))
    with torch.cuda.device(mask.device):
        cuda_build.launch_counts["cc_label"] += 1
        err = fn(mask.data_ptr(), parent.data_ptr(), out.data_ptr(), h, w,
                 cuda_build.stream_handle(mask))
    cuda_build.check(err, "cc_label")
    return out


def neighbor_min(lab: torch.Tensor, big: int) -> torch.Tensor:
    """Min over the 4-neighbourhood, out-of-image reads as ``big``."""
    h, w = lab.shape
    p = F.pad(lab[None], (1, 1, 1, 1), value=big)[0]
    return torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                         torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))


def connected_components_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same contract: 4-neighbour min-label
    propagation with pointer jumping (labels are flat indices + 1, so
    ``lab <- lab[lab - 1]`` follows a label to the pixel it names), run to
    the fixed point with one convergence test every few sweeps."""
    if mask.dim() != 2:
        raise ValueError("mask must be 2-D, got shape %s"
                         % (tuple(mask.shape),))
    mask = mask.bool()
    h, w = mask.shape
    n = h * w
    if n == 0:
        return torch.zeros((h, w), dtype=torch.int32, device=mask.device)
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
