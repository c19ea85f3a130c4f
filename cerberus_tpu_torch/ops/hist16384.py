"""Exact 16384-bin histogram: CUDA kernel wrapper and plain version.

Contract: counts of int32 ids clipped into [0, 16383], returned as a
(16384,) int32 vector. (The TPU kernel returned f32, exact to 2^24; these
counts are exact integers.)
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

N_BINS = 16384
SOURCE = "cerberus_tpu_torch/csrc/hist16384.cu"
REPLACES = "cerberus_tpu/ops/pallas_hist.py:37"


def _bind(lib):
    fn = lib.hist16384_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hist16384(ids: torch.Tensor) -> torch.Tensor:
    """Histogram of int32 ``ids`` (any shape) into 16384 int32 bins.

    On a CUDA tensor this launches ``csrc/hist16384.cu`` (per-block
    shared-memory histograms flushed with global atomics), which replaces
    the TPU kernel ``ops/pallas_hist.py:_hist_kernel`` (MXU one-hot
    matmuls). It is bound by bytes on an H100: the ids read once (4 B/px)
    and 64 KB of counts written. On a CPU tensor it runs the plain version.
    """
    if ids.device.type == "cpu":
        return hist16384_plain(ids)
    cuda_build.require_cuda(ids, "ids", torch.int32)
    out = torch.empty((N_BINS,), dtype=torch.int32, device=ids.device)
    fn = _bind(cuda_build.load("hist16384"))
    blocks = 3 * torch.cuda.get_device_properties(
        ids.device).multi_processor_count
    with torch.cuda.device(ids.device):
        cuda_build.launch_counts["hist16384"] += 1
        err = fn(ids.data_ptr(), ids.numel(), out.data_ptr(), blocks,
                 cuda_build.stream_handle(ids))
    cuda_build.check(err, "hist16384")
    return out


def hist16384_plain(ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a scatter-add of ones into the clipped bins."""
    flat = ids.reshape(-1).clamp(0, N_BINS - 1).long()
    counts = torch.zeros((N_BINS,), dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))
