"""Exact 16384-bin histogram: CUDA kernel wrapper and plain version.

Contract: counts of int32 ids clipped into [0, 16383], returned as a
(16384,) int32 vector. (The TPU kernel returned f32, exact to 2^24; these
counts are exact integers.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

N_BINS = 16384
SOURCE = "cerberus_tpu_torch/csrc/hist16384.cu"
REPLACES = "cerberus_tpu/ops/pallas_hist.py:37"


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded ``hist16384`` library with its entries' C types set."""
    lib = cuda_build.load("hist16384")
    lib.hist16384_setup.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.hist16384_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.hist16384_setup.restype = lib.hist16384_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """Sets the kernel up on a device (once) and returns its SM count."""
    sms = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        cuda_build.check(_library().hist16384_setup(ctypes.byref(sms)),
                         "hist16384 setup")
    return sms.value


def hist16384(ids: torch.Tensor, n_live: int = N_BINS) -> torch.Tensor:
    """Histogram of int32 ``ids`` (any shape) into 16384 int32 bins.

    ``n_live`` is the caller's promise that the ids lie in ``[0, n_live)``;
    it only makes the kernel cheaper, and ids that break it are still
    counted exactly (clipped into [0, 16383] like all others).

    On a CUDA tensor this launches ``csrc/hist16384.cu`` (per-block
    shared-memory histograms of the live bins, flushed with global
    atomics), which replaces the TPU kernel ``ops/pallas_hist.py:
    _hist_kernel`` (MXU one-hot matmuls). It is bound by bytes on an H100:
    the ids read once (4 B/px) and 64 KB of counts written. On a CPU tensor
    it runs the plain version.
    """
    if not 1 <= n_live <= N_BINS:
        raise ValueError("n_live must be in [1, %d], got %d"
                         % (N_BINS, n_live))
    if ids.device.type == "cpu":
        return hist16384_plain(ids, n_live)
    cuda_build.require_cuda(ids, "ids", torch.int32)
    lib = _library()
    sms = _sm_count(ids.device.index)
    out = torch.empty((N_BINS,), dtype=torch.int32, device=ids.device)
    with cuda_build.device_guard(ids):
        cuda_build.launch_counts["hist16384"] += 1
        err = lib.hist16384_launch(ids.data_ptr(), ids.numel(),
                                   out.data_ptr(), n_live, sms,
                                   cuda_build.stream_handle(ids))
    cuda_build.check(err, "hist16384")
    return out


def hist16384_plain(ids: torch.Tensor, n_live: int = N_BINS) -> torch.Tensor:
    """Plain PyTorch version: a scatter-add of ones into the clipped bins.
    ``n_live`` is a hint for the kernel and changes nothing here."""
    flat = ids.reshape(-1).clamp(0, N_BINS - 1).long()
    counts = torch.zeros((N_BINS,), dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))
