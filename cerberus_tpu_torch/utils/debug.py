"""Debug and numerical-safety modes (counterpart of
``cerberus_tpu/utils/debug.py``).

The CLIs call ``configure_from_env()`` at start:

  * ``CERBERUS_DEFAULT_DEVICE=cpu|cuda[:<n>]`` picks the device when the
    caller gives none (``infer/manager.resolve_device`` and the CLIs'
    ``main`` read it through ``default_device``); it is how the CLIs run on
    a machine without a card;
  * ``CERBERUS_DEBUG=1`` turns on autograd's anomaly detection and a
    NaN/Inf check of every step output, which raises and names the head
    (``infer/steps.make_infer_step`` reads it when it binds a step).

``deterministic_mode(seed)`` is the region for reproducing numerics.
"""
from __future__ import annotations

import contextlib
import os
import random
from typing import Optional

import numpy as np
import torch


def default_device() -> Optional[str]:
    """``CERBERUS_DEFAULT_DEVICE`` (``cpu``, ``cuda`` or ``cuda:<n>``), or
    None where it is unset; any other value raises ``ValueError``."""
    value = os.environ.get("CERBERUS_DEFAULT_DEVICE", "").strip()
    if not value:
        return None
    if value not in ("cpu", "cuda") and not (
            value.startswith("cuda:") and value[5:].isdigit()):
        raise ValueError("CERBERUS_DEFAULT_DEVICE=%r: use cpu, cuda or "
                         "cuda:<n>" % value)
    return value


def debug_mode_requested() -> bool:
    return os.environ.get("CERBERUS_DEBUG", "") not in ("", "0")


def configure_from_env() -> None:
    """CLI-entry knobs: checks ``CERBERUS_DEFAULT_DEVICE`` and, with
    ``CERBERUS_DEBUG`` set, turns on autograd's anomaly detection (the
    step's NaN/Inf check is bound with the step)."""
    default_device()
    if debug_mode_requested():
        torch.autograd.set_detect_anomaly(True)


def check_finite(name: str, tensor: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` naming ``name`` when ``tensor`` holds a
    NaN or an Inf (one host sync)."""
    if not bool(torch.isfinite(tensor).all()):
        raise FloatingPointError("CERBERUS_DEBUG: step output %s holds NaN "
                                 "or Inf" % name)


@contextlib.contextmanager
def deterministic_mode(seed: int = 0):
    """Fixed-seed, deterministic-kernel region for numerics reproduction:
    seeds Python, numpy and torch, turns on
    ``torch.use_deterministic_algorithms`` (with the cuBLAS workspace
    setting it needs), cuDNN deterministic with benchmark off, and TF32
    off; yields a seeded ``torch.Generator``. Everything is restored on
    exit."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield torch.Generator().manual_seed(seed)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved[2:6]
        if saved[6] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[6]
