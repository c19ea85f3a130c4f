"""Tracing and profiling helpers (counterpart of
``cerberus_tpu/utils/profiling.py``).

``trace_span`` logs a phase's wall time as ``"<name>: <seconds>"`` (the
per-slide log's spans) inside a ``torch.profiler.record_function`` and,
on the card, an NVTX range, so the phase shows in a profiler trace.
``maybe_profile`` writes a ``torch.profiler`` Chrome trace of its region
when ``CERBERUS_PROFILE_DIR`` is set.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch


@contextlib.contextmanager
def trace_span(name: str, logger: logging.Logger = None):
    """Wall-clock + profiler span; logs ``'<name>: <seconds>'`` on exit."""
    start = time.perf_counter()
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    (logger or logging).info("%s: %.4f", name, time.perf_counter() - start)


@contextlib.contextmanager
def maybe_profile(name: str = "cerberus"):
    """With ``CERBERUS_PROFILE_DIR`` set, profile the region (host, and the
    card where there is one) and write
    ``<dir>/<name>_<pid>_<ns>.pt.trace.json``; otherwise do nothing."""
    profile_dir = os.environ.get("CERBERUS_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
        prof.export_chrome_trace(os.path.join(
            profile_dir, "%s_%d_%d.pt.trace.json"
            % (safe, os.getpid(), time.time_ns())))
