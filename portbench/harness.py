"""One run of one cell: resolve its files by name, set up, warm up,
measure a window, optionally profile one more unit, check the outputs
against the reference, and assemble the result.

Everything that belongs to a cell is found by name:
``BENCHMARK.json`` names its configuration, traffic and chips and lists
the metrics (and is the only place that says them);
``workloads/<cell>.json`` names its driver and holds the limits of its
output comparison; ``configs/<config>.json`` and
``traffic/<traffic>.json`` hold the sizes; ``drivers/<driver>.py``
drives one entry of the program; ``metrics/<metric>.py`` reads one
number from what a run recorded.

A driver is a class ``Driver(cell)`` with ``setup()`` (inputs, weights,
the program's manager, warm-up), ``unit(i)`` (one unit of work, a slide
or a directory job: returns a record with its ``mpx``, ``flops`` and
``spans``), ``counters()`` (the program's counters), ``release()`` (drops
the program's state), ``check(precision)`` (the numbers compared) and
``close()``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
# whole top-level module names that no run may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cerberus_tpu")


def load_json(path: str):
    with open(path) as handle:
        return json.load(handle)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError("no %s file %s" % (kind, path))
    spec = importlib.util.spec_from_file_location(
        "portbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    where it has one, else every cell (an end-to-end metric) or every
    cell that reports what it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    device = "cuda"  # the tests' CPU runs set "cpu"

    def __init__(self, name: str, seed: int, seconds: float,
                 bench: Optional[dict] = None, files: str = HERE):
        """``files``: the folder of ``workloads/`` and ``traffic/``."""
        bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError("no workload %r in BENCHMARK.json" % name)
        entry = entry[0]
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.chips = int(entry["chips"])
        self.spec = load_json(os.path.join(files, "workloads",
                                           name + ".json"))
        conf = [c for c in bench["configs"] if c["name"] == entry["config"]]
        self.config = load_json(os.path.join(ROOT, conf[0]["file"]))
        self.traffic = load_json(os.path.join(files, "traffic",
                                              entry["traffic"] + ".json"))
        self.limits = self.spec["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name, [])]
        reported = [m["name"] for m in self.end_to_end]
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name, reported)]
        self.work_dir = os.path.join(
            os.environ.get("TMPDIR") or "/tmp", "portbench_" + name)

    def driver(self):
        return load_module("drivers", self.spec["driver"]).Driver(self)


# ---------------------------------------------------------------- device
def device_info(cell) -> dict:
    import torch

    if cell.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(cell.chips))}


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return "nvidia-smi failed: %r" % (err,)


def host_state() -> dict:
    """The host's dirty and writeback page cache (kB, ``/proc/meminfo``)
    and its CPU and IO pressure (``some avg10``, ``/proc/pressure``),
    where the kernel shows them: logged beside each unit to tell
    writeback stalls from a busy host."""
    out = {}
    try:
        with open("/proc/meminfo") as handle:
            for line in handle:
                key = line.split(":")[0]
                if key in ("Dirty", "Writeback"):
                    out[key.lower() + "_kb"] = int(line.split()[1])
    except OSError:
        pass
    for kind in ("cpu", "io"):
        try:
            with open("/proc/pressure/" + kind) as handle:
                some = handle.readline().split()
            out[kind + "_some10"] = float(some[1].split("=")[1])
        except (OSError, IndexError, ValueError):
            pass
    return out


def disk_bytes(*paths) -> int:
    """The bytes that the files under ``paths`` hold on disk (allocated
    blocks: a sparse canvas counts what was written of it)."""
    total = 0
    for path in paths:
        if os.path.isfile(path):
            total += os.stat(path).st_blocks * 512
        for root, _, files in os.walk(path):
            for name in files:
                try:
                    total += os.stat(os.path.join(root, name)).st_blocks * 512
                except OSError:
                    pass
    return total


def synchronize(cell) -> None:
    import torch

    if cell.device == "cuda":
        for d in range(cell.chips):
            torch.cuda.synchronize(d)


def forbidden_modules() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------- trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def summarize_trace(events: list) -> dict:
    """A profiler trace's events (Chrome trace ``traceEvents``) -> the
    device's busy seconds per card, seconds per device operation name,
    and the idle gaps (seconds) named by the innermost host operation
    running at their midpoint."""
    dev: Dict[int, list] = {}
    host = []
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            card = int((e.get("args") or {}).get("device", 0))
            dev.setdefault(card, []).append((ts, ts + dur, e["name"]))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
        else:
            continue
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
    ops: Dict[str, float] = {}
    busy: Dict[int, float] = {}
    holes = []  # (start, end) of every idle stretch of every card
    for card, spans in dev.items():
        spans.sort()
        total, end = 0.0, t_lo
        for start, stop, name in spans:
            ops[name] = ops.get(name, 0.0) + (stop - start) * 1e-6
            if start > end:
                holes.append((end, start))
            if stop > end:
                total += stop - max(start, end)
                end = stop
        if t_hi > end:
            holes.append((end, t_hi))
        busy[card] = total * 1e-6
    gaps: Dict[str, float] = {}
    for (start, end), name in zip(holes, _host_at(
            host, [(a + b) / 2 for a, b in holes])):
        gaps[name] = gaps.get(name, 0.0) + (end - start) * 1e-6
    return {"busy_s": busy, "device_ops": ops, "idle_gaps": gaps}


def _host_at(host: list, times: list) -> list:
    """For each of ``times``, the innermost (latest-starting) host
    operation running then, by one sweep over both in time order."""
    import heapq

    host = sorted(host)
    names = [None] * len(times)
    heap: list = []  # (-start, stop, name) of the operations begun so far
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(host) and host[j][0] <= t:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < t:  # ended: it covers no later time
            heapq.heappop(heap)
        names[i] = heap[0][2] if heap else "(no host op)"
    return names


def top(items: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            [:n]]


def profile_unit(driver, index: int, cell) -> dict:
    """``driver.unit(index)`` under ``torch.profiler`` (host and card):
    its record, the wall seconds between synchronised ends, and the
    trace summary."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(cell)
    activities = [ProfilerActivity.CPU]
    if cell.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    try:
        record = driver.unit(index)
        synchronize(cell)
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    path = os.path.join(cell.work_dir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        events = load_json(path)["traceEvents"]
    finally:
        os.remove(path)
    summary = summarize_trace(events)
    del events
    return {"unit": record, "wall_s": wall, **summary}


# ---------------------------------------------------------------- run
def run_cell(cell: Cell, trace: bool, t_start: float, log=None) -> dict:
    """One run of ``cell``; returns the result line's object with the
    compared numbers under ``checks``."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver = cell.driver()
    try:
        driver.setup()
        synchronize(cell)
        setup_s = time.perf_counter() - t_start
        setup_bytes = disk_bytes(cell.work_dir)
        log("portbench: set-up %.3f s" % setup_s)

        before = driver.counters()
        units = []
        t_open = time.perf_counter()
        i = 0
        while True:
            record = driver.unit(i)
            synchronize(cell)
            record["end_s"] = time.perf_counter() - t_open
            log("portbench: unit %d ends at %.3f s, %s, host %s" % (
                i, record["end_s"], json.dumps(record["spans"]),
                json.dumps(host_state())))
            units.append(record)
            i += 1
            if record["end_s"] >= cell.seconds:
                break
        window_s = units[-1]["end_s"]
        after = driver.counters()
        profile = profile_unit(driver, i, cell) if trace else None
        device = device_info(cell)
        run = {"setup_s": setup_s, "window_s": window_s, "units": units,
               "window_mpx": sum(u["mpx"] for u in units),
               "counters": {k: after[k] - before.get(k, 0) for k in after},
               "profile": profile, "chips": cell.chips,
               "peak_flops": PEAK_FLOPS * cell.chips}
        log("portbench: %d units in %.3f s, %.4f Mpx; files written: %d B "
            "in set-up (warm-up included), %d B in the window; peak %d B; "
            "nvidia-smi: %s" % (
                len(units), window_s, run["window_mpx"], setup_bytes,
                sum(u["bytes"] for u in units), device["memory_peak_bytes"],
                nvidia_smi().replace("\n", " | ")))
        if profile is not None:
            log("portbench: profiled unit %.3f s, busy s per card %s" % (
                profile["wall_s"], json.dumps(profile["busy_s"])))
        driver.release()
        gc.collect()
        if cell.device == "cuda":
            torch.cuda.empty_cache()
        checks = driver.check()
        log("portbench: checked %s" % json.dumps(checks))
    finally:
        driver.close()
    found = forbidden_modules()
    if found:
        raise SystemExit("portbench: modules that no run may hold are "
                         "loaded: %s" % ", ".join(found))

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(checks[k] <= cell.limits[k] for k in cell.limits)
    for k in cell.limits:
        log("check %s %r limit %r" % (k, checks[k], cell.limits[k]))
    result = {"correct": correct, "attempted": len(units), "failed": 0,
              "metrics": metrics, "device": device}
    if profile is not None:
        busy = profile["busy_s"]
        result["device"]["busy_s"] = (sum(busy.values()) / cell.chips
                                      if busy else 0.0)
        result["device"]["window_s"] = profile["wall_s"]
        result["breakdown"] = {"device_ops": top(profile["device_ops"]),
                               "idle_gaps": top(profile["idle_gaps"])}
    result["checks"] = {k: {"value": checks[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    return result
