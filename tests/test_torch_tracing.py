"""The port's spans on the CPU: ``utils/profiling.trace_span``'s ``label``
and ``totals``, the tile engine's job spans (``infer/tile.py``), the
resident WSI loop's waits and the gland/lumen region spans
(``infer/resident_wsi.py``, ``infer/wsi.py``) in a ``torch.profiler``
trace and in the logs, and the benchmark's metrics that read them
(``portbench/metrics/*_idle_s_per_mpx.py``) from canned run records.

The forward is ``tests/test_torch_wsi.py``'s numpy stub step on that
file's slide fixture and on the tile-cache tests' small images.
"""
import json
import logging
import os

import pytest
import torch

from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
from cerberus_tpu_torch.infer import resident_wsi
from cerberus_tpu_torch.infer import tile as port_tile
from cerberus_tpu_torch.infer import wsi as port_wsi
from cerberus_tpu_torch.utils import profiling
from portbench.harness import ROOT, load_json, load_module
from test_torch_tile_cache import (IN_SHAPE, MODEL_KWARGS, OUT_SHAPE,
                                   run_args, write_images)
from test_torch_wsi import _port_run, _write_slide, stub_outputs

torch.set_num_threads(2)

WSI_PHASES = ("Preparing Input Output Placement", "Inference Time",
              "Nuclei Post Proc Time", "Tissue Region Post Proc Time",
              "Gland & Lumen Post Proc Time")


def _annotations(prof, path):
    """The trace's ``record_function`` events as (name, start, end)."""
    prof.export_chrome_trace(str(path))
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        fn()
    return prof


def test_trace_span_totals_add_and_do_not_log(caplog):
    totals = {}
    logger = logging.getLogger("cerberus_test_totals")
    with caplog.at_level(logging.INFO):
        for _ in range(3):
            with profiling.trace_span("phase/y", logger, label="Y Time",
                                      totals=totals):
                sum(range(1000))
        with profiling.trace_span("phase/z", logger, label="Z Time"):
            pass
    assert set(totals) == {"Y Time"} and 0 < totals["Y Time"] < 10
    (message,) = _messages(caplog)
    label, seconds = message.rsplit(": ", 1)
    assert label == "Z Time" and 0 <= float(seconds) < 10


def test_tile_job_spans_on_the_main_thread(tmp_path, monkeypatch, caplog):
    """Every tile phase shows in the trace; the records and the writer once
    a file; no forward or stitch span encloses a post-processing one (no
    span is held across the cache's ``yield``); the job's totals are
    logged once a phase."""
    images = write_images(tmp_path / "input", ((100, 120), (90, 60)))
    monkeypatch.setattr(
        port_tile.InferManager, "run_step",
        lambda self, batch, out_sz: torch.from_numpy(
            stub_outputs(batch.numpy(), out_sz)))
    manager = port_tile.InferManager(
        model_args=MODEL_KWARGS, decoder_dict=dict(DEFAULT_TARGET_CODE),
        device="cpu", batch_size=4, patch_input_shape=IN_SHAPE,
        patch_output_shape=OUT_SHAPE)
    with caplog.at_level(logging.INFO):
        prof = _profiled(lambda: manager.process_file_list(
            run_args(tmp_path / "input", tmp_path / "out", "gpu")))
    spans = [s for s in _annotations(prof, tmp_path / "trace.json")
             if s[0].startswith("tile/")]
    names = [s[0] for s in spans]
    assert set(names) == set(port_tile.TILE_SPANS)
    assert names.count("tile/instance_info") == len(images)
    assert names.count("tile/write") == len(images)
    assert names.count("tile/read") == len(images)
    for outer in (s for s in spans if s[0] in ("tile/forward",
                                                "tile/stitch")):
        for inner in (s for s in spans if s[0] == "tile/postproc"):
            assert not (outer[1] <= inner[1] and inner[2] <= outer[2]), \
                (outer, inner)
    for label in port_tile.TILE_SPANS.values():
        lines = [m for m in _messages(caplog) if label + ": " in m]
        assert len(lines) == 1, (label, lines)


def test_resident_slide_spans_and_labels(tmp_path, caplog):
    """A resident slide logs the phase labels letter for letter and the
    loop's waits once each; the wait and region spans show in the
    trace."""
    slide = tmp_path / "input" / "s"
    _write_slide(slide, 3, blocks=(24, 30))
    with caplog.at_level(logging.INFO):
        prof = _profiled(lambda: _port_run(tmp_path, "trace", slide))
    messages = _messages(caplog)
    for label in WSI_PHASES + resident_wsi.WAIT_LABELS + (
            port_wsi.REGION_WAIT, port_wsi.REGION_INFO, "Overall Time"):
        lines = [m for m in messages if m.startswith(label + ": ")]
        assert len(lines) == 1, (label, lines)
        float(lines[0].rsplit(": ", 1)[1])
    assert not [m for m in messages if m.startswith("wsi/")]
    names = {s[0] for s in _annotations(prof, tmp_path / "trace.json")}
    assert {"wsi/placement", "wsi/inference", "wsi/nuclei_sets",
            "wsi/tissue_map", "wsi/gland_lumen", "wsi/read_wait",
            "wsi/land_wait", "wsi/records_wait", "wsi/region_wait",
            "wsi/region_info"} <= names


# ---------------------------------------------------------------- metrics
METRICS = {
    "tile_input_idle_s_per_mpx": ("tile/read", "tile/prepare"),
    "tile_postproc_idle_s_per_mpx": ("tile/postproc",),
    "tile_records_idle_s_per_mpx": ("tile/instance_info",),
    "tile_writer_idle_s_per_mpx": ("tile/write",),
    "wsi_read_wait_idle_s_per_mpx": ("wsi/read_wait",),
    "wsi_host_wait_idle_s_per_mpx": ("wsi/land_wait", "wsi/records_wait"),
    "wsi_gland_lumen_host_idle_s_per_mpx": ("wsi/region_wait",
                                            "wsi/region_info"),
}


def _run(gaps):
    return {"profile": {"unit": {"mpx": 4.0}, "idle_gaps": gaps}}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_idle_metric_reads_its_spans_over_mpx(name):
    spans = METRICS[name]
    gaps = {"(no host op)": 7.0, "wsi/inference": 5.0, "tile/forward": 3.0}
    gaps.update({span: 1.5 * (k + 1) for k, span in enumerate(spans)})
    expected = sum(1.5 * (k + 1) for k in range(len(spans))) / 4.0
    metric = load_module("metrics", name)
    assert metric.read(_run(gaps)) == pytest.approx(expected)
    # one of its names alone still reads
    assert metric.read(_run({spans[-1]: 2.0})) == pytest.approx(0.5)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_idle_metric_reads_none_without_its_spans(name):
    metric = load_module("metrics", name)
    assert metric.read({"profile": None}) is None
    assert metric.read(_run({"(no host op)": 7.0,
                             "wsi/gland_lumen": 1.0})) is None


def test_every_idle_metric_is_in_the_benchmark():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, spans in METRICS.items():
        entry = entries[name]
        assert entry["unit"] == "s/Mpx" and entry["better"] == "lower"
        assert entry["source"] == "device_trace"
        cells = (["r34-tiles"] if name.startswith("tile_")
                 else ["r34-wsi", "dsf8-wsi"])
        assert entry["workloads"] == cells
        assert load_module("metrics", name).SPANS == spans
