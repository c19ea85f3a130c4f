"""The benchmark's DSF-CNN cell on the CPU at a test size: the
``wsi_cohort_rel`` driver (``portbench/drivers/wsi_cohort_rel.py``: each
INST gap over the bfloat16 reference's on the same windows) on a
``dsf_cnn_4`` model at 64->32 over one 192^2 ``.svs`` slide through the
port's WSI engine, and the ``gconv_syntheses_per_mpx`` reader on canned
run records.

* the sound program passes every limit and its relative gaps lie far
  below the limit (here the program runs in float32, the canvas in f16);
* the float8 control, put in the program's place, fails a relative gap;
* the program with every G->G orientation roll reversed is not correct;
* the window's slides log ``Steerable Kernel Syntheses``, which the
  reader sums over their Mpx.
"""
import json
import os

import numpy as np
import pytest
import torch

from cerberus_tpu_torch.models import gconv
from portbench.drivers import wsi_cohort_rel
from portbench.harness import ROOT, Cell, load_json, load_module
from portbench.traffic import weights

torch.set_num_threads(2)

LIMIT = 4.0
CONFIG = {
    "name": "tiny-dsf4", "source": "test size: cerberus-dsf8 as dsf_cnn_4",
    "encoder": "dsf_cnn_4",
    "decoders": {"Lumen": {"INST": 3}, "Gland": {"INST": 3},
                 "Nuclei": {"INST": 3}, "Nuclei#TYPE": {"TYPE": 7},
                 "Gland#TYPE": {"TYPE": 3}},
    "target_code": {"Lumen-INST": "IP-ERODED-CONTOUR-3",
                    "Gland-INST": "IP-ERODED-CONTOUR-11",
                    "Nuclei-INST": "IP-ERODED-CONTOUR-3",
                    "Nuclei-TYPE": "TP", "Gland-TYPE": "TP"},
    "patch_input": 64, "patch_output": 32, "compute_dtype": "bfloat16",
    "canvas_dtype": "float16", "weights": "dsf_served", "reduced": {}}
TRAFFIC = {
    "slide_px": 192, "tile_px": 64, "jpeg_quality": 90, "mpp": 0.5,
    "mask_ds": 4, "slides": [{"tissue": [[0.5, 0.5, 0.4, 0.36]]}],
    "run": {"gpu": "0", "batch_size": 8, "tile_shape": 288,
            "chunk_shape": 15000, "ambiguous_size": 64, "wsi_proc_mag": 0.5,
            "postproc_backend": "gpu", "nr_inference_workers": 0,
            "nr_post_proc_workers": 0, "save_thumb": False,
            "save_mask": False, "auto_mask": False, "save_json": False},
    "check": {"windows": 6, "tiles": 1, "interior_px": 0}}
LIMITS = {"inst_mean_gap_rel": LIMIT, "inst_window_gap_rel": LIMIT,
          "nuclei_mismatch": 0.0, "gland_lumen_mismatch": 0.0}


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A cell of a scratch benchmark, on the CPU, with a short weight
    search (4 sample windows, one draw)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(weights, "SAMPLE_WINDOWS", 4)
    monkeypatch.setattr(weights, "MAX_DRAWS", 1)
    files = tmp_path / "bench"
    for sub, name, body in (
            ("configs", "tiny-dsf4", CONFIG),
            ("traffic", "tiny-dsf", TRAFFIC),
            ("workloads", "tiny-dsf-wsi",
             {"driver": "wsi_cohort_rel", "why": "test", "limits": LIMITS})):
        (files / sub).mkdir(parents=True, exist_ok=True)
        (files / sub / (name + ".json")).write_text(json.dumps(body))
    bench = {"configs": [{"name": "tiny-dsf4",
                          "file": str(files / "configs" / "tiny-dsf4.json")}],
             "workloads": [{"name": "tiny-dsf-wsi", "config": "tiny-dsf4",
                            "traffic": "tiny-dsf", "chips": 1}],
             "end_to_end": [{"name": "wsi_mpx_per_s", "unit": "Mpx/s"}],
             "per_layer": [{"name": "gconv_syntheses_per_mpx",
                            "unit": "syntheses/Mpx",
                            "moves": "wsi_mpx_per_s"}]}

    def make():
        cell = Cell("tiny-dsf-wsi", 2 ** 31 + 11, 0.1, bench=bench,
                    files=str(files))
        cell.device = "cpu"
        return cell
    return make


def test_program_passes_and_the_fp8_control_fails(tiny_cell):
    cell = tiny_cell()
    driver = cell.driver()
    try:
        driver.setup()
        before = gconv.synth_counts["kernels"]
        record = driver.unit(0)
        synthesised = gconv.synth_counts["kernels"] - before
        program = driver.check("f32")
        control = driver.check("fp8")
    finally:
        driver.close()
    print("tiny dsf cell program %r control %r" % (program, control))
    assert all(program[k] <= LIMITS[k] for k in LIMITS), program
    assert program["inst_mean_gap_rel"] < LIMIT / 4, program
    assert program["inst_mean_gap"] > 0 and program["bf16_mean_gap"] > 0
    assert control["inst_mean_gap_rel"] > LIMIT, control
    assert control["inst_window_gap_rel"] > LIMIT, control
    assert program["bf16_mean_gap"] == control["bf16_mean_gap"]
    assert synthesised > 0
    assert record["spans"]["Steerable Kernel Syntheses"] == synthesised


def _reversed_roll(n_out, n_in):
    o = np.arange(n_out)[:, None]
    j = np.arange(n_in)[None, :]
    return (j + o) % n_in


def test_reversed_orientation_roll_is_not_correct(tiny_cell, monkeypatch):
    monkeypatch.setattr(gconv, "_roll_index", _reversed_roll)
    cell = tiny_cell()
    driver = cell.driver()
    try:
        driver.setup()
        driver.unit(0)
        checks = driver.check("f32")
    finally:
        driver.close()
    assert checks["inst_mean_gap_rel"] > LIMIT, checks
    assert not all(checks[k] <= LIMITS[k] for k in LIMITS)


def test_rel_gaps_divide_by_the_yardstick():
    out = wsi_cohort_rel.rel_gaps(
        {"inst_mean_gap": 0.006, "inst_window_gap": 0.02},
        {"mean": 0.003, "window": 0.005})
    assert out == pytest.approx({"inst_mean_gap_rel": 2.0,
                                 "inst_window_gap_rel": 4.0})


# ------------------------------------------------------------ the reader
def _units(*counts):
    return [{"spans": ({"Inference Time": 1.0} if c is None else
                       {"Inference Time": 1.0,
                        "Steerable Kernel Syntheses": float(c)})}
            for c in counts]


def test_syntheses_reader_sums_over_the_window_mpx():
    metric = load_module("metrics", "gconv_syntheses_per_mpx")
    run = {"units": _units(656, 738, 656), "window_mpx": 3 * 9.437184}
    assert metric.read(run) == pytest.approx(2050 / (3 * 9.437184))


def test_syntheses_reader_reads_none_without_the_line():
    metric = load_module("metrics", "gconv_syntheses_per_mpx")
    assert metric.read({"units": _units(None, None),
                        "window_mpx": 2.0}) is None


def test_dsf_cell_in_the_benchmark():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    (cell,) = [w for w in bench["workloads"] if w["name"] == "dsf8-wsi"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "cerberus-dsf8", "cohort-3072", 1)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "gconv_syntheses_per_mpx"]
    assert entry["workloads"] == ["dsf8-wsi"]
    assert entry["layer"] == "Model step"
    spec = load_json(os.path.join(ROOT, "portbench", "workloads",
                                  "dsf8-wsi.json"))
    assert spec["driver"] == "wsi_cohort_rel"
    assert set(spec["limits"]) == set(LIMITS)
