"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""
import json
import os
import re

import pytest

from portbench.harness import HERE, ROOT, Cell, applies, load_json

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert not path.endswith("_torch")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for conf in BENCH["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(conf["name"]) and _line(conf["source"])
        assert _line(conf["why"]) and len(conf["reduced"]) <= 16
        assert all(NAME.match(k) for k in conf["reduced"])
        assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        names.append(conf["name"])
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    metric_names = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert all(c in CELLS for c in m.get("workloads", CELLS))
        metric_names.append(m["name"])
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if applies(m, cell, [])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(m, cell, e2e) for m in BENCH["per_layer"])


def test_every_moves_is_reported_in_each_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert applies(e2e[m["moves"]], cell, [])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = Cell(cell, 1, 1.0)
    assert os.path.isfile(os.path.join(HERE, "drivers",
                                       c.spec["driver"] + ".py"))
    for m in c.end_to_end + c.per_layer:
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    entry = [w for w in BENCH["workloads"] if w["name"] == cell][0]
    assert c.config["name"] == entry["config"]
    assert set(c.spec) == {"driver", "why", "limits"}


def test_configs_keep_every_width():
    for conf in BENCH["configs"]:
        body = load_json(os.path.join(ROOT, conf["file"]))
        assert body["reduced"] == {} and conf["reduced"] == []
        assert body["patch_input"] == 448 and body["patch_output"] == 144
