"""Whole runs: ``run.py`` without a card, the import probes, and the
harness driven on the CPU at a test size (``tests/data``: ResNet-34 at
144->48 windows, 576^2 slides and three small regions) past its look for
a chip, sound and with the timed path broken underneath."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench.harness import ROOT, Cell, load_json, run_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FORBIDDEN = ("jax", "jaxlib", "flax", "cerberus_tpu")


def _python(code, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_exits_without_a_result_where_there_is_no_card():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "r34-wsi",
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.model, portbench.reference."
            "postproc, portbench.reference.grid, portbench.reference.flops, "
            "portbench.traffic.images, portbench.traffic.weights\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    tops = set(json.loads(proc.stdout.replace("'", '"')))
    assert not tops & set(FORBIDDEN + ("cerberus_tpu_torch",))
    ref_dir = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            with open(os.path.join(ref_dir, name)) as handle:
                assert "cerberus_tpu" not in handle.read(), name


def _tiny(name, seed=2 ** 31 + 5):
    cell = Cell(name, seed, 0.5, bench=load_json(os.path.join(
        DATA, "bench.json")), files=DATA)
    cell.device = "cpu"
    return cell


def test_a_run_holds_no_jax_and_no_jax_package():
    """A whole CPU run of the tile cell in a fresh process: by whole
    top-level name, nothing of JAX or the JAX package is loaded once the
    window has closed (``cerberus_tpu_torch`` is the program)."""
    code = ("import sys, time, json\n"
            "sys.path.insert(0, %r)\n"
            "from test_portbench_run import _tiny\n"
            "from portbench.harness import run_cell\n"
            "res = run_cell(_tiny('tiny-tiles'), False, time.perf_counter())\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % os.path.dirname(os.path.abspath(__file__)))
    proc = _python(code, {"TMPDIR": os.environ.get("TMPDIR", "/tmp")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "cerberus_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def _half_batch(monkeypatch):
    """Half of every batch left out: the step's outputs for the second
    half of the batch are zeros."""
    from cerberus_tpu_torch.infer.manager import InferManager

    step = InferManager.run_step

    def broken(self, batch, output_shape):
        out = step(self, batch, output_shape).clone()
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(InferManager, "run_step", broken)


def _altered_nuclei_wsi(monkeypatch):
    """A nucleus record altered where it is produced: every centroid of
    a grid tile's records moved by one pixel."""
    from cerberus_tpu_torch.infer import wsi

    made = wsi.tile_instances

    def broken(*args, **kwargs):
        new, removed = made(*args, **kwargs)
        for rec in new.values():
            rec["centroid"] = rec["centroid"] + np.array([1.0, 0.0])
        return new, removed

    monkeypatch.setattr(wsi, "tile_instances", broken)


def _altered_nuclei_tile(monkeypatch):
    """An answer altered where it is produced: the nuclei map written
    for every image loses its left half."""
    from cerberus_tpu_torch.infer import tile

    save = tile.save_results

    def broken(root, name, img, inst_maps, *rest):
        inst_maps = dict(inst_maps)
        nuclei = inst_maps["Nuclei"].copy()
        nuclei[:, :nuclei.shape[1] // 2] = 0
        inst_maps["Nuclei"] = nuclei
        return save(root, name, img, inst_maps, *rest)

    monkeypatch.setattr(tile, "save_results", broken)


def _altered_glands_wsi(monkeypatch):
    """An answer altered where it is produced: every tissue region's
    gland with the largest id is left out."""
    from cerberus_tpu_torch.infer import wsi

    made = wsi.region_instance_map

    def broken(region, new_idx, tissue_code, *args, **kwargs):
        inst_map, type_map = made(region, new_idx, tissue_code, *args,
                                  **kwargs)
        if tissue_code == "Gland" and inst_map.max() > 0:
            inst_map = np.where(inst_map == inst_map.max(), 0, inst_map)
        return inst_map, type_map

    monkeypatch.setattr(wsi, "region_instance_map", broken)


def _altered_glands_tile(monkeypatch):
    """An answer altered where it is produced: each image's gland with
    the largest id is left out of its label map."""
    from cerberus_tpu_torch.infer import tile

    made = tile.post_process_canvas

    def broken(*args, **kwargs):
        inst_maps, type_maps, pclass = made(*args, **kwargs)
        gland = inst_maps["Gland"]
        if gland.max() > 0:
            inst_maps["Gland"] = np.where(gland == gland.max(), 0, gland)
        return inst_maps, type_maps, pclass

    monkeypatch.setattr(tile, "post_process_canvas", broken)


CASES = [("tiny-wsi", None), ("tiny-wsi", _half_batch),
         ("tiny-wsi", _altered_nuclei_wsi), ("tiny-wsi", _altered_glands_wsi),
         ("tiny-tiles", None), ("tiny-tiles", _half_batch),
         ("tiny-tiles", _altered_nuclei_tile),
         ("tiny-tiles", _altered_glands_tile)]


@pytest.mark.parametrize("name,fault", CASES, ids=[
    "%s-%s" % (n, f.__name__.strip("_") if f else "sound") for n, f in CASES])
def test_harness_run_is_correct_only_when_sound(name, fault, monkeypatch,
                                                tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    if fault is not None:
        fault(monkeypatch)
    cell = _tiny(name)
    res = run_cell(cell, trace=fault is None and name == "tiny-tiles",
                   t_start=time.perf_counter(), log=lambda msg: None)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["metrics"]
    assert not os.path.exists(cell.work_dir)
