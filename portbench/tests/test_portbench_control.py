"""On the card, at each cell's own size, on three seeds: the program's
compared numbers within their limits and the control's outside one of
them. The control is the reference computed with float8 e4m3 inputs and
weights (the precision below the configurations' bfloat16), put in the
program's place. Marked ``cuda``: run it on a GPU machine with
``python3 -m pytest portbench/tests -m cuda -q``."""
import gc

import pytest

from portbench.harness import ROOT, Cell, load_json

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in load_json(ROOT + "/BENCHMARK.json")["workloads"]
         if w["chips"] == 1]
SEEDS = (3500000001, 3500000002, 3500000003)


@pytest.fixture(scope="module")
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cuda, cell):
    for seed in SEEDS:
        c = Cell(cell, seed, 0.0)
        driver = c.driver()
        try:
            driver.setup()
            driver.unit(0)
            driver.release()
            gc.collect()
            cuda.cuda.empty_cache()
            program = driver.check("f32")
            control = driver.check("fp8")
        finally:
            driver.close()
        print("portbench control %s %d program %r control %r" % (
            cell, seed, program, control))
        assert all(program[k] <= c.limits[k] for k in c.limits), program
        assert any(control[k] > c.limits[k] for k in c.limits
                   if k in control), control
