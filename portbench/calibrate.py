"""Readings that the limits of a cell's output comparison are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--units 2]

For each seed, in one process: the cell's set-up (inputs and weights from
the seed, the program's manager, warm-up), ``--units`` units of work, then
the compared numbers of the program (the reference in float32 against
what the program wrote) and of the control (the reference computed with
float8 e4m3 inputs and weights put in the program's place). Prints one
JSON line a seed; ``--control 0`` leaves the control out.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--units", type=int, default=2)
    parser.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import Cell

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = Cell(args.workload, seed, 0.0)
        driver = cell.driver()
        try:
            driver.setup()
            for i in range(args.units):
                driver.unit(i)
            torch.cuda.synchronize()
            driver.release()
            gc.collect()
            torch.cuda.empty_cache()
            line = {"workload": cell.name, "seed": seed,
                    "program": driver.check("f32")}
            if args.control:
                line["control"] = driver.check("fp8")
        finally:
            driver.close()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
