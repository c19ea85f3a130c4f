"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA GPUs as the
cell asks for. Set-up makes the inputs and weights from ``--seed``, builds
the program's kernels into its own build directory (the first run in a
checkout compiles them) and warms every shape up; the window then runs
units of work for ``--seconds`` (ending with the first unit that ends
past it); with ``--trace 1`` one more unit runs under the profiler and
the per-layer metrics are reported instead of the end-to-end ones. The
output is checked against the plain reference after the window. The last
line of standard output is the result's JSON object; the last lines of
standard error are the compared numbers beside their limits.

Exits non-zero without a result where CUDA is absent (2), where the cell
asks for more cards than there are (2), or where a module of JAX or the
JAX package (``jax``, ``jaxlib``, ``flax``, ``cerberus_tpu``, by whole
top-level name) is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# every kernel and build cache at a fixed place inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(HERE, ".cache", sub)

    from portbench.harness import Cell, run_cell

    cell = Cell(args.workload, args.seed, args.seconds)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("portbench: %s needs %d CUDA device(s), found %s" % (
            cell.name, cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    result = run_cell(cell, bool(args.trace), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
