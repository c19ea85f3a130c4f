"""convert_checkpoint.py (PyTorch + CUDA port)

Usage:
  convert_checkpoint.py <torch_tar> <output_path>
  convert_checkpoint.py (-h | --help)

Converts a reference ``weights.tar`` (torch ``{"desc": state_dict}``, with
or without DataParallel prefixes) to the JAX package's native msgpack
checkpoint, as ``tools/convert_checkpoint.py`` does, without flax. Run as
``python -m cerberus_tpu_torch.convert_checkpoint``. Both packages read
either kind of file (``models/convert.load_checkpoint``).
"""
from __future__ import annotations

import sys

from .models.convert import (
    jax_params_from_state_dict,
    load_torch_checkpoint,
    save_native_checkpoint,
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help") or len(argv) != 2:
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    src, dst = argv
    params = jax_params_from_state_dict(load_torch_checkpoint(src))
    save_native_checkpoint(dst, params)
    n = sum(v.size for leaf in params.values() for v in leaf.values())
    print(f"converted {src} -> {dst} ({len(params)} layers, {n:,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
