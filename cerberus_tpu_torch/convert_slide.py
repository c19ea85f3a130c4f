"""convert_slide — write any readable slide as an .npy pyramid.

Usage:
  python -m cerberus_tpu_torch.convert_slide <slide_path> <output_dir> [--levels=<n>] [--mpp=<f>]

A copy of the JAX package's ``tools/convert_slide.py``. Reads the slide
through ``wsi.reader.open_wsi`` (SVS/TIFF/NDPI/SCN/BIF/Philips through the
native parser, MIRAX, JPEG 2000, OpenSlide formats where openslide is
installed, plain images) and writes a directory of ``level_<N>.npy``
memmaps (each level half the previous one, down to 64 px, at most
``--levels``) and ``meta.yml`` ({mpp, objective_power}): the input the WSI
CLI reads fastest (the legacy loop gathers its batches straight off the
level's memmap). Reads and writes in row stripes, so peak memory is one
stripe whatever the slide's size.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from .wsi.reader import open_wsi

STRIPE = 4096


def convert(slide_path: str, out_dir: str, n_levels: int = 4,
            mpp: Optional[float] = None) -> None:
    import yaml

    reader = open_wsi(slide_path, mpp=mpp)
    w, h = reader.info.slide_dimensions
    os.makedirs(out_dir, exist_ok=True)

    lv0 = np.lib.format.open_memmap(
        os.path.join(out_dir, "level_0.npy"), mode="w+", dtype=np.uint8,
        shape=(h, w, 3))
    for y0 in range(0, h, STRIPE):
        y1 = min(y0 + STRIPE, h)
        lv0[y0:y1] = reader.read_bounds([0, y0, w, y1],
                                        resolution=reader.info.mpp,
                                        units="mpp")
    lv0.flush()

    prev, ph, pw = lv0, h, w
    for lev in range(1, n_levels):
        nh, nw = ph // 2, pw // 2
        if min(nh, nw) < 64:
            break
        cur = np.lib.format.open_memmap(
            os.path.join(out_dir, f"level_{lev}.npy"), mode="w+",
            dtype=np.uint8, shape=(nh, nw, 3))
        for y0 in range(0, nh, STRIPE):
            y1 = min(y0 + STRIPE, nh)
            cur[y0:y1] = prev[2 * y0:2 * y1:2, :2 * nw:2]
        cur.flush()
        prev, ph, pw = cur, nh, nw

    with open(os.path.join(out_dir, "meta.yml"), "w") as f:
        yaml.safe_dump({"mpp": float(reader.info.mpp),
                        "objective_power": reader.info.objective_power}, f)
    print(f"converted {slide_path} -> {out_dir} "
          f"({w}x{h} @ {reader.info.mpp} mpp)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "-h" in argv or "--help" in argv:
        print(__doc__)
        return 0
    paths = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv
                if a.startswith("--") and "=" in a)
    if len(paths) != 2 or set(opts) - {"levels", "mpp"}:
        print(__doc__, file=sys.stderr)
        return 1
    convert(paths[0], paths[1], n_levels=int(opts.get("levels", 4)),
            mpp=float(opts["mpp"]) if "mpp" in opts else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
