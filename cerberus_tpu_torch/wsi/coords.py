"""Sliding-window and tile placement for gigapixel images.

A copy of ``cerberus_tpu/wsi/coords.py``.

Behavioral equivalents of the tiatoolbox surface the reference delegates to
(SURVEY.md §2.8): ``get_coordinates``, ``filter_coordinates`` and
``_get_tile_info`` (used at ``infer/wsi.py:272-317,562-579,643``). All
coordinates are XY bounds ``[tl_x, tl_y, br_x, br_y]`` at processing
resolution; image shapes are (w, h).

Vectorized numpy throughout — the reference routes per-patch queries through
shapely STRtree objects; at ~1e5 patches a handful of broadcast comparisons
is faster and dependency-free.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _grid_starts(length: int, window: int, stride: int) -> np.ndarray:
    """Window start positions covering [0, length): stride steps, last window
    may overrun the edge (callers clip on read/write)."""
    if length <= window:
        return np.array([0], dtype=np.int64)
    last = int(np.ceil((length - window) / stride)) * stride
    return np.arange(0, last + 1, stride, dtype=np.int64)


def get_coordinates(image_shape, ioconfig) -> Tuple[np.ndarray, np.ndarray]:
    """Full sliding-window grid.

    Returns (patch_inputs, patch_outputs): aligned (N, 4) XY bounds. Output
    windows tile the image at ``stride_shape``; each input window is the
    centered ``patch_input_shape`` enclosure (may extend past the image —
    readers pad out-of-bounds reads).
    """
    w, h = int(image_shape[0]), int(image_shape[1])
    out_w, out_h = ioconfig.patch_output_shape
    in_w, in_h = ioconfig.patch_input_shape
    sw, sh = ioconfig.stride_shape

    xs = _grid_starts(w, out_w, sw)
    ys = _grid_starts(h, out_h, sh)
    xx, yy = np.meshgrid(xs, ys)
    tl = np.stack([xx.ravel(), yy.ravel()], axis=1)
    patch_outputs = np.concatenate([tl, tl + [out_w, out_h]], axis=1)

    diff = np.array([(in_w - out_w) // 2, (in_h - out_h) // 2])
    in_tl = tl - diff
    patch_inputs = np.concatenate([in_tl, in_tl + [in_w, in_h]], axis=1)
    return patch_inputs, patch_outputs


def filter_coordinates(mask: np.ndarray, bounds: np.ndarray,
                       proc_shape) -> np.ndarray:
    """Boolean selection of output bounds that intersect tissue.

    ``mask``: low-res binary mask (H, W); ``proc_shape``: (w, h) of the
    processing-resolution plane the bounds live in. A bound survives when any
    mask pixel inside its mapped region is positive — evaluated for all
    bounds at once via a summed-area table.
    """
    mask = (np.asarray(mask) > 0).astype(np.int64)
    mh, mw = mask.shape
    sx = mw / float(proc_shape[0])
    sy = mh / float(proc_shape[1])

    # integral image with a zero row/col prefix
    integral = np.zeros((mh + 1, mw + 1), np.int64)
    integral[1:, 1:] = mask.cumsum(0).cumsum(1)

    x0 = np.clip(np.floor(bounds[:, 0] * sx).astype(np.int64), 0, mw)
    y0 = np.clip(np.floor(bounds[:, 1] * sy).astype(np.int64), 0, mh)
    x1 = np.clip(np.ceil(bounds[:, 2] * sx).astype(np.int64), 0, mw)
    y1 = np.clip(np.ceil(bounds[:, 3] * sy).astype(np.int64), 0, mh)
    # guarantee at least one pixel is probed
    x1 = np.maximum(x1, x0 + 1).clip(max=mw)
    y1 = np.maximum(y1, y0 + 1).clip(max=mh)
    x0 = np.minimum(x0, mw - 1)
    y0 = np.minimum(y0, mh - 1)

    region_sum = (integral[y1, x1] - integral[y0, x1]
                  - integral[y1, x0] + integral[y0, x0])
    return region_sum > 0


def get_tile_info(image_shape, ioconfig) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The 4 tile sets for seam-free tiled post-processing.

    Returns [(bounds, flags)] x 4 in XY:
      set 0 — non-overlapping grid tiles (tile_shape floored to a multiple of
              patch_output_shape); flags mark edges that border another tile;
      set 1 — vertical boundary strips (margin*4 wide) straddling each
              internal vertical tile boundary, full tile height;
      set 2 — horizontal strips, symmetric;
      set 3 — cross-section tiles (margin*4 square) at internal corners.
    Flags are per-edge removal indicators ordered [top, bottom, left, right],
    matching the dedup contract in wsi/dedup.py (reference worker docstring,
    infer/wsi.py:98-117).
    """
    w, h = int(image_shape[0]), int(image_shape[1])
    out_w, out_h = ioconfig.patch_output_shape
    tw = max(int(ioconfig.tile_shape[0] // out_w) * out_w, out_w)
    th = max(int(ioconfig.tile_shape[1] // out_h) * out_h, out_h)
    m = int(ioconfig.margin)

    xs = _grid_starts(w, tw, tw)
    ys = _grid_starts(h, th, th)

    def clip_bounds(tl_x, tl_y, br_x, br_y):
        b = np.stack([tl_x, tl_y, np.minimum(br_x, w), np.minimum(br_y, h)],
                     axis=1)
        return b.astype(np.int64)

    # --- set 0: grid tiles
    xx, yy = np.meshgrid(xs, ys)
    tl_x, tl_y = xx.ravel(), yy.ravel()
    grid = clip_bounds(tl_x, tl_y, tl_x + tw, tl_y + th)
    flags = np.stack([
        grid[:, 1] > 0,        # top edge borders another tile
        grid[:, 3] < h,        # bottom
        grid[:, 0] > 0,        # left
        grid[:, 2] < w,        # right
    ], axis=1).astype(np.int32)
    sets = [(grid, flags)]

    # internal boundaries
    bx = xs[1:]  # x coords of internal vertical boundaries
    by = ys[1:]
    half = 2 * m  # strip half-width: margin area plus recovery room

    # --- set 1: vertical strips (full height columns at each boundary x)
    if len(bx) > 0:
        xxb, yyb = np.meshgrid(bx, ys)
        sx, sy = xxb.ravel(), yyb.ravel()
        v_bounds = clip_bounds(np.maximum(sx - half, 0), sy,
                               sx + half, sy + th)
        # remove along left/right margins (they duplicate grid-tile interiors)
        v_flags = np.tile(np.array([[0, 0, 1, 1]], np.int32),
                          (len(v_bounds), 1))
        sets.append((v_bounds, v_flags))
    else:
        sets.append((np.zeros((0, 4), np.int64), np.zeros((0, 4), np.int32)))

    # --- set 2: horizontal strips
    if len(by) > 0:
        xxb, yyb = np.meshgrid(xs, by)
        sx, sy = xxb.ravel(), yyb.ravel()
        h_bounds = clip_bounds(sx, np.maximum(sy - half, 0),
                               sx + tw, sy + half)
        h_flags = np.tile(np.array([[1, 1, 0, 0]], np.int32),
                          (len(h_bounds), 1))
        sets.append((h_bounds, h_flags))
    else:
        sets.append((np.zeros((0, 4), np.int64), np.zeros((0, 4), np.int32)))

    # --- set 3: cross sections at internal corners
    if len(bx) > 0 and len(by) > 0:
        xxb, yyb = np.meshgrid(bx, by)
        sx, sy = xxb.ravel(), yyb.ravel()
        c_bounds = clip_bounds(np.maximum(sx - half, 0),
                               np.maximum(sy - half, 0),
                               sx + half, sy + half)
        c_flags = np.ones((len(c_bounds), 4), np.int32)
        sets.append((c_bounds, c_flags))
    else:
        sets.append((np.zeros((0, 4), np.int64), np.zeros((0, 4), np.int32)))

    return sets


def assign_patches_to_tiles(patch_outputs: np.ndarray,
                            tile_bounds: np.ndarray) -> np.ndarray:
    """Indices of patches whose output window's top-left falls inside the
    tile — a partition (each patch processed exactly once), unlike the
    reference's intersect-query which double-feeds boundary-straddling
    patches into adjacent tiles without count renormalization
    (infer/wsi.py:594-621)."""
    tlx, tly = patch_outputs[:, 0], patch_outputs[:, 1]
    inside = ((tlx >= tile_bounds[0]) & (tlx < tile_bounds[2])
              & (tly >= tile_bounds[1]) & (tly < tile_bounds[3]))
    return np.flatnonzero(inside)

