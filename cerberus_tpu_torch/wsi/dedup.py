"""Tile-boundary instance deduplication for seam-free WSI post-processing.

A copy of ``cerberus_tpu/wsi/dedup.py``.

Behavioral spec: the reference worker ``_process_tile_predictions``
(``infer/wsi.py:81-268``) — instances produced per post-processing tile are
filtered by tile kind so that, across the four tile sets
(grid / v-strip / h-strip / cross), every physical object is emitted exactly
once:

  mode 0 (grid):   drop instances fully contained in the margin band of each
                   edge that borders another tile;
  mode 3 (cross):  same containment rule on all four margins, PLUS return the
                   ids of already-accumulated instances that intersect the
                   tile's inner-margin rectangle outline (they are the
                   corner-crossing duplicates this tile re-detects);
  mode 1/2 (strips): drop instances *intersecting* the margin band of
                   flagged edges and the 1-px boundary line of unflagged
                   edges (fragments the neighboring grid tiles already own).

Implemented as vectorized numpy interval queries over (N, 4) XY boxes —
the reference builds shapely STRtrees per tile; for the box-in-box and
box-touches-box predicates needed here, broadcast comparisons are exact,
faster, and dependency-free.
"""
from __future__ import annotations

import numpy as np


def _contained(boxes: np.ndarray, region) -> np.ndarray:
    return ((boxes[:, 0] >= region[0]) & (boxes[:, 1] >= region[1])
            & (boxes[:, 2] <= region[2]) & (boxes[:, 3] <= region[3]))


def _intersects(boxes: np.ndarray, region) -> np.ndarray:
    return ((boxes[:, 0] <= region[2]) & (boxes[:, 2] >= region[0])
            & (boxes[:, 1] <= region[3]) & (boxes[:, 3] >= region[1]))


def _edge_regions(w: int, h: int, m: int):
    """[top, bottom, left, right] margin bands, boundary lines, and the
    inner-margin rectangle outline segments (all XY boxes)."""
    margin_boxes = [
        (0, 0, w, m),
        (0, h - m, w, h),
        (0, 0, m, h),
        (w - m, 0, w, h),
    ]
    boundary_lines = [
        (0, 0, w, 1),
        (0, h - 1, w, h),
        (0, 0, 1, h),
        (w - 1, 0, w, h),
    ]
    margin_lines = [
        (m, m, w - m, m),
        (m, h - m, w - m, h - m),
        (m, m, m, h - m),
        (w - m, m, w - m, h - m),
    ]
    return margin_boxes, boundary_lines, margin_lines


def select_tile_removals(inst_boxes: np.ndarray, tile_shape, margin: int,
                         tile_flag, tile_mode: int) -> np.ndarray:
    """Boolean mask over the tile's instances: True = drop.

    inst_boxes: (N, 4) flat XY boxes in TILE coordinates."""
    if len(inst_boxes) == 0:
        return np.zeros((0,), bool)
    w, h = int(tile_shape[0]), int(tile_shape[1])
    m = int(margin)
    margin_boxes, boundary_lines, _ = _edge_regions(w, h, m)

    drop = np.zeros(len(inst_boxes), bool)
    if tile_mode in (0, 3):
        for idx in range(4):
            if tile_flag[idx] or tile_mode == 3:
                drop |= _contained(inst_boxes, margin_boxes[idx])
    elif tile_mode in (1, 2):
        for idx in range(4):
            if tile_flag[idx]:
                # margin along the strip's long sides duplicates grid-tile
                # interiors: drop anything touching it
                drop |= _intersects(inst_boxes, margin_boxes[idx])
            else:
                # strip ends: fragments cut by the strip boundary belong to
                # whoever sees them whole (grid or cross), and instances
                # fully inside the end margin are corner (cross) territory
                drop |= _intersects(inst_boxes, boundary_lines[idx])
                drop |= _contained(inst_boxes, margin_boxes[idx])
    else:
        raise ValueError(f"unknown tile mode {tile_mode}")
    return drop


def select_ref_removals(ref_boxes: np.ndarray, tile_bounds,
                        margin: int) -> np.ndarray:
    """For cross-section tiles: boolean mask over accumulated instances
    (WSI-coordinate boxes) intersecting the tile's inner-margin rectangle
    outline — the duplicates this tile supersedes."""
    if len(ref_boxes) == 0:
        return np.zeros((0,), bool)
    x0, y0, x1, y1 = [int(v) for v in tile_bounds]
    w, h = x1 - x0, y1 - y0
    _, _, margin_lines = _edge_regions(w, h, int(margin))
    drop = np.zeros(len(ref_boxes), bool)
    for line in margin_lines:
        region = (line[0] + x0, line[1] + y0, line[2] + x0, line[3] + y0)
        drop |= _intersects(ref_boxes, region)
    return drop
