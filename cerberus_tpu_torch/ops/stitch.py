"""Canvas stitching on the device.

Counterpart of ``cerberus_tpu/ops/stitch.py:17-39`` with the same contract:
paste (or, for overlapped grids, sum-and-count average) per-patch outputs
onto an f32 (H, W, C) canvas. The canvas is allocated on the patches'
device, so it never round-trips to the host before post-processing.
"""
from __future__ import annotations

from typing import Sequence

import torch


def stitch_canvas(patch_outputs: torch.Tensor, out_tl_list: Sequence,
                  canvas_hw, average: bool = False) -> torch.Tensor:
    """patch_outputs: (P, h, w, C) tensor (or a sequence of (h, w, C));
    out_tl_list: matching (y, x) top-left corners in padded-image space;
    canvas_hw: (H, W) of the padded canvas."""
    first = patch_outputs[0]
    canvas = torch.zeros((*canvas_hw, first.shape[-1]), dtype=torch.float32,
                         device=first.device)
    count = None
    if average:
        count = torch.zeros((*canvas_hw, 1), dtype=torch.float32,
                            device=first.device)
    for out, (ty, tx) in zip(patch_outputs, out_tl_list):
        ty, tx = int(ty), int(tx)
        region = (slice(ty, ty + out.shape[0]), slice(tx, tx + out.shape[1]))
        if count is None:
            canvas[region] = out
        else:
            canvas[region] += out
            count[region] += 1.0
    if count is None:
        return canvas
    return canvas / (count + 1.0e-8)
