"""Valid-region decoding: each decoder tower runs only on the kept output
window plus its receptive-field margin, instead of the full patch.

Counterpart of ``cerberus_tpu/models/valid_decode.py``. The reference runs
every tower at the full input size and crops the central output window
afterwards; here the window each level needs is solved once, the skip
pyramid is cropped once after the encoder, and the towers' convolutions run
with padding 0 on the small windows (``ConvBlock.forward_valid``).

Why the kept pixels are the same values:
  * a 3x3 convolution with padding 0 on a cropped window computes the same
    dot products as the padded one restricted to interior pixels, so each
    two-conv block needs a 2 px margin per side (``CONV_MARGIN``);
  * ``upsample2x`` (half-pixel bilinear, edge-clamped) maps fine pixel g to
    coarse coordinate g/2 - 0.25: even g = 2k reads coarse {k-1, k}, odd
    g = 2k+1 reads {k, k+1}. Upsampling the coarse crop [c0, c1) gives the
    full tensor's fine pixels on [2 c0 + 2, 2 c1 - 2) exactly (one guard
    pixel per side keeps the crop's own edge clamp away), so a fine window
    [f0, f1) needs coarse [floor(f0/2) - 1, ceil(f1/2) + 1) and the slice
    ``[up_lo : n - up_hi]`` of the upsampled crop;
  * the 1x1 head convolutions need no margin.

Tensors are NCHW; windows crop ``[..., a:b, a:b]``. Inference only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..config import ModelConfig
from .layers import upsample2x

CONV_MARGIN = 2  # 2 convs per decoder block x (k=3)//2 px each


@dataclass(frozen=True)
class _Level:
    """One decoder level's crop plan (block index == list position)."""
    skip_win: Tuple[int, int]   # crop of the skip feature at this scale
    up_lo: int                  # fine-scale slice offsets after upsample2x
    up_hi: int


@dataclass(frozen=True)
class ValidPlan:
    bottom_win: Tuple[int, int]   # crop of the bottom (conv_map) feature
    levels: Tuple[_Level, ...]    # coarse -> fine (block 0 .. n_up-1)
    out_size: int


def solve_windows(in_size: int, out_size: int,
                  n_up: int = 4) -> Optional[ValidPlan]:
    """Per-level crop windows for the centred ``out_size`` output of an
    ``in_size`` patch, or None when a window leaves its feature map. The
    output offset is the reference's floor centre, int((in - out) * 0.5)."""
    start = int((in_size - out_size) * 0.5)
    win = (start, start + out_size)
    levels: List[_Level] = []
    for b in reversed(range(n_up)):
        skip_scale = in_size >> (n_up - 1 - b)
        i0, i1 = win[0] - CONV_MARGIN, win[1] + CONV_MARGIN
        if i0 < 0 or i1 > skip_scale:
            return None
        c0 = i0 // 2 - 1
        c1 = -((-i1) // 2) + 1
        levels.append(_Level((i0, i1), i0 - 2 * c0, 2 * c1 - i1))
        win = (c0, c1)
    if win[0] < 0 or win[1] > (in_size >> n_up):
        return None
    levels.reverse()
    return ValidPlan(bottom_win=win, levels=tuple(levels), out_size=out_size)


def supports_valid_region(cfg: ModelConfig, in_size: int,
                          out_size: int) -> Optional[ValidPlan]:
    """The plan when the encoder and geometry admit valid-region decoding,
    else None (the full-tower path). DSF encoders' G-conv decoders have
    another margin structure and keep the full towers."""
    if cfg.encoder_backbone_name[:3] == "dsf":
        return None
    if out_size >= in_size:
        return None
    return solve_windows(in_size, out_size)


def _crop(x: torch.Tensor, win: Tuple[int, int]) -> torch.Tensor:
    return x[..., win[0]:win[1], win[0]:win[1]]


def valid_decoder_tower(blocks, bottom: torch.Tensor, skips,
                        plan: ValidPlan) -> torch.Tensor:
    """One summation-skip tower (``blocks``: its four ``ConvBlock``s) on
    the planned windows. ``bottom`` is the ``conv_map`` output cropped to
    ``plan.bottom_win``; ``skips`` the skip features cropped to each
    level's ``skip_win``, coarse to fine."""
    prev = bottom
    for blk, lvl, skip in zip(blocks, plan.levels, skips):
        up = upsample2x(prev)
        n = up.shape[-1]
        up = up[..., lvl.up_lo:n - lvl.up_hi, lvl.up_lo:n - lvl.up_hi]
        prev = blk.forward_valid(skip + up)
    return prev


def valid_head_outputs(model, x: torch.Tensor, plan: ValidPlan,
                       pclass_cells: int = 1) -> Dict[str, torch.Tensor]:
    """``model`` (a ``NetDesc``) on NCHW input in [0, 1]: the full encoder,
    valid-region towers and 1x1 heads. Segmentation logits are already the
    central ``plan.out_size`` window; Patch-Class is (N, C, cells, cells)."""
    from .net_desc import pclass_for_cells

    feats, bottom_feats = model.encode(x)
    bottom = _crop(feats[-1], plan.bottom_win)
    # coarse -> fine: feats[-2] .. feats[0]
    n_up = len(plan.levels)
    skips = [_crop(feats[n_up - 1 - b], lvl.skip_win)
             for b, lvl in enumerate(plan.levels)]
    out: Dict[str, torch.Tensor] = {}
    towers = {}
    for decoder_name, head_name, key in model._heads:
        if decoder_name not in towers:
            towers[decoder_name] = valid_decoder_tower(
                model.decoder_head[decoder_name], bottom, skips, plan)
        # the heads' 1x1 convolutions have no padding to drop
        out[key] = model.output_head[decoder_name][head_name](
            towers[decoder_name])
    if "Patch-Class" in model.decoder_head:
        out["Patch-Class"] = pclass_for_cells(
            model.decoder_head["Patch-Class"], bottom_feats, pclass_cells)
    return out
