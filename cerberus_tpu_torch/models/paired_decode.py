"""Width-paired ("pair-plane") valid-region decoding.

Counterpart of ``cerberus_tpu/models/paired_decode.py``. The JAX package
lowers the valid-region towers (``models/valid_decode.py``) onto a layout
in which adjacent column pairs are stacked on the channel axis, so that
the towers' 64-channel convolutions fill the TPU's 128 MXU lanes. JAX
writes the pairing ``paired(x)[n, h, j, p*C + c] == x[n, h, 2j + p, c]``;
on the port's NCHW tensors it is

    xp[n, p*C + c, h, j] == x[n, c, h, 2j + p]

so every repacked kernel here is, element for element, the (O, I, H, W)
transpose of the JAX package's (H, W, I, O) one.

Layout: the helpers work on the NHWC view of their tensors
(``x.permute(0, 2, 3, 1)``), where the pairing is a reshape. A tensor in
``torch.channels_last`` memory has a contiguous NHWC view, so there
``pair_w`` / ``unpair_w`` are free views and the paired ``(N, 2C, H, W/2)``
tensor has exactly the strides of the unpaired one; on a contiguous NCHW
tensor they copy once and return a channels-last tensor. The paired path
runs channels-last: the port's inference and training inputs already are
(``imgs.permute(0, 3, 1, 2)`` of an NHWC batch), and cuDNN keeps the
format through the convolutions.

Why the kept values are the unpaired ones:
  * a 3x3 VALID convolution becomes a 3x2-block VALID convolution with a
    repacked ``(2Co, 2Ci, 3, 2)`` kernel: for output parity p, tap k reads
    block ``(p + k) // 2`` at parity ``(p + k) % 2``; every other entry is
    an exact zero, so each output sums the same products (4/3 the MACs);
  * the bilinear 2x upsample's even and odd output columns ARE the two
    parity groups: ``layers.upsample2x`` of the unpaired view, cropped, is
    paired by a view (``_upsample_crop_pair``; JAX's two separable passes
    in one);
  * BN runs on the unpaired view (``paired_bn``); biases and 1x1
    convolutions pair by tiling their (C,) vectors and kernels.
On the CPU the paired towers agree with the JAX ones within 2e-5 of the
heads' largest logit (``tests/test_torch_paired_decode.py``).

The towers here are inference only; the repacked kernels and tiled
biases are cached per weight until the weight changes (``packed``). JAX's
``optimization_barrier`` between towers has no eager counterpart: eager
execution runs the towers one after another and frees each tower's
activations before the next.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import upsample2x
from .valid_decode import ValidPlan, _crop


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def pair_w(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 2C, H, W/2); W must be even."""
    n, c, h, w = x.shape
    return _nchw(_nhwc(x).reshape(n, h, w // 2, 2 * c))


def unpair_w(x: torch.Tensor) -> torch.Tensor:
    """(N, 2C, H, Wb) -> (N, C, H, 2*Wb)."""
    n, c2, h, wb = x.shape
    return _nchw(_nhwc(x).reshape(n, h, 2 * wb, c2 // 2))


def repack(w: torch.Tensor, blocks: int, taps: Dict[Tuple[int, int, int],
                                                    int],
           out_parities: int = 2) -> torch.Tensor:
    """OIHW ``(Co, Ci, kh, kw)`` -> ``(out_parities * Co, 2 * Ci, kh,
    blocks)``: entry (output parity p, block b, input parity q) holds tap
    ``taps[(p, b, q)]`` of ``w`` and every other entry is zero. Built
    out of place from ``w`` (stack and cat), so gradients reach ``w``."""
    co, ci, kh, _ = w.shape
    zero = w.new_zeros((co, ci, kh))
    rows = []
    for p in range(out_parities):
        rows.append(torch.cat([
            torch.stack([w[..., taps[(p, b, q)]] if (p, b, q) in taps
                         else zero for b in range(blocks)], dim=-1)
            for q in range(2)], dim=1))
    return torch.cat(rows, dim=0)


def pair_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) VALID -> (2Co, 2Ci, 3, 2) width-paired block kernel.

    Output parity p at block j covers window-local column 2j+p; tap k
    reads column 2j+p+k = block j + (p+k)//2, parity (p+k)%2."""
    assert w.shape[-1] == 3, w.shape
    return repack(w, 2, {(p, (p + k) // 2, (p + k) % 2): k
                         for p in range(2) for k in range(3)})


def pair_conv1x1_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 1, 1) -> (2Co, 2Ci, 1, 1) block-diagonal (parity kept)."""
    return repack(w, 1, {(p, 0, p): 0 for p in range(2)})


def _pair_vec(v: torch.Tensor) -> torch.Tensor:
    """A (C,) vector of the unpaired channels -> (2C,): both parities."""
    return v.repeat(2)


def packed(fn: Callable, w: torch.Tensor) -> torch.Tensor:
    """``fn(w)``; without autograd (inference) cached on ``w`` itself
    (``{fn: (key, value)}`` in its ``_paired_packed`` attribute) until it
    changes: in place (its version counter) or moved (its storage)."""
    if torch.is_grad_enabled() and w.requires_grad:
        return fn(w)
    key = (w._version, w.data_ptr(), w.dtype, w.device)
    per_weight = w.__dict__.setdefault("_paired_packed", {})
    hit = per_weight.get(fn)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = per_weight[fn] = (key, fn(w))
    return hit[1]


def paired_bn(bn, x: torch.Tensor) -> torch.Tensor:
    """``bn`` (a ``layers.BatchNorm2d`` of the unpaired channels) on a
    paired tensor, in the module's mode: the module on the unpaired view,
    paired again. Channel c of the view is the paired channels {c, C + c}
    together (equal counts, W even), so in training its batch statistics
    are JAX ``_paired_bn_train``'s fold, ``mean = (m0 + m1) / 2`` and
    ``var = (v0 + v1) / 2 + ((m0 - m1) / 2)^2`` over n = 2 N H Wb, folded
    unbiased ``n / max(n - 1, 1)``; in eval the stored statistics act as
    JAX's tiled ones. The module's own forward keeps its contract (the
    ``training`` flag of subtype freezing, ``fold_stats`` during a remat
    recompute, momentum 0.1, ``num_batches_tracked`` left alone, the ranks
    of ``sync_group``), and autograd differentiates it. In channels-last
    memory both views are free."""
    return pair_w(bn(unpair_w(x)))


def _paired_conv_block(block, x: torch.Tensor) -> torch.Tensor:
    """A ``layers.ConvBlock`` (VALID, inference) on a paired tensor:
    conv -> BN -> ReLU per layer."""
    for layer in block.block:
        conv = layer.conv
        pairer = (pair_conv1x1_kernel if conv.weight.shape[-1] == 1
                  else pair_conv_kernel)
        bias = None if conv.bias is None else packed(_pair_vec, conv.bias)
        x = F.conv2d(x, packed(pairer, conv.weight), bias)
        x = F.relu(paired_bn(layer.bn, x))
    return x


def _upsample_crop_pair(prev: torch.Tensor, paired_in: bool, lo: int = 0,
                        hi: int = 0, length: Optional[int] = None
                        ) -> torch.Tensor:
    """2x bilinear upsample of ``prev`` (paired with ``paired_in``), rows
    [lo, 2H - hi) and columns [lo, lo + length) kept (default: to the
    right edge), emitted paired with the pairing starting at column ``lo``
    (``length`` even). The JAX package's H pass (``_upsample_h_crop``) and
    paired W pass (``_upsample_w_crop_pair``) in one: ``layers.upsample2x``
    (the unpaired towers' arithmetic) on the unpaired view, the crop, and
    ``pair_w``. The even and odd output columns are the parity groups, and
    in channels-last memory the pairing of the cropped rows is a view
    (each row's (W, C) block is contiguous): no interleave is copied."""
    up = upsample2x(unpair_w(prev) if paired_in else prev)
    if length is None:
        length = up.shape[3] - lo
    return pair_w(up[:, :, lo:up.shape[2] - hi, lo:lo + length])


def _crop_w_paired(t: torch.Tensor, win: Tuple[int, int]) -> torch.Tensor:
    """Square-window crop of a paired (phase-0) feature map. An even
    ``lo`` is a block slice; an odd one re-phases: window-local block i
    covers columns (lo + 2i, lo + 2i + 1) = (block (lo-1)//2 + i,
    parity 1) and (block (lo+1)//2 + i, parity 0), two shifted channel
    halves whose concat is the locally paired crop."""
    lo, hi = win
    v = _nhwc(t)
    if lo % 2 == 0:
        return _nchw(v[:, lo:hi, lo // 2:hi // 2])
    c = v.shape[-1] // 2
    j0 = (lo - 1) // 2
    nb = (hi - lo) // 2
    return _nchw(torch.cat([v[:, lo:hi, j0:j0 + nb, c:],
                            v[:, lo:hi, j0 + 1:j0 + 1 + nb, :c]], dim=-1))


def supports_paired(plan: ValidPlan, in_size: int) -> bool:
    """Pairing needs every tower window of even width.

    An odd *bottom* window (every margin-304 dense geometry has one, e.g.
    1168->864 crops 63 of 73) is widened one column to the right; the
    level-0 upsample crop drops that column (every solved plan has
    ``up_lo >= 2`` of slack), so it needs one spare column in the bottom
    feature map. Odd level windows are not widened: the unpaired
    valid-region path serves them."""
    lo, hi = plan.bottom_win
    if (hi - lo) % 2 and hi >= (in_size >> len(plan.levels)):
        return False
    return all((lvl.skip_win[1] - lvl.skip_win[0]) % 2 == 0
               for lvl in plan.levels)


def paired_decoder_tower(blocks, bottom_p: torch.Tensor, skips_p,
                         plan: ValidPlan) -> torch.Tensor:
    """One summation-skip tower (``blocks``: its four ``ConvBlock``s) in
    the paired domain. ``bottom_p`` and ``skips_p`` are already cropped
    and paired (shared by the towers)."""
    prev = bottom_p
    for blk, lvl, skip_p in zip(blocks, plan.levels, skips_p):
        lo, hi = lvl.up_lo, lvl.up_hi
        # square windows: the kept width is the kept height (the odd
        # bottom's widening column falls outside it)
        up_p = _upsample_crop_pair(prev, True, lo, hi,
                                   2 * prev.shape[2] - hi - lo)
        prev = _paired_conv_block(blk, skip_p + up_p)
    return prev


def paired_head_outputs(model, x: torch.Tensor, plan: ValidPlan,
                        pclass_cells: int = 1,
                        data_parallel: int = 1) -> Dict[str, torch.Tensor]:
    """Width-paired counterpart of ``valid_decode.valid_head_outputs``:
    ``model`` (a ``NetDesc``) on NCHW input in [0, 1] -> {head_code: NCHW
    logits} of the central window, and the Patch-Class head on the
    unpaired bottom features.

    The encoder front runs paired too (``paired_encoder``) where
    ``use_paired_front`` says so: a basic-block ResNet, W % 4 == 0 and a
    per-device batch below 48 (``data_parallel``: devices the caller's
    batch spans), or ``CERBERUS_PAIRED_ENCODER=1`` / ``0``."""
    import os

    from .net_desc import pclass_for_cells
    from .paired_encoder import resnet_forward_paired, use_paired_front

    x = x.contiguous(memory_format=torch.channels_last)
    paired_front = use_paired_front(
        model.cfg.encoder_backbone_name, int(x.shape[3]), int(x.shape[0]),
        data_parallel, os.environ.get("CERBERUS_PAIRED_ENCODER"))
    feats = (resnet_forward_paired(model.backbone, x) if paired_front
             else model.backbone(x))
    bottom_feats = feats[-1]
    mapped = model.conv_map(bottom_feats)

    b0, b1 = plan.bottom_win
    # an odd bottom width takes one more column (see supports_paired)
    bw1 = b1 + 1 if (b1 - b0) % 2 else b1
    bottom_p = pair_w(mapped[:, :, b0:b1, b0:bw1])
    # coarse -> fine: feats[-2] .. feats[0]
    n_up = len(plan.levels)
    skips_p = []
    for b, lvl in enumerate(plan.levels):
        idx = n_up - 1 - b
        if paired_front and idx <= 1:
            skips_p.append(_crop_w_paired(feats[idx], lvl.skip_win))
        else:
            skips_p.append(pair_w(_crop(feats[idx], lvl.skip_win)))

    out: Dict[str, torch.Tensor] = {}
    towers = {}
    for decoder_name, head_name, key in model._heads:
        if decoder_name not in towers:
            towers[decoder_name] = paired_decoder_tower(
                model.decoder_head[decoder_name], bottom_p, skips_p, plan)
        head = model.output_head[decoder_name][head_name]
        y = _paired_conv_block(head.x[0], towers[decoder_name])
        conv = head.x[1].conv
        bias = None if conv.bias is None else packed(_pair_vec, conv.bias)
        out[key] = unpair_w(F.conv2d(y, packed(pair_conv1x1_kernel,
                                               conv.weight), bias))
    if "Patch-Class" in model.decoder_head:
        out["Patch-Class"] = pclass_for_cells(
            model.decoder_head["Patch-Class"], bottom_feats, pclass_cells)
    return out
