"""Width-paired training decoder towers and output heads.

Counterpart of ``cerberus_tpu/models/paired_tower.py``. Training runs the
five summation-skip towers at full resolution with SAME convolutions; the
JAX package lowers their 64-channel levels (blocks ``PAIR_FROM`` and up:
the two finest of every basic-block ResNet's tower) and the output heads
onto the paired layout of ``paired_decode``, while the coarse 256- and
128-channel blocks stay unpaired. Built from:

  * ``pair_same3_kernel`` / ``conv_paired(w_pad=1)``: a SAME 3x3 as a
    phase-0 block convolution (``paired_encoder``);
  * ``pair_conv1x1_kernel``: the block-diagonal 1x1;
  * ``_upsample_crop_pair`` over the whole map: the upsample's even and
    odd columns are the parity groups, paired by a view;
  * ``paired_bn``: BN on the unpaired view, whose training statistics are
    the exact fold of the paired ones (``paired_decode``).

Tensors are NCHW; the paired path runs channels-last (``paired_decode``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .layers import upsample2x
from .paired_decode import (
    _pair_vec,
    _upsample_crop_pair,
    packed,
    pair_conv1x1_kernel,
    pair_w,
    paired_bn,
    unpair_w,
)
from .paired_encoder import conv_paired, pair_same3_kernel

PAIR_FROM = 2  # first tower block lowered paired: the 64-channel levels


def _paired_conv_block_train(block, x: torch.Tensor) -> torch.Tensor:
    """A ``layers.ConvBlock`` (SAME) on a paired tensor: conv (+ bias) ->
    BN in the module's mode -> ReLU per layer."""
    for layer in block.block:
        conv = layer.conv
        bias = None if conv.bias is None else packed(_pair_vec, conv.bias)
        if conv.weight.shape[-1] == 1:
            x = conv_paired(x, packed(pair_conv1x1_kernel, conv.weight),
                            bias, w_pad=0)
        else:
            x = conv_paired(x, packed(pair_same3_kernel, conv.weight), bias,
                            w_pad=1)
        x = F.relu(paired_bn(layer.bn, x))
    return x


def paired_train_tower(blocks, feats: List[torch.Tensor],
                       pair_from: int = PAIR_FROM) -> torch.Tensor:
    """One summation-skip tower (``blocks``: its ``ConvBlock``s) over the
    unpaired pyramid ``feats`` (``conv_map`` applied to the last level):
    blocks below ``pair_from`` run unpaired, the rest paired. Returns the
    finest map paired (phase 0)."""
    n_blocks = len(feats) - 1
    assert 0 <= pair_from < n_blocks, (pair_from, n_blocks)
    prev = feats[-1]
    for blk in range(n_blocks):
        skip = feats[-(blk + 2)]
        if blk < pair_from:
            prev = blocks[blk](skip + upsample2x(prev))
        else:
            up_p = _upsample_crop_pair(prev, paired_in=blk > pair_from)
            prev = _paired_conv_block_train(blocks[blk], pair_w(skip) + up_p)
    return prev


def paired_train_head(head, prev_p: torch.Tensor) -> torch.Tensor:
    """An output head (``net_desc._OutputHead``) on a paired tower map ->
    UNPAIRED logits."""
    x = _paired_conv_block_train(head.x[0], prev_p)
    conv = head.x[1].conv
    bias = None if conv.bias is None else packed(_pair_vec, conv.bias)
    return unpair_w(conv_paired(x, packed(pair_conv1x1_kernel, conv.weight),
                                bias, w_pad=0))
