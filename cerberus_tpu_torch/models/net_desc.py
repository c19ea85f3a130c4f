"""Multi-task U-Net (eval path): shared encoder, per-task summation-skip
decoder towers, 1x1 heads and the global-pool Patch-Class head.

Counterpart of ``cerberus_tpu/models/net_desc.py:104-474`` (inference
only) and the reference ``models/net_desc.py``:
  * ``imgs / 255``; the encoder returns a 5-scale pyramid;
  * ``conv_map``: 1x1 f[-1]->f[-2], no bias;
  * each tower runs ``prev = blk(upsample2x(prev) + skip)`` over 4 levels;
  * per-output head: ConvBlock(f[-5], [96], 1) + Conv(96, out, 1);
  * Patch-Class: centre-crop the pre-``conv_map`` bottom features to 9x9
    when BOTH sides differ from 9 (the reference's ``and``), global
    average pool, BN-ReLU-Conv(512->256)-BN-ReLU-Conv(256->9);
  * output keys ``"<decoder before '#'>-<head>"`` and ``"Patch-Class"``.

Module names equal the reference state_dict names
(``decoder_head.Nuclei#TYPE.0.block.1.bn.running_var``,
``output_head.Gland.INST.x.1.conv.weight``), so ``weights.tar["desc"]``
loads with ``load_state_dict(strict=True)``. Training-only branches
(batch-statistics BN, dropout, remat, subtype freezing) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from .backbones import get_backbone
from .layers import ConvBlock, batch_norm, center_crop, conv2d, upsample2x

CLS_HEAD_INT_CH = 96  # classification-head hidden width (net_layers.py:31)


class _Conv(nn.Module):
    """Holds one conv under the attribute name ``conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class _OutputHead(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.x = nn.ModuleList([ConvBlock(cin, [CLS_HEAD_INT_CH], 1),
                                _Conv(CLS_HEAD_INT_CH, cout)])

    def forward(self, x):
        return self.x[1](self.x[0](x))


class _PatchClassHead(nn.Module):
    def __init__(self, cin, n_classes):
        super().__init__()
        self.bn1 = batch_norm(cin)
        self.conv1 = conv2d(cin, 256, 1)
        self.bn2 = batch_norm(256)
        self.conv2 = conv2d(256, n_classes, 1)

    def forward(self, bottom):
        if bottom.shape[-2] != 9 and bottom.shape[-1] != 9:
            bottom = center_crop(bottom, 9, 9)
        x = bottom.mean(dim=(2, 3), keepdim=True)
        x = self.conv1(F.relu(self.bn1(x)))
        return self.conv2(F.relu(self.bn2(x)))


class NetDesc(nn.Module):
    """``forward(x)``: NCHW float in [0, 1] -> {head_code: NCHW logits}."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone, filters = get_backbone(cfg.encoder_backbone_name)
        self.conv_map = conv2d(filters[-1], filters[-2], 1, bias=False)
        self.decoder_head = nn.ModuleDict()
        self.output_head = nn.ModuleDict()
        self._heads = []  # (decoder name, head name, output key)
        for decoder_name, heads in cfg.decoder_info:
            if decoder_name not in cfg.considered_tasks:
                continue
            if decoder_name == "Patch-Class":
                (_, n_cls), = heads
                self.decoder_head[decoder_name] = _PatchClassHead(filters[-1],
                                                                  n_cls)
                continue
            spec = [(filters[-2], [filters[-2], filters[-3]]),
                    (filters[-3], [filters[-3], filters[-4]]),
                    (filters[-4], [filters[-4], filters[-5]]),
                    (filters[-5], [filters[-5], filters[-5]])]
            self.decoder_head[decoder_name] = nn.ModuleList(
                [ConvBlock(cin, unit, 3) for cin, unit in spec])
            outs = nn.ModuleDict()
            for head_name, out_ch in heads:
                outs[head_name] = _OutputHead(filters[-5], out_ch)
                self._heads.append((decoder_name, head_name,
                                    decoder_name.split("#")[0] + "-"
                                    + head_name))
            self.output_head[decoder_name] = outs

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x)
        bottom = feats[-1]
        feats = feats[:-1] + [self.conv_map(bottom)]
        out: Dict[str, torch.Tensor] = {}
        towers = {}
        for decoder_name, head_name, key in self._heads:
            if decoder_name not in towers:
                prev = feats[-1]
                for idx, blk in enumerate(self.decoder_head[decoder_name]):
                    prev = blk(feats[-(idx + 2)] + upsample2x(prev))
                towers[decoder_name] = prev
            out[key] = self.output_head[decoder_name][head_name](
                towers[decoder_name])
        if "Patch-Class" in self.decoder_head:
            out["Patch-Class"] = self.decoder_head["Patch-Class"](bottom)
        return out


def net_forward(model: NetDesc, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """NHWC images (any numeric dtype, 0-255) -> {head_code: NHWC logits},
    the layout of ``cerberus_tpu.models.net_desc.net_forward``."""
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    return {k: v.permute(0, 2, 3, 1) for k, v in model(x).items()}


def init_weights(model: NetDesc, generator: Optional[torch.Generator] = None
                 ) -> NetDesc:
    """Reference-equivalent random init: kaiming-normal fan_out convs with
    zero bias, unit/zero BN, and torch's default uniform init for
    ``conv_map`` (which the reference never re-initialises)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                if name == "conv_map":
                    bound = 1.0 / math.sqrt(w[0].numel())
                    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1)
                            * bound)
                else:
                    std = math.sqrt(2.0 / (w.shape[0] * w.shape[2]
                                           * w.shape[3]))
                    w.copy_(torch.randn(w.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model
