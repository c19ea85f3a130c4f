"""Multi-task U-Net: shared encoder, per-task summation-skip decoder
towers, 1x1 heads and the global-pool Patch-Class head.

Counterpart of ``cerberus_tpu/models/net_desc.py:104-474`` and the
reference ``models/net_desc.py``:
  * ``imgs / 255``; the encoder returns a 5-scale pyramid;
  * ``conv_map``: 1x1 f[-1]->f[-2], no bias;
  * each tower runs ``prev = blk(upsample2x(prev) + skip)`` over 4 levels;
  * per-output head: ConvBlock(f[-5], [96], 1) + Conv(96, out, 1);
  * Patch-Class: centre-crop the pre-``conv_map`` bottom features to 9x9
    when BOTH sides differ from 9 (the reference's ``and``), global
    average pool, BN-ReLU-Conv(512->256)-BN-ReLU-Conv(256->9); a dense
    window's per-144^2 grid pools 9x9 cells instead
    (``patch_class_head_grid``);
  * output keys ``"<decoder before '#'>-<head>"`` and ``"Patch-Class"``.

Module names equal the reference state_dict names
(``decoder_head.Nuclei#TYPE.0.block.1.bn.running_var``,
``output_head.Gland.INST.x.1.conv.weight``), so ``weights.tar["desc"]``
loads with ``load_state_dict(strict=True)``.

``NetDesc.forward_train`` is the training forward (JAX ``net_forward`` with
``bn_sink``, ``dropout_rng`` and ``remat``): batch-statistics BN
(``layers.BatchNorm2d``), dropout 0.3 in the Patch-Class MLP, full towers,
and ``torch.utils.checkpoint`` regions. Subtype fine-tuning
(``subtype_frozen_prefixes``) freezes every module but the active TYPE
decoders: ``NetDesc.train()`` keeps their BN layers in eval mode, and the
train step (``train/steps.py``) gives their parameters no gradient.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from .backbones import get_backbone
from .layers import (
    ConvBlock,
    batch_norm,
    center_crop,
    conv2d,
    dropout,
    dropout_mask,
    no_stat_fold,
    upsample2x,
)

REMAT_MODES = (False, True, "backbone", "towers")

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
    """The tissue classifier's MLP; pooling is ``patch_class_head`` /
    ``patch_class_head_grid``."""

    def __init__(self, cin, n_classes):
        super().__init__()
        self.bn1 = batch_norm(cin)
        self.conv1 = conv2d(cin, 256, 1)
        self.bn2 = batch_norm(256)
        self.conv2 = conv2d(256, n_classes, 1)

    def forward(self, pooled, keep: Optional[torch.Tensor] = None):
        """(N, C, h, w) pooled bottom features -> (N, n_classes, h, w);
        ``keep``: the dropout keep-mask after ``bn1`` (training only)."""
        x = F.relu(self.bn1(pooled))
        if keep is not None:
            x = dropout(x, keep)
        x = self.conv1(x)
        return self.conv2(F.relu(self.bn2(x)))


def patch_class_head(head: _PatchClassHead, bottom: torch.Tensor,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference head: centre-crop the bottom to 9x9 when BOTH sides
    differ from 9, global average pool, MLP -> (N, n_classes, 1, 1)."""
    if bottom.shape[-2] != 9 and bottom.shape[-1] != 9:
        bottom = center_crop(bottom, 9, 9)
    return head(bottom.mean(dim=(2, 3), keepdim=True), keep)


def patch_class_head_grid(head: _PatchClassHead, bottom: torch.Tensor,
                          n_cells: int) -> torch.Tensor:
    """Per-144^2-cell classification of a dense window (counterpart of
    ``cerberus_tpu/models/net_desc.py:226-243``).

    For input 144n + 304, the 448 window the reference would centre on
    output cell k has bottom features [9k, 9k + 28), whose centre 9x9 crop
    is dense bottom [9k + 9, 9k + 18): a 9x9 / stride-9 average pool over
    ``bottom[..., 9 : 9 + 9n, 9 : 9 + 9n]`` gives every cell's pooled
    feature. Returns (N, n_classes, n, n)."""
    x = bottom[..., 9:9 + 9 * n_cells, 9:9 + 9 * n_cells]
    return head(F.avg_pool2d(x, 9, 9))


def pclass_for_cells(head: _PatchClassHead, bottom: torch.Tensor,
                     n_cells: int) -> torch.Tensor:
    """The grid head when ``n_cells > 1`` and the bottom plane is the
    9n + 19 square the cell arithmetic assumes, else the reference head
    (``cerberus_tpu/models/net_desc.py:246-254``)."""
    expect = 9 * n_cells + 19
    if n_cells > 1 and tuple(bottom.shape[-2:]) == (expect, expect):
        return patch_class_head_grid(head, bottom, n_cells)
    return patch_class_head(head, bottom)


def head_output_channels(cfg: ModelConfig) -> Dict[str, int]:
    """{head code: channel count} in decoder order
    (``cerberus_tpu/models/net_desc.py:51-62``)."""
    out = {}
    for decoder_name, heads in cfg.decoder_info:
        if decoder_name not in cfg.considered_tasks:
            continue
        for head_name, ch in heads:
            if decoder_name == "Patch-Class":
                out["Patch-Class"] = ch
            else:
                out[decoder_name.split("#")[0] + "-" + head_name] = ch
    return out


def subtype_frozen_prefixes(cfg: ModelConfig
                            ) -> Optional[Callable[[str], bool]]:
    """Subtype fine-tuning (reference ``_freeze_weight``,
    ``cerberus_tpu/models/net_desc.py:257-282``): with ``subtype_gland`` or
    ``subtype_nuclei`` set, every module but the active TYPE decoder(s)
    and their output heads is frozen. Returns ``frozen(name) -> bool`` for
    parameter or module names, or None when no subtype flag is set."""
    if not (cfg.subtype_gland or cfg.subtype_nuclei):
        return None
    trainable = [name for name, flag in (("Gland#TYPE", cfg.subtype_gland),
                                         ("Nuclei#TYPE", cfg.subtype_nuclei))
                 if flag]

    def frozen(name: str) -> bool:
        return not any(name.startswith(("decoder_head.%s." % t,
                                        "output_head.%s." % t))
                       for t in trainable)

    return frozen


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

    def encode(self, x: torch.Tensor):
        """Encoder pyramid with ``conv_map`` applied to its last level, and
        the pre-``conv_map`` bottom features (the Patch-Class input)."""
        return self._conv_map(self.backbone(x))

    def _conv_map(self, feats):
        bottom = feats[-1]
        return feats[:-1] + [self.conv_map(bottom)], bottom

    def _branch(self, decoder_name: str, *feats) -> Dict[str, torch.Tensor]:
        """One decoder tower over the pyramid and its output heads ->
        {output key: logits}."""
        prev = feats[-1]
        for idx, blk in enumerate(self.decoder_head[decoder_name]):
            prev = blk(feats[-(idx + 2)] + upsample2x(prev))
        return {key: self.output_head[decoder_name][head_name](prev)
                for name, head_name, key in self._heads
                if name == decoder_name}

    def _decoders(self):
        return list(dict.fromkeys(name for name, _, _ in self._heads))

    def forward(self, x: torch.Tensor,
                pclass_cells: int = 1) -> Dict[str, torch.Tensor]:
        """Full towers. ``pclass_cells > 1``: the dense window's
        Patch-Class grid (``pclass_for_cells``)."""
        feats, bottom = self.encode(x)
        out: Dict[str, torch.Tensor] = {}
        for decoder_name in self._decoders():
            out.update(self._branch(decoder_name, *feats))
        if "Patch-Class" in self.decoder_head:
            out["Patch-Class"] = pclass_for_cells(
                self.decoder_head["Patch-Class"], bottom, pclass_cells)
        return out

    def train(self, mode: bool = True) -> "NetDesc":
        """``nn.Module.train``, except that under subtype fine-tuning the
        frozen modules' BN layers stay in eval mode (stored statistics,
        nothing folded), as JAX ``net_forward`` runs them
        (``cerberus_tpu/models/net_desc.py:370-398``)."""
        super().train(mode)
        frozen = subtype_frozen_prefixes(self.cfg)
        if mode and frozen is not None:
            for name, mod in self.named_modules():
                if isinstance(mod, nn.BatchNorm2d) and frozen(name + "."):
                    mod.eval()
        return self

    def forward_train(self, x: torch.Tensor, remat=False,
                      keep: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The training forward: NCHW float in [0, 1] -> {head: NCHW
        logits}, full towers, BN per its mode (``train()``).

        ``keep``: the Patch-Class dropout keep-mask, (N, C, 1, 1) bool for
        the pooled features after ``bn1``; else one is drawn from
        ``generator``; with neither, no dropout (JAX ``dropout_rng=None``).
        ``remat`` (``False``/``True``/``"backbone"``/``"towers"``) runs the
        encoder and/or each tower with its output heads as one
        ``torch.utils.checkpoint`` region whose recompute folds no BN
        statistics; the Patch-Class head stays outside every region."""
        if remat not in REMAT_MODES:
            raise ValueError("remat must be bool or 'backbone'/'towers', "
                             "got %r" % (remat,))
        feats, bottom = self._conv_map(self._region(
            self.backbone, remat in (True, "backbone"), self.backbone, x))
        out: Dict[str, torch.Tensor] = {}
        for decoder_name in self._decoders():
            out.update(self._region(
                self._branch, remat in (True, "towers"),
                nn.ModuleList([self.decoder_head[decoder_name],
                               self.output_head[decoder_name]]),
                decoder_name, *feats))
        if "Patch-Class" in self.decoder_head:
            head = self.decoder_head["Patch-Class"]
            if keep is None and generator is not None:
                keep = dropout_mask((bottom.shape[0], bottom.shape[1], 1, 1),
                                    generator, bottom.device)
            out["Patch-Class"] = patch_class_head(head, bottom, keep)
        return out

    @staticmethod
    def _region(fn, remat: bool, module: nn.Module, *args):
        """``fn(*args)``, as a checkpointed region when ``remat``."""
        if not remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              no_stat_fold(module)))


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
