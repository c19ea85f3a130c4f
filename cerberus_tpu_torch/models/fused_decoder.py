"""The decoder towers as one bank of grouped convolutions (inference).

Counterpart of ``cerberus_tpu/models/fused_decoder.py``. The segmentation
towers (Lumen, Gland, Nuclei, Nuclei#TYPE, Gland#TYPE) are the same
summation-skip stack with other weights; the bank stacks them on the
channel axis and runs

  * level 1's first convolution as ONE plain convolution with T x the
    output channels (every tower reads the same ``skip + upsample``);
  * every other convolution as a ``groups=T`` convolution over the stacked
    (N, T*C, H, W) tensor, the skip added to every tower's upsample;
  * the heads as grouped 1x1 convolutions, each tower's output rows
    zero-padded to the widest head and sliced back.

BN is folded to (inv, shift) from the stored statistics. The bank runs
full towers (the JAX package turns valid-region decoding off whenever the
bank is given). A net whose towers are not plain ``ConvBlock`` stacks (the
DSF-CNN G-conv towers) has no bank: ``build_fused_decoder`` raises
``KeyError`` there, as the JAX one does, and the step runs the towers one
after another. Tensors are NCHW.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .layers import BN_EPS, upsample2x

N_LEVELS = 4  # decoder blocks a tower
N_LAYERS = 2  # conv layers a block


def tower_names(cfg: ModelConfig) -> List[str]:
    return [name for name in cfg.active_decoders() if name != "Patch-Class"]


def _fold_bn(state, key: str) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = state[key + ".weight"] / torch.sqrt(state[key + ".running_var"]
                                              + BN_EPS)
    return inv, state[key + ".bias"] - state[key + ".running_mean"] * inv


def _stack_layer(state, names, key: str) -> Dict[str, torch.Tensor]:
    """The layer ``key`` ("decoder_head.{}.<blk>.block.<i>") of every
    tower: conv weights and biases concatenated on the output channels,
    BN folded and concatenated."""
    folded = [_fold_bn(state, key.format(n) + ".bn") for n in names]
    return {"weight": torch.cat([state[key.format(n) + ".conv.weight"]
                                 for n in names]),
            "bias": torch.cat([state[key.format(n) + ".conv.bias"]
                               for n in names]),
            "inv": torch.cat([f[0] for f in folded]),
            "shift": torch.cat([f[1] for f in folded])}


def build_fused_decoder(model) -> Tuple[Dict, Tuple]:
    """``model`` (a ``NetDesc``) -> (bank, head_specs): the stacked
    weights of every level and head, and (decoder, head, out channels) in
    tower order. ``KeyError`` where a tower is no ``ConvBlock`` stack."""
    cfg = model.cfg
    state = {k: v.detach() for k, v in model.state_dict().items()}
    names = tower_names(cfg)
    bank = {"levels": [
        [_stack_layer(state, names,
                      "decoder_head.{}" + ".%d.block.%d" % (blk, layer))
         for layer in range(N_LAYERS)] for blk in range(N_LEVELS)]}
    head_specs = []
    for name in names:
        (head_name, out_ch), = dict(cfg.decoder_kwargs[name]).items()
        head_specs.append((name, head_name, out_ch))
    bank["head_hidden"] = _stack_layer(
        state, [("%s.%s" % (n, h)) for n, h, _ in head_specs],
        "output_head.{}.x.0.block.0")
    max_out = max(s[2] for s in head_specs)
    weights, biases = [], []
    for name, head_name, out_ch in head_specs:
        base = "output_head.%s.%s.x.1.conv" % (name, head_name)
        pad = max_out - out_ch
        weights.append(F.pad(state[base + ".weight"],
                             (0, 0, 0, 0, 0, 0, 0, pad)))
        biases.append(F.pad(state[base + ".bias"], (0, pad)))
    bank["head_out"] = {"weight": torch.cat(weights),
                        "bias": torch.cat(biases)}
    return bank, tuple(head_specs)


def _bn_relu(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    return F.relu(x * layer["inv"].to(x.dtype)[None, :, None, None]
                  + layer["shift"].to(x.dtype)[None, :, None, None])


def fused_decoder_forward(bank: Dict, head_specs: Tuple,
                          feats: List[torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """``feats``: the encoder pyramid with ``conv_map`` applied to its
    last level -> {head_code: NCHW logits} of every tower."""
    n_towers = len(head_specs)
    prev = None
    for blk, (first, second) in enumerate(bank["levels"]):
        skip = feats[-(blk + 2)]
        if prev is None:
            # every tower reads this input: one plain, widened convolution
            x = F.conv2d(skip + upsample2x(feats[-1]), first["weight"],
                         first["bias"], padding=1)
        else:
            # skip + upsample per tower, stacked: each upsample is one
            # tower's (the stacked (N, T*C, 2H, 2W) output can pass
            # upsample_bilinear2d's INT_MAX elements at dense sizes), and
            # cat keeps the channels-last format of the convolutions
            x = F.conv2d(torch.cat([skip + upsample2x(p)
                                    for p in prev.chunk(n_towers, dim=1)],
                                   dim=1), first["weight"], first["bias"],
                         padding=1, groups=n_towers)
        x = _bn_relu(x, first)
        x = F.conv2d(x, second["weight"], second["bias"], padding=1,
                     groups=n_towers)
        prev = _bn_relu(x, second)
    hidden = bank["head_hidden"]
    x = _bn_relu(F.conv2d(prev, hidden["weight"], hidden["bias"],
                          groups=n_towers), hidden)
    x = F.conv2d(x, bank["head_out"]["weight"], bank["head_out"]["bias"],
                 groups=n_towers)
    max_out = max(s[2] for s in head_specs)
    return {name.split("#")[0] + "-" + head_name:
            x[:, t * max_out:t * max_out + out_ch]
            for t, (name, head_name, out_ch) in enumerate(head_specs)}


def fused_head_outputs(model, bank: Dict, head_specs: Tuple, x: torch.Tensor,
                       pclass_cells: int = 1) -> Dict[str, torch.Tensor]:
    """``model`` (a ``NetDesc``) on NCHW input in [0, 1] with the bank in
    place of its towers -> {head_code: NCHW logits} (full towers) and the
    Patch-Class head (JAX ``model_head_outputs`` with ``fused``)."""
    from .net_desc import pclass_for_cells

    feats, bottom = model.encode(x)
    out = fused_decoder_forward(bank, head_specs, feats)
    if "Patch-Class" in model.decoder_head:
        out["Patch-Class"] = pclass_for_cells(
            model.decoder_head["Patch-Class"], bottom, pclass_cells)
    return out
