"""The inference step: forward + per-head activation + centre crop -> one
canvas-ready tensor.

Counterpart of ``cerberus_tpu/infer/steps.py:74-200`` (reference
``infer_step``, ``models/run_desc.py:439-502``):
  * INST heads -> softmax over channels, drop channel 0;
  * TYPE heads -> softmax then argmax (1 channel);
  * Patch-Class -> argmax of softmax, each class broadcast over its block
    of the output window (one block, or the dense window's per-144^2 grid);
  * segmentation heads centre-cropped to the output window.
Channels are concatenated in ``make_channel_index_map`` order into one
(N, out, out, C) NHWC tensor.

The forward is valid-region decoding by default (``models/valid_decode``):
the towers run on the kept window plus its margin, and where the geometry
admits no plan the towers run at full size and are cropped.
``CERBERUS_VALID_REGION=0`` selects the full towers, as it does for the
JAX package. ``CERBERUS_DEBUG=1`` (also read when a step is bound) checks
every head's logits for NaN and Inf.

The JAX package's TPU lowerings are opt-in knobs with its meaning and its
off-TPU defaults (off): ``CERBERUS_PAIRED=1`` runs the valid-region towers
width-paired (``models/paired_decode``; the encoder front too where
``paired_encoder.use_paired_front`` says so, ``CERBERUS_PAIRED_ENCODER``
overriding), and ``fuse_decoders=True`` runs the towers as one bank of
grouped convolutions (``models/fused_decoder``; full towers).
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig
from ..data.patching import make_channel_index_map
from ..models.layers import center_crop
from ..models.fused_decoder import build_fused_decoder, fused_head_outputs
from ..models.net_desc import NetDesc
from ..models.paired_decode import paired_head_outputs, supports_paired
from ..models.valid_decode import supports_valid_region, valid_head_outputs
from ..utils.debug import check_finite, debug_mode_requested

_UNFUSED_LOGGED = set()


def pclass_cells(in_size: int, out_size: int) -> int:
    """Patch-Class cells per side: a dense window (output a multiple of
    144 at the 304 px margin of 448 -> 144) keeps the reference's
    per-144^2 class, on every forward path; any other window has one."""
    if out_size % 144 == 0 and in_size - out_size == 304:
        return out_size // 144
    return 1


def canvas_from_logits(pred: Dict[str, torch.Tensor], cfg: ModelConfig,
                       output_shape: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """{head_code: NCHW logits} -> (N, out, out, C) NHWC canvas tensor.
    Activations run in f32 whatever the compute dtype."""
    idx_dict, _ = make_channel_index_map(cfg.active_decoder_kwargs)
    chunks = []
    for head_code in idx_dict:
        out = pred[head_code].float()
        if head_code == "Patch-Class":
            cls = torch.argmax(torch.softmax(out, dim=1), dim=1)  # (N, n, n)
            cell_px = output_shape // cls.shape[-1]
            chunk = cls.repeat_interleave(cell_px, dim=1).repeat_interleave(
                cell_px, dim=2)[:, None].float()
        elif head_code.endswith("-INST"):
            out = center_crop(out, output_shape, output_shape)
            chunk = torch.softmax(out, dim=1)[:, 1:]
        else:  # TYPE: softmax -> argmax
            out = center_crop(out, output_shape, output_shape)
            chunk = torch.argmax(torch.softmax(out, dim=1), dim=1)[:, None]
            chunk = chunk.float()
        chunks.append(chunk)
    return torch.cat(chunks, dim=1).permute(0, 2, 3, 1).to(out_dtype)


def head_outputs(model: NetDesc, x: torch.Tensor, output_shape: int,
                 valid_region: bool = True, paired: bool = False,
                 fused=None) -> Dict[str, torch.Tensor]:
    """NCHW input in [0, 1] -> {head_code: NCHW logits}: valid-region
    towers where ``supports_valid_region`` gives a plan (paired with
    ``paired`` where ``supports_paired`` holds), else full towers, or the
    bank ``fused`` (``(bank, head_specs)`` of ``build_fused_decoder``),
    which always runs full towers (``cerberus_tpu/infer/steps.py:
    74-135``)."""
    in_size = int(x.shape[-1])
    cells = pclass_cells(in_size, output_shape)
    plan = (supports_valid_region(model.cfg, in_size, output_shape)
            if valid_region and fused is None else None)
    if plan is not None:
        if paired and supports_paired(plan, in_size):
            return paired_head_outputs(model, x, plan, cells)
        return valid_head_outputs(model, x, plan, cells)
    if fused is not None:
        return fused_head_outputs(model, *fused, x, cells)
    return model(x, cells)


def infer_outputs(model: NetDesc, imgs: torch.Tensor, cfg: ModelConfig,
                  output_shape: int, compute_dtype=torch.float32,
                  out_dtype=torch.float32, valid_region: bool = True,
                  check: bool = False, paired: bool = False,
                  fused=None) -> torch.Tensor:
    """uint8 NHWC batch -> (N, output_shape, output_shape, C) canvas
    tensor. ``compute_dtype`` other than f32 runs the forward under
    autocast (bf16 on the card, as the JAX package computes in bf16).
    ``check``: raise ``FloatingPointError`` naming a head whose logits hold
    NaN or Inf."""
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), torch.autocast(
            device_type=x.device.type, dtype=compute_dtype,
            enabled=compute_dtype != torch.float32):
        pred = head_outputs(model, x, output_shape, valid_region, paired,
                            fused)
    if check:
        for head_code, logits in pred.items():
            check_finite(head_code, logits)
    return canvas_from_logits(pred, cfg, output_shape, out_dtype)


def bank_or_none(model: NetDesc) -> Optional[tuple]:
    """``build_fused_decoder(model)``, or None where it raises
    ``KeyError`` (towers that are no ``ConvBlock`` stacks, as DSF-CNN's):
    the JAX package's rule (``cerberus_tpu/infer/steps.py:186-192``), the
    step then running the towers one after another. Logged once per
    encoder."""
    try:
        return build_fused_decoder(model)
    except KeyError as err:
        arch = model.cfg.encoder_backbone_name
        if arch not in _UNFUSED_LOGGED:
            _UNFUSED_LOGGED.add(arch)
            logging.getLogger(__name__).info(
                "fuse_decoders: %s towers have no grouped bank (missing %s);"
                " running them one after another", arch, err)
        return None


def make_infer_step(model: NetDesc, cfg: ModelConfig, output_shape: int = 144,
                    compute_dtype=torch.bfloat16,
                    out_dtype=torch.float16,
                    fuse_decoders: bool = False) -> Callable:
    """Bind the step for one output shape: uint8 NHWC batch on the model's
    device -> (N, out, out, C) tensor of ``out_dtype``. Read here, as the
    JAX package's ``make_infer_step`` reads them: valid-region decoding
    unless ``CERBERUS_VALID_REGION=0``; the paired towers with
    ``CERBERUS_PAIRED=1`` (default 0: the card is not a TPU); the NaN/Inf
    check where ``CERBERUS_DEBUG`` is set. ``fuse_decoders``: the grouped
    bank (``bank_or_none``), built here from the model's weights."""
    valid_region = os.environ.get("CERBERUS_VALID_REGION", "1") != "0"
    paired = os.environ.get("CERBERUS_PAIRED", "0") == "1"
    check = debug_mode_requested()
    fused = bank_or_none(model) if fuse_decoders else None

    def step(imgs: torch.Tensor) -> torch.Tensor:
        return infer_outputs(model, imgs, cfg, output_shape, compute_dtype,
                             out_dtype, valid_region, check, paired, fused)

    return step
