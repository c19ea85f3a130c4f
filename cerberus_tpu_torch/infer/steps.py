"""The inference step: forward + per-head activation + centre crop -> one
canvas-ready tensor.

Counterpart of ``cerberus_tpu/infer/steps.py:74-200`` (reference
``infer_step``, ``models/run_desc.py:439-502``):
  * INST heads -> softmax over channels, drop channel 0;
  * TYPE heads -> softmax then argmax (1 channel);
  * Patch-Class -> argmax of softmax, broadcast over the output window;
  * segmentation heads centre-cropped to the output window.
Channels are concatenated in ``make_channel_index_map`` order into one
(N, out, out, C) NHWC tensor. The towers run at full size and the result is
cropped; the JAX default (valid-region decoding) is bit-identical to that
and is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import ModelConfig
from ..data.patching import make_channel_index_map
from ..models.layers import center_crop
from ..models.net_desc import NetDesc


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
            cls = torch.argmax(torch.softmax(out, dim=1), dim=1)  # (N, 1, 1)
            chunk = cls[:, None].float().expand(-1, 1, output_shape,
                                                output_shape)
        elif head_code.endswith("-INST"):
            out = center_crop(out, output_shape, output_shape)
            chunk = torch.softmax(out, dim=1)[:, 1:]
        else:  # TYPE: softmax -> argmax
            out = center_crop(out, output_shape, output_shape)
            chunk = torch.argmax(torch.softmax(out, dim=1), dim=1)[:, None]
            chunk = chunk.float()
        chunks.append(chunk)
    return torch.cat(chunks, dim=1).permute(0, 2, 3, 1).to(out_dtype)


def infer_outputs(model: NetDesc, imgs: torch.Tensor, cfg: ModelConfig,
                  output_shape: int, compute_dtype=torch.float32,
                  out_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC batch -> (N, output_shape, output_shape, C) canvas
    tensor. ``compute_dtype`` other than f32 runs the forward under
    autocast (bf16 on the card, as the JAX package computes in bf16)."""
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), torch.autocast(
            device_type=x.device.type, dtype=compute_dtype,
            enabled=compute_dtype != torch.float32):
        pred = model(x)
    return canvas_from_logits(pred, cfg, output_shape, out_dtype)


def make_infer_step(model: NetDesc, cfg: ModelConfig, output_shape: int = 144,
                    compute_dtype=torch.bfloat16,
                    out_dtype=torch.float16) -> Callable:
    """Bind the step for one output shape: uint8 NHWC batch on the model's
    device -> (N, out, out, C) tensor of ``out_dtype``."""
    def step(imgs: torch.Tensor) -> torch.Tensor:
        return infer_outputs(model, imgs, cfg, output_shape, compute_dtype,
                             out_dtype)

    return step
