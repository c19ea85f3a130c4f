"""Forward FLOP counts of the inference step's network, per window and per
output pixel, from ``torch.utils.flop_counter.FlopCounterMode`` on the meta
device (no weights, no data: the count depends only on the shapes). It
counts the convolutions and matrix products, two FLOPs a multiply-add; the
elementwise work (batch norm, ReLU, upsampling, softmax) is not in it.

Run ``python -m cerberus_tpu_torch.utils.flops`` for the table of the
default model (ResNet-34, the six heads) on its four forward paths, then
of the DSF-CNN nets (the five heads without Patch-Class) on their full
towers at 448->144. A G-convolution counts its kernel synthesis (an einsum,
once a forward) besides the convolution.
"""
from __future__ import annotations

import json
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import DEFAULT_DECODER_KWARGS, ModelConfig

# (name, input, output, valid-region towers)
PATHS = (("windowed_full", 448, 144, False),
         ("windowed_valid", 448, 144, True),
         ("dense_full", 1168, 864, False),
         ("dense_valid", 1168, 864, True))


DSF_BACKBONES = ("dsf_cnn_4", "dsf_cnn_8", "dsf_cnn_12")


def default_config(backbone: str = "resnet34") -> ModelConfig:
    """The six default heads; a DSF-CNN encoder takes the five without
    Patch-Class, which it cannot serve."""
    decoders = {k: v for k, v in DEFAULT_DECODER_KWARGS.items()
                if k != "Patch-Class" or backbone[:3] != "dsf"}
    return ModelConfig.from_kwargs({
        "encoder_backbone_name": backbone, "decoder_kwargs": decoders,
        "considered_tasks": list(decoders)})


def forward_flops(in_size: int, out_size: int, valid_region: bool,
                  cfg: Optional[ModelConfig] = None, batch: int = 1) -> dict:
    """FLOPs of one forward of ``batch`` windows: the whole network and the
    encoder alone."""
    from ..infer.steps import head_outputs
    from ..models.net_desc import NetDesc

    cfg = cfg or default_config()
    with torch.device("meta"):
        model = NetDesc(cfg).eval()
        x = torch.empty((batch, 3, in_size, in_size))
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            head_outputs(model, x, out_size, valid_region)
        total = counter.get_total_flops()
        with FlopCounterMode(display=False) as counter:
            model.backbone(x)
        encoder = counter.get_total_flops()
    return {"flops": total, "encoder_flops": encoder}


def flop_table() -> list:
    rows = []
    paths = [("resnet34",) + p for p in PATHS] + [
        (b, "windowed_full", 448, 144, False) for b in DSF_BACKBONES]
    for backbone, name, in_size, out_size, valid in paths:
        counts = forward_flops(in_size, out_size, valid,
                               default_config(backbone))
        rows.append({"backbone": backbone, "path": name, "in": in_size,
                     "out": out_size,
                     "gflop_per_window": counts["flops"] / 1e9,
                     "encoder_gflop_per_window": counts["encoder_flops"] / 1e9,
                     "mflop_per_output_px": counts["flops"] / out_size ** 2
                     / 1e6})
    return rows


if __name__ == "__main__":
    for row in flop_table():
        print(json.dumps(row))
