"""Backbone registry (ResNets only in the port so far).

Counterpart of ``cerberus_tpu/models/backbones/__init__.py`` and the
reference's filter tables (``models/backbone/__init__.py:13-73``).
"""
from __future__ import annotations

from .resnet import RESNET_SPECS, ResNet

FILTER_INFO = {
    "resnet18": [64, 64, 128, 256, 512],
    "resnet34": [64, 64, 128, 256, 512],
    "resnet50": [64, 256, 512, 1024, 2048],
    "resnet101": [64, 256, 512, 1024, 2048],
    "resnet152": [64, 256, 512, 1024, 2048],
}


def get_backbone(backbone_name: str):
    """Returns (backbone module, filter pyramid)."""
    if backbone_name not in RESNET_SPECS:
        raise NotImplementedError(
            "backbone %r is not ported yet (ResNets only)" % backbone_name)
    return ResNet(backbone_name), FILTER_INFO[backbone_name]
