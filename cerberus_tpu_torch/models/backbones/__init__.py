"""Backbone registry: name -> (encoder module, filter pyramid).

Counterpart of ``cerberus_tpu/models/backbones/__init__.py`` and the
reference's filter tables (``models/backbone/__init__.py:13-73``). The
DSF-CNN encoders (``dsf_cnn_*``) and their G-conv decoders are not ported
yet.
"""
from __future__ import annotations

from .densenet import DenseNet121
from .mobilenet import MobileNetV2
from .resnet import RESNET_SPECS, ResNet
from .unet_encoder import UNetEncoder

FILTER_INFO = {
    "resnet18": [64, 64, 128, 256, 512],
    "resnet34": [64, 64, 128, 256, 512],
    "resnet50": [64, 256, 512, 1024, 2048],
    "resnet101": [64, 256, 512, 1024, 2048],
    "resnet152": [64, 256, 512, 1024, 2048],
    "densenet121": [64, 256, 512, 1024, 1024],
    "mobilenet_v2": [32, 24, 32, 96, 1280],
    "unet_encoder": [64, 128, 256, 512, 1024],
}

_ENCODERS = {"densenet121": DenseNet121, "mobilenet_v2": MobileNetV2,
             "unet_encoder": UNetEncoder}


def get_backbone(backbone_name: str):
    """Returns (backbone module, filter pyramid)."""
    if backbone_name in RESNET_SPECS:
        return ResNet(backbone_name), FILTER_INFO[backbone_name]
    if backbone_name in _ENCODERS:
        return _ENCODERS[backbone_name](), FILTER_INFO[backbone_name]
    raise NotImplementedError(
        "backbone %r is not ported yet (the DSF-CNN encoders are still to "
        "port)" % backbone_name)
