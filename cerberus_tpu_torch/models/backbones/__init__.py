"""Backbone registry: name -> (encoder module, filter pyramid).

Counterpart of ``cerberus_tpu/models/backbones/__init__.py`` and the
reference's filter tables (``models/backbone/__init__.py:13-73``). The
DSF-CNN encoders (``dsf_cnn_{4,8,12}``) give channels per orientation:
their pyramid level ``i`` has ``O * FILTER_INFO[name][i]`` channels.
"""
from __future__ import annotations

from .densenet import DenseNet121
from .dsf_cnn import DSF_CNN
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
    "dsf_cnn_4": [10, 16, 32, 32, 32],
    "dsf_cnn_8": [10, 16, 32, 32, 32],
    "dsf_cnn_12": [10, 16, 32, 32, 32],
}

_ENCODERS = {"densenet121": DenseNet121, "mobilenet_v2": MobileNetV2,
             "unet_encoder": UNetEncoder}


def get_backbone(backbone_name: str):
    """Returns (backbone module, filter pyramid)."""
    if backbone_name in RESNET_SPECS:
        return ResNet(backbone_name), FILTER_INFO[backbone_name]
    if backbone_name in _ENCODERS:
        return _ENCODERS[backbone_name](), FILTER_INFO[backbone_name]
    if backbone_name in ("dsf_cnn_4", "dsf_cnn_8", "dsf_cnn_12"):
        return (DSF_CNN(int(backbone_name.split("_")[-1])),
                FILTER_INFO[backbone_name])
    raise NotImplementedError("backbone %r is not available"
                              % backbone_name)
