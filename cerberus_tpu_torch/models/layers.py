"""Layer helpers with the reference's torch semantics (NCHW inside the port).

Counterpart of ``cerberus_tpu/models/layers.py:28-139``: convolutions pad
``k // 2`` on each side (torch style), batch norm with ``BN_EPS`` (eval:
stored statistics; training: ``BatchNorm2d`` below), ``MaxPool2d(3, 2, 1)``,
bilinear 2x upsampling with half-pixel centres
(``F.interpolate(..., align_corners=False)``, the same function as the JAX
separable formulation), a floor-offset centre crop and dropout with an
explicit keep-mask.

``ConvBNReLU.forward_valid`` / ``ConvBlock.forward_valid`` apply the same
modules with padding 0 (the counterpart of
``cerberus_tpu/models/valid_decode.py:94-99``): the interior values of the
padded convolution, on the module's own weights, so one ``state_dict``
drives both the full-tower and the valid-region path.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # running = (1 - m) * running + m * batch statistic
DROPOUT_KEEP = 0.7  # Patch-Class MLP dropout 0.3 (net_desc.py:64-76)


def conv2d(cin: int, cout: int, ksize: int, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, ksize, stride=stride, padding=ksize // 2,
                     bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the JAX package's training semantics
    (``cerberus_tpu/models/layers.py:50-65``, the step's fold at
    ``cerberus_tpu/train/steps.py:232-240``).

    Eval mode is ``nn.BatchNorm2d``'s. In training mode the layer
    normalises with the batch's biased variance and, while ``fold_stats``
    is set, folds the batch mean and the unbiased variance
    ``var * n / max(n - 1, 1)`` into the running statistics with momentum
    0.1. With one value per channel (the Patch-Class MLP at batch 1)
    ``nn.BatchNorm2d`` raises; this layer keeps JAX's guard: the output is
    the bias and the variance folded is 0. ``fold_stats`` is cleared while
    a checkpointed region recomputes (``no_stat_fold``), so a step folds
    each batch once."""

    fold_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        fold = self.fold_stats
        if n > 1:
            # a recompute folds into copies: the same op saves the same
            # tensors for the backward as the original forward did
            mean, var = ((self.running_mean, self.running_var) if fold else
                         (self.running_mean.clone(),
                          self.running_var.clone()))
            return torch.batch_norm(x, self.weight, self.bias, mean, var,
                                    True, BN_MOMENTUM, self.eps,
                                    torch.backends.cudnn.enabled)
        out = torch.batch_norm(x, self.weight, self.bias, None, None, True,
                               0.0, self.eps, False)
        if fold:
            with torch.no_grad():
                mean = x.detach().float().mean(dim=(0, 2, 3))
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(
                    mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1.0 - BN_MOMENTUM)
        return out


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


@contextlib.contextmanager
def no_stat_fold(module: nn.Module):
    """Within the region, no ``BatchNorm2d`` of ``module`` folds its batch
    statistics (they still normalise with them): the recompute context of
    a ``torch.utils.checkpoint`` region."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.fold_stats for m in layers]
    for m in layers:
        m.fold_stats = False
    try:
        yield
    finally:
        for m, value in zip(layers, saved):
            m.fold_stats = value


def dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``where(keep, x / 0.7, 0)`` (``cerberus_tpu/models/layers.py:136-139``
    with the mask given)."""
    return torch.where(keep, x / DROPOUT_KEEP, 0.0)


def dropout_mask(shape, generator: torch.Generator, device) -> torch.Tensor:
    """A keep-mask of ``shape`` (probability 0.7) drawn from ``generator``
    (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) \
        < DROPOUT_KEEP


def max_pool_3x3_s2() -> nn.MaxPool2d:
    return nn.MaxPool2d(kernel_size=3, stride=2, padding=1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, half-pixel centres, edge-clamped (the
    reference's ``upsample2x``, models/utils/net_layers.py:45-46)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def center_crop(x: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop the last two (H, W) dims around the centre, floor offset
    (reference ``models/utils/misc_utils.py:6-25``)."""
    h0 = int((x.shape[-2] - crop_h) * 0.5)
    w0 = int((x.shape[-1] - crop_w) * 0.5)
    return x[..., h0:h0 + crop_h, w0:w0 + crop_w]


class ConvBNReLU(nn.Module):
    """One ``ConvBlock`` layer: conv + BN + ReLU, with the reference's
    ``block.<i>.conv`` / ``block.<i>.bn`` parameter names."""

    def __init__(self, cin: int, cout: int, ksize: int):
        super().__init__()
        self.conv = conv2d(cin, cout, ksize)
        self.bn = batch_norm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def forward_valid(self, x):
        """The same layer with padding 0: each side shrinks by ``k // 2``."""
        return F.relu(self.bn(F.conv2d(x, self.conv.weight, self.conv.bias)))


class ConvBlock(nn.Module):
    """Sequence of conv+BN+ReLU layers (reference conv_layers.py:63-103)."""

    def __init__(self, cin: int, unit_ch, ksize: int):
        super().__init__()
        layers = []
        for cout in unit_ch:
            layers.append(ConvBNReLU(cin, cout, ksize))
            cin = cout
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x

    def forward_valid(self, x):
        for layer in self.block:
            x = layer.forward_valid(x)
        return x
