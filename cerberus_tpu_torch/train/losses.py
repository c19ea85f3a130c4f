"""Loss functions for multi-task training (NCHW logits, class dim 1).

Counterpart of ``cerberus_tpu/train/losses.py`` (reference
``models/utils/loss_utils.py``):
  * ``xentropy_loss``: per-pixel cross entropy over the class logits;
  * ``dice_loss``: batch-joint dice summed over classes, optional mask,
    smooth 1e-3;
  * ``focal_loss``, ``mse_loss``, ``msge_loss`` (HoVerNet gradient MSE with
    the normalised-coordinate Sobel kernels) and ``simclr_loss``;
  * ``class_weight_map``: the per-pixel weight LUT of the TYPE heads.

The JAX functions take channel-last arrays; these take the PyTorch layout
(N, C, H, W) and compute the same values. The multi-task composition
lives in ``train/steps.py``.

``group``: in the data-parallel step each rank holds some rows of the
global batch, and the batch-joint sums (dice's intersection and totals,
the MSGE focus) go through a differentiable ``all_reduce`` over the
process group (``models/layers.allsum``), so every rank computes the global batch's
value, as the JAX package's step computes it on its sharded batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import allsum


def xentropy_loss(true: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy. true: (N, ...) int labels; logits:
    (N, C, ...) -> (N, ...)."""
    log_p = F.log_softmax(logits, dim=1)
    return -log_p.gather(1, true.long().unsqueeze(1)).squeeze(1)


def dice_loss(true_onehot: torch.Tensor, pred_prob: torch.Tensor,
              mask=None, smooth: float = 1.0e-3, group=None) -> torch.Tensor:
    """Batch-joint dice over classes. true_onehot/pred_prob: (N, C, H, W);
    mask broadcastable to them. Sums (1 - dice) over classes; with
    ``group``, over the rows of every rank."""
    if mask is not None:
        true_onehot = true_onehot * mask
        pred_prob = pred_prob * mask
    dims = (0, 2, 3)
    sums = allsum(torch.stack([torch.sum(pred_prob * true_onehot, dim=dims),
                               torch.sum(pred_prob, dim=dims),
                               torch.sum(true_onehot, dim=dims)]), group)
    inse, left, right = sums[0], sums[1], sums[2]
    loss = 1.0 - (2.0 * inse + smooth) / (left + right + smooth)
    return torch.sum(loss)


def focal_loss(true: torch.Tensor, logits: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on per-pixel logits (class dim 1)."""
    log_pt = -xentropy_loss(true, logits)
    pt = torch.exp(log_pt)
    return -((1.0 - pt) ** gamma) * log_pt


def mse_loss(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    diff = pred - true
    return diff * diff


def hv_sobel_kernels(size: int = 5):
    """Normalised-coordinate gradient kernels (loss_utils.py:116-137):
    (kernel_h, kernel_v) as float32 numpy arrays."""
    rng = np.arange(-(size // 2), size // 2 + 1, dtype=np.float32)
    h, v = np.meshgrid(rng, rng, indexing="ij")
    denom = h * h + v * v + 1.0e-15
    return h / denom, v / denom


def _grad_hv(hv: torch.Tensor, kernel_h, kernel_v) -> torch.Tensor:
    """Directional gradients of a 2-channel HV map (N, 2, H, W): the h
    kernel on channel 0, the v kernel on channel 1 (a cross-correlation,
    as ``lax.conv_general_dilated`` computes)."""
    kernel = torch.from_numpy(np.stack([kernel_h, kernel_v])[:, None]).to(
        hv.device, hv.dtype)
    pad = (kernel.shape[-1] - 1) // 2
    return F.conv2d(hv, kernel, padding=pad, groups=2)


def msge_loss(true: torch.Tensor, pred: torch.Tensor,
              focus: torch.Tensor, group=None) -> torch.Tensor:
    """HoVerNet-style masked MSE of horizontal/vertical map gradients
    (loss_utils.py:98-163). true/pred: (N, 2, H, W); focus: (N, H, W);
    with ``group``, over the rows of every rank."""
    kh, kv = hv_sobel_kernels(5)
    focus = torch.stack([focus, focus], dim=1).float()
    diff = _grad_hv(pred, kh, kv) - _grad_hv(true, kh, kv)
    loss = focus * diff * diff
    sums = allsum(torch.stack([torch.sum(loss),
                               torch.sum(focus).to(loss.dtype)]), group)
    return sums[0] / (sums[1] + 1.0e-8)


def simclr_loss(features: torch.Tensor, temperature: float = 0.07,
                contrast_mode: str = "all",
                base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised-contrastive / SimCLR loss (loss_utils.py:166-230).
    features: (bsz, n_views, dim)."""
    bsz, n_views = features.shape[0], features.shape[1]
    features = features.reshape(bsz, n_views, -1)
    mask = torch.eye(bsz, dtype=torch.float32, device=features.device)
    contrast_feature = torch.cat([features[:, v] for v in range(n_views)],
                                 dim=0)
    if contrast_mode == "one":
        anchor_feature, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor_feature, anchor_count = contrast_feature, n_views
    else:
        raise ValueError("Unknown mode: %s" % contrast_mode)

    logits = anchor_feature @ contrast_feature.T / temperature
    logits = logits - torch.max(logits, dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, n_views)
    logits_mask = 1.0 - torch.eye(bsz * anchor_count, bsz * n_views,
                                  device=features.device)
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True))
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / torch.sum(mask,
                                                                      dim=1)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return torch.mean(loss.reshape(anchor_count, bsz))


def class_weight_map(true: torch.Tensor, class_weights: dict,
                     n_classes: int) -> torch.Tensor:
    """Per-pixel weights from a {class: weight} table (reference
    ``get_class_wmap``, models/run_desc.py:18-22): classes absent from the
    table keep their label value as weight, which in the shipped configs
    zeroes background (label 0) and nothing else."""
    lut = torch.tensor([float(class_weights.get(c, c))
                        for c in range(n_classes)], dtype=torch.float32,
                       device=true.device)
    return lut[true.long()]
