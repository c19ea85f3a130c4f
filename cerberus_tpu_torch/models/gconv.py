"""Steerable-filter group convolutions (rotation equivariance), NCHW.

Counterpart of ``cerberus_tpu/models/gconv.py`` (the reference's DSF-CNN
stack, ``models/utils/gconv_utils.py`` and ``gconv_layers.py``):
  * circular-harmonic basis filters with per-radius bandlimits for k in
    {5, 7, 9} (``basis_filters``), rotated by e^{-i f theta} for each
    orientation (``rotated_basis``);
  * a G-convolution's kernel is the real part of (w_re + i w_im) times the
    rotated basis, summed over the basis atoms; for a G->G convolution
    output orientation ``o`` reads the input orientations rolled by ``o``
    (``synthesize_kernel``), then one ordinary convolution runs;
  * G batch norm: one set of statistics per channel, shared across the
    orientations (``GBatchNorm2d``); pooling over the orientations
    (``group_pool``); concatenation along the channel axis inside each
    orientation (``group_concat_channels``).

``synth_counts["kernels"]`` counts the kernels ``GConv2d`` synthesises:
one per G-convolution a forward, so a unit of work reads its share as the
difference around it.

Channel layout: the channel axis is orientation-major, ``O * C`` flattened
from ``(O, C)``, the reference's own ``(N, O*C, H, W)``. A G-convolution's
parameter is ``weight`` of shape ``(2, 1, Q, 1, 1, O_in, in, out)``, the
reference's (the JAX package's ``gweight``).
"""
from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import batch_norm

# ksize -> (frequencies, radii, bandlimit per radius) (gconv_utils.py:9-88)
BASIS_INFO = {
    5: ([0, 1, 2], [0, 1, 2], [0, 2, 2]),
    7: ([0, 1, 2, 3], [0, 1, 2, 3], [0, 2, 3, 2]),
    9: ([0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [0, 3, 4, 4, 3]),
}

synth_counts = {"kernels": 0}


@lru_cache(maxsize=None)
def basis_filters(ksize: int):
    """Atomic complex basis filters: ((Q, K, K) complex128, frequencies)."""
    freq_list, radius_list, bandlimit_list = BASIS_INFO[ksize]
    filters, used_freqs = [], []
    eps = 1e-8
    his = ksize // 2
    y_index, x_index = np.mgrid[-his: his + 1, -his: his + 1]
    z = (x_index + 1j * (-y_index)) + eps
    r = np.abs(z)
    for radius in radius_list:
        sigma = 0.4 if radius == radius_list[-1] else 0.6
        rad_prof = np.exp(-((r - radius) ** 2) / (2 * sigma ** 2))
        for freq in freq_list:
            if freq <= bandlimit_list[radius]:
                c_image = rad_prof * (z / r) ** freq
                c_image = (math.sqrt(2) * c_image) / np.linalg.norm(c_image)
                filters.append(c_image)
                used_freqs.append(freq)
    return np.array(filters), tuple(used_freqs)


@lru_cache(maxsize=None)
def rotated_basis(ksize: int, nr_orients: int) -> np.ndarray:
    """(2 [re, im], O, Q, K, K) float32: the basis rotated to each
    orientation, computed in float64."""
    filters, freqs = basis_filters(ksize)
    freqs = np.array(freqs)[None, :]  # (1, Q)
    angles = (2 * np.pi / nr_orients) * np.arange(nr_orients)[:, None]
    rot = np.exp(-1j * freqs * angles)  # (O, Q)
    rotated = rot[:, :, None, None] * filters[None]  # (O, Q, K, K)
    return np.stack([rotated.real, rotated.imag]).astype(np.float32)


def n_basis(ksize: int) -> int:
    return basis_filters(ksize)[0].shape[0]


@lru_cache(maxsize=None)
def _roll_index(nr_orients_out: int, nr_orients_in: int) -> np.ndarray:
    """(O_out, O_in) int64: output orientation ``o`` reads input
    orientation ``(j - o) mod O_in`` at position ``j`` (``jnp.roll`` by
    ``o``); all zeros for a Z2->G convolution."""
    o = np.arange(nr_orients_out)[:, None]
    j = np.arange(nr_orients_in)[None, :]
    return (j - o) % nr_orients_in


def synthesize_kernel(weight: torch.Tensor, basis: torch.Tensor,
                      nr_orients_in: int,
                      roll: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``weight`` (2, 1, Q, 1, 1, O_in, in, out) and ``basis``
    (2, O_out, Q, K, K) -> OIHW kernel (O_out*out, O_in*in, K, K) with the
    cyclic input-orientation roll applied (``cerberus_tpu/models/gconv.py:
    83-105``). Computed in f32 (f64 for an f64 weight), outside autocast.
    ``roll``: ``_roll_index`` as a tensor on the weight's device (made here
    when not given)."""
    dtype = torch.promote_types(weight.dtype, torch.float32)
    with (torch.autocast(weight.device.type, enabled=False)
          if weight.device.type in ("cpu", "cuda")
          else contextlib.nullcontext()):
        w = weight.to(dtype)[:, 0, :, 0, 0]  # (2, Q, O_in, in, out)
        basis = basis.to(dtype)
        n_out, k = basis.shape[1], basis.shape[-1]
        if roll is None:
            roll = torch.from_numpy(_roll_index(n_out, nr_orients_in)).to(
                w.device)
        w = w[:, :, roll]  # (2, Q, O_out, O_in, in, out)
        kernel = (torch.einsum("oqhw,qoiab->obiahw", basis[0], w[0])
                  - torch.einsum("oqhw,qoiab->obiahw", basis[1], w[1]))
    n_in, c_in, c_out = w.shape[3], w.shape[4], w.shape[5]
    return kernel.reshape(n_out * c_out, n_in * c_in, k, k)


class GConv2d(nn.Module):
    """Steerable G-convolution, no bias: (N, O_in*in, H, W) ->
    (N, O_out*out, H, W), padding ``ksize // 2``. The rotated basis is a
    non-persistent buffer (a reference checkpoint's ``basis_filters``
    entries are dropped on load, ``models/convert.py``), and so is the roll
    index, so that a forward copies nothing from the host."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int,
                 nr_orients_in: int, nr_orients_out: int):
        super().__init__()
        self.ksize = ksize
        self.nr_orients_in = nr_orients_in
        self.weight = nn.Parameter(torch.empty(
            2, 1, n_basis(ksize), 1, 1, nr_orients_in, in_ch, out_ch))
        self.register_buffer("basis", torch.from_numpy(
            rotated_basis(ksize, nr_orients_out)), persistent=False)
        self.register_buffer("roll", torch.from_numpy(
            _roll_index(nr_orients_out, nr_orients_in)), persistent=False)

    def kernel(self) -> torch.Tensor:
        synth_counts["kernels"] += 1
        return synthesize_kernel(self.weight, self.basis, self.nr_orients_in,
                                 self.roll)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel(), padding=self.ksize // 2)


class GBatchNorm2d(nn.Module):
    """G-equivariant batch norm: one set of statistics per channel ``C``
    shared across the ``O`` orientations (``gconv.py:125-149``). The input
    (N, O*C, H, W) is viewed as (N*O, C, H, W), whose per-channel values
    are those of all orientations, and goes through the
    ``layers.BatchNorm2d`` held as ``norm`` (the reference's
    ``...pre_bn.norm.*`` names): eval applies the stored statistics;
    training normalises with, and folds, the statistics of ``n*h*w*O``
    values with the JAX semantics."""

    def __init__(self, channels: int, nr_orients: int):
        super().__init__()
        self.nr_orients = nr_orients
        self.norm = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, oc, h, w = x.shape
        return self.norm(x.reshape(n * self.nr_orients, oc // self.nr_orients,
                                   h, w)).reshape(n, oc, h, w)


def group_pool(x: torch.Tensor, nr_orients: int,
               pool_type: str = "max") -> torch.Tensor:
    """(N, O*C, H, W) -> (N, C, H, W): max or mean over the orientations."""
    n, oc, h, w = x.shape
    xr = x.reshape(n, nr_orients, oc // nr_orients, h, w)
    return xr.amax(dim=1) if pool_type == "max" else xr.mean(dim=1)


def group_concat_channels(tensors: Sequence[torch.Tensor],
                          nr_orients: int) -> torch.Tensor:
    """Concatenate G-maps along the channel axis inside each orientation
    (``gconv.py:162-170``), not along the flattened ``O*C`` axis."""
    n, _, h, w = tensors[0].shape
    out = torch.cat([t.reshape(n, nr_orients, t.shape[1] // nr_orients, h, w)
                     for t in tensors], dim=2)
    return out.reshape(n, -1, h, w)


def init_gconv(weight: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """The reference's ``weights_init_dsf``: normal with std
    ``sqrt(2 / out * Q)`` (``gconv.py:173-184``), in place."""
    q, out_ch = weight.shape[2], weight.shape[-1]
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * math.sqrt(2.0 / out_ch * q))
