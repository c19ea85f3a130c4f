"""Width-paired ResNet encoder front: stem, max-pool, layer1 and the entry
of layer2.

Counterpart of ``cerberus_tpu/models/paired_encoder.py``. The JAX package
extends the width pairing of ``paired_decode`` (``xp[n, p*C + c, h, j] ==
x[n, c, h, 2j + p]`` here) through the basic-block ResNets' 64-channel
front, so that on a TPU those convolutions fill the 128 MXU lanes too.
Everything stays at phase 0 (block j covers columns 2j, 2j + 1), so the
x0 / x1 skips arrive block-aligned for the paired towers' even-start crop
windows.

Kernel repacks (output column 2j+p reading column 2j+p+t-o for tap t and
left reach o: block j + (p+t-o)//2, parity (p+t-o)%2):
  * 7x7 stem, o = 3: blocks -2..2 -> ``(2Co, 2Ci, 7, 5)``, W block pad 2;
  * 3x3 layer1, o = 1: blocks -1..1 -> ``(2Co, 2Ci, 3, 3)``, block pad 1;
  * 3x3 stride-2 layer2 entry, unpaired output (column c reads columns
    2c-1..2c+1: block c-1 parity 1, block c parities 0 and 1) ->
    ``(Co, 2Ci, 3, 2)``, stride (2, 1), W pad (1, 0).
Every tap appears once; the rest are exact zeros, and the pad columns the
block pads add beyond the SAME pads only meet those zeros.

BN on a paired tensor is ``paired_decode.paired_bn``: the module on the
unpaired view, whose per-channel batch statistics are JAX
``_paired_bn_train``'s exact fold of the paired ones, with
``layers.BatchNorm2d``'s contract (eval for subtype-frozen layers, no fold
during a remat recompute, the ranks of the data-parallel step).
Gradients come from autograd through BN and the repacks, which are
rebuilt from the live weights on every training forward
(``paired_decode.packed``). Tensors are NCHW; the paired path runs
channels-last (``paired_decode``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .backbones.resnet import RESNET_SPECS
from .paired_decode import packed, pair_w, paired_bn, repack, unpair_w

PAIRED_FRONT_MAX_BATCH = 48  # per-device batch below which the front pairs


def pair_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 7, 7) SAME (pad 3) -> (2Co, 2Ci, 7, 5) phase-0 block
    kernel, W block pad 2."""
    assert tuple(w.shape[-2:]) == (7, 7), w.shape
    return repack(w, 5, {(p, (p + t - 3) // 2 + 2, (p + t - 3) % 2): t
                         for p in range(2) for t in range(7)})


def pair_same3_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) SAME (pad 1) -> (2Co, 2Ci, 3, 3) phase-0 block
    kernel, W block pad 1."""
    assert tuple(w.shape[-2:]) == (3, 3), w.shape
    return repack(w, 3, {(p, (p + t - 1) // 2 + 1, (p + t - 1) % 2): t
                         for p in range(2) for t in range(3)})


def pair_s2_exit_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) stride-2 SAME (pad 1) -> (Co, 2Ci, 3, 2): paired
    input, unpaired output; a width-2 stride-1 block convolution over
    blocks [c-1, c] with one zero block on the left."""
    assert tuple(w.shape[-2:]) == (3, 3), w.shape
    return repack(w, 2, {(0, 0, 1): 0, (0, 1, 0): 1, (0, 1, 1): 2},
                  out_parities=1)


def conv_paired(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor],
                w_pad: Union[int, Tuple[int, int]], h_stride: int = 1,
                h_pad: Optional[int] = None) -> torch.Tensor:
    """A block convolution: stride (``h_stride``, 1), H padded ``h_pad``
    (default kh // 2) on both sides, W padded ``w_pad`` (an int, or
    (left, right) through ``F.pad``, since ``F.conv2d`` pads
    symmetrically)."""
    if h_pad is None:
        h_pad = w.shape[2] // 2
    if isinstance(w_pad, int):
        return F.conv2d(x, w, bias, stride=(h_stride, 1),
                        padding=(h_pad, w_pad))
    return F.conv2d(F.pad(x, (w_pad[0], w_pad[1], h_pad, h_pad)), w, bias,
                    stride=(h_stride, 1))


def max_pool_paired(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(3, 2, 1)`` of a phase-0 paired tensor, separable: H on
    the paired tensor, then W on the unpaired view, re-paired. max is
    order-free, so the result is exact. Needs W % 4 == 0."""
    assert x.shape[-1] % 2 == 0, x.shape
    xh = F.max_pool2d(x, (3, 1), (2, 1), (1, 0))
    return pair_w(F.max_pool2d(unpair_w(xh), (1, 3), (1, 2), (0, 1)))


def supports_paired_encoder(arch: str, width: int) -> bool:
    """Basic-block ResNets only (a bottleneck layer1 is 256 wide already)
    and W divisible by 4 (the paired max-pool)."""
    spec = RESNET_SPECS.get(arch)
    return spec is not None and spec[0] == "basic" and width % 4 == 0


def use_paired_front(arch: str, width: int, batch: int,
                     data_parallel: int = 1,
                     env: Optional[str] = None) -> bool:
    """The JAX package's paired-front gate (a pure function): pair when
    ``supports_paired_encoder`` and the per-device batch
    ``batch // data_parallel`` is below 48; ``env`` (the value of
    ``CERBERUS_PAIRED_ENCODER``, "1" or "0") overrides the batch test."""
    if not supports_paired_encoder(arch, width):
        return False
    if env is not None:
        return env == "1"
    return batch // max(int(data_parallel), 1) < PAIRED_FRONT_MAX_BATCH


def resnet_forward_paired(backbone, x: torch.Tensor) -> List[torch.Tensor]:
    """``backbone`` (a basic-block ``backbones.resnet.ResNet``) on NCHW
    ``x`` -> ``[x0p, x1p, x2, x3, x4]``: x0 and x1 paired (phase 0), the
    rest unpaired, as ``backbone(x)`` up to summation order. BN runs in
    each module's mode (``paired_bn``)."""
    assert x.shape[-1] % 4 == 0, x.shape
    xp = pair_w(x.contiguous(memory_format=torch.channels_last))
    xp = conv_paired(xp, packed(pair_stem_kernel, backbone.conv1.weight),
                     None, w_pad=2)
    x0p = xp = F.relu(paired_bn(backbone.bn1, xp))
    xp = max_pool_paired(xp)
    for block in backbone.layer1:  # stride 1, no downsample (basic)
        assert block.downsample is None and block.n_convs == 2
        out = conv_paired(xp, packed(pair_same3_kernel, block.conv1.weight),
                          None, w_pad=1)
        out = F.relu(paired_bn(block.bn1, out))
        out = conv_paired(out, packed(pair_same3_kernel,
                                      block.conv2.weight), None, w_pad=1)
        xp = F.relu(paired_bn(block.bn2, out) + xp)
    x1p = xp

    # layer2.0 reads the paired x1: conv1 through the stride-2 exit kernel
    # (one zero block on the left only), the 1x1 stride-2 downsample from
    # the parity-0 channel half (the even columns); its output is unpaired
    block = backbone.layer2[0]
    out = conv_paired(xp, packed(pair_s2_exit_kernel, block.conv1.weight),
                      None, w_pad=(1, 0), h_stride=2, h_pad=1)
    out = F.relu(block.bn1(out))
    out = block.bn2(block.conv2(out))
    ds = F.conv2d(xp[:, :xp.shape[1] // 2], block.downsample[0].weight,
                  block.downsample[0].bias, stride=(2, 1))
    x = F.relu(out + block.downsample[1](ds))
    x = backbone.layer2[1:](x)
    feats = [x]
    for stage in (3, 4):
        x = getattr(backbone, "layer%d" % stage)(x)
        feats.append(x)
    return [x0p, x1p] + feats
