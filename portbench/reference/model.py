"""Plain float32 forward of the benchmark's two configurations, written
from the published architectures over a flat ``{name: tensor}`` state dict.

* Cerberus with a ResNet-34 encoder (Graham et al., MedIA 2022): a
  torchvision ResNet-34 whose 7x7 stem has stride 1, a 1x1 ``conv_map``
  (512->256, no bias) on the bottom level, one U-Net tower per decoder
  (``prev = block(skip + upsample2x(prev))`` over four levels, two 3x3
  conv-BN-ReLU layers a level), each head a 1x1 conv-BN-ReLU to 96
  channels and a 1x1 conv, and the Patch-Class MLP on the 9x9 centre of
  the bottom features, average pooled.
* DSF-CNN (Graham et al., IEEE TMI 2020) with O orientations: steerable
  G-convolutions whose kernels are the real part of complex coefficients
  times circular-harmonic basis filters rotated to each orientation, G
  batch norm shared over the orientations, four G-dense blocks; the towers
  are pre-activation G-conv layers (k7) and end in a max over the
  orientations; each head is BN-ReLU-Conv1x1 (->96) then BN-ReLU-Conv1x1.

Batch norm runs with stored statistics (inference). Names are those of
the published checkpoints (``decoder_head.Gland.0.block.1.bn.weight``), so
the same dict is what a model directory's ``weights.tar`` holds. Nothing
here imports the code under test.

``precision="fp8"`` rounds every convolution's input and weight to
float8 e4m3 (one scale a tensor, so the largest magnitude sits at e4m3's
largest normal) before the float32 convolution: the next precision below
the bfloat16 the configurations state, used as the control of the
output comparison.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
HEAD_HIDDEN = 96
RESNET_BLOCKS = {"resnet34": (3, 4, 6, 3)}
RESNET_PLANES = (64, 128, 256, 512)
FILTERS = {"resnet34": (64, 64, 128, 256, 512),
           "dsf_cnn": (10, 16, 32, 32, 32)}
# G-dense blocks: (name, in, out, units); a unit is k7 -> 14, k5 -> 6
DSF_DENSE = (("d1", 10, 16, 3), ("d2", 16, 32, 4), ("d3", 32, 32, 5),
             ("d4", 32, 32, 6))
DSF_UNIT = ((7, 14), (5, 6))
DSF_TOWER_K = 7
# ksize -> (frequencies, radii, bandlimit per radius)
BASIS_INFO = {
    5: ((0, 1, 2), (0, 1, 2), (0, 2, 2)),
    7: ((0, 1, 2, 3), (0, 1, 2, 3), (0, 2, 3, 2)),
}
E4M3_MAX = 448.0


def is_dsf(encoder: str) -> bool:
    return encoder.startswith("dsf_cnn")


def orientations(encoder: str) -> int:
    return int(encoder.rsplit("_", 1)[1]) if is_dsf(encoder) else 1


def head_keys(decoders: Dict[str, Dict[str, int]]
              ) -> List[Tuple[str, str, str]]:
    """(decoder, head, output key) of every segmentation head."""
    return [(dec, head, dec.split("#")[0] + "-" + head)
            for dec, heads in decoders.items() if dec != "Patch-Class"
            for head in heads]


# ---------------------------------------------------------------- basis
@lru_cache(maxsize=None)
def basis_filters(ksize: int):
    """Complex circular-harmonic atoms (Q, K, K) and their frequencies:
    a Gaussian ring per radius times e^{i f phi}, normalised to norm
    sqrt(2), for every frequency up to the radius's bandlimit."""
    freqs, radii, bandlimits = BASIS_INFO[ksize]
    half = ksize // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    z = (xx + 1j * (-yy)) + 1e-8
    r = np.abs(z)
    atoms, used = [], []
    for radius in radii:
        sigma = 0.4 if radius == radii[-1] else 0.6
        ring = np.exp(-((r - radius) ** 2) / (2 * sigma ** 2))
        for f in freqs:
            if f <= bandlimits[radius]:
                atom = ring * (z / r) ** f
                atoms.append(math.sqrt(2) * atom / np.linalg.norm(atom))
                used.append(f)
    return np.array(atoms), tuple(used)


@lru_cache(maxsize=None)
def rotated_basis(ksize: int, n_orients: int) -> np.ndarray:
    """(2 [re, im], O, Q, K, K): every atom rotated to each orientation
    (e^{-i f theta_o}), in float64 then float32."""
    atoms, freqs = basis_filters(ksize)
    theta = 2 * np.pi / n_orients * np.arange(n_orients)[:, None]
    rot = np.exp(-1j * np.array(freqs)[None, :] * theta)
    rotated = rot[:, :, None, None] * atoms[None]
    return np.stack([rotated.real, rotated.imag]).astype(np.float32)


def n_atoms(ksize: int) -> int:
    return len(basis_filters(ksize)[1])


def gconv_kernel(weight: torch.Tensor, n_out: int) -> torch.Tensor:
    """Coefficients (2, 1, Q, 1, 1, O_in, in, out) -> OIHW kernel
    (O_out*out, O_in*in, K, K). Output orientation o reads input
    orientation (j - o) mod O_in at position j."""
    k = {n_atoms(s): s for s in BASIS_INFO}[weight.shape[2]]
    basis = torch.from_numpy(rotated_basis(k, n_out)).to(weight.device)
    w = weight[:, 0, :, 0, 0].float()  # (2, Q, O_in, in, out)
    n_in, c_in, c_out = w.shape[2], w.shape[3], w.shape[4]
    roll = torch.from_numpy(
        (np.arange(n_in)[None, :] - np.arange(n_out)[:, None]) % n_in
    ).to(weight.device)
    w = w[:, :, roll]  # (2, Q, O_out, O_in, in, out)
    kernel = (torch.einsum("oqhw,qoiab->obiahw", basis[0], w[0])
              - torch.einsum("oqhw,qoiab->obiahw", basis[1], w[1]))
    return kernel.reshape(n_out * c_out, n_in * c_in, k, k)


# ---------------------------------------------------------------- layers
class Net:
    """The forward over a state dict ``sd`` (tensors on one device)."""

    def __init__(self, sd: Dict[str, torch.Tensor], encoder: str,
                 decoders: Dict[str, Dict[str, int]], precision="f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError("precision is f32 or fp8, got %r" % precision)
        self.sd = sd
        self.encoder = encoder
        self.decoders = decoders
        self.orients = orientations(encoder)
        self.fp8 = precision == "fp8"
        self._kernels: Dict[str, torch.Tensor] = {}

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def conv(self, x, name, stride=1, bias=True, padding=None):
        w = self.sd[name + ".weight"]
        b = self.sd.get(name + ".bias") if bias else None
        pad = w.shape[-1] // 2 if padding is None else padding
        return F.conv2d(self._q(x), self._q(w), b, stride, pad)

    def bn(self, x, name):
        sd = self.sd
        return F.batch_norm(x, sd[name + ".running_mean"],
                            sd[name + ".running_var"], sd[name + ".weight"],
                            sd[name + ".bias"], False, 0.0, BN_EPS)

    def gconv(self, x, name):
        key = name + ".weight"
        if key not in self._kernels:
            self._kernels[key] = gconv_kernel(self.sd[key], self.orients)
        w = self._kernels[key]
        return F.conv2d(self._q(x), self._q(w), None, 1, w.shape[-1] // 2)

    def gbn(self, x, name):
        n, oc, h, w = x.shape
        o = self.orients
        return self.bn(x.reshape(n * o, oc // o, h, w), name).reshape(
            n, oc, h, w)

    def gconcat(self, parts):
        n, _, h, w = parts[0].shape
        o = self.orients
        return torch.cat([p.reshape(n, o, p.shape[1] // o, h, w)
                          for p in parts], 2).reshape(n, -1, h, w)

    # ------------------------------------------------------------ encoders
    def resnet(self, x):
        x0 = F.relu(self.bn(self.conv(x, "backbone.conv1", bias=False),
                            "backbone.bn1"))
        x = F.max_pool2d(x0, 3, 2, 1)
        feats = [x0]
        for stage, n_blocks in enumerate(RESNET_BLOCKS[self.encoder]):
            for b in range(n_blocks):
                p = "backbone.layer%d.%d." % (stage + 1, b)
                stride = 2 if stage > 0 and b == 0 else 1
                out = F.relu(self.bn(self.conv(x, p + "conv1", stride,
                                               bias=False), p + "bn1"))
                out = self.bn(self.conv(out, p + "conv2", bias=False),
                              p + "bn2")
                if p + "downsample.0.weight" in self.sd:
                    x = self.bn(self.conv(x, p + "downsample.0", stride,
                                          bias=False), p + "downsample.1")
                x = F.relu(out + x)
            feats.append(x)
        return feats

    def dsf(self, x):
        x = self.gconv(x, "backbone.i1")
        x = self.gconv(F.relu(self.gbn(x, "backbone.i2.block.0.pre_bn.norm")),
                       "backbone.i2.block.0.conv")
        feats = [x]
        for name, _, _, n_units in DSF_DENSE:
            x = F.max_pool2d(x, 2, 2)
            parts = [x]
            for u in range(n_units):
                p = "backbone.%s.units.%d." % (name, u)
                y = self.gconcat(parts)
                y = self.gconv(F.relu(self.gbn(y, p + "norm1.norm")),
                               p + "conv1")
                y = self.gconv(F.relu(self.gbn(y, p + "norm2.norm")),
                               p + "conv2")
                parts.append(y)
            p = "backbone.%s.transition." % name
            x = self.gconv(F.relu(self.gbn(self.gconcat(parts),
                                           p + "bn.norm")), p + "conv")
            feats.append(x)
        return feats

    # ------------------------------------------------------------ decoders
    def tower(self, dec, feats):
        prev = feats[-1]
        for level in range(4):
            x = feats[-(level + 2)] + F.interpolate(
                prev, scale_factor=2, mode="bilinear", align_corners=False)
            for j in range(2):
                p = "decoder_head.%s.%d.block.%d." % (dec, level, j)
                if self.orients > 1:
                    x = self.gconv(F.relu(self.gbn(x, p + "pre_bn.norm")),
                                   p + "conv")
                else:
                    x = F.relu(self.bn(self.conv(x, p + "conv"), p + "bn"))
            prev = x
        if self.orients > 1:
            n, oc, h, w = prev.shape
            prev = prev.reshape(n, self.orients, oc // self.orients, h,
                                w).amax(1)
        return prev

    def head(self, dec, head, x):
        p = "output_head.%s.%s." % (dec, head)
        if self.orients > 1:
            for j in range(2):
                q = p + "block.%d." % j
                x = self.conv(F.relu(self.bn(x, q + "bn")), q + "conv")
            return x
        x = F.relu(self.bn(self.conv(x, p + "x.0.block.0.conv"),
                           p + "x.0.block.0.bn"))
        return self.conv(x, p + "x.1.conv")

    def patch_class(self, bottom):
        p = "decoder_head.Patch-Class."
        if bottom.shape[-2] != 9 and bottom.shape[-1] != 9:
            h0 = (bottom.shape[-2] - 9) // 2
            w0 = (bottom.shape[-1] - 9) // 2
            bottom = bottom[..., h0:h0 + 9, w0:w0 + 9]
        x = F.relu(self.bn(bottom.mean((2, 3), keepdim=True), p + "bn1"))
        x = self.conv(x, p + "conv1")
        return self.conv(F.relu(self.bn(x, p + "bn2")), p + "conv2")

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """NCHW float in [0, 1] -> {output key: NCHW logits}."""
        feats = self.dsf(x) if self.orients > 1 else self.resnet(x)
        bottom = feats[-1]
        if "conv_map.weight" in self.sd:
            feats = feats[:-1] + [self.conv(bottom, "conv_map", bias=False)]
        out = {}
        keys = head_keys(self.decoders)
        for dec in dict.fromkeys(d for d, _, _ in keys):
            prev = self.tower(dec, feats)
            for d, head, key in keys:
                if d == dec:
                    out[key] = self.head(dec, head, prev)
        if "Patch-Class" in self.decoders:
            out["Patch-Class"] = self.patch_class(bottom)
        return out


def channel_map(decoders: Dict[str, Dict[str, int]]
                ) -> Dict[str, Tuple[int, int]]:
    """The canvas's channels per output key: an INST head gives its
    foreground classes (its channels but the first), a TYPE head and
    Patch-Class one channel each (the class id), in decoder order."""
    idx, n = {}, 0
    for dec, heads in decoders.items():
        for head, ch in heads.items():
            width = ch - 1 if head == "INST" else 1
            key = (dec if dec == "Patch-Class"
                   else dec.split("#")[0] + "-" + head)
            idx[key] = (n, n + width)
            n += width
    return idx


def window_canvas(logits: Dict[str, torch.Tensor], decoders, out_size: int
                  ) -> torch.Tensor:
    """{key: NCHW logits} of whole windows -> (N, out, out, C) float32:
    the centre ``out_size`` square, INST softmax without its first class,
    TYPE and Patch-Class as class ids."""
    chunks = []
    for key in channel_map(decoders):
        t = logits[key].float()
        if key == "Patch-Class":
            cls = t.argmax(1).float()  # (N, 1, 1)
            chunks.append(cls[:, None].expand(-1, 1, out_size, out_size))
            continue
        h0 = (t.shape[-2] - out_size) // 2
        w0 = (t.shape[-1] - out_size) // 2
        t = t[..., h0:h0 + out_size, w0:w0 + out_size]
        if key.endswith("-INST"):
            chunks.append(torch.softmax(t, 1)[:, 1:])
        else:
            chunks.append(t.argmax(1, keepdim=True).float())
    return torch.cat(chunks, 1).permute(0, 2, 3, 1)


def forward_windows(net: Net, windows: np.ndarray, out_size: int,
                    device, batch: int = 8) -> np.ndarray:
    """(N, in, in, 3) uint8 windows -> (N, out, out, C) float32 canvas
    values, ``batch`` windows at a time, TF32 off."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        with torch.no_grad():
            for s in range(0, len(windows), batch):
                x = torch.from_numpy(np.ascontiguousarray(
                    windows[s:s + batch])).to(device)
                x = x.permute(0, 3, 1, 2).float() / 255.0
                outs.append(window_canvas(net(x), net.decoders,
                                          out_size).cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------- params
def param_specs(encoder: str, decoders: Dict[str, Dict[str, int]]):
    """Every entry of the state dict in order: (name, shape, kind), kind
    one of ``conv`` (kaiming normal, fan out), ``conv_map`` (uniform
    +-1/sqrt(fan in)), ``gconv`` (normal, std sqrt(2 Q / out)), ``zero``,
    ``one``, ``count`` (BN's int64 batch counter)."""
    specs = []

    def bn(name, c):
        specs.extend([(name + ".weight", (c,), "one"),
                      (name + ".bias", (c,), "zero"),
                      (name + ".running_mean", (c,), "zero"),
                      (name + ".running_var", (c,), "one"),
                      (name + ".num_batches_tracked", (), "count")])

    def conv(name, cin, cout, k, bias=True):
        specs.append((name + ".weight", (cout, cin, k, k), "conv"))
        if bias:
            specs.append((name + ".bias", (cout,), "zero"))

    def gconv(name, cin, cout, k, o_in):
        specs.append((name + ".weight", (2, 1, n_atoms(k), 1, 1, o_in, cin,
                                         cout), "gconv"))

    filters = FILTERS["dsf_cnn" if is_dsf(encoder) else encoder]
    o = orientations(encoder)
    if is_dsf(encoder):
        gconv("backbone.i1", 3, 10, 7, 1)
        bn("backbone.i2.block.0.pre_bn.norm", 10)
        gconv("backbone.i2.block.0.conv", 10, 10, 7, o)
        for name, cin, cout, n_units in DSF_DENSE:
            for u in range(n_units):
                p = "backbone.%s.units.%d." % (name, u)
                c = cin + DSF_UNIT[1][1] * u
                bn(p + "norm1.norm", c)
                gconv(p + "conv1", c, DSF_UNIT[0][1], DSF_UNIT[0][0], o)
                bn(p + "norm2.norm", DSF_UNIT[0][1])
                gconv(p + "conv2", DSF_UNIT[0][1], DSF_UNIT[1][1],
                      DSF_UNIT[1][0], o)
            c = cin + DSF_UNIT[1][1] * n_units
            bn("backbone.%s.transition.bn.norm" % name, c)
            gconv("backbone.%s.transition.conv" % name, c, cout, 5, o)
    else:
        conv("backbone.conv1", 3, 64, 7, bias=False)
        bn("backbone.bn1", 64)
        cin = 64
        for stage, n_blocks in enumerate(RESNET_BLOCKS[encoder]):
            planes = RESNET_PLANES[stage]
            for b in range(n_blocks):
                p = "backbone.layer%d.%d." % (stage + 1, b)
                stride = 2 if stage > 0 and b == 0 else 1
                conv(p + "conv1", cin, planes, 3, bias=False)
                bn(p + "bn1", planes)
                conv(p + "conv2", planes, planes, 3, bias=False)
                bn(p + "bn2", planes)
                if stride != 1 or cin != planes:
                    conv(p + "downsample.0", cin, planes, 1, bias=False)
                    bn(p + "downsample.1", planes)
                cin = planes
        specs.append(("conv_map.weight", (filters[-2], filters[-1], 1, 1),
                      "conv_map"))
    levels = [(filters[-2], (filters[-2], filters[-3])),
              (filters[-3], (filters[-3], filters[-4])),
              (filters[-4], (filters[-4], filters[-5])),
              (filters[-5], (filters[-5], filters[-5]))]
    for dec, heads in decoders.items():
        if dec == "Patch-Class":
            if is_dsf(encoder):
                raise ValueError("a DSF-CNN encoder serves no Patch-Class")
            p = "decoder_head.Patch-Class."
            bn(p + "bn1", filters[-1])
            conv(p + "conv1", filters[-1], 256, 1)
            bn(p + "bn2", 256)
            conv(p + "conv2", 256, heads["OUT"], 1)
            continue
        for level, (cin, units) in enumerate(levels):
            for j, cout in enumerate(units):
                p = "decoder_head.%s.%d.block.%d." % (dec, level, j)
                if is_dsf(encoder):
                    bn(p + "pre_bn.norm", cin)
                    gconv(p + "conv", cin, cout, DSF_TOWER_K, o)
                else:
                    conv(p + "conv", cin, cout, 3)
                    bn(p + "bn", cout)
                cin = cout
        for head, out_ch in heads.items():
            p = "output_head.%s.%s." % (dec, head)
            if is_dsf(encoder):
                bn(p + "block.0.bn", filters[-5])
                conv(p + "block.0.conv", filters[-5], HEAD_HIDDEN, 1)
                bn(p + "block.1.bn", HEAD_HIDDEN)
                conv(p + "block.1.conv", HEAD_HIDDEN, out_ch, 1)
            else:
                conv(p + "x.0.block.0.conv", filters[-5], HEAD_HIDDEN, 1)
                bn(p + "x.0.block.0.bn", HEAD_HIDDEN)
                conv(p + "x.1.conv", HEAD_HIDDEN, out_ch, 1)
    return specs
