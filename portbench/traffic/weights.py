"""Seeded weights for a configuration, made on the device in a few large
calls, in float32 (the type the model directory serves them in), and the
recipes that make random weights give instances.

* ``standardised_heads`` (the ResNet-34 model): the reference init
  (kaiming normal, fan out; ``conv_map`` uniform +-1/sqrt(fan in); zero
  biases; unit BN), then the last 1x1 conv of every INST and TYPE head
  rewritten so that its logits in the output windows of seeded sample
  windows have per-channel standard deviation 3 and means ``INST_BIAS``
  (TYPE: 0): instances are blobs on a minority of the pixels and class ids vary
  across the slide. (The port's chip smoke scales the INST convs 0.003x
  instead; at 448^2 windows that puts the nuclei probability at
  0.92-0.95 over all tissue, a handful of slide-sized nuclei.)
* ``dsf_served`` (the DSF-CNN model): G-conv coefficients from the
  reference init (normal, std sqrt(2 Q / out)) times 0.01, which keeps
  every level's activations at order one, default BN, then each INST
  head's last conv rewritten as above.

Both then set the nuclei density (``NUCLEI_PER_MPX``, below).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference.model import Net, param_specs

DSF_GSCALE = 0.01
SPREAD = 3.0
# (bg, inner, contour): the contour class is kept out, and the inner mean
# puts a minority of the pixels in blobs above the families' thresholds
INST_BIAS = {"Gland": (0.0, -1.0, -6.0), "Lumen": (0.0, -1.0, -6.0),
             "Nuclei": (0.0, -0.5, -6.0)}
# A draw's nuclei: blobs where the inner class's probability passes 0.5,
# eroded by the 3x3 cross and kept from MIN_BLOB px (4-connected), as the
# nuclei family's mask keeps them, in the output windows (the centre the
# canvas keeps) of SAMPLE_WINDOWS seeded input windows. The inner bias is
# shifted until the sample holds NUCLEI_PER_MPX of them a Mpx; a draw
# whose field cannot reach that within DENSITY_TOLERANCE (its blobs are
# too wide) is set aside for the next draw of the same seed. A random draw
# otherwise decides how many nuclei the post-processing finds (from none
# to over 2000 on two 6144^2 slides), and the seed would change the work.
# After MAX_DRAWS the draw nearest the density is taken.
NUCLEI_PER_MPX = 100.0
DENSITY_TOLERANCE = 0.1
MIN_BLOB = 8
SAMPLE_WINDOWS = 48
MAX_DRAWS = 8


def _std(kind: str, shape) -> float:
    if kind == "conv":  # kaiming normal, fan out
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    # G-conv: (2, 1, Q, 1, 1, O_in, in, out)
    return math.sqrt(2.0 / shape[-1] * shape[2])


def init_state_dict(encoder: str, decoders, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """The reference init of every entry of ``param_specs``: one normal
    draw for all conv and G-conv weights, one uniform draw for
    ``conv_map``, from ``torch.Generator(device).manual_seed(seed)``."""
    specs = param_specs(encoder, decoders)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = [s for s in specs if s[2] in ("conv", "gconv")]
    uniform = [s for s in specs if s[2] == "conv_map"]
    sizes = [int(np.prod(s[1])) for s in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat_u = torch.rand(sum(int(np.prod(s[1])) for s in uniform),
                        generator=gen, device=device)
    sd = {}
    offset = 0
    for (name, shape, kind), n in zip(normal, sizes):
        sd[name] = flat[offset:offset + n].view(shape) * _std(kind, shape)
        offset += n
    offset = 0
    for name, shape, _ in uniform:
        n = int(np.prod(shape))
        bound = 1.0 / math.sqrt(n // shape[0])
        sd[name] = (flat_u[offset:offset + n].view(shape) * 2 - 1) * bound
        offset += n
    for name, shape, kind in specs:
        if kind == "zero":
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            sd[name] = torch.ones(shape, device=device)
        elif kind == "count":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {name: sd[name] for name, _, _ in specs}


def _sample_heads(sd, encoder, decoders, x, out_size):
    """The segmentation heads' logits of the windows ``x`` (four at a
    time, TF32 allowed, cuDNN deterministic), cropped to the centre
    ``out_size`` square the canvas keeps."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    try:
        net = Net(sd, encoder, decoders)
        parts = []
        with torch.no_grad():
            for i in range(0, len(x), 4):
                out = net(x[i:i + 4])
                out.pop("Patch-Class", None)
                h0 = (x.shape[-1] - out_size) // 2
                parts.append({k: v[..., h0:h0 + out_size, h0:h0 + out_size]
                              for k, v in out.items()})
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def _last_conv(encoder, dec, head):
    return "output_head.%s.%s.%s.conv." % (
        dec, head, "block.1" if encoder.startswith("dsf") else "x.1")


def _standardise(sd, out, encoder, heads):
    """Rewrite the last conv of each (decoder, head, key, means) so that
    its logits in ``out`` get standard deviation ``SPREAD`` and ``means``
    per channel (0 where ``means`` is None); ``out`` is updated to
    match."""
    for dec, head, key, want in heads:
        logits = out[key].double()
        mean = logits.mean(dim=(0, 2, 3))
        std = logits.std(dim=(0, 2, 3)).clamp(min=1e-12)
        gain = SPREAD / std
        bias = (torch.tensor(want, dtype=torch.float64, device=mean.device)
                if want is not None else torch.zeros_like(mean))
        p = _last_conv(encoder, dec, head)
        sd[p + "weight"] = sd[p + "weight"] * gain.float()[:, None, None,
                                                            None]
        sd[p + "bias"] = ((sd[p + "bias"].double() - mean) * gain
                          + bias).float()
        out[key] = ((logits - mean[:, None, None]) * gain[:, None, None]
                    + bias[:, None, None])


def _blobs(mask: np.ndarray) -> int:
    """Blobs of at least ``MIN_BLOB`` px after an erosion by the 3x3
    cross, 4-connected within each window of (N, H, W) ``mask``."""
    from scipy import ndimage

    structure = np.zeros((3, 3, 3), bool)
    structure[1] = ndimage.generate_binary_structure(2, 1)
    mask = ndimage.binary_erosion(mask, structure, border_value=1)
    labels, _ = ndimage.label(mask, structure)
    return int((np.bincount(labels.ravel())[1:] >= MIN_BLOB).sum())


def _nuclei_density(sd, out, encoder) -> float:
    """Shift the nuclei inner class's bias to the threshold, on the side
    of the blob count's peak where a higher threshold gives fewer and
    smaller blobs, whose count on the sample is nearest
    ``NUCLEI_PER_MPX``; returns that count a Mpx."""
    logits = out["Nuclei-INST"].double()
    margin = (logits[:, 1] - torch.logsumexp(logits[:, [0, 2]], dim=1)
              ).cpu().numpy()
    mpx = margin.size / 1e6
    levels = np.quantile(margin, np.linspace(0.5, 0.998, 80))
    counts = [_blobs(margin > t) / mpx for t in levels]
    peak = int(np.argmax(counts))
    best = min(range(peak, len(levels)),
               key=lambda i: abs(counts[i] - NUCLEI_PER_MPX))
    p = _last_conv(encoder, "Nuclei", "INST") + "bias"
    sd[p] = sd[p] - torch.tensor([0.0, float(levels[best]), 0.0],
                                 device=sd[p].device)
    return counts[best]


def _windows(rng, n, size, device, jpeg_quality=None):
    """``n`` seeded windows as the traffic hands them to the program:
    through a JPEG round trip at ``jpeg_quality`` where its slides are
    JPEG-coded (the codec changes the noise the features answer to)."""
    import cv2

    from .images import synthetic_image

    imgs = []
    for _ in range(n):
        img = synthetic_image((size, size), rng)
        if jpeg_quality is not None:
            _, enc = cv2.imencode(".jpg", img[..., ::-1],
                                  [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
            img = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
        imgs.append(img)
    x = torch.from_numpy(np.stack(imgs)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def standardised_heads(sd, encoder, decoders, x, out_size):
    out = _sample_heads(sd, encoder, decoders, x, out_size)
    _standardise(sd, out, encoder, [
        (dec, head, dec.split("#")[0] + "-" + head,
         INST_BIAS.get(dec) if head == "INST" else None)
        for dec, hs in decoders.items() if dec != "Patch-Class"
        for head in hs])
    return _nuclei_density(sd, out, encoder)


def dsf_served(sd, encoder, decoders, x, out_size):
    for name in sd:
        if name.endswith(".weight") and sd[name].dim() == 8:
            sd[name] = sd[name] * DSF_GSCALE
    out = _sample_heads(sd, encoder, decoders, x, out_size)
    _standardise(sd, out, encoder, [(dec, "INST", dec + "-INST", want)
                                    for dec, want in INST_BIAS.items()
                                    if dec in decoders])
    return _nuclei_density(sd, out, encoder)


RECIPES = {"standardised_heads": standardised_heads, "dsf_served": dsf_served}


def make_weights(config: dict, seed: int, device, jpeg_quality=None
                 ) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``, on ``device``: the
    seed's first draw whose recipe reaches the nuclei density on sample
    windows coded as the traffic codes its images (``jpeg_quality``, or
    None for lossless)."""
    encoder, decoders = config["encoder"], config["decoders"]
    seed = int(seed) % 2 ** 63
    best = None
    for draw in range(MAX_DRAWS):
        sd = init_state_dict(encoder, decoders,
                             (seed * 1000003 + draw) % 2 ** 63, device)
        x = _windows(np.random.default_rng([seed, 17, draw]),
                     SAMPLE_WINDOWS, int(config["patch_input"]), device,
                     jpeg_quality)
        density = RECIPES[config["weights"]](
            sd, encoder, decoders, x, int(config["patch_output"]))
        miss = abs(density - NUCLEI_PER_MPX)
        if miss <= DENSITY_TOLERANCE * NUCLEI_PER_MPX:
            return sd
        if best is None or miss < best[0]:
            best = (miss, sd)
    return best[1]
