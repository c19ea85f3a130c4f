"""DSF-CNN fixtures for the port's tests and ``chip_smoke.py`` (the port
and numpy only; no JAX): seeded random DSF NetDescs and the synthetic-head
recipe that makes their INST heads give instances.

Random DSF weights overflow: the reference init (std ``sqrt(2Q/out)``)
takes the activations to inf/NaN within three dense blocks, so every random
DSF model scales its G-conv coefficients. ``GSCALE_PARITY`` (0.05) is
``tests/test_dsf_cnn.py``'s recipe, with BN statistics randomised: values
stay finite but grow by orders of magnitude a level, which parity checks
(relative errors) tolerate. A served model needs logits of order one for
its probability maps to have structure: ``GSCALE_SERVED`` (0.01) keeps
each level's activations within about 0.01-1 for 4, 8 and 12 orientations,
and ``synthetic_inst_heads`` then standardises each INST head's logits on a
sample input and adds the synthetic bias, so that the instance families
find objects.
"""
import numpy as np

from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS, ModelConfig

GSCALE_PARITY = 0.05
GSCALE_SERVED = 0.01
# the five default heads a DSF encoder can serve (no Patch-Class)
DSF_DECODERS = {k: v for k, v in DEFAULT_DECODER_KWARGS.items()
                if k != "Patch-Class"}
# synthetic INST logits: standardised logit * SYNTH_SPREAD + bias
# (bg, inner, contour); the contour class is kept out, and the inner bias
# puts a minority of the pixels in blobs above the families' thresholds
SYNTH_SPREAD = 3.0
SYNTH_INST_BIAS = {"Gland": (0.0, -1.0, -6.0), "Lumen": (0.0, -1.0, -6.0),
                   "Nuclei": (0.0, -0.5, -6.0)}


def dsf_kwargs(arch="dsf_cnn_4", decoders=None):
    decoders = DSF_DECODERS if decoders is None else decoders
    return {"encoder_backbone_name": arch, "decoder_kwargs": dict(decoders),
            "considered_tasks": list(decoders)}


def dsf_model(arch="dsf_cnn_4", decoders=None, seed=0, gscale=GSCALE_PARITY,
              random_bn=True):
    """(NetDesc in eval mode on the CPU, model kwargs): the reference init
    from ``torch.Generator().manual_seed(seed)``, every G-conv's
    coefficients times ``gscale``, and with ``random_bn`` every BN's
    running mean ~ N(0, 0.1) and variance ~ U(0.5, 1.5)."""
    import torch

    from cerberus_tpu_torch.models.gconv import GConv2d
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

    kwargs = dsf_kwargs(arch, decoders)
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(NetDesc(ModelConfig.from_kwargs(kwargs)), gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GConv2d):
                mod.weight.mul_(gscale)
            elif random_bn and isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.running_mean.shape
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model.eval(), kwargs


def synthetic_inst_heads(model, x, bias=None, spread=SYNTH_SPREAD):
    """Rewrite each INST head's last 1x1 conv so that its logits on ``x``
    (NCHW in [0, 1], on the model's device) have mean ``bias[task]`` and
    standard deviation ``spread`` per channel, over the pixels of ``x``.
    In place; returns the model."""
    import torch

    bias = SYNTH_INST_BIAS if bias is None else bias
    model.eval()
    with torch.no_grad():
        out = model(x)
        for task, want in bias.items():
            key = "%s-INST" % task
            if key not in out:
                continue
            logits = out[key].double()
            mean = logits.mean(dim=(0, 2, 3))
            std = logits.std(dim=(0, 2, 3)).clamp(min=1e-12)
            conv = model.output_head[task]["INST"].block[1].conv
            gain = spread / std
            conv.weight.mul_(gain.to(conv.weight.dtype)[:, None, None, None])
            conv.bias.copy_(((conv.bias.double() - mean) * gain
                             + torch.tensor(want, dtype=torch.float64,
                                            device=mean.device)).to(
                                                conv.bias.dtype))
    return model


def noise_image(seed, hw):
    """Random noise with a dozen flat discs (``tests/test_torch_tile.py``'s
    ``_image``), uint8 HWC."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for _ in range(12):
        cy, cx, r = rng.integers(0, hw[0]), rng.integers(0, hw[1]), \
            rng.integers(6, 30)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 255, 3)
    return img
