"""The DSF-CNN-8 model through the port's WSI engine against the plain
reference (``portbench/reference``: PyTorch, numpy, scipy, cv2 in float32,
nothing of the port), on the CPU, with no JAX.

A seeded ``dsf_cnn_8`` with the five DSF heads: the reference init
(``init_weights``), G-conv coefficients x0.01 (``GSCALE_SERVED``: at the
x0.05 of the four-orientation parity tests, eight orientations take the
logits to 1e26 and every TYPE head to one class), randomised BN
statistics (so the G batch norm's orientation view matters), and the last
1x1 conv of every INST and TYPE head standardised on two of the slide's
windows, so that the INST heads give nuclei and each TYPE head more than
one class. It serves a 192x240 Aperio-style ``.svs`` slide with a tissue
mask PNG at 64->32 through ``process_single_file``: the resident loop and
the ``gpu`` families, as the WSI CLI runs them, here on the CPU in f32
with the disk canvas in f16.

Held against the reference forward of the same input windows and the
reference nuclei family on the canvas:
  * every written window's INST probabilities within ``INST_TOL`` (one f16
    ulp in [0.5, 1): the canvas rounds to f16, the forwards agree to
    float32 rounding);
  * TYPE class ids equal, with at least two classes in each TYPE channel;
  * the slide's nuclei records (box and centroid) equal the reference
    family's on the whole canvas, with no record on either side alone;
  * the same run with one G->G convolution's orientation roll reversed
    fails that comparison.
The slide log's ``Steerable Kernel Syntheses`` line is held against the
model's forward calls times its 82 G-convolutions.
"""
import logging
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from _torch_dsf_helpers import (
    DSF_DECODERS,
    GSCALE_SERVED,
    SYNTH_INST_BIAS,
    SYNTH_SPREAD,
    dsf_model,
)
from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
from cerberus_tpu_torch.infer import wsi as port_wsi
from cerberus_tpu_torch.models.gconv import GConv2d
from cerberus_tpu_torch.wsi.ioconfig import (
    make_inference_ioconfig,
    make_postproc_ioconfig,
)
from portbench.drivers.wsi_cohort import _SPAN, dat_records, input_window
from portbench.reference import grid
from portbench.reference import postproc as ref_pp
from portbench.reference.model import Net, channel_map, forward_windows
from portbench.traffic.images import synthetic_image, tissue_mask, write_svs

torch.set_num_threads(2)

ARCH = "dsf_cnn_8"
N_GCONV = 82  # G-convolutions of dsf_cnn_8 with the five DSF heads
WIN_IN, WIN_OUT = 64, 32
SLIDE_HW = (192, 240)
MASK_DS = 4
TISSUE = [[0.5, 0.5, 0.2, 0.2]]  # 12 output windows
TARGET_CODE = {k: v for k, v in DEFAULT_TARGET_CODE.items()
               if k != "Patch-Class"}
INST_TOL = 4.9e-4


def standardised_heads(model, x):
    """Rewrite the last 1x1 conv of each INST and TYPE head so that its
    logits in the output windows of ``x`` (NCHW in [0, 1]; the centre the
    canvas keeps) get standard deviation ``SYNTH_SPREAD`` per channel and
    means ``SYNTH_INST_BIAS`` (INST) or 0 (TYPE). In place; returns the
    model."""
    m = (WIN_IN - WIN_OUT) // 2
    with torch.no_grad():
        out = model(x)
        for dec, heads in DSF_DECODERS.items():
            task = dec.split("#")[0]
            for head in heads:
                logits = out["%s-%s" % (task, head)][
                    ..., m:m + WIN_OUT, m:m + WIN_OUT].double()
                mean = logits.mean(dim=(0, 2, 3))
                std = logits.std(dim=(0, 2, 3)).clamp(min=1e-12)
                want = torch.tensor(SYNTH_INST_BIAS[task] if head == "INST"
                                    else [0.0] * len(mean),
                                    dtype=torch.float64)
                conv = model.output_head[dec][head].block[1].conv
                gain = SYNTH_SPREAD / std
                conv.weight.mul_(gain.float()[:, None, None, None])
                conv.bias.copy_(((conv.bias.double() - mean) * gain
                                 + want).float())
    return model


def run_slide(root, tag, state_dict, kwargs, slide, fault=None):
    """``process_single_file`` on ``slide`` with ``state_dict`` (and
    ``fault`` applied to the manager's model): (the f16 disk canvas as f32,
    the ``.dat`` payload, the slide log's lines, the model's forward
    calls)."""
    ckpt = os.path.join(root, tag + ".tar")
    torch.save({"desc": state_dict}, ckpt)
    out = os.path.join(root, "out_" + tag)
    for sub in ("dat", "tissue"):
        os.makedirs(os.path.join(out, sub))
    manager = port_wsi.InferManager(
        checkpoint_path=ckpt, decoder_dict=TARGET_CODE, model_args=kwargs,
        device="cpu", batch_size=6, patch_input_shape=WIN_IN,
        patch_output_shape=WIN_OUT, tile_shape=288, chunk_shape=480,
        ambiguous_size=16, wsi_proc_mag=0.5, postproc_backend="gpu",
        nr_inference_workers=0, nr_post_proc_workers=0,
        cache_path=os.path.join(root, "cache_" + tag))
    if fault is not None:
        fault(manager.model)
    calls = []
    manager.model.register_forward_hook(lambda *_: calls.append(1))
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    manager.logger = logging.getLogger("test_dsf_reference." + tag)
    manager.logger.handlers = [handler]
    manager.logger.setLevel(logging.INFO)
    manager.logger.propagate = False
    n_heads = len(manager.cfg.active_decoder_kwargs)
    manager.process_single_file(
        make_inference_ioconfig(0.5, n_heads, tile_shape=480, margin=16,
                                patch_input=WIN_IN, patch_output=WIN_OUT),
        make_postproc_ioconfig(0.5, tile_shape=288, margin=16),
        slide["path"], slide["mask_path"], "s", out)
    canvas = np.load(os.path.join(manager.cache_path, "raw.npy"))
    with open(os.path.join(out, "dat", "s.dat"), "rb") as handle:
        dat = pickle.load(handle)
    return canvas.astype(np.float32), dat, lines, len(calls)


def compare(canvas, dat, ref, windows):
    """The comparison: (INST gap, TYPE ids that differ, reference nuclei
    records, records of either side without an equal one on the
    other)."""
    chans = channel_map(DSF_DECODERS)
    gap, flips = 0.0, 0
    for (x, y), r in zip(windows, ref):
        got = canvas[y:y + WIN_OUT, x:x + WIN_OUT]
        r = r[:got.shape[0], :got.shape[1]]
        for key, (s, e) in chans.items():
            if key.endswith("-INST"):
                gap = max(gap, float(np.abs(got[..., s:e]
                                            - r[..., s:e]).max()))
            else:
                flips += int((got[..., s] != r[..., s]).sum())
    s, e = chans["Nuclei-INST"]
    h, w = canvas.shape[:2]
    plane = np.zeros((grid.pad512(h, WIN_OUT), grid.pad512(w, WIN_OUT),
                      e - s), np.float32)
    plane[:h, :w] = canvas[..., s:e]
    labels = ref_pp.nuclei_labels(plane[..., 0], plane[..., 1], "cpu")
    want = ref_pp.records(labels)
    missing, extra = ref_pp.unmatched(want, dat_records(dat))
    return gap, flips, len(want), missing + extra


@pytest.fixture(scope="module")
def dsf8(tmp_path_factory):
    """The slide, the sound model's state dict and the reference's canvas
    windows of the written windows."""
    root = str(tmp_path_factory.mktemp("dsf8_reference"))
    rng = np.random.default_rng(1618)
    truth = write_svs(os.path.join(root, "s.svs"),
                      synthetic_image(SLIDE_HW, rng), 64, 90, 0.5)
    mask = tissue_mask((SLIDE_HW[0] // MASK_DS, SLIDE_HW[1] // MASK_DS),
                       TISSUE)
    mask_path = os.path.join(root, "s.png")
    cv2.imwrite(mask_path, mask * 255)
    windows = grid.slide_windows(SLIDE_HW[1], SLIDE_HW[0], WIN_IN, WIN_OUT,
                                 mask)
    margin = (WIN_IN - WIN_OUT) // 2
    inputs = np.stack([input_window(truth, x - margin, y - margin, WIN_IN)
                       for x, y in windows])
    model, kwargs = dsf_model(ARCH, seed=7, gscale=GSCALE_SERVED,
                              random_bn=True)
    assert sum(isinstance(m, GConv2d) for m in model.modules()) == N_GCONV
    sample = torch.from_numpy(inputs[:2]).permute(0, 3, 1, 2).float() / 255
    sd = standardised_heads(model, sample).state_dict()
    ref = forward_windows(Net(dict(sd), ARCH, DSF_DECODERS), inputs, WIN_OUT,
                          "cpu")
    slide = {"path": os.path.join(root, "s.svs"), "mask_path": mask_path}
    return {"root": root, "slide": slide, "sd": sd, "kwargs": kwargs,
            "windows": windows, "ref": ref}


def test_dsf8_wsi_run_equals_the_reference(dsf8):
    canvas, dat, lines, calls = run_slide(
        dsf8["root"], "sound", dsf8["sd"], dsf8["kwargs"], dsf8["slide"])
    gap, flips, n_ref, mismatch = compare(canvas, dat, dsf8["ref"],
                                          dsf8["windows"])
    assert gap <= INST_TOL and flips == 0 and mismatch == 0, (
        gap, flips, mismatch)
    assert n_ref >= 5, n_ref
    chans = channel_map(DSF_DECODERS)
    for key in ("Nuclei-TYPE", "Gland-TYPE"):
        ids = np.concatenate([canvas[y:y + WIN_OUT, x:x + WIN_OUT,
                                     chans[key][0]].ravel()
                              for x, y in dsf8["windows"]])
        assert len(np.unique(ids)) >= 2, key
    assert not os.path.exists(os.path.join(dsf8["root"], "out_sound",
                                           "tissue", "s.mat"))
    synth = [m for m in map(_SPAN.match, lines)
             if m and m.group(1) == "Steerable Kernel Syntheses"]
    assert len(synth) == 1
    assert calls >= 2 and int(synth[0].group(2)) == N_GCONV * calls


def reverse_one_roll(model):
    """One G->G convolution (the middle one) reads the input orientations
    rolled the wrong way: (j + o) mod O at position j of output
    orientation o, not (j - o) mod O."""
    g2g = [m for m in model.modules()
           if isinstance(m, GConv2d) and m.roll.any()]
    roll = g2g[len(g2g) // 2].roll
    n = roll.shape[1]
    roll.copy_((2 * torch.arange(n)[None, :] - roll) % n)


def test_reversed_orientation_roll_fails_the_comparison(dsf8):
    canvas, dat, _, _ = run_slide(dsf8["root"], "fault", dsf8["sd"],
                                  dsf8["kwargs"], dsf8["slide"],
                                  fault=reverse_one_roll)
    gap, flips, _, mismatch = compare(canvas, dat, dsf8["ref"],
                                      dsf8["windows"])
    assert gap > INST_TOL or flips > 0 or mismatch > 0
