"""Training convergence round trip: synthetic structured samples -> the
port's ``run_train`` for some hundred steps -> the loss must fall -> the
saved checkpoint through the port's tile CLI -> instances aligned with the
drawn discs.

The port's counterpart of ``tools/train_convergence.py``: the same model
(resnet18; Gland, Gland#TYPE and Patch-Class), 48^2 geometry, batch 4,
logging, validation and a checkpoint once an epoch, 20 epochs, the same 64
samples (discs of radius 9-13 px), and the tile CLI at 144 -> 48 on the
same 384^2 image of twelve discs drawn six times larger. Both CLIs run in
this process, on the card unless ``CERBERUS_DEFAULT_DEVICE`` says ``cpu``.

The served discs are larger than any the 64 samples show, and there the
trained model either fills them (foreground IoU ~0.94) or calls their
inside contour (IoU 0.1-0.75): which, the initial weights and f32
rounding decide, for the JAX package's trainer as for this one (PERF.md
§6). So by default 32 more samples are 64^2 windows of images drawn at
the served scale (``--served_scale_samples``; 0 is the JAX tool's data):
the round trip then checks what training learned, not a coin flip
(96 samples, 480 steps).

Usage:
  python -m cerberus_tpu_torch.train.convergence [--epochs=20] [--root=<dir>]
      [--seed=0] [--served_scale_samples=32]

``--seed`` is ``run_train``'s: it draws the initial weights. Prints the
loss curve per epoch, ``infer_instances`` and ``infer_fg_iou`` (foreground
IoU against the drawn discs) and the seconds of each half, as one JSON
line (also written to ``<root>/convergence.json``), and exits non-zero
unless ``loss_last <= 0.1 * loss_first``, ``infer_instances > 0`` and
``infer_fg_iou >= 0.75``.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": {"Gland": {"INST": 3},
                       "Gland#TYPE": {"TYPE": 3},
                       "Patch-Class": {"OUT": 9}},
    "considered_tasks": ["Gland", "Gland#TYPE", "Patch-Class"],
}
TARGET_CODE = {"Gland-INST": "IP-ERODED-CONTOUR-3", "Gland-TYPE": "TP",
               "Patch-Class": "PC"}
LOSS_RATIO_MAX = 0.1
IOU_MIN = 0.75
SERVED_SCALE_SAMPLES = 32


def draw_sample(rng, hw=64, infer_scale=1):
    """White background + dark discs: a colour rule a small net can learn.
    Returns (img, inst_map)."""
    import cv2

    h = w = hw * infer_scale
    img = np.full((h, w, 3), 235, np.uint8)
    inst = np.zeros((h, w), np.int32)
    n = rng.integers(1, 3) if infer_scale == 1 else 12
    for i in range(1, int(n) + 1):
        r = int(rng.integers(9, 14)) * infer_scale
        cy = int(rng.integers(r + 2, h - r - 2))
        cx = int(rng.integers(r + 2, w - r - 2))
        col = tuple(int(v) for v in rng.integers(30, 110, 3))
        cv2.circle(img, (cx, cy), r, col, -1)
        cv2.circle(inst, (cx, cy), r, int(i), -1)
    return img, inst


def _save(data_dir, name, img, inst):
    np.save(os.path.join(data_dir, name + ".npy"), {
        "img": img, "ann": np.stack([inst, (inst > 0).astype(np.int32)], -1),
        "channels": ["Gland-INST", "Gland-TYPE"], "patch_class": 1})


def make_dataset(data_dir, n=64, seed=0, served_scale=0):
    """``n`` samples in ``MTLPatchDataset``'s ``.npy`` format (those of
    ``tools/train_convergence.py``), then ``served_scale`` more: 64^2
    windows at random places of images drawn at the served scale (6x),
    from their own generator."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        _save(data_dir, "s%d" % i, *draw_sample(rng))
    rng = np.random.default_rng(seed + 1)
    for i in range(served_scale):
        if i % 4 == 0:
            img, inst = draw_sample(rng, infer_scale=6)
        y, x = (int(v) for v in rng.integers(0, img.shape[0] - 64, 2))
        _save(data_dir, "big%d" % i, img[y:y + 64, x:x + 64].copy(),
              inst[y:y + 64, x:x + 64].copy())


def _epoch_loss(entry: dict) -> float:
    for key, value in entry.items():
        if key.endswith("overall_loss"):
            return float(value)
    return float(sum(float(v) for k, v in entry.items()
                     if "loss" in k and isinstance(v, (int, float))))


def run(epochs: int = 20, root: str = None, n_samples: int = 64,
        device=None, seed: int = 0, pretrained: str = None,
        served_scale: int = SERVED_SCALE_SAMPLES) -> dict:
    """Train (``run_train --seed=<seed>``, or from the ``--pretrained``
    checkpoint), serve the last checkpoint, and return the artifact
    dict."""
    import cv2
    import scipy.io as sio
    import yaml

    from .. import run_infer_tile, run_train

    root = root or os.path.join(tempfile.gettempdir(),
                                "cerberus_train_convergence")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data_dir = os.path.join(root, "data")
    make_dataset(data_dir, n=n_samples, served_scale=served_scale)
    settings = {
        "model_kwargs": MODEL_KWARGS,
        "optimizer_kwargs": {"lr": 1.0e-3, "betas": [0.9, 0.999]},
        "loss_kwargs": {"loss_info": {
            "Gland-INST": {"weight": 1, "loss": {"ce": 1}},
            "Gland-TYPE": {"weight": 1, "loss": {"ce": 1, "dice": 1}},
            "Patch-Class": {"weight": 0.4, "loss": {"ce": 1}},
        }},
        "dataset_kwargs": {"req_target_code": dict(TARGET_CODE),
                           "train_dir": data_dir, "input_shape": 48,
                           "output_shape": 48},
    }
    settings_path = os.path.join(root, "settings.yml")
    with open(settings_path, "w") as handle:
        yaml.safe_dump(settings, handle)

    log_dir = os.path.join(root, "logs")
    steps_per_epoch = (n_samples + served_scale) // 4
    start = time.perf_counter()
    run_train.main(["--settings=%s" % settings_path, "--log_dir=%s" % log_dir,
                    "--nr_epochs=%d" % epochs, "--batch_size=4",
                    "--per_n_steps=%d" % steps_per_epoch, "--seed=%d" % seed]
                   + (["--pretrained=%s" % pretrained] if pretrained else []),
                   device=device)
    train_s = time.perf_counter() - start
    with open(os.path.join(log_dir, "stats.yml")) as handle:
        stats = yaml.safe_load(handle)
    curve = [_epoch_loss(stats[k]) for k in sorted(stats, key=int)]

    ckpts = (sorted(glob.glob(os.path.join(log_dir, "*epoch-*.tar")))
             or sorted(glob.glob(os.path.join(log_dir, "*step-*.tar"))))
    if not ckpts:
        raise FileNotFoundError("no checkpoints under %s" % log_dir)
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    shutil.copy(ckpts[-1], os.path.join(model_dir, "weights.tar"))
    with open(os.path.join(model_dir, "settings.yml"), "w") as handle:
        yaml.safe_dump({"dataset_kwargs":
                        {"req_target_code": dict(TARGET_CODE)},
                        "model_kwargs": MODEL_KWARGS}, handle)
    img, inst_true = draw_sample(np.random.default_rng(99), hw=64,
                                 infer_scale=6)  # 384^2
    in_dir = os.path.join(root, "input")
    os.makedirs(in_dir)
    cv2.imwrite(os.path.join(in_dir, "t.png"),
                cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    out_dir = os.path.join(root, "out")
    start = time.perf_counter()
    run_infer_tile.main(["--model=%s" % model_dir, "--input_dir=%s" % in_dir,
                         "--output_dir=%s" % out_dir, "--batch_size=4",
                         "--patch_input_shape=144",
                         "--patch_output_shape=48"], device=device)
    infer_s = time.perf_counter() - start
    inst_map = sio.loadmat(os.path.join(out_dir, "gland_mat",
                                        "t.mat"))["inst_map"]
    true_fg, pred_fg = inst_true > 0, inst_map > 0
    iou = (np.logical_and(true_fg, pred_fg).sum()
           / max(np.logical_or(true_fg, pred_fg).sum(), 1))
    artifact = {
        "metric": "train->checkpoint->infer round trip (48^2 resnet18)",
        "seed": seed, "served_scale_samples": served_scale,
        "epochs": epochs, "steps": epochs * steps_per_epoch,
        "loss_curve_per_epoch": curve,
        "loss_first": curve[0], "loss_last": curve[-1],
        "infer_instances": int(len(np.unique(inst_map)) - 1),
        "infer_fg_iou": float(iou),
        "train_seconds": train_s, "infer_seconds": infer_s,
    }
    with open(os.path.join(root, "convergence.json"), "w") as handle:
        json.dump(artifact, handle, indent=1)
    return artifact


def check(artifact: dict) -> None:
    """Raise ``AssertionError`` unless the loss fell to a tenth and the
    served checkpoint found mask-aligned instances."""
    first, last = artifact["loss_first"], artifact["loss_last"]
    if not last <= LOSS_RATIO_MAX * first:
        raise AssertionError("loss did not fall to %.2fx: %.4f -> %.4f"
                             % (LOSS_RATIO_MAX, first, last))
    if artifact["infer_instances"] <= 0:
        raise AssertionError("the trained checkpoint found no instances")
    if not artifact["infer_fg_iou"] >= IOU_MIN:
        raise AssertionError("instances not mask-aligned (IoU %.3f < %.2f)"
                             % (artifact["infer_fg_iou"], IOU_MIN))


def main(argv=None) -> int:
    epochs, root, seed, served = 20, None, 0, SERVED_SCALE_SAMPLES
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, value = arg.partition("=")
        if name == "--epochs":
            epochs = int(value)
        elif name == "--root":
            root = value
        elif name == "--seed":
            seed = int(value)
        elif name == "--served_scale_samples":
            served = int(value)
        else:
            raise SystemExit(__doc__)
    artifact = run(epochs, root, seed=seed, served_scale=served)
    print(json.dumps(artifact), flush=True)
    check(artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
