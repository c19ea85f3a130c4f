#!/usr/bin/env python3
"""Drive cerberus_tpu_torch on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with an H100 and nvcc):

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device: ``nvidia-smi`` name and power limit, then the kernel build
     (every ``csrc/*.cu`` compiled by nvcc in parallel, at first use);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, exactly, at the main path's shapes (CC on 600^2 and 1000^2
     foreground masks and a thin spiral, the histogram on a 1000^2 compacted
     id plane, the watershed and its one-level ``propagate_labels`` entry
     on a 1000^2 nuclei-like plane), with median CUDA-event times of
     kernel, plain version and, for the histogram, ``torch.bincount``;
  3. forward: a full-width ResNet-34 NetDesc with seeded random weights and
     randomised BN statistics, written as ``weights.tar`` and loaded through
     ``InferManager``; the card's f32 forward (TF32 off) against the port's
     CPU forward on a batch of 2 at 448^2, 1e-3 relative per head;
  4. main path: the same seeded model with the synthetic-model recipe
     (INST heads scaled 0.003x, bias [-2, 2, -1.5] for Nuclei and
     [-2, -0.3, -1.5] for Gland and Lumen, default BN statistics), loaded
     the same way, through ``InferManager.process_image`` on three
     synthetic images (600^2, 1000^2, 1000^2) at 448->144, batch 10, bf16,
     with launch counts reset just before and read just after. The Gland
     bias splits the gland plane into separate instances whose dilations
     enclose pockets bordered by two of them, so every image takes
     ``fill_label_holes``'s contested flood (``propagate_labels``). Then the
     kernel-backed families against the plain-version families on the same
     device canvases, byte for byte.

The second-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without CUDA, or without the package beside this script, it exits 1 and
prints no result. It imports nothing of JAX, cerberus_tpu, cv2 or PyYAML.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
FWD_REL_TOL = 1e-3
# synthetic INST-head bias (bg, inner, contour) per task; the kernel is
# scaled 0.003x so the image modulates the probabilities around it
SYNTH_INST_BIAS = {"Gland": (-2.0, -0.3, -1.5), "Lumen": (-2.0, -0.3, -1.5),
                   "Nuclei": (-2.0, 2.0, -1.5)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, one pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def blob_prob(hw, n, seed, rmin, rmax):
    """Max of n seeded cone blobs: a probability plane with nuclei- or
    gland-like components."""
    rng = np.random.default_rng(seed)
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        rad = rng.uniform(rmin, rmax)
        r = int(np.ceil(rad))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, hw[0])
        x0, x1 = max(cx - r, 0), min(cx + r + 1, hw[1])
        yy, xx = np.mgrid[y0:y1, x0:x1]
        cone = np.clip(1 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / rad,
                       0, 1).astype(np.float32)
        prob[y0:y1, x0:x1] = np.maximum(prob[y0:y1, x0:x1], cone)
    return prob


def spiral(n):
    mask = np.zeros((n, n), bool)
    t, l, b, r = 0, 0, n - 1, n - 1
    while t <= b and l <= r:
        mask[t, l:r + 1] = mask[b, l:r + 1] = True
        mask[t:b + 1, r] = True
        mask[t + 2:b + 1, l] = True
        if t + 2 <= b:
            mask[t + 2, l:r - 1] = True
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    return mask


def synthetic_image(hw, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for _ in range(hw[0] * hw[1] // 4000):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        r = rng.integers(4, 40)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(
            0, 255, 3)
    return img


def phase_kernels(torch, dev):
    """Each kernel vs its plain version on the card, exact."""
    from cerberus_tpu_torch.ops import device_postproc as D
    from cerberus_tpu_torch.ops.cc_label import (
        REPLACES as CC_REPLACES, SOURCE as CC_SOURCE,
        connected_components, connected_components_plain)
    from cerberus_tpu_torch.ops.hist16384 import (
        REPLACES as H_REPLACES, SOURCE as H_SOURCE, hist16384,
        hist16384_plain)
    from cerberus_tpu_torch.ops.watershed import (
        REPLACES as WS_REPLACES, SOURCE as WS_SOURCE, propagate_labels,
        propagate_labels_plain, watershed, watershed_plain)

    rows, worst = {}, {}

    def check(name, case, got, ref, ms, plain_ms, lib_ms, bytes_, ops,
              report):
        err = int((got.long() - ref.long()).abs().max()) if got.numel() \
            else 0
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        emit({"phase": "kernel", "name": name, "case": case,
              "shape": list(got.shape), "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bound_by": bound_by})
        if err != 0:
            raise AssertionError("%s/%s differs from its plain version"
                                 % (name, case))
        worst[name] = max(worst.get(name, 0), err)
        if report:
            rows[name] = {"ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}

    cc_cases = [
        ("fg600", torch.from_numpy(blob_prob((600, 600), 600, 1, 3, 12)
                                   > 0.5), False),
        ("spiral512", torch.from_numpy(spiral(512)), False),
        ("fg1000", torch.from_numpy(blob_prob((1000, 1000), 1600, 2, 3, 12)
                                    > 0.5), True),
    ]
    for case, mask, report in cc_cases:
        mask = mask.to(dev).contiguous()
        n = mask.numel()
        got = connected_components(mask)
        ref = connected_components_plain(mask)
        check("cc_label", case, got, ref,
              cuda_ms(lambda: connected_components(mask), 20),
              cuda_ms(lambda: connected_components_plain(mask), 3), None,
              n * 1 + n * 4, n * 4, report)

    prob = blob_prob((1000, 1000), 1600, 3, 3, 12)
    lab = connected_components(torch.from_numpy(prob > 0.5).to(dev))
    ids, n_ids = D.compact_labels(lab)
    ids = ids.contiguous()
    if n_ids >= D.HIST_CAP:
        raise AssertionError("compacted id plane has %d ids" % n_ids)
    got, ref = hist16384(ids), hist16384_plain(ids)
    lib = torch.bincount(ids.reshape(-1).clamp(0, D.HIST_CAP - 1).long(),
                         minlength=D.HIST_CAP)
    if not torch.equal(lib.int(), ref):
        raise AssertionError("torch.bincount disagrees with hist16384_plain")
    check("hist16384", "ids1000", got, ref, cuda_ms(lambda: hist16384(ids), 50),
          cuda_ms(lambda: hist16384_plain(ids), 20),
          cuda_ms(lambda: torch.bincount(
              ids.reshape(-1).clamp(0, D.HIST_CAP - 1).long(),
              minlength=D.HIST_CAP), 20),
          ids.numel() * 4 + D.HIST_CAP * 4, ids.numel(), True)

    inner = blob_prob((1000, 1000), 1600, 4, 3, 9)
    image = torch.from_numpy(-inner).to(dev)
    markers = connected_components(torch.from_numpy(inner > 0.6).to(dev))
    wmask = torch.from_numpy(inner > 0.1).to(dev)
    got = watershed(image, markers, wmask)
    ref = watershed_plain(image, markers, wmask)
    n = image.numel()
    # what the function needs: a level-bucketed wavefront flood touches each
    # pixel a constant number of times (bucket, then one neighbour minimum)
    check("watershed", "nuclei1000", got, ref,
          cuda_ms(lambda: watershed(image, markers, wmask), 5),
          cuda_ms(lambda: watershed_plain(image, markers, wmask), 2), None,
          n * (4 + 4 + 1) + n * 4, n * 6, True)
    got = propagate_labels(markers, wmask)
    ref = propagate_labels_plain(markers, wmask)
    check("propagate_labels", "nuclei1000", got, ref,
          cuda_ms(lambda: propagate_labels(markers, wmask), 5),
          cuda_ms(lambda: propagate_labels_plain(markers, wmask), 2), None,
          n * (4 + 1) + n * 4, n * 4, True)
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
    sources = {"cc_label": (CC_SOURCE, CC_REPLACES),
               "hist16384": (H_SOURCE, H_REPLACES),
               "watershed": (WS_SOURCE, WS_REPLACES),
               "propagate_labels": (WS_SOURCE, WS_REPLACES)}
    return rows, sources


def make_manager(torch, path, synthetic_heads: bool):
    """A seeded random full-width ResNet-34 NetDesc written as weights.tar
    and loaded through ``InferManager``. ``synthetic_heads``: the
    synthetic-model recipe (INST kernels scaled 0.003x, biases
    ``SYNTH_INST_BIAS``) so instances appear; otherwise BN statistics are
    randomised so the forward check exercises them."""
    from cerberus_tpu_torch.config import (DEFAULT_DECODER_KWARGS,
                                           DEFAULT_TARGET_CODE, ModelConfig)
    from cerberus_tpu_torch.infer.tile import InferManager
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

    model_kwargs = {"encoder_backbone_name": "resnet34",
                    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
                    "considered_tasks": list(DEFAULT_DECODER_KWARGS)}
    gen = torch.Generator().manual_seed(0)
    model = init_weights(NetDesc(ModelConfig.from_kwargs(model_kwargs)), gen)
    with torch.no_grad():
        if synthetic_heads:
            for task, bias in SYNTH_INST_BIAS.items():
                conv = model.output_head[task]["INST"].x[1].conv
                conv.weight.mul_(0.003)
                conv.bias.copy_(torch.tensor(bias))
        else:
            for mod in model.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    mod.running_mean.copy_(torch.randn(
                        mod.running_mean.shape, generator=gen) * 0.1)
                    mod.running_var.copy_(torch.rand(
                        mod.running_var.shape, generator=gen) + 0.5)
    os.makedirs(path, exist_ok=True)
    try:
        torch.save({"desc": model.state_dict()},
                   os.path.join(path, "weights.tar"))
        return InferManager(
            checkpoint_path=os.path.join(path, "weights.tar"),
            decoder_dict=dict(DEFAULT_TARGET_CODE), model_args=model_kwargs,
            device="cuda", batch_size=10, patch_input_shape=448,
            patch_output_shape=144)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def phase_forward(torch, manager):
    """The card's f32 forward vs the port's CPU forward, 448^2, batch 2."""
    import copy

    from cerberus_tpu_torch.models.net_desc import net_forward

    imgs = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 448, 448, 3)).astype(np.uint8))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            gpu = net_forward(manager.model, imgs.to(manager.device))
            cpu_model = copy.deepcopy(manager.model).cpu()
            cpu = net_forward(cpu_model, imgs)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    errs = {}
    for head, ref in cpu.items():
        got = gpu[head].cpu()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError("forward head %s malformed" % head)
        errs[head] = float((got - ref).abs().max()) / max(
            1.0, float(ref.abs().max()))
    emit({"phase": "forward", "batch": 2, "hw": 448, "rel_err": errs,
          "tol": FWD_REL_TOL})
    bad = {k: v for k, v in errs.items() if not v <= FWD_REL_TOL}
    if bad:
        raise AssertionError("forward heads off tolerance: %s" % bad)


def phase_main_path(torch, manager):
    from cerberus_tpu_torch.data.patching import prepare_patching
    from cerberus_tpu_torch.infer.tile import post_process_canvas
    from cerberus_tpu_torch.ops import cuda_build
    from cerberus_tpu_torch.ops.device_postproc import KERNELS, PLAIN

    images = [synthetic_image(hw, seed) for hw, seed in
              (((600, 600), 11), ((1000, 1000), 12), ((1000, 1000), 13))]
    n_tiles = sum(len(prepare_patching(img, 448, 144)[1]) for img in images)
    manager.process_image(images[0])  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()

    cuda_build.reset_launch_counts()
    results, per_image_ms = [], []
    t_all = time.perf_counter()
    for img in images:
        t0 = time.perf_counter()
        results.append(manager.process_image(img))
        torch.cuda.synchronize()
        per_image_ms.append((time.perf_counter() - t0) * 1e3)
    seconds = time.perf_counter() - t_all
    launches = dict(cuda_build.launch_counts)

    instances = {}
    for img, (inst, types, pclass) in zip(images, results):
        for task, lab in inst.items():
            if lab.shape != img.shape[:2]:
                raise AssertionError("%s label map has shape %s"
                                     % (task, lab.shape))
            instances.setdefault(task, []).append(len(np.unique(
                lab[lab > 0])))
        if pclass is None or pclass.shape != img.shape[:2] or not (
                np.isfinite(pclass).all() and 0 <= pclass.min()
                and pclass.max() <= 8):
            raise AssertionError("patch-class map malformed")
    emit({"phase": "main_path", "images": [list(i.shape[:2]) for i in images],
          "batch": int(manager.batch_size), "compute": "bf16",
          "instances": instances, "ms_per_image": per_image_ms,
          "tiles_448": n_tiles, "tiles_per_s": n_tiles / seconds,
          "launches": launches})
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("kernel %s was not launched on the main path"
                                 % name)
    for task in ("Gland", "Nuclei"):
        if sum(instances.get(task, [])) <= 0:
            raise AssertionError("no %s instances on the main path" % task)

    # host-clock split of each image's time (synchronised at each seam)
    split = {"canvas_ms": [], "postproc_ms": [], "plain_postproc_ms": []}
    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)
    for i, img in enumerate(images):
        t0 = time.perf_counter()
        canvas = manager.infer_canvas(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, _, _ = post_process_canvas(canvas, *args, impl=KERNELS)
        t2 = time.perf_counter()
        ref, _, _ = post_process_canvas(canvas, *args, impl=PLAIN)
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(dt * 1e3)
        for task in ref:
            if not np.array_equal(got[task], ref[task]):
                raise AssertionError("image %d %s: kernel families differ "
                                     "from plain families" % (i, task))
    emit({"phase": "families_vs_plain", "images": len(images),
          "byte_equal": True, **split})
    return launches


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cerberus_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    emit({"phase": "build", "seconds": cuda_build.build_all(),
          "kernels": list(cuda_build.KERNELS)})

    rows, sources = phase_kernels(torch, dev)

    model_dir = os.path.join(cuda_build.BUILD_DIR, "smoke_model")
    phase_forward(torch, make_manager(torch, model_dir, False))
    launches = phase_main_path(torch, make_manager(torch, model_dir, True))

    kernels = []
    for name in cuda_build.LAUNCH_COUNTERS:
        source, replaces = sources[name]
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    try:
        return run()
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
