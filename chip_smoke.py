#!/usr/bin/env python3
"""Drive cerberus_tpu_torch on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with an H100 and nvcc):

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device: ``nvidia-smi`` name and power limit, then the kernel build
     (every ``csrc/*.cu`` compiled by nvcc in parallel, at first use);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, exactly, at the main path's shapes (CC on 600^2 and 1000^2
     foreground masks, a 1002^2 ring-padded background plane and thin
     spirals; the histogram on a 1000^2 compacted id plane, with and
     without the family's ``n_live`` hint, and the two alternated over
     twelve rounds on a ``hist_n_live_pairs`` line; the
     watershed and its one-level ``propagate_labels`` entry on a 1000^2
     nuclei-like plane, the same plane quantised into plateaus, and a
     768^2 one-pixel spiral corridor flooded from both ends) and at the
     WSI grid tile's window (CC and both flood entries on 2560^2
     nuclei-like planes), with median
     CUDA-event times of kernel, plain version and, for the histogram,
     ``torch.bincount``. Each kernel case times a call four ways: ``ms``
     (one call per CUDA-event pair, the host's enqueue inside the window),
     ``device_ms`` (the call's kernels and memsets alone, summed from
     ``torch.profiler``; ``device_ms_from`` says ``queue`` where it is
     ``queued_ms`` instead: a call of over 20 ms, or a profile that kept
     losing events), ``host_us`` (host wall time to enqueue one call, no
     synchronise inside), and ``queued_ms`` (per call when many are
     enqueued behind one event pair). A ``launch_floor`` line gives the
     same figures for an empty kernel through the same ctypes route, and a
     ``host_parts_us`` line the host's cost of a wrapper's pieces. Each
     flood case also prints the levels visited, passes and tile passes of
     the entry's last call, read back from its device counters;
  3. forward: a full-width ResNet-34 NetDesc with seeded random weights and
     randomised BN statistics, written as ``weights.tar`` and loaded through
     ``InferManager``; on a batch of 2 at 448->144 in f32 (TF32 off) the
     card's full towers and valid-region heads against the port's CPU
     forward (1e-3 relative per head), and the valid-region heads against
     the full towers' centre crop on the card (1e-4); the same check for
     densenet121, mobilenet_v2 and unet_encoder NetDescs at 224->72; the
     print-only ``valid_vs_full_f32_deterministic`` line repeats the
     ResNet-34 comparison with cuDNN deterministic, benchmark and TF32
     off, and says whether the heads are bit-equal;
  4. main path: the same seeded model with the synthetic-model recipe
     (INST heads scaled 0.003x, bias [-2, 2, -1.5] for Nuclei and
     [-2, -0.3, -1.5] for Gland and Lumen, default BN statistics), loaded
     the same way, through ``InferManager.process_image`` on three
     synthetic images (600^2, 1000^2, 1000^2) at 448->144, batch 10, bf16,
     valid-region decoding (the default), with launch counts reset just
     before and read just after (before it, the print-only
     ``batch_position_invariance`` line: the same windows stepped twice,
     with a zero-padded tail, and moved among other windows). The Gland
     bias splits the gland plane into separate instances whose dilations
     enclose pockets bordered by two of them, so every image takes
     ``fill_label_holes``'s contested flood (``propagate_labels``). Then the
     kernel-backed families against the plain-version families on the same
     device canvases, byte for byte; the same images through a manager
     bound under ``CERBERUS_VALID_REGION=0`` (full towers,
     ``main_path_full_towers``), and the two forwards' bf16 canvases and
     label maps side by side (``valid_vs_full_bf16``, printed only);
     ``main_path_dense``: the same images at 1168->864 (``--dense``), batch
     16, with output megapixels per second for both geometries, the
     families against the plain families and the Patch-Class grid checked;
     ``forward_profile``: ``torch.profiler`` over one batch of each forward
     (windowed full towers, windowed valid-region, dense valid-region), the
     top device operations and the achieved TFLOP/s;
  5. wsi: the WSI engine's device path with the same model in the WSI
     ``InferManager`` (448->144, batch 30, bf16) on a seeded synthetic
     3000x3500 ``.npy`` pyramid at 0.5 mpp (two levels), post-processing
     tile 2160 (a 2x2 grid whose nuclei windows pad to 2560^2), margin 64,
     inference tile 15000, no mask: placement, the resident loop
     (``ResidentWSIProcessor.run``, with this script's own host callback in
     place of the manager's contours), the nuclei boundary sets 1-3, and the
     gland/lumen region program on the landed canvas at 0.5x (made by a
     2x2 mean on the card: cv2's linear halving without cv2), launch counts
     reset just before and read just after. Every grid tile's, boundary
     tile's and region's label maps then equal the plain families' on the
     same inputs, byte for byte. It prints patches, slide seconds, per-phase
     seconds, launches and the largest plane each kernel was given;
  6. wsi_cli: ``python -m cerberus_tpu_torch.run_infer_wsi --gpu=0`` (its
     ``main``, in this process) on the same slide and model, host side
     included, launch counts reset just before and read just after, the
     per-phase spans read from its per-slide log; ``wsi_cli_dense``: the
     same with ``--dense --batch_size=16``;
  7. readers: the wsi phase's slide written by this script's own tiled
     TIFF writer as an Aperio ``.svs`` (256^2 tiles, two levels,
     ``MPP = 0.5``), deflate- and JPEG-coded, through ``open_wsi``: open
     time and read Mpx/s at 0.5 and 1.0 mpp, the deflate pixels equal to
     the ``.npy`` pyramid; ``read_batch`` patches/s on ``convert_slide``'s
     pyramid of the JPEG slide, the native gather equal to its numpy
     version; whether cv2 decodes JPEG 2000;
  8. wsi_cli_svs: the WSI CLI with its default ``--wsi_file_ext`` on the
     JPEG ``.svs`` (``gpu``, resident loop) and on its converted pyramid,
     payloads equal by content; wsi_cli_legacy:
     ``CERBERUS_RESIDENT=0 --postproc_backend=gpu`` (the legacy loop with
     the CUDA families), timed at batch 30, and equal by content to the
     resident loop where both run at ``--batch_size=1`` (the card's
     forward is not invariant to a window's place in its batch);
     wsi_cli_cpu: ``--postproc_backend=cpu`` (the reference's default
     run) with 0 and 4 post-processing workers, payloads equal, and
     against wsi_cli_legacy the JAX package's bounds between its
     backends (gland and lumen counts equal, nuclei within 2 %, filled
     instances disagreeing on < 2 % of pixels; >= 98 % of the gland and
     lumen instances matched by a centroid within 3 px, printed for
     nuclei).

  9. serving (after ``forward_profile``, on the main path's model):
     ``import_probe`` (whether sklearn, msgpack, flax and joblib are
     installed; none is imported); ``native_checkpoint``: the model written
     by the port's msgpack encoder as a native ``weights.tar`` and loaded
     through ``InferManager``, its state dict and the main path's canvases
     equal to the torch checkpoint's; ``tile_cli_cache``: the tile CLI on a
     directory of ten images (the main path's three and seven of 256^2 to
     600^2, so the cross-file batch cache mixes files) at batch 10 and
     ``--dense`` batch 16, with Mpx/s, ms per image and the zero-padded
     share of the windows for the CLI, the batch cache and the per-image
     path timed in alternating turns in the same call (the canvases
     alone and the whole path, on the main path's managers), the kernel
     families equal to the plain ones on every cached canvas, the ``.mat``
     files' maps at ``--batch_size=1`` equal to the per-image path's on
     the seven small images, and at batch 10 the canvas difference,
     instance counts and foreground IoU against the per-image path
     printed only; ``tile_cli_fused``: ``--tile_backend=fused`` at batch
     10, its canvases byte-equal to ``infer_canvas``'s (timed in turns
     with it) and its ``.mat`` maps to the per-image path's; ``predictor``: ``CerberusPredictor.from_model_dir``
     at batch 10, ``predict_tile`` / ``predict_raw`` byte-equal to
     ``process_image`` / ``infer_canvas`` and two threads to the serial
     results, ms per 1000^2 tile; ``patch_eval``: the ``run_eval_patch`` CLI
     on 512 seeded pickle-written 160^2 patches in 9 classes (the model's
     Patch-Class head scaled 0.01x so its softmax is not saturated, then
     standardised per class on the patches so that at least two
     classes are predicted), patches/s,
     its metrics equal to a recomputation from the step's probabilities
     and to a plain per-threshold numpy version, and the card's f32
     probabilities on 32 patches within 1e-3 relative of the CPU forward.
     The cache, fused and predictor runs reset the launch counts just
     before and read them just after; every kernel must launch in each.

  10. training (after the WSI phases; no kernel of the JAX package lies
     on it): ``train_step``: the default model (ResNet-34, six heads) at
     448^2, batch 12, on the synthetic batch of
     ``tests/_torch_train_helpers.py``, in bf16 and f32, bf16 with
     ``remat=True`` and bf16 with ``grad_accum=4``: median step ms,
     images/s, peak GiB, the device-busy share and top five operations
     of a profiled step, model TFLOP/s against the dense bf16 peak;
     ``train_parity``: the train step on the card against the CPU's
     (resnet18, 96^2, batch 4) in float64 and f32, plain, subtype-frozen
     and with a head missing and masked; ``train_cli``: ``python -m
     cerberus_tpu_torch.run_train`` on 24 seeded 448^2 samples for one
     epoch in bf16, then ``--resume`` of its checkpoint, with the host
     loader's share of the wall time; ``train_convergence``: ``python -m
     cerberus_tpu_torch.train.convergence`` (480 steps, then the tile
     CLI on the checkpoint); ``training_seconds``.

The second-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without CUDA, or without the package beside this script, it exits 1 and
prints no result. It imports nothing of JAX or cerberus_tpu; cv2 and
PyYAML are imported only by the CLIs' host side (phases 6, 8, 9 and 10)
and the readers phase.
"""
from __future__ import annotations

import contextlib
import io
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
VALID_REL_TOL = 1e-4   # valid-region vs full towers on the card, f32
NEW_ENCODERS = ("densenet121", "mobilenet_v2", "unet_encoder")
DENSE = (1168, 864, 16)  # the CLIs' --dense windows, batch 16
WSI_HW = (3000, 3500)  # (h, w) of the synthetic slide at 0.5 mpp
# post-processing tile of the wsi phase: 15 x 144 px, so each grid tile's
# nuclei window pads to 2560^2 (the CLI's 2048 floors to 2016-px tiles,
# whose windows pad to 2048^2)
WSI_TILE = 2160
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


def device_ms(fn, calls: int):
    """The device's own milliseconds per call of ``fn()``: every kernel,
    memset and copy that ``torch.profiler`` saw on the card over ``calls``
    calls, summed and divided. Gaps between them and the host's enqueue are
    not in it. Also returns the microseconds per call by activity name.
    The profiler now and then loses events (seen on calls of hundreds of
    milliseconds): a profile that does not hold every activity once (or n
    times) per call is taken again, and after three such, None is returned.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts, whole = {}, True
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            parts[evt.key[:48]] = parts.get(evt.key[:48], 0.0) + us / calls
            whole &= evt.count % calls == 0
        if parts and whole:
            return sum(parts.values()) / 1e3, parts
    return None


def enqueue_times(fn, calls: int):
    """(host microseconds to enqueue one call, milliseconds per call with
    the queue kept full): ``calls`` calls of ``fn()`` with no synchronise
    inside, under one host-clock window and behind one CUDA-event pair."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host / calls * 1e6, start.elapsed_time(end) / calls


def kernel_times(fn, iters: int) -> dict:
    """``ms``, ``device_ms``, ``host_us`` and ``queued_ms`` of one call of a
    kernel wrapper (see the module note). The unsynchronised loops are kept
    to ~30 ms of device work, so the launch queue never fills.
    ``device_ms_from`` says where ``device_ms`` comes from: ``profiler``,
    or ``queue`` (it is ``queued_ms``) for a call of over 20 ms, whose
    enqueue the device cannot notice, and where the profiler kept losing
    events."""
    ms = cuda_ms(fn, iters)
    calls = max(3, min(300, int(30 / max(ms, 1e-3))))
    host_us, queued_ms = enqueue_times(fn, calls)
    profiled = device_ms(fn, min(calls, 50)) if ms < 20 else None
    dev_ms, parts = profiled or (queued_ms, {})
    return {"ms": ms, "device_ms": dev_ms,
            "device_ms_from": "profiler" if profiled else "queue",
            "host_us": host_us, "queued_ms": queued_ms,
            "device_parts_us": parts}


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
    """Seeded noise with one flat-coloured disc per 4000 px (each drawn in
    its bounding box, so slide-sized images stay cheap)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    for _ in range(hw[0] * hw[1] // 4000):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        r = int(rng.integers(4, 40))
        y0, x0 = max(cy - r, 0), max(cx - r, 0)
        yy, xx = np.mgrid[y0:min(cy + r, hw[0]), x0:min(cx + r, hw[1])]
        img[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]][
            (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 255, 3)
    return img


def phase_kernels(torch, dev):
    """Each kernel vs its plain version on the card, exact."""
    from cerberus_tpu_torch.ops import cc_label as cc_mod
    from cerberus_tpu_torch.ops import device_postproc as D
    from cerberus_tpu_torch.ops.cc_label import (
        REPLACES as CC_REPLACES, SOURCE as CC_SOURCE,
        connected_components, connected_components_plain)
    from cerberus_tpu_torch.ops.hist16384 import (
        REPLACES as H_REPLACES, SOURCE as H_SOURCE, hist16384,
        hist16384_plain)
    from cerberus_tpu_torch.ops.watershed import (
        REPLACES as WS_REPLACES, SOURCE as WS_SOURCE, flood_stats,
        propagate_labels, propagate_labels_plain, watershed, watershed_plain)

    from cerberus_tpu_torch.ops import cuda_build

    like = torch.empty(1, device=dev)
    emit({"phase": "launch_floor",
          **kernel_times(lambda: cc_mod.launch_floor(like), 50)})

    def with_device():
        with torch.cuda.device(dev):
            pass

    # what the host pays for the pieces of a wrapper's call
    emit({"phase": "host_parts_us", **{
        name: enqueue_times(fn, 1000)[0] for name, fn in (
            ("stream_object", lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            ("stream_handle", lambda: cuda_build.stream_handle(like)),
            ("device_context", with_device),
            ("device_guard", lambda: cuda_build.device_guard(like)),
            ("empty_1000x1000_int32", lambda: torch.empty(
                (1000, 1000), dtype=torch.int32, device=dev)),
            ("launch_floor", lambda: cc_mod.launch_floor(like)))}})

    rows, worst = {}, {}

    def check(name, case, got, ref, times, plain_ms, lib_ms, bytes_, ops,
              report, extra=None):
        err = int((got.long() - ref.long()).abs().max()) if got.numel() \
            else 0
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        emit({"phase": "kernel", "name": name, "case": case,
              "shape": list(got.shape), "max_abs_err": err, **times,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, **(extra or {})})
        if err != 0:
            raise AssertionError("%s/%s differs from its plain version"
                                 % (name, case))
        worst[name] = max(worst.get(name, 0), err)
        if report:
            rows[name] = {"ms": times["ms"], "device_ms": times["device_ms"],
                          "device_ms_from": times["device_ms_from"],
                          "host_us": times["host_us"], "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}

    ring_bg = np.pad(blob_prob((1000, 1000), 1600, 2, 3, 12) <= 0.5, 1,
                     constant_values=True)  # as fill_holes pads a plane
    # case, mask, runs of the plain version, in the kernels line
    cc_cases = [
        ("fg600", blob_prob((600, 600), 600, 1, 3, 12) > 0.5, 3, False),
        ("spiral512", spiral(512), 3, False),
        ("fg1002_ring", ring_bg, 3, False),
        ("spiral1000", spiral(1000), 1, False),
        ("fg1000", blob_prob((1000, 1000), 1600, 2, 3, 12) > 0.5, 3, True),
        # a WSI grid tile's nuclei window (2160-px tile padded to 512s)
        ("fg2560", blob_prob((2560, 2560), 10500, 6, 3, 12) > 0.5, 1, False),
    ]
    for case, mask, plain_iters, report in cc_cases:
        mask = torch.from_numpy(mask).to(dev).contiguous()
        n = mask.numel()
        got = connected_components(mask)
        refs = []
        plain_ms = cuda_ms(
            lambda: refs.append(connected_components_plain(mask)),
            plain_iters, warmup=int(plain_iters > 1))
        check("cc_label", case, got, refs[-1],
              kernel_times(lambda: connected_components(mask), 20),
              plain_ms, None, n * 1 + n * 4, n * 4, report)

    prob = blob_prob((1000, 1000), 1600, 3, 3, 12)
    lab = connected_components(torch.from_numpy(prob > 0.5).to(dev))
    ids, n_ids = D.compact_labels(lab)
    ids = ids.contiguous()
    if n_ids >= D.HIST_CAP:
        raise AssertionError("compacted id plane has %d ids" % n_ids)
    ref = hist16384_plain(ids)
    lib = torch.bincount(ids.reshape(-1).clamp(0, D.HIST_CAP - 1).long(),
                         minlength=D.HIST_CAP)
    if not torch.equal(lib.int(), ref):
        raise AssertionError("torch.bincount disagrees with hist16384_plain")
    plain_ms = cuda_ms(lambda: hist16384_plain(ids), 20)
    lib_ms = cuda_ms(lambda: torch.bincount(
        ids.reshape(-1).clamp(0, D.HIST_CAP - 1).long(),
        minlength=D.HIST_CAP), 20)
    # the family's call (remove_small_objects) names its live bins; that
    # case is the kernels line's
    hist_cases = {"ids1000": (), "ids1000_live": (n_ids + 1,)}
    for case, extra_args in hist_cases.items():
        check("hist16384", case, hist16384(ids, *extra_args), ref,
              kernel_times(lambda: hist16384(ids, *extra_args), 50),
              plain_ms, lib_ms, ids.numel() * 4 + D.HIST_CAP * 4,
              ids.numel(), case == "ids1000_live", {"n_ids": n_ids})
    # what the hint is worth beyond the host clock's swing between two
    # measurements: the two cases alternated, the order swapped every round
    pairs = {case: {"ms": [], "host_us": [], "queued_ms": []}
             for case in hist_cases}
    for rnd in range(12):
        for case in sorted(hist_cases, reverse=bool(rnd % 2)):
            extra_args = hist_cases[case]
            ms = cuda_ms(lambda: hist16384(ids, *extra_args), 50)
            host_us, queued_ms = enqueue_times(
                lambda: hist16384(ids, *extra_args), 300)
            for key, value in (("ms", ms), ("host_us", host_us),
                               ("queued_ms", queued_ms)):
                pairs[case][key].append(value)
    emit({"phase": "hist_n_live_pairs", "rounds": 12, "n_ids": n_ids,
          "median": {case: {key: statistics.median(values)
                            for key, values in times.items()}
                     for case, times in pairs.items()},
          "rounds_won_by_n_live": {key: sum(
              live < plain for live, plain in zip(
                  pairs["ids1000_live"][key], pairs["ids1000"][key]))
              for key in ("ms", "host_us", "queued_ms")},
          "all": pairs})

    # what the function needs: a level-bucketed wavefront flood touches each
    # pixel a constant number of times (bucket, then one neighbour minimum)
    inner = blob_prob((1000, 1000), 1600, 4, 3, 9)
    inner2560 = blob_prob((2560, 2560), 10500, 7, 3, 9)
    # 768^2, not 1000^2: the plain floods of a 1000^2 corridor took 94 s of
    # a 191 s run of this script (NVIDIA H100 80GB HBM3, 700 W)
    spiral_mask = spiral(768)
    ys, xs = np.nonzero(spiral_mask)
    spiral_markers = np.zeros(spiral_mask.shape, np.int32)
    spiral_markers[0, 0] = 7  # the corridor's outer end
    ring = np.abs(ys - 384) + np.abs(xs - 384)
    spiral_markers[ys[ring.argmin()], xs[ring.argmin()]] = 3  # near the centre
    # case, image, markers (None: the cores of the probability plane), mask
    # (or that probability plane), runs of the plain version
    flood_cases = [
        ("nuclei1000", -inner, None, inner, 2),
        ("plateau1000", -np.round(inner * 8) / 8, None,
         np.round(inner * 8) / 8, 2),
        ("spiral768", np.zeros(spiral_mask.shape, np.float32),
         spiral_markers, spiral_mask, 1),
        ("nuclei2560", -inner2560, None, inner2560, 1),
    ]
    for case, img_np, mk_np, prob_np, plain_iters in flood_cases:
        image = torch.from_numpy(np.ascontiguousarray(img_np, np.float32)).to(
            dev)
        if mk_np is None:  # nuclei recipe: cores as markers, prob as mask
            markers = connected_components(torch.from_numpy(
                prob_np > 0.6).to(dev))
            wmask = torch.from_numpy(prob_np > 0.1).to(dev)
        else:
            markers = torch.from_numpy(mk_np).to(dev)
            wmask = torch.from_numpy(prob_np).to(dev)
        n = image.numel()
        report = case == "nuclei1000"
        for name, fn, plain, args, bytes_ in (
                ("watershed", watershed, watershed_plain,
                 (image, markers, wmask), n * (4 + 4 + 1) + n * 4),
                ("propagate_labels", propagate_labels,
                 propagate_labels_plain, (markers, wmask),
                 n * (4 + 1) + n * 4)):
            got = fn(*args)
            times = kernel_times(lambda: fn(*args), 5)
            stats = flood_stats(name)
            refs = []  # the spiral's plain version runs once, timed
            plain_ms = cuda_ms(lambda: refs.append(plain(*args)),
                               plain_iters, warmup=int(plain_iters > 1))
            ref = refs[-1]
            check(name, case, got, ref, times, plain_ms, None, bytes_,
                  n * (6 if name == "watershed" else 4), report, stats)
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
    sources = {"cc_label": (CC_SOURCE, CC_REPLACES),
               "hist16384": (H_SOURCE, H_REPLACES),
               "watershed": (WS_SOURCE, WS_REPLACES),
               "propagate_labels": (WS_SOURCE, WS_REPLACES)}
    return rows, sources


def random_model(torch, backbone: str, synthetic_heads: bool):
    """A seeded random full-width NetDesc (the six heads) on the CPU; see
    ``write_model``."""
    from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS, ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

    model_kwargs = {"encoder_backbone_name": backbone,
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
    return model.eval(), model_kwargs


def write_model(torch, path, synthetic_heads: bool):
    """A seeded random full-width ResNet-34 NetDesc written as a model
    directory (``weights.tar`` and a ``settings.yml``, JSON being YAML).
    ``synthetic_heads``: the synthetic-model recipe (INST kernels scaled
    0.003x, biases ``SYNTH_INST_BIAS``) so instances appear; otherwise BN
    statistics are randomised so the forward check exercises them. Returns
    the model kwargs."""
    from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE

    model, model_kwargs = random_model(torch, "resnet34", synthetic_heads)
    os.makedirs(path, exist_ok=True)
    torch.save({"desc": model.state_dict()},
               os.path.join(path, "weights.tar"))
    with open(os.path.join(path, "settings.yml"), "w") as handle:
        json.dump({"dataset_kwargs": {
            "req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": model_kwargs}, handle)
    return model_kwargs


def make_manager(torch, path, synthetic_heads: bool, wsi: bool = False,
                 geometry=(448, 144, 10)):
    """``write_model``'s model loaded through the tile ``InferManager``
    (``geometry``: input, output, batch; 448->144 at batch 10 by default),
    or with ``wsi`` the WSI one (batch 30, the WSI CLI's default). The
    step is bound at the first call, so ``CERBERUS_VALID_REGION`` is read
    then."""
    from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
    from cerberus_tpu_torch.infer import tile, wsi as wsi_mod

    try:
        model_kwargs = write_model(torch, path, synthetic_heads)
        cls = wsi_mod.InferManager if wsi else tile.InferManager
        return cls(
            checkpoint_path=os.path.join(path, "weights.tar"),
            decoder_dict=dict(DEFAULT_TARGET_CODE), model_args=model_kwargs,
            device="cuda", batch_size=30 if wsi else geometry[2],
            patch_input_shape=geometry[0], patch_output_shape=geometry[1])
    finally:
        shutil.rmtree(path, ignore_errors=True)


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@contextlib.contextmanager
def tf32_off(torch):
    """cuDNN's and cuBLAS's TF32 off, both restored as they were."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def forward_check(torch, model, hw: int, out: int, batch: int = 2) -> dict:
    """One f32 batch (TF32 off) through ``model`` on the card, full towers
    and valid-region, and its copy on the CPU (full towers): per head, the
    valid-region heads against the full towers' centre crop on the card
    (``VALID_REL_TOL``) and both against the CPU (``FWD_REL_TOL``)."""
    import copy

    from cerberus_tpu_torch.models.layers import center_crop
    from cerberus_tpu_torch.models.valid_decode import (
        supports_valid_region, valid_head_outputs)

    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (batch, hw, hw, 3)).astype(np.uint8)).permute(
            0, 3, 1, 2).float() / 255.0
    plan = supports_valid_region(model.cfg, hw, out)
    if plan is None:
        raise AssertionError("no valid-region plan for %d->%d" % (hw, out))
    dev = next(model.parameters()).device
    with tf32_off(torch), torch.no_grad():
        full = {k: v.cpu() for k, v in model(x.to(dev)).items()}
        valid = {k: v.cpu() for k, v in valid_head_outputs(
            model, x.to(dev), plan).items()}
        cpu = copy.deepcopy(model).cpu()(x)

    def crop(t, head):
        return t if head == "Patch-Class" else center_crop(t, out, out)

    errs = {"full_vs_cpu": {}, "valid_vs_cpu": {}, "valid_vs_full": {}}
    for head, ref in cpu.items():
        for name, got in (("full", full[head]), ("valid", valid[head])):
            if not torch.isfinite(got).all() or got.shape != (
                    ref.shape if name == "full" else crop(ref, head).shape):
                raise AssertionError("forward head %s (%s) malformed"
                                     % (head, name))
        errs["full_vs_cpu"][head] = rel_err(full[head], ref)
        errs["valid_vs_cpu"][head] = rel_err(valid[head], crop(ref, head))
        errs["valid_vs_full"][head] = rel_err(valid[head],
                                              crop(full[head], head))
    bad = [(kind, head, err) for kind, per in errs.items()
           for head, err in per.items()
           if not err <= (VALID_REL_TOL if kind == "valid_vs_full"
                          else FWD_REL_TOL)]
    emit({"phase": "forward", "backbone": model.cfg.encoder_backbone_name,
          "batch": batch, "hw": hw, "out": out,
          "rel_err": errs["full_vs_cpu"], **errs, "tol": FWD_REL_TOL,
          "valid_tol": VALID_REL_TOL})
    if bad:
        raise AssertionError("forward heads off tolerance: %s" % bad)
    return errs


def valid_vs_full_deterministic(torch, model, hw: int, out: int,
                                batch: int = 2) -> None:
    """Print only: whether the f32 valid-region heads equal the full
    towers' centre crop bit for bit on the card when cuDNN's algorithm
    choice is fixed (``cudnn.deterministic``, ``benchmark`` off, TF32
    off)."""
    from cerberus_tpu_torch.models.layers import center_crop
    from cerberus_tpu_torch.models.valid_decode import (
        supports_valid_region, valid_head_outputs)

    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (batch, hw, hw, 3)).astype(np.uint8)).permute(
            0, 3, 1, 2).float() / 255.0
    dev = next(model.parameters()).device
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            full = model(x.to(dev))
            valid = valid_head_outputs(model, x.to(dev),
                                       supports_valid_region(model.cfg, hw,
                                                             out))
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    diff = {}
    for head, ref in full.items():
        if head != "Patch-Class":
            ref = center_crop(ref, out, out)
        diff[head] = float((valid[head] - ref).abs().max())
    emit({"phase": "valid_vs_full_f32_deterministic",
          "backbone": model.cfg.encoder_backbone_name, "batch": batch,
          "hw": hw, "out": out, "cudnn_deterministic": True,
          "cudnn_benchmark": False, "tf32": False,
          "bit_equal": {h: d == 0.0 for h, d in diff.items()},
          "max_abs_diff": diff, "all_bit_equal": all(
              d == 0.0 for d in diff.values())})


def batch_position_invariance(torch, manager) -> None:
    """Print only: the bf16 step (448->144, the manager's batch) on the same
    windows twice, on a batch whose tail rows are zeros, and on windows
    moved to other places among other windows: which of these give the
    same bits per window."""
    n = int(manager.batch_size)
    half = n // 2
    wins = torch.from_numpy(np.stack([
        synthetic_image((448, 448), 100 + i) for i in range(n + half)])).to(
            manager.device)

    def step(batch):
        if len(batch) < n:
            batch = torch.cat([batch, batch.new_zeros((n - len(batch),
                                                       *batch.shape[1:]))])
        return manager.run_step(batch, 144).float()

    first = step(wins[:n])
    again = step(wins[:n])
    padded = step(wins[:half])
    moved = step(wins[half:n + half])
    diff = (first[half:] - moved[:n - half]).abs()
    emit({"phase": "batch_position_invariance", "batch": n, "hw": 448,
          "out": 144, "same_batch_equal": bool(torch.equal(first, again)),
          "zero_padded_tail_equal": bool(torch.equal(first[:half],
                                                     padded[:half])),
          "moved_equal": bool(diff.max() == 0),
          "moved_values_differing": float((diff > 0).float().mean()),
          "moved_max_abs": float(diff.max()),
          "moved_max_abs_per_channel": diff.amax(dim=(0, 1, 2)).tolist()})


def phase_forward(torch, manager):
    """The card's f32 forward against the port's CPU forward and the
    valid-region heads against the full towers: the ResNet-34 model at
    448->144, then each other encoder at 224->72. The
    ``valid_vs_full_f32_deterministic`` line (print only) repeats the
    ResNet-34 comparison with cuDNN's algorithm choice fixed."""
    forward_check(torch, manager.model, 448, 144)
    valid_vs_full_deterministic(torch, manager.model, 448, 144)
    for backbone in NEW_ENCODERS:
        model, _ = random_model(torch, backbone, False)
        forward_check(torch, model.to(manager.device), 224, 72)
        del model
        torch.cuda.empty_cache()


def drive_images(torch, manager, images):
    """``process_image`` on each image (after a warm-up image), launch
    counts reset just before and read just after. Returns (results,
    seconds, ms per image, launches, instances per task)."""
    from cerberus_tpu_torch.ops import cuda_build

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
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("kernel %s was not launched on the main path"
                                 % name)
    for task in ("Gland", "Nuclei"):
        if sum(instances.get(task, [])) <= 0:
            raise AssertionError("no %s instances on the main path" % task)
    return results, seconds, per_image_ms, launches, instances


def path_numbers(manager, images, seconds, per_image_ms, instances,
                 launches) -> dict:
    """The main path's line: windows and output megapixels per second (the
    images' own pixels, so windowed and dense compare on one unit)."""
    from cerberus_tpu_torch.data.patching import prepare_patching

    in_sz, out_sz = int(manager.patch_input_shape), int(
        manager.patch_output_shape)
    n_win = sum(len(prepare_patching(img, in_sz, out_sz)[1])
                for img in images)
    px = sum(img.shape[0] * img.shape[1] for img in images)
    return {"images": [list(i.shape[:2]) for i in images],
            "patch": [in_sz, out_sz], "batch": int(manager.batch_size),
            "compute": "bf16", "instances": instances,
            "ms_per_image": per_image_ms, "windows": n_win,
            "windows_per_s": n_win / seconds,
            "output_mpx_per_s": px / seconds / 1e6, "seconds": seconds,
            "launches": launches}


def split_times(torch, manager, images, plain: bool):
    """Host-clock split of each image's time, synchronised at each seam:
    ``canvas_ms`` (gather, forward, stitch) and ``postproc_ms`` (kernel
    families); with ``plain``, the plain-version families on the same
    canvas too, which must equal the kernel families byte for byte.
    Returns the split and each image's (canvas, label maps)."""
    from cerberus_tpu_torch.infer.tile import post_process_canvas
    from cerberus_tpu_torch.ops.device_postproc import KERNELS, PLAIN

    split = {"canvas_ms": [], "postproc_ms": []}
    if plain:
        split["plain_postproc_ms"] = []
    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)
    outs = []
    for i, img in enumerate(images):
        t0 = time.perf_counter()
        canvas = manager.infer_canvas(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, _, _ = post_process_canvas(canvas, *args, impl=KERNELS)
        t2 = time.perf_counter()
        split["canvas_ms"].append((t1 - t0) * 1e3)
        split["postproc_ms"].append((t2 - t1) * 1e3)
        if plain:
            ref, _, _ = post_process_canvas(canvas, *args, impl=PLAIN)
            split["plain_postproc_ms"].append((time.perf_counter() - t2)
                                              * 1e3)
            for task in ref:
                if not np.array_equal(got[task], ref[task]):
                    raise AssertionError(
                        "image %d %s: kernel families differ from plain "
                        "families" % (i, task))
        outs.append((canvas, got))
    return split, outs


def main_path_images():
    return [synthetic_image(hw, seed) for hw, seed in
            (((600, 600), 11), ((1000, 1000), 12), ((1000, 1000), 13))]


def phase_main_path(torch, manager, full_manager):
    """The tile main path (valid-region, the default) through
    ``process_image``, then the same images through ``full_manager``, whose
    step was bound under ``CERBERUS_VALID_REGION=0`` (full towers); the
    kernel families against the plain families on the valid-region
    canvases; the bf16 canvases and label maps of the two forwards side by
    side (printed, not asserted: cuDNN picks other algorithms for the two
    shapes)."""
    images = main_path_images()
    _, seconds, per_image_ms, launches, instances = drive_images(
        torch, manager, images)
    line = path_numbers(manager, images, seconds, per_image_ms, instances,
                        launches)
    emit({"phase": "main_path", "valid_region": True, **line,
          "tiles_448": line["windows"], "tiles_per_s": line["windows_per_s"]})
    split, valid_outs = split_times(torch, manager, images, plain=True)
    emit({"phase": "families_vs_plain", "images": len(images),
          "byte_equal": True, **split})

    old = os.environ.get("CERBERUS_VALID_REGION")
    os.environ["CERBERUS_VALID_REGION"] = "0"
    try:
        _, f_seconds, f_ms, f_launches, f_instances = drive_images(
            torch, full_manager, images)
        f_split, full_outs = split_times(torch, full_manager, images,
                                         plain=False)
    finally:
        if old is None:
            os.environ.pop("CERBERUS_VALID_REGION")
        else:
            os.environ["CERBERUS_VALID_REGION"] = old
    f_line = path_numbers(full_manager, images, f_seconds, f_ms,
                          f_instances, f_launches)
    emit({"phase": "main_path_full_towers", "valid_region": False, **f_line,
          "tiles_per_s": f_line["windows_per_s"], **f_split})

    from cerberus_tpu_torch.data.patching import make_channel_index_map

    idx_dict, _ = make_channel_index_map(manager.cfg.active_decoder_kwargs)
    diff = {"canvas_max_abs": [], "inst_max_abs": [],
            "argmax_differ_share": {}, "fg_iou": {}}
    for (canvas_v, lab_v), (canvas_f, lab_f) in zip(valid_outs, full_outs):
        delta = (canvas_v.float() - canvas_f.float()).abs()
        diff["canvas_max_abs"].append(float(delta.max()))
        diff["inst_max_abs"].append(max(
            float(delta[..., s:e].max()) for code, (s, e) in idx_dict.items()
            if code.endswith("-INST")))
        for code, (s, _) in idx_dict.items():
            if not code.endswith("-INST"):  # TYPE and Patch-Class ids
                diff["argmax_differ_share"].setdefault(code, []).append(
                    float((delta[..., s] > 0).float().mean()))
        for task in lab_v:
            a, b = lab_v[task] > 0, lab_f[task] > 0
            union = int((a | b).sum())
            diff["fg_iou"].setdefault(task, []).append(
                int((a & b).sum()) / union if union else 1.0)
    emit({"phase": "valid_vs_full_bf16", **diff})
    return launches


def phase_main_path_dense(torch, manager):
    """The same images through the tile main path at 1168->864 (the CLIs'
    ``--dense``), batch 16: launches, instances, output megapixels per
    second, the kernel families against the plain families, and the
    Patch-Class grid (a (N, 9, 6, 6) head output, classes in [0, 9),
    constant on each 144^2 cell of the canvas)."""
    from cerberus_tpu_torch.data.patching import make_channel_index_map
    from cerberus_tpu_torch.infer.steps import head_outputs

    images = main_path_images()
    _, seconds, per_image_ms, launches, instances = drive_images(
        torch, manager, images)
    line = path_numbers(manager, images, seconds, per_image_ms, instances,
                        launches)
    split, outs = split_times(torch, manager, images, plain=True)

    in_sz, out_sz, batch = DENSE
    imgs = torch.from_numpy(np.stack([synthetic_image((in_sz, in_sz), 30 + i)
                                      for i in range(batch)])).to(
                                          manager.device)
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        grid = head_outputs(manager.model, x, out_sz)["Patch-Class"]
    canvas = manager.run_step(imgs, out_sz)
    idx_dict, _ = make_channel_index_map(manager.cfg.active_decoder_kwargs)
    pc = canvas[..., idx_dict["Patch-Class"][0]].float()
    n = out_sz // 144
    cells = pc.reshape(batch, n, 144, n, 144)
    grid_ok = (tuple(grid.shape) == (batch, 9, n, n)
               and torch.equal(cells.amax(dim=(2, 4)), cells.amin(dim=(2, 4)))
               and 0 <= float(pc.min()) and float(pc.max()) < 9
               and torch.equal(pc, pc.round()))
    classes = sorted(int(v) for v in torch.unique(pc))
    pclass_maps_ok = all(
        0 <= float(c[..., idx_dict["Patch-Class"][0]].min())
        and float(c[..., idx_dict["Patch-Class"][0]].max()) < 9
        for c, _ in outs)
    emit({"phase": "main_path_dense", "valid_region": True, **line,
          "families_vs_plain": "byte_equal", **split,
          "grid_shape": list(grid.shape), "grid_classes": classes,
          "grid_ok": bool(grid_ok and pclass_maps_ok)})
    if not (grid_ok and pclass_maps_ok):
        raise AssertionError("dense Patch-Class grid malformed")
    return launches


def phase_forward_profile(torch, managers):
    """``torch.profiler`` over one batch of the step on each forward path
    (windowed full towers, windowed valid-region, dense valid-region):
    device time, the top device operations by share, and the achieved
    TFLOP/s against the convolutions' FLOP count (``utils/flops.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cerberus_tpu_torch.utils.flops import forward_flops

    paths = {}
    for name, manager, valid in managers:
        in_sz, out_sz = int(manager.patch_input_shape), int(
            manager.patch_output_shape)
        batch = int(manager.batch_size)
        imgs = torch.from_numpy(np.stack([
            synthetic_image((in_sz, in_sz), 40 + i) for i in range(batch)
        ])).to(manager.device)
        # each manager's step was bound on its main path, full towers or
        # valid-region as ``valid`` says
        wall_ms = cuda_ms(lambda: manager.run_step(imgs, out_sz), 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            manager.run_step(imgs, out_sz)
            torch.cuda.synchronize()
        ops = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            ops[evt.key[:90]] = ops.get(evt.key[:90], 0.0) + us
        device_ms = sum(ops.values()) / 1e3
        flops = forward_flops(in_sz, out_sz, valid, manager.cfg,
                              batch)["flops"]
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        paths[name] = {
            "patch": [in_sz, out_sz], "batch": batch, "valid_region": valid,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "gflop": flops / 1e9,
            "tflop_per_s_device": flops / (device_ms * 1e-3) / 1e12
            if device_ms else None,
            "tflop_per_s_wall": flops / (wall_ms * 1e-3) / 1e12,
            "mflop_per_output_px": flops / batch / out_sz ** 2 / 1e6,
            "top_ops": [{"name": k, "ms": v / 1e3,
                         "share": v / 1e3 / device_ms} for k, v in top]}
    emit({"phase": "forward_profile", "paths": paths,
          "peak_bf16_tflop_per_s": 989})
    for name, row in paths.items():
        if not row["device_ms"]:
            raise AssertionError("profiler saw no device time for %s" % name)


def write_slide(slide_dir):
    """The seeded synthetic slide: a ``.npy`` pyramid directory of
    ``WSI_HW`` at 0.5 mpp (``level_0``, ``level_1``). It has no
    ``meta.yml``: the reader's default is 0.5 mpp."""
    os.makedirs(slide_dir)
    img = synthetic_image(WSI_HW, 21)
    np.save(os.path.join(slide_dir, "level_0.npy"), img)
    np.save(os.path.join(slide_dir, "level_1.npy"),
            np.ascontiguousarray(img[::2, ::2]))


def phase_wsi(torch, manager):
    """The WSI engine's device path on a synthetic slide: placement, the
    resident loop (inference into the row canvas, nuclei per grid tile,
    the disk canvas landed), the boundary-repair sets 1-3 and the
    gland/lumen region program, launch counts reset just before and read
    just after. Then every grid tile's, boundary tile's and region's label
    maps against the plain families on the same inputs, byte for byte."""
    import torch.nn.functional as F

    from cerberus_tpu_torch.data.patching import make_channel_index_map
    from cerberus_tpu_torch.infer.resident_wsi import (
        ResidentWSIProcessor, nuclei_tile_labels, region_labels)
    from cerberus_tpu_torch.infer.wsi import boundary_tile_labels
    from cerberus_tpu_torch.ops import cuda_build
    from cerberus_tpu_torch.ops.device_postproc import KERNELS, PLAIN, Impl
    from cerberus_tpu_torch.wsi.coords import (filter_coordinates,
                                               get_coordinates, get_tile_info)
    from cerberus_tpu_torch.wsi.ioconfig import (make_inference_ioconfig,
                                                 make_postproc_ioconfig)
    from cerberus_tpu_torch.wsi.merge import CanvasSet
    from cerberus_tpu_torch.wsi.reader import open_wsi

    dev = manager.device
    work = os.path.join(cuda_build.BUILD_DIR, "smoke_wsi")
    shutil.rmtree(work, ignore_errors=True)
    slide_dir = os.path.join(work, "slide")
    try:
        write_slide(slide_dir)

        # the kernels as the families call them, each noting the largest
        # plane it was given
        largest = {}

        def noting(name, fn):
            def call(plane, *args):
                if plane.numel() > np.prod(largest.get(name, [0])):
                    largest[name] = list(plane.shape)
                return fn(plane, *args)
            return call

        impl = Impl(*(noting(name, fn) for name, fn in
                      zip(cuda_build.LAUNCH_COUNTERS, KERNELS)))
        nuclei_code = manager.decoder_dict["Nuclei-INST"]
        seconds = {}

        t0 = time.perf_counter()
        n_heads = len(manager.cfg.active_decoder_kwargs)
        ioconfig = make_inference_ioconfig(0.5, n_heads, 15000, 64, 448, 144)
        ioconfig_pp = make_postproc_ioconfig(0.5, WSI_TILE, 64)
        reader = open_wsi(slide_dir)
        resolution = ioconfig.highest_input_resolution
        shape_xy = reader.slide_dimensions(**resolution)
        shape = tuple(int(v) for v in shape_xy[::-1])
        wsi_mask = np.ones(shape, np.uint8)
        patch_inputs, patch_outputs = get_coordinates(shape_xy, ioconfig)
        sel = filter_coordinates(wsi_mask, patch_outputs, shape_xy)
        patch_inputs, patch_outputs = patch_inputs[sel], patch_outputs[sel]
        pp_sets = get_tile_info(shape_xy, ioconfig_pp)
        idx_dict, n_ch = make_channel_index_map(
            manager.cfg.active_decoder_kwargs)
        canvas = CanvasSet(os.path.join(work, "cache"), shape, n_ch)
        seconds["placement"] = time.perf_counter() - t0

        # cuDNN plans for the batch-30 forward, outside the timed run
        manager.run_step(torch.zeros((manager.batch_size, 448, 448, 3),
                                     dtype=torch.uint8, device=dev), 144)
        torch.cuda.synchronize()

        grid = {}

        def on_tile(inst, type_map, bounds, flags, tile_idx):
            grid[tile_idx] = (inst, type_map)

        proc = ResidentWSIProcessor(manager, idx_dict, n_ch, nuclei_code,
                                    output_shape=144, impl=impl)
        cuda_build.reset_launch_counts()
        t_slide = time.perf_counter()
        deferred = proc.run(reader, resolution, patch_inputs, patch_outputs,
                            pp_sets[0], wsi_mask, shape_xy, set(),
                            lambda: None, canvas, on_tile)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seconds["inference_and_grid_tiles"] = t1 - t_slide

        boundary = []
        for set_idx in (1, 2, 3):
            for bounds in pp_sets[set_idx][0]:
                boundary.append((bounds, *boundary_tile_labels(
                    canvas.raw, bounds, idx_dict["Nuclei-INST"],
                    idx_dict.get("Nuclei-TYPE"), nuclei_code, dev, impl)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        seconds["boundary_sets"] = t2 - t1

        # the region program's input: the landed canvas at 0.5x as a 2x2
        # mean on the card (cv2's INTER_LINEAR halving, without cv2), one
        # region (the mask is all tissue), 512-padded
        regions = {}
        for task in ("Gland", "Lumen"):
            s, e = idx_dict[f"{task}-INST"]
            plane = torch.from_numpy(np.ascontiguousarray(
                canvas.raw[..., s:e])).to(dev).float().permute(2, 0, 1)
            half = F.avg_pool2d(plane[None], 2)[0]
            h, w = half.shape[1:]
            padded = F.pad(half, (0, -(-w // 512) * 512 - w,
                                  0, -(-h // 512) * 512 - h))
            padded = padded.permute(1, 2, 0).contiguous()
            inst16, count = region_labels(
                padded, task, manager.decoder_dict[f"{task}-INST"], 0.5,
                impl)
            regions[task] = (padded, inst16[:h, :w].cpu().numpy(),
                             int(count))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        seconds["gland_lumen_regions"] = t3 - t2
        launches = dict(cuda_build.launch_counts)
        slide_s = t3 - t_slide + seconds["placement"]

        # the same inputs through the plain families
        windows = []
        for tile_idx, (inst, types) in sorted(grid.items()):
            x0, y0, x1, y1 = [int(v) for v in pp_sets[0][0][tile_idx]]
            h, w = y1 - y0, x1 - x0
            hp, wp = proc.padded_shape(h, w)
            windows.append([hp, wp])
            window = torch.zeros((hp, wp, n_ch), dtype=torch.float16,
                                 device=dev)
            window[:h, :w] = torch.from_numpy(np.ascontiguousarray(
                canvas.raw[y0:y1, x0:x1])).to(dev)
            ref, ref_types, _ = nuclei_tile_labels(window, h, w, idx_dict,
                                                   nuclei_code, PLAIN)
            if not (np.array_equal(inst, ref.cpu().numpy()) and
                    np.array_equal(types, ref_types.cpu().numpy()
                                   .astype(np.float32))):
                raise AssertionError("WSI grid tile %d: kernel families "
                                     "differ from plain families" % tile_idx)
        for bounds, inst, types in boundary:
            ref, ref_types = boundary_tile_labels(
                canvas.raw, bounds, idx_dict["Nuclei-INST"],
                idx_dict.get("Nuclei-TYPE"), nuclei_code, dev, PLAIN)
            if not (np.array_equal(inst, ref)
                    and np.array_equal(types, ref_types)):
                raise AssertionError("WSI boundary tile %s: kernel families "
                                     "differ from plain families"
                                     % list(bounds))
        for task, (padded, inst, count) in regions.items():
            ref, ref_count = region_labels(
                padded, task, manager.decoder_dict[f"{task}-INST"], 0.5,
                PLAIN)
            if not (int(ref_count) == count and np.array_equal(
                    inst, ref[:inst.shape[0], :inst.shape[1]].cpu().numpy())):
                raise AssertionError("WSI %s region: kernel family differs "
                                     "from the plain family" % task)
        plain_s = time.perf_counter() - t3
        canvas.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    instances = {
        "Nuclei_grid": [int(len(np.unique(i[i > 0])))
                        for i, _ in grid.values()],
        "Nuclei_boundary": int(sum(len(np.unique(i[i > 0]))
                                   for _, i, _ in boundary)),
        **{task: count for task, (_, _, count) in regions.items()}}
    emit({"phase": "wsi", "slide_hw": list(WSI_HW), "mpp": 0.5, "levels": 2,
          "patch": [448, 144], "batch": int(manager.batch_size),
          "tile_shape": WSI_TILE, "ambiguous_size": 64, "chunk_shape": 15000,
          "patches": int(len(patch_inputs)), "grid_tiles": len(grid),
          "grid_windows": windows, "deferred": deferred,
          "boundary_tiles": len(boundary),
          "region_planes": {t: list(r[0].shape[:2])
                            for t, r in regions.items()},
          "region_input": "2x2 mean of the landed canvas on the card",
          "instances": instances, "slide_seconds": slide_s,
          "seconds": seconds,
          "patches_per_s": len(patch_inputs)
          / seconds["inference_and_grid_tiles"],
          "launches": launches, "largest_plane": largest,
          "families_vs_plain": "byte_equal", "plain_seconds": plain_s})
    if deferred:
        raise AssertionError("grid tiles deferred: %s" % deferred)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("kernel %s was not launched on the WSI "
                                 "path" % name)
    if sum(instances["Nuclei_grid"]) <= 0 or instances["Gland"] <= 0:
        raise AssertionError("no nuclei or gland instances on the WSI path")
    return launches


def run_wsi_cli(torch, work, input_dir, extra_argv=(), env=None):
    """``python -m cerberus_tpu_torch.run_infer_wsi`` as a user runs it (its
    ``main``, in this process) with ``--gpu=0`` on the slides in
    ``input_dir`` and the synthetic model, host side included (cv2
    contours and resizes, the ``.dat`` pickle, the tissue map), with
    ``extra_argv`` added and ``env`` set for the run. Launch counts are
    reset just before and read just after; the per-phase spans come from
    the per-slide log. Returns a dict: ``dat`` (the one slide's payload),
    ``seconds``, ``spans``, ``launches``, ``argv``, ``pclass_classes``."""
    import glob
    import pickle
    import re

    from cerberus_tpu_torch import run_infer_wsi
    from cerberus_tpu_torch.ops import cuda_build

    write_model(torch, os.path.join(work, "model"), True)
    argv = ["--gpu=0", "--model=%s/model" % work,
            "--input_dir=%s" % input_dir, "--output_dir=%s/out" % work,
            "--cache_path=%s/cache/" % work, "--logging_dir=%s/log" % work,
            "--tile_shape=%d" % WSI_TILE, *extra_argv]
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        run_infer_wsi.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(cuda_build.launch_counts)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dats = glob.glob(os.path.join(work, "out", "dat", "*.dat"))
    if len(dats) != 1:
        raise AssertionError("WSI CLI wrote %d .dat files, expected 1"
                             % len(dats))
    name = os.path.splitext(os.path.basename(dats[0]))[0]
    with open(dats[0], "rb") as f:
        dat = pickle.load(f)
    with open(glob.glob(os.path.join(work, "log", name + "_*.log"))[0]) as f:
        spans = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"INFO - ([^:]+): ([0-9.]+)$", f.read(), re.M)}
    tissue_path = os.path.join(work, "out", "tissue", name + ".mat")
    pclass_classes = None
    if os.path.exists(tissue_path):
        import scipy.io as sio

        pclass = sio.loadmat(tissue_path)["pclass"]
        pclass_classes = sorted(int(v) for v in np.unique(pclass))
    return {"dat": dat, "seconds": seconds, "spans": spans,
            "launches": launches, "argv": argv[:1] + argv[6:],
            "pclass_classes": pclass_classes}


def check_cli_outputs(run, phase, hw=WSI_HW, kernels=True) -> None:
    """The checks every WSI CLI phase makes: the slide's dimensions, a
    tissue map of classes in [0, 9), nuclei and gland instances, and (for
    the card's families) every kernel launched."""
    dat, classes = run["dat"], run["pclass_classes"]
    if [int(v) for v in dat["proc_dimensions"]] != list(hw) or not (
            classes and 0 <= min(classes) and max(classes) <= 8):
        raise AssertionError("%s: WSI CLI outputs malformed" % phase)
    if len(dat.get("Nuclei", {})) <= 0 or len(dat.get("Gland", {})) <= 0:
        raise AssertionError("%s: no nuclei or gland instances" % phase)
    for name, count in run["launches"].items():
        if kernels and count <= 0:
            raise AssertionError("%s: kernel %s was not launched"
                                 % (phase, name))


def emit_cli(phase, run, **extra) -> None:
    dat = run["dat"]
    emit({"phase": phase, "argv": run["argv"], "seconds": run["seconds"],
          "log_spans_s": run["spans"],
          "instances": {t: len(dat.get(t, {}))
                        for t in ("Nuclei", "Gland", "Lumen")},
          "proc_dimensions": [int(v) for v in dat["proc_dimensions"]],
          "tissue_map": run["pclass_classes"] is not None,
          "pclass_classes": run["pclass_classes"],
          "launches": run["launches"], **extra})


def phase_wsi_cli(torch, extra_argv=(), phase="wsi_cli"):
    """The WSI CLI on the wsi phase's ``.npy`` slide and model, with
    ``extra_argv`` added (``--dense --batch_size=16`` for
    ``wsi_cli_dense``). Returns the run (``run_wsi_cli``)."""
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_wsi_cli")
    shutil.rmtree(work, ignore_errors=True)
    try:
        write_slide(os.path.join(work, "input", "slide"))
        run = run_wsi_cli(torch, work, os.path.join(work, "input"),
                          ("--wsi_file_ext=.npy", *extra_argv))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit_cli(phase, run)
    check_cli_outputs(run, phase)
    return run


TASKS = ("Nuclei", "Gland", "Lumen")


def _sig(x):
    if isinstance(x, dict):
        return tuple(sorted((repr(k), _sig(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return repr(x)


def payload(dat):
    """A ``.dat`` payload by content: instance keys are uuid4 per run, so
    each task is the sorted multiset of its instances' signatures; the rest
    compares exactly (as ``tools/verify_postproc_ab.py`` compares)."""
    return {k: (tuple(sorted(_sig(iv) for iv in v.values())) if k in TASKS
                else _sig(v)) for k, v in dat.items()}


def write_tiff(path, levels, compression, tile=256,
               description="Aperio |MPP = 0.5|"):
    """A minimal tiled, little-endian classic TIFF as Aperio writes an
    ``.svs``: one IFD per level (full resolution first), ``tile``-square
    tiles, RGB, ``ImageDescription`` on the first IFD. ``compression`` 8
    codes the tiles with zlib (deflate), 7 with cv2's JPEG (quality 90)."""
    import struct
    import zlib

    out = bytearray(b"II" + struct.pack("<HI", 42, 0))

    def align():
        if len(out) % 2:
            out.extend(b"\0")

    ifds = []
    for lvl, img in enumerate(levels):
        h, w = img.shape[:2]
        offsets, counts = [], []
        for ty in range(-(-h // tile)):
            for tx in range(-(-w // tile)):
                t = np.zeros((tile, tile, 3), np.uint8)
                sub = img[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
                t[:sub.shape[0], :sub.shape[1]] = sub
                if compression == 8:
                    data = zlib.compress(t.tobytes(), 6)
                else:
                    import cv2

                    ok, enc = cv2.imencode(
                        ".jpg", np.ascontiguousarray(t[..., ::-1]),
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
                    if not ok:
                        raise AssertionError("cv2 could not encode a JPEG")
                    data = enc.tobytes()
                align()
                offsets.append(len(out))
                counts.append(len(data))
                out.extend(data)
        entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
                   (259, 3, [compression]),
                   (262, 3, [6 if compression == 7 else 2]),
                   (277, 3, [3]), (322, 4, [tile]), (323, 4, [tile]),
                   (324, 4, offsets), (325, 4, counts)]
        if lvl == 0:
            entries.append((270, 2, list(description.encode() + b"\0")))
        entries.sort()
        packed = []
        for tag, vtype, vals in entries:
            data = (bytes(vals) if vtype == 2 else struct.pack(
                "<" + {3: "H", 4: "I"}[vtype] * len(vals), *vals))
            if len(data) > 4:
                align()
                field = struct.pack("<I", len(out))
                out.extend(data)
            else:
                field = data + b"\0" * (4 - len(data))
            packed.append(struct.pack("<HHI", tag, vtype, len(vals)) + field)
        align()
        ifds.append((len(out), len(packed)))
        out.extend(struct.pack("<H", len(packed)) + b"".join(packed)
                   + b"\0\0\0\0")
    struct.pack_into("<I", out, 4, ifds[0][0])
    for (off, n), (nxt, _) in zip(ifds, ifds[1:]):
        struct.pack_into("<I", out, off + 2 + 12 * n, nxt)
    with open(path, "wb") as f:
        f.write(out)


def phase_readers(torch, work):
    """The wsi phase's slide written as an Aperio ``.svs`` (256^2 tiles, two
    levels, ``MPP = 0.5``), once deflate-coded and once JPEG-coded; each
    opened through ``open_wsi`` and read in full-width 1024-row stripes at
    0.5 and 1.0 mpp (a new reader each time, so every tile is decoded). The
    deflate slide's pixels must equal the ``.npy`` pyramid's at both
    resolutions. Then ``read_batch`` on ``convert_slide``'s pyramid of the
    JPEG slide: the native gather against its numpy plain version on the
    wsi phase's 448^2 windows, batch 30, equal outputs. Last, whether cv2
    decodes a JPEG 2000 stream it encoded (printed, with what it gave).
    Returns the JPEG ``.svs`` path and the pyramid directory."""
    from cerberus_tpu_torch import convert_slide
    from cerberus_tpu_torch.native import patch_gather
    from cerberus_tpu_torch.wsi.coords import get_coordinates
    from cerberus_tpu_torch.wsi.ioconfig import make_inference_ioconfig
    from cerberus_tpu_torch.wsi.reader import open_wsi

    img = synthetic_image(WSI_HW, 21)
    levels = [img, np.ascontiguousarray(img[::2, ::2])]
    npy_dir = os.path.join(work, "npy_slide")
    write_slide(npy_dir)
    ref = open_wsi(npy_dir)
    line = {"phase": "readers", "slide_hw": list(WSI_HW), "tile": 256,
            "levels": 2, "codecs": {}}
    paths = {}
    for codec, comp in (("deflate", 8), ("jpeg", 7)):
        path = os.path.join(work, "svs_" + codec, "slide.svs")
        os.makedirs(os.path.dirname(path))
        t0 = time.perf_counter()
        write_tiff(path, levels, comp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader = open_wsi(path)
        open_ms = (time.perf_counter() - t0) * 1e3
        row = {"reader": type(reader).__name__, "bytes": os.path.getsize(path),
               "write_s": write_s, "open_ms": open_ms,
               "mpp": reader.info.mpp,
               "level_downsamples": reader._level_downsamples}
        for mpp in (0.5, 1.0):
            reader = open_wsi(path)
            w, h = (int(v) for v in reader.slide_dimensions(mpp))
            t0 = time.perf_counter()
            plane = np.concatenate([
                reader.read_bounds([0, y, w, min(y + 1024, h)], mpp)
                for y in range(0, h, 1024)])
            sec = time.perf_counter() - t0
            row["read_mpx_per_s_%s" % mpp] = w * h / sec / 1e6
            want = ref.read_bounds([0, 0, w, h], mpp)
            err = np.abs(plane.astype(np.int16) - want).astype(np.float64)
            row["vs_npy_%s" % mpp] = {"max_abs": float(err.max()),
                                      "mean_abs": float(err.mean())}
            if codec == "deflate" and err.max() != 0:
                raise AssertionError("deflate .svs pixels differ from the "
                                     ".npy pyramid at %s mpp" % mpp)
        line["codecs"][codec] = row
        paths[codec] = path

    conv_dir = os.path.join(work, "converted", "slide")
    t0 = time.perf_counter()
    if convert_slide.main([paths["jpeg"], conv_dir]) != 0:
        raise AssertionError("convert_slide failed")
    line["convert_s"] = time.perf_counter() - t0
    conv = open_wsi(conv_dir)
    patch_inputs, _ = get_coordinates(
        conv.slide_dimensions(0.5), make_inference_ioconfig(0.5, 6, 15000,
                                                            64, 448, 144))
    batches = [patch_inputs[i:i + 30] for i in range(0, len(patch_inputs), 30)]
    level = conv._levels[0]

    def native():
        return [conv.read_batch(b, 0.5) for b in batches]

    def plain():
        return [patch_gather.gather_patches_plain(level, b[:, [1, 0]], 448,
                                                  448) for b in batches]

    native()  # the page cache warm for both, the gather built
    rates = {"native": [], "plain": []}
    for name in ("native", "plain", "plain", "native"):
        t0 = time.perf_counter()
        got = native() if name == "native" else plain()
        rates[name].append(len(patch_inputs) / (time.perf_counter() - t0))
        if name == "native":
            ref_batches = got
        elif not all(np.array_equal(a, b) for a, b in zip(ref_batches, got)):
            raise AssertionError("read_batch (native gather) differs from "
                                 "the numpy gather")
    line["read_batch"] = {"patches": int(len(patch_inputs)), "batch": 30,
                          "order": "native, plain, plain, native (warm)",
                          "native_patches_per_s": rates["native"],
                          "plain_patches_per_s": rates["plain"],
                          "equal": True}

    import cv2

    small = img[:256, :320]
    try:
        ok, enc = cv2.imencode(".jp2", np.ascontiguousarray(small[..., ::-1]),
                               [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                1000])
        dec = cv2.imdecode(enc, cv2.IMREAD_COLOR) if ok else None
        line["jpeg2000"] = {
            "cv2": cv2.__version__, "encoded": bool(ok),
            "decoded": dec is not None,
            "lossless_equal": bool(dec is not None and np.array_equal(
                dec[..., ::-1], small))}
    except cv2.error as exc:
        line["jpeg2000"] = {"cv2": cv2.__version__, "error": str(exc)[:200]}
    emit(line)
    return paths["jpeg"]


def phase_wsi_cli_svs(torch, svs_path):
    """The WSI CLI with its default ``--wsi_file_ext`` (``.svs``) on a folder
    holding the JPEG-coded ``.svs``, ``--postproc_backend=gpu``, resident
    loop; then on ``convert_slide``'s ``.npy`` pyramid of the same file. The
    two payloads must be equal by content."""
    from cerberus_tpu_torch import convert_slide
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_wsi_cli_svs")
    shutil.rmtree(work, ignore_errors=True)
    try:  # the .svs is the only file in its directory
        svs = run_wsi_cli(torch, os.path.join(work, "a"),
                          os.path.dirname(svs_path),
                          ("--postproc_backend=gpu",))
        if convert_slide.main([svs_path,
                               os.path.join(work, "npy", "slide")]) != 0:
            raise AssertionError("convert_slide failed")
        npy = run_wsi_cli(torch, os.path.join(work, "b"),
                          os.path.join(work, "npy"),
                          ("--postproc_backend=gpu", "--wsi_file_ext=.npy"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    equal = payload(svs["dat"]) == payload(npy["dat"])
    emit_cli("wsi_cli_svs", svs, npy_seconds=npy["seconds"],
             npy_log_spans_s=npy["spans"], npy_launches=npy["launches"],
             dat_equal_to_npy=equal)
    check_cli_outputs(svs, "wsi_cli_svs")
    if not equal:
        raise AssertionError("wsi_cli_svs: the .svs and its .npy pyramid "
                             "give different .dat payloads")
    return svs["launches"]


def phase_wsi_cli_legacy(torch, resident_run):
    """``CERBERUS_RESIDENT=0 --postproc_backend=gpu`` on the wsi phase's
    ``.npy`` slide: the legacy host-canvas loop with the CUDA families, at
    the CLI's batch of 30 (timed; ``wsi_cli_cpu``'s partner). The card's
    bf16 forward is deterministic for a given batch but not invariant to a
    window's place in its batch (the deep encoder levels differ), and the
    two loops batch the slide's windows differently (per tile row, per
    inference tile). So the loops are held equal where the forward sees
    every window alone: both at ``--batch_size=1``, the payloads must be
    equal by content (2160 is a multiple of 144, so both loops write every
    canvas pixel from the same patch). At batch 30 the legacy run is set
    beside ``wsi_cli``'s (counts, centroid matches; printed)."""
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_wsi_cli_legacy")
    shutil.rmtree(work, ignore_errors=True)
    legacy = {"CERBERUS_RESIDENT": "0"}
    try:
        write_slide(os.path.join(work, "input", "slide"))
        flags = ("--wsi_file_ext=.npy", "--postproc_backend=gpu")
        run = run_wsi_cli(torch, os.path.join(work, "b30"),
                          os.path.join(work, "input"), flags, env=legacy)
        one = {name: run_wsi_cli(torch, os.path.join(work, name),
                                 os.path.join(work, "input"),
                                 flags + ("--batch_size=1",), env=env)
               for name, env in (("legacy", legacy), ("resident", {}))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    equal1 = payload(one["legacy"]["dat"]) == payload(one["resident"]["dat"])
    at30 = {t: {"instances_legacy_resident": [len(run["dat"][t]),
                                              len(resident_run["dat"][t])],
                "centroid_match_3px": [
                    centroid_match(run["dat"][t], resident_run["dat"][t]),
                    centroid_match(resident_run["dat"][t], run["dat"][t])]}
            for t in TASKS}
    emit_cli("wsi_cli_legacy", run, env=legacy,
             batch1={"dat_equal_legacy_vs_resident": equal1,
                     "seconds": {k: r["seconds"] for k, r in one.items()},
                     "instances": {k: {t: len(r["dat"][t]) for t in TASKS}
                                   for k, r in one.items()}},
             batch30_vs_wsi_cli=at30,
             dat_equal_to_wsi_cli=payload(run["dat"])
             == payload(resident_run["dat"]))
    check_cli_outputs(run, "wsi_cli_legacy")
    for name, r in one.items():
        check_cli_outputs(r, "wsi_cli_legacy (batch 1, %s)" % name)
    if "Legacy Read Time" not in run["spans"] or \
            "Legacy Read Time" not in one["legacy"]["spans"]:
        raise AssertionError("wsi_cli_legacy: the legacy loop did not run")
    if not equal1:
        raise AssertionError("wsi_cli_legacy: at batch 1 the legacy and the "
                             "resident loop give different payloads")
    return run


def centroid_match(a: dict, b: dict, tol: float = 3.0) -> float:
    """Share of the instances of ``a`` with a centroid of ``b`` within
    ``tol`` px."""
    ca = np.array([v["centroid"] for v in a.values()], np.float64)
    cb = np.array([v["centroid"] for v in b.values()], np.float64)
    if len(ca) == 0 or len(cb) == 0:
        return float(len(ca) == len(cb))
    nearest = np.full(len(ca), np.inf)
    for i in range(0, len(ca), 1024):
        d2 = ((ca[i:i + 1024, None] - cb[None]) ** 2).sum(-1)
        nearest[i:i + 1024] = d2.min(1)
    return float((nearest <= tol * tol).mean())


def foreground(dat_task: dict, hw) -> np.ndarray:
    """The instances' filled contours as one (h, w) bool plane."""
    import cv2

    plane = np.zeros(hw, np.uint8)
    contours = [np.asarray(v["contour"], np.int32).reshape(-1, 1, 2)
                for v in dat_task.values()]
    if contours:
        cv2.drawContours(plane, contours, -1, 1, thickness=cv2.FILLED)
    return plane.astype(bool)


def phase_wsi_cli_cpu(torch, legacy_run):
    """``--postproc_backend=cpu`` (the reference's default run: the legacy
    loop and the scipy/cv2 families on the host) on the wsi phase's
    ``.npy`` slide, with ``--nr_post_proc_workers=0`` and then ``4`` (spawned
    processes): the two payloads must be equal by content. Against
    ``wsi_cli_legacy`` (the same loop and batches, so the same canvas; the
    CUDA families) it must meet the JAX package's bounds between its two
    backends (``tests/test_tpu_backend_pipeline.py``): instance counts
    equal for gland and lumen and within 2 % for nuclei, and the filled
    instance contours of each task disagreeing on < 2 % of the slide's
    pixels; for gland and lumen also >= 98 % of the instances (both ways)
    matched by a centroid within 3 px. For nuclei the centroid match is
    printed, not held: the device watershed floods 64 elevation buckets
    (ties on a plateau go to the lowest marker id), the host one the exact
    elevations, and on this synthetic model's near-flat nuclei
    probability the two split the same foreground into basins at other
    places."""
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_wsi_cli_cpu")
    shutil.rmtree(work, ignore_errors=True)
    runs = {}
    try:
        write_slide(os.path.join(work, "input", "slide"))
        for workers in (0, 4):
            runs[workers] = run_wsi_cli(
                torch, os.path.join(work, "w%d" % workers),
                os.path.join(work, "input"),
                ("--wsi_file_ext=.npy", "--postproc_backend=cpu",
                 "--nr_post_proc_workers=%d" % workers))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run = runs[0]
    equal = payload(run["dat"]) == payload(runs[4]["dat"])
    gpu = legacy_run["dat"]
    counts = {t: [len(run["dat"][t]), len(gpu[t])] for t in TASKS}
    match = {t: [centroid_match(run["dat"][t], gpu[t]),
                 centroid_match(gpu[t], run["dat"][t])] for t in TASKS}
    disagree = {t: float((foreground(run["dat"][t], WSI_HW)
                          != foreground(gpu[t], WSI_HW)).mean())
                for t in TASKS}
    nuclei_rel = abs(counts["Nuclei"][0] - counts["Nuclei"][1]) / max(
        counts["Nuclei"][1], 1)
    host_s = {w: r["spans"].get("Nuclei Post Proc Time", 0.0)
              + r["spans"].get("Gland & Lumen Post Proc Time", 0.0)
              for w, r in runs.items()}
    emit_cli("wsi_cli_cpu", run, workers4_seconds=runs[4]["seconds"],
             workers4_log_spans_s=runs[4]["spans"],
             host_postproc_s={"workers0": host_s[0], "workers4": host_s[4]},
             dat_equal_workers0_vs_4=equal,
             vs_wsi_cli_legacy={"counts_cpu_gpu": counts,
                                "nuclei_count_rel_diff": nuclei_rel,
                                "foreground_pixel_disagreement": disagree,
                                "centroid_match_3px_cpu_in_gpu_and_back":
                                match})
    check_cli_outputs(run, "wsi_cli_cpu", kernels=False)
    if not equal:
        raise AssertionError("wsi_cli_cpu: 0 and 4 post-processing workers "
                             "give different payloads")
    bad = []
    if counts["Gland"][0] != counts["Gland"][1] or \
            counts["Lumen"][0] != counts["Lumen"][1]:
        bad.append("gland/lumen counts %s" % counts)
    if nuclei_rel > 0.02:
        bad.append("nuclei counts %s" % counts["Nuclei"])
    bad += ["%s foreground disagreement %s" % (t, d)
            for t, d in disagree.items() if not d < 0.02]
    bad += ["%s centroid match %s" % (t, m) for t, m in match.items()
            if t != "Nuclei" and min(m) < 0.98]
    if bad:
        raise AssertionError("wsi_cli_cpu against wsi_cli_legacy: "
                             + "; ".join(bad))


# --------------------------------------------------------------- serving
# the tile_cli phases' seven small images (hw, seed), beside the main
# path's three
SERVE_SMALL = (((256, 256), 51), ((320, 400), 52), ((384, 300), 53),
               ((450, 450), 54), ((512, 600), 55), ((600, 520), 56),
               ((300, 600), 57))
MAT_TASKS = ("gland", "lumen", "nuclei", "pclass")
PATCHES = (512, 9, 160)  # patch_eval: count, classes, side
PATCH_REL_TOL = 1e-3  # patch_eval: card f32 probabilities vs the CPU's
# patch_eval: the Patch-Class head's last conv scaled so its random-weight
# logits (hundreds) leave the softmax unsaturated and the classes apart
SYNTH_PCLASS_SCALE = 0.01
PCLASS_MIN_PREDICTED = 2  # patch_eval: classes the calibrated head predicts


def serve_images():
    """The tile_cli phases' directory, by file name: the main path's three
    images and seven small ones."""
    images = {"main%d" % i: img for i, img in enumerate(main_path_images())}
    for hw, seed in SERVE_SMALL:
        images["small%d" % seed] = synthetic_image(hw, seed)
    return images


def load_model_dir(torch, path):
    """The tile ``InferManager`` over a model directory, as the CLI loads
    it (448->144, batch 10)."""
    from cerberus_tpu_torch.config import load_settings
    from cerberus_tpu_torch.infer.tile import InferManager

    paramset = load_settings(path)
    return InferManager(
        checkpoint_path=os.path.join(path, "weights.tar"),
        decoder_dict=paramset.req_target_code,
        model_args=paramset.model_kwargs, device="cuda", batch_size=10,
        patch_input_shape=448, patch_output_shape=144)


def phase_native_checkpoint(torch, manager):
    """The smoke model written by the port's msgpack encoder as a native
    ``weights.tar`` in a second model directory and loaded through
    ``InferManager``: its state dict must equal the torch-tar one's, and
    the main path's canvases must be byte-equal."""
    from cerberus_tpu_torch.models.convert import (
        jax_params_from_state_dict, save_native_checkpoint)
    from cerberus_tpu_torch.ops import cuda_build

    path = os.path.join(cuda_build.BUILD_DIR, "smoke_native_model")
    shutil.rmtree(path, ignore_errors=True)
    try:
        write_model(torch, path, True)
        ckpt = os.path.join(path, "weights.tar")
        params = jax_params_from_state_dict(
            torch.load(ckpt, map_location="cpu")["desc"])
        t0 = time.perf_counter()
        save_native_checkpoint(ckpt, params)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(ckpt)
        with open(ckpt, "rb") as handle:
            native_file = handle.read(2) != b"PK"
        t0 = time.perf_counter()
        native = load_model_dir(torch, path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    ref = manager.model.state_dict()
    got = native.model.state_dict()
    sd_equal = set(got) == set(ref) and all(
        torch.equal(got[k], ref[k]) for k in ref)
    canvases_equal = [bool(torch.equal(native.infer_canvas(img),
                                       manager.infer_canvas(img)))
                      for img in main_path_images()]
    emit({"phase": "native_checkpoint", "layers": len(params),
          "bytes": size, "native_file": native_file, "write_s": write_s,
          "load_s": load_s, "state_dict_equal": sd_equal,
          "main_path_canvases_byte_equal": canvases_equal})
    if not (native_file and sd_equal and all(canvases_equal)):
        raise AssertionError("native checkpoint: state dict or canvases "
                             "differ from the torch checkpoint's")


def run_tile_cli(torch, argv):
    """``python -m cerberus_tpu_torch.run_infer_tile --gpu=0`` (its
    ``main``, in this process), launch counts reset just before and read
    just after. Returns (seconds, launches)."""
    from cerberus_tpu_torch import run_infer_tile
    from cerberus_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    run_infer_tile.main(["--gpu=0", *argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(cuda_build.launch_counts)


def read_mats(out_dir, names):
    import scipy.io as sio

    return {(name, task): {k: v for k, v in sio.loadmat(os.path.join(
        out_dir, "%s_mat" % task, name + ".mat")).items()
        if not k.startswith("__")} for name in names for task in MAT_TASKS}


def mats_equal_maps(mats, names, results) -> bool:
    """The ``.mat`` files' maps (``inst_map``, ``type_map``, ``pclass``)
    against (inst_map_dict, type_map_dict, pclass_map) label maps per
    image, in ``names`` order (the ``type`` and ``id`` vectors are
    functions of these maps)."""
    for name, (inst, types, pclass) in zip(names, results):
        for task, mat_task in (("Gland", "gland"), ("Lumen", "lumen"),
                               ("Nuclei", "nuclei")):
            mat = mats[(name, mat_task)]
            if not np.array_equal(mat["inst_map"], inst[task]) or (
                    ("type_map" in mat) != (types[task] is not None)) or (
                    types[task] is not None
                    and not np.array_equal(mat["type_map"], types[task])):
                return False
        if not np.array_equal(mats[(name, "pclass")]["pclass"], pclass):
            return False
    return True


def windows_ran(manager, images, cached: bool):
    """(windows of the images, windows the step ran: the per-image path
    pads each image's last batch, the cache each cache's last batch)."""
    from cerberus_tpu_torch.data.patching import prepare_patching
    from cerberus_tpu_torch.infer.tile import CACHE_WINDOWS

    batch = int(manager.batch_size)
    counts = [len(prepare_patching(img, int(manager.patch_input_shape),
                                   int(manager.patch_output_shape))[1])
              for img in images.values()]
    groups, run = [], 0
    for n in counts:
        if not cached:
            groups.append(n)
            continue
        run += n
        if run > CACHE_WINDOWS:
            groups.append(run)
            run = 0
    if run:
        groups.append(run)
    return sum(counts), sum(-(-g // batch) * batch for g in groups)


def time_tile_paths(torch, manager, images, canvas_order, full_order):
    """The per-image path and the batch cache on the same in-memory images,
    in the turns of ``canvas_order`` (the canvases alone: per image
    ``infer_canvas``, the cache ``cached_canvases``) and then of
    ``full_order`` (the label maps: ``process_image`` per image, the cache's
    canvases through ``post_process_canvas``). Returns the lines, each
    path's canvases from its last canvas turn, and its label maps."""
    from cerberus_tpu_torch.infer.tile import post_process_canvas

    items = list(images.items())
    px = sum(i.shape[0] * i.shape[1] for i in images.values())
    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)

    def canvases(path):
        if path == "cache":
            return {n: c for n, _, c in manager.cached_canvases(items)}
        return {n: manager.infer_canvas(img) for n, img in items}

    def label_maps(path):
        if path == "cache":
            return [post_process_canvas(c, *args)
                    for _, _, c in manager.cached_canvases(items)]
        return [manager.process_image(img) for _, img in items]

    # warm-up on two images (the managers ran the main path already)
    list(manager.cached_canvases(items[:2]))
    for _, img in items[:2]:
        manager.infer_canvas(img)
    torch.cuda.synchronize()
    line, outs = {}, {}
    for what, order, fn in (("canvas", canvas_order, canvases),
                            ("full", full_order, label_maps)):
        turns = []  # (path, seconds) in the order run
        for path in order:
            t0 = time.perf_counter()
            outs[what, path] = fn(path)
            torch.cuda.synchronize()
            turns.append((path, time.perf_counter() - t0))
        seconds = {path: [t for p, t in turns if p == path]
                   for path in ("per_image", "cache") if path in order}
        for path, secs in seconds.items():
            n_win, ran = windows_ran(manager, images, path == "cache")
            mid = statistics.median(secs)
            entry = line.setdefault(path, {
                "windows": n_win, "windows_ran": ran,
                "zero_padded_share": (ran - n_win) / ran})
            entry[what] = {"seconds": secs, "median_s": mid,
                           "output_mpx_per_s": px / mid / 1e6,
                           "ms_per_image": mid / len(items) * 1e3}
        if len(seconds) == 2:
            # the speed ratio of the medians, and the A/B pairs (turns 2i
            # and 2i + 1, one of each path) that the cache won
            pairs = [dict(turns[i:i + 2]) for i in range(0, len(turns), 2)]
            line["%s_cache_over_per_image" % what] = (
                statistics.median(seconds["per_image"])
                / statistics.median(seconds["cache"]))
            line["%s_cache_faster_pairs" % what] = [
                sum(p["cache"] < p["per_image"] for p in pairs), len(pairs)]
    return line, outs


def families_on_cached_canvases(torch, manager, canvases):
    """The kernel families against the plain families on every canvas the
    batch cache stitched (``canvases``, by name), byte for byte."""
    from cerberus_tpu_torch.infer.tile import post_process_canvas
    from cerberus_tpu_torch.ops.device_postproc import KERNELS, PLAIN

    args = (manager.decoder_dict, manager.postproc_list,
            manager.cfg.active_decoder_kwargs)
    for name, canvas in canvases.items():
        got = post_process_canvas(canvas, *args, impl=KERNELS)
        ref = post_process_canvas(canvas, *args, impl=PLAIN)
        for part, ref_part in zip(got, ref):
            same = (all(np.array_equal(part[t], ref_part[t])
                        for t in ref_part) if isinstance(ref_part, dict)
                    else np.array_equal(part, ref_part))
            if not same:
                raise AssertionError("%s: kernel families differ from the "
                                     "plain families on the cached canvas"
                                     % name)


def batch_effect(outs):
    """Print only: the cache's batch-10 canvases and label maps against the
    per-image path's (the card's batch-position effect)."""
    cached, per_image = outs["canvas", "cache"], outs["canvas", "per_image"]
    canvas_max = {name: float((cached[name].float()
                               - per_image[name].float()).abs().max())
                  for name in per_image}
    counts, iou = {}, {}
    for (inst_c, _, _), (inst_p, _, _) in zip(outs["full", "cache"],
                                             outs["full", "per_image"]):
        for task in inst_p:
            counts.setdefault(task, []).append(
                [len(np.unique(inst_c[task][inst_c[task] > 0])),
                 len(np.unique(inst_p[task][inst_p[task] > 0]))])
            a, b = inst_c[task] > 0, inst_p[task] > 0
            union = int((a | b).sum())
            iou.setdefault(task, []).append(
                int((a & b).sum()) / union if union else 1.0)
    return {"canvas_max_abs": canvas_max,
            "instances_cache_vs_per_image": counts, "fg_iou": iou}


def check_launches(phase, launches):
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("%s: kernel %s was not launched"
                                 % (phase, name))


# tile_cli_cache: turns (per image = A, cache = B) of the canvases alone
# and of the whole path: windowed ABBA x 3 each (six A/B pairs, to resolve a
# 10 % difference on a host whose turns spread by 10-20 %); dense one each
# (the paths differ several-fold)
TILE_TURNS = {"windowed": (("per_image", "cache", "cache", "per_image") * 3,
                           ("per_image", "cache", "cache", "per_image") * 3),
              "dense": (("cache",), ("per_image", "cache"))}


def phase_tile_cli_cache(torch, work, model_dir, images, managers):
    """The tile CLI's ``main`` on a directory of ten images (the main
    path's three and seven small ones, so a cache mixes files) at
    ``--batch_size=10`` and ``--dense --batch_size=16``, timed beside the
    per-image path (``TILE_TURNS``) on ``managers`` (the main path's, one
    per geometry, the smoke model's weights); the kernel families against
    the plain families on every cached canvas; at ``--batch_size=1`` the
    ``.mat`` files' maps of the seven small images against the per-image
    path's; at batch 10 the cache's maps against the per-image path's,
    printed only. Returns the windowed run's launches, CLI seconds and
    per-image label maps."""
    line = {"images": {n: list(i.shape[:2]) for n, i in images.items()}}
    argv = ["--model=%s" % model_dir]
    steps = {}  # seconds of each step of this phase

    def mark(step, t0):
        steps[step] = time.perf_counter() - t0
        return time.perf_counter()

    for name, flags in (("windowed", ["--batch_size=10"]),
                        ("dense", ["--dense", "--batch_size=16"])):
        manager = managers[name]
        out = os.path.join(work, "out_" + name)
        t0 = time.perf_counter()
        seconds, run_launches = run_tile_cli(torch, argv + [
            "--input_dir=%s" % os.path.join(work, "input"),
            "--output_dir=%s" % out, *flags])
        check_launches("tile_cli_cache (%s)" % name, run_launches)
        t0 = mark(name + "_cli", t0)
        paths, outs = time_tile_paths(torch, manager, images,
                                      *TILE_TURNS[name])
        t0 = mark(name + "_turns", t0)
        families_on_cached_canvases(torch, manager, outs["canvas", "cache"])
        t0 = mark(name + "_families_vs_plain", t0)
        px = sum(i.shape[0] * i.shape[1] for i in images.values())
        line[name] = {"patch": [int(manager.patch_input_shape),
                                int(manager.patch_output_shape)],
                      "batch": int(manager.batch_size),
                      "cli_seconds": seconds,
                      "cli_output_mpx_per_s": px / seconds / 1e6,
                      "cli_ms_per_image": seconds / len(images) * 1e3,
                      "cli_launches": run_launches, **paths,
                      "families_vs_plain": "byte_equal"}
        if name == "windowed":
            windowed = {"launches": run_launches, "cli_seconds": seconds,
                        "per_image_maps": outs["full", "per_image"]}
            line[name]["batch_effect"] = batch_effect(outs)
            line[name]["mats_equal_per_image"] = mats_equal_maps(
                read_mats(out, images), images, outs["full", "per_image"])
            t0 = mark(name + "_batch_effect_and_mats", t0)
        del outs
        torch.cuda.empty_cache()
    # at batch 1 every window runs alone on both paths; the seven small
    # images still span caches that mix files
    small = {n: img for n, img in images.items() if n.startswith("small")}
    out = os.path.join(work, "out_b1")
    t0 = time.perf_counter()
    run_tile_cli(torch, argv + [
        "--input_dir=%s" % os.path.join(work, "input_small"),
        "--output_dir=%s" % out, "--batch_size=1"])
    t0 = mark("batch1_cli", t0)
    manager = managers["windowed"]
    manager.batch_size = 1
    try:
        per_image = [manager.process_image(img) for img in small.values()]
    finally:
        manager.batch_size = 10
    line["batch1_images"] = list(small)
    line["batch1_mats_equal_per_image"] = mats_equal_maps(
        read_mats(out, small), small, per_image)
    mark("batch1_per_image", t0)
    emit({"phase": "tile_cli_cache", **line, "step_seconds": steps})
    if not line["batch1_mats_equal_per_image"]:
        raise AssertionError("tile_cli_cache: at batch 1 the cache's .mat "
                             "files differ from the per-image path's")
    return windowed


def phase_tile_cli_fused(torch, work, model_dir, images, manager, windowed):
    """``--tile_backend=fused`` at batch 10 on the same directory: its
    ``.mat`` files' maps against the per-image path's, and on ``manager``
    its canvases against the host path's (``infer_canvas``) byte for byte,
    timed in turns with it (fused, host, host, fused, twice). Returns the
    CLI run's launches."""
    from cerberus_tpu_torch.infer.fused_tile import run_fused_tile

    out = os.path.join(work, "out_fused")
    seconds, launches = run_tile_cli(torch, [
        "--model=%s" % model_dir, "--input_dir=%s" % os.path.join(
            work, "input"), "--output_dir=%s" % out, "--batch_size=10",
        "--tile_backend=fused"])
    check_launches("tile_cli_fused", launches)
    mats_ok = mats_equal_maps(read_mats(out, images), images,
                              windowed["per_image_maps"])
    paths = {"fused": lambda img: run_fused_tile(manager, img),
             "host": manager.infer_canvas}
    paths["fused"](images["main0"])  # warm-up
    ms, got = {"fused": [], "host": []}, {}
    for path in ("fused", "host", "host", "fused") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[path] = {n: paths[path](img) for n, img in images.items()}
        torch.cuda.synchronize()
        ms[path].append((time.perf_counter() - t0) * 1e3)
    # A/B pairs (turns 2i and 2i + 1) that the fused backend won
    fused_won = sum(f < h for f, h in zip(ms["fused"], ms["host"]))
    equal = {n: bool(torch.equal(got["fused"][n], c))
             for n, c in got["host"].items()}
    px = sum(i.shape[0] * i.shape[1] for i in images.values())
    emit({"phase": "tile_cli_fused", "batch": 10, "cli_seconds": seconds,
          "cli_output_mpx_per_s": px / seconds / 1e6,
          "host_cli_seconds": windowed["cli_seconds"], "launches": launches,
          "mats_equal_per_image": mats_ok, "canvases_byte_equal": equal,
          "canvas_ms_ten_images": ms,
          "fused_faster_pairs": [fused_won, len(ms["fused"])]})
    if not (mats_ok and all(equal.values())):
        raise AssertionError("tile_cli_fused: canvases or .mat files differ "
                             "from the host path's")
    return launches


def phase_predictor(torch, model_dir, manager):
    """``CerberusPredictor.from_model_dir`` on the smoke model (batch 10):
    ``predict_tile`` label maps and ``predict_raw`` canvases against
    ``manager``'s ``process_image`` / ``infer_canvas`` at batch 10, byte for
    byte, and two
    threads against the serial results. Returns the launches of the serial
    ``predict_tile`` calls."""
    import threading

    from cerberus_tpu_torch.ops import cuda_build
    from cerberus_tpu_torch.predictor import CerberusPredictor

    predictor = CerberusPredictor.from_model_dir(model_dir, batch_size=10)
    images = main_path_images()
    predictor.predict_tile(images[0])  # warm-up
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    serial, ms = [], []
    for img in images:
        t0 = time.perf_counter()
        serial.append(predictor.predict_tile(img))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda_build.launch_counts)
    check_launches("predictor", launches)
    tasks = ("Gland", "Lumen", "Nuclei")
    maps_equal, raw_equal = [], []
    for img, got in zip(images, serial):
        inst, types, pclass = manager.process_image(img)
        maps_equal.append(all(
            np.array_equal(got[t]["inst_map"], inst[t])
            and (types[t] is None) == (got[t]["type_map"] is None)
            and (types[t] is None
                 or np.array_equal(got[t]["type_map"], types[t]))
            for t in tasks) and np.array_equal(got["pclass_map"], pclass))
        raw_equal.append(bool(np.array_equal(
            predictor.predict_raw(img),
            manager.infer_canvas(img).float().cpu().numpy())))
    threaded = [None, None]

    def work(i):
        threaded[i] = predictor.predict_tile(images[i + 1])

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    threads_equal = [not t.is_alive() for t in threads] == [True, True] and \
        all(all(np.array_equal(got[t]["inst_map"], ref[t]["inst_map"])
                for t in tasks)
            and np.array_equal(got["pclass_map"], ref["pclass_map"])
            for got, ref in zip(threaded, serial[1:]))
    emit({"phase": "predictor", "batch": 10,
          "images": [list(i.shape[:2]) for i in images],
          "ms_per_image": ms, "ms_per_1000_tile": statistics.mean(ms[1:]),
          "launches": launches, "predict_tile_equal": maps_equal,
          "predict_raw_equal": raw_equal, "threads_equal": threads_equal,
          "instances": {t: [int(len(np.unique(r[t]["inst_map"]))) - 1
                            for r in serial] for t in tasks}})
    if not (all(maps_equal) and all(raw_equal) and threads_equal):
        raise AssertionError("predictor: outputs differ from process_image "
                             "or between threads")
    return launches


def plain_metrics(labels, probs) -> dict:
    """The patch metrics by their definitions, one threshold at a time
    (an independent check of ``infer/patch.evaluate_classification``)."""
    k = probs.shape[1]
    pred = probs.argmax(1)
    aps, accs = [], []
    for c in range(k):
        y = labels == c
        if not y.any():
            continue
        score = probs[:, c].astype(np.float64)
        ap = prev_recall = 0.0
        for thr in sorted(set(score.tolist()), reverse=True):
            sel = score >= thr
            tp = float((sel & y).sum())
            recall = tp / y.sum()
            ap += (recall - prev_recall) * tp / sel.sum()
            prev_recall = recall
        aps.append(ap)
        accs.append(float((pred[y] == c).mean()))
    f1 = []
    for c in range(k):
        tp = float(((pred == c) & (labels == c)).sum())
        denom = float((pred == c).sum() + (labels == c).sum())
        f1.append(2 * tp / denom if denom else 0.0)
    conf = np.zeros((k, k))
    for t, p in zip(labels, pred):
        conf[t, p] += 1
    rows = conf.sum(1, keepdims=True)
    conf = np.divide(conf, rows, out=np.zeros_like(conf), where=rows > 0)
    return {"acc_all": float((pred == labels).mean()),
            "avg_acc": float(np.mean(accs)), "avg_ap": float(np.mean(aps)),
            "avg_f1": float(np.mean(f1)), "conf_mat": conf}


def calibrate_pclass_head(torch, model_dir, crops):
    """The model directory's Patch-Class head scaled by
    ``SYNTH_PCLASS_SCALE``, then standardised per class on ``crops`` (the
    bf16 forward on the card): each class's logit, taken relative to the
    patch's mean logit, gets zero mean and unit spread over the patches, so
    that no class wins every patch and the metrics are graded."""
    from cerberus_tpu_torch.config import load_settings
    from cerberus_tpu_torch.infer import patch

    ckpt = os.path.join(model_dir, "weights.tar")
    state = torch.load(ckpt, map_location="cpu")
    head = "decoder_head.Patch-Class.conv2."
    for attr in ("weight", "bias"):
        state["desc"][head + attr] *= SYNTH_PCLASS_SCALE
    torch.save(state, ckpt)
    probs = patch.InferManager(
        checkpoint_path=ckpt, model_args=load_settings(model_dir).model_kwargs,
        device="cuda", batch_size=32).predict_probs(crops)
    z = np.log(np.maximum(probs.astype(np.float64), 1e-30))
    z -= z.mean(axis=1, keepdims=True)
    mean = torch.from_numpy(z.mean(axis=0)).float()
    spread = torch.from_numpy(np.maximum(z.std(axis=0), 1e-6)).float()
    weight = state["desc"][head + "weight"]
    state["desc"][head + "weight"] = weight / spread.reshape(
        -1, *([1] * (weight.dim() - 1)))
    state["desc"][head + "bias"] = (state["desc"][head + "bias"]
                                    - mean) / spread
    torch.save(state, ckpt)


def phase_patch_eval(torch, work):
    """The ``run_eval_patch`` CLI on ``PATCHES`` seeded ``pickle``-written
    patches, with the smoke model's Patch-Class head scaled by
    ``SYNTH_PCLASS_SCALE`` and then calibrated on these patches
    (``calibrate_pclass_head``) so that several classes are predicted:
    patches per second; its metrics against ``evaluate_classification``
    and ``plain_metrics`` on the step's probabilities; the card's f32
    probabilities on a subset against the CPU forward's
    (``PATCH_REL_TOL``)."""
    import pickle

    from cerberus_tpu_torch import run_eval_patch
    from cerberus_tpu_torch.infer import patch
    from cerberus_tpu_torch.utils.geometry import cropping_center

    model_dir = os.path.join(work, "pclass_model")
    write_model(torch, model_dir, True)
    ckpt = os.path.join(model_dir, "weights.tar")
    n, k, side = PATCHES
    input_dir = os.path.join(work, "patches")
    os.makedirs(input_dir)
    labels = np.arange(n) % k
    imgs = np.stack([synthetic_image((side, side), 2000 + i)
                     for i in range(n)])
    for i in range(n):
        with open(os.path.join(input_dir, "p%04d.dat" % i), "wb") as f:
            pickle.dump({"img": imgs[i], "ann": int(labels[i])}, f)
    calibrate_pclass_head(torch, model_dir, cropping_center(
        imgs, (144, 144), batch=True))
    argv = ["--gpu=0", "--model=%s" % model_dir,
            "--input_dir=%s" % input_dir, "--batch_size=32"]
    printout = io.StringIO()  # the CLI's metric printout, kept off stdout
    with contextlib.redirect_stdout(printout):
        run_eval_patch.main(argv)  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_eval_patch.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0

    from cerberus_tpu_torch.config import load_settings

    manager = patch.InferManager(
        checkpoint_path=os.path.join(model_dir, "weights.tar"),
        model_args=load_settings(model_dir).model_kwargs, device="cuda",
        batch_size=32)
    files = sorted(os.listdir(input_dir))
    crops, file_labels = patch.load_patch_dataset(
        [os.path.join(input_dir, f) for f in files], 144)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = manager.predict_probs(crops)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(printout):
        again = patch.evaluate_classification(
            file_labels, probs, {i + 1: str(i + 1) for i in range(k)})
    plain = plain_metrics(file_labels, probs)
    same = all(metrics[key] == again[key] for key in
               ("acc_all", "avg_acc", "avg_ap", "avg_f1")) and \
        np.array_equal(metrics["conf_mat"], again["conf_mat"])
    plain_diff = max([abs(metrics[key] - plain[key]) for key in
                      ("acc_all", "avg_acc", "avg_ap", "avg_f1")]
                     + [float(np.abs(metrics["conf_mat"]
                                     - plain["conf_mat"]).max())])
    # f32 on the card (TF32 off) against the CPU forward, on 32 patches
    sub = crops[:32]
    manager.compute_dtype = torch.float32
    with tf32_off(torch):
        card = manager.predict_probs(sub)
    cpu = patch.InferManager(
        checkpoint_path=os.path.join(model_dir, "weights.tar"),
        model_args=manager.model_args, device="cpu",
        batch_size=32).predict_probs(sub)
    rel = float(np.abs(card - cpu).max()) / float(np.abs(cpu).max())
    emit({"phase": "patch_eval", "patches": n, "classes": k,
          "side": side, "crop": 144, "batch": 32, "compute": "bf16",
          "cli_seconds": cli_s, "cli_patches_per_s": n / cli_s,
          "step_seconds": step_s, "step_patches_per_s": n / step_s,
          "metrics": {key: metrics[key] for key in
                      ("acc_all", "avg_acc", "avg_ap", "avg_f1")},
          "printout_lines": len(printout.getvalue().splitlines()),
          "metrics_equal_recomputed": same,
          "plain_metrics_max_abs_diff": plain_diff,
          "f32_card_vs_cpu_rel_err": rel, "tol": PATCH_REL_TOL,
          "prob_range": [float(probs.min()), float(probs.max())],
          "predicted_classes": sorted(set(probs.argmax(1).tolist()))})
    if not (same and plain_diff <= 1e-9 and rel <= PATCH_REL_TOL
            and np.isfinite(probs).all() and probs.shape == (n, k)
            and len(set(probs.argmax(1).tolist())) >= PCLASS_MIN_PREDICTED):
        raise AssertionError("patch_eval: metrics or probabilities off")


def phase_serving(torch, managers):
    """The serving phases on one model directory (the smoke model, whose
    weights ``managers`` hold: the main path's, one per geometry):
    ``native_checkpoint``, ``tile_cli_cache``, ``tile_cli_fused``,
    ``predictor``, ``patch_eval``, and the import probe. Returns the
    launches of the cache, fused and predictor paths."""
    import importlib.util

    import cv2

    from cerberus_tpu_torch.ops import cuda_build

    emit({"phase": "import_probe", "found": {
        name: importlib.util.find_spec(name) is not None
        for name in ("sklearn", "msgpack", "flax", "joblib")}})
    manager = managers["windowed"]
    seconds = {}
    t0 = time.perf_counter()
    phase_native_checkpoint(torch, manager)
    seconds["native_checkpoint"] = time.perf_counter() - t0
    work = os.path.join(cuda_build.BUILD_DIR, "smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    try:
        model_dir = os.path.join(work, "model")
        write_model(torch, model_dir, True)
        images = serve_images()
        for name, img in images.items():
            for sub in ("input",) + (("input_small",) if name.startswith(
                    "small") else ()):
                os.makedirs(os.path.join(work, sub), exist_ok=True)
                cv2.imwrite(os.path.join(work, sub, name + ".png"),
                            cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        t0 = time.perf_counter()
        windowed = phase_tile_cli_cache(torch, work, model_dir, images,
                                        managers)
        t1 = time.perf_counter()
        fused = phase_tile_cli_fused(torch, work, model_dir, images, manager,
                                     windowed)
        t2 = time.perf_counter()
        predictor = phase_predictor(torch, model_dir, manager)
        t3 = time.perf_counter()
        phase_patch_eval(torch, work)
        seconds.update(tile_cli_cache=t1 - t0, tile_cli_fused=t2 - t1,
                       predictor=t3 - t2,
                       patch_eval=time.perf_counter() - t3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "serving_seconds", **seconds})
    return {"cache": windowed["launches"], "fused": fused,
            "predictor": predictor}


TRAIN_HW, TRAIN_BATCH = 448, 12  # run_train.py's default geometry
TRAIN_RUNS = (("bf16", True, False, 1), ("f32", False, False, 1),
              ("bf16_remat", True, True, 1), ("bf16_accum4", True, False, 4))
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_CLI_SAMPLES = 24


def train_helpers():
    """The port's train-test helpers (``tests/_torch_train_helpers.py``:
    the 6-head config, the loss table, the synthetic batch and the
    card-against-CPU step comparison)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_train_helpers

    return _torch_train_helpers


def profile_step(torch, fn):
    """One ``fn()`` under ``torch.profiler``: (wall ms, device ms, top five
    device operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        ops[evt.key[:90]] = ops.get(evt.key[:90], 0.0) + us
    dev_ms = sum(ops.values()) / 1e3
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:5]
    return wall_ms, dev_ms, [{"name": k, "ms": v / 1e3,
                              "share": v / 1e3 / dev_ms if dev_ms else None}
                             for k, v in top]


def phase_train_step(torch, dev):
    """The default model (ResNet-34, six heads) training at 448^2, batch
    12, on ``tests/_torch_train_helpers.make_batch``'s synthetic batch:
    bf16 and f32 (cuDNN's default TF32), bf16 with ``remat=True``, bf16
    with ``grad_accum=4``. Per run: median step ms of 10 steps after 3
    warm-up ones (the host batch copied in through pinned memory each
    step, the loss read back), images/s, peak GiB, the profiled step's
    device-busy share and top five device operations, and model TFLOP/s
    (3x the full-tower forward FLOPs of ``utils/flops.py``) as a share of
    the card's dense bf16 peak. Every loss must be finite and the BN
    statistics must move."""
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
    from cerberus_tpu_torch.train.steps import make_train_step
    from cerberus_tpu_torch.train.utils import tame_head_logits
    from cerberus_tpu_torch.utils.flops import forward_flops

    helpers = train_helpers()
    kwargs = helpers.model_kwargs("resnet34")
    cfg = ModelConfig.from_kwargs(kwargs)
    state = tame_head_logits(init_weights(
        NetDesc(cfg), torch.Generator().manual_seed(0)).state_dict())
    batch = helpers.make_batch(np.random.default_rng(0), n=TRAIN_BATCH,
                               hw=TRAIN_HW)
    step_flops = 3 * forward_flops(TRAIN_HW, TRAIN_HW, False, cfg,
                                   TRAIN_BATCH)["flops"]
    runs = {}
    for name, bf16, remat, accum in TRAIN_RUNS:
        model = NetDesc(cfg)
        model.load_state_dict(state)
        model.to(dev)
        step = make_train_step(
            cfg, helpers.LOSS_KWARGS, {"lr": 1e-3},
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=remat, grad_accum=accum, model=model)
        gen = torch.Generator(device=dev).manual_seed(1)
        stats0 = model.backbone.bn1.running_var.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics = step(batch, generator=gen)
            losses.append(float(metrics["overall_loss"]))
            if i >= TRAIN_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, dev_ms, top = profile_step(
            torch, lambda: float(step(batch, generator=gen)
                                 ["overall_loss"]))
        ms = statistics.median(times)
        runs[name] = {
            "compute": "bf16" if bf16 else "f32", "remat": remat,
            "grad_accum": accum, "step_ms": ms,
            "step_ms_range": [min(times), max(times)],
            "images_per_s": TRAIN_BATCH / ms * 1e3, "peak_gib": peak,
            "profiled_step_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms, "top_ops": top,
            "model_tflop_per_s": step_flops / (ms * 1e-3) / 1e12,
            "share_of_bf16_dense_peak": step_flops / (ms * 1e-3) / 989e12,
            "loss_first": losses[0], "loss_last": losses[-1]}
        moved = not torch.equal(model.backbone.bn1.running_var, stats0)
        del model, step
        torch.cuda.empty_cache()
        if not (all(np.isfinite(losses)) and moved and dev_ms > 0):
            raise AssertionError("train_step %s: losses %s, BN moved %s"
                                 % (name, losses, moved))
    emit({"phase": "train_step", "model": "resnet34, six heads",
          "hw": TRAIN_HW, "batch": TRAIN_BATCH,
          "model_gflop_per_step": step_flops / 1e9,
          "peak_bf16_dense_tflop_per_s": 989, "runs": runs})
    return runs


def phase_train_parity(torch, dev):
    """The train step on the card against the same step on the CPU
    (``tests/_torch_train_helpers.card_parity``): resnet18, six heads,
    96^2, batch 4, the dropout keep-mask passed, TF32 off. In float64 the
    two agree within 1e-8 (loss, BN statistics) and 1e-6 of each gradient
    tensor's largest magnitude: the same function. In f32 the loss scalars
    agree within 1e-4 relative and the BN statistics within 1e-4; the f32
    gradients are printed against each other and against float64 (batch
    statistics at random init put the CPU's own f32 gradients 1.8e-3 to
    8e-2 of a tensor's largest magnitude from float64), and the card's
    median tensor error against float64 must stay within 4x the CPU's.
    Also the subtype-frozen step (frozen weights and BN
    statistics unchanged on the card) and a batch with Nuclei-TYPE missing
    and Gland-TYPE masked for two samples (that head's gradients exactly
    zero on the card)."""
    helpers = train_helpers()
    cases = {}
    for name, flags in (("plain", {}), ("subtype_gland",
                                        {"subtype_gland": True}),
                        ("masked", {})):
        kwargs, state, batch, keep = helpers.parity_case(**flags)
        if name == "masked":
            batch.pop("Nuclei-TYPE")
            batch["has_target"][:2, 4] = 0  # Gland-TYPE, samples 0 and 1
        with tf32_off(torch):
            report = helpers.card_parity(dev, kwargs, state, batch, keep)
        _metrics, card_grads, card_state = report.pop("card_f32")
        if name == "subtype_gland":
            frozen = [k for k in state if not k.startswith((
                "decoder_head.Gland#TYPE.", "output_head.Gland#TYPE."))
                and not k.endswith("num_batches_tracked")]
            report["frozen_unchanged"] = all(
                torch.equal(card_state[k], state[k]) for k in frozen)
            report["ok"] &= report["frozen_unchanged"] and not any(
                k in card_grads for k in frozen)
        if name == "masked":
            report["missing_head_grads_zero"] = all(
                not bool(v.any()) for k, v in card_grads.items()
                if "Nuclei#TYPE" in k)
            report["ok"] &= report["missing_head_grads_zero"]
        cases[name] = report
    emit({"phase": "train_parity", "setting": "resnet18, six heads, 96^2, "
          "batch 4, TF32 off", "tolerances": {
              "f64": helpers.PARITY_F64_TOLS,
              "f32_loss_rel": helpers.PARITY_LOSS_TOL,
              "f32_bn_rel": helpers.PARITY_BN_TOL,
              "f32_grad_median_vs_f64_over_cpu":
                  helpers.PARITY_F32_GRAD_FACTOR},
          "cases": cases})
    if not all(c["ok"] for c in cases.values()):
        raise AssertionError("train_parity: the card's step disagrees with "
                             "the CPU's")


def write_train_samples(data_dir, n, hw, seed=0):
    """``n`` seeded ``MTLPatchDataset`` samples with every head's channels:
    gland discs (types 1-2) holding a lumen each, nuclei dots (types
    1-6) between them, a patch class."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n):
        img = np.full((hw, hw, 3), 230, np.uint8)
        maps = {k: np.zeros((hw, hw), np.int32) for k in (
            "Gland-INST", "Gland-TYPE", "Lumen-INST", "Nuclei-INST",
            "Nuclei-TYPE")}
        for g in range(1, 7):
            r = int(rng.integers(hw // 18, hw // 7))
            cy, cx = (int(v) for v in rng.integers(r, hw - r, 2))
            col = tuple(int(v) for v in rng.integers(120, 200, 3))
            cv2.circle(img, (cx, cy), r, col, -1)
            cv2.circle(maps["Gland-INST"], (cx, cy), r, g, -1)
            cv2.circle(maps["Gland-TYPE"], (cx, cy), r,
                       int(rng.integers(1, 3)), -1)
            cv2.circle(img, (cx, cy), r // 3, (245, 245, 245), -1)
            cv2.circle(maps["Lumen-INST"], (cx, cy), r // 3, g, -1)
        for k in range(1, 81):
            cy, cx = (int(v) for v in rng.integers(5, hw - 5, 2))
            cv2.circle(img, (cx, cy), 4, (60, 30, 110), -1)
            cv2.circle(maps["Nuclei-INST"], (cx, cy), 4, k, -1)
            cv2.circle(maps["Nuclei-TYPE"], (cx, cy), 4,
                       int(rng.integers(1, 7)), -1)
        channels = list(maps)
        np.save(os.path.join(data_dir, "s%03d.npy" % i), {
            "img": img, "ann": np.stack([maps[c] for c in channels], -1),
            "channels": channels, "patch_class": int(rng.integers(0, 9))})


def phase_train_cli(torch):
    """``python -m cerberus_tpu_torch.run_train`` (its ``main``, in this
    process, ``--gpu=0 --bf16``) on 24 seeded 448^2 samples, one epoch at
    the default batch 12 with ``--per_n_steps=1``: ``stats.yml`` and a
    train state are written; then ``--resume`` of that state runs one more
    epoch from its update count (the next state holds count + 1 and Adam's
    count with it). Prints the wall seconds and the share of them spent
    waiting for the host loader's next batch beside the step's."""
    import yaml

    from cerberus_tpu_torch import run_train
    from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
    from cerberus_tpu_torch.models.convert import load_train_state
    from cerberus_tpu_torch.ops import cuda_build

    helpers = train_helpers()
    work = os.path.join(cuda_build.BUILD_DIR, "smoke_train_cli")
    shutil.rmtree(work, ignore_errors=True)
    try:
        data = os.path.join(work, "data")
        write_train_samples(data, TRAIN_CLI_SAMPLES, TRAIN_HW)
        settings = os.path.join(work, "settings.yml")
        with open(settings, "w") as handle:
            yaml.safe_dump({
                "model_kwargs": helpers.model_kwargs("resnet34"),
                "optimizer_kwargs": {"lr": 1.0e-3, "betas": [0.9, 0.999]},
                "loss_kwargs": helpers.LOSS_KWARGS,
                "dataset_kwargs": {"req_target_code": dict(
                    DEFAULT_TARGET_CODE), "train_dir": data,
                    "input_shape": TRAIN_HW, "output_shape": TRAIN_HW}},
                handle)
        log_dir = os.path.join(work, "logs")
        argv = ["--settings=%s" % settings, "--log_dir=%s" % log_dir,
                "--nr_epochs=1", "--per_n_steps=1", "--bf16", "--gpu=0"]
        t0 = time.perf_counter()
        net = run_train.main(argv)
        first_s = time.perf_counter() - t0
        timing = dict(net.timing)
        ckpt = os.path.join(log_dir, "net_step-000001.tar")
        with open(os.path.join(log_dir, "stats.yml")) as handle:
            stats = yaml.safe_load(handle)
        _, _, saved_step = load_train_state(ckpt)
        resumed = run_train.main(argv + ["--resume=%s" % ckpt])
        _, opt_state, next_step = load_train_state(
            os.path.join(log_dir, "net_step-000002.tar"))
        adam_count = int(opt_state["inner_states"]["train"]["inner_state"]
                         ["0"]["count"])
        row = {"samples": TRAIN_CLI_SAMPLES, "hw": TRAIN_HW,
               "batch": 12, "seconds_first_run": first_s,
               "loader_wait_s": timing["loader_wait_s"],
               "step_s": timing["step_s"], "wall_s": timing["wall_s"],
               "loader_wait_share": timing["loader_wait_s"]
               / timing["wall_s"],
               "stats_keys": sorted(stats.get("0", {})),
               "saved_step": saved_step, "resumed_step": resumed.step,
               "next_checkpoint_step": next_step,
               "next_checkpoint_adam_count": adam_count,
               "lr_after_resume": resumed.lr}
        emit({"phase": "train_cli", **row})
        if not (net.step == 2 and saved_step == 2 and resumed.step == 4
                and next_step == 3 and adam_count == 3
                and "train-overall_loss" in row["stats_keys"]
                and resumed.lr == resumed.train_step.schedule(4)):
            raise AssertionError("train_cli: checkpoint or resume off")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train_convergence(torch):
    """``python -m cerberus_tpu_torch.train.convergence`` on the card: 480
    steps of resnet18 at 48^2 through ``run_train`` (the JAX tool's 64
    samples and 32 windows drawn at the served scale), then the last
    checkpoint through the tile CLI; the loss must fall to a tenth and the
    instances must align with the drawn discs (``convergence.check``)."""
    from cerberus_tpu_torch.ops import cuda_build
    from cerberus_tpu_torch.train import convergence

    root = os.path.join(cuda_build.BUILD_DIR, "smoke_convergence")
    try:
        artifact = convergence.run(root=root)
        emit({"phase": "train_convergence", **artifact})
        convergence.check(artifact)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_training(torch, dev):
    """The training phases, with their seconds."""
    seconds = {}
    t0 = time.perf_counter()
    phase_train_step(torch, dev)
    seconds["train_step"] = time.perf_counter() - t0
    for name, fn in (("train_parity", lambda: phase_train_parity(torch,
                                                                  dev)),
                     ("train_cli", lambda: phase_train_cli(torch)),
                     ("train_convergence",
                      lambda: phase_train_convergence(torch))):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"phase": "training_seconds", **seconds})


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
    manager = make_manager(torch, model_dir, True)
    batch_position_invariance(torch, manager)
    full_manager = make_manager(torch, model_dir, True)
    launches = phase_main_path(torch, manager, full_manager)
    dense_manager = make_manager(torch, model_dir, True, geometry=DENSE)
    phase_main_path_dense(torch, dense_manager)
    phase_forward_profile(torch, [("windowed_full", full_manager, False),
                                  ("windowed_valid", manager, True),
                                  ("dense_valid", dense_manager, True)])
    del full_manager
    torch.cuda.empty_cache()
    serve_launches = phase_serving(torch, {"windowed": manager,
                                           "dense": dense_manager})
    del manager, dense_manager
    torch.cuda.empty_cache()
    wsi_launches = phase_wsi(torch, make_manager(torch, model_dir, True,
                                                 wsi=True))
    resident_run = phase_wsi_cli(torch)
    phase_wsi_cli(torch, ("--dense", "--batch_size=16"), "wsi_cli_dense")
    readers_work = os.path.join(cuda_build.BUILD_DIR, "smoke_readers")
    shutil.rmtree(readers_work, ignore_errors=True)
    try:
        svs_launches = phase_wsi_cli_svs(
            torch, phase_readers(torch, readers_work))
    finally:
        shutil.rmtree(readers_work, ignore_errors=True)
    legacy_run = phase_wsi_cli_legacy(torch, resident_run)
    phase_wsi_cli_cpu(torch, legacy_run)
    phase_training(torch, dev)

    kernels = []
    for name in cuda_build.LAUNCH_COUNTERS:
        source, replaces = sources[name]
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "wsi_launches": wsi_launches[name],
                        "wsi_cli_svs_launches": svs_launches[name],
                        "wsi_cli_legacy_launches":
                            legacy_run["launches"][name],
                        **{"%s_launches" % path: counts[name]
                           for path, counts in serve_launches.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "device_ms": row["device_ms"],
                        "device_ms_from": row["device_ms_from"],
                        "host_us": row["host_us"],
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
