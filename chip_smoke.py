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
     nuclei-like planes), and the tile records' per-instance tables
     (``inst_stats``) on gland, gated lumen and nuclei stacks of 1000^2
     and 1536^2, one launch a stack, with median
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

  11. dsf (after training; the DSF-CNN family, ``tests/_torch_dsf_helpers.py``
     models): ``dsf_forward``: dsf_cnn_{4,8,12} (five heads, coefficients
     x0.05, randomised BN statistics) at 64^2, batch 2, f32 with TF32 off,
     the card against the CPU within 1e-3; then a seeded dsf_cnn_8 model
     directory (coefficients x0.01, each INST head's logits standardised
     on a 448^2 window, synthetic biases) through ``dsf_main_path``: the
     main path's three images at 448->144, batch 10, bf16, full towers,
     launch counts reset just before and read just after, every kernel
     launched, instances in every family, every canvas finite, the
     families byte-equal to the plain ones; ``dsf_forward_profile``: one
     profiled batch (device ms, TFLOP/s); ``dsf_tile_cli`` and
     ``dsf_wsi_cli``: both CLIs' ``main`` on that model directory (the
     three images; the synthetic slide), launches counted the same way;
     ``dsf_train_step``: dsf_cnn_8 at 448^2, batch 12, bf16 (step ms,
     images/s, peak GiB; ``remat=True`` only if plain bf16 runs out of
     memory, and the line says so); ``dsf_train_parity``: dsf_cnn_4 at
     64^2, batch 2, the card against the CPU in float64 within 1e-8 /
     1e-6; ``dsf_seconds``.

  12. multi-GPU (after ``wsi_cli_cpu``, before training; one card, so
     meshes are virtual, ``[cuda:0] * k``, and both ranks of the
     two-process phases share it): ``mesh_infer``: the main path's model
     through ``make_sharded_infer_step`` on a 4-entry mesh at batch 10
     (padded to 12), byte-equal to the single-device step run on each
     3-window chunk, ms per batch beside the single-device step's;
     ``sharded_cc``: ``connected_components_sharded`` over 2, 4 and 8
     entries on the 1000^2 and 2560^2 foreground planes and the 1000^2
     spiral, byte-equal to one ``cc_label``, and ``watershed_sharded``
     (4 entries) on the 1000^2 and 2560^2 nuclei planes, byte-equal to
     the same function on CPU strips (the plain passes), with its rounds
     per level and the pixels where it differs from the single-device
     watershed; ``mesh_wsi``: the WSI CLI with ``--gpu=0,0,0,0
     --batch_size=4`` on the slide, gland and lumen payloads equal to
     the single-device legacy loop's at batch 1 (``wsi_cli_legacy``),
     nuclei counts and differing pixels printed; ``dp_train``: two gloo
     ranks, the data-parallel step in float64 (resnet18, 96^2, batch 4)
     against the single-device card step within ``train_parity``'s
     float64 tolerances, and the ResNet-34 448^2 batch-12 bf16 step's ms
     (printed); ``distributed_tiles``: two gloo ranks split the ten
     ``tile_cli_cache`` images (``shard_slides``) through the tile CLI's
     manager at batch 1, the union's ``.mat`` files equal to one
     process's; ``multi_gpu_seconds``.

  13. paired (after ``forward_profile``; the JAX package's TPU lowerings,
     off by default): ``paired_forward``: the forward check's ResNet-34 in
     f32 with TF32 off, the paired towers and paired front
     (``CERBERUS_PAIRED=1``'s forward) against the valid-region heads at
     448->144 batch 10 and 1168->864 batch 2 (each head within 2e-5 of
     its largest logit), the grouped bank against the full towers at
     448->144 batch 10 (1e-3); ``paired_main_path`` / ``fused_main_path``:
     the main path's images through managers bound with
     ``CERBERUS_PAIRED=1`` and ``fuse_decoders=True``, launch counts reset
     just before and read just after, the families against the plain
     ones, the bf16 canvases and label maps beside the plain and
     full-tower ones (printed), ``paired_dense_main_path`` the same at
     1168->864; ``paired_ab``: device ms a batch of the plain, paired and
     fused steps in three alternating turns, windowed (batch 10) and dense
     (batch 8), TFLOP/s on the plain convolutions' FLOPs (print only);
     ``paired_train``: the ResNet-34 448^2 batch-12 bf16 step paired and
     unpaired in turns (ms, GiB), and resnet18 96^2 float64 paired on the
     card against the CPU (1e-8 / 1e-6); ``paired_seconds``. Before
     ``main_path``, ``batch_position_invariance`` also compares the moved
     windows layer by layer (stem, encoder stages, ``conv_map``, one
     tower's levels, its head) in bf16, bf16 with cuDNN deterministic and
     f32 TF32-off deterministic, and names the first layer that differs.

The second-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without CUDA, or without the package beside this script, it exits 1 and
prints no result. It imports nothing of JAX or cerberus_tpu; cv2 and
PyYAML are imported only by the CLIs' host side (phases 6, 8, 9 and 10)
and the readers phase. The ``kernels`` line carries each kernel's
launches on every driven path, the paired ones
(``paired_main_path_launches``, ``fused_main_path_launches``), the DSF
ones (``dsf_main_path_launches``,
``dsf_tile_cli_launches``, ``dsf_wsi_cli_launches``) and the multi-GPU
ones (``mesh_wsi_launches``, ``sharded_cc_launches``; ``watershed`` is 0
there: the sharded paths flood with ``propagate_labels``) included.
"""
from __future__ import annotations

import contextlib
import hashlib
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
# the tile engine's kernel alone (the records' per-instance tables): no
# WSI path launches it
TILE_ONLY_KERNELS = ("inst_stats",)
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
    from cerberus_tpu_torch.ops.inst_stats import (
        REPLACES as IS_REPLACES, SOURCE as IS_SOURCE, inst_stats,
        inst_stats_plain)
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
    # the tile records' tables: a gland, lumen (gated by the glands) and
    # nuclei stack, typed by spatially coherent class planes, in one launch;
    # 1536^2 is the tile benchmark's largest region, 1000^2 the main path's
    for side, report in ((1000, False), (1536, True)):
        hw = (side, side)
        planes, n_ids = [], []
        for seed, (n, rmin, rmax) in enumerate(
                ((side * side // 160000, 60, 200),
                 (side * side // 40000, 10, 40),
                 (side * side // 620, 3, 9))):
            lab, n_lab = D.compact_labels(connected_components(
                torch.from_numpy(blob_prob(hw, n, 30 + seed, rmin, rmax)
                                 > 0.5).to(dev)))
            planes.append(lab)
            n_ids.append(n_lab)
        planes[1] = planes[1] * (planes[0] > 0)
        labels = torch.stack(planes).contiguous()
        types = torch.from_numpy(np.stack([
            np.minimum(np.floor(blob_prob(hw, 40, 40, 20, 120) * 3), 2),
            np.minimum(np.floor(blob_prob(hw, 900, 41, 5, 20) * 7), 6)
        ]).astype(np.int32)).to(dev)
        args = (labels, types, n_ids, [0, 0, 1], [3, 7])

        def flat(table):
            return torch.cat([table.ints.long(), table.sums])

        refs = []
        plain_ms = cuda_ms(lambda: refs.append(inst_stats_plain(*args)), 3)
        got = inst_stats(*args)
        # label planes and the type planes they use read once, tables
        # written once
        bytes_ = (labels.numel() * 4 + types.numel() * 4
                  + got.ints.numel() * 4 + got.sums.numel() * 8)
        check("inst_stats", "tile%d" % side, flat(got), flat(refs[-1]),
              kernel_times(lambda: inst_stats(*args), 50), plain_ms, None,
              bytes_, labels.numel(), report, {"n_ids": n_ids})
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
    sources = {"cc_label": (CC_SOURCE, CC_REPLACES),
               "hist16384": (H_SOURCE, H_REPLACES),
               "watershed": (WS_SOURCE, WS_REPLACES),
               "propagate_labels": (WS_SOURCE, WS_REPLACES),
               "inst_stats": (IS_SOURCE, IS_REPLACES)}
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
                 geometry=(448, 144, 10), **extra):
    """``write_model``'s model loaded through the tile ``InferManager``
    (``geometry``: input, output, batch; 448->144 at batch 10 by default),
    or with ``wsi`` the WSI one (batch 30, the WSI CLI's default);
    ``extra``: more constructor keywords (``fuse_decoders=True``). The
    step is bound at the first call, so ``CERBERUS_VALID_REGION`` and
    ``CERBERUS_PAIRED`` are read then."""
    from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
    from cerberus_tpu_torch.infer import tile, wsi as wsi_mod

    try:
        model_kwargs = write_model(torch, path, synthetic_heads)
        cls = wsi_mod.InferManager if wsi else tile.InferManager
        return cls(
            checkpoint_path=os.path.join(path, "weights.tar"),
            decoder_dict=dict(DEFAULT_TARGET_CODE), model_args=model_kwargs,
            device="cuda", batch_size=30 if wsi else geometry[2],
            patch_input_shape=geometry[0], patch_output_shape=geometry[1],
            **extra)
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


POSITION_DECODER = "Nuclei"  # the tower whose levels the probe reads


def layer_outputs(torch, model, x, out_sz):
    """The forward's (``infer/steps.head_outputs``) activations on NCHW
    ``x``, read by forward hooks, in the order the forward makes them: the
    stem convolution and its BN, each encoder stage, ``conv_map``, the
    last BN of each level of the ``POSITION_DECODER`` tower and its INST
    head's logits. Returns {name: tensor}."""
    from cerberus_tpu_torch.infer.steps import head_outputs

    bb = model.backbone
    tower = model.decoder_head[POSITION_DECODER]
    probes = [("stem_conv", bb.conv1), ("stem_bn", bb.bn1)]
    probes += [("layer%d" % s, getattr(bb, "layer%d" % s))
               for s in range(1, 5)]
    probes += [("conv_map", model.conv_map)]
    probes += [("tower_level%d" % i, blk.block[-1].bn)
               for i, blk in enumerate(tower)]
    probes += [("inst_head", model.output_head[POSITION_DECODER]["INST"])]
    got = {}
    hooks = [mod.register_forward_hook(
        lambda _m, _i, out, name=name: got.__setitem__(name, out))
        for name, mod in probes]
    try:
        head_outputs(model, x, out_sz)
    finally:
        for hook in hooks:
            hook.remove()
    return {name: got[name] for name, _ in probes}


def position_effect(torch, model, wins, out_sz, half) -> dict:
    """Windows ``half..n-1`` of ``wins[:n]`` against the same windows at
    positions ``0..n-half-1`` of ``wins[half:half + n]`` (the step line's
    comparison): each probed layer's largest difference and the first
    layer that differs."""
    n = len(wins) - half
    x = wins.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        first = layer_outputs(torch, model, x[:n], out_sz)
        moved = layer_outputs(torch, model, x[half:half + n], out_sz)
    diff = {name: float((first[name][half:].float()
                         - moved[name][:n - half].float()).abs().max())
            for name in first}
    differing = [name for name, d in diff.items() if d > 0]
    return {"max_abs_diff": diff,
            "first_differing": differing[0] if differing else None}


def batch_position_invariance(torch, manager) -> None:
    """Print only: the bf16 step (448->144, the manager's batch) on the same
    windows twice, on a batch whose tail rows are zeros, and on windows
    moved to other places among other windows: which of these give the
    same bits per window. Then the moved windows at their two batch
    positions, layer by layer (``position_effect``): the encoder's stages
    and one tower's levels in bf16 (autocast), in bf16 with cuDNN
    deterministic, and in f32 with TF32 off and cuDNN deterministic, each
    with the first layer that differs."""
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
    layers = {}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        layers["bf16"] = position_effect(torch, manager.model, wins, 144,
                                         half)
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            layers["bf16_deterministic"] = position_effect(
                torch, manager.model, wins, 144, half)
        with tf32_off(torch):
            layers["f32_tf32_off_deterministic"] = position_effect(
                torch, manager.model, wins, 144, half)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    emit({"phase": "batch_position_invariance", "batch": n, "hw": 448,
          "out": 144, "same_batch_equal": bool(torch.equal(first, again)),
          "zero_padded_tail_equal": bool(torch.equal(first[:half],
                                                     padded[:half])),
          "moved_equal": bool(diff.max() == 0),
          "moved_values_differing": float((diff > 0).float().mean()),
          "moved_max_abs": float(diff.max()),
          "moved_max_abs_per_channel": diff.amax(dim=(0, 1, 2)).tolist(),
          "windows_moved": n - half, "shift": half,
          "tower": POSITION_DECODER, "layers": layers})


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


def drive_images(torch, manager, images, tasks=("Gland", "Nuclei"),
                 pclass=True):
    """``process_image`` on each image (after a warm-up image), launch
    counts reset just before and read just after; each of ``tasks`` must
    give instances, and with ``pclass`` the Patch-Class map must be whole.
    Returns (results, seconds, ms per image, launches, instances per
    task)."""
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
    for img, (inst, types, pc) in zip(images, results):
        for task, lab in inst.items():
            if lab.shape != img.shape[:2]:
                raise AssertionError("%s label map has shape %s"
                                     % (task, lab.shape))
            instances.setdefault(task, []).append(len(np.unique(
                lab[lab > 0])))
        if pclass and (pc is None or pc.shape != img.shape[:2] or not (
                np.isfinite(pc).all() and 0 <= pc.min() and pc.max() <= 8)):
            raise AssertionError("patch-class map malformed")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("kernel %s was not launched on the main path"
                                 % name)
    for task in tasks:
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

    emit({"phase": "valid_vs_full_bf16",
          **canvas_diff(manager, valid_outs, full_outs)})
    return launches


def canvas_diff(manager, outs, ref_outs) -> dict:
    """Two forwards' per-image (canvas, label maps) side by side: the
    canvas's and the INST channels' largest difference, the share of TYPE
    and Patch-Class ids that differ, and each task's foreground IoU."""
    from cerberus_tpu_torch.data.patching import make_channel_index_map

    idx_dict, _ = make_channel_index_map(manager.cfg.active_decoder_kwargs)
    diff = {"canvas_max_abs": [], "inst_max_abs": [],
            "argmax_differ_share": {}, "fg_iou": {}}
    for (canvas_v, lab_v), (canvas_f, lab_f) in zip(outs, ref_outs):
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
    return diff


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


def phase_forward_profile(torch, managers, phase="forward_profile"):
    """``torch.profiler`` over one batch of the step on each forward path
    (windowed full towers, windowed valid-region, dense valid-region):
    device time, the top device operations by share, and the achieved
    TFLOP/s against the convolutions' FLOP count (``utils/flops.py``).
    Returns the line's paths."""
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
    emit({"phase": phase, "paths": paths, "peak_bf16_tflop_per_s": 989})
    for name, row in paths.items():
        if not row["device_ms"]:
            raise AssertionError("profiler saw no device time for %s" % name)
    return paths


PAIRED_HOLD = ((448, 144, 10), (1168, 864, 2))  # (a): in, out, batch
PAIRED_TOL = 2e-5  # paired vs valid heads, of each head's max |logit|
FUSED_TOL = 1e-3   # the bank vs the sequential full towers, scaled
PAIRED_AB = {"windowed": (448, 144, 10), "dense": (1168, 864, 8)}
PAIRED_AB_TURNS = 3
PAIRED_TRAIN_TURNS = (False, True, True, False)  # unpaired / paired


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set within the block, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def phase_paired_forward(torch, dev):
    """(a) and (b), f32 with TF32 off, the forward check's ResNet-34
    (randomised BN statistics): the paired towers and paired front
    (``paired_head_outputs``) against the unpaired valid-region heads at
    448->144 batch 10 and 1168->864 batch 2, each head within
    ``PAIRED_TOL`` of its largest |logit| (the JAX package's bar); the
    grouped bank (``fused_head_outputs``) against the sequential full
    towers at 448->144 batch 10 within ``FUSED_TOL``."""
    from cerberus_tpu_torch.infer.steps import pclass_cells
    from cerberus_tpu_torch.models.fused_decoder import (
        build_fused_decoder, fused_head_outputs)
    from cerberus_tpu_torch.models.paired_decode import (
        paired_head_outputs, supports_paired)
    from cerberus_tpu_torch.models.paired_encoder import use_paired_front
    from cerberus_tpu_torch.models.valid_decode import (
        supports_valid_region, valid_head_outputs)

    model, _ = random_model(torch, "resnet34", False)
    model.to(dev)
    holds = {}
    with tf32_off(torch), torch.no_grad():
        for in_sz, out_sz, batch in PAIRED_HOLD:
            x = torch.from_numpy(np.random.default_rng(7).integers(
                0, 256, (batch, in_sz, in_sz, 3)).astype(np.uint8)).to(
                    dev).permute(0, 3, 1, 2).float() / 255.0
            plan = supports_valid_region(model.cfg, in_sz, out_sz)
            cells = pclass_cells(in_sz, out_sz)
            ref = valid_head_outputs(model, x, plan, cells)
            got = paired_head_outputs(model, x, plan, cells)
            err = {h: float((got[h] - ref[h]).abs().max())
                   / float(ref[h].abs().max()) for h in ref}
            holds["%d_%d" % (in_sz, out_sz)] = {
                "batch": batch, "supports_paired": supports_paired(
                    plan, in_sz),
                "paired_front": use_paired_front(
                    model.cfg.encoder_backbone_name, in_sz, batch),
                "rel_err": err, "tol": PAIRED_TOL,
                "met": all(e < PAIRED_TOL for e in err.values())}
            del x, ref, got
        in_sz, out_sz, batch = PAIRED_HOLD[0]
        x = torch.from_numpy(np.random.default_rng(8).integers(
            0, 256, (batch, in_sz, in_sz, 3)).astype(np.uint8)).to(
                dev).permute(0, 3, 1, 2).float() / 255.0
        full = model(x)
        fused = fused_head_outputs(model, *build_fused_decoder(model), x)
        ferr = {h: rel_err(fused[h], full[h]) for h in full}
    fused_line = {"batch": batch, "rel_err": ferr, "tol": FUSED_TOL,
                  "met": all(e < FUSED_TOL for e in ferr.values())}
    emit({"phase": "paired_forward", "compute": "f32, TF32 off",
          "paired_vs_valid": holds, "fused_vs_full_towers": fused_line})
    del model
    torch.cuda.empty_cache()
    if not (all(h["met"] and h["supports_paired"] for h in holds.values())
            and fused_line["met"]):
        raise AssertionError("paired_forward: off tolerance")


def phase_paired_main_path(torch, model_dir, manager, full_manager,
                           dense_manager):
    """(c) The main path's three images through a manager bound under
    ``CERBERUS_PAIRED=1`` and through one with ``fuse_decoders=True``
    (bf16), launch counts reset just before and read just after each, the
    kernel families against the plain families on their canvases; their
    canvases and label maps beside the plain valid-region manager's and
    the full towers' (the bank runs full towers), printed only, as
    ``valid_vs_full_bf16``; then the same for ``CERBERUS_PAIRED=1`` at
    1168->864 (``DENSE``) beside ``dense_manager``. Returns the 448->144
    paths' launches."""
    images = main_path_images()
    _, valid_outs = split_times(torch, manager, images, plain=False)
    _, full_outs = split_times(torch, full_manager, images, plain=False)
    _, dense_outs = split_times(torch, dense_manager, images, plain=False)
    launches = {}
    for name, env, extra, ref_name, ref_outs in (
            ("paired", {"CERBERUS_PAIRED": "1"}, {}, "valid", valid_outs),
            ("fused", {}, {"fuse_decoders": True}, "full_towers",
             full_outs),
            ("paired_dense", {"CERBERUS_PAIRED": "1"}, {"geometry": DENSE},
             "valid", dense_outs)):
        with env_set(**env):
            run_manager = make_manager(torch, model_dir, True, **extra)
            _, seconds, ms, launches[name], instances = drive_images(
                torch, run_manager, images)
        split, outs = split_times(torch, run_manager, images, plain=True)
        line = path_numbers(run_manager, images, seconds, ms, instances,
                            launches[name])
        emit({"phase": "%s_main_path" % name, **line,
              "families_vs_plain": "byte_equal", **split,
              "vs_%s_bf16" % ref_name: canvas_diff(run_manager, outs,
                                                   ref_outs)})
        del run_manager
        torch.cuda.empty_cache()
    launches.pop("paired_dense")
    return launches


def phase_paired_ab(torch, manager):
    """(d) Print only: device ms a batch (``profile_step``, the
    ``forward_profile`` method) of the plain valid-region step, the paired
    step and the grouped bank, windowed (448->144, batch 10) and dense
    (1168->864, batch 8), in ``PAIRED_AB_TURNS`` alternating turns
    (plain, paired, fused, then reversed). TFLOP/s on the plain
    convolutions' FLOPs (``utils/flops.py``: valid-region towers for plain
    and paired, full towers for the bank), so the repacks' zero MACs
    count as lost time."""
    from cerberus_tpu_torch.infer.steps import make_infer_step
    from cerberus_tpu_torch.utils.flops import forward_flops

    model, cfg = manager.model, manager.cfg
    arms = ("plain", "paired", "fused")
    paths = {}
    for geo, (in_sz, out_sz, batch) in PAIRED_AB.items():
        imgs = torch.from_numpy(np.stack([
            synthetic_image((in_sz, in_sz), 60 + i) for i in range(batch)
        ])).to(manager.device)
        steps = {}
        for arm in arms:
            with env_set(CERBERUS_PAIRED="1" if arm == "paired" else "0"):
                steps[arm] = make_infer_step(
                    model, cfg, out_sz, torch.bfloat16, torch.float16,
                    fuse_decoders=arm == "fused")
            steps[arm](imgs)  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        device, wall, top = {a: [] for a in arms}, {a: [] for a in arms}, {}
        for turn in range(PAIRED_AB_TURNS):
            for arm in arms if turn % 2 == 0 else arms[::-1]:
                w_ms, d_ms, top[arm] = profile_step(
                    torch, lambda arm=arm: steps[arm](imgs))
                device[arm].append(d_ms)
                wall[arm].append(w_ms)
        rows = {}
        for arm in arms:
            flops = forward_flops(in_sz, out_sz, arm != "fused", cfg,
                                  batch)["flops"]
            med = statistics.median(device[arm])
            rows[arm] = {"device_ms": device[arm], "wall_ms": wall[arm],
                         "device_ms_median": med, "gflop": flops / 1e9,
                         "tflop_per_s_device": flops / (med * 1e-3) / 1e12,
                         "top_ops": top[arm]}
        plain = rows["plain"]["device_ms_median"]
        paths[geo] = {"patch": [in_sz, out_sz], "batch": batch, **rows,
                      "paired_over_plain": rows["paired"][
                          "device_ms_median"] / plain,
                      "fused_over_plain": rows["fused"][
                          "device_ms_median"] / plain}
        del steps, imgs
        torch.cuda.empty_cache()
    emit({"phase": "paired_ab", "compute": "bf16", "turns": PAIRED_AB_TURNS,
          "paths": paths, "peak_bf16_tflop_per_s": 989})
    for geo, row in paths.items():
        if not all(row[a]["device_ms_median"] > 0 for a in arms):
            raise AssertionError("paired_ab: no device time for %s" % geo)


def phase_paired_train(torch, dev):
    """(e) ``--paired`` training. ResNet-34, six heads, 448^2, batch 12,
    bf16 (``train_step_runs``), unpaired and paired in turns
    (``PAIRED_TRAIN_TURNS``): step ms, peak GiB, top operations. Then
    resnet18 at 96^2, batch 4, float64: the paired step on the card
    against the paired step on the CPU within ``train_parity``'s float64
    tolerances."""
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
    from cerberus_tpu_torch.train.utils import tame_head_logits

    helpers = train_helpers()
    kwargs = helpers.model_kwargs("resnet34")
    state = tame_head_logits(init_weights(
        NetDesc(ModelConfig.from_kwargs(kwargs)),
        torch.Generator().manual_seed(0)).state_dict())
    turns = {"unpaired": [], "paired": []}
    for paired in PAIRED_TRAIN_TURNS:
        runs, _ = train_step_runs(torch, dev, kwargs, state,
                                  (("bf16", True, False, 1),),
                                  "backbone.bn1.running_var", paired=paired)
        turns["paired" if paired else "unpaired"].append(runs["bf16"])
    p_kwargs, p_state, batch, keep = helpers.parity_case()
    card = helpers.step_on(dev, p_kwargs, p_state, batch, keep,
                           dtype=torch.float64, paired=True)
    cpu = helpers.step_on("cpu", p_kwargs, p_state, batch, keep,
                          dtype=torch.float64, paired=True)
    f64 = helpers.worst_errors(card, cpu)
    ok = (all(f64[k] <= v for k, v in helpers.PARITY_F64_TOLS.items())
          and f64["zero_grad"] <= 1)
    summary = {name: {"step_ms": [r["step_ms"] for r in runs],
                      "peak_gib": [r["peak_gib"] for r in runs],
                      "images_per_s": [r["images_per_s"] for r in runs],
                      "device_busy_share": [r["device_busy_share"]
                                            for r in runs],
                      "top_ops": runs[-1]["top_ops"]}
               for name, runs in turns.items()}
    emit({"phase": "paired_train", "model": "resnet34, six heads",
          "hw": TRAIN_HW, "batch": TRAIN_BATCH, "compute": "bf16",
          "turns": ["paired" if p else "unpaired"
                    for p in PAIRED_TRAIN_TURNS], **summary,
          "paired_over_unpaired": statistics.median(
              summary["paired"]["step_ms"]) / statistics.median(
                  summary["unpaired"]["step_ms"]),
          "parity_f64": {"setting": "resnet18, 96^2, batch 4, card vs CPU",
                         "errors": f64, "tolerances":
                             helpers.PARITY_F64_TOLS, "ok": ok}})
    if not ok:
        raise AssertionError("paired_train: the card's float64 paired step "
                             "disagrees with the CPU's")


def phase_paired(torch, dev, model_dir, manager, full_manager, dense_manager):
    """The width-paired and fused-bank phases, with their seconds.
    Returns the launches of ``paired_main_path`` and ``fused_main_path``."""
    seconds = {}
    t0 = time.perf_counter()
    phase_paired_forward(torch, dev)
    seconds["paired_forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = phase_paired_main_path(torch, model_dir, manager,
                                      full_manager, dense_manager)
    seconds["paired_main_path"] = time.perf_counter() - t0
    for name, fn in (("paired_ab", lambda: phase_paired_ab(torch, manager)),
                     ("paired_train", lambda: phase_paired_train(torch,
                                                                 dev))):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"phase": "paired_seconds", **seconds})
    return launches


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
        if count <= 0 and name not in TILE_ONLY_KERNELS:
            raise AssertionError("kernel %s was not launched on the WSI "
                                 "path" % name)
    if sum(instances["Nuclei_grid"]) <= 0 or instances["Gland"] <= 0:
        raise AssertionError("no nuclei or gland instances on the WSI path")
    return launches


def run_wsi_cli(torch, work, input_dir, extra_argv=(), env=None,
                write=None, gpu="0"):
    """``python -m cerberus_tpu_torch.run_infer_wsi`` as a user runs it (its
    ``main``, in this process) with ``--gpu=<gpu>`` on the slides in
    ``input_dir`` and the synthetic model, host side included (cv2
    contours and resizes, the ``.dat`` pickle, the tissue map), with
    ``extra_argv`` added and ``env`` set for the run. Launch counts are
    reset just before and read just after; the per-phase spans come from
    the per-slide log. ``write(path)`` writes the model directory (the
    synthetic ResNet-34 model by default). Returns a dict: ``dat`` (the one
    slide's payload), ``seconds``, ``spans``, ``launches``, ``argv``,
    ``pclass_classes``."""
    import glob
    import pickle
    import re

    from cerberus_tpu_torch import run_infer_wsi
    from cerberus_tpu_torch.ops import cuda_build

    if write is None:
        write_model(torch, os.path.join(work, "model"), True)
    else:
        write(os.path.join(work, "model"))
    argv = ["--gpu=%s" % gpu, "--model=%s/model" % work,
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


def check_cli_outputs(run, phase, hw=WSI_HW, kernels=True,
                      tasks=("Nuclei", "Gland"), pclass=True) -> None:
    """The checks every WSI CLI phase makes: the slide's dimensions, a
    tissue map of classes in [0, 9) (with ``pclass``), instances of each
    of ``tasks``, and (for the card's families) every kernel but the tile
    engine's launched."""
    dat, classes = run["dat"], run["pclass_classes"]
    if [int(v) for v in dat["proc_dimensions"]] != list(hw) or (
            pclass and not (classes and 0 <= min(classes)
                            and max(classes) <= 8)):
        raise AssertionError("%s: WSI CLI outputs malformed" % phase)
    if any(len(dat.get(task, {})) <= 0 for task in tasks):
        raise AssertionError("%s: no instances of one of %s"
                             % (phase, tasks))
    for name, count in run["launches"].items():
        if kernels and count <= 0 and name not in TILE_ONLY_KERNELS:
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
    beside ``wsi_cli``'s (counts, centroid matches; printed). Returns the
    batch-30 run and the batch-1 legacy run."""
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
    return run, one["legacy"]


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


def run_ranks(target, world, args, timeout_s):
    """``tests/_torch_ranks.run_ranks``: ``target(rank, world, *args)`` in
    ``world`` gloo processes (kept for the next call), results in rank
    order; a failed or late rank fails the call."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_ranks

    return _torch_ranks.run_ranks(target, world, args, timeout_s)


def close_ranks():
    """End the processes ``run_ranks`` started."""
    if "_torch_ranks" in sys.modules:
        sys.modules["_torch_ranks"].close_pools()


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
    with ``grad_accum=4`` (``train_step_runs``)."""
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
    from cerberus_tpu_torch.train.utils import tame_head_logits

    kwargs = train_helpers().model_kwargs("resnet34")
    state = tame_head_logits(init_weights(
        NetDesc(ModelConfig.from_kwargs(kwargs)),
        torch.Generator().manual_seed(0)).state_dict())
    runs, step_flops = train_step_runs(torch, dev, kwargs, state, TRAIN_RUNS,
                                       "backbone.bn1.running_var")
    emit({"phase": "train_step", "model": "resnet34, six heads",
          "hw": TRAIN_HW, "batch": TRAIN_BATCH,
          "model_gflop_per_step": step_flops / 1e9,
          "peak_bf16_dense_tflop_per_s": 989, "runs": runs})
    return runs


def train_step_runs(torch, dev, kwargs, state, runs_spec, bn_key,
                    paired=False):
    """Training of the model ``kwargs`` from ``state`` at 448^2, batch 12,
    on ``make_batch``'s synthetic batch, once per ``(name, bf16, remat,
    grad_accum)`` of ``runs_spec``. Per run: median step ms of 10 steps
    after 3 warm-up ones (the host batch copied in through pinned memory
    each step, the loss read back), images/s, peak GiB, the profiled
    step's device-busy share and top five device operations, and model
    TFLOP/s (3x the full-tower forward FLOPs of ``utils/flops.py``) as a
    share of the card's dense bf16 peak. Every loss must be finite and the
    BN statistics ``bn_key`` must move. ``paired``: the width-paired
    training forward (its zero MACs not counted as work). Returns (runs,
    step FLOPs)."""
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc
    from cerberus_tpu_torch.train.steps import make_train_step
    from cerberus_tpu_torch.utils.flops import forward_flops

    helpers = train_helpers()
    cfg = ModelConfig.from_kwargs(kwargs)
    batch = helpers.make_batch(np.random.default_rng(0), n=TRAIN_BATCH,
                               hw=TRAIN_HW, cfg=cfg)
    step_flops = 3 * forward_flops(TRAIN_HW, TRAIN_HW, False, cfg,
                                   TRAIN_BATCH)["flops"]
    runs = {}
    for name, bf16, remat, accum in runs_spec:
        model = NetDesc(cfg)
        model.load_state_dict(state)
        model.to(dev)
        step = make_train_step(
            cfg, helpers.LOSS_KWARGS, {"lr": 1e-3},
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=remat, grad_accum=accum, model=model, paired=paired)
        gen = torch.Generator(device=dev).manual_seed(1)
        stats0 = model.state_dict()[bn_key].clone()
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
        moved = not torch.equal(model.state_dict()[bn_key], stats0)
        del model, step
        torch.cuda.empty_cache()
        if not (all(np.isfinite(losses)) and moved and dev_ms > 0):
            raise AssertionError("train_step %s: losses %s, BN moved %s"
                                 % (name, losses, moved))
    return runs, step_flops


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


DSF_ARCHS = ("dsf_cnn_4", "dsf_cnn_8", "dsf_cnn_12")
DSF_ARCH = "dsf_cnn_8"  # the served and trained DSF model
DSF_FORWARD = (64, 2)  # dsf_forward: side and batch of the f32 check


def dsf_helpers():
    """``tests/_torch_dsf_helpers.py``: seeded random DSF NetDescs and the
    synthetic INST recipe."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_dsf_helpers

    return _torch_dsf_helpers


def write_dsf_model(torch, path, dev):
    """A seeded random dsf_cnn_8 NetDesc with the five heads a DSF encoder
    serves, written as a model directory: G-conv coefficients x0.01
    (``GSCALE_SERVED``), default BN statistics, and each INST head's last
    conv rewritten so that its logits on a 448^2 synthetic window
    (computed on the card, f32) have the synthetic means and spread
    (``synthetic_inst_heads``). Returns (model kwargs, target codes)."""
    from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE

    helpers = dsf_helpers()
    model, kwargs = helpers.dsf_model(DSF_ARCH, seed=0,
                                      gscale=helpers.GSCALE_SERVED,
                                      random_bn=False)
    x = torch.from_numpy(synthetic_image((448, 448), 7)).permute(
        2, 0, 1)[None].float().div(255.0).to(dev)
    with tf32_off(torch):
        helpers.synthetic_inst_heads(model.to(dev), x)
    os.makedirs(path, exist_ok=True)
    torch.save({"desc": {k: v.cpu() for k, v in model.state_dict().items()}},
               os.path.join(path, "weights.tar"))
    codes = {k: v for k, v in DEFAULT_TARGET_CODE.items()
             if k != "Patch-Class"}
    with open(os.path.join(path, "settings.yml"), "w") as handle:
        json.dump({"dataset_kwargs": {"req_target_code": codes},
                   "model_kwargs": kwargs}, handle)
    del model
    torch.cuda.empty_cache()
    return kwargs, codes


def phase_dsf_forward(torch, dev):
    """dsf_cnn_{4,8,12} (the five heads, ``tests/test_dsf_cnn.py``'s
    recipe: coefficients x0.05, randomised BN statistics) at 64^2, batch
    2, f32 with TF32 off: the card's heads against the CPU's within
    ``FWD_REL_TOL`` of each head's largest magnitude."""
    import copy

    helpers = dsf_helpers()
    hw, batch = DSF_FORWARD
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (batch, 3, hw, hw)).astype(np.float32) / 255.0)
    errs, magnitude = {}, {}
    for arch in DSF_ARCHS:
        model, _ = helpers.dsf_model(arch)
        with tf32_off(torch), torch.no_grad():
            cpu = model(x)
            card = {k: v.cpu() for k, v in copy.deepcopy(model).to(dev)(
                x.to(dev)).items()}
        errs[arch], magnitude[arch] = {}, {}
        for head, ref in cpu.items():
            got = card[head]
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError("dsf_forward %s %s malformed"
                                     % (arch, head))
            errs[arch][head] = rel_err(got, ref)
            magnitude[arch][head] = float(ref.abs().max())
        del model
        torch.cuda.empty_cache()
    emit({"phase": "dsf_forward", "hw": hw, "batch": batch,
          "compute": "f32, TF32 off", "rel_err": errs,
          "max_abs_logit": magnitude, "tol": FWD_REL_TOL})
    bad = [(a, h, e) for a, per in errs.items() for h, e in per.items()
           if not e <= FWD_REL_TOL]
    if bad:
        raise AssertionError("dsf_forward off tolerance: %s" % bad)


def phase_dsf_main_path(torch, manager):
    """The tile main path with the DSF model (448->144, batch 10, bf16,
    full towers: DSF has no valid-region plan) on the main path's three
    images through ``process_image``, launch counts reset just before and
    read just after: every kernel launched, instances in every family;
    then the kernel families against the plain families on the same
    device canvases byte for byte, every canvas finite."""
    images = main_path_images()
    _, seconds, per_image_ms, launches, instances = drive_images(
        torch, manager, images, tasks=("Gland", "Lumen", "Nuclei"),
        pclass=False)
    line = path_numbers(manager, images, seconds, per_image_ms, instances,
                        launches)
    split, outs = split_times(torch, manager, images, plain=True)
    finite = [bool(torch.isfinite(canvas).all()) for canvas, _ in outs]
    emit({"phase": "dsf_main_path", "arch": DSF_ARCH, "valid_region": False,
          **line, "tiles_448": line["windows"],
          "tiles_per_s": line["windows_per_s"],
          "families_vs_plain": "byte_equal", "canvases_finite": finite,
          **split})
    if not all(finite):
        raise AssertionError("dsf_main_path: a canvas holds NaN or Inf")
    return launches


def phase_dsf_tile_cli(torch, model_dir):
    """The tile CLI's ``main`` (``--gpu=0``, batch 10) on the DSF model
    directory and the main path's three images written as PNGs: seconds,
    output Mpx/s, every kernel launched, and ``.mat`` files with instances
    of every family (no Patch-Class map: a DSF net has no such head)."""
    import cv2

    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_dsf_tile")
    shutil.rmtree(work, ignore_errors=True)
    try:
        images = {"main%d" % i: img
                  for i, img in enumerate(main_path_images())}
        os.makedirs(os.path.join(work, "input"))
        for name, img in images.items():
            cv2.imwrite(os.path.join(work, "input", name + ".png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        out = os.path.join(work, "out")
        seconds, launches = run_tile_cli(torch, [
            "--model=%s" % model_dir,
            "--input_dir=%s" % os.path.join(work, "input"),
            "--output_dir=%s" % out, "--batch_size=10"])
        import scipy.io as sio

        instances = {task: [int(len(np.unique(sio.loadmat(os.path.join(
            out, "%s_mat" % task, name + ".mat"))["inst_map"])) - 1)
            for name in images] for task in ("gland", "lumen", "nuclei")}
        pclass_written = os.path.exists(os.path.join(out, "pclass_mat"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    px = sum(img.shape[0] * img.shape[1] for img in images.values())
    emit({"phase": "dsf_tile_cli", "arch": DSF_ARCH, "batch": 10,
          "images": [list(i.shape[:2]) for i in images.values()],
          "seconds": seconds, "output_mpx_per_s": px / seconds / 1e6,
          "instances": instances, "pclass_mat_written": pclass_written,
          "launches": launches})
    check_launches("dsf_tile_cli", launches)
    if pclass_written or not all(sum(v) > 0 for v in instances.values()):
        raise AssertionError("dsf_tile_cli: outputs malformed")
    return launches


def phase_dsf_wsi_cli(torch, model_dir):
    """The WSI CLI's ``main`` (``--gpu=0``, resident loop, batch 30) on the
    wsi phase's synthetic slide with the DSF model directory."""
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_dsf_wsi")
    shutil.rmtree(work, ignore_errors=True)
    try:
        write_slide(os.path.join(work, "input", "slide"))
        run = run_wsi_cli(torch, work, os.path.join(work, "input"),
                          ("--wsi_file_ext=.npy",),
                          write=lambda path: shutil.copytree(model_dir,
                                                             path))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit_cli("dsf_wsi_cli", run, arch=DSF_ARCH)
    check_cli_outputs(run, "dsf_wsi_cli", tasks=TASKS, pclass=False)
    return run["launches"]


def phase_dsf_train_step(torch, dev):
    """dsf_cnn_8 (the five heads, coefficients x0.01, heads tamed) training
    at 448^2, batch 12, bf16 (``train_step_runs``). Should that run out of
    memory, the line says so and the run is repeated with
    ``remat=True``."""
    from cerberus_tpu_torch.train.utils import tame_head_logits

    helpers = dsf_helpers()
    model, kwargs = helpers.dsf_model(DSF_ARCH, seed=0,
                                      gscale=helpers.GSCALE_SERVED,
                                      random_bn=False)
    state = tame_head_logits(model.state_dict())
    bn_key = "backbone.d1.units.0.norm1.norm.running_var"
    setting, oom = "bf16", None
    try:
        runs, step_flops = train_step_runs(
            torch, dev, kwargs, state, (("bf16", True, False, 1),), bn_key)
    except torch.cuda.OutOfMemoryError as exc:
        torch.cuda.empty_cache()
        setting, oom = "bf16_remat", str(exc).splitlines()[0]
        runs, step_flops = train_step_runs(
            torch, dev, kwargs, state, (("bf16_remat", True, True, 1),),
            bn_key)
    emit({"phase": "dsf_train_step", "model": "%s, five heads" % DSF_ARCH,
          "hw": TRAIN_HW, "batch": TRAIN_BATCH, "setting": setting,
          "plain_bf16_out_of_memory": oom,
          "model_gflop_per_step": step_flops / 1e9,
          "peak_bf16_dense_tflop_per_s": 989, "runs": runs})


def phase_dsf_train_parity(torch, dev):
    """The dsf_cnn_4 train step (the five heads, coefficients x0.05,
    randomised BN statistics, heads tamed) on the card against the CPU's
    (``tests/_torch_train_helpers.card_parity``) at 64^2, batch 2, TF32
    off: float64 within 1e-8 (loss, BN statistics) and 1e-6 of each
    gradient tensor's largest magnitude; f32 loss and BN statistics within
    1e-4."""
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.train.utils import tame_head_logits

    helpers, dsf = train_helpers(), dsf_helpers()
    model, kwargs = dsf.dsf_model("dsf_cnn_4")
    state = tame_head_logits(model.state_dict())
    batch = helpers.make_batch(np.random.default_rng(0), n=2, hw=64,
                               cfg=ModelConfig.from_kwargs(kwargs))
    keep = torch.ones((2, 1, 1, 1), dtype=torch.bool)  # no Patch-Class
    with tf32_off(torch):
        report = helpers.card_parity(dev, kwargs, state, batch, keep)
    report.pop("card_f32")
    emit({"phase": "dsf_train_parity", "setting": "dsf_cnn_4, five heads, "
          "64^2, batch 2, TF32 off", "tolerances": {
              "f64": helpers.PARITY_F64_TOLS,
              "f32_loss_rel": helpers.PARITY_LOSS_TOL,
              "f32_bn_rel": helpers.PARITY_BN_TOL}, **report})
    if not report["ok"]:
        raise AssertionError("dsf_train_parity: the card's step disagrees "
                             "with the CPU's")


def phase_dsf(torch, dev):
    """The DSF-CNN phases, with their seconds: ``dsf_forward``, then the
    served dsf_cnn_8 model directory through ``dsf_main_path`` (and one
    profiled batch, ``dsf_forward_profile``), ``dsf_tile_cli`` and
    ``dsf_wsi_cli``, then ``dsf_train_step`` and ``dsf_train_parity``.
    Returns the launches of the main path and both CLIs."""
    from cerberus_tpu_torch.infer import tile
    from cerberus_tpu_torch.ops import cuda_build

    seconds = {}
    t0 = time.perf_counter()
    phase_dsf_forward(torch, dev)
    seconds["dsf_forward"] = time.perf_counter() - t0
    work = os.path.join(cuda_build.BUILD_DIR, "smoke_dsf_model")
    shutil.rmtree(work, ignore_errors=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        kwargs, codes = write_dsf_model(torch, work, dev)
        seconds["write_model"] = time.perf_counter() - t0
        manager = tile.InferManager(
            checkpoint_path=os.path.join(work, "weights.tar"),
            decoder_dict=codes, model_args=kwargs, device="cuda",
            batch_size=10,
            patch_input_shape=448, patch_output_shape=144)
        t0 = time.perf_counter()
        launches["dsf_main_path"] = phase_dsf_main_path(torch, manager)
        phase_forward_profile(torch, [("dsf_cnn_8_windowed_full", manager,
                                       False)], "dsf_forward_profile")
        seconds["dsf_main_path"] = time.perf_counter() - t0
        del manager
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches["dsf_tile_cli"] = phase_dsf_tile_cli(torch, work)
        seconds["dsf_tile_cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches["dsf_wsi_cli"] = phase_dsf_wsi_cli(torch, work)
        seconds["dsf_wsi_cli"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    for name, fn in (("dsf_train_step",
                      lambda: phase_dsf_train_step(torch, dev)),
                     ("dsf_train_parity",
                      lambda: phase_dsf_train_parity(torch, dev))):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"phase": "dsf_seconds", **seconds})
    return launches


# ---------------------------------------------------------------------------
# multi-GPU (ROADMAP queue 1 item 7): one card, so meshes are virtual
# ([cuda:0] * k) and the two-process phases put both ranks on cuda:0 (gloo)
# ---------------------------------------------------------------------------

MESH_SIZES = (2, 4, 8)
MESH_INFER = (4, 10)  # mesh_infer: virtual mesh entries, batch (padded to 12)
MESH_WSI_ENTRIES = 4  # mesh_wsi: --gpu=0,0,0,0 --batch_size=4
MESH_WSI_TILE_ROWS = 2560  # a WSI_TILE nuclei tile after pad_to_512
RANKS = 2
DP_TIMED = (1, 3)  # dp_train bf16: warm-up steps, timed steps


def counted(torch, launches, fn):
    """``fn()``, adding the kernel launches it makes to ``launches``."""
    from cerberus_tpu_torch.ops import cuda_build

    before = dict(cuda_build.launch_counts)
    out = fn()
    torch.cuda.synchronize()
    for name, count in cuda_build.launch_counts.items():
        launches[name] = launches.get(name, 0) + count - before[name]
    return out


def phase_mesh_infer(torch, manager):
    """The main path's model (ResNet-34, 448->144, bf16) through
    ``make_sharded_infer_step`` on a 4-entry virtual mesh of the card:
    a batch of 10 windows, zero-padded to 12, one chunk of 3 a replica.
    Byte-equal to the single-device step run on each 3-window chunk (the
    card's forward is exact for a given batch, not across batch sizes);
    ms per batch beside the single-device step's at batch 10. The tile
    manager with that mesh (``InferManager(mesh=...)``) gives the same
    canvas as the sharded step chunk by chunk."""
    from cerberus_tpu_torch.infer.steps import make_infer_step
    from cerberus_tpu_torch.infer.tile import InferManager
    from cerberus_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_infer_step)

    dev = manager.device
    entries, n = MESH_INFER
    mesh = make_mesh([dev] * entries)
    args = (manager.cfg, 144, manager.compute_dtype, manager.out_dtype)
    sharded = make_sharded_infer_step(manager.model, args[0], mesh, *args[1:])
    single = make_infer_step(manager.model, *args)
    img = main_path_images()[1]
    rng = np.random.default_rng(5)
    tls = rng.integers(0, img.shape[0] - 448, (n, 2))
    batch = torch.from_numpy(np.stack([img[y:y + 448, x:x + 448]
                                       for y, x in tls])).to(dev)
    out = sharded(batch)
    chunk = -(-n // entries)
    padded = torch.cat([batch, batch.new_zeros((chunk * entries - n,
                                                *batch.shape[1:]))])
    ref = torch.cat([single(padded[i * chunk:(i + 1) * chunk])
                     for i in range(entries)])[:n]
    equal = out.shape == ref.shape and torch.equal(out, ref)
    ms_mesh = cuda_ms(lambda: sharded(batch), 10)
    ms_single = cuda_ms(lambda: single(batch), 10)
    mesh_manager = InferManager(
        decoder_dict=manager.decoder_dict, model_args=manager.model_args,
        device=None, mesh=mesh, batch_size=chunk * entries,
        patch_input_shape=448, patch_output_shape=144)
    mesh_manager.model.load_state_dict(manager.model.state_dict())
    canvas_equal = torch.equal(mesh_manager.run_step(padded, 144)[:n], ref)
    emit({"phase": "mesh_infer", "mesh": "[cuda:0] * %d" % entries,
          "batch": n, "padded_to": chunk * entries,
          "equal_to_single_device_chunks": equal,
          "manager_equal": canvas_equal,
          "ms_per_batch_mesh": ms_mesh, "ms_per_batch_single": ms_single})
    if not (equal and canvas_equal):
        raise AssertionError("mesh_infer: the sharded step differs from the "
                             "single-device step run chunk by chunk")


def phase_sharded_cc(torch, dev):
    """``ops/sharded_cc`` on virtual meshes of the card: the row-sharded CC
    over 2, 4 and 8 entries on the kernels phase's 1000^2 and 2560^2
    planes and the 1000^2 spiral, each byte-equal to one ``cc_label``;
    the sharded watershed (4 entries) on the 1000^2 and 2560^2 nuclei
    planes, byte-equal to the same function on CPU copies of the strips
    (the plain passes), with the pixels where it differs from the
    single-device ``watershed`` (plateau ties at strip boundaries, JAX's
    sharded behaviour), the rounds per level and the launches. Launches
    are counted over the sharded calls only. Returns them."""
    from cerberus_tpu_torch.ops import sharded_cc as S
    from cerberus_tpu_torch.ops.cc_label import connected_components
    from cerberus_tpu_torch.ops.watershed import watershed
    from cerberus_tpu_torch.parallel.mesh import make_mesh

    launches = {}
    cases = [("fg1000", blob_prob((1000, 1000), 1600, 2, 3, 12) > 0.5),
             ("spiral1000", spiral(1000)),
             ("fg2560", blob_prob((2560, 2560), 10500, 6, 3, 12) > 0.5)]
    rows = []
    for case, mask in cases:
        mask = torch.from_numpy(mask).to(dev)
        ref = connected_components(mask)
        for k in MESH_SIZES:
            mesh = make_mesh([dev] * k)
            got = counted(torch, launches,
                          lambda: S.connected_components_sharded(mask, mesh))
            rows.append({"case": case, "entries": k,
                         "equal": bool(torch.equal(got, ref)),
                         "ms": cuda_ms(lambda: S.connected_components_sharded(
                             mask, mesh), 3),
                         "single_ms": cuda_ms(
                             lambda: connected_components(mask), 3)})
    ws_rows = []
    cpu_mesh = make_mesh(["cpu"] * 4)
    mesh = make_mesh([dev] * 4)
    for case, hw, seed in (("nuclei1000", (1000, 1000), 4),
                           ("nuclei2560", (2560, 2560), 7)):
        prob = blob_prob(hw, 1600 if hw[0] == 1000 else 10500, seed, 3, 9)
        image = torch.from_numpy(-prob).to(dev)
        markers = connected_components(torch.from_numpy(prob > 0.6).to(dev))
        wmask = torch.from_numpy(prob > 0.1).to(dev)
        rounds = []
        t0 = time.perf_counter()
        got = counted(torch, launches,
                      lambda: S.watershed_sharded(image, markers, wmask,
                                                  mesh, rounds=rounds))
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = S.watershed_sharded(image.cpu(), markers.cpu(), wmask.cpu(),
                                    cpu_mesh)
        plain_s = time.perf_counter() - t0
        single = watershed(image, markers, wmask)
        ws_rows.append({
            "case": case, "entries": 4,
            "equal_to_plain_strips": bool(torch.equal(got.cpu(), plain)),
            "pixels_differing_from_single_device": int((got != single).sum()),
            "foreground_px": int((got > 0).sum()),
            "levels_flooded": len(rounds), "rounds_total": sum(rounds),
            "rounds_max": max(rounds, default=0), "rounds_per_level": rounds,
            "seconds": seconds, "plain_strips_seconds": plain_s})
    emit({"phase": "sharded_cc", "cc": rows, "watershed": ws_rows,
          "launches": launches})
    if not all(r["equal"] for r in rows) or not all(
            r["equal_to_plain_strips"] for r in ws_rows):
        raise AssertionError("sharded_cc: a sharded result differs")
    for name in ("cc_label", "propagate_labels"):
        if launches.get(name, 0) <= 0:
            raise AssertionError("sharded_cc: %s was not launched" % name)
    return launches


@contextlib.contextmanager
def recording_families(torch, taken):
    """Record, as CPU copies, the first nuclei tile of at least
    ``MESH_WSI_TILE_ROWS`` rows that reaches ``sharded_nuclei_watershed``
    and the largest plane of each (thresh, min_size, ksize) that reaches
    ``sharded_contour_instances``, in ``taken``: {name: (args, kwargs)}
    without the mesh and the impl."""
    from cerberus_tpu_torch.ops import sharded_cc as S

    saved = S.sharded_nuclei_watershed, S.sharded_contour_instances

    def nuclei(inner, cnt, mesh, impl=S.KERNELS):
        if "nuclei" not in taken and inner.shape[0] >= MESH_WSI_TILE_ROWS:
            taken["nuclei"] = ((inner.cpu(), cnt.cpu()), {})
        return saved[0](inner, cnt, mesh, impl)

    def contour(inner, cnt, thresh, min_size, ksize, mesh, impl=S.KERNELS):
        key = "contour_t%g_m%d_k%d" % (thresh, min_size, ksize)
        if key not in taken or taken[key][0][0].numel() < inner.numel():
            taken[key] = ((inner.cpu(), cnt.cpu(), thresh, min_size,
                           ksize), {})
        return saved[1](inner, cnt, thresh, min_size, ksize, mesh, impl)

    S.sharded_nuclei_watershed, S.sharded_contour_instances = nuclei, contour
    try:
        yield taken
    finally:
        S.sharded_nuclei_watershed, S.sharded_contour_instances = saved


def hold_sharded_families(torch, dev, taken):
    """Each recorded family call of the mesh WSI run once more on the
    card's kernels over ``[cuda:0] * 4`` and with the plain passes over a
    CPU mesh of 4: byte-equal. The eroded family runs on the largest
    gland region's inner channel (its gland sizes; on the nuclei tile its
    plain passes take ~90 s of the CPU). The nuclei tile also runs
    through the single-device family: the pixels where the two differ
    are the sharded watershed's plateau ties, printed with the share of
    them within 16 rows of a strip boundary."""
    from cerberus_tpu_torch.ops import gpu_postproc, sharded_cc as S
    from cerberus_tpu_torch.ops.device_postproc import KERNELS, PLAIN
    from cerberus_tpu_torch.parallel.mesh import make_mesh

    if "nuclei" not in taken:
        raise AssertionError("mesh_wsi: no nuclei tile of %d rows reached "
                             "the sharded family" % MESH_WSI_TILE_ROWS)
    inner, cnt = taken["nuclei"][0]
    gland = max((k for k in taken if k.startswith("contour_t0.55")),
                key=lambda k: taken[k][0][0].numel())
    calls = dict(taken, eroded_gland=((taken[gland][0][0], 0.5, 1500, 11),
                                      {}))
    fns = {"nuclei": S.sharded_nuclei_watershed,
           "eroded_gland": S.sharded_eroded_instances}
    mesh = make_mesh([dev] * MESH_WSI_ENTRIES)
    cpu_mesh = make_mesh(["cpu"] * MESH_WSI_ENTRIES)
    rows = []
    for name, (args, _) in sorted(calls.items()):
        fn = fns.get(name, S.sharded_contour_instances)
        card_args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        t0 = time.perf_counter()
        got = fn(*card_args, mesh, KERNELS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = fn(*args, cpu_mesh, PLAIN)
        plain_s = time.perf_counter() - t0
        row = {"family": name, "shape": list(args[0].shape),
               "equal_to_plain_cpu_mesh": bool(torch.equal(got.cpu(), plain)),
               "instances": int(torch.unique(got[got > 0]).numel()),
               "seconds": seconds,
               "plain_seconds": plain_s}
        if name == "nuclei":
            single = gpu_postproc._nuclei_watershed(
                inner.to(dev).contiguous(), cnt.to(dev).contiguous(),
                KERNELS).cpu()
            ties = (got.cpu() != single).nonzero()[:, 0].numpy()
            edges = np.array([r1 for _, r1 in S._strip_bounds(
                S._pad_rows(inner, MESH_WSI_ENTRIES)[0].shape[0],
                MESH_WSI_ENTRIES)][:-1])
            near = (np.abs(ties[:, None] - edges[None]).min(1) < 16
                    if len(ties) else np.zeros(0, bool))
            row.update(foreground_px=int((single > 0).sum()),
                       pixels_differing_from_single_device=int(len(ties)),
                       share_within_16_rows_of_a_strip_edge=(
                           float(near.mean()) if len(ties) else None))
        rows.append(row)
    return rows


def phase_mesh_wsi(torch, dev, legacy_one):
    """The WSI CLI with ``--gpu=0,0,0,0`` (a 4-entry virtual mesh: each
    batch of 4 split one window a replica; the legacy loop, and the
    nuclei tiles and tissue regions through the row-sharded families) on
    the wsi phase's slide, ``gpu`` backend. Its gland and lumen payloads
    equal the single-device legacy loop's at batch 1 (``legacy_one``) by
    content; the nuclei counts are printed beside it with the pixels
    where the two runs' filled nuclei differ (the sharded watershed's
    plateau ties). ``cc_label``, ``hist16384`` and ``propagate_labels``
    must launch; ``watershed`` does not run on the sharded path. The
    family calls of a 2560-row nuclei tile and of the largest gland and
    lumen regions are then held against the plain passes on a CPU mesh
    (``hold_sharded_families``). Returns the launches."""
    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_mesh_wsi")
    shutil.rmtree(work, ignore_errors=True)
    taken = {}
    try:
        write_slide(os.path.join(work, "input", "slide"))
        with recording_families(torch, taken):
            run = run_wsi_cli(
                torch, work, os.path.join(work, "input"),
                ("--wsi_file_ext=.npy", "--postproc_backend=gpu",
                 "--batch_size=%d" % MESH_WSI_ENTRIES),
                gpu=",".join(["0"] * MESH_WSI_ENTRIES))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    families = hold_sharded_families(torch, dev, taken)
    dat, ref = run["dat"], legacy_one["dat"]
    equal = {t: payload({t: dat[t]}) == payload({t: ref[t]})
             for t in ("Gland", "Lumen")}
    ties = int((foreground(dat["Nuclei"], WSI_HW)
                != foreground(ref["Nuclei"], WSI_HW)).sum())
    emit_cli("mesh_wsi", run, gland_lumen_equal_to_legacy_batch1=equal,
             nuclei_instances_mesh_single=[len(dat["Nuclei"]),
                                           len(ref["Nuclei"])],
             nuclei_pixels_differing=ties,
             nuclei_centroid_match_3px=centroid_match(dat["Nuclei"],
                                                      ref["Nuclei"]),
             families_against_plain=families)
    check_cli_outputs(run, "mesh_wsi", kernels=False)
    if not all(row["equal_to_plain_cpu_mesh"] for row in families):
        raise AssertionError("mesh_wsi: a sharded family on the card "
                             "differs from its plain passes")
    if "Legacy Read Time" not in run["spans"]:
        raise AssertionError("mesh_wsi: the legacy loop did not run")
    if not all(equal.values()):
        raise AssertionError("mesh_wsi: gland/lumen differ from the "
                             "single-device legacy loop at batch 1")
    for name in ("cc_label", "hist16384", "propagate_labels"):
        if run["launches"][name] <= 0:
            raise AssertionError("mesh_wsi: %s was not launched" % name)
    return run["launches"]


def dp_rank(rank, world, kwargs, state, batch, keep):
    """One rank of ``dp_train`` (gloo on the card): the float64
    data-parallel step (resnet18, 96^2, batch 4) from ``state``, then the
    ResNet-34 448^2 batch-12 bf16 step timed. Returns (metrics, gradients
    and state after as numpy on rank 0, a digest of the state after, ms per
    bf16 step)."""
    import torch

    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
    from cerberus_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_train_step)

    helpers = train_helpers()
    mesh = make_mesh(group="world")
    dev = mesh.local_device
    cfg = ModelConfig.from_kwargs(kwargs)
    model = NetDesc(cfg)
    model.load_state_dict(state)
    model.to(dev, torch.float64)
    step = make_sharded_train_step(cfg, mesh,
                                   helpers.LOSS_KWARGS_CLASS_WEIGHTS,
                                   {"lr": 1e-3}, return_grads=True,
                                   model=model)
    with tf32_off(torch):
        metrics, grads = step(batch, keep=keep.to(dev))
    state_after = {k: v.detach().cpu().numpy()
                   for k, v in model.state_dict().items()}
    digest = hashlib.sha256(b"".join(state_after[k].tobytes()
                                     for k in sorted(state_after)))
    # rank 0 sends the tensors, every rank a digest of its state
    f64 = ({k: float(v) for k, v in metrics.items()},
           {k: v.cpu().numpy() for k, v in grads.items()} if rank == 0
           else None, state_after if rank == 0 else None,
           digest.hexdigest())
    del step, model, grads
    big_kwargs = helpers.model_kwargs("resnet34")
    big_cfg = ModelConfig.from_kwargs(big_kwargs)
    model = init_weights(NetDesc(big_cfg), torch.Generator().manual_seed(0))
    step = make_sharded_train_step(
        big_cfg, mesh, helpers.LOSS_KWARGS_CLASS_WEIGHTS, {"lr": 1e-3},
        compute_dtype=torch.bfloat16, model=model)
    big = helpers.make_batch(np.random.default_rng(0), n=TRAIN_BATCH,
                             hw=TRAIN_HW, cfg=big_cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    times = []
    for i in range(sum(DP_TIMED)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(big, generator=gen)
        torch.cuda.synchronize()
        if i >= DP_TIMED[0]:
            times.append((time.perf_counter() - t0) * 1e3)
    del step, model, big
    torch.cuda.empty_cache()  # the rank stays for the next phase
    return f64 + (statistics.median(times),)


def phase_dp_train(torch, dev):
    """The data-parallel train step on a process mesh of two gloo ranks
    that share the card. In float64 (resnet18, six heads, 96^2, batch 4,
    TF32 off; ``train_parity``'s case) it equals the single-device card
    step on the global batch within ``train_parity``'s float64 tolerances
    (1e-8 loss and BN statistics, 1e-6 of each gradient's largest
    magnitude). The ResNet-34 448^2 batch-12 bf16 step's ms are printed
    beside the single-device ``train_step`` (two ranks on one card: no
    speed-up is expected)."""
    helpers = train_helpers()
    kwargs, state, batch, keep = helpers.parity_case()
    with tf32_off(torch):
        ref = helpers.step_on(dev, kwargs, state, batch, keep,
                              dtype=torch.float64)
    ranks = run_ranks(dp_rank, RANKS, (kwargs, state, batch, keep),
                      timeout_s=600)
    metrics, grads, state_after = ranks[0][:3]
    got = (metrics, {k: torch.from_numpy(v) for k, v in grads.items()},
           {k: torch.from_numpy(v) for k, v in state_after.items()})
    errors = helpers.worst_errors(got, ref)
    same = len({r[3] for r in ranks}) == 1
    ok = (all(errors[k] <= v for k, v in helpers.PARITY_F64_TOLS.items())
          and errors["zero_grad"] <= 1 and same)
    emit({"phase": "dp_train", "ranks": RANKS, "backend": "gloo",
          "device": "cuda:0 (both ranks)",
          "f64": {"setting": "resnet18, six heads, 96^2, global batch 4, "
                             "TF32 off", **errors,
                  "tolerances": helpers.PARITY_F64_TOLS,
                  "ranks_hold_the_same_state": same},
          "bf16_resnet34": {"hw": TRAIN_HW, "global_batch": TRAIN_BATCH,
                            "ms_per_step": [r[4] for r in ranks]},
          "ok": ok})
    if not ok:
        raise AssertionError("dp_train: the data-parallel step differs from "
                             "the single-device step")


def tiles_rank(rank, world, model_dir, input_dir, out_dir):
    """One rank of ``distributed_tiles``: its strided share of the images
    (``shard_slides``) through the tile CLI's manager on the card at
    batch 1. Returns the share."""
    from cerberus_tpu_torch.parallel.distributed import shard_slides

    names = sorted(os.listdir(input_dir))
    mine, _ = shard_slides(names, [None] * len(names))
    my_in = os.path.join(out_dir, "_in_p%d" % rank)
    os.makedirs(my_in)
    for name in mine:
        shutil.copy(os.path.join(input_dir, name), os.path.join(my_in, name))
    run_tile_dir(model_dir, my_in, out_dir)
    return mine


def run_tile_dir(model_dir, input_dir, out_dir):
    """The tile CLI's manager over ``input_dir`` at ``--batch_size=1``."""
    from cerberus_tpu_torch.config import DEFAULT_TARGET_LIST

    import torch

    manager = load_model_dir(torch, model_dir)
    manager.process_file_list({
        "nr_inference_workers": 0, "nr_post_proc_workers": 0,
        "batch_size": 1, "input_dir": input_dir, "output_dir": out_dir,
        "patch_input_shape": 448, "patch_output_shape": 144,
        "patch_output_overlap": 0,
        "postproc_list": list(DEFAULT_TARGET_LIST)})


def phase_distributed_tiles(torch):
    """Two gloo processes on the card each take a strided share of the
    ``tile_cli_cache`` phase's ten images (``shard_slides``) through the
    tile CLI's manager at ``--batch_size=1``; the union of their ``.mat``
    files equals one process's run over all ten."""
    import cv2

    from cerberus_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "smoke_distributed_tiles")
    shutil.rmtree(work, ignore_errors=True)
    try:
        model_dir = os.path.join(work, "model")
        write_model(torch, model_dir, True)
        images = serve_images()
        os.makedirs(os.path.join(work, "input"))
        for name, img in images.items():
            cv2.imwrite(os.path.join(work, "input", name + ".png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        t0 = time.perf_counter()
        shares = run_ranks(tiles_rank, RANKS, (
            model_dir, os.path.join(work, "input"),
            os.path.join(work, "dist")), timeout_s=600)
        dist_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_tile_dir(model_dir, os.path.join(work, "input"),
                     os.path.join(work, "single"))
        single_s = time.perf_counter() - t0
        names = sorted(images)
        a = read_mats(os.path.join(work, "dist"), names)
        b = read_mats(os.path.join(work, "single"), names)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    union = sorted(n for share in shares for n in share)
    equal = union == sorted(n + ".png" for n in names) and all(
        set(a[key]) == set(b[key]) and all(
            np.array_equal(a[key][k], b[key][k]) for k in b[key])
        for key in b)
    emit({"phase": "distributed_tiles", "ranks": RANKS, "backend": "gloo",
          "shares": shares, "union_equal_to_single": equal,
          "seconds_two_processes": dist_s, "seconds_single": single_s,
          "nuclei_instances": sum(int(b[(n, "nuclei")]["inst_map"].max())
                                  for n in names)})
    if not equal:
        raise AssertionError("distributed_tiles: the two processes' .mat "
                             "files differ from one process's")


def phase_multi_gpu(torch, dev, model_dir, legacy_one):
    """The multi-GPU phases, with their seconds. Returns the launches of
    ``mesh_wsi`` and ``sharded_cc``."""
    seconds = {}
    t0 = time.perf_counter()
    manager = make_manager(torch, model_dir, True)
    phase_mesh_infer(torch, manager)
    del manager
    torch.cuda.empty_cache()
    seconds["mesh_infer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = {"sharded_cc": phase_sharded_cc(torch, dev)}
    seconds["sharded_cc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["mesh_wsi"] = phase_mesh_wsi(torch, dev, legacy_one)
    seconds["mesh_wsi"] = time.perf_counter() - t0
    try:
        for name, fn in (("dp_train", lambda: phase_dp_train(torch, dev)),
                         ("distributed_tiles",
                          lambda: phase_distributed_tiles(torch))):
            t0 = time.perf_counter()
            fn()
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        close_ranks()
    emit({"phase": "multi_gpu_seconds", **seconds})
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
    manager = make_manager(torch, model_dir, True)
    batch_position_invariance(torch, manager)
    full_manager = make_manager(torch, model_dir, True)
    launches = phase_main_path(torch, manager, full_manager)
    dense_manager = make_manager(torch, model_dir, True, geometry=DENSE)
    phase_main_path_dense(torch, dense_manager)
    phase_forward_profile(torch, [("windowed_full", full_manager, False),
                                  ("windowed_valid", manager, True),
                                  ("dense_valid", dense_manager, True)])
    paired_launches = phase_paired(torch, dev, model_dir, manager,
                                   full_manager, dense_manager)
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
    legacy_run, legacy_one = phase_wsi_cli_legacy(torch, resident_run)
    phase_wsi_cli_cpu(torch, legacy_run)
    multi_launches = phase_multi_gpu(torch, dev, model_dir, legacy_one)
    phase_training(torch, dev)
    dsf_launches = phase_dsf(torch, dev)

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
                        **{"%s_main_path_launches" % path: counts[name]
                           for path, counts in paired_launches.items()},
                        **{"%s_launches" % path: counts[name]
                           for path, counts in dsf_launches.items()},
                        **{"%s_launches" % path: counts.get(name, 0)
                           for path, counts in multi_launches.items()},
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
