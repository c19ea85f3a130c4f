"""WSI inference: whole slides -> per-slide instance dictionaries
(``dat/<name>.dat``), tissue-class maps (``tissue/<name>.mat``), optional
thumbnails, masks and json.

Counterpart of ``cerberus_tpu/infer/wsi.py:278-915``. Per slide, with
wall-clock spans in the per-slide log:

  * placement: the tissue mask (``--msk_dir`` PNG, ``--auto_mask``, or all
    ones), the patch grid filtered by it, and mid-slide resume from the
    disk canvas when ``progress.json`` carries the same fingerprint;
  * inference, by one of two loops, chosen as the JAX engine chooses
    (``gpu`` standing for its ``tpu``): the resident loop
    (``infer/resident_wsi.py``, with the set-0 nuclei instances) for the
    ``gpu`` backend unless ``CERBERUS_RESIDENT=0``; otherwise the legacy
    host-canvas loop (``_run_tile_pipelined``: a read thread over the
    reader's ``read_batch``, the forward on the card, each batch's outputs
    landed in the disk canvas from pinned memory);
  * nuclei post-processing over the four tile sets of the post-processing
    grid (set 0 only for the tiles the resident loop deferred), re-read
    from the disk canvas: the CUDA families (``gpu``) or the scipy/cv2
    oracle families (``cpu``, in a pool of ``spawn`` processes with
    ``nr_post_proc_workers > 0``);
  * the tissue-class map (Patch-Class at 0.25x, gated by the mask);
  * gland and lumen per tissue region at 0.5x: host reads on a prefetch
    thread, then the family: on the device with the id compaction in the
    resident mode (``resident_wsi.region_labels``, the families'
    ``post_process`` past the uint16 limit), the CUDA families'
    ``post_process`` in the legacy loop, or the oracle families (``cpu``);
  * the ``.dat`` payload, a plain pickle (``joblib.load`` reads it).

Each phase runs under one ``trace_span`` (``wsi/placement``,
``wsi/inference``, ``wsi/nuclei_sets``, ``wsi/tissue_map``,
``wsi/gland_lumen``) that logs its ``<label>: <seconds>`` line; inside,
the main thread's waits and host work have spans of their own (the
resident loop's ``wsi/read_wait``, ``wsi/land_wait``,
``wsi/records_wait``; per tissue region ``wsi/region_wait`` on the
prefetch and ``wsi/region_info`` for the lumen gating and the instance
records), summed over the slide and logged once. A slide whose forwards
synthesised G-conv kernels (DSF-CNN) also logs ``Steerable Kernel
Syntheses: <n>``, their count (``models/gconv.synth_counts``).

Device work is enqueued by the calling thread only; host threads do the
disk reads, resizes, contours and dedup. The device half of each step
(``boundary_tile_labels``, ``region_instance_map``'s device part) needs
neither cv2 nor PyYAML; the host half imports cv2 inside its functions.

The mesh branch (``cerberus_tpu/infer/wsi.py:244-248, 469-473, 613-615,
766-769``): with a manager ``mesh`` the legacy loop runs (the resident
loop only without one), every batch is sharded over the mesh, and under
the ``gpu`` backend the nuclei tiles (``boundary_tile_labels``, after
``pad_to_512``) and the tissue regions' family run row-sharded over it
(``ops/sharded_cc.py``); the ``cpu`` backend and its pool never see it.
Several processes (``parallel/distributed.initialize``) each take a
strided share of the slide list, with a ``_host<rank>`` cache
(``process_wsi_list``, JAX :836-844). JAX's region-program warmer has no
counterpart: torch compiles nothing.
"""
from __future__ import annotations

import json
import logging
import multiprocessing
import os
import pathlib
import pickle
import queue
import threading
import time
import uuid
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from datetime import datetime

import numpy as np
import torch

from ..data.patching import make_channel_index_map
from ..models import gconv
from ..ops.cc_cpu import label as cc_label
from ..ops.device_postproc import KERNELS, Impl
from ..ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT, pad_to_512
from ..ops.postproc import POSTPROC_FUNC_DICT, get_inst_info_dict
from ..parallel.distributed import process_info, shard_slides
from ..utils import mkdir, rm_n_mkdir, save_json
from ..utils.geometry import get_bounding_box
from ..utils.profiling import maybe_profile, trace_span
from ..wsi.coords import (
    assign_patches_to_tiles,
    filter_coordinates,
    get_coordinates,
    get_tile_info,
)
from ..wsi.dedup import select_ref_removals, select_tile_removals
from ..wsi.ioconfig import make_inference_ioconfig, make_postproc_ioconfig
from ..wsi.merge import CanvasSet
from ..wsi.reader import open_wsi
from . import resident_wsi
from .manager import InferManager as BaseInferManager

# "gpu": families on the card ("tpu" is accepted as an alias); "cpu": the
# scipy/cv2 oracle families on the host
POSTPROC_BACKENDS = ("gpu", "tpu", "cpu")
# host batches between the read thread and the card, and batch outputs
# between the card and the canvas writer, in the legacy loop
_LEGACY_BUFFERS = 4
# the gland/lumen phase's totals over a slide's tissue regions
REGION_WAIT = "Gland & Lumen Region Wait Time"
REGION_INFO = "Gland & Lumen Region Info Time"


def _info_to_wsi_format(inst_info_dict, offset_xy):
    """Info dicts -> the WSI .dat contract: flat XY boxes [x0, y0, x1, y1],
    coordinates offset to slide space, uuid keys."""
    out = {}
    for _inst_id, info in inst_info_dict.items():
        box = info["box"]
        flat_box = np.array([box[0][1], box[0][0], box[1][1], box[1][0]])
        new_info = {
            "box": flat_box + np.concatenate([offset_xy] * 2),
            "centroid": np.asarray(info["centroid"]) + offset_xy,
            "contour": np.asarray(info["contour"]) + offset_xy,
        }
        if "type" in info:
            new_info["type"] = info["type"]
            new_info["type_prob"] = info["type_prob"]
        out[uuid.uuid4().hex] = new_info
    return out


def _read_region_resized(canvas, bounds, channels, ds: float, mask=None,
                         interp=None):
    """Stripe-read a canvas region and downscale it (cv2), in row stripes
    whose heights are multiples of 1/ds, so the stripes' resizes
    concatenate to exactly the whole-plane resize while peak memory stays
    O(stripe + output)."""
    import cv2

    x0, y0, x1, y1 = [int(v) for v in bounds]
    src_h, src_w = y1 - y0, x1 - x0
    out_w = int(round(src_w * ds))
    out_h = int(round(src_h * ds))
    inv = max(1, int(round(1.0 / ds)))
    step = 4096 - (4096 % inv)
    interp = cv2.INTER_LINEAR if interp is None else interp

    jobs = []
    done = 0
    for sy in range(0, src_h, step):
        ey = min(sy + step, src_h)
        oh = (out_h - done) if ey == src_h else int((ey - sy) * ds)
        if oh <= 0:
            continue
        jobs.append((sy, ey, oh))
        done += oh

    def one(job):
        sy, ey, oh = job
        stripe = canvas.read_region((x0, y0 + sy, x1, y0 + ey),
                                    channels=channels)
        if mask is not None:
            stripe = stripe * mask[sy:ey]
        stripe = cv2.resize(stripe, (out_w, oh), interpolation=interp)
        if stripe.ndim == 2:
            stripe = stripe[..., None]
        return stripe

    if len(jobs) <= 1:
        parts = [one(j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=min(6, len(jobs))) as pool:
            parts = list(pool.map(one, jobs))
    return np.concatenate(parts, axis=0)


def _plan_tissue_regions(wsi_mask):
    """Label the tissue mask; returns ``(labelled_mask, tissue_info_list)``
    with per-region ``[rmin, rmax, cmin, cmax]`` boxes at mask
    resolution."""
    wsi_mask_lab, n_regions = cc_label(wsi_mask)
    tissue_info_list = []
    if n_regions >= 1:
        for region_id in range(1, n_regions + 1):
            rmin, rmax, cmin, cmax = get_bounding_box(
                wsi_mask_lab == region_id)
            tissue_info_list.append([rmin, rmax, cmin, cmax])
    else:
        tissue_info_list.append([0, wsi_mask_lab.shape[0],
                                 0, wsi_mask_lab.shape[1]])
    return wsi_mask_lab, tissue_info_list


def _tile_raw_map(raw, tile_bounds, inst_slice, type_slice, dtype):
    """A nuclei post-processing tile's window of the disk memmap ``raw``,
    clipped to the canvas, as ``dtype``: (INST + TYPE channels, the
    family's idx_dict)."""
    x0, y0, x1, y1 = [int(v) for v in tile_bounds]
    x1 = min(x1, raw.shape[1])
    y1 = min(y1, raw.shape[0])
    region = np.asarray(raw[y0:y1, x0:x1], dtype=dtype)
    n_inst = inst_slice[1] - inst_slice[0]
    parts = [region[..., inst_slice[0]:inst_slice[1]]]
    idx_dict = {"Nuclei-INST": [0, n_inst]}
    if type_slice is not None:
        parts.append(region[..., type_slice[0]:type_slice[1]])
        idx_dict["Nuclei-TYPE"] = [n_inst,
                                   n_inst + type_slice[1] - type_slice[0]]
    return np.concatenate(parts, axis=-1), idx_dict


def boundary_tile_labels(raw, tile_bounds, inst_slice, type_slice,
                         postproc_code, device, impl: Impl = KERNELS,
                         mesh=None):
    """The device half of a nuclei boundary-repair (or deferred grid)
    tile: its f16 canvas window read from the disk memmap ``raw``,
    512-padded, through the family's ``post_process`` on ``device``
    (row-sharded over ``mesh`` when one is given). Returns (float64
    inst_map, f32 type_map or None) cropped to the clipped window."""
    raw_map, idx_dict = _tile_raw_map(raw, tile_bounds, inst_slice,
                                      type_slice, np.float16)
    h, w = raw_map.shape[:2]
    raw_map = torch.from_numpy(pad_to_512(raw_map)).to(device)
    inst_map, type_map = GPU_POSTPROC_FUNC_DICT[postproc_code].post_process(
        raw_map, idx_dict, "Nuclei", impl=impl, mesh=mesh)
    return inst_map[:h, :w], (type_map[:h, :w] if type_map is not None
                              else None)


def host_tile_labels(raw, tile_bounds, inst_slice, type_slice,
                     postproc_code):
    """The ``cpu`` backend's nuclei tile: the f32 canvas window through the
    oracle family (the JAX ``_process_tile_predictions`` with
    ``backend="cpu"``). Returns (float64 inst_map, f32 type_map or
    None)."""
    raw_map, idx_dict = _tile_raw_map(raw, tile_bounds, inst_slice,
                                      type_slice, np.float32)
    return POSTPROC_FUNC_DICT[postproc_code].post_process(raw_map, idx_dict,
                                                          "Nuclei")


def host_tile_instances(raw, tile_bounds, inst_slice, type_slice,
                        postproc_code, tile_flag, tile_mode, ref_boxes,
                        ref_uids, margin):
    """A whole ``cpu`` nuclei tile, the process pool's worker: ``raw`` is
    the disk canvas memmap or its path (opened read-only here). Returns
    ``tile_instances``'s (new_inst_dict, remove_uuid_list)."""
    if isinstance(raw, str):
        raw = np.load(raw, mmap_mode="r")
    inst_map, type_map = host_tile_labels(raw, tile_bounds, inst_slice,
                                          type_slice, postproc_code)
    return tile_instances(inst_map, type_map, tile_bounds, tile_flag,
                          tile_mode, ref_boxes, ref_uids, margin)


def tile_instances(inst_map, type_map, tile_bounds, tile_flag, tile_mode,
                   ref_boxes, ref_uids, margin):
    """The host half of a nuclei post-processing tile: instance dicts
    (cv2 contours), the tile-kind dedup, slide-space uuid entries. Returns
    (new_inst_dict, remove_uuid_list)."""
    inst_dict = get_inst_info_dict(inst_map, type_map)
    if len(inst_dict) == 0:
        return {}, []
    x0, y0 = int(tile_bounds[0]), int(tile_bounds[1])
    h, w = inst_map.shape[:2]
    boxes = np.array([
        [v["box"][0][1], v["box"][0][0], v["box"][1][1], v["box"][1][0]]
        for v in inst_dict.values()])
    drop = select_tile_removals(boxes, (w, h), margin, tile_flag, tile_mode)
    kept = {k: inst_dict[k] for k, d in zip(inst_dict.keys(), drop) if not d}
    new_inst_dict = _info_to_wsi_format(kept, np.array([x0, y0]))

    remove_uuid_list = []
    if tile_mode == 3 and len(ref_boxes) > 0:
        ref_drop = select_ref_removals(np.asarray(ref_boxes), tile_bounds,
                                       margin)
        remove_uuid_list = [u for u, d in zip(ref_uids, ref_drop) if d]
    return new_inst_dict, remove_uuid_list


def region_instance_map(region: np.ndarray, new_idx, tissue_code, code,
                        ds: float, device):
    """Gland or lumen instances of one tissue region plane (rh, rw, C) f32
    at scale ``ds``: the INST channels go up 512-padded, the family and the
    id compaction run on the device, uint16 ids come down. Past
    ``resident_wsi._U16_LIMIT`` ids the family's ``post_process`` (host
    compaction to float64 ids) runs instead. Returns (inst_map, type_map
    or None)."""
    rh, rw = region.shape[:2]
    n_dev_ch = 2 if code.startswith("IP-ERODED-CONTOUR") else 1
    padded = torch.from_numpy(pad_to_512(np.ascontiguousarray(
        region[..., :n_dev_ch]))).to(device)
    inst16, count = resident_wsi.region_labels(padded, tissue_code, code, ds)
    if int(count) <= resident_wsi._U16_LIMIT:
        inst_map = inst16[:rh, :rw].cpu().numpy()
        type_key = f"{tissue_code}-TYPE"
        type_map = (np.squeeze(region[..., new_idx[type_key][0]:
                                      new_idx[type_key][1]])
                    if type_key in new_idx else None)
        return inst_map, type_map
    return region_post_process(region, new_idx, tissue_code, code, ds,
                               device)


def region_post_process(region: np.ndarray, new_idx, tissue_code, code,
                        ds: float, device, mesh=None):
    """Gland or lumen instances of one tissue region plane through the
    family's ``post_process`` on ``device``, 512-padded (the legacy loop's
    ``gpu`` path, row-sharded over ``mesh`` when one is given, and the
    resident path past the uint16 limit). Returns (float64 inst_map,
    type_map or None) cropped to the region."""
    rh, rw = region.shape[:2]
    inst_map, type_map = GPU_POSTPROC_FUNC_DICT[code].post_process(
        torch.from_numpy(pad_to_512(region)).to(device), new_idx,
        tissue_code, ds, mesh=mesh)
    return inst_map[:rh, :rw], (type_map[:rh, :rw] if type_map is not None
                                else None)


class InferManager(BaseInferManager):
    """WSI-mode inference on the card (``device="cpu"`` for the tests)."""

    def _parse_args(self, run_args):
        for variable, value in run_args.items():
            setattr(self, variable, value)

    # ------------------------------------------------------------------
    def _read_patch_batches(self, reader, patch_inputs, resolution,
                            new_batch=None):
        """Fixed-shape uint8 batches of the patch windows, ``(batch,
        valid)``: one ``read_batch`` call per batch where the reader has
        it (the native gather), else windows read by ``read_bounds`` on
        ``nr_inference_workers`` threads. ``new_batch()`` returns the
        (batch_size, h, w, 3) array each batch is read into (default: a
        new one); rows past ``valid`` are zeroed."""
        batch_size = int(self.batch_size)
        in_w = int(patch_inputs[0, 2] - patch_inputs[0, 0])
        in_h = int(patch_inputs[0, 3] - patch_inputs[0, 1])
        if new_batch is None:
            def new_batch():
                return np.empty((batch_size, in_h, in_w, 3), np.uint8)

        def read_one(bounds):
            return reader.read_bounds(bounds, **resolution)

        workers = int(getattr(self, "nr_inference_workers", 8) or 8)
        use_batch_reader = hasattr(reader, "read_batch")
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for start in range(0, len(patch_inputs), batch_size):
                chunk = patch_inputs[start:start + batch_size]
                batch = new_batch()
                if use_batch_reader:
                    batch[:len(chunk)] = reader.read_batch(chunk,
                                                           **resolution)
                else:
                    for bi, patch in enumerate(pool.map(read_one, chunk)):
                        batch[bi] = patch
                batch[len(chunk):] = 0
                yield batch, len(chunk)

    def _run_tile_pipelined(self, reader, tile_in, tile_out, resolution,
                            canvas):
        """The legacy host-canvas loop over one inference tile's patches.

          * a read thread fills host batches (``_read_patch_batches``) into
            a ring of ``_LEGACY_BUFFERS`` pinned buffers, two batches
            ahead of the forward (a bounded queue);
          * the main thread copies each batch to the card without waiting
            (the buffer goes back to the ring behind an event recorded
            after its copy) and enqueues the forward;
          * each batch's outputs are copied into a pinned host buffer on a
            side stream that waits for the forward, and a writer thread
            waits for that copy and lands the valid outputs in the disk
            canvas (``CanvasSet.write_patches``); at most
            ``_LEGACY_BUFFERS`` batches are between the card and the
            canvas.

        Pageable copies, or copies on the stream that runs the forward,
        would make the read thread and the forward wait on each other. On
        the CPU (the tests) the buffers are plain and the step's outputs
        land as they are. Returns (the read thread's seconds reading, the
        main thread's seconds waiting for it)."""
        device = self.device
        on_card = device.type == "cuda"
        batch_size = int(self.batch_size)
        in_w = int(tile_in[0, 2] - tile_in[0, 0])
        in_h = int(tile_in[0, 3] - tile_in[0, 1])
        stop = threading.Event()
        _END = object()

        class _Stopped(Exception):
            pass

        def take(q):
            """``q.get()`` that gives up once the main loop has stopped."""
            while not stop.is_set():
                try:
                    return q.get(timeout=0.5)
                except queue.Empty:
                    continue
            raise _Stopped()

        def bounded_put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue
            raise _Stopped()

        in_free: "queue.Queue" = queue.Queue()
        for _ in range(_LEGACY_BUFFERS):
            in_free.put((torch.empty((batch_size, in_h, in_w, 3),
                                     dtype=torch.uint8, pin_memory=on_card),
                         None))
        read_q: "queue.Queue" = queue.Queue(maxsize=2)
        read_s = [0.0]

        def read_worker():
            held = []

            def new_batch():
                buf, event = take(in_free)
                if event is not None:
                    event.synchronize()  # its copy to the card is done
                held.append(buf)
                return buf.numpy()

            try:
                t0 = time.perf_counter()
                for _batch, valid in self._read_patch_batches(
                        reader, tile_in, resolution, new_batch):
                    read_s[0] += time.perf_counter() - t0
                    bounded_put(read_q, (held.pop(0), valid))
                    t0 = time.perf_counter()
                bounded_put(read_q, _END)
            except _Stopped:
                pass
            except BaseException as exc:  # raised again in the main loop
                try:
                    bounded_put(read_q, exc)
                except _Stopped:
                    pass

        copy_stream = torch.cuda.Stream(device) if on_card else None
        out_free: "queue.Queue" = queue.Queue()
        n_out = 0

        def land(host, done, coords, valid):
            if done is not None:
                done.synchronize()
            canvas.write_patches(host[:valid].numpy(), coords)
            if on_card:
                out_free.put(host)

        reader_thread = threading.Thread(target=read_worker, daemon=True)
        reader_thread.start()
        writer = ThreadPoolExecutor(max_workers=1)
        write_futs = []
        cursor = 0
        wait_s = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                item = read_q.get()
                wait_s += time.perf_counter() - t0
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                buf, valid = item
                if on_card:
                    batch = buf.to(device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    in_free.put((buf, event))
                    out = self.run_step(batch, self.patch_output_shape)
                    # at most _LEGACY_BUFFERS outputs between card and disk
                    while len(write_futs) >= _LEGACY_BUFFERS:
                        write_futs.pop(0).result()
                    if n_out < _LEGACY_BUFFERS:
                        n_out += 1
                        host = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True)
                    else:
                        host = out_free.get_nowait()
                    ready = torch.cuda.Event()
                    ready.record()
                    with torch.cuda.stream(copy_stream):
                        copy_stream.wait_event(ready)
                        host.copy_(out, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                    out.record_stream(copy_stream)
                else:
                    host = self.run_step(buf, self.patch_output_shape)
                    done = None
                    in_free.put((buf, None))
                write_futs.append(writer.submit(
                    land, host, done, tile_out[cursor:cursor + valid],
                    valid))
                cursor += valid
                while write_futs and write_futs[0].done():
                    write_futs.pop(0).result()  # write errors surface early
            for fut in write_futs:
                fut.result()
        finally:
            stop.set()
            writer.shutdown(wait=True)
            reader_thread.join(timeout=60)
        return read_s[0], wait_s

    # ------------------------------------------------------------------
    def _tissue_mask(self, reader, mask_path, wsi_proc_shape, resolution):
        if mask_path is not None and os.path.isfile(mask_path):
            import cv2

            wsi_mask = cv2.imread(mask_path)
            wsi_mask = cv2.cvtColor(wsi_mask, cv2.COLOR_BGR2GRAY)
            wsi_mask[wsi_mask > 0] = 1
            return wsi_mask
        if getattr(self, "auto_mask", False):
            from ..ops.tissue_mask import get_tissue_mask

            # downsample at most 8x, keeping the thumbnail's short side
            # >= ~512 px: the cleanup's fixed 2000 px area thresholds wipe
            # out all tissue on tiny thumbnails
            ds = min(8.0, max(1.0, min(wsi_proc_shape) / 512.0))
            thumb_mpp = max(ds * reader.info.mpp,
                            float(resolution["resolution"]) * ds)
            thumb = reader.slide_thumbnail(resolution=thumb_mpp, units="mpp")
            return get_tissue_mask(thumb).astype(np.uint8)
        return np.ones(tuple(wsi_proc_shape), dtype=np.uint8)

    def process_single_file(self, ioconfig, ioconfig_pp, wsi_path, mask_path,
                            wsi_basename, output_dir):
        logger = self.logger
        syntheses = gconv.synth_counts["kernels"]

        with trace_span("wsi/placement", logger,
                        label="Preparing Input Output Placement"):
            resolution = ioconfig.highest_input_resolution
            reader = open_wsi(wsi_path)
            wsi_proc_shape_xy = reader.slide_dimensions(**resolution)  # (w, h)
            wsi_proc_shape = wsi_proc_shape_xy[::-1]  # YX
            wsi_base_mpp = reader.info.mpp
            wsi_base_shape = np.array(reader.info.slide_dimensions)[::-1]  # YX

            wsi_mask = self._tissue_mask(reader, mask_path, wsi_proc_shape,
                                         resolution)
            mask_downsample_ratio = wsi_mask.shape[0] / wsi_proc_shape[0]

            if getattr(self, "save_mask", False):
                import cv2

                cv2.imwrite(f"{output_dir}/mask/{wsi_basename}.png",
                            wsi_mask * 255)
            if getattr(self, "save_thumb", False):
                import cv2

                try:
                    thumb = reader.slide_thumbnail(resolution=1.25,
                                                   units="power")
                except ValueError:
                    thumb = reader.slide_thumbnail(
                        resolution=8 * reader.info.mpp, units="mpp")
                cv2.imwrite(f"{output_dir}/thumb/{wsi_basename}.png",
                            cv2.cvtColor(thumb, cv2.COLOR_RGB2BGR))

            idx_dict, n_ch = make_channel_index_map(
                self.cfg.active_decoder_kwargs)

            # the JAX engine's choice of loop, with gpu for its tpu: a mesh
            # keeps the legacy loop (its post-processing row-shards)
            backend = getattr(self, "postproc_backend", "gpu")
            resident = (backend in ("gpu", "tpu") and self.mesh is None
                        and os.environ.get("CERBERUS_RESIDENT", "1") != "0")

            # mid-slide resume: the disk canvas + a tile-progress marker let a
            # preempted job continue this slide; done_tiles index the
            # post-processing grid (resident) or the inference grid (legacy),
            # so the grids, the loop (1 resident, 0 legacy, as in the JAX
            # package's marker), the patch geometry and the mask are in the
            # fingerprint
            progress_path = os.path.join(self.cache_path, "progress.json")
            grid_fp = [int(ioconfig.tile_shape[0]),
                       int(ioconfig.patch_input_shape[0]),
                       int(ioconfig.patch_output_shape[0]),
                       int(ioconfig.margin), int(resident),
                       int(ioconfig_pp.tile_shape[0])]
            mask_fp = [list(map(int, wsi_mask.shape)), int(wsi_mask.sum())]
            done_tiles = set()
            resume = False
            if os.path.exists(progress_path):
                try:
                    with open(progress_path) as handle:
                        meta = json.load(handle)
                except (OSError, ValueError):
                    meta = {}
                if (meta.get("slide") == wsi_basename
                        and meta.get("shape") == list(map(int, wsi_proc_shape))
                        and meta.get("n_ch") == n_ch
                        and meta.get("grid") == grid_fp
                        and meta.get("mask") == mask_fp):
                    done_tiles = set(meta.get("done_tiles", []))
                    resume = True
            if not resume:
                rm_n_mkdir(self.cache_path)
            canvas = CanvasSet(self.cache_path, tuple(wsi_proc_shape), n_ch,
                               resume=resume)

            # the canvas-landing thread saves progress while the main thread
            # marks empty tiles: serialise the tmp+replace
            progress_lock = threading.Lock()

            def save_progress():
                with progress_lock:
                    with open(progress_path + ".tmp", "w") as handle:
                        json.dump({"slide": wsi_basename,
                                   "shape": list(map(int, wsi_proc_shape)),
                                   "n_ch": n_ch,
                                   "grid": grid_fp,
                                   "mask": mask_fp,
                                   "done_tiles": sorted(done_tiles)}, handle)
                    os.replace(progress_path + ".tmp", progress_path)

            patch_inputs, patch_outputs = get_coordinates(wsi_proc_shape_xy,
                                                          ioconfig)
            sel = filter_coordinates(wsi_mask, patch_outputs,
                                     wsi_proc_shape_xy)
            patch_inputs = patch_inputs[sel]
            patch_outputs = patch_outputs[sel]

        # ===== inference (+ set-0 nuclei in the resident loop) ==========
        with trace_span("wsi/inference", logger, label="Inference Time"):
            pp_sets = get_tile_info(wsi_proc_shape_xy, ioconfig_pp)
            nuclei_inst_info = {}
            info_lock = threading.Lock()
            margin = int(ioconfig_pp.margin)

            def grid_tile(inst_map, type_map, bounds, flags, _tile_idx):
                new_dict, _ = tile_instances(inst_map, type_map, bounds,
                                             flags, 0, [], [], margin)
                with info_lock:
                    nuclei_inst_info.update(new_dict)

            if resident:
                proc = resident_wsi.ResidentWSIProcessor(
                    self, idx_dict, n_ch,
                    postproc_code=self.decoder_dict.get("Nuclei-INST"),
                    output_shape=int(self.patch_output_shape))
                waits: dict = {}
                deferred = proc.run(
                    reader, resolution, patch_inputs, patch_outputs,
                    pp_sets[0], wsi_mask, wsi_proc_shape_xy, done_tiles,
                    save_progress, canvas, grid_tile, totals=waits)
                logger.info("Resident grid tiles: %d deferred to the disk "
                            "canvas" % len(deferred))
                for label in resident_wsi.WAIT_LABELS:
                    logger.info("%s: %.4f" % (label, waits[label]))
            else:
                # legacy: the inference grid's tiles through the host
                # canvas; every set-0 tile is post-processed from the disk
                # canvas below
                read_s = read_wait_s = 0.0
                set_bounds, _ = get_tile_info(wsi_proc_shape_xy, ioconfig)[0]
                for tile_idx, tile_bounds in enumerate(set_bounds):
                    if tile_idx in done_tiles:
                        continue
                    tile_sel = assign_patches_to_tiles(patch_outputs,
                                                       tile_bounds)
                    if len(tile_sel) > 0:
                        read, wait = self._run_tile_pipelined(
                            reader, patch_inputs[tile_sel],
                            patch_outputs[tile_sel], resolution, canvas)
                        read_s += read
                        read_wait_s += wait
                        canvas.flush()
                    done_tiles.add(tile_idx)
                    save_progress()
                deferred = range(len(pp_sets[0][0]))
                logger.info("Legacy Read Time: %.4f" % read_s)
                logger.info("Legacy Read Wait Time: %.4f" % read_wait_s)
        syntheses = gconv.synth_counts["kernels"] - syntheses
        if syntheses:
            logger.info("Steerable Kernel Syntheses: %d" % syntheses)

        # ===== nuclei post-processing (sets 1-3, deferred set 0) =========
        with trace_span("wsi/nuclei_sets", logger,
                        label="Nuclei Post Proc Time"), \
                ThreadPoolExecutor(max_workers=3) as host_pool:
            if "Nuclei-INST" in idx_dict:
                postproc_code = self.decoder_dict["Nuclei-INST"]
                deferred = set(deferred)
                pool = getattr(self, "_postproc_workers", None)
                # the tissue test sums the whole mask: once, for every tile
                # of every set, when a tile no patch output reaches asks
                all_bounds = np.concatenate([b for b, _ in pp_sets])
                first = np.cumsum([0] + [len(b) for b, _ in pp_sets])
                tissue = None
                for set_idx, (pp_bounds, pp_flags) in enumerate(pp_sets):
                    futures = []
                    for tile_idx, tile_bounds in enumerate(pp_bounds):
                        if set_idx == 0 and tile_idx not in deferred:
                            continue  # already post-processed on the card
                        # skipped only where no patch output reaches the
                        # tile and it holds no tissue: an 864 px dense
                        # output covers a 256 px strip that holds none of
                        # its top-lefts (the JAX package asks for a
                        # top-left and loses that strip's nuclei where the
                        # mask ends short of it; ROADMAP section 3)
                        if len(resident_wsi.patches_touching(
                                patch_outputs, tile_bounds)) == 0:
                            if tissue is None:
                                tissue = filter_coordinates(
                                    wsi_mask, all_bounds, wsi_proc_shape_xy)
                            if not tissue[first[set_idx] + tile_idx]:
                                continue
                        ref_uids = (list(nuclei_inst_info.keys())
                                    if set_idx == 3 else [])
                        ref_boxes = (np.array([nuclei_inst_info[u]["box"]
                                               for u in ref_uids])
                                     if ref_uids else np.zeros((0, 4)))
                        if backend == "cpu":
                            # the pool's workers open the canvas by path
                            futures.append((pool or host_pool).submit(
                                host_tile_instances,
                                canvas.raw_path if pool else canvas.raw,
                                tile_bounds, idx_dict["Nuclei-INST"],
                                idx_dict.get("Nuclei-TYPE"), postproc_code,
                                pp_flags[tile_idx], set_idx, ref_boxes,
                                ref_uids, margin))
                            continue
                        inst_map, type_map = boundary_tile_labels(
                            canvas.raw, tile_bounds, idx_dict["Nuclei-INST"],
                            idx_dict.get("Nuclei-TYPE"), postproc_code,
                            self.device, mesh=self.mesh)
                        futures.append(host_pool.submit(
                            tile_instances, inst_map, type_map, tile_bounds,
                            pp_flags[tile_idx], set_idx, ref_boxes, ref_uids,
                            margin))
                    for fut in futures:
                        new_dict, remove_uuids = fut.result()
                        nuclei_inst_info.update(new_dict)
                        for u in remove_uuids:
                            nuclei_inst_info.pop(u, None)
            wsi_inst_info = {"Nuclei": nuclei_inst_info}

        # ===== tissue-class map ==========================================
        with trace_span("wsi/tissue_map", logger,
                        label="Tissue Region Post Proc Time"):
            if "Patch-Class" in idx_dict:
                import cv2
                import scipy.io as sio

                H, W = int(wsi_proc_shape[0]), int(wsi_proc_shape[1])
                pclass_ch = idx_dict["Patch-Class"][0]
                if H % 4 == 0 and W % 4 == 0:
                    pclass = canvas.read_decimated(4, pclass_ch)
                else:
                    pclass = _read_region_resized(
                        canvas, (0, 0, W, H), [pclass_ch], 0.25,
                        interp=cv2.INTER_NEAREST)[..., 0]
                lores_mask = cv2.resize(wsi_mask,
                                        (pclass.shape[1], pclass.shape[0]),
                                        interpolation=cv2.INTER_NEAREST)
                pclass *= lores_mask
                sio.savemat("%s/tissue/%s.mat" % (output_dir, wsi_basename),
                            {"pclass": pclass})

        # ===== gland + lumen per tissue region ===========================
        gland_inst_info = {}
        lumen_inst_info = {}
        target_list = [t for t in ("Gland", "Lumen")
                       if f"{t}-INST" in idx_dict]
        ds = 0.5

        def region_channels(tissue_code):
            chans = list(range(*idx_dict[f"{tissue_code}-INST"]))
            new_idx = {f"{tissue_code}-INST": [0, len(chans)]}
            if f"{tissue_code}-TYPE" in idx_dict:
                t0 = len(chans)
                chans += list(range(*idx_dict[f"{tissue_code}-TYPE"]))
                new_idx[f"{tissue_code}-TYPE"] = [t0, len(chans)]
            return chans, new_idx

        def prep_region(region_idx, tissue_info):
            """Host side of one tissue region (prefetch thread): the mask
            crop and the 0.5x masked channel reads of every target."""
            import cv2

            rmin = int(round(tissue_info[0] / mask_downsample_ratio))
            rmax = int(round(tissue_info[1] / mask_downsample_ratio))
            cmin = int(round(tissue_info[2] / mask_downsample_ratio))
            cmax = int(round(tissue_info[3] / mask_downsample_ratio))
            rmax = min(rmax, int(wsi_proc_shape[0]))
            cmax = min(cmax, int(wsi_proc_shape[1]))
            region_mask = (wsi_mask_lab[tissue_info[0]:tissue_info[1],
                                        tissue_info[2]:tissue_info[3]]
                           == region_idx + 1).astype("uint8")
            region_mask = cv2.resize(region_mask, (cmax - cmin, rmax - rmin),
                                     interpolation=cv2.INTER_NEAREST)
            region_mask = region_mask[..., None]
            regions = {}
            for tissue_code in target_list:
                chans, new_idx = region_channels(tissue_code)
                regions[tissue_code] = (_read_region_resized(
                    canvas, (cmin, rmin, cmax, rmax), chans, ds,
                    mask=region_mask), new_idx)
            return np.array([cmin, rmin]), regions

        with trace_span("wsi/gland_lumen", logger,
                        label="Gland & Lumen Post Proc Time"), \
                ThreadPoolExecutor(max_workers=1) as prefetch:
            wsi_mask_lab, tissue_info_list = _plan_tissue_regions(wsi_mask)
            region_totals: dict = {}
            fut = (prefetch.submit(prep_region, 0, tissue_info_list[0])
                   if tissue_info_list else None)
            for region_idx in range(len(tissue_info_list)):
                with trace_span("wsi/region_wait", label=REGION_WAIT,
                                totals=region_totals):
                    tissue_topleft, regions = fut.result()
                if region_idx + 1 < len(tissue_info_list):
                    fut = prefetch.submit(prep_region, region_idx + 1,
                                          tissue_info_list[region_idx + 1])
                pred_inst_map, pred_type_map = {}, {}
                for tissue_code in target_list:
                    region, new_idx = regions[tissue_code]
                    code = self.decoder_dict[f"{tissue_code}-INST"]
                    if backend == "cpu":
                        result = POSTPROC_FUNC_DICT[code].post_process(
                            region, new_idx, tissue_code, ds)
                    elif resident:
                        result = region_instance_map(
                            region, new_idx, tissue_code, code, ds,
                            self.device)
                    else:
                        result = region_post_process(
                            region, new_idx, tissue_code, code, ds,
                            self.device, mesh=self.mesh)
                    pred_inst_map[tissue_code], pred_type_map[tissue_code] = \
                        result
                with trace_span("wsi/region_info", label=REGION_INFO,
                                totals=region_totals):
                    if "Gland" in pred_inst_map and "Lumen" in pred_inst_map:
                        binary_gland = (pred_inst_map["Gland"] > 0).astype(
                            pred_inst_map["Lumen"].dtype)
                        pred_inst_map["Lumen"] = (binary_gland
                                                  * pred_inst_map["Lumen"])
                    for tissue_code in target_list:
                        info = get_inst_info_dict(
                            pred_inst_map[tissue_code],
                            pred_type_map[tissue_code], ds)
                        wsi_info = _info_to_wsi_format(info, tissue_topleft)
                        if tissue_code == "Gland":
                            gland_inst_info.update(wsi_info)
                        else:
                            lumen_inst_info.update(wsi_info)
            if "Gland" in target_list:
                wsi_inst_info["Gland"] = gland_inst_info
            if "Lumen" in target_list:
                wsi_inst_info["Lumen"] = lumen_inst_info
            for label in (REGION_WAIT, REGION_INFO):
                logger.info("%s: %.4f"
                            % (label, region_totals.get(label, 0.0)))

        wsi_inst_info["proc_resolution"] = {
            "resolution": self.wsi_proc_mag, "units": "mpp"}
        wsi_inst_info["base_resolution"] = {
            "resolution": wsi_base_mpp, "units": "mpp"}
        wsi_inst_info["proc_dimensions"] = np.asarray(wsi_proc_shape)
        wsi_inst_info["base_dimensions"] = np.asarray(wsi_base_shape)
        with open("%s/dat/%s.dat" % (output_dir, wsi_basename), "wb") as f:
            pickle.dump(wsi_inst_info, f, protocol=pickle.HIGHEST_PROTOCOL)
        if getattr(self, "save_json", False):
            mkdir(f"{output_dir}/json/")
            save_json(f"{output_dir}/json/{wsi_basename}.json",
                      {k: v for k, v in wsi_inst_info.items()
                       if k in ("Nuclei", "Gland", "Lumen")},
                      mag=self.wsi_proc_mag)
        canvas.close()

    # ------------------------------------------------------------------
    def process_wsi_list(self, run_args):
        self._parse_args(run_args)
        backend = getattr(self, "postproc_backend", "gpu")
        if backend not in POSTPROC_BACKENDS:
            raise ValueError("postproc_backend=%r: use one of %s"
                             % (backend, POSTPROC_BACKENDS))

        # several processes: each takes a strided share of this job's
        # slides and a cache of its own; one process takes them all
        pid, pcount = process_info()
        if pcount > 1:
            self.input_list, self.mask_list = shard_slides(
                self.input_list, self.mask_list, pid, pcount)
            self.cache_path = "%s_host%d" % (self.cache_path, pid)

        if not os.path.exists(self.cache_path):
            rm_n_mkdir(self.cache_path)
        mkdir(self.output_dir + "/dat/")
        mkdir(self.output_dir + "/tissue/")
        if getattr(self, "save_thumb", False):
            mkdir(self.output_dir + "/thumb/")
        if getattr(self, "save_mask", False):
            mkdir(self.output_dir + "/mask/")
        logging_dir = getattr(self, "logging_dir", self.output_dir)
        mkdir(logging_dir)

        n_heads = len(self.cfg.active_decoder_kwargs)
        ioconfig = make_inference_ioconfig(
            self.wsi_proc_mag, n_heads,
            tile_shape=int(getattr(self, "chunk_shape", 15000)),
            margin=int(getattr(self, "ambiguous_size", 64)),
            patch_input=int(self.patch_input_shape),
            patch_output=int(self.patch_output_shape))
        ioconfig_pp = make_postproc_ioconfig(
            self.wsi_proc_mag,
            tile_shape=int(getattr(self, "tile_shape", 4096)),
            margin=int(getattr(self, "ambiguous_size", 64)))

        # the cpu backend's nuclei tiles in spawned processes: they get the
        # canvas path and numpy only (a forked child of a process that has
        # initialised CUDA cannot use it, and the families need no card)
        nr_pp = int(getattr(self, "nr_post_proc_workers", 0) or 0)
        self._postproc_workers = (
            ProcessPoolExecutor(
                nr_pp, mp_context=multiprocessing.get_context("spawn"))
            if backend == "cpu" and nr_pp > 0 else None)
        try:
            self._process_slides(ioconfig, ioconfig_pp, logging_dir)
        finally:
            if self._postproc_workers is not None:
                self._postproc_workers.shutdown()
                self._postproc_workers = None
        rm_n_mkdir(self.cache_path)

    def _process_slides(self, ioconfig, ioconfig_pp, logging_dir):
        for wsi_path, mask_path in zip(self.input_list, self.mask_list):
            wsi_basename = pathlib.Path(wsi_path).stem
            dt_string = datetime.now().strftime("%d-%m-%Y_%H:%M:%S")
            log_path = f"{logging_dir}/{wsi_basename}_{dt_string}_std.log"
            self.logger = logging.getLogger("cerberus_tpu_torch.wsi")
            fhandler = logging.FileHandler(filename=log_path, mode="w")
            fhandler.setFormatter(logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
            self.logger.addHandler(fhandler)
            self.logger.setLevel(logging.DEBUG)
            try:
                if not os.path.exists(
                        self.output_dir + "/dat/%s.dat" % wsi_basename):
                    self.logger.info(f"Processing {wsi_basename} ...")
                    # CERBERUS_PROFILE_DIR=<dir> writes a Chrome trace per
                    # slide; the span goes to the per-slide log either way
                    with maybe_profile(wsi_basename), trace_span(
                            f"wsi/{wsi_basename}", self.logger,
                            label="Overall Time"):
                        self.process_single_file(
                            ioconfig, ioconfig_pp, wsi_path, mask_path,
                            wsi_basename, self.output_dir)
                    self.logger.info("Finish")
                else:
                    self.logger.warning(
                        f"Skip {wsi_basename} - already processed!")
            finally:
                self.logger.removeHandler(fhandler)
                fhandler.close()
