"""The GPU-resident WSI loop: patches -> a row canvas on the card -> grid
tile nuclei instances, with the disk canvas landed in the background.

Counterpart of ``cerberus_tpu/infer/resident_wsi.py:108-483``, per TILE ROW
of the set-0 post-processing grid (``wsi/coords.get_tile_info``):

  * the row's input pixels (the union of its patch windows) are read on a
    host thread and uploaded once as uint8; the windows are gathered on the
    card (``infer/tile.gather_windows``, exact integer indexing);
  * a row runs every patch whose output window overlaps one of its tiles
    (``patches_touching``), and its canvas starts at the highest of them.
    Where the tile is a multiple of the output window that is the tiles'
    own patches; where it is not (864 px dense windows on the 2016 px grid
    of the default 2048 tile shape) a patch that reaches into the next row
    is run for both rows, so each row canvas holds every pixel of its
    tiles. (The JAX package's resident loop keeps only the patches whose
    top-left lies in the row, and loses those pixels there.);
  * every batch the forward sees is ``batch_size`` long, its tail
    zero-padded (batch sizes are not bit-equal per sample); only the valid
    entries are written;
  * outputs scatter into a float16 row canvas on the card, 512-padded in
    height and ``w_row`` wide so that every tile's padded window is an
    in-bounds slice (torch slicing would silently shorten an out-of-range
    one, where ``jax.lax.dynamic_slice`` clamped it);
  * per grid tile, the nuclei family runs on the tile's window padded to
    512-multiples (``padded_shape``), rows and columns past the slide edge
    zeroed (what ``pad_to_512`` fed the tile path: cv2-compatible erosion
    treats the array border as foreground, so the padding changes results),
    then ``compact_present_ids``; only uint16 instance ids and uint8 type
    ids come down, and a host thread hands them to the caller's
    ``on_tile``;
  * each tile's exact canvas window comes down once and lands in the disk
    ``CanvasSet`` on a host thread (mid-slide resume, the tissue map, the
    boundary-repair tiles and the gland/lumen reads use it).

All device work — kernels, families, slicing, copies — is enqueued by the
calling thread. Host threads receive only host tensors: every download is
a non-blocking copy into pinned memory followed by a recorded CUDA event,
which the host thread waits on before it reads (``_to_host``). The copy is
ordered on the stream before any later write to the row canvas or reuse
of its memory, so the landing cannot race the next row. (A pageable copy
issued from a host thread instead would block the stream the main thread
is filling, and would read the canvas with no ordering against it.)

A tile with more than ``_U16_LIMIT`` instances cannot ride the uint16
download; it is deferred, with the tiles a resumed run already landed, to
the caller's disk-canvas path.

The main thread's waits on the host threads run under ``trace_span``s
(``wsi/read_wait`` on the row reader, ``wsi/land_wait`` on the disk
canvas, ``wsi/records_wait`` on ``on_tile``), summed into the caller's
``totals`` under the labels of ``WAIT_LABELS`` with the reader thread's
own seconds (timed there with the clock alone: a profiler span opened on
a host thread does not show in the trace).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.device_postproc import KERNELS, Impl
from ..ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT, compact_present_ids
from ..utils.profiling import trace_span
from ..wsi.coords import filter_coordinates
from .tile import gather_windows

_U16_LIMIT = 65535
# a slide's totals: the reader thread's seconds reading, the main thread's
# waits on it, and its waits on the canvas landing and the tile records
READ, READ_WAIT, HOST_WAIT = ("Resident Read Time", "Resident Read Wait Time",
                              "Resident Host Wait Time")
WAIT_LABELS = (READ, READ_WAIT, HOST_WAIT)


def _pad512(n: int) -> int:
    return max(-(-int(n) // 512) * 512, 512)


def _to_host(*tensors: Optional[torch.Tensor]):
    """Host copies of device tensors and the event to wait on before
    reading them (None on the CPU). ``None`` entries stay ``None``."""
    if all(t is None or t.device.type == "cpu" for t in tensors):
        return [t for t in tensors], None
    hosts = []
    for t in tensors:
        if t is not None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        hosts.append(t)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


def nuclei_tile_labels(window: torch.Tensor, h_valid: int, w_valid: int,
                       idx_dict: Dict, postproc_code: str,
                       impl: Impl = KERNELS):
    """A grid tile's nuclei instances from its padded canvas window.

    ``window``: (hp, wp, C) slice of the row canvas; rows and columns past
    ``(h_valid, w_valid)`` are zeroed for the family. Returns the valid
    window's (uint16 instance ids, uint8 type ids or None, instance count
    as a 0-d tensor), all on the window's device."""
    s, e = idx_dict["Nuclei-INST"]
    inst = window[..., s:e].float()
    inst[h_valid:] = 0
    inst[:, w_valid:] = 0
    lab = GPU_POSTPROC_FUNC_DICT[postproc_code].labels(inst, "Nuclei", 1.0,
                                                       impl)
    lab_k, count = compact_present_ids(lab, impl)
    inst16 = lab_k[:h_valid, :w_valid].to(torch.uint16)
    t_slice = idx_dict.get("Nuclei-TYPE")
    type8 = (window[:h_valid, :w_valid, t_slice[0]].to(torch.uint8)
             if t_slice is not None else None)
    return inst16, type8, count


def region_labels(region: torch.Tensor, tissue_code: str, postproc_code: str,
                  ds: float, impl: Impl = KERNELS):
    """Gland/lumen instances of a 512-padded tissue region plane at scale
    ``ds``: (H, W, n) INST channels on the device -> (uint16 ids, count as
    a 0-d tensor). Ids alias when count passes ``_U16_LIMIT``."""
    lab = GPU_POSTPROC_FUNC_DICT[postproc_code].labels(region, tissue_code,
                                                       ds, impl)
    lab_k, count = compact_present_ids(lab, impl)
    return lab_k.to(torch.uint16), count


def patches_touching(patch_outputs: np.ndarray,
                     bounds: np.ndarray) -> np.ndarray:
    """Indices of the patches whose output window overlaps the tile. Where
    the tile is a multiple of the output window these are the patches whose
    top-left lies in it (``wsi/coords.assign_patches_to_tiles``); where it
    is not, as for 864 px dense windows on the 2016 px grid of the default
    tile shape, a patch reaches into the next tile too and is run for
    both."""
    x0, y0, x1, y1 = [int(v) for v in bounds]
    return np.flatnonzero((patch_outputs[:, 0] < x1)
                          & (patch_outputs[:, 2] > x0)
                          & (patch_outputs[:, 1] < y1)
                          & (patch_outputs[:, 3] > y0))


def _write_outputs(canvas: torch.Tensor, outs: torch.Tensor,
                   tls: np.ndarray, size: int) -> None:
    """Scatter (N, size, size, C) outputs into the canvas at their (y, x)
    top-lefts, in one indexed write (patches do not overlap)."""
    ar = torch.arange(size, device=canvas.device)
    tl = torch.as_tensor(tls, dtype=torch.int64, device=canvas.device)
    ys = tl[:, 0, None] + ar
    xs = tl[:, 1, None] + ar
    canvas[ys[:, :, None], xs[:, None, :]] = outs.to(canvas.dtype)


class ResidentWSIProcessor:
    """Fused inference + set-0 nuclei post-processing over the
    post-processing tile grid. ``manager`` supplies ``run_step``,
    ``batch_size`` and ``device``."""

    def __init__(self, manager, idx_dict: Dict, n_ch: int,
                 postproc_code: Optional[str], output_shape: int,
                 impl: Impl = KERNELS):
        self.manager = manager
        self.idx_dict = idx_dict
        self.n_ch = n_ch
        self.postproc_code = postproc_code
        self.out = int(output_shape)
        self.impl = impl

    def _padded(self, n: int) -> int:
        return _pad512(-(-int(n) // self.out) * self.out)

    def padded_shape(self, h_clip: int, w_clip: int) -> Tuple[int, int]:
        """The (hp, wp) window the nuclei family sees for a tile whose
        valid extent is (h_clip, w_clip)."""
        return self._padded(h_clip), self._padded(w_clip)

    def run(self, reader, resolution, patch_inputs, patch_outputs, set0,
            wsi_mask, wsi_proc_shape_xy, done_tiles, save_progress, canvas,
            on_tile: Callable, totals: Optional[dict] = None) -> List[int]:
        """Process every set-0 grid tile. ``on_tile(inst_map uint16,
        type_map float32 or None, bounds, flags, tile_idx)`` runs on a host
        thread for each tile that had patches. Returns the deferred tile
        indices (landed by an earlier run, or past ``_U16_LIMIT``). The
        seconds of ``WAIT_LABELS`` are added to ``totals``."""
        totals = {} if totals is None else totals
        for label in WAIT_LABELS:
            totals.setdefault(label, 0.0)
        set_bounds, set_flags = set0
        deferred: List[int] = []
        deferred_lock = threading.Lock()
        run_nuclei = ("Nuclei-INST" in self.idx_dict
                      and self.postproc_code is not None)
        device = self.manager.device

        def land_canvas(window, event, bounds, tile_idx):
            if event is not None:
                event.synchronize()
            canvas.write_region(bounds, window.numpy())
            canvas.flush()
            done_tiles.add(tile_idx)
            save_progress()

        def finish_tile(inst, type8, count, event, bounds, flags, tile_idx):
            if event is not None:
                event.synchronize()
            if int(count) > _U16_LIMIT:  # the uint16 ids alias
                with deferred_lock:
                    deferred.append(tile_idx)
                return
            type_map = (type8.numpy().astype(np.float32)
                        if type8 is not None else None)
            on_tile(inst.numpy(), type_map, bounds, flags, tile_idx)

        # plan: resolve skips and deferrals per tile, then group the rest by
        # tile ROW (one input region, one row canvas and one stream of full
        # batches per row)
        work = []
        tissue = None  # the tissue test sums the whole mask: once, if asked
        for tile_idx, bounds in enumerate(set_bounds):
            if tile_idx in done_tiles:
                deferred.append(tile_idx)  # canvas already on disk
                continue
            sel = patches_touching(patch_outputs, bounds)
            if len(sel) == 0 and tissue is None:
                tissue = filter_coordinates(wsi_mask, np.asarray(set_bounds),
                                            wsi_proc_shape_xy)
            if len(sel) == 0 and not tissue[tile_idx]:
                done_tiles.add(tile_idx)
                save_progress()
                continue
            work.append((tile_idx, np.asarray(bounds), sel))

        rows: Dict[int, List] = {}
        for item in work:
            rows.setdefault(int(item[1][1]), []).append(item)
        row_keys = sorted(rows)
        for key in row_keys:
            rows[key].sort(key=lambda it: int(it[1][0]))  # by tile x0

        in_sz = (int(patch_inputs[0, 2] - patch_inputs[0, 0])
                 if len(patch_inputs) else self.out)
        m_in = (in_sz - self.out) // 2
        W = int(wsi_proc_shape_xy[0])
        aw_slide = -(-W // self.out) * self.out  # covers every patch window
        w_row = max([aw_slide] + [int(b[0]) + self._padded(b[2] - b[0])
                                  for b in set_bounds])

        def row_geom(key):
            """The row's patches (each once, in tile order), the canvas
            origin ``y_top`` and its patch-aligned height. Where the tile
            is no multiple of the output window, patches of the row above
            reach into this row: the canvas starts at the highest of them,
            ``key - y_top`` rows above the tiles."""
            sel_row = np.concatenate([it[2] for it in rows[key]])
            sel_row = sel_row[np.sort(np.unique(sel_row,
                                                return_index=True)[1])]
            y1 = max(int(it[1][3]) for it in rows[key])
            y_top, y_bot = key, y1
            if len(sel_row):
                y_top = min(key, int(patch_outputs[sel_row, 1].min()))
                y_bot = max(y1, int(patch_outputs[sel_row, 3].max()))
            align_h = -(-(y_bot - y_top) // self.out) * self.out
            return sel_row, y_top, align_h, y1 - key

        def read_row_input(y_top, align_h):
            rb = (-m_in, y_top - m_in, aw_slide + m_in,
                  y_top + align_h + m_in)
            t0 = time.perf_counter()
            region = np.ascontiguousarray(reader.read_bounds(rb,
                                                             **resolution))
            totals[READ] += time.perf_counter() - t0  # one reader thread
            return region

        def wait_span(name, label):
            return trace_span(name, label=label, totals=totals)

        batch_size = max(int(self.manager.batch_size), 1)
        read_pool = ThreadPoolExecutor(max_workers=1)   # row input reads
        land_pool = ThreadPoolExecutor(max_workers=1)   # disk canvas
        host_pool = ThreadPoolExecutor(max_workers=3)   # on_tile
        host_futs: List = []
        row_land_futs: List[List] = []
        try:
            geoms = {key: row_geom(key) for key in row_keys}
            if row_keys:
                rfut = read_pool.submit(read_row_input,
                                        *geoms[row_keys[0]][1:3])
            for ri, key in enumerate(row_keys):
                tiles = rows[key]
                with wait_span("wsi/read_wait", READ_WAIT):
                    region = rfut.result()
                if ri + 1 < len(row_keys):
                    rfut = read_pool.submit(read_row_input,
                                            *geoms[row_keys[ri + 1]][1:3])
                sel_row, y_top, align_h, h_row = geoms[key]
                off = key - y_top
                hp = self._padded(h_row)

                # backpressure: at most two rows' downloads in flight
                with wait_span("wsi/land_wait", HOST_WAIT):
                    while len(row_land_futs) > 1:
                        for fut in row_land_futs.pop(0):
                            fut.result()

                dev = torch.zeros((max(off + hp, align_h), w_row, self.n_ch),
                                  dtype=torch.float16, device=device)
                inp = torch.from_numpy(region).to(device)
                # output-window top-lefts in canvas coordinates equal
                # input-window top-lefts in input-region coordinates (both
                # origins sit m_in before the row's top-left)
                row_out = patch_outputs[sel_row]
                tls_all = np.stack([row_out[:, 1] - y_top, row_out[:, 0]],
                                   axis=1)
                for start in range(0, len(tls_all), batch_size):
                    tls = tls_all[start:start + batch_size]
                    batch = gather_windows(inp, tls, in_sz)
                    if len(tls) < batch_size:
                        batch = torch.cat([batch, batch.new_zeros(
                            (batch_size - len(tls), *batch.shape[1:]))])
                    outs = self.manager.run_step(batch, self.out)
                    _write_outputs(dev, outs[:len(tls)], tls, self.out)
                del inp

                futs: List = []
                for tile_idx, bounds, sel in tiles:
                    x0, y0, x1, y1 = [int(v) for v in bounds]
                    h_clip, w_clip = y1 - y0, x1 - x0
                    if run_nuclei and len(sel) > 0:
                        wp = self._padded(w_clip)
                        window = dev[off:off + hp, x0:x0 + wp]
                        if window.shape[:2] != (hp, wp):
                            raise AssertionError(
                                "tile window %s out of the row canvas %s"
                                % ((hp, wp), tuple(dev.shape)))
                        hosts, event = _to_host(*nuclei_tile_labels(
                            window, h_clip, w_clip, self.idx_dict,
                            self.postproc_code, self.impl))
                        host_futs.append(host_pool.submit(
                            finish_tile, *hosts, event, bounds,
                            set_flags[tile_idx], tile_idx))
                    (window,), event = _to_host(
                        dev[off:off + h_clip, x0:x0 + w_clip])
                    futs.append(land_pool.submit(land_canvas, window, event,
                                                 bounds, tile_idx))
                row_land_futs.append(futs)
                del dev
                while host_futs and host_futs[0].done():
                    host_futs.pop(0).result()
                with wait_span("wsi/records_wait", HOST_WAIT):
                    while len(host_futs) > 8:
                        host_futs.pop(0).result()
            with wait_span("wsi/land_wait", HOST_WAIT):
                for futs in row_land_futs:
                    for fut in futs:
                        fut.result()
            with wait_span("wsi/records_wait", HOST_WAIT):
                for fut in host_futs:
                    fut.result()
        finally:
            read_pool.shutdown(wait=True)
            land_pool.shutdown(wait=True)
            host_pool.shutdown(wait=True)
        return sorted(deferred)
