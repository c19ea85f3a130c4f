"""Tile inference: directory of images -> per-task instance maps, instance
dictionaries, overlays and ``.mat`` files.

Counterpart of ``cerberus_tpu/infer/tile.py:44-341``, split at one seam:

  * ``InferManager.process_image(img)`` is the device path: patch grid
    (``data/patching.py``), window gather from the padded image already on
    the card, batched forward (the final partial batch zero-padded to the
    batch size, as the JAX engine does), device stitch, source crop and
    instance post-processing on the card (``ops/gpu_postproc.py``). It
    returns ``(inst_map_dict, type_map_dict, pclass_map)`` as numpy and
    needs neither cv2 nor PyYAML.
  * ``postproc_backend="cpu"`` (the JAX CLIs' default) takes the stitched
    canvas to the host in one copy per image and runs the scipy/cv2 oracle
    families there (``post_process_host``, the JAX ``post_process_tile``),
    in this process or, with ``nr_post_proc_workers > 0``, in a pool of
    ``spawn`` processes that receive numpy arrays only (a forked child of a
    process that has initialised CUDA cannot use it, and the families need
    no card).
  * The records — ``instance_info``, the instance dictionaries in the 2x
    frame of the reference — come, on the ``gpu`` backend, from a
    per-instance table (``ops/inst_stats.py``) built on the card from the
    1x label maps and copied down with them (``post_process_canvas(...,
    stats=)``): the host traces each instance's contour on its own 2x
    crop and nothing else. The ``cpu`` backend has no table and runs
    ``get_inst_info_dict`` on the 2x-upscaled maps. The writer — ``.mat``
    files and the overlay on the 2x-upscaled image — and the PNG read are
    host code that imports cv2 inside its functions.

``process_file_list`` (the CLI) runs the JAX engine's cross-file batch
cache (``cerberus_tpu/infer/tile.py:201-223,269-309``, here
``cached_canvases``): sorted files are taken until more than
``CACHE_WINDOWS`` windows are cached, every cached window runs in one
stream of fixed-size batches (only the cache's last batch is zero-padded),
each batch gathered on the card from the padded images it spans, and each
file's canvas is stitched on the card from its own slice of the outputs.
``process_image`` / ``infer_canvas`` run that cache on one image, which
gives the per-image batches.
``tile_backend="fused"`` runs ``infer/fused_tile.run_fused_tile`` per file.

A job's phases run under the ``trace_span`` names of ``TILE_SPANS``, all
on the main thread and none held open across the cache's ``yield``; their
seconds are summed over the job and logged once at its end, one line a
phase under the table's label.

Kept reference quirks: lumen instances survive only inside glands, and
lumen instances are typed against the gland type map (the previous task's
upscaled type map).
"""
from __future__ import annotations

import multiprocessing
import os
import pathlib
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from ..config import DEFAULT_TARGET_LIST
from ..data.patching import make_channel_index_map, prepare_patching
from ..ops.device_postproc import KERNELS, Impl
from ..ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT, compact_present_ids
from ..ops.inst_stats import inst_info_from_stats, split_tables
from ..ops.postproc import POSTPROC_FUNC_DICT, get_inst_info_dict
from ..ops.stitch import stitch_canvas
from ..utils import log_info, mkdir, recur_find_ext
from ..utils.profiling import trace_span
from .manager import InferManager as BaseInferManager

# "gpu": families on the card ("tpu" is accepted as an alias); "cpu": the
# scipy/cv2 oracle families on the host
POSTPROC_BACKENDS = ("gpu", "tpu", "cpu")
# "host": the batch cache and a stitch per file; "fused": infer/fused_tile
TILE_BACKENDS = ("host", "fused")
# files are cached until more than this many windows are (JAX tile.py:213)
CACHE_WINDOWS = 256
# a job's phases: trace name -> the label of its total in the job's log
TILE_SPANS = {"tile/read": "Tile Read Time",
              "tile/prepare": "Tile Prepare Time",
              "tile/forward": "Tile Forward Time",
              "tile/stitch": "Tile Stitch Time",
              "tile/postproc": "Tile Postproc Time",
              "tile/instance_info": "Tile Instance Info Time",
              "tile/write": "Tile Write Time"}


def _span(name: str, totals: dict):
    """``trace_span`` of the job phase ``name``, summed into ``totals``."""
    return trace_span(name, label=TILE_SPANS[name], totals=totals)


def window_index(tl_list, size: int, device) -> tuple:
    """(P, 2) top-left (y, x) corners (an array, or a tensor already on
    ``device``) -> the (ys, xs) advanced index of the P size x size windows
    of an (H, W, ...) tensor on ``device``."""
    if not isinstance(tl_list, torch.Tensor):
        tl_list = torch.from_numpy(np.asarray(tl_list, np.int64))
    tl = tl_list.to(device)
    ar = torch.arange(size, device=device)
    ys = tl[:, 0, None] + ar
    xs = tl[:, 1, None] + ar
    return ys[:, :, None], xs[:, None, :]


def gather_windows(img: torch.Tensor, tl_list, size: int) -> torch.Tensor:
    """(H, W, C) image tensor + (P, 2) top-left (y, x) corners -> (P, size,
    size, C) windows, as one gather on the image's device. Corners given as
    a tensor on that device need no copy (and no stream sync)."""
    return img[window_index(tl_list, size, img.device)]


def post_process_canvas(canvas: torch.Tensor, postproc_code: dict,
                        postproc_list, decoder_kwargs: dict,
                        impl: Impl = KERNELS, stats: dict = None):
    """Instance post-processing of a stitched, source-cropped (H, W, C)
    device canvas (the device half of the JAX ``post_process_tile``):
    each task's family on the card, ids compacted there, lumen kept inside
    the glands (reference tile.py:187-191; its ids are not compacted
    again), and one ``inst_stats`` launch for every task's per-instance
    table. The maps, type maps, tissue classes and tables come to the host
    in one copy. Returns (inst_map_dict, type_map_dict, pclass_map) as
    numpy; given a dict as ``stats``, puts each task's table
    (``InstStats``, for ``instance_info``) in it."""
    idx_dict, _ = make_channel_index_map(decoder_kwargs)
    labels, counts, type_planes = {}, {}, {}
    pclass_map = None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code + "-INST" in postproc_code:
            family = GPU_POSTPROC_FUNC_DICT[postproc_code[tissue_code
                                                          + "-INST"]]
            s, e = idx_dict[tissue_code + "-INST"]
            labels[tissue_code], counts[tissue_code] = compact_present_ids(
                family.labels(canvas[..., s:e], tissue_code, impl=impl),
                impl)
            if tissue_code + "-TYPE" in idx_dict:
                s, e = idx_dict[tissue_code + "-TYPE"]
                type_planes[tissue_code] = canvas[..., s:e].float()
        elif tissue_code == "Patch-class" and "Patch-Class" in idx_dict:
            pclass_map = canvas[..., idx_dict["Patch-Class"][0]]
    if "Lumen" in labels and "Gland" in labels:
        labels["Lumen"] = labels["Lumen"] * (labels["Gland"] > 0)
    tasks = list(labels)
    sources = _type_sources(postproc_list, labels, type_planes)
    typed = [t for t in type_planes if t in sources.values()]
    type_ids = [type_planes[t][..., 0].to(torch.int32) for t in typed]
    sizes = torch.stack([counts[t] for t in tasks]
                        + [p.max() for p in type_ids]).tolist()
    table = impl.stats(
        torch.stack([labels[t] for t in tasks]),
        torch.stack(type_ids) if type_ids else None, sizes[:len(tasks)],
        [typed.index(sources[t]) if sources[t] else -1 for t in tasks],
        [max(m, 0) + 1 for m in sizes[len(tasks):]])
    extra = [pclass_map] if pclass_map is not None else []
    host = _to_host([table.sums, table.ints, *(labels[t] for t in tasks),
                     *(type_planes[t] for t in type_planes), *extra])
    if stats is not None:
        stats.update(zip(tasks, split_tables(table.layout, host[1],
                                             host[0])))
    inst_maps = {t: m.astype(np.float64)
                 for t, m in zip(tasks, host[2:2 + len(tasks)])}
    squeezed = dict(zip(type_planes, (
        np.squeeze(m) for m in host[2 + len(tasks):][:len(type_planes)])))
    type_maps = {t: squeezed.get(t) for t in tasks}
    return inst_maps, type_maps, host[-1] if extra else None


def _to_host(tensors) -> list:
    """Tensors of one device as numpy arrays of their shapes and dtypes,
    through one copy (one synchronisation) of their bytes."""
    parts, metas = [], []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8  # every array starts 8-byte aligned
        parts += [raw, raw.new_zeros(pad)] if pad else [raw]
        metas.append((t.shape, torch.empty(0, dtype=t.dtype).numpy().dtype,
                      raw.numel() + pad))
    buf = torch.cat(parts).cpu().numpy()
    out, start = [], 0
    for shape, dtype, nbytes in metas:
        size = int(np.prod(shape)) * dtype.itemsize
        out.append(buf[start:start + size].view(dtype).reshape(shape))
        start += nbytes
    return out


def post_process_host(canvas: np.ndarray, postproc_code: dict,
                      postproc_list, decoder_kwargs: dict):
    """The ``cpu`` backend: the scipy/cv2 oracle families on a stitched,
    source-cropped (H, W, C) numpy canvas (the JAX ``post_process_tile``
    with ``backend="cpu"``), lumen gated by the glands. Returns
    (inst_map_dict, type_map_dict, pclass_map) as ``post_process_canvas``
    does."""
    idx_dict, _ = make_channel_index_map(decoder_kwargs)
    inst_maps, type_maps = {}, {}
    pclass_map = None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code + "-INST" in postproc_code:
            proc_cls = POSTPROC_FUNC_DICT[postproc_code[tissue_code + "-INST"]]
            inst_maps[tissue_code], type_maps[tissue_code] = \
                proc_cls.post_process(canvas, idx_dict, tissue_code)
        elif tissue_code == "Patch-class" and "Patch-Class" in idx_dict:
            pclass_map = canvas[..., idx_dict["Patch-Class"][0]]
    # lumen predictions only survive inside glands (reference tile.py:187-191)
    if "Lumen" in inst_maps and "Gland" in inst_maps:
        gland = (inst_maps["Gland"] > 0).astype(inst_maps["Lumen"].dtype)
        inst_maps["Lumen"] = gland * inst_maps["Lumen"]
    return inst_maps, type_maps, pclass_map


def _host_postproc_and_info(canvas: np.ndarray, postproc_code: dict,
                            postproc_list, decoder_kwargs: dict):
    """Pool worker of the ``cpu`` backend: ``post_process_host`` and the
    instance dictionaries, from and to numpy only. Returns (inst_maps,
    inst_info, type_maps, pclass_map), ``save_results``'s order."""
    inst_maps, type_maps, pclass_map = post_process_host(
        canvas, postproc_code, postproc_list, decoder_kwargs)
    return (inst_maps, instance_info(inst_maps, type_maps, postproc_list),
            type_maps, pclass_map)


def _upscale2x(arr: np.ndarray) -> np.ndarray:
    """2x nearest-neighbour upscale (cv2.resize INTER_NEAREST, fx=fy=2)."""
    return np.repeat(np.repeat(arr, 2, axis=0), 2, axis=1)


def _type_sources(postproc_list, inst_maps: dict, type_maps: dict) -> dict:
    """Each task of ``inst_maps``, in ``postproc_list``'s order -> the task
    whose type map types its instances, or None: the last task so far,
    lumen excepted, with a type map (lumen, without a TYPE head, takes the
    gland's, as in the reference)."""
    sources, last = {}, None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code not in inst_maps:
            continue
        if tissue_code != "Lumen" and type_maps.get(tissue_code) is not None:
            last = tissue_code
        sources[tissue_code] = last
    return sources


def instance_info(inst_maps: dict, type_maps: dict, postproc_list,
                  stats: dict = None) -> dict:
    """Per-task instance dictionaries in the 2x-upscaled frame. With the
    tables that ``post_process_canvas(..., stats=)`` filled, from them and
    each instance's own crop; without (the ``cpu`` backend), by
    ``get_inst_info_dict`` on the 2x-upscaled maps. The two are equal."""
    sources = _type_sources(postproc_list, inst_maps, type_maps)
    if stats:
        return {task: inst_info_from_stats(inst_maps[task], stats[task])
                for task in sources}
    info, upscaled = {}, {}
    for task, source in sources.items():
        if source is not None and source not in upscaled:
            upscaled[source] = _upscale2x(type_maps[source])
        info[task] = get_inst_info_dict(_upscale2x(inst_maps[task]),
                                        upscaled.get(source))
    return info


def save_results(save_root_dir: str, base_name: str, src_image: np.ndarray,
                 inst_maps: dict, inst_info: dict, type_maps: dict,
                 pclass_map, viz_info) -> None:
    """Write ``overlay/<name>.jpg`` and ``<task>_mat/<name>.mat`` with the
    JAX CLI's keys ({inst_map, type, id[, type_map]}, {pclass})."""
    import cv2
    import scipy.io as sio

    from ..utils.viz import visualize_instances_dict

    mkdir("%s/overlay/" % save_root_dir)
    overlay = visualize_instances_dict(_upscale2x(src_image), inst_info,
                                       viz_info)
    overlay = cv2.cvtColor(overlay, cv2.COLOR_BGR2RGB)
    cv2.imwrite("%s/overlay/%s.jpg" % (save_root_dir, base_name), overlay)
    for tissue_code, pred_inst in inst_maps.items():
        info = inst_info[tissue_code]
        mkdir("%s/%s_mat/" % (save_root_dir, tissue_code.lower()))
        mat_dict = {"inst_map": pred_inst,
                    "type": [d.get("type", -1) for d in info.values()],
                    "id": list(info.keys())}
        if type_maps[tissue_code] is not None:
            mat_dict["type_map"] = type_maps[tissue_code]
        sio.savemat("%s/%s_mat/%s.mat" % (save_root_dir, tissue_code.lower(),
                                          base_name), mat_dict)
    if pclass_map is not None:
        mkdir("%s/pclass_mat/" % save_root_dir)
        sio.savemat("%s/pclass_mat/%s.mat" % (save_root_dir, base_name),
                    {"pclass": pclass_map})


class InferManager(BaseInferManager):
    """Tile-mode inference (images < ~5000^2)."""

    batch_size = 10
    patch_input_shape = 448
    patch_output_shape = 144
    patch_output_overlap = 0
    postproc_list = DEFAULT_TARGET_LIST

    def infer_canvas(self, img: np.ndarray) -> torch.Tensor:
        """RGB uint8 (H, W, 3) image -> stitched, source-cropped f32
        (H, W, C) canvas on the device, from this image's own batches (the
        batch cache over this one image)."""
        return next(self.cached_canvases([(None, img)]))[2]

    def step_padded(self, batch: torch.Tensor,
                    sharded: bool = True) -> torch.Tensor:
        """The step on ``batch`` zero-padded to the batch size; the padding
        rows' outputs are dropped. ``sharded=False``: on the manager's
        device alone, mesh or not (``device_step``)."""
        valid, batch_size = batch.shape[0], int(self.batch_size)
        if valid < batch_size:
            batch = torch.cat([batch, batch.new_zeros(
                (batch_size - valid, *batch.shape[1:]))])
        step = self.run_step if sharded else self.device_step
        return step(batch, int(self.patch_output_shape))[:valid]

    def _stitch(self, outputs, patch_info, padded_hw, src_pos, src_hw):
        canvas = stitch_canvas(outputs, patch_info[:, 1, 0], padded_hw,
                               self.patch_output_overlap != 0)
        return canvas[src_pos[0]:src_pos[0] + src_hw[0],
                      src_pos[1]:src_pos[1] + src_hw[1]]

    def cached_canvases(self, items: Iterable[Tuple[object, np.ndarray]],
                        totals: dict = None
                        ) -> Iterator[Tuple[object, np.ndarray,
                                            torch.Tensor]]:
        """The cross-file batch cache over ``items``, (key, RGB uint8
        image) pairs read lazily in order: yields (key, image, stitched
        source-cropped f32 device canvas) per image, in order.

        Images are taken until more than ``CACHE_WINDOWS`` windows are
        cached; the cache's windows, file after file, run as one stream of
        fixed-size batches, each gathered on the card from the padded
        images it spans (the JAX ``_run_cached`` job order). Only the
        cache's last batch is zero-padded. The outputs stay in the step's
        dtype (f16 on the card) until each image's canvas is stitched.
        The seconds of its ``tile/prepare``, ``tile/forward`` and
        ``tile/stitch`` spans are added to ``totals``."""
        totals = {} if totals is None else totals
        in_shape = int(self.patch_input_shape)
        batch_size = int(self.batch_size)
        items = iter(items)
        while True:
            cache: List[tuple] = []
            n_windows = 0
            for key, img in items:
                with _span("tile/prepare", totals):
                    padded, patch_info, src_pos = prepare_patching(
                        img, in_shape, int(self.patch_output_shape),
                        self.patch_output_overlap)
                    dev_img = torch.from_numpy(
                        np.ascontiguousarray(padded)).to(self.device)
                    # the input top-lefts, uploaded once: no copy in the
                    # loop
                    in_tl = torch.from_numpy(
                        patch_info[:, 0, 0].astype(np.int64)).to(self.device)
                cache.append((key, img, dev_img, in_tl, patch_info, src_pos))
                n_windows += len(patch_info)
                if n_windows > CACHE_WINDOWS:
                    break
            if not cache:
                return
            bounds = np.cumsum([0] + [len(c[4]) for c in cache])
            outputs: List[list] = [[] for _ in cache]
            with _span("tile/forward", totals):
                for start in range(0, n_windows, batch_size):
                    end = min(start + batch_size, n_windows)
                    spans = [(f, max(start, bounds[f]) - bounds[f],
                              min(end, bounds[f + 1]) - bounds[f])
                             for f in range(len(cache))
                             if bounds[f] < end and start < bounds[f + 1]]
                    parts = [gather_windows(cache[f][2], cache[f][3][lo:hi],
                                            in_shape) for f, lo, hi in spans]
                    out = self.step_padded(
                        parts[0] if len(parts) == 1 else torch.cat(parts))
                    offset = 0
                    for f, lo, hi in spans:
                        outputs[f].append(out[offset:offset + hi - lo])
                        offset += hi - lo
            for f, (key, img, dev_img, _, patch_info, src_pos) in enumerate(
                    cache):
                # the span closes before the yield: the consumer's phases
                # are not nested in it
                with _span("tile/stitch", totals):
                    canvas = self._stitch(torch.cat(outputs[f]), patch_info,
                                          dev_img.shape[:2], src_pos,
                                          img.shape[:2])
                outputs[f] = None
                yield key, img, canvas

    def process_image(self, img: np.ndarray):
        """RGB uint8 (H, W, 3) image -> (inst_map_dict, type_map_dict,
        pclass_map), everything up to the label maps on the device."""
        return post_process_canvas(self.infer_canvas(img), self.decoder_dict,
                                   self.postproc_list,
                                   self.cfg.active_decoder_kwargs)

    def _files_to_do(self) -> list:
        """Sorted input images missing an output (skip-if-done on the
        directories actually written, ``pclass_mat`` for Patch-Class)."""
        todo = []
        for file_path in recur_find_ext(self.input_dir, [".png", ".jpg"]):
            base_name = pathlib.Path(file_path).stem
            missing = sum(
                not os.path.exists("%s/%s_mat/%s.mat" % (
                    self.output_dir,
                    "pclass" if t == "patch-class" else t, base_name))
                for t in self.postproc_list
                if (t.capitalize() + "-INST" in self.decoder_dict
                    or (t == "patch-class"
                        and "Patch-Class" in self.decoder_dict)))
            if missing > 0:
                todo.append(file_path)
        return sorted(todo)

    def process_file_list(self, run_args: dict) -> None:
        import cv2

        from ..utils.viz import load_viz_info

        for variable, value in run_args.items():
            setattr(self, variable, value)
        backend = getattr(self, "postproc_backend", "gpu")
        if backend not in POSTPROC_BACKENDS:
            raise ValueError("postproc_backend=%r: use one of %s"
                             % (backend, POSTPROC_BACKENDS))
        tile_backend = getattr(self, "tile_backend", "host")
        if tile_backend not in TILE_BACKENDS:
            raise ValueError("tile_backend=%r: use one of %s"
                             % (tile_backend, TILE_BACKENDS))
        viz_info = load_viz_info()
        file_path_list = self._files_to_do()
        assert len(file_path_list) > 0, "Not Detected Any Files From Path"

        totals: dict = {}  # the job's seconds per phase label

        def read(file_path):
            with _span("tile/read", totals):
                img = cv2.cvtColor(cv2.imread(file_path), cv2.COLOR_BGR2RGB)
            return pathlib.Path(file_path).stem, img

        def fused(items):
            from .fused_tile import run_fused_tile

            for name, img in items:
                with _span("tile/forward", totals):
                    canvas = run_fused_tile(self, img)
                yield name, img, canvas

        if tile_backend == "fused":
            canvases = fused(map(read, file_path_list))
        else:
            canvases = self.cached_canvases(map(read, file_path_list),
                                            totals)

        def finish(name, img, inst_maps, type_maps, pclass_map, info=None,
                   stats=None):
            if info is None:
                with _span("tile/instance_info", totals):
                    info = instance_info(inst_maps, type_maps,
                                         self.postproc_list, stats)
            with _span("tile/write", totals):
                save_results(self.output_dir, name, img, inst_maps, info,
                             type_maps, pclass_map, viz_info)
            log_info("Done Assembling %s" % name)

        pool = None
        if backend == "cpu" and int(getattr(self, "nr_post_proc_workers", 0)
                                    or 0) > 0:
            pool = ProcessPoolExecutor(
                int(self.nr_post_proc_workers),
                mp_context=multiprocessing.get_context("spawn"))
        try:
            futures = {}
            for name, img, canvas in canvases:
                stats = None
                with _span("tile/postproc", totals):
                    if backend != "cpu":
                        stats = {}
                        maps = post_process_canvas(
                            canvas, self.decoder_dict, self.postproc_list,
                            self.cfg.active_decoder_kwargs, stats=stats)
                    else:
                        # one copy of the stitched canvas to the host per
                        # image
                        args = (canvas.cpu().numpy(), self.decoder_dict,
                                self.postproc_list,
                                self.cfg.active_decoder_kwargs)
                        if pool is None:
                            maps = post_process_host(*args)
                        else:
                            futures[pool.submit(_host_postproc_and_info,
                                                *args)] = (name, img)
                            continue
                finish(name, img, *maps, stats=stats)
            # as the JAX engine: a failed worker is logged and its image
            # left without outputs; the others are written
            for fut in as_completed(futures):
                name, img = futures[fut]
                if fut.exception() is not None:
                    log_info("Postproc worker failed: %r" % fut.exception())
                    continue
                inst_maps, info, type_maps, pclass_map = fut.result()
                finish(name, img, inst_maps, type_maps, pclass_map, info)
        finally:
            if pool is not None:
                pool.shutdown()
        for label in TILE_SPANS.values():
            if label in totals:
                log_info("%s: %.4f" % (label, totals[label]))
