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
  * The writer — ``instance_info`` (2x nearest upscale + instance dicts),
    ``.mat`` files, overlay, PNG read — is host code that imports cv2 inside
    its functions.

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
from ..ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT
from ..ops.postproc import POSTPROC_FUNC_DICT, get_inst_info_dict
from ..ops.stitch import stitch_canvas
from ..utils import log_info, mkdir, recur_find_ext
from .manager import InferManager as BaseInferManager

# "gpu": families on the card ("tpu" is accepted as an alias); "cpu": the
# scipy/cv2 oracle families on the host
POSTPROC_BACKENDS = ("gpu", "tpu", "cpu")
# "host": the batch cache and a stitch per file; "fused": infer/fused_tile
TILE_BACKENDS = ("host", "fused")
# files are cached until more than this many windows are (JAX tile.py:213)
CACHE_WINDOWS = 256


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


def _post_process(canvas, postproc_code: dict, postproc_list,
                  decoder_kwargs: dict, families: dict, **kwargs):
    """Each task's family (from ``families``) on a stitched, source-cropped
    (H, W, C) canvas, lumen gated by the glands. Returns (inst_map_dict,
    type_map_dict, pclass_map) as numpy."""
    idx_dict, _ = make_channel_index_map(decoder_kwargs)
    inst_maps, type_maps = {}, {}
    pclass_map = None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code + "-INST" in postproc_code:
            proc_cls = families[postproc_code[tissue_code + "-INST"]]
            inst_maps[tissue_code], type_maps[tissue_code] = \
                proc_cls.post_process(canvas, idx_dict, tissue_code, **kwargs)
        elif tissue_code == "Patch-class" and "Patch-Class" in idx_dict:
            pclass_map = canvas[..., idx_dict["Patch-Class"][0]]
            if isinstance(pclass_map, torch.Tensor):
                pclass_map = pclass_map.cpu().numpy()
    # lumen predictions only survive inside glands (reference tile.py:187-191)
    if "Lumen" in inst_maps and "Gland" in inst_maps:
        gland = (inst_maps["Gland"] > 0).astype(inst_maps["Lumen"].dtype)
        inst_maps["Lumen"] = gland * inst_maps["Lumen"]
    return inst_maps, type_maps, pclass_map


def post_process_canvas(canvas: torch.Tensor, postproc_code: dict,
                        postproc_list, decoder_kwargs: dict,
                        impl: Impl = KERNELS):
    """Instance post-processing of a stitched, source-cropped (H, W, C)
    device canvas (the device half of the JAX ``post_process_tile``).
    Returns (inst_map_dict, type_map_dict, pclass_map) as numpy."""
    return _post_process(canvas, postproc_code, postproc_list,
                         decoder_kwargs, GPU_POSTPROC_FUNC_DICT, impl=impl)


def post_process_host(canvas: np.ndarray, postproc_code: dict,
                      postproc_list, decoder_kwargs: dict):
    """The ``cpu`` backend: the scipy/cv2 oracle families on a stitched,
    source-cropped (H, W, C) numpy canvas (the JAX ``post_process_tile``
    with ``backend="cpu"``). Returns (inst_map_dict, type_map_dict,
    pclass_map) as ``post_process_canvas`` does."""
    return _post_process(canvas, postproc_code, postproc_list,
                         decoder_kwargs, POSTPROC_FUNC_DICT)


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


def instance_info(inst_maps: dict, type_maps: dict, postproc_list) -> dict:
    """Per-task instance dictionaries from the 2x-upscaled maps. Lumen (no
    TYPE head) is typed against the previous task's type map, as in the
    reference."""
    info = {}
    type_tmp = None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code not in inst_maps:
            continue
        inst_tmp = _upscale2x(inst_maps[tissue_code])
        if tissue_code != "Lumen" and type_maps[tissue_code] is not None:
            type_tmp = _upscale2x(type_maps[tissue_code])
        info[tissue_code] = get_inst_info_dict(inst_tmp, type_tmp)
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

    def step_padded(self, batch: torch.Tensor) -> torch.Tensor:
        """The step on ``batch`` zero-padded to the batch size; the padding
        rows' outputs are dropped."""
        valid, batch_size = batch.shape[0], int(self.batch_size)
        if valid < batch_size:
            batch = torch.cat([batch, batch.new_zeros(
                (batch_size - valid, *batch.shape[1:]))])
        return self.run_step(batch, int(self.patch_output_shape))[:valid]

    def _stitch(self, outputs, patch_info, padded_hw, src_pos, src_hw):
        canvas = stitch_canvas(outputs, patch_info[:, 1, 0], padded_hw,
                               self.patch_output_overlap != 0)
        return canvas[src_pos[0]:src_pos[0] + src_hw[0],
                      src_pos[1]:src_pos[1] + src_hw[1]]

    def cached_canvases(self, items: Iterable[Tuple[object, np.ndarray]]
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
        dtype (f16 on the card) until each image's canvas is stitched."""
        in_shape = int(self.patch_input_shape)
        batch_size = int(self.batch_size)
        items = iter(items)
        while True:
            cache: List[tuple] = []
            n_windows = 0
            for key, img in items:
                padded, patch_info, src_pos = prepare_patching(
                    img, in_shape, int(self.patch_output_shape),
                    self.patch_output_overlap)
                dev_img = torch.from_numpy(np.ascontiguousarray(padded)).to(
                    self.device)
                # the input top-lefts, uploaded once: no copy in the loop
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

        def read(file_path):
            img = cv2.cvtColor(cv2.imread(file_path), cv2.COLOR_BGR2RGB)
            return pathlib.Path(file_path).stem, img

        if tile_backend == "fused":
            from .fused_tile import run_fused_tile

            canvases = ((name, img, run_fused_tile(self, img))
                        for name, img in map(read, file_path_list))
        else:
            canvases = self.cached_canvases(map(read, file_path_list))

        pool = None
        if backend == "cpu" and int(getattr(self, "nr_post_proc_workers", 0)
                                    or 0) > 0:
            pool = ProcessPoolExecutor(
                int(self.nr_post_proc_workers),
                mp_context=multiprocessing.get_context("spawn"))
        try:
            futures = {}
            for name, img, canvas in canvases:
                if backend != "cpu":
                    inst_maps, type_maps, pclass_map = post_process_canvas(
                        canvas, self.decoder_dict, self.postproc_list,
                        self.cfg.active_decoder_kwargs)
                    info = instance_info(inst_maps, type_maps,
                                         self.postproc_list)
                    save_results(self.output_dir, name, img, inst_maps, info,
                                 type_maps, pclass_map, viz_info)
                    log_info("Done Assembling %s" % name)
                    continue
                # one copy of the stitched canvas to the host per image
                args = (canvas.cpu().numpy(), self.decoder_dict,
                        self.postproc_list, self.cfg.active_decoder_kwargs)
                if pool is None:
                    save_results(self.output_dir, name, img,
                                 *_host_postproc_and_info(*args),
                                 viz_info)
                    log_info("Done Assembling %s" % name)
                else:
                    futures[pool.submit(_host_postproc_and_info, *args)] = \
                        (name, img)
            # as the JAX engine: a failed worker is logged and its image
            # left without outputs; the others are written
            for fut in as_completed(futures):
                name, img = futures[fut]
                if fut.exception() is not None:
                    log_info("Postproc worker failed: %r" % fut.exception())
                    continue
                save_results(self.output_dir, name, img,
                             *fut.result(), viz_info)
                log_info("Done Assembling %s" % name)
        finally:
            if pool is not None:
                pool.shutdown()
