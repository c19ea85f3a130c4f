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
  * The writer — ``instance_info`` (2x nearest upscale + instance dicts),
    ``.mat`` files, overlay, PNG read — is host code that imports cv2 inside
    its functions.

Kept reference quirks: lumen instances survive only inside glands, and
lumen instances are typed against the gland type map (the previous task's
upscaled type map). Each image runs its own batches; the JAX engine's
cross-file batch cache and its native C++ patch gather are not ported.
"""
from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from ..config import DEFAULT_TARGET_LIST
from ..data.patching import make_channel_index_map, prepare_patching
from ..ops.device_postproc import KERNELS, Impl
from ..ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT
from ..ops.postproc import get_inst_info_dict
from ..ops.stitch import stitch_canvas
from ..utils import log_info, mkdir, recur_find_ext
from .manager import InferManager as BaseInferManager

POSTPROC_BACKENDS = ("gpu", "tpu")  # "tpu" is accepted as an alias


def gather_windows(img: torch.Tensor, tl_list, size: int) -> torch.Tensor:
    """(H, W, C) image tensor + (P, 2) top-left (y, x) corners -> (P, size,
    size, C) windows, as one gather on the image's device."""
    ar = torch.arange(size, device=img.device)
    tl = torch.as_tensor(np.asarray(tl_list, np.int64), device=img.device)
    ys = tl[:, 0, None] + ar
    xs = tl[:, 1, None] + ar
    return img[ys[:, :, None], xs[:, None, :]]


def post_process_canvas(canvas: torch.Tensor, postproc_code: dict,
                        postproc_list, decoder_kwargs: dict,
                        impl: Impl = KERNELS):
    """Instance post-processing of a stitched, source-cropped (H, W, C)
    device canvas (the device half of the JAX ``post_process_tile``).
    Returns (inst_map_dict, type_map_dict, pclass_map) as numpy."""
    idx_dict, _ = make_channel_index_map(decoder_kwargs)
    inst_maps, type_maps = {}, {}
    pclass_map = None
    for tissue_code in postproc_list:
        tissue_code = tissue_code.capitalize()
        if tissue_code + "-INST" in postproc_code:
            proc_cls = GPU_POSTPROC_FUNC_DICT[
                postproc_code[tissue_code + "-INST"]]
            inst_maps[tissue_code], type_maps[tissue_code] = \
                proc_cls.post_process(canvas, idx_dict, tissue_code,
                                      impl=impl)
        elif tissue_code == "Patch-class" and "Patch-Class" in idx_dict:
            pclass_map = canvas[..., idx_dict["Patch-Class"][0]].cpu().numpy()
    # lumen predictions only survive inside glands (reference tile.py:187-191)
    if "Lumen" in inst_maps and "Gland" in inst_maps:
        gland = (inst_maps["Gland"] > 0).astype(inst_maps["Lumen"].dtype)
        inst_maps["Lumen"] = gland * inst_maps["Lumen"]
    return inst_maps, type_maps, pclass_map


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
        (H, W, C) canvas on the device."""
        in_shape = int(self.patch_input_shape)
        out_shape = int(self.patch_output_shape)
        batch_size = int(self.batch_size)
        padded, patch_info, src_pos = prepare_patching(
            img, in_shape, out_shape, self.patch_output_overlap)
        dev_img = torch.from_numpy(np.ascontiguousarray(padded)).to(
            self.device)
        in_tl = patch_info[:, 0, 0]
        outputs = []
        for start in range(0, len(in_tl), batch_size):
            batch = gather_windows(dev_img, in_tl[start:start + batch_size],
                                   in_shape)
            valid = batch.shape[0]
            if valid < batch_size:
                batch = torch.cat([batch, batch.new_zeros(
                    (batch_size - valid, *batch.shape[1:]))])
            outputs.append(self.run_step(batch, out_shape)[:valid])
        canvas = stitch_canvas(torch.cat(outputs), patch_info[:, 1, 0],
                               padded.shape[:2],
                               self.patch_output_overlap != 0)
        h, w = img.shape[:2]
        return canvas[src_pos[0]:src_pos[0] + h, src_pos[1]:src_pos[1] + w]

    def process_image(self, img: np.ndarray):
        """RGB uint8 (H, W, 3) image -> (inst_map_dict, type_map_dict,
        pclass_map), everything up to the label maps on the device."""
        return post_process_canvas(self.infer_canvas(img), self.decoder_dict,
                                   self.postproc_list,
                                   self.cfg.active_decoder_kwargs)

    def process_file_list(self, run_args: dict) -> None:
        import cv2

        from ..utils.viz import load_viz_info

        for variable, value in run_args.items():
            setattr(self, variable, value)
        backend = getattr(self, "postproc_backend", "gpu")
        if backend not in POSTPROC_BACKENDS:
            raise NotImplementedError(
                "postproc_backend=%r is not ported yet (use gpu)" % backend)
        if getattr(self, "tile_backend", "host") != "host":
            raise NotImplementedError("tile_backend=%r is not ported yet"
                                      % self.tile_backend)
        viz_info = load_viz_info()

        file_path_list = []
        for file_path in recur_find_ext(self.input_dir, [".png", ".jpg"]):
            base_name = pathlib.Path(file_path).stem
            # skip-if-done on the directories actually written (pclass_mat)
            missing = sum(
                not os.path.exists("%s/%s_mat/%s.mat" % (
                    self.output_dir,
                    "pclass" if t == "patch-class" else t, base_name))
                for t in self.postproc_list
                if (t.capitalize() + "-INST" in self.decoder_dict
                    or (t == "patch-class"
                        and "Patch-Class" in self.decoder_dict)))
            if missing > 0:
                file_path_list.append(file_path)
        assert len(file_path_list) > 0, "Not Detected Any Files From Path"

        for file_path in sorted(file_path_list):
            img = cv2.cvtColor(cv2.imread(file_path), cv2.COLOR_BGR2RGB)
            inst_maps, type_maps, pclass_map = self.process_image(img)
            info = instance_info(inst_maps, type_maps, self.postproc_list)
            name = pathlib.Path(file_path).stem
            save_results(self.output_dir, name, img, inst_maps, info,
                         type_maps, pclass_map, viz_info)
            log_info("Done Assembling %s" % name)
