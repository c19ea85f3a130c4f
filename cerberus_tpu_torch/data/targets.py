"""Ground-truth target encoding for multi-task training.

Behavioral spec (reference ``loader/targets.py``):
  * ``IP``: binary foreground;
  * ``IP-ERODED-{3,11}``: per-instance elliptical erosion -> [bg, inner,
    U-Net weight map] (:67-106);
  * ``IP-ERODED-CONTOUR-{3,11}``: erode + dilate per instance -> [bg,
    {1=inner, 2=contour} positive map, weight map] (:109-159);
  * ``NP``/``TP``/``PC``: binary nuclei / raw type map / patch class;
  * ``unet_weight_map``: classic boundary weighting
    ``w0 * exp(-((d1+d2)/sigma)^2 / 2)``, zeroed inside instances (:12-57);
  * ``gen_targets``: target dict + per-channel has/dummy flags for MTL
    batches (:185-244). Note the reference emits duplicate dict keys for the
    [bg, positive] pair so only the positive map survives — we emit the
    positive map directly.

The per-instance erode/dilate loops run over instance bounding boxes (one
``find_objects`` pass) rather than full-image masks per id.

A copy of ``cerberus_tpu/data/targets.py`` with cv2 and scipy imported
inside the functions that use them: the same bytes for the same inputs.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.geometry import cropping_center, get_bounding_box
from .augs import fix_mirror_padding


def unet_weight_map(ann: np.ndarray, inst_list, w0: float = 10.0,
                    sigma: float = 3.0, decay_margin: int = 10) -> np.ndarray:
    """U-Net boundary weight map from the two nearest instance distances."""
    from scipy.ndimage import distance_transform_edt

    if len(inst_list) <= 1:
        return np.zeros(ann.shape[:2])
    stacked = np.full(ann.shape[:2] + (len(inst_list),), 1000, np.float32)
    hw = np.array(ann.shape[:2])
    for idx, inst_id in enumerate(inst_list):
        fgd = np.array(ann == inst_id, np.uint8)
        rmin, rmax, cmin, cmax = get_bounding_box(fgd)
        tl = np.maximum(np.array([rmin, cmin]) - decay_margin, 0)
        br = np.minimum(np.array([rmax, cmax]) + decay_margin, hw)
        bgd = (fgd[tl[0]:br[0], tl[1]:br[1]] == 0).astype(np.uint8)
        stacked[tl[0]:br[0], tl[1]:br[1], idx] = distance_transform_edt(bgd)
    near2 = np.partition(stacked, 1, axis=-1)[..., 0:2]
    weight = (near2[..., 0] + near2[..., 1]) / sigma
    weight = w0 * np.exp(-(weight ** 2) / 2)
    weight[ann > 0] = 0
    return weight


def _per_instance_morph(fixed_ann: np.ndarray, inst_ids, ksize: int,
                        dilate_too: bool):
    """inner (and optionally contour) maps via bbox-local morphology."""
    import cv2
    from scipy import ndimage

    k_disk = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    inner_map = np.zeros(fixed_ann.shape[:2], np.uint8)
    contour_map = np.zeros(fixed_ann.shape[:2], np.uint8)
    h, w = fixed_ann.shape[:2]
    objects = ndimage.find_objects(fixed_ann.astype(np.int64))
    pad = ksize + 1
    for inst_id in inst_ids:
        slc = objects[int(inst_id) - 1] if int(inst_id) - 1 < len(objects) \
            else None
        if slc is None:
            continue
        y1 = max(slc[0].start - pad, 0)
        y2 = min(slc[0].stop + pad, h)
        x1 = max(slc[1].start - pad, 0)
        x2 = min(slc[1].stop + pad, w)
        inst = (fixed_ann[y1:y2, x1:x2] == inst_id).astype(np.uint8)
        inner = cv2.erode(inst, k_disk, iterations=1)
        inner_map[y1:y2, x1:x2] += inner
        if dilate_too:
            outer = cv2.dilate(inst, k_disk, iterations=1)
            contour_map[y1:y2, x1:x2] += outer - inner
    return inner_map, contour_map


class InstPixelMap:
    output_ch_code = [""]

    def __call__(self, ann, *args, **kwargs):
        return [(ann > 0).astype(np.int32)]


class _ErodedBase:
    def __init__(self, ksize: int, with_contour: bool):
        self.ksize = ksize
        self.with_contour = with_contour

    # channel codes: positive map + weight map (the reference's duplicate-key
    # [bg, positive] pair collapses to the positive map in its target dict)
    output_ch_code = ["", "#WEIGHT-MAP"]

    def __call__(self, ann, crop_shape, gen_unet_weight_map=True, **kwargs):
        from scipy import ndimage

        fixed_ann = fix_mirror_padding(ann.copy())
        crop_ann = cropping_center(fixed_ann, crop_shape)
        inst_ids = np.unique(crop_ann)
        inst_ids = inst_ids[inst_ids != 0]

        inner_map, contour_map = _per_instance_morph(
            fixed_ann, inst_ids, self.ksize, self.with_contour)

        if gen_unet_weight_map:
            inner_label, _ = ndimage.label(inner_map)
            ids = np.unique(inner_label)
            ids = ids[ids != 0].tolist()
            weight_map = unet_weight_map(inner_label, ids, sigma=self.ksize)
        else:
            weight_map = np.zeros(ann.shape[:2])
        weight_map = weight_map + 1

        inner_map = (inner_map > 0).astype(np.int32)
        if self.with_contour:
            contour_map = (contour_map > 0).astype(np.int32)
            positive_map = inner_map + 2 * contour_map
        else:
            positive_map = inner_map
        return [positive_map.astype(np.int32), weight_map]


class InstErodedMap(_ErodedBase):
    def __init__(self, ksize):
        super().__init__(ksize, with_contour=False)


class InstErodedContourMap(_ErodedBase):
    def __init__(self, ksize):
        super().__init__(ksize, with_contour=True)


class TypePixelMap:
    output_ch_code = [""]

    def __call__(self, ann, *args, **kwargs):
        return [ann.astype(np.int32)]


class NucleiPixelMap:
    output_ch_code = [""]

    def __call__(self, ann, *args, **kwargs):
        out = ann.copy()
        out[out > 0] = 1
        return [out.astype(np.int32)]


class PatchClass:
    output_ch_code = [""]

    def __call__(self, ann, *args, **kwargs):
        return [np.asarray(ann).astype(np.int32)]


TARGET_GETTER_DICT = {
    "IP": InstPixelMap(),
    "IP-ERODED-3": InstErodedMap(ksize=3),
    "IP-ERODED-11": InstErodedMap(ksize=11),
    "IP-ERODED-CONTOUR-3": InstErodedContourMap(ksize=3),
    "IP-ERODED-CONTOUR-11": InstErodedContourMap(ksize=11),
    "NP": NucleiPixelMap(),
    "TP": TypePixelMap(),
    "PC": PatchClass(),
}


def gen_targets(ann: np.ndarray, channel: List[str],
                channel_to_target: Dict[str, str], crop_shape,
                task_mode: str = "seg", **kwargs
                ) -> Tuple[Dict[str, np.ndarray], List[Optional[str]]]:
    """Encode GT channels into per-head target maps.

    Returns (target_dict, has_flag): target_dict maps ``<head>[#WEIGHT-MAP]``
    to HWC arrays center-cropped to ``crop_shape``; has_flag lists, per
    emitted channel, the channel code when real GT was present and None when
    the map is a dummy zero fill (the MTL dummy-batch protocol).
    """
    has_flag: List[Optional[str]] = []
    new_ch_list, new_ch_code = [], []
    for ch_code, tg_code in channel_to_target.items():
        getter = TARGET_GETTER_DICT[tg_code]
        sub_codes = [ch_code + c for c in getter.output_ch_code]
        if ch_code not in channel:
            maps = [np.zeros(list(ann.shape[:2])) for _ in sub_codes]
            has_flag.extend([None] * len(sub_codes))
        else:
            if task_mode == "seg":
                ann_ch = ann[..., channel.index(ch_code)].copy()
            else:
                ann_ch = ann
            maps = getter(ann_ch, crop_shape, **kwargs)
            has_flag.extend(sub_codes)
        new_ch_list.extend(maps)
        new_ch_code.extend(sub_codes)

    assert len(new_ch_list) == len(new_ch_code)
    new_ch_list = [cropping_center(np.asarray(ch), crop_shape)
                   if np.asarray(ch).ndim >= 2 else np.asarray(ch)
                   for ch in new_ch_list]
    new_ch_list = [v[..., None] if v.ndim == 2 else v for v in new_ch_list]
    return collections.OrderedDict(zip(new_ch_code, new_ch_list)), has_flag
