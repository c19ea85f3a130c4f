"""Instance-info extraction on the host (a copy of
``cerberus_tpu/ops/postproc.py:175-267``; reference ``loader/postproc.py``
:12-98). cv2 and scipy are imported inside the function.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def get_inst_info_dict(inst_map: np.ndarray, type_map: Optional[np.ndarray],
                       ds_factor: float = 1.0) -> Dict:
    """Per-instance {box, centroid, contour[, type, type_prob]} dictionary.

    Output format identical to the reference (boxes [[rmin,cmin],[rmax,cmax]]
    with exclusive max, centroids/contours in XY, types by in-mask majority
    vote with background demoted to runner-up). Instances whose simplified
    contour has <3 points are skipped.
    """
    import cv2
    from scipy import ndimage

    inst_map = np.asarray(inst_map)
    inst_ids = np.unique(inst_map)
    inst_ids = inst_ids[inst_ids != 0]
    inst_info_dict: Dict = {}
    if inst_ids.size == 0:
        return inst_info_dict

    lab64 = inst_map.astype(np.int64)
    objects = ndimage.find_objects(lab64)
    for inst_id in inst_ids:
        slc = objects[int(inst_id) - 1]
        if slc is None:
            continue
        rmin, rmax = slc[0].start, slc[0].stop
        cmin, cmax = slc[1].start, slc[1].stop
        inst_bbox = np.array([[rmin, cmin], [rmax, cmax]])
        single = (lab64[rmin:rmax, cmin:cmax] == inst_id).astype(np.uint8)
        inst_moment = cv2.moments(single)
        contours = cv2.findContours(single, cv2.RETR_TREE,
                                    cv2.CHAIN_APPROX_SIMPLE)
        inst_contour = np.squeeze(contours[0][0].astype("int32"))
        if inst_contour.ndim != 2 or inst_contour.shape[0] < 3:
            continue
        if inst_moment["m00"] == 0:
            continue
        inst_centroid = np.array([
            inst_moment["m10"] / inst_moment["m00"],
            inst_moment["m01"] / inst_moment["m00"],
        ])
        inst_contour = inst_contour + np.array([[cmin, rmin]])  # to XY
        inst_centroid = inst_centroid + np.array([cmin, rmin])
        inst_info_dict[inst_id] = {
            "box": inst_bbox,
            "centroid": inst_centroid,
            "contour": inst_contour,
        }

    if type_map is not None:
        type_map_i = np.asarray(type_map).astype(np.int32)
        n_types = int(type_map_i.max()) + 1 if type_map_i.size else 1
        max_id = int(inst_map.max())
        # one joint bincount: counts[inst_id, type] for every instance at
        # once (mask first — ids*n_types on foreground pixels only), then
        # the majority vote / bg-demotion for ALL instances in one argsort
        # (per-id python argsorts measured ~40% of this function's steady
        # time on a 5k-instance canvas)
        fg = lab64 > 0
        # int32 halves the bincount input traffic; ids on any real canvas
        # are far below the wrap point, but guard the narrowing explicitly
        idx_dtype = (np.int32 if (max_id + 1) * n_types < 2 ** 31
                     else np.int64)
        joint = np.bincount(
            lab64[fg].astype(idx_dtype) * idx_dtype(n_types)
            + type_map_i[fg].astype(idx_dtype),
            minlength=(max_id + 1) * n_types,
        ).reshape(max_id + 1, n_types)
        order = np.argsort(-joint, axis=1, kind="stable")
        top = order[:, 0]
        runner = order[:, 1] if n_types > 1 else top
        n_nonzero = (joint != 0).sum(axis=1)
        # background majority demotes to the runner-up when any other type
        # is present (reference quirk)
        inst_type_all = np.where((top == 0) & (n_nonzero > 1), runner, top)
        totals = joint.sum(axis=1)
        probs_all = joint[np.arange(max_id + 1), inst_type_all] / (
            totals + 1.0e-6)
        for inst_id in list(inst_info_dict.keys()):
            inst_info_dict[inst_id]["type"] = int(inst_type_all[int(inst_id)])
            inst_info_dict[inst_id]["type_prob"] = float(
                probs_all[int(inst_id)])

    if ds_factor != 1.0:
        for inst_id in list(inst_info_dict.keys()):
            info = inst_info_dict[inst_id]
            rescaled = {
                "box": np.round(info["box"] / ds_factor).astype("int"),
                "centroid": np.round(info["centroid"] / ds_factor).astype("int"),
                "contour": np.round(info["contour"] / ds_factor).astype("int"),
            }
            if "type" in info:
                rescaled["type"] = info["type"]
                rescaled["type_prob"] = info["type_prob"]
            inst_info_dict[inst_id] = rescaled
    return inst_info_dict
