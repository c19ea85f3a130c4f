"""Annotation-server export (Wasabi format): a copy of
``cerberus_tpu/utils/export.py`` (reference ``misc/utils.py:348-415``).
Instance-info dicts become the Wasabi annotation JSON (point or closed
polyline elements with per-type colours), coordinates scaled.
"""
from __future__ import annotations

import json

import numpy as np


def _gen_wasabi_dict(obj_id, coords, type_name, type_color, mode, line_width):
    new_dict = {
        "fillColor": "rgba({0},{1},{2},{3})".format(*type_color),
        "id": "{:024d}".format(obj_id),
        "label": {"value": "nuclei"},
        "group": type_name,
    }
    if mode == "centroid":
        new_dict.update({
            "lineColor": "rgb(0, 0, 0)",
            "type": "point",
            "center": coords,
            "lineWidth": line_width,
        })
    elif mode == "contour":
        new_dict.update({
            "lineColor": "rgb({0},{1},{2})".format(*type_color),
            "type": "polyline",
            "closed": True,
            "points": coords,
            "lineWidth": line_width,
        })
    return new_dict


def to_wasabi(save_path, inst_info_dict, viz_info, mode, scale_factor,
              annotator):
    """Write instance annotations (``mode``: ``"contour"`` or
    ``"centroid"``) as a Wasabi JSON document at ``save_path``."""
    line_width = viz_info["line_width"]

    ann_list_all, type_list_all = [], []
    for _idx, inst_info in inst_info_dict.items():
        ann_list_all.append(inst_info[mode])
        type_list_all.append(inst_info.get("type", -1))

    format_obj_list = []
    for i, ann in enumerate(ann_list_all):
        lab = type_list_all[i]
        if mode == "contour":
            pts = np.ceil(np.asarray(ann) * scale_factor)
            pts_list = [[int(v[0]), int(v[1]), 0] for v in pts]
        else:  # centroid
            pos = np.asarray(ann) * scale_factor
            pts_list = [int(pos[0]), int(pos[1]), 0]
        if lab == -1:
            type_colour = viz_info["inst_colour"]
            type_name = viz_info["type_names"][1]
        else:
            type_colour = viz_info["type_colour"][lab]
            type_name = viz_info["type_names"][lab]
        format_obj_list.append(
            _gen_wasabi_dict(i, pts_list, type_name, type_colour, mode,
                             line_width))

    output_dict = {
        "annotation": {
            "description": "",
            "elements": format_obj_list,
            "name": annotator,
        }
    }
    with open(save_path, "w") as handle:
        json.dump(output_dict, handle)
