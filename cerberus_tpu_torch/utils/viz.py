"""Instance overlay drawing and ``colorize`` (copies of those parts of
``cerberus_tpu/utils/viz.py``; reference ``misc/viz_utils.py``
``colorize`` :83-95, ``visualize_instances_dict_orig`` :187-214). Draws
Gland -> Lumen -> Nuclei with per-tissue colours and line widths from a cwd
``dataset.yml`` ``viz_info`` when present, else the built-in defaults. cv2,
PyYAML and matplotlib are imported inside the functions that need them.
"""
from __future__ import annotations

import os

import numpy as np

from .geometry import center_pad_to_shape

# defaults mirroring the reference dataset.yml viz_info blocks (dataset.yml:21-79)
DEFAULT_VIZ_INFO = {
    "gland": {
        "line_width": 12,
        "inst_colour": [255, 255, 0, 0],
        "type_colour": {0: [0, 0, 0, 0], 1: [255, 255, 0, 0], 2: [177, 52, 235, 0]},
        "type_names": ["nolabel", "gland", "surface-epi"],
    },
    "lumen": {
        "line_width": 12,
        "inst_colour": [255, 0, 255, 0],
        "type_colour": {0: [0, 0, 0, 0], 1: [131, 235, 52, 0]},
        "type_names": ["nolabel", "lumen"],
    },
    "nuclei": {
        "line_width": 3,
        "inst_colour": [0, 255, 0, 1],
        "type_colour": {
            0: [0, 0, 0, 1], 1: [0, 0, 255, 1], 2: [0, 255, 0, 1],
            3: [255, 0, 255, 1], 4: [176, 244, 230, 1], 5: [0, 191, 255, 1],
            6: [255, 165, 0, 1],
        },
        "type_names": ["nolabel", "neutrophil", "epithelial", "lymphocyte",
                       "plasma", "eosinophil", "connective"],
    },
}


def load_viz_info(dataset_yml: str = "dataset.yml") -> dict:
    """Per-tissue viz_info: from a cwd dataset.yml when available (reference
    reads it relative to cwd, misc/viz_utils.py:191-192), else defaults."""
    if os.path.exists(dataset_yml):
        import yaml

        with open(dataset_yml) as fptr:
            info = yaml.safe_load(fptr)
        out = {}
        for tissue in ("gland", "lumen", "nuclei"):
            if tissue in info and "viz_info" in info[tissue]:
                out[tissue] = info[tissue]["viz_info"]
            else:
                out[tissue] = DEFAULT_VIZ_INFO[tissue]
        return out
    return DEFAULT_VIZ_INFO


def visualize_instances_dict(input_image, inst_dict_all, viz_info=None):
    """Overlay from per-tissue instance-info dicts, draw order
    Gland -> Lumen -> Nuclei (reference ``visualize_instances_dict_orig``)."""
    import cv2

    overlay = np.copy(input_image.astype(np.uint8))
    if viz_info is None:
        viz_info = load_viz_info()
    for tissue in ("Gland", "Lumen", "Nuclei"):
        if tissue not in inst_dict_all:
            continue
        info = viz_info[tissue.lower()]
        line_width = info["line_width"]
        for _inst_id, inst_info in inst_dict_all[tissue].items():
            if "type" in inst_info:
                # Fall back to inst_colour for type ids missing from the
                # table: the lumen-typed-by-gland quirk (infer/tile.py) can
                # assign lumen instances gland type ids outside lumen's
                # 2-entry colour map — the reference's
                # visualize_instances_dict_orig raises KeyError there
                # (deliberate divergence; PARITY.md).
                colour = info["type_colour"].get(
                    inst_info["type"], info.get("inst_colour", [255, 0, 0]))
            else:
                colour = info["inst_colour"]
            colour = tuple(int(c) for c in colour[:3])
            cv2.drawContours(overlay, [np.asarray(inst_info["contour"],
                                                  dtype=np.int32)],
                             -1, colour, line_width)
    return overlay


def colorize(ch, vmin, vmax, cmap=None, shape=None):
    """A single-channel map -> (H, W, 3) uint8 through a matplotlib colour
    map (``jet`` by default), clipped to [vmin, vmax]; centre-padded to
    ``shape`` when given."""
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = plt.get_cmap("jet")
    ch = np.squeeze(np.asarray(ch).astype("float32")).copy()
    ch = np.clip(ch, vmin, vmax)
    ch = (ch - vmin) / (vmax - vmin + 1.0e-16)
    ch_cmap = (cmap(ch)[..., :3] * 255).astype("uint8")
    if shape is not None:
        ch_cmap = center_pad_to_shape(ch_cmap, shape)
    return ch_cmap
