"""Overlay, colour and figure utilities (a copy of
``cerberus_tpu/utils/viz.py``; reference ``misc/viz_utils.py``
``colorize`` :83-95, ``visualize_instances_map`` :98-147,
``visualize_instances_dict_orig`` :187-214, ``visualize_graph`` :217-246,
``gen_figure`` :249-293, ``plot_roc`` :296-341). The dict overlay draws
Gland -> Lumen -> Nuclei with per-tissue colours and line widths from a cwd
``dataset.yml`` ``viz_info`` when present, else the built-in defaults. cv2,
PyYAML and matplotlib are imported inside the functions that need them;
``plot_roc`` computes its ROC curves and AUCs in numpy (``roc_curve``,
``auc``: sklearn's), so it needs no sklearn.
"""
from __future__ import annotations

import os

import numpy as np

from .geometry import center_pad_to_shape, get_bounding_box

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


def visualize_instances_map(input_image, inst_map, type_map=None,
                            type_colour=None, line_width=2):
    """Contour overlay from an instance map (+ optional type colouring)."""
    import cv2

    overlay = np.copy(input_image.astype(np.uint8))
    inst_ids = np.unique(inst_map)
    inst_ids = inst_ids[inst_ids != 0]
    for inst_id in inst_ids:
        mask = np.array(inst_map == inst_id, np.uint8)
        y1, y2, x1, x2 = get_bounding_box(mask)
        y1 = max(y1 - 2, 0)
        x1 = max(x1 - 2, 0)
        y2 = min(y2 + 2, inst_map.shape[0])
        x2 = min(x2 + 2, inst_map.shape[1])
        crop = mask[y1:y2, x1:x2]
        contours = cv2.findContours(crop, cv2.RETR_TREE,
                                    cv2.CHAIN_APPROX_SIMPLE)
        cnt = np.squeeze(contours[0][0].astype("int32"))
        if cnt.size == 2:
            cnt = np.expand_dims(cnt, 0)
        cnt = cnt + np.asarray([[x1, y1]])
        if type_map is not None:
            type_id = int(np.unique(type_map[y1:y2, x1:x2]).max())
            colour = type_colour[type_id]
        else:
            colour = (255, 255, 0)
        cv2.drawContours(overlay, [cnt], -1, colour, line_width)
    return overlay


def visualize_graph(vertices, edges, canvas=None, edge_color=(0, 255, 0),
                    node_color=(255, 0, 0)):
    """Draw a spatial graph: edges as lines, vertices as filled circles."""
    import cv2

    if canvas is None:
        x_max = np.max(vertices[:, 0])
        y_max = np.max(vertices[:, 1])
        canvas = np.zeros([int(round(y_max)), int(round(x_max)), 3])
    rounded = (np.asarray(vertices) + 0.5).astype("int32")
    for edge in edges:
        cv2.line(canvas, tuple(rounded[edge[0]]), tuple(rounded[edge[1]]),
                 edge_color, 2)
    for vertex in rounded:
        cv2.circle(canvas, tuple(vertex), 8, node_color, -1)
    return canvas


def gen_figure(imgs_list, titles, fig_inch=None, shape=None,
               colormap=None):
    """A matplotlib figure: the images on a grid (``shape`` rows x cols, or
    near-square), each under its title."""
    import math

    import matplotlib.pyplot as plt

    if colormap is None:
        colormap = plt.get_cmap("jet")
    num_img = len(imgs_list)
    if shape is None:
        ncols = math.ceil(math.sqrt(num_img))
        nrows = math.ceil(num_img / ncols)
    else:
        nrows, ncols = shape
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols, squeeze=False)
    for idx in range(nrows * ncols):
        cell = axes[idx // ncols][idx % ncols]
        cell.axis("off")
        if idx < num_img:
            cell.set_title(titles[idx])
            cell.imshow(imgs_list[idx], cmap=colormap)
    fig.tight_layout()
    return fig


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) of a binary problem, as sklearn's
    ``roc_curve`` with its defaults (``drop_intermediate=True``) computes
    them: one point per distinct score, collinear points dropped, a first
    point at (0, 0) with threshold ``inf``."""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = y_score[idx]
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def auc(x, y) -> float:
    """Area under a curve by the trapezoidal rule (sklearn's ``auc``: ``x``
    monotonic, either direction)."""
    x, y = np.asarray(x), np.asarray(y)
    area = np.trapezoid(y, x) if hasattr(np, "trapezoid") else np.trapz(y, x)
    return float(-area if np.any(np.diff(x) < 0) else area)


def plot_roc(y_true_list, y_prob_list, names, save_path, title="ROC"):
    """Mean ROC with a +-1 std band across folds, saved to ``save_path``.
    Returns the AUC of each fold and of the mean curve."""
    import matplotlib.pyplot as plt

    mean_fp = np.linspace(0, 1, 100)
    tp_list, auc_list = [], []
    for y, p in zip(y_true_list, y_prob_list):
        fp, tp, _ = roc_curve(y, p)
        auc_list.append(auc(fp, tp))
        interp_tp = np.interp(mean_fp, fp, tp)
        interp_tp[0] = 0.0
        tp_list.append(interp_tp)
    fig, ax = plt.subplots()
    mean_tp = np.mean(tp_list, axis=0)
    mean_tp[-1] = 1.0
    mean_auc = auc(mean_fp, mean_tp)
    ax.plot(mean_fp, mean_tp, color="b",
            label=r"Mean ROC (AUC = %0.2f $\pm$ %0.2f)"
                  % (mean_auc, np.std(auc_list)), lw=2, alpha=0.8)
    std_tp = np.std(tp_list, axis=0)
    ax.fill_between(mean_fp, np.maximum(mean_tp - std_tp, 0),
                    np.minimum(mean_tp + std_tp, 1), color="grey",
                    alpha=0.2, label=r"$\pm$ 1 std. dev.")
    ax.set(xlim=[-0.05, 1.05], ylim=[-0.05, 1.05], title=title)
    ax.legend(loc="lower right")
    ax.grid(True)
    fig.savefig(save_path)
    plt.close(fig)
    return {"fold_auc": auc_list, "mean_auc": mean_auc}
