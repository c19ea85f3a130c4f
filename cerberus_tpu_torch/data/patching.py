"""Patch-grid math for tile inference.

Reproduces the placement semantics of the reference's ``_prepare_patching``
(``infer/tile.py:43-106``) and the channel-index map built inside
``_post_process_patches`` (``infer/tile.py:118-134``), as pure numpy
functions with unit tests pinned to the original behavior.
"""
from __future__ import annotations

import math

import numpy as np


def prepare_patching(img: np.ndarray, input_size: int, output_size: int,
                     output_overlap_size: int = 0):
    """Reflect-pad ``img`` and compute the sliding-window placement grid.

    Returns ``(padded_img, info_list, [padt, padl])`` where ``info_list`` has
    shape (P, 2, 2, 2): per patch, [input|output] x [tl|br] x [y|x], all
    coordinates relative to the padded image. Output windows are
    ``output_size``² at stride ``output_size``; input windows are centered
    ``input_size``² around them.
    """
    win_size = input_size
    msk_size = step_size = output_size

    def get_last_steps(length, msk_size, step_size):
        nr_step = math.ceil((length - msk_size) / step_size)
        return int((nr_step + 1) * step_size)

    im_h, im_w = img.shape[0], img.shape[1]
    last_h = get_last_steps(im_h, msk_size, output_size)
    last_w = get_last_steps(im_w, msk_size, output_size)

    diff = win_size - step_size
    padt = padl = diff // 2
    padb = last_h + win_size - im_h
    padr = last_w + win_size - im_w

    padded_img = np.pad(img, ((padt, padb), (padl, padr), (0, 0)), "reflect")

    # grid of top-left corners; note the reference meshgrids (y, x) in xy-order
    # which yields an x-major flattening — kept identical for output ordering.
    input_tl_y = np.arange(0, last_h, step_size, dtype=np.int32)
    input_tl_x = np.arange(0, last_w, step_size, dtype=np.int32)
    input_tl_y, input_tl_x = np.meshgrid(input_tl_y, input_tl_x)
    input_tl = np.stack([input_tl_y.flatten(), input_tl_x.flatten()], axis=-1)
    output_tl = input_tl + diff // 2

    padded_shape = padded_img.shape[:2]
    output_br = output_tl + output_size
    input_br = input_tl + input_size
    sel = np.any(input_br > padded_shape, axis=-1)
    info_list = np.stack(
        [
            np.stack([input_tl[~sel], input_br[~sel]], axis=1),
            np.stack([output_tl[~sel], output_br[~sel]], axis=1),
        ],
        axis=1,
    )

    # NB: the reference duplicates the grid when output_overlap_size == 0
    # (`infer/tile.py:90-103` adds a second, identical placement set). That is
    # a pure 2x-work no-op under sum/count averaging; we do NOT duplicate,
    # halving inference FLOPs with identical stitched output.
    return padded_img, info_list, [padt, padl]


def make_channel_index_map(decoder_kwargs: dict):
    """Map each output-head code to its channel slice in the stitched canvas.

    INST heads contribute ``nr_chans - 1`` channels (softmax foreground
    classes), TYPE heads 1 channel (argmax), anything else (Patch-Class) 1
    channel. Returns ``(idx_dict, nr_out_chs)`` where ``idx_dict[code] =
    [start, end)``. Mirrors ``infer/tile.py:118-134``.
    """
    nr_out_chs = 0
    idx_dict = {}
    for tissue_name, decoder_info in decoder_kwargs.items():
        for chann_type, nr_chans in decoder_info.items():
            start_idx = nr_out_chs
            if chann_type == "INST":
                nr_out_chs += nr_chans - 1
                idx_dict[tissue_name + "-INST"] = [start_idx, nr_out_chs]
            elif chann_type == "TYPE":
                nr_out_chs += 1
                idx_dict[tissue_name.split("#")[0] + "-TYPE"] = [start_idx, nr_out_chs]
            else:
                nr_out_chs += 1
                idx_dict[tissue_name] = [start_idx, nr_out_chs]
    return idx_dict, nr_out_chs
