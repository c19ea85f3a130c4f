"""The fused tile backend (``--tile_backend=fused``): windows gathered on
the card, the step, and each batch's outputs scattered into one
preallocated device canvas as the batch comes out.

Counterpart of ``cerberus_tpu/infer/fused_tile.py``, whose one XLA program
scans the batches and writes each window with ``dynamic_update_slice``.
Here there is no per-image output list, no host sync and no host copy
until the canvas is done; the caller post-processes it with either
backend.

One departure: the JAX program pads a short last batch with copies of its
last window and lets the last write win (:78-81). On the card the bf16
forward is not invariant to a window's place in its batch, so such a copy
could overwrite the original with other values. The short batch is
zero-padded instead, as the host path pads it, and only its real rows are
written: the canvas equals ``InferManager.infer_canvas``'s byte for byte at
the same batch size.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.patching import make_channel_index_map, prepare_patching
from .tile import gather_windows, window_index


def run_fused_tile(manager, img: np.ndarray) -> torch.Tensor:
    """RGB uint8 (H, W, 3) image -> the source-cropped f32 (H, W, C)
    canvas on ``manager.device``, through the tile ``manager``'s
    ``step_padded`` at its ``patch_input_shape``, ``patch_output_shape``
    and ``batch_size``. Output windows must not overlap
    (``patch_output_overlap == 0``)."""
    if int(getattr(manager, "patch_output_overlap", 0)) != 0:
        raise ValueError("the fused tile backend writes each output window "
                         "once and needs patch_output_overlap=0")
    in_shape = int(manager.patch_input_shape)
    out_shape = int(manager.patch_output_shape)
    batch_size = int(manager.batch_size)
    device = manager.device
    padded, patch_info, src_pos = prepare_patching(img, in_shape, out_shape,
                                                   0)
    dev_img = torch.from_numpy(np.ascontiguousarray(padded)).to(device)
    # (P, 2, 2): per window, [input | output] top-left (y, x), one upload
    tls = torch.from_numpy(patch_info[:, :, 0].astype(np.int64)).to(device)
    _, n_ch = make_channel_index_map(manager.cfg.active_decoder_kwargs)
    canvas = torch.zeros((*padded.shape[:2], n_ch), dtype=torch.float32,
                         device=device)
    for start in range(0, len(tls), batch_size):
        tl = tls[start:start + batch_size]
        out = manager.step_padded(gather_windows(dev_img, tl[:, 0], in_shape),
                                  sharded=False)
        canvas[window_index(tl[:, 1], out_shape, device)] = out.to(
            canvas.dtype)
    return canvas[src_pos[0]:src_pos[0] + img.shape[0],
                  src_pos[1]:src_pos[1] + img.shape[1]]
