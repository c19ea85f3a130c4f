"""The disk-backed prediction canvas of a slide.

A copy of ``CanvasSet`` from ``cerberus_tpu/wsi/merge.py:28-121``: one
(H, W, C) float16 ``.npy`` memmap under the cache directory (``raw.npy``),
landed one grid tile at a time by the resident loop (``write_region``) or
one batch of patch outputs at a time by the legacy host-canvas loop
(``write_patches``), and read back for mid-slide resume, the tissue map,
the nuclei post-processing tiles and the gland/lumen region reads. Patches
are partitioned across tiles, so every value is written exactly once and
the JAX class's count canvas (for overlapping strides) has no caller here.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

DTYPE = np.float16


class CanvasSet:
    def __init__(self, cache_dir: str, canvas_hw, n_ch: int,
                 resume: bool = False):
        self.cache_dir = cache_dir
        self.shape = (int(canvas_hw[0]), int(canvas_hw[1]), n_ch)
        os.makedirs(cache_dir, exist_ok=True)
        self.raw_path = os.path.join(cache_dir, "raw.npy")
        self.raw = None
        if resume and os.path.exists(self.raw_path):
            existing = np.lib.format.open_memmap(self.raw_path, mode="r+")
            if existing.shape == self.shape and existing.dtype == DTYPE:
                self.raw = existing  # mid-slide resume: keep written tiles
            else:
                del existing
        if self.raw is None:
            self.raw = np.lib.format.open_memmap(
                self.raw_path, mode="w+", dtype=DTYPE, shape=self.shape)

    def write_patches(self, predictions: np.ndarray,
                      locations: np.ndarray) -> None:
        """predictions: (N, h, w, C); locations: (N, 4) XY output bounds.
        Out-of-canvas parts of edge windows are clipped."""
        H, W, _ = self.shape
        for pred, (x0, y0, x1, y1) in zip(predictions, locations):
            cx1, cy1 = min(int(x1), W), min(int(y1), H)
            pw, ph = cx1 - int(x0), cy1 - int(y0)
            if pw <= 0 or ph <= 0:
                continue
            self.raw[y0:cy1, x0:cx1] = pred[:ph, :pw]

    def write_region(self, bounds, values: np.ndarray) -> None:
        """Land one contiguous region (XY bounds) in a single strided write,
        clipped to the canvas."""
        x0, y0, x1, y1 = [int(v) for v in bounds]
        H, W, _ = self.shape
        cx1, cy1 = min(x1, W), min(y1, H)
        if cx1 <= x0 or cy1 <= y0:
            return
        self.raw[y0:cy1, x0:cx1] = values[: cy1 - y0, : cx1 - x0]

    def read_region(self, bounds, channels: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
        """Read an XY-bounds region to RAM as float32."""
        x0, y0, x1, y1 = [int(v) for v in bounds]
        x1, y1 = min(x1, self.shape[1]), min(y1, self.shape[0])
        region = self.raw[y0:y1, x0:x1]
        if channels is not None:
            region = region[..., list(channels)]
        return np.asarray(region, dtype=np.float32)

    def read_decimated(self, step: int, channel: int) -> np.ndarray:
        """``[::step, ::step]`` of one channel as float32.

        Exactly equals the stripe-wise cv2 INTER_NEAREST 1/step resize of
        the whole plane when H % step == W % step == 0 (integer scale:
        cv2 maps dst j -> src floor(j * step) = j * step), while touching
        only every ``step``-th row of the mmap."""
        return np.asarray(self.raw[::step, ::step, channel], np.float32)

    def flush(self) -> None:
        self.raw.flush()

    def close(self) -> None:
        self.flush()
        self.raw = None
