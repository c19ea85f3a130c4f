"""Whole-slide readers with pyramid-level selection.

Counterpart of ``cerberus_tpu/wsi/reader.py:48-256,442-447,462-463``:
``WSIReader`` (mpp-aware ``slide_dimensions``, bounds reads at a requested
resolution, thumbnails), ``NpyPyramidReader`` (a directory of
``level_<N>.npy`` arrays + ``meta.yml``, or a bare ``.npy``; every level is
mmap'd and reads touch only the requested window), ``ImageReader`` (png /
jpg) and ``VirtualWSIReader`` (an in-memory array), with ``open_wsi``'s
extension dispatch for those formats.

``read_bounds`` picks the coarsest level whose downsample is at most the
requested scale, reads only that window and resizes it when the level is
not the requested scale; huge reads decimate straight off the memmap.
Out-of-bounds regions are zero-padded. cv2 (resizes, png/jpg decode) and
PyYAML (``meta.yml``) are imported inside the functions that need them: a
read at a native pyramid level needs neither.

The JAX package's TIFF/SVS, MIRAX, OpenSlide and JPEG 2000 readers, and
the batched native gather of its legacy loop, are not ported yet (ROADMAP
queue 1); ``open_wsi`` refuses those formats.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import List, Optional, Tuple

import numpy as np

# beyond this many level pixels a single read switches to the strided
# (read-time decimation) path
_MAX_READ_PIXELS = 1 << 26

NOT_PORTED_FORMATS = (".tif", ".tiff", ".svs", ".ndpi", ".mrxs", ".scn",
                      ".vms", ".vmu", ".svslide", ".bif", ".jp2", ".j2k")


@dataclasses.dataclass
class SlideInfo:
    mpp: float                 # microns-per-pixel at level 0
    slide_dimensions: Tuple[int, int]  # (w, h) at level 0
    objective_power: Optional[float] = None


class WSIReader:
    """Abstract reader. Subclasses implement ``_read_level`` (+ optionally
    ``_read_level_strided``) and set ``info`` / ``_level_downsamples``."""

    info: SlideInfo
    _level_downsamples: List[float] = [1.0]

    # -- geometry --------------------------------------------------------
    def slide_dimensions(self, resolution: float, units: str = "mpp"):
        """(w, h) of the slide plane at the requested resolution."""
        scale = self._scale_for(resolution, units)
        w, h = self.info.slide_dimensions
        return np.array([int(round(w / scale)), int(round(h / scale))])

    def _scale_for(self, resolution: float, units: str) -> float:
        if units == "mpp":
            return float(resolution) / self.info.mpp
        if units == "power":
            if not self.info.objective_power:
                raise ValueError("slide has no objective power metadata")
            return self.info.objective_power / float(resolution)
        if units == "baseline":
            return 1.0 / float(resolution)
        raise ValueError(f"unknown units {units}")

    def _best_level(self, scale: float) -> Tuple[int, float]:
        """Coarsest level with downsample <= scale (read the fewest pixels
        that still oversample the request)."""
        best_idx, best_ds = 0, self._level_downsamples[0]
        for idx, ds in enumerate(self._level_downsamples):
            if ds <= scale * 1.001 and ds > best_ds:
                best_idx, best_ds = idx, ds
        return best_idx, best_ds

    def _level_dims(self, lvl: int) -> Tuple[int, int]:
        w, h = self.info.slide_dimensions
        ds = self._level_downsamples[lvl]
        return int(round(w / ds)), int(round(h / ds))

    # -- reads -----------------------------------------------------------
    def read_bounds(self, bounds, resolution: float, units: str = "mpp"
                    ) -> np.ndarray:
        """Read XY bounds given at the *requested* resolution; returns
        (h, w, 3) uint8, zero-padded where the region exits the slide."""
        scale = self._scale_for(resolution, units)
        x0, y0, x1, y1 = [int(v) for v in bounds]
        out_w, out_h = x1 - x0, y1 - y0
        lvl, ds = self._best_level(scale)
        s = scale / ds  # level px per requested px
        lx0, ly0 = int(np.floor(x0 * s)), int(np.floor(y0 * s))
        lx1, ly1 = int(np.ceil(x1 * s)), int(np.ceil(y1 * s))

        stride = 1
        if (lx1 - lx0) * (ly1 - ly0) > _MAX_READ_PIXELS and s >= 2 \
                and hasattr(self, "_read_level_strided"):
            stride = int(s)
        region = self._read_level_padded(lvl, lx0, ly0, lx1, ly1, stride)
        if region.shape[:2] != (out_h, out_w):
            import cv2

            region = cv2.resize(region, (out_w, out_h),
                                interpolation=cv2.INTER_LINEAR)
        return region

    def slide_thumbnail(self, resolution: float = 1.25, units: str = "power"
                        ) -> np.ndarray:
        w, h = self.slide_dimensions(resolution, units)
        return self.read_bounds([0, 0, int(w), int(h)], resolution, units)

    # -- backend hooks -----------------------------------------------------
    def _read_level_padded(self, lvl, x0, y0, x1, y1, stride: int = 1
                           ) -> np.ndarray:
        w, h = self._level_dims(lvl)
        sx0, sy0 = max(x0, 0), max(y0, 0)
        sx1, sy1 = min(x1, w), min(y1, h)
        if stride > 1:
            out = np.zeros((-(-(y1 - y0) // stride), -(-(x1 - x0) // stride),
                            3), np.uint8)
            if sx1 > sx0 and sy1 > sy0:
                sub = self._read_level_strided(lvl, sx0, sy0, sx1, sy1, stride)
                oy, ox = (sy0 - y0) // stride, (sx0 - x0) // stride
                out[oy:oy + sub.shape[0], ox:ox + sub.shape[1]] = sub
            return out
        out = np.zeros((y1 - y0, x1 - x0, 3), np.uint8)
        if sx1 > sx0 and sy1 > sy0:
            out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = \
                self._read_level(lvl, sx0, sy0, sx1, sy1)
        return out

    def _read_level(self, lvl, x0, y0, x1, y1) -> np.ndarray:
        raise NotImplementedError


def _to_rgb_u8(region: np.ndarray) -> np.ndarray:
    if region.ndim == 2:
        region = np.repeat(region[..., None], 3, axis=-1)
    return region.astype(np.uint8)


class NpyPyramidReader(WSIReader):
    """Pyramid from ``level_<N>.npy`` arrays + ``meta.yml`` ({mpp,
    objective_power}) in a directory; or a bare ``.npy`` file (mpp given by
    the caller, 0.5 otherwise). All levels are mmap'd; per-level
    downsamples are inferred from the shape ratios."""

    def __init__(self, path: str, mpp: Optional[float] = None,
                 objective_power: Optional[float] = None):
        if os.path.isdir(path):
            meta_path = os.path.join(path, "meta.yml")
            meta = {}
            if os.path.exists(meta_path):
                import yaml

                with open(meta_path) as f:
                    meta = yaml.safe_load(f) or {}
            mpp = meta.get("mpp", mpp)
            objective_power = meta.get("objective_power", objective_power)
            level_paths = sorted(
                glob.glob(os.path.join(path, "level_*.npy")),
                key=lambda p: int(re.search(r"level_(\d+)", p).group(1)))
            if not level_paths:
                raise FileNotFoundError(f"{path}: no level_<N>.npy found")
            self._levels = [np.load(p, mmap_mode="r") for p in level_paths]
        else:
            self._levels = [np.load(path, mmap_mode="r")]
        if mpp is None:
            mpp = 0.5
        h, w = self._levels[0].shape[:2]
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(w, h),
                              objective_power=objective_power)
        self._level_downsamples = [w / lv.shape[1] for lv in self._levels]

    def _read_level(self, lvl, x0, y0, x1, y1):
        return _to_rgb_u8(np.asarray(self._levels[lvl][y0:y1, x0:x1]))

    def _read_level_strided(self, lvl, x0, y0, x1, y1, stride):
        return _to_rgb_u8(np.asarray(
            self._levels[lvl][y0:y1:stride, x0:x1:stride]))


class ImageReader(NpyPyramidReader):
    """png/jpg behind the WSIReader API (loaded fully; small inputs only)."""

    def __init__(self, path: str, mpp: float = 0.5,
                 objective_power: Optional[float] = 40.0):
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode the image")
        self._levels = [cv2.cvtColor(img, cv2.COLOR_BGR2RGB)]
        h, w = img.shape[:2]
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(w, h),
                              objective_power=objective_power)
        self._level_downsamples = [1.0]


class VirtualWSIReader(WSIReader):
    """Wraps an in-memory array (e.g. a low-res tissue mask) as a pseudo
    slide."""

    def __init__(self, img: np.ndarray, info: Optional[SlideInfo] = None):
        self._img = np.asarray(img)
        h, w = self._img.shape[:2]
        self.info = info or SlideInfo(mpp=0.5, slide_dimensions=(w, h))
        self._level_downsamples = [1.0]

    def _read_level(self, lvl, x0, y0, x1, y1):
        return _to_rgb_u8(self._img[y0:y1, x0:x1])


def open_wsi(path: str, mpp: Optional[float] = None) -> WSIReader:
    """Extension dispatch: ``.npy`` pyramid directories and bare ``.npy``
    files, ``.png`` / ``.jpg`` / ``.jpeg`` / ``.bmp``."""
    ext = os.path.splitext(path)[1].lower()
    if os.path.isdir(path) or ext == ".npy":
        return NpyPyramidReader(path, mpp=mpp)
    if ext in (".png", ".jpg", ".jpeg", ".bmp"):
        return ImageReader(path, mpp=mpp or 0.5)
    if ext in NOT_PORTED_FORMATS:
        raise NotImplementedError(
            f"{path}: {ext} slides are not readable by the port yet (ROADMAP "
            "queue 1, 'Other slide readers': wsi/tiff_reader.py, "
            "wsi/mirax_reader.py, OpenSlide and JPEG 2000); convert the "
            "slide to an .npy pyramid directory")
    raise ValueError(f"unsupported slide format: {path}")
