"""Whole-slide readers with pyramid-level selection.

Counterpart of ``cerberus_tpu/wsi/reader.py``: ``WSIReader`` (mpp-aware
``slide_dimensions``, bounds reads at a requested resolution, thumbnails),
``NpyPyramidReader`` (a directory of ``level_<N>.npy`` arrays +
``meta.yml``, or a bare ``.npy``; every level is mmap'd and reads touch
only the requested window; ``read_batch`` gathers a batch of windows with
the native C++ gather), ``ImageReader`` (png / jpg), ``VirtualWSIReader``
(an in-memory array), ``OpenSlideReader`` and ``JP2Reader`` (openslide and
glymur imported when a slide is opened), ``Jp2NativeReader`` (cv2's
OpenJPEG), and ``open_wsi``'s extension dispatch with the JAX package's
fallbacks. TIFF-based slides (SVS, NDPI, SCN, BIF, Philips) go to
``tiff_reader.TiffSlideReader`` and MIRAX to
``mirax_reader.MiraxSlideReader`` when OpenSlide is absent.

``read_bounds`` picks the coarsest level whose downsample is at most the
requested scale, reads only that window and resizes it when the level is
not the requested scale; huge reads decimate straight off the memmap.
Out-of-bounds regions are zero-padded. cv2 (resizes, png/jpg decode) and
PyYAML (``meta.yml``) are imported inside the functions that need them: a
read at a native pyramid level needs neither.
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

    def read_batch(self, bounds_list, resolution: float, units: str = "mpp"
                   ) -> np.ndarray:
        """Batched window read, (N, h, w, 3) uint8. When the requested
        scale is a pyramid level, one threaded C++ gather straight off that
        level's memmap (``native.patch_gather``); other scales read each
        window with ``read_bounds``, on threads (cv2 and numpy release the
        GIL)."""
        scale = self._scale_for(resolution, units)
        bounds = np.asarray(bounds_list)
        win_w = int(bounds[0, 2] - bounds[0, 0])
        win_h = int(bounds[0, 3] - bounds[0, 1])
        lvl, ds = self._best_level(scale)
        level = self._levels[lvl]
        if abs(scale / ds - 1.0) < 1e-9 and level.ndim == 3 \
                and level.shape[2] == 3:
            from ..native.patch_gather import gather_patches

            return gather_patches(level, bounds[:, [1, 0]], win_h, win_w)
        if len(bounds) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(bounds))) as pool:
                return np.stack(list(pool.map(
                    lambda b: self.read_bounds(b, resolution, units),
                    bounds)))
        return np.stack([self.read_bounds(b, resolution, units)
                         for b in bounds])


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


class OpenSlideReader(WSIReader):
    """OpenSlide-backed pyramid reader (``openslide`` imported when a slide
    is opened). Reads go through the best native level."""

    def __init__(self, path: str):
        import openslide

        self._slide = openslide.OpenSlide(path)
        props = self._slide.properties
        mpp = float(props.get("openslide.mpp-x", 0.25))
        power = props.get("openslide.objective-power")
        w, h = self._slide.dimensions
        self.info = SlideInfo(mpp=mpp, slide_dimensions=(w, h),
                              objective_power=float(power) if power else None)
        self._level_downsamples = [float(d)
                                   for d in self._slide.level_downsamples]

    def _read_level(self, lvl, x0, y0, x1, y1):
        ds = self._level_downsamples[lvl]
        # openslide addresses the location in LEVEL-0 coordinates
        region = self._slide.read_region(
            (int(round(x0 * ds)), int(round(y0 * ds))), lvl,
            (x1 - x0, y1 - y0))
        region = np.asarray(region.convert("RGB")
                            if hasattr(region, "convert") else region)
        return _to_rgb_u8(region)


class JP2Reader(WSIReader):
    """JPEG 2000 through glymur (imported when a slide is opened) with
    pseudo-levels: JP2 streams have no stored pyramid, so the levels are
    powers of two read as strided slices of the codestream
    (``jp2[y0:y1:s, x0:x1:s]``, 6 levels)."""

    N_PSEUDO_LEVELS = 6

    def __init__(self, path: str, mpp: Optional[float] = None,
                 objective_power: Optional[float] = 40.0):
        import glymur

        self._jp2 = glymur.Jp2k(path)
        h, w = self._jp2.shape[:2]
        if mpp is None:
            mpp = 0.275  # the reference's CRC-slide default without metadata
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(w, h),
                              objective_power=objective_power)
        self._level_downsamples = [float(2 ** k)
                                   for k in range(self.N_PSEUDO_LEVELS)]

    def _plane(self):
        """The sliceable full-resolution pixel source."""
        return self._jp2

    def _read_level(self, lvl, x0, y0, x1, y1):
        s = int(self._level_downsamples[lvl])
        region = self._plane()[y0 * s:y1 * s:s, x0 * s:x1 * s:s]
        return _to_rgb_u8(np.asarray(region))

    def _read_level_strided(self, lvl, x0, y0, x1, y1, stride):
        # the extra stride folds into the pseudo-level step
        ds = int(self._level_downsamples[lvl])
        region = self._plane()[y0 * ds:y1 * ds:ds * stride,
                               x0 * ds:x1 * ds:ds * stride]
        return _to_rgb_u8(np.asarray(region))


class Jp2NativeReader(WSIReader):
    """JPEG 2000 (.jp2 / .j2k) through cv2's bundled OpenJPEG, with
    ``JP2Reader``'s pseudo-levels. cv2 has no region decode, so the first
    pixel access decodes the whole codestream once and keeps it; every
    level is a strided view (the same values as glymur's slicing).
    Geometry comes from the JP2 ihdr box or the J2K SIZ marker without a
    decode. The frame must fit cv2.imdecode's pixel cap
    (``OPENCV_IO_MAX_IMAGE_PIXELS``, default 2^30), checked at open."""

    N_PSEUDO_LEVELS = JP2Reader.N_PSEUDO_LEVELS

    def __init__(self, path: str, mpp: Optional[float] = None,
                 objective_power: Optional[float] = 40.0):
        self._path = path
        self._img: Optional[np.ndarray] = None
        w, h = self._parse_dimensions(path)
        try:
            cap = int(os.environ.get("OPENCV_IO_MAX_IMAGE_PIXELS",
                                     1 << 30))
        except ValueError:
            cap = 1 << 30
        if w * h > cap:
            raise RuntimeError(
                f"{path}: {w}x{h} exceeds cv2.imdecode's pixel cap "
                f"({cap}); the native .jp2 path decodes the whole frame. "
                "Install glymur for windowed decode, convert the slide to "
                "an .npy pyramid (python -m cerberus_tpu_torch.convert_slide"
                "), or raise OPENCV_IO_MAX_IMAGE_PIXELS if RAM allows")
        if mpp is None:
            mpp = 0.275
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(w, h),
                              objective_power=objective_power)
        self._level_downsamples = [float(2 ** k)
                                   for k in range(self.N_PSEUDO_LEVELS)]

    @staticmethod
    def _parse_dimensions(path: str) -> tuple:
        """(w, h) from the JP2 'ihdr' box or the raw codestream's SIZ
        marker: an ISO 15444-1 box walk, box to box, honouring LBox 1
        (64-bit XLBox follows) and 0 (box runs to the end of the file)."""
        import struct

        fsize = os.path.getsize(path)
        with open(path, "rb") as f:
            sig = f.read(4)
            if sig == b"\xff\x4f\xff\x51":   # SOC + SIZ (raw codestream)
                # SOC(2) SIZ(2) Lsiz(2) Rsiz(2) then Xsiz Ysiz XOsiz YOsiz
                head = sig + f.read(20)
                xs, ys, xo, yo = struct.unpack(">4I", head[8:24])
                return xs - xo, ys - yo
            pos = 0
            while pos + 8 <= fsize:          # JP2 box walk (top + jp2h)
                f.seek(pos)
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                length, btype = struct.unpack(">I4s", hdr)
                hdr_len = 8
                if length == 1:              # XLBox: 64-bit length follows
                    ext = f.read(8)
                    if len(ext) < 8:
                        break
                    (length,) = struct.unpack(">Q", ext)
                    hdr_len = 16
                elif length == 0:            # box extends to end of file
                    length = fsize - pos
                if btype == b"ihdr":
                    h, w = struct.unpack(">2I", f.read(8))
                    return w, h
                if btype == b"jp2h":         # descend into the superbox
                    pos += hdr_len
                    continue
                if length < hdr_len:         # corrupt length: stop walking
                    break
                pos += length
        raise ValueError(f"{path}: no JP2 ihdr box / J2K SIZ marker found "
                         "(not a decodable JPEG2000 file?)")

    def _plane(self) -> np.ndarray:
        """The whole frame, decoded once."""
        if self._img is None:
            import cv2

            with open(self._path, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
            img = cv2.imdecode(data, cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(f"{self._path}: cv2/OpenJPEG failed to "
                                 "decode the JPEG2000 stream")
            self._img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return self._img

    _read_level = JP2Reader._read_level
    _read_level_strided = JP2Reader._read_level_strided


def open_wsi(path: str, mpp: Optional[float] = None) -> WSIReader:
    """Extension dispatch, with the JAX package's fallbacks:

      * ``.npy`` pyramid directories and bare ``.npy`` files;
      * ``.tif`` / ``.tiff``: the native TIFF parser; a file it cannot
        parse (``ValueError``, ``struct.error``) goes to ``ImageReader``;
      * ``.png`` / ``.jpg`` / ``.jpeg`` / ``.bmp``;
      * ``.jp2`` / ``.j2k``: glymur, else ``Jp2NativeReader`` (cv2);
      * ``.svs``, ``.ndpi``, ``.mrxs``, ``.scn``, ``.vms``, ``.vmu``,
        ``.svslide``, ``.bif``: OpenSlide, else ``MiraxSlideReader`` for
        ``.mrxs`` and ``TiffSlideReader`` for the rest.
    """
    ext = os.path.splitext(path)[1].lower()
    if os.path.isdir(path) or ext == ".npy":
        return NpyPyramidReader(path, mpp=mpp)
    if ext in (".tif", ".tiff"):
        import struct

        from .tiff_reader import TiffSlideReader

        try:
            return TiffSlideReader(path, mpp=mpp)
        except (ValueError, struct.error):
            return ImageReader(path, mpp=mpp or 0.5)
    if ext in (".png", ".jpg", ".jpeg", ".bmp"):
        return ImageReader(path, mpp=mpp or 0.5)
    if ext in (".jp2", ".j2k"):
        try:
            return JP2Reader(path, mpp=mpp)
        except ImportError:
            return Jp2NativeReader(path, mpp=mpp)
    if ext in (".svs", ".ndpi", ".mrxs", ".scn", ".vms", ".vmu",
               ".svslide", ".bif"):
        try:
            return OpenSlideReader(path)
        except ImportError:
            pass
        if ext == ".mrxs":
            from .mirax_reader import MiraxSlideReader

            return MiraxSlideReader(path, mpp=mpp)
        from .tiff_reader import TiffSlideReader

        return TiffSlideReader(path, mpp=mpp)
    raise ValueError(f"unsupported slide format: {path}")
