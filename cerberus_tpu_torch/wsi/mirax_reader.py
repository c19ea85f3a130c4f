"""Native MIRAX (.mrxs) slide reader — no OpenSlide dependency.

A copy of ``cerberus_tpu/wsi/mirax_reader.py`` for the port (cv2 imported
inside the tile decoder). The reference opens MIRAX slides only through
OpenSlide, a C library absent from many deployment images, so this module
parses the MIRAX container directly, following the format as documented by
the OpenSlide project (their MIRAX format notes) and mirrored by the
fixture writer in ``tests/test_mirax_reader.py``:

Container
  ``<name>.mrxs`` (a small marker/thumbnail file) next to a directory
  ``<name>/`` holding ``Slidedat.ini``, the index file it names, and the
  ``Data####.dat`` payload files.

Slidedat.ini (INI, optional UTF-8 BOM)
  * ``[GENERAL]``: ``IMAGENUMBER_X/Y`` (camera-image grid), ``SLIDE_ID``,
    ``OBJECTIVE_MAGNIFICATION``, ``CAMERA_IMAGE_DIVISIONS_PER_SIDE``.
  * ``[HIERARCHICAL]``: ``HIER_COUNT`` hierarchies, each with
    ``HIER_i_NAME`` / ``HIER_i_COUNT`` / ``HIER_i_VAL_j(_SECTION)``;
    zoom levels live under the hierarchy named ``Slide zoom level``.
    ``NONHIER_*`` catalogs associated records — the one consumed here is
    ``VIMSLIDE_POSITION_BUFFER`` (per-camera-image pixel positions).
    ``INDEXFILE`` names the index.
  * ``[DATAFILE]``: ``FILE_COUNT`` + ``FILE_i`` payload file names.
  * per-level sections: ``DIGITIZER_WIDTH/HEIGHT`` (stored tile px),
    ``OVERLAP_X/Y`` (camera-image overlap at that level, px),
    ``MICROMETER_PER_PIXEL_X``, ``IMAGE_FORMAT`` (JPEG/PNG/BMP),
    ``IMAGE_FILL_COLOR_BGR`` (background), ``IMAGE_CONCAT_FACTOR``
    (camera images per stored-tile side; 2^k at zoom level k).

Index file
  5-byte ASCII version + 32-byte slide id, then two little-endian int32
  roots (hierarchical, nonhierarchical). Each root is a table of int32
  page-list offsets, one per catalog value in Slidedat order (0 = none).
  A page = ``int32 n_entries, int32 next_page_offset`` + n 16-byte
  entries ``int32 image_number, int32 offset, int32 length, int32
  file_number``; nonhier entries reuse the shape with image_number = 0.

Position buffer
  zlib-compressed 9-byte records ``uint8 flag, int32 x, int32 y`` — one
  per camera-image grid cell in row-major order; flag != 0 marks a
  recorded position, (x, y) are level-0 pixel coordinates of that camera
  image's top-left corner. Absent buffer => the regular grid with pitch
  ``tile - overlap``.

Geometry
  Zoom level k stores DIGITIZER-sized tiles each covering ``concat_k``
  camera positions per side, so its downsample is
  ``concat_k * camera_w / (tile_w)`` with ``camera_w`` the level-0
  camera-image width; entries' image_number indexes the LEVEL-0 camera
  grid (row-major), always a multiple of ``concat_k`` per axis. Reads
  composite the covered tiles onto a fill-color canvas, clipping to the
  window — O(window) work, tiles LRU-cached.

Caveats: validated against generated fixtures, not vendor files;
``CAMERA_IMAGE_DIVISIONS_PER_SIDE`` > 1 is rejected at open.
"""
from __future__ import annotations

import configparser
import os
import struct
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reader import SlideInfo, WSIReader

_ZOOM_HIER_NAME = "Slide zoom level"
_POSITION_NONHIER = "VIMSLIDE_POSITION_BUFFER"


class _Level:
    """One zoom level: stored-tile geometry + (image_number -> record)."""

    # overlap_* feed the level-0 grid pitch only (placement at coarser
    # levels derives from level-0 camera positions, never from their own
    # overlaps); kept per level for introspection
    __slots__ = ("tile_w", "tile_h", "overlap_x", "overlap_y", "concat",
                 "fmt", "fill_bgr", "records", "downsample")

    def __init__(self):
        self.records: Dict[int, Tuple[int, int, int]] = {}


def _read_ini(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(interpolation=None, strict=False)
    cp.optionxform = str  # MIRAX keys are case-sensitive upper-case
    with open(path, encoding="utf-8-sig") as f:
        cp.read_string(f.read())
    return cp


def _walk_pages(data: bytes, first_page: int
                ) -> List[Tuple[int, int, int, int]]:
    """All (image_number, offset, length, file_number) entries of a page
    list starting at ``first_page``."""
    out = []
    pos = first_page
    seen = set()
    while pos:
        # negative offsets would make unpack_from read from the buffer
        # END silently — reject them as the corruption they are
        if pos < 0 or pos in seen or pos + 8 > len(data):
            raise ValueError("corrupt index: bad page chain")
        seen.add(pos)
        n, nxt = struct.unpack_from("<ii", data, pos)
        if n < 0 or pos + 8 + 16 * n > len(data):
            raise ValueError("corrupt index: bad page entry count")
        for i in range(n):
            out.append(struct.unpack_from("<iiii", data, pos + 8 + 16 * i))
        pos = nxt
    return out


class MiraxSlideReader(WSIReader):
    """Pyramidal reader over the MIRAX container (module docstring)."""

    def __init__(self, path: str, mpp: Optional[float] = None):
        self._path = path
        base = os.path.splitext(path)[0]
        slide_dir = base if os.path.isdir(base) else None
        if slide_dir is None:
            raise ValueError(
                f"{path}: no sibling MIRAX data directory {base!r}")
        ini_path = os.path.join(slide_dir, "Slidedat.ini")
        if not os.path.exists(ini_path):
            raise ValueError(f"{path}: {ini_path} not found")
        cp = _read_ini(ini_path)

        gen = cp["GENERAL"]
        self._nx = int(gen["IMAGENUMBER_X"])
        self._ny = int(gen["IMAGENUMBER_Y"])
        power = float(gen.get("OBJECTIVE_MAGNIFICATION", 0)) or None
        divisions = int(gen.get("CAMERA_IMAGE_DIVISIONS_PER_SIDE", 1))
        if divisions != 1:
            raise ValueError(
                f"{path}: CAMERA_IMAGE_DIVISIONS_PER_SIDE="
                f"{divisions} not supported by the native MIRAX reader")

        hier = cp["HIERARCHICAL"]
        index_name = hier.get("INDEXFILE", "Index.dat")
        datafile = cp["DATAFILE"]
        self._files = [os.path.join(slide_dir, datafile[f"FILE_{i}"])
                       for i in range(int(datafile["FILE_COUNT"]))]

        # catalog order: the index root tables follow Slidedat's flattened
        # HIER_i_VAL_j / NONHIER_i_VAL_j ordering
        hier_values: List[Tuple[str, str, Optional[str]]] = []
        for i in range(int(hier.get("HIER_COUNT", 0))):
            name = hier[f"HIER_{i}_NAME"]
            for j in range(int(hier[f"HIER_{i}_COUNT"])):
                hier_values.append(
                    (name, hier[f"HIER_{i}_VAL_{j}"],
                     hier.get(f"HIER_{i}_VAL_{j}_SECTION")))
        nonhier_values: List[Tuple[str, str]] = []
        for i in range(int(hier.get("NONHIER_COUNT", 0))):
            name = hier[f"NONHIER_{i}_NAME"]
            for j in range(int(hier[f"NONHIER_{i}_COUNT"])):
                nonhier_values.append((name, hier[f"NONHIER_{i}_VAL_{j}"]))

        with open(os.path.join(slide_dir, index_name), "rb") as f:
            index = f.read()
        if len(index) < 45:
            raise ValueError(f"{path}: truncated MIRAX index")
        hier_root, nonhier_root = struct.unpack_from("<ii", index, 37)
        if hier_root < 0 or nonhier_root < 0:
            raise ValueError(f"{path}: corrupt index: negative root")

        # zoom levels, in catalog order (level 0 first by convention)
        self._levels: List[_Level] = []
        zoom_rows = [(k, sec) for k, (name, _val, sec)
                     in enumerate(hier_values) if name == _ZOOM_HIER_NAME]
        if not zoom_rows:
            raise ValueError(f"{path}: no '{_ZOOM_HIER_NAME}' hierarchy")
        for k, sec in zoom_rows:
            if sec is None or sec not in cp:
                raise ValueError(f"{path}: missing level section {sec!r}")
            s = cp[sec]
            lv = _Level()
            lv.tile_w = int(s["DIGITIZER_WIDTH"])
            lv.tile_h = int(s["DIGITIZER_HEIGHT"])
            lv.overlap_x = float(s.get("OVERLAP_X", 0))
            lv.overlap_y = float(s.get("OVERLAP_Y", 0))
            lv.concat = int(s.get("IMAGE_CONCAT_FACTOR", 1))
            lv.fmt = s.get("IMAGE_FORMAT", "JPEG").upper()
            if lv.fmt not in ("JPEG", "PNG", "BMP"):
                raise ValueError(f"{path}: IMAGE_FORMAT {lv.fmt} "
                                 "not supported")
            fill = int(s.get("IMAGE_FILL_COLOR_BGR", 0))
            lv.fill_bgr = ((fill >> 16) & 255, (fill >> 8) & 255, fill & 255)
            if hier_root + 4 * k + 4 > len(index):
                raise ValueError(f"{path}: corrupt index: root table "
                                 "truncated")
            (page,) = struct.unpack_from("<i", index, hier_root + 4 * k)
            if page:
                for img_no, off, length, fno in _walk_pages(index, page):
                    lv.records[img_no] = (off, length, fno)
            self._levels.append(lv)

        # nonhier: camera-image position buffer (level-0 px, row-major)
        self._cam_pos: Optional[Dict[int, Tuple[int, int]]] = None
        for k, (name, _val) in enumerate(nonhier_values):
            if name != _POSITION_NONHIER:
                continue
            if nonhier_root + 4 * k + 4 > len(index):
                raise ValueError(f"{path}: corrupt index: nonhier table "
                                 "truncated")
            (page,) = struct.unpack_from("<i", index, nonhier_root + 4 * k)
            if not page:
                continue
            recs = _walk_pages(index, page)
            if not recs:
                continue
            # large slides may split the buffer across several records —
            # each an independent zlib stream of consecutive 9-byte
            # position chunks; concatenate them all (dropping any would
            # silently misplace the affected cameras onto the grid pitch)
            raw = b"".join(
                zlib.decompress(self._read_blob(fno, off, length))
                for _img, off, length, fno in recs)
            pos: Dict[int, Tuple[int, int]] = {}
            n = len(raw) // 9
            for i in range(min(n, self._nx * self._ny)):
                flag, x, y = struct.unpack_from("<Bii", raw, 9 * i)
                if flag:
                    pos[i] = (x, y)
            self._cam_pos = pos or None
            break

        lv0 = self._levels[0]
        if lv0.concat != 1:
            raise ValueError(f"{path}: level 0 IMAGE_CONCAT_FACTOR "
                             f"{lv0.concat} != 1")
        # level-0 camera-image pitch
        pitch_x = lv0.tile_w - lv0.overlap_x
        pitch_y = lv0.tile_h - lv0.overlap_y
        self._pitch = (pitch_x, pitch_y)

        # per-level downsample: concat_k camera images per stored-tile
        # side, re-encoded at DIGITIZER size => ds = concat * camera_px /
        # tile_px. Both axes must agree — oy placement divides by the
        # x-derived value, so an anisotropic level would silently garble
        # vertical placement; reject it loudly instead.
        for lv in self._levels:
            dsx = lv.concat * lv0.tile_w / lv.tile_w
            dsy = lv.concat * lv0.tile_h / lv.tile_h
            if abs(dsx - dsy) > 0.01 * dsx:
                raise ValueError(
                    f"{path}: anisotropic level downsample x={dsx} "
                    f"y={dsy} not supported")
            lv.downsample = dsx
        self._level_downsamples = [lv.downsample for lv in self._levels]

        # plane extent from EVERY placed tile (recorded positions AND
        # grid-pitch fallbacks, all levels): a partial position buffer or
        # negative recorded positions must not leave reachable tiles
        # outside the slide bounds, where _read_level_padded would clip
        # them to zero padding. Negative minima shift the whole
        # coordinate system (self._l0_origin) so content starts at 0.
        raw_origins: List[Dict[int, Tuple[int, int]]] = []
        min_x = min_y = 0
        max_x = max_y = 1
        n_tiles = 0
        for lvl, lv in enumerate(self._levels):
            d: Dict[int, Tuple[int, int]] = {}
            span_x = int(round(lv.tile_w * lv.downsample))
            span_y = int(round(lv.tile_h * lv.downsample))
            for img_no in lv.records:
                x, y = self._tile_origin_l0(lvl, img_no)
                d[img_no] = (x, y)
                min_x, min_y = min(min_x, x), min(min_y, y)
                max_x = max(max_x, x + span_x)
                max_y = max(max_y, y + span_y)
            n_tiles += len(d)
            raw_origins.append(d)
        if not n_tiles:
            raise ValueError(f"{path}: no stored tiles in any zoom level")
        self._l0_origin = (min_x, min_y)
        w0, h0 = max_x - min_x, max_y - min_y

        if mpp is None:
            sec0 = cp[zoom_rows[0][1]]
            v = sec0.get("MICROMETER_PER_PIXEL_X")
            mpp = float(v) if v else None
        if mpp is None:
            raise ValueError(f"{path}: no MICROMETER_PER_PIXEL_X; pass "
                             "mpp= explicitly")
        if not 0 < float(mpp) < 1e6:
            raise ValueError(f"{path}: implausible mpp {mpp}")
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(w0, h0),
                              objective_power=power)
        self._decode_tile = lru_cache(maxsize=256)(self._decode_tile_impl)
        # per-level placement cache: img numbers + level-px origins as
        # arrays, so window reads vector-test intersection instead of
        # looping every record in Python (a 40x slide stores ~10^4-10^5
        # tiles per level)
        self._placed: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for lvl, lv in enumerate(self._levels):
            d = raw_origins[lvl]
            nos = np.fromiter(d.keys(), np.int64, count=len(d))
            ox = np.empty(len(nos), np.int64)
            oy = np.empty(len(nos), np.int64)
            for i, img_no in enumerate(nos):
                l0x, l0y = d[int(img_no)]
                ox[i] = int(round((l0x - min_x) / lv.downsample))
                oy[i] = int(round((l0y - min_y) / lv.downsample))
            self._placed.append((nos, ox, oy))

    # -- payload access ----------------------------------------------------
    def _read_blob(self, fno: int, off: int, length: int) -> bytes:
        if not 0 <= fno < len(self._files):
            raise ValueError(f"{self._path}: record file number {fno} "
                             "out of range")
        with open(self._files[fno], "rb") as f:
            f.seek(off)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{self._path}: truncated data record")
        return data

    def _decode_tile_impl(self, lvl: int, img_no: int) -> np.ndarray:
        import cv2

        lv = self._levels[lvl]
        off, length, fno = lv.records[img_no]
        data = np.frombuffer(self._read_blob(fno, off, length), np.uint8)
        img = cv2.imdecode(data, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{self._path}: tile {img_no}@L{lvl} failed "
                             f"to decode as {lv.fmt}")
        if img.shape[:2] != (lv.tile_h, lv.tile_w):
            # a mis-sized tile would broadcast-error deep inside the blit;
            # fail with the tile identity instead
            raise ValueError(
                f"{self._path}: tile {img_no}@L{lvl} decoded to "
                f"{img.shape[1]}x{img.shape[0]}, expected "
                f"{lv.tile_w}x{lv.tile_h} (DIGITIZER_WIDTH/HEIGHT)")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    # -- placement ----------------------------------------------------------
    def _tile_origin_l0(self, lvl: int, img_no: int) -> Tuple[int, int]:
        """Level-0 px origin of a stored tile (top-left camera image)."""
        cx = img_no % self._nx
        cy = img_no // self._nx
        if self._cam_pos is not None:
            p = self._cam_pos.get(img_no)
            if p is not None:
                return p
            # concatenated tiles anchor at their top-left camera position;
            # fall through to grid pitch when that camera was not recorded
        return (int(round(cx * self._pitch[0])),
                int(round(cy * self._pitch[1])))

    def _read_level(self, lvl: int, x0: int, y0: int, x1: int, y1: int
                    ) -> np.ndarray:
        lv = self._levels[lvl]
        out = np.empty((y1 - y0, x1 - x0, 3), np.uint8)
        out[:] = lv.fill_bgr[::-1]  # BGR fill -> RGB canvas
        nos, ox, oy = self._placed[lvl]
        hit = ((ox < x1) & (oy < y1)
               & (ox + lv.tile_w > x0) & (oy + lv.tile_h > y0))
        for img_no, tx0, ty0 in zip(nos[hit], ox[hit], oy[hit]):
            img_no, tx0, ty0 = int(img_no), int(tx0), int(ty0)
            tile = self._decode_tile(lvl, img_no)
            sx0, sy0 = max(x0, tx0), max(y0, ty0)
            sx1 = min(x1, tx0 + lv.tile_w)
            sy1 = min(y1, ty0 + lv.tile_h)
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
                tile[sy0 - ty0:sy1 - ty0, sx0 - tx0:sx1 - tx0]
        return out  # already (h, w, 3) uint8 — no conversion copy
