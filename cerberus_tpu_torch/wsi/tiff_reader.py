"""Pure-Python TIFF / Aperio SVS slide reader (no OpenSlide dependency).

A copy of ``cerberus_tpu/wsi/tiff_reader.py`` for the port. An SVS file is a
multi-IFD TIFF whose pyramid levels are JPEG-compressed tile grids, so a
container parser plus cv2's JPEG decoder covers the format natively:

  * classic TIFF and BigTIFF, little/big endian;
  * tiled and stripped IFDs; compression: none (1), JPEG (7, with the
    shared-JPEGTables merge), deflate (8/32946 via zlib), LZW (5, the
    TIFF6 early-change variant), Aperio J2K (33003/33005 via cv2's
    OpenJPEG); LZW/deflate honor the horizontal predictor (tag 317);
  * pyramid levels = IFDs whose aspect matches the baseline (Aperio
    label/macro images differ in aspect and are skipped);
  * mpp from the Aperio ImageDescription (``|MPP = 0.25|``) or the
    XResolution/ResolutionUnit tags;
  * Leica SCN (BigTIFF + collection XML): the scan's pyramid IFDs, mpp
    (view physical extent over pixels) and objective come from the
    ImageDescription XML instead of aspect inference (_scn_main_levels);
  * Ventana BIF (iScan XMP) and Philips (DPUfsImport XML, sparse white
    background tiles) metadata;
  * Hamamatsu NDPI: tag 65420 marks the format, pyramid levels are the
    IFDs with positive SourceLens (65421; macro = -1 and map = -2 are
    skipped), objective power = the base SourceLens, mpp from XResolution
    in cm, z-stacks keep the in-focus plane, and >4 GB files get the
    32-bit offset unwrap (_unwrap_ndpi_offset — NDPI stays a classic-TIFF
    container past 4 GB, storing offsets modulo 2^32).

Reads decode only the tiles covering the requested window (LRU-cached),
so window reads are O(window), independent of slide size. Plugs into the
port's ``WSIReader`` API (reader.py): ``_read_level`` + level metadata.

A corrupt container fails closed: every length, count and offset read from
the file is checked against the file before it sizes a read or an array,
the IFD chain may not loop, and a level whose geometry tags are missing,
non-integral or inconsistent with its tile table raises ``ValueError`` at
open. (The JAX copy sized a read by a tag's stored count, so one flipped
count byte asked for gigabytes.) A valid file reads to the same pixels.
cv2 is imported inside the functions that decode.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reader import SlideInfo, WSIReader

# TIFF tag ids consumed here
_TAGS = {
    256: "width", 257: "height", 258: "bits", 259: "compression",
    262: "photometric", 270: "description", 273: "strip_offsets",
    277: "spp", 278: "rows_per_strip", 279: "strip_counts",
    282: "xres", 296: "res_unit", 317: "predictor",
    305: "software",
    322: "tile_w", 323: "tile_h", 324: "tile_offsets", 325: "tile_counts",
    347: "jpeg_tables", 700: "xmp",
    # Hamamatsu NDPI private tags (TIFF-with-quirks; OpenSlide docs):
    # 65420 marks the format, 65421 is the per-IFD source lens — the
    # objective magnification for pyramid levels, -1 for the macro image
    # and -2 for the map image
    # 65422 is the per-IFD focal-plane Z offset (nm) in z-stacked scans
    65420: "ndpi_version", 65421: "source_lens", 65422: "z_offset",
}
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}


class _IFD:
    __slots__ = ("tags",)

    def __init__(self):
        self.tags: Dict[str, object] = {}

    def __getattr__(self, name):
        try:
            return self.tags[name]
        except KeyError:
            raise AttributeError(name) from None

    def get(self, name, default=None):
        return self.tags.get(name, default)


def _read_values(handle, endian, vtype, count, raw, file_size,
                 unwrap=None):
    """Decode an IFD entry's values from its inline bytes or offset.

    An out-of-line payload that does not lie inside the file raises
    ``ValueError`` before anything is read (a corrupt count would otherwise
    size the read).

    ``unwrap`` (optional) maps a stored out-of-line value offset to its
    true file offset — the NDPI >4 GB 32-bit-modulo fixup; classic-TIFF
    value-offset fields are 32-bit, so on a >4 GB NDPI they wrap exactly
    like strip offsets do."""
    size = _TYPE_SIZES.get(vtype)
    if size is None:
        return None
    total = size * count
    if total > len(raw):
        (offset,) = struct.unpack(endian + ("Q" if len(raw) == 8 else "I"),
                                  raw[:8 if len(raw) == 8 else 4])
        if unwrap is not None:
            offset = unwrap(offset)
        if offset + total > file_size:
            raise ValueError("corrupt TIFF: tag payload of %d bytes at %d "
                             "past the end of the file" % (total, offset))
        handle.seek(offset)
        data = handle.read(total)
    else:
        data = raw[:total]
    if vtype == 2:  # ascii
        return data.split(b"\0")[0].decode("ascii", "replace")
    if vtype in (5, 10):  # rational
        vals = struct.unpack(endian + ("II" if vtype == 5 else "ii") * count,
                             data)
        return [vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                for i in range(0, 2 * count, 2)]
    if vtype in (6, 7):  # raw bytes
        return data
    fmt = _TYPE_FMT.get(vtype)
    if fmt is None or count == 0:
        return None
    vals = struct.unpack(endian + fmt * count, data)
    return list(vals) if count > 1 else vals[0]


def _plausible_ifd(handle, endian, pos, big, file_size) -> bool:
    """Whether ``pos`` plausibly points at an IFD: in-file, sane entry
    count, and the first few entries carry valid field types with
    ascending tags (TIFF6 requires sorted tags). Used to pick the right
    ``offset + k*2^32`` candidate when unwrapping NDPI's wrapped next-IFD
    pointers — a wrong candidate lands in JPEG data, which fails these
    checks with overwhelming probability."""
    if not 0 <= pos < file_size:
        return False
    try:
        handle.seek(pos)
        if big:
            raw = handle.read(8)
            if len(raw) < 8:
                return False
            (n,) = struct.unpack(endian + "Q", raw)
            esize = 20
        else:
            raw = handle.read(2)
            if len(raw) < 2:
                return False
            (n,) = struct.unpack(endian + "H", raw)
            esize = 12
        if not 1 <= n <= 4096:
            return False
        check = min(int(n), 8)
        raw = handle.read(esize * check)
        if len(raw) < esize * check:
            return False
        prev_tag = -1
        for i in range(check):
            tag, vtype = struct.unpack_from(endian + "HH", raw, i * esize)
            if not 1 <= vtype <= 18 or tag < prev_tag:
                return False
            prev_tag = tag
        return True
    except (OSError, struct.error):
        return False


def _resolve_ifd_offset(handle, endian, stored, prev_pos, big,
                        file_size) -> int:
    """Resolve a next-IFD pointer, unwrapping NDPI's 32-bit-modulo fields.

    The only classic-TIFF containers past 4 GB in the wild are Hamamatsu
    NDPI, which keeps 32-bit offset fields storing the true offset modulo
    2^32. NDPI appends IFDs in file order, so of the in-file candidates
    ``stored + k*2^32`` prefer the first AT/AFTER the current parse
    position that actually looks like an IFD (_plausible_ifd); fall back
    to any plausible candidate, then the raw value."""
    if stored == 0 or big or file_size <= 0xFFFFFFFF:
        return stored
    G = 0x100000000
    cands = [stored + k * G for k in range(file_size // G + 1)
             if stored + k * G < file_size]
    forward = [c for c in cands if c >= prev_pos]
    backward = [c for c in cands if c < prev_pos][::-1]
    for cand in forward + backward:
        if _plausible_ifd(handle, endian, cand, big, file_size):
            return cand
    return stored


def _parse_tiff(path: str) -> Tuple[List[_IFD], str]:
    """Parse every IFD; returns (ifds, endian)."""
    ifds: List[_IFD] = []
    file_size = os.path.getsize(path)
    with open(path, "rb") as handle:
        header = handle.read(8)
        if header[:2] == b"II":
            endian = "<"
        elif header[:2] == b"MM":
            endian = ">"
        else:
            raise ValueError(f"{path}: not a TIFF file")
        (version,) = struct.unpack(endian + "H", header[2:4])
        big = version == 43
        if big:
            handle.seek(8)
            (next_ifd,) = struct.unpack(endian + "Q", handle.read(8))
        elif version == 42:
            (next_ifd,) = struct.unpack(endian + "I", header[4:8])
        else:
            raise ValueError(f"{path}: unknown TIFF version {version}")

        entry_fmt = (endian + "HHQ", 20, "Q", 8) if big \
            else (endian + "HHI", 12, "I", 4)
        # NDPI >4 GB: the header/next-IFD pointers and out-of-line value
        # offsets are 32-bit-wrapped just like strip offsets. A LEGIT
        # classic TIFF can also exceed 4 GB (all offsets < 2^32, only
        # trailing data past the boundary) and its offsets must NOT be
        # relocated — so the unwrap is gated on actually seeing the NDPI
        # marker tag (65420), detected from the raw entry tags before any
        # value decode. The header IFD0 pointer is resolved by plausibility
        # alone (we cannot know ndpi-ness before reading IFD0; a valid
        # stored pointer always wins because it IS a plausible IFD).
        wrapped = (not big) and file_size > 0xFFFFFFFF
        is_ndpi = False
        next_ifd = _resolve_ifd_offset(handle, endian, next_ifd, 8, big,
                                       file_size)
        seen = set()
        while next_ifd:
            if next_ifd in seen or not 0 < next_ifd < file_size:
                raise ValueError(f"{path}: corrupt TIFF: IFD chain loops or "
                                 "leaves the file")
            seen.add(next_ifd)
            handle.seek(next_ifd)
            if big:
                (n_entries,) = struct.unpack(endian + "Q", handle.read(8))
            else:
                (n_entries,) = struct.unpack(endian + "H", handle.read(2))
            if handle.tell() + entry_fmt[1] * n_entries > file_size:
                raise ValueError(f"{path}: corrupt TIFF: IFD of {n_entries} "
                                 "entries past the end of the file")
            entries = handle.read(entry_fmt[1] * n_entries)
            ifd = _IFD()
            # file position of this IFD: the anchor for NDPI's >4 GB
            # 32-bit-offset unwrap (_unwrap_ndpi_offset)
            ifd.tags["ifd_pos"] = next_ifd
            if wrapped and not is_ndpi:
                for i in range(n_entries):
                    (tag,) = struct.unpack_from(
                        endian + "H", entries, i * entry_fmt[1])
                    if tag == 65420:
                        is_ndpi = True
                        break
            unwrap = None
            if wrapped and is_ndpi:
                anchor = next_ifd
                unwrap = (lambda o, a=anchor:
                          _unwrap_ndpi_offset(o, a, file_size))
            for i in range(n_entries):
                raw = entries[i * entry_fmt[1]:(i + 1) * entry_fmt[1]]
                tag, vtype, count = struct.unpack(entry_fmt[0], raw[:entry_fmt[1] - entry_fmt[3]])
                name = _TAGS.get(tag)
                if name is None:
                    continue
                pos = handle.tell()
                ifd.tags[name] = _read_values(
                    handle, endian, vtype, count,
                    raw[entry_fmt[1] - entry_fmt[3]:], file_size,
                    unwrap=unwrap)
                handle.seek(pos)
            for key in ("description", "software"):
                if key in ifd.tags:  # text whatever the stored type
                    ifd.tags[key] = _xml_text(ifd, key)
            ifds.append(ifd)
            after_entries = handle.tell() + entry_fmt[3]
            (next_ifd,) = struct.unpack(endian + entry_fmt[2],
                                        handle.read(entry_fmt[3]))
            # mid-chain candidate search only for confirmed NDPI: a legit
            # >4 GB classic TIFF's next-IFD pointer is already correct
            # (and may legally point BACKWARD, which the forward-first
            # search would misresolve)
            if is_ndpi:
                next_ifd = _resolve_ifd_offset(handle, endian, next_ifd,
                                               after_entries, big, file_size)
    return ifds, endian


def _unwrap_ndpi_offset(offset: int, anchor: int, file_size: int) -> int:
    """Reconstruct a >4 GB NDPI file offset from its 32-bit field.

    NDPI keeps the classic-TIFF container even past 4 GB, so stored
    offsets are the true offset modulo 2^32 (the reason OpenSlide calls
    NDPI "not valid TIFF"). Hamamatsu writes strip data adjacent to its
    IFD, so of the candidates ``offset + k*2^32`` the true one is the
    in-file candidate nearest the IFD position (``anchor``); files under
    4 GB are returned unchanged."""
    if file_size <= 0xFFFFFFFF:
        return offset
    base = (anchor & ~0xFFFFFFFF) | offset
    cands = [c for c in (base - 0x100000000, base, base + 0x100000000)
             if 0 <= c < file_size]
    if not cands:
        return offset
    return min(cands, key=lambda c: abs(c - anchor))


def _as_list(v) -> List[int]:
    return [v] if isinstance(v, int) else list(v)


def _tag_int(ifd: _IFD, name: str, default=None) -> int:
    """A tag holding one integer; ``ValueError`` when it is missing (and
    has no default) or holds anything else."""
    v = ifd.get(name, default)
    if not isinstance(v, int):
        raise ValueError(f"corrupt TIFF: tag {name}={v!r:.40} is not one "
                         "integer")
    return v


def _tag_float(ifd: _IFD, name: str) -> float:
    """A numeric tag as a float, 0 when absent (first value of a list)."""
    v = ifd.get(name, 0) or 0
    v = v[0] if isinstance(v, list) else v
    if not isinstance(v, (int, float)):
        raise ValueError(f"corrupt TIFF: tag {name}={v!r:.40} is not numeric")
    return float(v)


def _dims(ifd: _IFD) -> Tuple[int, int]:
    """(width, height) of an IFD, both positive integers."""
    w, h = _tag_int(ifd, "width"), _tag_int(ifd, "height")
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt TIFF: image size {w}x{h}")
    return w, h


def _check_level(path: str, ifd: _IFD, file_size: int) -> None:
    """Fail at open, with ``ValueError``, on a level whose tags cannot
    drive ``_read_level``: compression, sample count and predictor not
    integers, tile or strip sizes not positive, fewer offsets or byte
    counts than tiles, or a tile's bytes outside the file."""
    w, h = _dims(ifd)
    comp = _tag_int(ifd, "compression", 1)
    if comp not in (1, 5, 7, 8, 32946, 33003, 33005):
        raise ValueError(f"{path}: unsupported TIFF compression {comp}")
    if _tag_int(ifd, "spp", 3) <= 0:
        raise ValueError(f"{path}: corrupt TIFF: samples per pixel")
    _tag_int(ifd, "predictor", 1)
    tiled = "tile_offsets" in ifd.tags
    if tiled:
        tw, th = _tag_int(ifd, "tile_w"), _tag_int(ifd, "tile_h")
        n = -(-w // tw) * -(-h // th) if tw > 0 and th > 0 else 0
    else:
        tw, th = w, _tag_int(ifd, "rows_per_strip", h)
        n = -(-h // th) if th > 0 else 0
    if tw <= 0 or th <= 0:
        raise ValueError(f"{path}: corrupt TIFF: tile size {tw}x{th}")
    offsets = ifd.get("tile_offsets" if tiled else "strip_offsets")
    counts = ifd.get("tile_counts" if tiled else "strip_counts")
    offsets = _as_list(offsets) if isinstance(offsets, (int, list)) else []
    counts = _as_list(counts) if isinstance(counts, (int, list)) else []
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"{path}: corrupt TIFF: {len(offsets)} offsets and "
                         f"{len(counts)} byte counts for {n} tiles")
    for off, cnt in zip(offsets[:n], counts[:n]):
        if not (isinstance(off, int) and isinstance(cnt, int)
                and off >= 0 and cnt >= 0 and off + cnt <= file_size):
            raise ValueError(f"{path}: corrupt TIFF: tile bytes "
                             f"[{off}, +{cnt}) outside the file")
    tables = ifd.get("jpeg_tables")
    if tables is not None and not isinstance(tables, (bytes, list)):
        raise ValueError(f"{path}: corrupt TIFF: JPEGTables")


def _scn_main_levels(ifds: List[_IFD]) -> Optional[Tuple[List[_IFD],
                                                         Optional[float],
                                                         Optional[float]]]:
    """Leica SCN: (pyramid IFDs, mpp, objective) from the collection XML.

    SCN is BigTIFF whose IFD0 ImageDescription holds a <scn> collection:
    each <image> (macro overview + one or more scanned regions) maps its
    pyramid via <pixels><dimension sizeX sizeY r= ifd= /> rows — the IFDs
    are NOT grouped by aspect like Aperio, so the generic pyramid
    inference would anchor on the macro and drop the scan. Returns the
    largest image's level IFDs in r order; mpp comes from the <view>
    physical extent (nanometers) over the pixel width, objective from
    <objective>. Returns None for non-SCN files. The reference reaches
    SCN only through OpenSlide (misc/wsi_handler.py:303-320)."""
    desc = ifds[0].get("description", "") or ""
    if "<scn" not in desc:
        return None
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(desc)
    except ET.ParseError as exc:
        raise ValueError(f"corrupt SCN ImageDescription XML: {exc}")

    def local(tag):
        return tag.split("}")[-1]

    best = None  # (size_x, levels {r: ifd_idx}, mpp, objective)
    for image in root.iter():
        if local(image.tag) != "image":
            continue
        dims: Dict[int, int] = {}
        size0 = view_nm = objective = None
        for el in image.iter():
            name = local(el.tag)
            if name == "dimension":
                # z-stacked planes repeat r values; keep the first (z=0).
                # Missing/garbled attributes are corruption — fail closed
                # as ValueError, not a TypeError from int(None)
                ifd_attr, size_attr = el.get("ifd"), el.get("sizeX")
                if ifd_attr is None or size_attr is None:
                    raise ValueError(
                        "corrupt SCN XML: <dimension> missing ifd/sizeX")
                r = int(el.get("r", 0))
                if r not in dims:
                    dims[r] = int(ifd_attr)
                    if r == 0:
                        size0 = int(size_attr)
                        if not 0 < size0 < (1 << 40):
                            raise ValueError(
                                f"corrupt SCN XML: sizeX={size0} out of "
                                "any plausible slide range")
            elif name == "view" and el.get("sizeX"):
                view_nm = float(el.get("sizeX"))
            elif name == "objective" and el.text:
                try:
                    objective = float(el.text)
                except ValueError:
                    pass
        if not dims or size0 is None:
            continue
        mpp = (view_nm / size0 / 1000.0) if view_nm else None
        if best is None or size0 > best[0]:
            best = (size0, dims, mpp, objective)
    if best is None:
        raise ValueError("SCN XML lists no scanned image with dimensions")
    _, dims, mpp, objective = best
    levels = []
    for r in sorted(dims):
        idx = dims[r]
        if not 0 <= idx < len(ifds):
            raise ValueError(f"SCN XML maps level r={r} to IFD {idx}, "
                             f"but the file has {len(ifds)} IFDs")
        levels.append(ifds[idx])
    return levels, mpp, objective


def _xml_text(ifd: _IFD, key: str) -> str:
    """A tag's payload as text regardless of TIFF type (ASCII string, BYTE
    int list, or UNDEFINED raw bytes)."""
    v = ifd.get(key)
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode("utf-8", "replace")
    if isinstance(v, list):
        return bytes(bytearray(x & 0xFF for x in v)).decode("utf-8",
                                                            "replace")
    return str(v)


def _bif_meta(ifds: List[_IFD]):
    """Ventana/Roche BIF: some IFD carries an ``<iScan ...>`` XMP blob with
    ScanRes (µm/px) and Magnification (OpenSlide's ventana driver contract,
    misc/wsi_handler.py:303-320 reaches it via OpenSlide). The first IFD is
    typically a thumbnail, so the pyramid anchors on the LARGEST aspect
    family instead of IFD0. Full-resolution AOI overlap stitching (real
    scanner output only; needs per-AOI join metadata) is NOT replicated —
    fixture-validated subset, documented in PARITY.md."""
    mpp = power = None
    seen = False
    for ifd in ifds:
        text = _xml_text(ifd, "xmp") or (ifd.get("description", "") or "")
        if "<iScan" not in text:
            continue
        seen = True
        m = re.search(r'ScanRes\s*=\s*"([0-9.eE+-]+)"', text)
        if m:
            mpp = float(m.group(1))
        m = re.search(r'Magnification\s*=\s*"([0-9.eE+-]+)"', text)
        if m:
            power = float(m.group(1))
    if not seen:
        return None
    if mpp is not None and not 0 < mpp < 1000:
        raise ValueError(f"corrupt BIF iScan XML: ScanRes={mpp}")
    # ancillary images are named in their per-IFD descriptions
    cands = [i for i in ifds
             if not re.search(r"\b(Thumbnail|Label|Probability)\b",
                              i.get("description", "") or "")]
    return mpp, power, (cands or list(ifds))


def _philips_meta(ifds: List[_IFD]):
    """Philips TIFF: Software tag 'Philips...' / a DPUfsImport XML
    ImageDescription. mpp = min DICOM_PIXEL_SPACING (mm -> µm; the base
    level has the finest spacing); Label/Macro images are named by their
    per-IFD description and excluded from the pyramid. Sparse background
    tiles (offset/bytecount 0) decode as white. Padded level dimensions are
    kept as stored (documented divergence — PARITY.md)."""
    head = ifds[0]
    soft = str(head.get("software", "") or "")
    desc0 = head.get("description", "") or ""
    if not (soft.startswith("Philips") or "DPUfsImport" in desc0):
        return None
    mpp = None
    spacings = []
    text = desc0.replace("&quot;", '"')  # PMSVR arrays escape their quotes
    for m in re.finditer(
            r'Name="DICOM_PIXEL_SPACING"[^>]*>([^<]*)<', text):
        for v in re.findall(r'"([0-9.eE+-]+)"', m.group(1)):
            spacings.append(float(v))
    if spacings:
        mpp = min(s for s in spacings if s > 0) * 1000.0  # mm -> µm
        if not 0 < mpp < 1000:
            raise ValueError(
                f"corrupt Philips XML: pixel spacing {mpp} µm")
    candidates = [i for i in ifds
                  if not re.search(r"\b(Label|Macro)\b",
                                   i.get("description", "") or "")]
    return mpp, None, (candidates or list(ifds))


def _z_offset(ifd: _IFD) -> float:
    """The NDPI focal-plane Z offset (tag 65422), 0 when absent/in-focus."""
    v = ifd.get("z_offset", 0) or 0
    return float(v[0] if isinstance(v, list) else v)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early change — TIFF6 §13)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset():
        table.clear()
        table.extend(bytes([i]) for i in range(256))
        table.extend((b"", b""))  # clear / eoi placeholders

    reset()
    bitbuf = bitcnt = 0
    width = 9
    prev: Optional[bytes] = None
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= width:
            code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
            bitcnt -= width
            if code == CLEAR:
                reset()
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if code > len(table) or (prev is None and code == len(table)):
                raise ValueError("corrupt LZW stream: code %d past the "
                                 "table" % code)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:  # KwKwK case
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # TIFF's "early change", plus the decoder's one-entry lag
            # behind the encoder: widen one code earlier than the table
            # size alone suggests
            if len(table) >= (1 << width) - 2 and width < 12:
                width += 1
    return bytes(out)


def _j2k_mct_enabled(cs: bytes) -> bool:
    """Whether a J2K codestream's COD marker enables the multiple-component
    transform (so OpenJPEG's output is already RGB). COD sits in the main
    header right after SIZ, so the first FF52 is the marker:
    marker(2) Lcod(2) Scod(1) order(1) layers(2) MCT(1)."""
    i = cs.find(b"\xff\x52")
    return 0 <= i and len(cs) > i + 8 and cs[i + 8] == 1


_CV2_QUIETED = False


def _quiet_cv2_decoder() -> None:
    """OpenJPEG warns per tile about the unspecified colorspace of raw
    codestreams; silence once (a 100k-tile slide would log 100k lines)."""
    global _CV2_QUIETED
    if _CV2_QUIETED:
        return
    _CV2_QUIETED = True
    import cv2

    try:
        cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
    except Exception:
        pass


class TiffSlideReader(WSIReader):
    """Tiled/stripped pyramidal TIFF (incl. Aperio SVS) reader."""

    def __init__(self, path: str, mpp: Optional[float] = None):
        self.path = path
        ifds, _endian = _parse_tiff(path)
        if not ifds:
            raise ValueError(f"{path}: no IFDs")
        # Leica SCN: the collection XML names the scan's level IFDs
        # explicitly (the aspect-based inference below would anchor on
        # the macro overview and drop the scan)
        scn = _scn_main_levels(ifds)
        scn_ifds, scn_mpp, scn_power = scn if scn else (None, None, None)
        # Ventana BIF / Philips TIFF: vendor XML carries the metadata and
        # the first IFD may be a thumbnail/padded object — anchor on the
        # largest candidate instead of IFD0
        vendor = None if scn else (_bif_meta(ifds) or _philips_meta(ifds))
        self._sparse_white = bool(vendor) and str(
            ifds[0].get("software", "") or "").startswith("Philips")
        v_mpp = v_power = None
        if vendor is not None:
            v_mpp, v_power, v_cands = vendor
            base = max(v_cands, key=lambda i: _dims(i)[0] * _dims(i)[1])
            rest_ifds = [i for i in v_cands if i is not base]
        else:
            base = scn_ifds[0] if scn else ifds[0]
            rest_ifds = None
        bw, bh = _dims(base)
        # NDPI (Hamamatsu): tag 65420 marks the format; pyramid levels are
        # the IFDs with a positive source lens (65421) — the macro (-1)
        # and map (-2) images are skipped by tag, not by aspect
        self._ndpi = "ndpi_version" in base.tags
        self._file_size = os.path.getsize(path)
        # NDPI z-stacks: each magnification repeats once per focal plane
        # (identical dimensions, differing ZOffset tag 65422). Keep only
        # the in-focus z=0 plane — OpenSlide's level set — otherwise every
        # plane passes the filters below and the pyramid holds duplicate
        # levels from arbitrary focal planes.
        if self._ndpi and any(_z_offset(i) for i in ifds):
            in_focus = [i for i in ifds if _z_offset(i) == 0]
            if in_focus:  # all-nonzero z would otherwise drop every level
                ifds = in_focus
                base = ifds[0]
                bw, bh = _dims(base)
        # pyramid levels: aspect must match the baseline (Aperio label /
        # macro images have different aspect); keep descending sizes.
        # SCN bypasses the inference: its XML already named the IFDs.
        self._levels: List[_IFD] = [base]
        for ifd in (rest_ifds if rest_ifds is not None
                    else (scn_ifds[1:] if scn else ifds[1:])):
            if scn:
                self._levels.append(ifd)
                continue
            if self._ndpi and _tag_float(ifd, "source_lens") <= 0:
                continue
            w, h = _dims(ifd)
            if w >= bw or h >= bh:
                continue
            if abs((w / h) - (bw / bh)) / (bw / bh) > 0.02:
                continue
            # Aperio IFD1 is a stripped mid-size thumbnail whose aspect
            # also matches — treat it as a level only when no tiled level
            # of similar size exists; keeping it is harmless (reads just
            # pick the best-fitting downsample)
            self._levels.append(ifd)
        self._levels.sort(key=lambda i: -_dims(i)[0])
        self._level_downsamples = [bw / _dims(l)[0] for l in self._levels]
        # NDPI >4 GB: unwrap each level's wrapped 32-bit strip/tile data
        # offsets ONCE here (anchored to the level's IFD position), not
        # per tile decode — a multi-strip level would otherwise redo the
        # full O(strips) unwrap on every cache-miss read
        if self._ndpi and self._file_size > 0xFFFFFFFF:
            for ifd in self._levels:
                anchor = int(ifd.get("ifd_pos", 0))
                for key in ("strip_offsets", "tile_offsets"):
                    if key in ifd.tags:
                        ifd.tags[key] = [
                            _unwrap_ndpi_offset(o, anchor, self._file_size)
                            for o in _as_list(ifd.tags[key])]
        # fail at OPEN time on codecs we can't decode (not at first read,
        # after a caller has already committed to this reader): lets
        # open_wsi's plain-tiff fallback actually trigger for e.g. PackBits;
        # a level whose tags are corrupt fails here too
        for ifd in self._levels:
            _check_level(path, ifd, self._file_size)

        if mpp is None:
            # SCN view-extent mpp first, then the generic tag/description
            # parse (scn_mpp is None for non-SCN files)
            mpp = scn_mpp or v_mpp or self._parse_mpp(base)
        if mpp is None:
            raise ValueError(
                f"{path}: no MPP in ImageDescription/XResolution; pass "
                "mpp= explicitly")
        if not 0 < float(mpp) < 1e6:
            raise ValueError(f"{path}: implausible mpp {mpp}")
        power = scn_power if scn else v_power
        desc = base.get("description", "") or ""
        m = re.search(r"AppMag\s*=\s*([0-9.]+)", desc)
        if m:
            power = float(m.group(1))
        elif self._ndpi and _tag_float(base, "source_lens") > 0:
            power = _tag_float(base, "source_lens")
        self.info = SlideInfo(mpp=float(mpp), slide_dimensions=(bw, bh),
                              objective_power=power)
        self._decode_tile = lru_cache(maxsize=256)(self._decode_tile_impl)

    @staticmethod
    def _parse_mpp(ifd: _IFD) -> Optional[float]:
        desc = ifd.get("description", "") or ""
        m = re.search(r"MPP\s*=\s*([0-9.]+)", desc)
        if m:
            return float(m.group(1))
        xres = ifd.get("xres")
        unit = ifd.get("res_unit", 2)
        if xres:
            xres = xres[0] if isinstance(xres, list) else xres
            if isinstance(xres, (int, float)) and xres > 0 \
                    and isinstance(unit, int):
                per_um = {2: 25400.0, 3: 10000.0}.get(unit)
                if per_um:
                    return per_um / xres
        return None

    # -- tile / strip decoding -------------------------------------------
    def _decode_tile_impl(self, lvl: int, idx: int) -> np.ndarray:
        import cv2

        ifd = self._levels[lvl]
        tiled = "tile_offsets" in ifd.tags
        offsets = _as_list(ifd.tile_offsets if tiled else ifd.strip_offsets)
        counts = _as_list(ifd.tile_counts if tiled else ifd.strip_counts)
        with open(self.path, "rb") as handle:
            handle.seek(offsets[idx])
            data = handle.read(counts[idx])
        comp = int(ifd.get("compression", 1))
        if tiled:
            th, tw = int(ifd.tile_h), int(ifd.tile_w)
        else:
            tw = int(ifd.width)
            rps = int(ifd.get("rows_per_strip", ifd.height))
            th = min(rps, int(ifd.height) - idx * rps)
        spp = int(ifd.get("spp", 3))
        if (counts[idx] == 0 or offsets[idx] == 0):
            if self._sparse_white:
                # Philips TIFF omits pure-background tiles; background is
                # the scanner's white
                return np.full((th, tw, 3), 255, np.uint8)
            raise ValueError(
                f"{self.path}: empty tile {idx} in a non-sparse format")
        if comp == 1:
            arr = np.frombuffer(data, np.uint8)
            arr = arr[:th * tw * spp].reshape(th, tw, spp)
            return arr[..., :3] if spp >= 3 else \
                np.repeat(arr[..., :1], 3, axis=-1)
        if comp in (5, 8, 32946):  # LZW / deflate
            blob = (zlib.decompress(data) if comp != 5
                    else _lzw_decode(data))
            raw = np.frombuffer(blob, np.uint8)
            raw = raw[:th * tw * spp].reshape(th, tw, spp)
            # tag 317: LZW/deflate rows are very commonly stored as
            # horizontal differences (predictor 2, TIFF6 §14); reconstruct
            # by per-channel cumulative sum mod 256. Anything else
            # (predictor 3 = float) must fail loudly, not scramble pixels.
            pred = int(ifd.get("predictor", 1))
            if pred == 2:
                raw = np.cumsum(raw, axis=1, dtype=np.uint8)
            elif pred != 1:
                raise ValueError(
                    f"{self.path}: unsupported TIFF predictor {pred}")
            return raw[..., :3] if spp >= 3 else \
                np.repeat(raw[..., :1], 3, axis=-1)
        if comp == 7:  # new-style JPEG (+ optional shared tables)
            tables = ifd.get("jpeg_tables")
            if tables and len(tables) > 4 and data[:2] == b"\xff\xd8":
                # tables stream: SOI..tables..EOI; tile: SOI..scan..EOI
                data = bytes(tables[:-2]) + data[2:]
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(f"{self.path}: JPEG tile decode failed")
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if comp in (33003, 33005):
            # Aperio J2K (33003 YCbCr / 33005 RGB wavelets): tiles are raw
            # JPEG2000 codestreams; cv2 ships OpenJPEG and decodes them
            # directly (the reference reaches these via OpenSlide,
            # misc/wsi_handler.py:303-320). OpenJPEG already undoes the
            # in-stream component transform when the COD marker signals it;
            # only MCT-less 33003 streams carry raw Y,Cb,Cr planes that we
            # must convert ourselves (same assumption OpenSlide's Aperio
            # driver makes from the compression tag).
            _quiet_cv2_decoder()
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(
                    f"{self.path}: J2K tile decode failed (OpenJPEG)")
            if comp == 33003 and not _j2k_mct_enabled(data):
                # imdecode read the (Y,Cb,Cr) components as if RGB and
                # returned "BGR" = (Cr,Cb,Y); regroup to (Y,Cr,Cb)
                return cv2.cvtColor(img[..., [2, 0, 1]],
                                    cv2.COLOR_YCrCb2RGB)
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        raise ValueError(f"{self.path}: unsupported TIFF compression {comp}")

    def _read_level(self, lvl, x0, y0, x1, y1) -> np.ndarray:
        ifd = self._levels[lvl]
        w, h = int(ifd.width), int(ifd.height)
        tiled = "tile_offsets" in ifd.tags
        if tiled:
            th, tw = int(ifd.tile_h), int(ifd.tile_w)
        else:
            tw = w
            th = int(ifd.get("rows_per_strip", h))
        tiles_across = -(-w // tw)
        out = np.zeros((y1 - y0, x1 - x0, 3), np.uint8)
        for ty in range(y0 // th, -(-y1 // th)):
            for tx in range(x0 // tw, -(-x1 // tw)):
                idx = ty * tiles_across + tx
                tile = self._decode_tile(lvl, idx)
                # tile-grid coords -> level coords -> output window
                gy0, gx0 = ty * th, tx * tw
                sy0 = max(y0, gy0); sy1 = min(y1, gy0 + tile.shape[0], h)
                sx0 = max(x0, gx0); sx1 = min(x1, gx0 + tile.shape[1], w)
                if sy1 <= sy0 or sx1 <= sx0:
                    continue
                out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
                    tile[sy0 - gy0:sy1 - gy0, sx0 - gx0:sx1 - gx0]
        return out
