"""Slide-container robustness fuzz for the port's readers: the cases of
``tests/test_reader_fuzz.py``, with its seeds, its fixtures and its
``ALLOWED`` errors, on ``cerberus_tpu_torch.wsi.reader.open_wsi``.

A corrupt container must raise one of the ``ALLOWED`` errors from open or
read, in bounded time, never hang or surface an internal crash. The SVS
case holds here: the port's TIFF parser checks every length, count and
offset against the file before it sizes a read (the JAX copy does not,
and fails that case).
"""
import os
import struct
import time

import cv2
import numpy as np
import pytest

from cerberus_tpu_torch.wsi.reader import open_wsi

from tests.test_mirax_reader import _write_mrxs
from tests.test_ndpi_reader import _write_ndpi
from tests.test_reader_fuzz import ALLOWED
from tests.test_tiff_reader import (
    _ISCAN_XML,
    _PHILIPS_XML,
    _SCN_XML,
    _write_tiff,
)

CASE_SECONDS = 30


def _try_open_read(path):
    r = open_wsi(path)
    r.read_bounds([0, 0, 64, 64], resolution=r.info.mpp, units="mpp")
    w, h = r.info.slide_dimensions
    if max(w, h) < 4096:  # a flipped size tag must not cost a huge canvas
        r.slide_thumbnail(resolution=4 * r.info.mpp, units="mpp")


def _mutations(data, rng, n_cases):
    for case in range(n_cases):
        if case % 2 == 0:  # truncation
            yield data[:int(rng.integers(1, len(data)))]
        else:  # byte flips
            blob = bytearray(data)
            for _ in range(int(rng.integers(1, 8))):
                blob[int(rng.integers(0, len(blob)))] ^= \
                    int(rng.integers(1, 256))
            yield bytes(blob)


def _fuzz_file(tmp_path, src, n_cases=16, seed=0):
    rng = np.random.default_rng(seed)
    data = open(src, "rb").read()
    ext = os.path.splitext(src)[1]
    failures = []
    t0 = time.perf_counter()
    for case, blob in enumerate(_mutations(data, rng, n_cases)):
        p = str(tmp_path / f"fz{case}{ext}")
        with open(p, "wb") as f:
            f.write(blob)
        try:
            _try_open_read(p)
        except ALLOWED:
            pass
        except Exception as exc:  # noqa: BLE001 — the fuzz contract
            failures.append((case, type(exc).__name__, str(exc)[:120]))
    assert not failures, failures
    assert time.perf_counter() - t0 < CASE_SECONDS


def _svs(tmp_path):
    lv0 = np.random.default_rng(1).integers(0, 255, (150, 200, 3)).astype(
        np.uint8)
    src = str(tmp_path / "s.svs")
    _write_tiff(src, [lv0, lv0[::2, ::2]], compression=7,
                description="Aperio |MPP = 0.5|")
    return src, 11


def _ndpi(tmp_path):
    lv0 = np.random.default_rng(2).integers(0, 255, (100, 120, 3)).astype(
        np.uint8)
    src = str(tmp_path / "s.ndpi")
    _write_ndpi(src, [lv0, lv0[::2, ::2]], [40.0, 10.0], mpp=0.5)
    return src, 12


def _jp2(tmp_path):
    plane = np.random.default_rng(3).integers(0, 255, (96, 128, 3)).astype(
        np.uint8)
    ok, enc = cv2.imencode(".jp2", cv2.cvtColor(plane, cv2.COLOR_RGB2BGR))
    assert ok
    src = str(tmp_path / "s.jp2")
    open(src, "wb").write(enc.tobytes())
    return src, 13


def _scn(tmp_path):
    rng = np.random.default_rng(5)
    macro = rng.integers(0, 255, (80, 100, 3)).astype(np.uint8)
    lv0 = rng.integers(0, 255, (200, 250, 3)).astype(np.uint8)
    src = str(tmp_path / "s.scn")
    _write_tiff(src, [macro, lv0, lv0[::2, ::2]], big=True,
                description=_SCN_XML)
    return src, 14


def _bif(tmp_path):
    rng = np.random.default_rng(17)
    thumb = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
    lv0 = rng.integers(0, 255, (200, 250, 3)).astype(np.uint8)
    xmp = _ISCAN_XML.encode()
    src = str(tmp_path / "s.bif")
    _write_tiff(src, [thumb, lv0, lv0[::2, ::2]], big=True,
                description=["Thumbnail", None, None],
                extra_tags={1: [(700, 7, len(xmp), xmp)]})
    return src, 18


def _philips(tmp_path):
    lv0 = np.random.default_rng(19).integers(0, 255, (200, 250, 3)).astype(
        np.uint8)
    soft = b"Philips DP v1.0\0"
    src = str(tmp_path / "s.tiff")
    _write_tiff(src, [lv0, lv0[::2, ::2]],
                description=[_PHILIPS_XML, None],
                extra_tags=[(305, 2, len(soft), soft)],
                sparse_tiles={(0, 5)})
    return src, 20


@pytest.mark.parametrize("make", [_svs, _ndpi, _jp2, _scn, _bif, _philips],
                         ids=["tiff_svs", "ndpi", "jp2", "scn", "bif",
                              "philips"])
def test_fuzz_container(tmp_path, make):
    src, seed = make(tmp_path)
    _try_open_read(src)  # the pristine fixture must work
    _fuzz_file(tmp_path, src, seed=seed)


def test_fuzz_mirax_container(tmp_path):
    """MIRAX: fuzz the Index.dat and Slidedat.ini sidecars."""
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 255, (4 * 48, 4 * 64, 3)).astype(np.uint8)
    src = str(tmp_path / "s.mrxs")
    _write_mrxs(src, plane, nx=4, ny=4)
    _try_open_read(src)
    base = str(tmp_path / "s")
    t0 = time.perf_counter()
    for sidecar in ("Index.dat", "Slidedat.ini"):
        orig = open(os.path.join(base, sidecar), "rb").read()
        for blob in _mutations(orig, rng, 10):
            with open(os.path.join(base, sidecar), "wb") as f:
                f.write(blob)
            try:
                _try_open_read(src)
            except ALLOWED:
                pass
        with open(os.path.join(base, sidecar), "wb") as f:
            f.write(orig)
        _try_open_read(src)  # restored container works again
    assert time.perf_counter() - t0 < CASE_SECONDS


@pytest.mark.parametrize("xml", [
    """<scn><collection><image><pixels>
       <dimension sizeX="120" sizeY="100" r="0"/>
       </pixels></image></collection></scn>""",
    """<scn><collection><image><pixels>
       <dimension sizeY="100" r="0" ifd="1"/>
       </pixels></image></collection></scn>""",
    """<scn><collection><image><view sizeX="60000"/><pixels>
       <dimension sizeX="120" sizeY="100" r="0" ifd="99"/>
       </pixels></image></collection></scn>""",
    """<scn><collection><image><pixels>
       <dimension sizeX="99999999999999" sizeY="1" r="0" ifd="1"/>
       </pixels></image></collection></scn>""",
    """<scn><collection><image name="macro"/></collection></scn>""",
], ids=["no_ifd", "no_sizex", "ifd_past_table", "size_overflow", "no_dims"])
def test_scn_malformed_xml_fails_closed(tmp_path, xml):
    rng = np.random.default_rng(6)
    macro = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
    lv0 = rng.integers(0, 255, (100, 120, 3)).astype(np.uint8)
    p = str(tmp_path / "bad.scn")
    _write_tiff(p, [macro, lv0], big=True, description=xml)
    with pytest.raises(ValueError):
        _try_open_read(p)


def test_mirax_index_overflow_fails_closed(tmp_path):
    """Page chains that loop, run past the buffer, or declare negative or
    overflowing entry counts raise ValueError."""
    rng = np.random.default_rng(7)
    plane = rng.integers(0, 255, (2 * 48, 2 * 64, 3)).astype(np.uint8)
    src = str(tmp_path / "s.mrxs")
    _write_mrxs(src, plane, nx=2, ny=2)
    idx_path = os.path.join(str(tmp_path / "s"), "Index.dat")
    orig = open(idx_path, "rb").read()
    hier_root, _ = struct.unpack_from("<ii", orig, 37)
    (first_page,) = struct.unpack_from("<i", orig, hier_root)
    for offset, value in ((first_page, 1 << 30), (first_page, -5),
                          (first_page + 4, first_page),
                          (first_page + 4, len(orig) + 1024)):
        blob = bytearray(orig)
        struct.pack_into("<i", blob, offset, value)
        with open(idx_path, "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(ValueError):
            _try_open_read(src)
    with open(idx_path, "wb") as f:
        f.write(orig)
    _try_open_read(src)
