"""The port's slide readers against the JAX package's, on every fixture the
JAX reader tests write: ``open_wsi`` returns a reader of the same class
name with the same ``SlideInfo`` and level downsamples, and the same pixels
for ``read_bounds`` at the native resolution and at twice its mpp, and for
``slide_thumbnail``. ``NpyPyramidReader.read_batch`` equals the JAX one.

The writers are the JAX tests' own (``tests/test_tiff_reader.py``,
``test_ndpi_reader.py``, ``test_mirax_reader.py``); the OpenSlide and
glymur cases drive both packages through one stub module, as
``tests/test_pyramid_readers.py`` does.
"""
import dataclasses
import os
import sys
import types
import zlib

import cv2
import numpy as np
import pytest
import yaml

from cerberus_tpu.wsi import reader as jax_reader
from cerberus_tpu_torch.wsi import reader as port_reader

from tests.test_mirax_reader import TH, TW, _write_mrxs
from tests.test_ndpi_reader import _write_ndpi
from tests.test_tiff_reader import (
    _ISCAN_XML,
    _PHILIPS_XML,
    _SCN_XML,
    _hdiff,
    _j2k_codestream,
    _lzw_encode,
    _write_tiff,
    _write_tiff_lzw,
)


def _levels():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (20, 25, 3)).astype(np.uint8)
    lv0 = np.kron(base, np.ones((10, 10, 1))).astype(np.uint8)  # 200x250
    return lv0, lv0[::2, ::2]


def _rand(seed, hw):
    return np.random.default_rng(seed).integers(
        0, 255, (*hw, 3)).astype(np.uint8)


def _tiff(name, **kw):
    def make(tmp_path):
        lv0, lv1 = _levels()
        path = str(tmp_path / name)
        _write_tiff(path, [lv0, lv1], **kw)
        return path, None
    return make


def _lzw(tmp_path):
    path = str(tmp_path / "lzw.tif")
    _write_tiff_lzw(path, _levels()[0])
    return path, 0.5


def _predictor2(compression):
    def make(tmp_path):
        enc = _lzw_encode if compression == 5 else zlib.compress
        path = str(tmp_path / f"pred_{compression}.tif")
        _write_tiff(path, [_levels()[0]], compression=compression,
                    tile_encoder=lambda t: enc(_hdiff(t)),
                    extra_tags=[(317, 3, 1, [2])])
        return path, 0.5
    return make


def _scn(tmp_path):
    lv0, lv1 = _levels()
    path = str(tmp_path / "slide.scn")
    _write_tiff(path, [_rand(4, (80, 100)), lv0, lv1], big=True,
                description=_SCN_XML)
    return path, None


def _bif(tmp_path):
    lv0, lv1 = _levels()
    xmp = _ISCAN_XML.encode()
    path = str(tmp_path / "slide.bif")
    _write_tiff(path, [_rand(7, (40, 50)), lv0, lv1], big=True,
                description=["Thumbnail", None, None],
                extra_tags={1: [(700, 7, len(xmp), xmp)]})
    return path, None


def _philips(tmp_path):
    lv0, lv1 = _levels()
    soft = b"Philips DP v1.0\0"
    path = str(tmp_path / "slide.tiff")
    _write_tiff(path, [lv0, lv1, _rand(8, (40, 50))],
                description=[_PHILIPS_XML, None, "Macro image"],
                extra_tags=[(305, 2, len(soft), soft)],
                sparse_tiles={(0, 5)})
    return path, None


def _j2k_rgb(tmp_path):
    lv0, lv1 = _levels()
    path = str(tmp_path / "j2k_33005.svs")
    _write_tiff(path, [lv0, lv1], compression=33005,
                description="Aperio |AppMag = 40|MPP = 0.25|",
                tile_encoder=_j2k_codestream)
    return path, None


def _j2k_ycbcr(tmp_path):
    def enc(t):
        tyc = cv2.cvtColor(t, cv2.COLOR_RGB2YCrCb)
        ok, data = cv2.imencode(
            ".jp2", tyc[..., [1, 2, 0]],
            [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
        assert ok
        data = data.tobytes()
        return data[data.find(b"jp2c") + 4:]

    path = str(tmp_path / "j2k_ycc.svs")
    _write_tiff(path, [_levels()[0]], compression=33003,
                description="|MPP = 0.25|", tile_encoder=enc)
    return path, None


def _ndpi_arrays():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (20, 25, 3)).astype(np.uint8)
    lv0 = np.kron(base, np.ones((10, 10, 1))).astype(np.uint8)
    return lv0, lv0[::2, ::2], rng.integers(0, 255, (40, 90, 3)).astype(
        np.uint8)


def _ndpi(tmp_path):
    lv0, lv1, macro = _ndpi_arrays()
    path = str(tmp_path / "slide.ndpi")
    _write_ndpi(path, [lv0, lv1, macro], [40.0, 10.0, -1.0], mpp=0.44)
    return path, None


def _ndpi_4gb(tmp_path):
    """``tests/test_ndpi_reader.py``'s >4 GB case: the body shifted by
    exactly 2^32 in a sparse file, so every stored offset wraps."""
    small, _ = _ndpi(tmp_path)
    data = open(small, "rb").read()
    path = str(tmp_path / "big.ndpi")
    try:
        with open(path, "wb") as f:
            f.write(data[:8])
            f.seek(1 << 32)
            f.write(data)
    except OSError:
        pytest.skip("filesystem cannot hold a 4 GB sparse file")
    if os.stat(path).st_blocks * 512 > 64 * 1024 * 1024:
        os.unlink(path)
        pytest.skip("filesystem does not store sparse files sparsely")
    return path, None


def _ndpi_zstack(tmp_path):
    lv0, lv1, macro = _ndpi_arrays()
    blur0 = cv2.GaussianBlur(lv0, (15, 15), 7)
    blur1 = cv2.GaussianBlur(lv1, (15, 15), 7)
    path = str(tmp_path / "zstack.ndpi")
    _write_ndpi(path, [blur0, lv0, blur0, blur1, lv1, blur1, macro],
                [40.0, 40.0, 40.0, 10.0, 10.0, 10.0, -1.0], mpp=0.44,
                z_offsets=[-2000, 0, 2000, -2000, 0, 2000, None])
    return path, None


def _mirax_plane():
    rng = np.random.default_rng(3)
    base = rng.integers(30, 225, (4 * TH // 8, 4 * TW // 8, 3))
    return np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)


def _mirax(**kw):
    def make(tmp_path):
        path = str(tmp_path / "a.mrxs")
        _write_mrxs(path, _mirax_plane(), nx=4, ny=4, **kw)
        return path, None
    return make


def _jp2(tmp_path):
    plane = _rand(3, (300, 400))
    ok, enc = cv2.imencode(".jp2", cv2.cvtColor(plane, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    assert ok
    path = tmp_path / "s.jp2"
    path.write_bytes(enc.tobytes())
    return str(path), 0.25


def _npy_pyramid(tmp_path):
    d = tmp_path / "slide"
    os.makedirs(d)
    level0 = _rand(0, (400, 600))
    np.save(d / "level_0.npy", level0)
    np.save(d / "level_1.npy", level0[::2, ::2])
    np.save(d / "level_2.npy", level0[::4, ::4])
    with open(d / "meta.yml", "w") as f:
        yaml.safe_dump({"mpp": 0.25, "objective_power": 40}, f)
    return str(d), None


FIXTURES = {
    "raw": _tiff("raw.svs", description="Aperio |MPP = 0.25|"),
    "deflate": _tiff("deflate.svs", compression=8,
                     description="Aperio |MPP = 0.25|"),
    "lzw": _lzw,
    "predictor2_lzw": _predictor2(5),
    "predictor2_deflate": _predictor2(8),
    "jpeg": _tiff("jpeg.svs", compression=7,
                  description="Aperio |AppMag = 20|MPP = 0.5|"),
    "bigtiff": _tiff("big.svs", big=True, compression=8,
                     description="Aperio |MPP = 0.25|"),
    "resolution_tags": _tiff("xres.tif"),
    "scn": _scn,
    "bif": _bif,
    "philips_sparse": _philips,
    "aperio_j2k_rgb": _j2k_rgb,
    "aperio_j2k_ycbcr": _j2k_ycbcr,
    "ndpi_macro_skip": _ndpi,
    "ndpi_4gb_unwrap": _ndpi_4gb,
    "ndpi_zstack": _ndpi_zstack,
    "mirax_grid": _mirax(mpp=0.25),
    "mirax_sparse_jpeg": _mirax(fmt="JPEG", skip_tiles={5},
                                fill_bgr=0xFFFFFF),
    "mirax_position_buffer": _mirax(
        positions={cy * 4 + cx: (cx * TW + 7, cy * TH + 11)
                   for cy in range(4) for cx in range(4)},
        fill_bgr=255 << 16),
    "mirax_negative_origin": _mirax(positions={0: (-5, -3)}),
    "jp2_native": _jp2,
    "npy_pyramid": _npy_pyramid,
}


def _info(reader):
    return dataclasses.astuple(reader.info)


def _assert_same_reader(path, mpp):
    ref = jax_reader.open_wsi(path, mpp=mpp)
    got = port_reader.open_wsi(path, mpp=mpp)
    assert type(got).__name__ == type(ref).__name__
    assert type(got).__module__.startswith("cerberus_tpu_torch.")
    assert _info(got) == _info(ref)
    assert got._level_downsamples == ref._level_downsamples
    base = got.info.mpp
    w, h = got.info.slide_dimensions
    for res, bounds in ((base, [3, 5, min(w, 131), min(h, 117)]),
                        (base, [-20, -10, 70, 60]),
                        (2 * base, [0, 0, w // 2, h // 2])):
        np.testing.assert_array_equal(
            got.read_bounds(bounds, resolution=res, units="mpp"),
            ref.read_bounds(bounds, resolution=res, units="mpp"))
    np.testing.assert_array_equal(
        got.slide_thumbnail(resolution=4 * base, units="mpp"),
        ref.slide_thumbnail(resolution=4 * base, units="mpp"))
    return got


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_open_wsi_matches_jax_reader(tmp_path, name):
    path, mpp = FIXTURES[name](tmp_path)
    got = _assert_same_reader(path, mpp)
    if name == "ndpi_4gb_unwrap":
        small = port_reader.open_wsi(str(tmp_path / "slide.ndpi"))
        np.testing.assert_array_equal(
            got.read_bounds([0, 0, 128, 128], resolution=0.44),
            small.read_bounds([0, 0, 128, 128], resolution=0.44))


def _stub_openslide(monkeypatch):
    level0 = _rand(1, (256, 512))
    levels = [level0, level0[::2, ::2], level0[::4, ::4]]

    class FakeSlide:
        properties = {"openslide.mpp-x": "0.25",
                      "openslide.objective-power": "40"}
        dimensions = (512, 256)
        level_downsamples = [1.0, 2.0, 4.0]

        def __init__(self, path):
            pass

        def read_region(self, loc, lvl, size):
            x0l, y0l = loc[0] // int(2 ** lvl), loc[1] // int(2 ** lvl)
            return levels[lvl][y0l:y0l + size[1], x0l:x0l + size[0]]

    fake = types.ModuleType("openslide")
    fake.OpenSlide = FakeSlide
    monkeypatch.setitem(sys.modules, "openslide", fake)


def _stub_glymur(monkeypatch):
    plane = _rand(2, (300, 400))

    class FakeJp2k:
        shape = plane.shape

        def __init__(self, path):
            pass

        def __getitem__(self, key):
            return plane[key]

    fake = types.ModuleType("glymur")
    fake.Jp2k = FakeJp2k
    monkeypatch.setitem(sys.modules, "glymur", fake)


@pytest.mark.parametrize("name, stub", [
    ("fake.svs", _stub_openslide), ("fake.mrxs", _stub_openslide),
    ("fake.jp2", _stub_glymur)])
def test_stubbed_library_readers_match_jax(monkeypatch, name, stub):
    """With ``openslide`` (or ``glymur``) importable, both packages' open_wsi
    take the library reader, and read the same pixels."""
    stub(monkeypatch)
    got = _assert_same_reader(name, 0.25 if name.endswith(".jp2") else None)
    assert type(got).__name__ in ("OpenSlideReader", "JP2Reader")


def test_tiff_that_fails_to_parse_falls_back_to_image_reader(tmp_path):
    """A ``.tif`` the TIFF parser refuses (cv2's single-image TIFF carries
    no MPP) goes to ``ImageReader`` in both packages."""
    img = _rand(9, (60, 80))
    path = str(tmp_path / "plain.tif")
    assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    got = _assert_same_reader(path, None)
    assert type(got).__name__ == "ImageReader"
    np.testing.assert_array_equal(
        got.read_bounds([0, 0, 80, 60], resolution=0.5), img)


@pytest.mark.parametrize("resolution", [0.25, 0.5, 0.75])
def test_read_batch_matches_jax(tmp_path, resolution):
    """Native-scale batches (level 0 at 0.25 mpp, level 1 at 0.5 mpp) go
    through the C++ gather, the 0.75 mpp batch through per-window reads;
    windows run off the slide on every side."""
    path, _ = _npy_pyramid(tmp_path)
    got_r = port_reader.open_wsi(path)
    ref_r = jax_reader.open_wsi(path)
    rng = np.random.default_rng(4)
    tl = np.concatenate([rng.integers(-40, 560, (12, 2)),
                         [[-64, -64], [590, 390]]])
    bounds = np.concatenate([tl, tl + 64], axis=1)
    got = got_r.read_batch(bounds, resolution)
    np.testing.assert_array_equal(got, ref_r.read_batch(bounds, resolution))
    assert got.shape == (len(bounds), 64, 64, 3)
