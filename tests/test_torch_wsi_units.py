"""The port's WSI modules, one by one, against their JAX package
counterparts on seeded inputs (CPU): placement, dedup, the disk canvas,
the npy-pyramid reader, the 512 padding, the on-device id compaction, the
host connected components and the tissue mask."""
import numpy as np
import pytest
import torch
import yaml

import conftest  # noqa: F401  (CPU pinning)

import jax.numpy as jnp

from cerberus_tpu.infer.resident_wsi import _compact_present_ids
from cerberus_tpu.ops import cc_cpu as jax_cc_cpu
from cerberus_tpu.ops import tissue_mask as jax_tissue_mask
from cerberus_tpu.ops.tpu_postproc import pad_to_512 as jax_pad_to_512
from cerberus_tpu.wsi import coords as jax_coords
from cerberus_tpu.wsi import dedup as jax_dedup
from cerberus_tpu.wsi import ioconfig as jax_ioconfig
from cerberus_tpu.wsi.merge import CanvasSet as JaxCanvasSet
from cerberus_tpu.wsi.reader import NpyPyramidReader as JaxNpyPyramidReader
from cerberus_tpu_torch.ops import cc_cpu, tissue_mask
from cerberus_tpu_torch.ops.device_postproc import HIST_CAP
from cerberus_tpu_torch.ops.gpu_postproc import (
    compact_present_ids,
    pad_to_512,
)
from cerberus_tpu_torch.wsi import coords, dedup, ioconfig
from cerberus_tpu_torch.wsi.merge import CanvasSet
from cerberus_tpu_torch.wsi.reader import NpyPyramidReader, open_wsi

SLIDE_SHAPES = [(503, 397), (144, 144), (1000, 53), (2049, 2050)]  # (w, h)


@pytest.mark.parametrize("shape", SLIDE_SHAPES)
@pytest.mark.parametrize("tile,margin,pin,pout", [(192, 16, 144, 48),
                                                  (2048, 64, 448, 144)])
def test_placement_matches_jax(shape, tile, margin, pin, pout):
    inf = ioconfig.make_inference_ioconfig(0.5, 6, 480, margin, pin, pout)
    pp = ioconfig.make_postproc_ioconfig(0.5, tile, margin)
    jinf = jax_ioconfig.make_inference_ioconfig(0.5, 6, 480, margin, pin,
                                                pout)
    jpp = jax_ioconfig.make_postproc_ioconfig(0.5, tile, margin)
    assert inf == type(inf)(**jinf.__dict__)
    assert pp.highest_input_resolution == jpp.highest_input_resolution
    ins, outs = coords.get_coordinates(shape, inf)
    jins, jouts = jax_coords.get_coordinates(shape, jinf)
    np.testing.assert_array_equal(ins, jins)
    np.testing.assert_array_equal(outs, jouts)

    rng = np.random.default_rng(sum(shape))
    mask = (rng.random((max(shape[1] // 7, 1), max(shape[0] // 7, 1)))
            > 0.8).astype(np.uint8)
    np.testing.assert_array_equal(
        coords.filter_coordinates(mask, outs, shape),
        jax_coords.filter_coordinates(mask, jouts, shape))

    sets = coords.get_tile_info(shape, pp)
    jsets = jax_coords.get_tile_info(shape, jpp)
    assert len(sets) == len(jsets) == 4
    for (b, f), (jb, jf) in zip(sets, jsets):
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(f, jf)
        for bounds in b:
            np.testing.assert_array_equal(
                coords.assign_patches_to_tiles(outs, bounds),
                jax_coords.assign_patches_to_tiles(jouts, bounds))


def _boxes(rng, n, w, h):
    x0 = rng.integers(-5, w, n)
    y0 = rng.integers(-5, h, n)
    return np.stack([x0, y0, x0 + rng.integers(1, 40, n),
                     y0 + rng.integers(1, 40, n)], axis=1)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_dedup_matches_jax(mode):
    rng = np.random.default_rng(mode)
    w, h, margin = 192, 160, 16
    boxes = _boxes(rng, 400, w, h)
    for flags in ([0, 0, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 1, 1]):
        np.testing.assert_array_equal(
            dedup.select_tile_removals(boxes, (w, h), margin, flags, mode),
            jax_dedup.select_tile_removals(boxes, (w, h), margin, flags,
                                           mode))
    ref_boxes = _boxes(rng, 300, 600, 500)
    tile = (150, 120, 150 + 4 * margin, 120 + 4 * margin)
    got = dedup.select_ref_removals(ref_boxes, tile, margin)
    np.testing.assert_array_equal(
        got, jax_dedup.select_ref_removals(ref_boxes, tile, margin))
    assert got.any() and not got.all()


def test_canvas_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    h, w, c = 61, 83, 9
    canvas = CanvasSet(str(tmp_path / "p"), (h, w), c)
    jcanvas = JaxCanvasSet(str(tmp_path / "j"), (h, w), c)
    for bounds in ((0, 0, 40, 30), (40, 0, 90, 30), (0, 30, 83, 70),
                   (90, 90, 100, 100)):
        values = rng.random((bounds[3] - bounds[1], bounds[2] - bounds[0],
                             c)).astype(np.float32)
        canvas.write_region(bounds, values)
        jcanvas.write_region(bounds, values)
    assert canvas.raw.dtype == np.float16
    np.testing.assert_array_equal(canvas.raw, jcanvas.raw)
    for bounds, chans in (((3, 5, 80, 61), [0, 4]), ((0, 0, 100, 100), None)):
        np.testing.assert_array_equal(canvas.read_region(bounds, chans),
                                      jcanvas.read_region(bounds, chans))
    np.testing.assert_array_equal(canvas.read_decimated(4, 8),
                                  jcanvas.read_decimated(4, 8))
    canvas.flush()
    # resume keeps what was written; another shape starts afresh
    again = CanvasSet(str(tmp_path / "p"), (h, w), c, resume=True)
    np.testing.assert_array_equal(again.raw, jcanvas.raw)
    fresh = CanvasSet(str(tmp_path / "p"), (h, w + 1), c, resume=True)
    assert fresh.raw.shape == (h, w + 1, c) and not fresh.raw.any()
    for cv in (canvas, jcanvas, again, fresh):
        cv.close()


@pytest.fixture(scope="module")
def pyramid(tmp_path_factory):
    d = tmp_path_factory.mktemp("pyr")
    rng = np.random.default_rng(1)
    lv0 = rng.integers(0, 256, (300, 420, 3)).astype(np.uint8)
    np.save(d / "level_0.npy", lv0)
    np.save(d / "level_1.npy", lv0[::2, ::2].copy())
    np.save(d / "level_2.npy", lv0[::4, ::4].copy())
    with open(d / "meta.yml", "w") as f:
        yaml.safe_dump({"mpp": 0.25, "objective_power": 40}, f)
    return str(d)


@pytest.mark.parametrize("bounds,resolution,units", [
    ((0, 0, 420, 300), 0.25, "mpp"),       # level 0
    ((-30, -20, 100, 90), 0.5, "mpp"),     # level 1, out of bounds
    ((50, 40, 120, 76), 1.0, "mpp"),       # level 2
    ((90, 60, 160, 90), 0.75, "mpp"),      # between levels: resized
    ((-10, 280, 40, 330), 0.25, "mpp"),    # past the bottom edge
    ((0, 0, 64, 64), 10, "power"),
])
def test_npy_pyramid_reads_match_jax(pyramid, bounds, resolution, units):
    reader = open_wsi(pyramid)
    jreader = JaxNpyPyramidReader(pyramid)
    assert isinstance(reader, NpyPyramidReader)
    assert reader.info == type(reader.info)(**jreader.info.__dict__)
    np.testing.assert_array_equal(reader.slide_dimensions(resolution, units),
                                  jreader.slide_dimensions(resolution, units))
    np.testing.assert_array_equal(
        reader.read_bounds(bounds, resolution, units),
        jreader.read_bounds(bounds, resolution, units))


def test_image_and_virtual_readers_match_jax(tmp_path):
    import cv2

    from cerberus_tpu.wsi.reader import ImageReader as JaxImageReader
    from cerberus_tpu.wsi.reader import VirtualWSIReader as JaxVirtual
    from cerberus_tpu_torch.wsi.reader import ImageReader, VirtualWSIReader

    img = np.random.default_rng(5).integers(0, 256, (90, 130, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    assert isinstance(open_wsi(path), ImageReader)
    gray = img[..., 0]
    for got, ref in ((open_wsi(path), JaxImageReader(path)),
                     (VirtualWSIReader(gray), JaxVirtual(gray))):
        for bounds, res in (((-7, 3, 70, 95), 0.5), ((10, 10, 50, 40), 1.0)):
            np.testing.assert_array_equal(got.read_bounds(bounds, res),
                                          ref.read_bounds(bounds, res))


@pytest.mark.parametrize("ext", [".svs", ".tif", ".mrxs", ".jp2"])
def test_unported_slide_formats_raise(tmp_path, ext):
    """These formats were refused before their readers were ported; an
    empty file of each now fails as a corrupt slide does (a ``ValueError``
    from the reader open_wsi dispatches to), never as unsupported."""
    path = tmp_path / ("x" + ext)
    path.write_bytes(b"")
    with pytest.raises(ValueError):
        open_wsi(str(path))


@pytest.mark.parametrize("shape", [(512, 512, 2), (1, 1), (513, 100, 3),
                                   (600, 1030)])
def test_pad_to_512_matches_jax(shape):
    arr = np.random.default_rng(2).random(shape).astype(np.float32)
    got = pad_to_512(arr)
    np.testing.assert_array_equal(got, jax_pad_to_512(arr))
    assert got.shape[:2] == tuple(-(-s // 512) * 512 for s in shape[:2])


def _sparse_labels(hw, n_ids, max_id, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, max_id + 1), n_ids, replace=False)
    lab = np.zeros(hw, np.int32)
    flat = rng.choice(hw[0] * hw[1], 3 * n_ids, replace=False)
    lab.reshape(-1)[flat] = np.repeat(ids, 3)
    return lab


@pytest.mark.parametrize("hw,n_ids,max_id", [
    ((64, 96), 300, HIST_CAP - 1),       # the hist16384 branch
    ((97, 131), 700, 97 * 131),          # past 16384: the bincount branch
    ((33, 40), 1, 1),
])
def test_compact_present_ids_matches_jax(hw, n_ids, max_id):
    lab = _sparse_labels(hw, n_ids, max_id, sum(hw))
    got, n = compact_present_ids(torch.from_numpy(lab))
    ref, ref_n = _compact_present_ids(jnp.asarray(lab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(n) == int(ref_n) == n_ids
    assert (max_id < HIST_CAP) == (int(lab.max()) < HIST_CAP)


def test_compact_present_ids_of_an_empty_plane():
    got, n = compact_present_ids(torch.zeros((5, 7), dtype=torch.int32))
    assert int(n) == 0 and not got.any()


def test_cc_cpu_label_matches_jax():
    mask = np.random.default_rng(3).random((120, 90)) > 0.55
    lab, n = cc_cpu.label(mask)
    ref, ref_n = jax_cc_cpu.label(mask)
    assert n == ref_n and lab.dtype == ref.dtype
    np.testing.assert_array_equal(lab, ref)


def test_tissue_mask_matches_jax():
    rng = np.random.default_rng(4)
    thumb = np.full((160, 200, 3), 235, np.uint8)  # bright background
    yy, xx = np.mgrid[:160, :200]
    tissue = (yy - 80) ** 2 / 60 ** 2 + (xx - 90) ** 2 / 70 ** 2 < 1
    stain = rng.integers(60, 200, (160, 200, 3)).astype(np.uint8)
    thumb[tissue] = stain[tissue]
    got = tissue_mask.get_tissue_mask(thumb)
    np.testing.assert_array_equal(got, jax_tissue_mask.get_tissue_mask(thumb))
    assert got.dtype == np.uint8 and 0 < got.mean() < 1
