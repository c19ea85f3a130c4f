"""The port's post-processing primitives and families against the JAX lax
versions (``cc_impl="lax"``) on the CPU, byte for byte.

Masks are the pinned-seed smoothed-noise and structured cases of
tests/test_postproc_fuzz.py; canvases are seeded blob probability planes.
The port's functions run here through the kernel wrappers, which take the
plain versions for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cerberus_tpu.ops import lax_postproc as L
from cerberus_tpu.ops import tpu_postproc as T
from cerberus_tpu_torch.ops import device_postproc as D
from cerberus_tpu_torch.ops import gpu_postproc as G

torch.set_num_threads(2)


def _smooth_noise_mask(shape, seed, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    for _ in range(2):
        for axis in (0, 1):
            x = sum(np.roll(x, s, axis=axis) for s in (-2, -1, 0, 1, 2)) / 5
    return x > np.quantile(x, 1.0 - density)


def _cases():
    cases = []
    for shape in [(64, 128), (96, 96), (97, 131), (48, 384)]:
        for seed, density in [(0, 0.15), (1, 0.5), (2, 0.85)]:
            cases.append(_smooth_noise_mask(shape, seed, density))
    cases.append(np.zeros((40, 130), bool))
    cases.append(np.ones((40, 130), bool))
    dots = np.zeros((33, 129), bool)
    dots[::4, ::5] = True
    cases.append(dots)
    stripes = np.zeros((64, 160), bool)
    stripes[:, ::3] = True
    stripes[0, :] = True
    cases.append(stripes)
    return cases


CASES = _cases()


def _t(x):
    return torch.tensor(np.asarray(x))


def _lax_lab(mask):
    return np.asarray(L.connected_components(jnp.asarray(mask)))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_cc_erode_fill_holes_match_lax(idx):
    mask = CASES[idx]
    lab = D.connected_components(_t(mask)).numpy()
    np.testing.assert_array_equal(lab, _lax_lab(mask))
    for k in (3, 7):  # 5 taps (shift path in lax) and 37 taps (conv path)
        se = L.disk_kernel(k)
        np.testing.assert_array_equal(
            D.binary_erode(_t(mask), se).numpy(),
            np.asarray(L.binary_erode(jnp.asarray(mask), se)))
    np.testing.assert_array_equal(
        D.fill_holes(_t(mask)).numpy(),
        np.asarray(L.fill_holes(jnp.asarray(mask), cc_impl="lax")))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_remove_small_dilate_fill_label_holes_match_lax(idx):
    lab = _lax_lab(CASES[idx])
    for min_size in (4, 64):
        got = D.remove_small_objects(_t(lab), min_size).numpy()
        ref = np.asarray(L.remove_small_objects(jnp.asarray(lab), min_size))
        np.testing.assert_array_equal(got, ref)
    for ksize in (2, 3, 10):
        dil = D.dilate_labels(_t(ref), ksize).numpy()
        ref_dil = np.asarray(L.dilate_labels(jnp.asarray(ref), ksize))
        np.testing.assert_array_equal(dil, ref_dil)
    np.testing.assert_array_equal(
        D.fill_label_holes(_t(ref_dil)).numpy(),
        np.asarray(L.fill_label_holes(jnp.asarray(ref_dil), cc_impl="lax")))


def test_remove_small_objects_past_16384_components():
    """More components than the histogram's bins: the bincount path."""
    mask = np.zeros((300, 300), bool)
    mask[::2, ::2] = True                   # 22500 single-pixel components
    mask[100:120, 100:120] = True           # one 400 px component
    lab = _lax_lab(mask)
    assert len(np.unique(lab)) - 1 > D.HIST_CAP
    for min_size in (1, 2):
        got = D.remove_small_objects(_t(lab), min_size).numpy()
        ref = np.asarray(L.remove_small_objects(jnp.asarray(lab), min_size))
        np.testing.assert_array_equal(got, ref)


def test_fill_label_holes_contested_path():
    """A pocket enclosed jointly by two instances takes the flood path."""
    lab = np.zeros((40, 48), np.int32)
    lab[5:30, 5:35] = 1
    lab[5:30, 20:35] = 2
    lab[10:25, 10:30] = 0                   # the pocket touches both
    lab[33:38, 40:46] = 3
    lab[34:37, 42:44] = 0                   # a one-instance hole too
    ref = np.asarray(L.fill_label_holes(jnp.asarray(lab), cc_impl="lax"))
    got = D.fill_label_holes(_t(lab)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got[10:25, 10:30])) == {1, 2}


def _blob_prob(hw, n, seed, rmin=3.0, rmax=12.0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = r.integers(0, hw[0]), r.integers(0, hw[1])
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r.uniform(rmin, rmax)
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    return prob + r.random(hw).astype(np.float32) * 0.02


FAMILY_SEEDS = [(0, (96, 128)), (1, (97, 131)), (2, (128, 96))]


def _lax_nuclei_compacted_markers(inner, cnt):
    """The JAX nuclei family with its markers compacted before the
    watershed, as ``cerberus_tpu/infer/resident_wsi.py:182-191`` runs it
    (and as the port's family does everywhere)."""
    msk = L.binary_erode((inner + cnt) > 0.5, L.disk_kernel(3))
    msk = L.remove_small_objects(L.connected_components(msk), 8) > 0
    mrk_lab = L.remove_small_objects(L.connected_components(inner > 0.5), 4)
    mrk = L.fill_holes(mrk_lab > 0)
    markers, _ = L._compact_labels_jit(L.connected_components(mrk))
    return L.watershed(-inner, markers, msk)


@pytest.mark.parametrize("seed,hw", FAMILY_SEEDS)
def test_nuclei_watershed_family_matches_lax(seed, hw):
    inner = _blob_prob(hw, 40, seed)
    cnt = _blob_prob(hw, 40, seed + 10) * 0.6
    ref = np.asarray(_lax_nuclei_compacted_markers(jnp.asarray(inner),
                                                   jnp.asarray(cnt)))
    got = G._nuclei_watershed(_t(inner), _t(cnt)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.max() > 0
    # the tile family's own output (uncompacted markers) after the host
    # compaction is the same map
    tile_ref = np.asarray(T._nuclei_watershed(jnp.asarray(inner),
                                              jnp.asarray(cnt), "lax"))
    np.testing.assert_array_equal(G._compact_labels(got),
                                  T._compact_labels(tile_ref))


@pytest.mark.parametrize("seed,hw", FAMILY_SEEDS)
@pytest.mark.parametrize("thresh,min_size,ksize", [(0.55, 60, 10),
                                                   (0.5, 20, 2),
                                                   (0.55, 1000, 10)])
def test_contour_and_eroded_families_match_lax(seed, hw, thresh, min_size,
                                               ksize):
    inner = _blob_prob(hw, 12, seed, rmin=8, rmax=30)
    cnt = _blob_prob(hw, 12, seed + 20, rmin=2, rmax=10)
    ref = np.asarray(T._inner_contour_instances(
        jnp.asarray(inner), jnp.asarray(cnt), thresh, min_size, ksize, "lax"))
    got = G._inner_contour_instances(_t(inner), _t(cnt), thresh, min_size,
                                     ksize).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(G._compact_labels(got),
                                  T._compact_labels(ref))
    ref = np.asarray(T._eroded_map_instances(jnp.asarray(inner), 0.5,
                                             min_size, ksize, "lax"))
    got = G._eroded_map_instances(_t(inner), 0.5, min_size, ksize).numpy()
    np.testing.assert_array_equal(got, ref)


def test_post_process_classes_match_tpu_classes():
    hw = (120, 150)
    canvas = np.zeros((*hw, 9), np.float32)
    for ch, (n, seed, rmax) in enumerate([(8, 3, 30), (10, 4, 14),
                                          (6, 5, 40), (8, 6, 12),
                                          (40, 7, 8), (40, 8, 9)]):
        canvas[..., ch] = _blob_prob(hw, n, seed, rmax=rmax)
    canvas[..., 6] = np.random.default_rng(0).integers(0, 7, hw)
    canvas[..., 7] = np.random.default_rng(1).integers(0, 3, hw)
    idx = {"Lumen-INST": [0, 2], "Gland-INST": [2, 4], "Nuclei-INST": [4, 6],
           "Nuclei-TYPE": [6, 7], "Gland-TYPE": [7, 8], "Patch-Class": [8, 9]}
    for tissue in ("Gland", "Lumen", "Nuclei"):
        ref_inst, ref_type = T.TPUPostProcInstErodedContourMap.post_process(
            canvas, idx, tissue)
        got_inst, got_type = G.GPUPostProcInstErodedContourMap.post_process(
            _t(canvas), idx, tissue)
        assert got_inst.dtype == np.float64
        np.testing.assert_array_equal(got_inst, ref_inst, err_msg=tissue)
        if ref_type is None:
            assert got_type is None
        else:
            np.testing.assert_array_equal(got_type, ref_type)
    ref_inst, _ = T.TPUPostProcInstErodedMap.post_process(
        canvas[..., 4:5], {"Nuclei-INST": [0, 1]}, "Nuclei")
    got_inst, _ = G.GPUPostProcInstErodedMap.post_process(
        _t(canvas[..., 4:5]), {"Nuclei-INST": [0, 1]}, "Nuclei")
    np.testing.assert_array_equal(got_inst, ref_inst)
