"""The port's kernel contracts on the CPU: each plain version (what a kernel
wrapper runs for a CPU tensor) against the JAX package's lax function and
its Pallas kernel in interpret mode, byte for byte. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cerberus_tpu.ops import lax_postproc as L
from cerberus_tpu.ops.pallas_cc import connected_components_pallas
from cerberus_tpu.ops.pallas_cc_blocked import (
    connected_components_pallas_blocked,
)
from cerberus_tpu.ops.pallas_hist import hist16384_pallas
from cerberus_tpu.ops.pallas_watershed import watershed_pallas
from cerberus_tpu_torch.ops import cuda_build
from cerberus_tpu_torch.ops.cc_label import (
    connected_components,
    connected_components_plain,
)
from cerberus_tpu_torch.ops.device_postproc import disk_kernel
from cerberus_tpu_torch.ops.hist16384 import N_BINS, hist16384
from cerberus_tpu_torch.ops.watershed import (
    propagate_labels,
    watershed,
    watershed_plain,
)

torch.set_num_threads(2)


def _random_mask(seed, hw, p=0.55):
    return np.random.default_rng(seed).random(hw) > p


def _blobs(seed=7, hw=(384, 256), n=40):
    r = np.random.default_rng(seed)
    yy, xx = np.ogrid[:hw[0], :hw[1]]
    mask = np.zeros(hw, bool)
    for _ in range(n):
        cy, cx = r.integers(10, hw[0] - 14), r.integers(10, hw[1] - 10)
        rad = r.integers(4, 14)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    return mask


def _snake():
    snake = np.zeros((512, 128), bool)
    snake[:, 0] = True
    snake[-1, :] = True
    snake[:, -1] = True
    snake[0, 64:] = True
    return snake


def _spiral(n=61):
    """One 1 px corridor winding inwards: the worst case for propagation."""
    mask = np.zeros((n, n), bool)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top <= bottom and left <= right:
        mask[top, left:right + 1] = True
        mask[top:bottom + 1, right] = True
        mask[bottom, left:right + 1] = True
        mask[top + 2:bottom + 1, left] = True
        if top + 2 <= bottom:
            mask[top + 2, left:right - 1] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return mask


def _id_space():
    mask = np.zeros((20, 150), bool)  # width not a multiple of 128
    mask[2:6, 2:6] = True
    mask[10:15, 120:145] = True
    return mask


CC_CASES = {
    "random64": lambda: _random_mask(0, (64, 64)),
    "random96x130": lambda: _random_mask(1, (96, 130)),
    "random40x257": lambda: _random_mask(2, (40, 257)),
    "id_space": _id_space,
    "blobs": _blobs,
    "blobs640": lambda: _blobs(seed=5, hw=(640, 640), n=300),  # > 400k px
    "snake": _snake,
    "spiral": _spiral,
    "empty": lambda: np.zeros((33, 70), bool),
    "full": lambda: np.ones((33, 70), bool),
}


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_cc_plain_matches_lax_and_pallas(case):
    mask = CC_CASES[case]()
    got = connected_components_plain(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    lax = np.asarray(L.connected_components(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, lax)
    if mask.size <= 64 * 1024:
        pal = np.asarray(connected_components_pallas(jnp.asarray(mask),
                                                     interpret=True))
        np.testing.assert_array_equal(got, pal)
    if case in ("blobs", "snake", "random96x130"):
        blk = np.asarray(connected_components_pallas_blocked(
            jnp.asarray(mask), interpret=True))
        np.testing.assert_array_equal(got, blk)


def test_cc_wrapper_runs_plain_on_cpu_without_counting():
    mask = _blobs(seed=3, hw=(64, 96), n=6)
    cuda_build.reset_launch_counts()
    got = connected_components(torch.from_numpy(mask))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(L.connected_components(jnp.asarray(mask))))
    assert cuda_build.launch_counts["cc_label"] == 0


@pytest.mark.parametrize("seed,shape,hi", [
    (0, (448, 448), 300),       # tile-mode canvas, small id space
    (1, (257, 515), N_BINS),    # ragged shape, every bin reachable
    (2, (70000,), 5),           # 1-D flat, heavy duplicate counts
])
def test_hist_matches_pallas_and_bincount(seed, shape, hi):
    ids = np.random.default_rng(seed).integers(0, hi, size=shape).astype(
        np.int32)
    got = hist16384(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.int32 and got.shape == (N_BINS,)
    np.testing.assert_array_equal(got, np.bincount(ids.reshape(-1),
                                                   minlength=N_BINS))
    np.testing.assert_array_equal(
        got, np.asarray(hist16384_pallas(ids, interpret=True)))


def test_hist_extreme_and_out_of_range_ids():
    ids = np.zeros((333,), np.int32)
    ids[:7] = N_BINS - 1
    ids[7:10] = N_BINS + 5      # clipped into the last bin
    ids[10:14] = -3             # clipped into bin 0
    got = hist16384(torch.from_numpy(ids)).numpy()
    assert got[0] == 333 - 10
    assert got[N_BINS - 1] == 10
    assert got.sum() == 333
    np.testing.assert_array_equal(
        got, np.asarray(hist16384_pallas(ids, interpret=True)))


def _ws_two_basins():
    rng = np.random.default_rng(0)
    inner = np.zeros((64, 80), np.float32)
    inner[10:30, 10:30] = 0.9
    inner[10:30, 34:60] = 0.9
    inner += rng.random((64, 80)).astype(np.float32) * 0.05
    mask = np.zeros((64, 80), bool)
    mask[8:32, 8:62] = True
    markers = np.zeros((64, 80), np.int32)
    markers[20, 20] = 1
    markers[20, 45] = 2
    return -inner, markers, mask


def _ws_padding():
    inner = np.zeros((30, 70), np.float32)
    inner[5:25, 5:65] = 0.8
    markers = np.zeros((30, 70), np.int32)
    markers[15, 10] = 3
    return -inner, markers, inner > 0.5


def _ws_nuclei_like(seed=4, hw=(96, 112)):
    """Many touching blobs with plateaus, markers from their cores."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(25):
        cy, cx = r.integers(0, hw[0]), r.integers(0, hw[1])
        rad = r.uniform(4, 9)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / rad
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    prob = np.round(prob * 8) / 8  # plateaus make ties
    markers = np.asarray(L.connected_components(jnp.asarray(prob > 0.6)))
    return -prob, markers.astype(np.int32), prob > 0.1


WS_CASES = {"two_basins": _ws_two_basins, "padding": _ws_padding,
            "nuclei_like": _ws_nuclei_like}


@pytest.mark.parametrize("case", sorted(WS_CASES))
def test_watershed_plain_matches_lax_and_pallas(case):
    image, markers, mask = WS_CASES[case]()
    got = watershed_plain(torch.from_numpy(image), torch.from_numpy(markers),
                          torch.from_numpy(mask)).numpy()
    args = (jnp.asarray(image), jnp.asarray(markers), jnp.asarray(mask))
    np.testing.assert_array_equal(got, np.asarray(L.watershed(*args)))
    np.testing.assert_array_equal(
        got, np.asarray(watershed_pallas(*args, interpret=True)))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        got, watershed(torch.from_numpy(image), torch.from_numpy(markers),
                       torch.from_numpy(mask)).numpy())


def test_propagate_matches_lax():
    image, markers, mask = _ws_nuclei_like(seed=9)
    big = jnp.int32(mask.size + 2)
    ref = np.asarray(L._propagate_labels(jnp.asarray(markers),
                                         jnp.asarray(mask), big))
    got = propagate_labels(torch.from_numpy(markers),
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ksize", range(1, 26))
def test_disk_kernel_matches_cv2(ksize):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    np.testing.assert_array_equal(disk_kernel(ksize), ref.astype(np.float32))
