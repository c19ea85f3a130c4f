"""The port's C++ patch gather (``cerberus_tpu_torch/native/patch_gather``)
against its numpy plain version and the JAX package's gather, with windows
off every edge of the source and from a memmap. The library builds with
the host's C++ compiler into ``cerberus_tpu_torch/build/``."""
import os

import numpy as np
import pytest

from cerberus_tpu.native import gather_patches as jax_gather
from cerberus_tpu_torch.native import patch_gather

COORDS = np.array([
    [0, 0], [100, 200], [250, 350],      # partly off the bottom-right
    [-20, -20],                          # off the top-left
    [296, 396],                          # mostly off
    [-64, 150], [150, -64],              # one side off
    [400, 500], [-100, -100],            # wholly off
])


def test_builds_into_the_package_build_dir():
    path = patch_gather.build()
    assert os.path.dirname(path) == patch_gather.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "build"
    assert os.path.isfile(path)


@pytest.mark.parametrize("channels", [3, 1, None])
def test_gather_matches_plain_and_jax(channels):
    rng = np.random.default_rng(0)
    shape = (300, 400) + ((channels,) if channels else ())
    src = rng.integers(0, 255, shape).astype(np.uint8)
    got = patch_gather.gather_patches(src, COORDS, 64, 48)
    np.testing.assert_array_equal(
        got, patch_gather.gather_patches_plain(src, COORDS, 64, 48))
    np.testing.assert_array_equal(got, jax_gather(src, COORDS, 64, 48))
    assert got.shape == (len(COORDS), 64, 48, channels or 1)


def test_gather_from_memmap_and_into_out(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 255, (256, 256, 3)).astype(np.uint8)
    np.save(tmp_path / "slide.npy", arr)
    mm = np.load(tmp_path / "slide.npy", mmap_mode="r")
    coords = np.array([[10, 10], [100, 100], [200, 200], [-30, 230]])
    out = np.full((4, 48, 48, 3), 7, np.uint8)
    got = patch_gather.gather_patches(mm, coords, 48, 48, out=out,
                                      n_threads=3)
    assert got is out
    np.testing.assert_array_equal(
        got, patch_gather.gather_patches_plain(arr, coords, 48, 48))


def test_non_contiguous_source_and_bad_out_are_handled():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 255, (200, 300, 3)).astype(np.uint8)[:, ::2]
    coords = np.array([[5, 5], [150, 120]])
    np.testing.assert_array_equal(
        patch_gather.gather_patches(src, coords, 32, 32),
        patch_gather.gather_patches_plain(np.ascontiguousarray(src), coords,
                                          32, 32))
    with pytest.raises(ValueError, match="out must be"):
        patch_gather.gather_patches(src, coords, 32, 32,
                                    out=np.empty((2, 32, 31, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        patch_gather.gather_patches(src.astype(np.float32), coords, 32, 32)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a compiler that fails makes the build raise."""
    monkeypatch.setattr(patch_gather, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(patch_gather, "_find_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="patch gather failed"):
        patch_gather.build()
