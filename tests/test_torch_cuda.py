"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
where CUDA is absent; on a GPU machine run
``python -m pytest tests/test_torch_cuda.py -q``. Outputs must be exact:
every kernel computes an integer fixed point with a deterministic contract.
"""
import numpy as np
import pytest
import torch

from cerberus_tpu_torch.ops import cuda_build
from cerberus_tpu_torch.ops import device_postproc as D
from cerberus_tpu_torch.ops import gpu_postproc as G
from cerberus_tpu_torch.ops.cc_label import (
    connected_components,
    connected_components_plain,
)
from cerberus_tpu_torch.ops.hist16384 import hist16384, hist16384_plain
from cerberus_tpu_torch.ops.watershed import (
    propagate_labels,
    propagate_labels_plain,
    watershed,
    watershed_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build_all()
    return torch.device("cuda")


def _blob_prob(hw, n, seed, rmin=4, rmax=14):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = r.integers(0, hw[0]), r.integers(0, hw[1])
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r.uniform(rmin, rmax)
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    return prob


@pytest.mark.parametrize("hw,density", [((600, 600), 0.5), ((1000, 1000), 0.3),
                                        ((37, 1029), 0.6)])
def test_cc_label_matches_plain(dev, hw, density):
    mask = torch.from_numpy(np.random.default_rng(0).random(hw) < density)
    mask = mask.to(dev)
    got = connected_components(mask)
    torch.cuda.synchronize()
    assert torch.equal(got, connected_components_plain(mask))


def test_cc_label_spiral(dev):
    n = 301
    mask = np.zeros((n, n), bool)
    t, l, b, r = 0, 0, n - 1, n - 1
    while t <= b and l <= r:
        mask[t, l:r + 1] = mask[b, l:r + 1] = True
        mask[t:b + 1, r] = True
        mask[t + 2:b + 1, l] = True
        if t + 2 <= b:
            mask[t + 2, l:r - 1] = True
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    m = torch.from_numpy(mask).to(dev)
    got = connected_components(m)
    assert torch.equal(got, connected_components_plain(m))
    assert int(got[m].unique().numel()) == 1


def test_hist16384_matches_plain(dev):
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        -5, 16400, (1000, 1000)).astype(np.int32)).to(dev)
    ids[:500] = 0  # mostly-background plane: contention on bin 0
    assert torch.equal(hist16384(ids), hist16384_plain(ids))


def test_watershed_matches_plain(dev):
    prob = _blob_prob((512, 640), 300, seed=2)
    prob = np.round(prob * 16) / 16
    image = torch.from_numpy(-prob).to(dev)
    markers = connected_components(torch.from_numpy(prob > 0.6).to(dev))
    mask = torch.from_numpy(prob > 0.1).to(dev)
    got = watershed(image, markers, mask)
    assert torch.equal(got, watershed_plain(image, markers, mask))
    allowed = mask.contiguous()
    cuda_build.reset_launch_counts()
    assert torch.equal(propagate_labels(markers, allowed),
                       propagate_labels_plain(markers, allowed))
    assert cuda_build.launch_counts["propagate_labels"] == 1
    assert cuda_build.launch_counts["watershed"] == 0


def test_families_match_plain(dev):
    hw = (700, 650)
    canvas = torch.zeros((*hw, 9), dtype=torch.float32)
    for ch, (n, seed, rmax) in enumerate([(20, 3, 60), (30, 4, 30),
                                          (60, 5, 50), (60, 6, 20),
                                          (400, 7, 9), (400, 8, 11)]):
        canvas[..., ch] = torch.from_numpy(_blob_prob(hw, n, seed,
                                                      rmax=rmax))
    canvas = canvas.to(dev)
    idx = {"Lumen-INST": [0, 2], "Gland-INST": [2, 4], "Nuclei-INST": [4, 6]}
    for tissue in ("Gland", "Lumen", "Nuclei"):
        got, _ = G.GPUPostProcInstErodedContourMap.post_process(
            canvas, idx, tissue)
        ref, _ = G.GPUPostProcInstErodedContourMap.post_process(
            canvas, idx, tissue, impl=D.PLAIN)
        np.testing.assert_array_equal(got, ref, err_msg=tissue)
        assert got.max() > 0, tissue
