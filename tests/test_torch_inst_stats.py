"""``ops/inst_stats``: the per-instance tables of label planes against a
numpy count per id (box, pixel count, coordinate sums, (id, type) counts),
and the CUDA kernel against its plain version on the card.

The card's cases are marked ``cuda`` and skip where CUDA is absent; on a GPU
machine run ``python -m pytest --noconftest tests/test_torch_inst_stats.py``.
"""
import numpy as np
import pytest
import torch

from cerberus_tpu_torch.ops import cuda_build
from cerberus_tpu_torch.ops.inst_stats import (
    EMPTY_MIN,
    inst_stats,
    inst_stats_plain,
    split_tables,
)


def _blobs(hw, n, seed, rmax=12, first_id=1):
    """Seeded discs with ids first_id.. (later discs overwrite earlier)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(hw, np.int32)
    for k in range(n):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        r = int(rng.integers(1, rmax))
        y0, x0 = max(cy - r, 0), max(cx - r, 0)
        yy, xx = np.mgrid[y0:min(cy + r, hw[0]), x0:min(cx + r, hw[1])]
        lab[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]][
            (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = first_id + k
    return lab


def _compact(lab):
    ids = np.unique(lab)
    ids = ids[ids > 0]
    lut = np.zeros(int(lab.max()) + 1, np.int32)
    lut[ids] = np.arange(1, len(ids) + 1)
    return lut[lab]


def _gated_lumen():
    gland = _compact(_blobs((96, 80), 6, 1, rmax=30))
    lumen = _compact(_blobs((96, 80), 40, 2, rmax=8))
    return lumen * (gland > 0)  # ids with gaps, as the tile path gates


def _one_pixel():
    lab = np.zeros((40, 50), np.int32)
    rng = np.random.default_rng(3)
    at = rng.choice(lab.size, 30, replace=False)
    lab.reshape(-1)[at] = np.arange(1, 31)
    return lab


def _borders():
    lab = np.zeros((37, 45), np.int32)
    lab[0, 3:20] = 1  # top
    lab[-1, 10:44] = 2  # bottom
    lab[2:30, 0] = 3  # left
    lab[5:37, -1] = 4  # right, reaching the bottom
    lab[0, 0] = lab[-1, -1] = 5  # two opposite corners
    return lab


def _whole_row():
    lab = _blobs((33, 70), 10, 4, rmax=6)
    lab[17, :] = 11
    return lab


def _high_id():
    lab = _blobs((64, 64), 12, 5, rmax=9, first_id=16380)
    lab[3, 3] = 20000
    return lab


CASES = {
    "blobs": lambda: _compact(_blobs((120, 90), 60, 0)),
    "gated_lumen": _gated_lumen,
    "empty": lambda: np.zeros((30, 40), np.int32),
    "one_pixel": _one_pixel,
    "borders": _borders,
    "whole_row": _whole_row,
    "id_above_16384": _high_id,
}


def _numpy_table(lab, types, n_types):
    """(box (4, n+1), sums (3, n+1), joint (n+1, T) or None) by numpy,
    one id at a time; types from n_types up are not counted."""
    n = int(lab.max())
    box = np.zeros((4, n + 1), np.int64)
    box[:2] = EMPTY_MIN
    sums = np.zeros((3, n + 1), np.int64)
    joint = None if types is None else np.zeros((n + 1, n_types), np.int64)
    for i in range(1, n + 1):
        ys, xs = np.nonzero(lab == i)
        if ys.size:
            box[:, i] = ys.min(), xs.min(), ys.max() + 1, xs.max() + 1
            sums[:, i] = ys.size, xs.sum(), ys.sum()
            if joint is not None:
                t = types[ys, xs]
                joint[i] = np.bincount(t[t < n_types], minlength=n_types)
    return box, sums, joint


def _assert_table(got, lab, types=None, n_types=0):
    box, sums, joint = _numpy_table(lab, types, n_types)
    assert got.box.dtype == np.int32 and got.sums.dtype == np.int64
    np.testing.assert_array_equal(got.box, box)
    np.testing.assert_array_equal(got.sums, sums)
    if joint is None:
        assert got.joint is None
    else:
        assert got.joint.dtype == np.int32
        np.testing.assert_array_equal(got.joint, joint)


def _host(table):
    return split_tables(table.layout, table.ints.cpu().numpy(),
                        table.sums.cpu().numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_table_equals_numpy_counts(case):
    lab = CASES[case]()
    types = np.random.default_rng(7).integers(0, 5, lab.shape).astype(
        np.int32)
    n = int(lab.max())
    table = inst_stats(torch.from_numpy(lab)[None],
                       torch.from_numpy(types)[None], [n], [0], [5])
    (got,) = _host(table)
    _assert_table(got, lab, types, 5)


def test_planes_of_one_launch_are_counted_apart():
    """Gland, gated lumen (typed by the gland's type plane) and nuclei in
    one call, as the tile path stacks them; an untyped plane has no joint
    counts; ids above a plane's n and types outside [0, n_types) are not
    counted."""
    gland = _compact(_blobs((80, 64), 5, 11, rmax=25))
    lumen = _compact(_blobs((80, 64), 30, 12, rmax=6)) * (gland > 0)
    nuclei = _compact(_blobs((80, 64), 90, 13, rmax=5))
    rng = np.random.default_rng(14)
    gtype = rng.integers(0, 3, gland.shape).astype(np.int32)
    ntype = rng.integers(0, 7, gland.shape).astype(np.int32)
    labels = torch.from_numpy(np.stack([gland, lumen, nuclei, nuclei]))
    types = torch.from_numpy(np.stack([gtype, ntype]))
    n_ids = [int(gland.max()), int(lumen.max()), int(nuclei.max()), 40]
    got = _host(inst_stats(labels, types, n_ids, [0, 0, 1, -1], [3, 6]))
    _assert_table(got[0], gland, gtype, 3)
    _assert_table(got[1], lumen, gtype, 3)
    _assert_table(got[2], nuclei, ntype, 6)  # type 6 is not counted
    _assert_table(got[3], np.where(nuclei <= 40, nuclei, 0))


def test_arguments_are_checked():
    lab = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        inst_stats(lab[0], None, [0], [-1])
    with pytest.raises(ValueError):
        inst_stats(lab.long(), None, [0], [-1])
    with pytest.raises(ValueError):
        inst_stats(lab, None, [0, 0], [-1])
    with pytest.raises(ValueError):
        inst_stats(lab, None, [0], [0])  # a type plane that is not there
    with pytest.raises(ValueError):
        inst_stats(lab.expand(9, 4, 4).contiguous(), None, [0] * 9, [-1] * 9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build_all()
    return torch.device("cuda")


def _assert_same(got, ref):
    assert got.layout == ref.layout
    assert torch.equal(got.ints.cpu(), ref.ints.cpu())
    assert torch.equal(got.sums.cpu(), ref.sums.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(dev, case):
    lab = CASES[case]()
    types = np.random.default_rng(8).integers(0, 4, lab.shape).astype(
        np.int32)
    args = (torch.from_numpy(lab)[None], torch.from_numpy(types)[None],
            [int(lab.max())], [0], [4])
    cuda_build.reset_launch_counts()
    got = inst_stats(*(a.to(dev) if torch.is_tensor(a) else a
                       for a in args))
    assert cuda_build.launch_counts["inst_stats"] == 1
    _assert_same(got, inst_stats_plain(*args))


@pytest.mark.cuda
def test_kernel_equals_plain_on_tile_sized_planes(dev):
    """A 1536^2 gland, gated lumen and nuclei stack (the largest plane of
    the tile benchmark) and a 1000x1003 one (rows not a multiple of a
    warp), one launch each."""
    for hw in ((1536, 1536), (1000, 1003)):
        gland = _compact(_blobs(hw, 12, 21, rmax=200))
        lumen = _compact(_blobs(hw, 40, 22, rmax=40)) * (gland > 0)
        nuclei = _compact(_blobs(hw, 2500, 23, rmax=9))
        rng = np.random.default_rng(24)
        types = np.stack([rng.integers(0, 3, hw), rng.integers(0, 7, hw)])
        args = (torch.from_numpy(np.stack([gland, lumen, nuclei])),
                torch.from_numpy(types.astype(np.int32)),
                [int(gland.max()), int(lumen.max()), int(nuclei.max())],
                [0, 0, 1], [3, 7])
        cuda_build.reset_launch_counts()
        got = inst_stats(*(a.to(dev) if torch.is_tensor(a) else a
                           for a in args))
        assert cuda_build.launch_counts["inst_stats"] == 1
        _assert_same(got, inst_stats_plain(*args))
