"""The port's copies of the host helpers (``utils/geometry.py``,
``utils/fsutils.py``) against the JAX package's, on seeded numpy inputs:
same outputs, same files."""
import json

import numpy as np
import pytest

from cerberus_tpu.utils import fsutils as ref_fs
from cerberus_tpu.utils import geometry as ref_geo
from cerberus_tpu_torch.utils import fsutils, geometry


def _label_map(seed, hw=(64, 80), n=9):
    rng = np.random.default_rng(seed)
    lab = np.zeros(hw, np.int32)
    for i in range(1, n + 1):
        y, x = rng.integers(0, hw[0] - 8), rng.integers(0, hw[1] - 8)
        h, w = rng.integers(2, 12, size=2)
        lab[y:y + h, x:x + w] = i * 3  # sparse ids
    return lab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_matches_reference(seed):
    lab = _label_map(seed)
    assert geometry.get_bounding_box(lab) == ref_geo.get_bounding_box(lab)
    batch = np.stack([lab, lab + 1])
    np.testing.assert_array_equal(
        geometry.cropping_center(lab, (31, 40)),
        ref_geo.cropping_center(lab, (31, 40)))
    np.testing.assert_array_equal(
        geometry.cropping_center(batch, (31, 40), batch=True),
        ref_geo.cropping_center(batch, (31, 40), batch=True))
    rgb = np.random.default_rng(seed).integers(0, 255, (21, 30, 3))
    np.testing.assert_array_equal(geometry.center_pad_to_shape(rgb, (40, 41)),
                                  ref_geo.center_pad_to_shape(rgb, (40, 41)))
    for by_size in (False, True):
        np.testing.assert_array_equal(
            geometry.remap_label(lab, by_size=by_size),
            ref_geo.remap_label(lab, by_size=by_size))
    bb1, bb2 = [2, 20, 3, 30], [10, 40, 15, 35]
    assert geometry.get_overlap(bb1, bb2) == ref_geo.get_overlap(bb1, bb2)
    true = geometry.remap_label(lab)
    pred = geometry.remap_label(_label_map(seed + 10))
    np.testing.assert_array_equal(geometry.pairwise_iou(true, pred),
                                  ref_geo.pairwise_iou(true, pred))
    for thresh in (0.5, 0.0):
        assert geometry.match_instances(true, pred, thresh) == \
            ref_geo.match_instances(true, pred, thresh)


def test_fsutils_match_reference(tmp_path):
    for sub in ("a", "b/c"):
        fsutils.mkdir(str(tmp_path / sub))
        for name in ("x.png", "y.jpg", "z.txt"):
            (tmp_path / sub / name).write_text("")
    root = str(tmp_path)
    assert fsutils.recur_find_ext(root, [".png", ".jpg"]) == \
        ref_fs.recur_find_ext(root, [".png", ".jpg"])
    dirs = [str(tmp_path / "a"), str(tmp_path / "b" / "c")]
    assert fsutils.get_files(dirs, ".png") == ref_fs.get_files(dirs, ".png")
    info = {"nuclei": {1: {"box": np.array([1, 2, 3, 4]), "type": np.int64(2),
                           "prob": np.float32(0.5)}}}
    fsutils.save_json(str(tmp_path / "port.json"), info, mag=40)
    ref_fs.save_json(str(tmp_path / "ref.json"), info, mag=40)
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == json.loads((tmp_path / "ref.json").read_text())
    assert port["mag"] == 40
    fsutils.rm_n_mkdir(str(tmp_path / "a"))
    assert list((tmp_path / "a").iterdir()) == []
