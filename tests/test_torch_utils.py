"""The port's copies of the host helpers (``utils/geometry.py``,
``utils/fsutils.py``, ``utils/export.py``, ``utils/viz.py``) against the JAX
package's, on seeded numpy inputs: same outputs, same files, same pixels;
``plot_roc``'s numpy ROC and AUC against sklearn's."""
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


@pytest.mark.parametrize("mode", ["contour", "centroid"])
def test_wasabi_export_matches_reference(tmp_path, mode):
    """``tests/test_longtail.py::test_wasabi_export``'s instances (and
    their centroids) through both ``to_wasabi``: the same JSON."""
    from cerberus_tpu.utils.export import to_wasabi as ref_to_wasabi
    from cerberus_tpu.utils.viz import DEFAULT_VIZ_INFO
    from cerberus_tpu_torch.utils.export import to_wasabi

    inst = {
        "a": {"contour": np.array([[0, 0], [10, 0], [10, 10]]), "type": 1,
              "centroid": np.array([6.6, 3.3])},
        "b": {"contour": np.array([[5, 5], [15, 5], [15, 15]]),
              "centroid": np.array([11.7, 8.2])},
    }
    out = {}
    for name, fn in (("port", to_wasabi), ("ref", ref_to_wasabi)):
        path = tmp_path / ("%s.json" % name)
        fn(str(path), inst, DEFAULT_VIZ_INFO["nuclei"], mode, 2.0, "cerberus")
        out[name] = path.read_text()
    assert out["port"] == out["ref"]
    elements = json.loads(out["port"])["annotation"]["elements"]
    assert len(elements) == 2
    if mode == "contour":
        assert elements[0]["points"][1] == [20, 0, 0]  # scaled by 2


def _figure_pixels(fig):
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    pixels = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return pixels


@pytest.mark.parametrize("case", ["instances_map", "instances_map_typed",
                                  "graph", "figure"])
def test_viz_functions_match_reference(case):
    import matplotlib

    matplotlib.use("Agg")
    from cerberus_tpu.utils import viz as ref_viz
    from cerberus_tpu_torch.utils import viz

    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
    inst = _label_map(4)
    if case.startswith("instances_map"):
        kwargs = {}
        if case.endswith("typed"):
            kwargs = {"type_map": (inst % 3).astype(np.int32),
                      "type_colour": {0: (0, 0, 0), 1: (255, 0, 0),
                                      2: (0, 0, 255)}, "line_width": 1}
        got = viz.visualize_instances_map(img, inst, **kwargs)
        ref = ref_viz.visualize_instances_map(img, inst, **kwargs)
        assert not np.array_equal(got, img)
    elif case == "graph":
        vertices = rng.uniform(5, 60, (7, 2))
        edges = [(0, 1), (1, 2), (2, 5), (3, 6)]
        got = viz.visualize_graph(vertices, edges)
        ref = ref_viz.visualize_graph(vertices, edges)
        canvas = np.zeros((64, 80, 3), np.uint8)
        np.testing.assert_array_equal(
            viz.visualize_graph(vertices, edges, canvas.copy()),
            ref_viz.visualize_graph(vertices, edges, canvas.copy()))
    else:
        imgs = [img, inst, inst > 0]
        got = _figure_pixels(viz.gen_figure(imgs, ["a", "b", "c"]))
        ref = _figure_pixels(ref_viz.gen_figure(imgs, ["a", "b", "c"]))
        np.testing.assert_array_equal(
            _figure_pixels(viz.gen_figure(imgs, ["a", "b", "c"],
                                          shape=(3, 1))),
            _figure_pixels(ref_viz.gen_figure(imgs, ["a", "b", "c"],
                                              shape=(3, 1))))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_plot_roc_matches_reference_and_sklearn(tmp_path):
    """The numpy ``roc_curve`` / ``auc`` equal sklearn's on scores with and
    without ties; ``plot_roc`` draws the JAX package's figure and returns
    sklearn's AUCs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    from cerberus_tpu.utils import viz as ref_viz
    from cerberus_tpu_torch.utils import viz

    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(7)
    ys, ps = [], []
    for fold in range(4):
        y = rng.integers(0, 2, 60)
        p = np.clip(y * 0.3 + rng.random(60) * 0.8, 0, 1)
        if fold % 2:
            p = np.round(p * 5) / 5  # ties
        ys.append(y)
        ps.append(p)
        for got, ref in zip(viz.roc_curve(y, p), metrics.roc_curve(y, p)):
            np.testing.assert_array_equal(got, ref)
        fp, tp, _ = metrics.roc_curve(y, p)
        assert viz.auc(fp, tp) == metrics.auc(fp, tp)
    aucs = viz.plot_roc(ys, ps, ["f%d" % i for i in range(4)],
                        str(tmp_path / "port.png"))
    ref_viz.plot_roc(ys, ps, ["f%d" % i for i in range(4)],
                     str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(mpimg.imread(str(tmp_path / "port.png")),
                                  mpimg.imread(str(tmp_path / "ref.png")))
    assert aucs["fold_auc"] == [metrics.roc_auc_score(y, p)
                                for y, p in zip(ys, ps)]
