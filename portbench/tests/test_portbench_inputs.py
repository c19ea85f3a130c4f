"""The seeded generators: the same seed gives the same inputs and
weights, another seed other content at the same sizes."""
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import HERE
from portbench.traffic.images import (synthetic_image, tissue_mask,
                                      write_png, write_svs)
from portbench.traffic.weights import make_weights

BIG_SEED = 2 ** 31 + 12345


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as handle:
        return json.load(handle)


def test_images_are_deterministic_by_seed():
    a = synthetic_image((96, 80), np.random.default_rng([BIG_SEED, 0]))
    b = synthetic_image((96, 80), np.random.default_rng([BIG_SEED, 0]))
    c = synthetic_image((96, 80), np.random.default_rng([BIG_SEED + 1, 0]))
    assert a.shape == (96, 80, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_svs_round_trip(tmp_path):
    img = synthetic_image((300, 260), np.random.default_rng(3))
    one = write_svs(str(tmp_path / "a.svs"), img, tile=128)
    two = write_svs(str(tmp_path / "b.svs"), img, tile=128)
    assert np.array_equal(one, two)
    assert (tmp_path / "a.svs").read_bytes() == \
        (tmp_path / "b.svs").read_bytes()
    # JPEG moves noise a long way (chroma subsampling), a channel swap
    # further still
    assert np.abs(one.astype(int) - img).mean() < 50
    # the program's reader sees exactly the pixels the reference is given,
    # zero-padded past the slide
    from cerberus_tpu_torch.wsi.reader import open_wsi

    reader = open_wsi(str(tmp_path / "a.svs"))
    assert tuple(reader.slide_dimensions(0.5, "mpp")) == (260, 300)
    got = reader.read_bounds((-16, -8, 284, 300), resolution=0.5,
                             units="mpp")
    want = np.zeros((308, 300, 3), np.uint8)
    want[8:, 16:276] = one
    assert np.array_equal(got, want)
    write_png(str(tmp_path / "c.png"), img)
    import cv2

    assert np.array_equal(cv2.imread(str(tmp_path / "c.png"))[..., ::-1], img)


def test_tissue_share_is_fixed_by_the_traffic():
    for name in ("cohort-6144", "cohort-3072"):
        with open(os.path.join(HERE, "traffic", name + ".json")) as handle:
            tr = json.load(handle)
        side = tr["slide_px"] // tr["mask_ds"]
        for slide in tr["slides"]:
            share = tissue_mask((side, side), slide["tissue"]).mean()
            assert 0.38 < share < 0.42


@pytest.mark.parametrize("config", ["cerberus-r34", "cerberus-dsf8",
                                    "tiny-r34"])
def test_weights_are_deterministic_by_seed(config):
    if config == "tiny-r34":
        # the whole recipe, at the test configuration's 144^2 windows
        with open(os.path.join(HERE, "tests", "data", "configs",
                               config + ".json")) as handle:
            cfg = json.load(handle)

        def make(seed):
            return make_weights(cfg, seed, "cpu")
    else:
        # the recipes run 448^2 forwards: the init alone here
        from portbench.traffic.weights import init_state_dict

        cfg = _config(config)

        def make(seed):
            return init_state_dict(cfg["encoder"], cfg["decoders"], seed,
                                   "cpu")
    a, b, c = make(BIG_SEED), make(BIG_SEED), make(7)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].is_floating_point() and a[k].numel() > 100)
