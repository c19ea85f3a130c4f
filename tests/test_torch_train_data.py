"""The port's training data path against the JAX package's, byte for byte:
the augmentations and target encoders (``data/augs.py``,
``data/targets.py``) on the same seeded inputs and ``np.random.Generator``
draws, and ``MTLPatchDataset`` batches (keys, order, dtypes, bytes) for one
seed over a directory of ``.npy`` samples and pickle/joblib ``.dat`` ones."""
import os
import pickle

import numpy as np
import pytest

from cerberus_tpu.config import DEFAULT_TARGET_CODE
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.data import augs as jax_augs
from cerberus_tpu.data import targets as jax_targets
from cerberus_tpu.data.train_loader import MTLPatchDataset as JaxDataset
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.data import augs, targets
from cerberus_tpu_torch.data.train_loader import MTLPatchDataset

from _torch_train_helpers import MODEL_KWARGS

AUGS = ("gaussian_blur", "median_blur", "add_to_hue", "add_to_saturation",
        "add_to_contrast", "add_to_brightness")


def _ann(hw=64, seed=0):
    """Overlapping discs and squares, a mirror-padded duplicate included."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    inst = np.zeros((hw, hw), np.int32)
    for i in range(1, 7):
        cy, cx, r = rng.integers(6, hw - 6), rng.integers(6, hw - 6), \
            rng.integers(3, 9)
        inst[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i
    inst[:4, :4] = 3  # a second piece of instance 3
    return inst


def _equal(got, ref):
    assert type(got) is type(ref)
    if isinstance(got, dict):
        assert list(got) == list(ref)
        for key in got:
            _equal(got[key], ref[key])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _equal(a, b)
    elif isinstance(got, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
    else:
        assert got == ref


@pytest.mark.parametrize("name", AUGS)
def test_augs_byte_equal(name):
    img = np.random.default_rng(1).integers(0, 255, (40, 48, 3)).astype(
        np.uint8)
    for seed in range(4):
        got = getattr(augs, name)(img.copy(), np.random.default_rng(seed))
        ref = getattr(jax_augs, name)(img.copy(),
                                      np.random.default_rng(seed))
        _equal(got, ref)


def test_fix_mirror_padding_byte_equal():
    ann = _ann()
    _equal(augs.fix_mirror_padding(ann.copy()),
           jax_augs.fix_mirror_padding(ann.copy()))


@pytest.mark.parametrize("code", sorted(targets.TARGET_GETTER_DICT))
def test_target_encoders_byte_equal(code):
    ann = _ann(seed=2)
    channels = ["Gland-INST", "Gland-TYPE"]
    full = np.stack([ann, (ann > 0).astype(np.int32) * 2], -1)
    mapping = {"Gland-INST": code, "Nuclei-INST": code}  # one dummy
    got = targets.gen_targets(full, channels, mapping, (48, 48))
    ref = jax_targets.gen_targets(full, channels, mapping, (48, 48))
    _equal(got, ref)


def test_unet_weight_map_byte_equal():
    ann = _ann(seed=3)
    ids = [i for i in np.unique(ann) if i]
    _equal(targets.unet_weight_map(ann, ids),
           jax_targets.unet_weight_map(ann, ids))


def _write_samples(data_dir, n=7, hw=64):
    """Gland and nuclei samples as ``.npy``, a pickle ``.dat`` and a
    joblib ``.dat``; one without a patch class."""
    import joblib

    rng = np.random.default_rng(0)
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n):
        inst = _ann(hw, seed=10 + i)
        types = (inst > 0).astype(np.int32) * int(rng.integers(1, 3))
        channels = (["Gland-INST", "Gland-TYPE"] if i % 2 == 0
                    else ["Nuclei-INST", "Nuclei-TYPE"])
        sample = {"img": rng.integers(0, 255, (hw, hw, 3)).astype(np.uint8),
                  "ann": np.stack([inst, types], -1), "channels": channels}
        if i != 3:
            sample["patch_class"] = int(rng.integers(0, 9))
        path = os.path.join(data_dir, "s%d" % i)
        if i == 4:
            with open(path + ".dat", "wb") as handle:
                pickle.dump(sample, handle)
        elif i == 5:
            joblib.dump(sample, path + ".dat", compress=3)
        else:
            np.save(path + ".npy", sample)


@pytest.mark.parametrize("augment,shuffle,drop_last",
                         [(True, True, True), (False, False, False)])
def test_loader_batches_byte_equal(tmp_path, augment, shuffle, drop_last):
    _write_samples(str(tmp_path))
    common = dict(req_target_code=dict(DEFAULT_TARGET_CODE), input_shape=56,
                  output_shape=40, batch_size=3, augment=augment, seed=5,
                  shuffle=shuffle, drop_last=drop_last)
    port = MTLPatchDataset.from_dir(
        str(tmp_path), ModelConfig.from_kwargs(MODEL_KWARGS), **common)
    ref = JaxDataset.from_dir(
        str(tmp_path), JaxModelConfig.from_kwargs(MODEL_KWARGS), **common)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for _epoch in range(2):  # the generator carries across epochs
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    assert got[0]["img"].shape == (3, 56, 56, 3)
    assert got[0]["Gland-INST"].shape == (3, 40, 40, 1)


def test_loader_rejects_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no training samples"):
        MTLPatchDataset.from_dir(str(tmp_path),
                                 ModelConfig.from_kwargs(MODEL_KWARGS), {},
                                 input_shape=48)
