"""The port's multi-process runs (``cerberus_tpu_torch.parallel.
distributed``) on the CPU: ``shard_slides`` against the JAX package's, and
two gloo processes (``run_ranks``: 127.0.0.1, a free port, a deadline per
run) through ``initialize``, ``shard_slides`` and the tile and WSI
managers (``tests/_torch_dist_workers.py``)."""
import os

import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

from _torch_train_helpers import jax_layout_params
from cerberus_tpu.config import (
    DEFAULT_DECODER_KWARGS,
    DEFAULT_TARGET_CODE,
)
from cerberus_tpu.parallel.distributed import shard_slides as jax_shard
from cerberus_tpu_torch.infer.tile import InferManager
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.parallel import distributed as D

import _torch_dist_workers as W
from _torch_ranks import run_ranks

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
TASKS = ("gland", "lumen", "nuclei")


def test_shard_slides_matches_jax_on_its_cases():
    """``tests/test_distributed_queue.py``'s three cases, the port's
    shares equal to JAX's."""
    slides = ["s%d" % i for i in range(10)]
    masks = ["m%d" % i for i in range(10)]
    seen = []
    for pid in range(4):
        got = D.shard_slides(slides, masks, pid, 4)
        assert got == jax_shard(slides, masks, pid, 4)
        seen += got[0]
    assert sorted(seen) == sorted(slides)
    assert D.shard_slides(["a", "b"], [None, None], 0, 1) == \
        jax_shard(["a", "b"], [None, None], 0, 1) == (["a", "b"], [None] * 2)
    cohort = ["s%03d" % i for i in range(599)]
    covered = []
    for bulk_idx in range(1, 7):
        job = cohort[(bulk_idx - 1) * 100: bulk_idx * 100]
        for pid in range(8):
            got = D.shard_slides(job, [None] * len(job), pid, 8)
            assert got == jax_shard(job, [None] * len(job), pid, 8)
            covered += got[0]
    assert sorted(covered) == cohort
    with pytest.raises(ValueError, match="process_count"):
        D.shard_slides(slides, masks, 1)


def test_single_process_defaults():
    assert D.process_info() == (0, 1)
    D.initialize()  # one process: a no-op
    D.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert D.shard_slides(["a", "b"], [1, 2]) == (["a", "b"], [1, 2])
    with pytest.raises(ValueError, match="process_id"):
        D.initialize("127.0.0.1:1", 2)


@pytest.fixture(scope="module")
def tile_job(tmp_path_factory):
    """``tests/test_distributed_2proc.py``'s job: four 100x120 tiles, a
    seeded model directory (resnet18 here)."""
    import cv2

    root = tmp_path_factory.mktemp("torch_dist")
    model_dir = root / "model"
    os.makedirs(model_dir)
    params = jax_layout_params(MODEL_KWARGS, 42)
    for task in ("Gland", "Lumen", "Nuclei"):
        leaf = dict(params["output_head.%s.INST.x.1.conv" % task])
        leaf["kernel"] = leaf["kernel"] * np.float32(0.003)
        leaf["bias"] = np.array([-2.0, 2.0, -1.5], np.float32)
        params["output_head.%s.INST.x.1.conv" % task] = leaf
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(model_dir / "weights.tar"))
    with open(model_dir / "settings.yml", "w") as f:
        yaml.safe_dump({
            "dataset_kwargs": {"req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": MODEL_KWARGS}, f)
    input_dir = root / "input"
    os.makedirs(input_dir)
    rng = np.random.default_rng(0)
    names = ["t%d" % i for i in range(4)]
    for name in names:
        cv2.imwrite(str(input_dir / ("%s.png" % name)),
                    rng.integers(0, 255, (100, 120, 3), np.uint8))
    return model_dir, input_dir, names


def test_two_process_tile_union_matches_single(tile_job, tmp_path):
    """Two gloo ranks each take a strided half of the four tiles through
    the tile manager; the union of their ``.mat`` maps equals one
    process's run over all four, byte for byte (batch 1: the batch
    composition differs between the runs)."""
    model_dir, input_dir, names = tile_job
    out_dist = tmp_path / "out_dist"
    os.makedirs(out_dist)
    shares = run_ranks(W.tile_shard, 2, (str(model_dir), str(input_dir),
                                           str(out_dist), 1),
                         timeout_s=300)
    assert shares == [["t0.png", "t2.png"], ["t1.png", "t3.png"]]

    out_single = tmp_path / "out_single"
    with open(model_dir / "settings.yml") as f:
        settings = yaml.safe_load(f)
    infer = InferManager(
        checkpoint_path=str(model_dir / "weights.tar"),
        decoder_dict=settings["dataset_kwargs"]["req_target_code"],
        model_args=settings["model_kwargs"], device="cpu")
    infer.process_file_list(W.tile_run_args(input_dir, out_single, 1))
    n_inst = 0
    for name in names:
        for task in TASKS:
            a = sio.loadmat(str(out_dist / ("%s_mat" % task) / (name
                                                                + ".mat")))
            b = sio.loadmat(str(out_single / ("%s_mat" % task) / (name
                                                                  + ".mat")))
            for key in ("inst_map", "inst_type", "inst_centroid"):
                if key in b:
                    np.testing.assert_array_equal(
                        a[key], b[key], err_msg="%s/%s %s" % (task, name,
                                                             key))
            n_inst += int(b["inst_map"].max())
        a = sio.loadmat(str(out_dist / "pclass_mat" / (name + ".mat")))
        b = sio.loadmat(str(out_single / "pclass_mat" / (name + ".mat")))
        np.testing.assert_array_equal(a["pclass"], b["pclass"])
    assert n_inst > 0


def test_two_process_wsi_list_writes_each_slide_once(tmp_path):
    """``process_wsi_list`` under two ranks: each takes a strided share of
    three slides with a ``_host<rank>`` cache; every slide's ``.dat`` is
    written once."""
    from test_torch_wsi import _write_slide

    slides = []
    for i in range(3):
        _write_slide(tmp_path / "input" / ("s%d" % i), i, blocks=(12, 15))
        slides.append(str(tmp_path / "input" / ("s%d" % i)))
    shares = run_ranks(W.wsi_shard, 2, (slides, str(tmp_path),
                                          MODEL_KWARGS,
                                          dict(DEFAULT_TARGET_CODE)),
                         timeout_s=300)
    assert [s[0] for s in shares] == [["s0", "s2"], ["s1"]]
    assert [s[1] for s in shares] == [str(tmp_path / "cache_host0"),
                                      str(tmp_path / "cache_host1")]
    assert sorted(os.listdir(tmp_path / "out" / "dat")) == \
        ["s0.dat", "s1.dat", "s2.dat"]
    assert not os.path.exists(tmp_path / "cache")
    for rank in range(2):
        assert os.path.isdir(tmp_path / ("cache_host%d" % rank))
