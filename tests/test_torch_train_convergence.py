"""The convergence round trip (``train/convergence.py``) on the CPU: a
short run through both CLIs; the sample set (the JAX tool's 64 samples
unchanged, then the served-scale windows); and (slow, ~2.5 min each) the
JAX tool's own experiment, its data (``--served_scale_samples=0``) from
the JAX yardstick's initial weights (``init_net_params(PRNGKey(seed))``
through ``run_train --pretrained``): the loss must fall to a tenth and
instances appear; the foreground IoU is printed, not held (it is bimodal:
PERF.md §6)."""
import os

import numpy as np
import pytest
import torch

import jax

from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.train import convergence


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("CERBERUS_DEFAULT_DEVICE", "cpu")
    torch.set_num_threads(2)


def test_round_trip_runs_both_clis(tmp_path, cpu):
    """Two epochs of 5 steps (a checkpoint at step 5) on 16 + 4 samples,
    then the tile CLI on the 384^2 image: a curve entry, a served
    checkpoint, an IoU."""
    artifact = convergence.run(epochs=2, root=str(tmp_path / "c"),
                               n_samples=16, served_scale=4)
    assert artifact["steps"] == 10
    assert len(artifact["loss_curve_per_epoch"]) == 1
    assert np.isfinite(artifact["loss_first"])
    assert 0.0 <= artifact["infer_fg_iou"] <= 1.0
    with pytest.raises(AssertionError, match="loss did not fall"):
        convergence.check(artifact)


def test_dataset_keeps_the_jax_tool_samples(tmp_path):
    """The first 64 samples are the JAX tool's draws; the served-scale
    windows follow from their own generator."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import train_convergence as jax_tool

    jax_tool.make_dataset(str(tmp_path / "jax"))
    convergence.make_dataset(str(tmp_path / "port"), served_scale=6)
    for i in range(64):
        got = np.load(tmp_path / "port" / ("s%d.npy" % i),
                      allow_pickle=True).item()
        ref = np.load(tmp_path / "jax" / ("s%d.npy" % i),
                      allow_pickle=True).item()
        assert got["img"].tobytes() == ref["img"].tobytes()
        assert got["ann"].tobytes() == ref["ann"].tobytes()
    big = [np.load(tmp_path / "port" / ("big%d.npy" % i),
                   allow_pickle=True).item() for i in range(6)]
    assert all(b["img"].shape == (64, 64, 3) for b in big)
    assert any((b["ann"][..., 0] > 0).mean() > 0.9 for b in big)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6))
def test_jax_tool_experiment_from_the_jax_initial_weights(tmp_path, cpu,
                                                          seed):
    cfg = JaxModelConfig.from_kwargs(convergence.MODEL_KWARGS)
    params = jax.tree.map(np.asarray,
                          init_net_params(jax.random.PRNGKey(seed), cfg))
    path = str(tmp_path / "init.tar")
    torch.save({"desc": state_dict_from_jax_params(params)}, path)
    artifact = convergence.run(root=str(tmp_path / ("jax_seed%d" % seed)),
                               pretrained=path, served_scale=0)
    print("seed %d: loss %.4f -> %.4f, %d instances, foreground IoU %.4f"
          % (seed, artifact["loss_first"], artifact["loss_last"],
             artifact["infer_instances"], artifact["infer_fg_iou"]))
    assert artifact["loss_last"] <= convergence.LOSS_RATIO_MAX \
        * artifact["loss_first"]
    assert artifact["infer_instances"] > 0
