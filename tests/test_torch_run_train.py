"""``python -m cerberus_tpu_torch.run_train`` on the CPU
(``CERBERUS_DEFAULT_DEVICE=cpu``): one epoch writes ``stats.yml`` and a
JAX-layout train state; ``--resume`` continues at its update count, LR
and Adam moments; what is not ported raises naming its ROADMAP item.
The pretrained-weight helpers (torchvision conversion, overlay, the
``pretrained.yml`` map) against the JAX package's on synthetic state dicts,
and the multi-phase runner's ``pretrained: -1`` carry-over."""
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from cerberus_tpu.models import convert as jax_convert
from cerberus_tpu_torch import run_train
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.models import convert
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from cerberus_tpu_torch.train import opt
from cerberus_tpu_torch.train.convergence import (
    MODEL_KWARGS,
    TARGET_CODE,
    make_dataset,
)

LOSS = {"loss_info": {
    "Gland-INST": {"weight": 1, "loss": {"ce": 1}},
    "Gland-TYPE": {"weight": 1, "loss": {"ce": 1, "dice": 1}},
    "Patch-Class": {"weight": 0.4, "loss": {"ce": 1}},
}}


@pytest.fixture
def settings(tmp_path, monkeypatch):
    monkeypatch.setenv("CERBERUS_DEFAULT_DEVICE", "cpu")
    torch.set_num_threads(2)
    data = str(tmp_path / "data")
    make_dataset(data, n=12)
    path = str(tmp_path / "settings.yml")
    with open(path, "w") as handle:
        yaml.safe_dump({"model_kwargs": MODEL_KWARGS,
                        "optimizer_kwargs": {"lr": 1.0e-3,
                                             "betas": [0.9, 0.999]},
                        "loss_kwargs": LOSS,
                        "dataset_kwargs": {"req_target_code": TARGET_CODE,
                                           "train_dir": data,
                                           "input_shape": 48,
                                           "output_shape": 48}}, handle)
    return path


def test_cli_one_epoch_then_resume(tmp_path, settings):
    log_dir = str(tmp_path / "logs")
    net = run_train.main(["--settings=%s" % settings, "--log_dir=%s" % log_dir,
                          "--nr_epochs=1", "--batch_size=4",
                          "--per_n_steps=2"])
    assert next(net.model.parameters()).device.type == "cpu"
    assert net.step == 3
    assert set(net.timing) == {"loader_wait_s", "step_s", "wall_s"}
    with open(os.path.join(log_dir, "stats.yml")) as handle:
        stats = yaml.safe_load(handle)
    assert {"train-overall_loss", "train-lr-net", "valid-Gland-INST-acc"} \
        <= set(stats["0"])
    ckpt = os.path.join(log_dir, "net_step-000002.tar")
    assert sorted(glob.glob(os.path.join(log_dir, "*.tar"))) == [ckpt]
    params, opt_state, step = convert.load_train_state(ckpt)
    assert step == 3 and set(opt_state) == {"inner_states"}

    resumed = run_train.main(["--settings=%s" % settings,
                              "--log_dir=%s" % log_dir, "--nr_epochs=1",
                              "--batch_size=4", "--per_n_steps=2",
                              "--resume=%s" % ckpt, "--bf16"])
    assert resumed.step == 6
    assert os.path.exists(os.path.join(log_dir, "net_step-000004.tar"))


def test_resume_restores_count_lr_and_moments(tmp_path, settings):
    """The trainer built with ``resume_from`` holds the file's weights,
    Adam moments and update count; the schedule and the engine's step
    counter continue from it."""
    log_dir = str(tmp_path / "logs")
    run_train.main(["--settings=%s" % settings, "--log_dir=%s" % log_dir,
                    "--nr_epochs=1", "--batch_size=4", "--per_n_steps=2"])
    ckpt = os.path.join(log_dir, "net_step-000002.tar")
    config = opt.get_config(MODEL_KWARGS, LOSS, nr_epochs=1, per_n_steps=2)
    net_cfg = config["phase_list"][0]["run_info"]["net"]
    net_cfg.update(resume_from=ckpt, lr_decay_steps=2)
    train_engine, _, net = opt.build_trainer(config, {}, {}, device="cpu")
    assert net.step == 3 and train_engine.state.curr_global_step == 3
    assert net.lr == pytest.approx(1e-4)  # 1e-3 * 0.1 ** (3 // 2)
    params, opt_state, _ = convert.load_train_state(ckpt)
    mu = opt_state["inner_states"]["train"]["inner_state"]["0"]["mu"]
    names = net.train_step.param_names
    idx = names.index("backbone.conv1.weight")
    got = net.train_step.optimizer.state_dict()["state"][idx]["exp_avg"]
    np.testing.assert_array_equal(
        got.numpy(), mu["backbone.conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        net.model.state_dict()["conv_map.weight"].numpy(),
        params["conv_map"]["kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("argv,item", [
    (["--paired"], "item 9"),
    (["--gpu=0,1"], "item 7"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, settings, argv, item):
    with pytest.raises(NotImplementedError, match=item):
        run_train.main(["--settings=%s" % settings,
                        "--log_dir=%s" % (tmp_path / "l")] + argv)


def test_mesh_and_dsf_are_not_ported():
    cfg = ModelConfig.from_kwargs({"encoder_backbone_name": "dsf_cnn_8"})
    with pytest.raises(NotImplementedError, match="item 6"):
        opt.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="item 7"):
        opt.check_supported(ModelConfig.from_kwargs(MODEL_KWARGS),
                            mesh=object())


def test_cli_defaults_to_cuda(tmp_path, settings, monkeypatch):
    monkeypatch.delenv("CERBERUS_DEFAULT_DEVICE")
    seen = []

    def fake_run(*args, device=None, **kwargs):
        seen.append(device)

    monkeypatch.setattr(opt, "run_training", fake_run)
    for extra, want in (([], "cuda:0"), (["--gpu=1"], "cuda:1")):
        run_train.main(["--settings=%s" % settings,
                        "--log_dir=%s" % (tmp_path / "l")] + extra)
        assert seen[-1] == want


def _torchvision_state(seed=0):
    """A raw torchvision-style resnet18 state_dict (bare keys, fc head)."""
    model = init_weights(NetDesc(ModelConfig.from_kwargs(MODEL_KWARGS)),
                         torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    state = {k[len("backbone."):]: v.clone() + (
        torch.randn(v.shape, generator=gen) * 0.01
        if v.is_floating_point() else 0)
        for k, v in model.state_dict().items() if k.startswith("backbone.")}
    state["fc.weight"] = torch.randn(1000, 512, generator=gen)
    state["fc.bias"] = torch.zeros(1000)
    return state


def test_torchvision_conversion_and_overlay_match_jax(tmp_path):
    tv = _torchvision_state()
    got = convert.convert_torchvision_backbone(tv)
    ref = jax_convert.convert_torchvision_backbone(tv)
    assert not any(k.startswith("backbone.fc.") for k in got)
    assert convert.jax_params_from_state_dict(got).keys() == ref.keys()
    for name, leaf in convert.jax_params_from_state_dict(got).items():
        for attr, value in leaf.items():
            np.testing.assert_array_equal(value, ref[name][attr])

    init = init_weights(NetDesc(ModelConfig.from_kwargs(MODEL_KWARGS)),
                        torch.Generator().manual_seed(3)).state_dict()
    out = convert.overlay_pretrained(init, got)
    ref_out = jax_convert.overlay_pretrained(
        convert.jax_params_from_state_dict(init), ref)
    for name, leaf in convert.jax_params_from_state_dict(out).items():
        for attr, value in leaf.items():
            np.testing.assert_array_equal(value, ref_out[name][attr])
    assert torch.equal(out["conv_map.weight"], init["conv_map.weight"])
    bad = dict(got, **{"backbone.conv1.weight": torch.zeros(1, 3, 7, 7)})
    with pytest.raises(ValueError, match="shape"):
        convert.overlay_pretrained(init, bad)

    # through the checkpoint loader and the CLI's --pretrained
    path = str(tmp_path / "tv.pth")
    torch.save(tv, path)
    loaded = convert.load_checkpoint(path)
    assert set(loaded) == set(got)
    assert all(torch.equal(loaded[k], got[k]) for k in got)


def test_pretrained_map_matches_jax(tmp_path):
    table = {"resnet18": {"fold1": {"imagenet_mtl": "w/fold1.tar"},
                          "fold2": {"imagenet_mtl": "/abs/fold2.tar"}}}
    path = str(tmp_path / "pretrained.yml")
    with open(path, "w") as handle:
        yaml.safe_dump(table, handle)
    for fold in (1, 2):
        assert convert.resolve_pretrained_map(path, "resnet18", fold) == \
            jax_convert.resolve_pretrained_map(path, "resnet18", fold)
    with pytest.raises(ValueError, match="no entry"):
        convert.resolve_pretrained_map(path, "resnet34", 1)


def test_run_training_carries_weights_across_phases(tmp_path, monkeypatch):
    """Two phases: ``<log_dir>/00`` and ``/01``; phase 1 starts from phase
    0's weights (``pretrained: -1``)."""
    seen = []
    real = opt.build_trainer

    def spy(config, *args, **kwargs):
        seen.append(args[4])  # pretrained state of this phase
        return real(config, *args, **kwargs)

    monkeypatch.setattr(opt, "build_trainer", spy)
    data = str(tmp_path / "data")
    make_dataset(data, n=4)
    from cerberus_tpu_torch.data.train_loader import MTLPatchDataset

    cfg = ModelConfig.from_kwargs(MODEL_KWARGS)
    loader = MTLPatchDataset.from_dir(data, cfg, TARGET_CODE, input_shape=48,
                                      batch_size=4)
    config = opt.get_config(MODEL_KWARGS, LOSS, nr_epochs=1, per_n_steps=1)
    phase = config["phase_list"][0]
    second = {"run_info": {"net": dict(phase["run_info"]["net"],
                                       pretrained=-1)}, "nr_epochs": 1}
    config["phase_list"].append(second)
    net = opt.run_training(config, {"train": loader}, {}, log_dir=str(
        tmp_path / "logs"), device="cpu")
    assert seen[0] is None and seen[1] is not None
    assert os.path.isdir(tmp_path / "logs" / "00")
    assert os.path.isdir(tmp_path / "logs" / "01")
    assert net.step == 1
