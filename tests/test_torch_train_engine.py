"""The port's run engine, callbacks, metrics and training utilities against
the JAX package's: the same stub steps through both engines give the same
event order and the same ``stats.yml``; the validation statistics, the
serialisers, the step visualisation and the parameter table are equal;
the train-state writer and the savers write files the JAX package reads."""
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from cerberus_tpu.models import convert as jax_convert
from cerberus_tpu.train import callbacks as jax_callbacks
from cerberus_tpu.train import engine as jax_engine
from cerberus_tpu.train import metrics as jax_metrics
from cerberus_tpu.train import serialize as jax_serialize
from cerberus_tpu.train import utils as jax_utils
from cerberus_tpu.train import viz as jax_viz
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.models import convert
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights
from cerberus_tpu_torch.train import callbacks, engine, metrics, serialize
from cerberus_tpu_torch.train import utils as train_utils
from cerberus_tpu_torch.train import viz
from cerberus_tpu_torch.train.steps import head_order, make_train_step
from cerberus_tpu_torch.utils.viz import colorize

from _torch_train_helpers import CFG, LOSS_KWARGS, MODEL_KWARGS, make_batch

HEAD_CH = {"Gland-INST": 3, "Patch-Class": 4}


class _Net:
    """What TrackLr and the port engine's flush read of a net holder."""
    lr = 1.0e-3

    def __init__(self):
        self.writer = convert.TrainStateWriter()


class _Recorder:
    engine_trigger = False

    def __init__(self, log, name):
        self.log, self.name = log, name

    def run(self, state, event):
        self.log.append((self.name, event.value, state.curr_global_step,
                         state.curr_epoch, state.curr_epoch_step))


def _drive(mod, cb, mtr, log_dir):
    """Chained train/infer engines of ``mod`` with stub steps, every
    callback of the trainer's graph but the savers; returns the event
    log."""
    rng = np.random.default_rng(0)
    heads = list(HEAD_CH)

    def train_step(batch, info):
        step = info[1]["step"]
        return {"EMA": {"overall_loss": 1.0 / (step + 1),
                        "Gland-INST_loss": 0.5 + 0.01 * step},
                "raw": {"img": batch}}

    def infer_step(batch, info):
        true = {"Gland-INST": rng.integers(0, 3, (2, 6, 6)),
                "Patch-Class": rng.integers(0, 4, 2)}
        pred = {"Gland-INST": rng.integers(0, 3, (2, 6, 6)),
                "Patch-Class": rng.integers(0, 4, 2)}
        return {"raw": {"pred": pred, "true": true,
                        "dummy": (rng.random((2, 2)) > 0.3).astype(
                            np.float32)}}

    log = []
    run_info = {"net": _Net()}
    train = mod.RunEngine("train", {"train": list(range(5))}, train_step,
                          run_info)
    infer = mod.RunEngine("infer", {"valid": list(range(3))}, infer_step,
                          run_info)
    for eng in (train, infer):
        eng.state.logging = True
        eng.state.log_dir = log_dir
        eng.state.log_info = {"yaml_file": os.path.join(log_dir,
                                                        "stats.yml")}
        for event in mod.Events:
            eng.add_event_handler(event, _Recorder(log, eng.engine_name))
    proc = mtr.ProcStepRawOutput(HEAD_CH, heads)
    infer.add_event_handler(mod.Events.STEP_COMPLETED, proc)
    infer.add_event_handler(mod.Events.EPOCH_COMPLETED,
                            cb.ProcessAccumulatedEpochOutput(
                                proc.proc_cum_epoch))
    infer.add_event_handler(mod.Events.EPOCH_COMPLETED,
                            cb.LoggingOutput(per_n_epoch=1))
    train.add_event_handler(mod.Events.STEP_COMPLETED,
                            cb.ScalarMovingAverage(alpha=0.95))
    train.add_event_handler(mod.Events.STEP_COMPLETED, cb.TrackLr())
    train.add_event_handler(mod.Events.STEP_COMPLETED,
                            cb.LoggingOutput(per_n_epoch=None, per_n_step=2))
    trigger = cb.TriggerEngine("infer", per_n_epoch=None, per_n_step=2)
    trigger.triggered_engine = infer
    train.add_event_handler(mod.Events.STEP_COMPLETED, trigger)
    train.add_event_handler(mod.Events.STEP_COMPLETED, cb.ScheduleLr())
    train.run(nr_epoch=2)
    with open(os.path.join(log_dir, "stats.yml")) as handle:
        return log, yaml.safe_load(handle), train.state


def test_engine_event_order_and_stats_match_jax(tmp_path):
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    ref_log, ref_stats, _ = _drive(jax_engine, jax_callbacks, jax_metrics,
                                   str(tmp_path / "jax"))
    log, stats, state = _drive(engine, callbacks, metrics,
                               str(tmp_path / "port"))
    assert log == ref_log
    assert stats == ref_stats
    assert set(stats["1"]) >= {"train-overall_loss", "train-lr-net",
                               "valid-Gland-INST-acc",
                               "valid-Patch-Class-acc"}
    assert state.step_seconds >= 0 and state.wait_seconds >= 0


def test_step_stats_accumulator_matches_jax():
    rng = np.random.default_rng(1)
    acc = metrics.StepStatsAccumulator(HEAD_CH)
    ref = jax_metrics.StepStatsAccumulator(HEAD_CH)
    for _ in range(3):
        true = {"Gland-INST": rng.integers(0, 3, (4, 8, 8)),
                "Patch-Class": rng.integers(0, 4, 4)}
        pred = {"Gland-INST": rng.integers(0, 3, (4, 8, 8)),
                "Patch-Class": rng.integers(0, 4, 4)}
        flags = (rng.random((4, 2)) > 0.4).astype(np.float32)
        acc.update(true, pred, flags, list(HEAD_CH))
        ref.update(true, pred, flags, list(HEAD_CH))
    assert acc.compute() == ref.compute()


@pytest.mark.parametrize("kind,value", [("scalar", np.float32(0.25)),
                                        ("conf_mat", np.eye(3)),
                                        ("image", np.zeros((4, 5, 3)))])
def test_serializers_match_jax(kind, value):
    for target in ("console", "json"):
        assert serialize.serialize(kind, target, value) == \
            jax_serialize.serialize(kind, target, value)


def test_step_visualisation_and_colorize_match_jax():
    rng = np.random.default_rng(2)
    raw = {"img": rng.integers(0, 255, (2, 16, 16, 3)).astype(np.uint8),
           "true": {"Gland-INST": rng.integers(0, 3, (2, 16, 16)),
                    "Patch-Class": rng.integers(0, 9, 2)},
           "pred": {"Gland-INST": rng.random((2, 8, 8, 3)),
                    "Patch-Class": rng.integers(0, 9, 2)}}
    got = viz.viz_step_output(raw, {"Gland-INST": 3, "Patch-Class": 9})
    ref = jax_viz.viz_step_output(raw, {"Gland-INST": 3, "Patch-Class": 9})
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    from cerberus_tpu.utils.viz import colorize as jax_colorize

    ch = rng.random((7, 9))
    assert np.array_equal(colorize(ch, 0.1, 0.8, shape=(11, 13)),
                          jax_colorize(ch, 0.1, 0.8, shape=(11, 13)))


def test_training_utils_match_jax(tmp_path):
    model = init_weights(NetDesc(CFG), torch.Generator().manual_seed(0))
    state = model.state_dict()
    params = convert.jax_params_from_state_dict(state)
    assert train_utils.count_parameters(model) == \
        jax_utils.count_parameters(params)
    assert train_utils.get_model_summary(state) == \
        jax_utils.get_model_summary(params)
    for kwargs in ({}, {"inst_only": True, "zero_bias": True}):
        got = convert.jax_params_from_state_dict(
            train_utils.tame_head_logits(state, 0.05, **kwargs))
        ref = jax_utils.tame_head_logits(params, 0.05, **kwargs)
        for name, leaf in ref.items():
            for attr, value in leaf.items():
                np.testing.assert_array_equal(got[name][attr],
                                              np.asarray(value))
    with pytest.raises(ValueError, match="matched no head"):
        train_utils.tame_head_logits({"backbone.conv1.weight":
                                      torch.zeros(1)})
    gen = train_utils.check_manual_seed(7)
    assert isinstance(gen, torch.Generator)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(7)))
    log_dir = str(tmp_path / "logs")
    train_utils.check_log_dir(log_dir, interactive=False)
    open(os.path.join(log_dir, "old"), "w").close()
    train_utils.check_log_dir(log_dir, interactive=False)
    assert os.listdir(log_dir) == []


def _holder(tmp_path, weight_decay=0.0):
    model = init_weights(NetDesc(CFG), torch.Generator().manual_seed(1))
    step = make_train_step(CFG, LOSS_KWARGS, {"lr": 1e-3,
                                              "weight_decay": weight_decay},
                           return_grads=True, model=model)
    return engine.NetHolder(step, torch.Generator().manual_seed(2), cfg=CFG)


def test_savers_write_states_jax_reads(tmp_path):
    """PeriodicSaver writes the JAX train state through the holder's
    writer (loaded by JAX ``load_train_state`` with an optax template);
    ConditionalSaver writes a params checkpoint on a better metric."""
    from cerberus_tpu.train.steps import make_optimizer

    net = _holder(tmp_path, weight_decay=1e-4)
    batch = make_batch(np.random.default_rng(0), n=2, hw=48)
    net.train_step(batch, generator=net.generator)
    state = engine.State()
    state.logging, state.log_dir = True, str(tmp_path)
    state.run_info = {"net": net}
    state.curr_global_step = 4
    callbacks.PeriodicSaver(per_n_epoch=None, per_n_step=2).run(
        state, engine.Events.STEP_COMPLETED)
    net.writer.flush()
    path = str(tmp_path / "net_step-000004.tar")
    template = make_optimizer({"lr": 1e-3, "weight_decay": 1e-4})[0].init(
        convert.jax_params_from_state_dict(net.model.state_dict()))
    params, opt_state, step = jax_convert.load_train_state(path, template)
    assert step == 1
    want = net.train_step.jax_train_state()
    np.testing.assert_array_equal(
        np.asarray(params["backbone.conv1"]["kernel"]),
        want[0]["backbone.conv1"]["kernel"])
    assert jax.tree.structure(opt_state) == jax.tree.structure(template)
    # and the port's tile loader reads it as a params checkpoint
    assert set(convert.load_checkpoint(path)) == set(net.model.state_dict())

    stat_file = str(tmp_path / "stats.yml")
    state.log_info = {"yaml_file": stat_file}
    saver = callbacks.ConditionalSaver("valid-acc", ">=")
    best = str(tmp_path / "net_best=[valid-acc].tar")
    for epoch, stats, saved in ((0, {"0": {"valid-acc": 0.5}}, True),
                                (1, {"0": {"valid-acc": 0.5},
                                     "1": {"valid-acc": 0.4}}, False)):
        with open(stat_file, "w") as handle:
            yaml.safe_dump(stats, handle)
        if os.path.exists(best):
            os.remove(best)
        state.curr_epoch = epoch
        saver.run(state, engine.Events.EPOCH_COMPLETED)
        assert os.path.exists(best) == saved
        if saved:
            assert set(jax_convert.load_native_checkpoint(best)) == \
                set(params)


def test_logging_gradient_histograms_use_the_jax_names(tmp_path):
    net = _holder(tmp_path)
    metrics_, grads = net.train_step(make_batch(np.random.default_rng(1)),
                                     generator=net.generator)

    class Writer:
        names = []

        def add_histogram(self, name, value, step):
            self.names.append(name)

    state = engine.State()
    state.run_info = {"net": net}
    state.log_info = {"tfwriter": Writer()}
    state.step_output = {"grads": grads}
    cb = callbacks.LoggingGradient(sample_rate=1.0)
    cb.run(state, engine.Events.STEP_COMPLETED)
    assert "grad/backbone.conv1.kernel" in Writer.names
    assert "param/backbone.bn1.mean" in Writer.names
    assert "grad/backbone.bn1.scale" in Writer.names


def test_train_state_writer_flushes_every_write_then_raises(tmp_path):
    writer = convert.TrainStateWriter()
    params = {"l": {"kernel": np.ones((1, 1, 1, 2), np.float32)}}
    bad = str(tmp_path / "missing_dir" / "a.tar")
    good = str(tmp_path / "b.tar")
    writer.submit(bad, params, None, 0)
    writer.submit(good, params, None, 1)
    with pytest.raises(OSError):
        writer.flush()
    assert os.path.exists(good)
    writer.flush()  # nothing pending
    assert jax_convert.load_train_state(good)[2] == 1


def test_head_order_matches_jax():
    from cerberus_tpu.config import ModelConfig as JaxModelConfig
    from cerberus_tpu.train.steps import head_order as jax_head_order

    assert head_order(ModelConfig.from_kwargs(MODEL_KWARGS)) == \
        jax_head_order(JaxModelConfig.from_kwargs(MODEL_KWARGS))
