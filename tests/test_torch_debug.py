"""The port's debug and profiling knobs on the CPU
(``cerberus_tpu_torch/utils/{debug,profiling}.py``): the environment
variables, the step's NaN/Inf check, ``trace_span`` logging,
``maybe_profile`` writing a Chrome trace, ``deterministic_mode``."""
import json
import logging
import os
import random

import numpy as np
import pytest
import torch

from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS
from cerberus_tpu_torch.infer.manager import InferManager, resolve_device
from cerberus_tpu_torch.utils import debug, profiling

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}


@pytest.mark.parametrize("value,device", [("cpu", "cpu"), ("", None)])
def test_default_device_env(monkeypatch, value, device):
    monkeypatch.setenv("CERBERUS_DEFAULT_DEVICE", value)
    assert debug.default_device() == device
    debug.configure_from_env()
    if device is not None:
        assert resolve_device(None) == torch.device(device)
        assert InferManager(model_args=MODEL_KWARGS).device.type == "cpu"
    # an explicit device wins over the environment
    assert resolve_device("cpu") == torch.device("cpu")


def test_bad_default_device_raises(monkeypatch):
    monkeypatch.setenv("CERBERUS_DEFAULT_DEVICE", "tpu")
    with pytest.raises(ValueError, match="CERBERUS_DEFAULT_DEVICE"):
        debug.configure_from_env()
    with pytest.raises(ValueError):
        resolve_device(None)


def test_debug_env_turns_on_anomaly_detection(monkeypatch):
    monkeypatch.setenv("CERBERUS_DEBUG", "1")
    try:
        debug.configure_from_env()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    monkeypatch.setenv("CERBERUS_DEBUG", "0")
    assert not debug.debug_mode_requested()


@pytest.mark.parametrize("debug_on", [True, False])
def test_nan_check_raises_and_names_the_head(monkeypatch, debug_on):
    monkeypatch.setenv("CERBERUS_DEBUG", "1" if debug_on else "0")
    manager = InferManager(model_args=MODEL_KWARGS, device="cpu")
    head = manager.model.output_head["Nuclei#TYPE"]["TYPE"]
    with torch.no_grad():
        head.x[1].conv.bias[0] = float("nan")
    batch = torch.zeros((1, 144, 144, 3), dtype=torch.uint8)
    if debug_on:
        with pytest.raises(FloatingPointError, match="Nuclei-TYPE"):
            manager.run_step(batch, 48)
    else:  # bound without the check: the NaN passes through silently
        manager.run_step(batch, 48)


def test_trace_span_logs_its_wall_time(caplog):
    logger = logging.getLogger("cerberus_test_span")
    with caplog.at_level(logging.INFO, logger="cerberus_test_span"):
        with profiling.trace_span("phase/x", logger):
            sum(range(1000))
    (record,) = [r for r in caplog.records if r.name == logger.name]
    name, seconds = record.getMessage().rsplit(": ", 1)
    assert name == "phase/x" and 0 <= float(seconds) < 10


def test_maybe_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("CERBERUS_PROFILE_DIR", raising=False)
    with profiling.maybe_profile("off"):
        pass
    monkeypatch.setenv("CERBERUS_PROFILE_DIR", str(tmp_path / "prof"))
    with profiling.maybe_profile("slide/a"):
        with profiling.trace_span("inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = list((tmp_path / "prof").iterdir())
    assert trace.name.startswith("slide_a_") and trace.name.endswith(
        ".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "inner" for e in events)


def test_deterministic_mode_sets_and_restores():
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    draws = []
    for _ in range(2):
        with debug.deterministic_mode(7) as gen:
            assert torch.are_deterministic_algorithms_enabled()
            assert cudnn.deterministic and not cudnn.benchmark
            assert not cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            draws.append((random.random(), np.random.rand(),
                          float(torch.rand(1, generator=gen)),
                          float(torch.rand(1))))
    assert draws[0] == draws[1]
    assert before == (torch.are_deterministic_algorithms_enabled(),
                      cudnn.deterministic, cudnn.benchmark,
                      cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32,
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
