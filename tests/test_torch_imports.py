"""The port stands alone: importing every module of cerberus_tpu_torch loads
neither JAX, flax, cv2, PyYAML nor anything of cerberus_tpu; the source
imports none of them at top level; kernel launches have no fallback; entry
points default to the card."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import cerberus_tpu_torch
from cerberus_tpu_torch.infer.manager import InferManager, resolve_device
from cerberus_tpu_torch.ops.cc_label import connected_components
from cerberus_tpu_torch.ops.hist16384 import hist16384
from cerberus_tpu_torch.ops.watershed import propagate_labels, watershed

PKG = pathlib.Path(cerberus_tpu_torch.__file__).parent
ROOT = PKG.parent

_PROBE = """
import importlib, pkgutil, sys
import cerberus_tpu_torch
for mod in pkgutil.walk_packages(cerberus_tpu_torch.__path__,
                                 "cerberus_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "yaml",
                                    "cerberus_tpu"))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("cerberus_tpu_torch")]))
print("BAD", bad)
"""


def test_import_all_modules_loads_no_jax_cv2_yaml_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 20
    assert lines["BAD"] == "[]"


def _sources():
    return sorted(PKG.rglob("*.py"))


def test_source_imports_no_jax_or_reference_package():
    forbidden = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|cerberus_tpu)(\.|\s|$)")
    offenders = [
        "%s:%d" % (path.relative_to(ROOT), no)
        for path in _sources()
        for no, line in enumerate(path.read_text().splitlines(), 1)
        if forbidden.match(line)]
    assert offenders == []


def test_kernel_wrappers_have_no_fallback():
    for name in ("cc_label.py", "hist16384.py", "watershed.py",
                 "cuda_build.py", "device_postproc.py", "gpu_postproc.py"):
        text = (PKG / "ops" / name).read_text()
        assert not re.search(r"^\s*(try:|except\b)", text, re.M), name


@pytest.mark.parametrize("call", [
    lambda t: connected_components(t.bool()),
    lambda t: hist16384(t.int()),
    lambda t: watershed(t.float(), t.int(), t.bool()),
    lambda t: propagate_labels(t.int(), t.bool()),
])
def test_wrappers_refuse_non_cuda_devices(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros((4, 4), device="meta"))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferManager(model_args={"encoder_backbone_name": "resnet18"})
