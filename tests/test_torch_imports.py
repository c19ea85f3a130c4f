"""The port stands alone: importing every module of cerberus_tpu_torch loads
neither JAX, flax, cv2, PyYAML, joblib nor anything of cerberus_tpu; the source
imports none of them at top level; kernel launches and the native patch
gather have no fallback; entry points default to the card."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import cerberus_tpu_torch
from cerberus_tpu_torch.infer.manager import InferManager, resolve_device
from cerberus_tpu_torch.infer.wsi import InferManager as WSIInferManager
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
                                    "joblib", "cerberus_tpu"))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("cerberus_tpu_torch")]))
print("BAD", bad)
print("WSI", sorted(m for m in sys.modules if m.startswith(
    ("cerberus_tpu_torch.wsi.", "cerberus_tpu_torch.infer.wsi",
     "cerberus_tpu_torch.infer.resident_wsi", "cerberus_tpu_torch.run_infer_wsi",
     "cerberus_tpu_torch.ops.cc_cpu", "cerberus_tpu_torch.ops.tissue_mask",
     "cerberus_tpu_torch.ops.postproc", "cerberus_tpu_torch.native.",
     "cerberus_tpu_torch.convert_slide"))))
"""


def test_import_all_modules_loads_no_jax_cv2_yaml_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 20
    assert lines["BAD"] == "[]"
    wsi = eval(lines["WSI"])  # the whole-slide modules are in the probe
    assert {"cerberus_tpu_torch.infer.wsi", "cerberus_tpu_torch.run_infer_wsi",
            "cerberus_tpu_torch.wsi.reader",
            "cerberus_tpu_torch.wsi.tiff_reader",
            "cerberus_tpu_torch.wsi.mirax_reader",
            "cerberus_tpu_torch.native.patch_gather",
            "cerberus_tpu_torch.convert_slide",
            "cerberus_tpu_torch.ops.postproc",
            "cerberus_tpu_torch.ops.tissue_mask"} <= set(wsi), wsi


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
    for name in ("ops/cc_label.py", "ops/hist16384.py", "ops/watershed.py",
                 "ops/cuda_build.py", "ops/device_postproc.py",
                 "ops/gpu_postproc.py", "native/patch_gather.py"):
        text = (PKG / name).read_text()
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
    with pytest.raises(RuntimeError, match="CUDA"):
        WSIInferManager(model_args={"encoder_backbone_name": "resnet18"})
