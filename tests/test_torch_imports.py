"""The port stands alone: importing every module of cerberus_tpu_torch loads
neither JAX, flax, optax, cv2, PyYAML, joblib, sklearn, msgpack, matplotlib
nor anything of cerberus_tpu; the source imports none of them at top level
(the training path no scipy either); kernel launches and the native patch
gather have no fallback; entry points default to the card."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import cerberus_tpu_torch
from cerberus_tpu_torch import run_eval_patch
from cerberus_tpu_torch.infer.manager import InferManager, resolve_device
from cerberus_tpu_torch.infer.patch import InferManager as PatchInferManager
from cerberus_tpu_torch.infer.wsi import InferManager as WSIInferManager
from cerberus_tpu_torch.predictor import CerberusPredictor
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
                                    "yaml", "joblib", "sklearn", "msgpack",
                                    "matplotlib", "cerberus_tpu"))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("cerberus_tpu_torch")]))
print("BAD", bad)
print("WSI", sorted(m for m in sys.modules if m.startswith(
    ("cerberus_tpu_torch.wsi.", "cerberus_tpu_torch.infer.wsi",
     "cerberus_tpu_torch.infer.resident_wsi", "cerberus_tpu_torch.run_infer_wsi",
     "cerberus_tpu_torch.ops.cc_cpu", "cerberus_tpu_torch.ops.tissue_mask",
     "cerberus_tpu_torch.ops.postproc", "cerberus_tpu_torch.native.",
     "cerberus_tpu_torch.convert_slide"))))
print("SERVE", sorted(m for m in sys.modules if m in (
    "cerberus_tpu_torch.predictor", "cerberus_tpu_torch.infer.patch",
    "cerberus_tpu_torch.infer.fused_tile", "cerberus_tpu_torch.run_eval_patch",
    "cerberus_tpu_torch.convert_checkpoint",
    "cerberus_tpu_torch.models.native_ckpt", "cerberus_tpu_torch.utils.debug",
    "cerberus_tpu_torch.utils.profiling")))
print("TRAIN", sorted(m for m in sys.modules if m.startswith(
    ("cerberus_tpu_torch.train.", "cerberus_tpu_torch.data.",
     "cerberus_tpu_torch.run_train"))))
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
    assert len(eval(lines["SERVE"])) == 8, lines["SERVE"]
    train = set(eval(lines["TRAIN"]))
    assert {"cerberus_tpu_torch.run_train"} | {
        "cerberus_tpu_torch.train." + name for name in _TRAIN_MODULES} | {
        "cerberus_tpu_torch.data." + name
        for name in ("augs", "targets", "train_loader")} <= train, train


def _sources():
    return sorted(PKG.rglob("*.py"))


_SERVE_MODULES = ("predictor.py", "models/native_ckpt.py",
                  "models/convert.py", "infer/patch.py", "infer/fused_tile.py",
                  "run_eval_patch.py", "convert_checkpoint.py")


_TRAIN_MODULES = ("callbacks", "convergence", "engine", "losses", "metrics",
                  "opt", "serialize", "steps", "utils", "viz")


def test_training_modules_import_no_host_library_at_module_level():
    """The training path imports cv2, scipy, PyYAML, matplotlib and joblib
    inside the functions that need them."""
    top = re.compile(r"^(import|from)\s+(joblib|cv2|scipy|yaml|matplotlib|"
                     r"optax|flax)(\.|\s|$)")
    names = (["train/%s.py" % name for name in _TRAIN_MODULES]
             + ["data/augs.py", "data/targets.py", "data/train_loader.py",
                "run_train.py", "models/layers.py", "models/net_desc.py"])
    offenders = ["%s:%d" % (name, no) for name in names
                 for no, line in enumerate(
                     (PKG / name).read_text().splitlines(), 1)
                 if top.match(line)]
    assert offenders == []


def test_serving_modules_import_no_host_library_at_module_level():
    """The predictor, the codec and the patch loader import joblib, cv2,
    sklearn and msgpack (where at all) inside the functions that need
    them."""
    top = re.compile(r"^(import|from)\s+(joblib|cv2|sklearn|msgpack|yaml)"
                     r"(\.|\s|$)")
    offenders = ["%s:%d" % (name, no) for name in _SERVE_MODULES
                 for no, line in enumerate(
                     (PKG / name).read_text().splitlines(), 1)
                 if top.match(line)]
    assert offenders == []


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
    with pytest.raises(RuntimeError, match="CUDA"):
        PatchInferManager(model_args={"encoder_backbone_name": "resnet18"})
    with pytest.raises(RuntimeError, match="CUDA"):
        CerberusPredictor(None, {"encoder_backbone_name": "resnet18"}, {})


def test_eval_patch_cli_defaults_to_cuda(tmp_path, monkeypatch):
    """``run_eval_patch`` picks ``cuda:<--gpu>`` unless told otherwise."""
    monkeypatch.delenv("CERBERUS_DEFAULT_DEVICE", raising=False)
    (tmp_path / "settings.yml").write_text(
        '{"model_kwargs": {"encoder_backbone_name": "resnet18"}}')
    seen = []

    class Stop(Exception):
        pass

    def fake_init(self, *args, device=None, **kwargs):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(PatchInferManager, "__init__", fake_init)
    with pytest.raises(Stop):
        run_eval_patch.main(["--model=%s" % tmp_path, "--input_dir=x"])
    with pytest.raises(Stop):
        run_eval_patch.main(["--model=%s" % tmp_path, "--input_dir=x",
                             "--gpu=1"])
    assert seen == ["cuda:0", "cuda:1"]
