"""The WSI engine's mesh branch on the CPU: an 8-entry CPU mesh, the
``gpu`` backend (the row-sharded families through the kernels' plain
versions), against the JAX WSI engine with ``mesh=make_mesh(
cpu_mesh_devices())`` and its ``tpu`` families.

Both engines take the legacy loop with a mesh. The stub forward of
``tests/test_torch_wsi.py`` makes both write the same canvas, so the
``.dat`` payloads (compared by content) differ only if the engines'
sharded post-processing does. A real resnet18 forward at batch 8 (one
window a replica) drives the mesh step through the loop end to end and
equals the single-device legacy loop at batch 1.
"""
import numpy as np
import pytest
import torch

import conftest

from cerberus_tpu.config import DEFAULT_TARGET_CODE
from _torch_train_helpers import jax_layout_params
from cerberus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cerberus_tpu_torch.infer import wsi as port_wsi
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.ops import sharded_cc
from cerberus_tpu_torch.parallel.mesh import make_mesh
from test_torch_wsi import (
    MODEL_KWARGS,
    TASKS,
    _biased_params,
    _outputs,
    _payload,
    _run_args,
    _torch_stub,
    _write_slide,
    stub_outputs,
)

torch.set_num_threads(2)

CPU_MESH = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """A 240x320 slide of ``test_torch_wsi``'s kind (post-processing tiles
    of 192: a 2x2 grid and its boundary sets)."""
    root = tmp_path_factory.mktemp("mesh_wsi")
    _write_slide(root / "input" / "s", 3, blocks=(30, 40))
    return root / "input" / "s"


def _port_mesh_run(root, tag, slide, checkpoint=None, mesh=CPU_MESH,
                   batch_size=8, resident="1"):
    infer = port_wsi.InferManager(
        checkpoint_path=checkpoint, decoder_dict=dict(DEFAULT_TARGET_CODE),
        model_args=MODEL_KWARGS, device="cpu",
        mesh=make_mesh(mesh) if mesh else None)
    if checkpoint is None:
        infer.run_step = _torch_stub.__get__(infer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CERBERUS_RESIDENT", resident)
        args = _run_args(root, tag, slide, "gpu")
        args["batch_size"] = batch_size
        infer.process_wsi_list(args)
    return _outputs(root, tag, slide)


def test_mesh_stub_dat_matches_jax_mesh_run(slide, tmp_path, monkeypatch):
    """The port's mesh run equals the JAX engine's mesh run by content;
    the legacy loop ran (no resident processor) and its nuclei tiles and
    tissue regions went through the sharded families."""
    from cerberus_tpu.infer.wsi import InferManager

    jax_infer = InferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                             model_args=MODEL_KWARGS,
                             mesh=jax_make_mesh(conftest.cpu_mesh_devices()))
    jax_infer.run_step = stub_outputs
    jax_infer.process_wsi_list(_run_args(tmp_path, "jax", slide, "tpu"))
    ref_dat, ref_pclass = _outputs(tmp_path, "jax", slide)

    calls = {"cc": 0, "resident": 0}
    orig_cc = sharded_cc.connected_components_sharded

    def counting_cc(*args, **kwargs):
        calls["cc"] += 1
        return orig_cc(*args, **kwargs)

    def no_resident(*args, **kwargs):
        calls["resident"] += 1
        raise AssertionError("the resident loop ran with a mesh")

    monkeypatch.setattr(sharded_cc, "connected_components_sharded",
                        counting_cc)
    monkeypatch.setattr(port_wsi.resident_wsi, "ResidentWSIProcessor",
                        no_resident)
    dat, pclass = _port_mesh_run(tmp_path, "port", slide)
    assert all(len(dat[t]) > 0 for t in TASKS)
    assert _payload(dat) == _payload(ref_dat)
    np.testing.assert_array_equal(pclass, ref_pclass)
    assert calls["cc"] > 0 and calls["resident"] == 0


def test_mesh_step_drives_the_legacy_loop(tmp_path):
    """The real forward (``test_torch_wsi``'s biased resnet18) on an
    8-entry mesh at batch 8 through the whole engine equals the
    single-device legacy loop at batch 1 (each replica steps one window,
    as the single device does; the sharded watershed's strip-boundary
    plateau ties do not arise on this slide's nuclei)."""
    slide = tmp_path / "input" / "s"
    _write_slide(slide, 3, blocks=(24, 30))
    params = _biased_params(params=jax_layout_params(MODEL_KWARGS, 5))
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(tmp_path / "weights.tar"))
    ckpt = str(tmp_path / "weights.tar")
    dat, pclass = _port_mesh_run(tmp_path, "mesh", slide, ckpt)
    ref_dat, ref_pclass = _port_mesh_run(tmp_path, "single", slide, ckpt,
                                         mesh=None, batch_size=1,
                                         resident="0")
    assert sum(len(dat[t]) for t in TASKS) > 0
    np.testing.assert_array_equal(dat["proc_dimensions"], [192, 240])
    assert _payload(dat) == _payload(ref_dat)
    np.testing.assert_array_equal(pclass, ref_pclass)
