"""The port's device mesh and batch-sharded inference
(``cerberus_tpu_torch.parallel.mesh``) on the CPU.

A mesh here lists the CPU several times (a virtual mesh, as the card's
smoke runs ``[cuda:0] * k``); the JAX side runs on the 8 virtual CPU
devices of ``tests/conftest.py``. resnet18 at 144->48, the JAX init crossed
by ``state_dict_from_jax_params``.
"""
import numpy as np
import pytest
import torch

import conftest

import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_DECODER_KWARGS, DEFAULT_TARGET_CODE
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from _torch_train_helpers import jax_layout_params
from cerberus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cerberus_tpu.parallel.mesh import (
    make_sharded_infer_step as jax_sharded_step,
)
from cerberus_tpu_torch import run_infer_tile
from cerberus_tpu_torch.config import ModelConfig
from cerberus_tpu_torch.infer import fused_tile
from cerberus_tpu_torch.infer import manager as manager_module
from cerberus_tpu_torch.infer.tile import InferManager
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.models.net_desc import NetDesc
from cerberus_tpu_torch.parallel import mesh as port_mesh
from cerberus_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_infer_step,
    replicate_params,
    shard_batch,
)

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return jax_layout_params(MODEL_KWARGS, 0)


def _model(params):
    model = NetDesc(ModelConfig.from_kwargs(MODEL_KWARGS))
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model.eval()


def test_make_mesh_and_shard_batch():
    mesh = make_mesh([CPU] * 4)
    assert mesh.devices == (CPU,) * 4
    assert mesh.group is None and mesh.size == 4 and mesh.rank == 0
    assert make_mesh(["cpu"]).devices == (CPU,)
    batch = torch.arange(8 * 3).view(8, 3)
    chunks = shard_batch(batch, mesh)
    assert [c.shape[0] for c in chunks] == [2, 2, 2, 2]
    assert torch.equal(torch.cat(chunks), batch)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch[:6], mesh)
    with pytest.raises(ValueError):
        make_mesh([])


def test_replicas_share_a_device():
    model = torch.nn.Linear(2, 2)
    replicas = replicate_params(model, make_mesh([CPU] * 3))
    assert all(r is model for r in replicas)


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().devices)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.gpu_flag_devices("0,1")
    assert port_mesh.gpu_flag_devices("1") == ("cuda:1", None)


def test_sharded_infer_accepts_non_divisible_batch_and_matches_jax(params):
    """JAX's ``test_sharded_infer_accepts_non_divisible_batch`` on an
    8-entry CPU mesh: a batch of 10 comes back as 10 rows equal to the
    batch of 16's first 10; the outputs are within 2e-4 relative of JAX's
    sharded step on the same params (f32)."""
    mesh = make_mesh([CPU] * 8)
    run = make_sharded_infer_step(_model(params), ModelConfig.from_kwargs(
        MODEL_KWARGS), mesh, output_shape=48, compute_dtype=torch.float32,
        out_dtype=torch.float32)
    imgs = np.random.default_rng(0).integers(0, 255, (16, 144, 144, 3),
                                             dtype=np.uint8)
    full = run(torch.from_numpy(imgs))
    part = run(torch.from_numpy(imgs[:10]))
    assert part.shape[0] == 10
    assert torch.equal(part, full[:10])

    jmesh = jax_make_mesh(conftest.cpu_mesh_devices())
    jrun = jax_sharded_step(params, JaxModelConfig.from_kwargs(MODEL_KWARGS),
                            jmesh, output_shape=48, compute_dtype=jnp.float32)
    ref = np.asarray(jrun(imgs[:10]))
    got = part.numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-4 * scale


def _tile_manager(params, batch_size, mesh=None):
    return InferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                        model_args=MODEL_KWARGS, params=params, device="cpu",
                        mesh=mesh, batch_size=batch_size,
                        patch_input_shape=144, patch_output_shape=48)


def test_manager_mesh_maps_equal_single_device(params, monkeypatch):
    """``InferManager(mesh=...)``: a 3-entry mesh at batch 3 (one window a
    replica) gives the maps of the single-device manager at batch 1;
    ``--tile_backend=fused`` keeps one device."""
    img = np.random.default_rng(1).integers(0, 255, (100, 120, 3),
                                            dtype=np.uint8)
    sharded = _tile_manager(params, 3, make_mesh([CPU] * 3))
    single = _tile_manager(params, 1)
    assert sharded.mesh.size == 3 and sharded.device == CPU
    assert torch.equal(sharded.infer_canvas(img), single.infer_canvas(img))
    got = sharded.process_image(img)
    ref = single.process_image(img)
    for g, r in zip(got[:2], ref[:2]):
        assert set(g) == set(r)
        for key in r:
            np.testing.assert_array_equal(g[key], r[key])
    np.testing.assert_array_equal(got[2], ref[2])
    assert list(sharded._step_cache) == [48]  # the sharded step alone

    def refuse(*args, **kwargs):
        raise AssertionError("the fused backend stepped the mesh")

    fused_single = fused_tile.run_fused_tile(_tile_manager(params, 3), img)
    monkeypatch.setattr(manager_module, "make_sharded_infer_step", refuse)
    fresh = _tile_manager(params, 3, make_mesh([CPU] * 3))
    assert torch.equal(fused_tile.run_fused_tile(fresh, img), fused_single)


def test_manager_mesh_arguments(params, monkeypatch):
    with pytest.raises(ValueError, match="single-controller"):
        InferManager(model_args=MODEL_KWARGS, params=params, device="cpu",
                     mesh=port_mesh.Mesh((CPU,), group=object()))
    with pytest.raises(ValueError, match="first device"):
        InferManager(model_args=MODEL_KWARGS, params=params, device="cpu",
                     mesh=port_mesh.Mesh((torch.device("meta"), CPU)))
    monkeypatch.delenv("CERBERUS_DEFAULT_DEVICE", raising=False)
    if not torch.cuda.is_available():
        # a --gpu list without a card raises, as a single id does
        with pytest.raises(RuntimeError, match="CUDA"):
            run_infer_tile.main(["--model=unused", "--input_dir=x",
                                 "--output_dir=%s" % "unused_out",
                                 "--gpu=0,1"])
