"""``cerberus_tpu_torch.predictor.CerberusPredictor`` on the CPU: against
JAX ``CerberusPredictor`` on shared params (held as
``tests/test_torch_tile.py`` holds the tile path), against the tile
engine's per-image path byte for byte, from threads, and from a model
directory whose ``weights.tar`` the JAX package wrote. The model and images
are ``tests/test_torch_tile_cache.py``'s."""
import os
import threading

import numpy as np
import pytest
import torch
import yaml

import conftest  # noqa: F401  (CPU pinning)

import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_TARGET_CODE, DEFAULT_TARGET_LIST
from cerberus_tpu.models.convert import save_checkpoint
from cerberus_tpu.predictor import CerberusPredictor as JaxPredictor
from cerberus_tpu_torch.infer.tile import (
    InferManager,
    post_process_canvas,
    post_process_host,
)
from cerberus_tpu_torch.predictor import CerberusPredictor
from test_torch_tile import _assert_agrees, _image
from test_torch_tile_cache import (
    IN_SHAPE,
    MODEL_KWARGS,
    OUT_SHAPE,
    model_params,
    port_manager,
)
from test_torch_wsi import stub_outputs

torch.set_num_threads(2)
TASKS = ("Gland", "Lumen", "Nuclei")


@pytest.fixture(scope="module")
def params():
    return model_params()


def _predictor(params, **kwargs):
    return CerberusPredictor(
        checkpoint_path=None, model_args=MODEL_KWARGS,
        decoder_dict=dict(DEFAULT_TARGET_CODE), batch_size=4,
        patch_input_shape=IN_SHAPE, patch_output_shape=OUT_SHAPE,
        params=params, device="cpu", **kwargs)


def _as_tuple(result):
    inst = {t: result[t]["inst_map"] for t in TASKS}
    types = {t: result[t]["type_map"] for t in TASKS}
    return inst, types, result["pclass_map"]


@pytest.fixture(scope="module")
def jax_results(params):
    predictor = JaxPredictor(
        checkpoint_path=None, model_args=MODEL_KWARGS,
        decoder_dict=dict(DEFAULT_TARGET_CODE), batch_size=4,
        patch_input_shape=IN_SHAPE, patch_output_shape=OUT_SHAPE,
        postproc_backend="tpu", params=params, compute_dtype=jnp.float32)
    img = _image(50, (100, 120))
    out = {"raw": predictor.predict_raw(img),
           "gpu": predictor.predict_tile(img)}
    predictor.postproc_backend = "cpu"
    out["cpu"] = predictor.predict_tile(img)
    return img, out


@pytest.fixture(scope="module")
def port_predictor(params):
    return _predictor(params)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_predictor_agrees_with_jax_predictor(port_predictor, jax_results,
                                             backend):
    img, ref = jax_results
    predictor = port_predictor
    if backend == "gpu":
        raw = predictor.predict_raw(img)
        assert raw.shape == ref["raw"].shape and raw.dtype == np.float32
        err = np.abs(raw - ref["raw"]).max() / max(1.0,
                                                   np.abs(ref["raw"]).max())
        assert err <= 2e-4, err
    predictor.postproc_backend = backend
    got = predictor.predict_tile(img)
    assert set(got) == set(ref[backend])
    _assert_agrees((None, (None, None) + _as_tuple(ref[backend])[:1]
                    + (None,) + _as_tuple(ref[backend])[1:],
                    _as_tuple(got)))
    for task in TASKS:
        assert set(got[task]["inst_info"]) == set(
            np.unique(got[task]["inst_map"][got[task]["inst_map"] > 0]))
    # the port's families on the JAX predictor's canvas give its maps
    families = post_process_canvas if backend == "gpu" else post_process_host
    inst, types, pclass = families(
        torch.from_numpy(ref["raw"]) if backend == "gpu" else ref["raw"],
        dict(DEFAULT_TARGET_CODE), list(DEFAULT_TARGET_LIST),
        predictor.cfg.active_decoder_kwargs)
    ref_inst, ref_types, ref_pclass = _as_tuple(ref[backend])
    for task in TASKS:
        np.testing.assert_array_equal(inst[task], ref_inst[task])
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_predictor_equals_process_image_and_threads(params, monkeypatch):
    """``predict_tile`` / ``predict_raw`` are ``process_image`` /
    ``infer_canvas`` at the same batch size, byte for byte; two threads
    give the serial results (under a per-window step: the real forward's
    agreement is the test above)."""
    monkeypatch.setattr(
        InferManager, "run_step",
        lambda self, batch, out_sz: torch.from_numpy(
            stub_outputs(batch.numpy(), out_sz)))
    predictor = _predictor(params)
    manager = port_manager(params)
    images = [_image(60 + i, hw) for i, hw in
              enumerate(((100, 120), (130, 90)))]
    serial = [predictor.predict_tile(img) for img in images]
    for img, got in zip(images, serial):
        np.testing.assert_array_equal(predictor.predict_raw(img),
                                      manager.infer_canvas(img).numpy())
        inst, types, pclass = manager.process_image(img)
        for task in TASKS:
            np.testing.assert_array_equal(got[task]["inst_map"], inst[task])
            if types[task] is None:
                assert got[task]["type_map"] is None
            else:
                np.testing.assert_array_equal(got[task]["type_map"],
                                              types[task])
        np.testing.assert_array_equal(got["pclass_map"], pclass)
    threaded = [None, None]

    def work(i):
        threaded[i] = predictor.predict_tile(images[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for got, ref in zip(threaded, serial):
        for task in TASKS:
            np.testing.assert_array_equal(got[task]["inst_map"],
                                          ref[task]["inst_map"])
        np.testing.assert_array_equal(got["pclass_map"], ref["pclass_map"])


def test_predictor_cpu_backend_is_the_host_families(params):
    predictor = _predictor(params, postproc_backend="cpu")
    img = _image(70, (60, 50))
    got = predictor.predict_tile(img)
    inst, types, pclass = post_process_host(
        predictor.predict_raw(img), dict(DEFAULT_TARGET_CODE),
        ["gland", "lumen", "nuclei", "patch-class"],
        predictor.cfg.active_decoder_kwargs)
    for task in TASKS:
        np.testing.assert_array_equal(got[task]["inst_map"], inst[task])
    np.testing.assert_array_equal(got["pclass_map"], pclass)
    with pytest.raises(ValueError, match="postproc_backend"):
        _predictor(params, postproc_backend="tpu2")


def test_from_model_dir_reads_a_jax_written_checkpoint(params, tmp_path):
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    save_checkpoint(str(model_dir / "weights.tar"), params)
    with open(model_dir / "settings.yml", "w") as f:
        yaml.safe_dump({
            "dataset_kwargs": {"req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": MODEL_KWARGS}, f)
    predictor = CerberusPredictor.from_model_dir(
        str(model_dir), device="cpu", batch_size=4,
        patch_input_shape=IN_SHAPE, patch_output_shape=OUT_SHAPE)
    assert predictor.device == torch.device("cpu")
    assert predictor.cfg.encoder_backbone_name == "resnet18"
    ref = _predictor(params)._manager.model.state_dict()
    got = predictor._manager.model.state_dict()
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert torch.equal(got[key], value), key
