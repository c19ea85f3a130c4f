"""The slice as a whole on the CPU: the port's tile path against the JAX
tile path on the same synthetic checkpoint and image (f32).

The model is ``tests/test_tile_pipeline.py::model_dir``'s (resnet34, the six
default heads, ``init_net_params(PRNGKey(42))``, 144->48 windows, whose
bottom features are 9x9 like the production 448->144), with the INST heads
biased so that instances appear (the synthetic-model recipe of the verify
skill). It crosses to torch as a reference-style ``weights.tar``.
"""
import os

import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

import jax
import jax.numpy as jnp

from cerberus_tpu.config import (
    DEFAULT_DECODER_KWARGS,
    DEFAULT_TARGET_CODE,
    DEFAULT_TARGET_LIST,
)
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.data.patching import prepare_patching as jax_prepare
from cerberus_tpu.infer.steps import fused_infer_outputs
from cerberus_tpu.infer.tile import post_process_tile
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.ops.stitch import stitch_canvas as jax_stitch
from cerberus_tpu_torch.infer.tile import InferManager, post_process_canvas
from cerberus_tpu_torch.models.convert import state_dict_from_jax_params
from cerberus_tpu_torch.run_infer_tile import main

torch.set_num_threads(2)

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet34",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}
IN_SHAPE, OUT_SHAPE = 144, 48


def _synthetic_params():
    cfg = JaxModelConfig.from_kwargs(MODEL_KWARGS)
    params = jax.tree.map(np.asarray,
                          init_net_params(jax.random.PRNGKey(42), cfg))
    for task in ("Gland", "Lumen", "Nuclei"):
        leaf = dict(params["output_head.%s.INST.x.1.conv" % task])
        leaf["kernel"] = leaf["kernel"] * np.float32(0.003)
        leaf["bias"] = np.array([-2.0, 2.0, -1.5], np.float32)
        params["output_head.%s.INST.x.1.conv" % task] = leaf
    return params


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_model")
    params = _synthetic_params()
    torch.save({"desc": state_dict_from_jax_params(params)},
               str(d / "weights.tar"))
    with open(d / "settings.yml", "w") as f:
        yaml.safe_dump({
            "dataset_kwargs": {"req_target_code": dict(DEFAULT_TARGET_CODE)},
            "model_kwargs": MODEL_KWARGS}, f)
    return d, params


def _image(seed=0, hw=(150, 170)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for _ in range(12):
        cy, cx, r = rng.integers(0, hw[0]), rng.integers(0, hw[1]), \
            rng.integers(6, 30)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 255, 3)
    return img


def _jax_tile(params, img):
    """The JAX tile path at f32: patch grid, forward, host stitch, crop,
    ``post_process_tile(backend="tpu")``. Returns (canvas, results)."""
    cfg = JaxModelConfig.from_kwargs(MODEL_KWARGS)
    padded, info, src_pos = jax_prepare(img, IN_SHAPE, OUT_SHAPE)
    wins = np.stack([padded[y:y + IN_SHAPE, x:x + IN_SHAPE]
                     for y, x in info[:, 0, 0]])
    with jax.default_matmul_precision("highest"):
        outs = np.asarray(fused_infer_outputs(
            params, jnp.asarray(wins), cfg, OUT_SHAPE,
            compute_dtype=jnp.float32, out_dtype=jnp.float32))
    canvas = jax_stitch(list(outs), info[:, 1, 0], padded.shape[:2])
    canvas = canvas[src_pos[0]:src_pos[0] + img.shape[0],
                    src_pos[1]:src_pos[1] + img.shape[1]]
    image_info = {"name": "x", "src_image": img}
    results = post_process_tile(canvas, image_info, dict(DEFAULT_TARGET_CODE),
                                list(DEFAULT_TARGET_LIST),
                                cfg.active_decoder_kwargs, backend="tpu")
    return canvas, results


def _manager(model_dir):
    d, _ = model_dir
    return InferManager(checkpoint_path=str(d / "weights.tar"),
                        decoder_dict=dict(DEFAULT_TARGET_CODE),
                        model_args=MODEL_KWARGS, device="cpu", batch_size=4,
                        patch_input_shape=IN_SHAPE,
                        patch_output_shape=OUT_SHAPE)


@pytest.fixture(scope="module")
def both_paths(model_dir):
    _, params = model_dir
    img = _image()
    canvas, jax_results = _jax_tile(params, img)
    port = _manager(model_dir).process_image(img)
    return canvas, jax_results, port


def test_process_image_agrees_with_jax_tile_path(both_paths):
    _, (_, _, ref_inst, _, ref_type, ref_pclass), (inst, types, pclass) = \
        both_paths
    assert set(inst) == set(ref_inst) == {"Gland", "Lumen", "Nuclei"}
    assert ref_inst["Gland"].max() > 0 and ref_inst["Nuclei"].max() > 0
    for task, ref in ref_inst.items():
        got = inst[task]
        assert got.shape == ref.shape and got.dtype == ref.dtype
        # only threshold flips of probabilities agreeing to 2e-4 may differ
        assert (got == ref).mean() >= 0.999, task
        assert len(np.unique(got)) == len(np.unique(ref)), task
        if ref_type[task] is None:
            assert types[task] is None
        else:
            np.testing.assert_array_equal(types[task], ref_type[task])
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_jax_canvas_through_port_postproc_is_byte_equal(both_paths):
    canvas, (_, _, ref_inst, _, ref_type, ref_pclass), _ = both_paths
    inst, types, pclass = post_process_canvas(
        torch.from_numpy(canvas), dict(DEFAULT_TARGET_CODE),
        list(DEFAULT_TARGET_LIST), DEFAULT_DECODER_KWARGS)
    for task, ref in ref_inst.items():
        np.testing.assert_array_equal(inst[task], ref, err_msg=task)
    np.testing.assert_array_equal(pclass, ref_pclass)


def test_cli_main_writes_reference_outputs(model_dir, tmp_path):
    import cv2

    d, _ = model_dir
    input_dir, output_dir = tmp_path / "input", tmp_path / "output"
    os.makedirs(input_dir)
    for name, seed in (("t1", 1), ("t2", 2)):
        cv2.imwrite(str(input_dir / ("%s.png" % name)),
                    cv2.cvtColor(_image(seed, (100, 120)), cv2.COLOR_RGB2BGR))
    argv = ["--model=%s" % d, "--input_dir=%s" % input_dir,
            "--output_dir=%s" % output_dir, "--batch_size=4",
            "--patch_input_shape=%d" % IN_SHAPE,
            "--patch_output_shape=%d" % OUT_SHAPE]
    main(argv, device="cpu")
    for name in ("t1", "t2"):
        assert (output_dir / "overlay" / ("%s.jpg" % name)).exists()
        for task in ("gland", "lumen", "nuclei"):
            mat = sio.loadmat(str(output_dir / ("%s_mat" % task)
                                  / ("%s.mat" % name)))
            assert mat["inst_map"].shape == (100, 120)
            assert {"inst_map", "type", "id"} <= set(mat)
            assert ("type_map" in mat) == (task != "lumen")
        pclass = sio.loadmat(str(output_dir / "pclass_mat"
                                 / ("%s.mat" % name)))
        assert pclass["pclass"].shape == (100, 120)
        assert 0 <= pclass["pclass"].min() <= pclass["pclass"].max() <= 8
    with pytest.raises(AssertionError):  # skip-if-done: nothing left to do
        main(argv, device="cpu")
    for flag in ("--postproc_backend=cpu", "--dense"):
        with pytest.raises(NotImplementedError):
            main(argv + [flag], device="cpu")
