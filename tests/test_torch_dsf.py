"""The DSF-CNN model family of the port against the JAX package (CPU, f32,
JAX at ``default_matmul_precision("highest")``).

Held against ``cerberus_tpu/models/gconv.py``,
``cerberus_tpu/models/backbones/dsf_cnn.py`` and the ``dsf`` branches of
``cerberus_tpu/models/net_desc.py``, on weights shared through the state
dict (``tests/_torch_dsf_helpers.py``: seeded reference init, G-conv
coefficients x0.05 and randomised BN statistics, ``tests/test_dsf_cnn.py``'s
recipe):
  * the basis, its rotations and the synthesised kernel equal JAX's for
    every k in {5, 7, 9} x O in {4, 8, 12}, Z2->G and G->G (1e-6 of the
    kernel's largest magnitude);
  * each G unit (G-conv, G batch norm in eval and in training with its
    fold, orientation pooling, channel concatenation) within 1e-5;
  * the dsf_cnn_4 pyramid and the whole net at 32^2 within 1e-4 of each
    output's largest magnitude (values reach 1e12 at this weight scale);
  * the state dict round trip, a reference-layout ``weights.tar`` (with
    ``basis_filters`` buffers) loading strictly, and native checkpoints;
  * Patch-Class with a DSF encoder raises in both packages;
  * one f32 train step (loss, gradients, parameters, Adam moments, BN
    statistics), held as ``tests/test_torch_train_step.py`` holds ResNet,
    at the served coefficient scale 0.01: at 0.05 the raw skip features'
    means dwarf their spread, and JAX's f32 batch norm (``x * inv +
    shift``) cancels in the backward, so its coarsest tower gradients
    drift from the float64 step far beyond the port's and beyond the
    noise the perturbed reruns measure;
  * the tile CLI's ``.mat`` maps on a 96x80 image at 64->32 against the JAX
    tile manager's, held as ``tests/test_torch_tile.py`` holds ResNet.
"""
import os

import numpy as np
import pytest
import scipy.io as sio
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_dsf_helpers import (
    GSCALE_SERVED,
    dsf_kwargs,
    dsf_model,
    noise_image,
    synthetic_inst_heads,
)
from _torch_train_helpers import LOSS_KWARGS_CLASS_WEIGHTS, make_batch
from cerberus_tpu.config import ModelConfig as JaxModelConfig
from cerberus_tpu.models import gconv as jg
from cerberus_tpu.models.backbones import get_backbone as jax_get_backbone
from cerberus_tpu.models.convert import convert_torch_state_dict
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu.models.net_desc import net_forward as jax_net_forward
from cerberus_tpu.train import steps as jax_steps
from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE, ModelConfig
from cerberus_tpu_torch.models import convert, gconv
from cerberus_tpu_torch.models.layers import BN_MOMENTUM
from cerberus_tpu_torch.models.net_desc import NetDesc, net_forward

torch.set_num_threads(2)

# the four decoders of the parity net and train step
DECODERS = {"Gland": {"INST": 3}, "Gland#TYPE": {"TYPE": 3},
            "Nuclei": {"INST": 3}, "Nuclei#TYPE": {"TYPE": 7}}
NET_TOL = 1e-4
UNIT_TOL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("g2g", [False, True], ids=["z2g", "g2g"])
@pytest.mark.parametrize("orients", [4, 8, 12])
@pytest.mark.parametrize("ksize", [5, 7, 9])
def test_basis_and_kernel_synthesis_match_jax(ksize, orients, g2g):
    filters, freqs = gconv.basis_filters(ksize)
    ref_filters, ref_freqs = jg.basis_filters(ksize)
    np.testing.assert_array_equal(filters, ref_filters)
    assert freqs == ref_freqs
    np.testing.assert_array_equal(gconv.rotated_basis(ksize, orients),
                                  jg.rotated_basis(ksize, orients))
    o_in = orients if g2g else 1
    rng = np.random.default_rng(ksize * 100 + orients)
    w = rng.standard_normal((2, 1, gconv.n_basis(ksize), 1, 1, o_in, 3, 2)
                            ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jg.synthesize_kernel(jnp.asarray(w), ksize, o_in,
                                              orients))
    got = gconv.synthesize_kernel(torch.from_numpy(w), torch.from_numpy(
        gconv.rotated_basis(ksize, orients)), o_in)
    assert tuple(got.shape) == (orients * 2, o_in * 3, ksize, ksize)
    assert _rel(got.numpy().transpose(2, 3, 1, 0), ref) < 1e-6


def _unit_case(unit, rng):
    """(port output, JAX output, extra checks) of one G unit on seeded
    inputs (4 orientations)."""
    o = 4
    if unit in ("gconv_z2g", "gconv_g2g"):
        o_in, cin, cout, k = (1, 3, 5, 7) if unit == "gconv_z2g" else \
            (o, 5, 3, 5)
        x = rng.standard_normal((2, 12, 12, o_in * cin)).astype(np.float32)
        mod = gconv.GConv2d(cin, cout, k, o_in, o)
        w = rng.standard_normal(mod.weight.shape).astype(np.float32)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(w))
            got = _nhwc(mod(_nchw(x)))
        ref = jg.gconv2d({"gweight": jnp.asarray(w)}, jnp.asarray(x), k,
                         o_in, o)
        return got, ref, {}
    if unit.startswith("gbn"):
        c = 5
        x = (rng.standard_normal((2, 6, 7, o * c)) * 2 + 0.5).astype(
            np.float32)
        p = {"scale": 1 + 0.1 * rng.standard_normal(c),
             "bias": 0.1 * rng.standard_normal(c),
             "mean": 0.1 * rng.standard_normal(c),
             "var": rng.random(c) + 0.5}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        mod = gconv.GBatchNorm2d(c, o)
        bn = mod.norm
        with torch.no_grad():
            for attr, key in (("weight", "scale"), ("bias", "bias"),
                              ("running_mean", "mean"),
                              ("running_var", "var")):
                getattr(bn, attr).copy_(torch.from_numpy(p[key]))
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        if unit == "gbn_eval":
            mod.eval()
            with torch.no_grad():
                got = _nhwc(mod(_nchw(x)))
            return got, jg.g_batch_norm(jp, jnp.asarray(x), o), {}
        mod.train()
        with torch.no_grad():
            got = _nhwc(mod(_nchw(x)))
        sink = {}
        ref = jg.g_batch_norm(jp, jnp.asarray(x), o, sink, "bn")
        mean, var = sink["bn"]
        m = BN_MOMENTUM
        return got, ref, {
            "running_mean": (bn.running_mean.numpy(),
                             (1 - m) * p["mean"] + m * np.asarray(mean)),
            "running_var": (bn.running_var.numpy(),
                            (1 - m) * p["var"] + m * np.asarray(var))}
    if unit.startswith("group_pool"):
        x = rng.standard_normal((2, 5, 6, o * 3)).astype(np.float32)
        kind = unit.rsplit("_", 1)[1]
        return (_nhwc(gconv.group_pool(_nchw(x), o, kind)),
                jg.group_pool(jnp.asarray(x), o, kind), {})
    xs = [rng.standard_normal((2, 5, 6, o * c)).astype(np.float32)
          for c in (2, 3, 1)]
    return (_nhwc(gconv.group_concat_channels([_nchw(x) for x in xs], o)),
            jg.group_concat_channels([jnp.asarray(x) for x in xs], o), {})


@pytest.mark.parametrize("unit", ["gconv_z2g", "gconv_g2g", "gbn_eval",
                                  "gbn_train", "group_pool_max",
                                  "group_pool_mean", "group_concat"])
def test_g_units_match_jax(unit):
    with jax.default_matmul_precision("highest"):
        got, ref, extra = _unit_case(unit, np.random.default_rng(3))
        ref = np.asarray(ref)
    assert _rel(got, ref) < UNIT_TOL
    for name, (port, jax_value) in extra.items():
        assert _rel(port, jax_value) < UNIT_TOL, name


def test_gbn_train_batch_of_one_value_keeps_the_guard():
    """One value per channel and orientation group: the fold takes a zero
    variance (JAX's ``max(count - 1, 1)``), as ``layers.BatchNorm2d``."""
    mod = gconv.GBatchNorm2d(3, 1).train()
    with torch.no_grad():
        mod(torch.randn(1, 3, 1, 1))
    assert torch.allclose(mod.norm.running_var, torch.full((3,), 0.9))


def _params(model):
    return convert.jax_params_from_state_dict(model.state_dict())


@pytest.fixture(scope="module")
def parity_net():
    model, kwargs = dsf_model("dsf_cnn_4", DECODERS)
    return model, kwargs, _params(model)


def test_dsf_pyramid_matches_jax(parity_net):
    model, _, params = parity_net
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    _init, fwd, filters = jax_get_backbone("dsf_cnn_4")
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: fwd(p, x, "backbone", None))(
            params, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(_nchw(x))
    assert len(got) == len(ref) == 5
    for level, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[1] == 4 * filters[level]
        assert _rel(_nhwc(g), r) < NET_TOL, level


def test_dsf_net_matches_jax(parity_net):
    model, kwargs, params = parity_net
    imgs = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3)).astype(
        np.float32)
    cfg = JaxModelConfig.from_kwargs(kwargs)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: jax_net_forward(p, x, cfg))(
            params, jnp.asarray(imgs))
    with torch.no_grad():
        got = net_forward(model, torch.from_numpy(imgs))
    assert set(got) == set(ref) == {"Gland-INST", "Gland-TYPE",
                                    "Nuclei-INST", "Nuclei-TYPE"}
    for head, r in ref.items():
        assert np.isfinite(np.asarray(r)).all()
        assert _rel(got[head].numpy(), r) < NET_TOL, head


def _reference_layout(state_dict):
    """The port's state dict as a reference DSF checkpoint holds it: each
    G-conv also carries a ``basis_filters`` buffer."""
    out = dict(state_dict)
    for key, value in state_dict.items():
        if key.endswith(".weight") and value.dim() == 8:
            out[key[:-len("weight")] + "basis_filters"] = torch.randn(
                value.shape[2], 2, 7, 7)
    return out


def test_state_dict_round_trip_and_reference_checkpoint(parity_net,
                                                        tmp_path):
    model, kwargs, params = parity_net
    state = model.state_dict()
    assert any(v.dim() == 8 for v in state.values())
    assert not any(k.endswith(("basis", "basis_filters")) for k in state)
    # JAX tree <-> state dict, exactly both ways
    back = convert.state_dict_from_jax_params(params)
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    again = convert.jax_params_from_state_dict(back)
    for name, leaf in params.items():
        assert set(again[name]) == set(leaf), name
        for attr, value in leaf.items():
            np.testing.assert_array_equal(again[name][attr], value)
    assert "gweight" in params["backbone.i1"]
    # a reference-layout weights.tar: the JAX converter drops the basis,
    # the port's loader too, and the rest loads strictly
    ref_state = _reference_layout(state)
    jax_tree = convert_torch_state_dict(ref_state)
    assert set(jax_tree) == set(params)
    for name, leaf in params.items():
        for attr, value in leaf.items():
            np.testing.assert_array_equal(jax_tree[name][attr], value)
    fresh = NetDesc(ModelConfig.from_kwargs(kwargs))
    with pytest.raises(RuntimeError, match="basis_filters"):
        fresh.load_state_dict(ref_state, strict=True)
    path = str(tmp_path / "weights.tar")
    torch.save({"desc": ref_state}, path)
    fresh.load_state_dict(convert.load_checkpoint(path), strict=True)
    for key, value in state.items():
        assert torch.equal(fresh.state_dict()[key], value), key
    # native msgpack checkpoint of the JAX tree
    native = str(tmp_path / "native.msgpack")
    convert.save_native_checkpoint(native, params)
    loaded = convert.load_checkpoint(native)
    for key, value in state.items():
        assert torch.equal(loaded[key], value), key


@pytest.mark.parametrize("package", ["port", "jax"])
def test_patch_class_with_dsf_raises(package):
    kwargs = dsf_kwargs("dsf_cnn_4", dict(DECODERS,
                                          **{"Patch-Class": {"OUT": 9}}))
    if package == "port":
        with pytest.raises(NotImplementedError, match="dsf"):
            NetDesc(ModelConfig.from_kwargs(kwargs))
        return
    cfg = JaxModelConfig.from_kwargs(kwargs)
    params = jax.eval_shape(lambda k: init_net_params(k, cfg),
                            jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="dsf"):
        jax.eval_shape(lambda p, x: jax_net_forward(p, x, cfg), params,
                       jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))


def test_tame_head_logits_scales_the_dsf_heads(parity_net):
    """The port's ``tame_head_logits`` finds a DSF net's last head convs
    (``output_head.*.block.1.conv``; the JAX function matches none there
    and raises) and nothing else."""
    from cerberus_tpu_torch.train.utils import tame_head_logits

    state = parity_net[0].state_dict()
    tamed = tame_head_logits(state, factor=0.5)
    changed = sorted(k for k in state if not torch.equal(tamed[k], state[k]))
    assert changed == sorted(
        "output_head.%s.%s.block.1.conv.weight" % (dec, head)
        for dec, heads in DECODERS.items() for head in heads)
    inst = tame_head_logits(state, factor=0.5, inst_only=True)
    assert sorted(k for k in state if not torch.equal(inst[k], state[k])) \
        == ["output_head.%s.INST.block.1.conv.weight" % dec
            for dec in ("Gland", "Nuclei")]


# -- one train step ----------------------------------------------------------

def _train_params(seed=0, gscale=GSCALE_SERVED):
    """The DSF model's JAX tree with BN affines and conv biases
    randomised as ``tests/test_torch_train_step.py`` does, and the heads'
    last convs tamed 0.05x (the JAX ``tame_head_logits`` matches no DSF
    head)."""
    model, kwargs = dsf_model("dsf_cnn_4", DECODERS, seed, gscale)
    rng = np.random.default_rng(seed + 1)
    params = {}
    for name, leaf in _params(model).items():
        leaf = dict(leaf)
        if "mean" in leaf:
            c = leaf["mean"].shape
            leaf["scale"] = (1 + rng.normal(size=c) * 0.1).astype(np.float32)
            leaf["bias"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        elif "bias" in leaf:
            leaf["bias"] = (rng.normal(size=leaf["bias"].shape) * 0.05
                            ).astype(np.float32)
        if name.endswith(".block.1.conv") and name.startswith("output_head."):
            leaf["kernel"] = leaf["kernel"] * np.float32(0.05)
        params[name] = leaf
    return kwargs, params


def test_dsf_train_step_matches_jax():
    """dsf_cnn_4 (coefficients x0.01), the four decoders, 32^2, batch 2,
    Adam: loss scalars, gradients, parameters, Adam moments and BN
    statistics of one f32 step within 1e-5 / 1e-4 or 4x each side's
    measured noise."""
    import test_torch_train_step as ts

    kwargs, params = _train_params()
    cfg = JaxModelConfig.from_kwargs(kwargs)
    rng = np.random.default_rng(5)
    batch = make_batch(rng, n=2, hw=32, cfg=ModelConfig.from_kwargs(kwargs))
    for head in list(batch):
        if head.endswith("#WEIGHT-MAP"):
            batch[head] = rng.uniform(1, 5, batch[head].shape).astype(
                np.float32)
    jstep, tx = jax_steps.make_train_step(
        cfg, LOSS_KWARGS_CLASS_WEIGHTS, {"lr": ts.LR}, donate=False,
        return_grads=True)
    state = jax_steps.TrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros((), jnp.int32))
    run = ts._compare(kwargs, {"lr": ts.LR}, jstep, state, batch,
                      jax.random.PRNGKey(7))
    assert set(run["ref"]["port_metrics"]) == {
        "Gland-INST_loss", "Gland-TYPE_loss", "Nuclei-INST_loss",
        "Nuclei-TYPE_loss", "overall_loss"}
    assert any("gweight" in leaf for leaf in run["ref"]["port_grads"].values())
    ts._assert_metrics(run)
    ts._assert_grads(run)
    ts._assert_state(run)
    # the G batch norms folded their statistics
    name = "backbone.d1.units.0.norm1.norm"
    assert not np.array_equal(run["ref"]["port"].jax_train_state()[0][name]
                              ["mean"], params[name]["mean"])


# -- the tile CLI ------------------------------------------------------------

TILE_IN, TILE_OUT = 64, 32
TARGET_CODE = {k: v for k, v in DEFAULT_TARGET_CODE.items()
               if k != "Patch-Class"}
TASKS = ("gland", "lumen", "nuclei")


def served_model(arch="dsf_cnn_4", seed=0, hw=TILE_IN):
    """A seeded DSF model with the synthetic INST heads, calibrated on a
    noise window of ``hw``^2."""
    model, kwargs = dsf_model(arch, seed=seed, gscale=GSCALE_SERVED,
                              random_bn=False)
    x = torch.from_numpy(noise_image(seed + 100, (hw, hw))).permute(
        2, 0, 1)[None].float() / 255.0
    return synthetic_inst_heads(model, x), kwargs


def test_tile_cli_matches_jax_tile_manager(tmp_path):
    import cv2

    from cerberus_tpu.infer.tile import InferManager as JaxInferManager
    from cerberus_tpu_torch.run_infer_tile import main

    model, kwargs = served_model()
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    torch.save({"desc": _reference_layout(model.state_dict())},
               str(model_dir / "weights.tar"))
    with open(model_dir / "settings.yml", "w") as handle:
        yaml.safe_dump({"dataset_kwargs": {"req_target_code": TARGET_CODE},
                        "model_kwargs": kwargs}, handle, sort_keys=False)
    input_dir = tmp_path / "input"
    os.makedirs(input_dir)
    cv2.imwrite(str(input_dir / "t.png"),
                cv2.cvtColor(noise_image(1, (96, 80)), cv2.COLOR_RGB2BGR))

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    with jax.default_matmul_precision("highest"):
        JaxInferManager(
            checkpoint_path=str(model_dir / "weights.tar"),
            decoder_dict=TARGET_CODE, model_args=kwargs,
            compute_dtype=jnp.float32).process_file_list({
                "nr_inference_workers": 0, "nr_post_proc_workers": 0,
                "batch_size": 4, "input_dir": str(input_dir),
                "output_dir": str(jax_out), "patch_input_shape": TILE_IN,
                "patch_output_shape": TILE_OUT, "patch_output_overlap": 0,
                "postproc_list": list(TASKS), "postproc_backend": "cpu"})
    main(["--model=%s" % model_dir, "--input_dir=%s" % input_dir,
          "--output_dir=%s" % port_out, "--batch_size=4",
          "--patch_input_shape=%d" % TILE_IN,
          "--patch_output_shape=%d" % TILE_OUT, "--postproc_backend=cpu",
          "--nr_post_proc_workers=0"], device="cpu")
    for task in TASKS:
        ref = sio.loadmat(str(jax_out / ("%s_mat" % task) / "t.mat"))
        got = sio.loadmat(str(port_out / ("%s_mat" % task) / "t.mat"))
        assert got["inst_map"].shape == ref["inst_map"].shape == (96, 80)
        if task != "lumen":
            assert ref["inst_map"].max() > 0, task
        # only threshold flips of probabilities agreeing to 1e-4 may differ
        assert (got["inst_map"] == ref["inst_map"]).mean() >= 0.999, task
        assert len(np.unique(got["inst_map"])) == len(np.unique(
            ref["inst_map"])), task
        assert ("type_map" in got) == ("type_map" in ref) == (
            task != "lumen")
        if task != "lumen":
            np.testing.assert_array_equal(got["type_map"], ref["type_map"])
    assert not (port_out / "pclass_mat").exists()


# -- the other serving entry points ------------------------------------------

@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    """A model directory of ``served_model`` (reference layout)."""
    model, kwargs = served_model()
    d = tmp_path_factory.mktemp("dsf_model")
    torch.save({"desc": _reference_layout(model.state_dict())},
               str(d / "weights.tar"))
    with open(d / "settings.yml", "w") as handle:
        yaml.safe_dump({"dataset_kwargs": {"req_target_code": TARGET_CODE},
                        "model_kwargs": kwargs}, handle, sort_keys=False)
    return d, kwargs, _params(model)


def _tile_manager(served_dir):
    from cerberus_tpu_torch.infer.tile import InferManager

    d, kwargs, _ = served_dir
    return InferManager(checkpoint_path=str(d / "weights.tar"),
                        decoder_dict=TARGET_CODE, model_args=kwargs,
                        device="cpu", batch_size=4,
                        patch_input_shape=TILE_IN,
                        patch_output_shape=TILE_OUT)


@pytest.mark.parametrize("path", ["fused", "cache", "predictor"])
def test_serving_paths_equal_the_per_image_path(served_dir, path):
    """``--tile_backend=fused``, the cross-file batch cache and
    ``CerberusPredictor`` on the DSF model: the per-image path's canvas
    and label maps, exactly (one batch size, the CPU)."""
    from cerberus_tpu_torch.infer.fused_tile import run_fused_tile
    from cerberus_tpu_torch.predictor import CerberusPredictor

    manager = _tile_manager(served_dir)
    images = [noise_image(s, hw) for s, hw in ((2, (96, 80)),
                                               (3, (70, 110)))]
    ref = [manager.infer_canvas(img) for img in images]
    if path == "fused":
        got = [run_fused_tile(manager, img) for img in images]
    elif path == "cache":
        got = [canvas for _, _, canvas in manager.cached_canvases(
            list(enumerate(images)))]
    else:
        predictor = CerberusPredictor.from_model_dir(
            str(served_dir[0]), device="cpu", batch_size=4,
            patch_input_shape=TILE_IN, patch_output_shape=TILE_OUT)
        got = [torch.from_numpy(predictor.predict_raw(img))
               for img in images]
        tile = predictor.predict_tile(images[0], list(TASKS))
        inst, _, pclass = manager.process_image(images[0])
        assert tile["pclass_map"] is None and pclass is None
        for task in ("Gland", "Lumen", "Nuclei"):
            np.testing.assert_array_equal(tile[task]["inst_map"], inst[task])
    for g, r in zip(got, ref):
        assert g.shape == r.shape and r.shape[-1] == 2 * 3 + 2
        assert torch.equal(g.float(), r.float())


def test_wsi_resident_and_legacy_loops_match_jax(served_dir, tmp_path):
    """The WSI engine with the DSF model on a 192x240 slide at 64->32 (f32):
    the port's resident and legacy loops give the JAX legacy loop's
    instance counts per task, and no tissue map (no Patch-Class head).
    (The JAX resident loop is not the reference here: at this geometry its
    counts differ from the JAX legacy loop's, which both port loops
    reproduce; ROADMAP section 3 records the resident loop's fault.)"""
    import joblib

    import test_torch_wsi as tw
    from cerberus_tpu.infer.wsi import InferManager as JaxWSIManager
    from cerberus_tpu_torch.infer import wsi as port_wsi

    d, kwargs, params = served_dir
    slide = tmp_path / "input" / "s"
    tw._write_slide(slide, 3, blocks=(24, 30))

    def run(tag, manager, resident):
        args = tw._run_args(tmp_path, tag, slide, "gpu" if tag != "jax"
                            else "tpu", geometry=(TILE_IN, TILE_OUT))
        args["postproc_list"] = list(TASKS)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("CERBERUS_RESIDENT", "1" if resident else "0")
            manager.process_wsi_list(args)
        out = tmp_path / ("out_%s" % tag)
        assert not (out / "tissue" / "s.mat").exists()
        dat = joblib.load(str(out / "dat" / "s.dat"))
        return {t: len(dat[t]) for t in tw.TASKS}

    with jax.default_matmul_precision("highest"):
        ref = run("jax", JaxWSIManager(
            decoder_dict=TARGET_CODE, model_args=kwargs, params=params,
            compute_dtype=jnp.float32), False)
    assert ref["Nuclei"] > 0 and ref["Gland"] > 0
    for tag, resident in (("resident", True), ("legacy", False)):
        manager = port_wsi.InferManager(
            checkpoint_path=str(d / "weights.tar"), decoder_dict=TARGET_CODE,
            model_args=kwargs, device="cpu")
        assert run(tag, manager, resident) == ref, tag
