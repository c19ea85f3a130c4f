"""Native checkpoints on the CPU: the port's msgpack codec
(``cerberus_tpu_torch/models/native_ckpt.py``) against flax's, the three
branches of ``models/convert.load_checkpoint`` against the JAX loader, the
manager's ``params=`` and ``cerberus_tpu_torch.convert_checkpoint``'s
``main`` against ``tools/convert_checkpoint.py``'s conversion."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (CPU pinning)

import flax.serialization as flax_ser
import jax

from cerberus_tpu.config import DEFAULT_DECODER_KWARGS, ModelConfig
from cerberus_tpu.models import convert as jax_convert
from cerberus_tpu.models.net_desc import init_net_params
from cerberus_tpu_torch import convert_checkpoint
from cerberus_tpu_torch.config import ModelConfig as PortConfig
from cerberus_tpu_torch.infer.manager import InferManager
from cerberus_tpu_torch.models import convert, native_ckpt
from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

MODEL_KWARGS = {
    "encoder_backbone_name": "resnet18",
    "decoder_kwargs": DEFAULT_DECODER_KWARGS,
    "considered_tasks": list(DEFAULT_DECODER_KWARGS.keys()),
}


@pytest.fixture(scope="module")
def params():
    """A JAX-layout tree of the resnet18 model (made by the port's seeded
    init: eager ``init_net_params`` takes ~16 s on the CPU), whose layer
    names equal ``init_net_params``'s."""
    model = init_weights(NetDesc(PortConfig.from_kwargs(MODEL_KWARGS)),
                         torch.Generator().manual_seed(3))
    tree = convert.jax_params_from_state_dict(model.state_dict())
    ref = jax.eval_shape(lambda: init_net_params(
        jax.random.PRNGKey(3), ModelConfig.from_kwargs(MODEL_KWARGS)))
    assert {k: {a: v.shape for a, v in leaf.items()}
            for k, leaf in tree.items()} == {
        k: {a: v.shape for a, v in leaf.items()} for k, leaf in ref.items()}
    return tree


def _assert_trees_equal(got, ref):
    """Same structure, key order aside; leaves of the same type, dtype,
    shape and bytes."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref)
        for key in ref:
            _assert_trees_equal(got[key], ref[key])
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref)
        assert got.dtype == ref.dtype and np.shape(got) == np.shape(ref)
        assert np.asarray(got).tobytes() == np.asarray(ref).tobytes()
    else:
        assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("max_chunk", [None, 4096])
def test_decoder_equals_flax_restore(params, tmp_path, monkeypatch,
                                     max_chunk):
    """JAX ``save_checkpoint`` files, with the scalar ``step`` and, with
    flax's ``MAX_CHUNK_SIZE`` lowered, chunked leaves."""
    if max_chunk is not None:
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", max_chunk)
    path = str(tmp_path / "weights.tar")
    jax_convert.save_checkpoint(path, params, step=7)
    blob = open(path, "rb").read()
    if max_chunk is not None:
        assert native_ckpt.CHUNKED.encode() in blob
    ref = flax_ser.msgpack_restore(blob)
    got = native_ckpt.decode(blob)
    _assert_trees_equal(got, ref)
    assert isinstance(got["step"], np.int64) and got["step"] == 7
    # the port writes what flax writes, byte for byte
    assert native_ckpt.encode(got, max_chunk or native_ckpt.MAX_CHUNK_SIZE) \
        == blob


def test_port_written_file_reads_back_through_jax(params, tmp_path):
    path = str(tmp_path / "weights.tar")
    convert.save_native_checkpoint(path, params, step=11)
    _assert_trees_equal(jax_convert.load_native_checkpoint(path), params)
    # the JAX loader's dispatch takes it for native too
    _assert_trees_equal(jax_convert.load_checkpoint(path), params)
    ref = str(tmp_path / "ref.tar")
    jax_convert.save_checkpoint(ref, params, step=11)
    assert open(path, "rb").read() == open(ref, "rb").read()


def test_codec_round_trips_every_type():
    tree = {"z": [None, True, False, 0, 127, 128, -1, -32, -33, 2 ** 40,
                  -2 ** 40, 1.5, "s" * 40, b"b" * 300, "x" * 70000],
            "a": {"f16": np.arange(6, dtype=np.float16).reshape(2, 3),
                  "u8": np.zeros((0, 3), np.uint8),
                  "b": np.array([True, False]),
                  "i": np.int32(-5), "d": np.float64(0.25)}}
    blob = native_ckpt.encode(tree)
    assert blob == flax_ser.msgpack_serialize(tree)
    _assert_trees_equal(native_ckpt.decode(blob),
                        flax_ser.msgpack_restore(blob))


@pytest.mark.parametrize("case", ["truncated", "length", "ext", "dtype",
                                  "trailing"])
def test_decoder_raises_value_error(params, case):
    blob = native_ckpt.encode({"params": {"x": {"kernel": np.ones(
        (3, 3), np.float32)}}, "step": np.int64(1)})
    if case == "truncated":
        bad = blob[:len(blob) // 2]
    elif case == "length":  # a str32 claiming more bytes than there are
        bad = b"\x81\xa1k\xdb\xff\xff\xff\x00abc"
    elif case == "ext":
        bad = b"\x81\xa1k\xd4\x07\x00"
    elif case == "dtype":
        inner = native_ckpt.encode([[2], "float128x", b"\x00" * 32])
        bad = b"\x81\xa1k\xc7" + bytes([len(inner)]) + b"\x01" + inner
    else:
        bad = blob + b"\xc0"
    with pytest.raises(ValueError):
        native_ckpt.decode(bad)


def _state_dict(params):
    return convert.state_dict_from_jax_params(params)


def _assert_state_dicts_equal(got, ref):
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("kind", ["zip", "legacy_tar", "native"])
def test_load_checkpoint_dispatch(params, tmp_path, kind):
    """The three branches: a ``PK`` zip, a legacy torch ``.tar`` that
    ``torch.load`` parses, and a native msgpack ``weights.tar``; each gives
    the state_dict the JAX loader's tree converts to."""
    sd = _state_dict(params)
    path = str(tmp_path / "weights.tar")
    if kind == "zip":
        torch.save({"desc": {"module." + k: v for k, v in sd.items()}}, path)
        assert open(path, "rb").read(2) == b"PK"
    elif kind == "legacy_tar":
        torch.save({"desc": sd}, path, _use_new_zipfile_serialization=False)
        assert open(path, "rb").read(2) != b"PK"
    else:
        jax_convert.save_checkpoint(path, params)
    got = convert.load_checkpoint(path)
    _assert_state_dicts_equal(got, sd)
    # the JAX loader reads the same file to the same tree
    _assert_trees_equal(convert.jax_params_from_state_dict(got),
                        {k: {a: np.asarray(v) for a, v in leaf.items()}
                         for k, leaf in jax_convert.load_checkpoint(
                             path).items()})


def test_torchvision_backbone_and_truncated_files_raise(params, tmp_path):
    tv = str(tmp_path / "resnet.pth")
    torch.save({"conv1.weight": torch.zeros(4, 3, 7, 7),
                "layer1.0.conv1.weight": torch.zeros(4, 4, 3, 3),
                "fc.weight": torch.zeros(2, 4)}, tv)
    # since training landed a torchvision backbone loads as the partial
    # ``backbone.*`` state_dict (fc dropped), as the JAX loader converts it
    loaded = convert.load_checkpoint(tv)
    assert sorted(loaded) == ["backbone.conv1.weight",
                              "backbone.layer1.0.conv1.weight"]
    assert sorted(jax_convert.load_checkpoint(tv)) == [
        "backbone.conv1", "backbone.layer1.0.conv1"]
    path = str(tmp_path / "weights.tar")
    jax_convert.save_checkpoint(path, params)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) - 100])
    with pytest.raises(ValueError):
        convert.load_checkpoint(path)


def test_manager_loads_native_checkpoint_and_params(params, tmp_path):
    path = str(tmp_path / "weights.tar")
    jax_convert.save_checkpoint(path, params)
    torch_path = str(tmp_path / "torch.tar")
    torch.save({"desc": _state_dict(params)}, torch_path)
    managers = [InferManager(checkpoint_path=p, model_args=MODEL_KWARGS,
                             device="cpu") for p in (path, torch_path)]
    managers.append(InferManager(model_args=MODEL_KWARGS, device="cpu",
                                 params=params))
    ref = managers[1].model.state_dict()
    for manager in (managers[0], managers[2]):
        _assert_state_dicts_equal(manager.model.state_dict(), ref)


def test_convert_checkpoint_cli(params, tmp_path, capsys):
    src = str(tmp_path / "weights.tar")
    torch.save({"desc": {"module." + k: v
                         for k, v in _state_dict(params).items()}}, src)
    dst = str(tmp_path / "native.msgpack")
    assert convert_checkpoint.main([src, dst]) == 0
    n = sum(v.size for leaf in params.values() for v in leaf.values())
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"converted {src} -> {dst} ({len(params)} layers, {n:,} params)")
    assert convert_checkpoint.main([]) == 1
    _assert_trees_equal(jax_convert.load_native_checkpoint(dst),
                        jax_convert.convert_torch_checkpoint(src))
