"""The plain reference against the port on the CPU, at small sizes: the
same state dict names and shapes, the same forward, the same nuclei
labels and records, the same window and tile grids. (The reference
itself imports nothing of the port; only this test holds both.)"""
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import HERE
from portbench.reference import grid
from portbench.reference import postproc as P
from portbench.reference.model import Net, forward_windows, param_specs


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as handle:
        return json.load(handle)


def _port_model(cfg, seed=1):
    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

    mc = ModelConfig.from_kwargs({
        "encoder_backbone_name": cfg["encoder"],
        "decoder_kwargs": cfg["decoders"],
        "considered_tasks": list(cfg["decoders"])})
    model = init_weights(NetDesc(mc), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(
                    mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(
                    mod.running_var.shape, generator=gen) + 0.5)
            elif type(mod).__name__ == "GConv2d":
                mod.weight.mul_(0.05)
    return model.eval(), mc


@pytest.mark.parametrize("config,size,out", [("cerberus-r34", 160, 48),
                                             ("cerberus-dsf8", 64, 32)])
def test_forward_and_canvas_equal_the_port(config, size, out):
    from cerberus_tpu_torch.infer.steps import infer_outputs

    cfg = _config(config)
    model, mc = _port_model(cfg)
    sd = model.state_dict()
    specs = param_specs(cfg["encoder"], cfg["decoders"])
    assert sorted(s[0] for s in specs) == sorted(sd)
    assert all(tuple(sd[n].shape) == tuple(shape) for n, shape, _ in specs)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, size, size, 3), dtype=np.uint8))
    net = Net(dict(sd), cfg["encoder"], cfg["decoders"])
    got = forward_windows(net, imgs.numpy(), out, "cpu")
    want = infer_outputs(model, imgs, mc, out, valid_region=False).numpy()
    assert np.array_equal(got, want)
    low = forward_windows(Net(dict(sd), cfg["encoder"], cfg["decoders"],
                              "fp8"), imgs.numpy(), out, "cpu")
    assert not np.array_equal(low, want)


def _blobs(hw, n, seed, rmin, rmax):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(rmin, rmax)
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    return prob


@pytest.mark.parametrize("seed", [0, 1])
def test_nuclei_labels_and_records_equal_the_port(seed):
    from cerberus_tpu_torch.ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT
    from cerberus_tpu_torch.ops.postproc import get_inst_info_dict

    hw = (260, 300)
    inner = np.clip(_blobs(hw, 50, seed, 4, 14) * 1.1, 0, 1).astype(
        np.float16).astype(np.float32)
    cnt = (_blobs(hw, 30, seed + 9, 2, 6) * 0.6).astype(np.float16).astype(
        np.float32)
    lab = GPU_POSTPROC_FUNC_DICT["IP-ERODED-CONTOUR-3"].labels(
        torch.from_numpy(np.stack([inner, cnt], -1)), "Nuclei").numpy()
    ref = P.nuclei_labels(inner, cnt, "cpu")
    assert np.array_equal(lab > 0, ref > 0)
    info = get_inst_info_dict(lab.astype(np.int64), None)
    port = [(v["box"][0][1] + 5, v["box"][0][0] + 7, v["box"][1][1] + 5,
             v["box"][1][0] + 7, v["centroid"][0] + 5, v["centroid"][1] + 7)
            for v in info.values()]
    recs = P.records(ref, (5, 7))
    assert len(recs) == len(port) > 10
    assert P.unmatched(recs, port) == (0, 0)
    shifted = [r[:4] + (r[4] + 0.5, r[5]) for r in port[:3]] + port[3:]
    assert P.unmatched(recs, shifted) == (3, 3)


def test_grids_equal_the_port():
    from cerberus_tpu_torch.data.patching import prepare_patching
    from cerberus_tpu_torch.wsi.coords import (filter_coordinates,
                                               get_coordinates, get_tile_info)
    from cerberus_tpu_torch.wsi.ioconfig import (make_inference_ioconfig,
                                                 make_postproc_ioconfig)

    for h, w in ((256, 320), (1000, 1000), (97, 1536)):
        img = np.random.default_rng(h).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)
        padded, info, _ = prepare_patching(img, 448, 144)
        ref_padded, tl = grid.tile_windows(img, 448, 144)
        assert np.array_equal(padded, ref_padded)
        assert np.array_equal(info[:, 0, 0], tl)
    side = 3072
    mask = np.zeros((768, 768), np.uint8)
    mask[100:500, 200:700] = 1
    io = make_inference_ioconfig(0.5, 6)
    inputs, outputs = get_coordinates((side, side), io)
    keep = filter_coordinates(mask, outputs, (side, side))
    assert np.array_equal(outputs[keep][:, :2],
                          grid.slide_windows(side, side, 448, 144, mask))
    tiles = get_tile_info((side, side), make_postproc_ioconfig(
        0.5, tile_shape=2048))[0][0]
    assert np.array_equal(tiles, grid.grid_tiles(side, side, 2048, 144))
