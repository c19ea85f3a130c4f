"""The count of steerable-filter kernel syntheses on the CPU:
``models/gconv.synth_counts`` against a DSF net's G-convolutions and
forward calls, and the WSI engine's once-a-slide ``Steerable Kernel
Syntheses`` log line (a ResNet slide logs none; a DSF slide's line is held
in ``tests/test_torch_dsf_reference.py``)."""
import logging
import os

import numpy as np
import torch
import yaml

from _torch_dsf_helpers import GSCALE_SERVED, dsf_model
from cerberus_tpu_torch.config import DEFAULT_TARGET_CODE
from cerberus_tpu_torch.data.patching import make_channel_index_map
from cerberus_tpu_torch.infer import wsi as port_wsi
from cerberus_tpu_torch.models import gconv
from cerberus_tpu_torch.wsi.ioconfig import (
    make_inference_ioconfig,
    make_postproc_ioconfig,
)

torch.set_num_threads(2)

LABEL = "Steerable Kernel Syntheses"
WIN_IN, WIN_OUT = 64, 32


def test_a_forward_adds_one_synthesis_per_gconv():
    model, _ = dsf_model("dsf_cnn_4", gscale=GSCALE_SERVED)
    x = torch.rand(1, 3, WIN_IN, WIN_IN)
    before = gconv.synth_counts["kernels"]
    with torch.no_grad():
        for _ in range(2):
            model(x)
    n_gconv = sum(isinstance(m, gconv.GConv2d) for m in model.modules())
    assert n_gconv > 0
    assert gconv.synth_counts["kernels"] - before == 2 * n_gconv


def test_a_resnet_slide_logs_no_syntheses(tmp_path):
    """A slide (96x96, 0.5 mpp) through ``process_single_file`` on the
    resident loop with a ResNet model (its forward stubbed) logs its
    phases and no ``Steerable Kernel Syntheses`` line. The DSF slide's
    line is held in ``tests/test_torch_dsf_reference.py``."""
    slide = tmp_path / "s"
    os.makedirs(slide)
    np.save(slide / "level_0.npy", np.random.default_rng(0).integers(
        0, 255, (96, 96, 3)).astype(np.uint8))
    with open(slide / "meta.yml", "w") as handle:
        yaml.safe_dump({"mpp": 0.5}, handle)
    out = tmp_path / "out"
    for sub in ("dat", "tissue"):
        os.makedirs(out / sub)
    manager = port_wsi.InferManager(
        decoder_dict=dict(DEFAULT_TARGET_CODE), device="cpu", batch_size=9,
        patch_input_shape=WIN_IN, patch_output_shape=WIN_OUT,
        tile_shape=144, chunk_shape=480, ambiguous_size=16,
        wsi_proc_mag=0.5, postproc_backend="gpu",
        cache_path=str(tmp_path / "cache"))
    _, n_ch = make_channel_index_map(manager.cfg.active_decoder_kwargs)
    manager.run_step = lambda batch, out_sz: torch.zeros(
        (batch.shape[0], out_sz, out_sz, n_ch))
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    manager.logger = logging.getLogger("test_gconv_counter.resnet")
    manager.logger.handlers = [handler]
    manager.logger.setLevel(logging.INFO)
    manager.logger.propagate = False
    n_heads = len(manager.cfg.active_decoder_kwargs)
    manager.process_single_file(
        make_inference_ioconfig(0.5, n_heads, tile_shape=480, margin=16,
                                patch_input=WIN_IN, patch_output=WIN_OUT),
        make_postproc_ioconfig(0.5, tile_shape=144, margin=16),
        str(slide), None, "s", str(out))
    assert any(line.startswith("Inference Time: ") for line in lines)
    assert not [line for line in lines if LABEL in line]

