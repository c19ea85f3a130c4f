"""Boundary strips that a dense window's output covers but none of its
top-lefts lie in, under a tissue mask that ends short of the strip (CPU,
the stub forward of ``tests/test_torch_wsi.py``).

The slide is 504 x 400 px at 592->288 (the dense margin of 304 px at a
CPU size), post-processing tiles of 432 px and strips 64 px wide (the
256 px strips of the 1168->864 default at ``ambiguous_size=16``). The
vertical strip over x = 432 spans x in [400, 464); patch outputs start at
x = 0 and 288, so no top-left lies in it, yet the window at 288 writes
its whole width. The mask holds tissue at x < 392 only: every window
still runs (each output reaches the tissue), so the canvas is the
unmasked one.

* The port post-processes a tile that a patch output reaches, so its
  nuclei with the mask, in the resident and the legacy loop, equal the
  JAX legacy engine's without a mask (the gland and lumen families run
  per tissue region of the mask, so they differ with it by design).
* The JAX package asks for a top-left and then for tissue: with the mask
  its legacy engine loses the strip's boundary nuclei and the whole
  grid tile right of it (ROADMAP section 3 records the divergence).
"""
import numpy as np
import pytest

import cv2

from cerberus_tpu.config import DEFAULT_TARGET_CODE
from cerberus_tpu.infer.wsi import InferManager as JaxInferManager
from test_torch_wsi import (
    MODEL_KWARGS,
    _outputs,
    _payload,
    _port_manager,
    _run_args,
    _torch_stub,
    _write_slide,
    stub_outputs,
)

GEOMETRY = {"geometry": (592, 288), "tile_shape": 432}
STRIP = (400, 464)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_wsi_boundary")
    slide = root / "slide.npy"
    _write_slide(slide, 0)
    mask = np.zeros((100, 126), np.uint8)
    mask[:, :98] = 255  # tissue at x < 392 of the 504 px wide slide
    cv2.imwrite(str(root / "mask.png"), mask)
    return root, slide


def _run(root, slide, tag, masked, resident, engine="port"):
    args = _run_args(root, tag, slide, "gpu", **GEOMETRY)
    if masked:
        args["mask_list"] = [str(root / "mask.png")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CERBERUS_RESIDENT", "1" if resident else "0")
        if engine == "port":
            infer = _port_manager()
            infer.run_step = _torch_stub.__get__(infer)
        else:
            infer = JaxInferManager(decoder_dict=dict(DEFAULT_TARGET_CODE),
                                    model_args=MODEL_KWARGS)
            infer.run_step = stub_outputs
            args["postproc_backend"] = "tpu"
        infer.process_wsi_list(args)
    return _outputs(root, tag, slide)[0]


def _in(dat, x0, x1=10 ** 9):
    return sum(1 for v in dat["Nuclei"].values() if x0 <= v["centroid"][0]
               < x1)


@pytest.fixture(scope="module")
def jax_legacy(case):
    root, slide = case
    return {masked: _run(root, slide, "jax%d" % masked, masked, False,
                         engine="jax") for masked in (False, True)}


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "legacy"])
def test_masked_strip_keeps_its_nuclei(case, jax_legacy, resident):
    root, slide = case
    masked = _run(root, slide, "m%d" % resident, True, resident)
    assert _in(masked, *STRIP) > 0
    assert _payload(masked)["Nuclei"] == \
        _payload(jax_legacy[False])["Nuclei"]


def test_jax_loses_the_uncovered_strip_under_the_mask(jax_legacy):
    lost, whole = jax_legacy[True], jax_legacy[False]
    assert _in(lost, *STRIP) < _in(whole, *STRIP)
    assert _in(lost, 432) == 0 < _in(whole, 432)
    assert _in(lost, 0, 392) == _in(whole, 0, 392)
