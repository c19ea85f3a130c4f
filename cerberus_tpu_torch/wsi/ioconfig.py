"""IO configuration for WSI processing.

A copy of ``cerberus_tpu/wsi/ioconfig.py``.

Behavioral equivalent of tiatoolbox's ``IOSegmentorConfig`` as used by the
reference (``infer/wsi.py:888-915``): bundles input/output resolutions (mpp),
tile shape, margin, patch input/output shapes and stride. Only the fields the
pipeline actually consumes are modeled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence


@dataclasses.dataclass(frozen=True)
class IOSegmentorConfig:
    input_resolutions: Sequence[Dict]
    output_resolutions: Sequence[Dict]
    margin: int
    tile_shape: Sequence[int]        # (w, h)
    patch_input_shape: Sequence[int]   # (w, h)
    patch_output_shape: Sequence[int]  # (w, h)
    stride_shape: Sequence[int]        # (w, h)
    save_resolution: Dict = None

    @property
    def highest_input_resolution(self) -> Dict:
        # mpp: smaller value = higher resolution
        return min(self.input_resolutions, key=lambda v: v["resolution"])


def make_inference_ioconfig(proc_mpp: float, n_heads: int = 6,
                            tile_shape: int = 15000, margin: int = 64,
                            patch_input: int = 448, patch_output: int = 144
                            ) -> IOSegmentorConfig:
    """The reference's inference ioconfig (infer/wsi.py:888-904)."""
    res = {"units": "mpp", "resolution": proc_mpp}
    return IOSegmentorConfig(
        input_resolutions=[res],
        output_resolutions=[dict(res) for _ in range(n_heads)],
        margin=margin,
        tile_shape=[tile_shape, tile_shape],
        patch_input_shape=[patch_input, patch_input],
        patch_output_shape=[patch_output, patch_output],
        stride_shape=[patch_output, patch_output],
        save_resolution=res,
    )


def make_postproc_ioconfig(proc_mpp: float, tile_shape: int = 4096,
                           margin: int = 64) -> IOSegmentorConfig:
    """The reference's post-processing ioconfig (infer/wsi.py:906-915)."""
    res = {"units": "mpp", "resolution": proc_mpp}
    return IOSegmentorConfig(
        input_resolutions=[res],
        output_resolutions=[res],
        margin=margin,
        tile_shape=[tile_shape, tile_shape],
        patch_input_shape=[448, 448],
        patch_output_shape=[144, 144],
        stride_shape=[144, 144],
        save_resolution=res,
    )
