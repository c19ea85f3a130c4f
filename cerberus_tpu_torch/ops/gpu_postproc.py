"""Instance post-processing families on the device.

Counterpart of ``cerberus_tpu/ops/tpu_postproc.py`` (lines 115-260): the
same channel, threshold and size contract as the CPU oracle, composed from
``device_postproc`` primitives so the stitched canvas stays on the card
until it is instance label maps. Label maps are byte-equal to the JAX
families on the same canvas.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device_postproc as D
from .device_postproc import KERNELS, Impl


def _inner_contour_instances(inner, cnt, thresh: float, min_size: int,
                             ksize: int, impl: Impl = KERNELS):
    """gland/lumen ErodedContourMap: fg = inner - binarized contour >
    thresh; label; small-object removal; dilate + fill re-growth."""
    cnt = (cnt > 0.5).to(inner.dtype)
    fg = (inner - cnt) > thresh
    lab = D.connected_components(fg, impl)
    lab = D.remove_small_objects(lab, min_size, impl)
    lab = D.dilate_labels(lab, ksize)
    return D.fill_label_holes(lab, impl)


def _nuclei_watershed(inner, cnt, impl: Impl = KERNELS):
    """nuclei ErodedContourMap: erode(inner+contour>.5, k3) mask (>=8 px),
    inner>.5 markers (>=4 px, holes filled), watershed(-inner)."""
    msk = D.binary_erode((inner + cnt) > 0.5, D.disk_kernel(3))
    msk = D.remove_small_objects(D.connected_components(msk, impl), 8,
                                 impl) > 0
    mrk_lab = D.remove_small_objects(D.connected_components(inner > 0.5,
                                                            impl), 4, impl)
    mrk = D.fill_holes(mrk_lab > 0, impl)
    markers = D.connected_components(mrk, impl)
    return D.watershed(-inner, markers, msk, impl)


def _eroded_map_instances(fg_raw, thresh: float, min_size: int, ksize: int,
                          impl: Impl = KERNELS):
    """ErodedMap family: threshold, label, small-object removal, regrow."""
    lab = D.connected_components(fg_raw > thresh, impl)
    lab = D.remove_small_objects(lab, min_size, impl)
    lab = D.dilate_labels(lab, ksize)
    return D.fill_label_holes(lab, impl)


def _compact_labels(lab) -> np.ndarray:
    """Relabel sparse ids to contiguous 1..N (ascending by id) as float64,
    like the JAX family output written to the ``.mat`` files."""
    if isinstance(lab, torch.Tensor):
        lab = lab.cpu().numpy()
    lab = np.asarray(lab)
    ids = np.unique(lab)
    ids = ids[ids != 0]
    lut = np.zeros(int(lab.max()) + 1 if lab.size else 1, np.float64)
    lut[ids] = np.arange(1, len(ids) + 1)
    return lut[lab]


def _type_map(raw_map, idx_dict, tissue_mode):
    type_key = tissue_mode + "-TYPE"
    if type_key not in idx_dict:
        return None
    s, e = idx_dict[type_key]
    return np.squeeze(raw_map[..., s:e].float().cpu().numpy()).astype(
        np.float32)


class GPUPostProcInstErodedMap:
    _SPEC = {"GLAND": (1500, 11), "LUMEN": (150, 3), "NUCLEI": (8, 3)}

    @classmethod
    def post_process(cls, raw_map: torch.Tensor, idx_dict, tissue_mode,
                     ds_factor=1.0, impl: Impl = KERNELS):
        """``raw_map``: (H, W, C) canvas tensor on the device. Returns
        (float64 inst_map, f32 type_map or None) as numpy."""
        min_size, ksize = cls._SPEC[tissue_mode.upper()]
        s, e = idx_dict["%s-INST" % tissue_mode]
        fg = raw_map[..., s:e].squeeze().float().contiguous()
        lab = _eroded_map_instances(fg, 0.5, min_size, ksize, impl)
        return _compact_labels(lab), _type_map(raw_map, idx_dict, tissue_mode)


class GPUPostProcInstErodedContourMap:
    _SPEC = {  # tissue -> (thresh, base_min_size, base_ksize)
        "GLAND": (0.55, 1000, 11),
        "LUMEN": (0.5, 150, 3),
    }

    @classmethod
    def post_process(cls, raw_map: torch.Tensor, idx_dict, tissue_mode,
                     ds_factor=1.0, impl: Impl = KERNELS):
        s, _e = idx_dict["%s-INST" % tissue_mode]
        inner = raw_map[..., s].float().contiguous()
        cnt = raw_map[..., s + 1].float().contiguous()
        mode = tissue_mode.upper()
        if mode == "NUCLEI":
            lab = _nuclei_watershed(inner, cnt, impl)
        else:
            thresh, base_min, base_k = cls._SPEC[mode]
            lab = _inner_contour_instances(
                inner, cnt, thresh, int(base_min * ds_factor ** 2),
                int((base_k - 1) * ds_factor), impl)
        return _compact_labels(lab), _type_map(raw_map, idx_dict, tissue_mode)


GPU_POSTPROC_FUNC_DICT = {
    "IP-ERODED-3": GPUPostProcInstErodedMap,
    "IP-ERODED-11": GPUPostProcInstErodedMap,
    "IP-ERODED-CONTOUR-3": GPUPostProcInstErodedContourMap,
    "IP-ERODED-CONTOUR-11": GPUPostProcInstErodedContourMap,
}
