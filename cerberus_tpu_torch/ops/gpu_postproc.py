"""Instance post-processing families on the device.

Counterpart of ``cerberus_tpu/ops/tpu_postproc.py`` (lines 115-260): the
same channel, threshold and size contract as the CPU oracle, composed from
``device_postproc`` primitives so the stitched canvas stays on the card
until it is instance label maps. Label maps are byte-equal to the JAX
families on the same canvas.

Each family class has ``labels`` (its INST channels -> device int32 label
map, ids not compacted: what the WSI engine's grid tiles and tissue regions
run) and ``post_process`` (labels, then the host ``np.unique`` compaction
and the type map: the tile engine's and the WSI fallback paths' contract).
``compact_present_ids`` is the WSI engine's on-device counterpart of that
host compaction (``cerberus_tpu/infer/resident_wsi.py:76-105``), and
``pad_to_512`` its shape rule (``cerberus_tpu/ops/tpu_postproc.py:42-57``).

With ``mesh=`` (a single-controller ``parallel.mesh.Mesh``) both entries
run the row-sharded compositions of ``ops/sharded_cc.py``, as
``cerberus_tpu/ops/tpu_postproc.py:186-236`` does: the CC (and the
nuclei watershed) cores split into row strips over the mesh, the rest on
the whole plane on ``mesh.devices[0]``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device_postproc as D
from . import sharded_cc as S
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
    # compacted markers (a monotone relabel, so the watershed's min-id
    # tie-breaks and the final compacted map are unchanged) keep the
    # watershed's ids below the histogram's 16384 bins on a WSI tile, where
    # compact_present_ids can then take the hist16384 kernel
    markers, _ = D.compact_labels(D.connected_components(mrk, impl))
    return D.watershed(-inner, markers, msk, impl)


def _eroded_map_instances(fg_raw, thresh: float, min_size: int, ksize: int,
                          impl: Impl = KERNELS):
    """ErodedMap family: threshold, label, small-object removal, regrow."""
    lab = D.connected_components(fg_raw > thresh, impl)
    lab = D.remove_small_objects(lab, min_size, impl)
    lab = D.dilate_labels(lab, ksize)
    return D.fill_label_holes(lab, impl)


def pad_to_512(arr: np.ndarray) -> np.ndarray:
    """Zero-pad H/W up to multiples of 512. The JAX package padded to
    bound its compiles, and the padding changes results, so the port keeps
    it: cv2-compatible erosion treats the ARRAY border as foreground, so at
    an image's true bottom/right edge the nuclei mask differs from the
    unpadded call's."""
    h, w = arr.shape[:2]
    ph, pw = -(-h // 512) * 512, -(-w // 512) * 512
    if (ph, pw) == (h, w):
        return arr
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad)


def compact_present_ids(lab: torch.Tensor, impl: Impl = KERNELS):
    """On-device ``np.unique``-style relabel: ids with no pixel are
    dropped, the rest become 1..n in ascending-id order (a monotone map, so
    every min/max-id convention downstream is kept). Returns (int32
    labels, n as a 0-d int32 tensor on the device).

    Below 16384 ids the per-id sizes come from the ``hist16384`` kernel
    (told that only bins 0..max id are live); wider id planes count through
    ``torch.bincount`` over the flat-index id space, as
    ``remove_small_objects`` does."""
    lab = lab.contiguous()
    n_max = int(lab.max()) if lab.numel() else 0
    if n_max < D.HIST_CAP:
        sizes = impl.hist(lab, n_max + 1)
    else:
        sizes = torch.bincount(lab.reshape(-1).long(),
                               minlength=lab.numel() + 1)
    present = (sizes > 0).to(torch.int32)
    present[0] = 0
    rank = torch.cumsum(present, 0, dtype=torch.int32)  # rank[0] == 0
    return rank[lab.long()], rank[-1]


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
    def labels(cls, inst: torch.Tensor, tissue_mode, ds_factor=1.0,
               impl: Impl = KERNELS, mesh=None) -> torch.Tensor:
        """(H, W, n) INST channels on the device -> int32 labels. The
        sizes are not scaled by ``ds_factor`` (as in the JAX family)."""
        min_size, ksize = cls._SPEC[tissue_mode.upper()]
        fg = inst[..., 0].float().contiguous()
        if mesh is not None:
            return S.sharded_eroded_instances(fg, 0.5, min_size, ksize, mesh,
                                              impl)
        return _eroded_map_instances(fg, 0.5, min_size, ksize, impl)

    @classmethod
    def post_process(cls, raw_map: torch.Tensor, idx_dict, tissue_mode,
                     ds_factor=1.0, impl: Impl = KERNELS, mesh=None):
        """``raw_map``: (H, W, C) canvas tensor on the device. Returns
        (float64 inst_map, f32 type_map or None) as numpy."""
        s, e = idx_dict["%s-INST" % tissue_mode]
        lab = cls.labels(raw_map[..., s:e], tissue_mode, ds_factor, impl,
                         mesh)
        return _compact_labels(lab), _type_map(raw_map, idx_dict, tissue_mode)


class GPUPostProcInstErodedContourMap:
    _SPEC = {  # tissue -> (thresh, base_min_size, base_ksize)
        "GLAND": (0.55, 1000, 11),
        "LUMEN": (0.5, 150, 3),
    }

    @classmethod
    def labels(cls, inst: torch.Tensor, tissue_mode, ds_factor=1.0,
               impl: Impl = KERNELS, mesh=None) -> torch.Tensor:
        """(H, W, 2) INST channels (inner, contour) on the device -> int32
        labels: the nuclei watershed, or the gland/lumen family with its
        sizes scaled by ``ds_factor``."""
        inner = inst[..., 0].float().contiguous()
        cnt = inst[..., 1].float().contiguous()
        mode = tissue_mode.upper()
        if mode == "NUCLEI":
            if mesh is not None:
                return S.sharded_nuclei_watershed(inner, cnt, mesh, impl)
            return _nuclei_watershed(inner, cnt, impl)
        thresh, base_min, base_k = cls._SPEC[mode]
        min_size = int(base_min * ds_factor ** 2)
        ksize = int((base_k - 1) * ds_factor)
        if mesh is not None:
            return S.sharded_contour_instances(inner, cnt, thresh, min_size,
                                               ksize, mesh, impl)
        return _inner_contour_instances(inner, cnt, thresh, min_size, ksize,
                                        impl)

    @classmethod
    def post_process(cls, raw_map: torch.Tensor, idx_dict, tissue_mode,
                     ds_factor=1.0, impl: Impl = KERNELS, mesh=None):
        s, e = idx_dict["%s-INST" % tissue_mode]
        lab = cls.labels(raw_map[..., s:e], tissue_mode, ds_factor, impl,
                         mesh)
        return _compact_labels(lab), _type_map(raw_map, idx_dict, tissue_mode)


GPU_POSTPROC_FUNC_DICT = {
    "IP-ERODED-3": GPUPostProcInstErodedMap,
    "IP-ERODED-11": GPUPostProcInstErodedMap,
    "IP-ERODED-CONTOUR-3": GPUPostProcInstErodedContourMap,
    "IP-ERODED-CONTOUR-11": GPUPostProcInstErodedContourMap,
}
