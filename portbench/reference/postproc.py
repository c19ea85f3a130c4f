"""Plain nuclei instance post-processing and the instance records it
implies, from the published contract of the IP-ERODED-CONTOUR family:

* the mask: ``inner + contour > 0.5``, eroded by the 3x3 cross with the
  image border counting as foreground, 4-connected components of fewer
  than 8 px dropped;
* the markers: ``inner > 0.5``, components of fewer than 4 px dropped,
  holes (background components not touching the border) filled, then
  labelled 4-connected in raster order;
* a marker watershed of ``-inner`` inside the mask with 64 elevation
  levels (``level = int((e - lo) / max(hi - lo, 1e-6) * 63)`` over the
  mask's range, in float32): at each level every unlabelled mask pixel at
  or below it takes the smallest 4-neighbour label, all at once, until
  nothing changes; a label is never overwritten.

Records: an instance's box [x0, y0, x1, y1] (exclusive ends) and centroid
(the mean pixel position, x then y); an instance whose outer contour
(cv2, simplified) has fewer than 3 points has no record. At a scale
``ds`` the box and centroid are divided by it and rounded half to even.

The gland and lumen family (IP-ERODED-CONTOUR, at scale ``ds``):

* the foreground ``inner - (contour > 0.5) > thresh`` (gland 0.55,
  lumen 0.5), 4-connected components of fewer than ``int(base * ds**2)``
  px dropped (gland 1000, lumen 150), the rest numbered in raster order;
* a grey-level max dilation of the ids by cv2's elliptical element of
  size ``int((k - 1) * ds)`` (gland k = 11, lumen 3), anchored at
  ``size // 2``, reading 0 outside the plane;
* holes (background 4-components not touching the border) flooded from
  their neighbours, every unlabelled pixel taking the smallest
  neighbouring id at each step;
* ids compacted to 1..n in ascending order; lumen ids kept only where a
  gland is.

The components and holes run in scipy, the floods in plain torch on the
given device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy import ndimage

N_LEVELS = 64
CROSS = ndimage.generate_binary_structure(2, 1)


def _drop_small(mask: np.ndarray, min_size: int) -> np.ndarray:
    lab, _ = ndimage.label(mask, CROSS)
    sizes = np.bincount(lab.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[lab]


def _neighbour_min(work: torch.Tensor, big: int) -> torch.Tensor:
    p = torch.full((work.shape[0] + 2, work.shape[1] + 2), big,
                   dtype=work.dtype, device=work.device)
    p[1:-1, 1:-1] = work
    return torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                         torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))


def _flood(work: torch.Tensor, allowed: torch.Tensor, big: int
           ) -> torch.Tensor:
    """Unlabelled (``big``) pixels of ``allowed`` take their smallest
    4-neighbour label, all at once, until nothing changes."""
    while True:
        prev = work
        for _ in range(8):
            cand = _neighbour_min(work, big)
            work = torch.where(allowed & (work == big), cand, work)
        if torch.equal(work, prev):
            return work


def watershed(elevation: np.ndarray, markers: np.ndarray, mask: np.ndarray,
              device) -> np.ndarray:
    """The 64-level marker watershed (module docstring); int64 labels."""
    out = np.zeros(mask.shape, np.int64)
    if not mask.any():
        return out
    rows, cols = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    y0, y1, x0, x1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    big = int(mask.size) + 2
    e = torch.from_numpy(np.ascontiguousarray(
        elevation[y0:y1, x0:x1], np.float32)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(mask[y0:y1, x0:x1])).to(device)
    mk = torch.from_numpy(markers[y0:y1, x0:x1].astype(np.int64)).to(device)
    work = torch.where(m & (mk > 0), mk, torch.full_like(mk, big))
    lo, hi = e[m].min(), e[m].max()
    span = torch.clamp(hi - lo, min=1e-6)
    level = ((e - lo) / span * (N_LEVELS - 1)).to(torch.int32).clamp(
        0, N_LEVELS - 1)
    for lvl in range(N_LEVELS):
        work = _flood(work, m & (level <= lvl), big)
    work = torch.where(work == big, torch.zeros_like(work), work)
    out[y0:y1, x0:x1] = work.cpu().numpy()
    return out


def nuclei_labels(inner: np.ndarray, contour: np.ndarray, device
                  ) -> np.ndarray:
    """(H, W) float32 INST probabilities (inner, contour) -> int64 labels."""
    inner = np.asarray(inner, np.float32)
    contour = np.asarray(contour, np.float32)
    mask = ndimage.binary_erosion((inner + contour) > 0.5, CROSS,
                                  border_value=1)
    mask = _drop_small(mask, 8)
    markers = ndimage.binary_fill_holes(_drop_small(inner > 0.5, 4), CROSS)
    markers, _ = ndimage.label(markers, CROSS)
    return watershed(-inner, markers, mask, device)


def compact(labels: np.ndarray) -> np.ndarray:
    """Ids renumbered 1..n in ascending order, 0 kept."""
    ids, inverse = np.unique(labels, return_inverse=True)
    rank = np.arange(len(ids)) + (0 if ids[0] == 0 else 1)
    return rank[inverse].reshape(labels.shape)


def dilate_ids(labels: np.ndarray, ksize: int) -> np.ndarray:
    """Grey-level max dilation by cv2's elliptical element of ``ksize``,
    anchored at ``ksize // 2``; 0 outside the plane."""
    import cv2

    if ksize <= 0:
        return labels
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    h, w = labels.shape
    padded = np.pad(labels, ksize)
    out = labels
    for i, j in np.argwhere(se > 0):
        dy, dx = int(i) - ksize // 2, int(j) - ksize // 2
        out = np.maximum(out, padded[ksize + dy:ksize + dy + h,
                                     ksize + dx:ksize + dx + w])
    return out


def fill_id_holes(labels: np.ndarray, device) -> np.ndarray:
    """Holes (background 4-components not touching the border) flooded
    from the instances around them, the smallest id first."""
    bg = np.pad(labels == 0, 1, constant_values=True)
    comp, _ = ndimage.label(bg, CROSS)
    holes = (comp != comp[0, 0])[1:-1, 1:-1]
    if not holes.any():
        return labels
    big = int(labels.max()) + 1
    lab = torch.from_numpy(labels.astype(np.int64)).to(device)
    work = torch.where(lab > 0, lab, torch.full_like(lab, big))
    work = _flood(work, torch.from_numpy(holes).to(device), big)
    return torch.where(work == big, torch.zeros_like(work),
                       work).cpu().numpy()


FAMILY = {"gland": (0.55, 1000, 11), "lumen": (0.5, 150, 3)}


def contour_labels(inner: np.ndarray, contour: np.ndarray, tissue: str,
                   ds: float, device) -> np.ndarray:
    """The gland or lumen family at scale ``ds`` (module docstring) on
    (H, W) float32 INST probabilities; compacted int64 ids."""
    thresh, base_min, base_k = FAMILY[tissue]
    inner = np.asarray(inner, np.float32)
    fg = (inner - (np.asarray(contour) > 0.5).astype(np.float32)) > thresh
    lab, _ = ndimage.label(fg, CROSS)
    sizes = np.bincount(lab.ravel())
    keep = sizes >= int(base_min * ds ** 2)
    keep[0] = False
    lab = np.where(keep[lab], lab, 0).astype(np.int64)
    lab = dilate_ids(lab, int((base_k - 1) * ds))
    return compact(fill_id_holes(lab, device))


def tissue_regions(mask: np.ndarray, proc_hw) -> List[Tuple]:
    """The tissue mask's 4-connected regions, in raster order: their
    (x0, y0, x1, y1) bounds at the processing resolution (the mask box
    scaled, rounded, clipped) and the region's own mask resized to them
    (nearest neighbour)."""
    import cv2

    lab, _ = ndimage.label(np.asarray(mask) > 0, CROSS)
    ratio = lab.shape[0] / proc_hw[0]
    out = []
    for i, slc in enumerate(ndimage.find_objects(lab), start=1):
        if slc is None:
            continue
        y0, x0 = int(round(slc[0].start / ratio)), int(round(
            slc[1].start / ratio))
        y1 = min(int(round(slc[0].stop / ratio)), int(proc_hw[0]))
        x1 = min(int(round(slc[1].stop / ratio)), int(proc_hw[1]))
        own = cv2.resize((lab[slc] == i).astype(np.uint8), (x1 - x0, y1 - y0),
                         interpolation=cv2.INTER_NEAREST)
        out.append(((x0, y0, x1, y1), own))
    return out


def region_plane(canvas, bounds, own_mask, channels, ds: float
                 ) -> np.ndarray:
    """A tissue region's ``channels`` of the (H, W, C) canvas as float32,
    zero outside the region's own mask, resized by ``ds`` (cv2 linear)."""
    import cv2

    x0, y0, x1, y1 = bounds
    plane = np.asarray(canvas[y0:y1, x0:x1][..., list(channels)], np.float32)
    plane = plane * own_mask[..., None]
    out = cv2.resize(plane, (int(round((x1 - x0) * ds)),
                             int(round((y1 - y0) * ds))),
                     interpolation=cv2.INTER_LINEAR)
    return out if out.ndim == 3 else out[..., None]


def pad_512(plane: np.ndarray) -> np.ndarray:
    """Zero-padded up to multiples of 512 rows and columns."""
    h, w = plane.shape[:2]
    pad = [(0, -(-h // 512) * 512 - h), (0, -(-w // 512) * 512 - w)]
    return np.pad(plane, pad + [(0, 0)] * (plane.ndim - 2))


def records(labels: np.ndarray, offset_xy=(0, 0), ds: float = 1.0
            ) -> List[Tuple]:
    """(x0, y0, x1, y1, cx, cy) of every instance with a record, in slide
    coordinates: at scale ``ds`` divided by it and rounded half to even,
    then ``offset_xy`` added."""
    import cv2

    ox, oy = offset_xy
    out = []
    for i, slc in enumerate(ndimage.find_objects(labels), start=1):
        if slc is None:
            continue
        single = (labels[slc] == i).astype(np.uint8)
        contours = cv2.findContours(single, cv2.RETR_TREE,
                                    cv2.CHAIN_APPROX_SIMPLE)[0]
        pts = np.squeeze(contours[0])
        if pts.ndim != 2 or pts.shape[0] < 3:
            continue
        ys, xs = np.nonzero(single)
        rec = np.array([slc[1].start, slc[0].start, slc[1].stop,
                        slc[0].stop, xs.mean() + slc[1].start,
                        ys.mean() + slc[0].start])
        if ds != 1.0:
            rec = np.round(rec / ds)
        out.append(tuple(float(v) for v in rec + [ox, oy, ox, oy, ox, oy]))
    return out


def unmatched(ref: List[Tuple], got: List[Tuple], tol: float = 1e-6
              ) -> Tuple[int, int]:
    """(records of ``ref`` with no equal box and centroid within ``tol``
    px in ``got``, and the other way round)."""
    def key(r):
        return tuple(int(v) for v in r[:4])

    pool: Dict[tuple, List] = {}
    for r in got:
        pool.setdefault(key(r), []).append(r)
    missing = 0
    for r in ref:
        cands = pool.get(key(r), [])
        hit = next((c for c in cands if abs(c[4] - r[4]) <= tol
                    and abs(c[5] - r[5]) <= tol), None)
        if hit is None:
            missing += 1
        else:
            cands.remove(hit)
    return missing, sum(len(v) for v in pool.values())
