"""CPU instance-segmentation primitives (numpy/scipy; no skimage).

A copy of ``cerberus_tpu/ops/cc_cpu.py`` (``watershed``'s loop over flat
lists, same output): the host-side oracles that the
``--postproc_backend=cpu`` families (``ops/postproc.py``) run on, with the
semantics the reference gets from skimage/scipy:

  * ``label``: 4-connected components (scipy.ndimage.label default); also
    the tissue-mask regions of the WSI gland/lumen phase.
  * ``remove_small_objects``: drop components < min_size; accepts bool masks
    (labels internally, 4-connectivity, like skimage's connectivity=1
    default) or already-labeled int arrays.
  * ``binary_fill_holes``: scipy.ndimage.
  * ``watershed``: marker-based priority-flood identical to
    skimage.segmentation.watershed(image, markers, mask=mask,
    connectivity=1): pixels are popped in (value, insertion-order) priority,
    labels spread to unlabeled in-mask neighbors.
"""
from __future__ import annotations

import heapq

import numpy as np
from scipy import ndimage


def label(mask: np.ndarray):
    """4-connected component labeling; returns (labels int32, count)."""
    lab, num = ndimage.label(mask)
    return lab.astype(np.int32), num


def binary_fill_holes(mask: np.ndarray) -> np.ndarray:
    return ndimage.binary_fill_holes(mask)


def remove_small_objects(ar: np.ndarray, min_size: int) -> np.ndarray:
    """skimage-compatible: bool input -> bool output; labeled int input ->
    same dtype with small components zeroed. connectivity=1."""
    if min_size <= 0:
        return ar.copy()
    if ar.dtype == bool:
        lab, num = label(ar)
    else:
        lab, num = ar.astype(np.int64), int(ar.max())
    if num == 0:
        return ar.copy()
    sizes = np.bincount(lab.ravel(), minlength=num + 1)
    keep = sizes >= min_size
    keep[0] = True
    out = ar.copy()
    out[~keep[lab]] = 0 if ar.dtype != bool else False
    return out


def watershed(image: np.ndarray, markers: np.ndarray,
              mask: np.ndarray = None) -> np.ndarray:
    """Marker-based watershed by priority flood (4-connectivity).

    ``image`` is the topography (flood ascends values — pass the negated
    probability map, as the reference does at ``loader/postproc.py:378``);
    ``markers`` a labeled seed array; ``mask`` restricts the flooded region.
    Matches skimage's semantics: strict FIFO tie-break on equal elevation,
    neighbors enqueued with the elevation at the *neighbor* pixel.

    The JAX package's loop, over flat Python lists instead of numpy
    scalars: the heap keys (elevation, insertion count) are unique, so the
    pixels pop in the same order and the output is the same, several
    times faster (the ``cpu`` backend's nuclei tiles are flooded almost
    whole).
    """
    image = np.asarray(image)
    markers = np.asarray(markers)
    if mask is None:
        mask = np.ones(image.shape, bool)
    else:
        mask = np.asarray(mask).astype(bool)

    output = np.where(mask, markers, 0).astype(np.int32)
    h, w = image.shape
    elev = image.ravel().tolist()
    out = output.ravel().tolist()
    free = (mask & (output == 0)).ravel().tolist()
    # seed pixels enter in raster order, like skimage's flattened marker scan
    heap = [(elev[f], c, f)
            for c, f in enumerate(np.flatnonzero(output).tolist())]
    heapq.heapify(heap)
    counter = len(heap)
    pop, push = heapq.heappop, heapq.heappush
    while heap:
        _val, _cnt, f = pop(heap)
        lab_here = out[f]
        y, x = divmod(f, w)
        # up, down, left, right: the JAX loop's neighbour order
        for n in (f - w if y > 0 else -1, f + w if y < h - 1 else -1,
                  f - 1 if x > 0 else -1, f + 1 if x < w - 1 else -1):
            if n >= 0 and free[n]:
                free[n] = False
                out[n] = lab_here
                push(heap, (elev[n], counter, n))
                counter += 1
    return np.array(out, np.int32).reshape(h, w)
