"""Automatic tissue masking: stain-entropy Otsu segmentation.

Behavioral spec (reference ``misc/utils.py:195-244``): RGB -> HED color
deconvolution, disk-4 local entropy of H + E - D, Otsu threshold, then
morphological cleanup (erode disk-3, remove small holes/objects >= 2000,
dilate, fill holes). skimage is not available in this environment, so the
pieces are implemented directly:

  * HED deconvolution with the Ruifrok-Johnston matrix (skimage-compatible
    normalization);
  * local entropy via per-bin box counting with a disk kernel (cv2.filter2D
    over a quantized image — runs on thumbnails, so 64 passes are cheap);
  * Otsu as the classic between-class-variance maximizer.

A copy of ``cerberus_tpu/ops/tissue_mask.py``; cv2 is imported inside
``local_entropy``, its only user.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

from .cc_cpu import label as cc_label

# rgb_from_hed (Ruifrok & Johnston), rows are H, E, DAB stain vectors
RGB_FROM_HED = np.array([
    [0.65, 0.70, 0.29],
    [0.07, 0.99, 0.11],
    [0.27, 0.57, 0.78],
])
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: euclidean ball of given radius."""
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return (yy ** 2 + xx ** 2 <= radius ** 2).astype(np.uint8)


def rgb2hed(img: np.ndarray) -> np.ndarray:
    """RGB uint8/float -> HED stain space (skimage-compatible)."""
    rgb = img.astype(np.float64)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    np.maximum(rgb, 1e-6, out=rgb)
    log_adjust = np.log(1e-6)
    stains = (np.log(rgb) / log_adjust) @ HED_FROM_RGB
    return np.maximum(stains, 0)


def local_entropy(img: np.ndarray, selem: np.ndarray,
                  n_bins: int = 64) -> np.ndarray:
    """Entropy (bits) of the local value histogram under ``selem``.

    Matches skimage.filters.rank.entropy semantics up to the quantization
    of the 256 gray levels into ``n_bins`` (the masks are thresholded with
    Otsu afterwards, so fine histogram resolution is immaterial)."""
    import cv2

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    q = (img.astype(np.int32) * n_bins) // 256
    kernel = selem.astype(np.float32)
    total = float(kernel.sum())
    ent = np.zeros(img.shape, np.float64)
    for b in range(n_bins):
        count = cv2.filter2D((q == b).astype(np.float32), -1, kernel,
                             borderType=cv2.BORDER_REFLECT)
        p = count / total
        with np.errstate(divide="ignore", invalid="ignore"):
            contrib = -p * np.log2(p)
        ent += np.where(p > 0, contrib, 0.0)
    return ent


def threshold_otsu(values: np.ndarray, n_bins: int = 256) -> float:
    hist, bin_edges = np.histogram(values.ravel(), bins=n_bins)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    mean1 = np.cumsum(hist * centers) / np.maximum(weight1, 1)
    mean2 = (np.cumsum((hist * centers)[::-1]) /
             np.maximum(weight2[::-1], 1))[::-1]
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    idx = int(np.argmax(variance12))
    return float(centers[idx])


def stain_entropy_otsu(img: np.ndarray) -> np.ndarray:
    """H+E entropy minus DAB entropy, Otsu-thresholded (misc/utils.py:195-213)."""
    hed = (rgb2hed(img) * 255).astype(np.uint8)
    selem = disk(4)
    h_ent = local_entropy(hed[..., 0], selem)
    e_ent = local_entropy(hed[..., 1], selem)
    d_ent = local_entropy(hed[..., 2], selem)
    entropy = h_ent + e_ent - d_ent
    return entropy > threshold_otsu(entropy)


def _remove_small_holes(mask: np.ndarray, area_threshold: int) -> np.ndarray:
    inv = ~mask
    lab, num = cc_label(inv)
    if num == 0:
        return mask
    sizes = np.bincount(lab.ravel(), minlength=num + 1)
    fill = sizes < area_threshold
    fill[0] = False
    return mask | fill[lab]


def _remove_small_objects(mask: np.ndarray, min_size: int) -> np.ndarray:
    lab, num = cc_label(mask)
    if num == 0:
        return mask
    sizes = np.bincount(lab.ravel(), minlength=num + 1)
    keep = sizes >= min_size
    keep[0] = False
    return keep[lab]


def morphology(mask: np.ndarray) -> np.ndarray:
    """Cleanup pass (misc/utils.py:216-235)."""
    selem = disk(3)
    mask = ndimage.binary_erosion(mask, selem)
    mask = _remove_small_holes(mask, 2000)
    mask = _remove_small_objects(mask, 2000)
    mask = ndimage.binary_dilation(mask, selem)
    mask = _remove_small_holes(mask, 2000)
    return ndimage.binary_fill_holes(mask)


def get_tissue_mask(img: np.ndarray) -> np.ndarray:
    """Thumbnail RGB -> uint8 tissue mask (misc/utils.py:238-244)."""
    mask = stain_entropy_otsu(img)
    mask = morphology(mask)
    return mask.astype("uint8")
