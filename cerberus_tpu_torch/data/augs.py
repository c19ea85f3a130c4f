"""Photometric / shape-fix augmentations (host-side numpy/cv2).

A copy of ``cerberus_tpu/data/augs.py`` with cv2 and scipy imported inside
the functions that use them; the same ``np.random.Generator`` draws give
the same bytes.

Behavioral parity with ``loader/augs.py``: instance relabeling after mirror
padding (:7-22), gaussian/median blur (:25-43), hue/saturation/contrast/
brightness jitter (:46-86). API is plain ``fn(img, rng, **kw) -> img``
instead of the imgaug callback signature. The reference's ``add_to_contrast``
clips the *input* instead of the adjusted image (:76), silently disabling the
augmentation — fixed here (deliberate divergence, SURVEY.md §7 bug list).
"""
from __future__ import annotations

import numpy as np


def fix_mirror_padding(ann: np.ndarray) -> np.ndarray:
    """Split instances duplicated by reflect padding into fresh ids."""
    from scipy import ndimage

    current_max_id = np.amax(ann)
    inst_ids = np.unique(ann)
    inst_ids = inst_ids[inst_ids != 0]
    for inst_id in inst_ids:
        remapped, n = ndimage.label(ann == inst_id)
        if n <= 1:
            continue
        sel = remapped > 1
        ann[sel] = remapped[sel] + current_max_id
        current_max_id = np.amax(ann)
    return ann


def gaussian_blur(img: np.ndarray, rng: np.random.Generator,
                  max_ksize: int = 3) -> np.ndarray:
    import cv2

    ksize = rng.integers(0, max_ksize, size=(2,))
    ksize = tuple((ksize * 2 + 1).tolist())
    ret = cv2.GaussianBlur(img, ksize, sigmaX=0, sigmaY=0,
                           borderType=cv2.BORDER_REPLICATE)
    return ret.reshape(img.shape).astype(np.uint8)


def median_blur(img: np.ndarray, rng: np.random.Generator,
                max_ksize: int = 3) -> np.ndarray:
    import cv2

    ksize = int(rng.integers(0, max_ksize)) * 2 + 1
    return cv2.medianBlur(img, ksize).astype(np.uint8)


def add_to_hue(img: np.ndarray, rng: np.random.Generator,
               range=(-8, 8)) -> np.ndarray:
    import cv2

    hue = rng.uniform(*range)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    if hsv.dtype.itemsize == 1:
        hsv[..., 0] = (hsv[..., 0] + hue) % 180
    else:
        hsv[..., 0] = (hsv[..., 0] + 2 * hue) % 360
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.uint8)


def add_to_saturation(img: np.ndarray, rng: np.random.Generator,
                      range=(-0.2, 0.2)) -> np.ndarray:
    import cv2

    value = 1 + rng.uniform(*range)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    ret = img * value + (gray * (1 - value))[:, :, np.newaxis]
    return np.clip(ret, 0, 255).astype(np.uint8)


def add_to_contrast(img: np.ndarray, rng: np.random.Generator,
                    range=(0.75, 1.25)) -> np.ndarray:
    value = rng.uniform(*range)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    ret = img * value + mean * (1 - value)
    return np.clip(ret, 0, 255).astype(np.uint8)


def add_to_brightness(img: np.ndarray, rng: np.random.Generator,
                      range=(-26, 26)) -> np.ndarray:
    value = rng.uniform(*range)
    return np.clip(img.astype(np.float64) + value, 0, 255).astype(np.uint8)
