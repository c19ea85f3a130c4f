"""Window and tile placement, worked out again from the inputs: the
reference's own copy of the published placement rules (the WSI engine's
sliding-window grid at stride = output window, the output windows kept
where the tissue mask touches them, the square post-processing grid of
``tile_shape`` floored to a multiple of the output window, and the tile
engine's reflect-padded window grid)."""
from __future__ import annotations

import math

import numpy as np


def _starts(length: int, window: int, stride: int) -> np.ndarray:
    if length <= window:
        return np.array([0], np.int64)
    last = int(math.ceil((length - window) / stride)) * stride
    return np.arange(0, last + 1, stride, dtype=np.int64)


def slide_windows(w: int, h: int, win_in: int, win_out: int, mask
                  ) -> np.ndarray:
    """(N, 2) output-window top-lefts (x, y) of a w x h slide whose
    output windows touch tissue in ``mask`` (any resolution, same
    extent); the input window is centred on each."""
    xs, ys = _starts(w, win_out, win_out), _starts(h, win_out, win_out)
    xx, yy = np.meshgrid(xs, ys)
    tl = np.stack([xx.ravel(), yy.ravel()], 1)
    m = (np.asarray(mask) > 0).astype(np.int64)
    mh, mw = m.shape
    integral = np.zeros((mh + 1, mw + 1), np.int64)
    integral[1:, 1:] = m.cumsum(0).cumsum(1)
    sx, sy = mw / float(w), mh / float(h)
    x0 = np.clip(np.floor(tl[:, 0] * sx).astype(np.int64), 0, mw)
    y0 = np.clip(np.floor(tl[:, 1] * sy).astype(np.int64), 0, mh)
    x1 = np.clip(np.ceil((tl[:, 0] + win_out) * sx).astype(np.int64), 0, mw)
    y1 = np.clip(np.ceil((tl[:, 1] + win_out) * sy).astype(np.int64), 0, mh)
    x1 = np.maximum(x1, x0 + 1).clip(max=mw)
    y1 = np.maximum(y1, y0 + 1).clip(max=mh)
    x0, y0 = np.minimum(x0, mw - 1), np.minimum(y0, mh - 1)
    tissue = (integral[y1, x1] - integral[y0, x1] - integral[y1, x0]
              + integral[y0, x0]) > 0
    return tl[tissue]


def grid_tiles(w: int, h: int, tile_shape: int, win_out: int) -> np.ndarray:
    """(T, 4) XY bounds of the post-processing grid's tiles, clipped."""
    t = max(int(tile_shape) // win_out * win_out, win_out)
    xs, ys = _starts(w, t, t), _starts(h, t, t)
    xx, yy = np.meshgrid(xs, ys)
    x0, y0 = xx.ravel(), yy.ravel()
    return np.stack([x0, y0, np.minimum(x0 + t, w), np.minimum(y0 + t, h)],
                    1).astype(np.int64)


def pad512(n: int, win_out: int) -> int:
    """The extent a grid tile's nuclei plane is zero-padded to: the tile
    rounded up to whole output windows, then to a multiple of 512."""
    n = -(-int(n) // win_out) * win_out
    return max(-(-n // 512) * 512, 512)


def tile_windows(img: np.ndarray, win_in: int, win_out: int):
    """The tile engine's grid on an (h, w, 3) image: (the image
    reflect-padded by (win_in - win_out) // 2 on top and left and up to
    whole windows plus that margin on the bottom and right, (N, 2)
    input-window top-lefts (y, x) in it). The output window of the input
    window at (y, x) covers the image's [y, y + win_out) x [x, x +
    win_out)."""
    def last(length):
        return int((math.ceil((length - win_out) / win_out) + 1) * win_out)

    h, w = img.shape[:2]
    lh, lw = last(h), last(w)
    pad = (win_in - win_out) // 2
    padded = np.pad(img, ((pad, lh + win_in - h), (pad, lw + win_in - w),
                          (0, 0)), "reflect")
    yy, xx = np.meshgrid(np.arange(0, lh, win_out),
                         np.arange(0, lw, win_out))
    tl = np.stack([yy.ravel(), xx.ravel()], 1)
    keep = ~np.any(tl + win_in > np.array(padded.shape[:2]), 1)
    return padded, tl[keep]
