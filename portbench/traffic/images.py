"""Seeded inputs: H&E-sized noise images with flat discs, tissue masks,
Aperio-style ``.svs`` slides with JPEG tiles, and PNG regions.

The image recipe is the one the port's chip smoke uses (seeded noise with
one flat-coloured disc per 4000 px); the slide writer is its minimal
tiled little-endian TIFF with an Aperio ``ImageDescription``. The slide
writer returns the pixels a JPEG decoder gives back for the tiles it
wrote, which is what both the program and the reference are handed.
"""
from __future__ import annotations

import struct

import numpy as np


def synthetic_image(hw, rng: np.random.Generator) -> np.ndarray:
    """(h, w, 3) uint8: uniform noise and one flat disc (radius 4-39,
    drawn by cv2) per 4000 px."""
    import cv2

    h, w = int(hw[0]), int(hw[1])
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    n = h * w // 4000
    cy = rng.integers(0, h, n)
    cx = rng.integers(0, w, n)
    rad = rng.integers(4, 40, n)
    colours = rng.integers(0, 255, (n, 3))
    for y, x, r, c in zip(cy.tolist(), cx.tolist(), rad.tolist(),
                          colours.tolist()):
        cv2.circle(img, (x, y), r, c, -1)
    return img


def tissue_mask(hw, ellipses) -> np.ndarray:
    """(h, w) uint8 0/1: the union of ``ellipses``, each
    ``[cy, cx, ry, rx]`` as fractions of the mask's height and width."""
    h, w = int(hw[0]), int(hw[1])
    yy, xx = np.ogrid[:h, :w]
    mask = np.zeros((h, w), bool)
    for cy, cx, ry, rx in ellipses:
        mask |= (((yy - cy * h) / (ry * h)) ** 2
                 + ((xx - cx * w) / (rx * w)) ** 2) <= 1.0
    return mask.astype(np.uint8)


def write_svs(path: str, img: np.ndarray, tile: int = 256,
              quality: int = 90, mpp: float = 0.5) -> np.ndarray:
    """Write ``img`` (RGB uint8) as one-level tiled TIFF with JPEG tiles
    (compression 7, YCbCr, ``quality``) and the Aperio description
    ``|MPP = <mpp>|``. Returns the (h, w, 3) RGB pixels the tiles decode
    to."""
    import cv2

    from concurrent.futures import ThreadPoolExecutor

    h, w = img.shape[:2]
    decoded = np.zeros_like(img)
    out = bytearray(b"II" + struct.pack("<HI", 42, 0))

    def align():
        if len(out) % 2:
            out.extend(b"\0")

    def code(origin):
        """One tile's JPEG bytes; its decoded pixels land in ``decoded``
        (cv2 releases the interpreter lock: tiles code in parallel)."""
        y, x = origin
        t = np.zeros((tile, tile, 3), np.uint8)
        sub = img[y:y + tile, x:x + tile]
        t[:sub.shape[0], :sub.shape[1]] = sub
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(t[..., ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        if not ok:
            raise RuntimeError("cv2 could not encode a JPEG tile")
        back = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
        decoded[y:y + tile, x:x + tile] = back[:sub.shape[0], :sub.shape[1]]
        return enc.tobytes()

    origins = [(ty * tile, tx * tile) for ty in range(-(-h // tile))
               for tx in range(-(-w // tile))]
    with ThreadPoolExecutor(max_workers=8) as pool:
        tiles = list(pool.map(code, origins))
    offsets, counts = [], []
    for data in tiles:
        align()
        offsets.append(len(out))
        counts.append(len(data))
        out.extend(data)
    description = ("Aperio |MPP = %g|" % mpp).encode() + b"\0"
    entries = sorted([(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
                      (259, 3, [7]), (262, 3, [6]), (277, 3, [3]),
                      (322, 4, [tile]), (323, 4, [tile]),
                      (324, 4, offsets), (325, 4, counts),
                      (270, 2, list(description))])
    packed = []
    for tag, vtype, vals in entries:
        data = (bytes(vals) if vtype == 2 else struct.pack(
            "<" + {3: "H", 4: "I"}[vtype] * len(vals), *vals))
        if len(data) > 4:
            align()
            field = struct.pack("<I", len(out))
            out.extend(data)
        else:
            field = data + b"\0" * (4 - len(data))
        packed.append(struct.pack("<HHI", tag, vtype, len(vals)) + field)
    align()
    struct.pack_into("<I", out, 4, len(out))
    out.extend(struct.pack("<H", len(packed)) + b"".join(packed)
               + b"\0\0\0\0")
    with open(path, "wb") as handle:
        handle.write(out)
    return decoded


def write_png(path: str, img: np.ndarray) -> None:
    """RGB uint8 -> a PNG (lossless: what is read back is ``img``)."""
    import cv2

    if not cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1])):
        raise RuntimeError("cv2 could not write %s" % path)
