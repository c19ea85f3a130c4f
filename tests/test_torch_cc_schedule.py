"""The schedule of ``csrc/cc_label.cu``, emulated in numpy on the CPU and
held against the JAX package's labelling.

The CUDA kernel labels each tile on its own in a shared-memory forest
(every pixel belongs to the start of its horizontal run, one union with the
row above per overlap segment), writes the tile roots as global flat
indices + 1 into the output plane, which from then on is the parent forest,
unites pixels across the top and left edge of every tile (skipping links
implied by the pixel before), and flattens. Unions link the larger root
under the smaller, so the labels must not depend on any order. This
emulation runs that schedule with the tiles, the unions inside a tile, the
border unions of the whole plane and the flattening all in seeded shuffled
orders, and must equal ``lax_postproc.connected_components`` exactly.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp

from cerberus_tpu.ops import lax_postproc as L
from test_torch_kernels import CC_CASES, _random_mask

# the kernel's tile shape (32 x 128), a square one (the schedule holds for
# any tile), and a small one so that the small planes span many tiles too
TILES = [(64, 64), (32, 128), (5, 7)]

EDGE_CASES = {
    "edge63x65": lambda: _random_mask(3, (63, 65)),
    "edge1x513": lambda: _random_mask(4, (1, 513), p=0.3),
    "edge513x1": lambda: _random_mask(5, (513, 1), p=0.3),
    "edge37x1029": lambda: _random_mask(6, (37, 1029)),
    "edge130x130": lambda: _random_mask(7, (130, 130)),
}
CASES = {**CC_CASES, **EDGE_CASES}


def _find(parent, x, off):
    """Root of x with path halving; ``parent[x] - off`` is x's parent."""
    p = parent[x] - off
    while p != x:
        gp = parent[p] - off
        if gp < p:
            parent[x] = min(parent[x], gp + off)
        x, p = p, gp
    return x


def _unite(parent, a, b, off):
    a, b = _find(parent, a, off), _find(parent, b, off)
    if a != b:
        parent[max(a, b)] = min(a, b) + off


def _label_tile(m, rng):
    """Tile-local roots (tile-row-major indices) of the bool tile ``m``."""
    th, tw = m.shape
    cols = np.arange(tw)
    left = np.zeros_like(m)
    left[:, 1:] = m[:, :-1]
    start = np.maximum.accumulate(np.where(m & ~left, cols, 0), axis=1)
    lab = (np.arange(th)[:, None] * tw + start).ravel()
    up = np.zeros_like(m)
    up[1:] = m[:-1]
    implied = np.zeros_like(m)
    implied[1:, 1:] = m[1:, :-1] & m[:-1, :-1]
    links = np.flatnonzero((m & up & ~implied).ravel())
    for p in rng.permutation(links):
        _unite(lab, p, p - tw, 0)
    while True:  # every pixel to its root
        nxt = lab[lab]
        if np.array_equal(nxt, lab):
            return lab.reshape(th, tw)
        lab = nxt


def cc_schedule(mask, tile, seed):
    rng = np.random.default_rng(seed)
    h, w = mask.shape
    th, tw = tile
    out = np.zeros(h * w, np.int64)  # parent's flat index + 1, 0 = background
    tiles = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    for i in rng.permutation(len(tiles)):
        y0, x0 = tiles[i]
        m = mask[y0:y0 + th, x0:x0 + tw]
        if not m.any():
            continue
        root = _label_tile(m, rng)
        glob = (y0 + root // m.shape[1]) * w + x0 + root % m.shape[1] + 1
        view = out.reshape(h, w)[y0:y0 + th, x0:x0 + tw]
        view[...] = np.where(m, glob, 0)
    fg = out.reshape(h, w) != 0
    links = []
    for y0, x0 in tiles:
        if y0 > 0:
            for x in range(x0, min(x0 + tw, w)):
                if fg[y0, x] and fg[y0 - 1, x] and not (
                        x > 0 and fg[y0, x - 1] and fg[y0 - 1, x - 1]):
                    links.append((y0 * w + x, (y0 - 1) * w + x))
        if x0 > 0:
            for y in range(y0, min(y0 + th, h)):
                if fg[y, x0] and fg[y, x0 - 1] and not (
                        y > y0 and fg[y - 1, x0] and fg[y - 1, x0 - 1]):
                    links.append((y * w + x0, y * w + x0 - 1))
    for i in rng.permutation(len(links)):
        _unite(out, *links[i], 1)
    for p in rng.permutation(np.flatnonzero(out)):
        out[p] = _find(out, out[p] - 1, 1) + 1
    return out.reshape(h, w).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _lax(case):
    return np.asarray(L.connected_components(jnp.asarray(CASES[case]())))


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cc_schedule_matches_lax(case, tile):
    mask = CASES[case]()
    got = cc_schedule(mask, tile, seed=len(case) + tile[0])
    np.testing.assert_array_equal(got, _lax(case))

