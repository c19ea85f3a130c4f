"""The schedule of ``csrc/watershed.cu``'s flood, emulated in numpy on the
CPU and held against the JAX package's synchronous flood.

The CUDA kernel does not sweep synchronously: it relaxes (distance, label)
keys in place, tile by tile in whatever order its blocks run, resets every
distance to 0 at the start of a level, skips levels that no pixel enters,
and revisits a tile only when a neighbour changed a key on their shared
border. Its exactness rests on the (distance, label) fixed point being
order-free. This emulation runs that schedule with the tiles in a seeded
shuffled order, the pixels of a tile in a shuffled order, and each tile's
halo read either from the start of the pass or live (as racing blocks
would), and must equal ``lax_postproc.watershed`` and
``lax_postproc._propagate_labels`` exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from cerberus_tpu.ops import lax_postproc as L
from test_torch_kernels import WS_CASES, _ws_nuclei_like

NONE = np.iinfo(np.int64).max
STEP = 1 << 32
NEVER = 255
TILE = (4, 6)  # small, so the test planes span many tiles


def _tiles(h, w):
    th, tw = TILE
    return [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]


def _relax_tile(work, lvl_tile, lvl, rng):
    """In-place relaxation of the interior of ``work`` (tile plus 1 px
    halo) in shuffled pixel order, to the tile's fixed point."""
    th, tw = lvl_tile.shape
    pix = [(y, x) for y in range(th) for x in range(tw) if lvl_tile[y, x]
           <= lvl]
    while True:
        changed = False
        for i in rng.permutation(len(pix)):
            y, x = pix[i]
            k = work[y + 1, x + 1]
            if k >> 32 == 0:  # a seed
                continue
            m = min(work[y, x + 1], work[y + 2, x + 1], work[y + 1, x],
                    work[y + 1, x + 2])
            if m != NONE and m + STEP < k:
                work[y + 1, x + 1] = m + STEP
                changed = True
        if not changed:
            return


def flood_schedule(level, keys, n_levels, seed):
    """Runs the kernel's schedule on int64 ``keys`` ((distance << 32) |
    label, NONE for unlabelled) over uint8 ``level`` (NEVER outside).
    Returns the keys and the number of levels visited."""
    rng = np.random.default_rng(seed)
    h, w = level.shape
    th, tw = TILE
    tiles = _tiles(h, w)
    ti = {t: i for i, t in enumerate(tiles)}
    hist = np.bincount(level[level != NEVER].ravel(), minlength=n_levels)
    present = [set(np.unique(level[y:y + th, x:x + tw]).tolist())
               for y, x in tiles]
    stale = [False] * len(tiles)
    act = set()
    visited = 0
    for lvl in range(n_levels):
        if hist[lvl] == 0:
            continue  # nothing enters: the previous fixed point stands
        visited += 1
        first = True
        while True:
            start = keys.copy()
            nxt = set()
            for i in rng.permutation(len(tiles)):
                if not (i in act or (first and (stale[i]
                                                 or lvl in present[i]))):
                    continue
                y0, x0 = tiles[i]
                y1, x1 = min(y0 + th, h), min(x0 + tw, w)
                src = start if rng.random() < 0.5 else keys
                work = np.full((y1 - y0 + 2, x1 - x0 + 2), NONE, np.int64)
                ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
                work[ys - y0 + 1:min(y1 + 1, h) - y0 + 1,
                     xs - x0 + 1:min(x1 + 1, w) - x0 + 1] = \
                    src[ys:min(y1 + 1, h), xs:min(x1 + 1, w)]
                work[0, 0] = work[0, -1] = work[-1, 0] = work[-1, -1] = NONE
                orig = keys[y0:y1, x0:x1].copy()
                inner = orig.copy()
                if first:
                    lab = inner != NONE
                    inner[lab] &= 0xFFFFFFFF
                work[1:-1, 1:-1] = inner
                _relax_tile(work, level[y0:y1, x0:x1], lvl, rng)
                new = work[1:-1, 1:-1]
                keys[y0:y1, x0:x1] = new
                stale[i] = bool(((new != NONE) & (new >> 32 != 0)).any())
                diff = new != orig
                for side, (dy, dx) in ((diff[0].any(), (-th, 0)),
                                       (diff[-1].any(), (th, 0)),
                                       (diff[:, 0].any(), (0, -tw)),
                                       (diff[:, -1].any(), (0, tw))):
                    if side and (y0 + dy, x0 + dx) in ti:
                        nxt.add(ti[(y0 + dy, x0 + dx)])
            act = nxt
            first = False
            if not nxt:
                break
    return keys, visited


def _labels(keys):
    return np.where(keys == NONE, 0, keys & 0xFFFFFFFF).astype(np.int32)


def watershed_schedule(image, markers, mask, seed, n_levels=L.N_LEVELS):
    mask = mask.astype(bool)
    keys = np.where(mask & (markers != 0), markers.astype(np.int64), NONE)
    level = np.full(image.shape, NEVER, np.uint8)
    if mask.any():
        lo, hi = image[mask].min(), image[mask].max()
        span = np.maximum(hi - lo, np.float32(1e-6))
        top = np.float32(n_levels - 1)
        lv = ((image - lo) / span * top).astype(np.int32)
        level[mask] = np.clip(lv, 0, n_levels - 1)[mask]
    keys, visited = flood_schedule(level, keys, n_levels, seed)
    return np.where(mask, _labels(keys), 0), visited


def propagate_schedule(lab, allowed, seed):
    keys = np.where(lab != 0, lab.astype(np.int64), NONE)
    level = np.where(allowed, 0, NEVER).astype(np.uint8)
    return _labels(flood_schedule(level, keys, 1, seed)[0])


def _lax_watershed(image, markers, mask):
    return np.asarray(L.watershed(jnp.asarray(image), jnp.asarray(markers),
                                  jnp.asarray(mask)))


def _lax_propagate(lab, allowed):
    big = jnp.int32(lab.size + 2)
    return np.asarray(L._propagate_labels(jnp.asarray(lab),
                                          jnp.asarray(allowed), big))


def _plateau_case(seed):
    """A small quantised image (plateau ties, most of the 64 levels empty),
    a random mask and sparse markers, some outside the mask."""
    rng = np.random.default_rng(1000 + seed)
    h, w = (int(v) for v in rng.integers(3, 41, 2))
    image = rng.integers(0, int(rng.choice([1, 2, 3, 5, 9])),
                         (h, w)).astype(np.float32)
    mask = rng.random((h, w)) < rng.uniform(0.5, 1.0)
    markers = np.where(rng.random((h, w)) < rng.uniform(0.01, 0.08),
                       rng.integers(1, h * w + 2, (h, w)), 0).astype(np.int32)
    return image, markers, mask


def _special(name):
    image, markers, mask = _plateau_case(7)
    if name == "constant":
        image = np.full_like(image, 0.25)
    elif name == "empty_mask":
        mask = np.zeros_like(mask)
    elif name == "no_markers":
        markers = np.zeros_like(markers)
    elif name == "markers_outside_mask":
        markers = np.where(mask, 0, markers).astype(np.int32)
        markers[0, 0], mask[0, 0] = 5, False
    return image, markers, mask


@pytest.mark.parametrize("case", sorted(WS_CASES))
def test_schedule_watershed_ws_cases(case):
    image, markers, mask = WS_CASES[case]()
    got, visited = watershed_schedule(image, markers, mask, seed=0)
    np.testing.assert_array_equal(got, _lax_watershed(image, markers, mask))
    assert visited <= L.N_LEVELS


@pytest.mark.parametrize("seed", range(30))
def test_schedule_watershed_plateaus(seed):
    image, markers, mask = _plateau_case(seed)
    got, visited = watershed_schedule(image, markers, mask, seed)
    np.testing.assert_array_equal(got, _lax_watershed(image, markers, mask))
    # quantised images leave most levels empty, and those are skipped
    assert visited <= len(np.unique(image[mask])) if mask.any() else \
        visited == 0


@pytest.mark.parametrize("name", ["constant", "empty_mask", "no_markers",
                                  "markers_outside_mask"])
def test_schedule_watershed_edge_cases(name):
    image, markers, mask = _special(name)
    got, _ = watershed_schedule(image, markers, mask, seed=3)
    np.testing.assert_array_equal(got, _lax_watershed(image, markers, mask))


@pytest.mark.parametrize("seed", range(10))
def test_schedule_propagate_plateaus(seed):
    _, lab, allowed = _plateau_case(100 + seed)
    got = propagate_schedule(lab, allowed, seed)
    np.testing.assert_array_equal(got, _lax_propagate(lab, allowed))


def test_schedule_propagate_nuclei_like():
    _, markers, mask = _ws_nuclei_like(seed=9)
    got = propagate_schedule(markers, mask, seed=1)
    np.testing.assert_array_equal(got, _lax_propagate(markers, mask))


def test_one_key_across_levels_is_not_the_schedule():
    """Dropping the per-level distance reset (one relaxation over the whole
    level order) is not exact: on these plateau cases it differs."""
    differs = 0
    for seed in range(40):
        image, markers, mask = _plateau_case(seed)
        ref = _lax_watershed(image, markers, mask)
        keys = np.where(mask & (markers != 0), markers.astype(np.int64),
                        NONE)
        if not mask.any():
            continue
        lo, hi = image[mask].min(), image[mask].max()
        span = np.maximum(hi - lo, np.float32(1e-6))
        lv = np.clip(((image - lo) / span * np.float32(63)).astype(np.int32),
                     0, 63)
        # key (level entered, distance, label): a pixel's level is the
        # earliest it may flood, distance counted from the level's seeds
        level = np.where(mask, lv, NEVER).astype(np.uint8)
        got = _one_key(level, keys)
        differs += int(not np.array_equal(np.where(mask, got, 0), ref))
    assert differs > 0


def _one_key(level, keys):
    """Relaxation of a single key per pixel across all levels: key =
    (level of the pixel, distance, label) minimised by neighbour + 1."""
    h, w = level.shape
    key = {}
    for y in range(h):
        for x in range(w):
            if keys[y, x] != NONE:
                key[y, x] = (0, 0, int(keys[y, x]))
    changed = True
    while changed:
        changed = False
        for y in range(h):
            for x in range(w):
                if level[y, x] == NEVER or (y, x) in key and \
                        key[y, x][1] == 0 and key[y, x][0] == 0:
                    continue
                best = key.get((y, x))
                for qy, qx in ((y - 1, x), (y + 1, x), (y, x - 1),
                               (y, x + 1)):
                    q = key.get((qy, qx))
                    if q is None:
                        continue
                    lv = max(q[0], int(level[y, x]))
                    cand = (lv, q[1] + 1 if lv == q[0] else 1, q[2])
                    if best is None or cand < best:
                        best = cand
                if best is not None and best != key.get((y, x)):
                    key[y, x] = best
                    changed = True
    out = np.zeros((h, w), np.int32)
    for (y, x), k in key.items():
        out[y, x] = k[2]
    return out
