"""Row-sharded CC, watershed and families (``cerberus_tpu_torch.ops.
sharded_cc``) against the JAX package's ``cerberus_tpu.ops.sharded_cc`` on
the CPU, byte for byte.

The port's mesh lists the CPU k times (strips labelled one after another by
the kernels' plain versions); JAX's is ``conftest.cpu_mesh_devices()[:k]``.
CC must also equal the single-device labels; the sharded watershed equals
JAX's SHARDED watershed, whose plateau ties at strip boundaries may go to
the other basin than the single-device one's (asserted on a seeded case).
"""
import numpy as np
import pytest
import torch

import conftest

import jax.numpy as jnp

from cerberus_tpu.ops import lax_postproc as L
from cerberus_tpu.ops import sharded_cc as JS
from cerberus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cerberus_tpu_torch.ops import gpu_postproc as G
from cerberus_tpu_torch.ops import sharded_cc as S
from cerberus_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

MESH_SIZES = [2, 4, 8]


def _meshes(k):
    return (make_mesh([torch.device("cpu")] * k),
            jax_make_mesh(conftest.cpu_mesh_devices()[:k], JS.AXIS))


def _single(mask):
    return np.asarray(L.connected_components(jnp.asarray(mask)))


def _spiral(n):
    mask = np.zeros((n, n), bool)
    t, l, b, r = 0, 0, n - 1, n - 1
    while t <= b and l <= r:
        mask[t, l:r + 1] = mask[b, l:r + 1] = True
        mask[t:b + 1, r] = True
        mask[t + 2:b + 1, l] = True
        if t + 2 <= b:
            mask[t + 2, l:r - 1] = True
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    return mask


def _bar_and_blobs(k):
    """One bar through every strip of a k-strip 64-row plane and one blob
    inside each strip."""
    mask = np.zeros((64, 32), bool)
    mask[:, 5] = True
    rows = 64 // k
    for s in range(k):
        mask[s * rows + 1: s * rows + rows - 1, 20:25] = True
    return mask


@pytest.mark.parametrize("k", MESH_SIZES)
def test_cc_matches_single_device_and_jax_sharded(k):
    """JAX's seeds 0 and 1 at 64x96, the bar crossing every strip and a
    64^2 spiral (one component winding through every strip)."""
    mesh, jmesh = _meshes(k)
    masks = [np.random.default_rng(seed).random((64, 96)) > 0.55
             for seed in (0, 1)] + [_bar_and_blobs(k), _spiral(64)]
    for mask in masks:
        ref = _single(mask)
        got = S.connected_components_sharded(mask, mesh)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            got.numpy(), JS.connected_components_sharded(mask, jmesh))
    assert len(np.unique(ref)) > 1
    bar = S.connected_components_sharded(masks[2], mesh).numpy()
    assert len(np.unique(bar)) == 1 + 1 + k  # bg, the bar, a blob a strip


@pytest.mark.parametrize("k", MESH_SIZES)
def test_cc_rows_not_dividing_the_mesh(k):
    """H = 61: strips of unequal height; the labels equal the single
    device's, and JAX's sharded labels of the zero-padded plane."""
    mesh, jmesh = _meshes(k)
    mask = np.random.default_rng(3).random((61, 96)) > 0.5
    got = S.connected_components_sharded(mask, mesh).numpy()
    np.testing.assert_array_equal(got, _single(mask))
    padded = np.pad(mask, ((0, -61 % k), (0, 0)))
    np.testing.assert_array_equal(
        got, JS.connected_components_sharded(padded, jmesh)[:61])


def _plateau_case(seed, hw=(64, 48)):
    """Elevations in 5 flat steps, 6 sparse markers with large ids, a mask
    with holes: plateau floods that cross strip boundaries."""
    rng = np.random.default_rng(seed)
    image = np.round(rng.random(hw) * 4).astype(np.float32)
    markers = np.zeros(hw, np.int32)
    for i in range(6):
        markers[rng.integers(0, hw[0]), rng.integers(0, hw[1])] = \
            100 + 37 * i
    mask = rng.random(hw) > 0.1
    return image, markers, mask


@pytest.mark.parametrize("k", MESH_SIZES)
def test_watershed_matches_jax_sharded(k):
    """The port equals JAX's sharded watershed on a plateau case where that
    differs from JAX's single-device watershed, and on JAX's two tall
    basins split by a ridge through every strip."""
    mesh, jmesh = _meshes(k)
    image, markers, mask = _plateau_case(k)
    ref = JS.watershed_sharded(image, markers, mask, jmesh)
    rounds = []
    got = S.watershed_sharded(image, markers, mask, mesh, rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), ref)
    single = np.asarray(L.watershed(jnp.asarray(image), jnp.asarray(markers),
                                    jnp.asarray(mask)))
    assert (ref != single).any()  # the strip-boundary tie divergence
    assert rounds and max(rounds) > 1

    h, w = 64, 48
    xx = np.tile(np.arange(w, dtype=np.float32), (h, 1))
    image = -np.minimum(np.abs(xx - 10), np.abs(xx - 36))
    markers = np.zeros((h, w), np.int32)
    markers[:, 10] = 1
    markers[:, 36] = 2
    mask = np.ones((h, w), bool)
    got = S.watershed_sharded(image, markers, mask, mesh).numpy()
    np.testing.assert_array_equal(
        got, JS.watershed_sharded(image, markers, mask, jmesh))
    assert (got[:, :20] == 1).all() and (got[:, 28:] == 2).all()


def _blob_prob(hw, n, seed, rmin=3.0, rmax=12.0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = r.integers(0, hw[0]), r.integers(0, hw[1])
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r.uniform(rmin, rmax)
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    return prob + r.random(hw).astype(np.float32) * 0.02


@pytest.mark.parametrize("k", MESH_SIZES)
def test_sharded_families_match_jax(k):
    """The three sharded families on 94x128 blob canvases (rows padded to
    the mesh): the port's compacted maps equal JAX's sharded families'
    compacted maps; through ``post_process(mesh=...)`` too."""
    mesh, jmesh = _meshes(k)
    hw = (94, 128)
    inner = _blob_prob(hw, 40, k)
    cnt = _blob_prob(hw, 40, k + 10) * 0.6
    ref_nuclei = JS.sharded_nuclei_watershed(inner, cnt, jmesh)
    got = S.sharded_nuclei_watershed(torch.from_numpy(inner),
                                     torch.from_numpy(cnt), mesh)
    assert got.shape == hw and got.numpy().max() > 0
    np.testing.assert_array_equal(G._compact_labels(got),
                                  G._compact_labels(ref_nuclei))

    g_inner = _blob_prob(hw, 5, k + 1, rmin=45, rmax=60)
    g_cnt = _blob_prob(hw, 12, k + 20, rmin=2, rmax=10)
    # the gland family's own sizes (min_size 1000, ksize 10)
    ref_gland = JS.sharded_contour_instances(g_inner, g_cnt, 0.55, 1000, 10,
                                             jmesh)
    got = S.sharded_contour_instances(torch.from_numpy(g_inner),
                                      torch.from_numpy(g_cnt), 0.55, 1000,
                                      10, mesh)
    assert got.numpy().max() > 0
    np.testing.assert_array_equal(G._compact_labels(got),
                                  G._compact_labels(ref_gland))
    ref = JS.sharded_eroded_instances(g_inner, 0.5, 20, 2, jmesh)
    got = S.sharded_eroded_instances(torch.from_numpy(g_inner), 0.5, 20, 2,
                                     mesh)
    np.testing.assert_array_equal(G._compact_labels(got),
                                  G._compact_labels(ref))

    canvas = torch.from_numpy(np.stack([g_inner, g_cnt, inner, cnt], -1))
    idx = {"Gland-INST": [0, 2], "Nuclei-INST": [2, 4]}
    cls = G.GPU_POSTPROC_FUNC_DICT["IP-ERODED-CONTOUR-11"]
    for tissue, ref in (("Gland", ref_gland), ("Nuclei", ref_nuclei)):
        got, _ = cls.post_process(canvas, idx, tissue, mesh=mesh)
        np.testing.assert_array_equal(got, G._compact_labels(ref),
                                      err_msg=tissue)
