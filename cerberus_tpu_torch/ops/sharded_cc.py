"""Row-sharded connected components and marker watershed over a mesh.

Counterpart of ``cerberus_tpu/ops/sharded_cc.py:142-376``, a ``shard_map``
lowering with no Pallas body: the port keeps its contract, not its loop.
The plane is split into ``mesh.size`` row strips, strip *i* on
``mesh.devices[i]``, and every local pass is a ported kernel (``cc_label``,
``watershed.cu``'s ``propagate_labels``) through an ``Impl``: on CUDA
strips the kernels, on CPU strips their plain versions. Device work is
enqueued strip after strip from the calling thread; only boundary rows
and label pairs cross devices, and the result is gathered on
``mesh.devices[0]``.

  * ``connected_components_sharded``: each strip labelled alone, its ids
    offset to global flat indices, the label pairs across each strip
    boundary united on the host to each class's minimum, the strips
    relabelled through a lookup. Ids equal the single-device labels
    (global min flat index + 1) bit for bit, at any mesh size.
  * ``watershed_sharded``: JAX's rounds exactly (its ``_propagate_sharded``
    and ``_sharded_watershed_kernel``): at each level every strip floods
    to its local fixed point, boundary rows go to the neighbouring strips,
    unlabelled allowed top/bottom rows take the halo, and a global changed
    flag decides another round. Its result equals JAX's
    ``watershed_sharded`` bit for bit, not the single-device watershed:
    the front crosses a strip boundary a round late, so plateau ties there
    can go to the other basin (JAX's docstring; ROADMAP §3).
  * the three families (``sharded_nuclei_watershed``,
    ``sharded_contour_instances``, ``sharded_eroded_instances``): rows
    zero-padded to a mesh multiple (``_pad_rows``), the CC and watershed
    cores sharded; erosion, small-object removal (``hist16384``), hole
    filling and the regrowth on the whole plane on ``mesh.devices[0]``
    (``ops/device_postproc``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import device_postproc as D
from .device_postproc import KERNELS, Impl


def _strip_bounds(h: int, n: int) -> List[Tuple[int, int]]:
    """Row ranges of ``n`` strips of ``h`` rows (``torch.tensor_split``'s
    sizes: the first ``h % n`` strips one row longer)."""
    if h < n:
        raise ValueError("a plane of %d rows cannot be split into %d row "
                         "strips" % (h, n))
    sizes = [h // n + (1 if i < h % n else 0) for i in range(n)]
    starts = np.cumsum([0] + sizes)
    return [(int(starts[i]), int(starts[i + 1])) for i in range(n)]


def _strips(plane: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Strip *i* of ``plane`` on ``mesh.devices[i]``, contiguous."""
    bounds = _strip_bounds(plane.shape[0], mesh.size)
    return [plane[r0:r1].to(dev, non_blocking=True).contiguous()
            for (r0, r1), dev in zip(bounds, mesh.devices)]


def _gather(strips: List[torch.Tensor], mesh) -> torch.Tensor:
    head = mesh.devices[0]
    return torch.cat([s.to(head, non_blocking=True) for s in strips])


def _class_minima(a: np.ndarray, b: np.ndarray):
    """Union of the id pairs (a[k], b[k]): (ids, the minimum id of each
    one's class), both sorted by id. Min-label propagation over the pairs
    with pointer jumping, in index space (ids sorted, so the minimum index
    is the minimum id)."""
    ids = np.unique(np.concatenate([a, b]))
    ia = np.searchsorted(ids, a)
    ib = np.searchsorted(ids, b)
    parent = np.arange(len(ids))
    while True:
        low = np.minimum(parent[ia], parent[ib])
        new = parent.copy()
        np.minimum.at(new, ia, low)
        np.minimum.at(new, ib, low)
        new = new[new]
        if np.array_equal(new, parent):
            return ids, ids[parent]
        parent = new


def _relabel(lab: torch.Tensor, keys: np.ndarray, vals: np.ndarray
             ) -> torch.Tensor:
    """``lab`` with each id in the sorted ``keys`` replaced by its
    ``vals`` entry (on ``lab``'s device)."""
    keys_t = torch.from_numpy(keys.astype(np.int32)).to(lab.device)
    vals_t = torch.from_numpy(vals.astype(np.int32)).to(lab.device)
    pos = torch.searchsorted(keys_t, lab).clamp_(max=len(keys) - 1)
    hit = keys_t[pos] == lab
    return torch.where(hit, vals_t[pos], lab)


def connected_components_sharded(mask, mesh, impl: Impl = KERNELS
                                 ) -> torch.Tensor:
    """4-connected labels of a (H, W) bool plane (tensor or array) row-
    sharded over ``mesh``: int32 on ``mesh.devices[0]``, id = global min
    flat index + 1, equal to the single-device labels. Any H of at least
    the mesh size (strips differ by at most one row)."""
    mask = torch.as_tensor(mask).bool()
    h, w = mask.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError("mask has %d pixels: labels are int32" % (h * w))
    bounds = _strip_bounds(h, mesh.size)
    labs = [impl.cc(strip) for strip in _strips(mask, mesh)]
    labs = [torch.where(lab > 0, lab + r0 * w, lab)
            for lab, (r0, _) in zip(labs, bounds)]
    if mesh.size == 1:
        return _gather(labs, mesh)
    # the pairs across each boundary: both pixels foreground, same column
    rows = [(labs[i][-1].cpu().numpy(), labs[i + 1][0].cpu().numpy())
            for i in range(mesh.size - 1)]
    a = np.concatenate([up[(up > 0) & (down > 0)] for up, down in rows])
    b = np.concatenate([down[(up > 0) & (down > 0)] for up, down in rows])
    if len(a):
        ids, low = _class_minima(a, b)
        moved = ids != low
        keys, vals = ids[moved], low[moved]
        if len(keys):
            labs = [_relabel(lab, keys, vals) for lab in labs]
    return _gather(labs, mesh)


def watershed_sharded(image, markers, mask, mesh, n_levels: int = 64,
                      impl: Impl = KERNELS,
                      rounds: Optional[List[int]] = None) -> torch.Tensor:
    """Marker watershed of a (H, W) f32 plane row-sharded over ``mesh``:
    int32 labels on ``mesh.devices[0]``, equal to JAX's
    ``watershed_sharded`` on the same strips. Levels are bucketed from
    lo/hi over the whole mask with ``watershed_plain``'s f32 arithmetic;
    each strip's local pass is ``impl.propagate`` (0 = unlabelled, JAX's
    ``local_sweeps`` with 0 in place of ``big``). ``rounds``, when given,
    gets the halo rounds of each level that some pixel enters (levels no
    pixel enters change nothing and are skipped)."""
    image = torch.as_tensor(image).float()
    markers = torch.as_tensor(markers).int()
    mask = torch.as_tensor(mask).bool()
    h, w = image.shape
    if not bool(mask.any()):
        return torch.zeros((h, w), dtype=torch.int32, device=mesh.devices[0])
    lo = image[mask].min()
    hi = image[mask].max()
    span = torch.clamp(hi - lo, min=1e-6)
    level = ((image - lo) / span * (n_levels - 1)).to(torch.int32)
    level = level.clamp(0, n_levels - 1)
    bounds = _strip_bounds(h, mesh.size)
    # pixels of each level in each strip (read on the host)
    present = np.stack([torch.bincount(
        level[r0:r1][mask[r0:r1]].long(), minlength=n_levels).cpu().numpy()
        for r0, r1 in bounds])
    lab = torch.where(mask & (markers > 0), markers,
                      torch.zeros_like(markers))
    labs = _strips(lab, mesh)
    levels = _strips(level.to(torch.uint8), mesh)
    masks = _strips(mask, mesh)
    n = mesh.size
    for lvl in range(n_levels):
        if not present[:, lvl].any():
            continue
        allowed = [m & (lv <= lvl) for m, lv in zip(masks, levels)]
        # a strip whose allowed set and labels did not change since its
        # last local pass is at its local fixed point: its pass (a no-op in
        # JAX's rounds) is not launched
        dirty = list(present[:, lvl] > 0)
        taken = 0
        while True:
            taken += 1
            labs = [impl.propagate(lab, ok) if d else lab
                    for lab, ok, d in zip(labs, allowed, dirty)]
            lasts = [lab[-1] for lab in labs]
            firsts = [lab[0] for lab in labs]
            changed = []
            for i in range(n):
                lab, ok = labs[i], allowed[i]
                new = lab.clone()
                if i > 0:  # the previous strip's last row, from above
                    above = lasts[i - 1].to(lab.device, non_blocking=True)
                    new[0] = torch.where(ok[0] & (lab[0] == 0), above, lab[0])
                if i < n - 1:  # written last, as JAX's .at[-1].set(bot)
                    below = firsts[i + 1].to(lab.device, non_blocking=True)
                    new[-1] = torch.where(ok[-1] & (lab[-1] == 0), below,
                                          lab[-1])
                changed.append((new[0] != lab[0]).any()
                               | (new[-1] != lab[-1]).any())
                labs[i] = new
            dirty = [bool(c) for c in changed]
            if not any(dirty):
                break
        if rounds is not None:
            rounds.append(taken)
    return _gather(labs, mesh)


def _pad_rows(arr: torch.Tensor, n_dev: int):
    """Zero-pad rows to a mesh multiple (zeros are background); returns
    (padded, original rows)."""
    h = arr.shape[0]
    ph = -(-h // n_dev) * n_dev
    if ph == h:
        return arr, h
    return torch.cat([arr, arr.new_zeros((ph - h, *arr.shape[1:]))]), h


def sharded_nuclei_watershed(inner, cnt, mesh, impl: Impl = KERNELS
                             ) -> torch.Tensor:
    """The nuclei family (``gpu_postproc._nuclei_watershed``) with its
    three CC labellings and the watershed flood row-sharded over ``mesh``;
    mask and marker preparation on the whole plane on ``mesh.devices[0]``.
    The compacted markers keep the maps of JAX's sharded family (a
    monotone relabel)."""
    head = mesh.devices[0]
    inner, h = _pad_rows(torch.as_tensor(inner).float().to(head), mesh.size)
    cnt, _ = _pad_rows(torch.as_tensor(cnt).float().to(head), mesh.size)
    msk = D.binary_erode((inner + cnt) > 0.5, D.disk_kernel(3))
    msk = D.remove_small_objects(
        connected_components_sharded(msk, mesh, impl), 8, impl) > 0
    mrk_lab = D.remove_small_objects(
        connected_components_sharded(inner > 0.5, mesh, impl), 4, impl)
    mrk = D.fill_holes(mrk_lab > 0, impl)
    markers, _ = D.compact_labels(connected_components_sharded(mrk, mesh,
                                                               impl))
    return watershed_sharded(-inner, markers, msk, mesh, impl=impl)[:h]


def _regrow(lab, min_size: int, ksize: int, impl: Impl):
    lab = D.remove_small_objects(lab, min_size, impl)
    lab = D.dilate_labels(lab, ksize)
    return D.fill_label_holes(lab, impl)


def sharded_contour_instances(inner, cnt, thresh: float, min_size: int,
                              ksize: int, mesh, impl: Impl = KERNELS
                              ) -> torch.Tensor:
    """The gland/lumen family with its CC row-sharded; the regrowth on the
    whole plane on ``mesh.devices[0]``."""
    head = mesh.devices[0]
    inner, h = _pad_rows(torch.as_tensor(inner).float().to(head), mesh.size)
    cnt, _ = _pad_rows(torch.as_tensor(cnt).float().to(head), mesh.size)
    fg = (inner - (cnt > 0.5).to(inner.dtype)) > thresh
    lab = connected_components_sharded(fg, mesh, impl)
    return _regrow(lab, min_size, ksize, impl)[:h]


def sharded_eroded_instances(fg, thresh: float, min_size: int, ksize: int,
                             mesh, impl: Impl = KERNELS) -> torch.Tensor:
    """The ErodedMap family with its CC row-sharded."""
    fg, h = _pad_rows(torch.as_tensor(fg).float().to(mesh.devices[0]),
                      mesh.size)
    lab = connected_components_sharded(fg > thresh, mesh, impl)
    return _regrow(lab, min_size, ksize, impl)[:h]
