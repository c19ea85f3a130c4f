"""Per-instance statistics of label planes: CUDA kernel wrapper, plain
version, and the instance records built from them on the host.

Contract of ``inst_stats``: for every id 1..n of each stacked int32 label
plane, exact integers

  * the box: ``rmin``, ``cmin`` and the exclusive ``rmax``, ``cmax``
    (an id with no pixel keeps ``EMPTY_MIN``, ``EMPTY_MIN``, 0, 0);
  * the pixel count ``n`` and the coordinate sums ``sx``, ``sy``;
  * where the plane is typed, the (id, type) pixel counts over one of the
    stacked int32 type planes.

Ids outside 1..n and types outside [0, n_types) are not counted.

``inst_info_from_stats`` turns one plane's table and its 1x label map into
the records ``ops/postproc.get_inst_info_dict`` makes from the
2x-upscaled maps, equal to them: every field but the contour is a closed
form of the table (the upscale doubles a box, makes ``m00 = 4n`` and
``m10 = 8 (sx - n cmin) + 2n``, and counts each type four times), and the
contour is traced on the 2x upscale of the instance's own 1x crop, which is
the reference's upscaled crop.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cuda_build

SOURCE = "cerberus_tpu_torch/csrc/inst_stats.cu"
REPLACES = "none (the host's whole-map passes of get_inst_info_dict)"

EMPTY_MIN = 0x7F7F7F7F  # rmin and cmin of an id with no pixel
MAX_PLANES = 8  # kMaxPlanes of the kernel's entry
_MAX_SIDE = 1 << 26  # a warp's 32 coordinates summed in 32 bits


class PlaneLayout(NamedTuple):
    row_base: int  # the plane's row 0 (its background) in the tables
    n_ids: int
    joint_base: int  # the plane's first joint count
    n_types: int  # 0: the plane is not typed


class InstTable(NamedTuple):
    """The tables of a launch, on the labels' device: ``ints`` holds
    the columns rmin, cmin, rmax, cmax (``rows`` each) and then each typed
    plane's (n_ids + 1, n_types) joint counts; ``sums`` the columns n, sx,
    sy. ``layout`` has one ``PlaneLayout`` a plane."""
    ints: torch.Tensor
    sums: torch.Tensor
    layout: tuple


class InstStats(NamedTuple):
    """One plane's tables on the host, indexed by id (row 0: background)."""
    box: np.ndarray  # (4, n_ids + 1) int32: rmin, cmin, rmax, cmax
    sums: np.ndarray  # (3, n_ids + 1) int64: n, sx, sy
    joint: Optional[np.ndarray]  # (n_ids + 1, n_types) int32, or None


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded ``inst_stats`` library with its entry's C types set."""
    lib = cuda_build.load("inst_stats")
    lib.inst_stats_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.inst_stats_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _layout(labels: torch.Tensor, types: Optional[torch.Tensor],
            n_ids: Sequence[int], type_of: Sequence[int],
            n_types: Sequence[int]):
    """Checks the arguments; returns (layout, rows, joint_len)."""
    if labels.dim() != 3 or labels.dtype != torch.int32:
        raise ValueError("labels must be (planes, H, W) int32, got %s %s"
                         % (labels.dtype, tuple(labels.shape)))
    planes, h, w = labels.shape
    if not 1 <= planes <= MAX_PLANES:
        raise ValueError("1 to %d label planes, got %d" % (MAX_PLANES, planes))
    if h >= _MAX_SIDE or w >= _MAX_SIDE:
        raise ValueError("planes of %dx%d: each side must be below %d"
                         % (h, w, _MAX_SIDE))
    n_typed = 0 if types is None else types.shape[0]
    if types is not None and (types.dtype != torch.int32 or types.dim() != 3
                              or tuple(types.shape[1:]) != (h, w)):
        raise ValueError("types must be (planes, %d, %d) int32, got %s %s"
                         % (h, w, types.dtype, tuple(types.shape)))
    if len(n_ids) != planes or len(type_of) != planes \
            or len(n_types) != n_typed:
        raise ValueError("n_ids and type_of need one entry a label plane, "
                         "n_types one a type plane")
    layout, rows, joint_len = [], 0, 0
    for n, t in zip(n_ids, type_of):
        if n < 0 or not -1 <= t < n_typed:
            raise ValueError("n_ids %d, type plane %d" % (n, t))
        nt = 0 if t < 0 else int(n_types[t])
        if t >= 0 and nt < 1:
            raise ValueError("type plane %d has n_types %d" % (t, nt))
        layout.append(PlaneLayout(rows, int(n), joint_len, nt))
        rows += int(n) + 1
        joint_len += (int(n) + 1) * nt
    return tuple(layout), rows, joint_len


def inst_stats(labels: torch.Tensor, types: Optional[torch.Tensor],
               n_ids: Sequence[int], type_of: Sequence[int],
               n_types: Sequence[int] = ()) -> InstTable:
    """The tables of (P, H, W) int32 ``labels`` with ids 1..``n_ids[p]``;
    plane p is typed by type plane ``type_of[p]`` of (Q, H, W) int32
    ``types`` (-1: untyped), whose types lie in [0, ``n_types[q]``).

    On CUDA tensors this launches ``csrc/inst_stats.cu`` (one launch for
    all planes; ids grouped per warp, one set of atomics a (warp, id) and
    one atomic a (warp, id, type)), which replaces no TPU kernel: it takes the tile
    engine's whole-map host passes off the host. It is bound by bytes on an
    H100: each label plane read once (4 B/px) and each type plane that
    types a plane read once (4 B/px). On CPU tensors it runs the plain
    version."""
    if labels.device.type == "cpu":
        return inst_stats_plain(labels, types, n_ids, type_of, n_types)
    layout, rows, joint_len = _layout(labels, types, n_ids, type_of, n_types)
    cuda_build.require_cuda(labels, "labels", torch.int32, ndim=3)
    if types is not None:
        cuda_build.require_cuda(types, "types", torch.int32, ndim=3)
    desc = (ctypes.c_longlong * (5 * len(layout)))(*[
        v for plane, t in zip(layout, type_of)
        for v in (t, plane.n_ids, plane.n_types, plane.row_base,
                  plane.joint_base)])
    ints = torch.empty((4 * rows + joint_len,), dtype=torch.int32,
                       device=labels.device)
    sums = torch.empty((3 * rows,), dtype=torch.int64, device=labels.device)
    planes, h, w = labels.shape
    with cuda_build.device_guard(labels):
        cuda_build.launch_counts["inst_stats"] += 1
        err = _library().inst_stats_launch(
            labels.data_ptr(), 0 if types is None else types.data_ptr(),
            planes, h, w, desc, rows, joint_len, ints.data_ptr(),
            sums.data_ptr(), _sm_count(labels.device.index),
            cuda_build.stream_handle(labels))
    cuda_build.check(err, "inst_stats")
    return InstTable(ints, sums, layout)


def inst_stats_plain(labels: torch.Tensor, types: Optional[torch.Tensor],
                     n_ids: Sequence[int], type_of: Sequence[int],
                     n_types: Sequence[int] = ()) -> InstTable:
    """Plain PyTorch version: scatter-adds and scatter-min/max per plane."""
    layout, rows, joint_len = _layout(labels, types, n_ids, type_of, n_types)
    dev = labels.device
    ints = torch.zeros((4 * rows + joint_len,), dtype=torch.int32, device=dev)
    ints[:2 * rows] = EMPTY_MIN
    sums = torch.zeros((3 * rows,), dtype=torch.int64, device=dev)
    _, h, w = labels.shape
    ys = torch.arange(h, device=dev).repeat_interleave(w)
    xs = torch.arange(w, device=dev).repeat(h)
    for p, plane in enumerate(layout):
        lab = labels[p].reshape(-1).long()
        keep = (lab >= 1) & (lab <= plane.n_ids)
        ids, y, x = lab[keep], ys[keep], xs[keep]
        row = ids + plane.row_base
        for col, src, reduce in ((0, y, "amin"), (1, x, "amin"),
                                 (2, y + 1, "amax"), (3, x + 1, "amax")):
            ints[col * rows:(col + 1) * rows].scatter_reduce_(
                0, row, src.to(torch.int32), reduce)
        for col, src in enumerate((torch.ones_like(ids), x, y)):
            sums[col * rows:(col + 1) * rows].index_add_(0, row, src)
        if plane.n_types:
            t = types[type_of[p]].reshape(-1)[keep].long()
            ok = (t >= 0) & (t < plane.n_types)
            at = (4 * rows + plane.joint_base
                  + ids[ok] * plane.n_types + t[ok])
            ints.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    return InstTable(ints, sums, layout)


def split_tables(layout: Sequence[PlaneLayout], ints: np.ndarray,
                 sums: np.ndarray) -> List[InstStats]:
    """A launch's tables, copied to the host (``ints``, ``sums``), as one
    ``InstStats`` a plane (views, no copy)."""
    rows = sum(plane.n_ids + 1 for plane in layout)
    box = ints[:4 * rows].reshape(4, rows)
    sums = sums.reshape(3, rows)
    out = []
    for plane in layout:
        lo, hi = plane.row_base, plane.row_base + plane.n_ids + 1
        joint = None
        if plane.n_types:
            start = 4 * rows + plane.joint_base
            joint = ints[start:start + (hi - lo) * plane.n_types].reshape(
                hi - lo, plane.n_types)
        out.append(InstStats(box[:, lo:hi], sums[:, lo:hi], joint))
    return out


def inst_info_from_stats(inst_map: np.ndarray, stats: InstStats) -> Dict:
    """``get_inst_info_dict(upscale2x(inst_map), upscale2x(type_map))``
    from the 1x ``inst_map`` (float64 ids) and its table: for every id with
    pixels, in ascending order, keyed by the id as the map's float64, the
    box, centroid and contour in the 2x frame and, where the table is
    typed, the majority type (background giving way to the runner-up) and
    its share. Instances whose contour has < 3 points are skipped."""
    import cv2

    box, sums, joint = stats
    info: Dict = {}
    for i in np.flatnonzero(sums[0]).tolist():  # row 0 is never counted
        r0, c0, r1, c1 = (int(box[0, i]), int(box[1, i]), int(box[2, i]),
                          int(box[3, i]))
        crop = inst_map[r0:r1, c0:c1] == i
        single = np.repeat(np.repeat(crop, 2, axis=0), 2,
                           axis=1).astype(np.uint8)
        contours = cv2.findContours(single, cv2.RETR_TREE,
                                    cv2.CHAIN_APPROX_SIMPLE)[0]
        if not contours:  # the map lost the id after the table was made
            continue
        inst_contour = np.squeeze(contours[0].astype("int32"))
        if inst_contour.ndim != 2 or inst_contour.shape[0] < 3:
            continue
        n, sx, sy = int(sums[0, i]), int(sums[1, i]), int(sums[2, i])
        # cv2.moments of the upscaled crop, exact integers as doubles
        m00 = float(4 * n)
        m10 = float(8 * (sx - n * c0) + 2 * n)
        m01 = float(8 * (sy - n * r0) + 2 * n)
        info[np.float64(i)] = {
            "box": np.array([[2 * r0, 2 * c0], [2 * r1, 2 * c1]]),
            "centroid": np.array([m10 / m00, m01 / m00])
            + np.array([2 * c0, 2 * r0]),
            "contour": inst_contour + np.array([[2 * c0, 2 * r0]]),
        }
    if joint is not None and info:
        # the reference's vote on the upscaled map, whose counts are four
        # times these
        counts = joint.astype(np.int64) * 4
        n_types = counts.shape[1]
        order = np.argsort(-counts, axis=1, kind="stable")
        top = order[:, 0]
        runner = order[:, 1] if n_types > 1 else top
        n_nonzero = (counts != 0).sum(axis=1)
        inst_type_all = np.where((top == 0) & (n_nonzero > 1), runner, top)
        totals = counts.sum(axis=1)
        probs_all = counts[np.arange(counts.shape[0]), inst_type_all] / (
            totals + 1.0e-6)
        for inst_id, entry in info.items():
            entry["type"] = int(inst_type_all[int(inst_id)])
            entry["type_prob"] = float(probs_all[int(inst_id)])
    return info
