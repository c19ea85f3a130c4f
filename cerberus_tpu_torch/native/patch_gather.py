"""ctypes binding of the C++ patch gather (``patch_gather.cpp``, a copy of
``cerberus_tpu/native/patch_gather.cpp``), built with the host's C++
compiler at first use.

The library goes to ``cerberus_tpu_torch/build/`` (git-ignored), named by a
hash of its source and flags, so an edited source is rebuilt and nothing is
written beside the source. The build lands through a temporary name and
``os.replace``, so processes that build at once do not see a half-written
file. A failed build raises: ``gather_patches`` never falls back.
``gather_patches_plain`` is the numpy loop of the same contract, which the
tests hold the C++ gather against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "patch_gather.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as handle:
        digest = hashlib.sha256(handle.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        "libpatchgather_%s.so" % digest.hexdigest()[:16])


def _find_cxx() -> str:
    for cxx in (os.environ.get("CXX"), "c++", "g++"):
        if cxx and shutil.which(cxx):
            return shutil.which(cxx)
    raise RuntimeError("no C++ compiler (c++ or g++) found to build the "
                       "patch gather; set CXX")


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output when the build fails."""
    final = library_path()
    if os.path.isfile(final):
        return final
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (final, os.getpid())
    proc = subprocess.run([_find_cxx(), *CXX_FLAGS, "-o", tmp, _SRC,
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building the patch gather failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, final)
    return final


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.gather_patches.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.gather_patches.restype = None
            _lib = lib
        return _lib


def _prepare(src: np.ndarray, coords_yx, win_h: int, win_w: int, out):
    if src.dtype != np.uint8:
        raise TypeError("gather_patches takes uint8, got %s" % src.dtype)
    if src.ndim == 2:
        src = src[..., None]
    if src.ndim != 3:
        raise ValueError("gather_patches takes (H, W[, C]), got shape %s"
                         % (src.shape,))
    coords = np.ascontiguousarray(np.asarray(coords_yx, dtype=np.int64)
                                  .reshape(-1, 2))
    shape = (len(coords), int(win_h), int(win_w), src.shape[2])
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous uint8 array of shape %s"
                         % (shape,))
    return src, coords, out


def gather_patches(src: np.ndarray, coords_yx, win_h: int, win_w: int,
                   out: np.ndarray = None, n_threads: int = 0) -> np.ndarray:
    """Crop ``len(coords_yx)`` windows of (win_h, win_w) from ``src``
    ((H, W, C) or (H, W) uint8, an array or a numpy memmap) at top-left
    (y, x) corners, in C++ on ``n_threads`` threads (0: up to 16). Parts
    outside the source are zero. Returns (N, win_h, win_w, C) uint8."""
    src, coords, out = _prepare(src, coords_yx, win_h, win_w, out)
    # the C loop indexes with dense row strides: a view with other strides
    # would scramble pixels (a memmap of a C-order .npy is contiguous)
    if not src.flags["C_CONTIGUOUS"]:
        src = np.ascontiguousarray(src)
    lib = _load()
    h, w, c = src.shape
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.gather_patches(
        ctypes.c_void_p(src.ctypes.data), h, w, c,
        ctypes.c_void_p(coords.ctypes.data), len(coords), int(win_h),
        int(win_w), ctypes.c_void_p(out.ctypes.data), n_threads)
    return out


def gather_patches_plain(src: np.ndarray, coords_yx, win_h: int, win_w: int,
                         out: np.ndarray = None) -> np.ndarray:
    """The numpy loop of ``gather_patches``'s contract."""
    src, coords, out = _prepare(src, coords_yx, win_h, win_w, out)
    h, w = src.shape[:2]
    for i, (y0, x0) in enumerate(coords):
        ys, ye = max(y0, 0), min(y0 + win_h, h)
        xs, xe = max(x0, 0), min(x0 + win_w, w)
        out[i] = 0
        if ys < ye and xs < xe:
            out[i, ys - y0: ye - y0, xs - x0: xe - x0] = src[ys:ye, xs:xe]
    return out
