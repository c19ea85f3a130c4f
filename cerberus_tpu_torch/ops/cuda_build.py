"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (H100) into
its own shared library with a plain C interface, and loaded with
``ctypes``. Pointers and the stream travel as ``c_void_p``; every C entry
returns its ``cudaGetLastError()``, which ``check`` turns into an exception.

Libraries are built at first use into ``cerberus_tpu_torch/build/`` (listed
in ``.gitignore``), named by a hash of their source and flags so an edited
source is rebuilt. All missing libraries are built together, one ``nvcc``
process per source, started at once. No fast-math: the watershed's level
buckets depend on IEEE division.

``launch_counts`` holds one plain integer per kernel entry (``watershed.cu``
has two: the watershed and its one-level ``propagate_labels``); each wrapper
adds one where it launches its kernel and nowhere else. ``LAUNCH_COUNTERS``
is in the order of ``device_postproc.Impl``'s fields.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNELS = ("cc_label", "hist16384", "watershed", "inst_stats")
LAUNCH_COUNTERS = ("cc_label", "hist16384", "watershed", "propagate_labels",
                   "inst_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launch_counts = {name: 0 for name in LAUNCH_COUNTERS}

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as handle:
        digest = hashlib.sha256(handle.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name,
                                                    digest.hexdigest()[:16]))


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``build/.lock`` across processes: processes
    that build at first use (the ranks of a multi-process run) build each
    library once, one after the other."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # closing the file (also when the build raises) releases the lock
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as handle:
        fcntl.flock(handle, fcntl.LOCK_EX)
        yield


def build_all(names=KERNELS) -> float:
    """Compile every missing library, all ``nvcc`` processes in parallel,
    each into a temporary file renamed into place when it is whole, under
    the build lock (a library another process built meanwhile is not
    built again). Returns the wall seconds spent; raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    if all(os.path.isfile(library_path(n)) for n in names):
        return 0.0
    with _build_lock():
        _build_missing(names)
    return time.perf_counter() - t0


def _build_missing(names) -> None:
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
        return
    nvcc = find_nvcc()
    procs = []
    for name in todo:
        final = library_path(name)
        tmp = "%s.%d.tmp" % (final, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, final, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append("%s:\n%s" % (name, out.decode(errors="replace")))
        else:
            os.replace(tmp, final)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.isfile(library_path(name)):
                build_all()
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError("%s failed: CUDA error %d" % (what, err))


def stream_handle(tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``tensor``'s
    device, for a ``c_void_p`` argument. (``torch.cuda.current_stream``
    builds a ``Stream`` object per call, several microseconds of host time
    that a kernel of a few microseconds cannot hide.)"""
    import torch

    return torch._C._cuda_getCurrentRawStream(tensor.device.index)


_NO_GUARD = contextlib.nullcontext()


def device_guard(tensor):
    """A context in which ``tensor``'s device is the current one, as the
    CUDA runtime calls of a C entry need; nothing is switched (and nothing
    paid) when it already is."""
    import torch

    if torch.cuda.current_device() == tensor.device.index:
        return _NO_GUARD
    return torch.cuda.device(tensor.device)


def require_cuda(tensor, name: str, dtype, ndim=None) -> None:
    """Raise unless ``tensor`` is a contiguous CUDA tensor of ``dtype``."""
    if tensor.device.type != "cuda":
        raise ValueError("%s must be a CUDA tensor, got %s"
                         % (name, tensor.device))
    if tensor.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, tensor.dtype))
    if ndim is not None and tensor.dim() != ndim:
        raise ValueError("%s must be %d-D, got shape %s"
                         % (name, ndim, tuple(tensor.shape)))
    if not tensor.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
