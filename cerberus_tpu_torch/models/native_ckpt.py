"""The JAX package's native checkpoint format, read and written in pure
Python and numpy (no ``msgpack`` or flax package).

A native checkpoint is the msgpack stream that
``flax.serialization.msgpack_serialize`` writes for
``{"params": {layer: {attr: ndarray}}, "step": np.int64}``
(``cerberus_tpu/models/convert.py:163-176``). The subset of msgpack such a
tree uses:

  * maps, arrays, strings, binaries, integers, floats, nil and booleans;
  * ext type 1: an ndarray, itself the msgpack triple
    ``(shape, dtype name, C-order bytes)``;
  * ext type 3: a numpy scalar, stored as a 0-d ndarray;
  * leaves larger than flax's ``MAX_CHUNK_SIZE`` split into
    ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
    maps (flax ``_chunk`` / ``_unchunk_array_leaves_in_place``).

``decode`` raises ``ValueError`` on a truncated stream, a length that runs
past the data, an unknown ext type or a dtype name it does not know.
``encode`` writes the same subset with msgpack's smallest encodings, as
``msgpack.packb`` does, so flax reads what it writes.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, in bytes

_DTYPES = frozenset((
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128"))


def _dtype_from_name(name) -> np.dtype:
    """A dtype name of the ndarray triple -> numpy dtype. ``bfloat16``
    (flax stores JAX's as such) has no numpy dtype and is widened to f32 by
    ``_ndarray_from_bytes``."""
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    if name not in _DTYPES:
        raise ValueError("native checkpoint: unknown dtype %r" % name)
    return np.dtype(name)


class _Reader:
    """msgpack decoding over one buffer. ``raw``: strings stay bytes (the
    ndarray triple is packed and read so by flax)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.data):
            raise ValueError("native checkpoint: truncated (%d bytes wanted "
                             "at offset %d of %d)"
                             % (n, self.pos, len(self.data)))
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.read_ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q",
                                ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.read_ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.read_str(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.read_array(self.unpack((">H", ">I")[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack((">H", ">I")[b - 0xDE]))
        raise ValueError("native checkpoint: invalid msgpack byte 0x%02x at "
                         "offset %d" % (b, self.pos - 1))

    def read_str(self, n: int):
        data = bytes(self.take(n))
        if self.raw:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as exc:
            raise ValueError("native checkpoint: invalid UTF-8 string") \
                from exc

    def read_array(self, n: int) -> list:
        if n > len(self.data) - self.pos:  # each element takes >= 1 byte
            raise ValueError("native checkpoint: array of %d runs past the "
                             "data" % n)
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        if 2 * n > len(self.data) - self.pos:
            raise ValueError("native checkpoint: map of %d runs past the "
                             "data" % n)
        out = {}
        for _ in range(n):
            key = self.read()
            try:
                out[key] = self.read()
            except TypeError as exc:  # an unhashable key
                raise ValueError("native checkpoint: bad map key %r"
                                 % (key,)) from exc
        return out

    def read_ext(self, code: int, n: int):
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError("native checkpoint: unknown ext type %d" % code)


def _ndarray_from_bytes(payload) -> np.ndarray:
    """flax ``_ndarray_from_bytes``: the triple (shape, dtype name,
    C-order bytes) -> a read-only ndarray over the buffer."""
    reader = _Reader(payload, raw=True)
    triple = reader.read()
    if (not isinstance(triple, list) or len(triple) != 3
            or not isinstance(triple[0], list)
            or not isinstance(triple[2], bytes)
            or not all(isinstance(d, int) and d >= 0 for d in triple[0])):
        raise ValueError("native checkpoint: malformed ndarray payload")
    shape, name, buf = triple
    bfloat16 = name in (b"bfloat16", "bfloat16")
    dtype = np.dtype(np.uint16) if bfloat16 else _dtype_from_name(name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError("native checkpoint: ndarray of shape %s %s holds "
                         "%d bytes" % (shape, name, len(buf)))
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    if bfloat16:  # the top half of an f32: widen exactly
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(node: dict) -> np.ndarray:
    """flax ``_unchunk``: a chunked leaf -> the whole array."""
    try:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError("native checkpoint: malformed chunked array") \
            from exc


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def decode(data) -> Any:
    """msgpack bytes -> the tree ``flax.serialization.msgpack_restore``
    gives (dicts, lists, str, bytes, int, float, bool, None, ndarrays and
    numpy scalars; chunked leaves joined)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("native checkpoint: %d trailing bytes"
                         % (len(reader.data) - reader.pos))
    return _unchunk_tree(tree)


# ---------------------------------------------------------------- encoding


def _pack_len(out: list, n: int, fix: Tuple[int, int], codes) -> None:
    """Length header: the fix form (base, limit) when it fits, else the
    8/16/32-bit codes (``codes`` may start with None: no 8-bit form)."""
    base, limit = fix
    if base is not None and n < limit:
        out.append(struct.pack(">B", base | n))
        return
    for code, fmt, cap in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < cap:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError("native checkpoint: object of %d is too large" % n)


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v > 0:
        for code, fmt, cap in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < cap:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError("native checkpoint: integer %d too large" % v)
    else:
        for code, fmt, cap in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -cap:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError("native checkpoint: integer %d too small" % v)


def _pack_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    else:
        _pack_len(out, n, (None, 0), (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: the triple packed with msgpack."""
    if arr.dtype.name not in _DTYPES:
        raise ValueError("native checkpoint: cannot store dtype %s"
                         % arr.dtype)
    out: list = []
    _pack(out, [list(arr.shape), arr.dtype.name,
                np.ascontiguousarray(arr).tobytes()])
    return b"".join(out)


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), (None, 0), (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise ValueError("native checkpoint: cannot store %s"
                         % type(obj).__name__)


def _sorted_copy(node):
    """flax's copy of the tree (``jax.tree_util.tree_map``), which orders
    each dict by its keys."""
    if isinstance(node, dict):
        keys = sorted(node) if all(isinstance(k, str) for k in node) \
            else list(node)
        return {k: _sorted_copy(node[k]) for k in keys}
    if isinstance(node, (list, tuple)):
        return [_sorted_copy(v) for v in node]
    return node


def _chunk(arr: np.ndarray, max_chunk_size: int) -> dict:
    size = max(1, int(max_chunk_size / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(node, max_chunk_size: int):
    """flax ``_chunk_array_leaves_in_place``: arrays of more than
    ``max_chunk_size`` bytes, at the top or in dicts (not in lists), become
    chunked maps."""
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, np.ndarray) and v.nbytes > max_chunk_size:
                node[k] = _chunk(v, max_chunk_size)
            elif isinstance(v, dict):
                _chunk_leaves(v, max_chunk_size)
    elif isinstance(node, np.ndarray) and node.nbytes > max_chunk_size:
        return _chunk(node, max_chunk_size)
    return node


def encode(tree, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """A tree of dicts, lists, scalars, ndarrays and numpy scalars ->
    the msgpack bytes ``flax.serialization.msgpack_serialize`` writes."""
    out: list = []
    _pack(out, _chunk_leaves(_sorted_copy(tree), max_chunk_size))
    return b"".join(out)


def read_native(path: str) -> Any:
    with open(path, "rb") as handle:
        return decode(handle.read())


def write_native(path: str, tree, max_chunk_size: int = MAX_CHUNK_SIZE
                 ) -> None:
    """``encode`` to ``path`` through a temporary file and a rename, as the
    JAX ``save_checkpoint`` writes."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as handle:
        handle.write(encode(tree, max_chunk_size))
    os.replace(tmp, path)
