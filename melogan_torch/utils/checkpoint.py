"""Checkpoints in the JAX package's ``.ckpt`` format, in pure Python and numpy.

``melogan_tpu/utils/checkpoint.py`` writes every artifact with
``flax.serialization.msgpack_serialize`` and reads it with
``msgpack_restore``. This module writes and reads the same bytes without
flax or the ``msgpack`` package:

- containers and scalars are standard msgpack: maps, arrays, nil, booleans,
  ints in their smallest encoding, float64, UTF-8 str and bin, all
  big-endian. Types are strict, as flax packs them: a tuple is not a list,
  and a ``np.float64`` is not a Python float;
- every map of the tree is written in sorted key order, as flax's tree
  copy leaves it;
- a numpy array is ext type 1 and a numpy scalar ext type 3. Their payload
  is itself msgpack of ``(shape, dtype name, C-order bytes)``, the name
  read back as bytes. A Python complex is ext type 2 (``(real, imag)``);
- an array over ``MAX_CHUNK_SIZE`` bytes is written as a
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  map of flat pieces, and joined again on reading.

``save_checkpoint`` converts a tree as the JAX version does before it
serializes: tensors and Python scalars become numpy arrays (a Python int
is a 0-d int64 array), and tuples and lists become ``{"0": ..., "1": ...}``
maps. Writes are atomic. ``load_checkpoint`` returns the raw tree of numpy
arrays; ``utils/weights.py`` maps it into the port's modules.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from melogan_torch.utils.atomic import atomic_write

# msgpack limits one object to 2**31 - 1 bytes; flax chunks arrays above this
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _int_bytes(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return bytes((n,))
        if n < 1 << 8:
            return struct.pack(">BB", 0xCC, n)
        if n < 1 << 16:
            return struct.pack(">BH", 0xCD, n)
        if n < 1 << 32:
            return struct.pack(">BI", 0xCE, n)
        if n < 1 << 64:
            return struct.pack(">BQ", 0xCF, n)
    else:
        if n >= -32:
            return struct.pack(">b", n)
        if n >= -(1 << 7):
            return struct.pack(">Bb", 0xD0, n)
        if n >= -(1 << 15):
            return struct.pack(">Bh", 0xD1, n)
        if n >= -(1 << 31):
            return struct.pack(">Bi", 0xD2, n)
        if n >= -(1 << 63):
            return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Optional[tuple], codes: tuple) -> bytes:
    """A length header: the fix form ``(base, limit)`` when n < limit, else
    the 8-, 16- or 32-bit form (``codes``; None where there is none)."""
    if fix is not None and n < fix[1]:
        return bytes((fix[0] | n,))
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return struct.pack(fmt, code, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _str_header(n: int) -> bytes:
    return _sized(n, (0xA0, 32), (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return struct.pack(">Bb", _FIXEXT[n], code)
    return _sized(n, None, (0xC7, 0xC8, 0xC9)) + struct.pack(">b", code)


def _ndarray_parts(arr: np.ndarray) -> List[bytes]:
    """The ext payload of an array: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    data = arr.tobytes("C")
    name = arr.dtype.name.encode()
    head = [b"\x93", _array_header(arr.ndim), *(_int_bytes(int(d)) for d in arr.shape),
            _str_header(len(name)), name, _bin_header(len(data))]
    return [b"".join(head), data]


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int_bytes(obj))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        b = obj.encode("utf-8")
        out += [_str_header(len(b)), b]
    elif t is bytes or t is bytearray:
        out += [_bin_header(len(obj)), bytes(obj)]
    elif t is dict:
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        parts = _ndarray_parts(np.asarray(obj))
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        out += [_ext_header(code, sum(len(p) for p in parts)), *parts]
    elif t is complex:
        inner = b"\x92" + struct.pack(">BdBd", 0xCB, obj.real, 0xCB, obj.imag)
        out += [_ext_header(_EXT_COMPLEX, len(inner)), inner]
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, flat.size, size))},
    }


def _oversized(x) -> bool:
    return isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE


def _sorted_copy(tree):
    """A copy with every map in sorted key order, as flax's ``tree_map``
    copy leaves it."""
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if type(tree) is list:
        return [_sorted_copy(v) for v in tree]
    return tree


def _chunk_leaves(tree):
    """Oversized array leaves of maps (and an oversized top-level array)
    become chunk maps, whose keys keep their insertion order; lists are
    left alone, as flax leaves them."""
    if isinstance(tree, dict):
        return {k: _chunk(v) if _oversized(v) else _chunk_leaves(v) for k, v in tree.items()}
    return _chunk(tree) if _oversized(tree) else tree


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for ``tree``
    (maps, lists, Python scalars, numpy arrays and scalars)."""
    out: List[bytes] = []
    _pack(_chunk_leaves(_sorted_copy(tree)), out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _dtype(name: bytes):
    if name == b"bfloat16":
        import torch

        return torch.bfloat16
    return np.dtype(name.decode())


class _Reader:
    """msgpack over a memoryview. ``raw``: str comes back as bytes (the
    array payload is read so, as flax reads it)."""

    def __init__(self, buf: memoryview, raw: bool = False):
        self.buf, self.pos, self.raw = buf, 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from(data)
            return arr[()] if code == _EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self._map(b & 0x0F)
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:
            return bytes(self._take(self._unpack((">B", ">H", ">I")[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            n = self._unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if 0xCA <= b <= 0xD3:
            return self._unpack((">f", ">d", ">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCA])
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def read_bin_view(self) -> memoryview:
        b = self._take(1)[0]
        if not 0xC4 <= b <= 0xC6:
            raise ValueError("array payload: expected bin data")
        return self._take(self._unpack((">B", ">H", ">I")[b - 0xC4]))


def _ndarray_from(data: memoryview):
    r = _Reader(data, raw=True)
    if r._take(1)[0] != 0x93:
        raise ValueError("array payload: expected (shape, dtype, bytes)")
    shape = tuple(r.read())
    dtype = _dtype(r.read())
    buf = r.read_bin_view()
    if not isinstance(dtype, np.dtype):  # bfloat16: a torch dtype
        import torch

        return torch.from_numpy(np.frombuffer(buf, np.uint16).reshape(shape).copy()).view(dtype)
    # copied: writable, and not a view of the whole file
    return np.frombuffer(buf, dtype).reshape(shape).copy()


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    r = _Reader(memoryview(data))
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the msgpack object")
    return _unchunk_leaves(tree)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def _to_host(tree):
    """The tree as JAX's ``save_checkpoint`` hands it to flax: numpy leaves
    (``np.asarray`` of each, so a Python int is a 0-d int64 array), string
    keys, and tuples and lists as index-keyed maps."""
    if isinstance(tree, dict):
        return {str(k): _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_host(v) for i, v in enumerate(tree)}
    if tree is None:
        return None
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree: Dict[str, Any]) -> str:
    """Atomically serialize a tree to ``path`` in the JAX ``.ckpt`` format."""
    data = msgpack_serialize(_to_host(tree))
    return atomic_write(path, lambda f: f.write(data), mode="wb")


def check_tree(want, got, where: str = "") -> None:
    """Raise ValueError, naming the key, where ``got`` lacks a key of
    ``want`` or a leaf's shape differs from ``want``'s."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"checkpoint at {where or '/'}: expected a map, got {type(got).__name__}")
        for k, v in want.items():
            if k not in got:
                raise ValueError(f"checkpoint lacks key {where}/{k}")
            check_tree(v, got[k], f"{where}/{k}")
    elif hasattr(want, "shape") and tuple(np.shape(got)) != tuple(want.shape):
        raise ValueError(f"checkpoint key {where}: shape {tuple(np.shape(got))}, "
                         f"expected {tuple(want.shape)}")


def load_checkpoint(path: str, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The raw tree of numpy arrays in ``path``. With ``target`` (a tree of
    arrays) its keys and shapes are checked first (``check_tree``)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if target is not None:
        check_tree(target, tree)
    return tree


def latest_checkpoint(directory: str, prefix: str) -> Optional[str]:
    """Newest ``<prefix>*.ckpt`` in ``directory`` by trailing number, if any."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".ckpt")]
    if not cands:
        return None

    def keyfn(name: str):
        digits = "".join(c for c in name if c.isdigit())
        return int(digits) if digits else -1

    return os.path.join(directory, max(cands, key=keyfn))
