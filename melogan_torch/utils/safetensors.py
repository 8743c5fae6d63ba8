"""A reader of ``.safetensors`` files in pure Python and numpy.

The format: an 8-byte little-endian unsigned header length N, then N bytes
of a JSON header mapping each tensor name to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (offsets into the byte buffer after the
header; an optional ``"__metadata__"`` entry holds strings), then the raw
little-endian C-order buffers. ``load_file`` returns numpy arrays, as
``safetensors.numpy.load_file`` does (``tests/test_torch_roberta.py`` holds
the two equal), without the ``safetensors`` package. BF16, which numpy
lacks, is widened to float32 exactly.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """name → numpy array of every tensor in the file at ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds the file ({len(data)} bytes)")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    buf = memoryview(data)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{path}: tensor {name!r} lies outside the buffer")
        raw = buf[begin:end]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _DTYPES:
            arr = np.frombuffer(raw, np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} values for shape {shape}")
        out[name] = arr.reshape(shape).astype(arr.dtype.newbyteorder("="), copy=True)
    return out
