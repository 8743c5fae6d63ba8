"""Minimal Caffe model I/O: caffemodel (protobuf) reader/writer + prototxt parser.

The port's copy of ``melogan_tpu/models/caffe.py`` (numpy and pure Python);
``write_caffemodel`` gives the original's bytes.

The reference loads its face detector with
``cv2.dnn.readNetFromCaffe(deploy.prototxt.txt, res10_…caffemodel)``
(camera/camera.py:37). This module supplies the equivalent loading substrate
without OpenCV or protoc-generated code: a hand-rolled protobuf wire-format
decoder for exactly the NetParameter subset a trained SSD carries
(layer name/type/blobs), plus an encoder so tests can synthesize valid
caffemodel files (the reference's own .caffemodel is a missing large blob,
.MISSING_LARGE_BLOBS:1).

Wire format facts used (protobuf encoding spec):
- NetParameter: name=1 (string), layer=100 (repeated LayerParameter, new
  format), layers=2 (legacy V1LayerParameter — rejected with a clear error)
- LayerParameter: name=1, type=2 (string), blobs=7 (repeated BlobProto)
- BlobProto: data=5 (repeated float, packed), shape=7 (BlobShape),
  legacy num/channels/height/width = 1/2/3/4 (int32)
- BlobShape: dim=1 (repeated int64, packed)
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt caffemodel)")


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value, payload_bytes_or_None)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            v, pos = _read_varint(buf, pos)
            yield fnum, wtype, v, None
        elif wtype == 1:  # 64-bit
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
            yield fnum, wtype, v, None
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield fnum, wtype, None, buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
            yield fnum, wtype, v, None
        else:
            raise ValueError(f"unsupported wire type {wtype} (corrupt caffemodel)")


def _tag(fnum: int, wtype: int) -> bytes:
    return _write_varint((fnum << 3) | wtype)


# ---------------------------------------------------------------------------
# caffemodel decode
# ---------------------------------------------------------------------------


@dataclass
class CaffeLayer:
    name: str
    type: str
    blobs: List[np.ndarray] = field(default_factory=list)


def _parse_blob(buf: bytes) -> np.ndarray:
    shape: Optional[List[int]] = None
    legacy = [None, None, None, None]  # num, channels, height, width
    data: List[np.ndarray] = []
    for fnum, wtype, v, payload in _iter_fields(buf):
        if fnum == 7 and wtype == 2:  # BlobShape
            dims = []
            for f2, w2, v2, p2 in _iter_fields(payload):
                if f2 == 1 and w2 == 2:  # packed int64
                    pos = 0
                    while pos < len(p2):
                        d, pos = _read_varint(p2, pos)
                        dims.append(d)
                elif f2 == 1 and w2 == 0:
                    dims.append(v2)
            shape = dims
        elif fnum == 5:
            if wtype == 2:  # packed floats
                data.append(np.frombuffer(payload, "<f4"))
            else:  # unpacked single float
                data.append(np.asarray([v], np.float32))
        elif fnum == 8 and wtype == 2:  # double_data
            data.append(np.frombuffer(payload, "<f8").astype(np.float32))
        elif fnum in (1, 2, 3, 4) and wtype == 0:
            legacy[fnum - 1] = v
    arr = np.concatenate(data) if data else np.zeros(0, np.float32)
    if shape is None and all(x is not None for x in legacy):
        shape = [int(x) for x in legacy]
    if shape is not None and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def _parse_layer(buf: bytes) -> CaffeLayer:
    name = ""
    typ = ""
    blobs: List[np.ndarray] = []
    for fnum, wtype, v, payload in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            name = payload.decode("utf-8", "replace")
        elif fnum == 2 and wtype == 2:
            typ = payload.decode("utf-8", "replace")
        elif fnum == 7 and wtype == 2:
            blobs.append(_parse_blob(payload))
    return CaffeLayer(name=name, type=typ, blobs=blobs)


def read_caffemodel(path: str) -> Dict[str, CaffeLayer]:
    """Parse a .caffemodel → {layer_name: CaffeLayer} (layers with blobs)."""
    with open(path, "rb") as f:
        buf = f.read()
    layers: Dict[str, CaffeLayer] = {}
    for fnum, wtype, v, payload in _iter_fields(buf):
        if fnum == 100 and wtype == 2:  # new-format LayerParameter
            layer = _parse_layer(payload)
            if layer.blobs:
                layers[layer.name] = layer
        elif fnum == 2 and wtype == 2:
            raise ValueError(
                "legacy V1LayerParameter caffemodel not supported; re-export "
                "with a current Caffe (the reference res10 model is new-format)"
            )
    return layers


# ---------------------------------------------------------------------------
# caffemodel encode (tests synthesize valid files with this)
# ---------------------------------------------------------------------------


def _encode_blob(arr: np.ndarray) -> bytes:
    out = bytearray()
    dims = b"".join(_tag(1, 0) + _write_varint(int(d)) for d in arr.shape)
    out += _tag(7, 2) + _write_varint(len(dims)) + dims
    data = np.ascontiguousarray(arr, "<f4").tobytes()
    out += _tag(5, 2) + _write_varint(len(data)) + data
    return bytes(out)


def write_caffemodel(path: str, layers: List[CaffeLayer]) -> str:
    out = bytearray()
    for layer in layers:
        body = bytearray()
        nb = layer.name.encode()
        body += _tag(1, 2) + _write_varint(len(nb)) + nb
        tb = layer.type.encode()
        body += _tag(2, 2) + _write_varint(len(tb)) + tb
        for blob in layer.blobs:
            eb = _encode_blob(np.asarray(blob, np.float32))
            body += _tag(7, 2) + _write_varint(len(eb)) + eb
        out += _tag(100, 2) + _write_varint(len(body)) + bytes(body)
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


# ---------------------------------------------------------------------------
# prototxt parse (topology/shape validation)
# ---------------------------------------------------------------------------


@dataclass
class ProtoLayer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    params: Dict[str, List[str]]


def parse_prototxt(path: str) -> List[ProtoLayer]:
    """Light-weight prototxt reader: layer name/type/bottom/top plus the
    scalar params needed for shape checks (num_output, kernel_size, pad,
    stride, dilation, bias_term, min/max_size, aspect_ratio, step)."""
    with open(path) as f:
        txt = f.read()
    layers: List[ProtoLayer] = []
    i = 0
    while True:
        m = re.search(r"\blayer\s*\{", txt[i:])
        if not m:
            break
        start = i + m.end()
        depth, j = 1, start
        while depth and j < len(txt):
            if txt[j] == "{":
                depth += 1
            elif txt[j] == "}":
                depth -= 1
            j += 1
        block = txt[start : j - 1]
        i = j
        name = re.search(r'name:\s*"([^"]+)"', block)
        typ = re.search(r'type:\s*"([^"]+)"', block)
        params: Dict[str, List[str]] = {}
        for key in (
            "num_output", "kernel_size", "pad", "stride", "dilation",
            "bias_term", "min_size", "max_size", "aspect_ratio", "step",
            "offset", "variance",
        ):
            vals = re.findall(rf"\b{key}:\s*([^\s}}]+)", block)
            if vals:
                params[key] = vals
        layers.append(
            ProtoLayer(
                name=name.group(1) if name else "",
                type=typ.group(1) if typ else "",
                bottoms=re.findall(r'bottom:\s*"([^"]+)"', block),
                tops=re.findall(r'top:\s*"([^"]+)"', block),
                params=params,
            )
        )
    return layers
