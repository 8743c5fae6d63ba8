"""Metrics: structured JSONL logging + self-contained TensorBoard event files.

The port's copy of ``melogan_tpu/utils/metrics.py`` (standard library
only). The reference logs scalars via torch's SummaryWriter; this writer
writes the same scalar tags in the tfevents format, encoded from scratch
(TFRecord framing with masked CRC32C, Event/Summary protos serialized by
hand), plus a JSONL stream for programmatic consumption.
"""
from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), required by the TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding for Event{Summary{Value{tag,
# simple_value}}} — field numbers from the public event.proto/summary.proto.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delimited(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double_field(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _float_field(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _varint_field(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # summary.Value: tag=1 (string), simple_value=2 (float)
    value_msg = _len_delimited(1, tag.encode()) + _float_field(2, float(value))
    summary = _len_delimited(1, value_msg)  # Summary.value = 1 (repeated)
    # Event: wall_time=1 (double), step=2 (int64), summary=5
    return _double_field(1, wall_time) + _varint_field(2, step) + _len_delimited(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 (string)
    return _double_field(1, wall_time) + _len_delimited(3, b"brain.Event:2")


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


def read_tfevents(path: str):
    """Parse scalar events from a tfevents file → list of (tag, value, step).

    Understands both this writer's output and real TensorBoard files (e.g. the
    reference's shipped training log, experiments/gan/logs/events.out.*) —
    TFRecord framing with the same Event/Summary wire format.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack("<Q", data[pos : pos + 8])
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        # decode Event fields
        p, step, wall = 0, 0, 0.0
        while p < len(payload):
            key = payload[p]
            field_num, wire = key >> 3, key & 7
            p += 1
            if wire == 0:  # varint
                val = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    val |= (b & 0x7F) << shift
                    shift += 7
                    if not (b & 0x80):
                        break
                if field_num == 2:
                    step = val
            elif wire == 1:  # 64-bit
                if field_num == 1:
                    (wall,) = struct.unpack("<d", payload[p : p + 8])
                p += 8
            elif wire == 5:  # 32-bit
                p += 4
            elif wire == 2:  # length-delimited
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not (b & 0x80):
                        break
                sub = payload[p : p + ln]
                p += ln
                if field_num == 5:  # summary
                    q = 0
                    while q < len(sub):
                        k2 = sub[q]
                        q += 1
                        if (k2 >> 3) == 1 and (k2 & 7) == 2:  # Summary.value
                            ln2, shift = 0, 0
                            while True:
                                b = sub[q]
                                q += 1
                                ln2 |= (b & 0x7F) << shift
                                shift += 7
                                if not (b & 0x80):
                                    break
                            v = sub[q : q + ln2]
                            q += ln2
                            tag, simple = None, None
                            r = 0
                            while r < len(v):
                                k3 = v[r]
                                fn3, w3 = k3 >> 3, k3 & 7
                                r += 1
                                if w3 == 2:
                                    ln3, shift = 0, 0
                                    while True:
                                        b = v[r]
                                        r += 1
                                        ln3 |= (b & 0x7F) << shift
                                        shift += 7
                                        if not (b & 0x80):
                                            break
                                    if fn3 == 1:
                                        tag = v[r : r + ln3].decode("utf-8", "replace")
                                    r += ln3
                                elif w3 == 5:
                                    if fn3 == 2:
                                        (simple,) = struct.unpack("<f", v[r : r + 4])
                                    r += 4
                                elif w3 == 0:
                                    while v[r] & 0x80:
                                        r += 1
                                    r += 1
                                elif w3 == 1:
                                    r += 8
                                else:
                                    r = len(v)
                            if tag is not None and simple is not None:
                                out.append((tag, simple, step))
                        else:
                            # skip unknown field
                            w2 = k2 & 7
                            if w2 == 0:
                                while sub[q] & 0x80:
                                    q += 1
                                q += 1
                            elif w2 == 1:
                                q += 8
                            elif w2 == 5:
                                q += 4
                            elif w2 == 2:
                                ln2, shift = 0, 0
                                while True:
                                    b = sub[q]
                                    q += 1
                                    ln2 |= (b & 0x7F) << shift
                                    shift += 7
                                    if not (b & 0x80):
                                        break
                                q += ln2
                            else:
                                q = len(sub)
            else:
                break
    return out


class MetricsWriter:
    """Scalar metrics → `events.out.tfevents.*` + `metrics.jsonl` in log_dir."""

    def __init__(self, log_dir: str, enable_tfevents: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tf = None
        if enable_tfevents:
            t = time.time()
            name = f"events.out.tfevents.{int(t)}.melogan"
            self._tf = open(os.path.join(log_dir, name), "wb")
            self._tf.write(_tfrecord(_file_version_event(t)))
            self._tf.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        t = time.time()
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "time": t}) + "\n")
        if self._tf is not None:
            self._tf.write(_tfrecord(_scalar_event(tag, float(value), int(step), t)))

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tf is not None:
            self._tf.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tf is not None:
            self._tf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
