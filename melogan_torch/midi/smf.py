"""Standard MIDI File (SMF) byte-level reader/writer.

Pure-Python, no third-party MIDI dependency. The writer reproduces the exact
byte stream the reference toolchain (pretty_midi → mido) emitted for the shipped
golden artifacts: format 1, running-status channel messages, note-offs encoded
as ``note_on`` with velocity 0, meta messages resetting running status.

The native encoder (``midi_codec.cpp`` beside this module, through
``native.py``) writes one-instrument songs; this module is the reference
implementation it is held to, and the fallback.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def encode_varlen(value: int) -> bytes:
    """Encode a MIDI variable-length quantity (big-endian 7-bit groups)."""
    if value < 0:
        raise ValueError(f"varlen must be non-negative, got {value}")
    out = bytearray([value & 0x7F])
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.reverse()
    return bytes(out)


def decode_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    """Decode a variable-length quantity at ``pos``; returns (value, new_pos)."""
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


@dataclass
class Event:
    """One absolute-time MIDI event.

    ``kind`` is one of: 'note_on', 'note_off', 'program_change',
    'control_change', 'pitchwheel', 'set_tempo', 'time_signature',
    'key_signature', 'end_of_track', 'meta', 'sysex', 'other'.
    """

    tick: int
    kind: str
    channel: int = 0
    # channel-message data
    a: int = 0  # note / program / controller / pitchwheel lsb-part
    b: int = 0  # velocity / value
    # meta payload
    data: bytes = b""

    # -- constructors ------------------------------------------------------
    @staticmethod
    def note_on(tick: int, channel: int, note: int, velocity: int) -> "Event":
        return Event(tick, "note_on", channel, note, velocity)

    @staticmethod
    def note_off(tick: int, channel: int, note: int, velocity: int = 0) -> "Event":
        return Event(tick, "note_off", channel, note, velocity)

    @staticmethod
    def program_change(tick: int, channel: int, program: int) -> "Event":
        return Event(tick, "program_change", channel, program)

    @staticmethod
    def set_tempo(tick: int, tempo_us_per_beat: int) -> "Event":
        return Event(tick, "set_tempo", data=struct.pack(">I", tempo_us_per_beat)[1:])

    @staticmethod
    def time_signature(
        tick: int, numerator: int = 4, denominator: int = 4,
        clocks_per_click: int = 24, notated_32nd: int = 8,
    ) -> "Event":
        denom_pow = max(0, denominator.bit_length() - 1)
        return Event(
            tick, "time_signature",
            data=bytes([numerator, denom_pow, clocks_per_click, notated_32nd]),
        )

    @staticmethod
    def end_of_track(tick: int) -> "Event":
        return Event(tick, "end_of_track")

    # -- encoding ----------------------------------------------------------
    def status_and_payload(self) -> Tuple[Optional[int], bytes]:
        """Return (status_byte_or_None_for_meta, payload_bytes)."""
        k = self.kind
        if k == "note_on":
            return 0x90 | self.channel, bytes([self.a, self.b])
        if k == "note_off":
            # golden-artifact convention: note_off as note_on with velocity 0,
            # which keeps running status alive (matches the reference output)
            return 0x90 | self.channel, bytes([self.a, 0])
        if k == "program_change":
            return 0xC0 | self.channel, bytes([self.a])
        if k == "control_change":
            return 0xB0 | self.channel, bytes([self.a, self.b])
        if k == "pitchwheel":
            v = self.a + 8192
            return 0xE0 | self.channel, bytes([v & 0x7F, (v >> 7) & 0x7F])
        if k == "set_tempo":
            return None, bytes([0xFF, 0x51, 0x03]) + self.data
        if k == "time_signature":
            return None, bytes([0xFF, 0x58, 0x04]) + self.data
        if k == "key_signature":
            return None, bytes([0xFF, 0x59, 0x02]) + self.data
        if k == "end_of_track":
            return None, bytes([0xFF, 0x2F, 0x00])
        if k == "meta":
            return None, bytes([0xFF, self.a]) + encode_varlen(len(self.data)) + self.data
        raise ValueError(f"cannot encode event kind {k!r}")

    @property
    def tempo_us(self) -> int:
        if self.kind != "set_tempo":
            raise ValueError("not a tempo event")
        return int.from_bytes(self.data, "big")


def encode_track(events: List[Event]) -> bytes:
    """Encode absolute-tick events (already sorted) into an MTrk chunk.

    Applies running status exactly like the reference writer: a channel-message
    status byte is omitted when identical to the previous one; meta/sysex
    messages clear running status.
    """
    body = bytearray()
    last_tick = 0
    running: Optional[int] = None
    for ev in events:
        delta = ev.tick - last_tick
        if delta < 0:
            raise ValueError("events must be sorted by tick")
        last_tick = ev.tick
        body += encode_varlen(delta)
        status, payload = ev.status_and_payload()
        if status is None:
            running = None
            body += payload
        else:
            if status != running:
                body.append(status)
                running = status
            body += payload
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def encode_file(tracks: List[List[Event]], division: int = 220, fmt: int = 1) -> bytes:
    header = b"MThd" + struct.pack(">IHHH", 6, fmt, len(tracks), division)
    return header + b"".join(encode_track(t) for t in tracks)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


@dataclass
class ParsedFile:
    fmt: int
    division: int
    tracks: List[List[Event]] = field(default_factory=list)


def _parse_track(data: bytes) -> List[Event]:
    events: List[Event] = []
    pos = 0
    tick = 0
    running: Optional[int] = None
    n = len(data)
    while pos < n:
        delta, pos = decode_varlen(data, pos)
        tick += delta
        b0 = data[pos]
        if b0 == 0xFF:  # meta
            meta_type = data[pos + 1]
            length, pos2 = decode_varlen(data, pos + 2)
            payload = data[pos2 : pos2 + length]
            pos = pos2 + length
            running = None
            if meta_type == 0x51:
                events.append(Event(tick, "set_tempo", data=payload))
            elif meta_type == 0x58:
                events.append(Event(tick, "time_signature", data=payload))
            elif meta_type == 0x59:
                events.append(Event(tick, "key_signature", data=payload))
            elif meta_type == 0x2F:
                events.append(Event(tick, "end_of_track"))
                break
            else:
                events.append(Event(tick, "meta", a=meta_type, data=payload))
            continue
        if b0 in (0xF0, 0xF7):  # sysex
            length, pos2 = decode_varlen(data, pos + 1)
            pos = pos2 + length
            running = None
            continue
        if b0 & 0x80:
            status = b0
            running = status
            pos += 1
        else:
            if running is None:
                raise ValueError("running status data byte with no prior status")
            status = running
        msg_type = status & 0xF0
        channel = status & 0x0F
        if msg_type in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
            a, b = data[pos], data[pos + 1]
            pos += 2
            if msg_type == 0x90:
                if b == 0:
                    events.append(Event(tick, "note_off", channel, a, 0))
                else:
                    events.append(Event(tick, "note_on", channel, a, b))
            elif msg_type == 0x80:
                events.append(Event(tick, "note_off", channel, a, b))
            elif msg_type == 0xB0:
                events.append(Event(tick, "control_change", channel, a, b))
            elif msg_type == 0xE0:
                events.append(Event(tick, "pitchwheel", channel, ((b << 7) | a) - 8192))
            # 0xA0 polyphonic aftertouch: ignored
        elif msg_type in (0xC0, 0xD0):
            a = data[pos]
            pos += 1
            if msg_type == 0xC0:
                events.append(Event(tick, "program_change", channel, a))
        else:
            raise ValueError(f"unhandled status byte 0x{status:02x}")
    return events


def parse_file(data: bytes) -> ParsedFile:
    """Parse SMF bytes. Raises :class:`ValueError` on ANY malformed input
    (wrong magic, truncation mid-event, unknown status, SMPTE timing, zero
    division) — callers handling user-supplied files need only catch one
    exception type."""
    try:
        return _parse_file(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated or malformed MIDI file: {e}") from e


def _parse_file(data: bytes) -> ParsedFile:
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    hlen, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    if hlen < 6:
        raise ValueError(f"malformed MThd length {hlen}")
    if division & 0x8000:
        raise ValueError("SMPTE division is not supported")
    if division == 0:
        raise ValueError("MIDI division is zero")
    out = ParsedFile(fmt=fmt, division=division)
    pos = 8 + hlen
    for _ in range(ntrk):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("expected MTrk chunk")
        (tlen,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        if pos + 8 + tlen > len(data):
            raise ValueError("MTrk chunk length exceeds file size")
        out.tracks.append(_parse_track(data[pos + 8 : pos + 8 + tlen]))
        pos += 8 + tlen
    return out
