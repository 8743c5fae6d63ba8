"""Note-level MIDI object model with byte-compatible serialization.

Replicates the output layout of the reference toolchain (pretty_midi → mido,
used by src/gan/utils.py:95-161 and src/ae/midi_utils.py) so that `.mid` files
written here are byte-identical to reference-rendered files for the same note
content:

- format 1, division 220 (pretty_midi default resolution)
- track 0: ``set_tempo`` (µs/beat = int(6e7/bpm)) + 4/4 ``time_signature``
  (24 clocks/click, 8 notated 32nds) at tick 0, end-of-track at last tick + 1
- one track per instrument: ``program_change`` at tick 0, note-offs encoded as
  velocity-0 ``note_on`` (keeps running status alive), events ordered by
  (tick, pitch, velocity) within a tick
- seconds → ticks via ``int(round(time / tick_scale))`` with
  ``tick_scale = 60 / (bpm · division)`` (pretty_midi ``time_to_tick`` on a
  freshly constructed object)

The port's own copy of ``melogan_tpu/midi/midifile.py`` without the native
encoder; ``tests/test_torch_sampling.py`` holds its bytes equal to the JAX
package's ``render_to_bytes``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from melogan_torch.midi import smf

DEFAULT_RESOLUTION = 220

# event_compare secondary ordering inside a tick (reference writer semantics):
# meta timing events < program_change < note events keyed by (pitch, velocity).
_KIND_ORDER = {
    "set_tempo": 1 << 16,
    "time_signature": 2 << 16,
    "key_signature": 3 << 16,
    "program_change": 6 << 16,
    "pitchwheel": 7 << 16,
    "control_change": 8 << 16,
    "end_of_track": 11 << 16,
}


def _event_sort_key(ev: smf.Event) -> Tuple[int, int]:
    if ev.kind in ("note_on", "note_off"):
        vel = ev.b if ev.kind == "note_on" else 0
        sub = (10 << 16) + (ev.a << 8) + vel
    else:
        sub = _KIND_ORDER.get(ev.kind, 5 << 16)
    return (ev.tick, sub)


@dataclass
class MidiNote:
    velocity: int
    pitch: int
    start: float  # seconds
    end: float  # seconds

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class MidiInstrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[MidiNote] = field(default_factory=list)


@dataclass
class MidiSong:
    """A song: tempo + instruments; serializes to the reference byte layout."""

    initial_tempo: float = 120.0
    resolution: int = DEFAULT_RESOLUTION
    instruments: List[MidiInstrument] = field(default_factory=list)
    # (tick, seconds_per_tick) change points, for files read from disk
    tick_scales: Optional[List[Tuple[int, float]]] = None
    # exact µs/beat from a parsed file; None for freshly constructed songs
    # (where µs is recovered through the float chain, matching the reference
    # writer's behavior for generated output)
    tempo_us: Optional[int] = None

    # ------------------------------------------------------------------
    @property
    def seconds_per_tick(self) -> float:
        return 60.0 / (self.initial_tempo * self.resolution)

    def time_to_tick(self, time: float) -> int:
        """Nearest-tick quantization (single-tempo write path)."""
        return int(round(time / self.seconds_per_tick))

    def _times_to_ticks(self, times: np.ndarray) -> np.ndarray:
        # np.round is round-half-even, same as Python round() used on scalars.
        return np.round(np.asarray(times, dtype=np.float64) / self.seconds_per_tick).astype(np.int64)

    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        # µs/beat recovered through the tick-scale exactly as the reference
        # writer does (float64 chain, then truncation); parsed files keep
        # their original value so round-trips are byte-exact.
        if self.tempo_us is not None:
            tempo_us = self.tempo_us
        else:
            ts = self.seconds_per_tick
            tempo_us = int(6e7 / (60.0 / (ts * self.resolution)))

        # this object-model writer is the port's only encoder; the JAX
        # package's native C++ encoder is byte-identical to it
        timing = [
            smf.Event.set_tempo(0, tempo_us),
            smf.Event.time_signature(0, 4, 4, 24, 8),
        ]
        timing.append(smf.Event.end_of_track(timing[-1].tick + 1))

        tracks = [timing]
        channel_cycle = [c for c in range(16) if c != 9]
        for idx, inst in enumerate(self.instruments):
            channel = 9 if inst.is_drum else channel_cycle[idx % len(channel_cycle)]
            events: List[smf.Event] = [
                smf.Event.program_change(0, channel, inst.program)
            ]
            if inst.notes:
                starts = self._times_to_ticks(np.array([n.start for n in inst.notes]))
                ends = self._times_to_ticks(np.array([n.end for n in inst.notes]))
                for note, st, en in zip(inst.notes, starts, ends):
                    events.append(smf.Event.note_on(int(st), channel, note.pitch, note.velocity))
                    events.append(smf.Event.note_on(int(en), channel, note.pitch, 0))
            events.sort(key=_event_sort_key)
            events.append(smf.Event.end_of_track(events[-1].tick + 1))
            tracks.append(events)

        return smf.encode_file(tracks, division=self.resolution, fmt=1)

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _TempoMap:
    """Piecewise tick→seconds map built from track-0 tempo events."""

    def __init__(self, division: int, tempo_events: List[Tuple[int, int]]):
        self.division = division
        if not tempo_events or tempo_events[0][0] != 0:
            tempo_events = [(0, 500000)] + list(tempo_events)
        self.ticks = np.array([t for t, _ in tempo_events], dtype=np.float64)
        scales = np.array(
            [us / 1e6 / division for _, us in tempo_events], dtype=np.float64
        )
        self.scales = scales
        # cumulative seconds at each change point
        seconds = np.zeros(len(tempo_events))
        for i in range(1, len(tempo_events)):
            seconds[i] = seconds[i - 1] + (self.ticks[i] - self.ticks[i - 1]) * scales[i - 1]
        self.seconds = seconds
        self.initial_tempo = 6e7 / tempo_events[0][1]

    def tick_to_time(self, tick) -> np.ndarray:
        tick = np.asarray(tick, dtype=np.float64)
        idx = np.clip(np.searchsorted(self.ticks, tick, side="right") - 1, 0, None)
        return self.seconds[idx] + (tick - self.ticks[idx]) * self.scales[idx]


def read_midi(path_or_bytes) -> MidiSong:
    """Parse a Standard MIDI File into a :class:`MidiSong`.

    Note pairing follows the reference reader semantics: per (channel, pitch)
    the parser stacks note-ons; a note-off closes every stacked note that
    started at an earlier tick (zero-length notes are dropped).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    parsed = smf.parse_file(data)

    tempo_events = [
        (ev.tick, ev.tempo_us)
        for track in parsed.tracks
        for ev in track
        if ev.kind == "set_tempo"
    ]
    if any(us <= 0 for _, us in tempo_events):
        raise ValueError("malformed MIDI file: non-positive tempo event")
    tempo_events.sort()
    tmap = _TempoMap(parsed.division, tempo_events)

    song = MidiSong(initial_tempo=tmap.initial_tempo, resolution=parsed.division)
    song.tick_scales = list(zip(tmap.ticks.astype(int).tolist(), tmap.scales.tolist()))
    if tempo_events:
        song.tempo_us = tempo_events[0][1]

    for track in parsed.tracks:
        # instruments keyed by (channel, program) within this track
        current_program: Dict[int, int] = {}
        open_notes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        insts: Dict[Tuple[int, bool], MidiInstrument] = {}

        def get_inst(channel: int) -> MidiInstrument:
            program = current_program.get(channel, 0)
            key = (program, channel == 9)
            if key not in insts:
                insts[key] = MidiInstrument(program=program, is_drum=(channel == 9))
            return insts[key]

        for ev in track:
            if ev.kind == "program_change":
                current_program[ev.channel] = ev.a
            elif ev.kind == "note_on":
                open_notes.setdefault((ev.channel, ev.a), []).append((ev.tick, ev.b))
            elif ev.kind == "note_off":
                key = (ev.channel, ev.a)
                stack = open_notes.get(key)
                if not stack:
                    continue
                end_tick = ev.tick
                # FIFO pairing: one note-off closes the earliest open note of
                # that pitch (zero-length candidates are skipped). This keeps
                # the on/off event multiset intact so writes round-trip
                # byte-identically even with overlapping same-pitch notes.
                match = next(
                    (i for i, (t, _) in enumerate(stack) if t != end_tick), None
                )
                if match is None:
                    continue
                start_tick, velocity = stack.pop(match)
                if not stack:
                    open_notes.pop(key, None)
                inst = get_inst(ev.channel)
                inst.notes.append(
                    MidiNote(
                        velocity=velocity,
                        pitch=ev.a,
                        start=float(tmap.tick_to_time(start_tick)),
                        end=float(tmap.tick_to_time(end_tick)),
                    )
                )
        for inst in insts.values():
            if inst.notes:
                song.instruments.append(inst)

    return song
