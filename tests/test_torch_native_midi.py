"""The port's native MIDI encoder (``melogan_torch/midi/native.py`` over
``midi_codec.cpp``) against the port's object-model writer and the JAX
package's ``render_to_bytes`` (native when ``native/libmelomidi.so``
builds), byte for byte; its refusals (ROADMAP C.3 repaired); where it
builds; and the two on-device twins, ``render_piano_roll_torch`` and
``ssd.nms``, against JAX's ``render_piano_roll_jax`` and ``nms``."""
import glob
import os
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melogan_torch.constants import EMOTION_BPM
from melogan_torch.midi import codec, native, smf
from melogan_torch.midi.midifile import MidiInstrument, MidiNote, MidiSong, read_midi
from melogan_torch.models import ssd
from melogan_torch.sampling import emotion_scale
from melogan_tpu.midi import codec as jcodec
from melogan_tpu.midi import midifile as jmidifile
from melogan_tpu.models import ssd as jssd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    if native.get_lib() is None:
        pytest.skip(f"the port's native MIDI library is unavailable ({native.load_error()})")


def song_of(notes, tempo=120.0, program=0, tempo_us=None, resolution=220):
    """A one-instrument song of (pitch, velocity, start, end) rows."""
    song = MidiSong(initial_tempo=tempo, resolution=resolution, tempo_us=tempo_us)
    song.instruments.append(MidiInstrument(program=program, notes=[MidiNote(v, p, s, e) for p, v, s, e in notes]))
    return song


def jax_song_of(song):
    """The same song in the JAX package's object model."""
    j = jmidifile.MidiSong(initial_tempo=song.initial_tempo, resolution=song.resolution, tempo_us=song.tempo_us)
    for inst in song.instruments:
        j.instruments.append(jmidifile.MidiInstrument(
            program=inst.program, notes=[jmidifile.MidiNote(n.velocity, n.pitch, n.start, n.end)
                                         for n in inst.notes]))
    return j


def no_fallback(monkeypatch):
    """From here on, the Python writer fails the test if it runs."""
    monkeypatch.setattr(smf, "encode_file", lambda *a, **k: pytest.fail("fell back to the Python writer"))


def encoded(song):
    """The song's bytes from the native path (which must have run) and the
    object-model writer, held equal; then the bytes."""
    before = native.encodes
    ours = song.to_bytes()
    assert native.encodes == before + 1
    assert ours == song.to_bytes(allow_native=False)
    return ours


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("emotion", ["happy", "sad", "angry", "calm"])
def test_render_to_bytes_equal_python_and_jax(emotion, seed):
    """512 rows at the emotion's bpm and scale (rests included): the native
    path, the object-model writer and JAX's ``render_to_bytes`` agree."""
    notes = np.random.default_rng(seed).normal(0, 0.8, size=(512, 4)).astype(np.float32)
    kw = dict(bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
    before = native.encodes
    ours = codec.render_to_bytes(notes, **kw)
    assert native.encodes == before + 1
    assert ours == codec.piano_roll_to_song(notes, **kw).to_bytes(allow_native=False)
    assert ours == encoded(codec.piano_roll_to_song(notes, **kw))
    assert ours == jcodec.render_to_bytes(notes, **kw)


def test_golden_files_reencode(reference_dir):
    """The golden ``good_gens1`` files, parsed and written again, give their
    own bytes on both paths (``tests/test_native_midi.py``'s case)."""
    files = sorted(glob.glob(os.path.join(reference_dir, "good_gens1", "*.mid")))
    assert files
    for path in files:
        song = read_midi(path)
        rebuilt = MidiSong(initial_tempo=song.initial_tempo, resolution=song.resolution,
                           instruments=song.instruments, tempo_us=song.tempo_us)
        with open(path, "rb") as f:
            assert encoded(rebuilt) == f.read(), path


@pytest.mark.parametrize("case", ["empty", "shared_ticks", "zero_length", "long_deltas", "parsed_tempo"])
def test_songs_equal_python_and_jax(case):
    """Layouts the serving path seldom makes: an instrument with no notes;
    notes that share a tick (ordered by pitch<<8 | velocity, offs first);
    zero-length notes; ticks whose deltas need 4-byte varlens; and a parsed
    file's own ``tempo_us`` (not the float chain's)."""
    beat = 0.5  # seconds at 120 bpm, 220 ticks
    if case == "empty":
        song = song_of([])
    elif case == "shared_ticks":
        song = song_of([(60, 100, 0.0, beat), (60, 90, 0.0, beat), (64, 100, 0.0, 2 * beat),
                        (55, 127, beat, 2 * beat), (60, 100, beat, beat * 3), (72, 1, 0.0, beat)])
    elif case == "zero_length":
        song = song_of([(60, 100, beat, beat), (62, 80, 0.0, 0.0), (60, 100, beat, 2 * beat)])
    elif case == "long_deltas":
        ts = 60.0 / (120.0 * 220)
        ticks = [0, 1 << 21, (1 << 21) + (1 << 14), (1 << 27), (1 << 28) - 1]
        song = song_of([(60 + i, 100, t * ts, (t + 5) * ts) for i, t in enumerate(ticks)])
    else:
        raw = song_of([(60, 100, 0.0, beat), (67, 90, beat, 3 * beat)], tempo_us=437_123).to_bytes(
            allow_native=False)
        parsed = read_midi(raw)
        assert parsed.tempo_us == 437_123
        song = MidiSong(initial_tempo=parsed.initial_tempo, resolution=parsed.resolution,
                        instruments=parsed.instruments, tempo_us=parsed.tempo_us)
        assert encoded(song) == raw
    ours = encoded(song)
    assert ours == jax_song_of(song).to_bytes(allow_native=True)
    if case == "long_deltas":
        ticks = np.sort(np.concatenate([song._times_to_ticks([n.start for n in song.instruments[0].notes]),
                                        song._times_to_ticks([n.end for n in song.instruments[0].notes])]))
        longest = int(np.diff(ticks).max())
        assert len(smf.encode_varlen(longest)) == 4 and smf.encode_varlen(longest) in ours


def test_note_before_time_zero_raises_and_leaves_no_file(tmp_path, monkeypatch):
    """ROADMAP C.3, repaired in the port's copy: a note before time 0 raises
    the Python writer's ValueError on the native path (no fallback), and
    ``write`` and the VAE's recon dump leave no file. The JAX native
    encoder writes bytes for the same song, whose times read back near
    2.7e18 s; that is left as it is."""
    song = song_of([(60, 100, -1.0, 0.5), (62, 90, 0.25, 1.0)])
    with pytest.raises(ValueError) as python:
        song.to_bytes(allow_native=False)
    before = native.encodes
    with monkeypatch.context() as m:
        no_fallback(m)
        with pytest.raises(ValueError) as ours:
            song.to_bytes()
    assert str(ours.value) == str(python.value) == "events must be sorted by tick"
    assert native.encodes == before
    with pytest.raises(ValueError, match="sorted by tick"):
        native.encode_song_native(np.array([60]), np.array([100]), np.array([-3]), np.array([5]),
                                  program=0, channel=0, tempo_us=500000, division=220)
    path = tmp_path / "x.mid"
    with pytest.raises(ValueError):
        song.write(str(path))
    assert not path.exists()
    raw_in = np.array([[60, -2.0, 1.0, 100], [62, 0.5, 1.0, 90]], np.float32)  # (pitch, start, dur, vel)
    with pytest.raises(ValueError):
        codec.save_recon_midi(raw_in, raw_in, str(tmp_path / "recon"), "ep1_song")
    assert os.listdir(tmp_path / "recon") == []
    theirs = jax_song_of(song).to_bytes(allow_native=True)
    starts = [n.start for n in jmidifile.read_midi(theirs).instruments[0].notes]
    assert min(starts) > 1e18  # the JAX encoder's 10-byte negative delta


@pytest.mark.parametrize("pitch,velocity,program,tempo_us", [
    (200, 100, 0, None),  # written as it is by both
    (60, 255, 130, None),
    (60, 0, 255, None),  # a velocity-0 note-on
    (300, 100, 0, None),  # refused by both
    (-1, 100, 0, None),
    (60, 256, 0, None),
    (60, -5, 0, None),
    (60, 100, 256, None),
    (60, 100, -1, None),
    (2 ** 40, 100, 0, None),  # beyond int32 too
    (60.0, 100, 0, None),  # not an integer
    (60, 100, 0, 1 << 32),  # a tempo that struct cannot pack
    (60, 100, 0, (1 << 24) + 7),  # packed to its low three bytes by both
])
def test_out_of_range_fields_as_the_python_writer(pitch, velocity, program, tempo_us, monkeypatch):
    """The native path does what the Python writer does with each field
    outside MIDI's range: the same bytes where Python encodes, the same
    exception and message where it raises (raised by the native path, not
    by a fallback to the Python writer)."""
    song = song_of([(pitch, velocity, 0.0, 0.5), (64, 90, 0.25, 1.0)], program=program, tempo_us=tempo_us)
    try:
        want = song.to_bytes(allow_native=False)
    except (ValueError, TypeError, struct.error) as e:
        no_fallback(monkeypatch)
        with pytest.raises(type(e)) as ours:
            song.to_bytes()
        if not isinstance(e, TypeError):
            assert str(ours.value) == str(e)
    else:
        assert encoded(song) == want


def test_library_builds_under_build_dir_and_rebuilds_when_stale(tmp_path, monkeypatch):
    """The library lives in ``build/melogan_torch/``, built from the port's
    own source; the bridge never opens ``native/libmelomidi.so``. A build
    lands by rename, and a source newer than the library rebuilds it."""
    assert native.LIB_PATH == Path(ROOT) / "build" / "melogan_torch" / "libmelomidi.so"
    assert native.SRC_PATH == Path(ROOT) / "melogan_torch" / "midi" / "midi_codec.cpp"
    assert native.get_lib()._name == str(native.LIB_PATH)
    assert native.LIB_PATH.exists() and not native.is_stale()
    mtime = native.LIB_PATH.stat().st_mtime
    assert native.build() == native.LIB_PATH and native.LIB_PATH.stat().st_mtime == mtime
    src, lib = tmp_path / "midi_codec.cpp", tmp_path / "lib" / "libmelomidi.so"
    src.write_bytes(native.SRC_PATH.read_bytes())
    monkeypatch.setattr(native, "SRC_PATH", src)
    monkeypatch.setattr(native, "LIB_PATH", lib)
    assert native.is_stale() and native.build() == lib and not native.is_stale()
    os.utime(lib, (src.stat().st_mtime - 10,) * 2)  # an edit of the source after the build
    old = lib.stat().st_mtime
    assert native.is_stale() and native.build() == lib and not native.is_stale()
    assert lib.stat().st_mtime > old
    assert sorted(os.listdir(lib.parent)) == ["libmelomidi.so"]  # no temporary file left


def test_without_the_library_the_python_writer_serves(monkeypatch):
    """A library that did not build or load: None from the bridge, the
    reason in ``load_error``, and the object-model writer's bytes."""
    monkeypatch.setattr(native, "_loaded", {"tried": True, "lib": None, "error": "RuntimeError: no g++"})
    notes = np.random.default_rng(7).normal(0, 0.8, size=(64, 4)).astype(np.float32)
    before = native.encodes
    assert native.encode_song_native(np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0), 0, 0, 500000, 220) is None
    assert not native.native_available() and native.load_error() == "RuntimeError: no g++"
    assert codec.render_to_bytes(notes, bpm=97) == jcodec.render_to_bytes(notes, bpm=97)
    assert native.encodes == before


@pytest.mark.parametrize("shape,bpm,scale,root_key", [
    ((512, 4), 120, "minor", 0), ((3, 512, 4), 97, "major", 0), ((2, 2, 64, 4), 240, "blues", 5),
])
def test_render_piano_roll_torch_matches_jax(shape, bpm, scale, root_key):
    """The on-device twin against ``render_piano_roll_jax`` on the same
    rows: keep, pitch and velocity exactly; the times to 1e-4 s (JAX's own
    test's tolerance against the host renderer), or to two float32 ulps of
    the latest time where that is coarser: both twins sum the beats in
    float32 in different orders, and at bpm 97 the times pass 512 s, where
    one ulp is 6.1e-5 s (JAX's twin is itself 1.7e-4 s from the float64
    host renderer there). The kept rows also against the host renderer."""
    notes = np.random.default_rng(len(shape)).normal(0, 0.8, size=shape).astype(np.float32)
    ours = codec.render_piano_roll_torch(torch.from_numpy(notes), bpm=bpm, scale=scale, root_key=root_key)
    theirs = jcodec.render_piano_roll_jax(notes, bpm=bpm, scale=scale, root_key=root_key)
    atol = max(1e-4, 2 * float(np.spacing(np.float32(np.asarray(theirs[3]).max()))))
    for name, a, b in zip(("pitch", "velocity", "start_sec", "end_sec", "keep"), ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape == shape[:-1], name
        if name.endswith("sec"):
            np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    pitch, velocity, start, end, keep = (t.numpy().reshape(-1, shape[-2]) for t in ours)
    for i, row in enumerate(notes.reshape(-1, shape[-2], 4)):
        want = codec.render_piano_roll(row, bpm=bpm, scale=scale, root_key=root_key)
        for got, w in zip((pitch, velocity), want[:2]):
            np.testing.assert_array_equal(got[i][keep[i]], w)
        for got, w in zip((start, end), want[2:]):
            np.testing.assert_allclose(got[i][keep[i]], w, atol=atol, rtol=0)


@pytest.mark.parametrize("n,top_k", [(500, 400), (64, 400), (300, 100)])
def test_nms_matches_jax(n, top_k):
    """The static-shape NMS against JAX's on seeded boxes whose overlaps sit
    around the 0.45 threshold, with tied scores: order and keep exactly,
    scores and boxes to 1e-6."""
    rng = np.random.default_rng(n + top_k)
    centres = rng.uniform(0, 1, size=(n // 4 + 1, 2))
    base = np.concatenate([centres - 0.05, centres + 0.05], axis=1)
    # copies shifted by 0.02-0.045 of a 0.1 box: IoUs of about 0.38-0.67
    shift = rng.uniform(0.02, 0.045, size=(n, 2)) * rng.choice([-1, 1], size=(n, 2))
    boxes = (base[rng.integers(0, len(base), n)] + np.tile(shift, 2)).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    ours = ssd.nms(torch.from_numpy(boxes), torch.from_numpy(scores), top_k=top_k)
    theirs = jssd.nms(jnp.asarray(boxes), jnp.asarray(scores), top_k=top_k)
    order, s, b, keep = (t.numpy() for t in ours)
    np.testing.assert_array_equal(order, np.asarray(theirs[0]))
    np.testing.assert_array_equal(keep, np.asarray(theirs[3]))
    np.testing.assert_allclose(s, np.asarray(theirs[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b, np.asarray(theirs[2]), atol=1e-6, rtol=0)
    assert 0 < keep.sum() < min(n, top_k)  # some suppressed, some kept
