"""The port's data layer against the JAX package's (CPU).

Both packages build the same seeded synthetic corpus (MIDI files and a
manifest), preprocess it into ``.npz`` samples and a scaler, split it, and
load the splits; the port's files and arrays must equal JAX's. Tolerance:
none. Every module here is numpy and file code run in the same order on the
same inputs, so CSVs, manifests and MIDI files compare byte for byte and
arrays exactly. ``.npz`` files compare by content, because ``np.savez``
stamps each zip entry with the time.
"""
import os

import numpy as np
import pytest

from melogan_tpu.config import AEConfig as JAEConfig
from melogan_tpu.config import AugmentConfig as JAugmentConfig
from melogan_tpu.data import augment as jaug
from melogan_tpu.data import datasets as jds
from melogan_tpu.data import npz as jnpz
from melogan_tpu.data import preprocess as jpre
from melogan_tpu.data import scaler as jscaler
from melogan_tpu.data import splits as jsplits
from melogan_tpu.data import synthetic as jsyn
from melogan_tpu.midi import codec as jcodec

from melogan_torch.config import AEConfig, AugmentConfig
from melogan_torch.data import augment as taug
from melogan_torch.data import datasets as tds
from melogan_torch.data import npz as tnpz
from melogan_torch.data import preprocess as tpre
from melogan_torch.data import scaler as tscaler
from melogan_torch.data import splits as tsplits
from melogan_torch.data import synthetic as tsyn
from melogan_torch.midi import codec as tcodec

PER_EMOTION, N_NOTES = 7, 64  # 7 a emotion: 5 train, 1 val, 1 test


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_npz_equal(a_path, b_path):
    with np.load(a_path, allow_pickle=True) as a, np.load(b_path, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{"jax": root, "port": root}: each package's corpus, processed and
    split, under its own directory."""
    out = {}
    for name, syn, pre, spl in (("jax", jsyn, jpre, jsplits), ("port", tsyn, tpre, tsplits)):
        root = str(tmp_path_factory.mktemp(name))
        entries = syn.generate_corpus(root, n_per_emotion=PER_EMOTION, seed=3, n_notes=N_NOTES)
        scaler = pre.preprocess_corpus(entries, os.path.join(root, "processed"), verbose=False)
        scaler.save(os.path.join(root, "scaler.npz"))
        spl.create_splits(spl.read_manifest(os.path.join(root, "data_manifest.csv")),
                          os.path.join(root, "splits"), seed=5)
        out[name] = (root, entries)
    return out


def test_synthetic_corpus_bytes_equal_jax(corpora):
    (jroot, jentries), (troot, tentries) = corpora["jax"], corpora["port"]
    assert len(tentries) == 4 * PER_EMOTION
    for (jk, jp, je), (tk, tp, te) in zip(jentries, tentries):
        assert (jk, je) == (tk, te)
        assert read(jp) == read(tp), jk
    jman = read(os.path.join(jroot, "data_manifest.csv")).replace(jroot.encode(), b"ROOT")
    tman = read(os.path.join(troot, "data_manifest.csv")).replace(troot.encode(), b"ROOT")
    assert jman == tman
    assert tsplits.read_manifest(os.path.join(troot, "data_manifest.csv"))[0]["source"] == "synthetic"


def test_preprocessed_npz_and_scaler_equal_jax(corpora):
    (jroot, _), (troot, _) = corpora["jax"], corpora["port"]
    names = sorted(os.listdir(os.path.join(jroot, "processed")))
    assert names == sorted(os.listdir(os.path.join(troot, "processed")))
    for name in names:
        assert_npz_equal(os.path.join(jroot, "processed", name), os.path.join(troot, "processed", name))
    assert_npz_equal(os.path.join(jroot, "scaler.npz"), os.path.join(troot, "scaler.npz"))
    ours = tscaler.StandardScaler.load(os.path.join(troot, "scaler.npz"))
    theirs = jscaler.StandardScaler.load(os.path.join(jroot, "scaler.npz"))
    x = np.random.default_rng(0).normal(size=(5, 6)) * 10
    np.testing.assert_array_equal(ours.transform(x), theirs.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(x), theirs.inverse_transform(x))
    assert ours.n_samples_seen_ == theirs.n_samples_seen_ == 4 * PER_EMOTION


def test_split_csvs_bytes_equal_jax(corpora, tmp_path):
    (jroot, _), (troot, _) = corpora["jax"], corpora["port"]
    for split in ("train", "val", "test"):
        name = f"{split}_split.csv"
        assert (read(os.path.join(jroot, "splits", name)).replace(jroot.encode(), b"ROOT")
                == read(os.path.join(troot, "splits", name)).replace(troot.encode(), b"ROOT"))
    # the same manifest rows, other ratios and seed: the same files
    rows = jsplits.read_manifest(os.path.join(jroot, "data_manifest.csv"))
    got = tsplits.create_splits(rows, str(tmp_path / "t"), ratios=(0.5, 0.25, 0.25), seed=9)
    want = jsplits.create_splits(rows, str(tmp_path / "j"), ratios=(0.5, 0.25, 0.25), seed=9)
    assert got == want
    for split in ("train", "val", "test"):
        assert read(tmp_path / "t" / f"{split}_split.csv") == read(tmp_path / "j" / f"{split}_split.csv")


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_split_arrays_equal_jax(corpora, split):
    (jroot, _), (troot, _) = corpora["jax"], corpora["port"]
    ours = tds.load_split(os.path.join(troot, "splits", f"{split}_split.csv"),
                          os.path.join(troot, "processed"), verbose=False)
    theirs = jds.load_split(os.path.join(jroot, "splits", f"{split}_split.csv"),
                            os.path.join(jroot, "processed"), verbose=False)
    for a, b in ((ours.notes_raw, theirs.notes_raw), (ours.emotions, theirs.emotions),
                 (ours.numeric, theirs.numeric), (ours.emotion_idx, theirs.emotion_idx),
                 (ours.notes_gan(), theirs.notes_gan()),
                 (ours.notes_ae(AEConfig()), theirs.notes_ae(JAEConfig())),
                 (ours.notes_ae(AEConfig(max_start_beat=7.0)), theirs.notes_ae(JAEConfig(max_start_beat=7.0)))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.filenames == theirs.filenames and ours.n == theirs.n > 0


def test_load_split_drops_unresolvable_rows_as_jax(corpora, tmp_path):
    (troot, _) = corpora["port"]
    src = os.path.join(troot, "splits", "train_split.csv")
    for who in ("jax", "port"):
        os.makedirs(tmp_path / who)
        text = read(src).decode() + "ghost,happy,synthetic,/nowhere/ghost.mid,ghost.npz\n"
        (tmp_path / who / "train_split.csv").write_text(text)
    ours = tds.load_split(str(tmp_path / "port" / "train_split.csv"), os.path.join(troot, "processed"),
                          verbose=False)
    theirs = jds.load_split(str(tmp_path / "jax" / "train_split.csv"), os.path.join(troot, "processed"),
                            verbose=False)
    assert np.array_equal(ours.notes_raw, theirs.notes_raw) and ours.filenames == theirs.filenames
    assert (read(tmp_path / "port" / "auto_filtered_train_split.csv")
            == read(tmp_path / "jax" / "auto_filtered_train_split.csv"))
    paths, emotions, dropped = tnpz.resolve_split(str(tmp_path / "port" / "train_split.csv"),
                                                  os.path.join(troot, "processed"))
    assert (paths, emotions, dropped) == jnpz.resolve_split(str(tmp_path / "jax" / "train_split.csv"),
                                                            os.path.join(troot, "processed"))
    assert len(dropped) == 1


def test_build_split_arrays_and_fast_path_equal_jax(corpora, tmp_path):
    (troot, _) = corpora["port"]
    csv, processed = os.path.join(troot, "splits", "val_split.csv"), os.path.join(troot, "processed")
    ours = tpre.build_split_arrays(csv, processed, str(tmp_path / "t"), verbose=False)
    theirs = jpre.build_split_arrays(csv, processed, str(tmp_path / "j"), verbose=False)
    for k in theirs:
        assert np.array_equal(ours[k], theirs[k]), k
    fast_t, fast_j = tds.load_split_fast(str(tmp_path / "t")), jds.load_split_fast(str(tmp_path / "j"))
    for k in fast_j:
        assert np.array_equal(fast_t[k], fast_j[k]), k
    assert tds.load_split_fast(str(tmp_path / "missing")) is None


def test_expand_corpus_equals_jax(corpora, tmp_path):
    (troot, entries) = corpora["port"]
    ours = taug.expand_corpus(entries, str(tmp_path / "t"), per_song=2, seed=4, verbose=False)
    theirs = jaug.expand_corpus(entries, str(tmp_path / "j"), per_song=2, seed=4, verbose=False)
    assert ours["counts"] == theirs["counts"] and ours["sources"] == theirs["sources"]
    for split in ("train", "val", "test"):
        t = read(tmp_path / "t" / "splits" / f"{split}_split.csv").replace(str(tmp_path / "t").encode(), b"R")
        j = read(tmp_path / "j" / "splits" / f"{split}_split.csv").replace(str(tmp_path / "j").encode(), b"R")
        assert t == j
    names = sorted(os.listdir(tmp_path / "j" / "processed"))
    assert names == sorted(os.listdir(tmp_path / "t" / "processed"))
    for name in names:
        assert_npz_equal(tmp_path / "j" / "processed" / name, tmp_path / "t" / "processed" / name)
    assert_npz_equal(tmp_path / "j" / "scaler.npz", tmp_path / "t" / "scaler.npz")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_note_features_and_layouts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    raw = tnpz.pad_notes(np.stack([rng.integers(30, 90, 40), np.cumsum(rng.uniform(0, 1, 40)),
                                   rng.uniform(0.1, 2, 40), rng.integers(20, 120, 40)], -1), 64)
    np.testing.assert_array_equal(raw, jnpz.pad_notes(raw[:40], 64))
    assert tpre.key_analysis(raw) == jpre.key_analysis(raw)
    np.testing.assert_array_equal(tpre.numeric_features_raw(raw, 97.0), jpre.numeric_features_raw(raw, 97.0))
    gan = tpre.raw_to_gan_normalized(raw)
    np.testing.assert_array_equal(gan, jpre.raw_to_gan_normalized(raw))
    np.testing.assert_array_equal(tpre.gan_normalized_to_raw(gan), jpre.gan_normalized_to_raw(gan))
    norm = tds.ae_normalize(raw)
    np.testing.assert_array_equal(norm, jds.ae_normalize(raw))
    np.testing.assert_array_equal(tds.ae_denormalize(norm, 50.0, 10.0), jds.ae_denormalize(norm, 50.0, 10.0))
    aug = AugmentConfig(tempo_jitter=0.1, pitch_shift=2, note_dropout=0.1, velocity_jitter=0.05,
                        timing_jitter=0.01)
    jaug_cfg = JAEConfig(augment=JAugmentConfig(**aug.__dict__))
    for k in range(20):  # each augmentation fires with its own probability
        a = tds.augment_ae_notes(norm, AEConfig(augment=aug), np.random.default_rng(100 * seed + k))
        b = jds.augment_ae_notes(norm, jaug_cfg, np.random.default_rng(100 * seed + k))
        np.testing.assert_array_equal(a, b)
    out_t, tempo_t = taug.augment_song_raw(raw, 120.0, np.random.default_rng(seed))
    out_j, tempo_j = jaug.augment_song_raw(raw, 120.0, np.random.default_rng(seed))
    np.testing.assert_array_equal(out_t, out_j)
    assert tempo_t == tempo_j


@pytest.mark.parametrize("shuffle,drop_last,weighted", [
    (True, True, False), (False, True, False), (True, False, False), (False, False, False), (True, True, True)])
def test_epoch_batches_and_class_weights_equal_jax(shuffle, drop_last, weighted):
    labels = np.array([0, 1, 1, 2, 2, 2, 3, 0, 1, 3, 3])
    w_t = tds.class_balance_weights(labels) if weighted else None
    w_j = jds.class_balance_weights(labels) if weighted else None
    if weighted:
        np.testing.assert_array_equal(w_t, w_j)
    a = list(tds.epoch_batches(11, 4, np.random.default_rng(7), shuffle, drop_last, w_t))
    b = list(jds.epoch_batches(11, 4, np.random.default_rng(7), shuffle, drop_last, w_j))
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_sample_files_cross_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    sample = tnpz.Sample(notes=tnpz.pad_notes(rng.uniform(0, 100, (10, 4)), 32), mood="calm",
                         numeric_features=rng.normal(size=6).astype(np.float32), tempo=88.0,
                         filename="x.mid")
    tnpz.save_sample(str(tmp_path / "t.npz"), sample)
    jnpz.save_sample(str(tmp_path / "j.npz"), jnpz.Sample(**sample.__dict__))
    assert_npz_equal(tmp_path / "t.npz", tmp_path / "j.npz")
    for path in ("t.npz", "j.npz"):
        a, b = tnpz.load_sample(str(tmp_path / path)), jnpz.load_sample(str(tmp_path / path))
        assert (a.mood, a.tempo, a.filename) == (b.mood, b.tempo, b.filename)
        np.testing.assert_array_equal(a.notes, b.notes)
        np.testing.assert_array_equal(a.numeric_features, b.numeric_features)
    # a malformed numeric vector is padded the same way
    np.savez(tmp_path / "short.npz", notes=sample.notes, numeric_features=np.ones(3, np.float32))
    np.testing.assert_array_equal(tnpz.load_sample(str(tmp_path / "short.npz")).numeric_features,
                                  jnpz.load_sample(str(tmp_path / "short.npz")).numeric_features)


def test_recon_midi_and_raw_roll_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    notes_in = np.stack([rng.uniform(-5, 130, 50), np.cumsum(rng.uniform(0, 1, 50)),
                         rng.uniform(-0.5, 2, 50), rng.uniform(-10, 140, 50)], -1).astype(np.float32)
    notes_out = notes_in + rng.normal(0, 0.5, notes_in.shape).astype(np.float32)
    tcodec.save_recon_midi(notes_in, notes_out, str(tmp_path / "t"), "ep1_song")
    jcodec.save_recon_midi(notes_in, notes_out, str(tmp_path / "j"), "ep1_song")
    for suffix in ("in", "out"):
        name = f"ep1_song_{suffix}.mid"
        assert read(tmp_path / "t" / name) == read(tmp_path / "j" / name)
    roll = np.stack([rng.uniform(-5, 130, 30), rng.uniform(-5, 140, 30), rng.uniform(0, 1, 30),
                     np.cumsum(rng.uniform(0, 0.5, 30))], -1)
    assert tcodec.raw_roll_to_song(roll, 100.0).to_bytes() == jcodec.raw_roll_to_song(roll, 100.0).to_bytes()
    assert (tcodec.notes_array_to_song(notes_in, 90.0).to_bytes()
            == jcodec.notes_array_to_song(notes_in, 90.0).to_bytes())
