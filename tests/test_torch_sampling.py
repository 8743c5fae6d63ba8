"""The port's sampling slice against the JAX package, MIDI bytes, and the
port's import isolation.

``Sampler.sample_from(features, noise)`` takes the jittered features and the
noise from the caller, so both packages get the same numpy inputs (their
random streams differ by design). Notes are compared relative to their own
scale (see tests/test_torch_models.py): both sides sum in IEEE f32 in
different orders, which agrees to about 1e-6 of the scale; 1e-4 is allowed.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.midi import codec as jax_codec
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.sampling import Sampler as JaxSampler

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.constants import EMOTION_BPM
from melogan_torch.midi import codec
from melogan_torch.midi.midifile import read_midi
from melogan_torch.sampling import EMOTION_FEATURES, FEATURE_JITTER_STD, Sampler, emotion_scale
from melogan_torch.utils.weights import export_feature_encoder, export_generator

REL = 1e-4
SMALL = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close_scaled(ours, theirs, rel=REL):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = float(np.max(np.abs(theirs)))
    err = float(np.max(np.abs(ours - theirs)))
    assert scale > 0 and err <= rel * scale, f"max abs err {err:.3e} vs scale {scale:.3e}"


def _inputs(rng, emotions, noise_dim):
    base = np.stack([EMOTION_FEATURES[e] for e in emotions]).astype(np.float32)
    feats = base + np.float32(FEATURE_JITTER_STD) * rng.normal(size=base.shape).astype(np.float32)
    noise = rng.normal(size=(len(emotions), noise_dim)).astype(np.float32)
    return feats, noise


def _jax_notes(js, feats, noise, cfg):
    emb = js.feature_encoder.apply(js.fe_variables, jnp.asarray(feats), train=False)
    latent = (jnp.zeros((len(feats), cfg.latent_dim))
              if cfg.integration_mode == "conditioning" else None)
    notes, _ = js.generator.apply(js.gen_variables, jnp.asarray(noise), latent, emb, train=False)
    return np.asarray(notes)


def _port_of(js, cfg, **kw):
    return Sampler(cfg, gen_variables=export_generator(js.gen_variables),
                   fe_variables=export_feature_encoder(js.fe_variables), device="cpu", **kw)


def test_sample_from_matches_jax_full_width(rng):
    """The slice at the shipped GANConfig() width: FE + Generator, same
    weights, same features and noise."""
    js = JaxSampler(JaxGANConfig(), seed=0)
    ts = _port_of(js, GANConfig())
    emotions = ["happy", "sad", "angry", "calm", "calm", "happy"]
    feats, noise = _inputs(rng, emotions, 128)
    ours = ts.sample_from(feats, noise)
    assert ours.shape == (6, 512, 4) and np.isfinite(ours).all()
    assert_close_scaled(ours, _jax_notes(js, feats, noise, JaxGANConfig()))


def test_sample_from_matches_jax_conditioning_small(rng):
    jcfg = JaxGANConfig(integration_mode="conditioning", **SMALL)
    js = JaxSampler(jcfg, seed=1)
    ts = _port_of(js, GANConfig(integration_mode="conditioning", **SMALL))
    feats, noise = _inputs(rng, list(EMOTIONS), 16)
    assert_close_scaled(ts.sample_from(feats, noise), _jax_notes(js, feats, noise, jcfg))


def test_sample_from_matches_jax_max_notes_1024(rng):
    """max_notes 1024 (M = 128) at full width, where JAX's fuse gate takes
    its fused Pallas tail (interpret mode) and the port its decoder-tail
    path: same weights, same features and noise."""
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on")
    try:
        jcfg = JaxGANConfig(max_notes=1024)
        js = JaxSampler(jcfg, seed=0)
        ts = _port_of(js, GANConfig(max_notes=1024))
        assert ts.generator.decoder.fuses()
        feats, noise = _inputs(rng, list(EMOTIONS), 128)
        ours = ts.sample_from(feats, noise)
        assert ours.shape == (4, 1024, 4) and np.isfinite(ours).all()
        assert_close_scaled(ours, _jax_notes(js, feats, noise, jcfg))
    finally:
        jax_conv_ops.set_use_pallas(prev)


def test_sample_notes_shapes_and_determinism():
    s = Sampler(GANConfig(**SMALL), seed=0, device="cpu")
    notes = s.sample_notes(list(EMOTIONS), seed=7)
    assert notes.shape == (4, 64, 4) and notes.dtype == np.float32
    assert np.isfinite(notes).all()
    np.testing.assert_array_equal(notes, s.sample_notes(list(EMOTIONS), seed=7))
    assert not np.array_equal(notes, s.sample_notes(list(EMOTIONS), seed=8))
    # the same seed and weights on a second sampler give the same notes
    np.testing.assert_array_equal(
        notes, Sampler(GANConfig(**SMALL), seed=0, device="cpu").sample_notes(list(EMOTIONS), seed=7))
    with pytest.raises(ValueError, match="unknown emotion"):
        s.sample_notes(["happy", "elated"])


def test_swap_variables_and_emotion_features(rng):
    cfg = GANConfig(**SMALL)
    s = Sampler(cfg, seed=0, device="cpu")
    feats, noise = _inputs(rng, ["happy", "sad"], 16)
    before = s.sample_from(feats, noise)
    donor = JaxSampler(JaxGANConfig(**SMALL), seed=9)
    s.swap_variables(export_generator(donor.gen_variables),
                     export_feature_encoder(donor.fe_variables))
    after = s.sample_from(feats, noise)
    assert not np.allclose(before, after)
    assert_close_scaled(after, _jax_notes(donor, feats, noise, JaxGANConfig(**SMALL)))

    ef = np.arange(24, dtype=np.float32).reshape(4, 6) / 24.0
    a = s.sample_notes(["happy", "sad"], seed=3)
    s.swap_variables(export_generator(donor.gen_variables),
                     export_feature_encoder(donor.fe_variables), emotion_features=ef)
    np.testing.assert_array_equal(s.emotion_features, ef)
    assert not np.array_equal(a, s.sample_notes(["happy", "sad"], seed=3))
    with pytest.raises(ValueError, match="emotion_features"):
        Sampler(cfg, seed=0, device="cpu", emotion_features=np.zeros((3, 6), np.float32))
    with pytest.raises(ValueError, match="both"):
        Sampler(cfg, gen_variables=export_generator(donor.gen_variables), device="cpu")


def test_unported_sampler_options_raise():
    with pytest.raises(NotImplementedError, match="fast_math"):
        Sampler(GANConfig(**SMALL), fast_math=True, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        Sampler(GANConfig(**SMALL), mesh=object(), device="cpu")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-fallback check needs one without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sampler(GANConfig(**SMALL))  # the default device is cuda


@pytest.mark.parametrize("emotion", EMOTIONS)
def test_render_to_bytes_identical_to_jax(rng, emotion):
    notes = rng.uniform(-1.0, 1.0, size=(512, 4)).astype(np.float32)
    kw = dict(bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
    ours = codec.render_to_bytes(notes, **kw)
    assert ours == jax_codec.render_to_bytes(notes, **kw)
    assert ours == jax_codec.piano_roll_to_song(notes, **kw).to_bytes(allow_native=False)


def test_render_sampler_output_identical_to_jax(tmp_path):
    notes = Sampler(GANConfig(**SMALL), seed=0, device="cpu").sample_notes(list(EMOTIONS), seed=2)
    for emotion, n in zip(EMOTIONS, notes):
        kw = dict(bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
        assert codec.render_to_bytes(n, **kw) == jax_codec.render_to_bytes(n, **kw)
        codec.save_piano_roll_to_midi(n, str(tmp_path / "a.mid"), verbose=False, **kw)
        jax_codec.save_piano_roll_to_midi(n, str(tmp_path / "b.mid"), verbose=False, **kw)
        assert (tmp_path / "a.mid").read_bytes() == (tmp_path / "b.mid").read_bytes()
    for scale in ("major", "minor", "blues", "nope"):
        np.testing.assert_array_equal(codec.scale_snap_table(scale, 3),
                                      jax_codec.scale_snap_table(scale, 3))


def test_generate_midi_and_many_end_to_end(tmp_path):
    s = Sampler(GANConfig(**SMALL), seed=0, device="cpu")
    for emotion in EMOTIONS:
        out = tmp_path / f"{emotion}.mid"
        s.generate_midi(emotion, str(out), seed=3)
        data = out.read_bytes()
        assert data[:4] == b"MThd"
        song = read_midi(data)
        assert abs(song.initial_tempo - EMOTION_BPM[emotion]) < 0.01
        assert len(song.instruments) == 1
    paths = [str(tmp_path / f"m{i}.mid") for i in range(4)]
    assert s.generate_many(list(EMOTIONS), paths, seed=5) == paths
    notes = s.sample_notes(list(EMOTIONS), seed=5)
    for emotion, n, p in zip(EMOTIONS, notes, paths):
        want = codec.render_to_bytes(n, bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
        assert open(p, "rb").read() == want


def test_port_imports_nothing_of_jax():
    """Every module of melogan_torch imports, in a fresh interpreter, without
    pulling in jax, flax, optax, msgpack, yaml or melogan_tpu; with msgpack,
    flax and yaml blocked, the checkpoint codec still writes and reads a
    file and the typed configs read the shipped YAML files."""
    code = (
        "import importlib, os, pkgutil, sys, tempfile\n"
        "for blocked in ('msgpack', 'flax', 'jax', 'optax', 'yaml', 'melogan_tpu'):\n"
        "    sys.modules[blocked] = None  # an import of it raises ImportError\n"
        "import numpy as np\n"
        "import melogan_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(melogan_torch.__path__, 'melogan_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from melogan_torch.utils.checkpoint import load_checkpoint, save_checkpoint\n"
        "path = os.path.join(tempfile.mkdtemp(), 'a.ckpt')\n"
        "save_checkpoint(path, {'w': np.arange(3.0), 'epoch': 2})\n"
        "assert int(load_checkpoint(path)['epoch']) == 2\n"
        "from melogan_torch.config import AEConfig, EDConfig, GANConfig\n"
        "assert AEConfig.from_yaml('configs/ae_freebits.yaml').free_bits == 0.25\n"
        "assert EDConfig.from_yaml('configs/ed.yaml').labels == ('happy', 'sad', 'angry', 'calm')\n"
        "assert GANConfig.from_yaml('configs/gan_conditioning.yaml').latent_dim == 8\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'yaml', 'melogan_tpu'))\n"
        "need = {'melogan_torch.models.vae', 'melogan_torch.train.vae_loop', 'melogan_torch.train.harness',\n"
        "        'melogan_torch.utils.yaml_subset', 'melogan_torch.data.npz', 'melogan_torch.data.scaler',\n"
        "        'melogan_torch.data.splits', 'melogan_torch.data.synthetic', 'melogan_torch.data.augment'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "assert len(mods) >= 30, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
