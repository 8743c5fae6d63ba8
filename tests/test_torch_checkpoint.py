"""The port's checkpoint layer against the JAX package (CPU).

- the pure-Python msgpack codec writes the bytes of
  ``flax.serialization.msgpack_serialize`` and each side reads the other's;
- ``save_checkpoint`` writes the bytes of the JAX ``save_checkpoint``;
- ``convert_*`` equal the JAX originals and invert ``export_*``;
- a port-trained ``gan_epochNNNN.ckpt`` restores into a JAX state through
  flax's ``from_state_dict`` (every key and shape), and JAX resumes from it;
- the port's ``gan_final.ckpt`` serves the same notes in both packages;
- the port's metrics writer and quality gate equal the JAX originals;
- ``train(track_best=True)`` keeps ``gan_best.ckpt`` across a resume.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from melogan_tpu.config import EDConfig as JaxEDConfig
from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.data import datasets as jdata
from melogan_tpu.diagnostics import quality as jquality
from melogan_tpu.train import gan_loop as jloop
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.utils import atomic as jatomic
from melogan_tpu.utils import checkpoint as jckpt
from melogan_tpu.utils import metrics as jmetrics
from melogan_tpu.utils import torch_interop

from melogan_torch import EMOTIONS
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data.datasets import SplitData
from melogan_torch.diagnostics import quality
from melogan_torch.sampling import Sampler
from melogan_torch.train import gan_loop
from melogan_torch.train import gan_step as tstep
from melogan_torch.utils import atomic, checkpoint, metrics, weights

TINY = dict(max_notes=64, batch_size=4, noise_dim=16, latent_dim=8, gen_hidden=32,
            encoder_hidden=(16, 8), encoder_out_dim=8, save_freq=2)
TINY_ED = dict(max_notes=64, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,))
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads, which made a 3 s test take
    minutes under pytest-xdist."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(rng, n, max_notes=64):
    pitch = rng.uniform(20, 110, (n, max_notes))
    pitch[:, -3:] = -1
    raw = np.stack([pitch, np.cumsum(rng.uniform(0, 1, (n, max_notes)), 1),
                    rng.uniform(0, 3, (n, max_notes)), rng.uniform(0, 127, (n, max_notes))],
                   -1).astype(np.float32)
    emotions = np.array(["happy", "sad", "angry", "calm"])[rng.integers(0, 4, n)]
    numeric = rng.normal(size=(n, 6)).astype(np.float32)
    return raw, emotions, numeric


def assert_trees_equal(ours, theirs, where=""):
    """Same keys, and leaves equal with the same dtype and shape."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), where
        for k in theirs:
            assert_trees_equal(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(theirs, (np.ndarray, np.generic)):
        assert type(ours) is type(theirs), where
        assert ours.dtype == theirs.dtype and np.shape(ours) == np.shape(theirs), where
        np.testing.assert_array_equal(ours, theirs, err_msg=where)
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_trees_equal(a, b, f"{where}[{i}]")
    else:
        assert type(ours) is type(theirs) and (ours == theirs or ours != ours), where


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


def _random_tree(seed):
    """A nested tree of every leaf kind, keys in a shuffled order."""
    r = np.random.default_rng(seed)
    dtypes = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.uint32, np.bool_]
    leaves = {}
    for i, dt in enumerate(dtypes):
        shape = tuple(int(s) for s in r.integers(1, 5, size=int(r.integers(0, 4))))
        a = r.normal(size=shape) * 100
        if np.dtype(dt).kind == "u":
            a = np.abs(a)
        leaves[f"arr_{np.dtype(dt).name}"] = (a > 0) if dt is np.bool_ else a.astype(dt)
        leaves[f"scalar_{i}"] = dt(a.reshape(-1)[0] if a.size else 1)
    leaves["zero_d"] = np.asarray(float(r.normal()), np.float32)
    leaves["ints"] = [int(x) for x in r.choice(np.array(_INTS, dtype=object), 8)]
    leaves["floats"] = [float(x) for x in r.normal(size=3)] + [0.0, -1.5, float("inf")]
    leaves["text"] = ["", "é" * int(r.integers(0, 40)), "♪" * 100, "x" * 300]
    leaves["misc"] = [True, False, None, b"\x00\x01" * int(r.integers(1, 200)), 3 - 4j]
    keys = list(leaves)
    r.shuffle(keys)
    return {"outer": {k: leaves[k] for k in keys},
            "wide": {f"k{j}": j for j in r.permutation(20)},
            "long": list(range(int(r.integers(16, 40)))),
            "big": r.normal(size=(300, 300)).astype(np.float32),
            "empty": {}}


CODEC_CASES = [
    {"a": np.arange(6, dtype=np.float32).reshape(2, 3)},
    {"n": _INTS},
    {"s": [np.float32(1.5), np.int64(-3), np.bool_(True), np.uint8(7), np.float64(2.0)]},
    {"zero_d": [np.asarray(v, dt) for v, dt in ((1.5, np.float32), (2, np.int64), (True, np.bool_),
                                                 (3, np.int32), (4, np.uint8), (5, np.uint32))]},
    {"u": "héllo ♪ " * 50, "t": "x" * 70000, "b": b"y" * 70000},
    {"map": {str(i): {"v": i} for i in range(70)}},
    {"mid": np.zeros(1000, np.float32), "large": np.ones((130, 130), np.float64)},
    _random_tree(0),
    _random_tree(1),
    _random_tree(2),
]


@pytest.mark.parametrize("tree", CODEC_CASES)
def test_codec_bytes_equal_flax_and_both_read_both(tree):
    ours = checkpoint.msgpack_serialize(tree)
    theirs = serialization.msgpack_serialize(tree)
    assert ours == theirs
    assert_trees_equal(checkpoint.msgpack_restore(theirs), serialization.msgpack_restore(theirs))
    assert_trees_equal(serialization.msgpack_restore(ours), checkpoint.msgpack_restore(ours))


def test_codec_refuses_what_flax_refuses():
    for bad in ({"t": (1, 2)}, {"o": object()}, {"i": 2**64}):
        with pytest.raises((TypeError, OverflowError)):
            checkpoint.msgpack_serialize(bad)
        with pytest.raises((TypeError, OverflowError)):
            serialization.msgpack_serialize(bad)
    with pytest.raises(ValueError, match="extra data"):
        checkpoint.msgpack_restore(serialization.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(serialization.msgpack_serialize({"a": np.ones(9)})[:-3])


def test_chunked_arrays_both_ways(monkeypatch):
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    r = np.random.default_rng(3)
    tree = {"w": r.normal(size=(40, 30)).astype(np.float32),  # 19 chunks of 64
            "small": np.arange(8, dtype=np.int64),
            "deep": {"v": r.integers(0, 9, size=(700,)).astype(np.uint8)}}
    ours = checkpoint.msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in ours
    for data in (ours, serialization.msgpack_serialize(tree)):
        assert_trees_equal(checkpoint.msgpack_restore(data), tree)
        assert_trees_equal(serialization.msgpack_restore(data), tree)


def test_save_checkpoint_writes_the_jax_files_bytes(tmp_path):
    """Python scalars, tuples, lists and tensors are converted as JAX's
    ``_to_host`` and ``to_state_dict`` convert them."""
    r = np.random.default_rng(4)
    tree = {"epoch": 7, "lr": 0.5, "flag": True, "none": None,
            "adam": ({"count": np.asarray(3, np.int32), "mu": {"w": r.normal(size=(3, 2))}}, {}),
            "seq": [np.float32(1.0), {"b": 2, "a": [3, 4]}],
            "emotion_features": r.normal(size=(4, 6)).astype(np.float32)}
    ours, theirs = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    checkpoint.save_checkpoint(str(ours), dict(tree, w=torch.arange(5.0)))
    jckpt.save_checkpoint(str(theirs), dict(tree, w=np.arange(5.0, dtype=np.float32)))
    assert ours.read_bytes() == theirs.read_bytes()
    loaded = checkpoint.load_checkpoint(str(theirs))
    assert_trees_equal(loaded, jckpt.load_checkpoint(str(theirs)))
    assert loaded["epoch"].dtype == np.int64 and loaded["epoch"].shape == ()
    checkpoint.load_checkpoint(str(theirs), target={"adam": {"0": {"mu": {"w": np.zeros((3, 2))}}}})
    with pytest.raises(ValueError, match="/adam/0/mu/w"):
        checkpoint.load_checkpoint(str(theirs), target={"adam": {"0": {"mu": {"w": np.zeros((2, 3))}}}})
    with pytest.raises(ValueError, match="/nope"):
        checkpoint.load_checkpoint(str(theirs), target={"nope": 1})


def test_latest_checkpoint_equals_jax(tmp_path):
    assert checkpoint.latest_checkpoint(str(tmp_path / "missing"), "gan_epoch") is None
    assert checkpoint.latest_checkpoint(str(tmp_path), "gan_epoch") is None
    for name in ("gan_epoch0002.ckpt", "gan_epoch0010.ckpt", "gan_epoch0009.ckpt",
                 "gan_final.ckpt", "gan_epoch0011.pth", "other0099.ckpt"):
        (tmp_path / name).write_bytes(b"")
    for prefix in ("gan_epoch", "gan_", "other", "none"):
        assert (checkpoint.latest_checkpoint(str(tmp_path), prefix)
                == jckpt.latest_checkpoint(str(tmp_path), prefix))
    assert checkpoint.latest_checkpoint(str(tmp_path), "gan_epoch").endswith("gan_epoch0010.ckpt")


@pytest.mark.parametrize("module", [atomic, jatomic])
def test_atomic_write_keeps_the_old_file_on_failure(tmp_path, module):
    path = tmp_path / "out.bin"
    module.atomic_write(str(path), lambda f: f.write(b"old"), mode="wb")

    def fail(f):
        f.write(b"partial")
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        module.atomic_write(str(path), fail, mode="wb")
    assert path.read_bytes() == b"old"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.bin"]
    module.atomic_write(str(path), lambda f: f.write("new"))
    assert path.read_text() == "new"


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def _reference_state_dicts():
    """Random reference-layout state dicts of each converted model at small
    widths: the port's modules for the GAN and the ED (BatchNorm statistics
    randomized), and the VAE's keys with random arrays of matching shapes."""
    g = torch.Generator().manual_seed(5)
    models = tstep.build_models(GANConfig(**TINY), EDConfig(**TINY_ED))
    sds = {}
    for kind, module in (("generator", models.generator), ("critic", models.critic),
                         ("feature_encoder", models.feature_encoder), ("ed", models.ed)):
        sds[kind] = {k: (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point() else v).numpy()
                     for k, v in module.state_dict().items()}
    r = np.random.default_rng(5)

    def arr(*shape):
        return r.normal(size=shape).astype(np.float32)

    vae = {}
    for prefix, shape in [("encoder.conv.0", (32, 4, 5)), ("encoder.conv.3", (64, 32, 5)),
                          ("encoder.conv.6", (128, 64, 5)), ("encoder._linear.1", (16, 256)),
                          ("fc_mu", (8, 16)), ("fc_log_var", (8, 16)), ("decoder.pre.0", (32, 8)),
                          ("decoder.pre.2", (512, 32)), ("decoder.deconv.0", (256, 128, 5)),
                          ("decoder.deconv.3", (128, 64, 5)), ("decoder.deconv.6", (64, 4, 5))]:
        vae[f"{prefix}.weight"], vae[f"{prefix}.bias"] = arr(*shape), arr(shape[0])
    for prefix, c in [("encoder.conv.1", 32), ("encoder.conv.4", 64), ("encoder.conv.7", 128),
                      ("decoder.deconv.1", 128), ("decoder.deconv.4", 64)]:
        for k in ("weight", "bias", "running_mean", "running_var"):
            vae[f"{prefix}.{k}"] = arr(c)
    sds["vae"] = vae
    return sds


def test_converters_equal_the_jax_originals_and_invert_export():
    for kind, sd in _reference_state_dicts().items():
        kw = {"notes_blocks": 2, "mlp_hidden": 1} if kind == "ed" else {}
        if kind == "feature_encoder":
            kw = {"hidden_layers": 2}
        ours = getattr(weights, f"convert_{kind}")(sd, **kw)
        assert_trees_equal(ours, getattr(torch_interop, f"convert_{kind}")(sd, **kw), kind)
        if kind == "vae":  # the port has no VAE yet, so no export_vae
            continue
        # export ∘ convert and convert ∘ export are the identity
        back = getattr(weights, f"export_{kind}")(ours)
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):  # JAX has no slot; exported as 0
                np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert_trees_equal(getattr(weights, f"convert_{kind}")(back, **kw), ours, kind)
    sds = _reference_state_dicts()
    final = {"G": sds["generator"], "E_num": sds["feature_encoder"]}
    for ours, theirs in zip(weights.convert_gan_final(final), torch_interop.convert_gan_final(final)):
        assert_trees_equal(ours, theirs)
    # a parameters-only tree (Adam's moments) maps its parameters alone
    params = weights.convert_generator(sds["generator"])["params"]
    params_sd = weights.export_generator({"params": params})
    assert not any("running" in k or "num_batches" in k for k in params_sd)
    assert_trees_equal(weights.convert_generator(params_sd)["params"], params)


# ---------------------------------------------------------------------------
# Port → JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port ``train()`` of 2 epochs with EMA 0.9 on the CPU (1 group step
    and a 2-batch tail an epoch): its workdir, config and data."""
    rng = np.random.default_rng(11)
    raw, emotions, numeric = _corpus(rng, 4 * 7 + 3)
    workdir = tmp_path_factory.mktemp("port_run")
    cfg = GANConfig(**dict(TINY, ema_decay=0.9))
    state, _ = gan_loop.train(cfg, EDConfig(**TINY_ED), SplitData(raw, emotions, numeric, []),
                              workdir=str(workdir), epochs=2, verbose=False, device="cpu")
    return workdir, cfg, (raw, emotions, numeric), state


def test_jax_restores_and_resumes_from_a_port_checkpoint(port_run, tmp_path):
    workdir, cfg, (raw, emotions, numeric), state = port_run
    ckpt_dir = workdir / cfg.checkpoint_dir
    raw_tree = jckpt.load_checkpoint(str(ckpt_dir / "gan_epoch0002.ckpt"))
    jcfg = JaxGANConfig(**dict(TINY, ema_decay=0.9))
    jstate = jstep.init_state(jcfg, jstep.build_models(jcfg, JaxEDConfig(**TINY_ED)), seed=0)
    fields = {"gen_params": ("G", "params"), "gen_stats": ("G", "batch_stats"),
              "critic_params": ("D", "params"), "fe_params": ("E_num", "params"),
              "opt_g": ("opt_G",), "opt_d": ("opt_D",), "ema_params": ("ema_raw",)}

    def layout(tree):
        return jax.tree_util.tree_map(lambda x: (np.shape(x), np.asarray(x).dtype),
                                      serialization.to_state_dict(tree))

    for field, keys in fields.items():
        src = raw_tree
        for k in keys:
            src = src[k]
        restored = serialization.from_state_dict(getattr(jstate, field), src)
        assert layout(restored) == layout(getattr(jstate, field)), field
    assert int(raw_tree["step"]) == state.step == 2 and int(raw_tree["epoch"]) == 2
    assert raw_tree["step"].dtype == np.int32 and raw_tree["opt_G"]["0"]["count"].dtype == np.int32
    assert int(raw_tree["opt_G"]["0"]["count"]) == 2 and int(raw_tree["opt_D"]["0"]["count"]) == 2 * 7
    assert "rng" not in raw_tree and "torch_rng" in raw_tree

    # the JAX loop resumes from it and trains a third epoch
    resumed = tmp_path / "resumed"
    (resumed / cfg.checkpoint_dir).mkdir(parents=True)
    (resumed / cfg.checkpoint_dir / "gan_epoch0002.ckpt").write_bytes(
        (ckpt_dir / "gan_epoch0002.ckpt").read_bytes())
    jnew, hist = jloop.train(jcfg, JaxEDConfig(**TINY_ED), jdata.SplitData(raw, emotions, numeric, []),
                             workdir=str(resumed), epochs=3, verbose=False, resume=True)
    assert int(jnew.step) == 3 and hist["epoch"] == 3
    assert all(np.isfinite(v) for v in hist.values())


def test_jax_samples_the_port_gan_final_ckpt(port_run, rng):
    """JAX ``load_gan_final_full`` reads the port's ``gan_final.ckpt`` (EMA
    on), and JAX sampling on it matches the port's on the same features and
    noise (1e-4 of the scale, as in tests/test_torch_sampling.py)."""
    workdir, cfg, _, state = port_run
    path = str(workdir / cfg.checkpoint_dir / "gan_final.ckpt")
    gen_vars, fe_vars, extras = jloop.load_gan_final_full(path, ema=True)
    ours_g, ours_fe, ours_extras = weights.load_gan_final_full(path, ema=True)
    np.testing.assert_array_equal(extras["emotion_features"], ours_extras["emotion_features"])
    for name, v in tstep.ema_weights(state, cfg.ema_decay).items():
        torch.testing.assert_close(ours_g[name], v, rtol=0, atol=0)
    jcfg = JaxGANConfig(**dict(TINY, ema_decay=0.9))
    models = jstep.build_models(jcfg, JaxEDConfig(**TINY_ED))
    feats = rng.normal(size=(4, 6)).astype(np.float32)
    noise = rng.normal(size=(4, jcfg.noise_dim)).astype(np.float32)
    emb = models.feature_encoder.apply(fe_vars, jnp.asarray(feats), train=False)
    theirs, _ = models.generator.apply(gen_vars, jnp.asarray(noise), None, emb, train=False)
    ours = Sampler(cfg, gen_variables=ours_g, fe_variables=ours_fe, device="cpu").sample_from(feats, noise)
    theirs = np.asarray(theirs)
    assert np.abs(ours - theirs).max() <= REL * np.abs(theirs).max()


def test_gan_final_converts_both_ways(port_run, tmp_path):
    workdir, cfg, _, _ = port_run
    ckpt_dir = workdir / cfg.checkpoint_dir
    pth, ckpt = str(ckpt_dir / "gan_final.pth"), str(ckpt_dir / "gan_final.ckpt")
    # train() wrote the same weights in both formats
    a, b = weights.read_gan_final(pth), weights.read_gan_final(ckpt)
    for part in ("G", "E_num", "G_ema"):
        for k, v in a[part].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, b[part][k]), (part, k)
    # .pth → .ckpt writes the JAX layout byte for byte; .ckpt → .pth → .ckpt too
    weights.convert_gan_final_file(pth, str(tmp_path / "from_pth.ckpt"))
    assert (tmp_path / "from_pth.ckpt").read_bytes() == open(ckpt, "rb").read()
    weights.main(["convert", ckpt, str(tmp_path / "back.pth")])
    weights.convert_gan_final_file(str(tmp_path / "back.pth"), str(tmp_path / "again.ckpt"))
    assert (tmp_path / "again.ckpt").read_bytes() == open(ckpt, "rb").read()
    back = torch.load(str(tmp_path / "back.pth"), weights_only=True)
    assert set(back) == {"G", "E_num", "G_ema", "emotion_features"}
    weights.write_gan_final(str(tmp_path / "plain.ckpt"), {"G": a["G"], "E_num": a["E_num"]})
    with pytest.raises(KeyError, match="rerun training with --ema"):
        weights.load_gan_final(str(tmp_path / "plain.ckpt"), ema=True)


# ---------------------------------------------------------------------------
# Metrics and the quality gate
# ---------------------------------------------------------------------------


def _records(path):
    return [(r["tag"], r["value"], r["step"]) for r in map(json.loads, open(path))]


def test_metrics_writer_equals_jax(port_run, tmp_path):
    """The same scalars through both writers give the same tags, steps and
    values; each package's ``read_tfevents`` reads both event files."""
    workdir, cfg, _, _ = port_run
    log_dir = workdir / cfg.log_dir
    recs = _records(log_dir / "metrics.jsonl")
    want_tags = {"Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo", "Critic/Wasserstein",
                 "Critic/d_real", "Critic/d_fake", "Critic/gp", "epoch_seconds"}
    assert {t for t, _, _ in recs} == want_tags and {s for _, _, s in recs} == {1, 2}
    out = {}
    for name, mod in (("ours", metrics), ("theirs", jmetrics)):
        with mod.MetricsWriter(str(tmp_path / name)) as w:
            for tag, value, step in recs:
                w.add_scalar(tag, value, step)
        out[name] = tmp_path / name
    assert _records(out["ours"] / "metrics.jsonl") == _records(out["theirs"] / "metrics.jsonl") == recs
    events = {n: [str(p) for p in d.iterdir() if p.name.startswith("events.out")][0] for n, d in out.items()}
    train_events = [str(p) for p in log_dir.iterdir() if p.name.startswith("events.out")][0]
    for reader in (metrics.read_tfevents, jmetrics.read_tfevents):
        got = [reader(events["ours"]), reader(events["theirs"])]
        assert got[0] == got[1] and len(got[0]) == len(recs)
        assert [(t, s) for t, _, s in reader(train_events)] == [(t, s) for t, _, s in recs]
    assert metrics.crc32c(b"123456789") == jmetrics.crc32c(b"123456789") == 0xE3069283


def test_quality_gate_equals_jax(tmp_path):
    s = Sampler(GANConfig(), seed=0, device="cpu")
    paths = [str(tmp_path / f"gate_{e}_{i}.mid") for e in EMOTIONS for i in (1, 2)]
    s.generate_many([os.path.basename(p).split("_")[1] for p in paths], paths, seed=3,
                    bpms=[95.0, 140.0, 70.0, 200.0, 160.0, 150.0, 90.0, 60.0])
    (tmp_path / "broken.mid").write_bytes(b"MThd\x00")
    ours, theirs = quality.gate_directory(str(tmp_path)), jquality.gate_directory(str(tmp_path))
    assert ours == theirs
    assert len(ours["files"]) == 9 and not ours["ok"]
    for tier in ("default", "strict"):
        assert quality.derive_bands([f for f in ours["files"].values() if "tempo_bpm" in f], tier) == \
            jquality.derive_bands([f for f in ours["files"].values() if "tempo_bpm" in f], tier)
    assert (quality.COMMON_BANDS, quality.EMOTION_BANDS, quality.STRICT_COMMON_BANDS,
            quality.STRICT_EMOTION_BANDS) == (jquality.COMMON_BANDS, jquality.EMOTION_BANDS,
                                              jquality.STRICT_COMMON_BANDS, jquality.STRICT_EMOTION_BANDS)
    (tmp_path / "none").mkdir()
    assert quality.gate_directory(str(tmp_path / "none")) == jquality.gate_directory(str(tmp_path / "none"))


def test_track_best_writes_and_keeps_gan_best(rng, tmp_path, monkeypatch):
    """``gan_best.ckpt`` holds the gate's winner with its ``gate`` dict; a
    resumed run keeps an existing best it does not beat."""
    raw, emotions, numeric = _corpus(rng, 4 * 7 + 3)
    data = SplitData(raw, emotions, numeric, [])
    cfg, ed_cfg = GANConfig(**dict(TINY, ema_decay=0.9)), EDConfig(**TINY_ED)
    state, _ = gan_loop.train(cfg, ed_cfg, data, workdir=str(tmp_path), epochs=2, verbose=False,
                              track_best=True, gate_samples_per_emotion=1, device="cpu")
    ckpt_dir = tmp_path / cfg.checkpoint_dir
    best = checkpoint.load_checkpoint(str(ckpt_dir / "gan_best.ckpt"))
    assert set(best) == {"epoch", "G", "E_num", "gate", "emotion_features", "G_ema"}
    assert int(best["epoch"]) == 2 and int(best["gate"]["total"]) == 4
    assert 0 <= int(best["gate"]["passed"]) <= 4 and int(best["gate"]["violations"]) >= 0
    assert len(os.listdir(tmp_path / cfg.sample_dir / "gate_epoch0002")) == 4
    gen_sd, _ = gan_loop.load_gan_final(str(ckpt_dir / "gan_best.ckpt"), ema=True)
    for name, v in tstep.ema_weights(state, cfg.ema_decay).items():
        assert torch.equal(gen_sd[name], v), name
    logged = _records(tmp_path / cfg.log_dir / "metrics.jsonl")
    assert [(t, s) for t, _, s in logged if t.startswith("Gate/")] == [("Gate/passed", 2), ("Gate/violations", 2)]

    # an unbeatable best survives a resumed run that gates epoch 4
    best["gate"] = {"passed": 99, "total": 4, "violations": 0}
    checkpoint.save_checkpoint(str(ckpt_dir / "gan_best.ckpt"), best)
    gan_loop.train(cfg, ed_cfg, data, workdir=str(tmp_path), epochs=4, verbose=False, resume=True,
                   track_best=True, gate_samples_per_emotion=1, device="cpu")
    kept = checkpoint.load_checkpoint(str(ckpt_dir / "gan_best.ckpt"))
    assert int(kept["gate"]["passed"]) == 99 and int(kept["epoch"]) == 2
    assert (tmp_path / cfg.sample_dir / "gate_epoch0004").is_dir()

    # a perfect gate at epoch 6 replaces it
    monkeypatch.setattr(quality, "gate_directory", lambda d: {
        "files": {f"f{i}": {"violations": []} for i in range(100)}})
    gan_loop.train(cfg, ed_cfg, data, workdir=str(tmp_path), epochs=6, verbose=False, resume=True,
                   track_best=True, gate_samples_per_emotion=1, device="cpu")
    new = checkpoint.load_checkpoint(str(ckpt_dir / "gan_best.ckpt"))
    assert int(new["epoch"]) == 6 and int(new["gate"]["passed"]) == 100


def test_unported_train_options_raise(tmp_path):
    raw, emotions, numeric = _corpus(np.random.default_rng(0), 8)
    data = SplitData(raw, emotions, numeric, [])
    # bf16 precision is ported (tests/test_torch_precision.py); a spectral-norm
    # model is refused, as the JAX loop cannot train one (ROADMAP C.5)
    # the mesh is ported (tests/test_torch_parallel.py): anything but a Mesh is refused
    cases = (({"mesh": object()}, TypeError, "mesh"),
             ({"precision": "fp16"}, ValueError, "precision"),
             ({"cfg": GANConfig(**dict(TINY, encoder_use_sn=True))}, NotImplementedError, "spectral"))
    for kw, err, what in cases:
        cfg = kw.pop("cfg", GANConfig(**TINY))
        with pytest.raises(err, match=what):
            gan_loop.train(cfg, EDConfig(**TINY_ED), data, workdir=str(tmp_path),
                           epochs=1, verbose=False, device="cpu", **kw)
