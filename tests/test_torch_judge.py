"""The port's judge against the JAX package's, and the slice end to end on
the CPU: a corpus on disk, the ED trained by the port, the warm-start GAN
trained against that ED, the judge trained on the held-out split and
scoring real and generated music.

The judge's report is compared exactly: both packages score in IEEE f32
(logits agree to about 1e-6 of their scale here), and the predicted classes
on random-weight EDs are far from ties at these sizes.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from melogan_tpu.config import EDConfig as JEDConfig
from melogan_tpu.diagnostics import judge as jjudge
from melogan_tpu.models import ed as jed
from melogan_tpu.train import ed_loop as jloop
from melogan_tpu.utils import torch_interop

from melogan_torch import EMOTIONS
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.data import preprocess as tpre
from melogan_torch.data import splits as tsplits
from melogan_torch.data import synthetic as tsyn
from melogan_torch.diagnostics import judge
from melogan_torch.models.ed import EmotionDiscriminator
from melogan_torch.sampling import Sampler
from melogan_torch.train import ed_loop, gan_loop
from melogan_torch.utils import checkpoint as tckpt
from melogan_torch.utils import weights

SMALL = dict(max_notes=64, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,), batch_size=8)
GAN_SMALL = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(jax.device_get(x))


def _port_judge(jcfg, cfg, seed=0):
    """A JAX judge state at its init (BN statistics moved off (0, 1)) and
    the port's state on the same weights."""
    model = jed.EmotionDiscriminator.from_config(jcfg)
    jstate = jloop.init_state(jcfg, model, seed=seed)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(_np, jstate.batch_stats)
    for blk in stats["encoder"].values():
        s = blk["TorchBatchNorm_0"]
        s["mean"] = rng.normal(0, 0.1, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    jstate = jstate.replace(batch_stats=stats)
    tm = EmotionDiscriminator.from_config(cfg)
    tm.load_state_dict(weights.to_tensors(weights.export_ed(
        {"params": jax.tree_util.tree_map(_np, jstate.params), "batch_stats": stats})), strict=True)
    return jstate, ed_loop.init_state(cfg, model=tm, device="cpu")


@pytest.mark.parametrize("epochs", [None, 3])
@pytest.mark.parametrize("ckpt,log", [("data/models/ed", "data/experiments/ed"), ("ed", "logs/ed/"), ("", "")])
def test_judge_config_equals_jax(epochs, ckpt, log):
    for mode in ("notes", "latent"):
        kw = dict(input_mode=mode, seed=5, num_epochs=7, checkpoint_dir=ckpt, log_dir=log)
        ours = judge.judge_config(EDConfig(**kw), epochs)
        theirs = jjudge.judge_config(JEDConfig(**kw), epochs)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert judge.JUDGE_SEED_OFFSET == jjudge.JUDGE_SEED_OFFSET


def test_judge_notes_matches_jax(rng):
    """``judge_notes`` on the same weights and notes: the whole report
    (accuracy, chance, per-emotion counts and accuracies, confusion)
    equal, and the judge's mode restored."""
    jcfg, cfg = JEDConfig(**SMALL), EDConfig(**SMALL)
    jstate, state = _port_judge(jcfg, cfg)
    notes = rng.normal(size=(19, 64, 4)).astype(np.float32)
    labels = np.array([0, 1, 2, 3] * 4 + [0, 0, 1])
    theirs = jjudge.judge_notes(jcfg, jstate, notes, labels)
    ours = judge.judge_notes(cfg, state, notes, labels)
    assert ours == theirs
    assert state.model.training
    assert sum(r["n"] for r in ours["per_emotion"].values()) == 19
    # an emotion without rows reports no accuracy, as JAX's does
    assert judge.judge_notes(cfg, state, notes[:3], labels[:3]) == jjudge.judge_notes(
        jcfg, jstate, notes[:3], labels[:3])


def test_judge_generated_is_deterministic_and_near_chance_for_random_G(rng):
    """Fresh samples of a random-weight generator: the same report twice
    for a seed, another seed's samples judged too, and at most one target
    class can score (an untrained G emits one near-constant pattern)."""
    jcfg, cfg = JEDConfig(**SMALL), EDConfig(**SMALL)
    _, state = _port_judge(jcfg, cfg, seed=1)
    sampler = Sampler(GANConfig(**GAN_SMALL), seed=0, device="cpu")
    r1 = judge.judge_generated(cfg, state, sampler, n_per_emotion=4, seed=7)
    r2 = judge.judge_generated(cfg, state, sampler, n_per_emotion=4, seed=7)
    assert r1 == r2 and r1["n"] == 16 and r1["n_per_emotion"] == 4 and r1["seed"] == 7
    assert r1["accuracy"] <= 0.5
    assert np.asarray(r1["confusion"]).sum() == 16
    # the report is judge_notes of the sampler's own samples
    notes = sampler.sample_notes([e for e in EMOTIONS for _ in range(4)], seed=7)
    report = judge.judge_notes(cfg, state, notes, np.repeat(np.arange(4), 4))
    assert {k: v for k, v in r1.items() if k not in ("n_per_emotion", "seed")} == report


def test_the_slice_end_to_end(tmp_path):
    """A synthetic corpus on disk, preprocessed and split; the port trains
    the ED on train (``ed_best.ckpt``, read by JAX's exporter into the same
    state dict); the warm-start GAN trains 1 epoch against that ED (its ED
    feature-matching targets on); the judge trains on val with test as its
    validation, is calibrated on the real test rows (the report equal to
    JAX's on the same weights) and judges fresh samples of the trained
    ``gan_final.ckpt``."""
    root = str(tmp_path)
    entries = tsyn.generate_corpus(root, n_per_emotion=8, seed=1, n_notes=64)
    tpre.preprocess_corpus(entries, os.path.join(root, "processed"), max_notes=64, verbose=False)
    tsplits.create_splits(tsplits.read_manifest(os.path.join(root, "data_manifest.csv")),
                          os.path.join(root, "splits"))
    train_d, val_d, test_d = (tdata.load_split(os.path.join(root, "splits", f"{s}_split.csv"),
                                               os.path.join(root, "processed"), verbose=False)
                              for s in ("train", "val", "test"))
    ed_cfg = EDConfig(**dict(SMALL, num_epochs=3, save_freq=2))
    ed_state, ed_metrics = ed_loop.train(ed_cfg, train_d, val_d, workdir=root, verbose=False, device="cpu")
    assert set(ed_metrics) == {"epoch", "val_loss", "val_acc"}
    best_path = os.path.join(root, ed_cfg.checkpoint_dir, "ed_best.ckpt")
    raw = tckpt.load_checkpoint(best_path)
    ed_sd = weights.export_ed({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    theirs = torch_interop.export_ed({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    assert set(ed_sd) == set(theirs) and all(np.array_equal(ed_sd[k], theirs[k]) for k in theirs)
    for k, v in ed_state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(v.numpy(), ed_sd[k]), k

    gan_cfg = GANConfig(**dict(GAN_SMALL, batch_size=4, critic_iters=2, lambda_fm=1.0))
    gan_state, hist = gan_loop.train(gan_cfg, ed_cfg, train_d, ed_variables=ed_sd, workdir=root, epochs=1,
                                     verbose=False, device="cpu")
    assert hist["epoch"] == 1 and np.isfinite(hist["Loss/Generator_FM"])
    for k, v in gan_state.ed.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(v.numpy(), ed_sd[k]), k

    jcfg, judge_state = judge.train_judge(ed_cfg, val_d, test_d, workdir=root, epochs=2, device="cpu")
    assert os.path.exists(os.path.join(root, jcfg.checkpoint_dir, "ed_best.ckpt"))
    assert jcfg.checkpoint_dir != ed_cfg.checkpoint_dir and jcfg.num_epochs == 2
    real = judge.judge_notes(jcfg, judge_state, test_d.notes_gan(), test_d.emotion_idx)
    assert real["n"] == test_d.n and np.asarray(real["confusion"]).sum() == test_d.n
    jj = JEDConfig(**dict(SMALL, input_mode="notes"))
    model = jed.EmotionDiscriminator.from_config(jj)
    js = jloop.init_state(jj, model)
    conv = weights.convert_ed({k: v.numpy() for k, v in judge_state.model.state_dict().items()},
                              notes_blocks=2, mlp_hidden=1)
    js = js.replace(params=serialization.from_state_dict(js.params, conv["params"]),
                    batch_stats=serialization.from_state_dict(js.batch_stats, conv["batch_stats"]))
    assert real == jjudge.judge_notes(jcfg, js, test_d.notes_gan(), test_d.emotion_idx)

    final = os.path.join(root, gan_cfg.checkpoint_dir, "gan_final.ckpt")
    gen_sd, fe_sd, extras = weights.load_gan_final_full(final)
    sampler = Sampler(gan_cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                      emotion_features=extras["emotion_features"], device="cpu")
    report = judge.judge_generated(jcfg, judge_state, sampler, n_per_emotion=2, seed=3)
    assert report["n"] == 8 and set(report["per_emotion"]) == set(EMOTIONS)
    assert 0.0 <= report["accuracy"] <= 1.0 and report["chance"] == 0.25
    np.testing.assert_array_equal(jnp.asarray(report["confusion"]).sum(axis=1), [2, 2, 2, 2])
