"""The port's population sweep against the JAX package's, and against the
port's own solo ``train()`` (CPU, small widths).

- ``HyperParams`` and one hyper group + tail step against JAX's, with JAX's
  draws injected, at the tolerances of ``tests/test_torch_train.py``
  (``test_group_and_tail_step_match_jax``; the reasons are in its module
  docstring).
- A member against a solo ``train()`` of the port: bit for bit (weights,
  BatchNorm statistics, Adam, steps, EMA, random stream, every history
  row), since the member runs the same epoch body on the same seeds.
- Halving and selection against JAX's ``sweep_gan`` with one scripted gate
  in both packages: the rung reports are equal.
- ``sweep_state.ckpt`` both ways with JAX, and straight-through against
  split-and-resumed, bit for bit.

JAX's side runs its Pallas kernels in interpret mode where a test turns
them on (``pallas_on``), else through XLA's convs, as its own tests do.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import EDConfig as JaxEDConfig
from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.data import datasets as jdata
from melogan_tpu.sampling import Sampler as JaxSampler
from melogan_tpu.train import gan_loop as jloop
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.train import sweep as jsweep
from melogan_tpu.utils import checkpoint as jckpt
from melogan_tpu.utils import torch_interop

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.train import gan_loop as tloop
from melogan_torch.train import gan_step as tstep
from melogan_torch.train import sweep as tsweep
from melogan_torch.utils import checkpoint as tckpt
from melogan_torch.utils import weights

from tests.test_torch_train import (TINY, TINY_ED, _assert_states_equal, _batches, _check_group,
                                    _corpus, _critic_draws, _group_draws, _records, _setup,
                                    _torch_batches, assert_metrics, pallas_on)  # noqa: F401 (a fixture)

# 31 rows at batch 4: 7 batches, one group of 5 and a 2-batch tail an epoch
N_ROWS = 4 * 7 + 3
SWEEP_DIR = "experiments/gan/sweep"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU runs: more torch threads only contend with the other test
    workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    return _corpus(np.random.default_rng(11), N_ROWS)


def _tdata(corpus):
    return tdata.SplitData(*corpus, [])


def _jdata(corpus):
    return jdata.SplitData(*corpus, [])


def _cfg(**kw):
    return GANConfig(**{**TINY, "save_freq": 1, **kw})


def _jcfg(**kw):
    return JaxGANConfig(**{**TINY, "save_freq": 1, **kw})


def _sweep(cfg, corpus, workdir, seeds, **kw):
    return tsweep.sweep_gan(cfg, EDConfig(**TINY_ED), _tdata(corpus), seeds, workdir=str(workdir),
                            verbose=False, samples_per_emotion=1, device="cpu", **kw)


def _jsweep(cfg, corpus, workdir, seeds, **kw):
    return jsweep.sweep_gan(cfg, JaxEDConfig(**TINY_ED), _jdata(corpus), seeds, workdir=str(workdir),
                            verbose=False, samples_per_emotion=1, **kw)


def _state_path(workdir):
    return os.path.join(str(workdir), SWEEP_DIR, "sweep_state.ckpt")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _meta(raw):
    return json.loads(bytes(np.asarray(raw["meta"], np.uint8)).decode())


def _saved_members(cfg, workdir):
    """The population of a ``sweep_state.ckpt``, loaded into fresh port
    states (the config's own learning rates: they are not state)."""
    raw = tckpt.load_checkpoint(_state_path(workdir))
    states = [tstep.init_state(cfg, tstep.build_models(cfg, EDConfig(**TINY_ED)), seed=s, device="cpu")
              for s in _meta(raw)["seeds"]]
    assert weights.load_sweep_state(states, raw) is None  # a port file: its random streams too
    return states


def _assert_member_is_solo(member, curve, solo, solo_dir):
    _assert_states_equal(solo, member)
    for a, b in ((solo.ed, member.ed),):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(v, w), f"ed.{k}"
    assert (solo.ema_params is None) == (member.ema_params is None)
    for n in solo.ema_params or {}:
        assert torch.equal(solo.ema_params[n], member.ema_params[n]), n
    logged = {(r["tag"], r["step"]): r["value"] for r in _records(os.path.join(solo_dir, "metrics.jsonl"))}
    assert [row["epoch"] for row in curve] == sorted({s for _, s in logged})
    # the shared keys: a member of a grid with λ_fm > 0 somewhere also logs
    # the FM loss, which a solo run without feature matching does not
    for row in curve:
        shared = [key for key in row if (key, row["epoch"]) in logged]
        assert set(shared) >= {"Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo", "Critic/Wasserstein"}
        for key in shared:
            assert row[key] == logged[key, row["epoch"]], (key, row["epoch"])


# ---------------------------------------------------------------------------
# HyperParams and the hyper step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    {}, {"lr_g": 1e-4}, {"lr_d": 3e-4, "lambda_gp": 5.0}, {"lambda_emotion": 0.5, "lambda_fm": 1.0},
    {"lr_g": None, "lambda_gp": 2},
])
def test_hyper_params_from_config_match_jax(overrides):
    kw = dict(lr_g=3e-4, lambda_fm=0.25)
    ours = tstep.HyperParams.from_config(GANConfig(**kw), **overrides)
    theirs = jstep.HyperParams.from_config(JaxGANConfig(**kw), **overrides)
    assert ours._fields == theirs._fields
    assert ours._asdict() == theirs._asdict()


def test_hyper_params_refuse_unknown_fields_as_jax():
    for bad in ({"learning_rate": 1e-4}, {"lr_g": 1e-4, "beta1": 0.5, "zeta": 1}):
        with pytest.raises(ValueError) as ours:
            tstep.HyperParams.from_config(GANConfig(), **bad)
        with pytest.raises(ValueError) as theirs:
            jstep.HyperParams.from_config(JaxGANConfig(), **bad)
        assert str(ours.value) == str(theirs.value)


@pytest.fixture(scope="module")
def hyper_setup():
    """One JAX state, batches and draws; the JAX group and tail steps
    jitted once with the hyperparameters as traced arguments (the JAX
    sweep's use), with the note-space targets on so λ_fm acts."""
    rng = np.random.default_rng(5)
    jcfg, models, jstate, _, _, _ = _setup(rng, False, 0.0, 0.0)
    raw, emotions, _ = _corpus(rng, 24)
    notes = jdata.SplitData(raw, emotions, np.zeros((24, 6)), []).notes_gan()
    idx = np.array([jdata.EMOTION_TO_INDEX[e] for e in emotions])
    fm_target = jstep.fm_targets_from_data(notes, idx)
    batches = _batches(rng, jcfg, jcfg.critic_iters)
    tail = _batches(rng, jcfg, 2)

    def run(kind):
        return jax.jit(lambda s, b, h: getattr(
            jstep.make_train_steps(jcfg, models, hyper=h, fm_target=fm_target), kind)(s, b))

    return dict(jcfg=jcfg, models=models, jstate=jstate, fm_target=fm_target, batches=batches,
                tail=tail, group=run("group"), tail_fn=run("tail"))


# λ_gp is 5.0, not 2.5: at 2.5 a unit of the critic's third conv sits on a
# LeakyReLU kink in this draw, and JAX's two conv routes (Pallas in
# interpret mode, XLA) already differ there by 7.2e-6 after the group step,
# above the 1e-6-an-update tolerance; at 5.0 they agree to 6e-8
@pytest.mark.parametrize("field,value", [("lr_g", 8e-4), ("lr_d", 3e-4), ("lambda_gp", 5.0),
                                         ("lambda_emotion", 0.5), ("lambda_fm", 1.0)])
def test_hyper_group_and_tail_step_match_jax(hyper_setup, pallas_on, field, value):
    s = hyper_setup
    jcfg, models, jstate = s["jcfg"], s["models"], s["jstate"]
    cfg = GANConfig(**dict(TINY, fused_critic_batch=False))
    hyper = tstep.HyperParams.from_config(cfg, **{field: value})
    jhyper = jstep.HyperParams(*(jnp.float32(v) for v in hyper))
    tstate = tstep.init_state(cfg, tstep.build_models(cfg, EDConfig(**TINY_ED)), seed=0, device="cpu",
                              hyper=hyper)
    weights.load_jax_train_state(tstate, jstate)
    tsteps = tstep.make_train_steps(cfg, hyper=hyper, fm_target=s["fm_target"])

    draws = _group_draws(jcfg, models, jstate, s["batches"])
    jnew, jm = s["group"](jstate, tuple(jnp.asarray(a) for a in s["batches"]), jhyper)
    tstate, tm = tsteps.group(tstate, _torch_batches(s["batches"]), draws)
    assert tstate.step == int(jnew.step) == 1
    assert_metrics(tm, jm, f"group {field}")
    gen_mu, fe_mu = jnew.opt_g[0].mu
    _check_group(tstate.generator, tstate.opt_g,
                 torch_interop.export_generator({"params": gen_mu, "batch_stats": jnew.gen_stats}),
                 torch_interop.export_generator({"params": jnew.gen_params, "batch_stats": jnew.gen_stats}),
                 hyper.lr_g, 1, "G")
    _check_group(tstate.feature_encoder, tstate.opt_g,
                 torch_interop.export_feature_encoder({"params": fe_mu}),
                 torch_interop.export_feature_encoder({"params": jnew.fe_params}), hyper.lr_g, 1, "FE")
    _check_group(tstate.critic, tstate.opt_d,
                 torch_interop.export_critic({"params": jnew.opt_d[0].mu}),
                 torch_interop.export_critic({"params": jnew.critic_params}),
                 hyper.lr_d, jcfg.critic_iters, "critic")

    tail_draws, _ = _critic_draws(jcfg, models, jnew.fe_params, jnew.rng, s["tail"][3])
    jtail, jtm = s["tail_fn"](jnew, tuple(jnp.asarray(a) for a in s["tail"]), jhyper)
    tstate, ttm = tsteps.tail(tstate, _torch_batches(s["tail"]), tail_draws)
    assert_metrics(ttm, jtm, f"tail {field}")
    c_sd = torch_interop.export_critic({"params": jtail.critic_params})
    for name, p in tstate.critic.named_parameters():
        assert np.abs(p.detach().numpy() - c_sd[name]).max() <= 2 * hyper.lr_d * (jcfg.critic_iters + 2)


def test_hyper_path_at_defaults_is_bit_identical(corpus):
    """``HyperParams.from_config(cfg)`` trains exactly as ``cfg``: one epoch
    of each path from the same seed, with the states' own draws; and a
    learning rate set through it acts."""
    cfg = _cfg()
    data = _tdata(corpus)
    gather = tloop.device_gather((data.notes_gan(), data.emotion_idx.astype(np.int64),
                                  np.zeros((N_ROWS, cfg.latent_dim), np.float32),
                                  data.numeric.astype(np.float32)), torch.device("cpu"))
    gi, ti = tdata.epoch_group_indices(N_ROWS, cfg.batch_size, cfg.critic_iters, np.random.default_rng(0))

    def one_epoch(hyper):
        state = tstep.init_state(cfg, tstep.build_models(cfg, EDConfig(**TINY_ED)), seed=3, device="cpu",
                                 hyper=hyper)
        state, m, _, _ = tloop.run_epoch(tstep.make_train_steps(cfg, hyper=hyper), state, gather, gi, ti)
        return state, m

    baked, m_baked = one_epoch(None)
    hyper, m_hyper = one_epoch(tstep.HyperParams.from_config(cfg))
    _assert_states_equal(baked, hyper)
    assert m_baked == m_hyper
    hot, _ = one_epoch(tstep.HyperParams.from_config(cfg, lr_d=cfg.lr_d * 10))
    assert not torch.equal(hot.critic.real_fake.weight, baked.critic.real_fake.weight)


# ---------------------------------------------------------------------------
# A member is a solo run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seeds,grid,kw", [
    ([7, 11], None, {"ema_decay": 0.9}),
    ([7, 7, 7], [{}, {"lr_g": 8e-4, "lr_d": 3e-4, "lambda_emotion": 2.5}, {"lambda_fm": 1.0, "lambda_gp": 5.0}],
     {}),
], ids=["seeds_ema", "hyper_grid"])
def test_member_is_a_solo_train_bit_for_bit(corpus, tmp_path, seeds, grid, kw):
    """Member k against ``train()`` with ``cfg.seed = seeds[k]`` and the
    member's overrides: the population's ``sweep_state.ckpt`` after 2
    epochs, loaded into fresh states, equals each solo run's state, and
    the report's curve equals the solo run's logged scalars."""
    cfg = _cfg(**kw)
    report = _sweep(cfg, corpus, tmp_path / "sweep", seeds, epochs=2, hyper_grid=grid)
    members = _saved_members(cfg, tmp_path / "sweep")
    for k, seed in enumerate(seeds):
        solo_cfg = dataclasses.replace(cfg, seed=seed, **(grid[k] if grid else {}))
        solo_dir = tmp_path / f"solo{k}"
        solo, _ = tloop.train(solo_cfg, EDConfig(**TINY_ED), _tdata(corpus), workdir=str(solo_dir), epochs=2,
                              verbose=False, device="cpu")
        _assert_member_is_solo(members[k], report["results"][k]["curve"], solo,
                               str(solo_dir / cfg.log_dir))
        label = f"m{k}_seed{seed}" if grid else f"seed{seed}"
        assert report["results"][k]["checkpoint"] == str(tmp_path / "sweep" / SWEEP_DIR / label / "gan_final.ckpt")
    if grid:
        assert [r["hyper"] for r in report["results"]] == [
            tstep.HyperParams.from_config(cfg, **h)._asdict() for h in grid]
        # λ_fm > 0 in the grid: every member's row carries the FM loss
        assert all("Loss/Generator_FM" in r["final"] for r in report["results"])
    else:
        assert all(r["hyper"] is None for r in report["results"])


def test_report_promotion_and_finals_load_in_jax(corpus, tmp_path):
    cfg = _cfg(ema_decay=0.9)
    report = _sweep(cfg, corpus, tmp_path, [1, 2, 3], epochs=2, promote_best=True)
    assert set(report) == {"seeds", "results", "best_seed", "best_checkpoint", "promoted", "promoted_to"}
    assert report["seeds"] == [1, 2, 3] and report["promoted"]
    jcfg = _jcfg(ema_decay=0.9)
    sampler = None
    for r in report["results"]:
        assert set(r) == {"seed", "checkpoint", "hyper", "gate_passed", "gate_total", "gate_violations",
                          "final", "curve"}
        assert r["gate_total"] == 4 and 0 <= r["gate_passed"] <= 4 and len(r["curve"]) == 2
        assert set(r["curve"][0]) == {"epoch", "Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo",
                                      "Critic/Wasserstein"}
        assert os.path.basename(os.path.dirname(r["checkpoint"])) == f"seed{r['seed']}"
        assert set(tckpt.load_checkpoint(r["checkpoint"])) == {"G", "E_num", "emotion_features", "G_ema"}
        gen, fe = jloop.load_gan_final(r["checkpoint"], ema=True)
        live, _ = jloop.load_gan_final(r["checkpoint"])
        features = jckpt.load_checkpoint(r["checkpoint"])["emotion_features"]
        np.testing.assert_array_equal(features, tloop.emotion_centroids(
            corpus[2].astype(np.float32), _tdata(corpus).emotion_idx))
        if sampler is None:
            sampler = JaxSampler(jcfg, gen_variables=gen, fe_variables=fe, emotion_features=features)
        else:
            sampler.swap_variables(gen, fe, emotion_features=features)
        notes = sampler.sample_notes(["happy", "sad", "angry", "calm"], seed=1)
        assert notes.shape == (4, 64, 4) and np.isfinite(notes).all()
        assert any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(gen), jax.tree.leaves(live)))
    best = next(r for r in report["results"] if r["seed"] == report["best_seed"])
    assert report["best_checkpoint"] == best["checkpoint"]
    for r in report["results"]:
        assert (r["gate_passed"], -r["gate_violations"]) <= (best["gate_passed"], -best["gate_violations"])
    assert report["promoted_to"] == str(tmp_path / cfg.checkpoint_dir / "gan_final.ckpt")
    assert _read(report["promoted_to"]) == _read(best["checkpoint"])
    with open(tmp_path / SWEEP_DIR / "sweep_report.json") as f:
        assert json.load(f) == report


# ---------------------------------------------------------------------------
# Halving and selection against JAX's
# ---------------------------------------------------------------------------

# (rung directory, member id) → (files passed of 4, violations)
GATE_SCRIPT = {("rung0", 0): (1, 2), ("rung0", 1): (3, 1), ("rung0", 2): (3, 0), ("rung0", 3): (0, 5),
               ("rung1", 1): (2, 1), ("rung1", 2): (4, 0)}


def _scripted(out_dir):
    rung, label = os.path.basename(os.path.dirname(out_dir)), os.path.basename(out_dir)
    if rung.startswith("rung"):
        passed, violations = GATE_SCRIPT[rung, int(label[1:label.index("_")])]
    else:  # the final selection
        passed, violations = 4, 0
    return passed, 4, violations


def _jax_gate(cfg, member, seed, out_dir, samples_per_emotion, sampler, emotion_features=None):
    return (*_scripted(out_dir), {"params": member.gen_params}, {"params": member.fe_params}, sampler)


def _port_gate(cfg, state, seed, out_dir, samples_per_emotion, sampler, emotion_features=None):
    return (*_scripted(out_dir), None, None, sampler)


def test_halving_and_selection_match_jax(corpus, tmp_path, monkeypatch):
    """K = 4, rungs of 1 epoch, 2 epochs (4 → 2 → 1): the same gate results
    in both packages give the same rung reports (members, seeds,
    hyperparameters, epochs, survivors) and the same winner; the port's
    winner is its uninterrupted solo run, bit for bit."""
    monkeypatch.setattr(jsweep, "_gate_member", _jax_gate)
    monkeypatch.setattr(tsweep, "gate_member", _port_gate)
    seeds = [1, 2, 3, 4]
    grid = [{}, {"lr_g": 1e-4}, {"lambda_emotion": 2.5}, {}]
    kw = dict(epochs=2, halving=True, rung_epochs=1, hyper_grid=grid)
    theirs = _jsweep(_jcfg(), corpus, tmp_path / "jax", seeds, **kw)
    ours = _sweep(_cfg(), corpus, tmp_path / "port", seeds, **kw)

    assert ours["rungs"] == theirs["rungs"]
    assert [len(r["members"]) for r in ours["rungs"]] == [4, 2]
    assert [[m["member"] for m in r["members"] if m["survived"]] for r in ours["rungs"]] == [[1, 2], [2]]
    assert set(ours) == set(theirs)
    assert ours["seeds"] == theirs["seeds"] == [3] and ours["best_seed"] == theirs["best_seed"]
    (w,), (jw,) = ours["results"], theirs["results"]
    assert set(w) == set(jw) and w["hyper"] == jw["hyper"]
    assert [row["epoch"] for row in w["curve"]] == [row["epoch"] for row in jw["curve"]] == [1, 2]
    for a, b in ((tmp_path / "port", ours), (tmp_path / "jax", theirs)):
        with open(a / SWEEP_DIR / "sweep_report.json") as f:
            assert json.load(f)["rungs"] == b["rungs"]

    solo_cfg = dataclasses.replace(_cfg(), seed=3, lambda_emotion=2.5)
    solo, _ = tloop.train(solo_cfg, EDConfig(**TINY_ED), _tdata(corpus), workdir=str(tmp_path / "solo"),
                          epochs=2, verbose=False, device="cpu")
    (winner,) = _saved_members(_cfg(), tmp_path / "port")
    _assert_member_is_solo(winner, w["curve"], solo, str(tmp_path / "solo" / solo_cfg.log_dir))


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seeds,grid", [([3, 5], None), ([3, 3], [{}, {"lr_d": 3e-4, "lambda_gp": 5.0}])],
                         ids=["seeds", "hyper_grid"])
def test_resume_is_bit_identical_to_straight_through(corpus, tmp_path, seeds, grid):
    """3 epochs in one go against 2 epochs, then a resume to 3, in chunks of
    2: the same curves, finals and ``sweep_state.ckpt``, byte for byte."""
    cfg = _cfg(save_freq=2, ema_decay=0.9)
    straight = _sweep(cfg, corpus, tmp_path / "a", seeds, epochs=3, hyper_grid=grid)
    _sweep(cfg, corpus, tmp_path / "b", seeds, epochs=2, hyper_grid=grid)
    assert _meta(tckpt.load_checkpoint(_state_path(tmp_path / "b")))["done"] == 2
    resumed = _sweep(cfg, corpus, tmp_path / "b", seeds, epochs=3, hyper_grid=grid, resume=True)
    for rs, rr in zip(straight["results"], resumed["results"]):
        assert rs["curve"] == rr["curve"] and len(rs["curve"]) == 3
        assert _read(rs["checkpoint"]) == _read(rr["checkpoint"])
    assert _read(_state_path(tmp_path / "a")) == _read(_state_path(tmp_path / "b"))


def test_halving_resume_mid_rung_is_bit_identical(corpus, tmp_path, monkeypatch):
    """A halving sweep (rungs of 2 epochs, chunks of 1) that fails in the
    middle of rung 0's second chunk resumes from the first chunk's state
    into the run done in one go: rungs, winner, final and state file."""
    cfg = _cfg()
    kw = dict(epochs=4, halving=True, rung_epochs=2)
    seeds = [1, 2, 3, 4]
    straight = _sweep(cfg, corpus, tmp_path / "a", seeds, **kw)
    assert [len(r["members"]) for r in straight["rungs"]] == [4, 2]

    real = tsweep.run_epoch
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 6:  # member 1's epoch 2
            raise RuntimeError("interrupted")
        return real(*a, **k)

    monkeypatch.setattr(tsweep, "run_epoch", failing)
    with pytest.raises(RuntimeError, match="interrupted"):
        _sweep(cfg, corpus, tmp_path / "b", seeds, **kw)
    monkeypatch.setattr(tsweep, "run_epoch", real)
    meta = _meta(tckpt.load_checkpoint(_state_path(tmp_path / "b")))
    assert (meta["done"], meta["rung"], len(meta["seeds"])) == (1, 0, 4)
    resumed = _sweep(cfg, corpus, tmp_path / "b", seeds, resume=True, **kw)
    assert resumed["rungs"] == straight["rungs"]
    (ws,), (wr,) = straight["results"], resumed["results"]
    assert ws["curve"] == wr["curve"] and len(ws["curve"]) == 4
    assert _read(ws["checkpoint"]) == _read(wr["checkpoint"])
    assert _read(_state_path(tmp_path / "a")) == _read(_state_path(tmp_path / "b"))


def test_resume_refuses_another_sweep_or_a_corrupt_file_as_jax(corpus, tmp_path):
    _sweep(_cfg(), corpus, tmp_path, [3, 5], epochs=1)
    with pytest.raises(ValueError, match="belongs to a different sweep") as ours:
        _sweep(_cfg(), corpus, tmp_path, [3, 6], epochs=2, resume=True)
    with pytest.raises(ValueError) as theirs:
        _jsweep(_jcfg(), corpus, tmp_path, [3, 6], epochs=2, resume=True)
    assert str(ours.value) == str(theirs.value)
    for payload in (b"", b"garbage", np.random.default_rng(0).bytes(256)):
        with open(_state_path(tmp_path), "wb") as f:
            f.write(payload)
        with pytest.raises(ValueError, match="is unreadable .*; delete it to restart the sweep from "
                                             "scratch — per-member finals and the report are unaffected"):
            _sweep(_cfg(), corpus, tmp_path, [3, 5], epochs=2, resume=True)


def _stub_metrics(k, e):
    return {key: np.zeros((k, e), np.float32)
            for key in ("loss_d_sum", "loss_g_adv", "loss_g_emo", "d_real_sum", "d_fake_sum")}


@pytest.mark.parametrize("n_epochs,save_freq,every,offset", [
    (5, 2, None, 0), (5, 2, "2", 0), (7, 2, "3", 0), (4, 1, "2", 3), (3, 5, "2", 0),
])
def test_state_write_cadence_matches_jax(monkeypatch, n_epochs, save_freq, every, offset):
    """The chunks, the history's epochs and the ``sweep_state.ckpt`` writes
    (``MELOGAN_SWEEP_STATE_EVERY``) of both ``_train_population``s, with
    the training itself stubbed out."""
    if every is None:
        monkeypatch.delenv("MELOGAN_SWEEP_STATE_EVERY", raising=False)
    else:
        monkeypatch.setenv("MELOGAN_SWEEP_STATE_EVERY", every)
    seeds = [1, 2]
    jsaves, tsaves = [], []
    jhist, thist = [[], []], [[], []]
    jrngs = [np.random.default_rng(s) for s in seeds]
    trngs = [np.random.default_rng(s) for s in seeds]
    jsweep._train_population(
        lambda b, hp, data, g, t, live: (b, _stub_metrics(*g.shape[:2])), None, None, None,
        _jcfg(save_freq=save_freq), jrngs, seeds, n_epochs, jhist, lambda x: x, N_ROWS, False,
        epoch_offset=offset, save_cb=lambda b, done: jsaves.append(done))
    monkeypatch.setattr(tsweep, "run_epoch", lambda steps, state, gather, gi, ti: (
        state, {k: 0.0 for k in ("loss_d_sum", "loss_g_adv", "loss_g_emo", "d_real_sum", "d_fake_sum",
                                 "gp_mean")}, gi.shape[0], gi.size // gi.shape[-1] + ti.shape[0]))
    tsweep._train_population([None, None], [None, None], None, _cfg(save_freq=save_freq), trngs, seeds,
                             n_epochs, thist, N_ROWS, False, epoch_offset=offset, save_cb=tsaves.append)
    assert tsaves == jsaves and tsaves[-1] == offset + n_epochs
    assert thist == jhist
    for a, b in zip(trngs, jrngs):
        assert a.bit_generator.state == b.bit_generator.state


# ---------------------------------------------------------------------------
# sweep_state.ckpt across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def crossed(corpus, tmp_path_factory):
    """A sweep of seeds 3 and 5 with EMA across the packages: the port for
    epoch 1, then JAX's ``sweep_gan(resume=True)`` from the port's
    ``sweep_state.ckpt`` for epoch 2. The port's file (read before JAX
    writes over it), the reports and the workdir."""
    workdir = tmp_path_factory.mktemp("crossed")
    ours = _sweep(_cfg(ema_decay=0.9), corpus, workdir, [3, 5], epochs=1)
    port_raw = tckpt.load_checkpoint(_state_path(workdir))
    theirs = _jsweep(_jcfg(ema_decay=0.9), corpus, workdir, [3, 5], epochs=2, resume=True)
    return dict(workdir=workdir, port_raw=port_raw, ours=ours, theirs=theirs)


def test_jax_resumes_a_port_sweep_state_and_trains_on(crossed):
    """JAX restores the port's file with flax (the port's keys beside
    ``state`` are not read), keeps the port's history and trains epoch 2
    from the port's weights: its own state file then holds the port's
    frozen ED, and steps and Adam counts one epoch on."""
    port_raw, after = crossed["port_raw"], jckpt.load_checkpoint(_state_path(crossed["workdir"]))
    assert set(port_raw) == {"meta", "state", weights.TORCH_RNG_KEY, weights.TORCH_BN_KEY}
    np.testing.assert_array_equal(port_raw["state"]["rng"], [[0, 4], [0, 6]])  # PRNGKey(seed + 1)
    for r, jr in zip(crossed["ours"]["results"], crossed["theirs"]["results"]):
        assert jr["curve"][0] == r["curve"][0] and [row["epoch"] for row in jr["curve"]] == [1, 2]
    assert _meta(after)["done"] == 2 and set(after) == {"meta", "state"}
    groups = (N_ROWS // 4) // 5
    np.testing.assert_array_equal(after["state"]["step"], port_raw["state"]["step"] + groups)
    np.testing.assert_array_equal(after["state"]["opt_d"]["0"]["count"],
                                  port_raw["state"]["opt_d"]["0"]["count"] + N_ROWS // 4)
    for a, b in zip(jax.tree.leaves(after["state"]["ed_params"]), jax.tree.leaves(port_raw["state"]["ed_params"])):
        np.testing.assert_array_equal(a, b)


def _drop_rng(tree):
    return {k: v for k, v in tree.items() if k != "rng"}


def _equal(ours, theirs, where=""):
    """Same keys; leaves bit for bit with the same dtype and shape."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), where
        for k in theirs:
            _equal(ours[k], theirs[k], f"{where}/{k}")
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_port_resumes_a_jax_sweep_state(corpus, tmp_path, crossed):
    """JAX's file after epoch 2 into port states and back: every field but
    ``rng`` (the port writes JAX's initial key) bit for bit, the EMA stream
    included; then ``sweep_gan(resume=True)`` on a copy trains epoch 3,
    keeping JAX's history."""
    import shutil

    raw = tckpt.load_checkpoint(_state_path(crossed["workdir"]))
    cfg = _cfg(ema_decay=0.9)
    states = [tstep.init_state(cfg, tstep.build_models(cfg, EDConfig(**TINY_ED)), seed=s, device="cpu")
              for s in (3, 5)]
    note = weights.load_sweep_state(states, raw)
    assert "no torch random stream" in note
    assert [s.step for s in states] == [2, 2]
    back = weights.export_sweep_state(states, [3, 5])
    _equal(_drop_rng(back["state"]), _drop_rng(raw["state"]))
    assert back["state"]["ema_params"] is not None

    shutil.copytree(str(crossed["workdir"]), str(tmp_path / "w"))
    ours = _sweep(cfg, corpus, tmp_path / "w", [3, 5], epochs=3, resume=True)
    for r, jr in zip(ours["results"], crossed["theirs"]["results"]):
        assert r["curve"][:2] == jr["curve"] and [row["epoch"] for row in r["curve"]] == [1, 2, 3]
    after = tckpt.load_checkpoint(_state_path(tmp_path / "w"))
    np.testing.assert_array_equal(after["state"]["step"], [3, 3])


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["duplicate_seeds", "grid_length", "unknown_hyper", "halving_one",
                                  "tiny_corpus"])
def test_validation_raises_as_jax(corpus, tmp_path, case):
    seeds, kw, rows = [1, 2], {}, N_ROWS
    if case == "duplicate_seeds":
        seeds = [1, 1]
    elif case == "grid_length":
        kw = {"hyper_grid": [{}]}
    elif case == "unknown_hyper":
        seeds, kw = [1], {"hyper_grid": [{"learning_rate": 1e-4}]}
    elif case == "halving_one":
        seeds, kw = [1], {"halving": True}
    else:
        rows = 8  # 2 batches < critic_iters (5)
    small = tuple(a[:rows] for a in corpus)
    with pytest.raises(ValueError) as ours:
        _sweep(_cfg(), small, tmp_path / "port", seeds, **kw)
    with pytest.raises(ValueError) as theirs:
        _jsweep(_jcfg(), small, tmp_path / "jax", seeds, **kw)
    assert str(ours.value) == str(theirs.value)


def test_unported_options_raise(corpus, tmp_path):
    # the mesh is ported (tests/test_torch_parallel.py): anything but a Mesh is refused
    with pytest.raises(TypeError, match="mesh"):
        _sweep(_cfg(), corpus, tmp_path, [1, 2], mesh=object())
    # bf16 precision is ported (tests/test_torch_precision.py); a spectral-norm
    # model is refused, as the JAX sweep cannot train one (ROADMAP C.5)
    with pytest.raises(ValueError, match="precision"):
        _sweep(_cfg(), corpus, tmp_path, [1, 2], precision="fp16")
    with pytest.raises(NotImplementedError, match="spectral"):
        _sweep(dataclasses.replace(_cfg(), encoder_use_sn=True), corpus, tmp_path, [1, 2])
