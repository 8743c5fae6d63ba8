"""The port's VAE, its trainer and the µ export against the JAX package (CPU).

Small sizes throughout (max_notes 64, hidden 32, latent 4, batch 8). The
JAX VAE's weights are carried into the port with ``utils.weights.
export_vae``; the reparameterisation noise of a JAX forward is recovered
from its own outputs as eps = (z − µ)/exp(½·logσ²) and injected through the
port's ``eps=`` (the two packages draw different streams, so runs are never
compared by seed). The JAX side runs its convs through XLA, and once through
its Pallas kernels in interpret mode.

Tolerances, and why:

- Forward outputs, losses and BatchNorm statistics: 1e-5 of each
  quantity's scale (REL). Both sides sum in IEEE f32 in different orders,
  which agrees to about 1e-7 here; the recovered eps adds about 1e-7 of z.
- Gradients, read as Adam's first moments after one step, relative to the
  largest element over the whole model: 1e-5 (GRAD_REL), as in
  ``tests/test_torch_train.py``.
- Parameters after one step: within 2·lr everywhere (Adam's first update
  is about lr·sign(g), so an element whose true gradient is zero, a conv
  bias in front of BatchNorm, moves ±lr on either side at random), and
  within 1e-7 absolute (1e-3 of lr) where the gradient is above 1e-4 of
  the largest.
- Scheduler decisions, checkpoint trees and the port's own resume: exact.
"""
import dataclasses
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from melogan_tpu.config import AEConfig as JAEConfig
from melogan_tpu.data import datasets as jdata
from melogan_tpu.models import vae as jvae
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.train import harness as jharness
from melogan_tpu.train import vae_loop as jloop
from melogan_tpu.utils import checkpoint as jckpt
from melogan_tpu.utils import torch_interop

from melogan_torch.config import AEConfig, EDConfig, GANConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.data import preprocess as tpre
from melogan_torch.data import splits as tsplits
from melogan_torch.data import synthetic as tsyn
from melogan_torch.midi.midifile import read_midi
from melogan_torch.models.vae import VAE, vae_loss
from melogan_torch.train import gan_loop, harness, vae_loop
from melogan_torch.utils import checkpoint as tckpt
from melogan_torch.utils import weights

REL = 1e-5
GRAD_REL = 1e-5
SMALL = dict(max_notes=64, hidden_dim=32, latent_dim=4, batch_size=8, recon_save_count=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(jax.device_get(x))


def assert_scaled(ours, theirs, rel=REL, what=""):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, what
    scale = max(float(np.max(np.abs(theirs))), 1e-30)
    err = float(np.max(np.abs(ours - theirs)))
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x scale {scale:.3e}"


def _tree_equal(ours, theirs, where=""):
    """Same keys; leaves bit for bit with the same dtype and shape."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), where
        for k in theirs:
            _tree_equal(ours[k], theirs[k], f"{where}/{k}")
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _split(seed: int, n: int, length: int = 64) -> tdata.SplitData:
    """A seeded split at AE shapes: raw (pitch, start, duration, velocity)
    rows, 20 to ``length`` notes a song, padding rows after."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((n, length, 4), np.float32)
    raw[..., 0] = -1.0
    for i in range(n):
        m = int(rng.integers(20, length + 1))
        steps = rng.choice([0.25, 0.5, 1.0], size=m)
        raw[i, :m] = np.stack([rng.integers(36, 97, m), np.cumsum(steps) - steps,
                               steps * rng.uniform(0.5, 1.5, m), rng.integers(40, 111, m)], -1)
    emotions = np.array(["happy", "sad", "angry", "calm"] * (n // 4 + 1))[:n]
    return tdata.SplitData(raw, emotions, rng.normal(size=(n, 6)).astype(np.float32),
                           [f"song{seed}_{i}.mid" for i in range(n)])


def _jax_split(d: tdata.SplitData) -> jdata.SplitData:
    return jdata.SplitData(d.notes_raw, d.emotions, d.numeric, list(d.filenames))


def _jax_model_state(seed=0, **kw):
    jcfg = JAEConfig(**dict(SMALL, **kw))
    model = jvae.VAE.from_config(jcfg)
    return jcfg, model, jloop.init_state(jcfg, model, seed=seed)


def _variables(jstate):
    return {"params": jax.tree_util.tree_map(_np, jstate.params),
            "batch_stats": jax.tree_util.tree_map(_np, jstate.batch_stats)}


def _port_state(jstate, **kw) -> vae_loop.VAETrainState:
    state = vae_loop.init_state(AEConfig(**dict(SMALL, **kw)), seed=0, device="cpu")
    state.model.load_state_dict(weights.to_tensors(weights.export_vae(_variables(jstate))), strict=True)
    return state


def _recover_eps(z, mu, log_var):
    z, mu, log_var = (np.asarray(a, np.float64) for a in (z, mu, log_var))
    return torch.from_numpy(((z - mu) / np.exp(0.5 * log_var)).astype(np.float32))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_vae_names_and_export_equal_the_jax_exporter():
    """``export_vae`` equals the JAX package's; the port's VAE loads it
    strictly (the reference module names), and ``convert_vae`` inverts it."""
    _, _, jstate = _jax_model_state()
    variables = _variables(jstate)
    ours, theirs = weights.export_vae(variables), torch_interop.export_vae(variables)
    assert ours.keys() == theirs.keys() == VAE(64, 4, 32).state_dict().keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
    _tree_equal(weights.convert_vae(ours), variables)
    params_only = weights.export_vae({"params": variables["params"]})
    assert set(ours) - set(params_only) == {k for k in ours if "running" in k or "num_batches" in k}


@pytest.mark.parametrize("train,pallas", [(True, False), (False, False), (True, True)])
def test_vae_forward_and_bn_stats_match_jax(train, pallas):
    """Train mode with JAX's eps injected, and eval mode (eps = 0); once with
    JAX's Pallas kernels in interpret mode (``MELOGAN_PALLAS=on``)."""
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on" if pallas else prev)
    try:
        cfg, model, jstate = _jax_model_state()
        x = _split(1, 8).notes_ae(cfg)
        key = jax.random.PRNGKey(3)
        if train:
            (recon, z, mu, lv), mutated = model.apply(
                {"params": jstate.params, "batch_stats": jstate.batch_stats}, jnp.asarray(x),
                train=True, rngs={"reparam": key}, mutable=["batch_stats"])
        else:
            recon, z, mu, lv = model.apply(
                {"params": jstate.params, "batch_stats": jstate.batch_stats}, jnp.asarray(x), train=False)
    finally:
        jax_conv_ops.set_use_pallas(prev)
    state = _port_state(jstate)
    state.model.train(train)
    eps = _recover_eps(z, mu, lv) if train else None
    with torch.no_grad():
        out = state.model(torch.from_numpy(x), eps=eps)
    for name, a, b in zip(("recon", "z", "mu", "log_var"), out, (recon, z, mu, lv)):
        assert_scaled(a.numpy(), _np(b), what=name)
    if train:
        want = weights.export_vae({"params": _variables(jstate)["params"],
                                   "batch_stats": jax.tree_util.tree_map(_np, mutated["batch_stats"])})
        got = state.model.state_dict()
        for k in want:
            if "running" in k:
                assert_scaled(got[k].numpy(), want[k], what=k)


@pytest.mark.parametrize("free_bits", [0.0, 0.25])
@pytest.mark.parametrize("capacity", [None, 0.5])
def test_vae_loss_matches_jax(free_bits, capacity):
    rng = np.random.default_rng(4)
    recon, x = rng.normal(size=(2, 8, 64, 4)).astype(np.float32)
    mu = rng.normal(size=(8, 4)).astype(np.float32) * 0.3
    lv = rng.normal(size=(8, 4)).astype(np.float32) * 0.5 - 2.0  # some dims below the floor
    ours = vae_loss(*(torch.from_numpy(a) for a in (recon, x, mu, lv)), 10.0, free_bits=free_bits,
                    capacity=capacity)
    theirs = jvae.vae_loss(*(jnp.asarray(a) for a in (recon, x, mu, lv)), 10.0, free_bits=free_bits,
                           capacity=None if capacity is None else jnp.float32(capacity))
    for name, a, b in zip(("total", "mse", "kld"), ours, theirs):
        assert_scaled(float(a), float(b), rel=1e-6, what=name)


@pytest.mark.parametrize("free_bits,capacity", [(0.0, None), (0.25, 0.5)])
def test_one_optimizer_step_matches_jax(free_bits, capacity):
    """One step of JAX's fused epoch (one batch) against ``train_step`` with
    JAX's eps: the losses, Adam's first and second moments, the count, the
    parameters and BN statistics after the clip, AdamW and decay."""
    cfg, model, jstate = _jax_model_state(free_bits=free_bits)
    x = _split(2, 8).notes_ae(cfg)
    _, k_rep = jax.random.split(jstate.rng)  # the key the step draws eps with
    (_, z, mu, lv), _ = model.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                    jnp.asarray(x), train=True, rngs={"reparam": k_rep},
                                    mutable=["batch_stats"])
    train_epoch = jloop.make_epoch_fns(cfg, model)[0]
    beta = np.float32(2.5)
    cap = None if capacity is None else jnp.float32(capacity)
    jnew, metrics = train_epoch(jstate, jnp.asarray(x)[None], jnp.float32(beta), cap)

    state = _port_state(jstate, free_bits=free_bits)
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    row = vae_loop.train_step(state, torch.from_numpy(x), float(beta), free_bits, capacity,
                              eps=_recover_eps(z, mu, lv))
    for name, a in zip(("total", "recon", "kld"), row):
        assert_scaled(float(a), float(metrics[name]), what=name)

    inject = jnew.opt_state[1]
    adam = inject.inner_state[0]
    assert state.opt.count == int(adam.count) == int(inject.count) == 1
    want_mu = weights.export_vae({"params": jax.tree_util.tree_map(_np, adam.mu)})
    want_nu = weights.export_vae({"params": jax.tree_util.tree_map(_np, adam.nu)})
    gmax = max(float(np.abs(v).max()) for v in want_mu.values())
    vmax = max(float(np.abs(v).max()) for v in want_nu.values())
    opt = state.opt.state_dict()
    want_p = weights.export_vae(_variables(jnew))
    lr = cfg.lr
    for name, p in state.model.named_parameters():
        assert float(np.abs(opt["mu"][name].numpy() - want_mu[name]).max()) <= GRAD_REL * gmax, name
        assert float(np.abs(opt["nu"][name].numpy() - want_nu[name]).max()) <= 2 * GRAD_REL * vmax, name
        d = np.abs(p.detach().numpy() - want_p[name])
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), name
        big = np.abs(want_mu[name]) > 1e-4 * gmax
        assert not big.any() or float(d[big].max()) <= 1e-7, name
        assert not torch.equal(p, before[name]) or not big.any(), name
    sd = state.model.state_dict()
    for k in want_p:
        if "running" in k:
            assert_scaled(sd[k].numpy(), want_p[k], what=k)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

SEQUENCES = {
    "improving": [5.0, 4.0, 3.0, 2.5, 2.0, 1.5],
    "plateau_then_stop": [3.0, 2.0] + [2.0] * 9,
    "below_threshold": [1.0] + [1.0 - 1e-5 * k for k in range(1, 10)],
    "at_threshold": [1.0, float(np.float32(1.0) * (np.float32(1.0) - np.float32(1e-4)))] + [0.99] * 8,
    "drops_to_min_lr": [1.0, 0.5] + [0.5 + 0.01 * k for k in range(1, 30)],
    "nan": [1.0, float("nan"), 0.9, float("nan"), float("nan"), float("nan")],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sched_step_matches_device_sched_step(name):
    """The port's host ``sched_step`` against JAX's on-device
    ``device_sched_step`` on scripted validation totals: the learning rate,
    the new-best flag, the stop flag and both controllers' counters, every
    epoch until the stop, exactly."""
    kw = dict(factor=0.5, patience=2, min_lr=2e-5)
    jp, js = jharness.ReduceLROnPlateau(**kw), jharness.EarlyStopping(patience=4)
    sched = jharness.device_sched_init(jp, js)
    tp, ts = harness.ReduceLROnPlateau(**kw), harness.EarlyStopping(patience=4)
    jlr = tlr = 1e-4
    live = jnp.asarray(True)
    for val in SEQUENCES[name]:
        sched, new_lr, improved = jharness.device_sched_step(sched, jnp.float32(val), jnp.float32(jlr), live)
        jlr = float(new_lr)
        tlr, t_improved, t_done = harness.sched_step(tp, ts, val, tlr)
        assert tlr == jlr and t_improved == bool(improved) and t_done == bool(sched["done"])
        for ours, theirs in ((tp.best, sched["plateau_best"]), (ts.best, sched["stop_best"])):
            assert ours == float(theirs) or (math.isnan(ours) and math.isnan(float(theirs)))
        assert (tp.num_bad_epochs, ts.num_bad_epochs) == (int(sched["plateau_bad"]), int(sched["stop_bad"]))
        if t_done:
            break


def test_schedules_equal_jax():
    for ep in range(0, 12):
        assert harness.beta_schedule(ep, 3, 10.0) == jharness.beta_schedule(ep, 3, 10.0)
        assert harness.capacity_schedule(ep, 2.0, 5) == jharness.capacity_schedule(ep, 2.0, 5)
        assert harness.capacity_schedule(ep, 2.0, 0) == jharness.capacity_schedule(ep, 2.0, 0)
    for tcls, jcls in ((harness.ReduceLROnPlateau, jharness.ReduceLROnPlateau),
                       (harness.EarlyStopping, jharness.EarlyStopping)):
        t, j = tcls(), jcls()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        state = {"best": 0.25, "num_bad_epochs": 3}
        t.load_state_dict(state)
        j.load_state_dict(state)
        assert t.state_dict() == j.state_dict() == state


def test_train_loop_follows_the_schedulers_on_scripted_validation(monkeypatch, tmp_path):
    """``train`` with its validation losses scripted: the logged learning
    rate, the epochs that run, the best epoch in ``ae_best.ckpt`` and the
    returned metrics follow ``device_sched_step`` (JAX's fused loop) on the
    same sequence; epochs after the stop do not run."""
    vals = iter([3.0, 2.0, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5])

    def scripted(state, x):
        return torch.tensor([next(vals), 0.0, 0.0])

    monkeypatch.setattr(vae_loop, "eval_step", scripted)
    cfg = AEConfig(**dict(SMALL, epochs=20, early_stop_patience=4, recon_save_count=0))
    best, metrics = vae_loop.train(cfg, _split(5, 16), _split(6, 8), workdir=str(tmp_path),
                                   verbose=False, device="cpu")
    logged = {}
    for line in open(tmp_path / cfg.log_dir / "metrics.jsonl"):
        rec = json.loads(line)
        logged.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    sched = jharness.device_sched_init(jharness.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6),
                                       jharness.EarlyStopping(patience=4))
    lr, want_lr, stop = cfg.lr, {}, None
    for ep, val in enumerate([3.0, 2.0] + [2.5] * 9, 1):
        sched, new_lr, _ = jharness.device_sched_step(sched, jnp.float32(val), jnp.float32(lr), jnp.asarray(True))
        lr = want_lr[ep] = float(new_lr)
        if bool(sched["done"]):
            stop = ep
            break
    assert sorted(logged) == list(range(1, stop + 1)) == list(range(1, 7))
    assert {ep: logged[ep]["lr"] for ep in logged} == want_lr
    raw = tckpt.load_checkpoint(str(tmp_path / cfg.checkpoint_dir / "ae_best.ckpt"))
    assert int(raw["epoch"]) == 2 and float(raw["best_val"]) == 2.0
    assert metrics == {"best_val": 2.0, "epoch": stop - 1, "val_total": 2.5}


def test_ae_best_is_written_at_the_end_of_each_improving_epoch(monkeypatch, tmp_path):
    """A run that fails in epoch 3 leaves the ``ae_best.ckpt`` of epoch 2,
    its last improving epoch, to resume from."""
    vals = iter([3.0, 2.0])

    def scripted(state, x):
        return torch.tensor([next(vals), 0.0, 0.0])  # StopIteration in epoch 3

    monkeypatch.setattr(vae_loop, "eval_step", scripted)
    cfg = AEConfig(**dict(SMALL, epochs=20, recon_save_count=0))
    with pytest.raises(StopIteration):
        vae_loop.train(cfg, _split(5, 16), _split(6, 8), workdir=str(tmp_path), verbose=False,
                       device="cpu")
    raw = tckpt.load_checkpoint(str(tmp_path / cfg.checkpoint_dir / "ae_best.ckpt"))
    assert int(raw["epoch"]) == 2 and float(raw["best_val"]) == 2.0


# ---------------------------------------------------------------------------
# The loop, checkpoints and resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX ``vae_loop.train`` for 2 epochs (2 steps an epoch, one 8-row
    validation batch): its workdir, config, returned state and data."""
    workdir = tmp_path_factory.mktemp("jax_vae")
    train_d, val_d = _split(11, 20), _split(12, 9)
    jcfg = JAEConfig(**dict(SMALL, epochs=2))
    state, metrics = jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), workdir=str(workdir),
                                 verbose=False)
    return workdir, jcfg, state, (train_d, val_d)


def _snapshot_from_raw(raw):
    """The keys of an ``ae_best.ckpt`` both packages write."""
    return {k: raw[k] for k in ("epoch", "params", "batch_stats", "opt_state", "best_val", "lr",
                                "plateau", "stopper")}


def test_jax_ae_best_loads_into_the_port_and_exports_back_bit_for_bit(jax_run):
    workdir, jcfg, _, _ = jax_run
    raw = tckpt.load_checkpoint(str(workdir / jcfg.checkpoint_dir / "ae_best.ckpt"))
    state = vae_loop.init_state(AEConfig(**SMALL), seed=7, device="cpu")
    epoch, note = weights.load_vae_payload(state, raw)
    assert epoch == int(raw["epoch"]) and "no torch random stream" in note
    assert state.opt.count == 2 * epoch and state.opt.lr == float(raw["lr"])
    plateau, stopper = harness.ReduceLROnPlateau(), harness.EarlyStopping()
    plateau.load_state_dict(raw["plateau"])
    stopper.load_state_dict(raw["stopper"])
    back = weights.export_vae_payload(vae_loop.snapshot(state, epoch, plateau, stopper))
    assert set(back) - set(raw) == {weights.TORCH_RNG_KEY, weights.TORCH_BN_KEY}
    assert set(raw) - set(back) == {"rng"}
    _tree_equal(_snapshot_from_raw(back), _snapshot_from_raw(raw))


def test_port_resumes_a_jax_ae_best(jax_run, tmp_path):
    """From JAX's epoch-2 file the port trains epoch 3, with the JAX data
    order replayed; its own seeded stream draws the noise."""
    workdir, jcfg, _, (train_d, val_d) = jax_run
    shutil.copytree(workdir / jcfg.checkpoint_dir, tmp_path / jcfg.checkpoint_dir)
    cfg = AEConfig(**dict(SMALL, epochs=3))
    best, metrics = vae_loop.train(cfg, train_d, val_d, workdir=str(tmp_path), resume=True,
                                   verbose=False, device="cpu")
    logged = [json.loads(line) for line in open(tmp_path / cfg.log_dir / "metrics.jsonl")]
    assert {r["step"] for r in logged} == {3} and metrics.get("epoch", 3) == 3
    assert all(math.isfinite(r["value"]) for r in logged)
    assert best.opt.count in (4, 6)  # the file's state (2 epochs) or epoch 3's


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's ``train`` for 2 epochs on the CPU: workdir, config, data
    and returned state."""
    workdir = tmp_path_factory.mktemp("port_vae")
    train_d, val_d = _split(21, 20), _split(22, 9)
    cfg = AEConfig(**dict(SMALL, epochs=2))
    state, metrics = vae_loop.train(cfg, train_d, val_d, workdir=str(workdir), verbose=False,
                                    device="cpu")
    return workdir, cfg, (train_d, val_d), state, metrics


def test_jax_restores_and_resumes_from_a_port_ae_best(port_run, tmp_path):
    workdir, cfg, (train_d, val_d), _, _ = port_run
    path = workdir / cfg.checkpoint_dir / "ae_best.ckpt"
    raw = tckpt.load_checkpoint(str(path))
    assert "rng" not in raw and weights.TORCH_RNG_KEY in raw
    # with nothing left to run, JAX's train returns the state it restored
    shutil.copytree(workdir / cfg.checkpoint_dir, tmp_path / "a" / cfg.checkpoint_dir)
    jcfg = JAEConfig(**dict(SMALL, epochs=int(raw["epoch"])))
    restored, _ = jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), workdir=str(tmp_path / "a"),
                              resume=True, verbose=False)
    _tree_equal({"params": serialization.to_state_dict(jax.tree_util.tree_map(_np, restored.params)),
                 "batch_stats": jax.tree_util.tree_map(_np, restored.batch_stats),
                 "opt_state": serialization.to_state_dict(jax.tree_util.tree_map(_np, restored.opt_state))},
                {k: raw[k] for k in ("params", "batch_stats", "opt_state")})
    # and it trains on from it
    shutil.copytree(workdir / cfg.checkpoint_dir, tmp_path / "b" / cfg.checkpoint_dir)
    _, metrics = jloop.train(dataclasses.replace(jcfg, epochs=int(raw["epoch"]) + 1), _jax_split(train_d),
                             _jax_split(val_d), workdir=str(tmp_path / "b"), resume=True, verbose=False)
    steps = {json.loads(line)["step"] for line in open(tmp_path / "b" / jcfg.log_dir / "metrics.jsonl")}
    assert steps == {int(raw["epoch"]) + 1} and math.isfinite(metrics["best_val"])


def test_train_writes_the_jax_files_tags_and_dumps(port_run, jax_run):
    """The same checkpoint keys, metric tags, history keys and
    reconstruction files as the JAX loop's run; the dumps parse back."""
    workdir, cfg, _, state, metrics = port_run
    jworkdir, jcfg, _, _ = jax_run
    for name in ("ae_best.ckpt", "ae_final.ckpt"):
        ours = tckpt.load_checkpoint(str(workdir / cfg.checkpoint_dir / name))
        theirs = jckpt.load_checkpoint(str(jworkdir / jcfg.checkpoint_dir / name))
        extra = {weights.TORCH_RNG_KEY, weights.TORCH_BN_KEY} if name == "ae_best.ckpt" else set()
        assert set(ours) == set(theirs) - {"rng"} | extra
    tags = [{(r["tag"], r["step"]) for r in map(json.loads, open(w / c.log_dir / "metrics.jsonl"))}
            for w, c in ((workdir, cfg), (jworkdir, jcfg))]
    assert tags[0] == tags[1]
    ours, theirs = sorted(os.listdir(workdir / cfg.recon_dir)), sorted(os.listdir(jworkdir / jcfg.recon_dir))
    assert [n.replace("song22", "") for n in ours] == [n.replace("song12", "") for n in theirs]
    assert len(ours) == 2 * 2 * 2  # 2 epochs × 2 songs × (in, out)
    for name in ours:
        assert read_midi(str(workdir / cfg.recon_dir / name)).instruments
    assert set(metrics) == {"best_val", "epoch", "val_total"} and metrics["epoch"] == 2


@pytest.mark.parametrize("kw", [{}, {"free_bits": 0.25, "kl_capacity": 0.5, "kld_warmup_epochs": 2}],
                         ids=["reference", "free_bits_capacity"])
def test_resume_is_bit_identical_to_straight_through(tmp_path, kw):
    """4 epochs in one go against 2, then ``resume=True`` to 4 in the same
    workdir: the final weights (``ae_final.ckpt``, byte for byte), the best
    state and the logged losses of epochs 3 and 4 agree exactly."""
    train_d, val_d = _split(31, 20), _split(32, 9)
    cfg = AEConfig(**dict(SMALL, epochs=4, **kw))
    straight, m1 = vae_loop.train(cfg, train_d, val_d, workdir=str(tmp_path / "a"), verbose=False,
                                  device="cpu")
    vae_loop.train(dataclasses.replace(cfg, epochs=2), train_d, val_d, workdir=str(tmp_path / "b"),
                   verbose=False, device="cpu")
    resumed, m2 = vae_loop.train(cfg, train_d, val_d, workdir=str(tmp_path / "b"), resume=True,
                                 verbose=False, device="cpu")
    final = [(tmp_path / w / cfg.checkpoint_dir / "ae_final.ckpt").read_bytes() for w in ("a", "b")]
    assert final[0] == final[1]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert straight.opt.count == resumed.opt.count
    assert torch.equal(straight.rng.get_state(), resumed.rng.get_state())
    assert m1 == m2

    def losses(w):
        out = {}
        for r in map(json.loads, open(tmp_path / w / cfg.log_dir / "metrics.jsonl")):
            if r["tag"] != "epoch_seconds" and r["step"] >= 3:
                out[r["tag"], r["step"]] = r["value"]
        return out

    assert losses("a") == losses("b") and len(losses("a")) == 2 * 8


def test_encode_mu_matches_jax_with_the_padding_tail(jax_run):
    """300 rows (a full chunk of 256 and a padded tail of 44) through JAX's
    ``encode_mu`` and the port's, on JAX's trained weights."""
    workdir, jcfg, jstate, _ = jax_run
    x = _split(41, 300).notes_ae(jcfg)
    theirs = jloop.encode_mu(jvae.VAE.from_config(jcfg), jstate, x)
    state = _port_state(jstate)
    ours = vae_loop.encode_mu(state.model, x)
    assert ours.shape == theirs.shape == (300, 4)
    assert_scaled(ours, theirs, what="mu")
    assert state.model.training  # restored after the export
    np.testing.assert_array_equal(vae_loop.encode_mu(state.model, x, batch_size=300), ours)


def test_unported_train_options_raise(tmp_path):
    cfg = AEConfig(**dict(SMALL, epochs=1))
    d = _split(51, 9)
    # bf16 precision and the mesh are ported (tests/test_torch_precision.py,
    # tests/test_torch_parallel.py); anything but a Mesh is refused
    for kw, err in (({"mesh": object()}, TypeError), ({"precision": "fp16"}, ValueError)):
        with pytest.raises(err):
            vae_loop.train(cfg, d, d, workdir=str(tmp_path), device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vae_loop.train(cfg, d, d, workdir=str(tmp_path))
    with pytest.raises(ValueError, match="eps or a torch.Generator"):
        VAE(64, 4, 32).train()(torch.zeros(2, 64, 4))


def test_stage_one_from_disk_to_the_conditioning_gan(tmp_path):
    """The slice end to end on the CPU: a synthetic corpus on disk,
    preprocessed, split and loaded; the VAE trained; µ exported and held
    against JAX's ``encode_mu`` on the trained weights (REL); the latents
    fed to the conditioning-mode GAN."""
    root = str(tmp_path)
    entries = tsyn.generate_corpus(root, n_per_emotion=7, seed=1, n_notes=64)
    tpre.preprocess_corpus(entries, os.path.join(root, "processed"), max_notes=64, verbose=False)
    tsplits.create_splits(tsplits.read_manifest(os.path.join(root, "data_manifest.csv")),
                          os.path.join(root, "splits"))
    train_d, val_d = (tdata.load_split(os.path.join(root, "splits", f"{s}_split.csv"),
                                       os.path.join(root, "processed"), verbose=False) for s in ("train", "val"))
    cfg = AEConfig(**dict(SMALL, epochs=2))
    best, _ = vae_loop.train(cfg, train_d, val_d, workdir=root, verbose=False, device="cpu")
    latents = vae_loop.encode_mu(best.model, train_d.notes_ae(cfg))
    assert latents.shape == (train_d.n, 4) and np.isfinite(latents).all()

    jcfg, model, jstate = _jax_model_state()
    variables = weights.convert_vae({k: v.numpy() for k, v in best.model.state_dict().items()})
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    assert_scaled(latents, jloop.encode_mu(model, jstate, train_d.notes_ae(cfg)), what="trained mu")

    gan_cfg = GANConfig(integration_mode="conditioning", max_notes=64, batch_size=4, noise_dim=16,
                        latent_dim=4, gen_hidden=32, encoder_hidden=(16, 8), encoder_out_dim=8)
    ed_cfg = EDConfig(max_notes=64, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,))
    state, hist = gan_loop.train(gan_cfg, ed_cfg, train_d, latents=latents, workdir=root, epochs=1,
                                 verbose=False, device="cpu")
    assert hist["epoch"] == 1 and all(math.isfinite(v) for v in hist.values())
    assert state.generator.mode == "conditioning"
