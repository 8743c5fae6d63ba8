"""The port's ED trainer against the JAX package (CPU).

Small sizes throughout (max_notes 64, 3 conv blocks, notes_hidden 32, MLP
(16, 8), batch 8). The JAX ED's weights are carried into the port with
``utils.weights.export_ed``; its dropout keep masks are read off its own
Dropout outputs (``capture_intermediates``) and injected through the
port's ``masks=`` (the two packages draw different streams, so runs are
never compared by seed). The JAX side runs its convs through XLA, and once
through its Pallas kernels in interpret mode.

Tolerances, and why:

- Logits, losses, accuracies and BatchNorm statistics: 1e-5 of each
  quantity's scale (REL). Both sides sum in IEEE f32 in different orders,
  which agrees to about 1e-7 here.
- Gradients, read as Adam's first moments after one step, relative to the
  largest element over the whole model: 1e-5 (second moments 2e-5).
- Parameters after one step: within 2·lr everywhere (Adam's first update
  is about lr·sign(g), so an element whose true gradient is zero, a conv
  bias in front of BatchNorm, moves ±lr either way at random), and within
  1e-7 absolute where the gradient is above 1e-4 of the largest.
- A whole loop on the same weights without dropout: logged losses 1e-4 of
  their scale after 3 epochs of Adam; the decisions (learning rate, best
  epoch, files) exactly.
- Scheduler decisions, batch orders, checkpoint trees, confusion matrices
  and the port's own resume: exact.
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

from melogan_tpu.config import EDConfig as JEDConfig
from melogan_tpu.data import datasets as jdata
from melogan_tpu.models import ed as jed
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.train import ed_loop as jloop
from melogan_tpu.train import harness as jharness
from melogan_tpu.utils import checkpoint as jckpt

from melogan_torch.config import EDConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.models.ed import EmotionDiscriminator
from melogan_torch.train import ed_loop
from melogan_torch.utils import checkpoint as tckpt
from melogan_torch.utils import weights

REL = 1e-5
GRAD_REL = 1e-5
SMALL = dict(max_notes=64, notes_blocks=3, notes_hidden=32, mlp_hidden=(16, 8), batch_size=8,
             latent_dim=6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are small: more torch threads only contend
    with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_on():
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on")
    try:
        yield
    finally:
        jax_conv_ops.set_use_pallas(prev)


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


def _split(seed: int, n: int, length: int = 64, emotions=None) -> tdata.SplitData:
    """A seeded split of raw (pitch, start, duration, velocity) rows, 20 to
    ``length`` notes a song, padding rows after."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((n, length, 4), np.float32)
    raw[..., 0] = -1.0
    for i in range(n):
        m = int(rng.integers(20, length + 1))
        steps = rng.choice([0.25, 0.5, 1.0], size=m)
        raw[i, :m] = np.stack([rng.integers(36, 97, m), np.cumsum(steps) - steps,
                               steps * rng.uniform(0.5, 1.5, m), rng.integers(40, 111, m)], -1)
    if emotions is None:
        emotions = np.array(["happy", "sad", "angry", "calm"] * (n // 4 + 1))[:n]
    return tdata.SplitData(raw, np.asarray(emotions), rng.normal(size=(n, 6)).astype(np.float32),
                           [f"song{seed}_{i}.mid" for i in range(n)])


def _jax_split(d: tdata.SplitData) -> jdata.SplitData:
    return jdata.SplitData(d.notes_raw, d.emotions, d.numeric, list(d.filenames))


def _cfgs(**kw):
    return JEDConfig(**dict(SMALL, **kw)), EDConfig(**dict(SMALL, **kw))


def _jax_state(jcfg, seed=0, perturb=True):
    """JAX's init_state, with the BatchNorm statistics moved off (0, 1) so
    that eval mode is not the identity."""
    model = jed.EmotionDiscriminator.from_config(jcfg)
    state = jloop.init_state(jcfg, model, seed=seed)
    if perturb and state.batch_stats:
        rng = np.random.default_rng(seed)
        stats = jax.tree_util.tree_map(_np, state.batch_stats)
        for blk in stats["encoder"].values():
            s = blk["TorchBatchNorm_0"]
            s["mean"] = rng.normal(0, 0.1, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
        state = state.replace(batch_stats=stats)
    return model, state


def _variables(jstate):
    out = {"params": jax.tree_util.tree_map(_np, jstate.params)}
    if jstate.batch_stats:
        out["batch_stats"] = jax.tree_util.tree_map(_np, jstate.batch_stats)
    return out


def _port_state(cfg, jstate) -> ed_loop.EDTrainState:
    model = EmotionDiscriminator.from_config(cfg)
    model.load_state_dict(weights.to_tensors(weights.export_ed(_variables(jstate))), strict=True)
    return ed_loop.init_state(cfg, model=model, device="cpu")


def _dropout_masks(model, variables, x, key):
    """The JAX ED's dropout keep masks for one train-mode call: where the
    Dropout outputs are non-zero (their inputs, GELUs of random
    pre-activations, are never exactly zero)."""
    _, inter = model.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": key},
                           capture_intermediates=True, mutable=["intermediates", "batch_stats"])
    inter = inter["intermediates"]["classifier"]
    return [torch.from_numpy(_np(inter[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(sum(1 for k in inter if k.startswith("Dropout_")))]


def _batch(rng, cfg, b=8):
    if cfg.input_mode == "latent":
        x = rng.normal(size=(b, cfg.latent_dim)).astype(np.float32)
    else:
        x = rng.normal(size=(b, cfg.max_notes, 4)).astype(np.float32)
    return x, rng.integers(0, 4, size=b).astype(np.int32)


# ---------------------------------------------------------------------------
# One forward, one step, evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["notes", "latent"])
def test_train_mode_forward_with_injected_masks_matches_jax(rng, mode):
    """One train-mode ED forward with JAX's dropout masks: the logits, and
    the BatchNorm running statistics it advances (momentum 0.1, unbiased
    running variance in both packages), at 1e-5 of scale."""
    jcfg, cfg = _cfgs(input_mode=mode)
    model, jstate = _jax_state(jcfg)
    x, _ = _batch(rng, cfg)
    key = jax.random.PRNGKey(3)
    logits, mutated = model.apply(_variables(jstate), jnp.asarray(x), train=True, rngs={"dropout": key},
                                  mutable=["batch_stats"])
    masks = _dropout_masks(model, _variables(jstate), x, key)
    assert len(masks) == 2 and not all(bool(m.all()) for m in masks)
    state = _port_state(cfg, jstate)
    ours = state.model.train()(torch.from_numpy(x), masks=masks)
    assert_scaled(ours.detach().numpy(), _np(logits), what="logits")
    if mode == "notes":
        want = weights.export_ed({"params": _variables(jstate)["params"],
                                  "batch_stats": jax.tree_util.tree_map(_np, mutated["batch_stats"])})
        sd = state.model.state_dict()
        for k in want:
            if "running" in k:
                assert_scaled(sd[k].numpy(), want[k], what=k)
    # features_and_logits takes the same masks
    _, again = state.model.features_and_logits(torch.from_numpy(x), masks=masks)
    assert again.shape == ours.shape


@pytest.mark.parametrize("mode,pallas", [("notes", False), ("notes", True), ("latent", False)],
                         ids=["notes-xla", "notes-pallas", "latent"])
def test_one_train_step_matches_jax(rng, mode, pallas):
    """One step of JAX's ``make_epoch_fns(...)[0]`` (one batch) against
    ``train_step`` with JAX's dropout masks: loss and accuracy, Adam's
    moments and count, the parameters and BN statistics after AdamW."""
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on" if pallas else prev)
    try:
        jcfg, cfg = _cfgs(input_mode=mode)
        model, jstate = _jax_state(jcfg)
        x, y = _batch(rng, cfg)
        _, k_drop = jax.random.split(jstate.rng)  # the key the step draws dropout with
        masks = _dropout_masks(model, _variables(jstate), x, k_drop)
        train_epoch = jloop.make_epoch_fns(jcfg, model)[0]
        jnew, metrics = train_epoch(jstate, (jnp.asarray(x)[None], jnp.asarray(y)[None]))
    finally:
        jax_conv_ops.set_use_pallas(prev)

    state = _port_state(cfg, jstate)
    row = ed_loop.train_step(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), masks=masks)
    assert_scaled(float(row[0]), float(metrics["loss"]), what="loss")
    assert float(row[1]) == float(metrics["acc"])

    inject = jnew.opt_state
    adam = inject.inner_state[0]
    assert state.opt.count == int(adam.count) == int(inject.count) == 1
    want_mu = weights.export_ed({"params": jax.tree_util.tree_map(_np, adam.mu)})
    want_nu = weights.export_ed({"params": jax.tree_util.tree_map(_np, adam.nu)})
    gmax = max(float(np.abs(v).max()) for v in want_mu.values())
    vmax = max(float(np.abs(v).max()) for v in want_nu.values())
    opt = state.opt.state_dict()
    want_p = weights.export_ed(_variables(jnew))
    lr = cfg.optimizer.lr
    for name, p in state.model.named_parameters():
        assert float(np.abs(opt["mu"][name].numpy() - want_mu[name]).max()) <= GRAD_REL * gmax, name
        assert float(np.abs(opt["nu"][name].numpy() - want_nu[name]).max()) <= 2 * GRAD_REL * vmax, name
        d = np.abs(p.detach().numpy() - want_p[name])
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), name
        big = np.abs(want_mu[name]) > 1e-4 * gmax
        assert not big.any() or float(d[big].max()) <= 1e-7, name
    sd = state.model.state_dict()
    for k in want_p:
        if "running" in k:
            assert_scaled(sd[k].numpy(), want_p[k], what=k)
    assert {k: float(v) for k, v in opt["hyperparams"].items()} == {
        k: float(v) for k, v in inject.hyperparams.items()}


def test_eval_step_and_evaluate_match_jax(rng, pallas_on):
    """``eval_step`` against JAX's ``eval_epoch`` on two batches, and
    ``evaluate`` over a 13-row split against JAX's: loss 1e-5 of scale,
    accuracy, confusion matrix and ``n`` exactly. Evaluation leaves the
    model in train mode."""
    jcfg, cfg = _cfgs()
    model, jstate = _jax_state(jcfg)
    xs, ys = zip(*(_batch(rng, cfg) for _ in range(2)))
    eval_epoch = jloop.make_epoch_fns(jcfg, model)[1]
    jm = eval_epoch(jstate, (jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(ys))))
    state = _port_state(cfg, jstate)
    rows = torch.stack([ed_loop.eval_step(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
                        for x, y in zip(xs, ys)]).mean(dim=0)
    assert_scaled(float(rows[0]), float(jm["loss"]), what="val loss")
    assert float(rows[1]) == float(jm["acc"])

    data = _split(7, 13)
    theirs = jloop.evaluate(jcfg, jstate, _jax_split(data))
    state.model.train()
    ours = ed_loop.evaluate(cfg, state, data)
    assert state.model.training
    assert set(ours) == set(theirs) == {"loss", "accuracy", "confusion", "n"}
    assert_scaled(ours["loss"], theirs["loss"], what="loss")
    assert (ours["accuracy"], ours["confusion"], ours["n"]) == (
        theirs["accuracy"], theirs["confusion"], theirs["n"])


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _logged(log_dir):
    out = {}
    for line in open(os.path.join(log_dir, "metrics.jsonl")):
        rec = json.loads(line)
        out.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    return out


@pytest.mark.parametrize("script,save_freq", [
    ([3.0, 2.0, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5], 2),  # plateau drops, stop at epoch 6
    ([3.0, 2.0, 1.0, 0.5, 0.4], 3),  # improving to the end, no stop
    ([1.0, 2.0, 2.0, 2.0], 2),  # the best is epoch 1; the stop at epoch 4 saves
], ids=["plateau_then_stop", "improving", "early_best"])
def test_loop_follows_the_schedulers_on_scripted_validation(monkeypatch, tmp_path, script, save_freq):
    """``train`` with its validation losses scripted, against JAX's fused
    loop's per-epoch body (``device_sched_step``) on the same sequence: the
    logged learning rate, the epochs that run, the periodic files (every
    ``save_freq`` epochs that ran, the stop epoch included), the best
    epoch in ``ed_best.ckpt`` and the returned metrics and state."""
    vals = iter(script)

    def scripted(state, x, y):
        return torch.tensor([next(vals), 0.5])

    monkeypatch.setattr(ed_loop, "eval_step", scripted)
    cfg = EDConfig(**dict(SMALL, num_epochs=len(script), save_freq=save_freq,
                          early_stopping_patience=3))
    cfg.scheduler.patience = 1
    best, metrics = ed_loop.train(cfg, _split(5, 16), _split(6, 8), workdir=str(tmp_path),
                                  verbose=False, device="cpu")
    logged = _logged(tmp_path / cfg.log_dir)
    sched = jharness.device_sched_init(jharness.ReduceLROnPlateau(factor=0.5, patience=1, threshold=1e-4),
                                       jharness.EarlyStopping(patience=3))
    lr, want_lr, best_epoch, ran = cfg.optimizer.lr, {}, None, 0
    for ep, val in enumerate(script, 1):
        sched, new_lr, improved = jharness.device_sched_step(sched, jnp.float32(val), jnp.float32(lr),
                                                             jnp.asarray(True))
        lr = want_lr[ep] = float(new_lr)
        ran = ep
        if bool(improved):
            best_epoch = ep
        if bool(sched["done"]):
            break
    assert sorted(logged) == list(range(1, ran + 1))
    assert {ep: logged[ep]["lr"] for ep in logged} == want_lr
    files = sorted(os.listdir(tmp_path / cfg.checkpoint_dir))
    assert files == ["ed_best.ckpt"] + [f"ed_epoch{e:04d}.ckpt" for e in range(save_freq, ran + 1, save_freq)]
    raw = tckpt.load_checkpoint(str(tmp_path / cfg.checkpoint_dir / "ed_best.ckpt"))
    best_val = float(np.float32(min(script[:ran])))  # the fused loop's float32
    assert int(raw["epoch"]) == best_epoch and float(raw["stopper"]["best"]) == best_val
    assert metrics == {"epoch": best_epoch, "val_loss": best_val, "val_acc": 0.5}
    assert best.opt.count == 2 * best_epoch  # the best epoch's state, 2 steps an epoch
    assert float(raw["lr"]) == want_lr[best_epoch] == best.opt.lr


def _jax_init_for_port(monkeypatch, jstate):
    """Make the port's ``train`` start from JAX's initial weights."""
    real = ed_loop.init_state

    def init(cfg, model=None, seed=42, device="cuda"):
        model = EmotionDiscriminator.from_config(cfg)
        model.load_state_dict(weights.to_tensors(weights.export_ed(_variables(jstate))), strict=True)
        return real(cfg, model=model, seed=seed, device=device)

    monkeypatch.setattr(ed_loop, "init_state", init)


@pytest.mark.parametrize("weighted", [False, True], ids=["permuted", "weighted"])
def test_loop_matches_the_jax_loop_and_its_batches(monkeypatch, tmp_path, weighted):
    """The port's ``train`` and JAX's fused loop from the same initial
    weights, dropout off (so no draw differs), 3 epochs with ``save_freq``
    2 on a 21-row split (2 full batches of 8, the remainder dropped) with
    imbalanced classes: every epoch's batch indices are JAX's exactly (the
    weighted sampler's ``choice`` or the permutation); the logged losses
    and accuracies agree to 1e-4 of scale; the learning rates, the best
    epoch and the files are the same."""
    emotions = ["happy"] * 9 + ["sad"] * 6 + ["angry"] * 4 + ["calm"] * 2
    train_d, val_d = _split(21, 21, emotions=emotions), _split(22, 11)
    kw = dict(num_epochs=3, save_freq=2, dropout=0.0, use_weighted_sampler=weighted)
    jcfg, cfg = _cfgs(**kw)
    _, jstate = _jax_state(jcfg, seed=jcfg.seed, perturb=False)

    seen = []
    real_jit = jharness.jit_with_precision

    def recording_jit(fn, precision=None, **k):
        run = real_jit(fn, precision, **k)

        def wrapped(state, x, y, idx, live, val, sched):
            seen.extend(np.asarray(idx)[np.asarray(live)])
            return run(state, x, y, idx, live, val, sched)
        return wrapped

    monkeypatch.setattr(jharness, "jit_with_precision", recording_jit)
    jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), workdir=str(tmp_path / "jax"), verbose=False)

    ours = []
    real_batches = ed_loop.batch_indices
    monkeypatch.setattr(ed_loop, "batch_indices", lambda order, bs: ours.append(real_batches(order, bs)) or ours[-1])
    _jax_init_for_port(monkeypatch, jstate)
    ed_loop.train(cfg, train_d, val_d, workdir=str(tmp_path / "port"), verbose=False, device="cpu")
    assert ours[0].tolist() == [list(range(8))]  # validation: one full batch of 8 of the 11 rows
    assert len(ours[1:]) == len(seen) == 3
    for a, b in zip(ours[1:], seen):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (2, 8)

    lj, lp = _logged(tmp_path / "jax" / jcfg.log_dir), _logged(tmp_path / "port" / cfg.log_dir)
    assert sorted(lj) == sorted(lp) == [1, 2, 3]
    for ep in lj:
        assert lj[ep]["lr"] == lp[ep]["lr"]
        for tag in ("loss/train", "loss/val", "acc/train", "acc/val"):
            assert_scaled(lp[ep][tag], lj[ep][tag], rel=1e-4, what=f"{tag} epoch {ep}")
    fj = sorted(os.listdir(tmp_path / "jax" / jcfg.checkpoint_dir))
    assert fj == sorted(os.listdir(tmp_path / "port" / cfg.checkpoint_dir)) == ["ed_best.ckpt", "ed_epoch0002.ckpt"]
    bj, bp = (tckpt.load_checkpoint(str(tmp_path / w / cfg.checkpoint_dir / "ed_best.ckpt"))
              for w in ("jax", "port"))
    assert int(bj["epoch"]) == int(bp["epoch"]) and float(bj["lr"]) == float(bp["lr"])


# ---------------------------------------------------------------------------
# Checkpoints both ways and resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX ``ed_loop.train`` for 2 epochs, ``save_freq`` 2 (2 steps an
    epoch, one 8-row validation batch): its workdir, config and data."""
    workdir = tmp_path_factory.mktemp("jax_ed")
    train_d, val_d = _split(11, 20), _split(12, 9)
    jcfg = JEDConfig(**dict(SMALL, num_epochs=2, save_freq=2))
    jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), workdir=str(workdir), verbose=False)
    return workdir, jcfg, (train_d, val_d)


_KEYS = ("epoch", "params", "batch_stats", "opt_state", "lr", "plateau", "stopper")


@pytest.mark.parametrize("name", ["ed_best.ckpt", "ed_epoch0002.ckpt"])
def test_jax_ed_files_load_into_the_port_and_export_back_bit_for_bit(jax_run, name):
    workdir, jcfg, _ = jax_run
    raw = tckpt.load_checkpoint(str(workdir / jcfg.checkpoint_dir / name))
    cfg = EDConfig(**SMALL)
    state = ed_loop.init_state(cfg, seed=7, device="cpu")
    epoch, note = weights.load_ed_payload(state, raw)
    assert epoch == int(raw["epoch"]) and "no torch random stream" in note
    assert state.opt.count == 2 * epoch
    plateau, stopper = ed_loop.ReduceLROnPlateau(), ed_loop.EarlyStopping()
    plateau.load_state_dict(raw["plateau"])
    stopper.load_state_dict(raw["stopper"])
    back = weights.export_ed_payload(ed_loop.snapshot(state, epoch, plateau, stopper))
    assert set(back) - set(raw) == {weights.TORCH_RNG_KEY, weights.TORCH_BN_KEY}
    assert set(raw) - set(back) == {"rng"}
    _tree_equal({k: back[k] for k in _KEYS}, {k: raw[k] for k in _KEYS})


def test_port_resumes_a_jax_run(jax_run, tmp_path):
    """From JAX's ``ed_epoch0002.ckpt`` the port trains epoch 3, with the
    data order of epochs 1 and 2 replayed; its own seeded stream draws the
    dropout masks."""
    workdir, jcfg, (train_d, val_d) = jax_run
    shutil.copytree(workdir / jcfg.checkpoint_dir, tmp_path / jcfg.checkpoint_dir)
    cfg = EDConfig(**dict(SMALL, num_epochs=3, save_freq=2))
    state, metrics = ed_loop.train(cfg, train_d, val_d, workdir=str(tmp_path), resume=True,
                                   verbose=False, device="cpu")
    logged = _logged(tmp_path / cfg.log_dir)
    assert sorted(logged) == [3] and all(math.isfinite(v) for v in logged[3].values())
    assert state.opt.count in (4, 6)  # the file's state (2 epochs) or epoch 3's
    assert set(metrics) in (set(), {"epoch", "val_loss", "val_acc"})


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's ``train`` for 2 epochs, ``save_freq`` 2, on the CPU."""
    workdir = tmp_path_factory.mktemp("port_ed")
    train_d, val_d = _split(21, 20), _split(22, 9)
    cfg = EDConfig(**dict(SMALL, num_epochs=2, save_freq=2))
    state, metrics = ed_loop.train(cfg, train_d, val_d, workdir=str(workdir), verbose=False, device="cpu")
    return workdir, cfg, (train_d, val_d), state, metrics


def test_jax_restores_and_resumes_from_a_port_file(port_run, tmp_path):
    """JAX's ``train(resume=True)`` restores a port ``ed_epoch0002.ckpt``
    bit for bit (with nothing left to run it returns the restored state),
    and trains on from it; JAX reads the port's ``ed_best.ckpt`` too."""
    workdir, cfg, (train_d, val_d), _, _ = port_run
    raw = tckpt.load_checkpoint(str(workdir / cfg.checkpoint_dir / "ed_epoch0002.ckpt"))
    assert "rng" not in raw and weights.TORCH_RNG_KEY in raw
    shutil.copytree(workdir / cfg.checkpoint_dir, tmp_path / "a" / cfg.checkpoint_dir)
    jcfg = JEDConfig(**dict(SMALL, num_epochs=2, save_freq=2))
    restored, metrics = jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), workdir=str(tmp_path / "a"),
                                    resume=True, verbose=False)
    assert metrics == {}
    _tree_equal({"params": serialization.to_state_dict(jax.tree_util.tree_map(_np, restored.params)),
                 "batch_stats": jax.tree_util.tree_map(_np, restored.batch_stats),
                 "opt_state": serialization.to_state_dict(jax.tree_util.tree_map(_np, restored.opt_state))},
                {k: raw[k] for k in ("params", "batch_stats", "opt_state")})
    shutil.copytree(workdir / cfg.checkpoint_dir, tmp_path / "b" / cfg.checkpoint_dir)
    jloop.train(dataclasses.replace(jcfg, num_epochs=3), _jax_split(train_d), _jax_split(val_d),
                workdir=str(tmp_path / "b"), resume=True, verbose=False)
    assert sorted(_logged(tmp_path / "b" / jcfg.log_dir)) == [3]
    model = jed.EmotionDiscriminator.from_config(jcfg)
    best = jckpt.load_checkpoint(str(workdir / cfg.checkpoint_dir / "ed_best.ckpt"))
    jstate = jloop.init_state(jcfg, model)
    jstate = jstate.replace(params=serialization.from_state_dict(jstate.params, best["params"]),
                            batch_stats=serialization.from_state_dict(jstate.batch_stats, best["batch_stats"]),
                            opt_state=serialization.from_state_dict(jstate.opt_state, best["opt_state"]))
    assert jloop.get_lr(jstate) == float(best["lr"])


@pytest.mark.parametrize("weighted", [False, True], ids=["permuted", "weighted"])
def test_resume_is_bit_identical_to_straight_through(tmp_path, weighted):
    """4 epochs in one go against 2, then ``resume=True`` to 4 in the same
    workdir: ``ed_epoch0004.ckpt`` byte for byte, the logged losses of
    epochs 3 and 4, and the returned best state with its random stream
    agree exactly."""
    train_d, val_d = _split(31, 20, emotions=["happy"] * 11 + ["sad"] * 5 + ["calm"] * 4), _split(32, 9)
    cfg = EDConfig(**dict(SMALL, num_epochs=4, save_freq=2, use_weighted_sampler=weighted))
    straight, m1 = ed_loop.train(cfg, train_d, val_d, workdir=str(tmp_path / "a"), verbose=False, device="cpu")
    ed_loop.train(dataclasses.replace(cfg, num_epochs=2), train_d, val_d, workdir=str(tmp_path / "b"),
                  verbose=False, device="cpu")
    resumed, m2 = ed_loop.train(cfg, train_d, val_d, workdir=str(tmp_path / "b"), resume=True,
                                verbose=False, device="cpu")
    final = [(tmp_path / w / cfg.checkpoint_dir / "ed_epoch0004.ckpt").read_bytes() for w in ("a", "b")]
    assert final[0] == final[1]
    # the returned state is the best of the run's own epochs: the straight
    # run's when the resumed run improved on the file's stopper, else the
    # state it resumed from, as JAX's loop returns
    if m2:
        assert m1 == m2
        want, count = straight, straight.opt.count
    else:
        want = ed_loop.init_state(cfg, device="cpu")
        weights.load_ed_payload(want, tckpt.load_checkpoint(str(tmp_path / "b" / cfg.checkpoint_dir /
                                                                 "ed_epoch0002.ckpt")))
        count = 2 * 2
    for k, v in want.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert resumed.opt.count == count
    assert torch.equal(want.rng.get_state(), resumed.rng.get_state())

    def losses(w):
        return {(ep, k): v for ep, d in _logged(tmp_path / w / cfg.log_dir).items() if ep >= 3
                for k, v in d.items() if k != "epoch_seconds"}

    assert losses("a") == losses("b") and len(losses("a")) == 2 * 5


def test_latent_mode_trains_and_evaluates(tmp_path):
    """Latent mode reads the latents, has no BatchNorm (an empty
    ``batch_stats`` map in the files, which JAX restores), and evaluates."""
    train_d, val_d = _split(41, 16), _split(42, 8)
    rng = np.random.default_rng(0)
    lat_t, lat_v = (rng.normal(size=(d.n, 6)).astype(np.float32) for d in (train_d, val_d))
    cfg = EDConfig(**dict(SMALL, input_mode="latent", num_epochs=2, save_freq=1))
    with pytest.raises(ValueError, match="latent mode requires"):
        ed_loop.train(cfg, train_d, val_d, workdir=str(tmp_path), device="cpu")
    state, metrics = ed_loop.train(cfg, train_d, val_d, train_latents=lat_t, val_latents=lat_v,
                                   workdir=str(tmp_path), verbose=False, device="cpu")
    raw = tckpt.load_checkpoint(str(tmp_path / cfg.checkpoint_dir / "ed_epoch0002.ckpt"))
    assert raw["batch_stats"] == {} and "encoder" not in raw["params"]
    jcfg = JEDConfig(**dict(SMALL, input_mode="latent", num_epochs=2, save_freq=1))
    restored, _ = jloop.train(jcfg, _jax_split(train_d), _jax_split(val_d), train_latents=lat_t,
                              val_latents=lat_v, workdir=str(tmp_path), resume=True, verbose=False)
    _tree_equal(serialization.to_state_dict(jax.tree_util.tree_map(_np, restored.params)), raw["params"])
    last = ed_loop.init_state(cfg, device="cpu")
    weights.load_ed_payload(last, raw)
    ours = ed_loop.evaluate(cfg, last, val_d, latents=lat_v)
    theirs = jloop.evaluate(jcfg, restored, _jax_split(val_d), latents=lat_v)
    assert_scaled(ours["loss"], theirs["loss"], what="loss")
    assert (ours["confusion"], ours["n"]) == (theirs["confusion"], 8)
    assert ed_loop.evaluate(cfg, state, val_d, latents=lat_v)["n"] == 8 and set(metrics) <= {
        "epoch", "val_loss", "val_acc"}


def test_unported_train_options_raise(tmp_path):
    cfg = EDConfig(**dict(SMALL, num_epochs=1))
    d = _split(51, 9)
    # bf16 precision is ported (tests/test_torch_precision.py); a spectral-norm
    # classifier is refused, as the JAX trainer cannot train one (ROADMAP C.5)
    sn_cfg = EDConfig(**dict(SMALL, num_epochs=1, use_spectral_norm=True))
    # the mesh is ported (tests/test_torch_parallel.py): anything but a Mesh is refused
    for c, kw, err in ((cfg, {"mesh": object()}, TypeError),
                       (cfg, {"precision": "fp16"}, ValueError),
                       (sn_cfg, {}, NotImplementedError)):
        with pytest.raises(err):
            ed_loop.train(c, d, d, workdir=str(tmp_path), device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ed_loop.train(cfg, d, d, workdir=str(tmp_path))
