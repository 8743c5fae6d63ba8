"""The port's WGAN-GP training step and loop against the JAX package (CPU).

One JAX ``GANTrainState`` is carried into the port with
``utils.weights.load_jax_train_state``; both sides then take one group step
and one critic-only tail step on the same numpy batches, and the port is
handed the JAX step's own random draws (noise, GP α, and the feature
encoder's dropout masks, read from the JAX encoder run with the same keys),
as ROADMAP "Random numbers" asks. The JAX side runs its Pallas kernels in
interpret mode (the generator's convT and the ED's conv1d); its critic is on
XLA's conv, the port's on ``F.conv1d``.

Tolerances, and why. Both sides sum in IEEE f32 in different orders, which
alone agrees to about 1e-7 of each quantity's scale here. Adam amplifies
some of it: at its first steps an update is about lr·g/(|g| + 1e-8), nearly
lr·sign(g), so an element whose true gradient is zero (a conv bias in front
of BatchNorm) moves by ±lr on either side at random.

- Metrics and BN running stats: 1e-4 of their scale (REL). An error in a
  term, a draw or an ordering is O(1).
- Gradients, read as Adam's first moments, per module group (G, feature
  encoder, critic) relative to the group's largest element: 1e-5
  (GRAD_REL). Relative to the group, because a zero gradient's own scale
  is rounding noise.
- Parameters: every element within 2·lr per update it took; where its
  gradient is above 1e-4 of the group's largest, within 1e-6 absolute per
  update (5e-5 of the 0.02 init scale).

The critic starts away from its N(0, 0.02) init (see ``_setup``). At the
init its pre-activations are so small that Adam's ±lr first moves flip
LeakyReLU kinks; then the two sides' rounding can send a unit down
different branches and its gradient differs by O(1) after a few updates.
"""
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import EDConfig as JaxEDConfig
from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.data import datasets as jdata
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.train import gan_loop as jloop
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.utils import checkpoint as jckpt
from melogan_tpu.utils import flops as jflops
from melogan_tpu.utils import torch_interop

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.sampling import Sampler
from melogan_torch.train import gan_loop as tloop
from melogan_torch.train import gan_step as tstep
from melogan_torch.utils import checkpoint as tckpt
from melogan_torch.utils import flops as tflops
from melogan_torch.utils import weights

REL = 1e-4
GRAD_REL = 1e-5
TINY = dict(max_notes=64, batch_size=4, noise_dim=16, latent_dim=8, gen_hidden=32,
            encoder_hidden=(16, 8), encoder_out_dim=8)
TINY_ED = dict(max_notes=64, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads, which made a 3 s test take
    minutes under pytest-xdist."""
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


def assert_metrics(ours, theirs, what):
    assert set(ours) == set(theirs), what
    for k in theirs:
        assert_scaled(float(ours[k]), float(theirs[k]), what=f"{what} {k}")


def _batches(rng, cfg, k):
    b = cfg.batch_size
    return (
        rng.normal(size=(k, b, cfg.max_notes, cfg.note_dim)).astype(np.float32),
        rng.integers(0, 4, size=(k, b)).astype(np.int32),
        rng.normal(size=(k, b, cfg.latent_dim)).astype(np.float32),
        rng.normal(size=(k, b, cfg.numeric_input_dim)).astype(np.float32),
    )


def _torch_batches(batches):
    notes, emo, lat, num = batches
    return (torch.from_numpy(notes), torch.from_numpy(emo.astype(np.int64)),
            torch.from_numpy(lat), torch.from_numpy(num))


def _fe_masks(models, fe_params, numeric, key):
    """The JAX encoder's dropout keep masks for one train-mode call: where
    the Dropout outputs are non-zero (their inputs, GELUs of random
    pre-activations, are never exactly zero)."""
    _, inter = models.feature_encoder.apply(
        {"params": fe_params}, jnp.asarray(numeric), train=True, rngs={"dropout": key},
        capture_intermediates=True, mutable=["intermediates"])
    inter = inter["intermediates"]
    return [torch.from_numpy(_np(inter[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(sum(1 for k in inter if k.startswith("Dropout_")))]


def _critic_draws(cfg, models, fe_params, rng, numeric_k):
    """Replay ``critic_update``'s splits of the carried key, one per batch."""
    draws = []
    for numeric in numeric_k:
        rng, k_drop, k_noise, k_alpha = jax.random.split(rng, 4)
        b = numeric.shape[0]
        draws.append(tstep.CriticDraws(
            noise=torch.from_numpy(_np(jax.random.normal(k_noise, (b, cfg.noise_dim)))),
            alpha=torch.from_numpy(_np(jax.random.uniform(k_alpha, (b, 1, 1)))),
            fe_masks=_fe_masks(models, fe_params, numeric, k_drop),
        ))
    return draws, rng


def _group_draws(cfg, models, state, batches):
    critic, rng = _critic_draws(cfg, models, state.fe_params, state.rng, batches[3])
    rng, k_drop, k_noise = jax.random.split(rng, 3)
    b = batches[3].shape[1]
    gen = tstep.GenDraws(
        noise=torch.from_numpy(_np(jax.random.normal(k_noise, (b, cfg.noise_dim)))),
        fe_masks=_fe_masks(models, state.fe_params, batches[3][-1], k_drop),
    )
    return tstep.GroupDraws(critic=critic, gen=gen)


def _corpus(rng, n, max_notes=64):
    """A SplitData-shaped corpus in the raw AE layout (a few padding rows)."""
    pitch = rng.uniform(20, 110, (n, max_notes))
    pitch[:, -3:] = -1
    raw = np.stack([pitch, np.cumsum(rng.uniform(0, 1, (n, max_notes)), 1),
                    rng.uniform(0, 3, (n, max_notes)), rng.uniform(0, 127, (n, max_notes))],
                   -1).astype(np.float32)
    emotions = np.array(["happy", "sad", "angry", "calm"])[rng.integers(0, 4, n)]
    numeric = rng.normal(size=(n, 6)).astype(np.float32)
    return raw, emotions, numeric


def _setup(rng, fused, lambda_fm, ema_decay, perturb_ed=True):
    kw = dict(TINY, fused_critic_batch=fused, lambda_fm=lambda_fm, ema_decay=ema_decay)
    jcfg, tcfg = JaxGANConfig(**kw), GANConfig(**kw)
    jed_cfg, ted_cfg = JaxEDConfig(**TINY_ED), EDConfig(**TINY_ED)
    models = jstep.build_models(jcfg, jed_cfg)
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("off")  # init's eval forward: same params, no interpreter
    try:
        jstate = jstep.init_state(jcfg, models, seed=0)
    finally:
        jax_conv_ops.set_use_pallas(prev)
    if perturb_ed:  # non-trivial ED running stats, so eval-mode BN is exercised
        stats = jax.tree.map(_np, jstate.ed_stats)
        for blk in stats["encoder"].values():
            s = blk["TorchBatchNorm_0"]
            s["mean"] = rng.normal(0, 0.1, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
        jstate = jstate.replace(ed_stats=stats)
    # a critic away from its N(0, 0.02) init (module docstring)
    critic = jax.tree.map(_np, jstate.critic_params)
    for layer in critic.values():
        layer["kernel"] = layer["kernel"] * np.float32(10.0)
        layer["bias"] = rng.normal(0, 0.05, layer["bias"].shape).astype(np.float32)
    jstate = jstate.replace(critic_params=critic)
    fm_target = fm_ed_target = None
    if lambda_fm:
        raw, emotions, _ = _corpus(rng, 24)
        notes = jdata.SplitData(raw, emotions, np.zeros((24, 6)), []).notes_gan()
        idx = np.array([jdata.EMOTION_TO_INDEX[e] for e in emotions])
        fm_target = jstep.fm_targets_from_data(notes, idx)
        fm_ed_target = jstep.fm_ed_targets_from_data(
            models.ed, {"params": jstate.ed_params, "batch_stats": jstate.ed_stats}, notes, idx)
    jsteps = jstep.make_train_steps(jcfg, models, fm_target=fm_target, fm_ed_target=fm_ed_target)

    tstate = tstep.init_state(tcfg, tstep.build_models(tcfg, ted_cfg), seed=0, device="cpu")
    weights.load_jax_train_state(tstate, jstate)
    tsteps = tstep.make_train_steps(tcfg, fm_target=fm_target, fm_ed_target=fm_ed_target)
    return jcfg, models, jstate, jsteps, tstate, tsteps


def _named(module):
    return dict(module.named_parameters())


def _check_group(module, opt, mu_sd, params_sd, lr, updates, what):
    """Gradients (Adam's first moments) and parameters of one module group,
    with the tolerances of the module docstring."""
    named = _named(module)
    gmax = max(float(np.abs(mu_sd[n]).max()) for n in named)
    assert gmax > 0, what
    for name, p in named.items():
        mu = np.asarray(mu_sd[name])
        err = np.abs(opt.state[p]["exp_avg"].numpy() - mu).max()
        assert err <= GRAD_REL * gmax, f"{what} grad {name}: {err:.3e} vs group max {gmax:.3e}"
        d = np.abs(p.detach().numpy() - np.asarray(params_sd[name]))
        assert d.max() <= 2 * lr * updates * (1 + 1e-3), f"{what} {name}: {d.max():.3e}"
        big = np.abs(mu) > 1e-4 * gmax
        if big.any():
            assert d[big].max() <= 1e-6 * updates, f"{what} {name}: {d[big].max():.3e} where the gradient is large"


CASES = [
    # (fused_critic_batch, lambda_fm, ema_decay): each value of each axis,
    # the reference loss alone first
    (False, 0.0, 0.0),
    (True, 0.0, 0.9),
    (False, 1.0, 0.9),
    (True, 1.0, 0.0),
]


@pytest.mark.parametrize("fused,lambda_fm,ema_decay", CASES)
def test_group_and_tail_step_match_jax(rng, pallas_on, fused, lambda_fm, ema_decay):
    jcfg, models, jstate, jsteps, tstate, tsteps = _setup(rng, fused, lambda_fm, ema_decay)
    batches = _batches(rng, jcfg, jcfg.critic_iters)
    draws = _group_draws(jcfg, models, jstate, batches)
    jnew, jm = jax.jit(jsteps.group)(jstate, tuple(jnp.asarray(a) for a in batches))
    tstate, tm = tsteps.group(tstate, _torch_batches(batches), draws)

    assert tstate.step == int(jnew.step) == 1
    assert_metrics(tm, jm, "group")

    # gradients (through Adam's first moments) and parameters
    gen_mu, fe_mu = jnew.opt_g[0].mu
    g_sd = torch_interop.export_generator({"params": jnew.gen_params, "batch_stats": jnew.gen_stats})
    _check_group(tstate.generator, tstate.opt_g,
                 torch_interop.export_generator({"params": gen_mu, "batch_stats": jnew.gen_stats}),
                 g_sd, jcfg.lr_g, 1, "G")
    _check_group(tstate.feature_encoder, tstate.opt_g,
                 torch_interop.export_feature_encoder({"params": fe_mu}),
                 torch_interop.export_feature_encoder({"params": jnew.fe_params}), jcfg.lr_g, 1, "FE")
    _check_group(tstate.critic, tstate.opt_d,
                 torch_interop.export_critic({"params": jnew.opt_d[0].mu}),
                 torch_interop.export_critic({"params": jnew.critic_params}),
                 jcfg.lr_d, jcfg.critic_iters, "critic")
    for t in (1, 4):
        bn = tstate.generator.decoder.deconv[t]
        assert_scaled(bn.running_mean.numpy(), g_sd[f"decoder.deconv.{t}.running_mean"], what="BN mean")
        assert_scaled(bn.running_var.numpy(), g_sd[f"decoder.deconv.{t}.running_var"], what="BN var")
    # the frozen ED did not move
    ed_sd = torch_interop.export_ed({"params": jnew.ed_params, "batch_stats": jnew.ed_stats})
    for name, v in tstate.ed.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ed_sd[name], err_msg=name)
    if ema_decay:
        ours = tstep.ema_weights(tstate, ema_decay)
        theirs = torch_interop.export_generator(
            {"params": jstep.ema_weights(jnew, ema_decay), "batch_stats": jnew.gen_stats})
        for name, v in ours.items():
            d = np.abs(v.numpy() - theirs[name]).max()
            assert d <= 2 * jcfg.lr_g * (1 + 1e-3), name  # the live weights' slack, see above
    else:
        assert tstate.ema_params is None and tstep.ema_weights(tstate, 0.0) is None

    # then a critic-only tail of two batches from the stepped states
    tail = _batches(rng, jcfg, 2)
    tail_draws, _ = _critic_draws(jcfg, models, jnew.fe_params, jnew.rng, tail[3])
    jtail, jtm = jax.jit(jsteps.tail)(jnew, tuple(jnp.asarray(a) for a in tail))
    tstate, ttm = tsteps.tail(tstate, _torch_batches(tail), tail_draws)
    assert_metrics(ttm, jtm, "tail")
    g_sd = torch_interop.export_generator({"params": jtail.gen_params, "batch_stats": jtail.gen_stats})
    for t in (1, 4):
        bn = tstate.generator.decoder.deconv[t]
        assert_scaled(bn.running_var.numpy(), g_sd[f"decoder.deconv.{t}.running_var"], what="tail BN")
    c_sd = torch_interop.export_critic({"params": jtail.critic_params})
    for name, p in _named(tstate.critic).items():
        assert np.abs(p.detach().numpy() - c_sd[name]).max() <= 2 * jcfg.lr_d * (jcfg.critic_iters + 2)


def test_gradient_penalty_matches_jax(rng):
    """The critic's scores and the GP (second derivative through F.conv1d)
    against ``_gradient_penalty`` at the shipped critic width."""
    jcfg = JaxGANConfig()
    models = jstep.build_models(jcfg, JaxEDConfig(**TINY_ED))
    b = 3
    real = rng.normal(size=(b, 128, 4)).astype(np.float32)
    fake = rng.normal(size=(b, 128, 4)).astype(np.float32)
    emb = rng.normal(size=(b, jcfg.encoder_out_dim)).astype(np.float32)
    alpha = rng.uniform(size=(b, 1, 1)).astype(np.float32)
    cvars = models.critic.init(jax.random.PRNGKey(0), jnp.asarray(real), jnp.asarray(emb))
    jscore = models.critic.apply(cvars, jnp.asarray(real), jnp.asarray(emb))
    jgp = jstep._gradient_penalty(models.critic, cvars["params"], *map(jnp.asarray, (real, fake, emb, alpha)))

    critic = tstep.Critic.from_config(GANConfig())
    critic.load_state_dict(weights.to_tensors(weights.export_critic(cvars)), strict=True)
    t = [torch.from_numpy(a) for a in (real, fake, emb, alpha)]
    assert_scaled(critic(t[0], t[2]).detach().numpy(), jscore, rel=1e-4, what="scores")
    gp = tstep.gradient_penalty(critic, *t)
    assert_scaled(float(gp), float(jgp), rel=1e-5, what="gp")
    # and it differentiates w.r.t. the critic's weights (the second derivative)
    gp.backward()
    for p in (critic.conv[0].weight, critic.conv[4].weight, critic.real_fake.weight):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


def test_note_space_stats_and_fm_targets_match_jax(rng):
    notes = rng.uniform(-1, 1, (5, 64, 4)).astype(np.float32)
    assert_scaled(tstep.note_space_stats(torch.from_numpy(notes)).numpy(),
                  jstep.note_space_stats(jnp.asarray(notes)), rel=1e-5)
    idx = np.array([0, 1, 1, 3, 0])  # emotion 2 absent: the corpus mean
    for a, b in zip(tstep.fm_targets_from_data(notes, idx), jstep.fm_targets_from_data(notes, idx)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 6)
    assert_scaled(float(tstep.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
                  float(jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)


def test_fm_ed_targets_match_jax(rng):
    jed = jstep.build_models(JaxGANConfig(**TINY), JaxEDConfig(**TINY_ED)).ed
    ed_vars = jed.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 4)), train=False)
    notes = rng.uniform(-1, 1, (10, 64, 4)).astype(np.float32)
    idx = rng.integers(0, 4, 10)
    theirs = jstep.fm_ed_targets_from_data(jed, ed_vars, notes, idx, batch_size=4)
    ted = tstep.build_models(GANConfig(**TINY), EDConfig(**TINY_ED)).ed.eval()
    ted.load_state_dict(weights.to_tensors(weights.export_ed(ed_vars)), strict=True)
    ours = tstep.fm_ed_targets_from_data(ted, notes, idx, batch_size=4)
    for a, b in zip(ours, theirs):
        assert_scaled(a, b, rel=1e-4)


def test_ema_helpers_match_jax():
    for kw, epochs, n in [({}, 10, 1282), ({"ema_decay": 0.9}, 2, 1282),
                          ({"ema_decay": 0.99}, 1000, 1282), ({"ema_decay": 0.9}, 3, 100)]:
        assert (tstep.ema_horizon_note(GANConfig(**kw), epochs, n) is None) == \
            (jstep.ema_horizon_note(JaxGANConfig(**kw), epochs, n) is None)
    for epochs, n in [(50, 1282), (2, 1282), (500, 5000)]:
        assert tstep.ema_auto_decay(GANConfig(), epochs, n) == jstep.ema_auto_decay(
            JaxGANConfig(), epochs, n)
    with pytest.raises(ValueError, match="zero generator updates"):
        tstep.ema_auto_decay(GANConfig(), 5, 10)


def test_epoch_group_indices_match_jax():
    for n, b, k in [(31, 4, 5), (400, 32, 5), (7, 4, 5), (3, 4, 5)]:
        ours = tdata.epoch_group_indices(n, b, k, np.random.default_rng(7))
        theirs = jdata.epoch_group_indices(n, b, k, np.random.default_rng(7))
        for a, t in zip(ours, theirs):
            assert (a is None) == (t is None)
            if a is not None:
                np.testing.assert_array_equal(a, t)


def test_split_data_matches_jax(rng):
    raw, emotions, numeric = _corpus(rng, 6)
    ours = tdata.SplitData(raw, emotions, numeric, [])
    theirs = jdata.SplitData(raw, emotions, numeric, [])
    np.testing.assert_array_equal(ours.notes_gan(), theirs.notes_gan())
    np.testing.assert_array_equal(ours.emotion_idx, theirs.emotion_idx)


@pytest.mark.parametrize("kw,ed_kw", [({}, {}), (dict(TINY, max_notes=500), TINY_ED)])
def test_flop_counts_match_jax(kw, ed_kw):
    """The port's FLOP counts are JAX's, except that the frozen ED counts 2×
    its forward in the generator update (forward and input gradient) where
    JAX counts 3×: a group step is critic_iters JAX batch-steps less one
    ED forward per sample (up to JAX's integer division by critic_iters)."""
    cfg, ed_cfg = GANConfig(**kw), EDConfig(**ed_kw)
    jcfg, jed_cfg = JaxGANConfig(**kw), JaxEDConfig(**ed_kw)
    for name in ("feature_encoder_flops", "generator_flops", "critic_flops"):
        assert getattr(tflops, name)(cfg) == getattr(jflops, name)(jcfg), name
    assert tflops.ed_flops(ed_cfg) == jflops.ed_flops(jed_cfg)
    k, b = cfg.critic_iters, cfg.batch_size
    group = tflops.group_step_flops(cfg, ed_cfg)
    want = k * jflops.train_flops_per_step(jcfg, jed_cfg) - b * jflops.ed_flops(jed_cfg)
    assert 0 <= group - want < k
    assert tflops.train_flops_per_step(cfg, ed_cfg) == group // k


def test_fm_without_targets_raises():
    with pytest.raises(ValueError, match="fm_target"):
        tstep.make_train_steps(GANConfig(lambda_fm=1.0))


# the per-epoch scalars the JAX loop writes (gan_loop.py:280-295)
JAX_HISTORY_KEYS = {"Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo",
                    "Critic/Wasserstein", "Critic/d_real", "Critic/d_fake", "Critic/gp",
                    "epoch_seconds", "epoch"}


@pytest.mark.parametrize("lambda_fm,ema_decay", [(0.0, 0.0), (1.0, 0.9)])
def test_train_loop_writes_a_gan_final_the_sampler_loads(rng, tmp_path, lambda_fm, ema_decay):
    """Two epochs of 1 group + a 2-batch tail each on the CPU."""
    raw, emotions, numeric = _corpus(rng, 4 * 7 + 3)
    data = tdata.SplitData(raw, emotions, numeric, [str(i) for i in range(len(raw))])
    cfg = GANConfig(**dict(TINY, lambda_fm=lambda_fm, ema_decay=ema_decay))
    ed_cfg = EDConfig(**TINY_ED)
    ed_sd = None
    if lambda_fm:  # a pre-trained ED turns the ED feature-matching term on
        ed = tstep.build_models(cfg, ed_cfg).ed
        ed_sd = ed.state_dict()
    state, hist = tloop.train(cfg, ed_cfg, data, ed_variables=ed_sd, workdir=str(tmp_path),
                              epochs=2, verbose=False, device="cpu")
    want = JAX_HISTORY_KEYS | ({"Loss/Generator_FM"} if lambda_fm else set())
    assert set(hist) == want and hist["epoch"] == 2
    assert all(math.isfinite(v) for v in hist.values())
    assert state.step == 2
    path = tmp_path / cfg.checkpoint_dir / "gan_final.pth"
    gen_sd, fe_sd, extras = weights.load_gan_final_full(str(path), ema=bool(ema_decay))
    features = extras["emotion_features"]
    want_ef = tloop.emotion_centroids(numeric, data.emotion_idx)
    np.testing.assert_array_equal(features, want_ef)
    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                      emotion_features=features, device="cpu")
    notes = sampler.sample_notes(["happy", "calm"], seed=1)
    assert notes.shape == (2, 64, 4) and np.isfinite(notes).all()
    # the JAX-layout gan_final.ckpt beside it serves the same notes
    ckpt_g, ckpt_fe, extras = tloop.load_gan_final_full(str(path.with_suffix(".ckpt")), ema=bool(ema_decay))
    np.testing.assert_array_equal(extras["emotion_features"], want_ef)
    ckpt_sampler = Sampler(cfg, gen_variables=ckpt_g, fe_variables=ckpt_fe,
                           emotion_features=extras["emotion_features"], device="cpu")
    np.testing.assert_array_equal(ckpt_sampler.sample_notes(["happy", "calm"], seed=1), notes)
    if not ema_decay:
        for p in (path, path.with_suffix(".ckpt")):
            with pytest.raises(KeyError, match="G_ema"):
                weights.load_gan_final_full(str(p), ema=True)


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------


def _split(seed, n=4 * 7 + 3):
    raw, emotions, numeric = _corpus(np.random.default_rng(seed), n)
    return raw, emotions, numeric


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


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX ``gan_loop.train`` for 2 epochs with EMA 0.9 and save_freq 2 (1
    group step and a 2-batch tail an epoch): its workdir and data."""
    workdir = tmp_path_factory.mktemp("jax_run")
    raw, emotions, numeric = _split(21)
    jloop.train(JaxGANConfig(**TINY, save_freq=2, ema_decay=0.9), JaxEDConfig(**TINY_ED),
                jdata.SplitData(raw, emotions, numeric, []), workdir=str(workdir), epochs=2,
                verbose=False)
    return workdir, (raw, emotions, numeric)


def _jax_ckpt(workdir, name="gan_epoch0002.ckpt"):
    return str(workdir / JaxGANConfig().checkpoint_dir / name)


def test_jax_checkpoint_loads_into_the_port_and_exports_back_bit_for_bit(jax_run):
    """Params, batch_stats, Adam's mu, nu and count, step, ema_raw and the
    debiased G_ema all come back as the file holds them."""
    workdir, _ = jax_run
    raw = tckpt.load_checkpoint(_jax_ckpt(workdir))
    cfg = GANConfig(**TINY, save_freq=2, ema_decay=0.9)
    state = tstep.init_state(cfg, tstep.build_models(cfg, EDConfig(**TINY_ED)), seed=0, device="cpu")
    epoch, note = weights.load_train_payload(state, raw, cfg.ema_decay)
    assert epoch == 2 and state.step == 2 and "no torch random stream" in note
    back = weights.export_train_payload(state, epoch, raw["emotion_features"],
                                        g_ema=tstep.ema_weights(state, cfg.ema_decay))
    assert set(back) - set(raw) == {weights.TORCH_RNG_KEY, weights.TORCH_BN_KEY}
    assert set(raw) - set(back) == {"rng"}
    _tree_equal({k: back[k] for k in raw if k != "rng"}, {k: raw[k] for k in raw if k != "rng"})
    # every torch parameter got its Adam state, ``step`` a CPU scalar as torch makes it
    for opt, count in ((state.opt_g, 2), (state.opt_d, 14)):
        for p in opt.param_groups[0]["params"]:
            st = opt.state[p]
            assert float(st["step"]) == count and st["step"].device.type == "cpu"
            assert st["exp_avg"].shape == p.shape
    # a file of another shape is refused, naming the key
    bad = dict(raw, D={"params": dict(raw["D"]["params"], TorchLinear_1={
        "kernel": np.zeros((3, 1), np.float32), "bias": np.zeros(1, np.float32)})})
    with pytest.raises(ValueError, match="/D/params/TorchLinear_1/kernel"):
        weights.load_train_payload(state, bad, cfg.ema_decay)


def _restore_jax(jstate, raw):
    """The JAX loop's resume (gan_loop.py:152-171) on a JAX state."""
    from flax import serialization as ser

    state = jstate.replace(
        gen_params=ser.from_state_dict(jstate.gen_params, raw["G"]["params"]),
        gen_stats=ser.from_state_dict(jstate.gen_stats, raw["G"]["batch_stats"]),
        critic_params=ser.from_state_dict(jstate.critic_params, raw["D"]["params"]),
        fe_params=ser.from_state_dict(jstate.fe_params, raw["E_num"]["params"]),
        opt_g=ser.from_state_dict(jstate.opt_g, raw["opt_G"]),
        opt_d=ser.from_state_dict(jstate.opt_d, raw["opt_D"]),
        rng=jnp.asarray(raw["rng"], jnp.uint32),
        step=jnp.asarray(raw["step"], jnp.int32),
    )
    if state.ema_params is not None:
        state = state.replace(ema_params=ser.from_state_dict(state.ema_params, raw["ema_raw"]))
    return state


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_port_resumes_a_jax_checkpoint_and_steps_like_jax(rng, jax_run, pallas_on, tmp_path, ema_decay):
    """One group step from a JAX ``gan_epoch0002.ckpt`` on each side, with
    JAX's draws injected, at the tolerances of
    ``test_group_and_tail_step_match_jax``. At step 2 Adam's moments and
    ``count`` shape the update, so a moment in the wrong layout, a wrong
    count or a moment left at zero shows. The file's critic is moved away
    from its init first (weights ×10, biases N(0, 0.05); module docstring)."""
    workdir, _ = jax_run
    raw = jckpt.load_checkpoint(_jax_ckpt(workdir))
    for layer in raw["D"]["params"].values():
        layer["kernel"] = layer["kernel"] * np.float32(10.0)
        layer["bias"] = rng.normal(0, 0.05, layer["bias"].shape).astype(np.float32)
    path = str(tmp_path / "gan_epoch0002.ckpt")
    jckpt.save_checkpoint(path, raw)

    kw = dict(TINY, save_freq=2, ema_decay=ema_decay)
    jcfg, tcfg = JaxGANConfig(**kw), GANConfig(**kw)
    jed_cfg, ted_cfg = JaxEDConfig(**TINY_ED), EDConfig(**TINY_ED)
    models = jstep.build_models(jcfg, jed_cfg)
    jax_conv_ops.set_use_pallas("off")  # init's eval forward: no interpreter
    try:
        jinit = jstep.init_state(jcfg, models, seed=0)
    finally:
        jax_conv_ops.set_use_pallas("on")
    jstate = _restore_jax(jinit, jckpt.load_checkpoint(path))
    tstate = tstep.init_state(tcfg, tstep.build_models(tcfg, ted_cfg), seed=0, device="cpu")
    weights.load_jax_train_state(tstate, jinit)  # the same frozen ED on both sides
    epoch, _ = weights.load_train_payload(tstate, tckpt.load_checkpoint(path), ema_decay)
    assert epoch == 2 and tstate.step == int(jstate.step) == 2

    batches = _batches(rng, jcfg, jcfg.critic_iters)
    draws = _group_draws(jcfg, models, jstate, batches)
    jnew, jm = jax.jit(jstep.make_train_steps(jcfg, models).group)(
        jstate, tuple(jnp.asarray(a) for a in batches))
    tstate, tm = tstep.make_train_steps(tcfg).group(tstate, _torch_batches(batches), draws)
    assert tstate.step == int(jnew.step) == 3
    assert_metrics(tm, jm, "group from checkpoint")
    gen_mu, fe_mu = jnew.opt_g[0].mu
    _check_group(tstate.generator, tstate.opt_g,
                 torch_interop.export_generator({"params": gen_mu, "batch_stats": jnew.gen_stats}),
                 torch_interop.export_generator({"params": jnew.gen_params, "batch_stats": jnew.gen_stats}),
                 jcfg.lr_g, 1, "G")
    _check_group(tstate.feature_encoder, tstate.opt_g,
                 torch_interop.export_feature_encoder({"params": fe_mu}),
                 torch_interop.export_feature_encoder({"params": jnew.fe_params}), jcfg.lr_g, 1, "FE")
    _check_group(tstate.critic, tstate.opt_d,
                 torch_interop.export_critic({"params": jnew.opt_d[0].mu}),
                 torch_interop.export_critic({"params": jnew.critic_params}),
                 jcfg.lr_d, jcfg.critic_iters, "critic")
    assert {float(st["step"]) for st in tstate.opt_g.state.values()} == {float(jnew.opt_g[0].count)} == {3.0}
    assert {float(st["step"]) for st in tstate.opt_d.state.values()} == {float(jnew.opt_d[0].count)}
    if ema_decay:
        theirs = torch_interop.export_generator(
            {"params": jstep.ema_weights(jnew, ema_decay), "batch_stats": jnew.gen_stats})
        for name, v in tstep.ema_weights(tstate, ema_decay).items():
            assert np.abs(v.numpy() - theirs[name]).max() <= 2 * jcfg.lr_g * (1 + 1e-3), name
    else:
        assert tstate.ema_params is None


def _records(path):
    import json

    return [json.loads(line) for line in open(path)]


def test_train_writes_the_jax_metric_tags_and_checkpoints(jax_run, tmp_path):
    """The same config and corpus through the port's ``train()``: the same
    tags at the same steps in the same order as the JAX run (the values
    differ: the random streams do), and the periodic checkpoints of the
    JAX cadence."""
    jax_dir, (raw, emotions, numeric) = jax_run
    cfg = GANConfig(**TINY, save_freq=2, ema_decay=0.9)
    tloop.train(cfg, EDConfig(**TINY_ED), tdata.SplitData(raw, emotions, numeric, []),
                workdir=str(tmp_path), epochs=3, verbose=False, device="cpu")
    ours = _records(tmp_path / cfg.log_dir / "metrics.jsonl")
    theirs = _records(jax_dir / cfg.log_dir / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in ours if r["step"] <= 2] == [(r["tag"], r["step"]) for r in theirs]
    assert {r["step"] for r in ours} == {1, 2, 3}
    ckpts = sorted(p.name for p in (tmp_path / cfg.checkpoint_dir).iterdir())
    assert ckpts == ["gan_epoch0002.ckpt", "gan_final.ckpt", "gan_final.pth"]


def _assert_states_equal(a, b):
    for name in ("generator", "feature_encoder", "critic"):
        for (k, v), (k2, v2) in zip(getattr(a, name).state_dict().items(),
                                    getattr(b, name).state_dict().items()):
            assert k == k2 and torch.equal(v, v2), f"{name}.{k}"
    for opt in ("opt_g", "opt_d"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(oa.state[pa][k], ob.state[pb][k]), f"{opt} {k}"
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("first_ema,ema", [(0.0, 0.0), (0.9, 0.9), (0.0, 0.9)])
def test_resume_is_bit_identical_to_straight_through(tmp_path, first_ema, ema):
    """``train(epochs=4)`` against ``train(epochs=2)`` then ``train(epochs=4,
    resume=True)``: every parameter, buffer, Adam moment and step, the EMA
    stream, the random stream and the last epoch's history are equal. The
    third case resumes a checkpoint written without EMA with EMA on: the
    stream is seeded as (1 − d^t)·p, and the trajectory is the EMA-less
    run's (EMA does not feed back into training)."""
    raw, emotions, numeric = _split(5)
    data = tdata.SplitData(raw, emotions, numeric, [])
    ed_cfg = EDConfig(**TINY_ED)

    def cfg(d):
        return GANConfig(**TINY, save_freq=2, ema_decay=d, lambda_fm=1.0 if ema else 0.0)

    straight, hs = tloop.train(cfg(first_ema), ed_cfg, data, workdir=str(tmp_path / "a"), epochs=4,
                               verbose=False, device="cpu")
    split = str(tmp_path / "b")
    tloop.train(cfg(first_ema), ed_cfg, data, workdir=split, epochs=2, verbose=False, device="cpu")
    if first_ema != ema:
        # resumed at its end: no epoch runs, and the debiased EMA is the live weights
        shutil.copytree(split, str(tmp_path / "mid"))
        mid, _ = tloop.train(cfg(ema), ed_cfg, data, workdir=str(tmp_path / "mid"), epochs=2,
                             verbose=False, device="cpu", resume=True)
        t = mid.step
        for n, p in mid.generator.named_parameters():
            assert torch.equal(mid.ema_params[n], p.detach() * torch.tensor(np.float32(1 - ema ** t)))
            torch.testing.assert_close(tstep.ema_weights(mid, ema)[n], p.detach(), rtol=1e-6, atol=1e-7)
    resumed, hr = tloop.train(cfg(ema), ed_cfg, data, workdir=split, epochs=4, verbose=False,
                              device="cpu", resume=True)
    _assert_states_equal(straight, resumed)
    if first_ema == ema and ema:
        for n in straight.ema_params:
            assert torch.equal(straight.ema_params[n], resumed.ema_params[n]), n
    assert (resumed.ema_params is None) == (not ema)
    assert {k: v for k, v in hs.items() if k != "epoch_seconds"} == \
        {k: v for k, v in hr.items() if k != "epoch_seconds"}
