"""The port's emotion discriminator and critic against the JAX package (CPU).

JAX variables cross into the port through ``utils/weights.py``
(``export_ed`` / ``export_critic``, strict loads). The JAX ED runs its
conv1d through the Pallas kernel in interpret mode. Outputs are compared
relative to their own scale at 1e-4: both sides sum in IEEE f32 in
different orders, about 1e-6 of the scale after four conv blocks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import EDConfig as JaxEDConfig
from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.models import ed as jed
from melogan_tpu.models import gan as jgan
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.utils import torch_interop

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.models import ed as ted
from melogan_torch.models import gan as tgan
from melogan_torch.models.layers import Dropout, gan_init_, torch_default_init_
from melogan_torch.utils import weights

REL = 1e-4


def assert_close_scaled(ours, theirs, rel=REL):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = float(np.max(np.abs(theirs)))
    assert scale > 0
    err = float(np.max(np.abs(ours - theirs)))
    assert err <= rel * scale, f"max abs err {err:.3e} > {rel} x scale {scale:.3e}"


@pytest.fixture
def pallas_on():
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on")
    try:
        yield
    finally:
        jax_conv_ops.set_use_pallas(prev)


def _perturb_stats(variables, rng):
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    for blk in variables.get("batch_stats", {}).get("encoder", {}).values():
        s = blk["TorchBatchNorm_0"]
        s["mean"] = rng.normal(0, 0.1, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return variables


def _pair(rng, cfg: dict, batch: int, length: int):
    jm = jed.EmotionDiscriminator.from_config(cfg)
    shape = (batch, cfg["latent_dim"]) if cfg["input_mode"] == "latent" else (batch, length, 4)
    x = rng.normal(size=shape).astype(np.float32)
    jvars = _perturb_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    tm = ted.EmotionDiscriminator.from_config(cfg).eval()
    tm.load_state_dict(weights.to_tensors(weights.export_ed(jvars)), strict=True)
    return jm, jvars, tm, x


SMALL = dict(input_mode="notes", latent_dim=8, notes_hidden=32, notes_blocks=3,
             mlp_hidden=[16, 8], n_classes=4, dropout=0.2, use_spectral_norm=False)


@pytest.mark.parametrize("mode", ["notes", "latent"])
def test_ed_matches_jax_small(rng, pallas_on, mode):
    cfg = dict(SMALL, input_mode=mode)
    jm, jvars, tm, x = _pair(rng, cfg, 3, 64)
    t = torch.from_numpy(x)
    with torch.no_grad():
        assert_close_scaled(tm(t).numpy(), jm.apply(jvars, jnp.asarray(x), train=False))
        for multi in (False, True):
            jf = jm.apply(jvars, jnp.asarray(x), train=False, multi=multi, method=jm.features)
            assert_close_scaled(tm.features(t, multi=multi).numpy(), jf)
            jf2, jl2 = jm.apply(jvars, jnp.asarray(x), train=False, multi=multi,
                                method=jm.features_and_logits)
            f2, l2 = tm.features_and_logits(t, multi=multi)
            assert_close_scaled(f2.numpy(), jf2)
            assert_close_scaled(l2.numpy(), jl2)
        jp = jm.apply(jvars, jnp.asarray(x), method=jm.predict_proba)
        assert_close_scaled(tm.predict_proba(t).numpy(), jp)
        np.testing.assert_array_equal(tm.predict(t).numpy(),
                                      np.asarray(jm.apply(jvars, jnp.asarray(x), method=jm.predict)))
    if mode == "notes":  # 32 + 32 + 32 (capped at notes_hidden) + 32 projected
        assert tm.features(t, multi=True).shape == (3, 64 + 32 + 32 + 32)


def test_ed_matches_jax_full_width(rng, pallas_on):
    """The shipped EDConfig() at batch 2 over 512 notes, features included."""
    cfg = JaxEDConfig().model_cfg()
    assert cfg == EDConfig().model_cfg()
    jm, jvars, tm, x = _pair(rng, cfg, 2, 512)
    t = torch.from_numpy(x)
    jf, jl = jm.apply(jvars, jnp.asarray(x), train=False, multi=True, method=jm.features_and_logits)
    with torch.no_grad():
        f, logits = tm.features_and_logits(t, multi=True)
    assert f.shape == (2, 64 + 128 + 256 + 256 + 256)
    assert_close_scaled(f.numpy(), jf)
    assert_close_scaled(logits.numpy(), jl)


def test_ed_input_gradient_matches_jax(rng, pallas_on):
    """The frozen ED inside the G loss passes only dx back to the notes: the
    input gradient of the CE through the Pallas conv's VJP vs the port's
    Function (the convT plain version on the CPU)."""
    jm, jvars, tm, x = _pair(rng, SMALL, 3, 64)
    labels = np.array([0, 2, 3])

    def loss(xx):
        logits = jm.apply(jvars, xx, train=False)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(3), labels])

    jdx = jax.grad(loss)(jnp.asarray(x))
    tm.requires_grad_(False)
    t = torch.from_numpy(x).requires_grad_()
    torch.nn.functional.cross_entropy(tm(t), torch.from_numpy(labels)).backward()
    assert all(p.grad is None for p in tm.parameters())
    assert_close_scaled(t.grad.numpy(), jdx)


def test_ed_train_mode_dropout_needs_explicit_randomness(rng):
    tm = ted.EmotionDiscriminator.from_config(SMALL).train()
    x = torch.from_numpy(rng.normal(size=(2, 64, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(x)
    a = tm(x, generator=torch.Generator().manual_seed(1))
    b = tm(x, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    d = Dropout(0.5).train()
    mask = torch.tensor([[True, False, True]])
    torch.testing.assert_close(d(torch.ones(1, 3), mask=mask), torch.tensor([[2.0, 0.0, 2.0]]))
    assert d.eval()(torch.ones(1, 3)) is not None


def test_exporters_equal_the_jax_originals(rng):
    jm, jvars, tm, _ = _pair(rng, SMALL, 2, 64)
    ours, theirs = weights.export_ed(jvars), torch_interop.export_ed(jvars)
    assert ours.keys() == theirs.keys() == tm.state_dict().keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    cfg = JaxGANConfig()
    critic = jgan.Critic.from_config(cfg)
    cvars = critic.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 4)), jnp.zeros((1, cfg.encoder_out_dim)))
    ours, theirs = weights.export_critic(cvars), torch_interop.export_critic(cvars)
    assert ours.keys() == theirs.keys() == tgan.Critic.from_config(GANConfig()).state_dict().keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_critic_matches_jax_without_numeric_embedding(rng):
    cfg = JaxGANConfig(use_numeric_encoder=False)
    critic = jgan.Critic.from_config(cfg)
    x = rng.normal(size=(3, 64, 4)).astype(np.float32)
    cvars = critic.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tc = tgan.Critic.from_config(GANConfig(use_numeric_encoder=False))
    tc.load_state_dict(weights.to_tensors(weights.export_critic(cvars)), strict=True)
    with torch.no_grad():
        assert_close_scaled(tc(torch.from_numpy(x)).numpy(), critic.apply(cvars, jnp.asarray(x)))
    with pytest.raises(ValueError, match="numeric embedding"):
        tgan.Critic.from_config(GANConfig())(torch.from_numpy(x))


def test_inits_draw_from_the_generator_only():
    """The GAN init and the torch-default init come from the generator
    given, never the global RNG: the same seed gives the same weights."""
    def build(seed):
        torch.manual_seed(1000 + seed)  # must not matter
        m = ted.EmotionDiscriminator.from_config(SMALL)
        torch_default_init_(m, torch.Generator().manual_seed(0))
        c = tgan.Critic.from_config(GANConfig())
        gan_init_(c, torch.Generator().manual_seed(0))
        return m, c

    (m1, c1), (m2, c2) = build(1), build(2)
    for a, b in ((m1, m2), (c1, c2)):
        for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    w = m1.encoder.conv[1].net[0].weight
    bound = 1 / np.sqrt(w[0].numel())
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.5 * bound
    assert float(c1.conv[0].weight.std()) == pytest.approx(0.02, rel=0.2)
    assert float(c1.conv[0].bias.abs().max()) == 0.0


def test_unported_ed_options_raise():
    with pytest.raises(NotImplementedError, match="SpectralNorm"):
        ted.EmotionDiscriminator.from_config(dict(SMALL, use_spectral_norm=True))
    with pytest.raises(ValueError, match="input_mode"):
        ted.EmotionDiscriminator(input_mode="audio")
    with pytest.raises(ValueError, match="expected"):
        ted.EmotionDiscriminator.from_config(SMALL)(torch.zeros(2, 4))
