"""The port's Generator and FeatureEncoder against the JAX package.

JAX variables cross into the port through ``utils/weights.py``
(``load_jax_variables``, strict loads); inputs come from a seeded numpy
generator. Outputs are compared relative to their own scale: the GAN init
N(0, 0.02) makes the notes small (about 1e-4), and both sides sum in IEEE f32
in different orders, which agrees to about 1e-6 of the scale; the tests allow
1e-4 of it.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.models import gan as jgan
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.utils import torch_interop

from melogan_torch.config import GANConfig
from melogan_torch.models import gan as tgan
from melogan_torch.models.layers import default_precision, set_default_precision, trim_or_pad_length
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


def _perturb_bn(variables, rng):
    """Non-trivial running statistics, so folding BN is exercised."""
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    for d in variables["batch_stats"]["decoder"].values():
        d["mean"] = rng.normal(0, 0.1, d["mean"].shape).astype(np.float32)
        d["var"] = rng.uniform(0.5, 2.0, d["var"].shape).astype(np.float32)
    for name, p in variables["params"]["decoder"].items():
        if name.startswith("TorchBatchNorm"):
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
            p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    return variables


def _pair(rng, mode, max_notes, noise_dim=16, latent_dim=16, hidden=32, emb=8, batch=3):
    jg = jgan.Generator(noise_dim=noise_dim, latent_dim=latent_dim, mode=mode, hidden=hidden,
                        max_notes=max_notes, numeric_embed_dim=emb)
    noise = rng.normal(size=(batch, noise_dim)).astype(np.float32)
    emb_in = rng.normal(size=(batch, emb)).astype(np.float32)
    lat = rng.normal(size=(batch, latent_dim)).astype(np.float32) if mode == "conditioning" else None
    jvars = jg.init(jax.random.PRNGKey(0), jnp.asarray(noise),
                    None if lat is None else jnp.asarray(lat), jnp.asarray(emb_in), train=False)
    jvars = _perturb_bn(jvars, rng)
    tg = tgan.Generator(noise_dim=noise_dim, latent_dim=latent_dim, mode=mode, hidden=hidden,
                        max_notes=max_notes, numeric_embed_dim=emb)
    tg.load_state_dict(weights.to_tensors(weights.export_generator(jvars)), strict=True)
    return jg, jvars, tg, noise, lat, emb_in


@pytest.mark.parametrize("mode", ["warm_start", "conditioning"])
@pytest.mark.parametrize("max_notes,fused", [(64, True), (60, False)])
def test_generator_matches_jax_small(rng, pallas_on, mode, max_notes, fused):
    """Both fuse-gate branches and both integration modes; the JAX side runs
    its Pallas kernels (interpret mode): the fused tail where its gate
    passes, the per-layer convT kernel where it does not."""
    jg, jvars, tg, noise, lat, emb = _pair(rng, mode, max_notes)
    jnotes, jlatent = jg.apply(jvars, jnp.asarray(noise), None if lat is None else jnp.asarray(lat),
                               jnp.asarray(emb), train=False)
    tg.eval()
    assert tg.decoder.fuses() is fused
    with torch.no_grad():
        tnotes, tlatent = tg(torch.from_numpy(noise),
                             None if lat is None else torch.from_numpy(lat), torch.from_numpy(emb))
    assert tnotes.shape == (3, max_notes, 4)
    assert_close_scaled(tlatent.numpy(), jlatent)
    assert_close_scaled(tnotes.numpy(), jnotes)


def test_generator_train_mode_matches_jax_and_updates_bn(rng):
    """Train mode never fuses; its output and the BN running-stat update
    (biased normalisation, unbiased running variance, momentum 0.1) match."""
    jg, jvars, tg, noise, _, emb = _pair(rng, "warm_start", 64, batch=4)
    jnotes, mutated = jg.apply(jvars, jnp.asarray(noise), None, jnp.asarray(emb), train=True,
                               mutable=["batch_stats"])
    tg.train()
    assert not tg.decoder.fuses()
    with torch.no_grad():
        tnotes, _ = tg(torch.from_numpy(noise), None, torch.from_numpy(emb))
    assert_close_scaled(tnotes.numpy(), jnotes[0])
    for i, t in enumerate((1, 4)):
        js = mutated["batch_stats"]["decoder"][f"TorchBatchNorm_{i}"]
        bn = tg.decoder.deconv[t]
        assert_close_scaled(bn.running_mean.numpy(), js["mean"])
        assert_close_scaled(bn.running_var.numpy(), js["var"])


def test_generator_and_encoder_match_jax_full_width(rng):
    """The shipped GANConfig() width, JAX on its XLA path."""
    cfg = JaxGANConfig()
    jg = jgan.Generator.from_config(cfg)
    jfe = jgan.FeatureEncoder.from_config(cfg, dropout=0.0)
    feats = rng.normal(size=(3, cfg.numeric_input_dim)).astype(np.float32)
    noise = rng.normal(size=(3, cfg.noise_dim)).astype(np.float32)
    fe_vars = jfe.init(jax.random.PRNGKey(1), jnp.asarray(feats), train=False)
    emb = jfe.apply(fe_vars, jnp.asarray(feats), train=False)
    g_vars = jg.init(jax.random.PRNGKey(2), jnp.asarray(noise), None, emb, train=False)
    g_vars = _perturb_bn(g_vars, rng)
    jnotes, _ = jg.apply(g_vars, jnp.asarray(noise), None, emb, train=False)

    tcfg = GANConfig()
    tg = tgan.Generator.from_config(tcfg).eval()
    tfe = tgan.FeatureEncoder.from_config(tcfg, dropout=0.0).eval()
    weights.load_jax_variables(tg, tfe, g_vars, fe_vars)
    assert tg.decoder.fuses()
    with torch.no_grad():
        temb = tfe(torch.from_numpy(feats))
        tnotes, _ = tg(torch.from_numpy(noise), None, temb)
    assert_close_scaled(temb.numpy(), emb)
    assert tnotes.shape == (3, 512, 4)
    assert_close_scaled(tnotes.numpy(), jnotes)


def test_feature_encoder_matches_jax_small(rng):
    jfe = jgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8, dropout=0.0)
    feats = rng.normal(size=(5, 6)).astype(np.float32)
    fe_vars = jfe.init(jax.random.PRNGKey(0), jnp.asarray(feats), train=False)
    tfe = tgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8, dropout=0.0).eval()
    tfe.load_state_dict(weights.to_tensors(weights.export_feature_encoder(fe_vars)), strict=True)
    with torch.no_grad():
        out = tfe(torch.from_numpy(feats)).numpy()
    assert_close_scaled(out, jfe.apply(fe_vars, jnp.asarray(feats), train=False))


def test_weight_bridge_equals_jax_export(rng):
    """The port's copies of the exporters give exactly the JAX package's
    state dicts, and those load strictly into the port's modules."""
    _, g_vars, tg, *_ = _pair(rng, "warm_start", 64)
    jfe = jgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8)
    fe_vars = jfe.init(jax.random.PRNGKey(0), jnp.zeros((1, 6)), train=False)
    ours = weights.export_gan_final(g_vars, fe_vars)
    theirs = torch_interop.export_gan_final(g_vars, fe_vars)
    assert ours.keys() == theirs.keys()
    for part in ours:
        assert ours[part].keys() == theirs[part].keys()
        for k in ours[part]:
            np.testing.assert_array_equal(ours[part][k], theirs[part][k], err_msg=k)
    assert set(tg.state_dict()) == set(ours["G"])
    tfe = tgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8)
    weights.load_state_dicts(tg, tfe, ours["G"], ours["E_num"])


def test_gan_final_pth_round_trip(rng, tmp_path):
    _, g_vars, tg, *_ = _pair(rng, "warm_start", 64)
    jfe = jgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8)
    fe_vars = jfe.init(jax.random.PRNGKey(0), jnp.zeros((1, 6)), train=False)
    ckpt = {k: weights.to_tensors(v) for k, v in weights.export_gan_final(g_vars, fe_vars).items()}
    path = tmp_path / "gan_final.pth"
    torch.save(ckpt, path)
    g_sd, fe_sd, extras = weights.load_gan_final_full(str(path))
    assert extras["emotion_features"] is None  # a reference file carries no emotion features
    tfe = tgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8)
    weights.load_state_dicts(tg, tfe, g_sd, fe_sd)
    torch.testing.assert_close(tg.decoder.deconv[0].weight, ckpt["G"]["decoder.deconv.0.weight"])
    torch.save({"G": ckpt["G"]}, path)
    with pytest.raises(ValueError, match="E_num"):
        weights.load_gan_final_full(str(path))


def test_precision_switch_gates_fusion_per_thread():
    dec = tgan.GeneratorDecoder(latent_dim=8, max_notes=64).eval()
    assert default_precision() == "f32" and dec.fuses()
    seen = []
    set_default_precision("fast")
    try:
        assert not dec.fuses()
        t = threading.Thread(target=lambda: seen.append(default_precision()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        set_default_precision("f32")
    assert seen == ["f32"] and dec.fuses()
    with pytest.raises(ValueError):
        set_default_precision("bf16")


def _perturb_torch_bn(dec, rng):
    with torch.no_grad():
        for i in (1, 4):
            bn = dec.deconv[i]
            n = bn.num_features
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))


def _layered(dec, latent):
    """The decoder's layered path (no folding) on the same module, in f32:
    the fuse gate closed for this call alone (the "fast" precision, which
    closed it before, now also rounds the products to bf16)."""
    dec.fuses = lambda: False
    try:
        with torch.no_grad():
            return dec(latent)
    finally:
        del dec.fuses


@pytest.fixture
def counted_folds(monkeypatch):
    """Each fold of a GeneratorDecoder's stages appends to the list."""
    folds, fold = [], tgan.GeneratorDecoder._fold

    def counting(self):
        folds.append(self)
        return fold(self)

    monkeypatch.setattr(tgan.GeneratorDecoder, "_fold", counting)
    return folds


def test_folded_stages_fold_once_and_follow_load_state_dict(rng, counted_folds):
    """Two forwards without grad fold BN once; a ``load_state_dict`` with
    other weights is seen, and the output matches the layered path."""
    dec = tgan.GeneratorDecoder(latent_dim=8, max_notes=64).eval()
    _perturb_torch_bn(dec, rng)
    latent = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    with torch.inference_mode():
        a = dec(latent)
        b = dec(latent)
    assert len(counted_folds) == 1 and dec.fuses()
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert_close_scaled(a.numpy(), _layered(dec, latent).numpy())

    other = tgan.GeneratorDecoder(latent_dim=8, max_notes=64)
    _perturb_torch_bn(other, rng)
    dec.load_state_dict(other.state_dict())
    with torch.no_grad():
        c = dec(latent)
    assert len(counted_folds) == 2
    assert not np.allclose(a.numpy(), c.numpy())
    assert_close_scaled(c.numpy(), _layered(dec, latent).numpy())


def test_folded_stages_follow_in_place_updates(rng, counted_folds):
    """An in-place optimiser step on a conv weight, and a train-mode forward
    that moves the BN running statistics, each invalidate the cache."""
    dec = tgan.GeneratorDecoder(latent_dim=8, max_notes=64).eval()
    _perturb_torch_bn(dec, rng)
    latent = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    with torch.no_grad():
        before = dec(latent)
        dec.deconv[3].weight.add_(0.05)
        after_step = dec(latent)
    assert len(counted_folds) == 2
    assert not np.allclose(before.numpy(), after_step.numpy())
    assert_close_scaled(after_step.numpy(), _layered(dec, latent).numpy())

    dec.train()
    with torch.no_grad():
        dec(latent)  # updates running_mean and running_var in place
    dec.eval()
    with torch.no_grad():
        after_bn = dec(latent)
    assert len(counted_folds) == 3
    assert_close_scaled(after_bn.numpy(), _layered(dec, latent).numpy())


def test_folded_stages_with_grad_are_differentiable(rng, counted_folds):
    """With grad mode on the stages are folded afresh on every forward,
    so gradients reach the conv and BN parameters."""
    dec = tgan.GeneratorDecoder(latent_dim=8, max_notes=64).eval()
    latent = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    for _ in range(2):
        dec.zero_grad()
        dec(latent).square().sum().backward()
    assert len(counted_folds) == 2
    for p in (dec.deconv[0].weight, dec.deconv[1].weight, dec.deconv[4].bias, dec.deconv[6].weight):
        assert p.grad is not None and float(p.grad.abs().max()) > 0


def test_unported_options_raise():
    # spectral norm is ported: the hidden layers, not the output layer
    fe = tgan.FeatureEncoder.from_config(GANConfig(encoder_use_sn=True))
    assert [type(m).__name__ for m in fe.net if isinstance(m, torch.nn.Linear)] == [
        "SpectralNormLinear", "SpectralNormLinear", "Linear"]
    with pytest.raises(ValueError, match="mode"):
        tgan.Generator(mode="other")


def test_trim_or_pad_length():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    assert trim_or_pad_length(x, 4).shape == (2, 4, 3)
    padded = trim_or_pad_length(x, 7)
    assert padded.shape == (2, 7, 3) and torch.all(padded[:, 5:] == 0)
    assert trim_or_pad_length(x, 5) is x
