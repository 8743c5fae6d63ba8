"""Spectral normalization on the port against the JAX package (CPU).

``SpectralNormLinear`` takes the JAX layer's ``kernel``, ``bias`` and ``u``
(injected: the two packages draw ``u`` from different streams), and both
run one power-iteration step in every forward in f32, so outputs and the
updated ``u`` agree to f32 rounding: 1e-5 of their scale (REL). The
feature encoder and the ED classifier with ``use_sn`` cross the weight
bridge both ways, ``u`` in the ``spectral`` collection; the sampler with a
spectral-norm encoder matches JAX's at the f32 parity tolerance of
``tests/test_torch_sampling.py`` (1e-4). The trainers refuse a
spectral-norm model, as the JAX trainers cannot train one (ROADMAP C.5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.models import ed as jed
from melogan_tpu.models import gan as jgan
from melogan_tpu.models.layers import SpectralNormLinear as JaxSpectralNormLinear
from melogan_tpu.sampling import Sampler as JaxSampler

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.models import ed as ted
from melogan_torch.models import gan as tgan
from melogan_torch.models.layers import SpectralNormLinear
from melogan_torch.precision import using
from melogan_torch.sampling import Sampler
from melogan_torch.train import ed_loop, gan_loop, sweep
from melogan_torch.utils import weights

from tests.test_torch_sampling import _inputs, _jax_notes
from tests.test_torch_train import TINY, TINY_ED, _corpus

REL = 1e-5


def assert_scaled(ours, theirs, rel=REL, what=""):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, what
    scale = max(float(np.max(np.abs(theirs))), 1e-30)
    err = float(np.max(np.abs(ours - theirs)))
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x scale {scale:.3e}"


def _np(x):
    return np.asarray(jax.device_get(x))


def _layer_pair(rng, fan_in=24, features=16, scale=3.0):
    """A JAX layer's variables with a kernel of spectral norm well above 1
    and a random ``u``, and the port's layer holding the same values."""
    jvars = {
        "params": {"kernel": jnp.asarray(rng.normal(size=(fan_in, features)) * scale, jnp.float32),
                   "bias": jnp.asarray(rng.normal(0, 0.1, features), jnp.float32)},
        "spectral": {"u": jnp.asarray(rng.normal(size=features), jnp.float32)},
    }
    layer = SpectralNormLinear(fan_in, features)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(_np(jvars["params"]["kernel"]).T.copy()))
        layer.bias.copy_(torch.from_numpy(_np(jvars["params"]["bias"])))
        layer.u.copy_(torch.from_numpy(_np(jvars["spectral"]["u"])))
    return jvars, layer


def test_spectral_norm_linear_matches_jax(rng):
    jvars, layer = _layer_pair(rng)
    mod = JaxSpectralNormLinear(features=16)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    # train mode: the output and u' (the JAX layer with update_stats)
    y, mut = mod.apply(jvars, jnp.asarray(x), update_stats=True, mutable=["spectral"])
    layer.train()
    ours = layer(torch.from_numpy(x))
    assert_scaled(ours.detach().numpy(), _np(y), what="train y")
    assert_scaled(layer.u.numpy(), _np(mut["spectral"]["u"]), what="u'")
    # eval mode: the iteration still runs, u stays
    u_before = layer.u.clone()
    y_eval = mod.apply({"params": jvars["params"], **mut}, jnp.asarray(x), update_stats=False)
    layer.eval()
    assert_scaled(layer(torch.from_numpy(x)).detach().numpy(), _np(y_eval), what="eval y")
    assert torch.equal(layer.u, u_before)
    # σ carries no gradient: the weight gradient is x-side only, through W/σ
    layer.train()
    sigma = float(layer.sigma())  # from the u this forward starts with
    xs = torch.from_numpy(x).requires_grad_(True)
    (gw,) = torch.autograd.grad(layer(xs).sum(), layer.weight)
    np.testing.assert_allclose(gw.numpy(), np.ones((16, 5), np.float32) @ x / sigma, rtol=1e-4)
    # the state dict: weight, bias and the u buffer, strictly reloadable
    assert list(layer.state_dict()) == ["weight", "bias", "u"]
    SpectralNormLinear(24, 16).load_state_dict(layer.state_dict(), strict=True)


def test_spectral_norm_linear_under_bf16(rng):
    """Under "fast" the product takes bf16 operands (the power iteration
    stays f32, so u' is unchanged): the output differs from f32's by a
    bf16 rounding of each operand (within 2·2⁻⁸ of the scale) and not by
    nothing."""
    _, layer = _layer_pair(rng)
    x = torch.from_numpy(rng.normal(size=(5, 24)).astype(np.float32))
    layer.eval()
    y32 = layer(x).detach().numpy()
    with using("fast"):
        y16 = layer(x).detach().numpy()
    err = float(np.abs(y16 - y32).max()) / float(np.abs(y32).max())
    assert 0 < err <= 2 * 2.0 ** -8


def test_spectral_norm_bounds_singular_value(rng):
    """The mirror of ``tests/test_models.py::test_spectral_norm_bounds_singular_value``:
    from that test's initial variables (``PRNGKey(0)``, the kernel ×25),
    30 train-mode forwards converge the power iteration, and W/σ has top
    singular value 1. (A draw of torch's global generator would make the
    start depend on the tests run before in the process: 30 steps do not
    converge to 1e-3 for every random 32×16 matrix.)"""
    xn = rng.normal(size=(4, 32)).astype(np.float32)
    x = torch.from_numpy(xn)
    jvars = JaxSpectralNormLinear(features=16).init(jax.random.PRNGKey(0), jnp.asarray(xn))
    layer = SpectralNormLinear(32, 16).train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(_np(jvars["params"]["kernel"]).T * 25.0))
        layer.bias.copy_(torch.from_numpy(_np(jvars["params"]["bias"])))
        layer.u.copy_(torch.from_numpy(_np(jvars["spectral"]["u"])))
    for _ in range(30):
        layer(x)
    kernel = layer.weight.detach().numpy().T  # (in, out), as the JAX test reads it
    u = layer.u.numpy()
    v = kernel @ u
    v /= np.linalg.norm(v)
    u2 = kernel.T @ v
    sigma = float(v @ (kernel @ (u2 / np.linalg.norm(u2))))
    top_sv = np.linalg.svd(kernel / sigma, compute_uv=False)[0]
    np.testing.assert_allclose(top_sv, 1.0, atol=1e-3)
    np.testing.assert_allclose(float(layer.sigma()), np.linalg.svd(kernel, compute_uv=False)[0], rtol=1e-3)


def _perturb_u(variables, rng):
    """JAX's ``u`` draws are the same PRNGKey(0) for every layer: give each
    its own, so a mix-up between layers shows."""
    spectral = jax.tree.map(lambda u: jnp.asarray(rng.normal(size=u.shape), jnp.float32),
                            variables["spectral"])
    return {**variables, "spectral": spectral}


def test_feature_encoder_with_sn_crosses_the_bridge_both_ways(rng):
    jfe = jgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8, dropout=0.0, use_sn=True)
    x = rng.normal(size=(6, 6)).astype(np.float32)
    jvars = _perturb_u(jfe.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False), rng)
    assert set(jvars["params"]) == {"TorchLayerNorm_0", "SpectralNormLinear_0",
                                    "SpectralNormLinear_1", "TorchLinear_0"}
    sd = weights.export_feature_encoder(jvars)
    assert {"net.1.u", "net.4.u"} <= set(sd) and "net.7.u" not in sd
    fe = tgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8, dropout=0.0, use_sn=True)
    fe.load_state_dict(weights.to_tensors(sd), strict=True)
    fe.eval()
    assert_scaled(fe(torch.from_numpy(x)).detach().numpy(),
                  _np(jfe.apply(jvars, jnp.asarray(x), train=False)), what="FE eval")
    # train mode: u advances on both sides
    y, mut = jfe.apply(jvars, jnp.asarray(x), train=True, mutable=["spectral"])
    fe.train()
    assert_scaled(fe(torch.from_numpy(x)).detach().numpy(), _np(y), what="FE train")
    back = weights.convert_feature_encoder(fe.state_dict(), 2)
    for name in ("SpectralNormLinear_0", "SpectralNormLinear_1"):
        assert_scaled(back["spectral"][name]["u"], _np(mut["spectral"][name]["u"]), what=name)
    # and the port's tree runs in JAX
    assert_scaled(_np(jfe.apply(back, jnp.asarray(x), train=False)),
                  fe.eval()(torch.from_numpy(x)).detach().numpy(), what="FE back in JAX")


def test_ed_classifier_with_sn_crosses_the_bridge_both_ways(rng):
    kw = dict(input_mode="notes", notes_hidden=32, notes_blocks=2, mlp_hidden=(16, 8), dropout=0.0)
    jmodel = jed.EmotionDiscriminator(**kw, use_spectral_norm=True)
    x = rng.normal(size=(3, 64, 4)).astype(np.float32)
    jvars = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    jvars = _perturb_u(dict(jvars), rng)
    sd = weights.export_ed(jvars)
    assert {"classifier.net.0.u", "classifier.net.3.u"} <= set(sd)
    model = ted.EmotionDiscriminator(**kw, use_spectral_norm=True)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    model.eval()
    theirs = _np(jmodel.apply(jvars, jnp.asarray(x), train=False))
    assert_scaled(model(torch.from_numpy(x)).detach().numpy(), theirs, rel=1e-4, what="ED eval")
    back = weights.convert_ed(model.state_dict(), notes_blocks=2, mlp_hidden=2)
    assert set(back["spectral"]["classifier"]) == {"SpectralNormLinear_0", "SpectralNormLinear_1"}
    assert_scaled(_np(jmodel.apply(back, jnp.asarray(x), train=False)), theirs, rel=1e-4,
                  what="ED back in JAX")


def test_sampler_with_sn_encoder_matches_jax_and_round_trips(rng, tmp_path):
    small = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32, encoder_use_sn=True)
    js = JaxSampler(JaxGANConfig(**small), seed=0)
    js.fe_variables = _perturb_u(js.fe_variables, rng)
    ts = Sampler(GANConfig(**small), gen_variables=weights.export_generator(js.gen_variables),
                 fe_variables=weights.export_feature_encoder(js.fe_variables), device="cpu")
    feats, noise = _inputs(rng, ["happy", "sad", "angry", "calm"], 16)
    ours = ts.sample_from(feats, noise)
    assert_scaled(ours, _jax_notes(js, feats, noise, JaxGANConfig(**small)), rel=1e-4, what="notes")
    u_before = ts.feature_encoder.net[1].u.clone()
    ts.sample_notes(["happy"], seed=0)
    assert torch.equal(ts.feature_encoder.net[1].u, u_before)  # eval mode: u stays
    # a gan_final with a spectral-norm encoder, both formats
    final = {"G": ts.generator.state_dict(), "E_num": ts.feature_encoder.state_dict()}
    for name in ("gan_final.ckpt", "gan_final.pth"):
        path = weights.write_gan_final(str(tmp_path / name), final)
        gen_sd, fe_sd = weights.load_gan_final(path)
        again = Sampler(GANConfig(**small), gen_variables=gen_sd, fe_variables=fe_sd, device="cpu")
        np.testing.assert_array_equal(again.sample_from(feats, noise), ours)


def test_trainers_refuse_spectral_norm(tmp_path):
    raw, emotions, numeric = _corpus(np.random.default_rng(0), 31)
    from melogan_torch.data import datasets as tdata

    data = tdata.SplitData(raw, emotions, numeric, [])
    sn_gan = GANConfig(**dict(TINY, encoder_use_sn=True))
    sn_ed = EDConfig(**dict(TINY_ED, use_spectral_norm=True))
    for call in (
        lambda: gan_loop.train(sn_gan, EDConfig(**TINY_ED), data, workdir=str(tmp_path), epochs=1,
                               verbose=False, device="cpu"),
        lambda: gan_loop.train(GANConfig(**TINY), sn_ed, data, workdir=str(tmp_path), epochs=1,
                               verbose=False, device="cpu"),
        lambda: sweep.sweep_gan(sn_gan, EDConfig(**TINY_ED), data, [1, 2], workdir=str(tmp_path),
                                epochs=1, verbose=False, device="cpu"),
        lambda: ed_loop.train(EDConfig(**dict(TINY_ED, use_spectral_norm=True, input_mode="notes")),
                              data, data, workdir=str(tmp_path), verbose=False, device="cpu"),
    ):
        with pytest.raises(NotImplementedError, match="ScopeCollectionNotFound"):
            call()
    # what the JAX step does with a spectral-norm encoder in train mode
    jfe = jgan.FeatureEncoder(hidden_dims=(16, 8), out_dim=8, use_sn=True)
    jvars = jfe.init(jax.random.PRNGKey(0), jnp.zeros((2, 6)), train=False)
    with pytest.raises(Exception, match="spectral"):
        jfe.apply({"params": jvars["params"]}, jnp.zeros((2, 6)), train=True,
                  rngs={"dropout": jax.random.PRNGKey(1)})
