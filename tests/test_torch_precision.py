"""The port's bf16 precision (``"fast"``, ``precision="bf16"``,
``fast_math``) on the CPU.

"bf16" is the TPU's one DEFAULT pass: every operand of every conv,
transposed conv and Linear product, forward and backward, rounded to bf16
with round-to-nearest-even; the products exact and summed in f32.

Two kinds of reference, and their tolerances:

- Each bf16 layer (``conv1d`` and ``conv_transpose1d`` through the conv
  Functions, ``Linear``, the critic's native conv) against a float64
  emulation: the operands, and the cotangent of each gradient, rounded to
  bf16 by a numpy RNE on the bits, then torch's own float64 ops (F.conv1d,
  F.conv_transpose1d, matmul) with float64 autograd. The port's products of
  bf16 values are exact in f32 and only its f32 summation differs: within
  ``EMU_REL`` = 1e-5 of each output's scale (f32 sums over at most a few
  hundred terms reach about 1e-7). Each must also differ from its f32
  result by more than ``DIFF_REL`` = 1e-4 of the scale: the rounding shows.
- Against JAX, which on the CPU computes its DEFAULT precision as HIGHEST
  (XLA's CPU backend ignores the request; ``tests/test_train_loops.py``
  says so), so its bf16 path is its f32 path. A product of two operands
  each rounded with a relative error of at most 2⁻⁹ is within 2⁻⁸ of the
  exact one; the error grows by about that at each product stage an output
  passes through. So a quantity that passes through n product stages is
  held within n · 2⁻⁸ of its scale (``stages_tol``), n counted on the path.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.models import layers as jlayers
from melogan_tpu.sampling import Sampler as JaxSampler
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.train import harness as jharness

from melogan_torch import EMOTIONS
from melogan_torch.config import AEConfig, EDConfig, GANConfig
from melogan_torch.data import datasets as tdata
from melogan_torch.models import gan as tgan
from melogan_torch.models.layers import Conv1d, Linear, default_precision
from melogan_torch.ops import conv as tconv
from melogan_torch.precision import mode_of, round_bf16, using
from melogan_torch.sampling import Sampler
from melogan_torch.train import ed_loop, gan_loop, gan_step, harness, sweep, vae_loop
from melogan_torch.utils.weights import export_feature_encoder, export_generator

from tests.test_torch_sampling import _inputs, _jax_notes
from tests.test_torch_train import (TINY, TINY_ED, _assert_states_equal, _batches, _corpus,
                                    _group_draws, _setup, _torch_batches)

EMU_REL = 1e-5
DIFF_REL = 1e-4
U = 2.0 ** -8  # a product of two bf16-rounded operands, relative to the exact one


def stages_tol(n: int) -> float:
    return n * U


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bf16_np(a) -> np.ndarray:
    """Round float32 values to bf16 with round-to-nearest-even on the bits
    (finite values), independently of torch."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def r64(a) -> torch.Tensor:
    """``a`` rounded to bf16, as a float64 leaf that takes gradients."""
    return torch.from_numpy(bf16_np(np.asarray(a)).astype(np.float64)).requires_grad_(True)


def scaled_err(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    return float(np.max(np.abs(ours - theirs))) / max(float(np.max(np.abs(theirs))), 1e-30)


def assert_matches_and_differs(bf16_out, emu, f32_out, what):
    err = scaled_err(bf16_out, emu)
    assert err <= EMU_REL, f"{what}: {err:.3e} of scale from the float64 emulation"
    diff = scaled_err(f32_out, bf16_out)
    assert diff > DIFF_REL, f"{what}: bf16 equals f32 ({diff:.3e} of scale): the mode was not honoured"


def test_round_bf16_is_round_to_nearest_even(rng):
    x = rng.normal(size=10_000).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 6, 10_000)
    # exact ties: bit 15 set and bits 0-14 clear, with the kept lowest bit 0 and 1
    ties = (np.arange(64, dtype=np.uint32) << 16 | 0x3F808000).view(np.float32)
    for a in (x, ties, np.array([0.0, -0.0, 1.0, -3.5, 65504.0], np.float32)):
        np.testing.assert_array_equal(round_bf16(torch.from_numpy(a)).numpy(), bf16_np(a))
    assert mode_of(None) == mode_of("highest") == "f32"
    assert mode_of("bf16") == mode_of("default") == "fast"
    with pytest.raises(ValueError):
        mode_of("fp16")


# (L, Cin, Cout, K, stride, padding): the ED's and the VAE's geometries and the
# corners of the core (Cin 4 and 17, K 7 stride 3, K 1, padding 0, stride > K)
CONV1D_CASES = [(64, 4, 8, 5, 1, 2), (64, 8, 16, 3, 1, 1), (64, 4, 8, 5, 2, 2), (33, 17, 6, 7, 3, 1),
                (20, 5, 3, 1, 1, 0), (40, 6, 7, 2, 5, 0)]
# (L, Cin, Cout, K, stride, padding, output_padding)
CONVT_CASES = [(16, 8, 4, 5, 2, 2, 1), (13, 17, 6, 7, 3, 1, 2), (20, 5, 3, 3, 1, 1, 0),
               (9, 6, 5, 4, 2, 0, 1), (11, 4, 4, 2, 4, 1, 3)]


def _conv_check(rng, x, w, b, ours, emulated, what):
    """``ours`` (x, w_hio, bias) at bf16 and at f32, forward and the three
    gradients, against ``emulated`` (float64 x, float64 HIO w, bias) on
    rounded operands and a rounded cotangent."""
    def run(precision):
        xs, ws, bs = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
        with using(precision):
            y = ours(xs, ws, bs)
            g = torch.from_numpy(rng_g.normal(size=tuple(y.shape)).astype(np.float32))
            return (y.detach().numpy(), *torch.autograd.grad(y, (xs, ws, bs), g)), g.numpy()

    rng_g = np.random.default_rng(0)
    (y, dx, dw, db), g = run("fast")
    rng_g = np.random.default_rng(0)
    (y32, dx32, dw32, _), _ = run("f32")
    xe, we = r64(x), r64(w)
    be = torch.from_numpy(b.astype(np.float64)).requires_grad_(True)
    ye = emulated(xe, we, be)
    ge = torch.from_numpy(bf16_np(g).astype(np.float64))
    dxe, dwe, dbe = torch.autograd.grad(ye, (xe, we, be), ge)
    assert_matches_and_differs(y, ye.detach().numpy(), y32, f"{what} y")
    assert_matches_and_differs(dx.numpy(), dxe.numpy(), dx32.numpy(), f"{what} dx")
    assert_matches_and_differs(dw.numpy(), dwe.numpy(), dw32.numpy(), f"{what} dw")
    # the bias gradient is a sum of g, no product: f32 at both precisions
    assert scaled_err(db.numpy(), g.sum(axis=(0, 1))) <= EMU_REL


@pytest.mark.parametrize("l,cin,cout,k,s,p", CONV1D_CASES)
def test_conv1d_bf16_matches_float64_emulation(rng, l, cin, cout, k, s, p):
    x = rng.normal(size=(3, l, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)

    def emulated(xe, we, be):  # torch Conv1d in float64: (B, C, L), (Cout, Cin, K)
        return F.conv1d(xe.transpose(1, 2), we.permute(2, 1, 0), be, s, p).transpose(1, 2)

    _conv_check(rng, x, w, b, lambda x_, w_, b_: tconv.conv1d(x_, w_, s, p, bias=b_), emulated,
                f"conv1d {l, cin, cout, k, s, p}")


@pytest.mark.parametrize("l,cin,cout,k,s,p,op", CONVT_CASES)
def test_conv_transpose1d_bf16_matches_float64_emulation(rng, l, cin, cout, k, s, p, op):
    x = rng.normal(size=(3, l, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)

    def emulated(xe, we, be):  # torch ConvTranspose1d in float64: (Cin, Cout, K)
        return F.conv_transpose1d(xe.transpose(1, 2), we.permute(1, 2, 0), be, s, p, op).transpose(1, 2)

    _conv_check(rng, x, w, b,
                lambda x_, w_, b_: tconv.conv_transpose1d(x_, w_, s, p, op, bias=b_), emulated,
                f"convT {l, cin, cout, k, s, p, op}")


def test_plain_kernels_take_the_bf16_mode(rng):
    """``conv1d_plain`` / ``convt1d_plain`` with ``bf16=True`` are the f32
    versions on rounded operands (the kernels' plain versions in chip_smoke)."""
    from melogan_torch.ops.conv1d import conv1d_plain
    from melogan_torch.ops.convt import convt1d_plain

    x = torch.from_numpy(rng.normal(size=(2, 32, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8, 6)).astype(np.float32))
    for plain, geo in ((conv1d_plain, (1, 2)), (convt1d_plain, (2, 2, 1))):
        torch.testing.assert_close(plain(x, w, None, *geo, bf16=True),
                                   plain(round_bf16(x), round_bf16(w), None, *geo), rtol=0, atol=0)
        assert not torch.equal(plain(x, w, None, *geo, bf16=True), plain(x, w, None, *geo))


def test_linear_bf16_matches_float64_emulation(rng):
    x = rng.normal(size=(7, 24)).astype(np.float32)
    lin = Linear(24, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32) / 5))
        lin.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 40).astype(np.float32)))
    g = rng.normal(size=(7, 40)).astype(np.float32)

    def run(precision):
        xs = torch.from_numpy(x).requires_grad_(True)
        with using(precision):
            y = lin(xs)
            return (y.detach().numpy(), *torch.autograd.grad(y, (xs, lin.weight, lin.bias),
                                                             torch.from_numpy(g)))

    y, dx, dw, db = run("fast")
    y32, dx32, dw32, _ = run("f32")
    xe, we = r64(x), r64(lin.weight.detach().numpy())
    ye = xe @ we.t() + torch.from_numpy(lin.bias.detach().numpy().astype(np.float64))
    dxe, dwe = torch.autograd.grad(ye, (xe, we), torch.from_numpy(bf16_np(g).astype(np.float64)))
    assert_matches_and_differs(y, ye.detach().numpy(), y32, "Linear y")
    assert_matches_and_differs(dx.numpy(), dxe.numpy(), dx32.numpy(), "Linear dx = r(g)·r(W)")
    assert_matches_and_differs(dw.numpy(), dwe.numpy(), dw32.numpy(), "Linear dW = r(g)ᵀ·r(x)")
    np.testing.assert_allclose(db.numpy(), g.sum(0), rtol=1e-6)
    # the state dict keeps nn.Linear's names
    assert list(lin.state_dict()) == ["weight", "bias"]


def test_native_critic_conv_bf16_matches_float64_emulation(rng):
    x = rng.normal(size=(3, 32, 4)).astype(np.float32)
    conv = Conv1d(4, 16, 5, stride=2, padding=2, native=True)
    w = conv.weight.detach().numpy().transpose(2, 1, 0).copy()  # HIO
    b = conv.bias.detach().numpy().copy()

    def run(precision):
        xs = torch.from_numpy(x).requires_grad_(True)
        with using(precision):
            y = conv(xs)
            gg = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(y.shape)).astype(np.float32))
            dx, dw = torch.autograd.grad(y, (xs, conv.weight), gg)
        return y.detach().numpy(), dx.numpy(), dw.permute(2, 1, 0).numpy(), gg.numpy()

    y, dx, dw, g = run("fast")
    y32, dx32, dw32, _ = run("f32")
    xe, we = r64(x), r64(w)
    ye = F.conv1d(xe.transpose(1, 2), we.permute(2, 1, 0),
                  torch.from_numpy(b.astype(np.float64)), 2, 2).transpose(1, 2)
    dxe, dwe = torch.autograd.grad(ye, (xe, we), torch.from_numpy(bf16_np(g).astype(np.float64)))
    assert_matches_and_differs(y, ye.detach().numpy(), y32, "critic conv y")
    assert_matches_and_differs(dx, dxe.numpy(), dx32, "critic conv dx")
    assert_matches_and_differs(dw, dwe.numpy(), dw32, "critic conv dw")


def test_gradient_penalty_second_derivative_runs_under_bf16(rng):
    """The WGAN-GP penalty differentiates the critic's input gradient again
    through its Linears and native convs; under bf16 every order's products
    are rounded. It runs, is finite, differs from f32, and the penalty stays
    within the stage tolerance of f32's (critic: 3 convs and 2 Linears
    forward, as many backward, and the second derivative again: 15)."""
    cfg = GANConfig(**TINY)
    critic = tgan.Critic.from_config(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in critic.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    t = [torch.from_numpy(a) for a in (
        rng.normal(size=(3, 64, 4)).astype(np.float32), rng.normal(size=(3, 64, 4)).astype(np.float32),
        rng.normal(size=(3, cfg.encoder_out_dim)).astype(np.float32),
        rng.uniform(size=(3, 1, 1)).astype(np.float32))]
    out = {}
    for precision in ("fast", "f32"):
        with using(precision):
            gp = gan_step.gradient_penalty(critic, *t)
            # the score head's bias does not enter the input gradient
            grads = [d for d in torch.autograd.grad(gp, list(critic.parameters()), allow_unused=True)
                     if d is not None]
        out[precision] = (float(gp.detach()), grads)
        assert np.isfinite(out[precision][0]) and all(torch.isfinite(d).all() for d in grads)
        # the weights' (a LeakyReLU net's input gradient is flat in its biases)
        assert all(float(d.abs().max()) > 0 for d in grads if d.dim() > 1)
    assert out["fast"][0] != out["f32"][0]
    assert abs(out["fast"][0] - out["f32"][0]) <= stages_tol(15) * abs(out["f32"][0])
    # the gradients differ from f32 by more than a stage count where a rounded
    # pre-activation crosses a LeakyReLU kink: held to differ, not to agree
    assert any(not torch.equal(a, b) for a, b in zip(out["fast"][1], out["f32"][1]))


def test_with_precision_restores_the_thread_precision():
    seen = []
    fn = harness.with_precision(lambda: seen.append(default_precision()) or 7, "bf16")
    assert fn() == 7 and seen == ["fast"] and default_precision() == "f32"

    def boom():
        seen.append(default_precision())
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        harness.with_precision(boom, "default")()
    assert seen[-1] == "fast" and default_precision() == "f32"
    f = lambda: 1  # noqa: E731
    assert harness.with_precision(f, None) is f and harness.with_precision(f, "highest") is f
    with pytest.raises(ValueError):
        harness.with_precision(f, "tf32")
    # per thread: another thread's switch is its own
    other = []
    with using("fast"):
        t = threading.Thread(target=lambda: other.append(default_precision()))
        t.start()
        t.join(timeout=10)
    assert other == ["f32"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", [None, "highest", "bf16", "default"])
def test_precision_tuned_cfg_matches_jax(fused, precision):
    ours = gan_step.precision_tuned_cfg(GANConfig(fused_critic_batch=fused), precision)
    theirs = jstep.precision_tuned_cfg(JaxGANConfig(fused_critic_batch=fused), precision)
    assert ours.fused_critic_batch == theirs.fused_critic_batch


def test_fast_sampler_matches_jax_and_differs_from_f32(rng):
    """``Sampler(fast_math=True)`` at the shipped width against the JAX fast
    sampler's forward (its f32 on the CPU), injected features and noise.
    Stages on the path: the encoder's 3 Linears, NoiseToLatent's 2, the
    pre-net's 2, the decoder's 3 transposed convs: 10."""
    js = JaxSampler(JaxGANConfig(), seed=0, fast_math=True)
    kw = dict(gen_variables=export_generator(js.gen_variables),
              fe_variables=export_feature_encoder(js.fe_variables), device="cpu")
    fast, f32 = Sampler(GANConfig(), fast_math=True, **kw), Sampler(GANConfig(), **kw)
    feats, noise = _inputs(rng, ["happy", "sad", "angry", "calm"], 128)
    prev = jlayers.default_precision()
    jlayers.set_default_precision(jax.lax.Precision.DEFAULT)
    try:
        theirs = _jax_notes(js, feats, noise, JaxGANConfig())
    finally:
        jlayers.set_default_precision(prev)
    ours = fast.sample_from(feats, noise)
    assert ours.shape == (4, 512, 4) and np.isfinite(ours).all()
    err = scaled_err(ours, theirs)
    assert err <= stages_tol(10), f"fast sampler {err:.3e} of scale from JAX"
    assert scaled_err(f32.sample_from(feats, noise), ours) > DIFF_REL
    assert scaled_err(f32.sample_from(feats, noise), theirs) <= 1e-4  # the f32 parity still holds
    assert default_precision() == "f32"


def test_fast_sampler_sets_precision_around_each_forward_on_any_thread(monkeypatch):
    """The switch is set inside each call, not at construction: a forward
    from another thread (the sample pool's refill) runs fast too, and the
    caller's precision is restored after each call, also when it raises."""
    s = Sampler(GANConfig(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32), seed=0,
                fast_math=True, device="cpu")
    assert default_precision() == "f32"
    seen = []
    real = s.generator.forward

    def spy(*a, **k):
        seen.append((threading.current_thread().name, default_precision(), s.generator.decoder.fuses()))
        return real(*a, **k)

    monkeypatch.setattr(s.generator, "forward", spy)
    notes = s.sample_notes(["happy"], seed=1)
    assert notes.shape == (1, 64, 4) and np.isfinite(notes).all()
    t = threading.Thread(target=lambda: s.sample_notes(["sad"], seed=2), name="refill")
    t.start()
    t.join(timeout=60)
    assert [p for _, p, _ in seen] == ["fast", "fast"] and seen[1][0] == "refill"
    assert not any(fused for _, _, fused in seen)  # the layered decoder: no fused f32 tail
    assert default_precision() == "f32"
    monkeypatch.setattr(s.generator, "forward", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        s.sample_notes(["calm"], seed=3)
    assert default_precision() == "f32"
    # a swap keeps the mode
    s.swap_variables(s.generator.state_dict(), s.feature_encoder.state_dict())
    assert s.fast_math


def test_group_step_at_bf16_matches_jax(rng, pallas_on):
    """One group step at ``precision="bf16"`` against JAX's bf16 group step
    (``jit_with_precision``: its f32 on the CPU) from the same state, with
    JAX's draws injected, and against the same bf16 step run in float64.

    Against JAX: the metrics pass the encoder (3 stages), the generator (7)
    and the critic (5), the penalty the critic's gradient (5) and its second
    derivative (5): 25 stages. The critic's gradients (Adam's first moments,
    relative to the group's largest) come back through at most 25 too, and
    so do those of the generator's last transposed conv. The generator's
    earlier layers get their gradients through its train-mode BatchNorms,
    whose backward subtracts each channel's mean and x̂-projection of the
    incoming gradient; here that leaves a small part of it, so its bf16
    noise is amplified past any stage count (up to half of the group's
    largest element, measured), and those layers are held instead against
    the float64 run of the port's own bf16 step: the same roundings, f64
    sums. There an f32 value and its f64 twin can round to neighbouring
    bf16 values: a few operands one bf16 step (2⁻⁸) apart, amplified by the
    same BatchNorms, so 2·2⁻⁸ of each group's largest (measured 2.9e-3).
    Parameters: within 2·lr per update of JAX's (an update is about
    lr·sign(g) at Adam's first steps)."""
    jcfg, models, jstate, jsteps, tstate, tsteps = _setup(rng, False, 0.0, 0.0)
    batches = _batches(rng, jcfg, jcfg.critic_iters)
    draws = _group_draws(jcfg, models, jstate, batches)
    jnew, jm = jharness.jit_with_precision(jsteps.group, "bf16")(
        jstate, tuple(jnp.asarray(a) for a in batches))
    assert jlayers.default_precision() == jax.lax.Precision.HIGHEST
    t64 = _float64_copy(tstate)
    bf16_group = gan_loop.precision_steps(tsteps, "bf16").group
    tstate, tm = bf16_group(tstate, _torch_batches(batches), draws)
    assert default_precision() == "f32"
    tol = stages_tol(25)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= tol * max(abs(float(jm[k])), 1e-6), k

    gen_mu = export_generator({"params": jnew.opt_g[0].mu[0]})
    against_jax = [(tstate.critic, tstate.opt_d, _critic_sd(jnew.opt_d[0].mu), None),
                   (tstate.generator, tstate.opt_g, gen_mu, ("decoder.deconv.6.",))]
    for module, opt, mu, only in against_jax:
        named = dict(module.named_parameters())
        gmax = max(float(np.abs(np.asarray(mu[n])).max()) for n in named)
        for n, p in named.items():
            if only is None or n.startswith(only):
                err = float(np.abs(opt.state[p]["exp_avg"].numpy() - np.asarray(mu[n])).max())
                assert err <= tol * gmax, f"{n}: {err:.3e} vs group max {gmax:.3e}"
    for module, params, lr, updates, export in (
            (tstate.generator, jnew.gen_params, jcfg.lr_g, 1, lambda t: export_generator({"params": t})),
            (tstate.critic, jnew.critic_params, jcfg.lr_d, jcfg.critic_iters, _critic_sd)):
        sd = export(params)
        for n, p in module.named_parameters():
            assert np.abs(p.detach().numpy() - np.asarray(sd[n])).max() <= 2 * lr * updates * (1 + 1e-3)

    d64 = gan_step.GroupDraws(
        critic=[gan_step.CriticDraws(d.noise.double(), d.alpha.double(), d.fe_masks) for d in draws.critic],
        gen=gan_step.GenDraws(draws.gen.noise.double(), draws.gen.fe_masks))
    b64 = tuple(t.double() if t.is_floating_point() else t for t in _torch_batches(batches))
    t64, _ = bf16_group(t64, b64, d64)
    for ours, theirs, opt, opt64 in ((tstate.generator, t64.generator, tstate.opt_g, t64.opt_g),
                                     (tstate.feature_encoder, t64.feature_encoder, tstate.opt_g, t64.opt_g),
                                     (tstate.critic, t64.critic, tstate.opt_d, t64.opt_d)):
        named64 = dict(theirs.named_parameters())
        gmax = max(float(opt64.state[p]["exp_avg"].abs().max()) for p in named64.values())
        for n, p in ours.named_parameters():
            err = float((opt.state[p]["exp_avg"].double() - opt64.state[named64[n]]["exp_avg"]).abs().max())
            assert err <= 2 * U * gmax, f"{n}: {err:.3e} vs group max {gmax:.3e} (float64 run)"


def _float64_copy(state):
    """The port's training state in float64, with its own Adams."""
    import copy

    models = gan_step.GANModels(*(copy.deepcopy(m).double() for m in (
        state.generator, state.critic, state.feature_encoder, state.ed)))
    opt_g, opt_d = gan_step.make_optimizers(GANConfig(**TINY), models)
    return gan_step.GANTrainState(generator=models.generator, critic=models.critic,
                                  feature_encoder=models.feature_encoder, ed=models.ed,
                                  opt_g=opt_g, opt_d=opt_d, rng=torch.Generator())


def _critic_sd(params):
    from melogan_torch.utils.weights import export_critic

    return export_critic({"params": params})


@pytest.fixture
def pallas_on():
    from melogan_tpu.ops import conv as jax_conv_ops

    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("on")
    try:
        yield
    finally:
        jax_conv_ops.set_use_pallas(prev)


def _scalars(h):
    return {k: v for k, v in h.items() if k not in ("epoch", "epoch_seconds")}


def _near(bf, f32, what, rel=0.1):
    """A bf16 run's final metrics near its f32 run's: two epochs of Adam
    whose first steps move every weight by about ±lr in the sign of its
    gradient, which bf16 rounding can flip where the gradient is small, so
    the runs drift apart by more than a stage tolerance; within 10% of the
    larger, and finite."""
    for k, v in f32.items():
        assert np.isfinite(bf[k]), f"{what} {k}"
        assert abs(bf[k] - v) <= rel * max(abs(v), abs(bf[k]), 1e-3), f"{what} {k}: {bf[k]} vs {v}"


def test_trainers_run_two_epochs_at_bf16_near_f32(tmp_path):
    """VAE, ED, GAN and the sweep at ``precision="bf16"`` on the CPU: finite
    metrics near the f32 run's, not equal to them, and the thread's precision
    restored after each."""
    from tests.test_torch_vae import SMALL as VAE_SMALL, _split as vae_split
    from tests.test_torch_ed_loop import SMALL as ED_SMALL, _split as ed_split

    vcfg = AEConfig(**dict(VAE_SMALL, epochs=2))
    tr, va = vae_split(21, 20), vae_split(22, 9)
    out = {}
    for p in (None, "bf16"):
        _, m = vae_loop.train(vcfg, tr, va, workdir=str(tmp_path / f"vae{p}"), verbose=False,
                              recon_dumps=False, precision=p, device="cpu")
        out[p] = m
        assert default_precision() == "f32"
    _near({"best_val": out["bf16"]["best_val"]}, {"best_val": out[None]["best_val"]}, "VAE")
    assert out["bf16"]["best_val"] != out[None]["best_val"]

    ecfg = EDConfig(**dict(ED_SMALL, num_epochs=2, save_freq=2))
    tr, va = ed_split(21, 20), ed_split(22, 9)
    for p in (None, "bf16"):
        _, m = ed_loop.train(ecfg, tr, va, workdir=str(tmp_path / f"ed{p}"), verbose=False,
                             precision=p, device="cpu")
        out[p] = m
        assert default_precision() == "f32"
    _near({"val_loss": out["bf16"]["val_loss"]}, {"val_loss": out[None]["val_loss"]}, "ED")
    assert out["bf16"]["val_loss"] != out[None]["val_loss"]

    raw, emotions, numeric = _corpus(np.random.default_rng(5), 4 * 7 + 3)
    data = tdata.SplitData(raw, emotions, numeric, [])
    gcfg = GANConfig(**TINY)
    for p in (None, "bf16"):
        _, h = gan_loop.train(gcfg, EDConfig(**TINY_ED), data, workdir=str(tmp_path / f"gan{p}"),
                              epochs=2, verbose=False, precision=p, device="cpu")
        out[p] = _scalars(h)
        assert default_precision() == "f32"
    _near(out["bf16"], out[None], "GAN", rel=0.2)
    assert out["bf16"] != out[None]

    for p in (None, "bf16"):
        rep = sweep.sweep_gan(dataclasses.replace(gcfg, save_freq=1), EDConfig(**TINY_ED), data, [1, 2],
                              workdir=str(tmp_path / f"sweep{p}"), epochs=2, verbose=False,
                              samples_per_emotion=1, precision=p, device="cpu")
        out[p] = [_scalars(r["final"]) for r in rep["results"]]
        assert default_precision() == "f32"
    for bf, f32 in zip(out["bf16"], out[None]):
        _near(bf, f32, "sweep member", rel=0.2)
    assert out["bf16"] != out[None]


def test_bf16_resume_is_bit_identical_to_straight_bf16(tmp_path):
    raw, emotions, numeric = _corpus(np.random.default_rng(5), 4 * 7 + 3)
    data = tdata.SplitData(raw, emotions, numeric, [])
    cfg = GANConfig(**TINY, save_freq=2, fused_critic_batch=True)
    ed_cfg = EDConfig(**TINY_ED)
    kw = dict(verbose=False, device="cpu", precision="bf16")
    straight, hs = gan_loop.train(cfg, ed_cfg, data, workdir=str(tmp_path / "a"), epochs=4, **kw)
    split = str(tmp_path / "b")
    gan_loop.train(cfg, ed_cfg, data, workdir=split, epochs=2, **kw)
    resumed, hr = gan_loop.train(cfg, ed_cfg, data, workdir=split, epochs=4, resume=True, **kw)
    _assert_states_equal(straight, resumed)
    assert _scalars(hs) == _scalars(hr)
    # bf16 unfused the critic batch (precision_tuned_cfg); the f32 run differs
    f32, _ = gan_loop.train(cfg, ed_cfg, data, workdir=str(tmp_path / "c"), epochs=1,
                            verbose=False, device="cpu")
    assert not torch.equal(f32.generator.decoder.deconv[0].weight, straight.generator.decoder.deconv[0].weight)


def test_fast_decoder_takes_three_bf16_convt_launches_and_no_tail():
    """Under "fast" the decoder's fuse gate is closed: the layered path's
    three transposed convs run in bf16 mode (the CPU counts no launch; the
    plain versions receive ``bf16=True``)."""
    import melogan_torch.ops.conv as conv_mod

    dec = tgan.GeneratorDecoder(latent_dim=8, max_notes=64).eval()
    calls = []
    real = conv_mod._convt_forward

    def spy(x, w, bias, s, p, op, bf16):
        calls.append(bf16)
        return real(x, w, bias, s, p, op, bf16)

    conv_mod._convt_forward = spy
    try:
        with torch.no_grad(), using("fast"):
            assert not dec.fuses()
            dec(torch.randn(2, 8))
        with torch.no_grad():
            assert dec.fuses()
            dec(torch.randn(2, 8))
    finally:
        conv_mod._convt_forward = real
    assert calls == [True, True, True]
    assert EMOTIONS  # the package imports cleanly with the switch in place


def test_fast_math_server_answers_and_keeps_the_mode_across_reload(tmp_path):
    """``create_server(fast_math=True)``: a fast sampler answering real HTTP
    with MIDI, still fast after ``/reload`` of a checkpoint (the swap keeps
    the sampler and its mode), and its notes those of a fresh fast sampler
    on that file, not of an f32 one."""
    import json
    import urllib.request

    from melogan_torch.serving.app import create_server
    from melogan_torch.train.gan_loop import save_gan_final
    from melogan_torch.utils.weights import load_gan_final

    cfg = GANConfig(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)
    donor = gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig(**TINY_ED)), seed=5,
                                device="cpu")
    ckpt = save_gan_final(str(tmp_path / "gan_final.ckpt"), donor, cfg, np.zeros((4, 6), np.float32))
    httpd, state = create_server("127.0.0.1", 0, config=cfg, checkpoint=str(tmp_path / "none.ckpt"),
                                 device="cpu", sample_pool=False, fast_math=True)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert state.sampler.fast_math
        req = urllib.request.Request(base + "/generate", data=b'{"emotion": "sad"}',
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200 and resp.read()[:4] == b"MThd"
        req = urllib.request.Request(base + "/reload", data=json.dumps({"checkpoint": ckpt}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        assert state.sampler.fast_math
        gen_sd, fe_sd = load_gan_final(ckpt)
        feats = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
        noise = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
        served = state.sampler.sample_from(feats, noise)
        kw = dict(gen_variables=gen_sd, fe_variables=fe_sd, device="cpu")
        np.testing.assert_array_equal(served, Sampler(cfg, fast_math=True, **kw).sample_from(feats, noise))
        assert not np.array_equal(served, Sampler(cfg, **kw).sample_from(feats, noise))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        state.close()
    assert not t.is_alive() and default_precision() == "f32"
