"""The WGAN-GP training step on the port.

Port of ``melogan_tpu/train/gan_step.py`` (reference src/gan/train_gan.py:
159-251), with the same semantics and metric keys:

- a critic update on every batch: the generator runs in train mode without
  gradients (its BatchNorm running stats still advance), then
  ``loss_d = mean(D(fake)) − mean(D(real)) + λ_gp·GP``
- the group step: ``critic_iters`` critic updates, then one generator +
  feature-encoder update on the last batch with fresh noise,
  ``loss_g = −mean(D(G(z))) + λ_emo·CE(ED(G(z)), emotion) [+ λ_fm·fm]`` with
  the emotion discriminator (ED) frozen in eval mode
- the gradient penalty ((‖∇ₓD(interp)‖₂ − 1)²).mean() over per-sample α
  interpolates, by ``torch.autograd.grad(create_graph=True)``; with
  ``fused_critic_batch`` one critic pass over [real; fake; interp]
- the critic-only tail step for the epoch remainder
- Adam(β 0.5/0.9, eps 1e-8): lr_g over G and the feature encoder jointly,
  lr_d over the critic; the debiased generator-weight EMA

The JAX package threads an immutable state through jitted programs; here
the state holds the modules and optimizers and the steps update it in place
(and return it, so a caller reads like the JAX one). Randomness — noise,
GP α, the feature encoder's dropout masks — comes from the state's
``torch.Generator``, or from ``draws`` given by the caller (how the tests
inject the JAX package's draws). The steps run wherever the state lives:
on the card the generator's transposed convs and the ED's convs launch the
port's kernels forward and backward; on the CPU their plain versions run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.device import resolve_device
from melogan_torch.models.ed import EmotionDiscriminator
from melogan_torch.models.gan import Critic, FeatureEncoder, Generator
from melogan_torch.models.layers import gan_init_, torch_default_init_
from melogan_torch.utils.weights import to_tensors


class GANModels(NamedTuple):
    generator: Generator
    critic: Critic
    feature_encoder: FeatureEncoder
    ed: EmotionDiscriminator


@dataclass
class GANTrainState:
    """Modules, optimizers and randomness of one WGAN-GP run, on one device.

    ``step`` counts group steps (one generator update each); ``ema_params``
    is the raw zero-seeded EMA stream of the generator's parameters (None
    when ``cfg.ema_decay`` is 0); :func:`ema_weights` debiases it."""

    generator: Generator
    critic: Critic
    feature_encoder: FeatureEncoder
    ed: EmotionDiscriminator
    opt_g: torch.optim.Adam  # over generator + feature encoder jointly
    opt_d: torch.optim.Adam
    rng: torch.Generator
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


class CriticDraws(NamedTuple):
    """The random numbers of one critic update."""

    noise: torch.Tensor  # (B, noise_dim)
    alpha: torch.Tensor  # (B, 1, 1) GP interpolation weights
    fe_masks: Sequence[torch.Tensor]  # keep masks, (B, hidden) per FE dropout


class GenDraws(NamedTuple):
    """The random numbers of one generator update."""

    noise: torch.Tensor
    fe_masks: Sequence[torch.Tensor]


class GroupDraws(NamedTuple):
    critic: Sequence[CriticDraws]  # one per critic update
    gen: GenDraws


def build_models(cfg: GANConfig, ed_cfg: Optional[EDConfig] = None) -> GANModels:
    return GANModels(
        generator=Generator.from_config(cfg),
        critic=Critic.from_config(cfg),
        feature_encoder=FeatureEncoder.from_config(cfg),
        ed=EmotionDiscriminator.from_config((ed_cfg or EDConfig()).model_cfg()),
    )


def make_optimizers(cfg: GANConfig, models: GANModels):
    g_params = list(models.generator.parameters()) + list(models.feature_encoder.parameters())
    opt_g = torch.optim.Adam(g_params, lr=cfg.lr_g, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    opt_d = torch.optim.Adam(models.critic.parameters(), lr=cfg.lr_d,
                             betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    return opt_g, opt_d


def init_state(
    cfg: GANConfig,
    models: GANModels,
    seed: int = 42,
    ed_variables: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> GANTrainState:
    """Initialize weights from ``seed`` (the reference's N(0, 0.02) for G,
    the feature encoder and the critic; torch's default for the ED), move
    everything to ``device`` and build the optimizers. ``ed_variables``: a
    pre-trained ED as a reference-layout state dict (``ed_best.pth``, or
    ``utils.weights.export_ed`` of JAX variables); without it the ED is
    random, as the reference warns and proceeds (train_gan.py:128-129)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # IEEE f32 as the JAX package's Precision.HIGHEST: no TF32 in cuBLAS,
        # nor in cuDNN, whose flag the critic's conv backward reads when
        # autograd runs it, outside the forward's ``cudnn.flags`` context
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's default conv backward algorithms (the critic's weight and
        # input gradients) add with atomics, so a resumed run would not repeat
        # the run done in one go bit for bit; on the H100 the deterministic
        # ones took no longer (chip_smoke.py's determinism phase)
        torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(seed)
    gan_init_(models.feature_encoder, g)
    gan_init_(models.generator, g)
    gan_init_(models.critic, g)
    if ed_variables is None:
        torch_default_init_(models.ed, g)
    else:
        models.ed.load_state_dict(to_tensors(ed_variables), strict=True)
    for m in models:
        m.to(dev)
    models.generator.train()
    models.feature_encoder.train()
    models.critic.train()
    models.ed.eval().requires_grad_(False)
    opt_g, opt_d = make_optimizers(cfg, models)
    ema = None
    if cfg.ema_decay:
        ema = {n: torch.zeros_like(p) for n, p in models.generator.named_parameters()}
    return GANTrainState(
        generator=models.generator, critic=models.critic,
        feature_encoder=models.feature_encoder, ed=models.ed,
        opt_g=opt_g, opt_d=opt_d,
        rng=torch.Generator(device=dev).manual_seed(seed + 1),
        ema_params=ema,
    )


def ema_weights(state: GANTrainState, decay: float) -> Optional[Dict[str, torch.Tensor]]:
    """Debiased EMA generator parameters, e_t / (1 − d^t) with t the group
    step count; the live parameters at t = 0; None when EMA is off."""
    if state.ema_params is None:
        return None
    if state.step == 0:
        return {n: p.detach().clone() for n, p in state.generator.named_parameters()}
    corr = np.float32(1.0 - float(decay) ** state.step)
    return {n: e / float(corr) for n, e in state.ema_params.items()}


def ema_horizon_note(cfg: GANConfig, n_epochs: int, n_train: int) -> Optional[str]:
    """A warning when the EMA decay does not fit the run: the run makes
    t = n_epochs × (⌊N/B⌋ // critic_iters) generator updates, and the
    debiased EMA needs about 2/(1−d) of them to catch the live weights.
    None when it fits or EMA is off."""
    d = cfg.ema_decay
    if not d:
        return None
    if d >= 1.0:
        return (f"[WARN] ema_decay={d:g} is ≥ 1.0: the EMA would never move off "
                f"its seed. Use a decay in [0, 1).")
    g_per_epoch = (n_train // cfg.batch_size) // max(cfg.critic_iters, 1)
    t = n_epochs * g_per_epoch
    if g_per_epoch == 0:
        return (
            f"[WARN] ema_decay={d:g} requested but this run will perform ZERO "
            f"generator updates: the corpus yields only "
            f"{n_train // cfg.batch_size} batches/epoch at batch_size="
            f"{cfg.batch_size}, fewer than critic_iters={cfg.critic_iters}, "
            f"so every epoch is a critic-only tail and G_ema stays its zero "
            f"seed regardless of epochs. Lower the batch size or critic_iters."
        )
    window = 1.0 / (1.0 - d)
    if t >= 2.0 * window:
        return None
    fix = f"lower the decay to ≤ {1.0 - 2.0 / t:.4g}, " if t > 2 else ""
    return (
        f"[WARN] ema_decay={d:g} averages over ~{window:.0f} G updates but "
        f"this run only performs t={t} ({n_epochs} epochs × {g_per_epoch} "
        f"G updates/epoch); the EMA needs ~2/(1−d) updates to catch the live "
        f"trajectory, so the exported G_ema will lag — {fix}or train longer"
    )


def ema_auto_decay(cfg: GANConfig, n_epochs: int, n_train: int) -> float:
    """An EMA decay sized to the planned generator-update count t: a window
    of about t/50 updates, d = 1 − 50/t, floored at 0.01."""
    g_per_epoch = (n_train // cfg.batch_size) // max(cfg.critic_iters, 1)
    t = n_epochs * g_per_epoch
    if t <= 0:
        raise ValueError(
            f"--ema auto: this run performs zero generator updates "
            f"({n_train} rows, batch_size={cfg.batch_size}, "
            f"critic_iters={cfg.critic_iters}); lower the batch size or "
            f"critic_iters."
        )
    return float(min(max(1.0 - 50.0 / t, 0.01), 0.9999))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss semantics: mean over batch of −log_softmax[y]."""
    return F.cross_entropy(logits, labels.long())


def note_space_stats(notes: torch.Tensor) -> torch.Tensor:
    """Differentiable per-sample note-space statistics φ(notes) → (B, 18):
    per-column mean, std (biased variance), mean |Δ| over the event axis,
    and a 6-dim chroma signature of the pitch column (mean sin/cos at the
    pitch-class frequency and two harmonics)."""
    mu = notes.mean(dim=1)
    sd = torch.sqrt(torch.clamp(notes.var(dim=1, correction=0), min=1e-8))
    dif = (notes[:, 1:, :] - notes[:, :-1, :]).abs().mean(dim=1)
    pitch_semi = (notes[..., 0] + 1.0) * 63.5  # renderer's pitch map
    chroma = []
    for k in (1, 2, 3):
        theta = (2.0 * math.pi / 12.0) * k * pitch_semi
        chroma.append(torch.sin(theta).mean(dim=1))
        chroma.append(torch.cos(theta).mean(dim=1))
    return torch.cat([mu, sd, dif, torch.stack(chroma, dim=-1)], dim=-1)


def _centroids(feats: np.ndarray, emotion_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    targets = np.stack([
        feats[emotion_idx == e].mean(axis=0) if (emotion_idx == e).any() else feats.mean(axis=0)
        for e in range(4)
    ])
    scale = np.maximum(feats.std(axis=0), 1e-3).astype(np.float32)
    return targets, scale


def fm_targets_from_data(notes_gan: np.ndarray, emotion_idx: np.ndarray):
    """Per-emotion real-data centroids of :func:`note_space_stats` and a
    per-feature scale (the std across songs): ``(targets (4, 18), scale
    (18,))`` as numpy, computed once on the host from the corpus."""
    pitch_semi = (notes_gan[..., 0] + 1.0) * 63.5
    chroma = []
    for k in (1, 2, 3):
        theta = (2.0 * np.pi / 12.0) * k * pitch_semi
        chroma.append(np.sin(theta).mean(axis=1))
        chroma.append(np.cos(theta).mean(axis=1))
    phi = np.concatenate(
        [notes_gan.mean(axis=1),
         np.sqrt(np.maximum(notes_gan.var(axis=1), 1e-8)),
         np.abs(np.diff(notes_gan, axis=1)).mean(axis=1),
         np.stack(chroma, axis=-1)], axis=-1
    ).astype(np.float32)
    return _centroids(phi, emotion_idx)


def fm_ed_targets_from_data(ed: EmotionDiscriminator, notes_gan: np.ndarray,
                            emotion_idx: np.ndarray, batch_size: int = 128):
    """Per-emotion centroids of the frozen ED's multi-scale features
    (``features(multi=True)``) over the real corpus, and a per-feature scale:
    ``(targets (4, D), scale (D,))`` as numpy; None in latent mode. Runs on
    the ED's device, in eval mode."""
    if ed.input_mode != "notes":
        return None
    dev = next(ed.parameters()).device
    was = ed.training
    ed.eval()
    outs = []
    try:
        with torch.no_grad():
            for i in range(0, notes_gan.shape[0], batch_size):
                x = torch.as_tensor(np.ascontiguousarray(notes_gan[i:i + batch_size], np.float32),
                                    device=dev)
                outs.append(ed.features(x, multi=True).cpu().numpy())
    finally:
        ed.train(was)
    return _centroids(np.concatenate(outs, axis=0).astype(np.float32), emotion_idx)


def gradient_penalty(critic: Critic, real, fake, emb, alpha) -> torch.Tensor:
    """((‖∇ₓD(interp)‖₂ − 1)²).mean() with per-sample α (utils.py:75-90);
    the graph is kept, so the penalty differentiates w.r.t. the critic."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(interp, emb).sum(), interp, create_graph=True)
    return _penalty(grads)


def _penalty(grads: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(grads.reshape(grads.shape[0], -1).square().sum(dim=1) + 1e-12)
    return (norms - 1.0).square().mean()


def _apply(opt: torch.optim.Adam, params: List[torch.Tensor], loss: torch.Tensor) -> None:
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


class TrainStepFns(NamedTuple):
    """group(state, batches, draws=None) → (state, metrics): ``critic_iters``
    critic updates and one G+FE update, each batch field stacked to
    (critic_iters, B, ...). tail(state, batches, draws=None) → (state,
    metrics): one critic update per stacked batch."""

    group: Callable
    tail: Callable


def make_train_steps(cfg: GANConfig, fm_target=None, fm_ed_target=None) -> TrainStepFns:
    """Build the step functions. ``fm_target`` / ``fm_ed_target``: the
    ``(targets, scale)`` pairs of :func:`fm_targets_from_data` /
    :func:`fm_ed_targets_from_data`; ``cfg.lambda_fm > 0`` needs at least
    one. Metrics are 0-d tensors on the state's device, with the JAX
    package's keys."""
    fm_on, fm_ed_on = fm_target is not None, fm_ed_target is not None
    if cfg.lambda_fm and not (fm_on or fm_ed_on):
        raise ValueError(
            "cfg.lambda_fm > 0 requires fm_target / fm_ed_target — compute "
            "them from the training corpus with fm_targets_from_data() / "
            "fm_ed_targets_from_data()"
        )
    consts: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def const(name: str, value, dev: torch.device) -> torch.Tensor:
        key = (name, dev)
        if key not in consts:
            consts[key] = torch.as_tensor(np.asarray(value, np.float32), device=dev)
        return consts[key]

    def latent_input(latents):
        return latents if cfg.integration_mode == "conditioning" else None

    def draw_critic(state: GANTrainState, b: int) -> CriticDraws:
        dev, rng = state.device, state.rng
        return CriticDraws(
            noise=torch.randn((b, cfg.noise_dim), generator=rng, device=dev),
            alpha=torch.rand((b, 1, 1), generator=rng, device=dev),
            fe_masks=state.feature_encoder.draw_masks(b, rng),
        )

    def draw_gen(state: GANTrainState, b: int) -> GenDraws:
        return GenDraws(
            noise=torch.randn((b, cfg.noise_dim), generator=state.rng, device=state.device),
            fe_masks=state.feature_encoder.draw_masks(b, state.rng),
        )

    def critic_update(state: GANTrainState, batch, draws: Optional[CriticDraws]):
        real, _, latents, numeric = batch
        b = real.shape[0]
        if draws is None:
            draws = draw_critic(state, b)
        critic = state.critic
        with torch.no_grad():
            # G in train mode: batch statistics, and its running stats advance
            emb = state.feature_encoder(numeric, masks=draws.fe_masks)
            fake, _ = state.generator(draws.noise, latent_input(latents), emb)
        alpha = draws.alpha
        if cfg.fused_critic_batch:
            # one critic pass over [real; fake; interp] (3B rows): exact, since
            # the critic has no cross-sample op (no batch-norm)
            interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
            s = critic(torch.cat([real, fake, interp], dim=0), torch.cat([emb, emb, emb], dim=0))
            (g,) = torch.autograd.grad(s[2 * b:].sum(), interp, create_graph=True)
            gp = _penalty(g)
            dr, df = s[:b].mean(), s[b:2 * b].mean()
        else:
            dr = critic(real, emb).mean()
            df = critic(fake, emb).mean()
            gp = gradient_penalty(critic, real, fake, emb, alpha)
        loss = df - dr + cfg.lambda_gp * gp
        _apply(state.opt_d, list(critic.parameters()), loss)
        return loss.detach(), gp.detach(), dr.detach(), df.detach()

    def gen_update(state: GANTrainState, batch, draws: Optional[GenDraws]):
        real, emot_idx, latents, numeric = batch
        if draws is None:
            draws = draw_gen(state, real.shape[0])
        ed = state.ed
        emb = state.feature_encoder(numeric, masks=draws.fe_masks)
        notes, glatent = state.generator(draws.noise, latent_input(latents), emb)
        adv = -state.critic(notes, emb).mean()
        ed_in = glatent if ed.input_mode == "latent" else notes
        if fm_ed_on:
            # one encoder pass serves the CE and the multi-scale feature match
            ed_feats, logits = ed.features_and_logits(ed_in, multi=True)
        else:
            logits = ed(ed_in)
        emo = cross_entropy(logits, emot_idx)
        loss = adv + cfg.lambda_emotion * emo
        fm = torch.zeros((), device=notes.device)
        if fm_on:
            phi = note_space_stats(notes)
            mu, scale = const("fm_mu", fm_target[0], notes.device), const("fm_scale", fm_target[1], notes.device)
            diff = (phi - mu[emot_idx]) / scale
            fm = fm + diff.square().sum(dim=-1).mean() / phi.shape[-1]
        if fm_ed_on:
            mu = const("fm_ed_mu", fm_ed_target[0], notes.device)
            scale = const("fm_ed_scale", fm_ed_target[1], notes.device)
            dfe = (ed_feats - mu[emot_idx]) / scale
            fm = fm + dfe.square().sum(dim=-1).mean() / dfe.shape[-1]
        if fm_on or fm_ed_on:
            loss = loss + cfg.lambda_fm * fm
        params = list(state.generator.parameters()) + list(state.feature_encoder.parameters())
        _apply(state.opt_g, params, loss)
        return adv.detach(), emo.detach(), fm.detach()

    def critic_updates(state, batches, draws):
        outs = [critic_update(state, tuple(f[k] for f in batches), None if draws is None else draws[k])
                for k in range(batches[0].shape[0])]
        return [torch.stack(col) for col in zip(*outs)]

    def group_step(state: GANTrainState, batches, draws: Optional[GroupDraws] = None):
        """batches: (notes, emotion_idx, latents, numeric), each stacked to
        (critic_iters, B, ...)."""
        d_losses, gps, drs, dfs = critic_updates(state, batches, None if draws is None else draws.critic)
        last = tuple(f[-1] for f in batches)
        adv, emo, fm = gen_update(state, last, None if draws is None else draws.gen)
        if state.ema_params is not None:
            d = np.float32(cfg.ema_decay)
            one_minus = float(np.float32(1.0) - d)
            with torch.no_grad():
                for n, p in state.generator.named_parameters():
                    e = state.ema_params[n]
                    e.copy_(float(d) * e + one_minus * p)
        state.step += 1
        metrics = {
            "loss_d_sum": d_losses.sum(),
            "gp_mean": gps.mean(),
            "loss_g_adv": adv,
            "loss_g_emo": emo,
            "d_real_sum": drs.sum(),
            "d_fake_sum": dfs.sum(),
        }
        if fm_on or fm_ed_on:
            metrics["loss_g_fm"] = fm
        return state, metrics

    def critic_only_step(state: GANTrainState, batches,
                         draws: Optional[Sequence[CriticDraws]] = None):
        """The epoch tail: one critic update per stacked batch."""
        d_losses, gps, drs, dfs = critic_updates(state, batches, draws)
        return state, {
            "loss_d_sum": d_losses.sum(),
            "gp_mean": gps.mean(),
            "d_real_sum": drs.sum(),
            "d_fake_sum": dfs.sum(),
        }

    return TrainStepFns(group=group_step, tail=critic_only_step)
