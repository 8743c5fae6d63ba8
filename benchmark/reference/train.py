"""The plain reference of WGAN-GP group steps (upstream src/gan/train_gan.py:
159-251 with config/gan_config.yaml's hyperparameters).

A group step: ``CRITIC_ITERS`` critic updates, one on each batch of the
group, then one generator and feature-encoder update on the last batch.

- critic update: the feature encoder (train mode, the given dropout masks)
  and the generator (train mode, batch statistics) without gradients give
  the embedding and the fakes; ``loss_d = mean D(fake) − mean D(real) +
  λ_gp · mean((‖∇ₓD(x̂)‖₂ − 1)²)`` with x̂ = α·real + (1 − α)·fake per row
  (the norm with 1e-12 under its root); one Adam step on the critic.
- generator update: ``loss_g = −mean D(G(z)) + λ_emotion · CE(ED(G(z)),
  emotion)`` with the emotion discriminator frozen in eval mode; one Adam
  step on the generator and feature encoder together.
- Adam (β from the config, eps 1e-8, no weight decay) written out, as
  ``torch.optim.Adam`` defines it.

The draws (noise, α, dropout keep masks) are inputs, as the benchmark hands
them to the program. ``fault="half_batch"`` takes each update's means over
the first half of its rows only (a fault the benchmark must catch).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import model


class Adam:
    """``torch.optim.Adam``'s update, one state per named parameter."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, betas[0], betas[1], eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(self.lr / bc1 * self.m[k] / denom)


def _rows(t: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    return t[: t.shape[0] // 2] if fault == "half_batch" else t


def critic_loss(params, gan, real, numeric, noise, alpha, keep, mode: str):
    """One critic update's loss and its gradient penalty."""
    p_gen, p_fe, p_critic = params["gen"], params["fe"], params["critic"]
    with torch.no_grad():
        emb = model.feature_encoder(p_fe, gan, numeric, mode, keep)
        fake = model.generator(p_gen, gan, noise, emb, mode, train=True)
    d_real = model.critic(p_critic, real, emb, mode).mean()
    d_fake = model.critic(p_critic, fake, emb, mode).mean()
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (gx,) = torch.autograd.grad(model.critic(p_critic, interp, emb, mode).sum(), interp, create_graph=True)
    norms = torch.sqrt(gx.reshape(gx.shape[0], -1).square().sum(dim=1) + 1e-12)
    gp = (norms - 1.0).square().mean()
    return d_fake - d_real + gan["LAMBDA_GP"] * gp, gp


def generator_loss(params, gan, ed, emotion, numeric, noise, keep, mode: str):
    """One generator update's loss and its two terms."""
    emb = model.feature_encoder(params["fe"], gan, numeric, mode, keep)
    fake = model.generator(params["gen"], gan, noise, emb, mode, train=True)
    adv = -model.critic(params["critic"], fake, emb, mode).mean()
    emo = F.cross_entropy(model.emotion_discriminator(params["ed"], ed, fake, mode), emotion.long())
    return adv + gan["LAMBDA_EMOTION"] * emo, adv, emo


def trainable(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """The generator's, feature encoder's and critic's float leaves (not the
    BatchNorm statistics) made leaves that require grad, put back in
    ``params``."""
    train = {m: {k: v.detach().requires_grad_(True) for k, v in params[m].items()
                 if v.is_floating_point() and not _is_buffer(k)}
             for m in ("gen", "fe", "critic")}
    for m in ("gen", "fe", "critic"):
        params[m].update(train[m])
    return train


def group_steps(params, gan, ed, batches: List[tuple], draws: List[dict], mode: str = "none",
                fault: Optional[str] = None) -> dict:
    """Run ``len(batches)`` group steps from ``params`` (``gen``, ``fe``,
    ``critic``, ``ed`` dicts in float64 on the device; updated in place).

    ``batches[s]``: (notes (k, B, L, C), emotion (k, B), numeric (k, B, 6));
    ``draws[s]``: ``{"critic": [(noise, alpha (B, 1, 1), keep masks)] * k,
    "gen": (noise, keep masks)}``.

    Returns ``{"metrics": [per step {loss_d_sum, gp_mean, loss_g_adv,
    loss_g_emo, loss_g}], "critic_grad": {name: g}, "gen_grad": {name: g}}``:
    the gradients of the first critic update and of the first generator
    update."""
    train = trainable(params)
    opt_d = Adam(train["critic"], gan["LR_D"], (gan["BETA1"], gan["BETA2"]))
    g_params = {**{"gen." + k: v for k, v in train["gen"].items()},
                **{"fe." + k: v for k, v in train["fe"].items()}}
    opt_g = Adam(g_params, gan["LR_G"], (gan["BETA1"], gan["BETA2"]))
    out = {"metrics": [], "critic_grad": None}
    for (notes, emotion, numeric), dr_ in zip(batches, draws):
        losses, gps = [], []
        for k, (noise, alpha, keep) in enumerate(dr_["critic"]):
            loss, gp = critic_loss(params, gan, _rows(notes[k], fault), _rows(numeric[k], fault),
                                   _rows(noise, fault), _rows(alpha, fault),
                                   [_rows(m, fault) for m in keep], mode)
            names = list(train["critic"])
            grads = dict(zip(names, torch.autograd.grad(loss, [train["critic"][n] for n in names])))
            if out["critic_grad"] is None:
                out["critic_grad"] = {n: g.detach().clone() for n, g in grads.items()}
            opt_d.step(grads)
            losses.append(loss.detach())
            gps.append(gp.detach())
        noise, keep = dr_["gen"]
        loss_g, adv, emo = generator_loss(params, gan, ed, _rows(emotion[-1], fault),
                                          _rows(numeric[-1], fault), _rows(noise, fault),
                                          [_rows(m, fault) for m in keep], mode)
        names = list(g_params)
        grads = dict(zip(names, torch.autograd.grad(loss_g, [g_params[n] for n in names])))
        if "gen_grad" not in out:
            out["gen_grad"] = {n: g.detach().clone() for n, g in grads.items()}
        opt_g.step(grads)
        out["metrics"].append({
            "loss_d_sum": float(torch.stack(losses).sum()),
            "gp_mean": float(torch.stack(gps).mean()),
            "loss_g_adv": float(adv.detach()),
            "loss_g_emo": float(emo.detach()),
            "loss_g": float(loss_g.detach()),
        })
    return out


def _is_buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")
