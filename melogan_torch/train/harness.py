"""Training harness: plateau learning-rate control, early stopping, the KL
schedules, the port of ``melogan_tpu/train/harness.py:17-125, 200-216``, and
what the VAE and ED loops share besides: ``AdamW``, optax's injected AdamW
written out, ``batch_indices``, an epoch's full batches, and
``with_precision``, the counterpart of ``jit_with_precision``.

``ReduceLROnPlateau`` and ``EarlyStopping`` hold the two controllers'
settings and resume state (torch semantics, mode 'min'), as the JAX
package's dataclasses do. The JAX loops step them on the device inside
their fused multi-epoch programs, in float32 (``device_sched_step``); the
port's loop runs that program's per-epoch body on the host, and
``sched_step`` is its float32 arithmetic, so both loops take the same
decisions on the same validation losses. (The JAX dataclasses' own host
``step`` methods, which neither package's loops call, are not ported.)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from melogan_torch.precision import mode_of, using


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamW:
    """optax's ``inject_hyperparams(adamw)(learning_rate, b1, b2,
    weight_decay)`` over a list of named parameters, step for step, after
    ``clip_by_global_norm(max_norm)`` when ``max_norm`` is given (the VAE's
    ``chain``; the ED's optimizer has no clip):

    - with a clip, the gradients are scaled by max_norm/‖g‖ only when their
      global norm ‖g‖ is not below max_norm (torch's ``clip_grad_norm_``
      scales by max_norm/(‖g‖ + 1e-6) at every step);
    - mu = (1−b1)·g + b1·mu and nu = (1−b2)·g² + b2·nu, bias-corrected by
      1 − b^count, u = mû/(√(nû + eps_root) + eps);
    - the decay is applied inside the update, p ← p − lr·(u + wd·p), on
      every parameter, BatchNorm's included.

    The hyperparameters are float32 values, as optax injects them; the
    plateau controller writes ``lr`` between epochs."""

    HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate", "weight_decay")

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, max_norm: Optional[float] = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.hyperparams = {k: _f32(v) for k, v in zip(
            self.HYPERPARAMS, (b1, b2, eps, eps_root, lr, weight_decay))}
        self.max_norm = None if max_norm is None else float(max_norm)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def lr(self) -> float:
        return self.hyperparams["learning_rate"]

    @lr.setter
    def lr(self, value: float) -> None:
        self.hyperparams["learning_rate"] = _f32(value)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        h = self.hyperparams
        g = [t.detach() for t in grads]  # fresh tensors of autograd's: scaled in place
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            # t if ‖g‖ < max_norm else (t / ‖g‖)·max_norm, with no host sync
            max_norm = torch.full_like(norm, self.max_norm)
            torch._foreach_div_(g, torch.where(norm < max_norm, max_norm, norm))
            torch._foreach_mul_(g, self.max_norm)
        self.count += 1
        one = np.float32(1.0)
        b1, b2 = np.float32(h["b1"]), np.float32(h["b2"])
        torch._foreach_mul_(self.mu, float(b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(g, float(one - b1)))
        torch._foreach_mul_(self.nu, float(b2))
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), float(one - b2)))
        mu_hat = torch._foreach_div(self.mu, float(one - b1 ** np.float32(self.count)))
        nu_hat = torch._foreach_div(self.nu, float(one - b2 ** np.float32(self.count)))
        torch._foreach_add_(nu_hat, h["eps_root"])
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, h["eps"])
        torch._foreach_div_(mu_hat, nu_hat)
        if h["weight_decay"]:
            torch._foreach_add_(mu_hat, torch._foreach_mul(self.params, h["weight_decay"]))
        torch._foreach_mul_(mu_hat, -h["learning_rate"])
        torch._foreach_add_(self.params, mu_hat)

    def state_dict(self) -> Dict[str, Any]:
        """{count, mu, nu (name → tensor copies), hyperparams}."""
        return {"count": self.count,
                "mu": {n: t.detach().clone() for n, t in zip(self.names, self.mu)},
                "nu": {n: t.detach().clone() for n, t in zip(self.names, self.nu)},
                "hyperparams": dict(self.hyperparams)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for n, mu, nu in zip(self.names, self.mu, self.nu):
                mu.copy_(state["mu"][n])
                nu.copy_(state["nu"][n])
        self.hyperparams.update({k: _f32(v) for k, v in state["hyperparams"].items()})


@dataclass
class ReduceLROnPlateau:
    """Plateau LR scheduler settings and state (mode 'min', relative
    threshold 1e-4); ``sched_step`` steps it."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 1e-6
    best: float = float("inf")
    num_bad_epochs: int = 0

    def state_dict(self) -> dict:
        """Resume-critical state: the best metric and the wait counter."""
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])


@dataclass
class EarlyStopping:
    """Stop after ``patience`` epochs without a new best metric; ``improved``
    flags whether the last epoch set one. ``sched_step`` steps it."""

    patience: int = 10
    best: float = float("inf")
    num_bad_epochs: int = 0
    improved: bool = False

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])


def sched_step(plateau: ReduceLROnPlateau, stopper: EarlyStopping, val: float,
               lr: float) -> Tuple[float, bool, bool]:
    """One epoch of the plateau scheduler, then the early stopper, in
    float32 as ``melogan_tpu/train/harness.py::device_sched_step`` computes
    them: updates both in place (``best`` stays a float32 value) and returns
    (the new learning rate, whether the stopper saw a new best, whether
    training should stop)."""
    f32 = np.float32
    val, lr = f32(val), f32(lr)
    if val < f32(plateau.best) * (f32(1.0) - f32(plateau.threshold)):
        plateau.best, plateau.num_bad_epochs = float(val), 0
    else:
        plateau.num_bad_epochs += 1
    if plateau.num_bad_epochs > plateau.patience:
        lr = max(lr * f32(plateau.factor), f32(plateau.min_lr))
        plateau.num_bad_epochs = 0
    stopper.improved = bool(val < f32(stopper.best))
    if stopper.improved:
        stopper.best, stopper.num_bad_epochs = float(val), 0
    else:
        stopper.num_bad_epochs += 1
    return float(lr), stopper.improved, stopper.num_bad_epochs >= stopper.patience


def batch_indices(order: np.ndarray, batch_size: int) -> np.ndarray:
    """(n_batches, B) gather indices: the full batches of ``min(batch_size,
    len(order))`` rows of ``order``, the remainder dropped (a split smaller
    than the batch is one whole-split batch), as the JAX loops stack them."""
    batch_size = min(batch_size, len(order))
    n_batches = max(1, len(order) // batch_size)
    return order[: n_batches * batch_size].reshape(n_batches, batch_size)


def beta_schedule(epoch: int, warmup_epochs: int, final_beta: float) -> float:
    """VAE KL annealing (reference train_ae.py:105-107): linear warm-up to
    ``final_beta`` over ``warmup_epochs``, then constant."""
    if epoch >= warmup_epochs:
        return final_beta
    return min(final_beta, (epoch / warmup_epochs) * final_beta)


def capacity_schedule(epoch: int, capacity: float, ramp_epochs: int) -> float:
    """Burgess et al. 2018 KL capacity annealing: the target C ramps linearly
    from 0 to ``capacity`` over ``ramp_epochs``, then stays constant
    (``vae_loss`` uses β·|KL − C|)."""
    if ramp_epochs <= 0 or epoch >= ramp_epochs:
        return capacity
    return capacity * epoch / ramp_epochs


def with_precision(fn, precision=None):
    """``fn`` run under a precision, the counterpart of the JAX package's
    ``jit_with_precision``: None or ``"highest"`` returns ``fn`` itself
    (IEEE f32, the parity default); ``"bf16"`` or ``"default"`` returns a
    wrapper that sets this thread's precision to ``"fast"`` around each call
    and restores the one before, also when the call raises. ``"fast"`` is
    the TPU's one bf16 pass (``melogan_torch/precision.py``): only the
    products' operands are rounded; parameters, activations at rest,
    gradients and optimizer state stay f32. Anything else raises
    ValueError."""
    if mode_of(precision) == "f32":
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with using("fast"):
            return fn(*args, **kwargs)

    return wrapped


def refuse_spectral_norm(trainer: str, what: Sequence[str]) -> None:
    """Raise NotImplementedError when a model to train has spectral norm on
    (``what``: the config fields that turn it on). The JAX trainers cannot
    train such a model: the GAN step applies the feature encoder with its
    ``params`` alone (``gan_step.py:474-477``) and the ED trainer with params
    and batch_stats (``ed_loop.py:116-145``), so flax finds no ``spectral``
    collection; the port refuses it in the same way (ROADMAP C.5). Sampling
    and the weight bridge take spectral-norm models."""
    if what:
        raise NotImplementedError(
            f"{trainer}: cannot train a spectral-norm model ({', '.join(what)}): the JAX "
            "trainers apply it without its 'spectral' collection (flax raises "
            "ScopeCollectionNotFound), so there is no reference run to port")
