"""Training harness: plateau learning-rate control, early stopping and the
KL schedules, the port of ``melogan_tpu/train/harness.py:17-80, 200-216``.

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

from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
