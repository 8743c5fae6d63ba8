"""Weights made on the device from ``--seed``, in the upstream state-dict
layout, handed alike to the program and to the reference.

All values come from one ``torch.randn`` call of a generator on the device,
cut into the leaves of ``reference.model.param_shapes`` and scaled by role:

- ``served`` (a trained model as sampling serves it): weights N(0, 1/fan-in),
  biases N(0, 0.1²), norm scales 1 + N(0, 0.1²), norm shifts N(0, 0.1²),
  running means N(0, 0.1²), running variances exp(N(0, 0.2²)), so that the
  BatchNorm fold does real work.
- ``train_start`` (what ``train-gan`` starts from): the upstream
  ``weights_init``, N(0, 0.02²) weights and zero biases, norm scales 1 and
  shifts 0, running statistics 0 and 1.

``num_batches_tracked`` is 0 in both.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import param_shapes


def _scaled(z: torch.Tensor, role: str, fan: int, scheme: str) -> torch.Tensor:
    if role == "count":
        return torch.zeros((), dtype=torch.int64, device=z.device)
    if scheme == "served":
        if role in ("weight", "convt"):
            return z / math.sqrt(fan)
        if role in ("bias", "norm_bias", "running_mean"):
            return 0.1 * z
        if role == "norm_weight":
            return 1.0 + 0.1 * z
        if role == "running_var":
            return torch.exp(0.2 * z)
    elif scheme == "train_start":
        if role in ("weight", "convt"):
            return 0.02 * z
        if role in ("bias", "norm_bias", "running_mean"):
            return torch.zeros_like(z)
        if role in ("norm_weight", "running_var"):
            return torch.ones_like(z)
    raise ValueError(f"no rule for role {role!r} under scheme {scheme!r}")


def make(gan, ed, seed: int, device, schemes: Dict[str, str]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{model: {name: float32 tensor}}`` for each model in ``schemes``
    (``gen``, ``fe``, ``critic``, ``ed`` → ``served`` or ``train_start``)."""
    shapes = param_shapes(gan, ed)
    leaves = [(m, name, spec) for m in schemes for name, spec in shapes[m].items()]
    total = sum(math.prod(spec[0]) for _, _, spec in leaves)
    rng = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=rng, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in schemes}
    at = 0
    for m, name, (shape, role, fan) in leaves:
        n = math.prod(shape)
        out[m][name] = _scaled(flat[at:at + n].reshape(shape), role, fan, schemes[m]).contiguous()
        at += n
    return out
