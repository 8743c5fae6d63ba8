"""Weight bridge: JAX parameter trees and reference ``gan_final.pth`` files →
the port's modules.

``export_*`` are the port's own copies of the numpy-only exporters in
``melogan_tpu/utils/torch_interop.py``: they map the JAX package's parameter
trees (numpy arrays or anything ``np.asarray`` takes) to reference-layout
torch state dicts, whose names the port's modules carry. Mapping:

- Linear: ``kernel`` (in, out) → torch ``weight`` (out, in)
- ConvTranspose1d: HIO ``kernel`` (k, in, out) → torch ``weight`` (in, out, k)
- BatchNorm1d: scale/bias + batch_stats {mean, var} → weight/bias/running_*
- LayerNorm: scale/bias → weight/bias

Reading the JAX package's ``.ckpt`` files (flax msgpack) comes later.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _exp_linear(p: Dict, prefix: str, sd: Dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _exp_convt1d(p: Dict, prefix: str, sd: Dict) -> None:
    # HIO kernel (k, in, out) → torch ConvTranspose1d weight (in, out, k)
    sd[f"{prefix}.weight"] = np.transpose(_np(p["kernel"]), (1, 2, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _exp_bn(p: Dict, s: Dict, prefix: str, sd: Dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    # torch BatchNorm1d state dicts carry this counter; unused at eval time
    # but required by strict=True loads
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _exp_ln(p: Dict, prefix: str, sd: Dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def export_generator(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX Generator variables → torch state_dict keyed per src/gan/models.py."""
    p, st = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _exp_linear(p["noise_to_latent"]["TorchLinear_0"], "noise_to_latent.net.0", sd)
    _exp_linear(p["noise_to_latent"]["TorchLinear_1"], "noise_to_latent.net.2", sd)
    _exp_linear(p["decoder"]["TorchLinear_0"], "decoder.pre.0", sd)
    _exp_linear(p["decoder"]["TorchLinear_1"], "decoder.pre.2", sd)
    for i, t in enumerate((0, 3, 6)):
        _exp_convt1d(p["decoder"][f"ConvTranspose1d_{i}"], f"decoder.deconv.{t}", sd)
    for i, t in enumerate((1, 4)):
        _exp_bn(
            p["decoder"][f"TorchBatchNorm_{i}"],
            st["decoder"][f"TorchBatchNorm_{i}"],
            f"decoder.deconv.{t}",
            sd,
        )
    return sd


def export_feature_encoder(
    variables: Mapping[str, Any], hidden_layers: int | None = None
) -> Dict[str, np.ndarray]:
    """JAX FeatureEncoder variables → torch state_dict (feature_encoder.py:5-45)."""
    p = variables["params"]
    if hidden_layers is None:
        hidden_layers = sum(1 for k in p if k.startswith("TorchLinear_")) - 1
    sd: Dict[str, np.ndarray] = {}
    _exp_ln(p["TorchLayerNorm_0"], "net.0", sd)
    for i in range(hidden_layers):
        _exp_linear(p[f"TorchLinear_{i}"], f"net.{1 + i * 3}", sd)
    _exp_linear(p[f"TorchLinear_{hidden_layers}"], f"net.{1 + hidden_layers * 3}", sd)
    return sd


def export_gan_final(gen_vars: Mapping[str, Any], fe_vars: Mapping[str, Any]) -> Dict[str, Any]:
    """Sampler vars → reference ``gan_final.pth`` layout (train_gan.py:279-282)."""
    return {"G": export_generator(gen_vars), "E_num": export_feature_encoder(fe_vars)}


def to_tensors(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state dict of numpy arrays or tensors → CPU tensors (copies: the
    arrays may be read-only views of JAX buffers)."""
    return {k: torch.from_numpy(np.array(_np(v))) for k, v in sd.items()}


def load_state_dicts(generator: nn.Module, fe: nn.Module,
                     gen_sd: Mapping[str, Any], fe_sd: Mapping[str, Any]) -> None:
    """Load reference-layout state dicts into the modules, strictly."""
    generator.load_state_dict(to_tensors(gen_sd), strict=True)
    fe.load_state_dict(to_tensors(fe_sd), strict=True)


def load_jax_variables(generator: nn.Module, fe: nn.Module,
                       gen_vars: Mapping[str, Any], fe_vars: Mapping[str, Any]) -> None:
    """Carry JAX parameter trees (numpy leaves) into the port's Generator and
    FeatureEncoder with ``load_state_dict(strict=True)``."""
    load_state_dicts(generator, fe, export_generator(gen_vars), export_feature_encoder(fe_vars))


def load_gan_final_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference-layout ``gan_final.pth`` ({'G': ..., 'E_num': ...}) →
    (generator state dict, feature-encoder state dict). Loaded with
    ``weights_only=True``: tensors and containers only, no pickled code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "G" not in ckpt or "E_num" not in ckpt:
        raise ValueError(f"{path}: expected a dict with 'G' and 'E_num' state dicts")
    return dict(ckpt["G"]), dict(ckpt["E_num"])
