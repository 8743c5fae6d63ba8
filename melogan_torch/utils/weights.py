"""Weight bridge: JAX parameter trees and reference ``gan_final.pth`` files →
the port's modules.

``export_*`` are the port's own copies of the numpy-only exporters in
``melogan_tpu/utils/torch_interop.py``: they map the JAX package's parameter
trees (numpy arrays or anything ``np.asarray`` takes) to reference-layout
torch state dicts, whose names the port's modules carry. Mapping:

- Linear: ``kernel`` (in, out) → torch ``weight`` (out, in)
- Conv1d: HIO ``kernel`` (k, in, out) → torch ``weight`` (out, in, k)
- ConvTranspose1d: HIO ``kernel`` (k, in, out) → torch ``weight`` (in, out, k)
- BatchNorm1d: scale/bias + batch_stats {mean, var} → weight/bias/running_*
- LayerNorm: scale/bias → weight/bias

``load_jax_train_state`` carries a whole JAX ``GANTrainState`` (generator,
feature encoder, critic, frozen ED) into the port's training state.
Reading the JAX package's ``.ckpt`` files (flax msgpack) comes later.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


def _exp_conv1d(p: Dict, prefix: str, sd: Dict) -> None:
    # HIO kernel (k, in, out) → torch Conv1d weight (out, in, k)
    sd[f"{prefix}.weight"] = np.transpose(_np(p["kernel"]), (2, 1, 0))
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


def export_ed(
    variables: Mapping[str, Any],
    notes_blocks: Optional[int] = None,
    mlp_hidden: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """ED variables → torch state_dict keyed per ed_model.py module names.

    Layer counts default to what the tree itself contains."""
    p = variables["params"]
    st = variables.get("batch_stats", {})
    if mlp_hidden is None:
        mlp_hidden = sum(1 for k in p["classifier"] if k.startswith("TorchLinear_")) - 1
    sd: Dict[str, np.ndarray] = {}
    if "encoder" in p:
        if notes_blocks is None:
            notes_blocks = sum(1 for k in p["encoder"] if k.startswith("ConvBlock1D_"))
        for i in range(notes_blocks):
            block = p["encoder"][f"ConvBlock1D_{i}"]
            _exp_conv1d(block["Conv1d_0"], f"encoder.conv.{i}.net.0", sd)
            _exp_bn(
                block["TorchBatchNorm_0"],
                st["encoder"][f"ConvBlock1D_{i}"]["TorchBatchNorm_0"],
                f"encoder.conv.{i}.net.1",
                sd,
            )
        _exp_linear(p["encoder"]["TorchLinear_0"], "encoder.project", sd)
    for i in range(mlp_hidden):
        _exp_linear(p["classifier"][f"TorchLinear_{i}"], f"classifier.net.{i * 3}", sd)
    _exp_linear(p["classifier"][f"TorchLinear_{mlp_hidden}"], "classifier.head", sd)
    return sd


def export_critic(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Critic variables → torch state_dict keyed per src/gan/models.py:132-169."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for i, t in enumerate((0, 2, 4)):
        _exp_conv1d(p[f"Conv1d_{i}"], f"conv.{t}", sd)
    _exp_linear(p["TorchLinear_0"], "fc.1", sd)
    _exp_linear(p["TorchLinear_1"], "real_fake", sd)
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


def load_jax_train_state(port_state, jax_state) -> None:
    """Carry a JAX ``GANTrainState`` (anything with its fields: numpy or JAX
    leaves) into the port's ``train.gan_step.GANTrainState``: generator
    params and BN stats, feature encoder, critic, and the frozen ED's params
    and stats, each with a strict ``load_state_dict``. The step counter comes
    along. Both Adams start from zero moments at step 0, so a fresh port
    state needs nothing more; the EMA stream, when on, is taken over too."""
    dev = port_state.device
    gen_sd = export_generator({"params": jax_state.gen_params, "batch_stats": jax_state.gen_stats})
    ed_vars = {"params": jax_state.ed_params}
    if jax_state.ed_stats:
        ed_vars["batch_stats"] = jax_state.ed_stats
    pairs = [
        (port_state.generator, gen_sd),
        (port_state.feature_encoder, export_feature_encoder({"params": jax_state.fe_params})),
        (port_state.critic, export_critic({"params": jax_state.critic_params})),
        (port_state.ed, export_ed(ed_vars)),
    ]
    for module, sd in pairs:
        module.load_state_dict({k: v.to(dev) for k, v in to_tensors(sd).items()}, strict=True)
    port_state.step = int(np.asarray(jax_state.step))
    if port_state.ema_params is not None and jax_state.ema_params is not None:
        ema_sd = to_tensors(export_generator(
            {"params": jax_state.ema_params, "batch_stats": jax_state.gen_stats}))
        for name in port_state.ema_params:
            port_state.ema_params[name].copy_(ema_sd[name])


def load_gan_final_pth(path: str, ema: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Optional[np.ndarray]]:
    """A reference-layout ``gan_final.pth`` ({'G': ..., 'E_num': ...}) →
    (generator state dict, feature-encoder state dict, emotion features).
    The emotion features are the training corpus's (4, 6) conditioning
    centroids as numpy, which ``train.gan_loop.train`` saves, or None when
    the file has none (a reference file). ``ema=True`` takes the generator
    from ``G_ema`` (written when training ran with ``ema_decay > 0``) and
    raises KeyError when there is none. Loaded with ``weights_only=True``:
    tensors and containers only, no pickled code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "G" not in ckpt or "E_num" not in ckpt:
        raise ValueError(f"{path}: expected a dict with 'G' and 'E_num' state dicts")
    g_key = "G"
    if ema:
        if "G_ema" not in ckpt:
            raise KeyError(f"{path} has no EMA weights (G_ema); it was trained without ema_decay")
        g_key = "G_ema"
    ef = ckpt.get("emotion_features")
    features = None if ef is None else _np(ef).astype(np.float32)
    return dict(ckpt[g_key]), dict(ckpt["E_num"]), features
