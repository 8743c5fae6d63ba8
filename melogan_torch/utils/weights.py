"""Weight bridge: the JAX package's parameter trees, ``.ckpt`` files and
reference ``gan_final.pth`` files ↔ the port's modules.

``export_*`` and ``convert_*`` are the port's own copies of the numpy-only
mappings in ``melogan_tpu/utils/torch_interop.py``: ``export_*`` maps the
JAX package's parameter trees (numpy arrays or anything ``np.asarray``
takes) to reference-layout torch state dicts, whose names the port's
modules carry, and ``convert_*`` is its inverse. Mapping:

- Linear: ``kernel`` (in, out) ↔ torch ``weight`` (out, in)
- Conv1d: HIO ``kernel`` (k, in, out) ↔ torch ``weight`` (out, in, k)
- ConvTranspose1d: HIO ``kernel`` (k, in, out) ↔ torch ``weight`` (in, out, k)
- BatchNorm1d: scale/bias + batch_stats {mean, var} ↔ weight/bias/running_*
- LayerNorm: scale/bias ↔ weight/bias

A tree or state dict without BatchNorm statistics maps its parameters
alone: that is how Adam's moments, which follow their parameters' layouts,
cross over.

``export_train_payload`` / ``load_train_payload`` carry the port's live
training state to and from the payload of the JAX loop's periodic
``gan_epochNNNN.ckpt`` (``melogan_tpu/train/gan_loop.py:335-353``), Adam
included; ``export_vae_payload`` / ``load_vae_payload`` do the same for the
VAE loop's ``ae_best.ckpt`` (``melogan_tpu/train/vae_loop.py:556-578``).
``read_gan_final`` / ``write_gan_final`` read and write a ``gan_final`` in
either format, by suffix: ``.pth`` (the reference layout) or ``.ckpt`` (the
JAX layout). Convert one into the other with
``python -m melogan_torch.utils.weights convert SRC DST``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from melogan_torch.utils.atomic import atomic_write
from melogan_torch.utils.checkpoint import check_tree, load_checkpoint, save_checkpoint


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


def _exp_bn(p: Dict, s: Optional[Dict], prefix: str, sd: Dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    if s is None:  # a parameters-only tree
        return
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    # torch BatchNorm1d state dicts carry this counter; unused at eval time
    # but required by strict=True loads
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _exp_ln(p: Dict, prefix: str, sd: Dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def export_generator(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX Generator variables → torch state_dict keyed per src/gan/models.py
    (its parameters alone when ``variables`` has no ``batch_stats``)."""
    p, st = variables["params"], variables.get("batch_stats")
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
            None if st is None else st["decoder"][f"TorchBatchNorm_{i}"],
            f"decoder.deconv.{t}",
            sd,
        )
    return sd


def export_vae(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{'params'[, 'batch_stats']} → torch state_dict keyed per
    src/ae/model.py (its parameters alone without ``batch_stats``)."""
    p, st = variables["params"], variables.get("batch_stats")
    sd: Dict[str, np.ndarray] = {}
    for i, t in enumerate((0, 3, 6)):
        _exp_conv1d(p["encoder"][f"Conv1d_{i}"], f"encoder.conv.{t}", sd)
    for i, t in enumerate((1, 4, 7)):
        _exp_bn(
            p["encoder"][f"TorchBatchNorm_{i}"],
            None if st is None else st["encoder"][f"TorchBatchNorm_{i}"],
            f"encoder.conv.{t}",
            sd,
        )
    _exp_linear(p["encoder"]["TorchLinear_0"], "encoder._linear.1", sd)
    _exp_linear(p["fc_mu"], "fc_mu", sd)
    _exp_linear(p["fc_log_var"], "fc_log_var", sd)
    _exp_linear(p["decoder"]["TorchLinear_0"], "decoder.pre.0", sd)
    _exp_linear(p["decoder"]["TorchLinear_1"], "decoder.pre.2", sd)
    for i, t in enumerate((0, 3, 6)):
        _exp_convt1d(p["decoder"][f"ConvTranspose1d_{i}"], f"decoder.deconv.{t}", sd)
    for i, t in enumerate((1, 4)):
        _exp_bn(
            p["decoder"][f"TorchBatchNorm_{i}"],
            None if st is None else st["decoder"][f"TorchBatchNorm_{i}"],
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


# ---------------------------------------------------------------------------
# convert_*: reference-layout state dicts → JAX parameter trees
# ---------------------------------------------------------------------------


def _linear(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _conv1d(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _convt1d(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 0, 1))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn(sd: Mapping, prefix: str) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """(params, stats); stats None in a parameters-only state dict."""
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    if f"{prefix}.running_mean" not in sd:
        return params, None
    return params, {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}


def _ln(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def convert_vae(sd: Mapping) -> Dict[str, Any]:
    """torch VAE state_dict → {'params': ..., 'batch_stats': ...}."""
    params: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    stats: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    for i, t in enumerate((0, 3, 6)):
        params["encoder"][f"Conv1d_{i}"] = _conv1d(sd, f"encoder.conv.{t}")
    for i, t in enumerate((1, 4, 7)):
        p, st = _bn(sd, f"encoder.conv.{t}")
        params["encoder"][f"TorchBatchNorm_{i}"] = p
        stats["encoder"][f"TorchBatchNorm_{i}"] = st
    params["encoder"]["TorchLinear_0"] = _linear(sd, "encoder._linear.1")
    params["fc_mu"] = _linear(sd, "fc_mu")
    params["fc_log_var"] = _linear(sd, "fc_log_var")
    params["decoder"]["TorchLinear_0"] = _linear(sd, "decoder.pre.0")
    params["decoder"]["TorchLinear_1"] = _linear(sd, "decoder.pre.2")
    for i, t in enumerate((0, 3, 6)):
        params["decoder"][f"ConvTranspose1d_{i}"] = _convt1d(sd, f"decoder.deconv.{t}")
    for i, t in enumerate((1, 4)):
        p, st = _bn(sd, f"decoder.deconv.{t}")
        params["decoder"][f"TorchBatchNorm_{i}"] = p
        stats["decoder"][f"TorchBatchNorm_{i}"] = st
    return {"params": params, "batch_stats": stats}


def convert_ed(sd: Mapping, notes_blocks: int = 4, mlp_hidden: int = 2) -> Dict[str, Any]:
    """ED state_dict (ed_model.py names) → {'params'[, 'batch_stats']}."""
    params: Dict[str, Any] = {"classifier": {}}
    stats: Dict[str, Any] = {}
    if any(k.startswith("encoder.") for k in sd):
        enc: Dict[str, Any] = {}
        enc_stats: Dict[str, Any] = {}
        for i in range(notes_blocks):
            p, st = _bn(sd, f"encoder.conv.{i}.net.1")
            enc[f"ConvBlock1D_{i}"] = {"Conv1d_0": _conv1d(sd, f"encoder.conv.{i}.net.0"),
                                       "TorchBatchNorm_0": p}
            enc_stats[f"ConvBlock1D_{i}"] = {"TorchBatchNorm_0": st}
        enc["TorchLinear_0"] = _linear(sd, "encoder.project")
        params["encoder"] = enc
        stats["encoder"] = enc_stats
    for i in range(mlp_hidden):
        params["classifier"][f"TorchLinear_{i}"] = _linear(sd, f"classifier.net.{i * 3}")
    params["classifier"][f"TorchLinear_{mlp_hidden}"] = _linear(sd, "classifier.head")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def convert_generator(sd: Mapping) -> Dict[str, Any]:
    """Generator state_dict → {'params', 'batch_stats'}; ``batch_stats``
    holds empty maps for a parameters-only state dict."""
    params: Dict[str, Any] = {
        "noise_to_latent": {
            "TorchLinear_0": _linear(sd, "noise_to_latent.net.0"),
            "TorchLinear_1": _linear(sd, "noise_to_latent.net.2"),
        },
        "decoder": {
            "TorchLinear_0": _linear(sd, "decoder.pre.0"),
            "TorchLinear_1": _linear(sd, "decoder.pre.2"),
        },
    }
    stats: Dict[str, Any] = {"decoder": {}}
    for i, t in enumerate((0, 3, 6)):
        params["decoder"][f"ConvTranspose1d_{i}"] = _convt1d(sd, f"decoder.deconv.{t}")
    for i, t in enumerate((1, 4)):
        p, st = _bn(sd, f"decoder.deconv.{t}")
        params["decoder"][f"TorchBatchNorm_{i}"] = p
        if st is not None:
            stats["decoder"][f"TorchBatchNorm_{i}"] = st
    return {"params": params, "batch_stats": stats}


def convert_critic(sd: Mapping) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for i, t in enumerate((0, 2, 4)):
        params[f"Conv1d_{i}"] = _conv1d(sd, f"conv.{t}")
    params["TorchLinear_0"] = _linear(sd, "fc.1")
    params["TorchLinear_1"] = _linear(sd, "real_fake")
    return {"params": params}


def _fe_hidden_layers(sd: Mapping) -> int:
    """The feature encoder's hidden Linear count, read off its state dict."""
    return sum(1 for k, v in sd.items()
               if k.startswith("net.") and k.endswith(".weight") and _np(v).ndim == 2) - 1


def convert_feature_encoder(sd: Mapping, hidden_layers: int = 2) -> Dict[str, Any]:
    params: Dict[str, Any] = {"TorchLayerNorm_0": _ln(sd, "net.0")}
    # net: [LayerNorm, (Linear, GELU, Dropout) × hidden, Linear]
    for i in range(hidden_layers):
        params[f"TorchLinear_{i}"] = _linear(sd, f"net.{1 + i * 3}")
    params[f"TorchLinear_{hidden_layers}"] = _linear(sd, f"net.{1 + hidden_layers * 3}")
    return {"params": params}


def convert_gan_final(ckpt: Mapping) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference ``gan_final.pth`` ({'G': ..., 'E_num': ...}) → sampler vars."""
    return convert_generator(ckpt["G"]), convert_feature_encoder(ckpt["E_num"])


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


# ---------------------------------------------------------------------------
# The training state ↔ the JAX loop's periodic checkpoint payload
# ---------------------------------------------------------------------------

# keys of the port's own, which the JAX loop does not read
TORCH_RNG_KEY = "torch_rng"
TORCH_BN_KEY = "torch_num_batches_tracked"


def _state_np(module: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def _adam_to_optax(opt: torch.optim.Adam, groups, convert) -> Dict[str, Any]:
    """optax ``adam``'s state as flax serializes it: ``{"0":
    ScaleByAdamState(count, mu, nu), "1": EmptyState()}``. ``groups`` are
    the modules whose parameters ``opt`` holds, in order; ``convert`` maps
    their moments, one parameters-only state dict per module keyed by the
    module's index, to the tree the JAX optimizer holds."""
    count = 0
    mu: Dict[int, Dict[str, np.ndarray]] = {}
    nu: Dict[int, Dict[str, np.ndarray]] = {}
    for g, module in enumerate(groups):
        mu[g], nu[g] = {}, {}
        for name, p in module.named_parameters():
            st = opt.state.get(p)
            if st:  # torch creates the state at a parameter's first step
                count = int(st["step"])
                mu[g][name] = st["exp_avg"].detach().cpu().numpy()
                nu[g][name] = st["exp_avg_sq"].detach().cpu().numpy()
            else:
                mu[g][name] = nu[g][name] = np.zeros(tuple(p.shape), np.float32)
    return {"0": {"count": np.asarray(count, np.int32), "mu": convert(mu), "nu": convert(nu)},
            "1": {}}


def _gen_params(sd) -> Dict[str, Any]:
    return convert_generator(sd)["params"]


def _fe_params(sd) -> Dict[str, Any]:
    return convert_feature_encoder(sd, _fe_hidden_layers(sd))["params"]


def export_train_payload(state, epoch: int, emotion_features: np.ndarray,
                         g_ema: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The port's ``train.gan_step.GANTrainState`` as the JAX loop's
    periodic checkpoint: ``G`` (params and batch_stats), ``D``, ``E_num``,
    ``opt_G`` (one Adam over (G, feature encoder): its moments are a
    ``{"0": G tree, "1": FE tree}`` pair), ``opt_D``, ``step``, ``epoch``,
    ``emotion_features`` and, with EMA on, ``G_ema`` (``g_ema``: the
    debiased parameters, beside the live BatchNorm statistics) and
    ``ema_raw`` (the raw stream). The ``torch.Generator``'s state and each
    BatchNorm's ``num_batches_tracked`` go under keys of the port's own,
    which JAX ignores. No ``rng``: a JAX run resumed from this file starts
    its own stream."""
    gen_sd = _state_np(state.generator)
    fe_sd = _state_np(state.feature_encoder)
    g = convert_generator(gen_sd)
    payload = {
        "epoch": int(epoch),
        "G": g,
        "D": convert_critic(_state_np(state.critic)),
        "E_num": {"params": _fe_params(fe_sd)},
        "opt_G": _adam_to_optax(state.opt_g, (state.generator, state.feature_encoder),
                                lambda t: {"0": _gen_params(t[0]), "1": _fe_params(t[1])}),
        "opt_D": _adam_to_optax(state.opt_d, (state.critic,),
                                lambda t: convert_critic(t[0])["params"]),
        "step": np.asarray(state.step, np.int32),
        "emotion_features": np.asarray(emotion_features, np.float32),
        TORCH_RNG_KEY: state.rng.get_state().numpy(),
        TORCH_BN_KEY: {k: v for k, v in gen_sd.items() if k.endswith("num_batches_tracked")},
    }
    if state.ema_params is not None:
        payload["ema_raw"] = _gen_params({k: _np(v) for k, v in state.ema_params.items()})
        payload["G_ema"] = {"params": _gen_params({k: _np(v) for k, v in g_ema.items()}),
                            "batch_stats": g["batch_stats"]}
    return payload


def _load_module(module: nn.Module, sd: Mapping[str, Any]) -> None:
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in to_tensors(sd).items()}, strict=True)


def _load_adam(opt: torch.optim.Adam, tree: Mapping, groups, export) -> None:
    """Restore an optax adam state into a torch Adam: every parameter gets
    ``exp_avg``/``exp_avg_sq`` from ``mu``/``nu`` in its torch layout and
    ``step`` from the optimizer-wide ``count``. ``export`` maps the moment
    tree to one parameters-only state dict per module of ``groups``."""
    adam = tree["0"]
    count = int(np.asarray(adam["count"]))
    index = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
    state = {}
    for module, mu, nu in zip(groups, export(adam["mu"]), export(adam["nu"])):
        for name, p in module.named_parameters():
            # load_state_dict moves the moments to the parameter's device and
            # dtype, and keeps ``step`` a CPU scalar as torch's Adam makes it
            state[index[id(p)]] = {"step": torch.tensor(float(count)),
                                   "exp_avg": torch.from_numpy(np.array(mu[name])),
                                   "exp_avg_sq": torch.from_numpy(np.array(nu[name]))}
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})


def load_train_payload(state, raw: Mapping[str, Any], ema_decay: float) -> Tuple[int, Optional[str]]:
    """Restore a periodic checkpoint (the port's or the JAX loop's) into
    ``state`` in place: weights, BatchNorm statistics, both Adams, ``step``
    and the EMA stream; from a port file also the ``torch.Generator`` and
    ``num_batches_tracked``. A file without ``ema_raw`` seeds the stream as
    (1 − d^t)·p, which debiases back to the restored weights. Keys and
    shapes are checked against the state first (a ValueError names the
    key). Returns (the checkpoint's epoch, a note when the file's random
    stream could not be taken over, else None)."""
    want = export_train_payload(state, 0, np.zeros((4, 6), np.float32), g_ema=state.ema_params)
    check_tree({k: want[k] for k in ("G", "D", "E_num", "opt_G", "opt_D")}, raw)
    if "epoch" not in raw:
        raise ValueError("checkpoint lacks key /epoch")
    gen_sd = export_generator(raw["G"])
    gen_sd.update({k: np.asarray(v) for k, v in raw.get(TORCH_BN_KEY, {}).items()})
    _load_module(state.generator, gen_sd)
    _load_module(state.critic, export_critic(raw["D"]))
    _load_module(state.feature_encoder, export_feature_encoder(raw["E_num"]))
    _load_adam(state.opt_g, raw["opt_G"], (state.generator, state.feature_encoder),
               lambda t: (export_generator({"params": t["0"]}), export_feature_encoder({"params": t["1"]})))
    _load_adam(state.opt_d, raw["opt_D"], (state.critic,), lambda t: (export_critic({"params": t}),))
    if "step" in raw:
        state.step = int(np.asarray(raw["step"]))
    if state.ema_params is not None:
        if "ema_raw" in raw:
            check_tree(want["ema_raw"], raw["ema_raw"], "/ema_raw")
            src = to_tensors(export_generator({"params": raw["ema_raw"]}))
        else:
            t = state.step
            corr = np.float32(1.0 - float(ema_decay) ** t if t else 0.0)
            src = {n: p.detach() * torch.tensor(corr) for n, p in state.generator.named_parameters()}
        with torch.no_grad():
            for name, e in state.ema_params.items():
                e.copy_(src[name])
    note = None
    if TORCH_RNG_KEY in raw:
        rng_state = torch.from_numpy(np.array(raw[TORCH_RNG_KEY], np.uint8))
        if rng_state.numel() == state.rng.get_state().numel():
            state.rng.set_state(rng_state)
        else:
            note = (f"the checkpoint's random stream is of another device's generator; "
                    f"the {state.rng.device} generator keeps its seeded stream")
    else:
        note = "the checkpoint carries no torch random stream; the seeded stream goes on"
    return int(np.asarray(raw["epoch"])), note


# ---------------------------------------------------------------------------
# The VAE loop's ae_best.ckpt
# ---------------------------------------------------------------------------


def export_vae_payload(snapshot: Mapping[str, Any]) -> Dict[str, Any]:
    """A snapshot of the port's VAE training state (``train.vae_loop.
    snapshot``) as the JAX loop's ``ae_best.ckpt``: ``epoch``, ``params``,
    ``batch_stats``, ``opt_state``, ``best_val``, ``lr``, ``plateau`` and
    ``stopper``. ``opt_state`` is the tree that JAX's
    ``chain(clip_by_global_norm, inject_hyperparams(adamw))`` state
    serializes to: ``{"0": {}, "1": {count, hyperparams, hyperparams_states,
    inner_state: {"0": {count, mu, nu}, "1": {}, "2": {}}}}``, the moments
    in the parameters' HIO layout. The ``torch.Generator``'s state and each
    BatchNorm's ``num_batches_tracked`` go under keys of the port's own,
    which JAX ignores; there is no ``rng``, so a JAX run resumed from this
    file keeps its own stream."""
    sd = {k: _np(v) for k, v in snapshot["model"].items()}
    opt = snapshot["opt"]
    count = np.asarray(opt["count"], np.int32)
    adam = {"count": count,
            "mu": convert_vae({k: _np(v) for k, v in opt["mu"].items()})["params"],
            "nu": convert_vae({k: _np(v) for k, v in opt["nu"].items()})["params"]}
    inject = {"count": count,
              "hyperparams": {k: np.asarray(v, np.float32) for k, v in opt["hyperparams"].items()},
              "hyperparams_states": {},
              "inner_state": {"0": adam, "1": {}, "2": {}}}
    return {
        "epoch": int(snapshot["epoch"]),
        **convert_vae(sd),
        "opt_state": {"0": {}, "1": inject},
        "best_val": float(snapshot["stopper"]["best"]),
        "lr": float(opt["hyperparams"]["learning_rate"]),
        "plateau": {"best": float(snapshot["plateau"]["best"]),
                    "num_bad_epochs": int(snapshot["plateau"]["num_bad_epochs"])},
        "stopper": {"best": float(snapshot["stopper"]["best"]),
                    "num_bad_epochs": int(snapshot["stopper"]["num_bad_epochs"])},
        TORCH_RNG_KEY: snapshot["rng"].numpy(),
        TORCH_BN_KEY: {k: v for k, v in sd.items() if k.endswith("num_batches_tracked")},
    }


def load_vae_payload(state, raw: Mapping[str, Any]) -> Tuple[int, Optional[str]]:
    """Restore an ``ae_best.ckpt`` (the port's or the JAX loop's) into the
    port's ``train.vae_loop.VAETrainState`` in place: weights, BatchNorm
    statistics, the optimizer's step count, moments and hyperparameters
    (the learning rate among them), and from a port file also the
    ``torch.Generator`` and ``num_batches_tracked``. Keys and shapes are
    checked first (a ValueError names the key). Returns (the file's epoch,
    a note when its random stream could not be taken over, else None).
    The scheduler state (``plateau``, ``stopper``, ``lr``) is the loop's to
    read."""
    from melogan_torch.train.vae_loop import snapshot

    want = export_vae_payload(snapshot(state, 0))
    check_tree({k: want[k] for k in ("params", "batch_stats", "opt_state")}, raw)
    if "epoch" not in raw:
        raise ValueError("checkpoint lacks key /epoch")
    sd = export_vae({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    sd.update({k: np.asarray(v) for k, v in raw.get(TORCH_BN_KEY, {}).items()})
    _load_module(state.model, sd)
    inject = raw["opt_state"]["1"]
    adam = inject["inner_state"]["0"]
    state.opt.load_state_dict({
        "count": int(np.asarray(adam["count"])),
        "mu": to_tensors(export_vae({"params": adam["mu"]})),
        "nu": to_tensors(export_vae({"params": adam["nu"]})),
        "hyperparams": {k: float(np.asarray(v)) for k, v in inject["hyperparams"].items()},
    })
    note = None
    if TORCH_RNG_KEY in raw:
        rng_state = torch.from_numpy(np.array(raw[TORCH_RNG_KEY], np.uint8))
        if rng_state.numel() == state.rng.get_state().numel():
            state.rng.set_state(rng_state)
        else:
            note = (f"the checkpoint's random stream is of another device's generator; "
                    f"the {state.rng.device} generator keeps its seeded stream")
    else:
        note = "the checkpoint carries no torch random stream; the seeded stream goes on"
    return int(np.asarray(raw["epoch"])), note


# ---------------------------------------------------------------------------
# gan_final in either format
# ---------------------------------------------------------------------------


def _is_ckpt(path: str) -> bool:
    return str(path).endswith(".ckpt")


def read_gan_final(path: str) -> Dict[str, Any]:
    """A ``gan_final`` file, ``.ckpt`` (JAX layout) or ``.pth`` (reference
    layout) by suffix, in the reference layout: ``{"G", "E_num"}`` state
    dicts of CPU tensors, plus ``emotion_features`` (numpy) and ``G_ema``
    where the file has them. ``.pth`` files load with
    ``weights_only=True``: tensors and containers only, no pickled code."""
    if _is_ckpt(path):
        tree = load_checkpoint(path)
    else:
        tree = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(tree, dict) or "G" not in tree or "E_num" not in tree:
        raise ValueError(f"{path}: expected a dict with 'G' and 'E_num' state dicts")
    if _is_ckpt(path):
        final = {"G": to_tensors(export_generator(tree["G"])),
                 "E_num": to_tensors(export_feature_encoder(tree["E_num"]))}
        if "G_ema" in tree:
            final["G_ema"] = to_tensors(export_generator(tree["G_ema"]))
    else:
        final = {k: dict(tree[k]) for k in ("G", "E_num", "G_ema") if k in tree}
    ef = tree.get("emotion_features")
    if ef is not None:
        final["emotion_features"] = _np(ef).astype(np.float32)
    return final


def write_gan_final(path: str, final: Mapping[str, Any]) -> str:
    """Write a reference-layout ``gan_final`` dict (see ``read_gan_final``)
    atomically: as the JAX ``gan_final.ckpt`` layout when ``path`` ends in
    ``.ckpt`` (``G``/``G_ema`` as params and batch_stats, ``E_num``,
    ``emotion_features``), else with ``torch.save``."""
    if _is_ckpt(path):
        tree: Dict[str, Any] = {
            "G": convert_generator(final["G"]),
            "E_num": {"params": _fe_params(final["E_num"])},
        }
        if final.get("emotion_features") is not None:
            tree["emotion_features"] = _np(final["emotion_features"]).astype(np.float32)
        if "G_ema" in final:
            tree["G_ema"] = convert_generator(final["G_ema"])
        return save_checkpoint(path, tree)
    pth = {k: to_tensors(final[k]) for k in ("G", "E_num", "G_ema") if k in final}
    if final.get("emotion_features") is not None:
        pth["emotion_features"] = torch.from_numpy(_np(final["emotion_features"]).astype(np.float32))
    return atomic_write(path, lambda f: torch.save(pth, f), mode="wb")


def convert_gan_final_file(src: str, dst: str) -> str:
    """Rewrite a ``gan_final`` in the other format (``.pth`` ↔ ``.ckpt``,
    by suffix). BatchNorm ``num_batches_tracked`` reads as 0 from a
    ``.ckpt``, which has no slot for it."""
    return write_gan_final(dst, read_gan_final(src))


def load_gan_final_full(path: str, ema: bool = False
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, Any]]:
    """A ``gan_final`` (``.ckpt`` or ``.pth``) → (generator state dict,
    feature-encoder state dict, extras). ``extras["emotion_features"]`` is
    the training corpus's (4, 6) conditioning centroids, or None for a file
    without them (a reference file). ``ema=True`` takes the generator from
    ``G_ema`` (written when training ran with ``ema_decay > 0``) and raises
    KeyError when there is none."""
    final = read_gan_final(path)
    g_key = "G"
    if ema:
        if "G_ema" not in final:
            raise KeyError(
                f"{path} has no EMA weights (G_ema); it was trained without "
                "ema_decay — rerun training with --ema or load without ema"
            )
        g_key = "G_ema"
    return final[g_key], final["E_num"], {"emotion_features": final.get("emotion_features")}


def load_gan_final(path: str, ema: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(generator state dict, feature-encoder state dict) of a ``gan_final``."""
    gen_sd, fe_sd, _ = load_gan_final_full(path, ema=ema)
    return gen_sd, fe_sd


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m melogan_torch.utils.weights",
        description="Rewrite a gan_final file in the other format: .pth (reference layout) <-> .ckpt (JAX layout)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    conv = sub.add_parser("convert", help="convert SRC to DST, formats by suffix")
    conv.add_argument("src")
    conv.add_argument("dst")
    args = ap.parse_args(argv)
    print(convert_gan_final_file(args.src, args.dst))


if __name__ == "__main__":
    main()
