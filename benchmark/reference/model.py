"""Plain PyTorch reference of Melo-GAN's models, written from the published
description (kaushik87599/Melo-GAN: src/gan/models.py, src/gan/feature_encoder.py,
src/emotion_discriminator/ed_model.py, config/gan_config.yaml, config/ed_config.yaml).

Functional: every model is a function of a parameter dict in the upstream
state-dict layout (the names a reference ``gan_final.pth`` or ``ed_best.pth``
holds), computed with ``torch.nn.functional`` in the dtype of its inputs
(float64 in the benchmark), on (B, C, L) for the convolutions. Nothing here
imports the program under test.

``mode`` says how every product operand is rounded before its exact product
(forward and, through the gradient, every backward product at any derivative
order): ``"none"`` (the f32 configuration's reference: no rounding),
``"bf16"`` (the bf16 configuration: bf16 operands, sums in full precision),
and the two controls one precision below: ``"tf32"`` (10-bit mantissas) and
``"fp8"`` (e4m3 with one scale a tensor, its largest magnitude at 448).
LayerNorm, BatchNorm, activations, losses and Adam are never rounded.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EMOTIONS = ("happy", "sad", "angry", "calm")
# the hand-tuned per-emotion numeric features of the upstream app.py:55-61
EMOTION_FEATURES = (
    (1.0, 1.0, 0.8, 0.8, 0.5, 0.5),
    (-1.0, -1.0, -0.5, -0.5, -0.5, -0.5),
    (1.0, -1.0, 1.0, 1.0, -0.8, 0.8),
    (-1.0, 1.0, -0.8, -0.8, 0.5, -0.5),
)
FEATURE_JITTER_STD = 0.15
BN_EPS = 1e-5
LN_EPS = 1e-5
LEAK = 0.2
DECODER_WIDTHS = (256, 128, 64)  # the decoder's fixed channels before note_dim
PRENET_HIDDEN = 512
CRITIC_WIDTHS = (64, 128, 256)
CRITIC_EMB = 256
ED_FIRST_WIDTH = 64
MODES = ("none", "bf16", "tf32", "fp8")
FP8_MAX = 448.0


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` with its values rounded as ``mode`` rounds a product operand."""
    if mode == "none":
        return x
    if mode == "bf16":
        return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)
    if mode == "tf32":
        bits = x.to(torch.float32).view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF  # nearest even at 10 mantissa bits
        return bits.view(torch.float32).to(x.dtype)
    if mode == "fp8":
        amax = x.detach().abs().max()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return ((x / scale).to(torch.float32).to(torch.float8_e4m3fn).to(x.dtype)) * scale
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


class _Round(torch.autograd.Function):
    """Forward rounds; the gradient passes through as ``_RoundGrad``, so a
    derivative of that gradient is rounded in turn."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return round_to(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _RoundGrad.apply(g, ctx.mode), None


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient is rounded (a cotangent enters
    the backward products rounded)."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.mode), None


def product(fn, x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``fn(x, w)`` (a bias-free linear map) on operands rounded by ``mode``."""
    if mode == "none":
        return fn(x, w)
    return _RoundGrad.apply(fn(_Round.apply(x, mode), _Round.apply(w, mode)), mode)


def linear(p, name: str, x: torch.Tensor, mode: str) -> torch.Tensor:
    return product(F.linear, x, p[name + ".weight"], mode) + p[name + ".bias"]


def conv1d(p, name: str, x: torch.Tensor, stride: int, padding: int, mode: str) -> torch.Tensor:
    y = product(lambda a, k: F.conv1d(a, k, None, stride, padding), x, p[name + ".weight"], mode)
    return y + p[name + ".bias"][:, None]


def conv_transpose1d(p, name: str, x: torch.Tensor, mode: str) -> torch.Tensor:
    """k5, stride 2, padding 2, output padding 1: the length doubles."""
    y = product(lambda a, k: F.conv_transpose1d(a, k, None, 2, 2, 1), x, p[name + ".weight"], mode)
    return y + p[name + ".bias"][:, None]


def batch_norm(p, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Over (B, C, L): batch statistics (biased variance) in train mode,
    the running ones in eval mode."""
    if train:
        mean = x.mean(dim=(0, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2), keepdim=True)
    else:
        mean = p[name + ".running_mean"][None, :, None]
        var = p[name + ".running_var"][None, :, None]
    xhat = (x - mean) / torch.sqrt(var + BN_EPS)
    return xhat * p[name + ".weight"][None, :, None] + p[name + ".bias"][None, :, None]


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------

def _fe_names(gan) -> Tuple[List[str], str]:
    hidden = [f"net.{1 + 3 * i}" for i in range(len(gan["ENCODER_HIDDEN"]))]
    return hidden, f"net.{1 + 3 * len(gan['ENCODER_HIDDEN'])}"


def _ed_names(ed) -> Tuple[List[str], str]:
    return [f"classifier.net.{3 * i}" for i in range(len(ed["mlp_hidden"]))], "classifier.head"


def ed_blocks(ed) -> List[Tuple[int, int, int]]:
    """(Cin, Cout, K) of each conv block of the notes encoder."""
    out, cin, ch = [], ed["note_dim"], ED_FIRST_WIDTH
    for i in range(ed["notes_blocks"]):
        out.append((cin, ch, 5 if i == 0 else 3))
        cin, ch = ch, min(ch * 2, ed["notes_hidden"])
    return out


def param_shapes(gan, ed) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], str, int]]]:
    """For each model (``gen``, ``fe``, ``critic``, ``ed``): name → (shape,
    role, fan-in), in the upstream layout. Roles: ``weight``, ``convt``
    (a transposed conv's (Cin, Cout, K) weight), ``bias``, ``norm_weight``,
    ``norm_bias``, ``running_mean``, ``running_var``, ``count``."""
    def lin(d, name, i, o):
        d[name + ".weight"] = ((o, i), "weight", i)
        d[name + ".bias"] = ((o,), "bias", i)

    def norm(d, name, c, running):
        d[name + ".weight"] = ((c,), "norm_weight", c)
        d[name + ".bias"] = ((c,), "norm_bias", c)
        if running:
            d[name + ".running_mean"] = ((c,), "running_mean", c)
            d[name + ".running_var"] = ((c,), "running_var", c)
            d[name + ".num_batches_tracked"] = ((), "count", 1)

    emb = gan["ENCODER_OUT_DIM"] if gan["USE_NUMERIC_ENCODER"] else 0
    in_dim = gan["NOISE_DIM"] + emb + (gan["LATENT_DIM"] if gan["INTEGRATION_MODE"] == "conditioning" else 0)
    reduced = max(1, gan["MAX_NOTES"] // 8)
    gen: Dict = {}
    lin(gen, "noise_to_latent.net.0", in_dim, gan["GEN_HIDDEN"])
    lin(gen, "noise_to_latent.net.2", gan["GEN_HIDDEN"], gan["LATENT_DIM"])
    lin(gen, "decoder.pre.0", gan["LATENT_DIM"], PRENET_HIDDEN)
    lin(gen, "decoder.pre.2", PRENET_HIDDEN, DECODER_WIDTHS[0] * reduced)
    widths = DECODER_WIDTHS + (gan["NOTE_DIM"],)
    for j, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        name = f"decoder.deconv.{3 * j}"
        gen[name + ".weight"] = ((cin, cout, 5), "convt", cin * 5 // 2)
        gen[name + ".bias"] = ((cout,), "bias", cin * 5 // 2)
        if j < 2:
            norm(gen, f"decoder.deconv.{3 * j + 1}", cout, True)

    fe: Dict = {}
    norm(fe, "net.0", gan["NUMERIC_INPUT_DIM"], False)
    hidden, out = _fe_names(gan)
    d = gan["NUMERIC_INPUT_DIM"]
    for name, h in zip(hidden, gan["ENCODER_HIDDEN"]):
        lin(fe, name, d, h)
        d = h
    lin(fe, out, d, gan["ENCODER_OUT_DIM"])

    critic: Dict = {}
    cin = gan["NOTE_DIM"]
    for j, ch in enumerate(CRITIC_WIDTHS):
        critic[f"conv.{2 * j}.weight"] = ((ch, cin, 5), "weight", cin * 5)
        critic[f"conv.{2 * j}.bias"] = ((ch,), "bias", cin * 5)
        cin = ch
    lin(critic, "fc.1", cin, CRITIC_EMB)
    lin(critic, "real_fake", CRITIC_EMB + emb, 1)

    edp: Dict = {}
    for i, (ci, co, k) in enumerate(ed_blocks(ed)):
        edp[f"encoder.conv.{i}.net.0.weight"] = ((co, ci, k), "weight", ci * k)
        edp[f"encoder.conv.{i}.net.0.bias"] = ((co,), "bias", ci * k)
        norm(edp, f"encoder.conv.{i}.net.1", co, True)
    last = ed_blocks(ed)[-1][1]
    lin(edp, "encoder.project", last, ed["notes_hidden"])
    hidden, head = _ed_names(ed)
    d = ed["notes_hidden"]
    for name, h in zip(hidden, ed["mlp_hidden"]):
        lin(edp, name, d, h)
        d = h
    lin(edp, head, d, ed["n_classes"])
    return {"gen": gen, "fe": fe, "critic": critic, "ed": edp}


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def feature_encoder(p, gan, x: torch.Tensor, mode: str,
                    keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """LayerNorm → (Linear, GELU, Dropout) per hidden width → Linear.
    ``keep``: the train-mode dropout keep masks; None in eval mode."""
    x = F.layer_norm(x, (x.shape[-1],), p["net.0.weight"], p["net.0.bias"], LN_EPS)
    hidden, out = _fe_names(gan)
    for i, name in enumerate(hidden):
        x = dropout(F.gelu(linear(p, name, x, mode)), None if keep is None else keep[i],
                    gan["ENCODER_DROPOUT"])
    return linear(p, out, x, mode)


def generator(p, gan, noise: torch.Tensor, emb: torch.Tensor, mode: str, train: bool) -> torch.Tensor:
    """[noise, embedding] → NoiseToLatent → pre-net → three transposed convs
    (BatchNorm and ReLU after the first two) → (B, max_notes, note_dim)."""
    z = torch.cat([noise, emb], dim=1)
    latent = linear(p, "noise_to_latent.net.2", torch.relu(linear(p, "noise_to_latent.net.0", z, mode)), mode)
    y = torch.relu(linear(p, "decoder.pre.0", latent, mode))
    y = torch.relu(linear(p, "decoder.pre.2", y, mode))
    y = y.reshape(y.shape[0], DECODER_WIDTHS[0], -1)
    for j in range(2):
        y = conv_transpose1d(p, f"decoder.deconv.{3 * j}", y, mode)
        y = torch.relu(batch_norm(p, f"decoder.deconv.{3 * j + 1}", y, train))
    y = conv_transpose1d(p, "decoder.deconv.6", y, mode)
    n = gan["MAX_NOTES"]
    y = y[..., :n] if y.shape[-1] >= n else F.pad(y, (0, n - y.shape[-1]))
    return y.transpose(1, 2)


def critic(p, notes: torch.Tensor, emb: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, L, C) notes → three k5 s2 convs with LeakyReLU(0.2) → mean over
    L → Linear + LeakyReLU → [·, embedding] → score (B,)."""
    x = notes.transpose(1, 2)
    for j in range(len(CRITIC_WIDTHS)):
        x = F.leaky_relu(conv1d(p, f"conv.{2 * j}", x, 2, 2, mode), LEAK)
    x = F.leaky_relu(linear(p, "fc.1", x.mean(dim=2), mode), LEAK)
    return linear(p, "real_fake", torch.cat([x, emb], dim=1), mode).squeeze(1)


def emotion_discriminator(p, ed, notes: torch.Tensor, mode: str) -> torch.Tensor:
    """Eval mode: conv blocks (Conv1d, BatchNorm, GELU) → mean over L →
    projection → MLP classifier → logits (B, n_classes)."""
    x = notes.transpose(1, 2)
    for i, (_, _, k) in enumerate(ed_blocks(ed)):
        x = conv1d(p, f"encoder.conv.{i}.net.0", x, 1, k // 2, mode)
        x = F.gelu(batch_norm(p, f"encoder.conv.{i}.net.1", x, False))
    x = linear(p, "encoder.project", x.mean(dim=2), mode)
    hidden, head = _ed_names(ed)
    for name in hidden:
        x = F.gelu(linear(p, name, x, mode))
    return linear(p, head, x, mode)
