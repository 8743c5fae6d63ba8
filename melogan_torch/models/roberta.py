"""RoBERTa sequence classifier (the go_emotions text backend) in torch.

The port of ``melogan_tpu/models/roberta.py``. The reference classifies text
with an HF pipeline around ``SamLowe/roberta-base-go_emotions`` (reference
textClassification/text.py:48-58, 96-104). This module computes that model
as ``nn.Module``s that carry HF's parameter names
(``roberta.embeddings.*``, ``roberta.encoder.layer.{i}.attention.self.query.*``,
…, ``classifier.dense.*``, ``classifier.out_proj.*``), so an HF state dict
loads with ``strict=True``. The numerics are the JAX module's:

- learned position ids offset past the pad token (``pad + cumsum(mask)·mask``);
- post-LayerNorm residuals with the config's eps; erf GELU;
- the additive mask bias ``(1 − mask)·finfo(f32).min``, softmax in f32;
- the tanh-pooled ``<s>`` token into the classification head.

Attention is a plain ``matmul`` + ``softmax``, as in JAX: no fused attention
kernel. Checkpoints load from a local directory (``model.safetensors``
through the port's own reader, or ``pytorch_model.bin``); nothing here
downloads, and neither ``transformers`` nor ``safetensors`` is imported.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from melogan_torch.device import resolve_device


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    num_labels: int = 28

    @classmethod
    def from_json(cls, path: str) -> "RobertaConfig":
        with open(path) as f:
            raw = json.load(f)
        n_labels = len(raw.get("id2label", {})) or raw.get("num_labels", 28)
        return cls(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            num_hidden_layers=raw["num_hidden_layers"],
            num_attention_heads=raw["num_attention_heads"],
            intermediate_size=raw["intermediate_size"],
            max_position_embeddings=raw["max_position_embeddings"],
            type_vocab_size=raw.get("type_vocab_size", 1),
            layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
            pad_token_id=raw.get("pad_token_id", 1),
            num_labels=n_labels,
        )


def position_ids_from_input_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """HF ``create_position_ids_from_input_ids``: positions count non-pad
    tokens, offset past the pad id; pad positions get ``pad_token_id``."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


# ---------------------------------------------------------------------------
# The model, under HF's module names
# ---------------------------------------------------------------------------


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.pad_token_id = cfg.pad_token_id
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        pos = position_ids_from_input_ids(input_ids, self.pad_token_id)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, bias):
        b, t, hidden = x.shape
        dh = hidden // self.heads

        def split(y):  # (B, T, H) → (B, h, T, dh)
            return y.view(b, t, self.heads, dh).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, hidden)


class _DenseLayerNorm(nn.Module):
    """``dense`` then the residual, then ``LayerNorm`` (post-LN)."""

    def __init__(self, d_in: int, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _DenseLayerNorm(cfg.hidden_size, cfg)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class _Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseLayerNorm(cfg.intermediate_size, cfg)

    def forward(self, x, bias):
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class _Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class _Roberta(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)


class _ClassificationHead(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, x):
        return self.out_proj(torch.tanh(self.dense(x[:, 0])))


class RobertaForSequenceClassification(nn.Module):
    """(B, T) token ids + (B, T) {0,1} mask → (B, num_labels) logits."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.roberta = _Roberta(cfg)
        self.classifier = _ClassificationHead(cfg)

    def forward(self, input_ids, attention_mask):
        x = self.roberta.embeddings(input_ids)
        # additive attention bias: 0 for real tokens, the most negative f32 for padding
        bias = (1.0 - attention_mask.to(x.dtype))[:, None, None, :] * torch.finfo(x.dtype).min
        return self.classifier(self.roberta.encoder(x, bias))


# ---------------------------------------------------------------------------
# Checkpoints (offline, a local directory)
# ---------------------------------------------------------------------------

# buffers that HF checkpoints of some versions store; the module derives them
_HF_BUFFERS = ("roberta.embeddings.position_ids", "roberta.embeddings.token_type_ids")


def load_hf_checkpoint(model_dir: str) -> Dict[str, torch.Tensor]:
    """The HF ``RobertaForSequenceClassification`` state dict of a local
    directory, as float32 tensors under this module's names:
    ``model.safetensors`` (read by ``utils/safetensors.py``) is preferred,
    ``pytorch_model.bin`` (``torch.load(weights_only=True)``) next. Names
    without the ``roberta.`` prefix (older checkpoints) get it; the position
    and token-type id buffers some checkpoints carry are dropped."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from melogan_torch.utils.safetensors import load_file

        sd = {k: torch.from_numpy(v) for k, v in load_file(st_path).items()}
    elif os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {model_dir}")
    out = {}
    for k, v in sd.items():
        name = k if k.startswith(("roberta.", "classifier.")) else f"roberta.{k}"
        if name not in _HF_BUFFERS:
            out[name] = v.float()
    return out


def load_id2label(model_dir: str) -> Dict[int, str]:
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    id2label = raw.get("id2label")
    if not id2label:
        raise ValueError(f"{model_dir}/config.json has no id2label map")
    return {int(k): v for k, v in id2label.items()}


# ---------------------------------------------------------------------------
# Inference pipeline (tokenize → padded bucket → forward on the device)
# ---------------------------------------------------------------------------

_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bucket_len(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class RobertaTextClassifier:
    """End-to-end text classifier over a local HF checkpoint directory, on
    ``device`` (the GPU by default).

    Tokenization is host-side through the framework's own byte-level BPE /
    WordLevel implementation (``models/tokenizer.py``); sequence lengths are
    padded to a small set of buckets, as the JAX classifier pads them."""

    def __init__(self, model_dir: str, device="cuda"):
        from melogan_torch.models.tokenizer import load_tokenizer

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products as JAX's: no TF32 in cuBLAS
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = RobertaConfig.from_json(os.path.join(model_dir, "config.json"))
        self.model = RobertaForSequenceClassification(self.cfg)
        self.model.load_state_dict(load_hf_checkpoint(model_dir), strict=True)
        self.model.to(self.device).eval()
        self.id2label = load_id2label(model_dir)
        self.tokenizer = load_tokenizer(model_dir)
        # position table must cover pad_token_id + seq_len (HF offsets past pad)
        self._max_len = min(
            _BUCKETS[-1], self.cfg.max_position_embeddings - self.cfg.pad_token_id - 1
        )

    def encode(self, texts):
        """(ids, mask) int64 arrays of ``texts``, padded to one bucket."""
        enc = self.tokenizer(
            list(texts), truncation=True, max_length=self._max_len, padding=False
        )["input_ids"]
        tlen = min(_bucket_len(max(len(x) for x in enc)), self._max_len)
        ids = np.full((len(enc), tlen), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((len(enc), tlen), np.int64)
        for i, row in enumerate(enc):
            ids[i, : len(row)] = row[:tlen]
            mask[i, : len(row)] = 1
        return ids, mask

    def logits(self, texts) -> np.ndarray:
        ids, mask = self.encode(texts)
        with torch.inference_mode():
            out = self.model(torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))
        return out.cpu().numpy()

    def top_label(self, text: str) -> str:
        logits = self.logits([str(text)])[0]
        return self.id2label[int(np.argmax(logits))]

    def __call__(self, text: str):
        # HF-pipeline-compatible result shape (top_k=1)
        logits = self.logits([str(text)])[0]
        # go_emotions is multi-label: HF applies sigmoid; argmax is unaffected
        probs = 1.0 / (1.0 + np.exp(-logits))
        i = int(np.argmax(probs))
        return [[{"label": self.id2label[i], "score": float(probs[i])}]]
