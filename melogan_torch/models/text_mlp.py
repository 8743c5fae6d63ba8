"""The framework's own text-emotion classifier: own-BPE tokens → embedding →
masked mean-pool, hashed char-n-grams and lexicon hits → MLP → go_emotions
category logits.

The port of ``melogan_tpu/models/text_mlp.py``. The features (BPE ids,
char-3–5-gram counts, lexicon hits) are computed on the host in numpy, as
there; the model, its training and its forward run in torch on the given
device, the GPU by default.

- ``TextEmotionMLP`` carries flax's layer names (``embed``, ``ngram_proj``,
  ``fc1``, ``head``) and flax's tanh-approximated GELU.
- The masked mean-pool of the embedding is a product of the (batch,
  vocabulary) matrix of masked token counts with the embedding table. Its
  gradient is then a matrix product, which repeats bit for bit on the card,
  where a gather's backward adds with atomics in no fixed order.
- ``TextMLPClassifier.save``/``load`` write and read the JAX package's cache
  file (flax msgpack, ``meta`` as uint8 JSON, ``params`` in the flax layout)
  with the port's codec, so a cache written by either package loads in the
  other.
- ``train_text_classifier`` is the JAX recipe: the same data order from
  numpy, the hierarchical category + 4-emotion loss, AdamW with decoupled
  weight decay on every parameter (optax ``adamw``'s rule).

Same output contract as every backend, ``clf(text) -> [[{"label",
"score"}]]``; the 28→4 music map is applied downstream
(``models/text_emotion.py``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from melogan_torch.device import resolve_device

MAX_LEN = 32
CATEGORIES: Tuple[str, ...] = (
    "joy", "amusement", "excitement", "love", "optimism", "gratitude",
    "surprise", "approval", "sadness", "disappointment", "grief", "disgust",
    "remorse", "anger", "annoyance", "fear", "nervousness", "disapproval",
    "neutral", "caring", "relief", "pride", "admiration", "realization",
    "curiosity", "desire", "confusion",
)  # 27 trained categories (go_emotions minus the unused 'embarrassment' row:
# the corpus covers exactly the categories the reference's 28→4 map needs)

N_NGRAM_BUCKETS = 4096
EMBED_DIM, NGRAM_DIM, HIDDEN_DIM = 64, 128, 256


def _char_ngram_counts(texts: Sequence[str], n_buckets: int = N_NGRAM_BUCKETS) -> np.ndarray:
    """Hashed bag of character 3–5-grams (fastText-style subword features),
    ``log1p`` of the counts. Hashing is zlib.crc32, deterministic across
    processes (Python's ``hash`` is salted), so a cached classifier stays
    valid."""
    import zlib

    out = np.zeros((len(texts), n_buckets), np.float32)
    for i, t in enumerate(texts):
        s = " " + " ".join(str(t).lower().split()) + " "
        b = s.encode("utf-8", "ignore")
        for n in (3, 4, 5):
            for j in range(len(b) - n + 1):
                out[i, zlib.crc32(b[j:j + n]) % n_buckets] += 1.0
    return np.log1p(out)


def _lexicon_features(texts: Sequence[str], categories: Sequence[str]) -> np.ndarray:
    from melogan_torch.models.text_emotion import LexiconClassifier

    lex = LexiconClassifier()
    out = np.zeros((len(texts), len(categories)), np.float32)
    for i, t in enumerate(texts):
        s = lex.scores(t)
        out[i] = [float(s.get(c, 0)) for c in categories]
    return out


def _encode_batch(bpe, texts: Sequence[str], max_len: int = MAX_LEN):
    ids = np.full((len(texts), max_len), bpe.pad_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    for i, t in enumerate(texts):
        row = bpe.encode(t, max_length=max_len)[:max_len]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1.0
    return ids, mask


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, scale by 1/(1 − rate)."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TextEmotionMLP(nn.Module):
    """Three feature channels: pooled own-BPE embeddings, hashed
    char-3–5-gram counts and the lexicon's per-category keyword hits, then
    a one-hidden-layer MLP. Dropout acts in training only, with the masks
    drawn from the generator passed to ``forward``."""

    def __init__(self, vocab_size: int, n_classes: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = float(dropout)
        self.embed = nn.Embedding(vocab_size, EMBED_DIM)
        self.ngram_proj = nn.Linear(N_NGRAM_BUCKETS, NGRAM_DIM)
        # the lexicon channel has one count a category
        self.fc1 = nn.Linear(EMBED_DIM + NGRAM_DIM + n_classes, HIDDEN_DIM)
        self.head = nn.Linear(HIDDEN_DIM, n_classes)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's defaults from ``gen``: the embedding N(0, 1/64) (variance
        scaling over its 64 features), each kernel LeCun normal (truncated
        at ±2σ, σ = 1/√fan_in corrected for the truncation), biases 0."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, EMBED_DIM ** -0.5, generator=gen)
            for lin in (self.ngram_proj, self.fc1, self.head):
                std = (1.0 / lin.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                lin.bias.zero_()

    def forward(self, ids, mask, lex, ngrams, gen: Optional[torch.Generator] = None):
        w = self.embed.weight
        # masked token counts per vocabulary entry: sums of 0s and 1s, exact
        # in any order, so the scatter repeats bit for bit
        counts = torch.zeros(ids.shape[0], w.shape[0], dtype=w.dtype, device=w.device)
        counts.scatter_add_(1, ids.long(), mask.to(w.dtype))
        denom = mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
        pooled = (counts @ w) / denom
        ng = F.gelu(self.ngram_proj(ngrams), approximate="tanh")
        feats = torch.cat([pooled, ng, lex], dim=-1)
        drop = self.training and self.dropout > 0.0
        if drop:
            feats = _dropout(feats, self.dropout, gen)
        h = F.gelu(self.fc1(feats), approximate="tanh")
        if drop:
            h = _dropout(h, self.dropout, gen)
        return self.head(h)


class TextMLPClassifier:
    """Backend-interface wrapper (same call contract as LexiconClassifier:
    ``clf(text) -> [[{"label", "score"}]]``). ``state`` is the model's state
    dict (arrays or tensors); the forward runs on ``device``."""

    def __init__(self, bpe, state: Mapping[str, object], categories: Sequence[str] = CATEGORIES,
                 fingerprint: Optional[str] = None, device="cuda"):
        self.bpe = bpe
        self.categories = tuple(categories)
        self.fingerprint = fingerprint
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products as JAX's: no TF32 in cuBLAS
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = TextEmotionMLP(len(bpe.vocab), len(self.categories))
        self.model.load_state_dict({k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                                    for k, v in state.items()})
        self.model.to(self.device).eval()

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()}

    def features(self, texts: Sequence[str]):
        """(ids, mask, lexicon hits, n-gram counts) of ``texts``, numpy."""
        texts = [str(t) for t in texts]
        ids, mask = _encode_batch(self.bpe, texts)
        return ids, mask, _lexicon_features(texts, self.categories), _char_ngram_counts(texts)

    def _logits(self, feats) -> np.ndarray:
        with torch.inference_mode():
            out = self.model(*(torch.from_numpy(a).to(self.device) for a in feats))
        return out.cpu().numpy()

    def logits(self, texts: Sequence[str]) -> np.ndarray:
        return self._logits(self.features(texts))

    def top_label(self, text: str) -> Tuple[str, float]:
        """Decision rule: softmax(model logits) + keyword-hit counts.

        Counts are integers and probabilities sum to 1, so any category with
        a unique keyword hit outranks every no-hit category, and ties between
        equally-hit categories (and all keyword-free text) are decided by the
        trained model."""
        feats = self.features([text])
        lex = feats[2]
        logits = self._logits(feats)[0]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        score = probs + lex[0]
        k = int(score.argmax())
        return self.categories[k], float(probs[k])

    def __call__(self, text: str):
        label, score = self.top_label(text)
        return [[{"label": label, "score": score}]]

    # -- persistence: the JAX package's cache file ---------------------------
    def save(self, path: str) -> None:
        from melogan_torch.utils.atomic import atomic_write
        from melogan_torch.utils.checkpoint import msgpack_serialize
        from melogan_torch.utils.weights import text_mlp_flax_from_state

        meta = {
            "vocab": self.bpe.vocab,
            "merges": [list(m) for m in self.bpe.ranks],
            "categories": list(self.categories),
            "add_prefix_space": self.bpe.add_prefix_space,
            "fingerprint": self.fingerprint,
        }
        blob = msgpack_serialize(
            {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8).copy(),
             "params": text_mlp_flax_from_state(self.state_dict())}
        )
        atomic_write(path, lambda f: f.write(blob), mode="wb")

    @classmethod
    def load(cls, path: str, device="cuda") -> "TextMLPClassifier":
        from melogan_torch.models.tokenizer import ByteLevelBPE
        from melogan_torch.utils.checkpoint import msgpack_restore
        from melogan_torch.utils.weights import text_mlp_state_from_flax

        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        meta = json.loads(bytes(np.asarray(tree["meta"], np.uint8)).decode())
        merges = sorted(meta["merges"], key=lambda m: meta["vocab"][m[0] + m[1]])
        bpe = ByteLevelBPE(
            meta["vocab"], [tuple(m) for m in merges],
            add_prefix_space=meta.get("add_prefix_space", False),
        )
        return cls(bpe, text_mlp_state_from_flax(tree["params"]), meta["categories"],
                   fingerprint=meta.get("fingerprint"), device=device)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def training_data(seed: int = 0, vocab_size: int = 600):
    """The BPE trained on the training split, and the split's features and
    labels as numpy arrays: ids, mask, lex, ngrams, y (category), y4 (music
    emotion), group_mask ((4, n_categories) membership)."""
    from melogan_torch import EMOTIONS
    from melogan_torch.data.text_corpus import generate_text_corpus
    from melogan_torch.models.text_emotion import DEFAULT_EMOTION, TEXT_MODEL_TO_MY_EMOTIONS
    from melogan_torch.models.tokenizer import train_bpe

    texts, labels = generate_text_corpus("train", seed=seed)
    cats = list(CATEGORIES)
    missing = set(labels) - set(cats)
    if missing:
        raise ValueError(f"corpus categories missing from CATEGORIES: {missing}")
    bpe = train_bpe(texts, vocab_size=vocab_size)
    ids, mask = _encode_batch(bpe, texts)
    y = np.asarray([cats.index(l) for l in labels], np.int64)
    group_of_cat = np.asarray(
        [EMOTIONS.index(TEXT_MODEL_TO_MY_EMOTIONS.get(c, DEFAULT_EMOTION)) for c in cats], np.int64)
    data = {
        "ids": ids, "mask": mask, "lex": _lexicon_features(texts, cats),
        "ngrams": _char_ngram_counts(texts), "y": y, "y4": group_of_cat[y],
        "group_mask": (group_of_cat[None, :] == np.arange(len(EMOTIONS))[:, None]).astype(np.float32),
    }
    return bpe, data


def data_order(n: int, epochs: int, batch_size: int, seed: int) -> np.ndarray:
    """(epochs, batches, batch) row indices: one permutation an epoch from
    ``default_rng(seed + 1)``, the last partial batch dropped (JAX's order)."""
    bs = min(batch_size, n)
    n_batches = n // bs
    rng = np.random.default_rng(seed + 1)
    return np.stack([rng.permutation(n)[: n_batches * bs].reshape(n_batches, bs)
                     for _ in range(epochs)])


def hierarchical_loss(logits, y, y4, group_mask, ce4_weight: float = 1.0,
                      label_smooth: float = 0.0) -> torch.Tensor:
    """Category cross-entropy plus ``ce4_weight`` × the 4-music-emotion
    marginal cross-entropy (log-sum-exp of each group's logits), as
    ``text_mlp.py``'s JAX loss. The label terms are one-hot products, so no
    scatter enters the backward."""
    n_cats = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    soft = F.one_hot(y, n_cats).to(logits.dtype) * (1.0 - label_smooth) + label_smooth / n_cats
    ce_cat = -(soft * logp).sum(dim=-1).mean()
    grouped = torch.logsumexp(logits[:, None, :] + torch.log(group_mask)[None], dim=-1)
    logp4 = grouped - torch.logsumexp(logits, dim=-1, keepdim=True)
    ce_4 = -(F.one_hot(y4, group_mask.shape[0]).to(logits.dtype) * logp4).sum(dim=-1).mean()
    return ce_cat + ce4_weight * ce_4


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """optax ``adamw(lr, weight_decay=1e-4)``: b1 0.9, b2 0.999, eps 1e-8,
    the decay decoupled and applied to every parameter. The fused
    implementation: one elementwise pass a parameter (on the CPU half the
    step time of the per-tensor loop), deterministic on the card."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, fused=True)


def train_step(model: TextEmotionMLP, opt: torch.optim.Optimizer, batch: Mapping[str, torch.Tensor],
               group_mask: torch.Tensor, ce4_weight: float = 1.0, label_smooth: float = 0.0,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """One AdamW step on ``batch`` (ids, mask, lex, ngrams, y, y4 tensors);
    returns the loss, detached, on the device (no host sync)."""
    logits = model(batch["ids"], batch["mask"], batch["lex"], batch["ngrams"], gen=gen)
    loss = hierarchical_loss(logits, batch["y"], batch["y4"], group_mask, ce4_weight, label_smooth)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_text_classifier(
    seed: int = 0,
    vocab_size: int = 600,
    epochs: int = 150,
    batch_size: int = 64,
    lr: float = 2e-3,
    verbose: bool = False,
    dropout: float = 0.0,
    label_smooth: float = 0.0,
    ce4_weight: float = 1.0,
    device="cuda",
    stats: Optional[Dict[str, object]] = None,
) -> TextMLPClassifier:
    """Train the offline text classifier on the framework corpus, on
    ``device``. Deterministic: the data order from numpy, the initial
    weights from ``torch.Generator().manual_seed(seed)`` on the host, the
    dropout masks from a device generator seeded ``seed + 2``. ``stats``,
    when given, receives ``epoch_losses`` (the mean loss of each epoch),
    ``steps``, ``data_s`` (host seconds to train the BPE and build the
    features) and ``loop_s`` (seconds of the training loop, ending in a
    device→host copy of the losses)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    bpe, data = training_data(seed, vocab_size)
    t1 = time.perf_counter()
    cats = list(CATEGORIES)
    model = TextEmotionMLP(len(bpe.vocab), len(cats), dropout=dropout)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt = make_optimizer(model, lr)
    order = torch.from_numpy(data_order(len(data["y"]), epochs, batch_size, seed)).to(dev)
    arrays = {k: torch.from_numpy(data[k]).to(dev)
              for k in ("ids", "mask", "lex", "ngrams", "y", "y4")}
    group_mask = torch.from_numpy(data["group_mask"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    losses = torch.empty(order.shape[:2], device=dev)
    for e in range(order.shape[0]):
        for b in range(order.shape[1]):
            idx = order[e, b]
            batch = {k: v[idx] for k, v in arrays.items()}
            losses[e, b] = train_step(model, opt, batch, group_mask, ce4_weight, label_smooth, gen)
    epoch_losses = losses.mean(dim=1).cpu().numpy()
    t2 = time.perf_counter()
    if verbose:
        print(f"[text-mlp] {epochs} epochs, loss {float(epoch_losses[0]):.3f} -> "
              f"{float(epoch_losses[-1]):.3f}")
    if stats is not None:
        stats.update(epoch_losses=epoch_losses, steps=int(order.shape[0] * order.shape[1]),
                     data_s=t1 - t0, loop_s=t2 - t1)
    fp = training_fingerprint(seed=seed, vocab_size=vocab_size, epochs=epochs, lr=lr,
                              dropout=dropout, label_smooth=label_smooth, ce4_weight=ce4_weight)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    return TextMLPClassifier(bpe, state, cats, fingerprint=fp, device=dev)


_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "melogan_torch", "text_mlp.ckpt"
)

# Bump when the model architecture or training recipe changes in a way the
# fingerprint's hashed inputs don't capture (kept equal to the JAX package's).
_MODEL_VERSION = 3


def training_fingerprint(seed: int = 0, vocab_size: int = 600,
                         epochs: int = 150, lr: float = 2e-3,
                         dropout: float = 0.0, label_smooth: float = 0.0,
                         ce4_weight: float = 1.0) -> str:
    """Hash of everything that determines the trained classifier: the corpus
    (texts+labels), the category list, and the training hyperparameters.

    Stored in the cache meta so that a stale cached classifier is retrained
    after the corpus or recipe changes. Equal to the JAX package's string
    for the same arguments."""
    import hashlib

    from melogan_torch.data.text_corpus import generate_text_corpus

    texts, labels = generate_text_corpus("train", seed=seed)
    h = hashlib.sha256()
    h.update(json.dumps({
        "version": _MODEL_VERSION,
        "categories": list(CATEGORIES),
        "seed": seed, "vocab_size": vocab_size, "epochs": epochs, "lr": lr,
        "dropout": dropout, "label_smooth": label_smooth,
        "ce4_weight": ce4_weight, "n_buckets": N_NGRAM_BUCKETS,
        "corpus": list(zip(texts, labels)),
    }, sort_keys=True).encode())
    return h.hexdigest()[:16]


def load_or_train(cache_path: Optional[str] = None, verbose: bool = False,
                  device="cuda") -> TextMLPClassifier:
    """Load the cached classifier or train it and cache it.

    Cache location: ``cache_path``, else ``MELOGAN_TEXT_MLP_CACHE``, else
    ~/.cache/melogan_torch/text_mlp.ckpt; ``MELOGAN_TEXT_MLP_CACHE=0``
    disables caching. A cache whose fingerprint differs from the current
    corpus and recipe, or that cannot be read, is retrained over."""
    env = os.environ.get("MELOGAN_TEXT_MLP_CACHE")
    if env == "0":
        return train_text_classifier(verbose=verbose, device=device)
    path = cache_path or env or _DEFAULT_CACHE
    if os.path.exists(path):
        try:
            clf = TextMLPClassifier.load(path, device=device)
        except Exception as e:  # noqa: BLE001 — a corrupt cache is retrained over
            print(f"[text-mlp] cache {path} unreadable ({type(e).__name__}: {e}); retraining")
        else:
            if clf.fingerprint == training_fingerprint():
                return clf
            print(f"[text-mlp] cache {path} fingerprint mismatch; retraining")
    clf = train_text_classifier(verbose=verbose, device=device)
    try:
        clf.save(path)
    except OSError as e:
        print(f"[text-mlp] could not cache to {path}: {e}")
    return clf
