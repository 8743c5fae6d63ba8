"""Self-contained tokenizers for the RoBERTa text backend.

The reference loads HF ``AutoTokenizer`` (textClassification/text.py:48-58)
— the last third-party model-stack dependency in a serving path this
framework otherwise owns end-to-end. This module removes it: a byte-level
BPE implementation (the GPT-2/RoBERTa scheme) plus a minimal WordLevel
variant, loading the standard checkpoint artifacts directly:

- ``vocab.json`` + ``merges.txt``  (classic RoBERTa checkpoint layout)
- ``tokenizer.json``               (HF *tokenizers* serialization; model
                                    types ``BPE`` and ``WordLevel``)

A copy of ``melogan_tpu/models/tokenizer.py``. Token-id equality with
``AutoTokenizer`` over an edge-case corpus (unicode, contractions, long words,
whitespace runs) is asserted in ``tests/test_roberta.py``, and the port's ids
equal the JAX package's in ``tests/test_torch_text.py``. Everything here is
stdlib-only — the GPT-2
pre-tokenization regex is replaced by an equivalent hand-written scanner so
no ``regex``/``transformers``/``tokenizers`` import is needed at runtime.
"""
from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Byte ↔ unicode table (GPT-2 scheme; behavioral-contract constant — byte
# values must map to the exact code points the checkpoint's vocab.json uses)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Printable bytes map to themselves; the rest shift into U+0100+ so
    every byte has a visible, dict-key-safe character."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# ---------------------------------------------------------------------------
# GPT-2 pre-tokenization: equivalent of the pattern
#   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# as a hand-written left-to-right scanner (alternation order preserved).
# ---------------------------------------------------------------------------

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# regex-module \s (what the GPT-2 pattern uses): unicode whitespace (Z*)
# plus these controls — NOT Python isspace(), which also accepts the file/
# group/record/unit separators U+001C–1F (regex \s does not: verified by an
# exhaustive all-codepoints scan against regex.match(r"\s"))
_WS_EXTRA = set("\t\n\x0b\x0c\r\x85")


def _is_ws(c: str) -> bool:
    return c in _WS_EXTRA or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _is_other(c: str) -> bool:
    return not (_is_ws(c) or _is_letter(c) or _is_number(c))


def pretokenize(text: str) -> List[str]:
    """Split ``text`` into GPT-2 pre-tokens (spaces stick to the following
    word: ``"so happy"`` → ``["so", " happy"]``)."""
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            for suf in _CONTRACTIONS:
                if text.startswith(suf, i):
                    toks.append(suf)
                    i += len(suf)
                    break
            else:
                suf = None
            if suf is not None:
                continue
        # " ?X+" branches: an optional single U+0020 prefix glued to a run
        for pred in (_is_letter, _is_number, _is_other):
            k = i + 1 if (c == " " and i + 1 < n and pred(text[i + 1])) else i
            if k < n and pred(text[k]) and not (k == i and c == " "):
                j = k + 1
                while j < n and pred(text[j]):
                    j += 1
                toks.append(text[i:j])
                i = j
                break
        else:
            # whitespace branches: \s+(?!\S) leaves one char for the next
            # token when non-whitespace follows; lone \s+ otherwise
            j = i
            while j < n and _is_ws(text[j]):
                j += 1
            if j < n and j - i >= 2:
                toks.append(text[i : j - 1])
                i = j - 1
            else:
                toks.append(text[i:j])
                i = j
    return toks


# ---------------------------------------------------------------------------
# BPE merge machinery
# ---------------------------------------------------------------------------


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


class ByteLevelBPE:
    """GPT-2/RoBERTa byte-level BPE encoder (vocab.json + merges.txt)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        bos_token: str = "<s>",
        eos_token: str = "</s>",
        pad_token: str = "<pad>",
        unk_token: str = "<unk>",
        add_prefix_space: bool = False,
    ):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab.get(unk_token)
        self.add_prefix_space = add_prefix_space
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if bigram not in self.ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        """Text → token ids, no special tokens (the raw BPE segment)."""
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        ids: List[int] = []
        for pre in pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                pid = self.vocab.get(piece)
                if pid is None:  # can't happen with a full 256-byte alphabet
                    pid = self.unk_id
                    if pid is None:
                        raise KeyError(f"token {piece!r} not in vocab and no unk token")
                ids.append(pid)
        return ids

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """RoBERTa single-sequence encoding: ``<s> tokens </s>``, truncated
        (specials kept) to ``max_length`` like HF ``truncation=True``."""
        ids = self.encode_text(text)
        if max_length is not None and max_length >= 2:
            ids = ids[: max_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def __call__(self, texts: Iterable[str], truncation: bool = True,
                 max_length: Optional[int] = None, padding: bool = False):
        """HF-tokenizer-call-compatible subset used by the classifier."""
        limit = max_length if truncation else None
        out = [self.encode(t, max_length=limit) for t in texts]
        if padding:
            tlen = max(len(r) for r in out)
            out = [r + [self.pad_id] * (tlen - len(r)) for r in out]
        return {"input_ids": out}


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 2048,
    add_prefix_space: bool = False,
) -> ByteLevelBPE:
    """Train a byte-level BPE from scratch (the standard merge-count loop).

    No reference equivalent — the reference downloads a pretrained RoBERTa
    tokenizer (textClassification/text.py:54-58); this makes the framework's
    own text classifier fully self-contained offline. Produces a
    :class:`ByteLevelBPE` whose vocab is ``specials + 256-byte alphabet +
    merge products`` (so every input always tokenizes; no unk needed)."""
    from collections import Counter

    byte_encoder = bytes_to_unicode()
    words: Counter = Counter()
    for text in texts:
        if add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        for pre in pretokenize(text):
            words[tuple(byte_encoder[b] for b in pre.encode("utf-8"))] += 1

    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    alphabet = [byte_encoder[b] for b in range(256)]
    vocab: Dict[str, int] = {}
    for tok in specials + alphabet:
        vocab[tok] = len(vocab)
    merges: List[Tuple[str, str]] = []

    work = {w: list(w) for w in words}
    while len(vocab) < vocab_size:
        pair_counts: Counter = Counter()
        for w, sym in work.items():
            f = words[w]
            for a, b in zip(sym[:-1], sym[1:]):
                pair_counts[(a, b)] += f
        if not pair_counts:
            break
        (a, b), count = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if count < 2:  # nothing left worth merging
            break
        merges.append((a, b))
        new_tok = a + b
        vocab[new_tok] = len(vocab)
        for w, sym in work.items():
            i, out = 0, []
            while i < len(sym):
                if i < len(sym) - 1 and sym[i] == a and sym[i + 1] == b:
                    out.append(new_tok)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            work[w] = out
    return ByteLevelBPE(vocab, merges, add_prefix_space=add_prefix_space)


class WordLevelTokenizer:
    """Minimal WordLevel model + Whitespace pre-tokenizer + ``<s> $A </s>``
    template — the shape of hand-built offline ``tokenizer.json`` files."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "<unk>",
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>"):
        self.vocab = dict(vocab)
        self.unk_id = self.vocab[unk_token]
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.vocab.get(pad_token, self.unk_id)

    @staticmethod
    def _is_word(c: str) -> bool:
        # the tokenizers library's Whitespace uses the unicode regex \w =
        # [\p{Alphabetic}\p{M}\p{Nd}\p{Pc}\p{Join_Control}]; Python's
        # isalnum() differs (e.g. superscript '²' is isalnum but No — not
        # \w; combining marks are \w but not isalnum), so classify by
        # category. (Other_Alphabetic symbols like circled letters are the
        # one uncovered sliver of \p{Alphabetic}.)
        cat = unicodedata.category(c)
        return (
            cat.startswith(("L", "M"))
            or cat in ("Nd", "Nl", "Pc")
            or c in ("\u200c", "\u200d")  # Join_Control (ZWNJ/ZWJ)
        )

    @staticmethod
    def _is_space(c: str) -> bool:
        # one shared White_Space classifier for both pre-tokenizers — the BPE
        # scanner once drifted from this copy (U+001C–1F; fixed in 9c9d7ec)
        return _is_ws(c)

    @classmethod
    def _split(cls, text: str) -> List[str]:
        # Whitespace pre-tokenizer: \w+|[^\w\s]+
        toks, run, mode = [], [], None  # mode: 'w' word chars, 'p' punct

        def flush():
            if run:
                toks.append("".join(run))
                run.clear()

        for c in text:
            if cls._is_space(c):
                flush()
                mode = None
            elif cls._is_word(c):
                if mode != "w":
                    flush()
                mode = "w"
                run.append(c)
            else:
                if mode != "p":
                    flush()
                mode = "p"
                run.append(c)
        flush()
        return toks

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.vocab.get(w, self.unk_id) for w in self._split(text)]
        if max_length is not None and max_length >= 2:
            ids = ids[: max_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def __call__(self, texts: Iterable[str], truncation: bool = True,
                 max_length: Optional[int] = None, padding: bool = False):
        limit = max_length if truncation else None
        out = [self.encode(t, max_length=limit) for t in texts]
        if padding:
            tlen = max(len(r) for r in out)
            out = [r + [self.pad_id] * (tlen - len(r)) for r in out]
        return {"input_ids": out}


# ---------------------------------------------------------------------------
# Loader over the standard checkpoint artifacts
# ---------------------------------------------------------------------------


def _parse_merges_txt(path: str) -> List[Tuple[str, str]]:
    merges: List[Tuple[str, str]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
    return merges


def _find_byte_level(pre_tokenizer) -> Dict:
    """Locate the ByteLevel entry in a ``tokenizer.json`` pre_tokenizer —
    either a bare ``{"type": "ByteLevel", ...}`` dict or nested inside a
    ``{"type": "Sequence", "pretokenizers": [...]}`` wrapper (the common HF
    serialization). Returns ``{}`` if absent, so ``add_prefix_space``
    defaults to False only when genuinely unspecified."""
    if not isinstance(pre_tokenizer, dict):
        return {}
    if pre_tokenizer.get("type") == "Sequence":
        for sub in pre_tokenizer.get("pretokenizers") or []:
            found = _find_byte_level(sub)
            if found:
                return found
    if pre_tokenizer.get("type") == "ByteLevel" or "add_prefix_space" in pre_tokenizer:
        return pre_tokenizer
    return {}


def _special_names(tokenizer_config: Dict) -> Dict[str, str]:
    names = {}
    for key in ("bos_token", "eos_token", "pad_token", "unk_token"):
        val = tokenizer_config.get(key)
        if isinstance(val, dict):  # {"content": "<s>", ...} AddedToken form
            val = val.get("content")
        if isinstance(val, str):
            names[key] = val
    return names


def load_tokenizer(model_dir: str):
    """Build a tokenizer from a checkpoint directory, preferring the classic
    ``vocab.json`` + ``merges.txt`` pair, then ``tokenizer.json``."""
    tok_cfg = {}
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            tok_cfg = json.load(f)
    specials = _special_names(tok_cfg)

    vocab_path = os.path.join(model_dir, "vocab.json")
    merges_path = os.path.join(model_dir, "merges.txt")
    if os.path.exists(vocab_path) and os.path.exists(merges_path):
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        return ByteLevelBPE(
            vocab,
            _parse_merges_txt(merges_path),
            bos_token=specials.get("bos_token", "<s>"),
            eos_token=specials.get("eos_token", "</s>"),
            pad_token=specials.get("pad_token", "<pad>"),
            unk_token=specials.get("unk_token", "<unk>"),
            add_prefix_space=bool(tok_cfg.get("add_prefix_space", False)),
        )

    tj_path = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(tj_path):
        with open(tj_path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj.get("model", {})
        mtype = model.get("type")
        if mtype == "BPE":
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                      for m in model["merges"]]
            pre = _find_byte_level(tj.get("pre_tokenizer"))
            return ByteLevelBPE(
                model["vocab"],
                merges,
                bos_token=specials.get("bos_token", "<s>"),
                eos_token=specials.get("eos_token", "</s>"),
                pad_token=specials.get("pad_token", "<pad>"),
                unk_token=specials.get("unk_token", model.get("unk_token") or "<unk>"),
                add_prefix_space=bool(pre.get("add_prefix_space", False)),
            )
        if mtype == "WordLevel":
            return WordLevelTokenizer(
                model["vocab"],
                unk_token=model.get("unk_token", specials.get("unk_token", "<unk>")),
                bos_token=specials.get("bos_token", "<s>"),
                eos_token=specials.get("eos_token", "</s>"),
                pad_token=specials.get("pad_token", "<pad>"),
            )
        raise ValueError(f"unsupported tokenizer.json model type {mtype!r}")

    raise FileNotFoundError(
        f"no tokenizer artifacts in {model_dir} "
        "(need vocab.json+merges.txt or tokenizer.json)"
    )
