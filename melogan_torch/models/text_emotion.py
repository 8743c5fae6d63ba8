"""Text → emotion classifier.

The port of ``melogan_tpu/models/text_emotion.py``. Reference behaviour
(textClassification/text.py): a go_emotions 28-label classifier whose top
label is mapped to the four music emotions (happy / sad / angry / calm,
default calm).

The backend is chosen by configuration, never by what happens to load:

- ``torch-roberta`` (``models/roberta.py``): the go_emotions RoBERTa from a
  local HF checkpoint directory, when ``MELOGAN_TEXT_MODEL_DIR`` is set and
  ``MELOGAN_TEXT_BACKEND`` is not ``text-mlp`` or ``lexicon``. The model
  named by the reference is ``SamLowe/roberta-base-go_emotions``; nothing
  here downloads it;
- ``text-mlp`` (``models/text_mlp.py``): the framework's own classifier,
  trained on the framework corpus; the default;
- ``lexicon``: the keyword lexicon, forced with
  ``MELOGAN_TEXT_BACKEND=lexicon``.

Unlike the JAX chain, nothing falls back: a backend that fails to load or to
run raises, and ``POST /get_text_emotion`` answers 500. A CUDA failure then
shows as one, not as a plausible ``calm``. Empty text, and a label outside
the 28→4 map, still give ``calm``, as in JAX. The JAX chain's
``transformers`` pipeline backend is not ported: it is the same RoBERTa on
torch, which ``torch-roberta`` computes.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Dict

# 28-label → 4-emotion map (behavioral contract from the reference,
# textClassification/text.py:8-43).
TEXT_MODEL_TO_MY_EMOTIONS: Dict[str, str] = {
    "joy": "happy", "amusement": "happy", "excitement": "happy",
    "love": "happy", "optimism": "happy", "gratitude": "happy",
    "surprise": "happy", "approval": "happy",
    "sadness": "sad", "disappointment": "sad", "grief": "sad",
    "disgust": "sad", "remorse": "sad",
    "anger": "angry", "annoyance": "angry", "fear": "angry",
    "nervousness": "angry", "disapproval": "angry",
    "neutral": "calm", "caring": "calm", "relief": "calm",
    "pride": "calm", "admiration": "calm", "realization": "calm",
    "curiosity": "calm", "desire": "calm", "confusion": "calm",
}
DEFAULT_EMOTION = "calm"

# go_emotions category → trigger lexicon for the offline backend
_LEXICON: Dict[str, list] = {
    "joy": ["happy", "joy", "joyful", "glad", "delighted", "cheerful", "great", "wonderful", "yay"],
    "amusement": ["funny", "hilarious", "lol", "haha", "amusing", "laugh"],
    "excitement": ["excited", "thrilled", "stoked", "pumped", "can't wait", "awesome"],
    "love": ["love", "adore", "beloved", "darling", "sweetheart"],
    "optimism": ["hopeful", "optimistic", "bright", "looking forward", "promising"],
    "gratitude": ["thanks", "thank", "grateful", "appreciate"],
    "surprise": ["surprised", "wow", "unexpected", "astonish", "amazed"],
    "approval": ["agree", "approve", "well done", "nice", "good job", "perfect"],
    "sadness": ["sad", "unhappy", "depressed", "down", "crying", "cry", "tears", "miserable", "blue", "heartbroken"],
    "disappointment": ["disappointed", "letdown", "let down", "bummer", "shame"],
    "grief": ["grief", "mourning", "loss", "died", "passed away", "funeral"],
    "disgust": ["disgusting", "gross", "nasty", "revolting", "yuck"],
    "remorse": ["sorry", "regret", "apologize", "guilty", "my fault"],
    "anger": ["angry", "furious", "infuriating", "infuriated", "mad", "rage", "outraged", "hate", "livid"],
    "annoyance": ["annoyed", "irritating", "annoying", "bothers", "ugh", "frustrating", "frustrated"],
    "fear": ["afraid", "scared", "terrified", "fear", "frightened", "horror"],
    "nervousness": ["nervous", "anxious", "worried", "uneasy", "stress", "stressed"],
    "disapproval": ["disagree", "disapprove", "wrong", "bad idea", "terrible idea"],
    "neutral": [],
    "caring": ["care", "caring", "take care", "comfort", "support you"],
    "relief": ["relieved", "relief", "phew", "finally over"],
    "pride": ["proud", "pride", "accomplished", "achievement"],
    "admiration": ["admire", "impressive", "brilliant", "amazing", "incredible"],
    "realization": ["realize", "realized", "turns out", "i see now"],
    "curiosity": ["curious", "wonder", "wondering", "interested", "intrigued"],
    "desire": ["wish", "want", "crave", "longing", "hope to"],
    "confusion": ["confused", "confusing", "don't understand", "puzzled", "unclear"],
}


class LexiconClassifier:
    """Offline 28-category keyword scorer with the reference's 28→4 map."""

    def __init__(self):
        self._patterns = {
            label: [re.compile(r"\b" + re.escape(w).replace(r"\ ", r"\s+") + r"\b") for w in words]
            for label, words in _LEXICON.items()
        }

    def scores(self, text: str) -> Dict[str, int]:
        """Per-category keyword-hit counts (feature vector for the hybrid
        text-mlp backend, models/text_mlp.py)."""
        t = str(text).lower()
        return {
            label: sum(1 for p in pats if p.search(t))
            for label, pats in self._patterns.items()
        }

    def top_label(self, text: str) -> str:
        scores = self.scores(text)
        best = max(scores, key=lambda k: scores[k])
        return best if scores[best] > 0 else "neutral"

    def __call__(self, text: str):
        return [[{"label": self.top_label(text), "score": 1.0}]]


_classifier = None
_loaded_key = None  # (backend, device, model dir) of _classifier
_load_lock = threading.Lock()  # server threads may ask for the first load together


def backend_name() -> str:
    """The configured backend: ``lexicon`` or ``text-mlp`` when
    ``MELOGAN_TEXT_BACKEND`` names it, else ``torch-roberta`` when
    ``MELOGAN_TEXT_MODEL_DIR`` is set, else ``text-mlp``. Any other value of
    ``MELOGAN_TEXT_BACKEND`` raises ValueError. Loads nothing."""
    forced = os.environ.get("MELOGAN_TEXT_BACKEND") or None
    if forced not in (None, "text-mlp", "lexicon"):
        raise ValueError(f"MELOGAN_TEXT_BACKEND={forced!r}; valid: 'text-mlp', 'lexicon', or unset")
    if forced:
        return forced
    return "torch-roberta" if os.environ.get("MELOGAN_TEXT_MODEL_DIR") else "text-mlp"


def load_classifier(device="cuda"):
    """The configured backend's classifier on ``device`` (the lexicon runs
    on the host), loaded once and kept until ``reset_backend`` or a change
    of backend, device or model directory. Raises when it cannot be
    loaded."""
    global _classifier, _loaded_key
    name = backend_name()
    if name != "lexicon":
        from melogan_torch.device import resolve_device  # noqa: PLC0415

        device = resolve_device(device)
    key = (name, str(device) if name != "lexicon" else None,
           os.environ["MELOGAN_TEXT_MODEL_DIR"] if name == "torch-roberta" else None)
    with _load_lock:
        if _classifier is not None and _loaded_key == key:
            return _classifier
        if name == "torch-roberta":
            from melogan_torch.models.roberta import RobertaTextClassifier  # noqa: PLC0415

            clf = RobertaTextClassifier(os.environ["MELOGAN_TEXT_MODEL_DIR"], device=device)
        elif name == "text-mlp":
            from melogan_torch.models.text_mlp import load_or_train  # noqa: PLC0415

            clf = load_or_train(device=device)
        else:
            clf = LexiconClassifier()
        _classifier, _loaded_key = clf, key
        return clf


def reset_backend() -> None:
    """Drop the cached classifier (tests / env change)."""
    global _classifier, _loaded_key
    with _load_lock:
        _classifier = None
        _loaded_key = None


# The port's own measurement on the held-out eval split of the framework
# corpus (data/text_corpus.py: 1,620 sentences, phrases and templates
# disjoint from training; majority-class chance 33%): the shipped recipe
# trained on an NVIDIA H100 (80GB HBM3, 700 W) by chip_smoke.py's
# ``text_mlp`` phase, which asserts that its live numbers equal these to
# 3 decimals; tests/test_torch_text.py holds a CPU-trained classifier
# within 0.02 of them. Re-derivable with ``python -m melogan_torch
# text-eval``. "macro" is the mean of the four per-emotion accuracies.
MEASURED_EVAL_ACCURACY = {
    "text-mlp": {"overall": 0.520, "macro": 0.488},
    "lexicon": {"overall": 0.417, "macro": 0.343},
}


def _note(name: str) -> str:
    if name == "torch-roberta":
        return ("go_emotions RoBERTa from MELOGAN_TEXT_MODEL_DIR, running in the port's "
                "torch module (accuracy that of the checkpoint served)")
    acc = MEASURED_EVAL_ACCURACY[name]
    measured = (f"measured {acc['overall']:.1%} overall / {acc['macro']:.1%} macro "
                f"4-emotion accuracy on the held-out eval set (chance 33%/25%)")
    if name == "text-mlp":
        lex = MEASURED_EVAL_ACCURACY["lexicon"]
        return ("framework-trained hybrid classifier (own BPE embeddings + hashed "
                "char-ngrams + lexicon features, hierarchical category/4-emotion loss) — "
                f"{measured}; the lexicon scores {lex['overall']:.1%}/{lex['macro']:.1%} "
                "there. NOT go_emotions-model grade: set MELOGAN_TEXT_MODEL_DIR to a local "
                "go_emotions checkpoint for reference accuracy.")
    return (f"keyword lexicon — {measured}. Set MELOGAN_TEXT_MODEL_DIR to a local "
            "go_emotions checkpoint for model-grade text emotion.")


def backend_info() -> Dict[str, object]:
    """The configured backend's name, its accuracy note and, for the offline
    backends, the port's measured eval-set accuracy (shown by /healthz)."""
    name = backend_name()
    info: Dict[str, object] = {"backend": name, "note": _note(name)}
    if name in MEASURED_EVAL_ACCURACY:
        info["measured_eval_accuracy"] = MEASURED_EVAL_ACCURACY[name]
    return info


def predict_emotion(text: str, device="cuda") -> str:
    """Top-label prediction mapped to the four music emotions; empty text
    and a label outside the map give ``calm``. A backend that fails to
    load or to run raises."""
    if not text or not str(text).strip():
        return DEFAULT_EMOTION
    result = load_classifier(device)(str(text))
    return TEXT_MODEL_TO_MY_EMOTIONS.get(str(result[0][0]["label"]).lower(), DEFAULT_EMOTION)
