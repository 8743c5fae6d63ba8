"""Measured accuracy of the offline text-emotion backends.

The port of ``melogan_tpu/diagnostics/text_eval.py``, with the same report
keys. Evaluates any backend with the standard call contract
(``clf(text) -> [[{"label", "score"}]]``) on the held-out split of the
framework's labelled corpus (``data/text_corpus.py``: phrases and templates
disjoint from the training split). Scoring happens at the 4-music-emotion
level, the granularity the serving path uses, through the reference's 28→4
map (textClassification/text.py:8-43). The port's classifier runs on
``device``, the GPU by default.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.data.text_corpus import generate_text_corpus
from melogan_torch.models.text_emotion import DEFAULT_EMOTION, TEXT_MODEL_TO_MY_EMOTIONS


def _to4(category: str) -> str:
    return TEXT_MODEL_TO_MY_EMOTIONS.get(str(category).lower(), DEFAULT_EMOTION)


def evaluate_text_backend(
    clf: Callable,
    seed: int = 0,
    limit: Optional[int] = None,
) -> Dict:
    """Accuracy report of a text backend over the held-out eval split."""
    texts, categories = generate_text_corpus("eval", seed=seed)
    if limit:
        texts, categories = texts[:limit], categories[:limit]
    y_true = np.asarray([_to4(c) for c in categories])
    y_pred = np.asarray([_to4(clf(t)[0][0]["label"]) for t in texts])
    per_emotion = {}
    confusion = np.zeros((len(EMOTIONS), len(EMOTIONS)), np.int64)
    for t, p in zip(y_true, y_pred):
        confusion[EMOTIONS.index(t), EMOTIONS.index(p)] += 1
    for e in EMOTIONS:
        mask = y_true == e
        per_emotion[e] = {
            "n": int(mask.sum()),
            "accuracy": float((y_pred[mask] == e).mean()) if mask.any() else None,
        }
    counts = np.unique(y_true, return_counts=True)[1]
    return {
        "n": int(len(y_true)),
        "accuracy": float((y_pred == y_true).mean()),
        "chance": float(counts.max() / len(y_true)),
        "per_emotion": per_emotion,
        "confusion": confusion.tolist(),
    }


def macro_accuracy(report: Dict) -> float:
    """The mean of a report's per-emotion accuracies (``MEASURED_EVAL_ACCURACY``'s
    "macro")."""
    return float(np.mean([v["accuracy"] for v in report["per_emotion"].values()]))


def ceiling_study(seed: int = 0, verbose: bool = True, device="cuda") -> Dict:
    """How much 4-emotion accuracy the eval split supports at all.

    Estimators, all label-free with respect to eval:
    - ``knn_ngram``: 1-NN over TRAIN texts by char-3–5-gram cosine, the
      ceiling of pure surface-form matching (no training, no model);
    - ``train_self``: the deployed classifier re-scored on its own training
      sentences, a capacity check (near 100% means the eval shortfall is a
      generalization gap, not underfitting).
    Also returns the eval confusion matrix and up to 12 misclassified eval
    sentences for error analysis."""
    from melogan_torch.models.text_mlp import _char_ngram_counts, load_or_train

    tr_texts, tr_cats = generate_text_corpus("train", seed=seed)
    ev_texts, ev_cats = generate_text_corpus("eval", seed=seed)
    tr4 = np.asarray([_to4(c) for c in tr_cats])
    ev4 = np.asarray([_to4(c) for c in ev_cats])

    # 1-NN by char-ngram cosine (numpy, one matmul)
    tr_ng = _char_ngram_counts(tr_texts)
    ev_ng = _char_ngram_counts(ev_texts)
    tr_n = tr_ng / np.maximum(np.linalg.norm(tr_ng, axis=1, keepdims=True), 1e-9)
    ev_n = ev_ng / np.maximum(np.linalg.norm(ev_ng, axis=1, keepdims=True), 1e-9)
    nn_idx = (ev_n @ tr_n.T).argmax(axis=1)
    knn_acc = float((tr4[nn_idx] == ev4).mean())

    clf = load_or_train(device=device)
    ev_report = evaluate_text_backend(clf, seed=seed)
    # capacity check on a deterministic subsample of train (speed)
    sub = np.random.default_rng(0).permutation(len(tr_texts))[:400]
    correct = sum(int(_to4(clf(tr_texts[i])[0][0]["label"]) == tr4[i]) for i in sub)
    train_self = correct / len(sub)

    examples = []
    for t, c in zip(ev_texts, ev_cats):
        if len(examples) >= 12:
            break
        pred_cat = str(clf(t)[0][0]["label"]).lower()
        if _to4(pred_cat) != _to4(c):
            examples.append({"text": t, "true_category": c,
                             "true": _to4(c), "predicted_category": pred_cat,
                             "predicted": _to4(pred_cat)})

    report = {
        "eval": {"accuracy": ev_report["accuracy"],
                 "confusion": ev_report["confusion"],
                 "emotions": list(EMOTIONS)},
        "knn_ngram_ceiling": knn_acc,
        "train_self_accuracy": float(train_self),
        "misclassified_examples": examples,
    }
    if verbose:
        print(f"[text-ceiling] deployed eval {ev_report['accuracy']:.1%} | "
              f"1-NN char-ngram surface baseline {knn_acc:.1%} | "
              f"train-self {train_self:.1%}")
        print(f"[text-ceiling] confusion (rows=true {list(EMOTIONS)}):")
        for e, row in zip(EMOTIONS, ev_report["confusion"]):
            print(f"  {e:6s} {row}")
        for ex in examples[:6]:
            print(f"  miss: {ex['true']}->{ex['predicted']}: {ex['text']!r}")
    return report


def compare_offline_backends(seed: int = 0, verbose: bool = True, device="cuda") -> Dict:
    """The lexicon against the framework's own trained classifier on the
    same eval set: the receipt for shipping text-mlp as the default
    offline backend."""
    from melogan_torch.models.text_emotion import LexiconClassifier
    from melogan_torch.models.text_mlp import load_or_train

    lex = evaluate_text_backend(LexiconClassifier(), seed=seed)
    own = evaluate_text_backend(load_or_train(device=device), seed=seed)
    report = {"lexicon": lex, "text-mlp": own}
    if verbose:
        for name, r in report.items():
            per = " ".join(
                f"{e}:{v['accuracy']:.0%}" for e, v in r["per_emotion"].items()
            )
            print(f"[text-eval] {name:9s} accuracy {r['accuracy']:.1%} "
                  f"(n={r['n']}, chance {r['chance']:.0%}) | {per}")
    return report
