"""The port's text path against the JAX package, on the CPU: the copied
corpus and tokenizers, the text MLP's forward, training step and cache file,
its trained accuracy, and the backend configuration.

Tolerances, and why. Both sides compute in IEEE f32 in different orders
(the port pools the embedding as a counts-by-table product, flax sums the
gathered rows), which agree to about 1e-7 of each quantity's scale here.

- Logits with the same weights, the loss and Adam's first moments after one
  step: 1e-5 of their scale. A wrong term, layer or GELU variant is O(1e-2)
  or more (the tanh and erf GELUs differ by up to 5e-4 of a unit's value).
- Parameters after 20 steps: within 2·lr per update (at its first steps an
  Adam update is about lr·sign(g), so an element whose gradient is near
  zero can move ±lr on either side).
- Labels: equal, except where the two top decision scores lie within 1e-5,
  where rounding may pick either; those are counted and printed.
- Accuracy of the full recipe trained here: within 0.02 of the card's pin
  (``MEASURED_EVAL_ACCURACY``); the lexicon's, computed on the host alike
  everywhere, equal to the pin to 3 decimals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from melogan_tpu.data import text_corpus as jcorpus
from melogan_tpu.diagnostics import text_eval as jeval
from melogan_tpu.models import text_emotion as jte
from melogan_tpu.models import text_mlp as jtm
from melogan_tpu.models import tokenizer as jtok

from melogan_torch.data import text_corpus as tcorpus
from melogan_torch.diagnostics.text_eval import evaluate_text_backend, macro_accuracy
from melogan_torch.models import text_emotion as tte
from melogan_torch.models import text_mlp as ttm
from melogan_torch.models import tokenizer as ttok
from melogan_torch.utils.weights import text_mlp_flax_from_state, text_mlp_state_from_flax

REL = 1e-5
LR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The full recipe trains here once (about a minute on two threads);
    more threads only contend with the other test workers'."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(a, b, rel=REL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x scale {scale:.3e}"


# ---------------------------------------------------------------------------
# The copied modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("seed", [0, 1])
def test_corpus_matches_jax(split, seed):
    ours = tcorpus.generate_text_corpus(split, seed=seed)
    theirs = jcorpus.generate_text_corpus(split, seed=seed)
    assert ours == theirs
    assert len(ours[0]) == {"train": 6786, "eval": 1620}[split]
    assert len(set(ours[1])) == 27


@pytest.fixture(scope="module")
def bpes():
    texts, _ = tcorpus.generate_text_corpus("train", seed=0)
    return ttok.train_bpe(texts, vocab_size=600), jtok.train_bpe(texts, vocab_size=600)


def test_train_bpe_matches_jax(bpes):
    ours, theirs = bpes
    assert ours.vocab == theirs.vocab
    assert ours.ranks == theirs.ranks
    assert len(ours.vocab) <= 600


def test_eval_encodings_match_jax(bpes):
    ours, theirs = bpes
    texts, _ = tcorpus.generate_text_corpus("eval", seed=0)
    ids, mask = ttm._encode_batch(ours, texts)
    jids, jmask = jtm._encode_batch(theirs, texts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(ttm._char_ngram_counts(texts[:200]), jtm._char_ngram_counts(texts[:200]))
    np.testing.assert_array_equal(ttm._lexicon_features(texts, ttm.CATEGORIES),
                                  jtm._lexicon_features(texts, jtm.CATEGORIES))


TOKENIZER_TEXTS = [
    "I am so happy today!", "don't can't won't it's I'll we've", "naïve façade résumé Zürich",
    "emoji 🎵🎹 and more", "  leading and   multiple    spaces  ", "numbers 12345 3.14159",
    "i am so happy today", "it is calm", "unknown words here", "", "a",
]


def _wordlevel_dir(d):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing

    words = ["i", "am", "so", "happy", "sad", "angry", "today", "it", "is", "calm"]
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: 4 + i for i, w in enumerate(words)})
    tok = tokenizers.Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.post_processor = TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    tok.save(str(d / "tokenizer.json"))


def _bytelevel_dir(d):
    pytest.importorskip("tokenizers")
    from tokenizers.implementations import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(TOKENIZER_TEXTS * 3 + ["the quick brown fox jumps over the lazy dog"],
                            vocab_size=400, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(str(d))


@pytest.mark.parametrize("kind", ["wordlevel", "bytelevel"])
def test_load_tokenizer_matches_jax(kind, tmp_path):
    {"wordlevel": _wordlevel_dir, "bytelevel": _bytelevel_dir}[kind](tmp_path)
    ours, theirs = ttok.load_tokenizer(str(tmp_path)), jtok.load_tokenizer(str(tmp_path))
    assert type(ours).__name__ == type(theirs).__name__
    kw = dict(truncation=True, max_length=16, padding=False)
    assert ours(TOKENIZER_TEXTS, **kw)["input_ids"] == theirs(TOKENIZER_TEXTS, **kw)["input_ids"]


# ---------------------------------------------------------------------------
# The text MLP: forward with carried weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return ttm.training_data(seed=0, vocab_size=600)


@pytest.fixture(scope="module")
def jax_init(data):
    bpe, d = data
    model = jtm._build_model(len(bpe.vocab), len(jtm.CATEGORIES))
    params = model.init(jax.random.PRNGKey(0), d["ids"][:1].astype(np.int32), d["mask"][:1],
                        d["lex"][:1], d["ngrams"][:1])["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_state_bridge_round_trips(jax_init):
    _, params = jax_init
    sd = text_mlp_state_from_flax(params)
    model = ttm.TextEmotionMLP(sd["embed.weight"].shape[0], len(ttm.CATEGORIES))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})  # strict: names and shapes
    back = text_mlp_flax_from_state(sd)
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(back[layer][leaf], params[layer][leaf])


def test_logits_match_jax_at_full_width(data, jax_init):
    bpe, _ = data
    model, params = jax_init
    assert params["embed"]["embedding"].shape == (len(bpe.vocab), 64)
    assert params["ngram_proj"]["kernel"].shape == (4096, 128)
    assert params["fc1"]["kernel"].shape == (64 + 128 + 27, 256)
    # weights ×4 so the logits are far from 0 and every layer matters
    params = jax.tree_util.tree_map(lambda a: a * 4.0, params)
    texts, _ = tcorpus.generate_text_corpus("eval", seed=0)
    clf = ttm.TextMLPClassifier(bpe, text_mlp_state_from_flax(params), device="cpu")
    ids, mask, lex, ng = clf.features(texts[:64])
    want = np.asarray(model.apply({"params": params}, ids, mask, lex, ng))
    assert np.abs(want).max() > 1.0
    _close(clf.logits(texts[:64]), want, what="logits")


def test_fingerprint_matches_jax():
    assert ttm.training_fingerprint() == jtm.training_fingerprint()
    kw = dict(seed=1, epochs=3, lr=1e-3, dropout=0.1)
    assert ttm.training_fingerprint(**kw) == jtm.training_fingerprint(**kw)


# ---------------------------------------------------------------------------
# The text MLP: training step against JAX's, rebuilt from text_mlp.py
# ---------------------------------------------------------------------------


def _jax_step(model, d):
    """One step of JAX's recipe (``text_mlp.py``'s loss at dropout 0,
    label smoothing 0, ce4 weight 1, and ``optax.adamw``)."""
    group_mask = jnp.asarray(d["group_mask"])
    n_cats = group_mask.shape[1]
    opt = optax.adamw(LR, weight_decay=1e-4)

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["ids"], b["mask"], b["lex"], b["ngrams"])
        logp = jax.nn.log_softmax(logits)
        ce_cat = -jnp.mean(jnp.sum(jax.nn.one_hot(b["y"], n_cats) * logp, axis=-1))
        grouped = jax.nn.logsumexp(logits[:, None, :] + jnp.log(group_mask)[None], axis=-1)
        logp4 = grouped - jax.nn.logsumexp(logits, axis=-1, keepdims=True)
        ce_4 = -jnp.mean(jnp.take_along_axis(logp4, b["y4"][:, None], axis=1))
        return ce_cat + ce_4

    @jax.jit
    def step(params, opt_state, b):
        loss, grads = jax.value_and_grad(loss_fn)(params, b)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return opt, step


def _batches(d, n):
    order = ttm.data_order(len(d["y"]), 1, 64, seed=0)[0]
    keys = ("ids", "mask", "lex", "ngrams", "y", "y4")
    return [{k: d[k][order[i]] for k in keys} for i in range(n)]


def _port_setup(params):
    sd = text_mlp_state_from_flax(params)
    model = ttm.TextEmotionMLP(sd["embed.weight"].shape[0], len(ttm.CATEGORIES))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.train()
    return model, ttm.make_optimizer(model, LR)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_one_step_matches_jax(data, jax_init):
    """The same parameters and batch: the loss, Adam's first moments (the
    gradients scaled by 1 − b1) and the updated parameters."""
    _, d = data
    model_j, params = jax_init
    opt_j, step_j = _jax_step(model_j, d)
    (b,) = _batches(d, 1)
    new_j, state_j, loss_j = step_j(params, opt_j.init(params), jax.tree_util.tree_map(jnp.asarray, b))
    model, opt = _port_setup(params)
    loss = ttm.train_step(model, opt, _torch_batch(b), torch.from_numpy(d["group_mask"]))
    _close(float(loss), float(loss_j), what="loss")
    mu = text_mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, state_j[0].mu))
    for name, p in model.named_parameters():
        _close(opt.state[p]["exp_avg"].numpy(), mu[name], what=f"first moment {name}")
    new = text_mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, new_j))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name], rtol=0, atol=2 * LR, err_msg=name)


def test_twenty_steps_match_jax(data, jax_init):
    _, d = data
    model_j, params = jax_init
    opt_j, step_j = _jax_step(model_j, d)
    model, opt = _port_setup(params)
    state_j = opt_j.init(params)
    gm = torch.from_numpy(d["group_mask"])
    losses, losses_j = [], []
    for b in _batches(d, 20):
        params, state_j, loss_j = step_j(params, state_j, jax.tree_util.tree_map(jnp.asarray, b))
        losses_j.append(float(loss_j))
        losses.append(float(ttm.train_step(model, opt, _torch_batch(b), gm)))
    new = text_mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name], rtol=0, atol=2 * LR * 20, err_msg=name)
    assert losses[-1] < losses[0] and losses_j[-1] < losses_j[0]


def test_training_repeats_bit_for_bit():
    a = ttm.train_text_classifier(epochs=2, device="cpu").state_dict()
    b = ttm.train_text_classifier(epochs=2, device="cpu").state_dict()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# The shipped recipe trained here; its labels, cache files and accuracy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    stats = {}
    clf = ttm.train_text_classifier(device="cpu", stats=stats)
    assert stats["steps"] == 150 * 106
    return clf, stats


def test_top_label_matches_jax_on_every_eval_text(trained):
    """The trained weights in both packages: logits within 1e-5 of scale on
    every eval text, and the same label, but where the two top decision
    scores lie within 1e-5."""
    clf, _ = trained
    params = text_mlp_flax_from_state(clf.state_dict())
    theirs = jtm.TextMLPClassifier(clf.bpe, params, clf.categories)
    texts, _ = tcorpus.generate_text_corpus("eval", seed=0)
    model = jtm._build_model(len(clf.bpe.vocab), len(clf.categories))
    for i in range(0, len(texts), 270):
        chunk = texts[i:i + 270]
        _close(clf.logits(chunk), np.asarray(model.apply({"params": params}, *clf.features(chunk))),
               what=f"trained logits, texts {i}-{i + len(chunk)}")
    near_ties = []
    for t in texts:
        ours, j = clf.top_label(t), theirs.top_label(t)
        if ours[0] != j[0]:
            lex = clf.features([t])[2]
            logits = clf.logits([t])[0]
            probs = np.exp(logits - logits.max())
            score = np.sort(probs / probs.sum() + lex[0])
            assert score[-1] - score[-2] <= 1e-5, (t, ours, j)
            near_ties.append(t)
    print(f"{len(near_ties)} near-tie texts of {len(texts)}: {near_ties}")


def test_port_cache_loads_in_jax_and_jax_cache_in_the_port(trained, tmp_path):
    clf, _ = trained
    texts, _ = tcorpus.generate_text_corpus("eval", seed=0)
    port_file, jax_file = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    clf.save(port_file)
    from_port = jtm.TextMLPClassifier.load(port_file)
    assert from_port.fingerprint == clf.fingerprint == jtm.training_fingerprint()
    assert from_port.bpe.vocab == clf.bpe.vocab and from_port.bpe.ranks == clf.bpe.ranks
    from_port.save(jax_file)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()  # the same tree gives the same bytes
    back = ttm.TextMLPClassifier.load(jax_file, device="cpu")
    assert back.fingerprint == clf.fingerprint and back.categories == clf.categories
    for k, v in clf.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k], v, err_msg=k)
    for t in texts[:200]:
        assert back(t)[0][0]["label"] == clf(t)[0][0]["label"] == from_port(t)[0][0]["label"]


def test_full_recipe_beats_the_lexicon_and_matches_the_card_pin(trained):
    clf, stats = trained
    own = evaluate_text_backend(clf)
    lex = evaluate_text_backend(tte.LexiconClassifier())
    assert own["n"] == lex["n"] == 1620
    assert own["accuracy"] > lex["accuracy"] and macro_accuracy(own) > macro_accuracy(lex)
    pin = tte.MEASURED_EVAL_ACCURACY
    print(f"text-mlp {own['accuracy']:.4f} / {macro_accuracy(own):.4f}, lexicon "
          f"{lex['accuracy']:.4f} / {macro_accuracy(lex):.4f}; losses {stats['epoch_losses'][[0, -1]]}")
    assert abs(own["accuracy"] - pin["text-mlp"]["overall"]) <= 0.02
    assert abs(macro_accuracy(own) - pin["text-mlp"]["macro"]) <= 0.02
    assert round(lex["accuracy"], 3) == pin["lexicon"]["overall"]
    assert round(macro_accuracy(lex), 3) == pin["lexicon"]["macro"]
    # the same report as JAX's for the same backend
    assert lex == jeval.evaluate_text_backend(jte.LexiconClassifier())


def test_keyword_text_never_regresses_below_lexicon(trained):
    """The decision rule: where the lexicon's top category is unique and
    right, the classifier's is right too."""
    clf, _ = trained
    lex = tte.LexiconClassifier()
    checked = 0
    for split in ("eval", "train"):
        texts, cats = tcorpus.generate_text_corpus(split)
        for t, c in zip(texts[:2000], cats[:2000]):
            scores = lex.scores(t)
            top = max(scores, key=lambda k: scores[k])
            if scores[top] > 0 and list(scores.values()).count(scores[top]) == 1 and top == c:
                assert clf(t)[0][0]["label"] == c, t
                checked += 1
    assert checked > 100


# ---------------------------------------------------------------------------
# The backend configuration
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_backend(monkeypatch):
    for var in ("MELOGAN_TEXT_MODEL_DIR", "MELOGAN_TEXT_BACKEND", "MELOGAN_TEXT_MLP_CACHE"):
        monkeypatch.delenv(var, raising=False)
    tte.reset_backend()
    yield monkeypatch
    tte.reset_backend()


def test_backend_is_chosen_by_configuration(clean_backend, tmp_path):
    mp = clean_backend
    assert tte.backend_name() == "text-mlp"
    mp.setenv("MELOGAN_TEXT_MODEL_DIR", str(tmp_path))
    assert tte.backend_name() == "torch-roberta"
    mp.setenv("MELOGAN_TEXT_BACKEND", "text-mlp")
    assert tte.backend_name() == "text-mlp"
    mp.setenv("MELOGAN_TEXT_BACKEND", "lexicon")
    assert tte.backend_name() == "lexicon"
    info = tte.backend_info()
    assert info["measured_eval_accuracy"] == tte.MEASURED_EVAL_ACCURACY["lexicon"]
    assert f"{tte.MEASURED_EVAL_ACCURACY['lexicon']['overall']:.1%}" in info["note"]
    assert tte.predict_emotion("i am furious about this", device="cpu") == "angry"
    assert tte.predict_emotion("   ", device="cpu") == tte.DEFAULT_EMOTION
    mp.setenv("MELOGAN_TEXT_BACKEND", "jax-roberta")
    with pytest.raises(ValueError, match="MELOGAN_TEXT_BACKEND"):
        tte.backend_name()


def test_lexicon_and_map_match_jax(clean_backend):
    assert tte.TEXT_MODEL_TO_MY_EMOTIONS == jte.TEXT_MODEL_TO_MY_EMOTIONS
    assert tte.DEFAULT_EMOTION == jte.DEFAULT_EMOTION
    ours, theirs = tte.LexiconClassifier(), jte.LexiconClassifier()
    texts, _ = tcorpus.generate_text_corpus("train", seed=0)
    for t in texts[:500]:
        assert ours.scores(t) == theirs.scores(t) and ours(t) == theirs(t)


def test_load_or_train_uses_a_fingerprinted_cache(clean_backend, tmp_path, capsys):
    """A cache whose fingerprint matches is served as it is; a stale one is
    retrained over (shown here with a 1-epoch classifier under the shipped
    recipe's fingerprint, then a wrong one)."""
    mp = clean_backend
    path = str(tmp_path / "c.ckpt")
    quick = ttm.train_text_classifier(epochs=1, device="cpu")
    quick.fingerprint = ttm.training_fingerprint()
    quick.save(path)
    mp.setenv("MELOGAN_TEXT_MLP_CACHE", path)
    got = ttm.load_or_train(device="cpu")
    for k, v in quick.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k], v)
    assert tte.load_classifier("cpu").fingerprint == quick.fingerprint
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    mp.setattr(ttm, "train_text_classifier", lambda **kw: quick)
    assert ttm.load_or_train(device="cpu") is quick
    assert "unreadable" in capsys.readouterr().out
