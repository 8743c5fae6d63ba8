"""The port's RoBERTa text backend against the JAX module and HF torch, on
the CPU, at a tiny width (2 layers, hidden 32, 2 heads): logits, padding,
position ids, the checkpoint readers (the port's safetensors reader against
``safetensors.numpy``, ``.bin`` against ``.safetensors``), the classifier
end to end and the ``torch-roberta`` backend.

Tolerance: 1e-5 absolute on logits of scale about 0.1-1 (f32 in different
summation orders agrees to about 1e-7 here; a wrong GELU, mask or position
offset is O(1e-2)).
"""
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.models import roberta as jrob

from melogan_torch.models import roberta as trob
from melogan_torch.models import text_emotion as tte
from melogan_torch.utils import safetensors as tsafe
from melogan_torch.utils.weights import roberta_state_from_jax

ATOL = 1e-5
GO_EMOTIONS_LABELS = [
    "admiration", "amusement", "anger", "annoyance", "approval", "caring",
    "confusion", "curiosity", "desire", "disappointment", "disapproval",
    "disgust", "embarrassment", "excitement", "fear", "gratitude", "grief",
    "joy", "love", "nervousness", "optimism", "pride", "realization",
    "relief", "remorse", "sadness", "surprise", "neutral",
]
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=66, num_labels=28)


def _ids_and_mask(rng, vocab=64):
    ids = rng.integers(4, vocab, size=(3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    ids[1, 8:], mask[1, 8:] = 1, 0  # padded rows
    ids[2, 5:], mask[2, 5:] = 1, 0
    return ids, mask


def _port_model(cfg, sd):
    model = trob.RobertaForSequenceClassification(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return model.eval()


def _logits(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def test_forward_matches_jax_on_init_params(rng):
    cfg = trob.RobertaConfig(**TINY)
    params = jrob.init_params(jrob.RobertaConfig(**TINY), jax.random.PRNGKey(0))
    # non-trivial norms and biases, so every parameter's mapping matters
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), params)
    ids, mask = _ids_and_mask(rng)
    want = np.asarray(jrob.forward(params, jrob.RobertaConfig(**TINY), jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask, jnp.int32)))
    got = _logits(_port_model(cfg, roberta_state_from_jax(params)), ids, mask)
    assert got.shape == (3, 28) and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_position_ids_match_jax():
    ids = np.asarray([[0, 5, 7, 2, 1, 1], [0, 9, 2, 1, 1, 1]], np.int64)
    got = trob.position_ids_from_input_ids(torch.from_numpy(ids), pad_token_id=1).numpy()
    np.testing.assert_array_equal(got, [[2, 3, 4, 5, 1, 1], [2, 3, 4, 1, 1, 1]])
    np.testing.assert_array_equal(
        got, np.asarray(jrob.position_ids_from_input_ids(jnp.asarray(ids, jnp.int32), 1)))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny random HF checkpoint saved both ways (``model.safetensors`` in
    one directory, ``pytorch_model.bin`` in another) with a WordLevel
    tokenizer, as ``tests/test_roberta.py`` builds one."""
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing
    from transformers import RobertaConfig as HFConfig
    from transformers import RobertaForSequenceClassification

    d = tmp_path_factory.mktemp("tiny_roberta")
    hf_cfg = HFConfig(**TINY, pad_token_id=1, id2label=dict(enumerate(GO_EMOTIONS_LABELS)),
                      label2id={l: i for i, l in enumerate(GO_EMOTIONS_LABELS)})
    torch.manual_seed(0)
    model = RobertaForSequenceClassification(hf_cfg).eval()
    with torch.no_grad():  # non-trivial norms and biases
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(str(d / "st"), safe_serialization=True)
    model.save_pretrained(str(d / "bin"), safe_serialization=False)

    words = ["i", "am", "so", "happy", "sad", "angry", "furious", "today",
             "feeling", "very", "down", "great", "it", "is", "calm"]
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: 4 + i for i, w in enumerate(words)})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.post_processor = TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    for sub in ("st", "bin"):
        tok.save(str(d / sub / "tokenizer.json"))
    assert os.path.exists(d / "st" / "model.safetensors") and os.path.exists(d / "bin" / "pytorch_model.bin")
    return str(d / "st"), str(d / "bin"), model


def test_forward_matches_hf_torch(tiny_ckpt, rng):
    st_dir, _, hf = tiny_ckpt
    ids, mask = _ids_and_mask(rng)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).logits.numpy()
    cfg = trob.RobertaConfig.from_json(os.path.join(st_dir, "config.json"))
    assert cfg.num_labels == 28 and cfg.num_hidden_layers == 2
    got = _logits(_port_model(cfg, trob.load_hf_checkpoint(st_dir)), ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # and the HF state dict itself loads strictly under the port's names
    hf_sd = {k: v for k, v in hf.state_dict().items() if k not in trob._HF_BUFFERS}
    np.testing.assert_allclose(_logits(_port_model(cfg, hf_sd), ids, mask), want, rtol=0, atol=ATOL)


def test_padding_is_inert(tiny_ckpt, rng):
    st_dir, _, _ = tiny_ckpt
    cfg = trob.RobertaConfig.from_json(os.path.join(st_dir, "config.json"))
    model = _port_model(cfg, trob.load_hf_checkpoint(st_dir))
    ids = rng.integers(4, 64, size=(1, 8)).astype(np.int64)
    mask = np.ones((1, 8), np.int64)
    base = _logits(model, ids, mask)
    padded = _logits(model, np.concatenate([ids, np.full((1, 6), cfg.pad_token_id)], 1),
                     np.concatenate([mask, np.zeros((1, 6), np.int64)], 1))
    np.testing.assert_allclose(padded, base, rtol=0, atol=ATOL)


def test_safetensors_reader_matches_the_library(tiny_ckpt, tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_dir, _, _ = tiny_ckpt
    path = os.path.join(st_dir, "model.safetensors")
    want, got = st_numpy.load_file(path), tsafe.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    # every dtype numpy has, scalars and empty tensors, with metadata
    rng = np.random.default_rng(0)
    mixed = {"f64": rng.normal(size=(2, 3)), "f16": rng.normal(size=(5,)).astype(np.float16),
             "i64": np.arange(6, dtype=np.int64).reshape(3, 2), "i8": np.array([-3, 4], np.int8),
             "u8": np.arange(7, dtype=np.uint8), "b": np.array([True, False]),
             "scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 4), np.float32)}
    p2 = str(tmp_path / "mixed.safetensors")
    st_numpy.save_file(mixed, p2, metadata={"format": "np"})
    got = tsafe.load_file(p2)
    for k, v in st_numpy.load_file(p2).items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    with open(p2, "rb") as f:
        head = f.read(64)
    with open(tmp_path / "short.safetensors", "wb") as f:
        f.write(head)
    with pytest.raises(ValueError):
        tsafe.load_file(str(tmp_path / "short.safetensors"))


def test_safetensors_reader_widens_bf16(tmp_path):
    vals = torch.tensor([1.5, -2.25, 3.0e-3, 65504.0], dtype=torch.bfloat16)
    raw = vals.view(torch.int16).numpy().tobytes()
    header = json.dumps({"x": {"dtype": "BF16", "shape": [4], "data_offsets": [0, len(raw)]}}).encode()
    path = str(tmp_path / "bf16.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + raw)
    got = tsafe.load_file(path)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vals.float().numpy())


def test_bin_and_safetensors_give_the_same_module(tiny_ckpt, tmp_path):
    st_dir, bin_dir, _ = tiny_ckpt
    a, b = trob.load_hf_checkpoint(st_dir), trob.load_hf_checkpoint(bin_dir)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # older checkpoints name the encoder without the roberta. prefix
    old = tmp_path / "old"
    shutil.copytree(st_dir, old)
    os.remove(old / "model.safetensors")
    torch.save({k.removeprefix("roberta."): v for k, v in a.items()}
               | {"embeddings.position_ids": torch.arange(66)[None]}, old / "pytorch_model.bin")
    c = trob.load_hf_checkpoint(str(old))
    assert sorted(c) == sorted(a) and all(torch.equal(a[k], c[k]) for k in a)
    with pytest.raises(FileNotFoundError):
        trob.load_hf_checkpoint(str(tmp_path))


def test_classifier_matches_jax_end_to_end(tiny_ckpt):
    """tokenizer → bucket pad → forward → label: the port's classifier and
    the JAX one on the same directory."""
    st_dir, _, _ = tiny_ckpt
    ours, theirs = trob.RobertaTextClassifier(st_dir, device="cpu"), jrob.RobertaTextClassifier(st_dir)
    texts = ["i am so happy today", "i am feeling very very down today", "it is calm", "unknown words"]
    np.testing.assert_allclose(ours.logits(texts), theirs.logits(texts), rtol=0, atol=ATOL)
    assert ours.logits(texts).shape == (4, 28)
    for t in texts:
        a, b = ours(t)[0][0], theirs(t)[0][0]
        assert a["label"] == b["label"] and a["label"] in GO_EMOTIONS_LABELS
        assert abs(a["score"] - b["score"]) <= ATOL
    assert ours._max_len == theirs._max_len


def test_torch_roberta_backend(tiny_ckpt, monkeypatch, tmp_path):
    """MELOGAN_TEXT_MODEL_DIR selects torch-roberta; its answers are in the
    4-emotion map; a broken directory raises rather than serving another
    backend."""
    st_dir, _, _ = tiny_ckpt
    monkeypatch.delenv("MELOGAN_TEXT_BACKEND", raising=False)
    monkeypatch.setenv("MELOGAN_TEXT_MODEL_DIR", st_dir)
    tte.reset_backend()
    try:
        assert tte.backend_name() == "torch-roberta"
        info = tte.backend_info()
        assert "measured_eval_accuracy" not in info and "RoBERTa" in info["note"]
        assert tte.predict_emotion("i am so happy today", device="cpu") in ("happy", "sad", "angry", "calm")
        assert isinstance(tte.load_classifier("cpu"), trob.RobertaTextClassifier)
        assert tte.predict_emotion("", device="cpu") == "calm"
        monkeypatch.setenv("MELOGAN_TEXT_MODEL_DIR", str(tmp_path))  # no checkpoint there
        with pytest.raises(FileNotFoundError):
            tte.predict_emotion("i am so happy today", device="cpu")
    finally:
        tte.reset_backend()
