"""The sample call's host staging (``melogan_torch/sampling.py``): emotion
names to indices by a table, and the notes landed on the host. The card's
own landing (page-locked, no ``cudaHostAlloc`` on a warm call) has tests
marked ``cuda``. This file imports neither JAX nor the JAX package; on a
machine with a card:

    python -m pytest tests/test_torch_staging.py --noconftest -q
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.sampling import Sampler, emotion_indices

TINY = dict(max_notes=64, batch_size=4, noise_dim=16, latent_dim=8, gen_hidden=32,
            encoder_hidden=(16, 8), encoder_out_dim=8)


def parent_indices(emotions):
    """The name check and indices as ``sample_notes`` made them before the
    table: the reference."""
    unknown = [e for e in emotions if e not in EMOTIONS]
    if unknown:
        raise ValueError(f"unknown emotion(s) {unknown}; valid emotions are {list(EMOTIONS)}")
    return torch.as_tensor([EMOTIONS.index(e) for e in emotions])


@pytest.mark.parametrize("emotions", [
    [EMOTIONS[i % 4] for i in range(2048)],
    ["calm", "happy", "calm", "angry", "sad"],
    [np.str_("sad"), np.str_("angry"), "happy"],
    ["happy", "elated"],
    ["elated", "happy", None, "zz", "Happy"],
    ["happy", ["sad"], {"calm": 1}],
    [],
], ids=["valid-2048", "valid", "numpy-str", "one-unknown", "several-unknown", "unhashable", "empty"])
def test_emotion_indices_are_the_parent_indices_or_its_error(emotions):
    try:
        want = parent_indices(emotions).numpy()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            emotion_indices(emotions)
        assert str(got.value) == str(e)
        return
    got = emotion_indices(emotions)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_sample_notes_rows_follow_the_indices():
    sampler = Sampler(GANConfig(**TINY), seed=0, device="cpu")
    emotions = ["sad", "calm", np.str_("happy"), "angry", "sad"]
    notes = sampler.sample_notes(emotions, seed=3)
    idx = torch.as_tensor([EMOTIONS.index(e) for e in emotions])
    np.testing.assert_array_equal(notes, torch.cat(sampler._step(idx, 3)).numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the page-locked landing exists only on a card")
    return torch.device("cuda")


def _runtime_calls(prof, tmp_path):
    """Names of the CUDA runtime calls in a ``torch.profiler`` trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("ph") == "X" and str(e.get("cat", "")).startswith("cuda_")]


@pytest.mark.cuda
def test_a_warm_call_on_the_card_page_locks_nothing_anew(cuda, tmp_path):
    sampler = Sampler(GANConfig(), seed=0, device="cuda")
    emotions = [EMOTIONS[i % 4] for i in range(2048)]
    sampler.sample_notes(emotions, seed=1)  # build, warm, allocate
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        notes = sampler.sample_notes(emotions, seed=2)
    calls = _runtime_calls(prof, tmp_path)
    assert "cudaLaunchKernel" in calls and "cudaHostAlloc" not in calls
    assert notes.shape == (2048, 512, 4)
    idx = torch.from_numpy(emotion_indices(emotions)).to(cuda)
    plain = sampler._step(idx, 2)[0].cpu().numpy()
    np.testing.assert_array_equal(notes, plain)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_rows_held_survive_the_next_call(device, request):
    if device == "cuda":
        request.getfixturevalue("cuda")
    cfg = GANConfig() if device == "cuda" else GANConfig(**TINY)
    sampler = Sampler(cfg, seed=0, device=device)
    emotions = [EMOTIONS[i % 4] for i in range(2048 if device == "cuda" else 8)]
    row = sampler.sample_notes(emotions, seed=1)[0]
    kept = row.copy()
    later = sampler.sample_notes(emotions, seed=2)
    assert not np.shares_memory(row, later)
    np.testing.assert_array_equal(row, kept)
    assert not np.array_equal(later[0], kept)
