"""The program's spans (``melogan_torch/utils/profiling.py``): free while no
profiler records, kept in memory with their parent and root while one
does, on the trace's clock, at the sampler's and the trainer's layer
boundaries. CPU at tiny sizes, torch on one thread; the copy to page-locked
memory exists only on a card, so its spans have a test marked ``cuda``.
This file imports neither JAX nor the JAX package; on a machine with a card:

    python -m pytest tests/test_torch_tracing.py --noconftest -q
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from melogan_torch.config import GANConfig
from melogan_torch.sampling import Sampler
from melogan_torch.train import gan_loop, gan_step
from melogan_torch.utils import profiling
from melogan_torch.utils.profiling import span

TINY = dict(max_notes=64, batch_size=4, noise_dim=16, latent_dim=8, gen_hidden=32,
            encoder_hidden=(16, 8), encoder_out_dim=8)
SAMPLER_TREE = {
    "sampler.sample_notes": None,
    "sampler.index": "sampler.sample_notes",
    "sampler.draw": "sampler.sample_notes",
    "sampler.forward": "sampler.sample_notes",
    "sampler.to_host": "sampler.sample_notes",
    "gan.feature_encoder": "sampler.forward",
    "gan.noise_to_latent": "sampler.forward",
    "gan.decoder.pre": "sampler.forward",
    "gan.decoder.tail": "sampler.forward",
}
HOST_COPY = {"sampler.pin_alloc": "sampler.to_host", "sampler.copy": "sampler.to_host"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _by_index(records):
    return {r["index"]: r for r in records}


def _parent_name(rec, index):
    return None if rec["parent"] is None else index[rec["parent"]]["name"]


def test_span_is_the_shared_noop_without_a_profiler():
    assert span("a") is span("b")
    with span("a"), span("b"):
        pass
    assert profiling.span_table() == {} and profiling.span_records() == []


def test_spans_record_name_parent_root_and_self_time_on_two_threads():
    def work(tag):
        with span(f"{tag}.outer"):
            time.sleep(0.002)
            with span(f"{tag}.inner"):
                time.sleep(0.003)
            with span(f"{tag}.inner"):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        other = threading.Thread(target=work, args=("side",))
        other.start()
        work("main")
        other.join(timeout=30)
    assert not other.is_alive()
    recs = profiling.span_records()
    index = _by_index(recs)
    assert sorted(r["name"] for r in recs) == ["main.inner", "main.inner", "main.outer",
                                               "side.inner", "side.inner", "side.outer"]
    for tag in ("main", "side"):
        outer = [r for r in recs if r["name"] == f"{tag}.outer"][0]
        inner = [r for r in recs if r["name"] == f"{tag}.inner"]
        assert outer["parent"] is None and outer["root"] == outer["index"]
        assert all(r["parent"] == outer["index"] and r["root"] == outer["index"] for r in inner)
        assert all(r["thread"] == outer["thread"] for r in inner)
        assert all(outer["start_ns"] <= r["start_ns"] <= r["end_ns"] <= outer["end_ns"] for r in inner)
        row = profiling.span_table()[f"{tag}.outer"]
        covered = sum(r["end_ns"] - r["start_ns"] for r in inner)
        assert row["count"] == 1
        assert row["host_s"] == pytest.approx((outer["end_ns"] - outer["start_ns"]) * 1e-9)
        assert row["self_s"] == pytest.approx(row["host_s"] - covered * 1e-9)
        assert 0.002 <= row["self_s"] and 0.003 <= profiling.span_table()[f"{tag}.inner"]["host_s"]
    main, side = (index[r["root"]]["thread"] for r in recs if r["name"].endswith("outer"))
    assert main != side
    profiling.reset()
    assert profiling.span_table() == {} and profiling.dropped() == 0


def test_spans_of_many_threads_keep_every_record_and_link():
    threads, spans = 16, 100

    def work():
        for _ in range(spans):
            with span("outer"):
                with span("inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    recs = profiling.span_records()
    assert [r["index"] for r in recs] == list(range(2 * threads * spans))
    index = _by_index(recs)
    for r in recs:
        if r["name"] == "inner":
            outer = index[r["parent"]]
            assert outer["name"] == "outer" and outer["thread"] == r["thread"] and r["root"] == outer["index"]
    assert profiling.span_table()["inner"]["count"] == threads * spans


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
        with span("d"):
            pass
    assert [r["name"] for r in profiling.span_records()] == ["a", "b"]
    assert profiling.dropped() == 2


def _check_tree(records, tree):
    index = _by_index(records)
    assert {r["name"] for r in records} == set(tree)
    for r in records:
        assert _parent_name(r, index) == tree[r["name"]], r["name"]
        root = index[r["root"]]
        assert root["name"] == "sampler.sample_notes" and root["start_ns"] <= r["start_ns"]


def _check_on_trace_clock(trace_dir, records):
    """Each record's interval, on the trace's clock, lies inside its trace
    event (the same name, in order) widened by 1 ms."""
    trace = json.loads((trace_dir / profiling.TRACE_FILE).read_text())
    base_us = trace["baseTimeNanoseconds"] / 1000
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for name in {r["name"] for r in records}:
        recs = sorted((r for r in records if r["name"] == name), key=lambda r: r["start_ns"])
        evs = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        assert len(evs) == len(recs), name
        for r, e in zip(recs, evs):
            lo, hi = base_us + e["ts"] - 1000, base_us + e["ts"] + e["dur"] + 1000
            assert lo <= r["start_ns"] / 1000 <= r["end_ns"] / 1000 <= hi, name


def _traced_calls(sampler, trace_dir, calls=2):
    with profiling.device_trace(str(trace_dir)):
        for seed in range(calls):
            sampler.sample_notes(["happy", "sad", "calm"], seed=seed)
    return json.loads((trace_dir / profiling.SPANS_FILE).read_text())


def test_sampler_spans_nest_and_lie_on_the_trace_clock(tmp_path):
    sampler = Sampler(GANConfig(**TINY), seed=0, device="cpu")
    sampler.sample_notes(["happy"], seed=0)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):  # device_trace forgets what came before it
        with span("before"):
            pass
    written = _traced_calls(sampler, tmp_path)
    assert written["dropped"] == 0
    assert written["table"] == json.loads(json.dumps(profiling.span_table()))
    assert written["records"] == profiling.span_records()
    records = written["records"]
    _check_tree(records, SAMPLER_TREE)
    assert written["table"]["sampler.sample_notes"]["count"] == 2
    assert len({r["root"] for r in records}) == 2  # one id a call
    _check_on_trace_clock(tmp_path, records)
    sampler.sample_notes(["angry"], seed=3)  # no profiler: nothing recorded
    assert profiling.span_records() == records


@pytest.mark.cuda
def test_sampler_spans_on_the_card_hold_the_page_locked_copy(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    sampler = Sampler(GANConfig(**TINY), seed=0, device="cuda")
    sampler.sample_notes(["happy"], seed=0)
    records = _traced_calls(sampler, tmp_path)["records"]
    _check_tree(records, {**SAMPLER_TREE, **HOST_COPY, "ops.decoder_tail": "gan.decoder.tail"})
    _check_on_trace_clock(tmp_path, records)


def test_group_step_spans_count_the_updates():
    cfg = GANConfig(**TINY, ema_decay=0.9)
    state = gan_step.init_state(cfg, gan_step.build_models(cfg), seed=0, device="cpu")
    steps = gan_step.make_train_steps(cfg)
    rng = np.random.default_rng(0)
    k, b, n = cfg.critic_iters, cfg.batch_size, 3 * cfg.batch_size * cfg.critic_iters
    corpus = (rng.normal(size=(n, cfg.max_notes, cfg.note_dim)).astype(np.float32),
              rng.integers(0, 4, size=n).astype(np.int64),
              rng.normal(size=(n, cfg.latent_dim)).astype(np.float32),
              rng.normal(size=(n, cfg.numeric_input_dim)).astype(np.float32))
    gather = gan_loop.device_gather(corpus, torch.device("cpu"))
    idx = rng.permutation(n)[:k * b].reshape(k, b)
    with profile(activities=[ProfilerActivity.CPU]):
        steps.group(state, gather(idx))
    table = profiling.span_table()
    counts = {name: row["count"] for name, row in table.items()}
    assert counts == {"gan.gather": 1, "gan.group": 1, "gan.number_nodes": 1, "gan.critic_update": k,
                      "gan.fake": k, "gan.penalty": k, "gan.gen_update": 1, "gan.apply": k + 1,
                      "gan.adam": k + 1, "gan.ema": 1, "gan.feature_encoder": k + 1,
                      "gan.noise_to_latent": k + 1, "gan.decoder.pre": k + 1, "gan.decoder.tail": k + 1}
    records = profiling.span_records()
    index = _by_index(records)
    group = [r for r in records if r["name"] == "gan.group"][0]
    parents = {"gan.adam": {"gan.apply"}, "gan.apply": {"gan.critic_update", "gan.gen_update"},
               "gan.fake": {"gan.critic_update"}, "gan.penalty": {"gan.critic_update"},
               "gan.critic_update": {"gan.group"}, "gan.gen_update": {"gan.group"}}
    for r in records:
        if r["name"] == "gan.gather":
            continue
        assert r["root"] == group["index"], r["name"]  # one id a group
        if r["name"] in parents:
            assert _parent_name(r, index) in parents[r["name"]], r["name"]
    assert table["gan.group"]["self_s"] < table["gan.group"]["host_s"]
