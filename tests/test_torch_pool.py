"""The port's copies of the sample pool and the metrics registry against
the JAX package's (``melogan_tpu/serving/{pool,metrics}.py``), on a stub
sampler, and the pool's threads.

Every wait here is bounded: the pool's own calls take timeouts, and a
state reached by a background thread is polled for at most 10 s.
"""
import threading
import time

import numpy as np
import pytest

from melogan_tpu.serving import metrics as jmetrics
from melogan_tpu.serving import pool as jpool

from melogan_torch import EMOTIONS
from melogan_torch.serving import metrics, pool


class StubSampler:
    """Deterministic notes: each row encodes its emotion, the call's seed
    and its place in the batch; every call is recorded."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.calls = []
        self.lock = threading.Lock()

    def sample_notes(self, prompts, seed=0):
        with self.lock:
            self.calls.append((list(prompts), seed))
        if self.fail:
            raise RuntimeError("boom")
        return np.asarray([[[EMOTIONS.index(e) * 1e6 + seed * 1e3 + i]] for i, e in enumerate(prompts)],
                          np.float32)


def _pair(**kw):
    kw = dict(dict(target=3, refill_batch=4, max_refill=16, background=False), **kw)
    ours, theirs = StubSampler(), StubSampler()
    return (pool.SamplePool(ours, **kw), ours), (jpool.SamplePool(theirs, **kw), theirs)


def _poll(cond, secs=10.0):
    deadline = time.monotonic() + secs
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_pool_matches_jax_on_a_stub_sampler():
    """The same sequence on both pools (no producer thread): prefill, hits
    and cold misses across emotions, a flush, an adaptive refill: every
    sample, every depth, every ``stats()`` and every sampler call equal."""
    (p, ps), (j, js) = _pair()
    for q in (p, j):
        q.prefill(timeout=10)
    assert p.depth() == j.depth() == {e: 3 for e in EMOTIONS}
    seq = ["happy", "sad", "happy", "happy", "happy", "calm", "angry", "happy", "sad"]
    for e in seq:
        np.testing.assert_array_equal(p.take(e, timeout=5), j.take(e, timeout=5))
        assert p.depth() == j.depth() and p.stats() == j.stats()
    assert p.flush() == j.flush() > 0
    assert p.depth() == j.depth() == {e: 0 for e in EMOTIONS}
    for e in seq:  # cold misses after the flush: the take path refills
        np.testing.assert_array_equal(p.take(e, timeout=5), j.take(e, timeout=5))
    assert p.stats() == j.stats() and p.stats()["misses"] > 0
    assert ps.calls == js.calls
    assert [p._refill_size(n) for n in range(0, 40, 3)] == [j._refill_size(n) for n in range(0, 40, 3)]
    assert p.warm_sizes() == j.warm_sizes() == [4, 8, 16]
    with pytest.raises(ValueError, match="unknown emotion"):
        p.take("elated")


def test_pool_timeout_carries_the_last_error():
    """A sampler that always fails: ``take`` gives up at its deadline with
    ``PoolTimeout`` carrying the refill's last error, as JAX's does, and
    ``prefill`` of a threaded pool times out naming it."""
    errors = []
    for mod in (pool, jpool):
        q = mod.SamplePool(StubSampler(fail=True), target=2, refill_batch=2, background=False)
        t0 = time.monotonic()
        with pytest.raises(mod.PoolTimeout) as e:
            q.take("sad", timeout=0.3)
        assert time.monotonic() - t0 < 5
        errors.append((str(e.value), e.value.last_error, q.stats()["last_error"]))
    assert errors[0] == errors[1]
    assert errors[0][1] == "RuntimeError: boom"
    q = pool.SamplePool(StubSampler(fail=True), target=2, refill_batch=2)
    try:
        with pytest.raises(TimeoutError, match="boom"):
            q.prefill(timeout=0.5)
    finally:
        q.close()
    assert not q._thread.is_alive()


def test_producer_restocks_after_a_flush_and_close_joins_every_thread():
    """With its producer thread the pool refills itself after a flush;
    ``warm_async`` runs the refill ladder once (stocking up to 4×target);
    ``close`` stops and joins both threads."""
    sampler = StubSampler()
    q = pool.SamplePool(sampler, target=3, refill_batch=4, max_refill=8)
    try:
        q.prefill(timeout=10)
        assert q.take("calm", timeout=5).shape == (1, 1)
        assert q.flush() >= 3 * 4 - 1
        assert _poll(lambda: all(v >= 3 for v in q.depth().values()))
        warm = q.warm_async()
        assert _poll(lambda: q.stats()["warm"] == "done")
        assert max(q.depth().values()) <= 4 * 3 + 4
    finally:
        q.close()
    assert not q._thread.is_alive() and not warm.is_alive()
    seeds = [s for _, s in sampler.calls]
    assert len(seeds) == len(set(seeds))  # every call draws a fresh seed


def test_metrics_render_equals_jax():
    """The same counters, histogram observations and gauges on both
    registries render the same Prometheus text, up to the uptime line."""
    def fill(reg):
        reg.counter_inc("melogan_http_requests_total", help="HTTP requests by route/method/status",
                        route="/generate", method="POST", status="200")
        reg.counter_inc("melogan_http_requests_total", help="HTTP requests by route/method/status",
                        route="other", method="other", status="404")
        reg.counter_inc("melogan_reloads_total", help="Successful checkpoint hot-swaps", value=2)
        for v in (0.0003, 0.004, 0.2, 7.0, 30.0):
            reg.observe("melogan_http_request_duration_seconds", v, help="Handler latency", route="/generate")
        reg.gauge_fn("melogan_pool_depth", lambda: {"happy": 3, "sad": 0}, help="depth")
        reg.gauge_fn("melogan_pool_hits_total", lambda: 5, help="hits", typ="counter")
        reg.gauge_fn("broken", lambda: 1 / 0)
        reg.gauge_fn("ratio", lambda: 0.25)
        return "\n".join(ln for ln in reg.render().splitlines() if "process_uptime_seconds" not in ln)

    ours, theirs = fill(metrics.Registry()), fill(jmetrics.Registry())
    assert ours == theirs
    assert 'melogan_http_request_duration_seconds_bucket{route="/generate",le="+Inf"} 5' in ours
    assert "broken" not in ours
