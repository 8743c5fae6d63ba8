"""Sample pool: batched, prefetched generation for low-latency serving.

The port's copy of ``melogan_tpu/serving/pool.py`` (numpy and threading
only). Generation has no per-request input besides the emotion name (noise
and feature jitter are server-side randomness), so requests do not need a
device call of their own:

- a background producer keeps a per-emotion pool of pre-generated note
  arrays topped up, generating in large device batches, so the fixed host
  cost of a ``sample_notes`` call is shared by many samples
- ``/generate`` pops a unique fresh sample, so the request path holds no
  device call, only the MIDI encoding
- cold misses coalesce: concurrent missers block on one refill lock and a
  single batched call serves them all, instead of N serial batch-1 calls

Every served sample is statistically identical to the direct path: same
per-emotion feature jitter and fresh noise, unique seeds (a global
counter), each sample served exactly once. ``close`` stops the producer and
the ``warm_async`` thread, each within a bounded join.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from melogan_torch import EMOTIONS


class PoolTimeout(RuntimeError):
    """Raised by :meth:`SamplePool.take` when the pool cannot produce a sample
    within the deadline (persistently failing sampler). Carries the producer's
    last error so the serving layer can surface it in a 503."""

    def __init__(self, message: str, last_error: Optional[str] = None):
        super().__init__(message)
        self.last_error = last_error


class SamplePool:
    """Per-emotion pool of pre-generated (max_notes, 4) note arrays."""

    def __init__(
        self,
        sampler,
        target: int = 64,
        refill_batch: int = 256,
        max_refill: int = 2048,
        emotions: Optional[List[str]] = None,
        background: bool = True,
        seed: int = 0x5EED,
        take_timeout: float = 10.0,
    ):
        self.sampler = sampler
        self.target = int(target)
        self.take_timeout = float(take_timeout)
        self.refill_batch = max(int(refill_batch), self.target)
        # adaptive sizing: under sustained load the refill batch grows toward
        # the drain rate (up to max_refill), amortizing the per-dispatch
        # round trip — sustained throughput approaches the device's
        # large-batch sampling rate instead of refill_batch/RTT. max_refill
        # also bounds the worst-case cold-miss wait: a misser blocks behind
        # at most one max_refill dispatch+transfer (2048 samples ≈ 16 MB)
        self.max_refill = max(int(max_refill), self.refill_batch)
        self._drained = 0  # takes since the last refill
        # bumped by flush(): a refill that sampled under an older generation
        # (i.e. with pre-hot-swap weights) discards its batch instead of
        # stocking stale samples after the flush
        self._generation = 0
        self.emotions = list(emotions or EMOTIONS)
        self._pools: Dict[str, deque] = {e: deque() for e in self.emotions}
        self._lock = threading.Lock()  # protects pools + seed counter
        self._stocked = threading.Condition(self._lock)  # signaled on refill
        self._refill_lock = threading.Lock()  # serializes device dispatches
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._seed = seed
        self._last_error: Optional[str] = None
        self._warm_state = "idle"  # idle | in-progress | done | stopped | error: ...
        self.hits = 0
        self.misses = 0
        self._thread = None
        self._warm_thread: Optional[threading.Thread] = None
        if background:
            self._thread = threading.Thread(
                target=self._producer, name="sample-pool", daemon=True
            )
            self._thread.start()

    # -- internals ----------------------------------------------------------

    def _next_seed(self) -> int:
        with self._lock:
            self._seed += 1
            return self._seed

    def _low_emotions(self) -> List[str]:
        with self._lock:
            return [e for e in self.emotions if len(self._pools[e]) < self.target]

    def _refill_size(self, requested: int) -> int:
        """Quantize the adaptive refill size to power-of-two multiples of
        ``refill_batch``, so that the batch sizes a server ever runs are
        log2(max_refill/refill_batch)+1 (each one a first call of its own:
        allocations and library heuristics), while still scaling with the
        drain rate."""
        size = self.refill_batch
        while size < requested and size < self.max_refill:
            size *= 2
        return min(size, self.max_refill)

    def _refill(self, emotions: List[str]) -> None:
        """One batched device dispatch covering every low emotion; batch size
        adapts (quantized) to the drain rate since the previous refill."""
        if not emotions:
            return
        with self._refill_lock:
            self._refill_locked(emotions)

    def _refill_locked(self, emotions: List[str]) -> None:
        """Refill body; caller must hold :attr:`_refill_lock` (split out so
        :meth:`take` can use a TIMED lock acquire and stay deadline-bounded
        even when another thread's dispatch is hung)."""
        # a concurrent refill may have stocked these emotions while we
        # waited on the lock — re-check so N coalesced missers cost ONE
        # dispatch, not N serial ones
        with self._lock:
            emotions = [e for e in emotions if len(self._pools[e]) < self.target]
            if not emotions:
                # a concurrent refill covered everything: keep the drain
                # count so the NEXT dispatch still sizes to the real rate
                return
            drained, self._drained = self._drained, 0
            generation = self._generation
        size = self._refill_size(max(self.refill_batch, 2 * drained))
        # round-robin so the total is exactly the quantized size
        prompts = [emotions[i % len(emotions)] for i in range(size)]
        notes = self.sampler.sample_notes(prompts, seed=self._next_seed())
        with self._lock:
            if self._generation != generation:
                # flush() ran while we were sampling: this batch came from
                # the pre-swap weights — drop it (and restore the drain count
                # so the NEXT dispatch still sizes to the real rate); the
                # pools stay low, so a fresh-weights refill follows at once
                self._drained += drained
                return
            for e, row in zip(prompts, notes):
                self._pools[e].append(row)
            self._stocked.notify_all()

    def _producer(self) -> None:
        while not self._stop.is_set():
            low = self._low_emotions()
            if low:
                try:
                    self._refill(low)
                    with self._lock:
                        self._last_error = None
                except Exception as e:  # noqa: BLE001 — keep the producer alive
                    msg = f"{type(e).__name__}: {e}"
                    with self._lock:
                        first = msg != self._last_error
                        self._last_error = msg
                    if first:  # once per distinct error, not per 0.5 s retry
                        import traceback

                        print(f"[sample-pool] refill failed: {msg}", file=sys.stderr)
                        traceback.print_exc()
                    self._stop.wait(0.5)
            else:
                self._wakeup.wait(timeout=0.25)
                self._wakeup.clear()

    # -- public -------------------------------------------------------------

    def take(self, emotion: str, timeout: Optional[float] = None) -> np.ndarray:
        """Pop one fresh sample (generating a coalesced batch on a miss).

        The cold-miss path is bounded: if the sampler keeps failing past
        ``timeout`` seconds (default :attr:`take_timeout`), or another
        thread's refill dispatch is hung holding the refill lock, raises
        :class:`PoolTimeout` carrying the last refill error instead of
        blocking forever — a request-path hang is worse than a slow p99.
        (The one unboundable case: THIS thread's own in-flight sampler
        dispatch hanging — a blocked device call cannot be interrupted from
        Python. With a background producer the request thread never
        dispatches unless it wins the timed lock, so a wedged device
        surfaces as a 503 here, not a stuck request.)"""
        if emotion not in self._pools:
            raise ValueError(f"unknown emotion {emotion!r}; valid: {self.emotions}")
        with self._lock:
            if self._pools[emotion]:
                self.hits += 1
                self._drained += 1
                note = self._pools[emotion].popleft()
                self._wakeup.set()
                return note
            self.misses += 1
            self._drained += 1
        # cold miss: coalesce with any concurrent missers on the refill lock
        deadline = time.monotonic() + (self.take_timeout if timeout is None else timeout)
        while True:
            with self._lock:
                if self._pools[emotion]:
                    return self._pools[emotion].popleft()
                last = self._last_error
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                detail = f" (last refill error: {last})" if last else ""
                raise PoolTimeout(
                    f"no {emotion!r} sample within deadline{detail}", last_error=last
                )
            # TIMED acquire: a stuck dispatch in another thread (wedged
            # device, a first-call kernel build) holds _refill_lock for minutes;
            # a blocking acquire here would defeat the deadline
            if not self._refill_lock.acquire(timeout=min(0.1, remaining)):
                # someone else is dispatching — wait (bounded) for their stock
                with self._stocked:
                    if not self._pools[emotion]:
                        self._stocked.wait(timeout=min(0.25, remaining))
                continue
            failed = False
            try:
                self._refill_locked([emotion])
                # a take-path refill that succeeds resolves any prior incident
                # (mirrors the producer) — without this, background=False
                # pools report a long-stale error on later unrelated timeouts
                with self._lock:
                    self._last_error = None
            except Exception as e:  # noqa: BLE001 — deadline the failure, don't 500
                msg = f"{type(e).__name__}: {e}"
                with self._lock:
                    self._last_error = msg
                failed = True
            finally:
                self._refill_lock.release()
            if failed:
                # brief backoff (AFTER releasing the refill lock — other
                # missers and the producer must not stall behind the sleep)
                # so a hot-failing sampler doesn't spin the CPU
                time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))

    def warm_sizes(self) -> List[int]:
        """The quantized refill-size ladder (each size a first call of its
        own): exactly the values :meth:`_refill_size` can return —
        doubling from ``refill_batch``, clamped to ``max_refill``, which is
        itself included even when it is not a power-of-two multiple."""
        sizes, s = [], self.refill_batch
        while s < self.max_refill:
            sizes.append(s)
            s *= 2
        sizes.append(self.max_refill)
        return sizes

    def warm_async(self, depth_cap: Optional[int] = None) -> threading.Thread:
        """Run the whole refill ladder once in a background thread.

        Without this, the FIRST time load pushes the adaptive refill to a new
        batch size, that call pays its first-call costs (allocations, library
        heuristics) while cold missers wait it out. Warmed samples are real
        and stocked up to ``depth_cap`` per emotion (default 4×target); the
        rest are discarded — the point is the first calls, not depth."""
        cap = 4 * self.target if depth_cap is None else int(depth_cap)

        def _warm():
            self._warm_state = "in-progress"
            try:
                for size in self.warm_sizes():
                    if self._stop.is_set():
                        self._warm_state = "stopped"
                        return
                    prompts = [self.emotions[i % len(self.emotions)] for i in range(size)]
                    with self._refill_lock:
                        with self._lock:
                            generation = self._generation
                        notes = self.sampler.sample_notes(prompts, seed=self._next_seed())
                        with self._lock:
                            if self._generation != generation:
                                continue  # flushed mid-warm: drop the stale samples
                            for e, row in zip(prompts, notes):
                                if len(self._pools[e]) < cap:
                                    self._pools[e].append(row)
                            self._stocked.notify_all()
                self._warm_state = "done"
            except Exception as e:  # noqa: BLE001 — warm failure must not kill serving
                self._warm_state = f"error: {type(e).__name__}: {e}"

        t = threading.Thread(target=_warm, name="sample-pool-warm", daemon=True)
        t.start()
        self._warm_thread = t
        return t

    def flush(self) -> int:
        """Discard every pooled sample (returns how many were dropped) and
        wake the producer to restock. Required after a checkpoint hot-swap:
        pooled notes were generated by the OLD weights and must not be served
        as output of the new ones. Also bumps the pool generation so an
        IN-FLIGHT refill/warm dispatch that sampled under the old weights
        drops its batch instead of restocking stale samples post-flush."""
        with self._lock:
            dropped = sum(len(q) for q in self._pools.values())
            for q in self._pools.values():
                q.clear()
            self._generation += 1
        self._wakeup.set()
        return dropped

    def depth(self) -> Dict[str, int]:
        with self._lock:
            return {e: len(q) for e, q in self._pools.items()}

    def stats(self) -> Dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "depth": {e: len(q) for e, q in self._pools.items()},
                "target": self.target,
                "warm": self._warm_state,
                "last_error": self._last_error,
            }

    def prefill(self, timeout: float = 60.0) -> None:
        """Block until every emotion reaches its target depth (warm-up)."""
        t0 = time.monotonic()
        while self._low_emotions():
            if self._thread is None:
                self._refill(self._low_emotions())
            elif time.monotonic() - t0 > timeout:
                with self._lock:
                    detail = f" (last refill error: {self._last_error})" if self._last_error else ""
                raise TimeoutError(f"sample pool prefill timed out{detail}")
            else:
                time.sleep(0.01)

    def close(self) -> None:
        """Stop the producer and the warm thread (which stops between batch
        sizes) and join each for at most 5 s."""
        self._stop.set()
        self._wakeup.set()
        for t in (self._thread, self._warm_thread):
            if t is not None:
                t.join(timeout=5)
