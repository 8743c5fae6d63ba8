"""Cells of ``sample`` traffic: a closed loop of bulk ``Sampler.sample_notes``
calls, one client, each call ``rows_per_call`` emotion rows in and the notes
on the host out.

End-to-end: ``samples_per_s`` (rows of the calls completed in the window
over the window, first call's start to last call's end) and
``sample_p95_ms`` (95th percentile, nearest rank, of every call's latency).
``correct``: a sample of the window's calls, drawn from the seed by a
reservoir, each compared whole with the plain reference
(``notes_err``: the largest gap over the call's notes, over the largest
reference magnitude of that call).
"""
from __future__ import annotations

import math
import random
import sys
import time
import traceback
from typing import Dict, List, Tuple

import torch

from benchmark import traffic as traffic_gen
from benchmark import weights
from benchmark.kinds import Phases
from benchmark.reference import sampling as ref_sampling


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.attempted = self.failed = 0
        self.phases = Phases()
        self.kept: List[Tuple[int, object]] = []
        self._offered = 0
        self._reservoir = random.Random(traffic_gen.derive(seed, "sample.check"))
        self._next = 0

    def setup(self) -> None:
        phase = self.phases
        with phase("import"):
            from melogan_torch.config import GANConfig
            from melogan_torch.sampling import Sampler

        gan = self.config["gan"]
        cfg = GANConfig(**{k.lower(): v for k, v in gan.items()})
        with phase("weights"):
            self.weights = weights.make(gan, self.config["ed"], traffic_gen.derive(self.seed, "weights"),
                                        self.device, {"gen": "served", "fe": "served"})
        with phase("sampler"):
            self.sampler = Sampler(cfg, gen_variables=self.weights["gen"], fe_variables=self.weights["fe"],
                                   fast_math=self.config["precision"] == "bf16", device=self.device)
        with phase("traffic"):
            self.calls = traffic_gen.SampleCalls(self.traffic, self.seed)
        for _ in range(int(self.traffic["warmup_calls"])):
            with phase("warm call"):
                self.sampler.sample_notes(self.calls.emotions(self._next), seed=self.calls.seed(self._next))
            self._next += 1

    def _call(self) -> Tuple[float, float, bool]:
        i = self._next
        self._next += 1
        self.attempted += 1
        t0 = time.perf_counter()
        try:
            notes = self.sampler.sample_notes(self.calls.emotions(i), seed=self.calls.seed(i))
        except Exception:  # a failed request counts against the run, which goes on
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            return time.perf_counter() - t0, time.perf_counter(), False
        t1 = time.perf_counter()
        self._offer(i, notes)
        return t1 - t0, t1, True

    def _offer(self, i: int, notes) -> None:
        """Reservoir sampling of the calls to check."""
        self._offered += 1
        k = int(self.traffic["checked_calls"])
        if len(self.kept) < k:
            self.kept.append((i, notes))
        else:
            j = self._reservoir.randrange(self._offered)
            if j < k:
                self.kept[j] = (i, notes)

    def run_window(self, seconds: float) -> Dict[str, Tuple[float, str]]:
        lat, done = [], 0
        t0 = time.perf_counter()
        while True:
            dt, t1, ok = self._call()
            lat.append(dt)
            done += ok
            if t1 - t0 >= seconds:
                break
        window = t1 - t0
        return {"samples_per_s": (done * self.calls.rows / window, "samples/s"),
                "sample_p95_ms": (p95(lat) * 1e3, "ms")}

    def install_spans(self, spans) -> None:
        gen, fe = self.sampler.generator, self.sampler.feature_encoder
        spans.around(fe, "feature_encoder")
        spans.around(gen.noise_to_latent, "noise_to_latent")
        spans.around(gen.decoder, "decoder")
        spans.around(gen.decoder.pre, "prenet")
        spans.around_method(gen.decoder, "tail", "decoder_tail")

    def run_traced(self) -> Tuple[int, int]:
        """The traced window's calls: (calls, rows completed)."""
        n = int(self.traffic["traced_calls"])
        done = 0
        for _ in range(n):
            with torch.autograd.profiler.record_function("sample_notes"):
                done += self._call()[2]
        return n, done * self.calls.rows

    def free_program(self) -> None:
        del self.sampler

    def check(self) -> Dict[str, float]:
        """The numbers compared, each with its name."""
        gan = self.config["gan"]
        mode = self.config["reference_rounding"]
        params = {m: {k: v.double() if v.is_floating_point() else v for k, v in self.weights[m].items()}
                  for m in ("gen", "fe")}
        worst = math.inf if not self.kept else 0.0
        for i, notes in self.kept:
            idx = torch.as_tensor(self.calls.idx(i), device=self.device)
            ref = ref_sampling.sample_notes(params, gan, idx, self.calls.seed(i), mode)
            got = torch.as_tensor(notes, device=self.device).double()
            if got.shape != ref.shape:
                return {"notes_err": math.inf}
            err = float((got - ref).abs().max() / ref.abs().max())
            worst = max(worst, err if math.isfinite(err) else math.inf)
        return {"notes_err": worst}
