"""The one general traffic generator: it reads a mix's parameters from
``benchmark/traffic/<name>.json`` and makes every input of a run from the
run's seed. The same seed gives the same inputs; every seed gives the same
sizes, in another order.

- ``sample`` mixes: a closed loop of bulk sampling calls as a server's
  sample pool makes them under sustained load (``serving/pool.py``'s
  refill): ``rows_per_call`` rows, the four emotions in turn in
  ``EMOTIONS`` order, and consecutive seeds a call from a first one drawn
  from the run's seed.
- ``train`` mixes: a corpus of ``corpus_rows`` rows (notes uniform in
  [-1, 1], numeric features N(0, 1), emotions uniform, zero AE latents)
  made on the device, one permutation an epoch cut into group steps of
  ``CRITIC_ITERS`` batches of the configuration's ``BATCH_SIZE`` rows, as
  ``train-gan`` cuts an epoch; the rest of an epoch that fills no group is
  left out.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch

from benchmark.reference.model import EMOTIONS

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
SEED_SPACE = 2 ** 63


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    path = directory / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``seed``."""
    words = np.random.SeedSequence([int(seed) % SEED_SPACE, *tag.encode()]).generate_state(2, np.uint64)
    return int(words[0] ^ (words[1] << np.uint64(17))) % SEED_SPACE


class SampleCalls:
    """The calls of a ``sample`` mix: ``emotions(i)`` (a list of names),
    ``idx(i)`` (their ``EMOTIONS`` indices) and ``seed(i)`` of call ``i``."""

    def __init__(self, traffic: dict, seed: int):
        self.rows = int(traffic["rows_per_call"])
        self._idx = np.arange(self.rows) % len(EMOTIONS)
        self._names = [EMOTIONS[i] for i in self._idx]
        self._first = int(np.random.default_rng(derive(seed, "sample.calls")).integers(0, 2 ** 31))

    def emotions(self, i: int) -> List[str]:
        return self._names

    def idx(self, i: int) -> np.ndarray:
        return self._idx

    def seed(self, i: int) -> int:
        return self._first + i


class TrainFeed:
    """The corpus of a ``train`` mix on ``device`` and its group indices."""

    def __init__(self, traffic: dict, gan: dict, seed: int, device):
        self.batch = int(gan["BATCH_SIZE"])
        self.k = int(gan["CRITIC_ITERS"])
        n = int(traffic["corpus_rows"])
        if n < self.k * self.batch:
            raise ValueError(f"corpus_rows {n} fills no group of {self.k} x {self.batch}")
        g = torch.Generator(device=device).manual_seed(derive(seed, "train.corpus"))
        self.notes = torch.rand((n, gan["MAX_NOTES"], gan["NOTE_DIM"]), generator=g, device=device) * 2 - 1
        self.emotion = torch.randint(0, len(EMOTIONS), (n,), generator=g, device=device)
        self.latents = torch.zeros((n, gan["LATENT_DIM"]), device=device)
        self.numeric = torch.randn((n, gan["NUMERIC_INPUT_DIM"]), generator=g, device=device)
        self._rng = np.random.default_rng(derive(seed, "train.order"))

    def arrays(self):
        """The corpus as host arrays, in ``device_gather``'s order."""
        return tuple(t.cpu().numpy() for t in (self.notes, self.emotion, self.latents, self.numeric))

    def groups(self) -> Iterator[np.ndarray]:
        """(critic_iters, batch) row indices of each group step, epoch after
        epoch."""
        n = self.notes.shape[0]
        per_epoch = n // (self.k * self.batch)
        while True:
            order = self._rng.permutation(n)[: per_epoch * self.k * self.batch]
            yield from order.reshape(per_epoch, self.k, self.batch)

    def rows(self, idx: np.ndarray):
        """(notes, emotion, numeric) of rows ``idx``, stacked as ``idx``."""
        i = torch.as_tensor(idx, device=self.notes.device)
        return self.notes[i], self.emotion[i], self.numeric[i]
