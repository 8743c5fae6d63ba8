"""In-memory corpus split and the WGAN-GP loop's batch indices.

The port's own copies of ``SplitData`` and ``epoch_group_indices`` from
``melogan_tpu/data/datasets.py`` (numpy only). Loading a split from
``.npz`` files, the AE normalization and augmentations come with later
slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from melogan_torch import EMOTION_TO_INDEX
from melogan_torch.data.preprocess import raw_to_gan_normalized


@dataclass
class SplitData:
    """One split, fully materialized."""

    notes_raw: np.ndarray  # (N, 512, 4) raw AE layout
    emotions: np.ndarray  # (N,) str
    numeric: np.ndarray  # (N, 6) standardized
    filenames: List[str]

    @property
    def n(self) -> int:
        return self.notes_raw.shape[0]

    @property
    def emotion_idx(self) -> np.ndarray:
        return np.array([EMOTION_TO_INDEX.get(str(e).lower(), -1) for e in self.emotions])

    def notes_gan(self) -> np.ndarray:
        return raw_to_gan_normalized(self.notes_raw)


def epoch_group_indices(
    n: int, batch_size: int, group: int, rng: np.random.Generator
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """One epoch's shuffled gather indices: (groups (G, group, B) or None,
    tail (K, B) or None), dropping the last partial batch as the reference
    loop does."""
    order = rng.permutation(n)
    n_batches = n // batch_size
    idx = order[: n_batches * batch_size].reshape(n_batches, batch_size)
    n_groups = n_batches // group
    groups = idx[: n_groups * group].reshape(n_groups, group, batch_size) if n_groups else None
    rem = n_batches - n_groups * group
    tail = idx[n_groups * group:] if rem else None
    return groups, tail
