"""Split creation: manifest → stratified train/val/test CSVs. The port's
copy of ``melogan_tpu/data/splits.py``.

Rebuilds the reference's missing ``create_splits.py`` (referenced by
src/ae/encode.py:90 but absent from the repo, SURVEY.md §2.10). Output CSVs use
the reference column layout ``file_key, emotion, source, full_path, npz_path``
with ~70/15/15 stratified-by-emotion proportions (matching the shipped
897/192/193 split of 1282 files)."""
from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def create_splits(
    manifest_rows: Sequence[Dict[str, str]],
    out_dir: str,
    ratios: Tuple[float, float, float] = (0.70, 0.15, 0.15),
    seed: int = 42,
    npz_name_fn=lambda row: f"{row['file_key']}.npz",
) -> Dict[str, List[Dict[str, str]]]:
    """Stratified split by ``emotion``; writes {train,val,test}_split.csv."""
    rng = np.random.default_rng(seed)
    by_emotion: Dict[str, List[Dict[str, str]]] = defaultdict(list)
    for row in manifest_rows:
        by_emotion[row["emotion"]].append(dict(row))

    splits: Dict[str, List[Dict[str, str]]] = {"train": [], "val": [], "test": []}
    for emotion, rows in sorted(by_emotion.items()):
        idx = rng.permutation(len(rows))
        n = len(rows)
        n_train = int(round(n * ratios[0]))
        n_val = int(round(n * ratios[1]))
        for j, i in enumerate(idx):
            row = rows[i]
            row["npz_path"] = npz_name_fn(row)
            if j < n_train:
                splits["train"].append(row)
            elif j < n_train + n_val:
                splits["val"].append(row)
            else:
                splits["test"].append(row)

    os.makedirs(out_dir, exist_ok=True)
    fieldnames = ["file_key", "emotion", "source", "full_path", "npz_path"]
    from melogan_torch.utils.atomic import atomic_write

    for name, rows in splits.items():
        def _write(f, rows=rows):
            writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            writer.writeheader()
            writer.writerows(rows)

        # atomic: these CSVs are pipeline --resume completion markers
        atomic_write(os.path.join(out_dir, f"{name}_split.csv"), _write, newline="")
    return splits


def read_manifest(manifest_csv: str) -> List[Dict[str, str]]:
    with open(manifest_csv, newline="") as f:
        return list(csv.DictReader(f))
