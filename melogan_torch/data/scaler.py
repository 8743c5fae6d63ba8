"""Standard scaler for numeric conditioning features: the port's copy of
``melogan_tpu/data/scaler.py``.

Self-contained (mean/std standardization, constant features mapped to 0) with
optional interop with the reference's sklearn ``scaler.joblib`` artifact
(data/models/scaler.joblib: 6 features fit on 890 samples)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class StandardScaler:
    def __init__(self, mean: Optional[np.ndarray] = None, scale: Optional[np.ndarray] = None):
        self.mean_ = None if mean is None else np.asarray(mean, np.float64)
        self.scale_ = None if scale is None else np.asarray(scale, np.float64)
        self.n_samples_seen_ = 0

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        std = x.std(axis=0)  # population std, sklearn semantics
        # constant features divide by 1 (sklearn _handle_zeros_in_scale)
        std = np.where(std == 0.0, 1.0, std)
        self.scale_ = std
        self.n_samples_seen_ = x.shape[0]
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.mean_ is None:
            raise RuntimeError("scaler is not fitted")
        return ((np.asarray(x, np.float64) - self.mean_) / self.scale_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) * self.scale_ + self.mean_).astype(np.float32)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> str:
        from melogan_torch.utils.atomic import atomic_write

        # atomic: scaler.npz is pipeline --resume's preprocess marker
        return atomic_write(
            path,
            lambda f: np.savez(f, mean=self.mean_, scale=self.scale_,
                               n=self.n_samples_seen_),
            mode="wb",
        )

    @classmethod
    def load(cls, path: str) -> "StandardScaler":
        if path.endswith(".joblib"):
            return cls.from_sklearn_joblib(path)
        with np.load(path) as data:
            sc = cls(mean=data["mean"], scale=data["scale"])
            sc.n_samples_seen_ = int(data["n"])
            return sc

    @classmethod
    def from_sklearn_joblib(cls, path: str) -> "StandardScaler":
        """Load the reference's sklearn StandardScaler artifact."""
        import joblib  # available in the image; only touched on this path

        sk = joblib.load(path)
        sc = cls(mean=sk.mean_, scale=sk.scale_)
        sc.n_samples_seen_ = int(getattr(sk, "n_samples_seen_", 0))
        return sc
