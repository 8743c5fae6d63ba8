"""Emotion-conditioned sampling: emotion → features → generator → MIDI.

Port of ``melogan_tpu/sampling.py`` (reference app.py:53-119):

- hand-tuned 6-d feature vectors per emotion + N(0, 0.15²) jitter
- numeric FeatureEncoder (inference dropout 0) → 128-d embedding
- Generator(noise, zeros-latent, embedding) → (B, 512, 4) notes
- emotion → bpm {happy 140, sad 70, angry 160, calm 90} and scale
  (major for happy/calm, minor otherwise)
- MIDI codec at the file boundary

Jitter and noise come from a ``torch.Generator`` on the sampler's device,
seeded per call: a seed gives the same notes on the same device every time,
but not the JAX package's notes (another random stream). ``sample_from`` is
the deterministic core that takes features and noise from the caller.
``fast_math`` runs each forward under the ``"fast"`` precision: the
one-pass bf16 products of the JAX package's fast-math sample step.
``mesh`` (``parallel.make_mesh(n)``, a local mesh) splits each batch's rows
over its devices after the draws, as JAX's sharded sample step does.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.constants import EMOTION_BPM
from melogan_torch.device import resolve_device
from melogan_torch.midi.codec import render_to_bytes, save_piano_roll_to_midi
from melogan_torch.models.gan import FeatureEncoder, Generator
from melogan_torch.models.layers import gan_init_
from melogan_torch.parallel.mesh import Mesh
from melogan_torch.precision import using
from melogan_torch.utils.weights import load_state_dicts

# Hand-tuned per-emotion numeric feature bases (reference app.py:55-61).
EMOTION_FEATURES: Dict[str, list] = {
    "happy": [1.0, 1.0, 0.8, 0.8, 0.5, 0.5],
    "sad": [-1.0, -1.0, -0.5, -0.5, -0.5, -0.5],
    "angry": [1.0, -1.0, 1.0, 1.0, -0.8, 0.8],
    "calm": [-1.0, 1.0, -0.8, -0.8, 0.5, -0.5],
}

FEATURE_JITTER_STD = 0.15


def emotion_scale(emotion: str) -> str:
    return "major" if emotion in ("happy", "calm") else "minor"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Device tensor → numpy. From the GPU through page-locked host memory:
    into pageable memory the 33.5 MB of a batch-4096 step took 12.7 ms of a
    22 ms step, into page-locked memory 0.6 ms (H100 80GB HBM3 at 700 W,
    ``python -m melogan_torch.profile_sample``)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _to_host(blocks) -> np.ndarray:
    """The blocks of ``Sampler._forward_blocks`` joined on the host."""
    outs = [_to_numpy(o) for o in blocks]
    return outs[0] if len(outs) == 1 else np.concatenate(outs)


class Sampler:
    """Holds the generator and feature encoder on one device.

    ``gen_variables`` / ``fe_variables``: reference-layout state dicts (the
    ``G`` and ``E_num`` entries of a ``gan_final.pth``, or
    ``utils.weights.export_gan_final`` of JAX variables), numpy arrays or
    tensors. Without them the weights are the reference's N(0, 0.02) init
    drawn from ``seed``.

    ``emotion_features``: optional (4, 6) conditioning centroids of the
    training corpus; the reference's hand-tuned map otherwise.

    ``fast_math=True``: every forward runs under the ``"fast"`` precision
    (bf16-rounded product operands, f32 sums; the decoder then takes its
    layered path, three ``convt1d`` launches in bf16 mode instead of the
    f32 decoder-tail kernel), set around each forward on the calling
    thread, as the JAX sampler flips its precision around each call: the
    sample pool's refill thread samples too. The notes differ from the f32
    default's within bf16 rounding.

    ``mesh``: a local mesh (``parallel.make_mesh(n)`` outside a process
    group) over whose devices each batch is split: the jitter and noise of
    the whole batch are drawn once on the first device, from the same
    generator as without a mesh, the rows are cut with
    ``torch.tensor_split`` (an uneven batch unevenly), each block runs on
    its device's copy of the modules, launched one after another without
    waiting, and the blocks are joined on the host. Eval mode has no
    cross-row operation, so the notes are those of one device up to the
    kernels' summation order. ``device`` is then the mesh's first device.
    """

    def __init__(
        self,
        cfg: Optional[GANConfig] = None,
        gen_variables: Optional[Mapping] = None,
        fe_variables: Optional[Mapping] = None,
        seed: int = 42,
        fast_math: bool = False,
        mesh=None,
        emotion_features=None,
        device="cuda",
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a melogan_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")
        if mesh is not None and mesh.group is not None and mesh.data > 1:
            raise ValueError("a Sampler's mesh is local, over this process's devices "
                             "(make_mesh outside a process group); a rank samples alone")
        self.cfg = cfg or GANConfig()
        self.fast_math = bool(fast_math)
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        if self.device.type == "cuda":
            # f32 parity with the JAX package (Precision.HIGHEST): cuBLAS
            # matmuls and cuDNN convs must not drop to TF32, which keeps
            # about three decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._seed = seed
        gen, fe = self._build_modules(gen_variables, fe_variables)
        base = self._validate_features(emotion_features)
        self.emotion_features = None if emotion_features is None else base
        # guards paired reads/writes of (generator, encoder, base features):
        # a hot-swap concurrent with sampling must never mix an old generator
        # with a new feature encoder
        self._var_lock = threading.Lock()
        self._gen, self._fe = gen, fe
        self._replicas = self._replicate(gen, fe)
        self._base_features = torch.as_tensor(base, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def _build_modules(self, gen_variables, fe_variables):
        gen = Generator.from_config(self.cfg)
        # serving uses dropout 0.0 in the feature encoder (reference app.py:41)
        fe = FeatureEncoder.from_config(self.cfg, dropout=0.0)
        if gen_variables is None and fe_variables is None:
            g = torch.Generator().manual_seed(self._seed)
            gan_init_(fe, g)
            gan_init_(gen, g)
        elif gen_variables is None or fe_variables is None:
            raise ValueError("pass both gen_variables and fe_variables, or neither")
        else:
            load_state_dicts(gen, fe, gen_variables, fe_variables)
        return gen.to(self.device).eval(), fe.to(self.device).eval()

    def _replicate(self, gen, fe):
        """(device, generator, encoder) for each device of the mesh, the
        modules themselves on the first; None without a mesh."""
        if self.mesh is None:
            return None
        copies = {self.device: (gen, fe)}
        for dev in self.mesh.devices:
            if dev not in copies:
                copies[dev] = (copy.deepcopy(gen).to(dev), copy.deepcopy(fe).to(dev))
        return [(dev,) + copies[dev] for dev in self.mesh.devices]

    def _validate_features(self, emotion_features) -> np.ndarray:
        if emotion_features is None:
            return np.stack([EMOTION_FEATURES[e] for e in EMOTIONS]).astype(np.float32)
        base = np.asarray(emotion_features, np.float32)
        want = (len(EMOTIONS), self.cfg.numeric_input_dim)
        if base.shape != want:
            raise ValueError(f"emotion_features must be {want}, got {base.shape}")
        return base

    @property
    def generator(self) -> Generator:
        return self._gen

    @property
    def feature_encoder(self) -> FeatureEncoder:
        return self._fe

    # ------------------------------------------------------------------
    def _forward(self, gen, fe, features: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        with using("fast") if self.fast_math else contextlib.nullcontext(), torch.inference_mode():
            emb = fe(features)
            latent = None
            if self.cfg.integration_mode == "conditioning":
                latent = torch.zeros((noise.shape[0], self.cfg.latent_dim), device=noise.device)
            notes, _ = gen(noise, latent, emb)
        return notes

    def _forward_blocks(self, gen, fe, replicas, features: torch.Tensor, noise: torch.Tensor):
        """Notes of (features, noise) left on the devices: one tensor on the
        first device, or one a non-empty block of the mesh's replicas."""
        if replicas is None:
            return [self._forward(gen, fe, features, noise)]
        blocks = zip(torch.tensor_split(features, len(replicas)), torch.tensor_split(noise, len(replicas)))
        return [self._forward(g, e, f.to(dev), z.to(dev))
                for (dev, g, e), (f, z) in zip(replicas, blocks) if f.shape[0]]  # B < devices: empty blocks

    def sample_from(self, features, noise) -> np.ndarray:
        """Deterministic core: (B, 6) jittered features and (B, noise_dim)
        noise → (B, max_notes, note_dim) notes as numpy."""
        f = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        z = torch.as_tensor(np.asarray(noise, np.float32), device=self.device)
        with self._var_lock:
            gen, fe, replicas = self._gen, self._fe, self._replicas
        return _to_host(self._forward_blocks(gen, fe, replicas, f, z))

    def sample_notes(self, emotions, seed: int = 0) -> np.ndarray:
        """Generate (B, max_notes, 4) note arrays for a list of emotion names."""
        unknown = [e for e in emotions if e not in EMOTIONS]
        if unknown:
            raise ValueError(
                f"unknown emotion(s) {unknown}; valid emotions are {list(EMOTIONS)}"
            )
        idx = torch.as_tensor([EMOTIONS.index(e) for e in emotions], device=self.device)
        return _to_host(self._step(idx, seed))

    def _step(self, idx: torch.Tensor, seed: int):
        """The device work of ``sample_notes``: jitter and noise drawn for the
        emotion rows ``idx`` (a device tensor of ``EMOTIONS`` indices) from a
        generator seeded with ``seed``, then the forward. The notes stay on
        the devices (``_forward_blocks``); nothing waits for them."""
        with self._var_lock:  # pair the reads (see swap_variables)
            gen, fe, base_all, replicas = self._gen, self._fe, self._base_features, self._replicas
        rng = torch.Generator(device=self.device).manual_seed(seed)
        base = base_all[idx]
        features = base + FEATURE_JITTER_STD * torch.randn(
            base.shape, generator=rng, device=self.device)
        noise = torch.randn((idx.shape[0], self.cfg.noise_dim), generator=rng, device=self.device)
        return self._forward_blocks(gen, fe, replicas, features, noise)

    def swap_variables(self, gen_variables, fe_variables, emotion_features=None) -> None:
        """Atomically replace the generator + feature-encoder weights
        (reference-layout state dicts). New modules are built and loaded
        first, then swapped in under the lock, so a sample in flight finishes
        on the old pair, and the new decoder folds its BatchNorm afresh (the
        old decoder's folded-stage cache goes with it). A load that fails
        raises before the swap. ``emotion_features``: the new checkpoint's
        conditioning centroids, if it carries them."""
        gen, fe = self._build_modules(gen_variables, fe_variables)
        replicas = self._replicate(gen, fe)
        new_base = None
        if emotion_features is not None:
            new_base = self._validate_features(emotion_features)
        with self._var_lock:
            self._gen, self._fe, self._replicas = gen, fe, replicas
            if new_base is not None:
                self.emotion_features = new_base
                self._base_features = torch.as_tensor(new_base, device=self.device)

    def generate_many(self, emotions, out_paths, seed: int = 0, bpms=None):
        """Bulk generation: ONE device batch for all prompts, then per-file
        byte encoding. Returns the written paths."""
        if len(emotions) != len(out_paths):
            raise ValueError("emotions and out_paths differ in length")
        notes = self.sample_notes(list(emotions), seed=seed)
        written = []
        for i, (emotion, path) in enumerate(zip(emotions, out_paths)):
            bpm = bpms[i] if bpms is not None else EMOTION_BPM[emotion]
            data = render_to_bytes(notes[i], bpm=bpm, scale=emotion_scale(emotion))
            with open(path, "wb") as f:
                f.write(data)
            written.append(path)
        return written

    def generate_midi(
        self,
        emotion: str,
        output_path: str,
        seed: int = 0,
        bpm: Optional[float] = None,
        instrument_name: str = "Acoustic Grand Piano",
    ):
        """End-to-end: one emotion prompt → .mid on disk. Returns the song."""
        notes = self.sample_notes([emotion], seed=seed)[0]
        return save_piano_roll_to_midi(
            notes,
            output_path,
            bpm=bpm if bpm is not None else EMOTION_BPM[emotion],
            scale=emotion_scale(emotion),
            instrument_name=instrument_name,
            verbose=False,
        )
