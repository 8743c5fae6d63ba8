"""melogan_torch — the PyTorch/CUDA port of ``melogan_tpu`` for NVIDIA Hopper.

The port serves emotion-conditioned MIDI generation (``POST /generate``) and
trains the WGAN-GP generator (``train.gan_loop.train``), with the generator's
transposed convolutions and the emotion discriminator's convolutions running
in hand-written CUDA kernels (``melogan_torch/csrc``), forward and backward.
It imports nothing of JAX or of the JAX package; the JAX package stays the
reference it is tested against.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU, where each kernel's plain PyTorch version runs instead.

The four emotions everywhere: ``happy, sad, angry, calm``.
"""

__version__ = "0.1.0"

EMOTIONS = ("happy", "sad", "angry", "calm")

# Canonical emotion -> class-index map (reference: src/gan/utils.py:63-73).
EMOTION_TO_INDEX = {"happy": 0, "sad": 1, "angry": 2, "calm": 3}
