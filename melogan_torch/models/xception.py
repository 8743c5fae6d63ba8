"""mini-Xception FER classifier in torch: the port of
``melogan_tpu/models/xception.py``.

The reference's Keras FER-2013 model (camera/mini_xception.h5, loaded in
camera/camera.py:49-51): two valid-padded 3×3 convs, four residual blocks (2×
separable conv + SAME 3×3/2 max-pool against a 1×1/2 projection shortcut,
each conv BN'd, eps 1e-3), a 3×3 conv to 7 logits, global average pool,
softmax. ``MiniXception``'s submodules carry the Keras layer names
(``conv2d_1``, ``separable_conv2d_1.depthwise``, ``batch_normalization_1``,
...); ``utils/weights.py::xception_state_from_keras`` maps the Keras arrays
(HWIO, depthwise (H, W, Cin, 1)) to its state dict (OIHW, depthwise
(Cin, 1, H, W) with ``groups=Cin``). TF's "SAME" padding is asymmetric (the
low side gets total//2, the high side the rest), so it is padded explicitly:
with zeros before a conv, with −inf before a max-pool.

The convs run ``F.conv2d`` (cuDNN on the card, TF32 off), the counterpart of
the JAX package's ``lax.conv_general_dilated``, which reaches no TPU kernel.
``FERClassifier`` resizes each face crop on the host (cv2's INTER_LINEAR,
not antialiased; a copy of the JAX helper) and runs the /255 normalisation
and the network on its device, from one worker thread
(``device.DeviceWorker``: PyTorch caches cuDNN's plans per thread). ``load_mini_xception_weights`` imports
``h5py`` when it is called, as the JAX package does.

7 FER labels → 4 music emotions via the reference map (camera/camera.py:22-32).
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from melogan_torch.device import DeviceWorker, resolve_device

MINI_XCEPTION_LABELS = ("angry", "disgust", "fear", "happy", "sad", "surprise", "neutral")

# 7→4 emotion map (behavioral contract, camera/camera.py:24-32)
XCEPTION_TO_MY_EMOTIONS: Dict[str, str] = {
    "happy": "happy",
    "sad": "sad",
    "angry": "angry",
    "neutral": "calm",
    "fear": "angry",
    "surprise": "happy",
    "disgust": "sad",
}

_BLOCKS = ((1, 16), (2, 32), (3, 64), (4, 128))  # (index, filters)
_STEM = (8, 8)  # conv2d_1, conv2d_2 filters
BN_EPS = 1e-3  # Keras BatchNormalization default
N_CLASSES = len(MINI_XCEPTION_LABELS)


def load_mini_xception_weights(h5_path: str) -> Dict[str, np.ndarray]:
    """Flatten the Keras h5 weight groups into a {name: array} dict."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(h5_path, "r") as f:
        def walk(group, prefix=""):
            for key in group:
                item = group[key]
                if hasattr(item, "keys"):
                    walk(item, prefix + key + "/")
                else:
                    # 'conv2d_1/conv2d_1_1/kernel:0' → 'conv2d_1/kernel'
                    name = (prefix + key).split(":")[0]
                    parts = name.split("/")
                    out[f"{parts[0]}/{parts[-1]}"] = np.asarray(item)

        walk(f["model_weights"])
    return out


def _same_pad(x: torch.Tensor, k: int, stride: int, value: float) -> torch.Tensor:
    """TF "SAME" padding of an NCHW tensor for a k×k window at ``stride``."""
    pads: List[int] = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dimension first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class KerasBatchNorm(nn.Module):
    """Keras ``BatchNormalization`` at inference: ``weight`` (gamma), ``bias``
    (beta), ``running_mean``, ``running_var``; eps 1e-3."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = lambda v: v[:, None, None]
        return (x - c(self.running_mean)) * c(torch.rsqrt(self.running_var + BN_EPS)) * c(self.weight) \
            + c(self.bias)


class SeparableConv2d(nn.Module):
    """Keras ``SeparableConv2D`` (3×3, SAME, no bias): a depthwise conv with
    ``groups=Cin``, then a 1×1 pointwise conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.depthwise = nn.Conv2d(cin, cin, 3, groups=cin, bias=False)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(_same_pad(x, 3, 1, 0.0)))


class MiniXception(nn.Module):
    """``forward((B, 64, 64, 1) in [0, 1])`` → (B, 7) softmax probabilities.

    Keras numbering: block i uses separable convs 2i−1 and 2i, BNs 3i+1 and
    3i+2 on them, and BN 3i on its shortcut conv ``conv2d_{i+2}``."""

    def __init__(self):
        super().__init__()
        self.conv2d_1 = nn.Conv2d(1, _STEM[0], 3, bias=False)
        self.batch_normalization_1 = KerasBatchNorm(_STEM[0])
        self.conv2d_2 = nn.Conv2d(_STEM[0], _STEM[1], 3, bias=False)
        self.batch_normalization_2 = KerasBatchNorm(_STEM[1])
        cin = _STEM[1]
        for i, filters in _BLOCKS:
            self.add_module(f"conv2d_{i + 2}", nn.Conv2d(cin, filters, 1, stride=2, bias=False))
            self.add_module(f"batch_normalization_{3 * i}", KerasBatchNorm(filters))
            self.add_module(f"separable_conv2d_{2 * i - 1}", SeparableConv2d(cin, filters))
            self.add_module(f"batch_normalization_{3 * i + 1}", KerasBatchNorm(filters))
            self.add_module(f"separable_conv2d_{2 * i}", SeparableConv2d(filters, filters))
            self.add_module(f"batch_normalization_{3 * i + 2}", KerasBatchNorm(filters))
            cin = filters
        self.conv2d_7 = nn.Conv2d(cin, N_CLASSES, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = lambda name: getattr(self, name)
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.batch_normalization_1(self.conv2d_1(h)))  # VALID
        h = F.relu(self.batch_normalization_2(self.conv2d_2(h)))
        for i, _filters in _BLOCKS:
            shortcut = m(f"batch_normalization_{3 * i}")(m(f"conv2d_{i + 2}")(_same_pad(h, 1, 2, 0.0)))
            r = F.relu(m(f"batch_normalization_{3 * i + 1}")(m(f"separable_conv2d_{2 * i - 1}")(h)))
            r = m(f"batch_normalization_{3 * i + 2}")(m(f"separable_conv2d_{2 * i}")(r))
            r = F.max_pool2d(_same_pad(r, 3, 2, -float("inf")), 3, 2)
            h = r + shortcut
        h = self.conv2d_7(_same_pad(h, 3, 1, 0.0))
        return torch.softmax(h.mean(dim=(2, 3)), dim=-1)


def _host_resize_bilinear(x: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, C) → (B, size, size, C) two-tap bilinear with half-pixel
    centers — exactly cv2.resize INTER_LINEAR, which is what the reference
    camera loop applies to face crops (camera/camera.py:97; NB unlike
    jax.image.resize this does not anti-alias on minification, matching cv2).
    A copy of the JAX package's helper: it runs on the host, so the network
    sees one input shape whatever the crop's."""
    b, h, w, c = x.shape
    if h == size and w == size:
        return x

    def axis(n_in: int, n_out: int):
        coords = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
        lo = np.floor(coords).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (coords - lo).astype(np.float32)

    ylo, yhi, fy = axis(h, size)
    xlo, xhi, fx = axis(w, size)
    fx = fx[None, None, :, None]
    rows_t, rows_b = x[:, ylo], x[:, yhi]
    top = rows_t[:, :, xlo] * (1 - fx) + rows_t[:, :, xhi] * fx
    bot = rows_b[:, :, xlo] * (1 - fx) + rows_b[:, :, xhi] * fx
    fy = fy[None, :, None, None]
    return top * (1 - fy) + bot * fy


class FERClassifier:
    """Batched inference on ``device``: grayscale face crop → music emotion."""

    def __init__(self, weights: Mapping[str, np.ndarray], input_size: int = 64, device="cuda"):
        from melogan_torch.utils.weights import to_tensors, xception_state_from_keras

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 parity with XLA's convs: cuDNN must not drop to TF32
            torch.backends.cudnn.allow_tf32 = False
        self.input_size = input_size
        self.net = MiniXception()
        self.net.load_state_dict(to_tensors(xception_state_from_keras(weights)), strict=True)
        self.net.to(self.device).eval()
        self._worker = DeviceWorker("fer")

    def close(self) -> None:
        """End the thread that runs the device calls."""
        self._worker.close()

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> torch.Tensor:
        """(B, input_size, input_size, 1) on the device → (B, 7) there."""
        # [0, 255] input → /255 (camera.py:99); branchless, so the host
        # never waits on the device for the max
        x = torch.where(x.max() > 1.5, x / 255.0, x)
        return self.net(x)

    def predict_proba(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W) or (B, H, W, 1) grayscale in [0, 255] or [0, 1] → (B, 7)."""
        x = np.asarray(frames, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        x = torch.from_numpy(np.ascontiguousarray(_host_resize_bilinear(x, self.input_size)))
        return self._worker(lambda: self.run(x.to(self.device)).cpu().numpy())

    def predict_emotion(self, frame: np.ndarray) -> str:
        """Single grayscale frame → one of happy/sad/angry/calm."""
        probs = self.predict_proba(np.asarray(frame)[None])
        label = MINI_XCEPTION_LABELS[int(probs[0].argmax())]
        return XCEPTION_TO_MY_EMOTIONS[label]


# where the weights are looked for, after $MELOGAN_FER_H5 and before
# $MELOGAN_REFERENCE_DIR/camera/mini_xception.h5 (relative to the working
# directory, as in the JAX package)
DEFAULT_H5_CANDIDATES = ("data/models/fer/mini_xception.h5",)


def h5_candidates() -> List[str]:
    """The weight files tried in order, the environment read at the call."""
    ref = os.environ.get("MELOGAN_REFERENCE_DIR")
    return [p for p in (os.environ.get("MELOGAN_FER_H5", ""), *DEFAULT_H5_CANDIDATES,
                        os.path.join(ref, "camera", "mini_xception.h5") if ref else "") if p]


def load_default_fer(device="cuda") -> Optional[FERClassifier]:
    """The FER from the first weight file of ``h5_candidates()`` that exists,
    on ``device``; None when there is none. A file that exists but fails to
    load raises."""
    for path in h5_candidates():
        if os.path.exists(path):
            return FERClassifier(load_mini_xception_weights(path), device=device)
    return None
