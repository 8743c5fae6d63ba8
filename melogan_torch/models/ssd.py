"""ResNet-10 SSD-300 face detector in torch: the prototxt-exact topology of
``melogan_tpu/models/ssd.py``.

The reference's OpenCV-DNN face detector (camera/camera.py:37,
camera/deploy.prototxt.txt — res10_300x300 SSD), layer for layer:

- data_bn/data_scale input normalization
- conv1_h 7×7/2 (+BN/Scale/ReLU) → 3×3/2 ceil-mode max-pool  (300→150→75)
- layer_64_1: plain residual block, 32ch, stride 1           (75)
- layer_128_1: pre-act block, 128ch, stride 2, 1×1 expand    (38)
- layer_256_1: pre-act block, 256ch, stride 2, 1×1 expand    (19)
  · the 38×38 pre-activation (layer_256_1_bn1+scale+relu) is the
    conv4_3_norm tap, through an L2 Normalize layer (scale init 20)
- layer_512_1: pre-act block, stride 1 with DILATED 3×3 (pad 2, dilation 2),
  128→256, 1×1 expand; + last_bn_h/scale/relu → fc7          (19)
- extras conv6_1/2 (→10), conv7_1/2 (→5), conv8_1/2 and conv9_1/2 at
  stride 1 (feature maps stay 5×5)
- six mbox loc/conf 3×3 heads; PriorBox min/max/aspect/step per prototxt
  (8892 priors), softmax over 2 classes, CENTER_SIZE decode with variances
  (0.1, 0.1, 0.2, 0.2), NMS 0.45 / top_k 400 / keep 200

``SSD`` is an ``nn.Module`` whose submodules carry the caffe layer names of
``CONV_SPECS`` and ``BN_SPECS``; its conv weights are OIHW (caffe's own
layout), its activations NCHW inside. The public functions take and return
NHWC, as the JAX package's do. ``init_params``, ``load_caffemodel`` and
``to_caffe_layers`` work on the JAX package's parameter tree (numpy, conv
weights HWIO), so a seed or a ``.caffemodel`` gives both packages the same
weights; ``utils/weights.py::ssd_state_from_jax`` maps that tree to the
module's state dict. ``PRIOR_CONFIG``, ``generate_priors``, ``decode_boxes``
and ``nms_host`` are copies; ``nms`` is the static-shape NMS on tensors (no
caller, as in the JAX package).

The convs run ``F.conv2d`` (cuDNN on the card, TF32 off) and the resize
``F.interpolate(antialias=True)``: the counterparts of the JAX package's
``lax.conv_general_dilated`` and ``jax.image.resize``, which reach no TPU
kernel. ``FaceDetector``'s device program ends at the sorted top 400
candidates; NMS runs on the host, as in the JAX package. ``detect`` runs
the device program from one worker thread (``device.DeviceWorker``:
PyTorch caches cuDNN's plans per thread). Detections mirror
cv2.dnn output: (N, 7) rows of (image_id, class_id, confidence, x1, y1, x2,
y2).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from melogan_torch.device import DeviceWorker, resolve_device
from melogan_torch.models.caffe import CaffeLayer, read_caffemodel

INPUT_SIZE = 300
MEAN_BGR = (104.0, 177.0, 123.0)
BN_EPS = 1e-5  # caffe BatchNormParameter default
NORM_EPS = 1e-10  # caffe NormalizeLayer eps

# PriorBox configuration straight from deploy.prototxt.txt. Feature-map sizes
# follow caffe conv arithmetic (conv8/9 are stride 1 ⇒ fm stays 5).
PRIOR_CONFIG = [
    dict(src="conv4_3_norm", fm=38, step=8, min_size=30.0, max_size=60.0, ars=(2.0,)),
    dict(src="fc7", fm=19, step=16, min_size=60.0, max_size=111.0, ars=(2.0, 3.0)),
    dict(src="conv6_2_h", fm=10, step=32, min_size=111.0, max_size=162.0, ars=(2.0, 3.0)),
    dict(src="conv7_2_h", fm=5, step=64, min_size=162.0, max_size=213.0, ars=(2.0, 3.0)),
    dict(src="conv8_2_h", fm=5, step=100, min_size=213.0, max_size=264.0, ars=(2.0,)),
    dict(src="conv9_2_h", fm=5, step=300, min_size=264.0, max_size=315.0, ars=(2.0,)),
]
VARIANCES = (0.1, 0.1, 0.2, 0.2)
NUM_CLASSES = 2  # background, face
# DetectionOutput params (deploy.prototxt.txt detection_out layer)
NMS_THRESHOLD = 0.45
NMS_TOP_K = 400
KEEP_TOP_K = 200


def priors_per_cell(cfg) -> int:
    # caffe PriorBox: min box + sqrt(min·max) box + (ar, 1/ar) per aspect
    return 2 + 2 * len(cfg["ars"])


def generate_priors() -> np.ndarray:
    """(P, 4) cxcywh priors in relative coords, caffe generation order
    (min, sqrt(min·max), then ar/flip pairs; offset 0.5, clip=false)."""
    priors = []
    for cfg in PRIOR_CONFIG:
        fm, step = cfg["fm"], cfg["step"]
        sizes = [(cfg["min_size"], cfg["min_size"])]
        s_prime = math.sqrt(cfg["min_size"] * cfg["max_size"])
        sizes.append((s_prime, s_prime))
        for ar in cfg["ars"]:
            w = cfg["min_size"] * math.sqrt(ar)
            h = cfg["min_size"] / math.sqrt(ar)
            sizes.append((w, h))
            sizes.append((h, w))  # flip
        for i in range(fm):
            for j in range(fm):
                cx = (j + 0.5) * step / INPUT_SIZE
                cy = (i + 0.5) * step / INPUT_SIZE
                for (w, h) in sizes:
                    priors.append((cx, cy, w / INPUT_SIZE, h / INPUT_SIZE))
    return np.asarray(priors, np.float32)


# ---------------------------------------------------------------------------
# Declarative conv table: drives init, the caffemodel loader, and the module.
# (name, in_ch, out_ch, kernel, stride, pad, dilation, bias)
# ---------------------------------------------------------------------------

_head = lambda cfg, kind: priors_per_cell(cfg) * (4 if kind == "loc" else NUM_CLASSES)

CONV_SPECS = [
    ("conv1_h", 3, 32, 7, 2, 3, 1, True),
    ("layer_64_1_conv1_h", 32, 32, 3, 1, 1, 1, False),
    ("layer_64_1_conv2_h", 32, 32, 3, 1, 1, 1, False),
    ("layer_128_1_conv1_h", 32, 128, 3, 2, 1, 1, False),
    ("layer_128_1_conv2", 128, 128, 3, 1, 1, 1, False),
    ("layer_128_1_conv_expand_h", 32, 128, 1, 2, 0, 1, False),
    ("layer_256_1_conv1", 128, 256, 3, 2, 1, 1, False),
    ("layer_256_1_conv2", 256, 256, 3, 1, 1, 1, False),
    ("layer_256_1_conv_expand", 128, 256, 1, 2, 0, 1, False),
    ("layer_512_1_conv1_h", 256, 128, 3, 1, 1, 1, False),
    ("layer_512_1_conv2_h", 128, 256, 3, 1, 2, 2, False),  # dilated
    ("layer_512_1_conv_expand_h", 256, 256, 1, 1, 0, 1, False),
    ("conv6_1_h", 256, 128, 1, 1, 0, 1, True),
    ("conv6_2_h", 128, 256, 3, 2, 1, 1, True),
    ("conv7_1_h", 256, 64, 1, 1, 0, 1, True),
    ("conv7_2_h", 64, 128, 3, 2, 1, 1, True),
    ("conv8_1_h", 128, 64, 1, 1, 0, 1, True),
    ("conv8_2_h", 64, 128, 3, 1, 1, 1, True),
    ("conv9_1_h", 128, 64, 1, 1, 0, 1, True),
    ("conv9_2_h", 64, 128, 3, 1, 1, 1, True),
    ("conv4_3_norm_mbox_loc", 128, _head(PRIOR_CONFIG[0], "loc"), 3, 1, 1, 1, True),
    ("conv4_3_norm_mbox_conf", 128, _head(PRIOR_CONFIG[0], "conf"), 3, 1, 1, 1, True),
    ("fc7_mbox_loc", 256, _head(PRIOR_CONFIG[1], "loc"), 3, 1, 1, 1, True),
    ("fc7_mbox_conf", 256, _head(PRIOR_CONFIG[1], "conf"), 3, 1, 1, 1, True),
    ("conv6_2_mbox_loc", 256, _head(PRIOR_CONFIG[2], "loc"), 3, 1, 1, 1, True),
    ("conv6_2_mbox_conf", 256, _head(PRIOR_CONFIG[2], "conf"), 3, 1, 1, 1, True),
    ("conv7_2_mbox_loc", 128, _head(PRIOR_CONFIG[3], "loc"), 3, 1, 1, 1, True),
    ("conv7_2_mbox_conf", 128, _head(PRIOR_CONFIG[3], "conf"), 3, 1, 1, 1, True),
    ("conv8_2_mbox_loc", 128, _head(PRIOR_CONFIG[4], "loc"), 3, 1, 1, 1, True),
    ("conv8_2_mbox_conf", 128, _head(PRIOR_CONFIG[4], "conf"), 3, 1, 1, 1, True),
    ("conv9_2_mbox_loc", 128, _head(PRIOR_CONFIG[5], "loc"), 3, 1, 1, 1, True),
    ("conv9_2_mbox_conf", 128, _head(PRIOR_CONFIG[5], "conf"), 3, 1, 1, 1, True),
]

# BatchNorm/Scale pairs: (bn_name, scale_name, channels)
BN_SPECS = [
    ("data_bn", "data_scale", 3),
    ("conv1_bn_h", "conv1_scale_h", 32),
    ("layer_64_1_bn2_h", "layer_64_1_scale2_h", 32),
    ("layer_128_1_bn1_h", "layer_128_1_scale1_h", 32),
    ("layer_128_1_bn2", "layer_128_1_scale2", 128),
    ("layer_256_1_bn1", "layer_256_1_scale1", 128),
    ("layer_256_1_bn2", "layer_256_1_scale2", 256),
    ("layer_512_1_bn1", "layer_512_1_scale1", 256),
    ("layer_512_1_bn2_h", "layer_512_1_scale2_h", 128),
    ("last_bn_h", "last_scale_h", 256),
]

Params = Dict[str, Dict[str, np.ndarray]]


def init_params(seed: int = 0) -> Params:
    """Random msra-style init in the JAX package's tree (conv weights HWIO,
    numpy f32): the same draws in the same order as
    ``melogan_tpu.models.ssd.init_params``, so a seed gives both packages
    equal weights. Real use loads a trained caffemodel instead."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, cin, cout, k, _s, _p, _d, bias in CONV_SPECS:
        fan_in = cin * k * k
        w = rng.normal(0.0, math.sqrt(2.0 / fan_in), (k, k, cin, cout))
        entry = {"w": np.asarray(w, np.float32)}
        if bias:
            entry["b"] = np.zeros((cout,), np.float32)
        params[name] = entry
    for bn, sc, ch in BN_SPECS:
        params[bn] = {"mean": np.zeros((ch,), np.float32), "var": np.ones((ch,), np.float32)}
        params[sc] = {"gamma": np.ones((ch,), np.float32), "beta": np.zeros((ch,), np.float32)}
    params["conv4_3_norm"] = {"scale": np.full((128,), 20.0, np.float32)}
    return params


def load_caffemodel(path: str) -> Params:
    """Convert a res10 SSD ``.caffemodel`` into the JAX package's parameter
    tree (numpy).

    Caffe blob layouts handled: Convolution (out,in,kh,kw)→HWIO (+bias);
    BatchNorm [mean_sum, var_sum, scale_factor] with the moving-average
    scale-factor fold; Scale [gamma, beta]; Normalize [per-channel scale].
    """
    layers = read_caffemodel(path)

    def need(name: str) -> CaffeLayer:
        if name not in layers:
            raise KeyError(f"caffemodel is missing layer {name!r}")
        return layers[name]

    params: Params = {}
    for name, cin, cout, k, _s, _p, _d, bias in CONV_SPECS:
        layer = need(name)
        w = np.asarray(layer.blobs[0], np.float32).reshape(cout, cin, k, k)
        entry = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
        if bias:
            if len(layer.blobs) < 2:
                raise ValueError(f"conv layer {name!r} expected a bias blob")
            entry["b"] = np.asarray(layer.blobs[1], np.float32).reshape(cout)
        params[name] = entry
    for bn, sc, ch in BN_SPECS:
        blobs = need(bn).blobs
        sf = float(np.asarray(blobs[2]).reshape(-1)[0]) if len(blobs) > 2 else 1.0
        inv = 1.0 / sf if sf != 0 else 0.0
        params[bn] = {
            "mean": np.asarray(blobs[0], np.float32).reshape(ch) * inv,
            "var": np.asarray(blobs[1], np.float32).reshape(ch) * inv,
        }
        sblobs = need(sc).blobs
        params[sc] = {
            "gamma": np.asarray(sblobs[0], np.float32).reshape(ch),
            "beta": np.asarray(sblobs[1], np.float32).reshape(ch),
        }
    params["conv4_3_norm"] = {
        "scale": np.asarray(need("conv4_3_norm").blobs[0], np.float32).reshape(128)
    }
    return params


def to_caffe_layers(params: Mapping) -> List[CaffeLayer]:
    """Inverse of ``load_caffemodel`` (round-trip tests / export)."""
    out: List[CaffeLayer] = []
    for name, cin, cout, k, _s, _p, _d, bias in CONV_SPECS:
        blobs = [np.asarray(params[name]["w"]).transpose(3, 2, 0, 1)]
        if bias:
            blobs.append(np.asarray(params[name]["b"]))
        out.append(CaffeLayer(name=name, type="Convolution", blobs=blobs))
    for bn, sc, ch in BN_SPECS:
        out.append(CaffeLayer(name=bn, type="BatchNorm", blobs=[
            np.asarray(params[bn]["mean"]), np.asarray(params[bn]["var"]),
            np.asarray([1.0], np.float32)]))
        out.append(CaffeLayer(name=sc, type="Scale", blobs=[
            np.asarray(params[sc]["gamma"]), np.asarray(params[sc]["beta"])]))
    out.append(CaffeLayer(name="conv4_3_norm", type="Normalize",
                          blobs=[np.asarray(params["conv4_3_norm"]["scale"])]))
    return out


# ---------------------------------------------------------------------------
# The module (prototxt order)
# ---------------------------------------------------------------------------


class CaffeBatchNorm(nn.Module):
    """Caffe ``BatchNorm`` with global statistics: buffers ``mean``, ``var``."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))


class CaffeScale(nn.Module):
    """Caffe ``Scale`` with a bias term: ``weight`` (gamma), ``bias`` (beta)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class CaffeNormalize(nn.Module):
    """Caffe ``Normalize`` across channels, one learned ``scale`` a channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), 20.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the epsilon is added outside the square root, as caffe does
        norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + NORM_EPS
        return x / norm * self.scale[:, None, None]


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class SSD(nn.Module):
    """The res10 SSD: ``forward((B, 300, 300, 3) mean-subtracted BGR)`` →
    ``(loc (B, P, 4), conf (B, P, 2))``."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p, d, bias in CONV_SPECS:
            self.add_module(name, nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d, bias=bias))
        for bn, sc, ch in BN_SPECS:
            self.add_module(bn, CaffeBatchNorm(ch))
            self.add_module(sc, CaffeScale(ch))
        self.conv4_3_norm = CaffeNormalize(128)

    def _bn_scale(self, bn: str, sc: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        p, q = getattr(self, bn), getattr(self, sc)
        y = (x - _chan(p.mean)) * _chan(torch.rsqrt(p.var + BN_EPS)) * _chan(q.weight) + _chan(q.bias)
        return F.relu(y) if relu else y

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self._conv
        x = self._bn_scale("data_bn", "data_scale", x.permute(0, 3, 1, 2), relu=False)
        x = self._bn_scale("conv1_bn_h", "conv1_scale_h", c("conv1_h", x))
        # conv1_pool: caffe ceil-mode 3×3/2 max-pool (150 → 75): pad the high
        # side by 1 with −inf
        x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=-math.inf), 3, 2)

        # layer_64_1: plain residual (no pre-activation on the trunk input)
        y = self._bn_scale("layer_64_1_bn2_h", "layer_64_1_scale2_h", c("layer_64_1_conv1_h", x))
        x = c("layer_64_1_conv2_h", y) + x

        # layer_128_1: pre-activation, stride 2, 1×1 expand shortcut
        pre = self._bn_scale("layer_128_1_bn1_h", "layer_128_1_scale1_h", x)
        y = self._bn_scale("layer_128_1_bn2", "layer_128_1_scale2", c("layer_128_1_conv1_h", pre))
        x = c("layer_128_1_conv2", y) + c("layer_128_1_conv_expand_h", pre)

        # layer_256_1 — its pre-activation (38×38×128) is the conv4_3_norm tap
        pre256 = self._bn_scale("layer_256_1_bn1", "layer_256_1_scale1", x)
        y = self._bn_scale("layer_256_1_bn2", "layer_256_1_scale2", c("layer_256_1_conv1", pre256))
        x = c("layer_256_1_conv2", y) + c("layer_256_1_conv_expand", pre256)

        # layer_512_1: stride 1, dilated 3×3 (pad 2, dilation 2)
        pre = self._bn_scale("layer_512_1_bn1", "layer_512_1_scale1", x)
        y = self._bn_scale("layer_512_1_bn2_h", "layer_512_1_scale2_h", c("layer_512_1_conv1_h", pre))
        x = c("layer_512_1_conv2_h", y) + c("layer_512_1_conv_expand_h", pre)

        fc7 = self._bn_scale("last_bn_h", "last_scale_h", x)  # 19×19×256

        c6 = F.relu(c("conv6_2_h", F.relu(c("conv6_1_h", fc7))))
        c7 = F.relu(c("conv7_2_h", F.relu(c("conv7_1_h", c6))))
        c8 = F.relu(c("conv8_2_h", F.relu(c("conv8_1_h", c7))))
        c9 = F.relu(c("conv9_2_h", F.relu(c("conv9_1_h", c8))))

        sources = {"conv4_3_norm": self.conv4_3_norm(pre256), "fc7": fc7, "conv6_2_h": c6,
                   "conv7_2_h": c7, "conv8_2_h": c8, "conv9_2_h": c9}
        locs, confs = [], []
        for cfg in PRIOR_CONFIG:
            src = sources[cfg["src"]]
            head = "conv4_3_norm" if cfg["src"] == "conv4_3_norm" else cfg["src"].removesuffix("_h")
            # NCHW → NHWC before the reshape: the priors run (row, col, anchor)
            loc = c(f"{head}_mbox_loc", src).permute(0, 2, 3, 1)
            conf = c(f"{head}_mbox_conf", src).permute(0, 2, 3, 1)
            locs.append(loc.reshape(loc.shape[0], -1, 4))
            confs.append(conf.reshape(conf.shape[0], -1, NUM_CLASSES))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """CENTER_SIZE decode with the prototxt variances."""
    vx, vy, vw, vh = VARIANCES
    cx = priors[:, 0] + loc[..., 0] * vx * priors[:, 2]
    cy = priors[:, 1] + loc[..., 1] * vy * priors[:, 3]
    w = priors[:, 2] * torch.exp(loc[..., 2] * vw)
    h = priors[:, 3] * torch.exp(loc[..., 3] * vh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def nms_host(boxes: np.ndarray, scores: np.ndarray, iou_threshold=NMS_THRESHOLD) -> np.ndarray:
    """Greedy NMS on the host over score-sorted candidates → keep mask.

    Exact greedy suppression is inherently sequential; over the ≤400
    DetectionOutput candidates it costs well under a millisecond in numpy,
    so the detector's device program ends at the sorted top-k and this runs
    on the CPU, as in the JAX package.
    """
    n = len(scores)
    keep = np.ones(n, bool)
    # untrained/degenerate weights can decode to inf/NaN/huge boxes; sanitize
    # in f64 with a hard clip so the suppression arithmetic stays defined and
    # overflow-free (degenerate candidates get suppressed/ignored)
    boxes = np.nan_to_num(boxes.astype(np.float64), nan=0.0, posinf=1e6, neginf=-1e6)
    boxes = np.clip(boxes, -1e6, 1e6)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    for i in range(n):
        if not keep[i]:
            continue
        xx1 = np.maximum(x1[i], x1[i + 1:])
        yy1 = np.maximum(y1[i], y1[i + 1:])
        xx2 = np.minimum(x2[i], x2[i + 1:])
        yy2 = np.minimum(y2[i], y2[i + 1:])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(area[i] + area[i + 1:] - inter, 1e-9)
        keep[i + 1:] &= iou <= iou_threshold
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold=NMS_THRESHOLD, top_k=NMS_TOP_K):
    """Static-shape NMS over the ``top_k`` best candidates, on the device of
    ``boxes`` and ``scores``: the counterpart of the JAX package's ``nms``
    (for fully on-device deployments; ``FaceDetector`` runs ``nms_host``, as
    the JAX detector does). Returns ``(order, scores, boxes, keep)`` over the
    top-k: the candidates' indices by descending score (ties in index
    order), their scores and boxes, and the greedy keep mask."""
    top_k = min(top_k, scores.shape[0])
    order = torch.sort(-scores, stable=True).indices[:top_k]
    b = boxes[order]
    s = scores[order]
    area = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    # row i: the IoU of candidate i with every candidate, as JAX's loop body computes it
    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    later = torch.ones(top_k, top_k, dtype=torch.bool, device=b.device).triu(1)
    over = (iou > iou_threshold) & later
    keep = torch.ones(top_k, dtype=torch.bool, device=b.device)
    for i in range(top_k):  # greedy: a suppressed candidate suppresses nothing
        keep &= ~(over[i] & keep[i])
    return order, s, b, keep


def resize_frame(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) → (300, 300, 3) bilinear with half-pixel centres,
    antialiased when it shrinks: ``jax.image.resize(..., "bilinear")``."""
    x = F.interpolate(frame.permute(2, 0, 1)[None], size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                      align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0)


class FaceDetector:
    """cv2.dnn-style interface over the SSD on ``device``.

    ``params`` is the JAX package's tree (``init_params``,
    ``load_caffemodel``); without trained weights the detector is
    topology-complete but unscored (the camera pipeline falls back to its
    heuristic localizer on empty detections).
    """

    def __init__(self, params=None, seed: int = 0, device="cuda"):
        from melogan_torch.utils.weights import ssd_state_from_jax, to_tensors

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 parity with XLA's convs: cuDNN must not drop to TF32
            torch.backends.cudnn.allow_tf32 = False
        self.net = SSD()
        self.net.load_state_dict(to_tensors(ssd_state_from_jax(
            params if params is not None else init_params(seed))), strict=True)
        self.net.to(self.device).eval()
        self.priors = torch.from_numpy(generate_priors()).to(self.device)
        self._mean = torch.tensor(MEAN_BGR, device=self.device)
        self._worker = DeviceWorker("ssd")

    def close(self) -> None:
        """End the thread that runs ``detect``'s device calls."""
        self._worker.close()

    @classmethod
    def from_caffemodel(cls, path: str, device="cuda") -> "FaceDetector":
        return cls(params=load_caffemodel(path), device=device)

    @torch.inference_mode()
    def candidates(self, frame_bgr) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device program: resize → mean-sub → SSD → softmax → decode →
        a stable descending sort of the face probabilities (``jnp.argsort(-p)``)
        → the top ``NMS_TOP_K`` boxes (K, 4) and scores (K,), on the device."""
        frame = torch.as_tensor(np.asarray(frame_bgr, np.float32)).to(self.device)
        x = resize_frame(frame) - self._mean
        loc, conf = self.net(x[None])
        probs = torch.softmax(conf, dim=-1)[0, :, 1]  # face class
        boxes = decode_boxes(loc[0], self.priors)
        order = torch.sort(probs, descending=True, stable=True).indices[:NMS_TOP_K]
        return boxes[order], probs[order]

    @staticmethod
    def rows(boxes: np.ndarray, scores: np.ndarray, conf_threshold: float = 0.5,
             max_det: int = 20) -> np.ndarray:
        """The host part: NMS over the sorted candidates, then the rows at or
        above ``conf_threshold``, at most ``max_det`` (and ``KEEP_TOP_K``)."""
        keep = nms_host(boxes, scores)
        rows = []
        max_det = min(max_det, KEEP_TOP_K)
        for i in range(len(scores)):
            if keep[i] and scores[i] >= conf_threshold and len(rows) < max_det:
                rows.append([0, 1, float(scores[i]), *[float(v) for v in boxes[i]]])
        return np.asarray(rows, np.float32).reshape(-1, 7)

    def detect(self, frame_bgr: np.ndarray, conf_threshold: float = 0.5, max_det: int = 20) -> np.ndarray:
        """(H, W, 3) BGR uint8/float → (N, 7) cv2.dnn-style detections."""
        boxes, scores = self._worker(lambda: [t.cpu().numpy() for t in self.candidates(frame_bgr)])
        return self.rows(boxes, scores, conf_threshold, max_det)
