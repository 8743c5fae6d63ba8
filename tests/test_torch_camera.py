"""The port's camera path against the JAX package, on the CPU: the JPEG
encoders (Python and native) and the drawing primitives byte for byte, the
y4m codec, the caffemodel codec, the res10 SSD (priors, seeded weights, the
forward, the resize, ``detect`` on the crafted detector), the mini-Xception
FER (forward and per-crop probabilities, the h5 loader), ``CameraEmotion``,
``mjpeg_parts`` and both weight bridges.

Tolerances: 1e-5 of the output's scale for the SSD's (loc, conf), the
resize and the FER's probabilities (both sides IEEE f32 in different
summation orders, about 3e-6 of scale here; a wrong pad, tap or layout is
O(1) of it). Bytes (JPEG, y4m, caffemodel, MJPEG parts) and host arithmetic
(priors, seeded draws, caffemodel round trips, draw) are equal exactly.
"""
import importlib.util
import io
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu import camera as jcam
from melogan_tpu.imaging import draw as jdraw
from melogan_tpu.imaging import jpeg as jjpeg
from melogan_tpu.imaging import native as jnative
from melogan_tpu.imaging import y4m as jy4m
from melogan_tpu.models import caffe as jcaffe
from melogan_tpu.models import ssd as jssd
from melogan_tpu.models import xception as jx
from melogan_tpu.serving import video as jvideo

from melogan_torch import camera as tcam
from melogan_torch.imaging import draw as tdraw
from melogan_torch.imaging import jpeg as tjpeg
from melogan_torch.imaging import native as tnative
from melogan_torch.imaging import y4m as ty4m
from melogan_torch.models import caffe as tcaffe
from melogan_torch.models import ssd as tssd
from melogan_torch.models import xception as tx
from melogan_torch.serving import video as tvideo
from melogan_torch.utils.weights import ssd_state_from_jax, to_tensors, xception_state_from_keras

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py: the crafted detector, the face frame and the random
    Keras weights it drives the card with."""
    return _load("chip_smoke_camera", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(out, ref, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= REL * scale, f"{what}: {err:.3e} > {REL} x {scale:.3e}"


def _smooth_image(h=120, w=160):
    gx, gy = np.meshgrid(np.linspace(0, 255, w), np.linspace(0, 255, h))
    img = np.stack([gx, gy, np.full((h, w), 128.0)], -1).astype(np.uint8)
    img[30:60, 40:90] = [220, 50, 50]
    return img


_RNG = np.random.default_rng(7)
IMAGES = {
    "smooth": _smooth_image(),
    "noise_37x53": _RNG.integers(0, 256, (37, 53, 3)).astype(np.uint8),
    "black": np.zeros((16, 16, 3), np.uint8),
    "white_64x48": np.full((64, 48, 3), 255, np.uint8),
    "gray_41x31": _RNG.integers(0, 256, (41, 31)).astype(np.uint8),
    "float_out_of_range": _RNG.uniform(-80, 400, (9, 13, 3)).astype(np.float32),
}


def _rgb(img):
    """What ``encode_jpeg`` encodes: uint8, clipped, grey stacked to RGB."""
    rgb = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([rgb] * 3, -1) if rgb.ndim == 2 else rgb


@pytest.fixture(scope="module")
def native_libs():
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip(f"native JPEG library unavailable ({tnative.load_error()})")


# ---------------------------------------------------------------------------
# imaging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [1, 20, 50, 80, 95, 100])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_python_jpeg_bytes_equal_jax(name, quality, monkeypatch):
    """The Python encoder through ``encode_jpeg`` (``MELOGAN_NATIVE_JPEG=0``
    forces it in both packages): grey, sizes that are not multiples of 8,
    values outside 0..255, the whole quality ladder."""
    monkeypatch.setenv("MELOGAN_NATIVE_JPEG", "0")
    data = tjpeg.encode_jpeg(IMAGES[name], quality)
    assert data == jjpeg._encode_jpeg_py(_rgb(IMAGES[name]), quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("quality", [20, 80, 95])
def test_native_jpeg_bytes_equal_jax_and_python(native_libs, quality):
    """The port's build of ``native/jpeg_codec.cpp`` gives the JAX build's
    bytes, and at the standard qualities the Python encoder's (above 90 a
    rounding tie may legally differ by one quantizer step)."""
    for name, img in IMAGES.items():
        rgb = _rgb(img)
        data = tnative.encode_jpeg_native(rgb, quality)
        assert data == jnative.encode_jpeg_native(rgb, quality), name
        assert tjpeg.encode_jpeg(img, quality) == data, name
        if quality <= 90:
            assert data == tjpeg._encode_jpeg_py(rgb, quality), name


def test_native_library_builds_under_build_dir(native_libs):
    """The library lives in ``build/melogan_torch/``, not in ``native/``
    (the JAX loader's), and is not rebuilt while it is newer than its source."""
    assert tnative.LIB_PATH == ROOT / "build" / "melogan_torch" / "libmelojpeg.so"
    assert tnative.LIB_PATH.exists() and not tnative.is_stale()
    mtime = tnative.LIB_PATH.stat().st_mtime
    assert tnative.build() == tnative.LIB_PATH and tnative.LIB_PATH.stat().st_mtime == mtime
    with pytest.raises(ValueError, match="H, W, 3"):
        tnative.encode_jpeg_native(np.zeros((4, 4), np.uint8))


def test_draw_equals_jax():
    a = np.zeros((60, 80, 3), np.uint8)
    b = a.copy()
    for mod, img in ((tdraw, a), (jdraw, b)):
        mod.draw_rect(img, 5, 7, 70, 50, color=(0, 230, 0), thickness=3)
        mod.draw_rect(img, -10, 90, 200, 30)  # clipped and sorted corners
        mod.draw_text(img, "Calm 97.5%: -x?", 2, 40, color=(10, 20, 30), scale=1)
        mod.draw_text(img, "happy", 60, -3, scale=3)  # off the frame's edges
    assert np.array_equal(a, b) and a.any()


@pytest.mark.parametrize("colorspace", ["444", "420"])
def test_y4m_bytes_and_frames_equal_jax(tmp_path, colorspace):
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) for _ in range(3)]
    bufs = {}
    for name, mod in (("port", ty4m), ("jax", jy4m)):
        buf = io.BytesIO()
        assert mod.write_y4m(buf, frames, rate=(25, 1), colorspace=colorspace) == 3
        bufs[name] = buf.getvalue()
    assert bufs["port"] == bufs["jax"]
    (hdr, it), (jhdr, jit) = ty4m.read_y4m(io.BytesIO(bufs["port"])), jy4m.read_y4m(io.BytesIO(bufs["jax"]))
    assert hdr == jhdr
    for a, b in zip(list(it), list(jit), strict=True):
        assert np.array_equal(a, b)
    # the variants of the header the reader takes
    for cs, chroma in ((b"C420jpeg", 12), (b"C422", 24), (b"Cmono", 0)):  # both planes' bytes at 6x4
        raw = b"YUV4MPEG2 W6 H4 F30:1 " + cs + b"\nFRAME\n" + bytes(range(24)) + bytes([128]) * chroma
        (a,), (b,) = list(ty4m.read_y4m(io.BytesIO(raw))[1]), list(jy4m.read_y4m(io.BytesIO(raw))[1])
        assert np.array_equal(a, b)


@pytest.mark.parametrize("raw", [
    b"NOTY4M W2 H2\n", b"YUV4MPEG2 F30:1\n", b"YUV4MPEG2 W2 H2 C999\n", b"",
    b"YUV4MPEG2 W2 H2 F30:0 C444\n", b"YUV4MPEG2 W4 H4 F25:1 C420p10\n", b"YUV4MPEG2 W3 H4 C420\n",
    b"YUV4MPEG2 W2 H2 C444\nFRAME\n\x01\x02", b"YUV4MPEG2 W2 H2 C444\nFRAMX\n" + bytes(12),
])
def test_y4m_malformed_fails_typed_as_jax(raw):
    """The same input fails in both packages, each with its own Y4MError."""
    errors = []
    for mod in (ty4m, jy4m):
        with pytest.raises(mod.Y4MError) as e:
            list(mod.read_y4m(io.BytesIO(raw))[1])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_y4m_frame_source_loops_as_jax(tmp_path):
    rng = np.random.default_rng(5)
    p = tmp_path / "loop.y4m"
    with open(p, "wb") as f:
        ty4m.write_y4m(f, [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8) for _ in range(2)])
    src, jsrc = ty4m.Y4MFrameSource(str(p), loop=True), jy4m.Y4MFrameSource(str(p), loop=True)
    assert (src.width, src.height, src.rate) == (jsrc.width, jsrc.height, jsrc.rate) == (8, 8, (30, 1))
    it, jit = iter(src), iter(jsrc)
    got = [next(it) for _ in range(5)]
    for a in got:
        assert np.array_equal(a, next(jit))
    assert np.array_equal(got[0], got[2]) and np.array_equal(got[1], got[3])
    assert len(list(ty4m.Y4MFrameSource(str(p), loop=False))) == 2
    with pytest.raises(OSError):
        ty4m.Y4MFrameSource(str(tmp_path / "missing.y4m"))


# ---------------------------------------------------------------------------
# caffemodel codec and the SSD
# ---------------------------------------------------------------------------


def test_caffemodel_bytes_and_round_trip_equal_jax(tmp_path):
    params = tssd.init_params(seed=3)
    tp, jp = str(tmp_path / "port.caffemodel"), str(tmp_path / "jax.caffemodel")
    tcaffe.write_caffemodel(tp, tssd.to_caffe_layers(params))
    jcaffe.write_caffemodel(jp, jssd.to_caffe_layers(jssd.init_params(seed=3)))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    raw = tcaffe.read_caffemodel(jp)
    assert raw["conv1_h"].type == "Convolution" and raw["conv1_h"].blobs[0].shape == (32, 3, 7, 7)
    loaded, jloaded = tssd.load_caffemodel(jp), jssd.load_caffemodel(tp)
    assert set(loaded) == set(params) == set(jloaded)
    for name in params:
        for key in params[name]:
            assert np.array_equal(loaded[name][key], params[name][key]), (name, key)
            assert np.array_equal(loaded[name][key], np.asarray(jloaded[name][key])), (name, key)
    # a BatchNorm scale factor other than 1 folds the same way
    layers = tssd.to_caffe_layers(params)
    for layer in layers:
        if layer.type == "BatchNorm":
            layer.blobs = [layer.blobs[0] * 4, layer.blobs[1] * 4 + 1, np.asarray([4.0], np.float32)]
    tcaffe.write_caffemodel(tp, layers)
    folded, jfolded = tssd.load_caffemodel(tp), jssd.load_caffemodel(tp)
    assert all(np.array_equal(folded[bn][k], np.asarray(jfolded[bn][k]))
               for bn, _sc, _ch in tssd.BN_SPECS for k in ("mean", "var"))
    missing = [layer for layer in layers if layer.name != "fc7_mbox_loc"]
    tcaffe.write_caffemodel(tp, missing)
    with pytest.raises(KeyError, match="fc7_mbox_loc"):
        tssd.load_caffemodel(tp)


def test_caffemodel_malformed_bytes_fail_as_jax(tmp_path):
    """Truncated, flipped and garbage bytes: both readers give the same
    layers or both raise a typed exception."""
    path = str(tmp_path / "m.caffemodel")
    tcaffe.write_caffemodel(path, [tcaffe.CaffeLayer("conv", "Convolution", [np.ones((2, 3), np.float32)])])
    valid = open(path, "rb").read()
    rng = np.random.default_rng(11)
    cases = [valid[:cut] for cut in (1, len(valid) // 2, len(valid) - 1)] + [b"\xff" * 64, b""]
    for _ in range(150):
        b = bytearray(valid)
        for _ in range(rng.integers(1, 6)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        cases.append(bytes(b))
    cases.append(b"\x12\x00")  # a legacy V1 layers field
    typed = (ValueError, KeyError, IndexError, EOFError, struct.error)
    for payload in cases:
        with open(path, "wb") as f:
            f.write(payload)
        out = {}
        for name, mod in (("port", tcaffe), ("jax", jcaffe)):
            try:
                out[name] = {k: (v.type, [np.asarray(x).tobytes() for x in v.blobs])
                             for k, v in mod.read_caffemodel(path).items()}
            except typed as e:
                out[name] = type(e)
        assert out["port"] == out["jax"], payload[:40]


def test_prototxt_parse_equals_jax(tmp_path, reference_dir):
    src = os.path.join(reference_dir, "camera", "deploy.prototxt.txt")
    if not os.path.exists(src):
        pytest.skip("reference prototxt not available")
    layers, jlayers = tcaffe.parse_prototxt(src), jcaffe.parse_prototxt(src)
    assert [vars(x) for x in layers] == [vars(x) for x in jlayers]
    convs = {x.name: x for x in layers if x.type == "Convolution"}
    assert set(convs) == {spec[0] for spec in tssd.CONV_SPECS}


def test_priors_and_seeded_params_equal_jax():
    priors = tssd.generate_priors()
    assert priors.shape == (8892, 4) and np.array_equal(priors, jssd.generate_priors())
    assert tssd.CONV_SPECS == jssd.CONV_SPECS and tssd.BN_SPECS == jssd.BN_SPECS
    assert tssd.PRIOR_CONFIG == jssd.PRIOR_CONFIG
    for seed in (0, 5):
        params, jparams = tssd.init_params(seed), jssd.init_params(seed)
        assert set(params) == set(jparams)
        for name in params:
            for key in params[name]:
                assert np.array_equal(params[name][key], np.asarray(jparams[name][key])), (seed, name, key)


def test_ssd_bridge_loads_strictly_and_maps_layouts():
    params = tssd.init_params(1)
    sd = ssd_state_from_jax(jssd.init_params(1))
    net = tssd.SSD()
    net.load_state_dict(to_tensors(sd), strict=True)
    assert set(sd) == set(net.state_dict())
    assert np.array_equal(sd["conv1_h.weight"], params["conv1_h"]["w"].transpose(3, 2, 0, 1))
    assert sd["layer_512_1_conv2_h.weight"].shape == (256, 128, 3, 3)
    assert net.layer_512_1_conv2_h.dilation == (2, 2) and net.layer_512_1_conv2_h.padding == (2, 2)
    assert np.array_equal(sd["data_scale.weight"], params["data_scale"]["gamma"])
    assert np.array_equal(sd["last_bn_h.var"], params["last_bn_h"]["var"])
    assert np.array_equal(sd["conv4_3_norm.scale"], np.full(128, 20.0, np.float32))


@pytest.fixture(scope="module")
def seeded():
    """Seeded SSD weights with BN statistics and biases away from the
    identity, in both packages."""
    params = tssd.init_params(2)
    rng = np.random.default_rng(9)
    for bn, sc, ch in tssd.BN_SPECS[1:]:
        params[bn]["mean"] = rng.normal(0, 0.5, ch).astype(np.float32)
        params[bn]["var"] = rng.uniform(0.5, 2.0, ch).astype(np.float32)
        params[sc]["gamma"] = rng.uniform(0.3, 0.8, ch).astype(np.float32)
        params[sc]["beta"] = rng.normal(0, 0.2, ch).astype(np.float32)
    for name, *_rest, bias in tssd.CONV_SPECS:
        if bias:
            params[name]["b"] = rng.normal(0, 0.2, params[name]["b"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("batch", [1, 2])
def test_ssd_forward_equals_jax(seeded, batch):
    rng = np.random.default_rng(batch)
    x = rng.uniform(-128, 128, (batch, 300, 300, 3)).astype(np.float32)
    jloc, jconf = jax.jit(jssd.forward)({k: {kk: jnp.asarray(v) for kk, v in e.items()}
                                         for k, e in seeded.items()}, jnp.asarray(x))
    net = tssd.FaceDetector(params=seeded, device="cpu").net
    with torch.inference_mode():
        loc, conf = net(torch.from_numpy(x))
    assert loc.shape == (batch, 8892, 4) and conf.shape == (batch, 8892, 2)
    _close(loc.numpy(), jloc, "loc")
    _close(conf.numpy(), jconf, "conf")


@pytest.mark.parametrize("hw", [(240, 320), (480, 640), (137, 451), (300, 300)])
def test_resize_equals_jax_image_resize(hw):
    """``F.interpolate(antialias=True)`` is ``jax.image.resize``'s bilinear,
    which antialiases when it shrinks (without it they differ by 19–141)."""
    frame = np.random.default_rng(hw[0]).uniform(0, 255, (*hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(frame), (300, 300, 3), "bilinear")
    _close(tssd.resize_frame(torch.from_numpy(frame)).numpy(), ref, f"resize {hw}")


@pytest.fixture(scope="module")
def crafted(cs):
    params = cs.crafted_ssd_params()
    return {"params": params, "port": tssd.FaceDetector(params=params, device="cpu"),
            "jax": jssd.FaceDetector(params={k: {kk: jnp.asarray(v) for kk, v in e.items()}
                                             for k, e in params.items()})}


def test_crafted_params_equal_the_jax_tests(cs):
    jt = _load("jax_emotion_model_tests", ROOT / "tests" / "test_emotion_models.py")
    ref, params = jt.craft_brightness_detector_params(), cs.crafted_ssd_params()
    assert set(ref) == set(params)
    for name in ref:
        for key in ref[name]:
            assert np.array_equal(np.asarray(ref[name][key]), params[name][key]), (name, key)


def test_detect_rows_equal_jax_on_the_crafted_detector(crafted, cs, tmp_path):
    """The crafted weights through a ``.caffemodel`` written by the port:
    the port's rows equal JAX's, the bright square is found, a dark frame
    gives none."""
    path = str(tmp_path / "crafted.caffemodel")
    tcaffe.write_caffemodel(path, tssd.to_caffe_layers(crafted["params"]))
    det = tssd.FaceDetector.from_caffemodel(path, device="cpu")
    frame = cs.face_frame()
    rows, jrows = det.detect(frame, conf_threshold=0.5), crafted["jax"].detect(frame, conf_threshold=0.5)
    assert rows.shape == jrows.shape and rows.shape[0] >= 1
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-5)
    best = rows[np.argmax(rows[:, 2])]
    cx, cy = (best[3] + best[5]) / 2, (best[4] + best[6]) / 2
    assert best[2] > 0.85 and 0.3125 < cx < 0.6875 and 0.25 < cy < 0.75
    low, jlow = det.detect(frame, conf_threshold=0.0, max_det=50), crafted["jax"].detect(
        frame, conf_threshold=0.0, max_det=50)
    np.testing.assert_allclose(low, jlow, rtol=0, atol=1e-5)
    dark = np.full((240, 320, 3), 20.0, np.float32)
    assert det.detect(dark, conf_threshold=0.5).shape == (0, 7)


def test_detect_candidates_sort_stably(crafted, cs):
    """The device program's top 400: probabilities descending, ties in
    prior order (``jnp.argsort(-p)``), and the host part's rows."""
    boxes, scores = crafted["port"].candidates(cs.face_frame())
    assert boxes.shape == (tssd.NMS_TOP_K, 4) and scores.shape == (tssd.NMS_TOP_K,)
    assert bool((scores[:-1] >= scores[1:]).all())
    jboxes, jscores = jax.device_get(crafted["jax"]._pipeline(crafted["jax"].params,
                                                              jnp.asarray(cs.face_frame())))
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(boxes.numpy(), jboxes, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# mini-Xception
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def keras(cs):
    return cs.random_keras_weights(seed=4)


@pytest.fixture(scope="module")
def fer(keras):
    return tx.FERClassifier(keras, device="cpu")


@pytest.mark.parametrize("batch", [1, 3])
def test_mini_xception_equals_jax(keras, fer, batch):
    x = np.random.default_rng(batch).uniform(0, 1, (batch, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jx.mini_xception_forward(keras, jnp.asarray(x)))
    with torch.inference_mode():
        out = fer.net(torch.from_numpy(x)).numpy()
    _close(out, ref, f"mini-Xception B={batch}")
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    assert ref.max() < 0.999  # the random weights give no one-hot answer


@pytest.mark.parametrize("shape", [(1, 40, 56), (1, 90, 70), (1, 17, 123), (2, 64, 64, 1)])
def test_fer_predict_proba_equals_jax(keras, fer, shape):
    """Crops of any size through the host resize, in [0, 255] (the /255 on
    the device) and in [0, 1]."""
    crop = np.random.default_rng(shape[1]).uniform(0, 255, shape).astype(np.float32)
    jfer = jx.FERClassifier(keras)
    for x in (crop, crop / 255.0):
        _close(fer.predict_proba(x), jfer.predict_proba(x), f"predict_proba {shape}")
    assert fer.predict_emotion(crop[0]) == jfer.predict_emotion(crop[0])


def test_xception_bridge_loads_strictly_and_maps_layouts(keras):
    sd = xception_state_from_keras(keras)
    net = tx.MiniXception()
    net.load_state_dict(to_tensors(sd), strict=True)
    assert set(sd) == set(net.state_dict())
    dw = keras["separable_conv2d_4/depthwise_kernel"]  # (3, 3, 32, 1)
    assert np.array_equal(sd["separable_conv2d_4.depthwise.weight"], dw.transpose(2, 3, 0, 1))
    assert net.separable_conv2d_4.depthwise.groups == 32
    assert np.array_equal(sd["conv2d_3.weight"][:, :, 0, 0], keras["conv2d_3/kernel"][0, 0].T)
    assert np.array_equal(sd["batch_normalization_12.running_var"],
                          keras["batch_normalization_12/moving_variance"])
    with pytest.raises(KeyError):
        xception_state_from_keras({**keras, "dense_1/kernel_constraint": np.zeros(1)})


def test_same_padding_is_tf_asymmetric():
    """60 → 30 pads (0, 1), 15 → 8 pads (1, 1), as XLA's "SAME" does."""
    for n, want in ((60, (0, 1)), (30, (0, 1)), (15, (1, 1)), (8, (0, 1))):
        x = torch.zeros(1, 1, n, n)
        padded = tx._same_pad(x, 3, 2, -1.0)
        assert padded.shape[-1] == n + sum(want)
        assert bool((padded[0, 0, 0, :] == -1).all()) == (want[0] == 1)


def _write_keras_h5(path, weights):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        group = f.create_group("model_weights")
        for key, value in weights.items():
            layer, leaf = key.split("/")
            group.require_group(layer).require_group(f"{layer}_1").create_dataset(f"{leaf}:0", data=value)


def test_h5_loader_and_default_fer_equal_jax(keras, tmp_path, monkeypatch):
    path = str(tmp_path / "mini_xception.h5")
    _write_keras_h5(path, keras)
    loaded, jloaded = tx.load_mini_xception_weights(path), jx.load_mini_xception_weights(path)
    assert set(loaded) == set(keras) == set(jloaded)
    assert all(np.array_equal(loaded[k], keras[k]) and np.array_equal(jloaded[k], keras[k]) for k in keras)
    monkeypatch.setenv("MELOGAN_FER_H5", path)
    assert tx.h5_candidates()[0] == path
    fer = tx.load_default_fer(device="cpu")
    crop = np.random.default_rng(0).uniform(0, 255, (1, 48, 80)).astype(np.float32)
    _close(fer.predict_proba(crop), jx.FERClassifier(jloaded).predict_proba(crop), "default FER")


def test_default_fer_absent_or_broken(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MELOGAN_FER_H5", raising=False)
    monkeypatch.delenv("MELOGAN_REFERENCE_DIR", raising=False)
    assert tx.load_default_fer(device="cpu") is None
    monkeypatch.setenv("MELOGAN_REFERENCE_DIR", str(tmp_path / "ref"))
    assert tx.h5_candidates()[-1] == str(tmp_path / "ref" / "camera" / "mini_xception.h5")
    bad = tmp_path / "broken.h5"
    bad.write_bytes(b"not an h5 file")
    monkeypatch.setenv("MELOGAN_FER_H5", str(bad))
    with pytest.raises((OSError, ImportError)):
        tx.load_default_fer(device="cpu")


def test_real_mini_xception_weights(reference_dir):
    path = os.path.join(reference_dir, "camera", "mini_xception.h5")
    if not os.path.exists(path):
        pytest.skip("no mini_xception.h5 available")
    weights = tx.load_mini_xception_weights(path)
    crop = np.random.default_rng(1).uniform(0, 255, (3, 64, 64)).astype(np.float32)
    _close(tx.FERClassifier(weights, device="cpu").predict_proba(crop),
           jx.FERClassifier(weights).predict_proba(crop), "mini_xception.h5")


# ---------------------------------------------------------------------------
# CameraEmotion and the MJPEG parts
# ---------------------------------------------------------------------------


def test_gray_and_heuristic_box_equal_jax():
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    assert np.array_equal(tcam.rgb_to_gray(frame), jcam.rgb_to_gray(frame))
    gray = np.zeros((120, 160), np.float32)
    gray[30:90, 50:110] = rng.uniform(0, 255, (60, 60))
    assert tcam.heuristic_face_box(gray) == jcam.heuristic_face_box(gray)


@pytest.mark.parametrize("with_ssd", [False, True])
def test_camera_emotion_equals_jax(keras, fer, crafted, cs, with_ssd):
    """The heuristic box, then the crafted SSD's: the same box and emotion
    in both packages, and the SSD's box on the bright square."""
    cam = tcam.CameraEmotion(fer=fer, face_detector=crafted["port"] if with_ssd else None)
    jcamera = jcam.CameraEmotion(fer=jx.FERClassifier(keras), face_detector=crafted["jax"] if with_ssd else None)
    frames = [cs.face_frame(), next(iter(tvideo.SyntheticFrameSource(n_frames=1))).astype(np.float32)]
    for frame in frames:
        assert cam.process_frame(frame) == jcamera.process_frame(frame)
        assert cam.last_box == jcamera.last_box and cam.current_emotion == jcamera.current_emotion
    cam.process_frame(frames[0])
    x1, y1, x2, y2 = cam.last_box
    if with_ssd:
        assert 100 <= (x1 + x2) / 2 <= 220 and 60 <= (y1 + y2) / 2 <= 180
    assert list(cam.generate_emotions(iter(frames))) == list(jcamera.generate_emotions(iter(frames)))


@pytest.mark.parametrize("with_camera", [False, True])
def test_mjpeg_parts_bytes_equal_jax(keras, fer, with_camera):
    frames = list(tvideo.SyntheticFrameSource(n_frames=3))
    assert all(np.array_equal(a, b) for a, b in zip(frames, jvideo.SyntheticFrameSource(n_frames=3)))
    seen, jseen = [], []
    parts = list(tvideo.mjpeg_parts(frames, tcam.CameraEmotion(fer=fer) if with_camera else None,
                                    on_emotion=seen.append))
    jparts = list(jvideo.mjpeg_parts(frames, jcam.CameraEmotion(fer=jx.FERClassifier(keras))
                                     if with_camera else None, on_emotion=jseen.append))
    assert parts == jparts and seen == jseen and len(parts) == 3
    assert tvideo.BOUNDARY == jvideo.BOUNDARY
    for part in parts:
        head, jpeg = part.split(b"\r\n\r\n", 1)
        assert head.startswith(b"--frame\r\nContent-Type: image/jpeg")
        assert jpeg[:2] == b"\xff\xd8" and jpeg.rstrip(b"\r\n")[-2:] == b"\xff\xd9"
