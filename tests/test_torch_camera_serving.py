"""The port's camera routes against the JAX server's, on the CPU:
``POST /camera_frame`` (503 without a FER, 413, 400, and with a FER
injected the JAX server's emotion for the same frame), ``GET
/get_camera_emotion``, ``GET /video_feed`` (503 without a source; the
synthetic source's parts with the overlay; a ``.y4m`` source, also through
``create_server``), ``/healthz``'s camera fields, ``/metrics``' labels, and
a FER weight file that fails to load stopping ``create_server``.

Each app is driven through WSGI calls in this process; every
``create_server`` is closed in a ``finally`` block.
"""
import importlib.util
import io
import itertools
import json
from pathlib import Path
from wsgiref.util import setup_testing_defaults

import numpy as np
import pytest
import torch

from melogan_tpu.config import GANConfig as JaxGANConfig
from melogan_tpu.models import xception as jx
from melogan_tpu.serving import app as japp

from melogan_torch.camera import CameraEmotion
from melogan_torch.config import GANConfig
from melogan_torch.imaging.y4m import Y4MFrameSource, write_y4m
from melogan_torch.models import xception as tx
from melogan_torch.sampling import Sampler
from melogan_torch.serving import app as tapp
from melogan_torch.serving.video import SyntheticFrameSource

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)
EMOTIONS = {"happy", "sad", "angry", "calm"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def no_fer_file(tmp_path, monkeypatch):
    """No weight file is found unless a test names one."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MELOGAN_FER_H5", raising=False)
    monkeypatch.delenv("MELOGAN_REFERENCE_DIR", raising=False)
    monkeypatch.delenv("MELOGAN_CAMERA_SOURCE", raising=False)


@pytest.fixture(scope="module")
def keras():
    spec = importlib.util.spec_from_file_location("chip_smoke_camera_serving", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.random_keras_weights(seed=6)


@pytest.fixture(scope="module")
def sampler():
    return Sampler(GANConfig(**SMALL), seed=0, device="cpu")


def call(app, method, path, body=b"", content_length=None, parts=None):
    """One WSGI request: (status, headers, body). With ``parts``, only that
    many chunks of a streamed body are read before it is closed, as a
    client that hangs up does."""
    environ = {}
    setup_testing_defaults(environ)
    environ.update(REQUEST_METHOD=method, PATH_INFO=path, CONTENT_TYPE="application/json",
                   CONTENT_LENGTH=str(len(body) if content_length is None else content_length))
    environ["wsgi.input"] = io.BytesIO(body)
    seen = {}

    def start_response(status, headers, exc_info=None):
        seen["status"], seen["headers"] = status, dict(headers)

    result = app(environ, start_response)
    try:
        out = b"".join(result if parts is None else itertools.islice(result, parts))
    finally:
        if hasattr(result, "close"):
            result.close()
    return int(seen["status"].split()[0]), seen["headers"], out


def _apps(sampler, keras=None, frame_source=None):
    """The port's app and the JAX package's, each with ``keras`` as its
    injected FER (and a camera pipeline when there is a frame source)."""
    ours = tapp.AppState(sampler.cfg, sampler, frame_source=frame_source)
    theirs = japp.AppState(JaxGANConfig(**SMALL), sampler=None, frame_source=frame_source)
    if keras is not None:
        ours.camera = tx.FERClassifier(keras, device="cpu")
        theirs.camera = jx.FERClassifier(keras)
        if frame_source is not None:
            from melogan_tpu.camera import CameraEmotion as JaxCameraEmotion

            ours.camera_pipeline = CameraEmotion(fer=ours.camera)
            theirs.camera_pipeline = JaxCameraEmotion(fer=theirs.camera)
    return (ours, tapp.build_app(ours)), (theirs, japp.build_app(theirs))


def _both(apps, *args, **kw):
    (_, ours), (_, theirs) = apps
    a, b = call(ours, *args, **kw), call(theirs, *args, **kw)
    return a, b


def _mjpeg(raw):
    parts = []
    for chunk in raw.split(b"--frame")[1:]:
        head, _, payload = chunk.partition(b"\r\n\r\n")
        assert head.startswith(b"\r\nContent-Type: image/jpeg"), head
        parts.append(payload.rstrip(b"\r\n"))
    return parts


def test_camera_routes_without_a_fer_or_a_source(sampler):
    apps = _apps(sampler)
    for path, method, body in (("/camera_frame", "POST", b'{"frame": [[1, 2], [3, 4]]}'),
                               ("/video_feed", "GET", b""), ("/get_camera_emotion", "GET", b"")):
        (status, headers, out), (jstatus, jheaders, jout) = _both(apps, method, path, body)
        assert (status, out) == (jstatus, jout), path
        assert headers["Content-Type"] == jheaders["Content-Type"] == "application/json"
    assert call(apps[0][1], "POST", "/camera_frame", b"{}")[0] == 503
    assert call(apps[0][1], "GET", "/video_feed")[0] == 503
    assert json.loads(call(apps[0][1], "GET", "/get_camera_emotion")[2]) == {"emotion": "calm"}
    assert apps[0][0].camera is None and apps[0][0].camera_pipeline is None


@pytest.mark.parametrize("body", [b"{}", b'{"frame": "abc"}', b'{"frame": [[1, 2], [3]]}', b'{"frame": []}',
                                  b'{"frame": [1, 2, 3]}', b"not json", b'{"frame": [[[[1.0]]]]}'])
def test_camera_frame_bad_frames_400_as_jax(sampler, keras, body):
    (status, _, out), (jstatus, _, jout) = _both(_apps(sampler, keras), "POST", "/camera_frame", body)
    assert status == jstatus == 400, (out, jout)
    assert json.loads(out)["error"].startswith("bad frame:")


def test_camera_frame_too_large_413_as_jax(sampler, keras):
    (status, _, out), (jstatus, _, jout) = _both(_apps(sampler, keras), "POST", "/camera_frame", b"{}",
                                                 content_length=tapp.MAX_FRAME_BODY + 1)
    assert status == jstatus == 413 and out == jout
    assert tapp.MAX_FRAME_BODY == japp.MAX_FRAME_BODY


def test_camera_frame_gives_the_jax_servers_emotion(sampler, keras):
    """The web page's 96×96 grey frame, then frames of other sizes and
    ranges: each answer equals the JAX server's, and /get_camera_emotion
    repeats the last one."""
    apps = _apps(sampler, keras)
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 255, (96, 96)), rng.uniform(0, 255, (48, 80)), rng.uniform(0, 1, (64, 64)),
              np.tile(np.linspace(0, 255, 40), (30, 1))]
    for frame in frames:
        body = json.dumps({"frame": frame.tolist()}).encode()
        (status, _, out), (jstatus, _, jout) = _both(apps, "POST", "/camera_frame", body)
        assert status == jstatus == 200 and out == jout
        emotion = json.loads(out)["emotion"]
        assert emotion in EMOTIONS
        (_, _, got), (_, _, jgot) = _both(apps, "GET", "/get_camera_emotion")
        assert json.loads(got) == json.loads(jgot) == {"emotion": emotion}


def test_video_feed_streams_annotated_parts(sampler, keras):
    """Three synthetic frames through the injected FER: SOI…EOI parts equal
    to the JAX server's bytes, the green overlay in each, and the camera
    emotion updated."""
    pytest.importorskip("PIL.Image")
    from PIL import Image

    apps = _apps(sampler, keras, frame_source=SyntheticFrameSource(n_frames=3))
    (status, headers, raw), (jstatus, jheaders, jraw) = _both(apps, "GET", "/video_feed")
    assert status == jstatus == 200
    assert headers["Content-Type"] == jheaders["Content-Type"] == "multipart/x-mixed-replace; boundary=frame"
    parts = _mjpeg(raw)
    assert len(parts) == 3 and raw == jraw
    for p in parts:
        assert p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9"
        img = np.asarray(Image.open(io.BytesIO(p)).convert("RGB"))
        assert img.shape == (240, 320, 3)
        green = (img[..., 1] > 180) & (img[..., 0] < 120) & (img[..., 2] < 120)
        assert green.sum() > 50
    ours, theirs = apps[0][0], apps[1][0]
    assert ours.camera_emotion == theirs.camera_emotion and ours.camera_emotion in EMOTIONS
    assert ours.inflight() == 0


def test_video_feed_without_a_fer_streams_raw_frames(sampler):
    apps = _apps(sampler, frame_source=SyntheticFrameSource(n_frames=2))
    (status, _, raw), (_, _, jraw) = _both(apps, "GET", "/video_feed")
    assert status == 200 and raw == jraw and len(_mjpeg(raw)) == 2
    assert apps[0][0].camera_emotion == "calm"


def _clip(path, n=3):
    with open(path, "wb") as f:
        write_y4m(f, list(SyntheticFrameSource(n_frames=n)), colorspace="420")
    return str(path)


def test_video_feed_from_a_y4m_file(sampler, keras, tmp_path):
    clip = _clip(tmp_path / "cam.y4m")
    apps = _apps(sampler, keras, frame_source=Y4MFrameSource(clip, loop=False))
    (status, _, raw), (_, _, jraw) = _both(apps, "GET", "/video_feed")
    assert status == 200 and raw == jraw and len(_mjpeg(raw)) == 3
    assert apps[0][0].camera_emotion in EMOTIONS


def test_healthz_camera_fields_as_jax(sampler, keras):
    for fer, source in ((None, None), (keras, None), (keras, SyntheticFrameSource(n_frames=1))):
        (ours, app), (theirs, japp_) = _apps(sampler, fer, frame_source=source)
        got = json.loads(call(app, "GET", "/healthz")[2])
        want = json.loads(call(japp_, "GET", "/healthz")[2])
        for key in ("camera_backend", "video_feed"):
            assert got[key] == want[key], (key, got[key], want[key])
        assert got["camera_backend"] == ("xception" if fer is not None else None)
        assert got["video_feed"] is (source is not None)


def test_metrics_labels_as_jax(sampler, keras):
    """The camera routes are known routes, /video_feed's stream has no
    latency series, and the counters equal the JAX server's."""
    apps = _apps(sampler, keras, frame_source=SyntheticFrameSource(n_frames=1))
    requests = [("GET", "/get_camera_emotion", b""), ("GET", "/video_feed", b""),
                ("POST", "/camera_frame", b'{"frame": [[1, 2], [3, 4]]}'), ("POST", "/camera_frame", b"{}"),
                ("PUT", "/video_feed", b""), ("GET", "/camera_framez", b"")]
    for method, path, body in requests:
        _both(apps, method, path, body)

    def series(registry):
        return [line for line in registry.render().splitlines()
                if "process_uptime_seconds" not in line and "_bucket{" not in line and "_sum{" not in line]

    ours = series(apps[0][0].metrics)
    assert ours == series(apps[1][0].metrics)
    assert 'melogan_http_requests_total{method="GET",route="/video_feed",status="200"} 1' in ours
    assert 'melogan_http_requests_total{method="POST",route="/camera_frame",status="400"} 1' in ours
    assert 'melogan_http_requests_total{method="PUT",route="/video_feed",status="404"} 1' in ours
    assert 'melogan_http_requests_total{method="GET",route="other",status="404"} 1' in ours
    assert not any('route="/video_feed"' in line for line in ours if line.startswith(
        "melogan_http_request_duration_seconds"))


def _server(tmp_path, **kw):
    return tapp.create_server("127.0.0.1", 0, workdir=str(tmp_path), config=GANConfig(**SMALL), device="cpu",
                              sample_pool=False, **kw)


@pytest.mark.parametrize("via_env", [False, True])
def test_create_server_camera_sources(tmp_path, monkeypatch, keras, via_env):
    """``camera_source`` (or ``MELOGAN_CAMERA_SOURCE``): a looped y4m file
    streams past its end; "synthetic"; a file that is not y4m fails at
    startup."""
    clip = _clip(tmp_path / "cam.y4m", n=2)
    if via_env:
        monkeypatch.setenv("MELOGAN_CAMERA_SOURCE", clip)
    httpd, state = _server(tmp_path, camera_source=None if via_env else clip)
    try:
        assert isinstance(state.frame_source, Y4MFrameSource) and state.frame_source.loop
        state.camera = tx.FERClassifier(keras, device="cpu")
        state.camera_pipeline = CameraEmotion(fer=state.camera)
        status, _, raw = call(httpd.get_app(), "GET", "/video_feed", parts=5)
        assert status == 200 and len(_mjpeg(raw)) == 5  # 2 frames, looped
        health = json.loads(call(httpd.get_app(), "GET", "/healthz")[2])
        assert health["video_feed"] is True and health["camera_backend"] == "xception"
        assert state.camera_emotion in EMOTIONS
    finally:
        httpd.server_close()
        state.close()
    httpd, state = _server(tmp_path, camera_source="synthetic")
    try:
        assert isinstance(state.frame_source, SyntheticFrameSource) and state.camera is None
    finally:
        httpd.server_close()
        state.close()
    bad = tmp_path / "not.y4m"
    bad.write_bytes(b"GIF89a\n")
    with pytest.raises(ValueError, match="bad magic"):
        _server(tmp_path, camera_source=str(bad))


def test_create_server_loads_the_fer_file_and_raises_on_a_broken_one(tmp_path, monkeypatch, keras):
    """A weight file that loads serves ``/camera_frame`` with its FER; one
    that exists but fails to load stops ``create_server`` (the JAX server
    serves on without a FER)."""
    h5py = pytest.importorskip("h5py")
    good = tmp_path / "mini_xception.h5"
    with h5py.File(good, "w") as f:
        for key, value in keras.items():
            layer, leaf = key.split("/")
            f.require_group("model_weights").require_group(layer).require_group(layer).create_dataset(
                f"{leaf}:0", data=value)
    monkeypatch.setenv("MELOGAN_FER_H5", str(good))
    httpd, state = _server(tmp_path)
    try:
        assert state.camera is not None and state.camera.device.type == "cpu"
        frame = np.random.default_rng(2).uniform(0, 255, (96, 96))
        status, _, out = call(httpd.get_app(), "POST", "/camera_frame",
                              json.dumps({"frame": frame.tolist()}).encode())
        assert status == 200
        assert json.loads(out)["emotion"] == jx.XCEPTION_TO_MY_EMOTIONS[
            jx.MINI_XCEPTION_LABELS[int(jx.FERClassifier(keras).predict_proba(frame[None])[0].argmax())]]
    finally:
        httpd.server_close()
        state.close()
    bad = tmp_path / "broken.h5"
    bad.write_bytes(b"\x89HDF\r\n not really")
    monkeypatch.setenv("MELOGAN_FER_H5", str(bad))
    with pytest.raises(OSError):
        _server(tmp_path)
    monkeypatch.setattr(jx, "DEFAULT_H5_CANDIDATES", (str(bad),))
    assert japp.AppState(JaxGANConfig(**SMALL), sampler=None).camera is None  # JAX swallows it
