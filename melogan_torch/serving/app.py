"""HTTP serving on the port: ``melogan_tpu/serving/app.py`` on a stdlib
WSGI stack.

- ``GET  /``          the web UI (the JAX package's page, byte for byte)
- ``POST /get_text_emotion``  {"text": ...} → {"emotion": ...}, by the
  configured text backend (``models/text_emotion.py``), loaded at the first
  request on the server's device; 413 for a body over ``MAX_JSON_BODY``, 500
  when the backend fails to load or to run (no fallback to another backend)
- ``POST /camera_frame``  {"frame": [[gray, ...], ...]} → {"emotion": ...}
  by the mini-Xception FER on the server's device (``models/xception.py``);
  503 when no FER is loaded, 413 for a body over ``MAX_FRAME_BODY``, 400 for
  a frame it cannot classify
- ``GET  /get_camera_emotion``  the emotion of the latest camera frame, from
  ``/camera_frame`` or the video feed ("calm" before any)
- ``GET  /video_feed``  MJPEG (multipart/x-mixed-replace) of the configured
  frame source's frames, each run through the camera pipeline (face box,
  FER, overlay) when a FER is loaded, at most ``MELOGAN_VIDEO_MAX_FPS``
  (default 20) frames a second; 503 when no source is configured
- ``POST /generate``  {"emotion": ...} → audio/midi download; 400 for an
  unknown emotion, 413 for a body over ``MAX_JSON_BODY``, 503 when the
  sample pool cannot produce a sample in time
- ``GET  /healthz``   liveness, the text backend with its measured accuracy
  and note, the camera backend and whether a video feed is configured,
  weight provenance, the sample pool's stats and the device that serves
- ``GET  /metrics``   Prometheus text: requests by route, method and status,
  handler latency by route (the stream of ``/video_feed`` excluded), pool
  gauges, reloads
- ``POST /reload``    hot-swap a checkpoint into the running sampler (the
  startup path, or {"checkpoint": path}); the pool is flushed

Generation math matches the reference serving path: per-emotion feature base
+ N(0, 0.15²) jitter, zeros latent, emotion→bpm/scale maps (app.py:53-65,
109-110), a fresh seed per sample. With the sample pool on (the default),
``/generate`` pops a sample that a background producer generated in a large
batch; without it each request samples on its own. As in the JAX ``serve``,
the weights come from ``<workdir>/<cfg.checkpoint_dir>/gan_final.ckpt``
unless a checkpoint (``.ckpt`` or ``.pth``) is named, with random weights
and a warning when the file is absent, and ``use_ema`` serves the file's EMA
generator; ``watch_ckpt`` polls the file and hot-swaps it when it changes.
The config is a YAML path (``configs/gan.yaml`` by default; ``GANConfig()``
when the file does not exist) or a ``GANConfig``. The FER loads from the
first weight file of ``models/xception.py::h5_candidates`` on the server's
device; with no file the camera routes answer as the JAX server's do without
one, and a file that fails to load stops ``create_server`` (the JAX server
serves on without a FER). The frame source is None, ``"synthetic"`` (a
drifting face-like blob) or a ``.y4m`` file, looped (``camera_source`` or
``MELOGAN_CAMERA_SOURCE``). The JAX server's device-init watchdog is not
ported: it guards a TPU backend that can hang while it initializes, and
CUDA's initialization either returns or raises.

Run: ``python -m melogan_torch.serving.app [--port 5000] [--workdir .]
[--config configs/gan.yaml] [--checkpoint gan_final.ckpt] [--ema]
[--watch-ckpt SECONDS] [--camera-source synthetic|clip.y4m] [--device
cuda]``; ``MELOGAN_SAMPLE_POOL=0`` turns the pool off and
``MELOGAN_POOL_WARM=0`` its background warm-up, as for the JAX server.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
from socketserver import ThreadingMixIn
from typing import Dict, Optional, Tuple, Union
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np

from melogan_torch.camera import CameraEmotion
from melogan_torch.config import GANConfig
from melogan_torch.constants import EMOTION_BPM
from melogan_torch.device import device_info
from melogan_torch.midi.codec import render_to_bytes
from melogan_torch.models.text_emotion import backend_info, backend_name, predict_emotion
from melogan_torch.models.xception import load_default_fer
from melogan_torch.sampling import Sampler, emotion_scale
from melogan_torch.serving.metrics import Registry
from melogan_torch.serving.pool import PoolTimeout, SamplePool
from melogan_torch.serving.video import BOUNDARY, SyntheticFrameSource, mjpeg_parts

# JSON request bodies are tiny ({"emotion": ...} / {"text": ...}); cap reads so an oversized
# body cannot balloon per-request memory. /camera_frame carries a whole
# grayscale frame as JSON numbers (~8 bytes/pixel of text, ~2.5 MB for
# 640x480), so it passes its own frame-sized limit.
MAX_JSON_BODY = 1 << 20
MAX_FRAME_BODY = 64 << 20
# how much of an over-limit body is drained (in chunks) so the connection
# closes cleanly after a 413; beyond this the client is hostile
_DRAIN_CAP = 8 << 20
# how long serve() waits for in-flight responses after the accept loop stops
DRAIN_SECS = 10.0

class AppState:
    """The sampler, the optional sample pool, the checkpoint served, the
    metrics registry, the per-request seed counter, the in-flight count, and
    the camera: the FER (``camera``, loaded here on the sampler's device;
    None without a weights file), the MJPEG ``frame_source``, the
    ``camera_pipeline`` that annotates its frames (a ``CameraEmotion`` over
    the FER, when both exist) and the latest ``camera_emotion``."""

    def __init__(self, cfg: GANConfig, sampler: Sampler, pool: Optional[SamplePool] = None,
                 ckpt_path: Optional[str] = None, loaded_version: Optional[tuple] = None, use_ema: bool = False,
                 frame_source=None):
        self.cfg = cfg
        self.sampler = sampler
        self.pool = pool
        self.ckpt_path = ckpt_path  # the default target of POST /reload
        self.use_ema = use_ema  # serve G_ema from every checkpoint loaded
        self._reload_lock = threading.Lock()  # serializes checkpoint swaps
        # (path, mtime) of the checkpoint the sampler serves, None for seeded
        # weights: the watcher's skip baseline, kept current by both reload
        # paths. A caller that loaded the weights itself passes the version
        # it read just before the load
        self.loaded_version = loaded_version
        self.watcher: Optional[threading.Thread] = None
        self.metrics = Registry()
        if pool is not None:
            # polled at /metrics render time, not on the request path
            self.metrics.gauge_fn("melogan_pool_depth", lambda: pool.depth(),
                                  help="Pre-generated samples pooled per emotion")
            self.metrics.gauge_fn("melogan_pool_hits_total", lambda: pool.stats()["hits"],
                                  help="Pool takes served without waiting on a refill", typ="counter")
            self.metrics.gauge_fn("melogan_pool_misses_total", lambda: pool.stats()["misses"],
                                  help="Pool takes that found their emotion empty", typ="counter")
        self.seed_counter = 0
        self._inflight = 0  # requests whose body is not fully written yet
        self._lock = threading.Lock()
        self._camera_emotion = "calm"
        self.camera = load_default_fer(sampler.device)
        # MJPEG source: any (re-)iterable of (H, W, 3) uint8 RGB frames
        self.frame_source = frame_source
        self.camera_pipeline = (CameraEmotion(fer=self.camera)
                                if frame_source is not None and self.camera is not None else None)

    @property
    def camera_emotion(self) -> str:
        with self._lock:
            return self._camera_emotion

    @camera_emotion.setter
    def camera_emotion(self, value: str) -> None:
        with self._lock:
            self._camera_emotion = value

    @property
    def loaded(self) -> bool:
        """Whether the sampler serves a checkpoint's weights."""
        return self.loaded_version is not None

    def next_seed(self) -> int:
        with self._lock:
            self.seed_counter += 1
            return self.seed_counter

    def request_started(self) -> None:
        with self._lock:
            self._inflight += 1

    def request_finished(self) -> None:
        with self._lock:
            self._inflight -= 1

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def reload_checkpoint(self, path: str) -> int:
        """Hot-swap ``path`` into the running sampler; returns how many stale
        pooled samples were flushed. Shared by ``POST /reload`` and the
        checkpoint watcher. Raises on an unreadable or malformed file, and
        the current weights keep serving: the swap happens only after a
        successful load."""
        from melogan_torch.utils.weights import load_gan_final_full

        with self._reload_lock:
            # mtime read BEFORE the load: if the file is replaced again
            # mid-load, the recorded version is stale and the watcher's next
            # tick reloads it
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                mtime = None
            gen_sd, fe_sd, extras = load_gan_final_full(path, ema=self.use_ema)
            self.sampler.swap_variables(gen_sd, fe_sd, emotion_features=extras["emotion_features"])
            flushed = self.pool.flush() if self.pool is not None else 0
            self.ckpt_path = path
            # (path, None) never equals a real (path, mtime): after a raced
            # mtime read the watcher reads the file once more
            self.loaded_version = (path, mtime)
        self.metrics.counter_inc("melogan_reloads_total", help="Successful checkpoint hot-swaps")
        return flushed

    def close(self) -> None:
        """Stop the checkpoint watcher's, the sample pool's and the FER's
        threads."""
        if self.watcher is not None:
            self.watcher.stop.set()
            self.watcher.join(timeout=10)
        if self.pool is not None:
            self.pool.close()
        if self.camera is not None:
            self.camera.close()


_KNOWN_METHODS = {"GET", "POST", "HEAD", "PUT", "DELETE", "OPTIONS", "PATCH"}
_ROUTES = {"/", "/healthz", "/get_text_emotion", "/get_camera_emotion", "/video_feed", "/camera_frame",
           "/generate", "/metrics", "/reload"}


def _method_label(method: str) -> str:
    """The metrics label of a request method: the known HTTP verbs pass
    through, anything else (a client-controlled token) is "other"."""
    return method if method in _KNOWN_METHODS else "other"


def _json_response(start_response, payload, status="200 OK"):
    body = json.dumps(payload).encode()
    start_response(
        status,
        [("Content-Type", "application/json"), ("Content-Length", str(len(body)))],
    )
    return [body]


def _read_json(environ, limit: int = MAX_JSON_BODY, strict: bool = False) -> Optional[Dict]:
    """Parse the JSON request body; ``None`` means the declared body exceeds
    ``limit`` (answer 413). A negative, absent or unparsable Content-Length
    reads nothing. Unparsable JSON, or a body that is not an object, reads
    as ``{}`` (the route's defaults) unless ``strict``, which raises
    ValueError: a mutating route must answer 400 rather than act on
    defaults."""
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except (TypeError, ValueError):
        length = 0
    if length > limit:
        remaining = min(length, _DRAIN_CAP)
        try:
            while remaining > 0:
                chunk = environ["wsgi.input"].read(min(remaining, 1 << 16))
                if not chunk:
                    break
                remaining -= len(chunk)
        except OSError:
            pass  # the client went away; the 413 is all it gets
        return None
    try:
        raw = environ["wsgi.input"].read(length) if length > 0 else b"{}"
    except OSError:
        if strict:
            raise ValueError("request body could not be read")
        return {}
    try:
        payload = json.loads(raw or b"{}")
    except ValueError:
        if strict:
            raise ValueError("request body is not valid JSON")
        return {}
    if not isinstance(payload, dict):
        if strict:
            raise ValueError("request body is not a JSON object")
        return {}
    return payload


INDEX_HTML = """<!DOCTYPE html>
<html><head><title>Melo-GAN TPU</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 760px; margin: 2rem auto; }
 button { margin: .3rem; padding: .5rem 1rem; }
 #log { color: #555; white-space: pre-wrap; }
</style></head>
<body>
<h1>Melo-GAN TPU</h1>
<p>Emotion-conditioned MIDI generation. Type how you feel, or pick an emotion.</p>
<textarea id="text" rows="3" cols="60" placeholder="How are you feeling?"></textarea><br>
<button onclick="detect()">Detect emotion from text</button>
<span id="emotion">calm</span><br>
<button onclick="gen('happy')">happy</button>
<button onclick="gen('sad')">sad</button>
<button onclick="gen('angry')">angry</button>
<button onclick="gen('calm')">calm</button>
<button onclick="gen(document.getElementById('emotion').textContent)">generate (detected)</button>
<h3>Camera</h3>
<video id="cam" width="320" height="240" autoplay muted playsinline style="background:#000"></video>
<img id="feed" width="320" height="240" style="display:none;background:#000" alt="server stream"><br>
<button onclick="startCam()">start camera</button>
<button onclick="captureEmotion()">detect emotion from camera</button>
<button onclick="toggleFeed()">server stream (/video_feed)</button>
<span id="camEmotion">-</span>
<div id="log"></div>
<script>
let camStream = null;
async function startCam() {
  try {
    camStream = await navigator.mediaDevices.getUserMedia({video: true});
    document.getElementById('cam').srcObject = camStream;
  } catch (e) {
    document.getElementById('log').textContent = 'camera unavailable: ' + e;
  }
}
function toggleFeed() {
  const img = document.getElementById('feed');
  if (img.style.display === 'none') {
    img.src = '/video_feed';  // MJPEG multipart stream (reference app.py:82-85)
    img.style.display = 'inline';
  } else {
    img.removeAttribute('src');
    img.style.display = 'none';
  }
}
async function captureEmotion() {
  const video = document.getElementById('cam');
  const canvas = document.createElement('canvas');
  canvas.width = 96; canvas.height = 96;
  const ctx = canvas.getContext('2d');
  ctx.drawImage(video, 0, 0, 96, 96);
  const data = ctx.getImageData(0, 0, 96, 96).data;
  const gray = [];
  for (let y = 0; y < 96; y++) {
    const row = [];
    for (let x = 0; x < 96; x++) {
      const i = (y * 96 + x) * 4;
      row.push(0.299 * data[i] + 0.587 * data[i+1] + 0.114 * data[i+2]);
    }
    gray.push(row);
  }
  const r = await fetch('/camera_frame', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({frame: gray})});
  const j = await r.json();
  document.getElementById('camEmotion').textContent = j.emotion || j.error;
  if (j.emotion) document.getElementById('emotion').textContent = j.emotion;
}
</script>
<script>
async function detect() {
  const r = await fetch('/get_text_emotion', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({text: document.getElementById('text').value})});
  const j = await r.json();
  document.getElementById('emotion').textContent = j.emotion;
}
async function gen(emotion) {
  document.getElementById('log').textContent = 'generating ' + emotion + '...';
  const r = await fetch('/generate', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({emotion})});
  const blob = await r.blob();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = 'melo_' + emotion + '.mid';
  a.click();
  document.getElementById('log').textContent = 'downloaded melo_' + emotion + '.mid';
}
</script>
</body></html>
"""


def _too_large(start_response):
    return _json_response(start_response, {"error": "request body too large"},
                          status="413 Content Too Large")


def build_app(state: AppState):
    def app(environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")

        if method == "GET" and path == "/":
            body = INDEX_HTML.encode()
            start_response("200 OK", [("Content-Type", "text/html"), ("Content-Length", str(len(body)))])
            return [body]

        if method == "GET" and path == "/healthz":
            text = backend_info()
            return _json_response(
                start_response,
                {
                    "status": "ok",
                    "text_backend": text["backend"],
                    "text_backend_accuracy": text.get("measured_eval_accuracy"),
                    "text_backend_note": text["note"],
                    "camera_backend": "xception" if state.camera else None,
                    "video_feed": state.frame_source is not None,
                    # weight provenance: random weights until a checkpoint is
                    # served (at startup, by /reload or by the watcher)
                    "generator": "checkpoint" if state.loaded else "random-weights",
                    "checkpoint": state.ckpt_path,
                    "ema": state.use_ema,
                    "sample_pool": state.pool.stats() if state.pool else None,
                    "device": device_info(state.sampler.device),
                },
            )

        if method == "POST" and path == "/get_text_emotion":
            payload = _read_json(environ)
            if payload is None:
                return _too_large(start_response)
            try:
                emotion = predict_emotion(payload.get("text", ""), device=state.sampler.device)
            except Exception as e:  # noqa: BLE001 — a failing backend is a 500, never another answer
                traceback.print_exc()
                return _json_response(start_response,
                                      {"error": f"text backend failed: {type(e).__name__}: {e}"},
                                      status="500 Internal Server Error")
            return _json_response(start_response, {"emotion": emotion})

        if method == "GET" and path == "/get_camera_emotion":
            return _json_response(start_response, {"emotion": state.camera_emotion})

        if method == "GET" and path == "/video_feed":
            if state.frame_source is None:
                return _json_response(
                    start_response,
                    {"error": "no camera frame source configured; "
                              "POST grayscale frames to /camera_frame instead"},
                    status="503 Service Unavailable")
            start_response("200 OK", [("Content-Type", f"multipart/x-mixed-replace; boundary={BOUNDARY}")])

            def _set_emotion(e):
                state.camera_emotion = e

            # cap the stream rate: with an infinite frame source each client
            # otherwise busy-loops detect+annotate+encode on a full host core
            return mjpeg_parts(iter(state.frame_source), state.camera_pipeline, on_emotion=_set_emotion,
                               max_fps=float(os.environ.get("MELOGAN_VIDEO_MAX_FPS", "20")))

        if method == "POST" and path == "/camera_frame":
            if state.camera is None:
                return _json_response(start_response, {"error": "camera emotion model not loaded"},
                                      status="503 Service Unavailable")
            payload = _read_json(environ, limit=MAX_FRAME_BODY)
            if payload is None:
                return _too_large(start_response)
            try:
                frame = np.asarray(payload["frame"], dtype=np.float32)
                emotion = state.camera.predict_emotion(frame)
            except Exception as e:  # noqa: BLE001 — a frame it cannot classify is the client's 400
                return _json_response(start_response, {"error": f"bad frame: {e}"}, status="400 Bad Request")
            state.camera_emotion = emotion
            return _json_response(start_response, {"emotion": emotion})

        if method == "POST" and path == "/generate":
            payload = _read_json(environ)
            if payload is None:
                return _too_large(start_response)
            emotion = str(payload.get("emotion", "happy")).lower()
            if emotion not in EMOTION_BPM:
                return _json_response(
                    start_response,
                    {"error": f"unknown emotion {emotion!r}; valid: {sorted(EMOTION_BPM)}"},
                    status="400 Bad Request",
                )
            if state.pool is not None:
                try:
                    notes = state.pool.take(emotion)
                except PoolTimeout as e:
                    # a persistently failing sampler is a 503 with the
                    # producer's last error, not a hang
                    return _json_response(start_response,
                                          {"error": str(e), "last_refill_error": e.last_error},
                                          status="503 Service Unavailable")
            else:
                notes = state.sampler.sample_notes([emotion], seed=state.next_seed())[0]
            body = render_to_bytes(notes, bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
            start_response(
                "200 OK",
                [
                    ("Content-Type", "audio/midi"),
                    ("Content-Disposition", f'attachment; filename="melo_{emotion}.mid"'),
                    ("Content-Length", str(len(body))),
                ],
            )
            return [body]

        if method == "GET" and path == "/metrics":
            body = state.metrics.render().encode()
            start_response("200 OK", [("Content-Type", "text/plain; version=0.0.4; charset=utf-8"),
                                      ("Content-Length", str(len(body)))])
            return [body]

        if method == "POST" and path == "/reload":
            # an internal operations route, unauthenticated as the whole
            # server is: bind it accordingly
            try:
                payload = _read_json(environ, strict=True)
            except ValueError as e:
                return _json_response(start_response, {"error": str(e)}, status="400 Bad Request")
            if payload is None:
                return _too_large(start_response)
            target = payload.get("checkpoint") or state.ckpt_path
            if not target or not os.path.exists(target):
                return _json_response(start_response, {"error": f"checkpoint not found: {target!r}"},
                                      status="404 Not Found")
            try:
                flushed = state.reload_checkpoint(target)
            except Exception as e:  # noqa: BLE001 — a bad file must not stop serving
                return _json_response(start_response,
                                      {"error": f"reload failed: {type(e).__name__}: {e}"},
                                      status="400 Bad Request")
            return _json_response(start_response, {"status": "ok", "checkpoint": target,
                                                   "flushed_pool_samples": flushed})

        return _json_response(start_response, {"error": "not found"}, status="404 Not Found")

    class _TrackedBody:
        """The response iterable, with the in-flight count held until the
        server has written the body and closed it."""

        def __init__(self, body):
            self._body = body
            self._done = False

        def __iter__(self):
            return iter(self._body)

        def close(self):
            if not self._done:
                self._done = True
                state.request_finished()
            closer = getattr(self._body, "close", None)
            if closer is not None:
                closer()

    def instrumented(environ, start_response):
        # counters and latency per known route; unknown paths and methods
        # collapse into "other" (client-controlled strings must not mint
        # unbounded label values)
        path = environ.get("PATH_INFO", "/")
        route = path if path in _ROUTES else "other"
        status_box = {"code": "500"}

        def recording_start_response(status, headers, exc_info=None):
            status_box["code"] = status.split(" ", 1)[0]
            return start_response(status, headers, exc_info)

        state.request_started()
        t0 = time.perf_counter()
        try:
            result = app(environ, recording_start_response)
        except BaseException:
            state.request_finished()
            raise
        finally:
            state.metrics.counter_inc(
                "melogan_http_requests_total", help="HTTP requests by route/method/status",
                route=route, method=_method_label(environ.get("REQUEST_METHOD", "-")),
                status=status_box["code"])
        if route != "/video_feed":  # the handler only sets the stream up
            state.metrics.observe("melogan_http_request_duration_seconds", time.perf_counter() - t0,
                                  help="Handler latency (body build included; streams excluded)",
                                  route=route)
        return _TrackedBody(result)

    return instrumented


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # serve() bounds the drain itself (AppState.inflight): server_close must
    # not block joining request threads
    block_on_close = False


def watch_checkpoint(state: AppState, interval_secs: float) -> threading.Thread:
    """Poll the served checkpoint's mtime every ``interval_secs`` and
    hot-swap it when it changes (a training job rewrites ``gan_final.ckpt``
    atomically, so a partial file is never visible under its name). A load
    failure keeps the current weights serving and records that (path,
    mtime) as failed: the next try comes when the file changes again. The
    skip baseline is ``state.loaded_version``, which ``POST /reload`` keeps
    current too. The returned thread carries a ``stop`` Event: set it to
    end the watch."""
    stop = threading.Event()

    def _watch():
        last_failed = None  # (path, mtime) of a version that failed to load
        while not stop.wait(interval_secs):
            path = state.ckpt_path
            if not path:
                continue
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue  # vanished mid-replace; retry next tick
            version = (path, mtime)
            if version == state.loaded_version or version == last_failed:
                continue
            try:
                flushed = state.reload_checkpoint(path)
                print(f"[RELOAD] checkpoint changed on disk: hot-swapped {path} "
                      f"(flushed {flushed} pooled samples)")
            except Exception as e:  # noqa: BLE001 — keep serving the old weights
                last_failed = version
                print(f"[WARN] checkpoint watch: reload of {path} failed "
                      f"({type(e).__name__}: {e}); keeping current weights "
                      f"until the file changes again")

    t = threading.Thread(target=_watch, name="ckpt-watch", daemon=True)
    t.stop = stop  # type: ignore[attr-defined]
    t.start()
    return t


DEFAULT_CONFIG = "configs/gan.yaml"


def _resolve_config(config) -> GANConfig:
    """A ``GANConfig`` as it is; a YAML path through ``GANConfig.from_yaml``
    when the file exists, else ``GANConfig()`` (the JAX ``serve``'s rule);
    None as ``GANConfig()``."""
    if isinstance(config, GANConfig):
        return config
    if config is not None and os.path.exists(config):
        return GANConfig.from_yaml(config)
    return GANConfig()


def camera_frame_source(source: Optional[str]):
    """The frames of ``/video_feed``: None, the synthetic webcam for
    ``"synthetic"``, else a looped ``.y4m`` file, whose header is read here
    so a bad path fails at startup, not at the first viewer."""
    if not source:
        return None
    if source == "synthetic":
        return SyntheticFrameSource()
    from melogan_torch.imaging.y4m import Y4MFrameSource

    frames = Y4MFrameSource(source, loop=True)
    print(f"[INIT] camera source: {source} ({frames.width}x{frames.height} y4m, looped)")
    return frames


def create_server(
    host: str = "0.0.0.0",
    port: int = 5000,
    workdir: str = ".",
    config: Union[str, GANConfig, None] = DEFAULT_CONFIG,
    checkpoint: Optional[str] = None,
    use_ema: bool = False,
    device="cuda",
    sample_pool: bool = True,
    pool_warm: bool = True,
    watch_ckpt: float = 0.0,
    fast_math: bool = False,
    camera_source: Optional[str] = None,
) -> Tuple[WSGIServer, AppState]:
    """Build the sampler, warm it up, fill the sample pool, and bind a
    threaded WSGI server. The caller runs ``serve_forever`` and, at the
    end, ``shutdown``, ``server_close`` and ``AppState.close``.

    ``config``: a YAML path (a missing file, or None, gives ``GANConfig()``)
    or a ``GANConfig``. ``checkpoint``: a ``gan_final`` (``.ckpt`` or
    ``.pth``); by default ``<workdir>/<cfg.checkpoint_dir>/gan_final.ckpt``.
    When the file is absent the weights are seeded random ones and a warning
    is printed; the path stays the target of ``/reload`` and of the watcher,
    which load it once it appears. ``use_ema``: serve the file's EMA
    generator (``G_ema``). ``sample_pool``: serve ``/generate`` from a
    ``SamplePool`` (prefilled here) and, with ``pool_warm``, run its refill
    ladder once in the background. ``watch_ckpt``: the watcher's poll
    interval in seconds (0: off). ``fast_math``: the sampler's one-pass bf16
    products (``Sampler(fast_math=True)``), kept across ``/reload`` and the
    watcher's swaps. ``camera_source`` (else ``MELOGAN_CAMERA_SOURCE``):
    ``/video_feed``'s frames, None (the route answers 503), ``"synthetic"``
    or the path of a ``.y4m`` file, looped. The FER loads on ``device`` from
    the first weight file that exists (``AppState``); a file that fails to
    load raises here."""
    from melogan_torch.utils.weights import load_gan_final_full

    backend_name()  # a misconfigured text backend fails here, not at a request
    frame_source = camera_frame_source(camera_source or os.environ.get("MELOGAN_CAMERA_SOURCE"))
    cfg = _resolve_config(config)
    gen_sd = fe_sd = features = None
    loaded_version = None
    ckpt_path = checkpoint or os.path.join(workdir, cfg.checkpoint_dir, "gan_final.ckpt")
    if os.path.exists(ckpt_path):
        # the version read just before the load: a file rewritten during the
        # warm-up below must look new to the watcher
        try:
            loaded_version = (ckpt_path, os.path.getmtime(ckpt_path))
        except OSError:
            pass
        # the training corpus's emotion centroids come along where train() saved them
        gen_sd, fe_sd, extras = load_gan_final_full(ckpt_path, ema=use_ema)
        features = extras["emotion_features"]
        print(f"[INIT] loaded GAN checkpoint from {ckpt_path}"
              + (" (EMA weights)" if use_ema else "")
              + ("" if features is None else " (corpus-calibrated conditioning)"))
    else:
        print(f"[WARN] GAN checkpoint not found at {ckpt_path}; serving random weights"
              + (" until it appears" if watch_ckpt > 0 else ""))
    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd, fast_math=fast_math,
                      emotion_features=features, device=device)
    # warm up before accepting traffic: the first call builds the kernels
    sampler.sample_notes(["happy"], seed=0)
    pool = None
    if sample_pool:
        pool = SamplePool(sampler)
        try:
            pool.prefill(timeout=120.0)
        except BaseException:
            pool.close()
            raise
        if pool_warm:
            pool.warm_async()
    try:
        state = AppState(cfg, sampler, pool=pool, ckpt_path=ckpt_path, loaded_version=loaded_version,
                         use_ema=use_ema, frame_source=frame_source)
    except BaseException:
        if pool is not None:
            pool.close()
        raise
    if watch_ckpt > 0:
        state.watcher = watch_checkpoint(state, watch_ckpt)
    try:
        httpd = make_server(host, port, build_app(state), server_class=ThreadingWSGIServer)
    except BaseException:
        state.close()
        raise
    return httpd, state


def serve(host: str = "0.0.0.0", port: int = 5000, workdir: str = ".",
          config: Union[str, GANConfig, None] = DEFAULT_CONFIG, checkpoint: Optional[str] = None,
          use_ema: bool = False, device="cuda", watch_ckpt: float = 0.0, dp: int = 0,
          fast_math: bool = False, camera_source: Optional[str] = None) -> None:
    """Serve until interrupted, then wait up to ``DRAIN_SECS`` for the
    responses in flight. The sample pool is on unless
    ``MELOGAN_SAMPLE_POOL=0``, and warms its refill ladder unless
    ``MELOGAN_POOL_WARM=0``, as for the JAX server. ``fast_math``: sample
    with the one-pass bf16 products (``create_server``). ``camera_source``:
    ``/video_feed``'s frames (``create_server``). ``dp``
    (data-parallel sampling) is not ported yet and raises unless 0."""
    if dp:
        raise NotImplementedError("data-parallel sampling over a mesh is not ported yet")
    httpd, state = create_server(
        host, port, workdir=workdir, config=config, checkpoint=checkpoint, use_ema=use_ema,
        device=device, sample_pool=os.environ.get("MELOGAN_SAMPLE_POOL", "1") != "0",
        pool_warm=os.environ.get("MELOGAN_POOL_WARM", "1") != "0", watch_ckpt=watch_ckpt,
        fast_math=fast_math, camera_source=camera_source)
    print(f"[INIT] serving on http://{host}:{httpd.server_address[1]} "
          f"({device_info(state.sampler.device)['kind']}, text backend {backend_name()}, "
          f"{'checkpoint ' + state.ckpt_path if state.loaded else 'random weights'}"
          f"{', sample pool ' + str(state.pool.depth()) if state.pool else ''})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        deadline = time.monotonic() + DRAIN_SECS
        while state.inflight() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        state.close()
        httpd.server_close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="melogan_torch generation server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--workdir", default=".",
                    help="the default checkpoint is <workdir>/experiments/gan/checkpoints/gan_final.ckpt")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="a GAN YAML config (GANConfig() when the file does not exist)")
    ap.add_argument("--checkpoint", default=None, help="a gan_final .ckpt or .pth")
    ap.add_argument("--ema", action="store_true", help="serve the checkpoint's EMA generator (G_ema)")
    ap.add_argument("--watch-ckpt", type=float, default=0.0, metavar="SECONDS",
                    help="poll the checkpoint and hot-swap it when it changes (0: off)")
    ap.add_argument("--camera-source", default=None, metavar="synthetic|PATH.y4m",
                    help="the frames of /video_feed (default $MELOGAN_CAMERA_SOURCE; none: 503)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve(args.host, args.port, workdir=args.workdir, config=args.config, checkpoint=args.checkpoint,
          use_ema=args.ema, device=args.device, watch_ckpt=args.watch_ckpt, camera_source=args.camera_source)


if __name__ == "__main__":
    main()
