"""HTTP serving on the port: ``POST /generate`` and ``GET /healthz``.

A stdlib WSGI app, the port of the generation part of
``melogan_tpu/serving/app.py``:

- ``POST /generate``  {"emotion": ...} → audio/midi download; 400 for an
  unknown emotion, 413 for a body over ``MAX_JSON_BODY``
- ``GET  /healthz``   liveness, weight provenance and the device that serves

Generation math matches the reference serving path: per-emotion feature base
+ N(0, 0.15²) jitter, zeros latent, emotion→bpm/scale maps (app.py:53-65,
109-110), a fresh seed per request. As in the JAX ``serve``, the weights come
from ``<workdir>/<cfg.checkpoint_dir>/gan_final.ckpt`` unless a checkpoint
(``.ckpt`` or ``.pth``) is named, with random weights and a warning when the
file is absent, and ``use_ema`` serves the file's EMA generator. The config
is a YAML path (``configs/gan.yaml`` by default; ``GANConfig()`` when the
file does not exist) or a ``GANConfig``. Text and camera emotion,
``/video_feed``, ``/metrics``, ``/reload`` and the sample pool come with
later slices.

Run: ``python -m melogan_torch.serving.app [--port 5000] [--workdir .]
[--config configs/gan.yaml] [--checkpoint gan_final.ckpt] [--ema]
[--device cuda]``.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
from socketserver import ThreadingMixIn
from typing import Dict, Optional, Tuple, Union
from wsgiref.simple_server import WSGIServer, make_server

from melogan_torch.config import GANConfig
from melogan_torch.constants import EMOTION_BPM
from melogan_torch.device import device_info
from melogan_torch.midi.codec import render_to_bytes
from melogan_torch.sampling import Sampler, emotion_scale

# JSON request bodies are tiny ({"emotion": ...}); cap reads so an oversized
# body cannot balloon per-request memory
MAX_JSON_BODY = 1 << 20
# how much of an over-limit body is drained (in chunks) so the connection
# closes cleanly after a 413; beyond this the client is hostile
_DRAIN_CAP = 8 << 20


class AppState:
    """The sampler, the per-request seed counter and the in-flight count."""

    def __init__(self, cfg: GANConfig, sampler: Sampler, ckpt_path: Optional[str] = None,
                 loaded: bool = False, use_ema: bool = False):
        self.cfg = cfg
        self.sampler = sampler
        self.ckpt_path = ckpt_path  # the checkpoint path served from, if any
        self.loaded = loaded  # whether the sampler holds its weights
        self.use_ema = use_ema
        self.seed_counter = 0
        self._inflight = 0
        self._lock = threading.Lock()

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


def _json_response(start_response, payload, status="200 OK"):
    body = json.dumps(payload).encode()
    start_response(
        status,
        [("Content-Type", "application/json"), ("Content-Length", str(len(body)))],
    )
    return [body]


def _read_json(environ, limit: int = MAX_JSON_BODY) -> Optional[Dict]:
    """Parse the JSON request body; ``None`` means the declared body exceeds
    ``limit`` (answer 413). A negative, absent or unparsable Content-Length
    reads nothing; unparsable JSON reads as ``{}`` (the route's defaults)."""
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
        return {}
    try:
        payload = json.loads(raw or b"{}")
    except ValueError:
        return {}
    return payload if isinstance(payload, dict) else {}


def build_app(state: AppState):
    def app(environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")

        if method == "GET" and path == "/healthz":
            return _json_response(
                start_response,
                {
                    "status": "ok",
                    # weight provenance: random weights until a checkpoint is
                    # served — an operator must be able to see that
                    "generator": "checkpoint" if state.loaded else "random-weights",
                    "checkpoint": state.ckpt_path,
                    "ema": state.use_ema,
                    "device": device_info(state.sampler.device),
                },
            )

        if method == "POST" and path == "/generate":
            payload = _read_json(environ)
            if payload is None:
                return _json_response(
                    start_response, {"error": "request body too large"},
                    status="413 Content Too Large",
                )
            emotion = str(payload.get("emotion", "happy")).lower()
            if emotion not in EMOTION_BPM:
                return _json_response(
                    start_response,
                    {"error": f"unknown emotion {emotion!r}; valid: {sorted(EMOTION_BPM)}"},
                    status="400 Bad Request",
                )
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

        return _json_response(start_response, {"error": "not found"}, status="404 Not Found")

    def tracked(environ, start_response):
        # in-flight accounting around the handler; bodies are single byte
        # strings, written by the server right after the handler returns
        state.request_started()
        try:
            return app(environ, start_response)
        finally:
            state.request_finished()

    return tracked


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


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


def create_server(
    host: str = "0.0.0.0",
    port: int = 5000,
    workdir: str = ".",
    config: Union[str, GANConfig, None] = DEFAULT_CONFIG,
    checkpoint: Optional[str] = None,
    use_ema: bool = False,
    device="cuda",
) -> Tuple[WSGIServer, AppState]:
    """Build the sampler, warm it up, and bind a threaded WSGI server. The
    caller runs ``serve_forever`` and, at the end, ``shutdown`` and
    ``server_close``.

    ``config``: a YAML path (a missing file, or None, gives ``GANConfig()``)
    or a ``GANConfig``. ``checkpoint``:
    a ``gan_final`` (``.ckpt`` or ``.pth``); by default
    ``<workdir>/<cfg.checkpoint_dir>/gan_final.ckpt``. When the file is
    absent the weights are seeded random ones and a warning is printed.
    ``use_ema``: serve the file's EMA generator (``G_ema``)."""
    from melogan_torch.utils.weights import load_gan_final_full

    cfg = _resolve_config(config)
    gen_sd = fe_sd = features = None
    ckpt_path = checkpoint or os.path.join(workdir, cfg.checkpoint_dir, "gan_final.ckpt")
    loaded = os.path.exists(ckpt_path)
    if loaded:
        # the training corpus's emotion centroids come along where train() saved them
        gen_sd, fe_sd, extras = load_gan_final_full(ckpt_path, ema=use_ema)
        features = extras["emotion_features"]
        print(f"[INIT] loaded GAN checkpoint from {ckpt_path}"
              + (" (EMA weights)" if use_ema else "")
              + ("" if features is None else " (corpus-calibrated conditioning)"))
    else:
        print(f"[WARN] GAN checkpoint not found at {ckpt_path}; serving random weights")
    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                      emotion_features=features, device=device)
    # warm up before accepting traffic: the first call builds the kernels
    sampler.sample_notes(["happy"], seed=0)
    state = AppState(cfg, sampler, ckpt_path=ckpt_path, loaded=loaded, use_ema=use_ema)
    httpd = make_server(host, port, build_app(state), server_class=ThreadingWSGIServer)
    return httpd, state


def serve(host: str = "0.0.0.0", port: int = 5000, workdir: str = ".",
          config: Union[str, GANConfig, None] = DEFAULT_CONFIG, checkpoint: Optional[str] = None,
          use_ema: bool = False, device="cuda") -> None:
    """Serve ``/generate`` and ``/healthz`` until interrupted."""
    httpd, state = create_server(host, port, workdir=workdir, config=config,
                                 checkpoint=checkpoint, use_ema=use_ema, device=device)
    print(f"[INIT] serving on http://{host}:{httpd.server_address[1]} "
          f"({device_info(state.sampler.device)['kind']}, "
          f"{'checkpoint ' + state.ckpt_path if state.loaded else 'random weights'})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve(args.host, args.port, workdir=args.workdir, config=args.config, checkpoint=args.checkpoint,
          use_ema=args.ema, device=args.device)


if __name__ == "__main__":
    main()
