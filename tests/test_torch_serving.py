"""The port's WSGI app with a CPU sampler: /generate, /healthz and errors."""
import io
import json
import threading
import urllib.error
import urllib.request
from wsgiref.util import setup_testing_defaults

import pytest

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.midi.midifile import read_midi
from melogan_torch.sampling import Sampler
from melogan_torch.serving.app import MAX_JSON_BODY, AppState, build_app, create_server

SMALL = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)


@pytest.fixture(scope="module")
def state():
    cfg = GANConfig(**SMALL)
    return AppState(cfg, Sampler(cfg, seed=0, device="cpu"))


def call(app, method, path, body=b"", content_length=None):
    environ = {}
    setup_testing_defaults(environ)
    environ.update(
        REQUEST_METHOD=method,
        PATH_INFO=path,
        CONTENT_LENGTH=str(len(body) if content_length is None else content_length),
        CONTENT_TYPE="application/json",
    )
    environ["wsgi.input"] = io.BytesIO(body)
    seen = {}

    def start_response(status, headers, exc_info=None):
        seen["status"], seen["headers"] = status, dict(headers)

    out = b"".join(app(environ, start_response))
    return int(seen["status"].split()[0]), seen["headers"], out


@pytest.mark.parametrize("emotion", EMOTIONS)
def test_generate_returns_midi(state, emotion):
    status, headers, body = call(build_app(state), "POST", "/generate",
                                 json.dumps({"emotion": emotion.upper()}).encode())
    assert status == 200
    assert headers["Content-Type"] == "audio/midi"
    assert headers["Content-Disposition"] == f'attachment; filename="melo_{emotion}.mid"'
    assert int(headers["Content-Length"]) == len(body)
    assert body[:4] == b"MThd"
    assert len(read_midi(body).instruments) == 1


def test_generate_uses_fresh_seed_per_request(state):
    app = build_app(state)
    bodies = [call(app, "POST", "/generate", b'{"emotion": "sad"}')[2] for _ in range(3)]
    seed = state.seed_counter
    assert call(app, "POST", "/generate", b'{"emotion": "sad"}')[0] == 200
    assert state.seed_counter == seed + 1
    assert state.inflight() == 0
    assert all(b[:4] == b"MThd" for b in bodies)


def test_generate_unknown_emotion_is_400(state):
    status, _, body = call(build_app(state), "POST", "/generate", b'{"emotion": "elated"}')
    assert status == 400
    assert "unknown emotion" in json.loads(body)["error"]


def test_oversized_body_is_413(state):
    big = b" " * (MAX_JSON_BODY + 10)
    status, _, body = call(build_app(state), "POST", "/generate", big)
    assert status == 413
    assert json.loads(body)["error"] == "request body too large"


def test_malformed_or_empty_body_uses_default_emotion(state):
    app = build_app(state)
    for body in (b"{not json", b"", b"[1, 2]"):
        status, headers, out = call(app, "POST", "/generate", body)
        assert status == 200 and out[:4] == b"MThd"
        assert "melo_happy.mid" in headers["Content-Disposition"]


def test_healthz_reports_cpu_device(state):
    status, _, body = call(build_app(state), "GET", "/healthz")
    payload = json.loads(body)
    assert status == 200 and payload["status"] == "ok"
    assert payload["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert payload["generator"] == "random-weights" and payload["checkpoint"] is None


def test_unknown_route_is_404(state):
    assert call(build_app(state), "GET", "/nope")[0] == 404
    assert call(build_app(state), "GET", "/generate")[0] == 404


def test_create_server_answers_over_http():
    """The user entry point: build, warm up, bind, and answer real HTTP."""
    httpd, state = create_server("127.0.0.1", 0, device="cpu")  # the shipped config
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(base + "/generate", data=b'{"emotion": "calm"}',
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200 and resp.read()[:4] == b"MThd"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["device"]["platform"] == "cpu"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=b'{"emotion": "x"}'), timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
