"""The port's WSGI app with a CPU sampler: /generate, /healthz and errors,
and ``create_server`` on a ``.ckpt`` with a config and EMA, and with the
shipped YAML configs."""
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from wsgiref.util import setup_testing_defaults

import numpy as np
import pytest
import torch

from melogan_torch import EMOTIONS
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data.datasets import SplitData
from melogan_torch.midi.midifile import read_midi
from melogan_torch.sampling import Sampler
from melogan_torch.serving.app import MAX_JSON_BODY, AppState, build_app, create_server
from melogan_torch.train import gan_loop, gan_step

SMALL = dict(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads, which made a 3 s test take
    minutes under pytest-xdist."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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
    assert payload["ema"] is False


def test_unknown_route_is_404(state):
    assert call(build_app(state), "GET", "/nope")[0] == 404
    assert call(build_app(state), "GET", "/generate")[0] == 404


def _serve(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, t):
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(base, emotion):
    req = urllib.request.Request(base + "/generate", data=json.dumps({"emotion": emotion}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _healthz(base):
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def test_create_server_answers_over_http(tmp_path):
    """The user entry point: build, warm up, bind, and answer real HTTP. No
    checkpoint in the workdir: seeded random weights, and /healthz says so."""
    httpd, state = create_server("127.0.0.1", 0, workdir=str(tmp_path), device="cpu")  # the shipped config
    t, base = _serve(httpd)
    try:
        status, body = _post(base, "calm")
        assert status == 200 and body[:4] == b"MThd"
        health = _healthz(base)
        assert health["device"]["platform"] == "cpu"
        assert health["generator"] == "random-weights" and health["ema"] is False
        assert health["checkpoint"] == str(tmp_path / GANConfig().checkpoint_dir / "gan_final.ckpt")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=b'{"emotion": "x"}'), timeout=60)
        assert e.value.code == 400
    finally:
        _stop(httpd, t)


@pytest.fixture(scope="module")
def trained_1024(tmp_path_factory):
    """A port ``train()`` at GANConfig(max_notes=1024, ema_decay=0.9) full
    width: 1 epoch of 2 group steps (batch 2, one critic update each) on a
    4-row corpus, with a small ED."""
    rng = np.random.default_rng(0)
    n, length = 4, 1024
    raw = np.stack([rng.uniform(20, 110, (n, length)), np.cumsum(rng.uniform(0, 1, (n, length)), 1),
                    rng.uniform(0, 3, (n, length)), rng.uniform(0, 127, (n, length))], -1).astype(np.float32)
    data = SplitData(raw, np.array(EMOTIONS), rng.normal(size=(n, 6)).astype(np.float32), [])
    cfg = GANConfig(max_notes=1024, ema_decay=0.9)
    workdir = tmp_path_factory.mktemp("trained_1024")
    state, _ = gan_loop.train(GANConfig(max_notes=1024, ema_decay=0.9, batch_size=2, critic_iters=1),
                              EDConfig(max_notes=1024, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,)),
                              data, workdir=str(workdir), epochs=1, verbose=False, device="cpu")
    return cfg, workdir, state


def test_create_server_serves_a_ckpt_with_config_and_ema(trained_1024):
    """A port-trained ``gan_final.ckpt`` of another max_notes, served with its
    config and EMA weights: /generate answers MIDI, /healthz reads "ema":
    true, and the sampler holds the file's debiased EMA generator."""
    cfg, workdir, state = trained_1024
    path = str(workdir / cfg.checkpoint_dir / "gan_final.ckpt")
    httpd, app_state = create_server("127.0.0.1", 0, config=GANConfig(max_notes=1024, ema_decay=0.9),
                                     checkpoint=path, use_ema=True, device="cpu")
    t, base = _serve(httpd)
    try:
        for emotion in EMOTIONS:
            status, body = _post(base, emotion)
            assert status == 200 and body[:4] == b"MThd"
            assert len(read_midi(body).instruments) == 1
        health = _healthz(base)
        assert health["ema"] is True and health["generator"] == "checkpoint"
        assert health["checkpoint"] == path
    finally:
        _stop(httpd, t)
    served = dict(app_state.sampler.generator.named_parameters())
    for name, v in gan_step.ema_weights(state, 0.9).items():
        assert torch.equal(served[name].detach(), v), name
    np.testing.assert_array_equal(app_state.sampler.emotion_features,
                                  gan_loop.load_gan_final_full(path)[2]["emotion_features"])


def test_create_server_default_checkpoint_and_config_path(trained_1024, tmp_path):
    """The default checkpoint is <workdir>/<cfg.checkpoint_dir>/gan_final.ckpt.
    ``config`` is a GANConfig or, as in the JAX server, a YAML path read with
    ``GANConfig.from_yaml``, and ``GANConfig()`` when the file does not
    exist: the shipped configs/gan.yaml and configs/gan_conditioning.yaml
    (the AE latent concatenated, zeros when serving) each answer
    ``POST /generate``."""
    cfg, workdir, _ = trained_1024
    httpd, app_state = create_server("127.0.0.1", 0, workdir=str(workdir), config=cfg, device="cpu")
    httpd.server_close()
    assert app_state.loaded and not app_state.use_ema
    assert app_state.ckpt_path == str(workdir / cfg.checkpoint_dir / "gan_final.ckpt")
    for path in ("configs/gan.yaml", "configs/gan_conditioning.yaml"):
        httpd, app_state = create_server("127.0.0.1", 0, workdir=str(tmp_path), config=path, device="cpu")
        t, base = _serve(httpd)
        try:
            status, body = _post(base, "angry")
            assert status == 200 and body[:4] == b"MThd"
            assert _healthz(base)["generator"] == "random-weights"
        finally:
            _stop(httpd, t)
        assert dataclasses.asdict(app_state.cfg) == dataclasses.asdict(GANConfig.from_yaml(path))
        assert app_state.sampler.generator.mode == app_state.cfg.integration_mode
        assert app_state.ckpt_path == str(tmp_path / app_state.cfg.checkpoint_dir / "gan_final.ckpt")
    assert app_state.cfg.integration_mode == "conditioning" and app_state.cfg.latent_dim == 8
    httpd, app_state = create_server("127.0.0.1", 0, workdir=str(tmp_path),
                                     config=str(tmp_path / "missing.yaml"), device="cpu")
    httpd.server_close()
    assert app_state.cfg == GANConfig()
