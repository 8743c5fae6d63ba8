"""The port's WSGI app with a CPU sampler: /generate, /healthz and errors,
``create_server`` on a ``.ckpt`` with a config and EMA and with the shipped
YAML configs, the sample pool behind /generate, /, /metrics against the JAX
server's, /reload and the checkpoint watcher.

Every server a test starts is shut down, and its pool and watcher closed,
in a ``finally`` block; every wait on a thread is bounded."""
import dataclasses
import io
import os
import json
import threading
import time
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
from melogan_torch.serving.app import MAX_JSON_BODY, AppState, build_app, create_server, serve
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

    result = app(environ, start_response)
    try:
        out = b"".join(result)
    finally:  # as a WSGI server does once the body is written
        if hasattr(result, "close"):
            result.close()
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
    httpd, state = create_server("127.0.0.1", 0, workdir=str(tmp_path), device="cpu",
                                 sample_pool=False)  # the shipped config
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
                                     checkpoint=path, use_ema=True, device="cpu", sample_pool=False)
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
    httpd, app_state = create_server("127.0.0.1", 0, workdir=str(workdir), config=cfg, device="cpu",
                                     sample_pool=False)
    httpd.server_close()
    assert app_state.loaded and not app_state.use_ema
    assert app_state.ckpt_path == str(workdir / cfg.checkpoint_dir / "gan_final.ckpt")
    for path in ("configs/gan.yaml", "configs/gan_conditioning.yaml"):
        httpd, app_state = create_server("127.0.0.1", 0, workdir=str(tmp_path), config=path, device="cpu",
                                         sample_pool=False)
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
                                     config=str(tmp_path / "missing.yaml"), device="cpu", sample_pool=False)
    httpd.server_close()
    assert app_state.cfg == GANConfig()


# ---------------------------------------------------------------------------
# The web UI, /metrics, the sample pool, /reload and the watcher
# ---------------------------------------------------------------------------


def test_index_page_is_the_jax_page(state):
    from melogan_tpu.serving.app import INDEX_HTML as JAX_INDEX

    status, headers, body = call(build_app(state), "GET", "/")
    assert status == 200 and headers["Content-Type"] == "text/html"
    assert body == JAX_INDEX.encode() and int(headers["Content-Length"]) == len(body)


def test_metrics_match_the_jax_server_for_the_same_requests(state):
    """The same requests to the port's app and to the JAX package's: the
    request counters by route, method and status and the histograms'
    series and counts are equal (the latencies themselves differ), with
    unknown paths and methods collapsed into "other"."""
    from melogan_tpu.config import GANConfig as JaxGANConfig
    from melogan_tpu.serving import app as japp

    requests = [("GET", "/", b""), ("GET", "/nope", b""), ("BREW", "/", b""),
                ("POST", "/generate", b'{"emotion": "elated"}'), ("POST", "/generate", b" " * (MAX_JSON_BODY + 1)),
                ("POST", "/reload", b"{not json"), ("POST", "/reload", b'{"checkpoint": "/nonexistent.ckpt"}'),
                ("GET", "/metrics", b"")]

    def scrape(app, registry):
        for method, path, body in requests:
            call(app, method, path, body)
        keep = []
        for line in registry.render().splitlines():
            if "process_uptime_seconds" in line or "_bucket{" in line or "_sum{" in line:
                continue
            keep.append(line)
        return keep

    ours_state = AppState(state.cfg, state.sampler)
    theirs_state = japp.AppState(JaxGANConfig(**SMALL), sampler=None)
    ours = scrape(build_app(ours_state), ours_state.metrics)
    theirs = scrape(japp.build_app(theirs_state), theirs_state.metrics)
    assert ours == theirs
    assert 'melogan_http_requests_total{method="other",route="/",status="404"} 1' in ours
    assert 'melogan_http_requests_total{method="GET",route="other",status="404"} 1' in ours
    assert 'melogan_http_requests_total{method="POST",route="/reload",status="400"} 1' in ours
    status, headers, body = call(build_app(ours_state), "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    assert ours_state.inflight() == 0


def _write_final(path, sampler, bn_shift=0.0):
    """A ``gan_final.ckpt`` of ``sampler``'s weights, the decoder's
    BatchNorm running means shifted by ``bn_shift``."""
    from melogan_torch.utils.weights import write_gan_final

    gen = {k: v.clone() for k, v in sampler.generator.state_dict().items()}
    for k in gen:
        if k.endswith("running_mean"):
            gen[k] += bn_shift
    write_gan_final(str(path), {"G": gen, "E_num": sampler.feature_encoder.state_dict(),
                                "emotion_features": None})
    return str(path)


@pytest.fixture(scope="module")
def two_checkpoints(tmp_path_factory):
    """Two ``gan_final.ckpt`` files at the small config that differ only in
    the decoder's BatchNorm running means, and fresh samplers on each."""
    from melogan_torch.utils.weights import load_gan_final_full

    d = tmp_path_factory.mktemp("ckpts")
    base = Sampler(GANConfig(**SMALL), seed=3, device="cpu")
    paths = [_write_final(d / "a.ckpt", base), _write_final(d / "b.ckpt", base, bn_shift=0.5)]
    samplers = []
    for p in paths:
        gen, fe, extras = load_gan_final_full(p)
        samplers.append(Sampler(GANConfig(**SMALL), gen_variables=gen, fe_variables=fe, device="cpu"))
    assert samplers[0].generator.decoder.fuses()  # eval mode takes the folded-BN stages
    return paths, samplers


def _served_notes(sampler, seed=11):
    return sampler.sample_notes(list(EMOTIONS), seed=seed)


def test_pooled_generate_serves_valid_unique_midi(two_checkpoints):
    """``create_server`` fills a sample pool; ``POST /generate`` pops
    samples from it (pool hits), each once, and /healthz and /metrics
    report it."""
    paths, _ = two_checkpoints
    httpd, app_state = create_server("127.0.0.1", 0, config=GANConfig(**SMALL), checkpoint=paths[0],
                                     device="cpu", pool_warm=False)
    t, base = _serve(httpd)
    try:
        assert app_state.pool is not None
        for e in ("happy", "happy", "sad", "happy"):
            status, body = _post(base, e)
            assert status == 200 and len(read_midi(body).instruments) == 1
        # each sample is served once (a random generator's pieces can encode
        # to the same bytes, so the notes are compared)
        a, b = app_state.pool.take("calm"), app_state.pool.take("calm")
        assert a.shape == (64, 4) and not np.array_equal(a, b)
        health = _healthz(base)
        assert health["sample_pool"]["hits"] == 6 and health["generator"] == "checkpoint"
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            text = resp.read().decode()
        assert "melogan_pool_hits_total 6" in text and 'melogan_pool_depth{key="happy"}' in text
    finally:
        _stop(httpd, t)
        app_state.close()
    assert not app_state.pool._thread.is_alive()


def test_generate_answers_503_when_the_pool_times_out(state):
    """A pool whose sampler keeps failing: ``/generate`` answers 503 with
    the refill's last error instead of hanging."""
    from melogan_torch.serving.pool import SamplePool

    class Failing:
        def sample_notes(self, prompts, seed=0):
            raise RuntimeError("device lost")

    pool = SamplePool(Failing(), target=1, refill_batch=1, background=False, take_timeout=0.2)
    app_state = AppState(state.cfg, state.sampler, pool=pool)
    status, _, body = call(build_app(app_state), "POST", "/generate", b'{"emotion": "calm"}')
    assert status == 503 and json.loads(body)["last_refill_error"] == "RuntimeError: device lost"


def test_reload_swaps_the_weights_and_flushes_the_pool(two_checkpoints, tmp_path):
    """``POST /reload``: 200 with the number of pooled samples flushed, the
    sampler then serves the new file's weights (its notes equal a fresh
    ``Sampler`` on that file bit for bit: the folded-BN stages of the old
    weights are not reused); 400 on a body that is not JSON and on a
    malformed file, which leave the new weights serving; 404 for a missing
    path; 413 for an oversized body; the reload is counted in /metrics."""
    (a, b), (fresh_a, fresh_b) = two_checkpoints
    from melogan_torch.serving.pool import SamplePool

    httpd, app_state = create_server("127.0.0.1", 0, config=GANConfig(**SMALL), checkpoint=a, device="cpu",
                                     sample_pool=False)
    httpd.server_close()
    app_state.pool = SamplePool(app_state.sampler, target=2, refill_batch=4, background=False)
    app_state.pool.prefill(timeout=10)
    app = build_app(app_state)
    try:
        np.testing.assert_array_equal(_served_notes(app_state.sampler), _served_notes(fresh_a))
        depth = sum(app_state.pool.depth().values())
        status, _, body = call(app, "POST", "/reload", json.dumps({"checkpoint": b}).encode())
        assert status == 200
        assert json.loads(body) == {"status": "ok", "checkpoint": b, "flushed_pool_samples": depth}
        assert app_state.ckpt_path == b and app_state.loaded_version[0] == b
        assert sum(app_state.pool.depth().values()) == 0
        served = _served_notes(app_state.sampler)
        np.testing.assert_array_equal(served, _served_notes(fresh_b))
        assert not np.array_equal(served, _served_notes(fresh_a))

        bad = tmp_path / "bad.ckpt"
        bad.write_bytes(b"\x81\xa1Gnot a checkpoint")
        for body_ in (b"{not json", b"[1]", json.dumps({"checkpoint": str(bad)}).encode()):
            status, _, out = call(app, "POST", "/reload", body_)
            assert status == 400, out
        np.testing.assert_array_equal(_served_notes(app_state.sampler), _served_notes(fresh_b))
        assert app_state.ckpt_path == b
        status, _, out = call(app, "POST", "/reload", b'{"checkpoint": "/nonexistent/gan_final.ckpt"}')
        assert status == 404 and "checkpoint not found" in json.loads(out)["error"]
        status, _, _ = call(app, "POST", "/reload", b" " * (MAX_JSON_BODY + 1))
        assert status == 413
        status, _, out = call(app, "POST", "/reload")  # no body: the path served
        assert status == 200 and json.loads(out)["checkpoint"] == b
        text = call(app, "GET", "/metrics")[2].decode()
        assert "melogan_reloads_total 2" in text
        assert 'melogan_http_requests_total{method="POST",route="/reload",status="400"} 3' in text
        status, _, out = call(app, "POST", "/generate", b'{"emotion": "sad"}')
        assert status == 200 and out[:4] == b"MThd"
    finally:
        app_state.close()


def test_watch_checkpoint_picks_up_a_replaced_file(two_checkpoints, tmp_path):
    """``create_server(watch_ckpt=...)`` polls the served file: when it is
    replaced (a new mtime), the watcher hot-swaps it and flushes the pool;
    ``close`` stops the watcher."""
    (a, b), (_, fresh_b) = two_checkpoints
    served = tmp_path / "gan_final.ckpt"
    served.write_bytes(open(a, "rb").read())
    httpd, app_state = create_server("127.0.0.1", 0, config=GANConfig(**SMALL), checkpoint=str(served),
                                     device="cpu", pool_warm=False, watch_ckpt=0.02)
    httpd.server_close()
    try:
        first = app_state.loaded_version
        assert first == (str(served), os.path.getmtime(served))
        tmp = tmp_path / "incoming.ckpt"
        tmp.write_bytes(open(b, "rb").read())
        os.utime(tmp, (first[1] + 10, first[1] + 10))
        os.replace(tmp, served)  # an atomic replace, as a training job writes it
        deadline = time.monotonic() + 10
        while app_state.loaded_version == first and time.monotonic() < deadline:
            time.sleep(0.01)
        assert app_state.loaded_version == (str(served), first[1] + 10)
        np.testing.assert_array_equal(_served_notes(app_state.sampler), _served_notes(fresh_b))
        assert "melogan_reloads_total 1" in app_state.metrics.render()
    finally:
        app_state.close()
    assert not app_state.watcher.is_alive() and not app_state.pool._thread.is_alive()


def test_unported_server_options_raise(tmp_path):
    with pytest.raises(NotImplementedError):
        serve("127.0.0.1", 0, workdir=str(tmp_path), config=GANConfig(**SMALL), device="cpu", dp=2)


# ---------------------------------------------------------------------------
# POST /get_text_emotion and the text fields of /healthz
# ---------------------------------------------------------------------------

TEXTS = ["i am so happy today", "this is infuriating", "i miss her so much, i keep crying",
         "i'm terrified of what comes next", "the meeting starts at nine", "", "   ",
         "thanks, that was a wonderful surprise", "ugh, so annoying", "i regret everything"]


@pytest.fixture
def lexicon_backend(monkeypatch):
    from melogan_torch.models import text_emotion as tte
    from melogan_tpu.models import text_emotion as jte

    monkeypatch.delenv("MELOGAN_TEXT_MODEL_DIR", raising=False)
    monkeypatch.setenv("MELOGAN_TEXT_BACKEND", "lexicon")
    tte.reset_backend()
    jte.reset_backend()
    yield monkeypatch
    tte.reset_backend()
    jte.reset_backend()


def test_text_emotion_matches_the_jax_server(state, lexicon_backend):
    """The same bodies to the port's app and to the JAX package's, the
    lexicon forced on both: the same statuses and answers, malformed JSON
    and a non-object body included; 413 for an oversized body on both."""
    from melogan_tpu.config import GANConfig as JaxGANConfig
    from melogan_tpu.serving import app as japp

    ours = build_app(AppState(state.cfg, state.sampler))
    theirs = japp.build_app(japp.AppState(JaxGANConfig(**SMALL), sampler=None))
    bodies = [json.dumps({"text": t}).encode() for t in TEXTS] + [
        b"{not json", b"", b"{}", json.dumps({"text": 12}).encode()]
    for body in bodies:
        a, b = call(ours, "POST", "/get_text_emotion", body), call(theirs, "POST", "/get_text_emotion", body)
        assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), body
        assert a[0] == 200
    big = b" " * (MAX_JSON_BODY + 10)
    a, b = call(ours, "POST", "/get_text_emotion", big), call(theirs, "POST", "/get_text_emotion", big)
    assert a[0] == b[0] == 413 and json.loads(a[2]) == json.loads(b[2])


def test_healthz_carries_the_text_backend(state, lexicon_backend):
    from melogan_torch.models.text_emotion import MEASURED_EVAL_ACCURACY

    status, _, body = call(build_app(state), "GET", "/healthz")
    payload = json.loads(body)
    assert status == 200 and payload["text_backend"] == "lexicon"
    assert payload["text_backend_accuracy"] == MEASURED_EVAL_ACCURACY["lexicon"]
    assert "lexicon" in payload["text_backend_note"]
    lexicon_backend.setenv("MELOGAN_TEXT_BACKEND", "text-mlp")
    payload = json.loads(call(build_app(state), "GET", "/healthz")[2])
    assert payload["text_backend"] == "text-mlp"
    assert payload["text_backend_accuracy"] == MEASURED_EVAL_ACCURACY["text-mlp"]


def test_broken_text_model_dir_answers_500_not_the_lexicon(state, lexicon_backend, tmp_path):
    """No fallback: a checkpoint directory that cannot be loaded makes the
    route answer 500 with the error, where the JAX chain would have served
    another backend's answer."""
    lexicon_backend.delenv("MELOGAN_TEXT_BACKEND")
    lexicon_backend.setenv("MELOGAN_TEXT_MODEL_DIR", str(tmp_path))
    app = build_app(AppState(state.cfg, state.sampler))
    status, _, body = call(app, "POST", "/get_text_emotion", json.dumps({"text": "i am so happy"}).encode())
    assert status == 500 and "FileNotFoundError" in json.loads(body)["error"]
    assert json.loads(call(app, "GET", "/healthz")[2])["text_backend"] == "torch-roberta"
    # empty text never reaches the backend, as in JAX
    status, _, body = call(app, "POST", "/get_text_emotion", json.dumps({"text": ""}).encode())
    assert status == 200 and json.loads(body) == {"emotion": "calm"}
    lexicon_backend.setenv("MELOGAN_TEXT_BACKEND", "no-such-backend")
    with pytest.raises(ValueError, match="MELOGAN_TEXT_BACKEND"):
        create_server("127.0.0.1", 0, workdir=str(tmp_path), device="cpu", sample_pool=False)
