"""The readers of the program's spans on a hand-filled span table: the
number with one device event in the view, nothing without device events (a
CPU run), without the span, or where the program has no span table."""
import pytest

import conftest  # noqa: F401  (the repository on the path)

from benchmark import harness, trace
from melogan_torch.utils import profiling

TABLE = {
    "sampler.sample_notes": {"count": 4, "host_s": 0.020, "self_s": 0.001},
    "sampler.index": {"count": 4, "host_s": 0.0036, "self_s": 0.0036},
    "sampler.pin_alloc": {"count": 4, "host_s": 0.0012, "self_s": 0.0012},
    "sampler.forward": {"count": 4, "host_s": 0.0050, "self_s": 0.0010},
    "gan.group": {"count": 4, "host_s": 0.400, "self_s": 0.004},
    "gan.adam": {"count": 24, "host_s": 0.030, "self_s": 0.030},
    "ops.conv1d": {"count": 28, "host_s": 0.0014, "self_s": 0.0014},
    "ops.convt1d": {"count": 90, "host_s": 0.0045, "self_s": 0.0045},
    "ops.decoder_tail": {"count": 2, "host_s": 0.0001, "self_s": 0.0001},
}
# per unit (4 calls or 4 group steps); the ops' µs a call over all 120 calls
EXPECTED = {
    "sample.index_host_ms": 0.9,
    "sample.pin_alloc_ms": 0.3,
    "sample.forward_host_ms": 1.25,
    "train.step_host_ms": 100.0,
    "train.adam_host_ms": 7.5,
    "train.core_host_us": 50.0,
}


def _view(events, units=4):
    return trace.TraceView(events, 1.0, 0.5, units, 8192, {}, {}, None)


def _one_event():
    return [trace.DeviceEvent("k", "kernel", 0.0, 10.0, frozenset())]


def test_the_readers_are_the_manifests_new_program_span_metrics():
    names = {m["name"] for m in harness.load_manifest()["per_layer"] if m["source"] == "program_span"}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_divides_its_spans_host_time_by_the_units(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    read = harness.load_reader(name)
    assert read(_view(_one_event())) == pytest.approx(EXPECTED[name])
    assert read(_view([])) is None  # a CPU run: no device event, no metric
    assert read(_view(_one_event(), units=0)) is None
    monkeypatch.setattr(profiling, "span_table", lambda: {})
    assert read(_view(_one_event())) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_finds_nothing_where_the_program_has_no_span_table(name, monkeypatch):
    monkeypatch.delattr(profiling, "span_table")
    assert harness.load_reader(name)(_view(_one_event())) is None
