"""The yardstick's copied counts equal the program's own at the published
configurations, and its work and peak arithmetic."""
import pytest

import conftest  # noqa: F401  (the repository on the path)

from benchmark import harness, yardstick
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.utils import flops


@pytest.fixture(scope="module")
def published():
    gan, ed = GANConfig.from_yaml(str(harness.ROOT / "configs/gan.yaml")), EDConfig.from_yaml(
        str(harness.ROOT / "configs/ed.yaml"))
    manifest = harness.load_manifest()
    entry = {c["name"]: c for c in manifest["configs"]}["melogan-gan"]
    return gan, ed, harness.load_config(entry)


@pytest.mark.parametrize("name", [c["name"] for c in harness.load_manifest()["configs"]])
def test_the_configuration_file_holds_the_published_numbers(published, name):
    """Every number as published but the keys the manifest lists in
    ``reduced``, and those differ."""
    gan, ed, _ = published
    entry = {c["name"]: c for c in harness.load_manifest()["configs"]}[name]
    cfg = harness.load_config(entry)
    changed = {k for k, v in cfg["gan"].items() if getattr(gan, k.lower()) != (tuple(v) if isinstance(v, list) else v)}
    changed |= {k for k, v in cfg["ed"].items() if getattr(ed, k) != (tuple(v) if isinstance(v, list) else v)}
    assert changed == set(entry["reduced"]) == set(cfg["reduced"])


def test_the_sample_mix_is_the_pools_refill_under_sustained_load():
    """The calls of ``sample-pool-b2048`` are the ones a server's sample pool
    makes once its refill has grown to its largest: the same rows, the
    emotions in the same turn, one seed after another; every run seed gives
    the same calls with other seeds."""
    from melogan_torch import EMOTIONS
    from melogan_torch.serving.pool import SamplePool

    from benchmark import traffic

    made = []

    class Recorder:
        def sample_notes(self, prompts, seed=0):
            made.append((list(prompts), seed))
            return [None] * len(prompts)

    pool = SamplePool(Recorder(), background=False)
    for _ in range(2):
        pool._drained = pool.max_refill  # a drain that asks for the largest refill
        pool._refill(list(EMOTIONS))
        for q in pool._pools.values():
            q.clear()
    mix = traffic.load("sample-pool-b2048")
    a, b = traffic.SampleCalls(mix, 2**31 + 3), traffic.SampleCalls(mix, 7)
    assert a.rows == len(made[0][0]) == pool.max_refill
    for i in range(2):
        assert a.emotions(i) == b.emotions(i) == made[i][0]
        assert [EMOTIONS[j] for j in a.idx(i)] == made[i][0]
    assert a.seed(1) - a.seed(0) == made[1][1] - made[0][1] == 1
    assert a.seed(0) != b.seed(0)


@pytest.mark.parametrize("batch", [32, 256])
def test_copied_counts_equal_the_programs(published, batch):
    import dataclasses

    gan, ed, cfg = published
    g = dataclasses.replace(gan, batch_size=batch)
    assert yardstick.sampling_flops_per_sample(cfg["gan"]) == flops.sampling_flops_per_sample(gan) == 49_384_448
    assert yardstick.feature_encoder_flops(cfg["gan"]) == flops.feature_encoder_flops(gan)
    assert yardstick.generator_flops(cfg["gan"]) == flops.generator_flops(gan)
    assert yardstick.critic_flops(cfg["gan"]) == flops.critic_flops(gan)
    assert yardstick.ed_flops(cfg["ed"]) == flops.ed_flops(ed)
    assert yardstick.group_step_flops(cfg["gan"], cfg["ed"], batch) == flops.group_step_flops(g, ed)


def test_group_step_flops_at_the_published_and_the_cell_batch(published):
    _, _, cfg = published
    assert round(yardstick.group_step_flops(cfg["gan"], cfg["ed"], 32) / 1e9, 2) == 98.69
    assert round(yardstick.group_step_flops(cfg["gan"], cfg["ed"], 256) / 1e9, 2) == 789.52


def test_decoder_tail_work_is_the_generators_transposed_convs(published):
    _, _, cfg = published
    f, b = yardstick.decoder_tail_work(cfg["gan"], 4096)
    assert f == 4096 * 2 * (64 * 256 * 128 + 128 * 128 * 64 + 256 * 64 * 4) * 5
    assert round(f / 1e9, 2) == 131.53
    # the pre-net's output in, the notes out, float32
    assert b > 4 * 4096 * (64 * 256 + 512 * 4)
    peaks = yardstick.device_peaks("NVIDIA H100 80GB HBM3")
    assert abs(yardstick.least_seconds(f, b, peaks, "f32") - f / 495e12) < 1e-12  # ops-bound


def test_train_conv_calls_are_the_cores_calls_of_a_group_step(published):
    _, _, cfg = published
    calls = yardstick.train_conv_calls(cfg["gan"], cfg["ed"], 256)
    kinds = [k for k, _, _ in calls]
    # 6 forwards of 3 transposed convs and 4 ED input gradients run the convt kernel (22),
    # 3 transposed-conv input gradients and 4 ED forwards the conv1d kernel (7)
    assert kinds.count("convt_forward") + kinds.count("ed_conv_input_grad") == 22
    assert kinds.count("convt_input_grad") + kinds.count("ed_conv_forward") == 7


def test_peaks_by_device_name():
    assert yardstick.device_peaks("NVIDIA H100 80GB HBM3")["tflops"] == {"f32": 495.0, "bf16": 989.4}
    assert yardstick.device_peaks("cpu") is None
