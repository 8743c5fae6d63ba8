"""The tiny sizes at which a cell runs on the CPU in the tests (widths the
model fixes stay as published; only the sizes the configuration names are
cut), and a copy of the manifest and the benchmark's files cut to them."""
import json
import shutil
from pathlib import Path

from benchmark import harness

TINY = {
    "gan": {"MAX_NOTES": 16, "NOISE_DIM": 8, "GEN_HIDDEN": 16, "ENCODER_HIDDEN": [8, 8],
            "ENCODER_OUT_DIM": 8, "LATENT_DIM": 8, "BATCH_SIZE": 4},
    "ed": {"max_notes": 16, "notes_hidden": 16, "mlp_hidden": [8, 8]},
}
TINY_TRAFFIC = {
    "sample": {"rows_per_call": 8, "warmup_calls": 1, "traced_calls": 3, "checked_calls": 2},
    "train": {"corpus_rows": 60, "traced_groups": 2},
}
# Limits for the tiny CPU sizes, read from clean tiny runs: a tiny model's
# first Adam steps swing the later losses, the generator's gradient and the
# changes by more than the published sizes do on the card (PERF.md gives
# those limits).
TINY_TRAIN_LIMITS = {"loss_gap": 1e-3, "critic_grad_gap": 1e-2, "critic_grad_median_gap": 1e-6,
                     "gen_grad_gap": 0.1, "change_gap": 0.3}


def tiny_config(config: dict) -> dict:
    """``config`` cut to the tiny sizes, with the tiny training limits."""
    config["gan"].update(TINY["gan"])
    config["ed"].update(TINY["ed"])
    if "train" in config["limits"]:
        config["limits"]["train"] = dict(TINY_TRAIN_LIMITS)
    return config


def tiny_manifest(directory: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's files under
    ``directory``, every configuration and traffic mix cut to its tiny size;
    returns the copy's manifest path for ``harness.run``."""
    shutil.copytree(harness.BENCH, directory / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.MANIFEST, directory / "BENCHMARK.json")
    for path in (directory / "benchmark" / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (directory / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        path.write_text(json.dumps(t))
    return directory / "BENCHMARK.json"
