"""The port's kill/resume fault injection (``melogan_torch/fault_inject.py``),
on the CPU.

- ``artifact_digests`` covers every ``.mid`` and every leaf of
  ``gan_final.ckpt``, and a byte changed in one leaf changes that leaf's
  digest alone; ``stage_running`` reads the stage markers.
- ``slow``: one trial of ``fault_inject.main`` on the CPU, as
  ``tests/test_fault_inject.py`` runs the JAX script's: the kill lands
  before the pipeline completes, and after ``pipeline --resume`` every
  artifact equals the uninterrupted run's.

The file imports no JAX.
"""
import json
import os

import numpy as np
import pytest

from melogan_torch import fault_inject as fi
from melogan_torch.utils.checkpoint import save_checkpoint


def _tiny_workdir(root, leaf_w):
    gen = os.path.join(root, "generated_tests")
    os.makedirs(gen)
    for name, body in (("test_happy_1.mid", b"MThd-a"), ("test_sad_1.mid", b"MThd-b")):
        with open(os.path.join(gen, name), "wb") as f:
            f.write(body)
    save_checkpoint(os.path.join(root, "experiments/gan/checkpoints/gan_final.ckpt"),
                    {"G": {"w": leaf_w, "b": np.zeros(3, np.float32)},
                     "E_num": {"w": np.ones((2, 2), np.float32)}, "epoch": 6})


def test_artifact_digests_cover_every_leaf(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    _tiny_workdir(str(tmp_path / "a"), w)
    a = fi.artifact_digests(str(tmp_path / "a"))
    assert set(a) == {os.path.join("generated_tests", "test_happy_1.mid"),
                      os.path.join("generated_tests", "test_sad_1.mid"),
                      "gan_final['E_num']['w']", "gan_final['G']['b']", "gan_final['G']['w']",
                      "gan_final['epoch']"}
    changed = w.copy()
    changed.reshape(-1).view(np.uint8)[5] ^= 1  # one byte of one leaf
    _tiny_workdir(str(tmp_path / "b"), changed)
    b = fi.artifact_digests(str(tmp_path / "b"))
    assert [k for k in a if a[k] != b[k]] == ["gan_final['G']['w']"]


def test_stage_running(tmp_path):
    wd = str(tmp_path / "w")
    assert fi.stage_running(wd) == "start-up"
    done = os.path.join(wd, ".pipeline_done")
    os.makedirs(done)
    assert fi.stage_running(wd) == "synth-data"
    for stage in fi.STAGES[:6]:
        with open(os.path.join(done, f"{stage}.json"), "w") as f:
            json.dump({"stage": stage}, f)
    assert fi.stage_running(wd) == "train-ed"
    for stage in fi.STAGES[6:]:
        with open(os.path.join(done, f"{stage}.json"), "w") as f:
            json.dump({"stage": stage}, f)
    assert fi.stage_running(wd) == "done"


@pytest.mark.slow
def test_randomized_kill_resume_artifacts_identical(tmp_path):
    reports = fi.main(str(tmp_path), trials=1, seed=3, device="cpu")
    assert len(reports) == 1 and all(r["ok"] for r in reports)
    # the trial must have killed a running pipeline
    assert not reports[0]["completed_before_kill"], reports
    assert set(reports[0]) == {"trial", "kill_after_s", "killed_on_tmp_file", "completed_before_kill", "ok"}
