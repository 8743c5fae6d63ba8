"""Randomized kill/resume fault injection over the whole pipeline.

The port's counterpart of ``scripts/fault_inject.py``. The property under
test: for any SIGKILL instant during ``python -m melogan_torch pipeline``,
running it again with ``--resume`` completes and leaves final artifacts
(every generated ``.mid`` byte for byte, every ``gan_final.ckpt`` array)
identical to those of a run that was never interrupted: the atomic writes,
the stage markers and the bit-identical resume of each trainer compose
into one end-to-end guarantee.

Method:

1. run the pipeline uninterrupted in a reference workdir; record its wall
   and its artifacts' digests;
2. for each trial: a fresh workdir, and SIGKILL to the pipeline's process
   group at a delay drawn uniformly from (0.05, wall); if a temporary file
   of an atomic write (``*.tmp``) is seen from that instant on (for at most
   a quarter of the delay more), the kill lands at once instead;
3. ``pipeline --resume``, then compare the artifacts with the reference.

Each pipeline is a child in a session of its own, so the kill reaches
everything it started (an ``nvcc`` building a kernel included). The
children run on ``--device`` (the card unless ``cpu``). Usage::

    python -m melogan_torch.fault_inject WORKROOT [--trials N] [--seed S] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 1800  # seconds for one uninterrupted or resumed pipeline

TINY_AE = ("latent_dim: 4\nhidden_dim: 32\nbatch_size: 8\nepochs: 8\n"
           "recon_save_count: 0\n")
TINY_ED = ("input_mode: notes\nnotes_hidden: 32\nmlp_hidden: [32, 16]\n"
           "batch_size: 8\nlatent_dim: 4\nnum_epochs: 6\n")
TINY_GAN = ("NOISE_DIM: 16\nLATENT_DIM: 4\nGEN_HIDDEN: 32\nBATCH_SIZE: 4\n"
            "CRITIC_ITERS: 2\nSAVE_FREQ: 2\nEPOCHS: 6\n")

# the pipeline's stages in order (cli.cmd_pipeline), each leaving
# <workdir>/.pipeline_done/<stage>.json when it completes
STAGES = ("synth-data", "preprocess", "make-splits", "split-arrays", "train-ae", "encode",
          "train-ed", "train-gan", "sample")


def _write_configs(root: str) -> dict:
    paths = {}
    for name, body in (("ae", TINY_AE), ("ed", TINY_ED), ("gan", TINY_GAN)):
        p = os.path.join(root, f"{name}.yaml")
        with open(p, "w") as f:
            f.write(body)
        paths[name] = p
    return paths


def _pipeline_args(workdir: str, cfgs: dict, resume: bool = False):
    a = ["pipeline", "--workdir", workdir, "--synthetic", "--per-emotion", "8",
         "--skip-quality-gate",
         "--ae-config", cfgs["ae"], "--ed-config", cfgs["ed"],
         "--gan-config", cfgs["gan"]]
    return a + (["--resume"] if resume else [])


def _start(device: str, workdir: str, cfgs: dict, resume: bool = False, **kw) -> subprocess.Popen:
    """``python -m melogan_torch --device <device> pipeline ...`` from the
    repository's root, as the leader of a new session."""
    return subprocess.Popen(
        [sys.executable, "-m", "melogan_torch", "--device", device, *_pipeline_args(workdir, cfgs, resume)],
        cwd=REPO, start_new_session=True, **kw)


def _kill(proc: subprocess.Popen) -> None:
    """SIGKILL to the child's whole process group, then reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:  # the group has already gone
        pass
    proc.wait(timeout=30)


def _run_to_end(device: str, workdir: str, cfgs: dict, resume: bool = False) -> None:
    """One pipeline run to its end; raises with its output if it fails or
    outlasts ``RUN_TIMEOUT`` (its process group is killed then)."""
    proc = _start(device, workdir, cfgs, resume, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=RUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            _kill(proc)
    if proc.returncode != 0:
        raise RuntimeError(f"pipeline{' --resume' if resume else ''} in {workdir} exited "
                           f"{proc.returncode}:\n{out[-4000:]}")


def _leaves(tree, prefix: str = ""):
    """(path, array) for every leaf of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, np.asarray(tree)


def artifact_digests(workdir: str) -> dict:
    """sha256 of every final artifact the pipeline promises: each
    ``generated_tests/*.mid`` and each leaf of ``gan_final.ckpt``."""
    from melogan_torch.utils.checkpoint import load_checkpoint

    out = {}
    for p in sorted(glob.glob(os.path.join(workdir, "generated_tests", "*.mid"))):
        with open(p, "rb") as f:
            out[os.path.relpath(p, workdir)] = hashlib.sha256(f.read()).hexdigest()
    ckpt = os.path.join(workdir, "experiments/gan/checkpoints/gan_final.ckpt")
    if os.path.exists(ckpt):
        for path, leaf in _leaves(load_checkpoint(ckpt)):
            out[f"gan_final{path}"] = hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest()
    return out


def stage_running(workdir: str) -> str:
    """The stage a pipeline in ``workdir`` is in: the first without its
    completion marker ("start-up" before the workdir exists, "done" after
    the last)."""
    if not os.path.exists(workdir):
        return "start-up"
    done = os.path.join(workdir, ".pipeline_done")
    return next((s for s in STAGES if not os.path.exists(os.path.join(done, f"{s}.json"))), "done")


def run_straight(workroot: str, cfgs: dict, device: str = "cuda"):
    """The uninterrupted reference run: (workdir, wall seconds, digests)."""
    wd = os.path.join(workroot, "straight")
    t0 = time.monotonic()
    _run_to_end(device, wd, cfgs)
    wall = time.monotonic() - t0
    digests = artifact_digests(wd)
    if not any(k.endswith(".mid") for k in digests):
        raise RuntimeError("the reference run produced no samples")
    return wd, wall, digests


def run_trial(i: int, workroot: str, cfgs: dict, kill_after: float, reference: dict,
              device: str = "cuda") -> dict:
    """One kill/resume trial: a report dict, or AssertionError when the
    resumed artifacts differ from ``reference``."""
    wd = os.path.join(workroot, f"trial{i:02d}")
    proc = _start(device, wd, cfgs, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    killed_on_tmp = False
    t0 = time.monotonic()
    try:
        # phase 1: let the pipeline run until the drawn instant
        while time.monotonic() - t0 < kill_after and proc.poll() is None:
            time.sleep(0.01)
        # phase 2: from then on, die the moment an atomic write is in flight
        # (its *.tmp visible), the most adversarial place to be killed;
        # bounded to a quarter of the instant more, so that pure-time kills
        # still happen
        deadline = time.monotonic() + max(0.2, 0.25 * kill_after)
        while time.monotonic() < deadline and proc.poll() is None:
            if glob.glob(os.path.join(wd, "**", "*.tmp"), recursive=True):
                killed_on_tmp = True
                break
            time.sleep(0.005)
        completed_before_kill = proc.poll() is not None
        stage = stage_running(wd)
        if not completed_before_kill:
            _kill(proc)
    finally:
        if proc.poll() is None:
            _kill(proc)
    print(f"[fault] trial {i}: killed in {stage}" if not completed_before_kill
          else f"[fault] trial {i}: the pipeline completed before the kill", flush=True)

    _run_to_end(device, wd, cfgs, resume=True)
    got = artifact_digests(wd)
    if got != reference:
        missing = set(reference) - set(got)
        extra = set(got) - set(reference)
        diff = [k for k in set(got) & set(reference) if got[k] != reference[k]]
        raise AssertionError(
            f"trial {i} (kill at {kill_after:.2f}s in {stage}, on_tmp={killed_on_tmp}): "
            f"artifacts differ from the uninterrupted run — "
            f"missing={sorted(missing)} extra={sorted(extra)} diff={sorted(diff)}")
    return {"trial": i, "kill_after_s": round(kill_after, 2),
            "killed_on_tmp_file": killed_on_tmp,
            "completed_before_kill": completed_before_kill, "ok": True}


def main(workroot: str, trials: int = 5, seed: int = 0, device: str = "cuda") -> list:
    """The reference run, then ``trials`` kill/resume trials with kill
    instants drawn from ``seed``; the trials' reports."""
    os.makedirs(workroot, exist_ok=True)
    cfgs = _write_configs(workroot)
    print(f"[fault] reference (uninterrupted) run on {device}...", flush=True)
    _, wall, reference = run_straight(workroot, cfgs, device)
    print(f"[fault] reference wall {wall:.1f}s, {len(reference)} artifact digests", flush=True)
    rng = np.random.default_rng(seed)
    reports = []
    for i in range(trials):
        kill_after = float(rng.uniform(0.05, wall))
        r = run_trial(i, workroot, cfgs, kill_after, reference, device)
        print(f"[fault] {r}", flush=True)
        reports.append(r)
    print(f"[fault] all {trials} kill/resume trials produced byte-identical artifacts", flush=True)
    return reports


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m melogan_torch.fault_inject",
                                description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("workroot")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = p.parse_args()
    main(a.workroot, trials=a.trials, seed=a.seed, device=a.device)
