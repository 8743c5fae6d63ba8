"""``python -m melogan_torch --device cpu pipeline`` end to end on the CPU,
with the tiny configs of ``tests/test_cli.py``: the assertions of the JAX
CLI's ``test_pipeline_gan_selection_flags`` and
``test_pipeline_resume_skips_done_stages`` (less its precompile part: the
port has no compile cache to warm), then ``eval-gen``, ``sweep`` and
``tsne`` on the pipeline's workdir.
"""
import json
import os
import shutil

import pytest
import torch

from melogan_torch.cli import main
from melogan_torch.utils.checkpoint import load_checkpoint

TINY = {
    "ae.yaml": "latent_dim: 4\nhidden_dim: 32\nbatch_size: 8\nrecon_save_count: 0\n",
    "ed.yaml": "input_mode: notes\nnotes_hidden: 32\nmlp_hidden: [32, 16]\nbatch_size: 8\nlatent_dim: 4\n",
    "gan.yaml": ("NOISE_DIM: 16\nLATENT_DIM: 4\nGEN_HIDDEN: 32\n"
                 "BATCH_SIZE: 4\nCRITIC_ITERS: 2\nSAVE_FREQ: 2\n"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _argv(work, cfg_dir):
    return ["--device", "cpu", "pipeline", "--workdir", work, "--synthetic",
            "--per-emotion", "6", "--epochs", "2", "--skip-quality-gate",
            "--gan-ema", "0.9", "--gan-track-best",
            "--ae-config", os.path.join(cfg_dir, "ae.yaml"),
            "--ed-config", os.path.join(cfg_dir, "ed.yaml"),
            "--gan-config", os.path.join(cfg_dir, "gan.yaml")]


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    """One completed pipeline: its configs' directory, its workdir and its
    stdout."""
    cfg_dir = str(tmp_path_factory.mktemp("cli_configs"))
    for name, text in TINY.items():
        with open(os.path.join(cfg_dir, name), "w") as f:
            f.write(text)
    work = str(tmp_path_factory.mktemp("cli_pipeline"))
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(_argv(work, cfg_dir))
    return {"cfg_dir": cfg_dir, "work": work, "out": buf.getvalue()}


def test_pipeline_gan_selection_flags(piped):
    """`pipeline --gan-ema DECAY --gan-track-best`: the GAN stage trains with
    a generator EMA and a gate-tracked best checkpoint, and the sample stage
    consumes gan_best.ckpt's EMA weights (not gan_final's live ones)."""
    out, work = piped["out"], piped["work"]
    assert "pipeline complete" in out
    best = os.path.join(work, "experiments/gan/checkpoints/gan_best.ckpt")
    ckpt = load_checkpoint(best)
    assert "G_ema" in ckpt and "gate" in ckpt
    assert f"loaded generator from {best}" in out
    assert "(EMA weights)" in out
    mids = [f for f in os.listdir(os.path.join(work, "generated_tests")) if f.endswith(".mid")]
    assert len(mids) == 8
    assert all(os.path.getsize(os.path.join(work, "generated_tests", m)) > 0 for m in mids)
    meta = json.load(open(os.path.join(work, "pipeline_timings.json")))
    assert [s["name"] for s in meta["stages"]] == [
        "synth-data", "preprocess", "make-splits", "split-arrays", "train-ae", "encode",
        "train-ed", "train-gan", "sample"]
    assert meta["resumed"] is False and meta["total_seconds"] > 0
    for stage in ("train-ae", "encode", "train-ed", "train-gan", "sample"):
        marker = json.load(open(os.path.join(work, ".pipeline_done", f"{stage}.json")))
        assert marker["stage"] == stage and set(marker) == {"stage", "sig", "data_sig"}
        assert marker["data_sig"] == {"synthetic": True, "per_emotion": 6, "manifest": None}
        assert marker["sig"]["gan_ema"] == "0.9" and marker["sig"]["gan_track_best"] is True


def test_pipeline_resume_skips_done_stages(piped, tmp_path, capsys):
    """`pipeline --resume` after a completed run: data stages are skipped
    (outputs exist) and the train stages on their completion markers; after
    an interruption inside train-gan (its marker missing) the stage resumes
    from its periodic checkpoint and the downstream stages re-run; a changed
    invocation, a deleted checkpoint or changed data parameters re-run what
    they invalidate."""
    work = str(tmp_path / "w")
    shutil.copytree(piped["work"], work)
    argv = _argv(work, piped["cfg_dir"])

    main(argv + ["--resume"])
    out = capsys.readouterr().out
    for s in ("synth-data", "preprocess", "make-splits", "split-arrays"):
        assert f"--resume: skipping {s}" in out, out
    for s in ("train-ae", "encode", "train-ed", "train-gan", "sample"):
        assert f"--resume: skipping {s} (completed in a previous run)" in out, out
    assert "pipeline complete" in out
    meta = json.load(open(os.path.join(work, "pipeline_timings.json")))
    assert meta["resumed"] is True
    assert [s["name"] for s in meta["stages"]][:2] == ["synth-data", "preprocess"]
    assert all(s["seconds"] == 0.0 for s in meta["stages"])

    # resume after an INTERRUPTION inside train-gan (its marker is missing):
    # upstream completed stages still skip, the interrupted stage resumes
    # from its periodic checkpoint, and downstream stages re-run
    os.unlink(os.path.join(work, ".pipeline_done", "train-gan.json"))
    main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "--resume: skipping train-ed (completed in a previous run)" in out
    assert "resumed from" in out and "gan_epoch0002.ckpt" in out
    assert "--resume: skipping sample" not in out
    assert "(EMA weights)" in out and "pipeline complete" in out
    assert len([f for f in os.listdir(os.path.join(work, "generated_tests"))
                if f.endswith(".mid")]) == 8

    # a changed invocation (different --epochs) invalidates every marker
    argv3 = [a if a != "2" else "3" for a in argv]  # --epochs 2 → 3
    main(argv3 + ["--resume"])
    out = capsys.readouterr().out
    assert "skipping train-ae (completed in a previous run)" not in out, out

    # a marker whose checkpoint was DELETED must re-run its stage: skipping
    # on the marker alone would hand the sample stage a missing checkpoint
    gan_ckpt = os.path.join(work, "experiments", "gan", "checkpoints", "gan_final.ckpt")
    assert os.path.exists(gan_ckpt)
    os.unlink(gan_ckpt)
    main(argv3 + ["--resume"])
    out = capsys.readouterr().out
    assert "skipping train-ed (completed in a previous run)" in out, out
    assert "skipping train-gan (completed in a previous run)" not in out, out
    assert os.path.exists(gan_ckpt)

    # a changed --per-emotion must REGENERATE the data (and retrain)
    argv4 = [a if a != "6" else "7" for a in argv3]  # --per-emotion 6 → 7
    main(argv4 + ["--resume"])
    out = capsys.readouterr().out
    assert "re-running synth-data (data parameters changed" in out, out
    assert "skipping train-ae" not in out, out


def test_pipeline_ends_in_the_quality_gate(piped, tmp_path, capsys):
    """Without --skip-quality-gate the last stage gates the fresh samples
    (it is never skipped): a failing gate exits 1 before the timings are
    written, a passing one is timed with the rest."""
    work = str(tmp_path / "w")
    shutil.copytree(piped["work"], work)
    argv = [a for a in _argv(work, piped["cfg_dir"]) if a != "--skip-quality-gate"] + ["--resume"]
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr().out
    assert "--resume: skipping sample (completed in a previous run)" in out
    verdict = [ln for ln in out.splitlines() if "quality gate (default tier)" in ln]
    assert len(verdict) == 1
    meta = json.load(open(os.path.join(work, "pipeline_timings.json")))
    if verdict[0].startswith("[PASS]"):
        assert code == 0 and meta["stages"][-1]["name"] == "quality-gate" and meta["resumed"]
    else:
        assert code == 1 and meta["resumed"] is False  # the copied first run's file


def test_eval_gen_writes_the_jax_report(piped, capsys):
    """`eval-gen` trains the judge on val (test as its validation), scores
    it on the real test rows, judges fresh samples of gan_final.ckpt and
    writes eval_gen.json with the JAX CLI's keys; a second run loads the
    judge."""
    work, cfg_dir = piped["work"], piped["cfg_dir"]
    argv = ["--device", "cpu", "eval-gen", "--workdir", work,
            "--config", os.path.join(cfg_dir, "gan.yaml"),
            "--ed-config", os.path.join(cfg_dir, "ed.yaml"),
            "--splits-dir", os.path.join(work, "data/splits"),
            "--processed-dir", os.path.join(work, "data/processed"),
            "--samples", "2", "--judge-epochs", "1"]
    main(argv)
    out = capsys.readouterr().out
    assert "training judge ED on the held-out val split" in out
    assert "judge on REAL held-out test data" in out
    report = json.load(open(os.path.join(work, "eval_gen.json")))
    assert set(report) == {"n", "accuracy", "chance", "per_emotion", "confusion",
                           "n_per_emotion", "seed", "judge_real"}
    assert report["n"] == 8 and report["n_per_emotion"] == 2 and report["seed"] == 1234
    assert set(report["judge_real"]) == {"n", "accuracy", "chance", "per_emotion", "confusion"}
    main(argv + ["--min-accuracy", "0"])
    out = capsys.readouterr().out
    assert "loaded judge ED from" in out
    assert json.load(open(os.path.join(work, "eval_gen.json")))["confusion"] == report["confusion"]
    with pytest.raises(SystemExit, match="below the --min-accuracy gate"):
        main(argv + ["--min-accuracy", "1.01"])


def test_sweep_and_train_gan_subcommands(piped, tmp_path, capsys):
    """`sweep` of two seeds and `train-gan --ema auto` (which turns
    --track-best on) against the pipeline's ED and latents."""
    work = str(tmp_path / "w")
    shutil.copytree(piped["work"], work)
    cfg_dir = piped["cfg_dir"]
    common = ["--workdir", work, "--config", os.path.join(cfg_dir, "gan.yaml"),
              "--ed-config", os.path.join(cfg_dir, "ed.yaml"),
              "--splits-dir", os.path.join(work, "data/splits"),
              "--processed-dir", os.path.join(work, "data/processed"), "--epochs", "1"]
    main(["--device", "cpu", "sweep", *common, "--population", "2", "--samples-per-emotion", "1"])
    out = capsys.readouterr().out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["best_seed"] in (42, 43) and [g["seed"] for g in report["gate"]] == [42, 43]
    assert "loaded frozen ED from" in out
    main(["--device", "cpu", "train-gan", *common, "--ema", "auto", "--fm", "1"])
    out = capsys.readouterr().out
    assert "--ema auto: decay" in out and "--track-best enabled" in out
    assert "gan_best.ckpt" in os.listdir(os.path.join(work, "experiments/gan/checkpoints"))


def test_tsne_writes_the_plot(piped, tmp_path, capsys):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    work = piped["work"]
    main(["tsne", "--split", "train", "--splits-dir", os.path.join(work, "data/splits"),
          "--processed-dir", os.path.join(work, "data/processed"), "--out", str(tmp_path)])
    png = tmp_path / "train_latent_tsne_visualization.png"
    assert png.stat().st_size > 0 and str(png) in capsys.readouterr().out
