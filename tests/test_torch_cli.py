"""The port's command line (``melogan_torch/cli.py``) against the JAX CLI
(``melogan_tpu/cli.py``) on the same inputs, on the CPU.

- the parsers: every JAX subcommand but one has the same option strings,
  dests, defaults, choices and actions; the port adds only the top-level
  ``--device``;
- the data subcommands write the same CSV, MIDI and manifest bytes and the
  same arrays; the host-only commands print the same and write the same;
- ``import-checkpoint`` writes the same ``.ckpt`` bytes and
  ``export-checkpoint`` the same tensors;
- ``encode`` and ``eval-ed`` on a VAE and an ED the port trained here agree
  with JAX's within 1e-5 of scale;
- ``sample`` with one seed writes the same file names at the same tempos;
- ``text-eval --json --ceiling`` on one cached classifier prints JAX's
  report;
- ``doctor`` is bounded and fails without a card, ``--dp N`` checks the
  config batch (JAX's message) and the device count before any work, and
  ``python -m melogan_torch`` imports no JAX.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from melogan_torch import cli as pcli
from melogan_tpu import cli as jcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX subcommands the port does not have, and why
EXCLUDED = {
    "precompile": "it warms the JAX compile cache; the port compiles nothing ahead",
}

TINY_AE = "latent_dim: 4\nhidden_dim: 32\nbatch_size: 8\nrecon_save_count: 0\n"
TINY_ED = "input_mode: notes\nnotes_hidden: 32\nmlp_hidden: [32, 16]\nbatch_size: 8\nlatent_dim: 4\n"
TINY_GAN = ("NOISE_DIM: 16\nLATENT_DIM: 4\nGEN_HIDDEN: 32\n"
            "BATCH_SIZE: 4\nCRITIC_ITERS: 2\nSAVE_FREQ: 2\n")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs in these tests are small: more torch threads only
    contend with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _choices(parser):
    return parser._subparsers._group_actions[0].choices


def _options(parser):
    """dest → (option strings, default, nargs, choices, required, type, action)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.nargs,
                       None if a.choices is None else list(a.choices), a.required,
                       getattr(a.type, "__name__", a.type), type(a).__name__)
    return out


JAX_SUBCOMMANDS = sorted(_choices(jcli.build_parser()))


def test_port_has_every_jax_subcommand_but_three():
    """Every JAX subcommand but those in EXCLUDED."""
    jax_subs = set(_choices(jcli.build_parser()))
    port_subs = set(_choices(pcli.build_parser()))
    assert set(EXCLUDED) <= jax_subs
    assert port_subs == jax_subs - set(EXCLUDED)
    # the one top-level addition: --device, cuda unless asked
    top = _options(pcli.build_parser())
    assert _options(jcli.build_parser()) == {}
    assert top == {"device": (("--device",), "cuda", None, ["cuda", "cpu"], False, None, "_StoreAction")}


@pytest.mark.parametrize("name", [n for n in JAX_SUBCOMMANDS if n not in EXCLUDED])
def test_subcommand_parser_parity(name):
    jp, pp = _choices(jcli.build_parser())[name], _choices(pcli.build_parser())[name]
    assert _options(pp) == _options(jp)
    defaults = {k: v for k, v in jp._defaults.items() if k != "fn"}
    assert {k: v for k, v in pp._defaults.items() if k != "fn"} == defaults
    fn = pp._defaults["fn"]
    assert fn is getattr(pcli, fn.__name__) and fn.__name__ == jp._defaults["fn"].__name__


def test_host_only_fns_exist():
    for name in pcli._HOST_ONLY_FNS:
        assert callable(getattr(pcli, name, None)), f"{name} is not a cli handler"
    # the JAX set, plus handlers of the port that never touch the device
    assert set(jcli._HOST_ONLY_FNS) <= pcli._HOST_ONLY_FNS
    assert {"cmd_diagnose", "cmd_roll_to_midi"} <= pcli._HOST_ONLY_FNS
    device_fns = {"cmd_train_ae", "cmd_encode", "cmd_train_ed", "cmd_eval_ed", "cmd_train_gan",
                  "cmd_sweep", "cmd_sample", "cmd_eval_gen", "cmd_pipeline", "cmd_serve",
                  "cmd_profile", "cmd_text_eval", "cmd_bench"}
    assert not device_fns & pcli._HOST_ONLY_FNS
    handlers = {a.get_default("fn").__name__ for a in _choices(pcli.build_parser()).values()}
    assert handlers == pcli._HOST_ONLY_FNS | device_fns


def test_parse_hyper_grid_matches_jax():
    for spec in ('[{"lr_g": 1e-4}, {"lr_g": 2e-4, "lambda_gp": 5}]',
                 '{"lr_g": [1e-4, 2e-4], "lambda_emotion": [1, 2]}', None):
        assert pcli.parse_hyper_grid(spec) == jcli.parse_hyper_grid(spec)
    for bad, msg in (('{"lr_g": [1e-4], "lr_d": [1, 2]}', "share one length"),
                     ("[1, 2]", "list of override dicts")):
        with pytest.raises(SystemExit, match=msg):
            pcli.parse_hyper_grid(bad)


def test_resolve_ema_arg_matches_jax(capsys):
    from melogan_torch.config import GANConfig
    from melogan_tpu.config import GANConfig as JGANConfig

    for raw in ("auto", "0.9", 0.0):
        assert pcli._resolve_ema_arg(raw, GANConfig(), 50, 896) == \
            jcli._resolve_ema_arg(raw, JGANConfig(), 50, 896)
    for raw in ("1.0", "-0.1"):
        with pytest.raises(SystemExit, match="--ema"):
            pcli._resolve_ema_arg(raw, GANConfig(), 50, 896)
    with pytest.raises(SystemExit, match="zero generator updates"):
        pcli._resolve_ema_arg("auto", GANConfig(), 1, 8)


def test_load_cfg_fallback_rule(tmp_path, capsys):
    from melogan_torch.config import AEConfig, GANConfig

    # only a _CFG_DEFAULTS path may fall back to the built-in defaults
    with pytest.raises(FileNotFoundError, match="not found"):
        pcli._load_cfg(GANConfig, str(tmp_path / "missing.yaml"), str(tmp_path))
    os.chdir(tmp_path)
    try:
        # the repo root resolves the default path from any cwd
        assert pcli._resolve_config("configs/ae.yaml", str(tmp_path)) == \
            os.path.join(REPO, "configs/ae.yaml")
        assert pcli._load_cfg(AEConfig, "configs/ae.yaml") == AEConfig.from_yaml(
            os.path.join(REPO, "configs/ae.yaml"))
    finally:
        os.chdir(REPO)


# ---------------------------------------------------------------------------
# byte and array equality of what the two CLIs write
# ---------------------------------------------------------------------------


def _snapshot(root):
    """{relative path: bytes, or {key: array} for .npz, or an array for .npy}."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            elif f.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), k
            for key in a[k]:
                np.testing.assert_array_equal(a[k][key], b[k][key], err_msg=f"{k}:{key}")
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _run_both(capsys, root, argv, setup=None):
    """Run ``argv`` through the JAX CLI and then the port's in the same
    ``root`` (emptied and set up before each): (stdout, files) of each."""
    got = []
    for mod in (jcli, pcli):
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        if setup:
            setup()
        capsys.readouterr()
        mod.main(argv)
        got.append((capsys.readouterr().out, _snapshot(root)))
    return got


def test_data_subcommands_match_jax(tmp_path, capsys):
    """synth-data → preprocess → make-splits --ratios → split-arrays, each
    stage's stdout and every file (MIDI and CSV bytes, arrays) as JAX's."""
    root = str(tmp_path / "w")
    data = os.path.join(root, "data")
    manifest = os.path.join(data, "data_manifest.csv")
    stages = [
        ["synth-data", "--out", data, "--per-emotion", "4", "--seed", "3"],
        ["preprocess", "--manifest", manifest, "--out", os.path.join(data, "processed")],
        ["make-splits", "--manifest", manifest, "--out", os.path.join(data, "splits"),
         "--ratios", "0.5/0.25/0.25"],
        ["split-arrays", "--splits-dir", os.path.join(data, "splits"),
         "--processed-dir", os.path.join(data, "processed")],
    ]
    runs = []
    for mod in (jcli, pcli):
        shutil.rmtree(root, ignore_errors=True)
        outs = []
        for argv in stages:
            capsys.readouterr()
            mod.main(argv)
            outs.append((capsys.readouterr().out, _snapshot(root)))
        runs.append(outs)
    for (jout, jfiles), (pout, pfiles) in zip(*runs):
        assert pout == jout
        _assert_same(pfiles, jfiles)
    files = runs[1][-1][1]
    assert len([k for k in files if k.endswith(".mid")]) == 16
    assert "'train': 8" in runs[1][2][0]
    assert files[os.path.join("data", "splits", "train", "notes.npy")].shape == (8, 512, 4)
    with pytest.raises(SystemExit, match="ratios"):
        pcli.main(["make-splits", "--manifest", manifest, "--out", str(tmp_path / "s2"),
                   "--ratios", "0.5/0.6"])


def test_augment_corpus_matches_jax(tmp_path, capsys):
    from melogan_torch.data.synthetic import generate_corpus

    src = str(tmp_path / "src")
    generate_corpus(src, n_per_emotion=2, seed=0, n_notes=48)
    root = str(tmp_path / "aug")
    (jout, jfiles), (pout, pfiles) = _run_both(
        capsys, root, ["augment-corpus", "--manifest", os.path.join(src, "data_manifest.csv"),
                       "--out", root, "--per-song", "2", "--ratios", "0.5/0.25/0.25"])
    assert pout == jout and json.loads(pout.strip().splitlines()[-1])
    _assert_same(pfiles, jfiles)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A port-made corpus (4 songs an emotion, splits 8/4/4 with arrays), a
    VAE trained 2 epochs and an ED trained 2 epochs by the port's CLI on the
    CPU with tiny configs, and the VAE's µ latents of every split."""
    root = str(tmp_path_factory.mktemp("cli_corpus"))
    data = os.path.join(root, "data")
    manifest = os.path.join(data, "data_manifest.csv")
    for name, text in (("ae.yaml", TINY_AE), ("ed.yaml", TINY_ED), ("gan.yaml", TINY_GAN)):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    splits = ["--splits-dir", os.path.join(data, "splits"),
              "--processed-dir", os.path.join(data, "processed")]
    for argv in (
        ["synth-data", "--out", data, "--per-emotion", "4"],
        ["preprocess", "--manifest", manifest, "--out", os.path.join(data, "processed")],
        ["make-splits", "--manifest", manifest, "--out", os.path.join(data, "splits"),
         "--ratios", "0.5/0.25/0.25"],
        ["split-arrays", *splits],
        ["--device", "cpu", "train-ae", "--config", os.path.join(root, "ae.yaml"),
         "--workdir", root, "--epochs", "2", *splits],
        ["--device", "cpu", "encode", "--config", os.path.join(root, "ae.yaml"),
         "--workdir", root, *splits],
        ["--device", "cpu", "train-ed", "--config", os.path.join(root, "ed.yaml"),
         "--workdir", root, "--epochs", "2", *splits],
    ):
        pcli.main(argv)
    return {"root": root, "splits": splits, "data": data}


def test_encode_matches_jax(corpus, tmp_path, capsys, monkeypatch):
    """`encode` of the port's ae_best.ckpt: µ of every split within 1e-5 of
    scale of JAX's `encode` of the same file."""
    monkeypatch.setenv("MELOGAN_COMPILE_CACHE", "0")
    root, splits = corpus["root"], corpus["splits"]
    out = {}
    for name, mod, pre in (("jax", jcli, []), ("port", pcli, ["--device", "cpu"])):
        d = str(tmp_path / name)
        shutil.copytree(os.path.join(corpus["data"], "splits"), d)
        argv = [*pre, "encode", "--config", os.path.join(root, "ae.yaml"), "--workdir", root,
                "--splits-dir", d, "--processed-dir", splits[3]]
        mod.main(argv)
        out[name] = {s: np.load(os.path.join(d, s, "encoder_feats.npy")) for s in ("train", "val", "test")}
    assert "wrote (8, 4) latents" in capsys.readouterr().out
    for s in ("train", "val", "test"):
        ref = out["jax"][s]
        scale = float(np.abs(ref).max())
        assert scale > 0
        assert np.abs(out["port"][s] - ref).max() <= 1e-5 * scale, s


@pytest.mark.parametrize("split", ["test", "val"])
def test_eval_ed_matches_jax(corpus, split, capsys, monkeypatch):
    """`eval-ed` of the port's ed_best.ckpt: loss within 1e-5 of scale,
    accuracy, confusion and n equal to JAX's `eval-ed` of the same file."""
    monkeypatch.setenv("MELOGAN_COMPILE_CACHE", "0")
    root, splits = corpus["root"], corpus["splits"]
    res = {}
    for name, mod, pre in (("jax", jcli, []), ("port", pcli, ["--device", "cpu"])):
        capsys.readouterr()
        mod.main([*pre, "eval-ed", "--config", os.path.join(root, "ed.yaml"), "--workdir", root,
                  "--split", split, *splits])
        res[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j, p = res["jax"], res["port"]
    assert abs(p["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
    assert (p["accuracy"], p["confusion"], p["n"]) == (j["accuracy"], j["confusion"], j["n"])


def test_eval_weights_load_from_an_imported_checkpoint(corpus, tmp_path, capsys):
    """An imported reference checkpoint holds params and batch_stats only;
    `encode` reads it as it reads the trainer's file."""
    root, splits = corpus["root"], corpus["splits"]
    ckpt = os.path.join(root, "data/models/ae/ae_best.ckpt")
    pth, back = str(tmp_path / "ae.pth"), str(tmp_path / "ae_imported.ckpt")
    pcli.main(["export-checkpoint", ckpt, pth, "--kind", "ae"])
    pcli.main(["import-checkpoint", pth, back, "--kind", "ae"])
    d = str(tmp_path / "splits")
    shutil.copytree(os.path.join(corpus["data"], "splits"), d)
    pcli.main(["--device", "cpu", "encode", "--config", os.path.join(root, "ae.yaml"),
               "--checkpoint", back, "--splits-dir", d, "--processed-dir", splits[3]])
    for s in ("train", "val", "test"):
        np.testing.assert_array_equal(np.load(os.path.join(d, s, "encoder_feats.npy")),
                                      np.load(os.path.join(corpus["data"], "splits", s,
                                                           "encoder_feats.npy")))


def test_diagnose_matches_jax(corpus, capsys):
    splits = corpus["splits"]
    outs = []
    for mod in (jcli, pcli):
        capsys.readouterr()
        mod.main(["diagnose", "--split", "train", *splits])
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    report = json.loads(outs[1])
    assert report["n_samples"] == 8 and "latent_structure" in report


def _gen_midis(d, seed=0):
    from melogan_torch.midi.codec import save_piano_roll_to_midi

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for emotion, bpm in (("happy", 140), ("sad", 70), ("angry", 160), ("calm", 90)):
        for i in (1, 2):
            notes = rng.normal(0, 0.6, size=(64, 4)).astype(np.float32)
            save_piano_roll_to_midi(notes, os.path.join(d, f"test_{emotion}_{i}.mid"), bpm=bpm,
                                    scale="major", verbose=False)


@pytest.mark.parametrize("tier", ["default", "strict"])
def test_quality_gate_matches_jax(tmp_path, capsys, tier):
    """`quality-gate --tier T --breakdown --breakdown-json P --no-strict`:
    the same stdout and the same JSON bytes; without --no-strict a failing
    gate exits 1 in both."""
    root = str(tmp_path / "gen")
    bd = str(tmp_path / "gen" / "bd.json")
    (jout, jfiles), (pout, pfiles) = _run_both(
        capsys, root, ["quality-gate", root, "--tier", tier, "--breakdown",
                       "--breakdown-json", bd, "--no-strict"], setup=lambda: _gen_midis(root))
    assert pout == jout and "quality gate" in pout
    _assert_same(pfiles, jfiles)
    assert json.loads(pfiles["bd.json"])["tier"] == tier
    codes = []
    os.makedirs(tmp_path / "empty")
    for mod in (jcli, pcli):
        with pytest.raises(SystemExit) as e:
            mod.main(["quality-gate", str(tmp_path / "empty")])
        codes.append(e.value.code)
    assert codes == [1, 1]


def test_analyze_midi_matches_jax(tmp_path, capsys):
    d = str(tmp_path / "m")
    _gen_midis(d, seed=1)
    files = sorted(os.path.join(d, f) for f in os.listdir(d))
    outs = []
    for mod in (jcli, pcli):
        capsys.readouterr()
        mod.main(["analyze-midi", *files])
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and len(outs[1].strip().splitlines()) == 8


def test_roll_to_midi_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    roll = np.zeros((16, 4), np.float32)
    roll[:, 0] = rng.integers(40, 90, 16)
    roll[:, 1] = rng.integers(30, 120, 16)
    roll[:, 2] = rng.uniform(0.1, 1.0, 16)
    roll[:, 3] = np.arange(16) * 0.5
    npy = str(tmp_path / "roll.npy")
    np.save(npy, roll)
    root = str(tmp_path / "out")
    (jout, jfiles), (pout, pfiles) = _run_both(
        capsys, root, ["roll-to-midi", npy, "--out", os.path.join(root, "o.mid"), "--bpm", "96"])
    assert pout == jout
    _assert_same(pfiles, jfiles)
    from melogan_torch.midi.midifile import read_midi

    assert abs(read_midi(os.path.join(root, "o.mid")).initial_tempo - 96.0) < 0.01


def test_logs_matches_jax(tmp_path, capsys):
    from melogan_torch.utils.metrics import MetricsWriter

    log_dir = str(tmp_path / "logs")
    w = MetricsWriter(log_dir)
    for step in range(1, 4):
        w.add_scalars({"loss/train": 1.0 / step, "acc/val": 0.2 * step}, step)
    w.close()
    for argv in (["logs", log_dir], ["logs", log_dir, "--tag", "acc/val"]):
        outs = []
        for mod in (jcli, pcli):
            capsys.readouterr()
            mod.main(argv)
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0] and outs[1].strip()


@pytest.mark.parametrize("confirm", [False, True])
def test_clean_matches_jax(tmp_path, capsys, confirm):
    root = str(tmp_path / "w")

    def setup():
        for rel in ("generated_tests", "experiments/gan/checkpoints", ".pipeline_done",
                    "data/splits/train", "configs"):
            os.makedirs(os.path.join(root, rel), exist_ok=True)
        np.save(os.path.join(root, "data/splits/train/encoder_feats.npy"), np.zeros(2))
        for rel in ("configs/gan.yaml", "generated_tests/a.mid"):
            with open(os.path.join(root, rel), "w") as f:
                f.write("x")

    argv = ["clean", "--workdir", root] + (["--confirm"] if confirm else [])
    (jout, jfiles), (pout, pfiles) = _run_both(capsys, root, argv, setup=setup)
    assert pout == jout
    log = "bulk_delete_log.jsonl"
    assert (log in pfiles) == confirm
    jfiles.pop(log, None)
    pfiles.pop(log, None)
    _assert_same(pfiles, jfiles)
    assert ("configs/gan.yaml" in pfiles) and (("generated_tests/a.mid" in pfiles) != confirm)


def _reference_pths(d):
    """Reference-layout .pth files of each kind, from seeded port modules."""
    from melogan_torch.config import AEConfig, EDConfig, GANConfig
    from melogan_torch.models.ed import EmotionDiscriminator
    from melogan_torch.models.gan import FeatureEncoder, Generator
    from melogan_torch.models.layers import gan_init_, torch_default_init_
    from melogan_torch.models.vae import VAE

    g = torch.Generator().manual_seed(0)
    vae = VAE.from_config(AEConfig(latent_dim=4, hidden_dim=32))
    ed = EmotionDiscriminator.from_config(EDConfig(notes_hidden=32, mlp_hidden=(32, 16)))
    cfg = GANConfig(noise_dim=16, latent_dim=4, gen_hidden=32)
    gen, fe = Generator.from_config(cfg), FeatureEncoder.from_config(cfg)
    for m in (vae, ed):
        torch_default_init_(m, g)
    for m in (gen, fe):
        gan_init_(m, g)
    for m in (vae, ed, gen):  # non-trivial running statistics
        for name, buf in m.named_buffers():
            if "running" in name:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    paths = {"ae": os.path.join(d, "ae.pth"), "ed": os.path.join(d, "ed.pth"),
             "gan": os.path.join(d, "gan.pth")}
    torch.save({"epoch": 7, "model_state": vae.state_dict()}, paths["ae"])
    torch.save({"epoch": 3, "model": ed.state_dict(), "optimizer": {}, "cfg": {"batch_size": 8}},
               paths["ed"])
    torch.save({"G": gen.state_dict(), "E_num": fe.state_dict()}, paths["gan"])
    return paths


@pytest.mark.parametrize("kind", ["ae", "ed", "gan"])
def test_checkpoint_import_export_match_jax(tmp_path, capsys, kind):
    """`import-checkpoint` of one .pth: .ckpt bytes equal to JAX's;
    `export-checkpoint` of that file: the same keys and tensors as JAX's."""
    pth = _reference_pths(str(tmp_path))[kind]
    outs = {}
    for name, mod in (("jax", jcli), ("port", pcli)):
        ckpt, back = str(tmp_path / f"{name}.ckpt"), str(tmp_path / f"{name}.pth")
        mod.main(["import-checkpoint", pth, ckpt, "--kind", kind])
        mod.main(["export-checkpoint", ckpt, back, "--kind", kind])
        with open(ckpt, "rb") as f:
            outs[name] = (f.read(), torch.load(back, weights_only=False))
    assert outs["port"][0] == outs["jax"][0]
    jt, pt = outs["jax"][1], outs["port"][1]
    assert sorted(pt) == sorted(jt)
    original = torch.load(pth, weights_only=True)
    for key in pt:
        if isinstance(jt[key], dict) and jt[key] and isinstance(next(iter(jt[key].values())), torch.Tensor):
            assert sorted(pt[key]) == sorted(jt[key]), key
            for k in jt[key]:
                assert torch.equal(pt[key][k], jt[key][k]), (key, k)
        else:
            assert pt[key] == jt[key], key
    # the round trip gives back the original tensors (running statistics
    # included; the reference's num_batches_tracked is not carried)
    sd_key = {"ae": "model_state", "ed": "model", "gan": "G"}[kind]
    for k, v in original[sd_key].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(pt[sd_key][k], v), k


def test_sample_names_and_tempos_match_jax(corpus, tmp_path, capsys, monkeypatch):
    """`sample --emotion all --samples 2 --seed 5` with random weights: the
    same eight file names, the same bpms printed and the same MIDI tempos as
    the JAX CLI (the bpms and the sampler seed come from one numpy stream)."""
    from melogan_torch.midi.midifile import read_midi

    monkeypatch.setenv("MELOGAN_COMPILE_CACHE", "0")
    gan = os.path.join(corpus["root"], "gan.yaml")
    res = {}
    for name, mod, pre in (("jax", jcli, []), ("port", pcli, ["--device", "cpu"])):
        out = str(tmp_path / name)
        capsys.readouterr()
        mod.main([*pre, "sample", "--emotion", "all", "--samples", "2", "--seed", "5",
                  "--config", gan, "--workdir", str(tmp_path), "--out", out])
        lines = [ln.replace(out, "OUT") for ln in capsys.readouterr().out.strip().splitlines()]
        res[name] = (lines, {f: read_midi(os.path.join(out, f)).initial_tempo
                             for f in sorted(os.listdir(out))})
    assert res["port"] == res["jax"]
    assert len(res["port"][1]) == 8 and "checkpoint not found" in res["port"][0][0]


@pytest.mark.parametrize("probe_secs", ["60", "0.001"])
def test_doctor_on_the_cpu_is_bounded_and_fails(tmp_path, capsys, monkeypatch, probe_secs):
    """`doctor` without a card: every check reported, `device` FAIL (the
    probe's error, or its time limit when the probe is cut), exit 1, and
    CUDA never initialized in this process; `native-midi` OK where g++
    builds the port's encoder."""
    import shutil
    import time

    monkeypatch.setenv("MELOGAN_DOCTOR_PROBE_SECS", probe_secs)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        pcli.main(["doctor", "--workdir", str(tmp_path)])
    assert e.value.code == 1
    assert time.perf_counter() - t0 < float(probe_secs) * 2 + 30
    out = capsys.readouterr().out
    for frag in ("device:", "nvcc:", "kernel-cache:", "ae-config:", "ed-config:", "gan-config:",
                 "splits:", "ae-ckpt:", "ed-ckpt:", "gan-ckpt:", "golden-artifacts:", "native-midi:",
                 "native-jpeg:", "text-backend:", "doctor:"):
        assert frag in out, out
    assert ("[OK] native-midi:" in out) == bool(shutil.which("g++")), out
    assert "[FAIL] device:" in out
    assert ("hung" in out) == (probe_secs == "0.001")
    assert "failing: device" in out
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("argv,batch_config", [
    (["train-ae"], ("AEConfig", "configs/ae.yaml")),
    (["train-ed"], ("EDConfig", "configs/ed.yaml")),
    (["train-gan"], ("GANConfig", "configs/gan.yaml")),
    (["sweep"], None), (["sample"], None), (["pipeline"], ("AEConfig", "configs/ae.yaml")),
    (["serve"], None),
])
def test_dp_checks_the_batch_and_the_device_count(argv, batch_config):
    """``--dp N`` before any work: a trainer whose config batch N does not
    divide exits with ``_mesh_from_args``' message, JAX's word for word;
    ``sweep`` (it shards members), ``sample`` and ``serve`` with N beyond
    the devices there are fail with ``make_mesh``'s device count."""
    if batch_config is not None:
        from melogan_torch import config as pconfig

        batch = pcli._load_cfg(getattr(pconfig, batch_config[0]), batch_config[1]).batch_size
        dp = next(n for n in range(3, 64) if batch % n)
        with pytest.raises(SystemExit) as theirs:
            jcli._mesh_from_args(argparse.Namespace(dp=dp), batch)
        with pytest.raises(SystemExit) as ours:
            pcli.main(["--device", "cpu", *argv, "--dp", str(dp)])
        assert str(ours.value) == str(theirs.value)
        return
    dp = (os.cpu_count() or 1) + 1
    with pytest.raises((ValueError, SystemExit), match=f"asked for {dp} devices, have {dp - 1}"):
        pcli.main(["--device", "cpu", *argv, "--dp", str(dp), "--workdir", "."])


def test_device_commands_raise_without_a_card(tmp_path):
    """No fallback: a device subcommand without --device cpu exits before
    any work where CUDA is not available."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="--device cuda: .*CUDA is not available"):
        pcli.main(["pipeline", "--workdir", str(tmp_path), "--synthetic"])
    assert not os.listdir(tmp_path)


def test_serve_passes_its_flags(monkeypatch, tmp_path):
    """`serve` hands the app every flag, the config resolved like every
    other subcommand's, and the device."""
    from melogan_torch.config import GANConfig
    from melogan_torch.serving import app

    got = {}
    monkeypatch.setattr(app, "serve", lambda **kw: got.update(kw))
    pcli.main(["--device", "cpu", "serve", "--port", "0", "--workdir", str(tmp_path),
               "--checkpoint", "x.ckpt", "--fast-math", "--watch-ckpt", "2.5", "--ema", "--dp", "2"])
    assert got == {"host": "0.0.0.0", "port": 0, "workdir": str(tmp_path),
                   "config": GANConfig.from_yaml(os.path.join(REPO, "configs/gan.yaml")),
                   "checkpoint": "x.ckpt", "fast_math": True, "watch_ckpt": 2.5, "use_ema": True,
                   "dp": 2, "device": "cpu"}


def test_profile_prints_jax_keys_and_a_trace(corpus, tmp_path, capsys):
    trace = str(tmp_path / "trace")
    pcli.main(["--device", "cpu", "profile", "--steps", "3", "--config",
               os.path.join(corpus["root"], "gan.yaml"), "--trace-dir", trace])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"batch", "steps", "mean_ms", "p50_ms", "p90_ms", "p99_ms",
                        "steps_per_sec", "trace_dir"}
    assert out["batch"] == 4 and out["steps"] == 3 and out["trace_dir"] == trace
    with open(os.path.join(trace, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    with open(os.path.join(trace, "spans.json")) as f:
        spans = json.load(f)
    assert spans["table"]["sampler.sample_notes"]["count"] == 3 and spans["dropped"] == 0
    assert len([r for r in spans["records"] if r["name"] == "sampler.sample_notes"]) == 3


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return type(tree).__name__


def test_text_eval_prints_the_jax_report(tmp_path, capsys, monkeypatch):
    """`text-eval --json --ceiling` of both CLIs on one cache file: a
    1-epoch classifier saved under the shipped recipe's fingerprint, which
    both packages load rather than train. The same keys, the same lexicon
    report and the same text-mlp predictions (equal accuracy and
    confusion; labels may differ only where two scores tie within
    rounding, so at most 2 of 1,620)."""
    from melogan_torch.models import text_emotion, text_mlp

    cache = str(tmp_path / "text_mlp.ckpt")
    clf = text_mlp.train_text_classifier(epochs=1, device="cpu")
    clf.fingerprint = text_mlp.training_fingerprint()
    clf.save(cache)
    with open(cache, "rb") as f:
        saved = f.read()
    monkeypatch.setenv("MELOGAN_TEXT_MLP_CACHE", cache)
    monkeypatch.delenv("MELOGAN_TEXT_BACKEND", raising=False)
    monkeypatch.delenv("MELOGAN_TEXT_MODEL_DIR", raising=False)
    text_emotion.reset_backend()

    def report(main, argv):
        main(argv)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    ours = report(pcli.main, ["--device", "cpu", "text-eval", "--json", "--ceiling"])
    theirs = report(jcli.main, ["text-eval", "--json", "--ceiling"])
    assert _keys(ours) == _keys(theirs)
    assert set(ours) == {"lexicon", "text-mlp", "ceiling"}
    assert ours["lexicon"] == theirs["lexicon"]
    assert ours["ceiling"]["knn_ngram_ceiling"] == theirs["ceiling"]["knn_ngram_ceiling"]
    a, b = ours["text-mlp"], theirs["text-mlp"]
    assert abs(a["accuracy"] - b["accuracy"]) * a["n"] <= 2
    assert np.abs(np.asarray(a["confusion"]) - np.asarray(b["confusion"])).sum() <= 4
    with open(cache, "rb") as f:  # loaded, not retrained over
        assert f.read() == saved


@pytest.mark.parametrize("module", ["melogan_torch", "melogan_torch.cli"])
def test_module_entry_point_imports_no_jax(module):
    """`python -m melogan_torch --help` in a fresh interpreter lists the
    subcommands, and no module of jax or of the JAX package is imported
    (``-X importtime`` lists every import)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", module, "--help"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for name in ("pipeline", "train-gan", "eval-gen", "text-eval", "doctor", "--device"):
        assert name in r.stdout
    imported = {ln.split("|")[-1].strip().split(".")[0] for ln in r.stderr.splitlines()
                if ln.startswith("import time:")}
    assert "melogan_torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "optax", "melogan_tpu", "yaml", "msgpack"}
