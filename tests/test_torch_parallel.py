"""Data parallelism of the port (``melogan_torch/parallel``) on the CPU.

Real ranks: ``parallel.launch.spawn`` starts two processes joined in a gloo
group through a ``file://`` store, with a deadline of ``DEADLINE`` seconds
each run, and they run the programs of ``tests/torch_dp_ranks.py`` (torch,
numpy and the port only). A world-size-2 run is held against the same
program in this process (world size 1) and against the JAX package's run on
``make_mesh(2)`` of the conftest's virtual CPU devices, with the same
global draws injected into both.

Tolerances, and why:

- Gradients, read as Adam's first moments, within 1e-5 of their module
  group's largest (GRAD_REL), as ``tests/test_torch_train.py`` and
  ``tests/test_torch_vae.py`` hold them; metrics within 1e-4 of their
  scale (REL). The ranks reduce in another order than one process or JAX
  does, which alone agrees to about 1e-7.
- Parameters: every element within 2·lr per update it took, since Adam's
  first steps move an element whose true gradient is zero (a conv bias in
  front of BatchNorm) by ±lr on either side at random. Where the gradient
  is large the element must agree closely: after one step, where its
  first moment is above 1e-4 of the group's largest, within 1e-7 (VAE,
  ED) or 1e-6 (GAN) absolute; after a whole run (several epochs), where
  its final first moment is above 1e-2 of the largest, within 1e-6
  absolute per update (an element above 1e-4 at the end may have had a
  near-zero gradient, and so a ±lr move, at an earlier step).
- BatchNorm running variances within REL of their scale, running means
  within REL plus 2·lr per update (``assert_running_stats``).
- Whole GAN runs against world size 1 also hold the JAX dp tests' metric
  tolerance (``tests/test_parallel.py:138-143``, rtol 1e-3), and VAE and
  ED runs the validation metric within 1e-4 (``:191-196``).
- The two ranks of a run hold bit-identical weights (the trainers check
  it), and a population sweep's member trains alone on its rank, so a
  sharded sweep equals the one-process sweep exactly.
- The cross-rank BatchNorm against ``nn.BatchNorm1d`` and JAX's
  ``TorchBatchNorm`` on the concatenated batch: 1e-5 of each quantity's
  scale (float64 sums against float32 ones).
- ``Sampler(mesh=)`` over two CPU shards against one ``Sampler``: 1e-5
  absolute, as ``test_sharded_sampling_matches_single_device``.
"""
import datetime
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import AEConfig as JAEConfig
from melogan_tpu.config import EDConfig as JEDConfig
from melogan_tpu.config import GANConfig as JGANConfig
from melogan_tpu.models.layers import TorchBatchNorm
from melogan_tpu.parallel import mesh as jmesh
from melogan_tpu.train import ed_loop as jed_loop
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.train import sweep as jsweep
from melogan_tpu.train import vae_loop as jvae_loop
from melogan_tpu.utils import torch_interop

from melogan_torch.cli import main as cli_main
from melogan_torch.config import AEConfig, EDConfig, GANConfig
from melogan_torch.parallel import distributed, launch
from melogan_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    microbatch_constrainer,
    partition_params,
    put_replicated,
    shard_pytree_batch,
)
from melogan_torch.sampling import Sampler
from melogan_torch.train import ed_loop, gan_loop, sweep, vae_loop
from melogan_torch.utils import weights
from melogan_torch.utils.checkpoint import load_checkpoint

from tests import torch_dp_ranks as ranks
from tests.test_torch_ed_loop import _dropout_masks, _jax_state as _jax_ed_state
from tests.test_torch_ed_loop import _split as _ed_split
from tests.test_torch_ed_loop import _variables as _ed_variables
from tests.test_torch_train import TINY, TINY_ED, _batches, _critic_draws, _group_draws, _setup, _torch_batches
from tests.test_torch_vae import SMALL as VAE_SMALL
from tests.test_torch_vae import _jax_model_state, _recover_eps, _split
from tests.test_torch_vae import _variables as _vae_variables

DEADLINE = 120.0  # seconds a spawned world-size-2 run may take before it is killed
RANK_TIMEOUT = datetime.timedelta(seconds=60)  # a collective whose peer is gone raises
REL = 1e-4
GRAD_REL = 1e-5
ED_SMALL = dict(max_notes=64, notes_blocks=3, notes_hidden=32, mlp_hidden=(16, 8), batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU runs: more torch threads only contend with the other test
    workers' (each rank takes its share of this process's, one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run2(fn, *args, timeout=DEADLINE):
    """``fn(mesh, *args)`` on two gloo ranks; each rank's return value."""
    return launch.spawn(fn, 2, args=args, device="cpu", timeout=timeout, rank_timeout=RANK_TIMEOUT)


def assert_scaled(ours, theirs, rel=REL, what=""):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, what
    scale = max(float(np.max(np.abs(theirs))), 1e-30)
    err = float(np.max(np.abs(ours - theirs)))
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x scale {scale:.3e}"


def assert_trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_trees_equal(a[k], b[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def assert_adam(ours_mu, want_mu, ours_p, want_p, lr, updates, big_rel=1e-4, big_abs=1e-6,
                what=""):
    """One module group after ``updates`` Adam steps, with the tolerances
    of the module docstring: every first moment within GRAD_REL of the
    group's largest; every parameter within 2·lr per update; where the
    wanted first moment is above ``big_rel`` of the largest, within
    ``big_abs`` per update (``big_rel`` None: that check is left out)."""
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in want_mu.values())
    assert gmax > 0, what
    for name, mu in want_mu.items():
        mu = np.asarray(mu, np.float64)
        err = float(np.abs(np.asarray(ours_mu[name], np.float64) - mu).max())
        assert err <= GRAD_REL * gmax, f"{what}{name} grad: {err:.3e} vs group max {gmax:.3e}"
        d = np.abs(np.asarray(ours_p[name], np.float64) - np.asarray(want_p[name], np.float64))
        assert d.max() <= 2 * lr * updates * (1 + 1e-3), f"{what}{name}: {d.max():.3e}"
        big = np.abs(mu) > (big_rel or np.inf) * gmax
        if big.any():
            assert d[big].max() <= big_abs * updates, \
                f"{what}{name}: {d[big].max():.3e} where the gradient is large"


# ---------------------------------------------------------------------------
# Meshes, placements, partitioning, the multi-host entry points
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_errors_match_jax():
    assert make_mesh(2, device="cpu").shape == dict(jmesh.make_mesh(2).shape) == {"data": 2, "model": 1}
    have = os.cpu_count()
    with pytest.raises(ValueError) as ours:
        make_mesh(have + 1, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jmesh.make_mesh(len(jax.devices()) + 1)
    assert str(ours.value) == f"asked for {have + 1} devices, have {have}"
    assert str(theirs.value) == f"asked for {len(jax.devices()) + 1} devices, have {len(jax.devices())}"
    for fn, kw in ((make_mesh, {"device": "cpu"}), (jmesh.make_mesh, {})):
        with pytest.raises(ValueError, match="n_devices must be divisible by model_parallel"):
            fn(4, model_parallel=3, **kw)
    with pytest.raises(NotImplementedError, match="A.9b"):
        make_mesh(4, model_parallel=2, device="cpu")
    mesh = make_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.group is None and mesh.is_main


@pytest.mark.parametrize("name", ["big", "small", "odd", "scalar"])
def test_partition_params_matches_jax_specs(name):
    """The four cases of ``test_partition_params_rules``: JAX's spec on a
    (data 4, model 2) mesh against the port's split dimension."""
    params = {"big": np.zeros((128, 4096), np.float32), "small": np.zeros((16, 16), np.float32),
              "odd": np.zeros((3, 4097), np.float32), "scalar": np.zeros((), np.float32)}
    spec = jmesh.partition_params(params, jmesh.make_mesh(8, model_parallel=2), min_dim=2048)[name].spec
    ours = partition_params(params, Mesh(data=4, model=2), min_dim=2048)[name]
    want = next((i for i, s in enumerate(spec) if s == "model"), None)
    assert ours == want
    # rules by name, and no model axis: replicated
    assert partition_params(params, Mesh(data=4, model=2), rules={"big": 0})["big"] == 0
    assert partition_params(params, Mesh(data=8), min_dim=2048)[name] is None


def test_placements():
    """One rule for every placement (``Mesh.rows``): a rank keeps its block
    of each leaf whose batch axis divides the data axis; a leaf that does
    not divide, and a 0-d one, stay whole (JAX's replicate-if-not-divisible,
    ``mesh.py:84-96``). ``microbatch_constrainer`` is
    ``shard_pytree_batch`` inside a step and the identity without a mesh,
    at data 1 and on a local mesh; ``put_replicated`` places the whole
    tree on the rank's device, or on the given one without a mesh."""
    mesh = Mesh(data=2, rank=1, group="a group")  # no collective is called here
    tree = {"x": torch.arange(8).reshape(4, 2), "odd": torch.arange(3), "s": torch.tensor(1.0)}
    got = microbatch_constrainer(mesh)(tree)
    assert got["x"].tolist() == [[4, 5], [6, 7]]
    assert got["odd"] is tree["odd"] and got["s"] is tree["s"]
    for m in (None, Mesh(data=1, group="a group"), Mesh(data=2)):
        assert microbatch_constrainer(m)(tree) is tree
    sharded = shard_pytree_batch({"a": np.arange(6), "odd": np.arange(5), "cols": np.arange(8).reshape(2, 4)},
                                 mesh)
    assert sharded["a"].tolist() == [3, 4, 5] and sharded["odd"].tolist() == [0, 1, 2, 3, 4]
    assert shard_pytree_batch(np.arange(8).reshape(2, 4), mesh, batch_axis=1).tolist() == [[2, 3], [6, 7]]
    assert torch.equal(sharded["cols"], torch.tensor([[4, 5, 6, 7]]))
    assert put_replicated([np.ones(2)], mesh)[0].device == torch.device("cpu")
    assert put_replicated({"a": np.ones(2), "n": None}, None, "cpu")["a"].dtype == torch.float64


def test_initialize_env_fallbacks(monkeypatch):
    """``initialize()`` takes the coordinator, the process count and the
    process id from the environment, as ``test_initialize_env_fallbacks``
    holds JAX's to."""
    calls = {}

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1, timeout=None):
        calls.update(backend=backend, init_method=init_method, world_size=world_size, rank=rank)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setenv("MELOGAN_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("MELOGAN_NUM_PROCESSES", "4")
    monkeypatch.setenv("MELOGAN_PROCESS_ID", "3")
    distributed.initialize(device="cpu")
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 3}
    distributed.initialize("10.0.0.2:99", 2, 0, device="cpu")  # arguments win
    assert calls["init_method"] == "tcp://10.0.0.2:99" and calls["world_size"] == 2
    monkeypatch.delenv("MELOGAN_PROCESS_ID")
    with pytest.raises(ValueError, match="MELOGAN_PROCESS_ID"):
        distributed.initialize(device="cpu")


def test_single_process_fallbacks():
    mesh = distributed.make_multihost_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    batch = distributed.global_batch_from_local(mesh, {"x": np.arange(16, dtype=np.float32).reshape(8, 2)})
    assert batch.global_rows == 8 and float(batch.local["x"].sum()) == 120.0
    assert distributed.process_count() == 1


def test_multihost_rows_of_two_ranks():
    """Two ranks: each keeps its own block of a global batch, on the CPU."""
    out = run2(ranks.rows_of, 6)
    assert out == [{"rank": 0, "rows": [0, 1, 2], "device": "cpu"},
                   {"rank": 1, "rows": [3, 4, 5], "device": "cpu"}]


# ---------------------------------------------------------------------------
# The launcher never hangs
# ---------------------------------------------------------------------------


def test_a_rank_that_raises_fails_the_launcher_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed\n-- rank 1:\n(.|\n)*rank 1 fails on purpose"):
        run2(ranks.raise_on_rank, 1, timeout=60)
    assert time.monotonic() - t0 < 60


def test_the_launcher_kills_ranks_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run2(ranks.sleep_forever, timeout=3)
    assert time.monotonic() - t0 < 40


# ---------------------------------------------------------------------------
# The cross-rank BatchNorm
# ---------------------------------------------------------------------------


def test_cross_rank_batch_norm_matches_batchnorm_on_the_whole_batch(rng):
    """Two train-mode steps (forward, backward, running stats,
    ``num_batches_tracked``) and an eval pass on two ranks' halves against
    ``nn.BatchNorm1d`` and JAX's ``TorchBatchNorm`` on the whole batch."""
    x = rng.normal(1.0, 2.0, size=(8, 16, 6)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    two = run2(ranks.batch_norm, x, dy, w, b, 2)
    one = ranks.batch_norm(None, x, dy, w, b, 2)
    for k in ("y", "dx"):
        for step in range(2):
            assert_scaled(np.concatenate([r[k][step] for r in two]), one[k][step], rel=1e-5, what=k)
    for k in ("dw", "db"):  # each rank's own sum; the trainers' mean over ranks, times 2
        assert_scaled(2 * two[0][k][-1], one[k][-1], rel=1e-5, what=k)
    for r in two:
        for k in ("running_mean", "running_var"):
            assert_scaled(r[k], one[k], rel=1e-5, what=k)
        assert r["num_batches_tracked"] == one["num_batches_tracked"] == 2
    assert_scaled(np.concatenate([r["eval"] for r in two]), one["eval"], rel=1e-5, what="eval")

    # JAX's TorchBatchNorm, one train step on the whole batch
    bn = TorchBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def loss(p, xx):
        y, mutated = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx,
                              use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, mutated["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    first = ranks.batch_norm(None, x, dy, w, b, 1)
    assert_scaled(np.concatenate([r["y"][0] for r in two]), y, rel=1e-5, what="jax y")
    assert_scaled(np.concatenate([r["dx"][0] for r in two]), gx, rel=1e-5, what="jax dx")
    assert_scaled(2 * two[0]["dw"][0], gp["scale"], rel=1e-5, what="jax dscale")
    assert_scaled(first["running_var"], stats["var"], rel=1e-5, what="jax running var")


# ---------------------------------------------------------------------------
# The WGAN-GP step and loop
# ---------------------------------------------------------------------------


def _modules(tstate):
    return {n: {k: v.numpy().copy() for k, v in getattr(tstate, n).state_dict().items()}
            for n in ("generator", "critic", "feature_encoder", "ed")}


def _group_of(name):
    return name.split(".", 1)[0]


@pytest.mark.parametrize("fused,ema_decay,with_jax", [(False, 0.0, True), (True, 0.9, False)])
def test_gan_steps_two_ranks_match_one_and_jax_mesh(rng, fused, ema_decay, with_jax):
    """One group step and a two-batch tail from JAX's state with JAX's draws:
    the port on two ranks against the port in one process (the tolerances
    of ``tests/test_torch_train.py``) and, for the reference critic passes,
    against JAX's ``make_train_steps(mesh=make_mesh(2))`` (the JAX dp
    test's; the fused pass's JAX program compiles for seconds more and
    differs only in the critic, which has no cross-row operation)."""
    jcfg, models, jstate, _, tstate, _ = _setup(rng, fused, 0.0, ema_decay)
    batches = _batches(rng, jcfg, jcfg.critic_iters)
    draws = _group_draws(jcfg, models, jstate, batches)
    jsteps = jstep.make_train_steps(jcfg, models, mesh=jmesh.make_mesh(2))
    jnew = jstate  # without JAX's step, any key draws the tail: only the port's runs compare
    if with_jax:
        jnew, jm = jax.jit(jsteps.group)(jstate, tuple(jnp.asarray(a) for a in batches))
    tail = _batches(rng, jcfg, 2)
    tail_draws, _ = _critic_draws(jcfg, models, jnew.fe_params, jnew.rng, tail[3])

    cfg_kw = dict(TINY, fused_critic_batch=fused, ema_decay=ema_decay)
    args = (cfg_kw, TINY_ED, _modules(tstate), [(_torch_batches(batches), draws)],
            [(_torch_batches(tail), tail_draws)])
    two = run2(ranks.gan_steps, *args)
    one = ranks.gan_steps(None, *args)

    assert_trees_equal(two[0]["modules"], two[1]["modules"], "rank 0 vs rank 1")
    assert two[0]["step"] == one["step"] == 1
    for got, want in zip(two[0]["metrics"], one["metrics"]):
        assert set(got) == set(want)
        for k in want:
            assert_scaled(got[k], want[k], what=k)
    # gradients through Adam's first moments, parameters, per module group
    lr = {"G": jcfg.lr_g, "FE": jcfg.lr_g, "D": jcfg.lr_d}
    updates = {"G": 1, "FE": 1, "D": jcfg.critic_iters + 2}
    module_of = {"G": "generator", "FE": "feature_encoder", "D": "critic"}

    def check(want_mu, want_modules, what):
        for group in ("G", "FE", "D"):
            mu = {n.split(".", 1)[1]: v for n, v in want_mu.items() if _group_of(n) == group}
            ours = {n.split(".", 1)[1]: v for n, v in two[0]["exp_avg"].items() if _group_of(n) == group}
            # the critic's tail: only its 2·lr bound, as tests/test_torch_train.py
            big_rel = 1e-4 if updates[group] == 1 else None
            assert_adam(ours, mu, two[0]["modules"][module_of[group]], want_modules[module_of[group]],
                        lr[group], updates[group], big_rel=big_rel, what=f"{what} {group}.")

    check(one["exp_avg"], one["modules"], "one rank")
    if ema_decay:
        for k, v in one["ema"].items():
            assert np.abs(two[0]["ema"][k] - v).max() <= 2 * jcfg.lr_g * (1 + 1e-3), k

    if not with_jax:
        return
    # against JAX on make_mesh(2): metrics, Adam's first moments, parameters
    jtail, jtm = jax.jit(jsteps.tail)(jnew, tuple(jnp.asarray(a) for a in tail))
    np.testing.assert_allclose(two[0]["metrics"][0]["loss_d_sum"], float(jm["loss_d_sum"]), rtol=1e-3)
    np.testing.assert_allclose(two[0]["metrics"][1]["loss_d_sum"], float(jtm["loss_d_sum"]), rtol=1e-3)
    for k in two[0]["metrics"][0]:
        assert_scaled(two[0]["metrics"][0][k], float(jm[k]), what=f"jax {k}")
    gen_mu, fe_mu = jtail.opt_g[0].mu
    jax_mu = {}
    for prefix, sd in (("G", torch_interop.export_generator({"params": gen_mu, "batch_stats": jtail.gen_stats})),
                       ("FE", torch_interop.export_feature_encoder({"params": fe_mu})),
                       ("D", torch_interop.export_critic({"params": jtail.opt_d[0].mu}))):
        jax_mu.update({f"{prefix}.{k}": np.asarray(v) for k, v in sd.items() if f"{prefix}.{k}" in one["exp_avg"]})
    want = {"generator": torch_interop.export_generator({"params": jtail.gen_params,
                                                          "batch_stats": jtail.gen_stats}),
            "critic": torch_interop.export_critic({"params": jtail.critic_params}),
            "feature_encoder": torch_interop.export_feature_encoder({"params": jtail.fe_params})}
    check(jax_mu, {n: {k: np.asarray(v) for k, v in sd.items()} for n, sd in want.items()}, "JAX")
    assert_running_stats(two[0]["modules"]["generator"], want["generator"], jcfg.lr_g, 1)


def _gan_corpus(rng, n):
    from tests.test_torch_train import _corpus

    raw, emotions, numeric = _corpus(rng, n)
    return raw, emotions, numeric, [f"s{i}" for i in range(n)]


def test_gan_train_two_ranks_match_one(rng, tmp_path):
    """``gan_loop.train`` for 2 epochs (2 group steps and a tail each, EMA
    on, a checkpoint every epoch) on two ranks against one process; rank 0
    alone writes the files, which a resume reads on every rank."""
    kw = dict(TINY, ema_decay=0.9, save_freq=1)
    arrays = _gan_corpus(rng, 2 * 5 * 4 + 3 * 4)
    two = run2(ranks.gan_train, kw, TINY_ED, arrays, str(tmp_path / "two"), 2)
    one = ranks.gan_train(None, kw, TINY_ED, arrays, str(tmp_path / "one"), 2)
    assert two[0]["step"] == one["step"] == 4
    for k, v in one["history"].items():
        if k not in ("epoch_seconds", "epoch"):
            np.testing.assert_allclose(two[0]["history"][k], v, rtol=1e-3, err_msg=k)
    cfg = GANConfig(**kw)
    for group, module, lr, updates in (("G", "generator", cfg.lr_g, 4), ("FE", "feature_encoder", cfg.lr_g, 4),
                                       ("D", "critic", cfg.lr_d, 4 * cfg.critic_iters + 2)):
        mu = {n.split(".", 1)[1]: v for n, v in one["exp_avg"].items() if _group_of(n) == group}
        ours = {n.split(".", 1)[1]: v for n, v in two[0]["exp_avg"].items() if _group_of(n) == group}
        assert_adam(ours, mu, two[0]["modules"][module], one["modules"][module], lr, updates,
                    big_rel=1e-2, what=f"{group}.")
    for name, sd in one["modules"].items():
        assert_trees_equal(two[0]["modules"][name], two[1]["modules"][name], name)
    assert_running_stats(two[0]["modules"]["generator"], one["modules"]["generator"], cfg.lr_g, 4)
    ckpts = tmp_path / "two" / "experiments" / "gan" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["gan_epoch0001.ckpt", "gan_epoch0002.ckpt", "gan_final.ckpt",
                                         "gan_final.pth"]
    assert load_checkpoint(str(ckpts / "gan_epoch0002.ckpt"))["epoch"] == 2


# ---------------------------------------------------------------------------
# The VAE and ED loops
# ---------------------------------------------------------------------------


def _arrays(split):
    return split.notes_raw, split.emotions, split.numeric, list(split.filenames)


def assert_running_stats(ours, want, lr, updates):
    """BatchNorm running statistics: variances within REL of their scale;
    means within REL of their scale plus 2·lr per update, because the conv
    bias in front of a BatchNorm (the ±lr element of the module docstring)
    shifts the batch mean that the running mean takes in."""
    for k in want:
        ours_k, want_k = np.asarray(ours[k], np.float64), np.asarray(want[k], np.float64)
        scale = float(np.abs(want_k).max())
        err = float(np.abs(ours_k - want_k).max())
        if k.endswith("running_var"):
            assert err <= REL * scale, f"{k}: {err:.3e} vs scale {scale:.3e}"
        elif k.endswith("running_mean"):
            assert err <= REL * scale + 2 * lr * updates * (1 + 1e-3), f"{k}: {err:.3e}"


@pytest.mark.parametrize("kw,n_val", [({}, 16), ({"free_bits": 0.25, "kl_capacity": 0.5,
                                                   "kld_warmup_epochs": 2}, 5)],
                         ids=["reference", "free-bits-capacity-replicated-val"])
def test_vae_train_two_ranks_match_one(tmp_path, kw, n_val):
    """``vae_loop.train`` for 3 epochs of 4 steps: the global-mean KL knobs,
    and a validation split of 5 rows (one whole batch, which does not
    divide the ranks and runs whole on each). The best state's first
    moments and parameters after its ``count`` updates, with the whole-run
    tolerances of the module docstring."""
    cfg_kw = dict(VAE_SMALL, epochs=3, recon_save_count=0, **kw)
    train, val = _arrays(_split(3, 32)), _arrays(_split(4, n_val))
    two = run2(ranks.vae_train, cfg_kw, train, val, str(tmp_path / "two"))
    one = ranks.vae_train(None, cfg_kw, train, val, str(tmp_path / "one"))
    assert two[0]["count"] == one["count"] > 0
    np.testing.assert_allclose(two[0]["metrics"]["best_val"], one["metrics"]["best_val"], rtol=1e-4)
    assert two[0]["metrics"]["epoch"] == one["metrics"]["epoch"]
    assert_adam(two[0]["mu"], one["mu"], two[0]["model"], one["model"], AEConfig(**cfg_kw).lr,
                one["count"], big_rel=1e-2)
    assert_running_stats(two[0]["model"], one["model"], AEConfig(**cfg_kw).lr, one["count"])
    assert_trees_equal(two[0]["model"], two[1]["model"], "rank 0 vs rank 1")
    assert "ae_final.ckpt" in {f for _, _, fs in os.walk(tmp_path / "two") for f in fs}


def _straddling_knobs(mu, log_var):
    """A free-bits level and a capacity that each rank's half of the batch
    sees on the other side than the whole batch does: from the latent
    dimension whose two halves' mean KL differ most, and from the halves'
    KLDs. With them a rank that clamped or took ``|KL − C|`` of its own
    half's mean would step otherwise than the global batch."""
    terms = -0.5 * (1 + log_var - np.square(mu) - np.exp(log_var))
    halves = np.stack([terms[: len(terms) // 2].mean(0), terms[len(terms) // 2:].mean(0)])
    d = int(np.argmax(np.abs(halves[0] - halves[1])))
    free_bits = float(halves[:, d].mean() + abs(halves[0, d] - halves[1, d]) / 4)
    klds = halves.mean(1)
    capacity = float(klds.mean() + abs(klds[0] - klds[1]) / 4)
    return free_bits, capacity


@pytest.mark.parametrize("free_bits,capacity", [(0.0, None), (0.25, 0.5), ("straddle", None), (0.0, "straddle")],
                         ids=["reference", "knobs", "free-bits-straddle", "capacity-straddle"])
def test_vae_step_two_ranks_match_jax_mesh(free_bits, capacity):
    """One optimizer step with JAX's reparameterisation noise: the port on
    two ranks against JAX's ``make_epoch_fns(mesh=make_mesh(2))`` and
    against the port in one process: the losses, Adam's first moments (the
    gradient all-reduce and, with free bits and a capacity, the global
    means that they read, ``cross_rank_mean``), the parameters and the BN
    statistics. The straddling cases set a knob between the two halves'
    values (``_straddling_knobs``), where a rank's own mean would give
    another loss and gradient than the global one."""
    cfg, model, jstate = _jax_model_state()
    x = _split(2, 8).notes_ae(cfg)
    _, k_rep = jax.random.split(jstate.rng)
    (_, z, mu, lv), _ = model.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                    jnp.asarray(x), train=True, rngs={"reparam": k_rep},
                                    mutable=["batch_stats"])
    fb_straddle, cap_straddle = _straddling_knobs(np.asarray(mu, np.float64), np.asarray(lv, np.float64))
    free_bits = fb_straddle if free_bits == "straddle" else free_bits
    capacity = cap_straddle if capacity == "straddle" else capacity
    cfg, model, jstate = _jax_model_state(free_bits=free_bits)
    train_epoch = jvae_loop.make_epoch_fns(cfg, model, mesh=jmesh.make_mesh(2))[0]
    cap = None if capacity is None else jnp.float32(capacity)
    jnew, metrics = jax.jit(train_epoch)(jstate, jnp.asarray(x)[None], jnp.float32(2.5), cap)
    cfg_kw = dict(VAE_SMALL, free_bits=free_bits, kl_capacity=capacity or 0.0)
    model_sd = {k: np.asarray(v) for k, v in weights.export_vae(_vae_variables(jstate)).items()}
    args = (cfg_kw, model_sd, x, 2.5, _recover_eps(z, mu, lv).numpy())
    two = run2(ranks.vae_step, *args)
    one = ranks.vae_step(None, *args)
    for i, name in enumerate(("total", "recon", "kld")):
        assert_scaled(two[0]["row"][i], float(metrics[name]), what=name)
        assert_scaled(two[0]["row"][i], one["row"][i], what=name)
    adam = jnew.opt_state[1].inner_state[0]
    jax_mu = weights.export_vae({"params": jax.tree_util.tree_map(np.asarray, adam.mu)})
    want = weights.export_vae(_vae_variables(jnew))
    assert two[0]["count"] == one["count"] == int(adam.count) == 1
    assert_adam(two[0]["mu"], {k: jax_mu[k] for k in two[0]["mu"]}, two[0]["model"], want, cfg.lr, 1,
                big_abs=1e-7, what="JAX ")
    assert_adam(two[0]["mu"], one["mu"], two[0]["model"], one["model"], cfg.lr, 1, big_abs=1e-7,
                what="one rank ")
    assert_running_stats(two[0]["model"], want, cfg.lr, 1)
    assert_trees_equal(two[0]["model"], two[1]["model"], "rank 0 vs rank 1")


def test_ed_train_two_ranks_match_one(tmp_path):
    """``ed_loop.train`` for 3 epochs of 4 steps, ``save_freq`` 2: the best
    state's first moments and parameters, with the whole-run tolerances."""
    cfg_kw = dict(ED_SMALL, num_epochs=3, save_freq=2)
    train, val = _arrays(_ed_split(5, 32)), _arrays(_ed_split(6, 16))
    two = run2(ranks.ed_train, cfg_kw, train, val, str(tmp_path / "two"))
    one = ranks.ed_train(None, cfg_kw, train, val, str(tmp_path / "one"))
    assert two[0]["metrics"]["epoch"] == one["metrics"]["epoch"]
    assert two[0]["count"] == one["count"] > 0
    np.testing.assert_allclose(two[0]["metrics"]["val_loss"], one["metrics"]["val_loss"], rtol=1e-4)
    assert_adam(two[0]["mu"], one["mu"], two[0]["model"], one["model"], EDConfig(**cfg_kw).optimizer.lr,
                one["count"], big_rel=1e-2)
    assert_running_stats(two[0]["model"], one["model"], EDConfig(**cfg_kw).optimizer.lr, one["count"])
    assert_trees_equal(two[0]["model"], two[1]["model"], "rank 0 vs rank 1")
    files = {f for _, _, fs in os.walk(tmp_path / "two") for f in fs}
    assert {"ed_epoch0002.ckpt", "ed_best.ckpt"} <= files


def test_ed_step_two_ranks_match_jax_mesh(rng):
    """One optimizer step with JAX's dropout masks: the port on two ranks
    against JAX's ``make_epoch_fns(mesh=make_mesh(2))`` and against the
    port in one process: loss and accuracy, Adam's first moments, the
    parameters and the BN statistics."""
    jcfg = JEDConfig(**ED_SMALL)
    model, jstate = _jax_ed_state(jcfg)
    x = rng.normal(size=(8, 64, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=8).astype(np.int32)
    _, k_drop = jax.random.split(jstate.rng)
    masks = _dropout_masks(model, _ed_variables(jstate), x, k_drop)
    train_epoch = jed_loop.make_epoch_fns(jcfg, model, mesh=jmesh.make_mesh(2))[0]
    jnew, metrics = jax.jit(train_epoch)(jstate, (jnp.asarray(x)[None], jnp.asarray(y)[None]))
    model_sd = {k: np.asarray(v) for k, v in weights.export_ed(_ed_variables(jstate)).items()}
    args = (ED_SMALL, model_sd, x, y.astype(np.int64), [m.numpy() for m in masks])
    two = run2(ranks.ed_step, *args)
    one = ranks.ed_step(None, *args)
    assert_scaled(two[0]["row"][0], float(metrics["loss"]), what="loss")
    assert_scaled(two[0]["row"][0], one["row"][0], what="loss")
    assert two[0]["row"][1] == float(metrics["acc"]) == one["row"][1]
    adam = jnew.opt_state.inner_state[0]
    jax_mu = weights.export_ed({"params": jax.tree_util.tree_map(np.asarray, adam.mu)})
    want = weights.export_ed(_ed_variables(jnew))
    lr = jcfg.optimizer.lr
    assert_adam(two[0]["mu"], {k: jax_mu[k] for k in two[0]["mu"]}, two[0]["model"], want, lr, 1,
                big_abs=1e-7, what="JAX ")
    assert_adam(two[0]["mu"], one["mu"], two[0]["model"], one["model"], lr, 1, big_abs=1e-7,
                what="one rank ")
    assert_running_stats(two[0]["model"], want, lr, 1)
    assert_trees_equal(two[0]["model"], two[1]["model"], "rank 0 vs rank 1")


# ---------------------------------------------------------------------------
# The population sweep
# ---------------------------------------------------------------------------


def test_sweep_sharded_over_two_ranks_equals_one_process(rng, tmp_path):
    """A 2-member sweep, one member a rank: the same report and the same
    ``sweep_state.ckpt`` and member finals, bit for bit."""
    kw = dict(TINY, save_freq=1)
    arrays = _gan_corpus(rng, 2 * 5 * 4)
    two = run2(ranks.sweep_run, kw, TINY_ED, arrays, [3, 4], str(tmp_path / "two"), 2)
    one = ranks.sweep_run(None, kw, TINY_ED, arrays, [3, 4], str(tmp_path / "one"), 2)
    assert two[1]["report"]["best_seed"] == two[0]["report"]["best_seed"] == one["report"]["best_seed"]
    for a, b in zip(two[0]["report"]["results"], one["report"]["results"]):
        assert a["curve"] == b["curve"] and a["gate_passed"] == b["gate_passed"]
    assert_trees_equal(load_checkpoint_bytes(two[0]["state"]), load_checkpoint_bytes(one["state"]))
    for (pa, a), (pb, b) in zip(sorted(two[0]["finals"].items()), sorted(one["finals"].items())):
        assert os.path.basename(os.path.dirname(pa)) == os.path.basename(os.path.dirname(pb))
        assert_trees_equal(load_checkpoint_bytes(a), load_checkpoint_bytes(b), pa)


def load_checkpoint_bytes(data: bytes):
    from melogan_torch.utils.checkpoint import msgpack_restore

    return msgpack_restore(data)


def test_sweep_mesh_errors_match_jax(rng, tmp_path):
    """K not divisible by the data axis, and halving under a mesh: JAX's
    two ValueErrors word for word; a non-Mesh raises TypeError."""
    from tests.test_torch_sweep import _cfg, _jcfg

    arrays = _gan_corpus(rng, 8)
    from melogan_tpu.data.datasets import SplitData as JSplit
    from melogan_torch.data.datasets import SplitData

    data, jdata_ = SplitData(*arrays), JSplit(*arrays)
    mesh = Mesh(data=2, group="a group")
    for kw in ({"seeds": [1, 2, 3]}, {"seeds": [1, 2], "halving": True}):
        with pytest.raises(ValueError) as ours:
            sweep.sweep_gan(_cfg(), EDConfig(**TINY_ED), data, workdir=str(tmp_path), mesh=mesh,
                            device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jsweep.sweep_gan(_jcfg(), JEDConfig(**TINY_ED), jdata_, workdir=str(tmp_path),
                             mesh=jmesh.make_mesh(2), **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError, match="Mesh"):
        sweep.sweep_gan(_cfg(), EDConfig(**TINY_ED), data, [1, 2], mesh=object(), device="cpu")


def test_trainers_take_only_a_mesh_of_ranks(tmp_path):
    """A non-Mesh raises TypeError, a local mesh of several devices
    ValueError (a trainer runs one process a device)."""
    d = _split(1, 8)
    for mesh, err in ((object(), TypeError), (make_mesh(2, device="cpu"), ValueError)):
        with pytest.raises(err):
            vae_loop.train(AEConfig(**VAE_SMALL), d, d, workdir=str(tmp_path), mesh=mesh, device="cpu")
        with pytest.raises(err):
            ed_loop.train(EDConfig(**ED_SMALL), d, d, workdir=str(tmp_path), mesh=mesh, device="cpu")
        with pytest.raises(err):
            gan_loop.train(GANConfig(**TINY), EDConfig(**TINY_ED), d, workdir=str(tmp_path), mesh=mesh,
                           device="cpu")


# ---------------------------------------------------------------------------
# Sampling over a local mesh
# ---------------------------------------------------------------------------


def test_sharded_sampler_matches_one_device():
    """``Sampler(mesh=make_mesh(2))`` over two CPU shards equals the single
    ``Sampler`` within 1e-5, at an even and an uneven batch, through
    ``sample_notes`` and ``sample_from`` and after a weight swap."""
    cfg = GANConfig(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)
    single = Sampler(cfg, seed=0, device="cpu")
    sharded = Sampler(cfg, seed=0, mesh=make_mesh(2, device="cpu"), device="cpu")
    for emotions in (["happy", "sad", "angry", "calm"] * 4, ["calm", "sad", "happy"], ["angry"]):
        np.testing.assert_allclose(sharded.sample_notes(emotions, seed=3),
                                   single.sample_notes(emotions, seed=3), atol=1e-5)
    f = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    z = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    np.testing.assert_allclose(sharded.sample_from(f, z), single.sample_from(f, z), atol=1e-5)
    donor = Sampler(cfg, seed=9, device="cpu")
    for s in (single, sharded):
        s.swap_variables(donor.generator.state_dict(), donor.feature_encoder.state_dict())
    np.testing.assert_allclose(sharded.sample_notes(["sad"] * 6, seed=1),
                               single.sample_notes(["sad"] * 6, seed=1), atol=1e-5)
    with pytest.raises(TypeError, match="Mesh"):
        Sampler(cfg, mesh=object(), device="cpu")


def test_server_with_dp_serves_from_the_sharded_sampler(tmp_path):
    """``create_server(dp=2)``: the sampler splits over two CPU shards, and
    ``/generate`` (one row, fewer than the shards) answers MIDI."""
    import threading
    import urllib.request

    from melogan_torch.serving.app import create_server

    cfg = GANConfig(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32)
    httpd, state = create_server("127.0.0.1", 0, workdir=str(tmp_path), config=cfg, device="cpu",
                                 sample_pool=False, dp=2)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert state.sampler.mesh.data == 2
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                                     data=b'{"emotion": "sad"}', headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200 and resp.read(4) == b"MThd"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        state.close()


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

TINY_YAML = {
    "ae.yaml": "latent_dim: 4\nhidden_dim: 32\nbatch_size: 8\nrecon_save_count: 0\n",
    "ed.yaml": "input_mode: notes\nnotes_hidden: 32\nmlp_hidden: [32, 16]\nbatch_size: 8\nlatent_dim: 4\n",
    "gan.yaml": ("NOISE_DIM: 16\nLATENT_DIM: 4\nGEN_HIDDEN: 32\n"
                 "BATCH_SIZE: 4\nCRITIC_ITERS: 2\nSAVE_FREQ: 2\n"),
}


def test_pipeline_dp2_runs_every_stage_and_resumes(tmp_path, capsys):
    """``pipeline --dp 2`` on two gloo ranks: the data stages, encode,
    sample and the markers on rank 0, the three trainers on both ranks;
    then ``--resume --dp 2`` skips every stage on both."""
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    for name, text in TINY_YAML.items():
        (cfg_dir / name).write_text(text)
    work = str(tmp_path / "work")
    argv = ["--device", "cpu", "pipeline", "--workdir", work, "--synthetic", "--per-emotion", "6",
            "--epochs", "2", "--skip-quality-gate", "--dp", "2",
            "--ae-config", str(cfg_dir / "ae.yaml"), "--ed-config", str(cfg_dir / "ed.yaml"),
            "--gan-config", str(cfg_dir / "gan.yaml")]
    t0 = time.monotonic()
    cli_main(argv)
    assert time.monotonic() - t0 < DEADLINE
    meta = json.load(open(os.path.join(work, "pipeline_timings.json")))
    assert [s["name"] for s in meta["stages"]] == [
        "synth-data", "preprocess", "make-splits", "split-arrays", "train-ae", "encode",
        "train-ed", "train-gan", "sample"]
    assert len([f for f in os.listdir(os.path.join(work, "generated_tests")) if f.endswith(".mid")]) == 8
    final = load_checkpoint(os.path.join(work, "experiments/gan/checkpoints/gan_final.ckpt"))
    assert "G" in final and "E_num" in final
    cli_main(argv + ["--resume"])
    meta = json.load(open(os.path.join(work, "pipeline_timings.json")))
    assert meta["resumed"] and all(s["seconds"] == 0.0 for s in meta["stages"])


def test_cli_dp_two_ranks_reports_a_failing_rank(tmp_path):
    """A rank's failure ends the run: the parent exits non-zero with the
    rank's traceback (here a missing split)."""
    with pytest.raises(SystemExit, match="a rank failed(.|\\n)*train_split.csv"):
        cli_main(["--device", "cpu", "train-ed", "--dp", "2", "--workdir", str(tmp_path),
                  "--splits-dir", str(tmp_path / "none"), "--processed-dir", str(tmp_path)])
