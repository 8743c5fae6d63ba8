"""Tensor parallelism of the port (``melogan_torch/parallel/tensor.py``) on
the CPU.

Real ranks: ``parallel.launch.spawn`` starts gloo processes that run the
programs of ``tests/torch_tp_ranks.py`` (torch and the port only) on
a ``make_mesh(model_parallel=k)`` mesh: (data 1, model 2) on two ranks and
(data 2, model 2) on four. They are held against one process and against
the JAX package's run on ``make_mesh(8, model_parallel=2)`` of the
conftest's virtual devices with a state placed by ``partition_params``,
with the same draws injected into both.

Tolerances, and why:

- The plan (which dimension of which parameter splits) equals JAX's
  ``partition_params`` exactly, on every parameter of ``GANConfig()`` at
  ``min_dim=256``: shapes only.
- The four conjugate Functions and the split layers, in float64, within
  1e-12 of their scale of one process: the only difference is the order
  of a sum over two ranks.
- The group step and tail against one process, both in float64:
  ``tests/test_torch_parallel.py``'s tolerances (Adam's first moments
  within 1e-5 of their group's largest, parameters within 2·lr per update,
  within 1e-6 where the gradient is large, metrics within 1e-4 of their
  scale). Float64, because at these shapes (4 rows, a critic scaled ×10)
  the generator's gradient jumps where an element of the critic crosses a
  LeakyReLU's kink: in one float32 process, moving the critic by 1e-7 of
  its scale moves ``decoder.pre.2.bias``'s gradient by 0.5% of the group's
  largest, and the ranks' float32 sums in another order did just that.
  Against JAX's tensor-parallel program (float32): the metrics at JAX's
  own TP test's tolerances (``tests/test_parallel.py:419-440``: rtol
  2e-3, atol 1e-4); Adam's first moments, exported through
  ``torch_interop``, within 1e-5 of their group's largest for G and FE
  (one update; read 7.8e-7 and 6.4e-7) and within 1e-4 for the critic
  (seven updates, the float32 ±lr moves of its near-zero gradients
  feeding the later ones; read 2.3e-5 at ``conv.0.bias``), its median
  leaf within 1e-5 (read 6.3e-6); the parameters within 2·lr per update,
  within 1e-6 per update where the first moment is above 1e-4 of the
  largest (read 3.3e-8, 2.4e-9 and 1.6e-6 after seven). The readings are
  the float64 port's on (1, 2) and (2, 2) ranks, alike in both; the test
  prints them. Each of these checks fails on a wrong backward of a
  conjugate Function (no sum in ``copy``, the other block in ``gather``,
  one rank's block in ``split``): moments then 0.6–1.35 of the largest.
- Replicated parameters bit-equal across the model ranks, and every
  gathered tensor bit-equal across all ranks.

At ``TINY`` shapes ``min_dim=16`` splits a leaf in each module: G's
pre-net, MLP and all three transposed convs (row: their input channels),
the FE's two hidden Linears (column, then row), the critic's three convs
(column, cuDNN pin) and both Linears (row: the (256, 256) tie and the
concat of features and embedding), the ED's two convs (column, then row,
the kernel route) and its three Linears (row).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.config import EDConfig as JEDConfig
from melogan_tpu.config import GANConfig as JGANConfig
from melogan_tpu.ops import conv as jax_conv_ops
from melogan_tpu.parallel import mesh as jmesh
from melogan_tpu.train import gan_step as jstep
from melogan_tpu.utils import torch_interop

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.parallel import distributed, launch, tensor
from melogan_torch.parallel.mesh import Mesh, make_mesh
from melogan_torch.train import gan_step
from melogan_torch.utils import weights

from tests import torch_tp_ranks as ranks
from tests.test_torch_parallel import (GRAD_REL, RANK_TIMEOUT, _group_of, _modules, assert_adam,
                                       assert_running_stats)
from tests.test_torch_train import TINY, TINY_ED, _batches, _critic_draws, _group_draws, _setup, _torch_batches

DEADLINE = 120.0  # seconds a spawned run may take before it is killed
MIN_DIM = 16  # splits a leaf of each module at TINY shapes (module docstring)
REL64 = 1e-12
EMA_DECAY = 0.9  # the EMA stream on, so its split is stepped and gathered
# Adam's first moments against JAX, of their module group's largest (module docstring)
JAX_GRAD_REL = {"G": GRAD_REL, "FE": GRAD_REL, "D": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run(fn, world, *args):
    return launch.spawn(fn, world, args=args, device="cpu", timeout=DEADLINE, rank_timeout=RANK_TIMEOUT)


def assert_close64(ours, want, what):
    ours, want = np.asarray(ours), np.asarray(want)
    assert ours.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(ours - want).max()) <= REL64 * scale, what


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_make_mesh_with_a_model_axis_matches_jax():
    """Shapes and both errors of JAX's ``make_mesh(n, model_parallel=k)``;
    a local mesh keeps one device a row of the grid (its data axis)."""
    for n, k in ((8, 2), (8, 4), (4, 2), (6, 3)):
        assert make_mesh(n, model_parallel=k, device="cpu").shape == dict(jmesh.make_mesh(n, model_parallel=k).shape)
    for fn, kw in ((make_mesh, {"device": "cpu"}), (jmesh.make_mesh, {})):
        with pytest.raises(ValueError, match="n_devices must be divisible by model_parallel"):
            fn(6, model_parallel=4, **kw)
    assert len(make_mesh(8, model_parallel=2, device="cpu").devices) == 4
    # rank r at (r // k, r % k), the place of device r in JAX's grid
    grid = jmesh.make_mesh(8, model_parallel=2).devices
    for d in range(4):
        for m in range(2):
            r = grid[d, m].id
            mesh = Mesh(data=4, model=2, rank=r)
            assert (mesh.data_rank, mesh.model_rank) == (d, m)


def test_make_multihost_mesh_in_one_process_matches_jax():
    """``tests/test_multihost.py:13-17`` on the port: the model axis given,
    the data axis the local devices over it."""
    have = len(make_mesh(device="cpu").devices)
    if have % 2:
        with pytest.raises(ValueError, match="divisible by model_parallel"):
            distributed.make_multihost_mesh(model_parallel=2, device="cpu")
        return
    mesh = distributed.make_multihost_mesh(model_parallel=2, device="cpu")
    assert mesh.shape["model"] == 2 and mesh.shape["data"] * 2 == have and mesh.group is None


def test_make_multihost_mesh_keeps_the_model_axis_within_a_host(monkeypatch):
    """In a group, the model axis must divide the ranks of one node
    (``LOCAL_WORLD_SIZE``), with JAX's message (``distributed.py:74-77``)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 6)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError) as err:
        distributed.make_multihost_mesh(model_parallel=2, device="cpu")
    assert str(err.value) == ("model_parallel=2 must divide the per-host device count 3 "
                              "(the model axis may not cross DCN)")


def test_four_ranks_take_their_grid_place_and_data_rows():
    """Four gloo ranks on ``make_multihost_mesh(model_parallel=2)``'s (2, 2)
    mesh: rank r at (r // 2, r % 2), and the rows of a global batch split
    over the data axis alone (model ranks that share a data index keep the
    same rows)."""
    out = run(ranks.coordinates, 4, 2)
    assert [(o["data_rank"], o["model_rank"]) for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["shape"] == {"data": 2, "model": 2} for o in out)
    assert [o["rows"] for o in out] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2


# ---------------------------------------------------------------------------
# The plan against JAX's partition_params
# ---------------------------------------------------------------------------


def _jax_shapes():
    cfg, ed_cfg = JGANConfig(), JEDConfig()
    models = jstep.build_models(cfg, ed_cfg)
    prev = jax_conv_ops.pallas_mode()
    jax_conv_ops.set_use_pallas("off")
    try:
        return jax.eval_shape(lambda: jstep.init_state(cfg, models, seed=0))
    finally:
        jax_conv_ops.set_use_pallas(prev)


def _marked(tree, specs):
    """Each leaf as a zero-cost array of its shape that varies along the
    dimension its spec puts on ``model`` only (a broadcast view)."""
    def mark(leaf, sharding):
        shape = tuple(leaf.shape)
        dims = [i for i, s in enumerate(sharding.spec) if s == "model"]
        if not dims:
            return np.broadcast_to(np.float32(0), shape)
        ramp = [1] * len(shape)
        ramp[dims[0]] = shape[dims[0]]
        return np.broadcast_to(np.arange(shape[dims[0]], dtype=np.float32).reshape(ramp), shape)
    return jax.tree_util.tree_map(mark, tree, specs)


def _split_dim(a):
    dims = [i for i, (n, st) in enumerate(zip(a.shape, a.strides)) if n > 1 and st != 0]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _jax_plan(shapes, model_parallel):
    """JAX's ``partition_params(min_dim=256)`` on (n, k) virtual devices, as
    the torch dimension of every parameter, through the port's bridge."""
    mesh = jmesh.make_mesh(2 * model_parallel, model_parallel=model_parallel)
    out = {}
    for key, tree, export in (("generator", shapes.gen_params, weights.export_generator),
                              ("feature_encoder", shapes.fe_params, weights.export_feature_encoder),
                              ("critic", shapes.critic_params, weights.export_critic),
                              ("ed", shapes.ed_params, weights.export_ed)):
        marked = _marked(tree, jmesh.partition_params(tree, mesh, min_dim=256))
        out.update({f"{key}.{n}": _split_dim(a) for n, a in export({"params": marked}).items()})
    return out


@pytest.fixture(scope="module")
def full_width():
    cfg, ed_cfg = GANConfig(), EDConfig()
    models = gan_step.build_models(cfg, ed_cfg)
    return {"generator": models.generator, "feature_encoder": models.feature_encoder,
            "critic": models.critic, "ed": models.ed}, _jax_shapes()


# the table of the split leaves at GANConfig(), min_dim=256, model 2, as torch dimensions
TABLE = {
    "generator.decoder.pre.0.weight": 0, "generator.decoder.pre.2.weight": 0,
    "generator.noise_to_latent.net.0.weight": 0, "generator.noise_to_latent.net.2.weight": 1,
    "generator.decoder.deconv.0.weight": 0,  # ConvTranspose1d (in, out, k): Cin, row
    "feature_encoder.net.1.weight": 0, "feature_encoder.net.4.weight": 1,
    "critic.conv.4.weight": 0, "critic.fc.1.weight": 1, "critic.real_fake.weight": 1,
    "ed.encoder.conv.2.net.0.weight": 0, "ed.encoder.conv.3.net.0.weight": 1,  # the tie: Cin
    "ed.encoder.project.weight": 1, "ed.classifier.net.0.weight": 1, "ed.classifier.net.3.weight": 1,
}


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_plan_matches_jax_partition_params_at_full_width(full_width, model_parallel):
    """Every parameter of ``GANConfig()``'s G, FE, critic and ED: the port's
    split dimension equals JAX's spec through the bridge. At 2 that is the
    table of ``TABLE`` (the (256, 256) ties split their input, as the flax
    kernel (in, out) does; four convs split, not "conv stacks stay
    replicated" as the JAX test's docstring says); at 3 no width but the
    score head's 384 inputs divides, and every other leaf replicates."""
    modules, shapes = full_width
    ours = tensor.plan(modules, model_parallel, min_dim=256)
    theirs = _jax_plan(shapes, model_parallel)
    assert set(ours) == set(theirs)
    assert ours == theirs
    split = {k: v for k, v in ours.items() if v is not None}
    if model_parallel == 2:
        assert split == TABLE
    else:
        assert split == {"critic.real_fake.weight": 1}


# ---------------------------------------------------------------------------
# The conjugate Functions and the split layers, against one process
# ---------------------------------------------------------------------------


def _one_process(op, inputs):
    """``torch_tp_ranks.functions``' quantities for two ranks computed in one
    process: a replicated input is one tensor, a rank's own one a tensor a
    rank; the loss over rank-local outputs is the sum of the ranks' losses,
    over a replicated output the one loss (and likewise for t)."""
    x, g, v = (torch.from_numpy(a) for a in inputs[op])
    local_x = ranks.OPS[op][0] == "local"
    xs = [x[r].clone().requires_grad_(True) for r in range(2)] if local_x else [x.clone().requires_grad_(True)]
    if op == "copy":
        ys = [xs[0], xs[0]]
    elif op == "split":
        ys = list(xs[0].chunk(2, dim=-1))
    elif op == "reduce":
        ys = [xs[0] + xs[1]]
    else:
        ys = [torch.cat(xs, dim=-1)]
    gs = [g[r] for r in range(2)] if len(ys) == 2 else [g]
    s = sum((torch.tanh(y) * gi).sum() for y, gi in zip(ys, gs))
    dxs = torch.autograd.grad(s, xs, create_graph=True)
    vs = [v[r] for r in range(2)] if local_x else [v]
    d2s = torch.autograd.grad(sum((d * vi).sum() for d, vi in zip(dxs, vs)), xs)
    per_rank = lambda t, r: t[r] if len(t) == 2 else t[0]  # noqa: E731
    return [{"y": per_rank(ys, r).detach().numpy(), "dx": per_rank(dxs, r).detach().numpy(),
             "d2": per_rank(d2s, r).numpy()} for r in range(2)]


@pytest.fixture(scope="module")
def function_runs():
    rng = np.random.default_rng(7)
    b, c = 3, 4
    shapes = {  # (x, g, v): the input, the output's cotangent, the input gradient's
        "copy": ((b, c), (2, b, c), (b, c)), "split": ((b, c), (2, b, c // 2), (b, c)),
        "reduce": ((2, b, c), (b, c), (2, b, c)), "gather": ((2, b, c // 2), (b, c), (2, b, c // 2))}
    inputs = {op: tuple(rng.normal(size=s) for s in shs) for op, shs in shapes.items()}
    return inputs, run(ranks.functions, 2, inputs)


@pytest.mark.parametrize("op", list(ranks.OPS))
def test_conjugate_function_forward_backward_and_double_backward(function_runs, op):
    """In float64 on two ranks: the output, the input gradient and the
    gradient of that gradient (each backward is its conjugate's apply)
    against the same composition in one process."""
    inputs, two = function_runs
    want = _one_process(op, inputs)
    for r in range(2):
        for k in ("y", "dx", "d2"):
            assert_close64(two[r][op][k], want[r][k], f"{op} rank {r} {k}")


def _layer_cases():
    rng = np.random.default_rng(11)

    def layer(kind, cin, cout, dim):
        wshape = {"linear": (cout, cin), "convt": (cin, cout, 5)}.get(kind, (cout, cin, 3))
        return (kind, cin, cout, dim, rng.normal(size=wshape) / np.sqrt(cin), rng.normal(size=cout))

    cases = {}
    for kind, dims in (("linear", (0, 1)), ("conv_native", (0, 1)), ("conv_kernel", (0, 1)),
                       ("convt", (1, 0))):
        for dim, role in zip(dims, ("column", "row")):
            x = rng.normal(size=(3, 6) if kind == "linear" else (3, 10, 6))
            spec = layer(kind, 6, 4, dim)
            y = ranks._layer(kind, 6, 4).double()
            with torch.no_grad():
                y.weight.copy_(torch.from_numpy(spec[4]))
            gshape = tuple(y(torch.from_numpy(x)).shape)
            cases[f"{kind}-{role}"] = {"layers": [spec], "x": x, "g": rng.normal(size=gshape),
                                       "twice": kind in ("linear", "conv_native"), "roles": [role]}
    # the critic's fc (column here) feeding its score head (row) through a LeakyReLU
    cases["linear-column-row"] = {"layers": [layer("linear", 6, 8, 0), layer("linear", 8, 2, 1)],
                                  "x": rng.normal(size=(3, 6)), "g": rng.normal(size=(3, 2)), "twice": True,
                                  "roles": ["column", "row"]}
    return cases


LAYER_CASES = _layer_cases()


@pytest.fixture(scope="module")
def layer_runs():
    names = list(LAYER_CASES)
    return dict(zip(names, zip(*run(ranks.layers, 2, [LAYER_CASES[n] for n in names]))))


def _whole(case):
    """The case on whole layers in one process (``torch_tp_ranks.layers``)."""
    stack = []
    for kind, cin, cout, _, w, b in case["layers"]:
        layer = ranks._layer(kind, cin, cout).double()
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(b))
        stack.append(layer)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = x
    for i, layer in enumerate(stack):
        y = layer(y) if i == 0 else layer(torch.nn.functional.leaky_relu(y, 0.2))
    params = [p for layer in stack for p in (layer.weight, layer.bias)]
    grads = torch.autograd.grad((y * torch.from_numpy(case["g"])).sum(), [x] + params,
                                create_graph=case["twice"])
    out = {"y": y.detach().numpy(), "dx": grads[0].detach().numpy(),
           "dw": [g.detach().numpy() for g in grads[1::2]], "db": [g.detach().numpy() for g in grads[2::2]]}
    if case["twice"]:
        second = torch.autograd.grad(grads[0].square().sum(), params, allow_unused=True)
        out["dw2"] = [g.numpy() for g in second[0::2]]
        out["db2"] = [None if g is None else g.numpy() for g in second[1::2]]
    return out


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_split_layer_matches_the_whole_layer(layer_runs, name):
    """A column- or row-parallel Linear, Conv1d (the cuDNN pin and the
    kernel route) and ConvTranspose1d on two ranks in float64 against the
    whole layer: the output, the input, weight (joined) and bias gradients
    on both ranks, and where the route is twice differentiable the gradient
    penalty's second derivative with respect to weight and bias (the
    critic's, through its column conv and its row Linears)."""
    case, two = LAYER_CASES[name], layer_runs[name]
    want = _whole(case)
    for r, got in enumerate(two):
        assert got["role"] == case["roles"]
        for k in ("y", "dx"):
            assert_close64(got[k], want[k], f"{name} rank {r} {k}")
        for i in range(len(case["layers"])):
            assert_close64(got["dw"][i], want["dw"][i], f"{name} rank {r} dw{i}")
            assert_close64(got["db"][i], want["db"][i], f"{name} rank {r} db{i}")
            if case["twice"]:
                assert_close64(got["dw2"][i], want["dw2"][i], f"{name} rank {r} dw2 {i}")
                if want["db2"][i] is None:
                    assert got["db2"][i] is None
                else:
                    assert_close64(got["db2"][i], want["db2"][i], f"{name} rank {r} db2 {i}")


def test_place_layer_refusals():
    """The kernel's taps never split; a spectral-norm layer and a foreign
    layer do not split; a local mesh has no model group to split over."""
    from melogan_torch.models.layers import Conv1d, Linear, SpectralNormLinear

    mesh = Mesh(data=1, model=2, rank=0, group="a group")  # no collective is called here
    with pytest.raises(ValueError, match="taps"):
        tensor.place_layer(Conv1d(4, 4, 3), 2, mesh)
    with pytest.raises(ValueError, match="spectral-norm"):
        tensor.place_layer(SpectralNormLinear(4, 4), 0, mesh)
    with pytest.raises(ValueError, match="only the port's"):
        tensor.place_layer(torch.nn.Linear(4, 4), 0, mesh)
    assert tensor.place_layer(Linear(4, 6), 0, mesh).role == "column"
    cfg = GANConfig(**TINY)
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig(**TINY_ED)), seed=0, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        tensor.place_state(state, make_mesh(4, model_parallel=2, device="cpu"), min_dim=MIN_DIM)
    assert not state.generator.decoder.deconv[0].tp  # nothing placed before the refusal


# ---------------------------------------------------------------------------
# The WGAN-GP group step and tail
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_setup():
    """JAX's state and draws (``tests/test_torch_train.py::_setup``: a
    critic away from its init, perturbed ED statistics), the port's state
    dicts from it, and JAX's group step and tail on
    ``make_mesh(8, model_parallel=2)`` with the state placed by
    ``partition_params(min_dim=MIN_DIM)``."""
    rng = np.random.default_rng(0)
    jcfg, models, jstate, _, tstate, _ = _setup(rng, False, 0.0, EMA_DECAY)
    batches = _batches(rng, jcfg, jcfg.critic_iters)
    draws = _group_draws(jcfg, models, jstate, batches)
    mesh = jmesh.make_mesh(8, model_parallel=2)

    def place(tree):
        return jax.tree_util.tree_map(jax.device_put, tree, jmesh.partition_params(tree, mesh, min_dim=MIN_DIM))

    rep = jmesh.replicated_sharding(mesh)
    placed = jstate.replace(
        gen_params=place(jstate.gen_params), fe_params=place(jstate.fe_params),
        critic_params=place(jstate.critic_params), ed_params=place(jstate.ed_params),
        opt_g=place(jstate.opt_g), opt_d=place(jstate.opt_d), ema_params=place(jstate.ema_params),
        gen_stats=jax.device_put(jstate.gen_stats, rep), ed_stats=jax.device_put(jstate.ed_stats, rep),
        rng=jax.device_put(jstate.rng, rep), step=jax.device_put(jstate.step, rep))
    jsteps = jstep.make_train_steps(jcfg, models, mesh=mesh)
    jnew, jm = jax.jit(jsteps.group)(placed, tuple(jnp.asarray(a) for a in batches))
    tail = _batches(rng, jcfg, 2)
    tail_draws, _ = _critic_draws(jcfg, models, jnew.fe_params, jnew.rng, tail[3])
    jtail, jtm = jax.jit(jsteps.tail)(jnew, tuple(jnp.asarray(a) for a in tail))
    args = (dict(TINY, ema_decay=EMA_DECAY), TINY_ED, _modules(tstate), [(_torch_batches(batches), draws)],
            [(_torch_batches(tail), tail_draws)])
    want = {"generator": torch_interop.export_generator({"params": jtail.gen_params,
                                                         "batch_stats": jtail.gen_stats}),
            "critic": torch_interop.export_critic({"params": jtail.critic_params}),
            "feature_encoder": torch_interop.export_feature_encoder({"params": jtail.fe_params})}
    gen_mu, fe_mu = jtail.opt_g[0].mu
    jax_mu = {}
    for prefix, sd in (("G", torch_interop.export_generator({"params": gen_mu, "batch_stats": jtail.gen_stats})),
                       ("FE", torch_interop.export_feature_encoder({"params": fe_mu})),
                       ("D", torch_interop.export_critic({"params": jtail.opt_d[0].mu}))):
        jax_mu.update({f"{prefix}.{k}": np.asarray(v) for k, v in sd.items()})
    one = ranks.gan_steps(None, 1, MIN_DIM, torch.float64, *args)
    jax_ema = torch_interop.export_generator({"params": jtail.ema_params, "batch_stats": jtail.gen_stats})
    return {"cfg": jcfg, "args": args, "one": one,
            "jax_mu": {k: v for k, v in jax_mu.items() if k in one["exp_avg"]},
            "jax_ema": {k: np.asarray(jax_ema[k]) for k in one["ema"]},
            "jax_metrics": [{k: float(v) for k, v in m.items()} for m in (jm, jtm)],
            "jax_modules": {n: {k: np.asarray(v) for k, v in sd.items()} for n, sd in want.items()}}


@pytest.mark.parametrize("world", [2, 4])
def test_gan_steps_split_over_model_ranks_match_one_process_and_jax(tp_setup, world):
    """One group step and a two-batch tail on (data 1, model 2) and (data 2,
    model 2) gloo ranks with the state split at ``MIN_DIM``: against the
    port in one process (the data-parallel tests' tolerances) and against JAX's
    tensor-parallel program (its TP test's); replicated parameters
    bit-equal across model ranks (``tensor.check_replicas`` ran inside), the
    gathered state bit-equal on every rank."""
    cfg, one = tp_setup["cfg"], tp_setup["one"]
    out = run(ranks.gan_steps, world, 2, MIN_DIM, torch.float64, *tp_setup["args"])
    assert [o["coords"] for o in out] == [(r // 2, r % 2) for r in range(world)]
    assert out[0]["shape"] == {"data": world // 2, "model": 2}
    split = {k for k, v in out[0]["dims"].items() if v is not None}
    assert {k.split(".", 1)[0] for k in split} == set(tensor.MODULES), split
    # replicated tensors bit-equal across the model ranks; the gathered state on every rank
    for o in out[1:]:
        if o["coords"][0] == out[0]["coords"][0]:
            for k, v in out[0]["replicated"].items():
                np.testing.assert_array_equal(o["replicated"][k], v, err_msg=k)
        for what in ("modules", "exp_avg", "exp_avg_sq", "ema"):
            for k, v in out[0][what].items():
                if isinstance(v, dict):
                    for n, a in v.items():
                        np.testing.assert_array_equal(o[what][k][n], a, err_msg=f"{k}.{n}")
                else:
                    np.testing.assert_array_equal(o[what][k], v, err_msg=k)
    got = out[0]
    assert got["step"] == one["step"] == 1
    for m, want in zip(got["metrics"], one["metrics"]):
        assert set(m) == set(want)
        for k in want:
            assert abs(m[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-30) + 1e-7, (k, m[k], want[k])
    lr = {"G": cfg.lr_g, "FE": cfg.lr_g, "D": cfg.lr_d}
    updates = {"G": 1, "FE": 1, "D": cfg.critic_iters + 2}
    module_of = {"G": "generator", "FE": "feature_encoder", "D": "critic"}

    def moments(run_, group, what="exp_avg"):
        return {n.split(".", 1)[1]: v for n, v in run_[what].items() if _group_of(n) == group}

    for group in ("G", "FE", "D"):
        big_rel = 1e-4 if updates[group] == 1 else None
        assert_adam(moments(got, group), moments(one, group), got["modules"][module_of[group]],
                    one["modules"][module_of[group]], lr[group], updates[group], big_rel=big_rel,
                    what=f"one process {group}.")
        # Adam's second moments: the squared gradients, summed in another order
        nu, want_nu = moments(got, group, "exp_avg_sq"), moments(one, group, "exp_avg_sq")
        numax = max(float(np.abs(v).max()) for v in want_nu.values())
        for n, v in want_nu.items():
            assert float(np.abs(nu[n] - v).max()) <= GRAD_REL * numax, f"one process {group}.{n} exp_avg_sq"
    for n, v in one["ema"].items():  # (1 − d) of G's parameters, within its 2·lr rule
        assert float(np.abs(got["ema"][n] - v).max()) <= 2 * cfg.lr_g * (1 + 1e-3), f"one process ema {n}"
    # against JAX's tensor-parallel program: its TP test's metric tolerances; Adam's first
    # moments (JAX_GRAD_REL) and the parameters (2·lr per update, 1e-6 per update where the
    # gradient is large) as the port's one-process tests hold JAX's single-device step
    for m, want in zip(got["metrics"], tp_setup["jax_metrics"]):
        for k in want:
            np.testing.assert_allclose(m[k], want[k], rtol=2e-3, atol=1e-4, err_msg=k)
    jax_mu = tp_setup["jax_mu"]
    for group in ("G", "FE", "D"):
        want_mu = {n.split(".", 1)[1]: v for n, v in jax_mu.items() if _group_of(n) == group}
        assert_adam(moments(got, group), want_mu, got["modules"][module_of[group]],
                    tp_setup["jax_modules"][module_of[group]], lr[group], updates[group],
                    grad_rel=JAX_GRAD_REL[group], what=f"JAX {group}.")
        gmax = max(float(np.abs(v).max()) for v in want_mu.values())
        errs = sorted(float(np.abs(moments(got, group)[n] - v).max()) / gmax for n, v in want_mu.items())
        print(f"world {world} JAX {group}: first moments of the group's largest, median leaf "
              f"{errs[len(errs) // 2]:.3e}, largest {errs[-1]:.3e}")
        assert errs[len(errs) // 2] <= GRAD_REL, f"JAX {group}: the median leaf's moment {errs[len(errs) // 2]:.3e}"
    for n, v in tp_setup["jax_ema"].items():
        assert float(np.abs(got["ema"][n] - v).max()) <= 2 * cfg.lr_g * (1 + 1e-3), f"JAX ema {n}"
    assert_running_stats(got["modules"]["generator"], tp_setup["jax_modules"]["generator"], cfg.lr_g, 1)


def test_a_whole_state_under_a_model_axis_is_the_data_parallel_run(tp_setup):
    """``make_train_steps(mesh=)`` with an unplaced state on (data 2, model
    2): every rank computes bit for bit what the rank of its data index
    computes on the data axis alone (two ranks), as JAX's trainers split
    the batch over ``data`` and replicate the state."""
    from tests import torch_dp_ranks

    four = run(ranks.whole_state, 4, 2, *tp_setup["args"])
    two = run(torch_dp_ranks.gan_steps, 2, *tp_setup["args"])
    for r, got in enumerate(four):
        want = two[r // 2]
        assert got["metrics"] == want["metrics"]
        for what in ("modules", "exp_avg"):
            for k, v in want[what].items():
                if isinstance(v, dict):
                    for n, a in v.items():
                        np.testing.assert_array_equal(got[what][k][n], a, err_msg=f"rank {r} {k}.{n}")
                else:
                    np.testing.assert_array_equal(got[what][k], v, err_msg=f"rank {r} {k}")
