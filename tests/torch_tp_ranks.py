"""Rank programs of ``tests/test_torch_tensor_parallel.py``.

``melogan_torch.parallel.launch.spawn`` sends a rank's function by its
import path, so these live in a module of their own that imports torch and
the port only: a spawned rank never imports JAX. Each takes the
launcher's mesh (the group's ranks on the data axis) and builds the
tensor-parallel one it needs with ``make_mesh(model_parallel=k)``; each
returns numpy arrays, so the parent can hold the ranks against one process
and against JAX.
"""
import torch

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.models.layers import Conv1d, ConvTranspose1d, Linear
from melogan_torch.parallel import distributed, tensor
from melogan_torch.parallel.mesh import make_mesh
from melogan_torch.train import gan_step


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def coordinates(mesh, model_parallel):
    """This rank's place on the (world / k, k) mesh that
    ``make_multihost_mesh`` builds (the ranks on one host), and the rows of
    a global batch of 8 it keeps."""
    tp = distributed.make_multihost_mesh(model_parallel=model_parallel, device="cpu")
    return {"rank": tp.rank, "shape": tp.shape, "data_rank": tp.data_rank, "model_rank": tp.model_rank,
            "rows": tp.rows(torch.arange(8)).tolist()}


# the conjugate Functions: which inputs and cotangents are this rank's own
# (local) and which every rank holds alike (replicated)
OPS = {"copy": ("rep", "local"), "split": ("rep", "local"), "reduce": ("local", "rep"),
       "gather": ("local", "rep")}


def functions(mesh, inputs):
    """Each conjugate Function on a (1, world) mesh in float64: y = op(x),
    s = Σ tanh(y)·g, dx = ∂s/∂x kept differentiable, t = Σ dx·v and
    d2 = ∂t/∂x. ``inputs[op]`` holds x, g and v, each one array or one a
    rank (``OPS``)."""
    tp = make_mesh(model_parallel=mesh.data, device="cpu")
    r = tp.model_rank
    out = {}
    for op in OPS:
        x, g, v = (torch.from_numpy(a if a.ndim == 2 else a[r]) for a in inputs[op])
        x = x.clone().requires_grad_(True)
        y = getattr(tensor, op)(x, tp)
        (dx,) = torch.autograd.grad((torch.tanh(y) * g).sum(), x, create_graph=True)
        (d2,) = torch.autograd.grad((dx * v).sum(), x)
        out[op] = {"y": _np(y), "dx": _np(dx), "d2": _np(d2)}
    return out


def _layer(kind, cin, cout):
    if kind == "linear":
        return Linear(cin, cout)
    if kind == "convt":
        return ConvTranspose1d(cin, cout, 5, stride=2, padding=2, output_padding=1)
    return Conv1d(cin, cout, 3, stride=2, padding=1, native=kind == "conv_native")


def layers(mesh, cases):
    """Each case (kind, cin, cout, dim, weight, bias, x, g) on a (1, world)
    mesh in float64: the layer split along torch weight dimension ``dim``
    (``tensor.place_layer``), its output, and the gradients of Σ y·g with
    respect to x, the weight (joined) and the bias; where the route is twice
    differentiable (Linear, the cuDNN-pinned conv) also the gradients of the
    gradient penalty's form ‖∂(Σ y·g)/∂x‖² with respect to the weight and
    the bias. The last case is a column layer feeding a row one through a
    LeakyReLU, as the critic's ``fc`` meets ``real_fake``."""
    tp = make_mesh(model_parallel=mesh.data, device="cpu")
    out = []
    for case in cases:
        stack = []
        for kind, cin, cout, dim, w, b in case["layers"]:
            layer = _layer(kind, cin, cout).double()
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(w))
                layer.bias.copy_(torch.from_numpy(b))
            tensor.place_layer(layer, dim, tp)
            stack.append((layer, dim))
        x = torch.from_numpy(case["x"]).requires_grad_(True)
        y = x
        for i, (layer, _) in enumerate(stack):
            y = layer(y) if i == 0 else layer(torch.nn.functional.leaky_relu(y, 0.2))
        params = [p for layer, _ in stack for p in (layer.weight, layer.bias)]
        twice = case["twice"]
        grads = torch.autograd.grad((y * torch.from_numpy(case["g"])).sum(), [x] + params,
                                    create_graph=twice)
        rec = {"y": _np(y), "dx": _np(grads[0]), "role": [layer.tp.role for layer, _ in stack],
               "dw": [], "db": [], "dw2": [], "db2": []}
        for i, (layer, dim) in enumerate(stack):
            rec["dw"].append(_np(tensor._joined(grads[1 + 2 * i].detach(), dim, tp)))
            rec["db"].append(_np(grads[2 + 2 * i]))
        if twice:
            pen = grads[0].square().sum()
            second = torch.autograd.grad(pen, params, allow_unused=True)
            for i, (layer, dim) in enumerate(stack):
                rec["dw2"].append(_np(tensor._joined(second[2 * i].detach(), dim, tp)))
                rec["db2"].append(_np(second[2 * i + 1]))
        out.append(rec)
    return out


def _to(tree, dtype):
    """The floating tensors of a tree of batches and draws in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(t, dtype) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, dtype) for t in tree)
    return tree


# the module groups' names of tests/torch_dp_ranks.py (G and FE share opt_g, D has opt_d)
GROUP = {"generator": "G", "feature_encoder": "FE", "critic": "D"}


def gan_steps(mesh, model_parallel, min_dim, dtype, cfg_kw, ed_kw, modules, groups, tails):
    """``tests/torch_dp_ranks.py::gan_steps`` in ``dtype`` on a (world / k,
    k) mesh with the state split by ``tensor.place_state(min_dim=)`` (mesh
    None: the same program in one process, the state whole): the metrics,
    the gathered modules, Adam's moments by ``G.``/``FE.``/``D.`` and
    parameter name and the EMA stream, this rank's replicated tensors (for
    the bitwise check across model ranks) and the plan.
    ``tensor.check_replicas`` runs after the steps."""
    tp = None if mesh is None else make_mesh(model_parallel=model_parallel, device="cpu")
    cfg, ed_cfg = GANConfig(**cfg_kw), EDConfig(**ed_kw)
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=0, device="cpu")
    for name in tensor.MODULES:
        module = getattr(state, name)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in modules[name].items()})
        module.to(dtype)
    if state.ema_params is not None:
        state.ema_params = {n: e.to(dtype) for n, e in state.ema_params.items()}
    dims = {} if tp is None else tensor.place_state(state, tp, min_dim=min_dim)
    steps = gan_step.make_train_steps(cfg, mesh=tp)
    metrics = []
    for batches, draws in _to(groups, dtype):
        state, m = steps.group(state, batches, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    for batches, draws in _to(tails, dtype):
        state, m = steps.tail(state, batches, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    tensor.check_replicas(state)
    full = tensor.gather_state(state)
    replicated = {f"{key}.{n}": _np(t) for key in tensor.MODULES
                  for n, t in getattr(state, key).state_dict().items() if dims.get(f"{key}.{n}") is None}

    def grouped(moments):
        out = {}
        for k, v in moments.items():
            key, n = k.split(".", 1)
            out[f"{GROUP[key]}.{n}"] = _np(v)
        return out

    return {"metrics": metrics, "step": state.step, "dims": dims,
            "shape": None if tp is None else tp.shape,
            "coords": None if tp is None else (tp.data_rank, tp.model_rank),
            "modules": {n: {k: _np(v) for k, v in full[n].items()}
                        for n in ("generator", "critic", "feature_encoder")},
            "exp_avg": grouped(full["exp_avg"]), "exp_avg_sq": grouped(full["exp_avg_sq"]),
            "ema": None if full["ema"] is None else {k: _np(v) for k, v in full["ema"].items()},
            "replicated": replicated}


def whole_state(mesh, model_parallel, *args):
    """``tests/torch_dp_ranks.py::gan_steps`` on a (world / k, k) mesh with
    the state left whole, as JAX's trainers run under a (data, model) mesh:
    each model rank a replica of its data index."""
    from tests import torch_dp_ranks

    return torch_dp_ranks.gan_steps(make_mesh(model_parallel=model_parallel, device="cpu"), *args)
