"""Rank programs of ``tests/test_torch_parallel.py``.

``melogan_torch.parallel.launch.spawn`` sends a rank's function by its
import path, so these live in a module of their own that imports torch,
numpy and the port only: a spawned rank never imports JAX. Each takes the
rank's ``Mesh`` first (None: the same program in the calling process, one
device) and returns numpy arrays, so the parent can hold a world-size-2 run
against the one-device run and against JAX.
"""
import os
import time

import numpy as np
import torch

from melogan_torch.config import AEConfig, EDConfig, GANConfig
from melogan_torch.data.datasets import SplitData
from melogan_torch.models.layers import batch_norm_lc
from melogan_torch.parallel.mesh import data_parallel, shard_pytree_batch
from melogan_torch.train import ed_loop, gan_loop, gan_step, sweep, vae_loop


def _np(t):
    return t.detach().cpu().numpy().copy()


def _module_np(module):
    return {k: _np(v) for k, v in module.state_dict().items()}


def batch_norm(mesh, x, dy, weight, bias, steps):
    """``steps`` train-mode passes of one BatchNorm1d over this rank's rows
    of the global (B, L, C) batch ``x``, the backward of Σ y·dy each, then
    one in eval mode: the outputs, input and affine gradients (this rank's
    rows; the affine ones mean over the ranks, as the trainers reduce
    them), running stats and ``num_batches_tracked``."""
    bn = torch.nn.BatchNorm1d(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xs, dys = torch.from_numpy(x), torch.from_numpy(dy)
    if mesh is not None:
        xs, dys = shard_pytree_batch((xs, dys), mesh)
    out = {"y": [], "dx": [], "dw": [], "db": []}
    for _ in range(steps):
        xi = xs.clone().requires_grad_(True)
        with data_parallel(mesh):
            y = batch_norm_lc(bn.train(), xi)
        dx, dw, db = torch.autograd.grad((y * dys).sum(), (xi, bn.weight, bn.bias))
        if mesh is not None:
            mesh.all_reduce_mean_([dw, db])
        for k, v in zip(("y", "dx", "dw", "db"), (y, dx, dw, db)):
            out[k].append(_np(v))
    with data_parallel(mesh), torch.no_grad():
        out["eval"] = _np(batch_norm_lc(bn.eval(), xs))
    out.update(running_mean=_np(bn.running_mean), running_var=_np(bn.running_var),
               num_batches_tracked=int(bn.num_batches_tracked))
    return out


def gan_steps(mesh, cfg_kw, ed_kw, modules, groups, tails):
    """Group steps, then tail steps, from the module state dicts
    ``modules`` (generator, critic, feature_encoder, ed) with fresh Adams,
    each step's batches and draws global and given: (metrics, state dicts,
    Adam first moments by parameter name, the EMA stream)."""
    cfg, ed_cfg = GANConfig(**cfg_kw), EDConfig(**ed_kw)
    dev = torch.device("cpu") if mesh is None else mesh.device
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=0, device=dev)
    for name in ("generator", "critic", "feature_encoder", "ed"):
        getattr(state, name).load_state_dict({k: torch.from_numpy(v) for k, v in modules[name].items()})
    steps = gan_step.make_train_steps(cfg, mesh=mesh)
    metrics = []
    for batches, draws in groups:
        state, m = steps.group(state, batches, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    for batches, draws in tails:
        state, m = steps.tail(state, batches, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "step": state.step,
            "modules": {n: _module_np(getattr(state, n)) for n in ("generator", "critic", "feature_encoder")},
            "exp_avg": _gan_moments(state),
            "ema": None if state.ema_params is None else {k: _np(v) for k, v in state.ema_params.items()}}


def _gan_moments(state):
    """Adam's first moments of the GAN state, by ``G.``/``FE.``/``D.`` and
    parameter name."""
    moments = {}
    for opt, mods in ((state.opt_g, {"G": state.generator, "FE": state.feature_encoder}),
                      (state.opt_d, {"D": state.critic})):
        for prefix, mod in mods.items():
            for n, p in mod.named_parameters():
                moments[f"{prefix}.{n}"] = _np(opt.state[p]["exp_avg"])
    return moments


def _split(arrays):
    raw, emotions, numeric, names = arrays
    return SplitData(raw, emotions, numeric, list(names))


def gan_train(mesh, cfg_kw, ed_kw, arrays, workdir, epochs):
    """``gan_loop.train`` on the corpus ``arrays``: the final state's
    modules, Adam's moments and the history."""
    cfg, ed_cfg = GANConfig(**cfg_kw), EDConfig(**ed_kw)
    state, history = gan_loop.train(cfg, ed_cfg, _split(arrays), workdir=workdir, epochs=epochs,
                                     verbose=False, mesh=mesh, device="cpu")
    return {"modules": {n: _module_np(getattr(state, n)) for n in ("generator", "critic", "feature_encoder")},
            "exp_avg": _gan_moments(state),
            "history": history, "step": state.step}


def vae_train(mesh, cfg_kw, train_arrays, val_arrays, workdir):
    """``vae_loop.train``: the best state's model and optimizer, metrics."""
    cfg = AEConfig(**cfg_kw)
    best, metrics = vae_loop.train(cfg, _split(train_arrays), _split(val_arrays), workdir=workdir,
                                   verbose=False, recon_dumps=False, mesh=mesh, device="cpu")
    opt = best.opt.state_dict()
    return {"model": _module_np(best.model), "mu": {k: _np(v) for k, v in opt["mu"].items()},
            "count": opt["count"], "metrics": metrics}


def vae_step(mesh, cfg_kw, model_sd, x, beta, eps):
    """One ``vae_loop.train_step`` on the global batch ``x`` with the
    global ``eps``: the row, the model, Adam's first moments and the
    count."""
    cfg = AEConfig(**cfg_kw)
    dev = torch.device("cpu") if mesh is None else mesh.device
    state = vae_loop.init_state(cfg, seed=0, device=dev)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in model_sd.items()})
    row = vae_loop.train_step(state, torch.from_numpy(x), beta, cfg.free_bits,
                              cfg.kl_capacity or None, eps=torch.from_numpy(eps), mesh=mesh)
    opt = state.opt.state_dict()
    return {"row": _np(row), "model": _module_np(state.model),
            "mu": {k: _np(v) for k, v in opt["mu"].items()}, "count": opt["count"]}


def ed_train(mesh, cfg_kw, train_arrays, val_arrays, workdir):
    """``ed_loop.train``: the best state's model, Adam's first moments and
    count, the metrics."""
    cfg = EDConfig(**cfg_kw)
    best, metrics = ed_loop.train(cfg, _split(train_arrays), _split(val_arrays), workdir=workdir,
                                  verbose=False, mesh=mesh, device="cpu")
    opt = best.opt.state_dict()
    return {"model": _module_np(best.model), "mu": {k: _np(v) for k, v in opt["mu"].items()},
            "count": opt["count"], "metrics": metrics}


def ed_step(mesh, cfg_kw, model_sd, x, y, masks):
    """One ``ed_loop.train_step`` on the global batch with the global
    dropout masks: the row, the model and Adam's moments."""
    cfg = EDConfig(**cfg_kw)
    dev = torch.device("cpu") if mesh is None else mesh.device
    state = ed_loop.init_state(cfg, seed=0, device=dev)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in model_sd.items()})
    row = ed_loop.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             masks=[torch.from_numpy(m) for m in masks], mesh=mesh)
    opt = state.opt.state_dict()
    return {"row": _np(row), "model": _module_np(state.model),
            "mu": {k: _np(v) for k, v in opt["mu"].items()}}


def sweep_run(mesh, cfg_kw, ed_kw, arrays, seeds, workdir, epochs):
    """``sweep.sweep_gan`` with the population sharded over the ranks: the
    report and the bytes of every member's ``gan_final.ckpt`` and of
    ``sweep_state.ckpt``."""
    cfg, ed_cfg = GANConfig(**cfg_kw), EDConfig(**ed_kw)
    report = sweep.sweep_gan(cfg, ed_cfg, _split(arrays), seeds, workdir=workdir, epochs=epochs,
                             verbose=False, samples_per_emotion=1, mesh=mesh, device="cpu")
    if mesh is not None and not mesh.is_main:
        return {"report": report}
    files = {r["checkpoint"]: open(r["checkpoint"], "rb").read() for r in report["results"]}
    state_path = os.path.join(workdir, "experiments", "gan", "sweep", "sweep_state.ckpt")
    return {"report": report, "finals": files, "state": open(state_path, "rb").read()}


def raise_on_rank(mesh, rank):
    """Rank ``rank`` raises; the others wait in a collective for it."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    mesh.barrier()


def sleep_forever(mesh):
    time.sleep(3600)


def rows_of(mesh, n):
    """Which rows of a global batch of ``n`` this rank keeps."""
    return {"rank": mesh.rank, "rows": shard_pytree_batch(np.arange(n), mesh).tolist(), "device": str(mesh.device)}
