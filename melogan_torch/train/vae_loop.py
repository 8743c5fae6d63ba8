"""VAE training (Stage 1) on the port: the port of
``melogan_tpu/train/vae_loop.py``.

Reference semantics (src/ae/train_ae.py): AdamW (lr 1e-4, wd 1e-5) after a
global gradient-norm clip at 1.0, the β-annealed MSE+KLD loss (β → 10 over
the warm-up epochs; a KL capacity C when ``kl_capacity`` > 0), validation at
β = 1 without free bits or capacity over full batches of
``min(batch_size, n_val)``, ReduceLROnPlateau (0.5, patience 5, min_lr
1e-6) on the validation total, early stopping, the best state on the
validation total, reconstruction MIDI dumps of up to ``recon_save_count``
fixed validation songs every ``recon_freq`` epochs, and the scalar tags
``loss/{train,val}_{total,recon,kld}``, ``lr``, ``beta``, ``epoch_seconds``.

The JAX loop runs chunks of epochs as one fused device program; the port
runs the same per-epoch body as a host loop over device steps, with one host
sync an epoch: the scheduler decisions are the same float32 arithmetic
(``harness.sched_step``), the best state is captured at the improved epoch
with that epoch's counters and post-drop learning rate, epochs after the
stop do not run, and ``ae_best.ckpt`` is written at the end of every epoch
that improved (the JAX loop writes it at the end of a fused chunk; the file
a run leaves is the same).

The optimizer is ``harness.AdamW`` with its global-norm clip at 1.0, the
arithmetic of optax's ``chain(clip_by_global_norm(1.0),
inject_hyperparams(adamw))`` in the same order. On the card the encoder's
convs and the decoder's transposed convs run the port's kernels forward,
and each conv's input gradient runs the other's kernel; on the CPU their
plain versions run.
"""
from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from melogan_torch.config import AEConfig
from melogan_torch.data.datasets import SplitData, ae_denormalize
from melogan_torch.device import resolve_device
from melogan_torch.midi.codec import save_recon_midi
from melogan_torch.models.layers import torch_default_init_
from melogan_torch.models.vae import VAE, vae_loss
from melogan_torch.train.harness import (
    AdamW,
    EarlyStopping,
    ReduceLROnPlateau,
    batch_indices,
    beta_schedule,
    capacity_schedule,
    sched_step,
    with_precision,
)
from melogan_torch.utils import weights
from melogan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from melogan_torch.utils.metrics import MetricsWriter

ENCODE_BATCH = 256  # encode_mu pads its last chunk to this, as the JAX loop does


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass
class VAETrainState:
    """The VAE, its optimizer and its random stream, on one device."""

    model: VAE
    opt: AdamW
    rng: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(cfg: AEConfig, model: VAE) -> AdamW:
    return AdamW(list(model.named_parameters()), lr=cfg.lr, weight_decay=cfg.weight_decay,
                 max_norm=1.0)


def init_state(cfg: AEConfig, seed: int = 42, device="cuda") -> VAETrainState:
    """The VAE at torch's default init drawn from ``seed``, on ``device``,
    with its optimizer and a ``torch.Generator`` seeded ``seed + 1`` for the
    reparameterisation noise. On the card TF32 is off (IEEE f32 Linears, as
    the JAX package's Precision.HIGHEST) and cuDNN deterministic."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    model = VAE.from_config(cfg)
    torch_default_init_(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    return VAETrainState(model=model, opt=make_optimizer(cfg, model),
                         rng=torch.Generator(device=dev).manual_seed(seed + 1))


def snapshot(state: VAETrainState, epoch: int, plateau: Optional[ReduceLROnPlateau] = None,
             stopper: Optional[EarlyStopping] = None) -> Dict[str, Any]:
    """Copies of everything a resume needs, as ``weights.export_vae_payload``
    writes it: the model's state dict, the optimizer's state, the random
    stream, and the two controllers' states."""
    plateau, stopper = plateau or ReduceLROnPlateau(), stopper or EarlyStopping()
    return {"epoch": epoch,
            "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "opt": state.opt.state_dict(), "rng": state.rng.get_state(),
            "plateau": plateau.state_dict(), "stopper": stopper.state_dict()}


def restore(state: VAETrainState, snap: Dict[str, Any]) -> VAETrainState:
    """A new state holding ``snap``'s model, optimizer and random stream."""
    model = copy.deepcopy(state.model)
    model.load_state_dict(snap["model"])
    opt = make_optimizer(AEConfig(), model)
    opt.load_state_dict(snap["opt"])
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(snap["rng"])
    return VAETrainState(model=model, opt=opt, rng=rng)


def train_step(state: VAETrainState, x: torch.Tensor, beta: float, free_bits: float = 0.0,
               capacity: Optional[float] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimizer step on the batch ``x`` (B, L, 4) in train mode, with
    the reparameterisation noise ``eps`` given or drawn from ``state.rng``.
    Returns the detached (total, mse, kld) as one device tensor."""
    state.model.train()
    recon, _, mu, log_var = state.model(x, eps=eps, generator=state.rng)
    total, mse, kld = vae_loss(recon, x, mu, log_var, beta, free_bits=free_bits, capacity=capacity)
    state.opt.step(torch.autograd.grad(total, state.opt.params))
    return torch.stack([total, mse, kld]).detach()


@torch.no_grad()
def eval_step(state: VAETrainState, x: torch.Tensor) -> torch.Tensor:
    """(total, mse, kld) of ``x`` in eval mode at β = 1, no free bits, no
    capacity."""
    state.model.eval()
    recon, _, mu, log_var = state.model(x)
    return torch.stack(vae_loss(recon, x, mu, log_var, beta=1.0))


def epoch_indices(n: int, batch_size: int, rng: np.random.Generator, shuffle=True) -> np.ndarray:
    """(n_batches, B) gather indices for one epoch; a split smaller than the
    batch is one whole-split batch."""
    return batch_indices(rng.permutation(n) if shuffle else np.arange(n), batch_size)


def _metrics(rows: List[torch.Tensor]) -> Dict[str, float]:
    total, recon, kld = (float(v) for v in torch.stack(rows).mean(dim=0).cpu())
    return {"total": total, "recon": recon, "kld": kld}


def train(
    cfg: AEConfig,
    train_data: SplitData,
    val_data: SplitData,
    workdir: Optional[str] = None,
    verbose: bool = True,
    recon_dumps: bool = True,
    resume: bool = False,
    mesh=None,
    precision=None,
    device="cuda",
) -> Tuple[VAETrainState, Dict[str, float]]:
    """Stage-1 training; returns (the best state, final metrics).

    Checkpoints go to ``<workdir>/<cfg.checkpoint_dir>``: ``ae_best.ckpt``
    (the JAX payload: params, batch_stats, optimizer state, epoch, best_val,
    lr, plateau and stopper, plus the port's random stream) and, at the end,
    ``ae_final.ckpt`` (the last state's params and batch_stats). Metrics go
    to ``<workdir>/<cfg.log_dir>``, reconstruction dumps to
    ``<workdir>/<cfg.recon_dir>``. ``resume=True`` restarts from
    ``ae_best.ckpt``, replaying the data order of the epochs before it; from
    a JAX file the port's random stream goes on from its seed.
    ``precision="bf16"`` (or ``"default"``): the training and validation
    steps and the reconstruction forwards run with bf16-rounded product
    operands and f32 sums (``harness.with_precision``), as the JAX loop's
    fused epoch program does; None or ``"highest"`` is IEEE f32. ``mesh`` is
    not ported yet and raises unless None."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training over a mesh is not ported yet")
    step = with_precision(train_step, precision)
    evaluate = with_precision(eval_step, precision)
    dev = resolve_device(device)
    state = init_state(cfg, seed=cfg.seed, device=dev)
    reconstruct = with_precision(lambda x: state.model(x)[0], precision)

    def under(path):
        return os.path.join(workdir, path) if workdir else path

    ckpt_dir, recon_dir = under(cfg.checkpoint_dir), under(cfg.recon_dir)
    writer = MetricsWriter(under(cfg.log_dir))
    x_train = train_data.notes_ae(cfg)
    x_val = val_data.notes_ae(cfg)
    fixed_val = x_val[: min(cfg.recon_save_count, x_val.shape[0])]
    fixed_names = val_data.filenames[: fixed_val.shape[0]]

    plateau = ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6)
    stopper = EarlyStopping(patience=cfg.early_stop_patience)
    data_rng = np.random.default_rng(cfg.seed)

    start_epoch = 1
    best_path = os.path.join(ckpt_dir, "ae_best.ckpt")
    if resume and os.path.exists(best_path):
        raw = load_checkpoint(best_path)
        epoch, note = weights.load_vae_payload(state, raw)
        start_epoch = epoch + 1
        best = float(raw.get("best_val", float("inf")))
        if "plateau" in raw:
            plateau.load_state_dict(raw["plateau"])
        else:
            plateau.best = best
        if "stopper" in raw:
            stopper.load_state_dict(raw["stopper"])
        else:
            stopper.best = best
        state.opt.lr = float(raw.get("lr", cfg.lr))
        for _ in range(start_epoch - 1):
            data_rng.permutation(x_train.shape[0])  # replay the data order
        if verbose:
            print(f"[AE] resumed from {best_path} at epoch {start_epoch}")
            if note:
                print(f"[AE] {note}")

    val_idx = torch.as_tensor(epoch_indices(x_val.shape[0], cfg.batch_size, data_rng, shuffle=False),
                              device=dev)
    x_train_dev = torch.as_tensor(x_train, device=dev)
    x_val_dev = torch.as_tensor(x_val, device=dev)
    fixed_dev = torch.as_tensor(fixed_val, device=dev)
    dumps = recon_dumps and fixed_val.shape[0] > 0

    best = snapshot(state, 0, plateau, stopper)
    history: Dict[str, float] = {}
    for ep in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        idx = torch.as_tensor(epoch_indices(x_train.shape[0], cfg.batch_size, data_rng), device=dev)
        beta = _f32(beta_schedule(ep, cfg.kld_warmup_epochs, cfg.beta))
        cap = None
        if cfg.kl_capacity > 0.0:
            cap = _f32(capacity_schedule(ep, cfg.kl_capacity, cfg.kl_capacity_epochs or cfg.epochs))
        rows = [step(state, x_train_dev[i], beta, cfg.free_bits, cap) for i in idx]
        tm = _metrics(rows)
        vm = _metrics([evaluate(state, x_val_dev[i]) for i in val_idx])
        recon = None
        if dumps and ep % cfg.recon_freq == 0:
            with torch.no_grad():
                recon = reconstruct(fixed_dev).cpu().numpy()
        lr, improved, done = sched_step(plateau, stopper, vm["total"], state.opt.lr)
        state.opt.lr = lr
        if improved:
            best = snapshot(state, ep, plateau, stopper)
        dt = time.perf_counter() - t0

        writer.add_scalars({
            "loss/train_total": tm["total"], "loss/train_recon": tm["recon"],
            "loss/train_kld": tm["kld"], "loss/val_total": vm["total"],
            "loss/val_recon": vm["recon"], "loss/val_kld": vm["kld"],
            "lr": state.opt.lr, "beta": beta, "epoch_seconds": dt,
        }, ep)
        if verbose:
            print(f"[AE epoch {ep}] train {tm['total']:.6f} (recon {tm['recon']:.6f}, "
                  f"kld {tm['kld']:.6f}) | val {vm['total']:.6f} | {dt:.2f}s")
        if recon is not None:
            for i, name in enumerate(fixed_names):
                base = os.path.splitext(os.path.basename(name))[0]
                try:
                    save_recon_midi(
                        ae_denormalize(fixed_val[i], cfg.max_start_beat, cfg.max_duration_beat),
                        ae_denormalize(recon[i], cfg.max_start_beat, cfg.max_duration_beat),
                        recon_dir, f"ep{ep}_{base}")
                except (ValueError, OSError) as e:  # fail-soft, as the reference
                    # a note before time 0 cannot be written as MIDI
                    print(f"[WARN] recon dump failed for {name}: {e}")
        if not done:
            history = {"epoch": ep, "val_total": vm["total"], "best_val": stopper.best}
        if improved:
            save_checkpoint(best_path, weights.export_vae_payload(best))
        if done:
            if verbose:
                print(f"[AE] early stop at epoch {ep} "
                      f"(no improvement {cfg.early_stop_patience} epochs)")
            break

    save_checkpoint(os.path.join(ckpt_dir, "ae_final.ckpt"),
                    weights.convert_vae({k: v.detach().cpu().numpy()
                                         for k, v in state.model.state_dict().items()}))
    writer.close()
    return restore(state, best), {"best_val": stopper.best, **history}


@torch.no_grad()
def encode_mu(model: VAE, notes_ae: np.ndarray, batch_size: int = ENCODE_BATCH) -> np.ndarray:
    """Deterministic µ latents (N, latent_dim) of AE-normalized notes
    (reference src/ae/encode.py), in eval mode on the model's device, in
    chunks of ``batch_size`` with the last one zero-padded (rows are
    independent in eval mode, so the padding changes nothing)."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    outs = []
    try:
        for i in range(0, notes_ae.shape[0], batch_size):
            chunk = np.asarray(notes_ae[i: i + batch_size], np.float32)
            k = chunk.shape[0]
            if k < batch_size:
                chunk = np.concatenate([chunk, np.zeros((batch_size - k,) + chunk.shape[1:], np.float32)])
            outs.append(model.encode_mu(torch.as_tensor(chunk, device=dev)).cpu().numpy()[:k])
    finally:
        model.train(was_training)
    return np.concatenate(outs, axis=0)
