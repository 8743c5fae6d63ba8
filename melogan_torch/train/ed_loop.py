"""Emotion-discriminator training (Stage 2) on the port: the port of
``melogan_tpu/train/ed_loop.py``.

Reference semantics (src/emotion_discriminator/train_ed.py): cross-entropy,
AdamW (lr 2e-4, betas (0.5, 0.999), no clip), ReduceLROnPlateau (0.5,
patience 5) on the validation loss, early stopping, the best state on the
validation loss (``ed_best.ckpt``), periodic ``ed_epochNNNN.ckpt`` every
``save_freq`` epochs, optional inverse-frequency weighted sampling, and the
scalar tags ``loss/{train,val}``, ``acc/{train,val}``, ``lr`` and
``epoch_seconds``. ``evaluate`` is the evaluation the reference lost
(loss, accuracy and a confusion matrix over a split).

The JAX loop runs chunks of ``save_freq`` epochs as one fused device
program; the port runs the same per-epoch body as a host loop over device
steps, with one host sync an epoch. It takes the same decisions: each
epoch's order is one numpy draw from ``default_rng(cfg.seed)`` (a weighted
``choice`` with ``use_weighted_sampler``, else a ``permutation``) cut into
``n // batch_size`` full batches (the remainder dropped), validation is the
mean of the batch means over the full batches of ``min(batch_size,
n_val)`` rows, the scheduler is the fused loop's float32 arithmetic
(``harness.sched_step``), the best state is captured at the improved epoch
with that epoch's counters and post-drop learning rate, epochs after the
stop do not run, and the state returned is the best one. ``ed_best.ckpt``
is written at the end of every epoch that improved (the JAX loop writes it
at the end of a fused chunk; the file a run leaves is the same).

On the card each of the encoder's convs runs the port's ``conv1d`` kernel
forward and its input gradient on the ``convt1d`` kernel (block 1's input
is data and takes none); the Linears stay on cuBLAS in IEEE f32.

With a data-parallel ``mesh`` (the ranks of ``--dp N`` or ``torchrun``)
each rank gathers every global batch from its own copy of the data, draws
the dropout keep masks for the global batch and keeps its rows of both;
its four BatchNorms take the global statistics, and the gradients and the
loss and accuracy of every batch are means over the ranks, so the
schedulers decide alike on every rank. A batch whose rows do not divide the
ranks runs whole on every rank. Rank 0 alone writes files.
"""
from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from melogan_torch.config import EDConfig
from melogan_torch.data.datasets import SplitData, class_balance_weights
from melogan_torch.device import resolve_device
from melogan_torch.models.ed import EmotionDiscriminator
from melogan_torch.models.layers import torch_default_init_
from melogan_torch.parallel.mesh import Mesh, data_parallel, put_replicated, shard_pytree_batch
from melogan_torch.train.gan_step import cross_entropy
from melogan_torch.train.harness import (
    AdamW,
    EarlyStopping,
    ReduceLROnPlateau,
    batch_indices,
    eval_on_shards,
    rank_device,
    rank_writer,
    refuse_spectral_norm,
    sched_step,
    with_precision,
)
from melogan_torch.utils import weights
from melogan_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint


@dataclass
class EDTrainState:
    """The ED, its optimizer and its dropout stream, on one device."""

    model: EmotionDiscriminator
    opt: AdamW
    rng: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(cfg: EDConfig, model: EmotionDiscriminator) -> AdamW:
    """optax's ``inject_hyperparams(adamw)`` of the JAX loop: no clip."""
    return AdamW(list(model.named_parameters()), lr=cfg.optimizer.lr,
                 weight_decay=cfg.optimizer.weight_decay, b1=cfg.optimizer.betas[0],
                 b2=cfg.optimizer.betas[1])


def get_lr(state: EDTrainState) -> float:
    return state.opt.lr


def set_lr(state: EDTrainState, lr: float) -> EDTrainState:
    state.opt.lr = lr
    return state


def init_state(cfg: EDConfig, model: Optional[EmotionDiscriminator] = None, seed: int = 42,
               device="cuda") -> EDTrainState:
    """``model`` (by default the ED of ``cfg`` at torch's default init drawn
    from ``seed``) on ``device`` in train mode, with its optimizer and a
    ``torch.Generator`` seeded ``seed + 1`` for the dropout masks. On the
    card TF32 is off (IEEE f32 Linears, as the JAX package's
    Precision.HIGHEST) and cuDNN deterministic."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    if model is None:
        model = EmotionDiscriminator.from_config(cfg)
        torch_default_init_(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    return EDTrainState(model=model, opt=make_optimizer(cfg, model),
                        rng=torch.Generator(device=dev).manual_seed(seed + 1))


def snapshot(state: EDTrainState, epoch: int, plateau: Optional[ReduceLROnPlateau] = None,
             stopper: Optional[EarlyStopping] = None) -> Dict[str, Any]:
    """Copies of everything a resume needs, as ``weights.export_ed_payload``
    writes it: the model's state dict, the optimizer's state, the random
    stream, and the two controllers' states."""
    plateau, stopper = plateau or ReduceLROnPlateau(), stopper or EarlyStopping()
    return {"epoch": epoch,
            "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "opt": state.opt.state_dict(), "rng": state.rng.get_state(),
            "plateau": plateau.state_dict(), "stopper": stopper.state_dict()}


def restore(state: EDTrainState, snap: Dict[str, Any]) -> EDTrainState:
    """A new state holding ``snap``'s model, optimizer and random stream."""
    model = copy.deepcopy(state.model)
    model.load_state_dict(snap["model"])
    opt = AdamW(list(model.named_parameters()), lr=state.opt.lr, weight_decay=0.0)
    opt.load_state_dict(snap["opt"])
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(snap["rng"])
    return EDTrainState(model=model, opt=opt, rng=rng)


def _loss_acc(logits: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return cross_entropy(logits, y), (logits.argmax(dim=-1) == y).float().mean()


def train_step(state: EDTrainState, x: torch.Tensor, y: torch.Tensor,
               masks: Optional[Sequence[torch.Tensor]] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One optimizer step on the batch (x, y) in train mode (BatchNorm on
    batch statistics, which advance the running ones), with the dropout
    keep ``masks`` given or drawn from ``state.rng``. Returns the detached
    (loss, accuracy) as one device tensor. With a ``mesh`` that splits the
    batch, the batch and the masks are global and this rank takes its rows
    (module docstring); the row returned is then the mean over the ranks,
    reduced with the gradients in one ``all_reduce``."""
    state.model.train()
    b = x.shape[0]
    dp = mesh if mesh is not None and mesh.splits(b) else None
    if dp is not None:
        if masks is None:
            masks = state.model.classifier.draw_masks(b, state.rng)
        x, y, masks = shard_pytree_batch((x, y, list(masks)), dp)
    with data_parallel(dp):
        loss, acc = _loss_acc(state.model(x, generator=state.rng, masks=masks), y)
        grads = torch.autograd.grad(loss, state.opt.params)
    row = torch.stack([loss, acc]).detach()
    if dp is not None:
        dp.all_reduce_mean_(list(grads) + [row])
    state.opt.step(grads)
    return row


@torch.no_grad()
def eval_step(state: EDTrainState, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(loss, accuracy) of the batch in eval mode (running statistics, no
    dropout)."""
    state.model.eval()
    return torch.stack(_loss_acc(state.model(x), y))


def _inputs(cfg: EDConfig, data: SplitData, latents: Optional[np.ndarray]) -> np.ndarray:
    """Latent mode: the encoder latents. Notes mode: the GAN-normalized
    layout by default (in-domain for the GAN's emotion loss), the raw notes
    with ``notes_domain: raw`` (the reference's training)."""
    if cfg.input_mode == "latent":
        if latents is None:
            raise ValueError("latent mode requires encoder_feats latents")
        return latents.astype(np.float32)
    if getattr(cfg, "notes_domain", "normalized") == "raw":
        return data.notes_raw.astype(np.float32)
    return data.notes_gan()


def epoch_order(n: int, rng: np.random.Generator, weights_: Optional[np.ndarray]) -> np.ndarray:
    """One epoch's row order: a weighted draw with replacement under the
    weighted sampler, else a permutation (one draw of ``rng`` either way)."""
    if weights_ is not None:
        return rng.choice(n, size=n, replace=True, p=weights_ / weights_.sum())
    return rng.permutation(n)


def _means(rows: List[torch.Tensor]) -> Tuple[float, float]:
    loss, acc = (float(v) for v in torch.stack(rows).mean(dim=0).cpu())
    return loss, acc


def train(
    cfg: EDConfig,
    train_data: SplitData,
    val_data: SplitData,
    train_latents: Optional[np.ndarray] = None,
    val_latents: Optional[np.ndarray] = None,
    workdir: Optional[str] = None,
    verbose: bool = True,
    resume: bool = False,
    mesh=None,
    precision=None,
    device="cuda",
) -> Tuple[EDTrainState, Dict[str, float]]:
    """Stage-2 training; returns (the best state, ``{epoch, val_loss,
    val_acc}`` of the best epoch this run found, empty when none improved).

    Checkpoints go to ``<workdir>/<cfg.checkpoint_dir>`` in the JAX payload
    (params, batch_stats, the ``inject_hyperparams(adamw)`` state, epoch,
    lr, plateau and stopper, plus the port's random stream and BatchNorm
    counters): ``ed_epochNNNN.ckpt`` at every epoch that ran and is a
    multiple of ``cfg.save_freq`` (a stop epoch included) and
    ``ed_best.ckpt``. Metrics go to ``<workdir>/<cfg.log_dir>``.
    ``resume=True`` restarts from the newest ``ed_epochNNNN.ckpt``,
    replaying one data-order draw for each finished epoch; the best then
    starts at the resumed state, with the stopper's best from the file. From
    a JAX file the port's random stream goes on from its seed.
    ``precision="bf16"`` (or ``"default"``): the training and validation
    steps run with bf16-rounded product operands and f32 sums
    (``harness.with_precision``); None or ``"highest"`` is IEEE f32. A
    spectral-norm classifier raises NotImplementedError, as the JAX trainer
    cannot train one (ROADMAP C.5). ``mesh``: data parallelism over the
    ranks of a process group (module docstring); ``device`` is then each
    rank's own."""
    step = with_precision(train_step, precision)
    evaluate = with_precision(eval_step, precision)
    refuse_spectral_norm("ed_loop.train", ["use_spectral_norm"] if cfg.use_spectral_norm else [])
    dev = rank_device(device, mesh)
    main = mesh is None or mesh.is_main
    verbose = verbose and main
    state = init_state(cfg, seed=cfg.seed, device=dev)

    def under(path):
        return os.path.join(workdir, path) if workdir else path

    ckpt_dir = under(cfg.checkpoint_dir)
    writer = rank_writer(under(cfg.log_dir), mesh)
    x_train = _inputs(cfg, train_data, train_latents)
    y_train = train_data.emotion_idx.astype(np.int64)
    x_val = _inputs(cfg, val_data, val_latents)
    y_val = val_data.emotion_idx.astype(np.int64)
    n = len(y_train)
    class_weights = class_balance_weights(y_train) if cfg.use_weighted_sampler else None
    data_rng = np.random.default_rng(cfg.seed)
    plateau = ReduceLROnPlateau(factor=cfg.scheduler.factor, patience=cfg.scheduler.patience,
                                threshold=cfg.scheduler.threshold)
    stopper = EarlyStopping(patience=cfg.early_stopping_patience)

    start_epoch = 1
    if resume:
        latest = latest_checkpoint(ckpt_dir, "ed_epoch")
        if latest:
            raw = load_checkpoint(latest)
            epoch, note = weights.load_ed_payload(state, raw)
            if "lr" in raw:
                state.opt.lr = float(raw["lr"])
            if "plateau" in raw:
                plateau.load_state_dict(raw["plateau"])
            if "stopper" in raw:
                stopper.load_state_dict(raw["stopper"])
            start_epoch = epoch + 1
            for _ in range(start_epoch - 1):
                epoch_order(n, data_rng, class_weights)  # replay the data order
            if verbose:
                print(f"[ED] resumed from {latest} at epoch {start_epoch}")
                if note:
                    print(f"[ED] {note}")

    x_train_dev, y_train_dev, x_val_dev, y_val_dev = put_replicated((x_train, y_train, x_val, y_val), mesh, dev)
    val_idx = torch.as_tensor(batch_indices(np.arange(len(y_val)), cfg.batch_size), device=dev)

    best = snapshot(state, 0, plateau, stopper)
    best_metrics: Dict[str, float] = {}
    for ep in range(start_epoch, cfg.num_epochs + 1):
        t0 = time.perf_counter()
        idx = torch.as_tensor(batch_indices(epoch_order(n, data_rng, class_weights), cfg.batch_size),
                              device=dev)
        train_loss, train_acc = _means([step(state, x_train_dev[i], y_train_dev[i], mesh=mesh)
                                        for i in idx])
        val_loss, val_acc = _means([eval_on_shards(evaluate, state, mesh, x_val_dev[i], y_val_dev[i])
                                    for i in val_idx])
        state.model.train()  # the state returned trains on, as it left the last step
        lr, improved, done = sched_step(plateau, stopper, val_loss, state.opt.lr)
        state.opt.lr = lr
        if improved:
            best = snapshot(state, ep, plateau, stopper)
            best_metrics = {"epoch": ep, "val_loss": stopper.best, "val_acc": val_acc}
        dt = time.perf_counter() - t0
        writer.add_scalars({"loss/train": train_loss, "acc/train": train_acc, "loss/val": val_loss,
                            "acc/val": val_acc, "lr": lr, "epoch_seconds": dt}, ep)
        if verbose:
            print(f"[ED epoch {ep}] train loss {train_loss:.4f} acc {train_acc:.3f} | "
                  f"val loss {val_loss:.4f} acc {val_acc:.3f} | {dt:.2f}s")
        if ep % cfg.save_freq == 0 and main:
            save_checkpoint(os.path.join(ckpt_dir, f"ed_epoch{ep:04d}.ckpt"),
                            weights.export_ed_payload(snapshot(state, ep, plateau, stopper)))
        if improved and main:
            save_checkpoint(os.path.join(ckpt_dir, "ed_best.ckpt"), weights.export_ed_payload(best))
        if done:
            if verbose:
                print(f"[ED] early stop at epoch {ep}")
            break
    writer.close()
    if mesh is not None:
        mesh.check_replicas(list(state.model.state_dict().values()), "ED weights")
        mesh.barrier()  # the files exist when train returns on any rank
    return restore(state, best), best_metrics


@torch.no_grad()
def logits_of(state: EDTrainState, x: np.ndarray) -> np.ndarray:
    """Eval-mode logits of ``x`` in one pass on the state's device; the
    model's mode is restored."""
    was = state.model.training
    state.model.eval()
    try:
        return state.model(torch.as_tensor(np.asarray(x, np.float32), device=state.device)).cpu().numpy()
    finally:
        state.model.train(was)


def confusion_matrix(labels: np.ndarray, pred: np.ndarray, n_classes: int) -> np.ndarray:
    confusion = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(labels, pred):
        confusion[int(t), int(p)] += 1
    return confusion


def evaluate(cfg: EDConfig, state: EDTrainState, data: SplitData,
             latents: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Loss, accuracy, the per-class confusion matrix (rows true, columns
    predicted) and ``n`` over a split, from one eval-mode pass."""
    y = data.emotion_idx.astype(np.int64)
    logits = logits_of(state, _inputs(cfg, data, latents))
    pred = logits.argmax(-1)
    loss = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(y)))
    return {"loss": loss, "accuracy": float((pred == y).mean()),
            "confusion": confusion_matrix(y, pred, cfg.n_classes).tolist(), "n": len(y)}
