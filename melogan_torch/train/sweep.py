"""The population sweep on the port: K WGAN-GP runs, gated and ranked.

Port of ``melogan_tpu/train/sweep.py``. Member ``k`` is a training state
built by ``gan_step.init_state(seed=seeds[k])``, with its own
``torch.Generator`` (noise, GP α, dropout) and its own epoch shuffles from
``np.random.default_rng(seeds[k])``, advanced as a solo
``gan_loop.train`` with ``cfg.seed = seeds[k]`` advances them. Its epochs
run ``gan_loop.run_epoch``, the loop body of that solo run, so the member
is that run. Members may also train other learning rates and loss weights
(``hyper_grid``, ``gan_step.HyperParams``).

The JAX package trains the population as one vmapped program; here the
members run one after another, each epoch on the same kernels as solo
training. The port's conv Functions call CUDA extension ops that have no
batching rule, so ``torch.func.vmap`` would either loop over the members
anyway or leave the hand-written kernels. A population axis inside the
conv core (per-member weights, one launch for K members) is kernel work
that this module does not do.

Selection gates each member's fresh samples against the golden bands
(``diagnostics/quality.py``) and ranks by files passed, then fewest
violations: WGAN critic losses are not comparable across independent
critics.

With a ``mesh`` (the ranks of ``--dp N`` or ``torchrun``) the population
is sharded in contiguous blocks: rank r trains members
[r·K/N, (r+1)·K/N), one after another, with no collective while they
train. After every chunk each member's state and curve are broadcast from
its owner, so every rank holds the whole population; rank 0 alone then
writes ``sweep_state.ckpt``, gates, ranks and writes the finals, and the
report is broadcast back.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.constants import BPM_JITTER, EMOTION_BPM
from melogan_torch.data.datasets import SplitData, epoch_group_indices
from melogan_torch.diagnostics import quality
from melogan_torch.parallel.mesh import Mesh
from melogan_torch.sampling import Sampler
from melogan_torch.train import gan_step
from melogan_torch.train.gan_loop import (_epoch_scalars, device_gather, emotion_centroids,
                                          precision_steps, run_epoch, save_gan_final)
from melogan_torch.train.harness import rank_device
from melogan_torch.utils import weights
from melogan_torch.utils.atomic import atomic_write
from melogan_torch.utils.checkpoint import load_checkpoint, save_checkpoint

# the per-epoch scalars of a sweep's history rows (the JAX sweep's keys; a
# solo ``train`` logs these and more)
HISTORY_KEYS = ("Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo", "Critic/Wasserstein",
                "Loss/Generator_FM")


def _sweep_dir(cfg: GANConfig, workdir: Optional[str]) -> str:
    base = os.path.join(workdir or ".", cfg.checkpoint_dir)
    return os.path.join(os.path.dirname(base.rstrip("/")), "sweep")


def _train_population(
    states: List[gan_step.GANTrainState],
    member_steps: List[gan_step.TrainStepFns],
    gather,
    cfg: GANConfig,
    rngs: List[np.random.Generator],
    seeds: Sequence[int],
    n_epochs: int,
    history: List[List[Dict[str, float]]],
    n_rows: int,
    verbose: bool,
    epoch_offset: int = 0,
    total_epochs: Optional[int] = None,
    save_cb=None,
    mesh: Optional[Mesh] = None,
) -> List[gan_step.GANTrainState]:
    """Run ``n_epochs`` epochs of every member in ``save_freq``-sized
    chunks (the JAX sweep's chunks; the short last chunk is not padded),
    appending one row per (member, epoch) to ``history`` and calling
    ``save_cb(done)`` after a chunk on ``MELOGAN_SWEEP_STATE_EVERY``'s
    cadence and after the last. The shuffle generators in ``rngs`` advance
    as solo runs' do, so halving rungs call this again with the same
    generators and a survivor's curve is its uninterrupted run's. With a
    ``mesh`` this rank trains its own block of members and every member is
    then taken from its owner (``_sync_members``) after each chunk."""
    owned = _owned(len(states), mesh)
    total = total_epochs if total_epochs is not None else epoch_offset + n_epochs
    epoch = 1
    while epoch <= n_epochs:
        chunk_end = min(n_epochs, ((epoch - 1) // cfg.save_freq + 1) * cfg.save_freq)
        chunk = list(range(epoch, chunk_end + 1))
        t0 = time.perf_counter()
        for k, rng in enumerate(rngs):
            if k not in owned:
                continue
            for ep in chunk:
                gi, ti = epoch_group_indices(n_rows, cfg.batch_size, cfg.critic_iters, rng)
                states[k], m, n_groups, n_steps = run_epoch(member_steps[k], states[k], gather, gi, ti)
                scalars = _epoch_scalars(m, n_groups, n_steps)
                history[k].append({"epoch": ep + epoch_offset,
                                   **{key: scalars[key] for key in HISTORY_KEYS if key in scalars}})
        _sync_members(states, history, cfg, mesh)
        dt = (time.perf_counter() - t0) / len(chunk)
        if verbose:
            last = [history[k][-1] for k in range(len(seeds))]
            print(
                f"[SWEEP epochs {chunk[0] + epoch_offset}-{chunk[-1] + epoch_offset}/{total}] "
                + " | ".join(f"s{seeds[k]}: D {last[k]['Loss/Critic']:.3f} "
                             f"G_emo {last[k]['Loss/Generator_Emo']:.3f}" for k in range(len(seeds)))
                + f" | {dt:.2f}s/epoch (population of {len(seeds)})"
            )
        if save_cb is not None:
            # the whole population's state is large: the cadence trades
            # resume granularity for wall; the last chunk always writes
            every = max(1, int(os.environ.get("MELOGAN_SWEEP_STATE_EVERY", "1")))
            chunk_no = (chunk_end + cfg.save_freq - 1) // cfg.save_freq
            if chunk_end >= n_epochs or chunk_no % every == 0:
                save_cb(epoch_offset + chunk_end)
        epoch = chunk_end + 1
    return states


def _block(k: int, ranks: int, rank: int) -> range:
    """The members rank ``rank`` of ``ranks`` trains: its contiguous block
    of the ``k``."""
    per = k // ranks
    return range(rank * per, (rank + 1) * per)


def _owned(k: int, mesh: Optional[Mesh]) -> range:
    return range(k) if mesh is None else _block(k, mesh.data, mesh.rank)


def _sync_members(states, history, cfg: GANConfig, mesh: Optional[Mesh]) -> None:
    """Every member's training state (weights, BatchNorm statistics, both
    Adams, step, EMA stream and random stream, as a periodic checkpoint
    holds them) and curve, broadcast from the rank that trains it; a no-op
    without a mesh of several ranks."""
    if mesh is None or mesh.data <= 1:
        return
    zeros = np.zeros((4, 6), np.float32)
    for src in range(mesh.data):
        mine = None
        if src == mesh.rank:
            mine = {k: (weights.export_train_payload(states[k], 0, zeros, g_ema=states[k].ema_params),
                        history[k]) for k in _block(len(states), mesh.data, src)}
        theirs = mesh.broadcast_object(mine, src)
        if src != mesh.rank:
            for k, (payload, curve) in theirs.items():
                weights.load_train_payload(states[k], payload, cfg.ema_decay)
                history[k] = curve


def sweep_gan(
    cfg: GANConfig,
    ed_cfg: EDConfig,
    train_data: SplitData,
    seeds: Sequence[int],
    latents: Optional[np.ndarray] = None,
    ed_variables: Optional[Dict] = None,
    workdir: Optional[str] = None,
    epochs: Optional[int] = None,
    verbose: bool = True,
    precision=None,
    samples_per_emotion: int = 2,
    promote_best: bool = False,
    mesh=None,
    hyper_grid: Optional[Sequence[Dict[str, float]]] = None,
    halving: bool = False,
    rung_epochs: Optional[int] = None,
    resume: bool = False,
    device="cuda",
) -> Dict:
    """Train ``len(seeds)`` WGAN-GP runs, one after another each epoch;
    gate and rank them. Returns the report that
    ``experiments/gan/sweep/sweep_report.json`` holds.

    ``hyper_grid``: one dict per seed with any of ``lr_g, lr_d, lambda_gp,
    lambda_emotion, lambda_fm``: member ``k`` then trains
    ``dataclasses.replace(cfg, **hyper_grid[k])``, and seeds may repeat.
    ``halving``: successive halving. Train the population for
    ``rung_epochs`` (default ``cfg.save_freq``), gate every member, keep
    the top half in index order (their states and shuffle streams go on,
    so their curves are their uninterrupted runs'), and repeat until one
    member remains; the winner then trains on to ``epochs``.

    Artifacts under ``<workdir>/experiments/gan/sweep/``: ``seed<S>/`` (or
    ``m<k>_seed<S>/`` with a grid) holds a member's ``gan_final.ckpt`` and
    its gate samples, ``rung<r>/m<id>_seed<S>/`` a rung's gate samples,
    ``sweep_report.json`` the curves, gate results and winner, and
    ``sweep_state.ckpt`` the whole population (the JAX sweep's layout,
    ``utils.weights.export_sweep_state``, with a JSON ``meta``), written
    after every chunk (``MELOGAN_SWEEP_STATE_EVERY`` spaces the writes;
    the last chunk always writes) and every rung. ``promote_best`` copies
    the winner's file to ``<workdir>/<cfg.checkpoint_dir>/gan_final.ckpt``.
    ``resume``: continue from ``sweep_state.ckpt``; the invocation must
    match the saved one (seeds, grid, rung shape, batch, critic_iters,
    EMA), and epochs may be extended. Each member's shuffle stream replays
    the epochs done; a port file also restores the random streams, so a
    resumed sweep repeats the sweep done in one go. A file of the JAX
    sweep restores the rest, and the members keep their seeded streams.

    As in the JAX sweep, feature matching uses the note-space targets
    only: with λ_fm > 0 and ``ed_variables`` a solo ``train`` also matches
    the ED's features, so such a member is not that solo run.
    ``precision="bf16"`` (or ``"default"``) runs every member's steps with
    bf16-rounded product operands and f32 sums, with ``fused_critic_batch``
    off (``gan_step.precision_tuned_cfg``); the gates sample in f32, as in
    the JAX sweep. A spectral-norm feature encoder or ED raises
    NotImplementedError (ROADMAP C.5). ``mesh``: the population sharded
    over the ranks of a process group (module docstring); ``len(seeds)``
    must divide by its size and ``halving`` is refused, as in the JAX
    sweep."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a melogan_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")
    cfg = gan_step.precision_tuned_cfg(cfg, precision)
    gan_step.refuse_gan_spectral_norm(cfg, ed_cfg, "sweep_gan")
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds) and hyper_grid is None:
        raise ValueError(f"duplicate seeds in {seeds}")
    hypers = None
    if hyper_grid is not None:
        if len(hyper_grid) != len(seeds):
            raise ValueError(
                f"hyper_grid has {len(hyper_grid)} entries for "
                f"{len(seeds)} seeds; they must pair 1:1"
            )
        hypers = [gan_step.HyperParams.from_config(cfg, **h) for h in hyper_grid]
    if mesh is not None and len(seeds) % mesh.shape["data"] != 0:
        raise ValueError(
            f"population ({len(seeds)}) must be divisible by the 'data' "
            f"axis size ({mesh.shape['data']}) to shard members over devices"
        )
    if halving:
        if len(seeds) < 2:
            raise ValueError("halving needs a population of at least 2")
        if mesh is not None:
            raise ValueError(
                "halving does not compose with population sharding: rung "
                "sizes K/2, K/4, … 1 cannot stay divisible by the mesh axis; "
                "run without --dp"
            )
    dev = rank_device(device, mesh)
    main = mesh is None or mesh.is_main
    verbose = verbose and main
    n_epochs = epochs or cfg.epochs
    r_epochs = (rung_epochs or cfg.save_freq) if halving else None

    sweep_dir = _sweep_dir(cfg, workdir)
    state_path = os.path.join(sweep_dir, "sweep_state.ckpt")
    # a resumed run must continue the SAME sweep, or the replayed streams
    # would diverge from the interrupted run
    fingerprint = {
        "seeds": list(seeds),
        "hypers": [h._asdict() for h in hypers] if hypers is not None else None,
        "halving": bool(halving),
        "r_epochs": r_epochs,
        "batch_size": cfg.batch_size,
        "critic_iters": cfg.critic_iters,
        "ema_decay": cfg.ema_decay,
    }

    ids = list(range(len(seeds)))  # member ids, stable across rungs
    rung = 0
    done = 0  # epochs the current population has trained
    rung_report: Optional[List[Dict]] = [] if halving else None
    raw = None
    resumed_history = None
    if resume and os.path.exists(state_path):
        try:
            raw = load_checkpoint(state_path)
            meta = json.loads(bytes(np.asarray(raw["meta"], np.uint8)).decode())
        except Exception as e:
            raise ValueError(
                f"sweep state at {state_path} is unreadable "
                f"({type(e).__name__}: {e}); delete it to restart the sweep "
                "from scratch — per-member finals and the report are "
                "unaffected"
            ) from e
        if meta["fingerprint"] != fingerprint:
            raise ValueError(
                f"sweep_state.ckpt at {state_path} belongs to a different "
                f"sweep (saved {meta['fingerprint']}, invoked {fingerprint}); "
                "delete it or rerun without resume"
            )
        seeds = [int(s) for s in meta["seeds"]]
        ids = [int(i) for i in meta["ids"]]
        rung = int(meta["rung"])
        done = int(meta["done"])
        if rung_report is not None:
            rung_report = meta["rung_report"]
        if meta["hypers"] is not None:
            hypers = [gan_step.HyperParams(**{k: float(v) for k, v in h.items()})
                      for h in meta["hypers"]]
        resumed_history = [list(h) for h in meta["history"]]
        if verbose:
            print(f"[SWEEP] resumed from {state_path}: population "
                  f"{len(seeds)} at epoch {done}" + (f", rung {rung}" if halving else ""))

    notes = train_data.notes_gan()
    emotion_idx = train_data.emotion_idx.astype(np.int64)
    numeric = train_data.numeric.astype(np.float32)
    n = notes.shape[0]
    note = gan_step.ema_horizon_note(cfg, n_epochs, n)
    if note and verbose:
        print(note)
    n_batches = n // cfg.batch_size
    if n_batches // cfg.critic_iters == 0:
        raise ValueError(
            f"corpus too small for a sweep: {n} rows yield {n_batches} batches "
            f"< critic_iters ({cfg.critic_iters}); use gan_loop.train"
        )
    if latents is None or latents.shape[0] != n:
        if latents is not None and verbose:
            print("[WARN] latent feats length mismatch; using zero latents")
        latents = np.zeros((n, cfg.latent_dim), np.float32)

    states = [
        gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=s,
                            ed_variables=ed_variables, device=dev,
                            hyper=None if hypers is None else hypers[k])
        for k, s in enumerate(seeds)
    ]
    if raw is not None:
        rng_note = weights.load_sweep_state(states, raw)
        if rng_note and verbose:
            print(f"[SWEEP] {rng_note}")
    # the conditioning centroids that sampling and gating feed the feature encoder
    emotion_features = emotion_centroids(numeric, emotion_idx)
    # note-space feature matching only, shared by every member (each
    # member's λ_fm is its own); no ED targets, as in the JAX sweep
    fm_target = None
    if cfg.lambda_fm or (hypers is not None and any(float(h.lambda_fm) for h in hypers)):
        fm_target = gan_step.fm_targets_from_data(notes, emotion_idx)
    if hypers is None:
        member_steps = [precision_steps(gan_step.make_train_steps(cfg, fm_target=fm_target),
                                        precision)] * len(seeds)
    else:
        member_steps = [precision_steps(gan_step.make_train_steps(cfg, hyper=h, fm_target=fm_target),
                                        precision) for h in hypers]
    gather = device_gather((notes, emotion_idx, latents.astype(np.float32), numeric), dev, mesh)

    # each member's epoch shuffles (the solo convention: seed = cfg.seed),
    # replayed past the epochs done (one permutation an epoch)
    rngs = [np.random.default_rng(s) for s in seeds]
    for r_ in rngs:
        for _ in range(done):
            r_.permutation(n)
    history: List[List[Dict[str, float]]] = (
        resumed_history if resumed_history is not None else [[] for _ in seeds])

    def save_state(done_now):
        """The whole sweep after a chunk or a rung: the population and the
        host meta to resume it. Reads the enclosing variables at call time,
        so the meta is the current (possibly halved) population's."""
        meta_now = {
            "version": 1,
            "fingerprint": fingerprint,
            "seeds": seeds,
            "ids": ids,
            "hypers": [h._asdict() for h in hypers] if hypers is not None else None,
            "rung": rung,
            "done": done_now,
            "rung_report": rung_report,
            "history": history,
        }
        payload = weights.export_sweep_state(states, seeds)
        # the codec has no string leaf: the JSON rides as uint8, in the same
        # atomic file as the state
        payload["meta"] = np.frombuffer(json.dumps(meta_now).encode(), np.uint8)
        save_checkpoint(state_path, payload)

    def save_state_main(done_now):
        if main:
            save_state(done_now)

    if halving:
        sampler = None
        while len(seeds) > 1:
            rung_target = (rung + 1) * r_epochs
            if done < rung_target:  # a resume may land on a rung's boundary
                states = _train_population(states, member_steps, gather, cfg, rngs, seeds,
                                           rung_target - done, history, n, verbose,
                                           epoch_offset=done, save_cb=save_state)
                done = rung_target
            rows = []
            for k in range(len(seeds)):
                out_dir = os.path.join(sweep_dir, f"rung{rung}", f"m{ids[k]}_seed{seeds[k]}")
                passed, total, violations, _, _, sampler = gate_member(
                    cfg, states[k], seeds[k], out_dir, samples_per_emotion, sampler,
                    emotion_features=emotion_features)
                rows.append({"member": ids[k], "seed": seeds[k],
                             "hyper": hypers[k]._asdict() if hypers is not None else None,
                             "gate_passed": passed, "gate_total": total,
                             "gate_violations": violations, "survived": False})
            order = sorted(range(len(seeds)),
                           key=lambda i: (-rows[i]["gate_passed"], rows[i]["gate_violations"], i))
            keep = sorted(order[: max(1, len(seeds) // 2)])
            for i in keep:
                rows[i]["survived"] = True
            rung_report.append({"rung": rung, "epochs": [done - r_epochs + 1, done], "members": rows})
            if verbose:
                kept = ", ".join(f"m{ids[i]}(s{seeds[i]})" for i in keep)
                print(f"[SWEEP rung {rung}] population {len(seeds)} -> {len(keep)}; survivors: {kept}")
            states = [states[i] for i in keep]
            member_steps = [member_steps[i] for i in keep]
            seeds = [seeds[i] for i in keep]
            rngs = [rngs[i] for i in keep]
            history = [history[i] for i in keep]
            ids = [ids[i] for i in keep]
            if hypers is not None:
                hypers = [hypers[i] for i in keep]
            rung += 1
            save_state(done)  # the survivors, before the next rung
        if done < n_epochs:  # the winner trains out the budget
            states = _train_population(states, member_steps, gather, cfg, rngs, seeds,
                                       n_epochs - done, history, n, verbose,
                                       epoch_offset=done, save_cb=save_state)
    elif done < n_epochs:
        states = _train_population(states, member_steps, gather, cfg, rngs, seeds,
                                   n_epochs - done, history, n, verbose, epoch_offset=done,
                                   total_epochs=n_epochs, save_cb=save_state_main, mesh=mesh)

    report = None
    if main:
        report = _select_and_save(cfg, states, seeds, history, workdir=workdir,
                                  samples_per_emotion=samples_per_emotion, promote_best=promote_best,
                                  verbose=verbose, hypers=hypers, emotion_features=emotion_features)
    if mesh is not None:
        report = mesh.broadcast_object(report)
    if rung_report is not None:
        report["rungs"] = rung_report
        _rewrite_report(cfg, workdir, report)
    return report


def _rewrite_report(cfg: GANConfig, workdir: Optional[str], report: Dict) -> None:
    """Write ``sweep_report.json`` again after fields are added."""
    atomic_write(os.path.join(_sweep_dir(cfg, workdir), "sweep_report.json"),
                 lambda f: json.dump(report, f, indent=2))


def gate_member(
    cfg: GANConfig,
    state: gan_step.GANTrainState,
    seed: int,
    out_dir: str,
    samples_per_emotion: int,
    sampler: Optional[Sampler],
    emotion_features=None,
):
    """Generate ``samples_per_emotion`` fresh .mid per emotion from the
    state's deployable weights (the debiased EMA generator when the run
    keeps one, else the live generator) and score them against the golden
    bands (``diagnostics.quality.gate_directory``). Tempos are jittered by
    ``BPM_JITTER`` from a numpy stream seeded with ``seed``.

    Returns ``(passed, total, violations, gen_sd, fe_sd, sampler)``: the
    sampler runs on the state's device, is built on first use and has its
    weights swapped after that."""
    gen_sd = {k: v.detach() for k, v in state.generator.state_dict().items()}
    ema = gan_step.ema_weights(state, cfg.ema_decay)
    if ema is not None:
        gen_sd.update(ema)
    fe_sd = {k: v.detach() for k, v in state.feature_encoder.state_dict().items()}
    os.makedirs(out_dir, exist_ok=True)
    if sampler is None:
        sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                          emotion_features=emotion_features, device=state.device)
    else:
        sampler.swap_variables(gen_sd, fe_sd, emotion_features=emotion_features)
    rng = np.random.default_rng(seed)
    prompts, paths, bpms = [], [], []
    for emotion in EMOTIONS:
        for i in range(1, samples_per_emotion + 1):
            prompts.append(emotion)
            paths.append(os.path.join(out_dir, f"gate_{emotion}_{i}.mid"))
            bpms.append(float(EMOTION_BPM[emotion] * (1.0 + rng.uniform(-BPM_JITTER, BPM_JITTER))))
    sampler.generate_many(prompts, paths, seed=int(rng.integers(0, 2**31)), bpms=bpms)
    gate = quality.gate_directory(out_dir)
    passed = sum(1 for f in gate["files"].values() if not f["violations"])
    violations = sum(len(f["violations"]) for f in gate["files"].values())
    return passed, len(gate["files"]), violations, gen_sd, fe_sd, sampler


def _select_and_save(
    cfg: GANConfig,
    states: Sequence[gan_step.GANTrainState],
    seeds: Sequence[int],
    history: List[List[Dict[str, float]]],
    workdir: Optional[str],
    samples_per_emotion: int,
    promote_best: bool,
    verbose: bool,
    hypers: Optional[Sequence[gan_step.HyperParams]] = None,
    emotion_features=None,
) -> Dict:
    """Gate each member's fresh samples against the golden bands; rank by
    (files passed, fewest violations, index); write each member's
    ``gan_final.ckpt`` and the report."""
    base = os.path.join(workdir or ".", cfg.checkpoint_dir)
    sweep_dir = _sweep_dir(cfg, workdir)
    os.makedirs(sweep_dir, exist_ok=True)

    sampler = None  # built once; weights swapped per member
    results = []
    for k, seed in enumerate(seeds):
        # a grid may repeat a seed: its members' directories carry the index
        label = f"seed{seed}" if hypers is None else f"m{k}_seed{seed}"
        seed_dir = os.path.join(sweep_dir, label)
        passed, gate_total, violations, _, _, sampler = gate_member(
            cfg, states[k], seed, seed_dir, samples_per_emotion, sampler,
            emotion_features=emotion_features)
        ckpt_path = os.path.join(seed_dir, "gan_final.ckpt")
        save_gan_final(ckpt_path, states[k], cfg, emotion_features)
        results.append({
            "seed": seed,
            "checkpoint": ckpt_path,
            "hyper": hypers[k]._asdict() if hypers is not None else None,
            "gate_passed": passed,
            "gate_total": gate_total,
            "gate_violations": violations,
            "final": history[k][-1] if history[k] else None,
            "curve": history[k],
        })
        if verbose:
            print(f"[SWEEP seed {seed}] gate {passed}/{gate_total} "
                  f"({violations} violations) -> {ckpt_path}")

    order = sorted(range(len(results)),
                   key=lambda i: (-results[i]["gate_passed"], results[i]["gate_violations"], i))
    best = results[order[0]]
    report = {"seeds": seeds, "results": results, "best_seed": best["seed"],
              "best_checkpoint": best["checkpoint"], "promoted": False}
    if promote_best:
        final_path = os.path.join(base, "gan_final.ckpt")
        with open(best["checkpoint"], "rb") as src:
            payload = src.read()
        atomic_write(final_path, lambda f: f.write(payload), mode="wb")
        report["promoted"] = True
        report["promoted_to"] = final_path
        if verbose:
            print(f"[SWEEP] promoted seed {best['seed']} -> {final_path}")

    report_path = os.path.join(sweep_dir, "sweep_report.json")
    atomic_write(report_path, lambda f: json.dump(report, f, indent=2))
    if verbose:
        print(f"[SWEEP] best seed {best['seed']} "
              f"(gate {best['gate_passed']}/{best['gate_total']}); report -> {report_path}")
    return report
