"""Cells of ``train`` traffic: WGAN-GP group steps, ``make_train_steps(cfg).group``
under ``precision_steps``, fed as ``train-gan`` feeds them: the corpus on the
device once (``device_gather``), each group's rows gathered there by a
permuted index, and the draws (noise, α, dropout masks) made on the device
from the seed and injected as ``GroupDraws``.

End-to-end: ``train_rows_per_s``, corpus rows consumed (group steps ×
CRITIC_ITERS × batch) over the window, the window ended by a synchronize.

``correct``: set-up builds one training state from the benchmark's weights
and drives it through its first ``checked_steps`` group steps with the
window's own call and feed (rows that all differ), then hands the same state
to the window. The plain reference follows those steps from the same
weights, rows and draws (``readings``).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from benchmark import traffic as traffic_gen
from benchmark import weights
from benchmark.kinds import Phases
from benchmark.reference import train as ref_train

NOUGHT = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's
MODELS = ("gen", "fe", "critic")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.attempted = self.failed = 0
        self.phases = Phases()

    def setup(self) -> None:
        phase = self.phases
        with phase("import"):
            from melogan_torch.config import EDConfig, GANConfig
            from melogan_torch.train import gan_step
            from melogan_torch.train.gan_loop import device_gather, precision_steps

        self._gan_step = gan_step
        gan, ed = self.config["gan"], self.config["ed"]
        precision = "bf16" if self.config["precision"] == "bf16" else None
        cfg = gan_step.precision_tuned_cfg(GANConfig(**{k.lower(): v for k, v in gan.items()}), precision)
        with phase("init_state"):
            models = gan_step.build_models(cfg, EDConfig(**ed))
            self.state = gan_step.init_state(cfg, models, seed=traffic_gen.derive(self.seed, "program"),
                                             device=self.device)
        with phase("weights"):
            self.weights = weights.make(gan, ed, traffic_gen.derive(self.seed, "weights"), self.device,
                                        {"gen": "train_start", "fe": "train_start",
                                         "critic": "train_start", "ed": "served"})
            for module, m in ((self.state.generator, "gen"), (self.state.feature_encoder, "fe"),
                              (self.state.critic, "critic"), (self.state.ed, "ed")):
                module.load_state_dict(self.weights[m], strict=True)
        self.steps = precision_steps(gan_step.make_train_steps(cfg), precision)
        with phase("corpus"):
            self.feed = traffic_gen.TrainFeed(self.traffic, gan, self.seed, self.device)
            self.gather = device_gather(self.feed.arrays(), torch.device(self.device))
        self._order = self.feed.groups()
        self._draw_rng = torch.Generator(device=self.device).manual_seed(
            traffic_gen.derive(self.seed, "train.draws"))
        self._checked_steps()

    def _draws(self):
        gan, b, dev, g = self.config["gan"], self.feed.batch, self.device, self._draw_rng
        keep = 1.0 - gan["ENCODER_DROPOUT"]

        def masks():
            return [torch.rand((b, h), generator=g, device=dev) < keep for h in gan["ENCODER_HIDDEN"]]

        critic = [self._gan_step.CriticDraws(
            noise=torch.randn((b, gan["NOISE_DIM"]), generator=g, device=dev),
            alpha=torch.rand((b, 1, 1), generator=g, device=dev), fe_masks=masks())
            for _ in range(self.feed.k)]
        gen = self._gan_step.GenDraws(noise=torch.randn((b, gan["NOISE_DIM"]), generator=g, device=dev),
                                      fe_masks=masks())
        return self._gan_step.GroupDraws(critic=critic, gen=gen)

    def _group(self):
        idx = next(self._order)
        draws = self._draws()
        self.attempted += 1
        self.state, metrics = self.steps.group(self.state, self.gather(idx), draws)
        return idx, draws, metrics

    def _checked_steps(self) -> None:
        """The first group steps, whose inputs and results the check keeps:
        each step's losses, the first critic update's gradient and the first
        generator update's (read back from the Adams' state after their first
        step), and the weights after the last checked step."""
        s = self.state
        beta1 = self.config["gan"]["BETA1"]
        critic_names = {id(p): n for n, p in s.critic.named_parameters()}
        side = {"metrics": []}

        def grab(opt, _args, _kwargs):
            if "critic_grad" not in side:
                side["critic_grad"] = {critic_names[id(p)]: st["exp_avg"] / (1.0 - beta1)
                                       for p, st in opt.state.items() if "exp_avg" in st}

        handle = s.opt_d.register_step_post_hook(grab)
        self.inputs = []
        lam = self.config["gan"]["LAMBDA_EMOTION"]
        for step in range(int(self.traffic["checked_steps"])):
            with self.phases(f"checked step {step + 1}"):
                idx, draws, m = self._group()
                _sync(self.device)
            self.inputs.append((idx, draws))
            side["metrics"].append({"loss_d_sum": float(m["loss_d_sum"]),
                                    "loss_g": float(m["loss_g_adv"]) + lam * float(m["loss_g_emo"])})
            if step == 0:
                handle.remove()
                # a leaf the optimizer kept no state for got no gradient: read it as zero
                got = side.get("critic_grad", {})
                side["critic_grad"] = {n: got.get(n, torch.zeros_like(p)) for n, p in s.critic.named_parameters()}
                side["gen_grad"] = {
                    prefix + n: (s.opt_g.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in s.opt_g.state[p]
                                 else torch.zeros_like(p))
                    for prefix, module in (("gen.", s.generator), ("fe.", s.feature_encoder))
                    for n, p in module.named_parameters()}
        side["after"] = {f"{m}.{n}": p.detach().clone()
                         for m, module in (("gen", s.generator), ("fe", s.feature_encoder), ("critic", s.critic))
                         for n, p in module.named_parameters()}
        self.side = side

    def run_window(self, seconds: float) -> Dict[str, Tuple[float, str]]:
        _sync(self.device)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._group()
            n += 1
        _sync(self.device)
        window = time.perf_counter() - t0
        return {"train_rows_per_s": (n * self.feed.k * self.feed.batch / window, "rows/s")}

    def install_spans(self, spans) -> None:
        s = self.state
        for module, name in ((s.generator, "generator"), (s.feature_encoder, "feature_encoder"),
                             (s.critic, "critic"), (s.ed, "ed")):
            spans.around(module, name)

    def run_traced(self) -> Tuple[int, int]:
        n = int(self.traffic["traced_groups"])
        for _ in range(n):
            with torch.autograd.profiler.record_function("group_step"):
                self._group()
        return n, n * self.feed.k * self.feed.batch

    def free_program(self) -> None:
        del self.state, self.steps, self.gather

    def reference_inputs(self) -> List[tuple]:
        """(batch, draws) of each checked step in float64, as the reference
        takes them."""
        out = []
        for idx, d in self.inputs:
            notes, emotion, numeric = self.feed.rows(idx)
            out.append(((notes.double(), emotion, numeric.double()),
                        {"critic": [(c.noise.double(), c.alpha.double(), list(c.fe_masks)) for c in d.critic],
                         "gen": (d.gen.noise.double(), list(d.gen.fe_masks))}))
        return out

    def check(self) -> Dict[str, float]:
        numbers, self.worst = readings(self.config, self.weights, self.reference_inputs(), self.side)
        return numbers


def start_params(w) -> Dict[str, Dict[str, torch.Tensor]]:
    """The benchmark's weights in float64, fresh copies."""
    return {m: {k: v.double() if v.is_floating_point() else v.clone() for k, v in w[m].items()}
            for m in (*MODELS, "ed")}


def readings(config: dict, w, inputs: List[tuple], side: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """The numbers compared for one side, each the worst of its ``gaps``,
    and ``critic_grad_median_gap``, the median leaf's gap of the first critic
    gradient: the worst leaf there swings with the LeakyReLU slope that
    round-off picks for a pre-activation within it of zero, the median does
    not. Returns the numbers and where each was read."""
    gaps = all_gaps(config, w, inputs, side)
    worst = {k: max(v, key=v.get) for k, v in gaps.items()}
    numbers = {k: gaps[k][worst[k]] for k in gaps}
    critic = gaps["critic_grad_gap"]
    numbers["critic_grad_median_gap"] = statistics.median(critic.values())
    worst["critic_grad_median_gap"] = f"the median of {len(critic)} leaves"
    return numbers, worst


def all_gaps(config: dict, w, inputs: List[tuple], side: dict) -> Dict[str, Dict[str, float]]:
    """The gaps of one side (the program, or a control in its place) from the
    plain reference, by step or by leaf, for each number compared:

    - ``loss_gap``: each checked step's critic loss (summed over its critic
      updates) and generator loss, |side − reference| / |reference|;
    - ``critic_grad_gap``: the first critic update's gradient, from the
      start, per leaf the gap between the two norms over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``gen_grad_gap``: the first generator update's gradient, the same way,
      against the reference's own first generator update (taken with the
      critic that the reference's own critic updates made);
    - ``change_gap``: per leaf of the generator, feature encoder and critic,
      the norm of the change after the checked steps, as the gradients are
      measured.

    Leaves whose first reference gradient is under a thousandth of the
    median leaf's are left out of the generator's gradient and of the
    change: the biases just before a train-mode BatchNorm (and the score
    head's bias, whose gradient is exactly 0), which move under Adam by
    round-off alone."""
    gan, ed, mode = config["gan"], config["ed"], config["reference_rounding"]
    batches = [b for b, _ in inputs]
    draws = [d for _, d in inputs]
    p = start_params(w)
    start = {f"{m}.{k}": v.clone() for m in MODELS for k, v in p[m].items()
             if f"{m}.{k}" in side["after"]}
    ref = ref_train.group_steps(p, gan, ed, batches, draws, mode)

    losses = {f"step {i + 1} {k}": _gap(s[k], r[k], abs(r[k]))
              for i, (s, r) in enumerate(zip(side["metrics"], ref["metrics"])) for k in ("loss_d_sum", "loss_g")}
    nought = {"critic." + n for n in _nought(ref["critic_grad"])} | _nought(ref["gen_grad"])
    ref_after = {f"{m}.{k}": v.detach() for m in MODELS for k, v in p[m].items()}
    gaps = {
        "loss_gap": losses,
        "critic_grad_gap": _leaf_gaps(side["critic_grad"], ref["critic_grad"], set()),
        "gen_grad_gap": _leaf_gaps(side["gen_grad"], ref["gen_grad"], nought),
        "change_gap": _leaf_gaps({n: side["after"][n].double() - start[n] for n in start},
                                 {n: ref_after[n] - start[n] for n in start}, nought),
    }
    return gaps


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def _nought(grads: Dict[str, torch.Tensor]) -> set:
    norms = _norms(grads)
    med = statistics.median(norms.values())
    return {n for n, g in norms.items() if g < NOUGHT * med}


def _leaf_gaps(side: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], skip: set) -> Dict[str, float]:
    """Per leaf (not in ``skip``): |‖side‖ − ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖."""
    r = {n: v for n, v in _norms(ref).items() if n not in skip}
    med = statistics.median(r.values())
    s = _norms({n: side[n] for n in r})
    return {n: _gap(s[n], r[n], max(r[n], med)) for n in r}


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _gap(prog: float, ref: float, scale: float) -> float:
    g = abs(prog - ref) / scale if scale > 0 else math.inf
    return g if math.isfinite(g) else math.inf
