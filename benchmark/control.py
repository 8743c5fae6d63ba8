"""Readings that set a cell's limits: the program's numbers on many seeds
(the lower readings) beside the control's and the faults' (the upper
readings), each at the cell's own size, in one process.

    python benchmark/control.py --workload <cell> --seeds 11 12 13 ... \\
        [--control-seeds 11 12 13] [--seconds 1]

For each seed it sets the cell up as a run does, runs a short window at the
cell's load (sample cells), and prints one JSON line: the program's numbers,
and on the control seeds the numbers of the plain reference put in the
program's place one precision below the configuration's
(``control_rounding``: TF32 operands for f32, fp8 e4m3 for bf16) and, for
train cells, of the reference with half of each batch left out. A control's
or a fault's numbers are the same comparisons the run makes, with it in the
program's place. The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def sample_control(cell, mode: str) -> float:
    """The control's ``notes_err`` over the calls the cell kept."""
    import torch

    from benchmark.reference import sampling as ref_sampling

    gan = cell.config["gan"]
    params = {m: {k: v.double() if v.is_floating_point() else v for k, v in cell.weights[m].items()}
              for m in ("gen", "fe")}
    worst = 0.0
    for i, _ in cell.kept:
        idx = torch.as_tensor(cell.calls.idx(i), device=cell.device)
        ref = ref_sampling.sample_notes(params, gan, idx, cell.calls.seed(i), cell.config["reference_rounding"])
        ctl = ref_sampling.sample_notes(params, gan, idx, cell.calls.seed(i), mode)
        err = float((ctl - ref).abs().max() / ref.abs().max())
        worst = max(worst, err if math.isfinite(err) else math.inf)
    return worst


def train_side(cell, mode: str, fault=None) -> dict:
    """The reference run in the program's place: its side of ``readings``."""
    from benchmark.kinds.train import MODELS, start_params
    from benchmark.reference import train as ref_train

    inputs = cell.reference_inputs()
    p = start_params(cell.weights)
    out = ref_train.group_steps(p, cell.config["gan"], cell.config["ed"], [b for b, _ in inputs],
                                [d for _, d in inputs], mode, fault)
    side = {"metrics": out["metrics"], "critic_grad": out["critic_grad"], "gen_grad": out["gen_grad"],
            "after": {f"{m}.{k}": v.detach() for m in MODELS for k, v in p[m].items()}}
    return side


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness, traffic as traffic_gen
    from benchmark.kinds.train import readings

    manifest = harness.load_manifest()
    cell_entry, config_entry = harness.find_cell(manifest, args.workload)
    controls = set(args.seeds[:3] if args.control_seeds is None else args.control_seeds)
    for seed in args.seeds:
        t0 = time.perf_counter()
        config = harness.load_config(config_entry)
        traffic = traffic_gen.load(cell_entry["traffic"])
        kind = harness.load_kind(traffic["kind"])
        cell = kind.Cell(config, traffic, seed, args.device)
        cell.setup()
        line = {"workload": args.workload, "seed": seed}
        if traffic["kind"] == "sample":
            cell.run_window(args.seconds)
        cell.free_program()
        gc.collect()
        line["program"] = cell.check()
        if hasattr(cell, "worst"):
            line["program_worst"] = cell.worst
        if seed in controls:
            if traffic["kind"] == "sample":
                line["control"] = {"notes_err": sample_control(cell, config["control_rounding"])}
            else:
                inputs = cell.reference_inputs()
                line["control"], line["control_worst"] = readings(
                    config, cell.weights, inputs, train_side(cell, config["control_rounding"]))
                line["half_batch"], line["half_batch_worst"] = readings(
                    config, cell.weights, inputs, train_side(cell, config["reference_rounding"], "half_batch"))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
