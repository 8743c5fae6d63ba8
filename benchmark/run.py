"""The benchmark of ``melogan_torch`` on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(weights and inputs from the seed, kernels built or loaded from
``build/melogan_torch/``, every shape of the cell warmed), then either the
measured window of ``--seconds`` (``--trace 0``: the end-to-end metrics) or
the traced window (``--trace 1``: the per-layer metrics from a
``torch.profiler`` trace), then the check against the plain reference. It
prints the compared numbers with their limits as the last lines of standard
error and one JSON result as the last line of standard output. It exits
with a code other than 0, and prints no result, without a CUDA card, with
the program missing from the checkout, or when JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every cache a library might keep stays inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host's cores stay with the loop that feeds the card
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness

    cell, _ = harness.find_cell(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import melogan_torch
    except ImportError as e:
        print(f"benchmark: the program is missing from the checkout: {e}", file=sys.stderr)
        return 2
    if Path(melogan_torch.__file__).resolve().parent.parent != ROOT:
        print(f"benchmark: melogan_torch was imported from {melogan_torch.__file__}, "
              f"not from the checkout {ROOT}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the process loaded {loaded}, which the benchmark must not load", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
