"""The benchmark of melogan_torch: see run.py and PERF.md."""
