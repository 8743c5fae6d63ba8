"""Artifact cleaner (reference bulk_delete.py capability): removes generated
training/experiment artifacts with dry-run, confirmation, and a deletion log.
Targets are explicit path globs relative to a workdir — never source files.
The port's copy of ``melogan_tpu/utils/cleaner.py`` (the standard library only)."""
from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Dict, List, Sequence

DEFAULT_TARGETS = (
    "experiments/ae",
    "experiments/gan",
    "data/experiments/ed",
    "data/models/ae",
    "data/models/ed",
    "generated_tests",
    "data/splits/*/encoder_feats.npy",
    "data/splits/*/auto_filtered_*.csv",
    # pipeline --resume completion markers: stale markers after an artifact
    # clean would claim stages are done whose outputs were just deleted
    ".pipeline_done",
)


def plan(workdir: str, targets: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    found: List[str] = []
    for t in targets:
        for path in sorted(glob.glob(os.path.join(workdir, t))):
            if os.path.exists(path):
                found.append(path)
    return found


def bulk_delete(
    workdir: str,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dry_run: bool = True,
    confirm: bool = False,
    log_path: str = "bulk_delete_log.jsonl",
) -> Dict:
    """Delete artifact paths. ``dry_run`` lists only; ``confirm`` must be True
    for actual deletion. Every deletion is journaled."""
    paths = plan(workdir, targets)
    report = {"planned": paths, "deleted": [], "dry_run": dry_run}
    if dry_run or not confirm:
        return report
    log_file = os.path.join(workdir, log_path)
    with open(log_file, "a") as log:
        for path in paths:
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.unlink(path)
                report["deleted"].append(path)
                log.write(json.dumps({"path": path, "time": time.time()}) + "\n")
            except OSError as e:
                report.setdefault("errors", []).append({"path": path, "error": str(e)})
    return report
