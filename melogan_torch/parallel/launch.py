"""Starting the ranks of a data-parallel run on this machine.

``spawn(fn, world_size, args)`` runs ``fn(mesh, *args)`` in ``world_size``
processes joined in one ``torch.distributed`` group, and returns what each
rank's ``fn`` returned. The processes start with ``torch.multiprocessing``'s
``spawn`` method (CUDA does not survive a ``fork``), so ``fn`` is sent by
its import path and a child imports only its module and the port. They meet
through a ``file://`` store in a fresh temporary directory, so runs started
side by side never share a port. Each rank:

- on the card turns TF32 off and ``cudnn.deterministic`` on, as
  ``init_state`` does for one device, and takes its device
  (``mesh.local_device``: several ranks on one card share it under gloo);
  on the CPU it takes its share of the parent's torch threads;
- joins the group (NCCL on the card, gloo on the CPU, or ``backend``) with
  ``rank_timeout``, so a collective whose peer died raises instead of
  waiting for ever;
- builds ``make_mesh`` over the group and calls ``fn``.

A world of one runs in this process, which joins a group of one for the
call and leaves it after (no child to start, as ``--dp 1`` costs nothing).
A rank that raises (or exits non-zero) makes ``spawn`` kill the others and
raise ``RuntimeError`` with the traceback of every rank that failed, the
first to fail first (a peer of a dead rank fails in its next collective);
with ``timeout`` the parent also kills every rank at the deadline and
raises ``TimeoutError``. ``cli_rank`` is the
command line's rank: ``melogan_torch.cli.main`` on the same arguments,
which then joins the group instead of spawning.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from melogan_torch.parallel.distributed import DEFAULT_TIMEOUT
from melogan_torch.parallel.mesh import Mesh, local_device, make_mesh


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str, backend: str,
               device: str, threads: int, rank_timeout_s: float, out_dir: str, args) -> None:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=rank_timeout_s))
    try:
        if cuda:
            torch.cuda.set_device(local_device(device))
        try:
            result = fn(make_mesh(device=device), *args)
        except SystemExit as e:  # the command line's exits, as a failure for the parent
            if e.code not in (None, 0):
                _write_failure(out_dir, rank, f"SystemExit: {e.code}\n")
                raise
            result = None
        except Exception:
            _write_failure(out_dir, rank, traceback.format_exc())
            raise
        if result is not None:
            torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _write_failure(out_dir: str, rank: int, text: str) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
        f.write(text)


def _failures(out_dir: str, world_size: int) -> str:
    """The failed ranks' tracebacks, the first written first."""
    paths = [os.path.join(out_dir, f"rank{r}.err") for r in range(world_size)]
    found = sorted((os.path.getmtime(p), r, p) for r, p in enumerate(paths) if os.path.exists(p))
    parts = []
    for _, rank, path in found:
        with open(path) as f:
            parts.append(f"-- rank {rank}:\n{f.read()}")
    return "\n".join(parts) or "a rank ended without a traceback (killed?)"


def spawn(fn: Callable[..., Any], world_size: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None, timeout: Optional[float] = None,
          rank_timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks (module docstring);
    returns each rank's return value (moved to the CPU), by rank. ``fn``
    and ``args`` must pickle. ``timeout``: seconds before the parent kills
    every rank and raises ``TimeoutError`` (None: no deadline)."""
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    threads = max(1, torch.get_num_threads() // world_size)
    with tempfile.TemporaryDirectory(prefix="melogan_dp_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        if world_size == 1:
            _rank_main(0, fn, 1, init_method, backend, str(device), torch.get_num_threads(),
                       rank_timeout.total_seconds(), tmp, tuple(args))
            return [_result(tmp, 0)]
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, init_method, backend, str(device), threads,
                  rank_timeout.total_seconds(), tmp, tuple(args)))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None else 0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size} ranks did not finish within {timeout} s")
        except ProcessException as e:
            raise RuntimeError(f"{world_size} ranks: a rank failed\n{_failures(tmp, world_size)}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for path in ctx.error_files:  # torch's own traceback files
                if os.path.exists(path):
                    os.unlink(path)
        return [_result(tmp, rank) for rank in range(world_size)]


def _result(out_dir: str, rank: int):
    path = os.path.join(out_dir, f"rank{rank}.pt")
    return torch.load(path, map_location="cpu", weights_only=False) if os.path.exists(path) else None


def cli_rank(mesh: Mesh, argv: Sequence[str]) -> None:
    """One rank of ``python -m melogan_torch <subcommand> --dp N``."""
    from melogan_torch.cli import main

    main(list(argv))
