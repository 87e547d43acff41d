"""Starting and waiting for the ranks of one machine.

Nothing on a machine tells a program of a cluster, so the caller names the
rendezvous (``file://`` of a path, or ``tcp://localhost:<port>``), the world
size and the backend. Ranks are processes started with the spawn method,
which pickles the rank function by its module: it must live in a module
that imports neither JAX nor the JAX package. Every process group gets a
timeout, so a rank left waiting in a collective fails instead of hanging,
and a rank that fails or overruns fails the caller.
"""

from __future__ import annotations

import datetime
import time

import torch.distributed as dist
import torch.multiprocessing as mp


def init_rank(rank: int, world: int, init_method: str, backend: str = "gloo",
              timeout_s: float = 300.0) -> None:
    """Join the default process group; raises where the backend cannot
    start (nothing switches to another)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def start_ranks(fn, world: int, args: tuple = ()):
    """Start fn(rank, *args) in ``world`` spawned processes; returns the
    context for ``join_ranks``."""
    return mp.start_processes(fn, args=args, nprocs=world, join=False,
                              start_method="spawn")


def join_ranks(ctx, timeout_s: float) -> None:
    """Wait for every rank of ``ctx``. A rank's exception or non-zero exit
    is raised here (``torch.multiprocessing`` ends the others first); past
    ``timeout_s`` every rank is killed and TimeoutError raised."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(2.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def run_ranks(fn, world: int, args: tuple = (), timeout_s: float = 600.0) -> None:
    """fn(rank, *args) on ``world`` spawned ranks, waited for."""
    join_ranks(start_ranks(fn, world, args), timeout_s)
