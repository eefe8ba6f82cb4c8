"""Runs a function on several ranks of one machine: processes spawned by
``torch.multiprocessing`` in a gloo process group that meets through a
file.

Gloo, because NCCL refuses two ranks on one card, and gloo's all-reduce
takes CUDA tensors (it stages them through the host).  The file rendezvous
needs no TCP port, so concurrent runs cannot clash.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn: Callable, world: int, workdir: str, threads: Optional[int],
           args: tuple):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, workdir, *args,
              threads: Optional[int] = None) -> list:
    """``fn(rank, world, *args)`` on `world` spawned ranks; returns their
    results (pickled through `workdir`) in rank order.  `fn` and `args` must
    pickle (a module-level function); `threads` caps each rank's CPU
    threads."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in [workdir / "rendezvous", *workdir.glob("rank*.pkl")]:
        stale.unlink(missing_ok=True)
    mp.spawn(_entry, args=(fn, world, str(workdir), threads, args), nprocs=world, join=True)
    results = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:  # written by our ranks
            results.append(pickle.load(f))
    return results
