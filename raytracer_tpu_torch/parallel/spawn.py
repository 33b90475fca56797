"""Run a function on the ranks of a fresh process group, one spawned
process each (the way the tests, the dry run and the card's smoke run
start a mesh on one host; a deployment starts its ranks with
``python -m torch.distributed.run`` instead).

The ranks meet through a ``file://`` store in a temporary directory, never
a fixed port, so runs on one host do not collide. Each rank pins PyTorch
to one intra-op thread: the ranks share the host's cores.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world_size: int, *args, backend: str = "gloo") -> list:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    process started with the spawn method inside an initialised default
    process group of ``backend``. ``fn`` and its arguments and results
    cross processes by pickling: ``fn`` is a module-level function, the
    results tensors and plain Python values. A rank that raises ends the
    others and raises here with its traceback."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    with tempfile.TemporaryDirectory(prefix="rt_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(world_size, backend, tmp, fn,
                                             args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(_result_path(tmp, r), weights_only=True)
                for r in range(world_size)]


def _result_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"rank{rank}.pt")


def _rank_main(rank: int, world_size: int, backend: str, tmp: str, fn,
               args):
    torch.set_num_threads(1)
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world_size)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, _result_path(tmp, rank))
