"""Run a function on n ranks started here (the tests, the dry run, the chip
smoke test's ranks on one card).

:func:`run_ranks` spawns n processes, each of which starts its rank of a
process group on a file store in a fresh temporary directory (no port, so
concurrent callers never clash), calls ``fn(*args)`` and hands its result
back; the results come back in rank order.  ``fn`` must be importable by
name (a module-level function).  Under ``torchrun`` a program starts its
rank with :func:`cfd_with_cuda_tpu_torch.parallel.sharding.init_ranks`
instead.
"""

from __future__ import annotations

import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cfd_with_cuda_tpu_torch.parallel.sharding import init_ranks

__all__ = ["run_ranks"]


def _rank_main(rank, fn, n, args, backend, device, workdir, threads):
    if threads:
        torch.set_num_threads(threads)
    init_ranks(backend, init_method=f"file://{workdir}/store", rank=rank, world_size=n,
               device=device)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, n: int, args: tuple = (), *, backend: str | None = None, device=None,
              threads: int | None = 1, workdir=None) -> list:
    """``[fn(*args) on rank r for r in range(n)]``, each rank a spawned
    process of an ``n``-rank group (``backend``, ``device`` as
    :func:`init_ranks` takes them: ``device=None`` is NCCL, a card a rank,
    and raises here without a card; ``device="cuda:0"`` with
    ``backend="gloo"`` puts every rank on one card; ``device="cpu"`` runs
    gloo on the CPU).  ``threads``: each CPU rank's torch threads.  A rank
    that raises fails the call."""
    if (device is None or torch.device(device).type == "cuda") and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device is available; pass device='cpu' to run "
                           "the ranks on the CPU over gloo")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(_rank_main, args=(fn, n, args, backend, device, tmp, threads),
                           nprocs=n, join=True, start_method="spawn")
        outs = []
        for r in range(n):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    return outs
