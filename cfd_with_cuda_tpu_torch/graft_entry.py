"""Multi-device dry run of the port (counterpart of ``__graft_entry__.py``).

``dryrun_multichip(n)`` spawns n ranks (``parallel/spawn.py``) on the cards:
``device=None`` (the default) is NCCL, a card a rank, and raises without a
card; ``device="cuda:0"`` with ``backend="gloo"`` puts every rank on one card;
``device="cpu"`` runs them over gloo on the CPU, as the JAX package's dry run
runs on a virtual n-device CPU mesh.  Each rank runs one step of the JAX
package's four dry-run cases, and rank 0 prints the JAX package's lines:
the two placed by annotation on ``cavity_deck(4)`` (F32, ``shard_pad`` n, the
XLA structured path the JAX package takes on several devices; placed with
``parallel/placement.py::place``), the explicit solver and the implicit one;
and the two sharded fast-path cases on the NE27000 cavity
(``cavity_deck(30)``) with their iteration caps: the explicit solver
(``pressure_cg_maxiter`` 16) and the implicit one (``pressure_cg_maxiter``
8, ``momentum_maxiter`` 6).

    python -m cfd_with_cuda_tpu_torch.graft_entry --n 2 [--deck-n 4] [--device cpu]
    torchrun --nproc-per-node 4 -m cfd_with_cuda_tpu_torch.graft_entry --torchrun
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["dryrun_multichip"]


def _case_configs(n: int):
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    base = dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=1,
                spmd_devices=n)
    return (SolverConfig(pressure_cg_maxiter=16, pressure_warm_start=True, **base),
            SolverConfig(pressure_cg_maxiter=8, momentum_maxiter=6, **base))


def _placed_step(cls, n: int, device) -> dict:
    """One step of the JAX package's annotation-placed dry-run case
    (``__graft_entry__.py:96-128``, ``:199-225``) on this rank: the
    ``cavity_deck(4)`` solver placed over the ranks; its history row."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.parallel.placement import place
    from cfd_with_cuda_tpu_torch.parallel.sharding import make_mesh
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=1,
                       shard_pad=n, pressure_backend="xla")
    solver = cls(cavity_deck(4, viscosity=0.01, dt=0.002, t_final=1.0), cfg, device)
    place(solver, make_mesh(n))
    assert solver.xla and solver.block is not None
    _, hist = solver.run(n_steps=1)
    if not np.isfinite(hist[-1]["u_mon"]):
        raise AssertionError(f"placed {cls.__name__} step non-finite")
    return hist[-1]


def _dryrun_rank(n: int, deck_n: int, device) -> list[str]:
    """One step of each dry-run case on this rank; the lines."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver

    size = "NE27000" if deck_n == 30 else f"cavity_deck({deck_n})"
    ecfg, icfg = _case_configs(n)
    row = _placed_step(ExplicitBCHSolver, n, device)
    lines = [f"dryrun_multichip[explicit]: {n} devices OK; u_mon={row['u_mon']:+.6f} "
             f"cg_iters={int(row['cg_iters'])}"]
    solver = ExplicitBCHSolver(cavity_deck(deck_n, viscosity=0.01, dt=0.001), ecfg, device)
    assert solver.spmd_mesh is not None and solver.layout == "interleaved"
    _, hist = solver.run(n_steps=1)
    u = hist[-1]["u_mon"]
    if not np.isfinite(u):
        raise AssertionError("sharded fused explicit step non-finite")
    lines.append(f"dryrun_multichip[explicit fused sharded, {size}]: {n} devices OK; "
                 f"u_mon={u:+.2e} cg_iters={int(hist[-1]['cg_iters'])}")
    del solver
    isolver = ImplicitGQSolver(cavity_deck(deck_n, viscosity=0.01, dt=0.001), icfg, device)
    assert isolver.spmd_mesh is not None and isolver.layout == "interleaved"
    _, hist = isolver.run(n_steps=1)
    u = hist[-1]["u_mon"]
    if not np.isfinite(u):
        raise AssertionError("sharded fused implicit step non-finite")
    lines.append(f"dryrun_multichip[implicit fused sharded, {size}]: {n} devices OK; "
                 f"u_mon={u:+.2e} cg_iters={int(hist[-1]['cg_iters'])}")
    del isolver
    row = _placed_step(ImplicitGQSolver, n, device)
    lines.append(f"dryrun_multichip[implicit]: {n} devices OK; u_mon={row['u_mon']:+.6f} "
                 f"mom_iters={int(row['mom_iters'])} cg_iters={int(row['cg_iters'])}")
    return lines


def dryrun_multichip(n_devices: int, device=None, *, backend: str | None = None,
                     deck_n: int = 30) -> list[str]:
    """One step of the four dry-run cases on ``n_devices`` spawned ranks (on
    the cards unless ``device="cpu"``); prints rank 0's lines and returns
    them.  Any rank's failure raises."""
    from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks

    outs = run_ranks(_dryrun_rank, n_devices, (n_devices, deck_n, device), backend=backend,
                     device=device)
    for line in outs[0]:
        print(line, flush=True)
    return outs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="ranks to spawn")
    ap.add_argument("--deck-n", type=int, default=30, help="cavity elements per edge")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, a card a rank; the default), cuda:0 (gloo, every rank "
                    "on one card) or cpu (gloo)")
    ap.add_argument("--torchrun", action="store_true",
                    help="run as one rank of torchrun's group instead of spawning")
    args = ap.parse_args()
    device = None if args.device == "cuda" else args.device
    backend = "gloo" if args.device.startswith("cuda:") else None
    if args.torchrun:
        import torch.distributed as dist

        from cfd_with_cuda_tpu_torch.parallel.sharding import init_ranks

        mesh = init_ranks(backend, device=device)
        try:
            lines = _dryrun_rank(mesh.size, args.deck_n, device)
        finally:
            dist.destroy_process_group()
        if mesh.rank == 0:
            print("\n".join(lines), flush=True)
        return 0
    dryrun_multichip(args.n, device, backend=backend, deck_n=args.deck_n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
