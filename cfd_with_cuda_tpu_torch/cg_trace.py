"""Where the pressure CG of an implicit step crosses its bound, kernel
against plain version.

    python -m cfd_with_cuda_tpu_torch.cg_trace                  # NE27000 cavity
    python -m cfd_with_cuda_tpu_torch.cg_trace --deck-n 4 --from-rest 5 --steps 2 --from-k 4 --to-k 40
    python -m cfd_with_cuda_tpu_torch.cg_trace --deck-n 44 --policy f32 \
        --from-rest 20 --steps 3 --from-k 196 --to-k 340     # NE85184, F32 steps

The per-iteration CG looks at ||r|| once per group of ``unroll``
iterations and stops at the first group with ||r|| <= tol ||b||.  Where
||r|| runs flat across the bound, rounding alone moves that group.  This
script shows how flat: it runs the implicit GQ solver ``--from-rest``
steps (F32), then ``--steps`` steps under MIXED (``--policy f32``: F32) on
the kernel path (``--path plain``: the plain path), keeps
each step's pressure system (b, x0), and for both dot modes prints
||r|| / (tol ||b||) after k = from-k, from-k + unroll, ..., to-k iterations
of the kernels (``fused_cg``) and of the plain version
(``fused_cg_plain``) on that same system, each obtained as the residual of
a solve with ``tol=0, maxiter=k``.  The deck's dt is the bench matrix's for
``--deck-n`` (``profile_step.BENCH_DT``: 5e-4 at 44).  One JSON line per
step, then the card's name and power limit.  Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg, fused_cg_plain
from cfd_with_cuda_tpu_torch.profile_step import BENCH_DT
from cfd_with_cuda_tpu_torch.solvers import implicit_gq
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig


def _ratios(solve, system, kw, ks, bound):
    win, b, dinv, x0 = system
    return [float(solve(win, b, dinv, x0=x0, tol=0.0, maxiter=k, **kw).residual) / bound
            for k in ks]


def _first_at_or_below(ks, ratios):
    return next((k for k, r in zip(ks, ratios) if r <= 1.0), None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck-n", type=int, default=30)
    ap.add_argument("--from-rest", type=int, default=50, help="F32 steps before the traced ones")
    ap.add_argument("--steps", type=int, default=10, help="MIXED steps whose CG is traced")
    ap.add_argument("--from-k", type=int, default=152)
    ap.add_argument("--to-k", type=int, default=220)
    ap.add_argument("--policy", choices=("mixed", "f32"), default="mixed",
                    help="the dtype policy of the traced steps")
    ap.add_argument("--path", choices=("kernel", "plain"), default="kernel",
                    help="the path whose steps' pressure systems are traced")
    ap.add_argument("--device", default=None, help="cpu: both columns are the plain version")
    args = ap.parse_args()

    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01,
                       dt=BENCH_DT.get(args.deck_n, 1e-3))
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                       pressure_warm_start=True, steps_per_chunk=25)
    solver = implicit_gq.ImplicitGQSolver(deck, cfg, device=args.device)
    state, _ = solver.run(n_steps=args.from_rest)
    attrs = {k: getattr(solver, k) for k in solver.STATIC_ATTRS}
    policy = DTypePolicy.MIXED if args.policy == "mixed" else DTypePolicy.F32
    traced = implicit_gq.ImplicitGQSolver.from_tables(
        deck, dataclasses.replace(cfg, dtype_policy=policy), solver.d, attrs,
        device=solver.device, plain=args.path == "plain")

    systems = []
    name = "fused_cg_plain" if args.path == "plain" else "fused_cg"
    solve = getattr(implicit_gq, name)

    def recording_cg(win, b, dinv, **kw):
        systems.append((win, b.clone(), dinv, kw["x0"].clone()))
        return solve(win, b, dinv, **kw)

    setattr(implicit_gq, name, recording_cg)     # the traced path's CG of _time_step
    try:
        _, hist = traced.run(state, n_steps=args.steps)
    finally:
        setattr(implicit_gq, name, solve)

    unroll = max(1, int(cfg.pressure_cg_unroll))
    ks = list(range(args.from_k, args.to_k + 1, unroll))
    for step, (system, row) in enumerate(zip(systems, hist), 1):
        bound = cfg.pressure_cg_tol * float(torch.linalg.vector_norm(system[1]))
        out = dict(step=step, cg_iters=int(row["cg_iters"]), bound=bound,
                   x0_norm=float(torch.linalg.vector_norm(system[3])), k=ks)
        for dot_mode in ("compensated", "plain"):
            kw = dict(dims=solver.coarse_dims, radius=solver.z_radius, unroll=unroll,
                      dot_mode=dot_mode)
            kern = _ratios(fused_cg, system, kw, ks, bound)
            plain = _ratios(fused_cg_plain, system, kw, ks, bound)
            out[dot_mode] = dict(
                kernel=kern, plain=plain,
                stop_kernel=_first_at_or_below(ks, kern), stop_plain=_first_at_or_below(ks, plain),
                max_rel_dev=max(abs(a - b) / b for a, b in zip(kern, plain)),
            )
        print(json.dumps(out), flush=True)
    if solver.device.type != "cuda":
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
