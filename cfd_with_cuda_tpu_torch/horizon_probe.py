"""How far from rest the explicit cavity run stays finite, by convection route.

    python -m cfd_with_cuda_tpu_torch.horizon_probe --deck-n 50 --steps 1500 auto planes
    python -m cfd_with_cuda_tpu_torch.horizon_probe --deck-n 4 --steps 100 auto --device cpu

Runs the explicit solver at rung 1's config (F32, CG tol 1e-6, warm start,
fused CG loop) on ``cavity_deck(deck_n, cluster=2.0, viscosity=0.01)`` at the
JAX package's bench-matrix dt for that size (``profile_step.BENCH_DT``) from
rest, once for each ``conv_mode`` given (``auto`` takes the flat route above
``_PLANES_MAX_SP``, ``planes`` forces the convection planes, ``matrix-free``
the flat route), in chunks of ``--every`` steps until ``--steps`` or until
the run stops (the steady test, or a monitor that is no longer finite).
Prints one JSON line per chunk: the monitor, max_acc, the sub-iterations of
the chunk's last step and max|u|.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.profile_step import BENCH_DT
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="+", help="conv_mode values to run")
    ap.add_argument("--deck-n", type=int, default=50)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dt = BENCH_DT.get(args.deck_n, 1e-3)
    device = None if args.device == "cuda" else args.device
    for mode in args.modes:
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                           pressure_warm_start=True, pressure_cg_fuse_loop=True,
                           steps_per_chunk=args.every, conv_mode=mode)
        t0 = time.perf_counter()
        solver = ExplicitBCHSolver(cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=dt),
                                   cfg, device)
        print(json.dumps(dict(conv_mode=mode, deck=f"cavity_deck({args.deck_n}, cluster=2.0, "
                              f"dt={dt})", sp=getattr(solver, "sp_c", None),
                              setup_s=time.perf_counter() - t0)), flush=True)
        state, done = solver.initial_state(), 0
        while done < args.steps:
            state, hist = solver.run(state, n_steps=args.every)
            done += args.every
            u, _ = solver.fields(state)
            h = hist[-1] if hist else {}
            amax = float(np.abs(u).max())
            print(json.dumps(dict(conv_mode=mode, step=done, ran=len(hist), u_mon=h.get("u_mon"),
                                  max_acc=h.get("max_acc"), iters=h.get("iters"),
                                  max_abs_u=amax)), flush=True)
            if len(hist) < args.every or not np.isfinite(amax):
                break
        del solver, state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
