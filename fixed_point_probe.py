"""The implicit cavity's long-horizon monitor, JAX package against the
PyTorch port, both on the CPU in float32.

    JAX_PLATFORMS=cpu python fixed_point_probe.py --n 8 --steps 5000

Runs ``ImplicitGQSolver`` of each package on ``cavity_deck(n, cluster=2.0,
viscosity=0.01, dt=0.01)`` with one Picard pass a step (the configuration of
``scripts/validate_cavity.py --implicit``: F32, pressure CG tol 1e-6, chunks
of 100) from rest, ``pressure_backend="xla"`` (the JAX package's path off
the TPU, no Pallas), and prints u_mon and max_acc of both every ``--every``
steps: whether the two schemes share one fixed point in the same
arithmetic.  Needs the JAX package, so it stays outside the port.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _history(pkg, n, steps, every):
    if pkg == "jax":
        from cfd_with_cuda_tpu.mesh.generators import cavity_deck
        from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver
        from cfd_with_cuda_tpu.utils.config import DTypePolicy, SolverConfig
        kw = {}
    else:
        from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
        from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
        from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig
        kw = dict(device="cpu")
    deck = cavity_deck(n, cluster=2.0, viscosity=0.01, dt=0.01, t_final=1e9)
    deck.max_iter = 1
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=100,
                       pressure_backend="xla")
    solver = ImplicitGQSolver(deck, cfg, **kw)
    state, rows, t0 = None, [], time.perf_counter()
    for done in range(every, steps + 1, every):
        state, hist = solver.run(state, n_steps=every)
        rows.append((done, hist[-1]["u_mon"], hist[-1]["max_acc"]))
    return rows, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="cavity elements per edge")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--every", type=int, default=500)
    args = ap.parse_args()
    runs = {pkg: _history(pkg, args.n, args.steps, args.every) for pkg in ("torch", "jax")}
    for (step, um_t, acc_t), (_, um_j, acc_j) in zip(runs["torch"][0], runs["jax"][0]):
        print(json.dumps(dict(step=step, u_mon_torch=um_t, u_mon_jax=um_j,
                              d_u_mon=abs(um_t - um_j), max_acc_torch=acc_t,
                              max_acc_jax=acc_j)), flush=True)
    print(json.dumps({f"{pkg}_s": runs[pkg][1] for pkg in runs}), flush=True)


if __name__ == "__main__":
    main()
