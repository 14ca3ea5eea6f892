"""Command-line entry point — the reference's run workflow, one command.

The reference solvers are launched next to a ``ProblemName.txt`` naming
the deck: they read ``<name>.inp``, print the monitor table per step,
and write ``<name>.dat`` (Tecplot) + ``<name>_restart.dat``
(``blascoCodinaHuerta.cpp:528-540, 4223, 4263``).  Port of the JAX
package's ``__main__.py``, every solver family:

    python -m cfd_with_cuda_tpu_torch                      # ./ProblemName.txt
    python -m cfd_with_cuda_tpu_torch path/to/ProblemName.txt
    python -m cfd_with_cuda_tpu_torch path/to/deck.inp --solver implicit
    python -m cfd_with_cuda_tpu_torch deck.inp --dtype f64 --device cpu
    python -m cfd_with_cuda_tpu_torch deck.inp --solver poisson

Solver selection defaults by deck dialect: ``fractional`` -> explicit BCH
(``--solver implicit`` for Guermond-Quartapelle), ``poisson`` -> the
scalar Poisson solver, ``legacy`` -> the segregated Horoutunian solver
(``--solver gls`` / ``--solver stokes`` for the monolithic ones).  Every
solver runs on the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions (and the legacy solvers' solves) on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from cfd_with_cuda_tpu_torch.utils.timers import ms_per_step

# the solver a deck dialect selects under --solver auto
_AUTO_SOLVER = {"fractional": "explicit", "poisson": "poisson", "legacy": "segregated"}
_LEGACY = ("poisson", "segregated", "gls", "stokes")
# steps left out of the timed ms/step (the first steps' launches load the kernels)
_WARM_STEPS = 5


def _resolve_deck(arg: str) -> Path:
    p = Path(arg)
    if p.is_dir():
        p = p / "ProblemName.txt"
    if p.name == "ProblemName.txt" or (p.suffix == ".txt" and p.exists()):
        # a missing / empty pointer file falls through to the caller's
        # "deck not found" error, with a sentinel naming the real problem
        if not p.exists():
            name = "<missing-ProblemName.txt>"
        else:
            words = p.read_text().split()
            name = words[0] if words else "<empty-ProblemName.txt>"
        return p.parent / f"{name}.inp"
    return p


def _run_legacy(kind: str, deck, out_base: Path, device, quiet: bool,
                report: dict | None) -> None:
    """The one-shot legacy solvers: solve, print the JAX CLI's lines, write
    ``<name>.dat`` (Poisson: the scalar in the u column, zero pressure)."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.io.tecplot import write_tecplot

    t0 = time.time()
    if kind == "poisson":
        from cfd_with_cuda_tpu_torch.solvers.poisson import PoissonSolver

        s = PoissonSolver(deck, device=device)
        setup_s = time.time() - t0
        t0 = time.time()
        u, iters, res = s.solve()
        history = iters
        print(f"poisson: {int(iters)} iterations (residual {float(res):.2e}),"
              f" {time.time()-t0:.1f}s, max|u|={float(abs(u).max()):.6f}")
        p = np.zeros(u.shape[0])
        u = np.column_stack([u, np.zeros((u.shape[0], 2))])   # the scalar in the u column
    elif kind == "segregated":
        from cfd_with_cuda_tpu_torch.solvers.segregated import SegregatedSolver

        s = SegregatedSolver(deck, device=device)
        setup_s = time.time() - t0
        t0 = time.time()
        u, p, history = s.solve(verbose=not quiet)
        print(f"segregated: {len(history)} outer iterations, "
              f"{time.time()-t0:.1f}s, max|dp| tail {history[-1]['max_dp']:.3e}")
    elif kind == "gls":
        from cfd_with_cuda_tpu_torch.solvers.monolithic import GLSNavierStokesSolver

        s = GLSNavierStokesSolver(deck, device=device)
        setup_s = time.time() - t0
        t0 = time.time()
        u, p, history = s.solve(verbose=not quiet)
        print(f"GLS NS: {len(history)} Picard iterations, {time.time()-t0:.1f}s")
    else:
        from cfd_with_cuda_tpu_torch.solvers.monolithic import StokesSolver

        s = StokesSolver(deck, device=device)
        setup_s = time.time() - t0
        t0 = time.time()
        u, p, history = s.solve()
        print(f"Stokes: {int(history)} iterations, {time.time()-t0:.1f}s")
    run_s = time.time() - t0
    dat = out_base.with_suffix(".dat")
    write_tecplot(dat, deck.title, deck.coords, deck.conn, np.asarray(u),
                  np.asarray(p)[: deck.coords.shape[0]])
    print(f"wrote {dat}")
    if report is not None:
        report.update(solver=s, fields=(u, p), history=history, setup_s=setup_s, run_s=run_s)


def main(argv=None, *, report: dict | None = None) -> int:
    """Run the deck ``argv`` names.  ``report``: a dict that gets what ran
    (``solver``, ``history``, ``setup_s``, ``run_s``; a time integrator's
    final ``state``, a legacy solver's ``fields`` (u, p)), for callers that
    drive the command in-process."""
    ap = argparse.ArgumentParser(
        prog="python -m cfd_with_cuda_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument(
        "problem", nargs="?", default=".",
        help="ProblemName.txt (or its directory), or a .inp deck directly",
    )
    ap.add_argument(
        "--solver", default="auto",
        choices=["auto", "explicit", "implicit", *_LEGACY],
    )
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "mixed"])
    ap.add_argument("--cg-tol", type=float, default=None,
                    help="pressure CG tolerance (default: 1e-6 f32, 1e-12 f64)")
    ap.add_argument("--chunk", type=int, default=50,
                    help="time steps per chunk (one stats read-back each)")
    ap.add_argument("--steps", type=int, default=None,
                    help="run exactly N steps instead of to t_final/steady")
    ap.add_argument("--tecplot-every", type=int, default=1000,
                    help="dump cadence in steps (reference: 1000)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-step monitor table")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a card) or cpu "
                         "(the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    deck_path = _resolve_deck(args.problem)
    if not deck_path.exists():
        ap.error(f"deck not found: {deck_path}")

    from cfd_with_cuda_tpu_torch.device import resolve_device
    from cfd_with_cuda_tpu_torch.io.deck import read_deck

    device = resolve_device(None if args.device == "cuda" else args.device)
    t0 = time.time()
    deck = read_deck(deck_path)
    print(f"read {deck_path.name}: dialect={deck.dialect} NE={deck.ne} "
          f"({time.time()-t0:.1f}s)")

    solver_kind = args.solver
    if solver_kind == "auto":
        solver_kind = _AUTO_SOLVER.get(deck.dialect, "explicit")
    out_base = deck_path.with_suffix("")           # <name>.dat next to the deck
    if solver_kind in _LEGACY:
        _run_legacy(solver_kind, deck, out_base, device, args.quiet, report)
        return 0

    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    cg_tol = args.cg_tol if args.cg_tol is not None else (
        1e-12 if args.dtype == "f64" else 1e-6
    )
    cfg = SolverConfig(
        dtype_policy=DTypePolicy(args.dtype), pressure_cg_tol=cg_tol,
        steps_per_chunk=args.chunk, setup_cache="auto",
        verbose=not args.quiet, pressure_warm_start=True,
    )
    if solver_kind == "implicit":
        from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver as cls
    else:
        from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver as cls
    t0 = time.time()
    solver = cls(deck, cfg, device)
    setup_s = time.time() - t0
    if cfg.setup_cache_dir() is None:
        cache = "off"
    elif solver.setup_cache_hit:
        cache = "hit"
    else:
        cache = (f"miss (stored {solver.setup_cache_bytes} bytes in "
                 f"{solver.setup_cache_store_s:.1f}s)")
    print(f"setup: {setup_s:.1f}s structured={solver.layout != 'ell'} "
          f"layout={solver.layout} NN={solver.nn} NNp={solver.nnp} "
          f"device={device} setup_cache={cache}")
    if not args.quiet:
        print(f"{'step':>6} {'iter':>4} {'time':>10} {'u_mon':>13} "
              f"{'v_mon':>13} {'w_mon':>13} {'p_mon':>13} {'maxAcc':>12}")
    t0 = time.time()
    state, hist = solver.run(
        n_steps=args.steps,
        tecplot_path=out_base.with_suffix(".dat"),
        tecplot_every=args.tecplot_every,
    )
    run_s = time.time() - t0
    n = len(hist)
    if n:
        timed = ""
        ms = ms_per_step(hist, _WARM_STEPS)
        if ms is not None:
            timed = f"; steps {_WARM_STEPS + 1}-{n}: {ms:.2f} ms/step"
        print(f"{n} steps in {run_s:.1f}s ({run_s/n*1e3:.1f} ms/step{timed}); "
              f"wrote {out_base.with_suffix('.dat')} + restart")
    if report is not None:
        report.update(solver=solver, state=state, history=hist, setup_s=setup_s,
                      run_s=run_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
