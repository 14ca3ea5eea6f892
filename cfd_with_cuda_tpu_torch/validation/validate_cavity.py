"""Run the lid-driven cavity towards steady state and validate its
centerline profiles against Ghia et al. (1982).

Port of ``scripts/validate_cavity.py``: the same decks, configurations,
flags and artifact keys, on the card (``--device cpu`` runs the plain
PyTorch versions on the CPU).

    python -m cfd_with_cuda_tpu_torch.validation.validate_cavity --implicit
    python -m cfd_with_cuda_tpu_torch.validation.validate_cavity --stab 0.5 --seed-implicit \\
        --steps 100000
    python -m cfd_with_cuda_tpu_torch.validation.validate_cavity        # explicit, to t = 250
    python -m cfd_with_cuda_tpu_torch.validation.validate_cavity --implicit --re1000 \\
        --nside 56 --seed-state cavity_re1000_implicit_state.npz --steps 5000

Decks: Re = 100 on ``cavity_deck(30, cluster=2.0, viscosity=0.01,
dt=0.001)`` (the NE27000 cavity; ``--deck-n`` another size), t_final 250;
``--re1000`` on ``cavity_deck(nside, cluster=2.0, viscosity=0.001,
dt=0.002)`` (``--nside``, default 40), at most 75,000 steps.  The implicit
integrator runs one Picard pass at dt 0.01 (Re = 100) or two at
dt = 0.2 / nside (Re = 1000); the explicit one converged sub-iterations
(``max_iter`` 10, tol 1e-6) unless ``--refparity`` keeps the deck's 4 /
1e-3.  ``--stab C`` sets the Temam convection stabilization
(``conv_stab``).  F32, pressure CG tol 1e-6, chunks of 100 steps, the
setup cache.

State: the run continues from ``<state-dir>/cavity_re<RE>_<tag>_state.npz``
when present (``--fresh``: from rest) and writes it back after every chunk.
``--seed-implicit`` starts from the implicit run's state of the same Re
(``--seed-state PATH`` another file) at t = 0 of this run's horizon;
``--seed-state PATH`` alone continues from that state's t.

Writes ``<out-dir>/cavity_re<RE>_<tag>.npz`` with the keys of the JAX
package's artifacts (``z, u_x, x, u_z, steps, max_acc, u_mon,
err_ghia_u, err_ghia_v, u_mon_tail, drift_per_kstep``) and ``seed`` (the
state file the run started from, or ``none``), ``t_start``, ``t_end``,
``dt``, ``setup_s``, ``wall_s``, ``ms_per_step``, ``device`` and ``card``
(``nvidia-smi``'s name and power limit, or ``cpu``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[1]
DATA_DIR = PKG / "validation" / "data"
STATE_DIR = PKG / "validation" / "state"


def _card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _deck(args):
    """(deck, re, max_steps) of the run."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck

    if args.re1000:
        # at 40^3 the interior cell-Peclet u h / nu is ~20-25 and the
        # plain-Galerkin convection sustains a dispersive limit cycle; the
        # refined 56^3 run is the validation configuration
        deck = cavity_deck(args.nside, cluster=2.0, viscosity=0.001, dt=0.002,
                           t_final=150.0, convergence=2e-5)
        return deck, 1000, 75000
    t_final = 250.0               # 3-D spin-up is slow (t ~ 1/nu)
    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001, t_final=t_final)
    return deck, 100, int(t_final / deck.dt)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--implicit", action="store_true", help="the implicit GQ integrator")
    ap.add_argument("--re1000", action="store_true", help="Re = 1000 on the refined cavity")
    ap.add_argument("--nside", type=int, default=40, help="Re = 1000 elements per edge")
    ap.add_argument("--deck-n", type=int, default=30, help="Re = 100 elements per edge")
    ap.add_argument("--refparity", action="store_true",
                    help="explicit: keep the deck's max_iter 4 / tol 1e-3 sub-iterations")
    ap.add_argument("--stab", type=float, default=None,
                    help="Temam convection stabilization coefficient (conv_stab)")
    ap.add_argument("--fresh", action="store_true", help="start from rest, not the state file")
    ap.add_argument("--seed-implicit", action="store_true",
                    help="start from the implicit run's state of the same Re")
    ap.add_argument("--seed-state", default=None,
                    help="state file (u, p, t) to start from")
    ap.add_argument("--steps", type=int, default=None, help="steps to run (default: to t_final)")
    ap.add_argument("--chunk-steps", type=int, default=5000,
                    help="steps between progress lines and steady checks")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out-dir", default=str(DATA_DIR), help="directory of the profile artifact")
    ap.add_argument("--state-dir", default=str(STATE_DIR), help="directory of the state files")
    return ap.parse_args(argv)


def main(argv=None) -> Path:
    """Run the validation; returns the artifact's path."""
    from cfd_with_cuda_tpu_torch.device import resolve_device
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig
    from cfd_with_cuda_tpu_torch.validation.ghia1982 import (
        centerline_profiles,
        check_against_ghia,
    )

    args = _parse(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    deck, re, max_steps = _deck(args)
    solver_cls = ImplicitGQSolver if args.implicit else ExplicitBCHSolver
    tag = "implicit" if args.implicit else "explicit"
    if args.implicit:
        # one pass a step (no sub-iterations) at dt 0.01; at Re = 1000 the
        # one-pass Picard linearization is not stable on the clustered
        # mesh (near-wall advective CFL ~0.8): dt for CFL ~0.5, two passes
        if args.re1000:
            deck.dt = round(0.2 / args.nside, 4)
            deck.max_iter = 2
            deck.tolerance = 1e-4
        else:
            deck.dt = 0.01
            deck.max_iter = 1
    elif not args.refparity:
        # converged nonlinear sub-iterations
        deck.max_iter = 10
        deck.tolerance = 1e-6
    stab = 0.0
    if args.stab is not None:
        stab = args.stab
        tag += "_stab"
    cfg = SolverConfig(
        dtype_policy=DTypePolicy.F32,
        pressure_cg_tol=1e-6,
        steps_per_chunk=100,
        setup_cache="auto",
        pressure_warm_start=solver_cls is ExplicitBCHSolver,
        conv_stab=stab,
    )
    t0 = time.time()
    solver = solver_cls(deck, cfg, device)
    setup_s = time.time() - t0
    print(f"setup {setup_s:.1f}s layout={solver.layout} device={device}", flush=True)

    state_dir = Path(args.state_dir)
    state_file = state_dir / f"cavity_re{re}_{tag}_state.npz"
    state, seed, t_done = None, "none", 0.0
    if args.seed_implicit or args.seed_state:
        # the implicit integrator's steady state: both integrators share
        # the spatial discretization, so the explicit fixed point is O(dt)
        # away; --seed-state alone continues from that state's time
        path = Path(args.seed_state) if args.seed_state else (
            state_dir / f"cavity_re{re}_implicit_state.npz")
        snap = np.load(path)
        state = solver.state_from_fields(snap["u"], snap["p"])
        seed = f"{path} (t={float(snap['t']):g})"
        if not args.seed_implicit:
            t_done = float(snap["t"])
        print(f"seeded from {seed}", flush=True)
    elif state_file.exists() and not args.fresh:
        snap = np.load(state_file)
        state = solver.state_from_fields(snap["u"], snap["p"])
        t_done = float(snap["t"])
        seed = f"{state_file.name} (t={t_done:g})"
        print(f"continuing from {seed}", flush=True)
    remaining = max(0, int(round((deck.t_final - t_done) / deck.dt)))
    max_steps = min(max_steps, remaining)
    if args.steps is not None:
        max_steps = args.steps

    t0 = time.time()
    hist = []
    state_dir.mkdir(parents=True, exist_ok=True)
    for done in range(0, max_steps, args.chunk_steps):
        state, part = solver.run(state, n_steps=min(args.chunk_steps, max_steps - done))
        hist.extend(part)
        h = part[-1]
        # the state after every chunk, so that a run cut short resumes from it
        u, p = solver.fields(state)
        np.savez(state_file, u=u, p=p, t=t_done + len(hist) * deck.dt)
        print(f"  step {len(hist):6d}: max_acc={h['max_acc']:.3e} "
              f"u_mon={h['u_mon']:+.6f} ({time.time() - t0:.0f} s)", flush=True)
        if h["max_acc"] <= deck.convergence_criteria:
            break
    wall_s = time.time() - t0
    h = hist[-1]
    t_end = t_done + len(hist) * deck.dt
    print(f"ran {len(hist)} steps in {wall_s:.0f}s "
          f"({wall_s / len(hist) * 1e3:.2f} ms/step); "
          f"max_acc={h['max_acc']:.3e} u_mon={h['u_mon']:+.6f} "
          f"steady={h['max_acc'] <= deck.convergence_criteria}", flush=True)

    z, u_x, x, u_z = centerline_profiles(solver.mesh.coords, u)
    err_u, err_v = check_against_ghia(z, u_x, x, u_z, re=re)
    print(f"Ghia Re={re}: max|u - ghia_u| = {err_u:.4f}, "
          f"max|w - ghia_v| = {err_v:.4f} (3-D band 0.06)", flush=True)

    # steadiness is judged by monitor drift, not max_acc: the deck's
    # sub-iterations leave a persistent near-lid oscillation, so max|du|/dt
    # never reaches the 1e-6 criterion
    u_mon_hist = np.asarray([hh["u_mon"] for hh in hist])
    tail = u_mon_hist[-5000:]
    drift_per_kstep = abs(tail[-1] - tail[0]) / max(len(tail) - 1, 1) * 1000.0
    print(f"monitor drift over last {len(tail)} steps: "
          f"{drift_per_kstep:.2e} per 1000 steps", flush=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"cavity_re{re}_{tag}.npz"
    np.savez(
        out, z=z, u_x=u_x, x=x, u_z=u_z,
        steps=len(hist), max_acc=h["max_acc"], u_mon=h["u_mon"],
        err_ghia_u=err_u, err_ghia_v=err_v,
        u_mon_tail=tail[::50], drift_per_kstep=drift_per_kstep,
        seed=seed, t_start=t_done, t_end=t_end, dt=float(deck.dt),
        setup_s=setup_s, wall_s=wall_s, ms_per_step=wall_s / len(hist) * 1e3,
        device=str(device), card=_card_line(device),
    )
    print(f"wrote {out}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
