"""Where a time step's time goes on the card, in two regimes per solver.

    python -m cfd_with_cuda_tpu_torch.profile_step                # NE27000 cavity
    python -m cfd_with_cuda_tpu_torch.profile_step --deck-n 4 --warm-steps 50
    python -m cfd_with_cuda_tpu_torch.profile_step --solver implicit

``--solver explicit`` (the default) runs the explicit BCH solver (F32, CG
tol 1e-6, warm-started fused CG) on ``cavity_deck(deck_n, cluster=2.0)``
from rest.  Two regimes:

* spin-up: steps 6-55 (after 5 warm-up steps), 2-4 sub-iterations a step;
* warm: after ``--warm-steps`` steps from rest, where the deck's
  sub-iteration test settles to 1 sub-iteration a step.

``--solver implicit`` runs the implicit GQ solver (F32, CG tol 1e-6, the
default per-iteration CG, warm-started solves) on the same deck:

* from rest: steps 6-55 at the deck's dt = 0.001;
* seeded: from ``--state`` (u (NN, 3), p (NNp,) of a developed flow; the
  stored Re = 100 run at t = 250 by default, NE27000 only) at dt = 0.01,
  steps 6-55.

For each: ms/step over a timed window (host clock around work that ends
in ``torch.cuda.synchronize()``), the sub-iteration histogram, mean CG and
momentum iterations, and a ``torch.profiler`` trace of 5 steps: device
time by kernel name and the device's busy share of the traced wall time
(busy = union of kernel and copy intervals).  Prints one JSON line per
regime, then the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

PROFILE_STEPS = 5
SEEDED_STATE = (Path(__file__).resolve().parents[1] / "cfd_with_cuda_tpu" / "validation"
                / "data" / "cavity_re100_implicit_state.npz")


def _timed(solver, state, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = solver.run(state, n_steps=n)
    torch.cuda.synchronize()
    return state, hist, (time.perf_counter() - t0) / n * 1e3


def _trace(solver, state):
    """(state, {kernel: device ms per step}, busy share, traced wall ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = solver.run(state, n_steps=PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(float)
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name] += (end - start) / 1e3 / PROFILE_STEPS
        spans.append((start, end))
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    return state, top, (busy / wall_us if spans else None), wall_us / 1e3 / PROFILE_STEPS


def _regime(name, solver, state, n_timed):
    state, hist, ms = _timed(solver, state, n_timed)
    subs = [int(h["iters"]) for h in hist]
    state, top, busy, traced_ms = _trace(solver, state)
    out = dict(
        regime=name, ms_per_step=ms, timed_steps=n_timed,
        sub_iters_hist={str(s): subs.count(s) for s in sorted(set(subs))},
        cg_iters_mean=sum(h["cg_iters"] for h in hist) / len(hist),
        mom_iters_mean=sum(h["mom_iters"] for h in hist) / len(hist),
        traced_ms_per_step=traced_ms, device_busy_share=busy,
        device_ms_per_step_by_kernel=top,
    )
    print(json.dumps(out), flush=True)
    return state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck-n", type=int, default=30)
    ap.add_argument("--warm-steps", type=int, default=1500,
                    help="steps from rest before the warm regime is timed")
    ap.add_argument("--timed-warm", type=int, default=200)
    ap.add_argument("--solver", choices=("explicit", "implicit"), default="explicit")
    ap.add_argument("--state", default=str(SEEDED_STATE),
                    help="npz with u (NN, 3), p (NNp,): the implicit solver's seeded regime")
    args = ap.parse_args()

    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001)
    if args.solver == "explicit":
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                           pressure_warm_start=True, pressure_cg_fuse_loop=True,
                           steps_per_chunk=50)
        solver = ExplicitBCHSolver(deck, cfg)
        state, _ = solver.run(n_steps=5)           # warm-up: kernel build and first launches
        state = _regime("spin_up", solver, state, 50)
        done = 5 + 50 + PROFILE_STEPS
        state, _ = solver.run(state, n_steps=max(0, args.warm_steps - done))
        _regime("warm", solver, state, args.timed_warm)
    else:
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                           pressure_warm_start=True, steps_per_chunk=25)
        solver = ImplicitGQSolver(deck, cfg)
        state, _ = solver.run(n_steps=5)
        _regime("from_rest", solver, state, 50)
        seed = np.load(args.state)
        if seed["u"].shape[0] == solver.nn:
            del solver, state
            deck.dt, deck.max_iter = 0.01, 1
            solver = ImplicitGQSolver(deck, cfg)
            state, _ = solver.run(solver.state_from_fields(seed["u"], seed["p"]), n_steps=5)
            _regime("seeded", solver, state, 50)
        else:
            print(json.dumps(dict(regime="seeded", skipped=f"{args.state} holds "
                                  f"{seed['u'].shape[0]} nodes, the deck {solver.nn}")), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
