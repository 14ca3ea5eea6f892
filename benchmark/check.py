"""The comparison that decides ``correct``.

A run hands the judge a :class:`Capture` of the segment it checks (one more
segment through the window's entry once the window has closed): the fields
of the states after the steps the check reads (deck node order, float64
copies of what the program produced) and the history rows of the segment.  The judge recomputes the steps with the float64 reference
and returns named numbers; ``correct`` holds when each number the cell's
``limits/<cell>.json`` names is finite and at most its limit.

The reference runs the first ``first`` steps from the start state itself
and one step from the run's own state before each sampled step (so the
start is checked apart from the steps that follow the run).  ``u_gap`` /
``p_gap`` are the largest max-norm differences of the velocity / pressure
over those steps as shares of the reference's max norm, ``mon_gap`` the
largest difference of a reported monitor (u, v, w as shares of max|u|, p of
max|p|) from the reference's, ``acc_gap`` that of the reported ``max_acc``
as a share of the reference's (a difference of two velocities a step apart,
so float32's rounding of the velocity shows in it magnified), and
``start_gap`` the run's start state (u, p, u_prev, pdot) against the start
fields the benchmark made (exact).  The reference solves at the configuration's tolerances: the
same algorithm in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Capture", "judge", "verdict"]

_MON = ("u_mon", "v_mon", "w_mon", "p_mon")


class Capture(NamedTuple):
    states: dict    # step of the segment -> tuple of float64 numpy fields
    rows: list      # history rows; rows[j - 1] is step j


def _rel(a, b, scale) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale) if scale > 0 else 0.0


def _mon_gap(row: dict, mon: np.ndarray, u_scale: float, p_scale: float) -> float:
    gaps = [abs(row[k] - mon[i]) / u_scale for i, k in enumerate(_MON[:3])]
    gaps.append(abs(row["p_mon"] - mon[3]) / p_scale if p_scale > 0 else 0.0)
    return max(gaps)


def _start_gap(cap: Capture, start: tuple) -> float:
    return max(_rel(a, b, 1.0) for a, b in zip(cap.states[0], start))


def judge(ref, cap: Capture, start: tuple, first: int, samples: list) -> dict:
    """The numbers of a run's capture: the reference's own steps 1..``first``
    from the start fields ``(u, p, u_prev, pdot)`` and one step from the
    run's state before each sampled step."""
    out = {"start_gap": _start_gap(cap, start), "u_gap": 0.0, "p_gap": 0.0, "mon_gap": 0.0,
           "acc_gap": 0.0}

    def compare(state, stats, j):
        u_ref, p_ref = ref.fields(state)
        u, p = cap.states[j][:2]
        us, ps = float(np.abs(u_ref).max()), float(np.abs(p_ref).max())
        out["u_gap"] = max(out["u_gap"], _rel(u, u_ref, us))
        out["p_gap"] = max(out["p_gap"], _rel(p, p_ref, ps))
        row = cap.rows[j - 1]
        out["mon_gap"] = max(out["mon_gap"], _mon_gap(row, stats.monitor, us, ps))
        out["acc_gap"] = max(out["acc_gap"], abs(row["max_acc"] - stats.max_acc)
                             / max(abs(stats.max_acc), 1e-300))

    with torch.no_grad():
        state = ref.state(*start)
        for j in range(1, first + 1):
            state, stats = ref.step(state, follow=int(cap.rows[j - 1]["iters"]))
            compare(state, stats, j)
        for j in samples:
            state, stats = ref.step(ref.state(*cap.states[j - 1]),
                                    follow=int(cap.rows[j - 1]["iters"]))
            compare(state, stats, j)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each present, finite and at most its limit.  A cell with
    no limit is not correct."""
    shown = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
             for name, limit in limits.items()}
    ok = bool(shown) and all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                             for v in shown.values())
    return ok, shown
