"""Readings that set a cell's correctness limits, in one process.

    python benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6]

For each seed of ``--seeds`` the program runs one segment from the seed's
start state, as a run's checked segment does, and the float64 reference
judges it: the numbers of ``check.py``, one JSON line a seed (the lower
readings).  For each seed of ``--control-seeds`` the reference in TF32, the
precision below the configuration's float32, runs in the program's place
and is judged the same way (the upper readings).  ``limits/<cell>.json`` is
set from the two.  Not part of a benchmark run; on a card only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_capture(ctrl, start: tuple, plan: list, upto: int):
    """The :class:`check.Capture` of the reference ``ctrl`` run in the
    program's place for the first ``upto`` steps of a segment from the
    fields ``start``."""
    from benchmark.check import Capture

    state = ctrl.state(*start)
    as_np = lambda st: tuple(t.double().cpu().numpy() for t in st)
    states, rows = {0: as_np(state)}, []
    for j in range(1, upto + 1):
        state, out = ctrl.step(state)
        m = out.monitor
        rows.append({"iters": out.iters, "cg_iters": out.cg_iters[-1], "u_mon": m[0], "v_mon": m[1], "w_mon": m[2], "p_mon": m[3],
                     "max_acc": out.max_acc})
        if j in plan:
            states[j] = as_np(state)
    return Capture(states, rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import Cell, _captured_segment, _program_state, load_spec
    from cfd_with_cuda_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cuda_lib.build_all()
    cell = Cell(load_spec(args.workload), "cuda")
    developed = cell.developed()
    ref = cell.reference("f64")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        solver = cell.solver()
        for seed in seeds:
            t0 = time.perf_counter()
            start = cell.start(seed, developed)
            samples = cell.samples(seed)
            captures, rows = _captured_segment(solver, _program_state(solver, start),
                                               cell.plan(samples), cell.seg_len)
            numbers = cell.judge(ref, cell.capture(solver, captures, rows), start, samples)
            print(json.dumps({"side": "program", "seed": seed, "samples": samples, **numbers,
                              "iters": [r["iters"] for r in rows[:cell.first]],
                              "s": time.perf_counter() - t0}), flush=True)
        del solver
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if cseeds:
        ctrl = cell.reference("tf32")
        for seed in cseeds:
            t0 = time.perf_counter()
            start = cell.start(seed, developed)
            samples = cell.samples(seed)
            plan = cell.plan(samples)
            cap = control_capture(ctrl, start, plan, max(plan))
            numbers = cell.judge(ref, cap, start, samples)
            print(json.dumps({"side": "tf32", "seed": seed, "samples": samples, **numbers,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
