"""Run one cell of ``BENCHMARK.json`` once: set up, warm up, measure a
window of back-to-back segments, run one more segment with its states kept
and check it against the reference, and build the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, its correctness limits in ``limits/<cell>.json``
and each per-layer metric's reader in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "load_spec", "Spec", "run_cell", "FORBIDDEN_MODULES",
           "forbidden_loaded", "metric_reader"]

# top-level module names that no process the benchmark measures may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cfd_with_cuda_tpu")

# the SolverConfig fields the reference takes from a cell's options
_REF_OPTS = ("pressure_cg_tol", "pressure_cg_maxiter", "pressure_warm_start",
             "pressure_pin_large")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """A cell with its configuration, traffic, limits and metrics."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = HERE

    @property
    def solver_options(self) -> dict:
        return {**self.config["solver"], **self.traffic.get("solver", {})}

    def reference_options(self) -> dict:
        o = self.solver_options
        out = {k: o[k] for k in _REF_OPTS}
        out["pressure_cg_every"] = 1 if o.get("pressure_cg_fuse_loop") else int(
            o["pressure_cg_unroll"])
        return out


def load_spec(workload: str, root: Path = HERE, bench: Path | None = None) -> Spec:
    """The :class:`Spec` of cell ``workload`` (files under ``root``)."""
    bench = _json(bench or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    has = lambda m: "workloads" not in m or workload in m["workloads"]
    return Spec(cell=cell,
                config=_json(root / "configs" / f"{cell['config']}.json"),
                traffic=_json(root / "traffic" / f"{cell['traffic']}.json"),
                limits=_json(root / "limits" / f"{workload}.json"),
                end_to_end=[m for m in bench["end_to_end"] if has(m)],
                per_layer=[m for m in bench["per_layer"] if has(m)], root=root)


def metric_reader(name: str, root: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """The modules of :data:`FORBIDDEN_MODULES` this process holds, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


@dataclass
class MetricContext:
    """What a per-layer reader reads: the trace of the traced segments, their
    history rows and steps, the kernels of the port's csrc/ by source, the
    structural counts of the deck (computed on first use)."""

    trace: object
    rows: list
    steps: int
    kernels: dict
    word: int
    host_setup_s: float
    _counts: object = None
    _cache: dict = field(default_factory=dict)

    def counts(self):
        if "counts" not in self._cache:
            self._cache["counts"] = self._counts()
        return self._cache["counts"]

    def _ms_by_source(self) -> dict:
        if "by_source" not in self._cache:
            from benchmark.trace import kernel_name

            out = {}
            for s in self.trace.device:
                src = self.kernels.get(kernel_name(s.name))
                out[src] = out.get(src, 0.0) + (s.end - s.start) * 1e-3
            self._cache["by_source"] = out
        return self._cache["by_source"]

    def kernel_ms(self, sources) -> float | None:
        """Device ms of the kernels defined in the csrc files ``sources``
        (None when none ran)."""
        by = self._ms_by_source()
        hit = [by[s] for s in sources if s in by]
        return sum(hit) if hit else None

    def other_ms(self) -> float:
        """Device ms of every event that is no csrc kernel."""
        return self._ms_by_source().get(None, 0.0)

    def last_solves(self, starts, sources) -> list | None:
        """``[(reported CG iterations, device ms), ...]`` of each traced
        step's last pressure solve.  A solve is the device time of the
        kernels of the csrc files ``sources`` from one launch of a kernel
        named in ``starts`` to the next; a step makes one solve a
        sub-iteration (``iters``) and reports the last one's count.  None
        when the trace holds no solve or not one a sub-iteration."""
        from benchmark.trace import kernel_name

        solves = []
        for s in sorted(self.trace.device, key=lambda s: s.start):
            name = kernel_name(s.name)
            if self.kernels.get(name) not in sources:
                continue
            if name in starts:
                solves.append(0.0)
            elif not solves:
                return None
            solves[-1] += (s.end - s.start) * 1e-3
        ends = np.cumsum([int(r["iters"]) for r in self.rows]) - 1
        if not solves or len(solves) != int(ends[-1]) + 1:
            return None
        return [(int(r["cg_iters"]), solves[e]) for r, e in zip(self.rows, ends)]


# --------------------------------------------------------------- the run
def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _fields(solver, state) -> tuple:
    """``(u, p, u_prev, pdot)`` of a program state, deck node order, float64."""
    u, p = solver.fields(state)
    u_prev, pdot = solver.fields(state._replace(un=state.unp1_prev, pn=state.pdot))
    return tuple(np.asarray(a, np.float64) for a in (u, p, u_prev, pdot))


def _program_state(solver, start: tuple):
    """The program's state of the fields ``(u, p, u_prev, pdot)``."""
    u, p, u_prev, pdot = start
    state = solver.state_from_fields(u, p)
    prev = solver.state_from_fields(u_prev, pdot)
    return state._replace(unp1_prev=prev.un, pdot=prev.pn, pdot_nm1=prev.pn)


def _captured_segment(solver, state0, plan: list, seg_len: int) -> tuple:
    """One segment from ``state0`` through the window's entry, ``run``, in
    pieces that end at the steps of ``plan``: ``({step: state}, rows)``,
    the states after step 0 and each step of ``plan``, the rows numbered
    1..n."""
    state, captures, rows, done = _clone(state0), {0: state0}, [], 0
    for stop in plan + [seg_len]:
        if stop <= done:
            continue
        state, hist = solver.run(state, n_steps=stop - done)
        for k, row in enumerate(hist):
            row["step"] = done + k + 1
        rows.extend(hist)
        done = stop
        captures[stop] = _clone(state)
    return captures, rows


class Cell:
    """A cell made ready on ``device``: its deck (the benchmark's own and the
    port's), the benchmark's own node tables, the solver configuration, and
    the helpers a run, the readings and the tests share."""

    def __init__(self, spec: Spec, device: str):
        os.environ["CFD_TORCH_CACHE_DIR"] = str(spec.root / ".cache" / "setup_torch")
        from benchmark import decks
        from benchmark.reference import mesh as rmesh
        from cfd_with_cuda_tpu_torch.io.deck import Deck
        from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

        self.spec, self.device = spec, device
        self.deck = decks.make_deck(spec.config["deck"])
        self.port_deck = Deck(dialect="fractional", **self.deck.as_kwargs())
        self.ltog, self.xyz = rmesh.promote(self.deck.conn, self.deck.coords)
        bc = rmesh.node_bcs(self.ltog, self.deck.bc_vel_faces, self.xyz.shape[0])
        self.is_bc = bc >= 0
        self.bc_vel = rmesh.boundary_velocity(self.deck, self.xyz, bc)
        opts = dict(spec.solver_options)
        opts["dtype_policy"] = DTypePolicy(opts["dtype_policy"])
        self.cfg = SolverConfig(**opts)
        self.seg_len = int(spec.traffic["segment_steps"])
        self.first = int(spec.traffic["check"]["first_steps"])

    def solver(self):
        from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver

        return ExplicitBCHSolver(self.port_deck, self.cfg, device=self.device)

    def developed(self) -> tuple:
        """The developed state ``(u, p, u_prev, pdot)`` (float64): the
        reference's ``start.developed_steps`` steps from rest, made once and
        kept under ``.cache/developed/`` at a name fixed by the deck, the
        reference's options and the step count."""
        import hashlib

        import torch

        from benchmark import traffic

        steps = int(self.spec.traffic["start"]["developed_steps"])
        key = json.dumps([self.spec.config["deck"], self.spec.reference_options(), steps],
                         sort_keys=True)
        path = (self.spec.root / ".cache" / "developed" /
                f"{self.spec.cell['config']}.{hashlib.sha1(key.encode()).hexdigest()[:16]}.npz")
        if path.is_file():
            with np.load(path) as z:
                return tuple(z[k] for k in ("u", "p", "u_prev", "pdot"))
        ref = self.reference()
        state = ref.state(*traffic.rest_fields(self.bc_vel, self.deck.nnp))
        with torch.no_grad():
            for _ in range(steps):
                state, _ = ref.step(state)
        out = tuple(t.double().cpu().numpy() for t in state)
        del ref, state
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_suffix(".part.npz")
        np.savez(part, **dict(zip(("u", "p", "u_prev", "pdot"), out)))
        os.replace(part, path)
        return out

    def start(self, seed: int, developed: tuple) -> tuple:
        """``(u, p, u_prev, pdot)`` of the seed: ``developed`` perturbed."""
        from benchmark import traffic

        spec = {**self.spec.traffic["start"], "speed": self.spec.config["speed"]}
        return traffic.start_fields(developed, self.xyz, self.is_bc, seed, spec)

    def samples(self, seed: int) -> list:
        from benchmark import traffic

        return traffic.sampled_steps(seed, self.first, self.seg_len,
                                     int(self.spec.traffic["check"]["sampled"]))

    def plan(self, samples: list) -> list:
        """The steps after which the checked segment's state is captured."""
        return sorted(set(range(1, self.first + 1)) | {j - 1 for j in samples} | set(samples))

    def reference(self, precision: str = "f64"):
        """The reference at the configuration's tolerances in ``precision``:
        the judge (``"f64"``) or the control (``"tf32"``)."""
        from benchmark.reference.explicit import ExplicitReference

        return ExplicitReference(self.deck, self.spec.reference_options(), self.device, precision)

    def capture(self, solver, captures: dict, rows: list):
        from benchmark.check import Capture

        return Capture({k: _fields(solver, s) for k, s in captures.items()}, rows)

    def judge(self, ref, cap, start, samples) -> dict:
        from benchmark.check import judge

        return judge(ref, cap, start, self.first, samples)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, spec: Spec | None = None, log=print) -> dict:
    """Run the cell once and return the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec(workload)

    import torch

    from benchmark import check
    from cfd_with_cuda_tpu_torch.ops import cuda_lib

    cuda = device == "cuda"
    if cuda:
        cuda_lib.build_all()
    cell = Cell(spec, device)
    cfg, seg_len, first = cell.cfg, cell.seg_len, cell.first
    t0 = time.perf_counter()
    start = cell.start(seed, cell.developed())
    developed_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    samples = cell.samples(seed)
    t0 = time.perf_counter()
    solver = cell.solver()
    host_setup_s = time.perf_counter() - t0
    state0 = _program_state(solver, start)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the warm-up: the first steps of a segment
    solver.run(_clone(state0), n_steps=int(spec.traffic["warmup_steps"]))
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s (developed state {developed_s:.3f} s, solver "
        f"{host_setup_s:.3f} s, cache hit {solver.setup_cache_hit}, stored "
        f"{solver.setup_cache_bytes} B), layout {solver.layout}", file=sys.stderr)

    # ---- the window: whole segments from the start state until `seconds`;
    # with `trace`, segments 1..trace_segments under the profiler (device
    # activity only, so the host pays no op recording)
    traced = range(1, 1 + int(spec.traffic["trace_segments"])) if trace else range(0)
    rows_all, traced_rows, seg_times = [], [], []
    prof, trace_wall, end_state = None, 0.0, None
    t_win = time.perf_counter()
    n_seg = 0
    while True:
        if n_seg in traced:
            from torch.profiler import ProfilerActivity, profile

            if prof is None:
                prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                               else [ProfilerActivity.CPU])
                prof.__enter__()
            t_seg = time.perf_counter()
        end_state, rows = solver.run(_clone(state0), n_steps=seg_len)
        sync()
        seg_times.append(time.perf_counter())
        if n_seg in traced:
            trace_wall += seg_times[-1] - t_seg
            traced_rows.extend(rows)
            if n_seg == traced[-1]:
                prof.__exit__(None, None, None)
        rows_all.extend(rows)
        n_seg += 1
        if seg_times[-1] - t_win >= seconds and n_seg > (traced[-1] if traced else -1):
            break
    window_s = seg_times[-1] - t_win
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of the JAX side are loaded: {found}")

    # ---- what the window did
    real = [r for r in rows_all if r["iters"] > 0]
    failed = sum(1 for r in real
                 if not all(np.isfinite([r[k] for k in ("u_mon", "v_mon", "w_mon", "p_mon",
                                                        "max_acc")]))
                 or r["cg_iters"] >= cfg.pressure_cg_maxiter)
    seg_ms = np.diff([t_win] + seg_times) * 1e3
    log(f"window: {window_s:.3f} s, {n_seg} segments of {seg_len} steps, {len(real)} steps; "
        f"sub-iterations {np.mean([r['iters'] for r in real]):.4f} a step; "
        f"segment ms p50 {np.percentile(seg_ms, 50):.3f} p95 {np.percentile(seg_ms, 95):.3f}; "
        f"launches {dict((k, v) for k, v in cuda_lib.launch_counts.items() if v)}",
        file=sys.stderr)

    # ---- the traced segments' per-layer metrics
    metrics = {}
    trace_data = None
    if trace:
        from benchmark import trace as tr
        from benchmark import yardstick

        trace_data = tr.reduce_profile(prof, trace_wall * 1e6)
        prof = None
        import cfd_with_cuda_tpu_torch

        kernels = tr.kernel_sources(Path(cfd_with_cuda_tpu_torch.__file__).parent / "csrc")
        ctx = MetricContext(
            trace=trace_data, rows=traced_rows, steps=len(traced_rows), kernels=kernels,
            word=4 if cfg.dtype_policy.value != "f64" else 8, host_setup_s=host_setup_s,
            _counts=lambda: yardstick.operator_counts(cell.ltog, cell.xyz.shape[0],
                                                      cell.deck.conn, cell.deck.nnp, device))
        for m in spec.per_layer:
            value = metric_reader(m["name"], spec.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"ms_per_step": window_s * 1e3 / max(len(real), 1), "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    # ---- the check: one more segment through the same entry, its states
    # kept, judged by the reference once the program's state is freed
    captures, rows = _captured_segment(solver, state0, cell.plan(samples), seg_len)
    end_gap = max(float((a - b).abs().max()) for a, b in zip(captures[seg_len], end_state))
    cap = cell.capture(solver, captures, rows)
    del solver, state0, captures, end_state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = cell.judge(cell.reference(), cap, start, samples)
    correct, shown = check.verdict(numbers, spec.limits)
    log(f"check: {time.perf_counter() - t_ref:.3f} s, steps 1..{first} and {samples}; the "
        f"checked segment's last state against the window's last: {end_gap!r}; "
        f"{json.dumps(numbers)}", file=sys.stderr)

    out = {"correct": bool(correct), "attempted": len(real), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": memory_peak}}
    if trace:
        from benchmark import trace as tr

        busy = tr.busy_share(trace_data.device, trace_data.wall_us) or 0.0
        out["device"]["busy_s"] = busy * trace_wall
        out["device"]["window_s"] = trace_wall
        out["breakdown"] = tr.breakdown(trace_data)
    out["check"] = shown
    return out
