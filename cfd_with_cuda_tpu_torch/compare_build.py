"""Hold the port's kernels against an earlier build of the same functions,
on the same inputs, on the card.

    git archive <commit> cfd_with_cuda_tpu_torch/csrc | tar -x -C _parent
    python -m cfd_with_cuda_tpu_torch.compare_build --against _parent [--parts ...]

(``_parent/`` is git-ignored.)  Builds the earlier checkout's
``csrc/{parity_apply,window_stencil,div_compact,cg_solve,cg_iter}.cu`` (each
with that checkout's ``cg_common.cuh``) with this checkout's ``nvcc`` flags
into ``_build/against/`` and calls both builds on the same inputs
(``--parts``: any of stencils, cg, parity; all by default):

* stencils: G on the class-compacted window (TPU kernel row 10) in f32 and
  f64 and both compact G^T forms (rows 4 and 11), on the interleaved
  explicit solver's tables of the NE27000 cavity ``cavity_deck(30,
  cluster=2.0)`` and seeded fields: the largest |difference|, bit equality
  (and value equality, the sign of an exact zero apart), and each build's
  device ms (CUDA events, the calls queued behind other device work) and
  ms per call (CUDA events) over REPS launches; then the window SPMV (row
  10) of both interleaved solvers, K, K + A, MK + A, M and f64 K
  (``spmv_checks``): the earlier build's full-window kernel on the full
  tables, this build's on the class-compacted ones, the same comparison;
* parity: every ``parity_apply`` form (rows 1-3: K, G and K + A of the
  explicit parity solver, MK + A and M of the implicit one, on seeded
  fields and convection planes) in both field forms, resident and
  streamed, at NE27000, at NE85184 (``cavity_deck(44, cluster=2.0)``) and
  on the non-cubic ``box_cavity_deck()``, and row 12's class tables
  (``parity_window_apply`` on the interleaved solver's K and one G
  direction) at NE27000: the same comparison and times, the whole weight
  tables' bytes and the byte bound of their nonzero weights; at NE85184
  also K and K + A on routes cut to the shortest class (what the classes'
  different lengths cost) and, in this build's streamed kernel, the warp
  schedule (``stream_schedule``) against two fixed dealings of the classes
  to the 4 warps, warp w summing classes (w, w + 4) or (w, 7 - w);
* cg: the pressure CG (rows 5, 6 and 9) on four windows: the NE27000
  explicit Z (125 slots), the NE27000 implicit Z (27 slots), the banded
  window of the backward-facing step ``bfs_deck(96, 40, 40)`` (275 slots x
  147,477 rows) and the NE85184 explicit Z (125 slots x 91,125 rows), each
  with a seeded right-hand side.  Every form: ``cg_init`` + ``cg_iter``
  (the per-group loop) and ``cg_solve``; the full window and its dq >= 0
  half (``sym``); plain and compensated dots; cold and warm starts
  converged at tol 1e-6 (unroll 4), and a fixed 0, 1 and 40 iterations
  (tol 0, one group).  For each: x, the count and |r| equal bit for bit or
  not.  Per window and build: the block count of each kernel (read from a
  profiler trace), the launch plan, and the time of an iteration split
  into its parts: device ms per iteration of ``cg_solve`` and of
  ``cg_iter`` (CUDA events around calls queued behind other device work, 40
  iterations less none; ``cg_iter`` launched raw, in groups of 4), the same
  with the window cut to its centre slot and dinv = 1 (``nw1``: the apply
  all but gone), the loop's ms per iteration on the host clock (CUDA
  events around the calls: launches and host reads included), and, from
  this checkout's ``csrc/cg_probe.cu`` (a timing probe built for this tool
  alone) at that block count (CUDA events over 200 rounds), one grid
  barrier and the two reductions of an iteration.

Every time in turns: earlier, this, this, earlier.  Prints one JSON line
per part, then the card's name and power limit.  Needs one CUDA card.  Both
builds are driven through this checkout's C interface and host tables.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, box_cavity_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import fused_cg as tcg
from cfd_with_cuda_tpu_torch.ops import window_stencil as ws
from cfd_with_cuda_tpu_torch.ops import parity_stencil as pstl
from cfd_with_cuda_tpu_torch.ops.stencil import coarse_to_fine
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

_SOURCES = ("parity_apply", "window_stencil", "div_compact", "cg_solve", "cg_iter")
_PARTS = ("stencils", "cg", "parity")
DECK_N = 30         # cavity elements per edge: NE27000
NE85_N = 44         # NE85184
BFS_DIMS = (96, 40, 40)
BFS_KW = dict(lengths=(15.0, 2.0, 2.0), step_frac=(0.2, 0.5), viscosity=0.01)
REPS = 20           # launches per timing of G / G^T
CG_REPS = 5         # calls per timing of a CG form
TOL, MAXITER, UNROLL = 1e-6, 1000, 4
DEPTHS = (0, 1, 40)
PROBE_REPS = 200
_P, _I = ctypes.c_void_p, ctypes.c_int
_PROBE_SIGNATURE = [_I] * 4 + [_P] * 3   # csrc/cg_probe.cu

def build_tools(checkout: Path) -> tuple[dict[str, ctypes.CDLL], ctypes.CDLL]:
    """(the earlier checkout's kernel libraries, this checkout's timing
    probe), one ``nvcc`` each, all started together."""
    out = cuda_lib.BUILD_DIR / "against"
    out.mkdir(parents=True, exist_ok=True)
    sources = {name: checkout / "cfd_with_cuda_tpu_torch" / "csrc" / f"{name}.cu"
               for name in _SOURCES}
    sources["probe"] = cuda_lib.CSRC / "cg_probe.cu"
    procs = {}
    for name, src in sources.items():
        lib = out / f"lib{name}.so"
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs, libs.pop("probe")


class Build:
    """One build's C entry points, typed by this checkout's interface."""

    def __init__(self, label: str, libs: dict[str, ctypes.CDLL]):
        self.label, self.libs = label, libs
        self._fns = {}

    def fn(self, name: str):
        if name not in self._fns:
            source, argtypes = cuda_lib._SIGNATURES[name]
            f = getattr(self.libs[source], name)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            self._fns[name] = f
        return self._fns[name]

    def cg(self, win, offs, b, dinv, x0, *, tol, maxiter, unroll, comp, sym, fuse_loop):
        """(x, k, |r|) of one solve, driven as the wrapper drives it
        (``win``/``offs`` already the half under ``sym``)."""
        res = tcg._cuda_cg(self.fn, win, b, dinv, offs, tol=tol, maxiter=maxiter, x0=x0,
                           unroll=unroll, comp=comp, sym=sym, fuse_loop=fuse_loop)
        return res.x, int(res.iters), res.residual

    def plan(self, n, offs, comp, sym, fuse_loop):
        """{"blocks", "form", "ring_stages"}: the grid, the kernel form (0, 1:
        built for 5 or 3 blocks an SM) and the weight ring's depth that the
        build's launcher of ``cg_solve`` (``fuse_loop``) or ``cg_iter`` picks."""
        tab = tcg.stage_table(offs, sym)
        out = (ctypes.c_int * 3)()
        name = "cg_solve_plan" if fuse_loop else "cg_iter_plan"
        cuda_lib.check(self.fn(name)(int(n), len(offs), len(tab), int(tab[1]), int(comp),
                                     int(sym), out), name)
        return dict(blocks=int(out[0]), form=int(out[1]), ring_stages=int(out[2]))


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), the calls
    queued behind ~5 ms of reads of a 1 GB buffer so that the host has
    enqueued them all before the card reaches them (``fn`` must not wait
    for the card)."""
    buf = torch.ones(1 << 28, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    torch.cuda.synchronize()
    for _ in range(16):
        buf.sum()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    del buf
    return ev[0].elapsed_time(ev[1]) / reps


def _grids(fn, names) -> dict[str, int | None]:
    """The grid size of each kernel in ``names`` that ``fn`` launches, read
    from an exported torch.profiler trace (None where three sessions saw no
    launch of it: in a long process a session now and then holds no device
    events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    trace = cuda_lib.BUILD_DIR / "compare_trace.json"
    grids = {w: None for w in names}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())
        trace.unlink()
        events = events["traceEvents"] if isinstance(events, dict) else events
        for e in events:
            for w in names:
                if e.get("cat") == "kernel" and w in e.get("name", ""):
                    grids[w] = int(e.get("args", {}).get("grid", [0])[0])
        if all(v is not None for v in grids.values()):
            break
    return grids


def _raw_cg(build: Build, win, offs, b, dinv, x0, iters: int):
    """A call that enqueues the build's ``cg_init`` and ``iters`` iterations
    of ``cg_iter`` launches (groups of UNROLL) with no host read, for timing
    the kernels alone; tol is never looked at, so ``iters`` always run."""
    fn, ptr, n, dev = build.fn, cuda_lib.ptr, b.shape[0], b.device
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    x, scal = torch.empty_like(b), torch.empty(3, dtype=b.dtype, device=dev)
    part = torch.empty(6 * fn("cg_iter_max_blocks")(), dtype=b.dtype, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    tab = tcg.stage_table(offs, False)
    stab = torch.from_numpy(tab).to(dev)
    rows, ld = tcg.cg_work_layout(n)
    work = torch.empty((len(rows), ld), dtype=b.dtype, device=dev)
    st = (ptr(stab), len(tab), int(tab[1]))
    init_args = (ptr(win), ptr(offs_t), len(offs), ptr(b), ptr(dinv), ptr(x0), ptr(x),
                 ptr(work), ld, ptr(part), ptr(scal), n, 0, 0, *st, stream)
    iter_args = (ptr(win), ptr(offs_t), len(offs), ptr(dinv), ptr(x), ptr(work), ld,
                 ptr(part), ptr(scal), n, UNROLL, 0, 0, *st, stream)
    init, step = fn("cg_init_f32"), fn("cg_iter_f32")

    def run():
        cuda_lib.check(init(*init_args), "cg_init")
        for _ in range(iters // UNROLL):
            cuda_lib.check(step(*iter_args), "cg_iter")
    run.buffers = (offs_t, x, scal, part, stab, work)   # alive as long as the call is
    return run


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.int32)


def _cg_forms(builds, win, offs, b, dinv, x0) -> dict:
    """Every form in both builds: bit equality of x, k and |r|."""
    try:
        half = tcg._sym_offsets(offs)
    except ValueError:       # a band whose offsets are not mirror-symmetric
        half = None
    win_h = None if half is None else win[len(offs) - len(half):].contiguous()
    out = {}
    for fuse_loop in (False, True):
        for sym in (False, True) if half is not None else (False,):
            for comp in (False, True):
                w, o = (win_h, half) if sym else (win, offs)
                name = (f"{'cg_solve' if fuse_loop else 'cg_iter'}"
                        f"{'_sym' if sym else ''}{'_comp' if comp else ''}")
                runs = [("cold", dict(x0=None, tol=TOL, maxiter=MAXITER, unroll=UNROLL)),
                        ("warm", dict(x0=x0, tol=TOL, maxiter=MAXITER, unroll=UNROLL))]
                runs += [(f"fixed_{k}", dict(x0=x0, tol=0.0, maxiter=k, unroll=max(k, 1)))
                         for k in DEPTHS]
                for start, kw in runs:
                    (xa, ka, ra), (xb, kb, rb) = [
                        bd.cg(w, o, b, dinv, comp=comp, sym=sym, fuse_loop=fuse_loop, **kw)
                        for bd in builds]
                    out[f"{name}_{start}"] = dict(
                        iters=[ka, kb], x_bits=torch.equal(_bits(xa), _bits(xb)),
                        k_equal=ka == kb, rn_bits=torch.equal(_bits(ra), _bits(rb)),
                        max_abs_diff=float((xa - xb).abs().max()))
    return out


def _split(build: Build, probe_fn, win, offs, b, dinv, x0) -> dict:
    """One build's iteration on one window split into its parts (module
    docstring): device ms per iteration of both loop forms, of the same with
    the centre slot alone, the loop's host-clock ms per iteration, and one
    grid barrier and one iteration's two reductions at the build's block
    count."""
    n, dev = b.shape[0], b.device
    c0 = list(offs).index(0)
    # the centre slot alone, under a preconditioner that does not invert it
    # (with dinv = 1 / diag one iteration would end the solve at |r| = 0)
    win1, offs1, dinv1 = win[c0:c0 + 1].contiguous(), (0,), torch.ones_like(dinv)
    depth = DEPTHS[-1]

    def run(w, o, k, fuse_loop):
        d = dinv1 if len(o) == 1 else dinv
        return lambda: build.cg(w, o, b, d, x0=x0, tol=0.0, maxiter=k, unroll=UNROLL,
                                comp=False, sym=False, fuse_loop=fuse_loop)

    def per_iter(w, o, fuse_loop):
        """Device ms an iteration: calls queued behind other device work, where
        the wrappers' host time cannot enter, at depth 40 less depth 0."""
        if fuse_loop:
            deep, start = run(w, o, depth, True), run(w, o, 0, True)
        else:
            d = dinv1 if len(o) == 1 else dinv
            deep, start = (_raw_cg(build, w, o, b, d, x0, k) for k in (depth, 0))
        return (_queued_ms(deep, CG_REPS) - _queued_ms(start, CG_REPS)) / depth

    raw = _raw_cg(build, win, offs, b, dinv, x0, UNROLL)
    grids = _grids(lambda: (run(win, offs, 0, True)(), raw()),
                   ("cg_solve_kernel", "cg_init_kernel", "cg_iter_kernel"))
    blocks = grids["cg_iter_kernel"] or min(-(-n // tcg.BLOCK_ROWS), 1024)
    part = torch.empty(3 * blocks, dtype=torch.float32, device=dev)
    sink = torch.empty(1, dtype=torch.float32, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    probe = []
    for mode in (0, 1):
        args = (blocks, PROBE_REPS, mode, 0, cuda_lib.ptr(part), cuda_lib.ptr(sink), stream)
        probe.append(_event_ms(lambda: cuda_lib.check(probe_fn(*args), "cg_probe"), 3)
                     / PROBE_REPS)
    loop_host = (_event_ms(run(win, offs, depth, False), CG_REPS)
                 - _event_ms(run(win, offs, 0, False), CG_REPS)) / depth
    return dict(
        blocks=grids, plan_iter=build.plan(n, offs, False, False, False),
        plan_solve=build.plan(n, offs, False, False, True),
        solve_ms_per_iter=per_iter(win, offs, True),
        solve_nw1_ms_per_iter=per_iter(win1, offs1, True),
        solve_nw1_iters=int(run(win1, offs1, depth, True)()[1]),
        iter_ms_per_iter=per_iter(win, offs, False),
        iter_nw1_ms_per_iter=per_iter(win1, offs1, False),
        init_ms=_queued_ms(_raw_cg(build, win, offs, b, dinv, x0, 0), CG_REPS),
        loop_host_ms_per_iter=loop_host,
        probe_blocks=blocks, grid_sync_ms=probe[0], reductions_ms=probe[1] - 2 * probe[0],
    )


def cg_window(builds, probe_fn, tag, win, offs, dinv, seed) -> dict:
    """Forms, block counts and the split on one window, times in turns."""
    n, dev = win.shape[1], win.device
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    b[0] = 0.0
    cold = builds[1].cg(win, offs, b, dinv, x0=None, tol=TOL, maxiter=MAXITER, unroll=UNROLL,
                        comp=False, sym=False, fuse_loop=True)[0]
    noise = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    x0 = (cold * (1 + 1e-3 * noise)).contiguous()
    forms = _cg_forms(builds, win, offs, b, dinv, x0)
    earlier, this = builds
    turns = [(bd, _split(bd, probe_fn, win, offs, b, dinv, x0))
             for bd in (earlier, this, this, earlier)]
    split = {bd.label: [s for b2, s in turns if b2 is bd] for bd in builds}
    return dict(phase="cg_window", window=tag, rows=n, slots=len(offs),
                max_halo=max(abs(o) for o in offs),
                all_bit_equal=all(v["x_bits"] and v["k_equal"] and v["rn_bits"]
                                  for v in forms.values()),
                forms=forms, split=split)


def _compare(earlier, this, reps: int) -> dict:
    """Both builds' results and times on the same inputs: device time (calls
    queued behind other device work) and time per call (CUDA events, which
    also read the host's launch rate), each in turns earlier, this, this,
    earlier."""
    a, b = earlier(), this()
    torch.cuda.synchronize()
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    order = (earlier, this, this, earlier)
    dev = [_queued_ms(fn, reps) for fn in order]
    ev = [_event_ms(fn, reps) for fn in order]
    return dict(max_abs_diff=float((a - b).abs().max()),
                bit_equal=torch.equal(a.view(ints), b.view(ints)),
                value_equal=torch.equal(a, b),
                earlier_device_ms=[dev[0], dev[3]], this_device_ms=[dev[1], dev[2]],
                earlier_event_ms=[ev[0], ev[3]], this_event_ms=[ev[1], ev[2]])


def stencil_checks(earlier: Build, s) -> dict:
    """G and both compact G^T forms of both builds on the interleaved
    explicit solver ``s``'s NE27000 tables."""
    d, fine, coarse, n = s.d, s.fine_dims, s.coarse_dims, s.s_pad
    rng = np.random.default_rng(20261020)
    dev = s.device
    pf = torch.nn.functional.pad(
        coarse_to_fine(torch.from_numpy(rng.standard_normal(s.nnp).astype(np.float32)).to(dev),
                       coarse, fine), (0, n - s.nn))
    u = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)).to(dev)
    stream, ptr = cuda_lib.stream_ptr(dev), cuda_lib.ptr
    out = {}
    offs_t, counts_t = ws._g_slot_tables(tuple(fine), int(s.g_radius), dev)
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        gc, xb = d["G_cwin"].to(dt), pf.to(dt)[None].contiguous()
        fn = earlier.fn(f"grad_compact_{tag}")
        y = torch.empty((3, n), dtype=dt, device=dev)

        def earlier_g(gc=gc, xb=xb, y=y, fn=fn):
            cuda_lib.check(fn(ptr(gc), gc.shape[1], ptr(xb), ptr(offs_t), ptr(counts_t), ptr(y),
                              n, fine[0], fine[1], stream), "earlier grad_compact")
            return y

        out[f"grad_{tag}"] = _compare(
            earlier_g, lambda gc=gc, xb=xb: ws.grad_window_compact(gc, xb[0], fine, s.g_radius,
                                                                   trim=False), REPS)
        del gc, xb, y
    gt = d["GT_cwin"]
    sp = gt.shape[-1]
    pairs = ws.div_class_pairs(coarse)
    pairs_t = torch.tensor(pairs, dtype=torch.int32, device=dev).reshape(-1)
    up = pstl.parity_split(u, fine, sp).contiguous()
    y_c = torch.empty(sp, device=dev)
    fn_c = earlier.fn("div_compact_f32")

    def earlier_c():
        cuda_lib.check(fn_c(ptr(gt), len(pairs), ptr(up), ptr(pairs_t), ptr(y_c), sp, stream),
                       "earlier div_compact")
        return y_c

    out["div_compact"] = _compare(earlier_c, lambda: ws.div_compact(gt, up, pairs), REPS)
    foffs = torch.tensor(ws.window_offsets(fine, 2), dtype=torch.int32, device=dev)
    (cx, cy, cz), (fx, fy, _) = coarse, fine
    y_i = torch.empty(sp, device=dev)
    fn_i = earlier.fn("div_compact_interleaved_f32")

    def earlier_i():
        cuda_lib.check(fn_i(ptr(gt), len(foffs), ptr(u), n, ptr(foffs), ptr(y_i), sp, cx, cy,
                            cx * cy * cz, fx, fy, stream), "earlier div_compact_interleaved")
        return y_i

    out["div_compact_interleaved"] = _compare(
        earlier_i, lambda: ws.div_compact_interleaved(gt, u, fine, coarse), REPS)
    return dict(phase="stencils", deck_n=DECK_N, s_pad=n, sp=sp, checks=out)


def spmv_checks(earlier: Build, xs, isolver) -> dict:
    """The window SPMV of every solver form (``window_stencil.spmv_forms``: K,
    K + A, MK + A, M, and K in f64) on the interleaved solvers' NE27000
    tables: the earlier build's full-window kernel on the full tables against
    this build's compact kernel (``window_spmv_compact``) on the compact
    ones, with each table's bytes and the bounds (3.35 TB/s, as
    ``chip_smoke.py`` counts them: the nonzero weights, the compact table,
    the full table, each with the fields read once and the output written
    once)."""
    rng = np.random.default_rng(20261030)
    forms = ws.spmv_forms(xs, isolver, rng)
    _, k_full, k_comp, k_offs, u = forms[0]
    forms.append(("f64_k", k_full.double(), k_comp.double(), k_offs, u.double()))
    fine, ptr, dev = xs.fine_dims, cuda_lib.ptr, xs.device
    stream = cuda_lib.stream_ptr(dev)
    out = {}
    for name, full, comp, offs, x in forms:
        n, b = x.shape[-1], x.element_size()
        tag = "f64" if x.dtype == torch.float64 else "f32"
        fn = earlier.fn(f"window_stencil_{tag}")
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        y = torch.empty_like(x)

        def earlier_spmv(full=full, x=x, offs_t=offs_t, y=y, fn=fn):
            cuda_lib.check(fn(0, ptr(full), ptr(x), x.shape[0], ptr(offs_t), offs_t.numel(),
                              ptr(y), n, stream), "earlier window_stencil")
            return y

        fields = b * 2 * x.numel()
        out[name] = dict(
            _compare(earlier_spmv, lambda comp=comp, x=x, offs=offs: ws.window_spmv_compact(
                comp, x, fine, offsets=offs, trim=False), REPS),
            compact_table_equal=torch.equal(comp, ws.compact_spmv_window(full, offs, fine)),
            full_weight_bytes=b * full.numel(), compact_weight_bytes=b * comp.numel(),
            bound_ms=(b * int(torch.count_nonzero(comp)) + fields) / 3.35e12 * 1e3,
            stream_bound_ms=(b * comp.numel() + fields) / 3.35e12 * 1e3,
            full_stream_bound_ms=(b * full.numel() + fields) / 3.35e12 * 1e3)
    return dict(phase="spmv", deck_n=DECK_N, s_pad=xs.s_pad, checks=out,
                all_bit_equal=all(v["bit_equal"] for v in out.values()))


def _earlier_apply(build: Build, wc, x, pairs, co, wc2, pairs2, streamed: bool):
    """A call of the earlier build's parity_apply (``streamed``: its streamed
    form) into a buffer allocated once, on this checkout's tables."""
    ptr, dev = cuda_lib.ptr, x.device
    c, px, sp = x.shape
    m2 = 0 if wc2 is None else wc2.shape[1]
    common = (ptr(wc), wc.shape[0], wc.shape[1], ptr(wc2), 1 if wc2 is None else wc2.shape[0],
              m2, ptr(x), c, px)
    y = torch.empty((co, 8, sp), dtype=x.dtype, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    if streamed:
        route, runs, n_runs, chan, sched = pstl._stream_tables(pairs, pairs2, wc.shape[1], m2,
                                                               px, dev)
        fn = build.fn("parity_apply_streamed_f32")
        args = (*common, ptr(route), ptr(runs), n_runs, chan, ptr(sched), pstl.STREAM_Q,
                pstl.STREAM_WARPS, pstl.STREAM_THREAD_Q, ptr(y), co, sp, stream)
        bufs = (route, runs, sched, y)
    else:
        route = pstl._route_table(pairs, pairs2, wc.shape[1], m2, px, dev)
        fn = build.fn("parity_apply_f32")
        args = (*common, ptr(route), ptr(y), co, sp, stream)
        bufs = (route, y)

    def run():
        cuda_lib.check(fn(*args), "earlier parity_apply")
        return y
    run.buffers = bufs   # alive as long as the call is
    return run


def _cut(pairs):
    """Each class of a route cut to the shortest class's length."""
    if pairs is None:
        return None
    n = min(len(cls) for cls in pairs)
    return tuple(tuple(cls[:n]) for cls in pairs)


# fixed dealings of the 8 classes to the streamed kernel's 4 warps, as
# (offsets, items) of a schedule (one item a class and block)
_DEALINGS = {"w_w4": ([0, 2, 4, 6, 8], [0, 4, 1, 5, 2, 6, 3, 7]),
             "w_7w": ([0, 2, 4, 6, 8], [0, 7, 1, 6, 2, 5, 3, 4])}


def _dealt_apply(wc, x, pairs, co, wc2, pairs2, schedule):
    """A call of this build's streamed parity_apply with the warp schedule
    ``schedule`` (offsets, items) in place of ``stream_schedule``'s."""
    ptr, dev = cuda_lib.ptr, x.device
    c, px, sp = x.shape
    m2 = 0 if wc2 is None else wc2.shape[1]
    route, runs, n_runs, chan, _ = pstl._stream_tables(pairs, pairs2, wc.shape[1], m2, px, dev)
    sched = torch.tensor(schedule[0] + schedule[1], dtype=torch.int32, device=dev)
    y = torch.empty((co, 8, sp), dtype=x.dtype, device=dev)
    args = (ptr(wc), wc.shape[0], wc.shape[1], ptr(wc2), 1 if wc2 is None else wc2.shape[0], m2,
            ptr(x), c, px, ptr(route), ptr(runs), n_runs, chan, ptr(sched), pstl.STREAM_Q,
            pstl.STREAM_WARPS, pstl.STREAM_THREAD_Q, ptr(y), co, sp, cuda_lib.stream_ptr(dev))
    fn = cuda_lib.function("parity_apply_streamed_f32")

    def run():
        cuda_lib.check(fn(*args), "parity_apply (streamed, dealt)")
        return y
    run.buffers = (route, runs, sched, y)   # alive as long as the call is
    return run


def parity_checks(earlier: Build, tag: str, forms, window_forms=(), cut_forms=()) -> dict:
    """Every ``parity_apply`` form of both builds in both field forms
    (``forms``: (name, wc, x, pairs, wc2, pairs2)), row 12's class tables on
    the resident kernel (``window_forms``: (name, wp, x, pairs)) and, for the
    names in ``cut_forms``, the same launches on the route with each class of
    each table cut to the shortest class's length (what the classes'
    different lengths cost) and this build's streamed launch under each
    fixed dealing (``_DEALINGS``; "earlier" the dealing, "this" the
    schedule): bit equality and device times in turns (``_compare``), the
    bytes of the whole weight tables the kernels stream and the byte bound
    of their nonzero weights and the fields (3.35 TB/s, as ``chip_smoke.py``
    counts it)."""
    out = {}

    def sizes(tables, x, co):
        fields = 4 * (x.numel() + co * 8 * x.shape[-1])
        nz = sum(int(torch.count_nonzero(t)) for t in tables)
        return dict(weight_bytes=4 * sum(t.numel() for t in tables),
                    bound_ms=(4 * nz + fields) / 3.35e12 * 1e3)

    for name, wc, x, pairs, wc2, pairs2 in forms:
        co = 3
        routes = [("", pairs, pairs2)]
        if name in cut_forms:
            routes.append(("_cut", _cut(pairs), _cut(pairs2)))
        for sfx, prs, prs2 in routes:
            for streamed in (False, True):
                this = (lambda wc=wc, x=x, prs=prs, wc2=wc2, prs2=prs2, s=streamed:
                        pstl.parity_apply(wc, x, pairs=prs, co=co, wc2=wc2, pairs2=prs2,
                                          stream_x=s))
                key = f"{name}{sfx}_{'streamed' if streamed else 'resident'}"
                out[key] = dict(
                    _compare(_earlier_apply(earlier, wc, x, prs, co, wc2, prs2, streamed),
                             this, REPS),
                    entries=[len(c) + (0 if prs2 is None else len(prs2[p]))
                             for p, c in enumerate(prs)],
                    **sizes([wc] + ([] if wc2 is None else [wc2]), x, co))
        if name in cut_forms:
            greedy = lambda wc=wc, x=x, pairs=pairs, wc2=wc2, pairs2=pairs2: pstl.parity_apply(
                wc, x, pairs=pairs, co=co, wc2=wc2, pairs2=pairs2, stream_x=True)
            for dealing, schedule in _DEALINGS.items():
                out[f"{name}_streamed_dealt_{dealing}"] = _compare(
                    _dealt_apply(wc, x, pairs, co, wc2, pairs2, schedule), greedy, REPS)
    for name, wp, x, pairs in window_forms:
        m, sp, co = wp.shape[1], wp.shape[2], x.shape[0]
        flat = wp.reshape(1, 8 * m, sp)
        route = pstl._class_route(pairs, m)
        out[name] = dict(
            _compare(_earlier_apply(earlier, flat, x, route, co, None, None, False),
                     lambda wp=wp, x=x, pairs=pairs: pstl.parity_window_apply(wp, x, pairs=pairs),
                     REPS),
            entries=[len(c) for c in pairs], **sizes([wp], x, co))
    return dict(phase="parity_apply", deck=tag, sp=forms[0][2].shape[-1],
                all_bit_equal=all(v["bit_equal"] for v in out.values()), checks=out)


def _window_forms(xs, rng):
    """Row 12's class tables on the interleaved explicit solver ``xs``: its
    K_vals (8, 125, Sp) and G_win's first direction (8, 27, Sp), split by
    class and compacted as ``chip_smoke.py`` window_apply does."""
    fine, dev = xs.fine_dims, xs.device
    cdims, sp = pstl.parity_dims(fine)

    def tables(win, offs):
        wp = pstl.parity_window_tables(win.cpu().numpy(), offs, fine)
        wp_c, pairs_c = pstl.compact_class_tables(wp, pstl.parity_pairs(offs, cdims))
        return torch.from_numpy(wp_c).to(dev), pairs_c

    r = xs.g_radius
    g_offs = tuple((dx, dy, dz) for dz in range(-r, r + 1)
                   for dy in range(-r, r + 1) for dx in range(-r, r + 1))
    wk, pk = tables(xs.d["K_vals"], pstl.decode_offsets(xs.k_offsets, fine))
    wg, pg = tables(xs.d["G_win"][0], g_offs)
    u = torch.from_numpy(rng.standard_normal((3, 8, sp)).astype(np.float32)).to(dev)
    x = torch.zeros(1, 8, sp, device=dev)
    x[0, 0, : xs.nnp] = torch.from_numpy(rng.standard_normal(xs.nnp).astype(np.float32))
    return [("window_k", wk, u, pk), ("window_g", wg, x, pg)]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="an earlier checkout (at least its cfd_with_cuda_tpu_torch/csrc)")
    ap.add_argument("--parts", nargs="+", choices=_PARTS, default=list(_PARTS),
                    help="what to compare (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_build: no CUDA device available")
    parts = set(args.parts)

    against, probe = build_tools(args.against)
    earlier = Build("earlier", against)
    probe_fn = probe.cg_probe_f32
    probe_fn.restype, probe_fn.argtypes = ctypes.c_int, _PROBE_SIGNATURE
    cuda_lib.build_all()
    this = Build("this", {name: cuda_lib._library(name) for name in _SOURCES})
    builds = (earlier, this)
    _emit(dict(phase="builds", against=str(args.against), parts=sorted(parts)))
    f32 = dict(dtype_policy=DTypePolicy.F32)
    ok = dict(cg=True, parity=True)
    rng = np.random.default_rng(20261200)

    def cg_line(*a):
        line = cg_window(builds, probe_fn, *a)
        ok["cg"] &= line["all_bit_equal"]
        _emit(line)

    def parity_line(*a, **kw):
        line = parity_checks(earlier, *a, **kw)
        ok["parity"] &= line["all_bit_equal"]
        _emit(line)

    # NE27000: the interleaved explicit solver (G, G^T, row 12's class
    # tables, the 125-slot Z), then both parity solvers (every parity_apply
    # form; the implicit solver's 27-slot Z)
    deck = cavity_deck(DECK_N, cluster=2.0, viscosity=0.01, dt=0.001)
    windows, window_forms = [], []
    if parts & {"stencils", "cg", "parity"}:
        s = ExplicitBCHSolver(deck, SolverConfig(structured_layout="interleaved", **f32))
        if "stencils" in parts:
            _emit(stencil_checks(earlier, s))
            i = ImplicitGQSolver(deck, SolverConfig(structured_layout="interleaved", **f32))
            line = spmv_checks(earlier, s, i)
            ok["spmv"] = line["all_bit_equal"]
            _emit(line)
            del i
        windows.append(("ne27000_z125", s.d["Z_win"], ws.window_offsets(s.coarse_dims,
                                                                         s.z_radius),
                        s.d["Z_dinv"]))
        if "parity" in parts:
            window_forms = _window_forms(s, rng)
        del s
    i = ImplicitGQSolver(deck, SolverConfig(**f32))
    windows.append(("ne27000_z27", i.d["Z_win"], ws.window_offsets(i.coarse_dims, i.z_radius),
                    i.d["Z_dinv"]))
    if "parity" in parts:
        s = ExplicitBCHSolver(deck, SolverConfig(**f32))
        parity_line("ne27000", pstl.parity_forms(s, i, rng), window_forms)
        del s, window_forms
    del i
    if "cg" in parts:
        for seed, (tag, win, offs_w, dinv) in enumerate(windows):
            cg_line(tag, win, offs_w, dinv, 20261100 + seed)
    del windows
    torch.cuda.empty_cache()

    # the BFS band, then NE85184 (the explicit Z; every parity_apply form,
    # and what the classes' different lengths cost the streamed K and K + A)
    if "cg" in parts:
        s = ExplicitBCHSolver(bfs_deck(*BFS_DIMS, dt=0.002, **BFS_KW), SolverConfig(**f32))
        cg_line("bfs_band", s.d["Z_bwin"], s.z_offs, s.d["Z_dinv"], 20261110)
        del s
        torch.cuda.empty_cache()
    ne85 = cavity_deck(NE85_N, cluster=2.0, viscosity=0.01, dt=5e-4)
    s = ExplicitBCHSolver(ne85, SolverConfig(**f32))
    if "cg" in parts:
        cg_line("ne85184_z125", s.d["Z_win"], ws.window_offsets(s.coarse_dims, s.z_radius),
                s.d["Z_dinv"], 20261120)
    if "parity" in parts:
        i = ImplicitGQSolver(ne85, SolverConfig(**f32))
        parity_line("ne85184", pstl.parity_forms(s, i, rng), cut_forms=("k", "k_plus_a"))
        del i
        # a non-cubic box, whose coarse shifts differ by axis
        box = box_cavity_deck(viscosity=0.01, dt=0.01)
        parity_line("box534", pstl.parity_forms(ExplicitBCHSolver(box, SolverConfig(**f32)),
                                            ImplicitGQSolver(box, SolverConfig(**f32)), rng))
    del s
    _emit(dict(phase="summary", cg_all_bit_equal=ok["cg"] if "cg" in parts else None,
               parity_all_bit_equal=ok["parity"] if "parity" in parts else None,
               spmv_all_bit_equal=ok.get("spmv")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
