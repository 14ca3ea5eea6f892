#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py      # NE27000, NE85184, NE125000 cavities, NE144600-class BFS, the bend
    python3 chip_smoke.py --deck-n 4 --steps 8 --implicit-steps 8 \
        --bfs-dims 12x4x4 --bfs-steps 8 --bfs-implicit-steps 8 \
        --ne85-n 4 --ne85-steps 8 --ne85-finite-steps 12 --ne85-implicit-steps 8 \
        --xla-steps 8 --xla-implicit-steps 4 \
        --cli-steps 8 --bend-dims 16x8x8 --bend-steps 8 --bend-implicit-steps 6 \
        --legacy-poisson-n 16 --legacy-stokes-n 6 --legacy-ns-n 6 --legacy-outer 4 \
        --legacy-cli-n 4 --import-n 4 --tet-ns 4,8 --ne125-n 4 --ne125-steps 8   # quick

Drives the port's main paths on the generated NE27000 lid-driven cavity
(``cavity_deck(30, cluster=2.0)``, 61^3 velocity and 31^3 pressure nodes):
the explicit BCH solver, ``ExplicitBCHSolver(deck, config).run(...)``, with
the F32 / CG tol 1e-6 / warm-started, fused-CG configuration, and the
implicit GQ solver, ``ImplicitGQSolver(deck, config).run(...)``, with the F32 /
CG tol 1e-6 configuration and the default per-iteration CG.  It checks:

1. toolchain: card, power limit, CUDA, nvcc, triton, and the kernel build
   (every ``csrc/*.cu`` compiled from the checkout, in parallel);
2. kernels: every launch form of the path (K, G, K + A planes, G^T, and the
   CG cold and warm) at the path's shapes and tables, against its plain
   PyTorch version on the card, with each tolerance and its reason, the
   kernel, plain and library times, and the roofline bound;
3. e2e: warm-up then timed steps with the launch counters set to 0 just
   before, every count > 0 and equal to what the sub-iteration history
   implies, finite fields; then 3 steps of the kernel path and of the plain
   path from the same state, which must agree; and on the NE27000 deck the
   100-step monitor trace and final velocity against the stored f64 run
   (``cfd_with_cuda_tpu/validation/data/precision_ne27000.npz``, bounds of
   ``tests/test_validation.py:194-195``);
4. CG modes: ``cg_solve``, ``cg_init`` + ``cg_iter`` (one launch a group of
   the unroll), the compensated dot and the symmetric half window, on the
   explicit solver's 125-slot Z and the implicit solver's 27-slot Z (and in
   phase 7 the NE85184 explicit Z), cold and warm, each against its plain
   version, with each solution's f64 true residual ||b - Z x|| / ||b||;
   ``comp_dot_f32`` alone against the f64 dot and the half-window apply
   alone against the full-window apply;
5. e2e_implicit: warm-up then timed steps from rest with the launch counts
   held against the iteration history, 3 steps of the kernel path against
   the plain path, then 10 steps under MIXED and 10 with ``pressure_cg_sym``
   against their plain paths, and on the NE27000 deck 20 steps at dt = 0.01
   from the stored developed state
   (``cfd_with_cuda_tpu/validation/data/cavity_re100_implicit_state.npz``);
6. the interleaved structured layout of both solvers on the same cavity
   (``structured_layout="interleaved"``, fields (3, 227,328)):
   ``kernels_interleaved`` (every launch form of the window kernel: the
   SPMV on the class-compacted, class-major table (``window_spmv_compact``,
   what the solvers launch) for K, the "assemble" K + A, the implicit MK + A
   and M, each also bit for bit against the full-window SPMV
   (``window_spmv``) on the full table, with both timed; G on the
   class-compacted window (``grad_window_compact``, its plain version also
   bit for bit against ``grad_window_plain``) and ``div_window``, in f32 and
   the three forms in f64, and the compact G^T on the interleaved field,
   against their plain versions on the solvers' own tables; device, plain
   and cuSPARSE CSR times and the byte bound), ``e2e_interleaved`` (rung 3 of bench.py's
   ladder from rest: launch counts held against the sub-iteration history,
   3 steps against the plain path and against the port's parity solver
   from the same fields, 10 steps each of ``conv_mode="assemble"``, MIXED
   and ``pressure_cg_sym`` against their plain paths) and
   ``e2e_interleaved_implicit`` (the same for the implicit solver, without
   "assemble"); ``window_apply`` (the class-split window apply, TPU kernel
   row 12, on the interleaved solver's K (rebuilt from its compact table)
   and ``G_win`` split by class: against its plain version and, after
   ``parity_merge``, against ``window_spmv_compact`` / ``grad_window``);
7. the parity layout of both solvers on the NE85184 cavity
   (``cavity_deck(44, cluster=2.0, dt=5e-4)``, the JAX package's "ne85"
   bench row), where the JAX package's 6 MiB rule streams every velocity
   field: ``e2e_ne85`` (explicit, 5 + 60 steps from rest, every K and K + A
   launch in the streamed form as the sub-iteration history implies, 3
   steps against the plain path, on untimed to step 200 with finite
   fields), the CG modes of phase 4 on its Z, ``kernels_streamed`` (the
   streamed kernel, TPU kernel row 3, in its K, K + A and MK + A forms on
   the solvers' own tables: bit for bit against the resident form, against
   the plain version, cuSPARSE CSR times) and ``e2e_ne85_implicit`` (20 steps from rest, the streamed M
   and MK + A launches held against the history, 3 steps against the plain
   path), and the compact G^T at those shapes.  At NE27000 the streamed
   form is forced in ``kernels`` and held bit for bit against the resident
   one; ``parity_apply_box``: both forms of every ``parity_apply`` form on
   a non-cubic 5 x 3 x 4-element box's routes (``box_cavity_deck()``,
   coarse shifts that differ by axis), against the plain version and bit
   for bit against each other;
8. the unstructured path of both solvers on the backward-facing step
   ``bfs_deck(96, 40, 40)`` (138,400 hexes, 1,143,153 velocity and 147,477
   pressure nodes; natural outflow): ``bfs_setup`` (the explicit solver's
   host setup and its 275-slot banded pressure window), ``banded_cg``
   (``cg_init`` + ``cg_iter`` and ``cg_solve`` on that window against the
   plain version: converged solves and a fixed 0, 1 and 40 iterations, both
   dot modes; device times, byte bound, a CSR ``torch.mv`` of the same Z),
   ``e2e_bfs`` (the explicit solver from rest, launch counts, the flow
   reaching the outflow plane, 3 steps against the plain path) and
   ``e2e_bfs_implicit`` (the implicit ELL step at dt 0.01: torch ops only,
   no launch; the outflow pressure rows stay 0; 3 steps against the plain
   path);
9. the XLA structured path of both solvers on the cavity (the JAX
   package's default ``SolverConfig()``: F64 and the multigrid V-cycle, torch
   ops only, every hand-written kernel's launch counter at 0):
   ``e2e_xla_f64`` (100 explicit steps from rest in the stored f64 run's
   config, held against ``precision_ne27000.npz``'s f64 rows: the final
   field and the CG count of every step, the monitor trace printed; ms/step,
   peak memory; its first 3 steps against the port's CPU path on the same
   tables), ``e2e_xla_f64_implicit`` (20 implicit steps from rest in the
   default F64 config with ``"mg"`` and with ``"jacobi"``: counts and the
   fields held together), ``e2e_xla_f32_mg`` (F32 through the V-cycle
   against the same stored run at the f32 bounds) and ``xla_card_vs_cpu``
   (3 F64 steps of both solvers on ``cavity_deck(8)``, card against CPU);
10. the run workflow through the command line, ``python -m
   cfd_with_cuda_tpu_torch`` (``__main__.main`` in-process; F32, CG tol
   1e-6, warm start, the default CG loop, ``setup_cache="auto"`` pointed at a
   temporary directory): ``cli_cavity`` (the NE27000 deck written to disk:
   run A, a setup-cache miss, and run B, a hit, with byte-equal ``.dat`` and
   ``_restart.dat``; the library run D on the same file, whose step-30 dump
   is byte-equal to A's; run C with ``isRestart`` resuming from the step-30
   checkpoint, its first state the file's fields and its ``u_mon`` within
   rtol 2e-4 of D's; launch counts, setup, snapshot, Tecplot write and read
   seconds) and ``cli_bend_explicit`` / ``cli_bend_implicit`` (the full-size
   ``bending_duct_deck()``, 48 x 32 x 32 elements: the parity layout, the
   field form, setup and ms/step, counts, launches, a traced busy share,
   the flow out of the outflow plane, and the first 3 steps against the
   plain path; the implicit pressure solves also against f64 solves);
11. the legacy solvers in float64 (``legacy_poisson``, ``legacy_stokes``,
   ``legacy_ns``, ``legacy_cli``), card against CPU and host ``splu``, every
   launch counter at 0;
12. mesh import and the NE125000 cavity: ``import_neu`` (the NE27000 corner
   mesh written as a Gambit .neu, read by ``read_neu``, made a Q2/Q1 deck by
   ``deck_from_mesh(..., quadratic=True)`` and run by the explicit solver at
   rung 1's config on the parity layout: the BC tables on the card against
   the import's and, but for the seam of the two node groups, the
   generator's; 5 + 20 steps with launch counts, 3 against the plain path),
   ``import_unv_tet`` (the unit cube split into six tets a hex at n = 16 and
   32, written as an IDEAS .unv, read by ``read_unv`` and solved by
   ``PoissonSolver``: card against CPU, equal CG counts, the MMS error's
   fall; no launch), ``e2e_ne125`` (the "ne125" row of the JAX package's
   bench matrix, ``cavity_deck(50, cluster=2.0, dt=4e-4)``: 5 + 25 steps
   with launch counts on the flat convection route with every K streamed,
   3 against the plain path; its host setup runs in a worker process on the
   CPU beside phases 2-11 and reaches the phase through the setup cache) and
   ``ghia_seeded`` (phase 5's seeded state against Ghia et al. within
   ``BAND_3D``);
13. the sharded kernel path (``parallel/``, ``spmd_devices``): (c)
   ``spmd_kernels`` inside phase 6, on its NE27000 tables: the sharded K,
   K + A, MK + A, M, G and G^T applies on 1 and 4 ranks' blocks joined equal
   to the single-device kernels bit for bit, G^T (the compact kernel on a
   rank's coarse rows) also against the full-window DIV mode, each against
   its plain version with device times beside the bound and phase 6's
   cuSPARSE; (a) ``spmd1_explicit`` / ``spmd1_implicit`` inside phase 6, on
   its solvers' tables: ``spmd_devices=1`` over a one-rank NCCL group, 5 +
   20 explicit steps (rung 3's config; 5 more with ``conv_mode="assemble"``)
   and 5 + 10 implicit (cell 2's), launch counts against the history,
   ms/step beside phase 6's, the collectives a step and their bytes, 3 steps
   against the single-device path; (b) ``spmd_ranks`` at the end: 2 and 4
   ranks spawned on the one card over gloo (CUDA tensors staged through
   pinned host buffers) at ``cavity_deck(8)``, the explicit, the implicit
   and the implicit step with ``momentum_solver="cr"`` (its dots summed over
   the ranks), held against one rank within the JAX package's sharded
   tolerances, equal explicit CG counts, rank 0's launches against its
   history by its momentum solver's A applies;
14. the annotation-placed paths (``parallel/placement.py::place``, the JAX
   caller's ``shard_params`` + ``shard_state`` before GSPMD): (a)
   ``placed_xla_f64`` / ``placed_xla_f64_implicit`` inside phase 9 (the JAX
   package's default ``SolverConfig()`` on its NE27000 tables; and
   ``placed_xla_f64_implicit_cr`` with ``momentum_solver="cr"``, where bit
   for bit is required) and
   ``placed_bfs`` / ``placed_bfs_implicit`` inside phase 8 (on its tables),
   each placed over a one-rank NCCL group against one device, 3 steps from
   rest in turns: bit for bit expected (the gap printed otherwise, beside
   the single-device path's own run-to-run gap), equal counts and launches,
   ms/step of both, the collectives a step; (b) ``placed_ranks`` at the end:
   2 and 4 ranks spawned on the one card over gloo on the five decks of
   ``tests/test_sharding.py`` (F64, ``shard_pad=8``) and its implicit box
   with ``momentum_solver="cr"``, against one device at that file's
   tolerances.

Each phase prints one JSON line.  Any failure raises (non-zero exit, no
result line).  The last lines are the ``kernels`` summary, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  In the summary a
row's ``ms``, ``plain_ms`` and ``bound_ms`` are per launch, the unit of its
``launches``: ``cg_iter`` and ``cg_iter_banded`` per launch of a group of
UNROLL iterations (the phase lines give the same per iteration).  The
``parity_apply`` rows' ``ms`` is device time (``queued_ms``: calls queued
behind other device work, so the wrapper's host work does not enter); the
phase lines give the CUDA-event time per call beside it (``event_ms``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32, outside the tensor cores
FP64_FLOP_PER_S = 34e12          # H100 SXM fp64, outside the tensor cores (data sheet)
WARMUP_STEPS = 5
FLUSH_BYTES = 1 << 30     # read ahead of a timed call: 20x the 50 MB L2, ~0.3 ms a read
APPLY_TOL = 1e-5   # of the largest sum |w x|: FMA vs rounded product over <= 1241 terms, same order
# the window kernel against its plain version, of the largest sum |w x|: the same <= 125
# terms in the same order, the kernel's FMA against torch's rounded product: at most a
# rounding per term, f32 (the parity applies read <= 8.2e-8 over up to 1241 terms) and f64
# (the 1e-12 of the JAX package's f64 fixtures, tests/test_pallas_stencil.py:71)
WINDOW_TOL = 1e-6
WINDOW_TOL_F64 = 1e-12
CG_X_TOL = 1e-3    # of max|x|: two f32 CGs whose dots sum in different orders, run to convergence
# the same CG after a FIXED 0, 1 and 40 iterations (tol = 0), where nothing is forgiven
# by convergence: x of max|x|, and |r| relative to itself, by depth.  0: one apply and
# one dot.  40: |r| has fallen by orders while the error that x carries into it has not
# (read 3e-7 of max|x| in x beside 1.1e-2 of |r| on the implicit Z), so x is the check
# and |r| only guards against a wrong recurrence
CG_FIXED_X_TOL = 1e-5
CG_FIXED_R_TOL = {0: 1e-5, 1: 1e-4, 40: 5e-2}
# where a system's own f32 rounding reaches past CG_FIXED_X_TOL at a fixed depth (the
# full-size bend's warm-started implicit Z, where Z x0 cancels in r0: kernel and plain
# CG read 7.1e-6 of max|x| apart after 1 iteration and 1.2e-5 after 40 on an H100), the
# kernel CG is held within this factor of the plain f32 CG's distance from the plain CG
# on the f64 widened system at the same depth: two f32 sums in other orders against one
CG_ROUNDING_FACTOR = 4
# a converged f32 CG against its own system: the f64 true residual ||b - Z x|| / ||b||
# (Z the f32 table widened to f64), in units of the solve's tol on the recurrence residual.
# On the card every converged kernel and plain solve of cg_modes (NE27000 explicit and
# implicit Z, NE85184 Z) and banded_cg read 0.77 to 1.19 tol; a solve whose x is off by
# more than its recurrence claims reads above 2
CG_TRUE_RES_TOL = 2.0
STEP_TOLS = dict(u=5e-6, p=5e-5, mon=5e-6)   # tests/test_parity_stencil.py:285-289
# implicit steps, tests/test_parity_stencil.py:344-354: the f32 BiCGStab stops at
# 1e-6 of |b|, which two summation orders meet with solutions ~2e-5 apart
IMPLICIT_TOLS = dict(u=5e-5, p=5e-5, cg_iters=4, mom_iters=1)
# CG counts of the 10 MIXED steps: at this deck |r| does not fall through tol |b|
# monotonically: it dips to 0.7-1.6 of the bound at k = 180-184, is back above it at
# 188-192 and falls below for good at k = 196, while kernel and plain |r| differ by 13-34 % at that
# depth in either dot mode (python -m cfd_with_cuda_tpu_torch.cg_trace).  Whether a solve
# stops in the dip or 12-16 iterations later hangs on rounding; the F32 and half-window
# runs on the parity layout happen to take the same side on every step and keep the
# bound of 4.  The interleaved layout's half-window run took the other side on one of
# its 10 steps (180 against 196, fields within 1.2e-6) and takes this bound too
MIXED_CG_ITERS_TOL = 16
UNROLL = 4         # SolverConfig.pressure_cg_unroll
SEEDED_U_MON = -0.2051389   # cavity_re100_implicit.npz: u_mon of the stored state at t = 250
# the backward-facing step of the JAX package's bench matrix at the NE144600 class's full
# size (scripts/bench_matrix.py:166-177 ran 48x20x20): 138,400 hexes after the step block
BFS_DIMS = (96, 40, 40)
BFS_KW = dict(lengths=(15.0, 2.0, 2.0), step_frac=(0.2, 0.5), viscosity=0.01)
# kernel path against plain path on the BFS, 3 steps: u and p of max|u|, max|p| (the
# implicit bound, as these CGs stop at 1e-6 of |b| through ~100 iterations), CG counts
# within one group of 4
BFS_TOLS = dict(u=5e-5, p=5e-5, cg_iters=4, mom_iters=1)
BFS_FIXED_DEPTHS = (0, 1, 40)
BFS_OUTFLOW_STEPS = 1000
# the NE85184 cavity, the "ne85" row of the JAX package's bench matrix
# (scripts/bench_matrix.py:136-150): cavity_deck(44, cluster=2.0, viscosity=0.01,
# dt=5e-4), 85,184 hexes, 704,969 / 91,125 nodes; dt is half NE27000's because
# 1e-3 blew up near step 100 at 44^3.  Its 9.28 MB halo-extended velocity field
# is over the JAX package's 6 MiB, so every K, K + A, MK + A and M apply streams
NE85_N = 44
NE85_DT = 5e-4
# CG counts of the NE85184 implicit check of 3 kernel steps against 3 plain steps.  The
# warm-started f32 CG stops at 1e-6 of |b|, while r0 = b - Z x0 (x0 the last step's
# increment, nearly the solution) carries cancellation at f32 rounding, so two paths that
# differ by rounding run different residual histories near the bound.  On the card
# (python -m cfd_with_cuda_tpu_torch.cg_trace --deck-n 44 --policy f32
# --from-rest 20 --steps 3 [--path plain]): on the plain path's second system
# |r| / (tol |b|) is 0.86-1.26 from k = 212 to 232 and below 1 again only at 336, on
# the kernel path's it is above 40 from k = 212 to 272 and first below 1 at 320; the
# paths stopped at 212 and 320 with fields 7e-7 (u) and 1.8e-5 (p) apart.  The fields
# keep IMPLICIT_TOLS; the counts may part by the span from the first dip to the last
# crossing
NE85_CG_ITERS_TOL = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel_name: str, reps: int) -> float:
    """Mean device time of the kernel whose name holds ``kernel_name`` over
    ``reps`` calls of ``fn`` (torch.profiler), whatever the host does between
    the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace may drop a launch or two; in a long process one now and then
    # holds no device events at all, so a session that saw too few is redone
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.name]
        if len(spans) >= reps // 2:
            return sum(spans) / len(spans) / 1e3
    raise AssertionError(f"profiler saw {len(spans)} launches of {kernel_name} in {reps} calls")


def cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` with a cold L2, as a solver step finds a
    table it last read before passing other tables through: each call is
    queued behind two reads of a FLUSH_BYTES buffer (~0.6 ms, longer than a
    call's host work, so the call's kernels run back to back after them) and
    timed by CUDA events around the call alone."""
    import torch

    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")   # f32: its sum writes one value
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        buf.sum()
        buf.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del buf
    return total / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), the calls queued behind reads of a FLUSH_BYTES buffer that keep
    the card busy until the host has enqueued them all, so that the
    wrappers' host work does not enter (``fn`` must not wait for the card).
    The reads double until they outlast the host's enqueueing; where they
    never do, the last time is returned (it then reads the host as well, as
    ``time_ms`` does) and a ``timing_note`` line says so."""
    import torch

    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")   # f32: its sum writes one value
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fn()
    torch.cuda.synchronize()
    reads = 16                       # ~5 ms of device work ahead of the calls
    for _ in range(4):
        ev[0].record()
        for _ in range(reads):
            buf.sum()
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            break
        reads *= 2
    else:
        emit(dict(phase="timing_note", queued=False, host_ms=host_ms, reads=reads // 2))
    del buf
    return ev[1].elapsed_time(ev[2]) / reps


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time of a function: the larger of its bytes over the HBM rate
    and its operations over the peak rate of their type.  Every bound here
    counts a weight table by its nonzero weights (``nnz``), the ones the
    function needs; the phase lines give the whole table's time beside it
    (``stream_bound_ms``), the bytes the kernels read."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nnz(table) -> int:
    import torch

    return int(torch.count_nonzero(table))


# ---------------------------------------------------------------- phase 1

def phase_toolchain(cuda_lib) -> dict:
    import torch

    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_info = triton.__version__
    except ImportError as e:
        triton_info = f"not importable: {e}"
    t0 = time.time()
    logs = cuda_lib.build_all(extra_flags=("-Xptxas", "-v"))
    build_s = time.time() - t0
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    out = dict(phase="toolchain", card=smi_line(), torch=torch.__version__,
               torch_cuda=torch.version.cuda, nvcc=nvcc[-1], triton=triton_info,
               kernel_build_s=build_s, ptxas=ptxas)
    emit(out)
    return out


# ---------------------------------------------------------------- phase 2

def _csr(rows, cols, vals, shape):
    import torch

    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                check_invariants=False).coalesce()
    return a.to_sparse_csr()


def _route_csr(tables, routes, sp, n_in_classes, per_channel):
    """The parity apply as one sparse matrix, for the library yardstick.

    ``tables``: weight tensors (cw, m_t, Sp); ``routes``: pairs tuples, one
    per table.  Shared weights (cw = 1): rows p*Sp + q, cols p_in*Sp + q + dq.
    Per-channel weights (cw = 3, one input channel): rows (c*8 + p)*Sp + q.
    """
    import torch

    dev = tables[0].device
    q = torch.arange(sp, device=dev)
    rows, cols, vals = [], [], []
    for w, pairs in zip(tables, routes):
        for p, cls in enumerate(pairs):
            if not cls:
                continue
            e = torch.tensor(cls, device=dev)              # (E, 3): j, p_in, dq
            j, pp, dq = e[:, 0], e[:, 1], e[:, 2]
            qs = q[None] + dq[:, None]
            ok = (qs >= 0) & (qs < sp)
            chans = range(w.shape[0]) if per_channel else (0,)
            for c in chans:
                r = (c * 8 + p) * sp + q[None].expand_as(qs) if per_channel else p * sp + q[None].expand_as(qs)
                rows.append(r[ok])
                cols.append((pp[:, None] * sp + qs)[ok])
                vals.append(w[c][j][ok])
    n_rows = (tables[0].shape[0] if per_channel else 1) * 8 * sp
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n_rows, n_in_classes * sp))


def _div_csr(gt, pairs, sp):
    import torch

    dev = gt.device
    q = torch.arange(sp, device=dev)
    e = torch.tensor(pairs, device=dev)
    cls, off = e[:, 0], e[:, 1]
    qs = q[None] + off[:, None]
    ok = (qs >= 0) & (qs < sp)
    rows, cols, vals = [], [], []
    for d in range(3):
        rows.append(q[None].expand_as(qs)[ok])
        cols.append(((d * 8 + cls[:, None]) * sp + qs)[ok])
        vals.append(gt[d][ok])
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (sp, 24 * sp))


def _apply_err(y, y_plain, y_abs):
    """(max |y - y_plain|, its ratio to the largest sum |w x|)."""
    err = float((y - y_plain).abs().max())
    return err, err / float(y_abs.abs().max())


def _div_compact_check(pstl, window_stencil, gt, u, coarse_dims) -> dict:
    """The class-major compact G^T apply (TPU kernel row 4) on ``u (3, 8,
    Sp)``: against its plain version (APPLY_TOL); the kernel's and cuSPARSE
    CSR's device times (``queued_ms``; the CUDA-event times per call beside them,
    which also read the wrapper's host work; and with a cold L2: the 46 MB
    table may stay in the 50 MB L2 when launches run back to back), the plain
    version's time; the bound of the nonzero weights."""
    import torch

    sp = u.shape[-1]
    y = pstl.parity_div_apply(gt, u, coarse_dims)
    y_plain = pstl.parity_div_apply_plain(gt, u, coarse_dims)
    y_abs = pstl.parity_div_apply_plain(gt.abs(), u.abs(), coarse_dims)
    err, rel = _apply_err(y, y_plain, y_abs)
    if not rel <= APPLY_TOL:
        raise AssertionError(f"div_compact: kernel vs plain {rel:.3e} > {APPLY_TOL}")
    a_d = _div_csr(gt, window_stencil.div_class_pairs(coarse_dims), sp)
    uf = u.reshape(-1)
    nbytes = 4 * (nnz(gt) + u.numel() + sp)
    b_ms, b_by = bound(nbytes, 2 * nnz(gt))
    kernel = lambda: pstl.parity_div_apply(gt, u, coarse_dims)
    out = dict(
        max_abs_err=err, err_rel=rel, tol=APPLY_TOL,
        ms=queued_ms(kernel, 20), event_ms=time_ms(kernel, 20), cold_ms=cold_ms(kernel, 20),
        plain_ms=time_ms(lambda: pstl.parity_div_apply_plain(gt, u, coarse_dims), 3),
        library_ms=queued_ms(lambda: torch.mv(a_d, uf), 20),
        library_event_ms=time_ms(lambda: torch.mv(a_d, uf), 20),
        library_cold_ms=cold_ms(lambda: torch.mv(a_d, uf), 20),
        library_abs_err=float((torch.mv(a_d, uf) - y).abs().max()),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=2 * nnz(gt),
        stream_bound_ms=bound(4 * (gt.numel() + u.numel() + sp), 0)[0],
    )
    del a_d
    return out


def phase_kernels(solver, pstl, cuda_lib, fused_cg_mod, window_stencil) -> dict:
    import numpy as np
    import torch

    d, sp = solver.d, solver.sp_c
    rng = np.random.default_rng(20260816)
    dev = solver.device
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    results = {}

    def apply_check(name, wc, x, pairs, co, wc2=None, pairs2=None, lib_fn=None, lib_out=None):
        kw = dict(pairs=pairs, co=co, wc2=wc2, pairs2=pairs2)
        y = pstl.parity_apply(wc, x, **kw)
        y_plain = pstl.parity_apply_plain(wc, x, **kw)
        y_abs = pstl.parity_apply_plain(wc.abs(), x.abs(), pairs=pairs, co=co,
                                        wc2=None if wc2 is None else wc2.abs(), pairs2=pairs2)
        torch.cuda.synchronize()
        err, rel = _apply_err(y, y_plain, y_abs)
        if not rel <= APPLY_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rel:.3e} > {APPLY_TOL}")
        # the streamed form forced at these shapes (the rule keeps them resident)
        y_s = pstl.parity_apply(wc, x, stream_x=True, **kw)
        torch.cuda.synchronize()
        if pstl.stream_field(x.shape, 4, pairs, pairs2) or not torch.equal(y_s, y):
            raise AssertionError(f"{name}: streamed form differs from the resident form")
        del y_s
        kernel = lambda: pstl.parity_apply(wc, x, **kw)
        streamed = lambda: pstl.parity_apply(wc, x, stream_x=True, **kw)
        plain_ms = time_ms(lambda: pstl.parity_apply_plain(wc, x, **kw), 3)
        lib_ms, lib_err = None, None
        if lib_fn is not None:
            lib_ms = time_ms(lib_fn, 20)
            lib_err = float((lib_out() - y).abs().max())
        tables = [wc] + ([] if wc2 is None else [wc2])
        fields = x.numel() + co * 8 * sp
        nbytes = 4 * (sum(nnz(t) for t in tables) + fields)
        # a table shared over the channels is used once per channel
        flops = sum(2 * nnz(t) * co // t.shape[0] for t in tables)
        b_ms, b_by = bound(nbytes, flops)
        results[name] = dict(max_abs_err=err, err_rel=rel, tol=APPLY_TOL,
                             ms=queued_ms(kernel, 20), event_ms=time_ms(kernel, 20),
                             streamed_bit_equal=True, streamed_ms=queued_ms(streamed, 20),
                             streamed_event_ms=time_ms(streamed, 20), plain_ms=plain_ms,
                             library_ms=lib_ms, library_abs_err=lib_err,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                             stream_bound_ms=bound(4 * (sum(t.numel() for t in tables)
                                                        + fields), 0)[0])
        del y, y_plain, y_abs

    # K u (one table, shared weights over 3 channels)
    u = rand(3, 8, sp)
    a_k = _route_csr([d["Kp"]], [solver.k_pairs], sp, 8, per_channel=False)
    ut = u.reshape(3, 8 * sp).T.contiguous()
    apply_check("parity_apply_k", d["Kp"], u, solver.k_pairs, 3,
                lib_fn=lambda: torch.sparse.mm(a_k, ut),
                lib_out=lambda: torch.sparse.mm(a_k, ut).T.reshape(3, 8, sp))
    del a_k
    # G p (one table, per-channel weights, the coarse pressure as (1, 1, Sp))
    p = torch.zeros(1, 1, sp, device=dev)
    p[0, 0, : solver.nnp] = rand(solver.nnp)
    a_g = _route_csr([d["Gp"]], [solver.g_pairs], sp, 1, per_channel=True)
    pv = p.reshape(sp)
    apply_check("parity_apply_g", d["Gp"], p, solver.g_pairs, 3,
                lib_fn=lambda: torch.mv(a_g, pv),
                lib_out=lambda: torch.mv(a_g, pv).reshape(3, 8, sp))
    del a_g
    # (K + A) u with convection planes from a seeded ae
    ne = int(np.prod(solver.elem_dims))
    ae = rng.standard_normal((27, 27, ne)).astype(np.float32) * 1e-3
    ae_e = pstl.embed_elem_table(ae, solver.elem_dims, solver.coarse_dims, sp)
    ae_t = torch.from_numpy(np.ascontiguousarray(ae_e[list(solver.conv_i_order)])).to(dev)
    planes = pstl.conv_planes_from_ae(ae_t, groups=solver.conv_groups)
    del ae_t
    a_ka = _route_csr([d["Kp"], planes], [solver.k_pairs, solver.conv_pairs2], sp, 8,
                      per_channel=False)
    apply_check("parity_apply_k_plus_a", d["Kp"], u, solver.k_pairs, 3,
                wc2=planes, pairs2=solver.conv_pairs2,
                lib_fn=lambda: torch.sparse.mm(a_ka, ut),
                lib_out=lambda: torch.sparse.mm(a_ka, ut).T.reshape(3, 8, sp))
    del a_ka, planes

    # G^T u (compact divergence)
    results["div_compact"] = _div_compact_check(pstl, window_stencil, d["GT_cwin"], u,
                                                solver.coarse_dims)

    # pressure CG, cold and warm, on a divergence-shaped right-hand side
    nnp = solver.nnp
    b = pstl.parity_div_apply_plain(d["GT_cwin"], u, solver.coarse_dims)[:nnp].clone()
    if solver.pin_grid >= 0:
        b[solver.pin_grid] = 0.0
    cfg = solver.config
    kw = dict(dims=solver.coarse_dims, radius=solver.z_radius, tol=cfg.pressure_cg_tol,
              maxiter=cfg.pressure_cg_maxiter, fuse_loop=True)
    win, dinv = d["Z_win"], d["Z_dinv"]
    cold = fused_cg_mod.fused_cg(win, b, dinv, **kw)
    x0 = (cold.x * (1 + 1e-3 * rand(nnp))).contiguous()
    for start, xs in (("cold", None), ("warm", x0)):
        sol = fused_cg_mod.fused_cg(win, b, dinv, x0=xs, **kw)
        ref = fused_cg_mod.fused_cg_plain(win, b, dinv, x0=xs, **kw)
        k, k_ref = int(sol.iters), int(ref.iters)
        err = float((sol.x - ref.x).abs().max())
        rel = err / float(ref.x.abs().max())
        true_res = float(torch.linalg.vector_norm(
            b.double() - fused_cg_mod.window_apply_plain(
                win.double(), sol.x.double(),
                window_stencil.window_offsets(solver.coarse_dims, solver.z_radius))
        ) / torch.linalg.vector_norm(b.double()))
        if abs(k - k_ref) > 1 or not rel <= CG_X_TOL or not k > 0:
            raise AssertionError(f"cg_solve {start}: k {k} vs {k_ref}, x err {rel:.3e}")
        if not (float(sol.residual) <= cfg.pressure_cg_tol * float(torch.linalg.vector_norm(b)) * 1.0001
                or k == cfg.pressure_cg_maxiter):
            raise AssertionError(f"cg_solve {start}: stopped unconverged at k={k}")
        ms = time_ms(lambda: fused_cg_mod.fused_cg(win, b, dinv, x0=xs, **kw), 20)
        plain_ms = time_ms(lambda: fused_cg_mod.fused_cg_plain(win, b, dinv, x0=xs, **kw), 2)
        w3, nz = win.shape[0], nnz(win)
        nbytes = 4 * (nz + (3 if xs is None else 4) * nnp) + 4 * w3 + 8
        flops = k * (2 * nz + 12 * nnp) + (2 * nz if xs is not None else 0) + 6 * nnp
        b_ms, b_by = bound(nbytes, flops)
        results[f"cg_solve_{start}"] = dict(
            max_abs_err=err, err_rel=rel, tol=CG_X_TOL, iters=k, iters_plain=k_ref,
            true_rel_residual=true_res, ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
        )
    emit(dict(phase="kernels", shapes=dict(sp=sp, nnp=nnp, k_planes=int(d["Kp"].shape[1]),
                                           g_planes=int(d["Gp"].shape[1]),
                                           conv_planes=27 * 27),
              checks=results))
    return results, (b, x0)


# ---------------------------------------------------------------- phase 3

def _explicit_parity_expect(hist, counts, sfx=""):
    """Launch counts a run of the explicit parity solver implies: per step of
    s sub-iterations, K + A s, K s - 1, G s + 1, G^T s and the CG s; ``sfx``
    ("_streamed" where the rule streams the field) names the K forms."""
    subs = [int(h["iters"]) for h in hist]
    on_path = {f"parity_apply_k_plus_a{sfx}": sum(subs),
               f"parity_apply_k{sfx}": sum(v - 1 for v in subs),
               "parity_apply_g": sum(v + 1 for v in subs), "div_compact": sum(subs),
               "cg_solve": sum(subs)}
    return on_path, {k: on_path.get(k, 0) for k in counts}


def phase_e2e(solver, cuda_lib, n_steps: int, ExplicitBCHSolver, precision_deck: bool) -> dict:
    import numpy as np
    import torch

    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    if len(hist) != n_steps:
        raise AssertionError(f"ran {len(hist)} of {n_steps} steps")
    subs = [int(h["iters"]) for h in hist]
    on_path, expect = _explicit_parity_expect(hist, counts)   # the other kernels: not on this path
    if min(on_path.values()) <= 0 or counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    if not (torch.isfinite(state.un).all() and torch.isfinite(state.pn).all()):
        raise AssertionError("non-finite fields")
    h = hist[-1]
    out = dict(
        phase="e2e", steps=n_steps, warmup_steps=warm,
        ms_per_step=(t2 - t1) / (n_steps - warm) * 1e3, warmup_s=t1 - t0,
        sub_iters=int(h["iters"]), cg_iters=int(h["cg_iters"]), u_mon=h["u_mon"],
        sub_iters_hist={str(s): subs.count(s) for s in sorted(set(subs))},
        cg_iters_first_last=[int(hist[0]["cg_iters"]), int(h["cg_iters"])],
        launches=counts, launches_per_step=dict(
            warm_1_sub_iter=dict(parity_apply_k_plus_a=1, parity_apply_k=0,
                                 parity_apply_g=2, div_compact=1, cg_solve=1),
            spin_up_2_sub_iters=dict(parity_apply_k_plus_a=2, parity_apply_k=1,
                                     parity_apply_g=3, div_compact=2, cg_solve=2),
        ),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)

    # ---- the kernel path against the plain-version path, 3 steps from this state
    attrs = {k: getattr(solver, k) for k in ExplicitBCHSolver.STATIC_ATTRS}
    plain = ExplicitBCHSolver.from_tables(solver.deck, solver.config, solver.d, attrs,
                                          device=solver.device, plain=True)
    st_k, h_k = solver.run(state, n_steps=3)
    st_p, h_p = plain.run(state, n_steps=3)
    u_k, p_k = solver.fields(st_k)
    u_p, p_p = plain.fields(st_p)
    du, dp = float(np.abs(u_k - u_p).max()), float(np.abs(p_k - p_p).max())
    mon = max(abs(a[f] - b[f]) for a, b in zip(h_k, h_p)
              for f in ("u_mon", "v_mon", "w_mon", "p_mon"))
    subs_k, subs_p = [r["iters"] for r in h_k], [r["iters"] for r in h_p]
    cg_k, cg_p = [r["cg_iters"] for r in h_k], [r["cg_iters"] for r in h_p]
    cmp = dict(phase="kernel_vs_plain_3_steps", du=du, dp=dp, dmon=mon, tols=STEP_TOLS,
               sub_iters=[subs_k, subs_p], cg_iters=[cg_k, cg_p])
    emit(cmp)
    if not (du <= STEP_TOLS["u"] and dp <= STEP_TOLS["p"] and mon <= STEP_TOLS["mon"]
            and subs_k == subs_p and all(abs(a - b) <= 1 for a, b in zip(cg_k, cg_p))):
        raise AssertionError(f"kernel path and plain path disagree: {cmp}")

    # ---- the stored f64 run of the same deck (100 steps from rest)
    if precision_deck and n_steps >= 100:
        ref = np.load(REPO / "cfd_with_cuda_tpu" / "validation" / "data" / "precision_ne27000.npz")
        u_mon = np.asarray([r["u_mon"] for r in hist[:100]])
        du_mon = float(np.max(np.abs(u_mon - ref["f64_u_mon"])))
        u_now, _ = solver.fields(state)           # the state after n_steps
        scale = float(np.abs(ref["f64_u"]).max())
        dfield = float(np.max(np.abs(u_now - ref["f64_u"]))) / scale if n_steps == 100 else None
        prec = dict(phase="precision_vs_stored_f64", du_mon=du_mon, du_mon_bound=1e-5,
                    dfield=dfield, dfield_bound=1e-2)
        emit(prec)
        if not du_mon < 1e-5 or (dfield is not None and not dfield < 1e-2):
            raise AssertionError(f"f32 port vs stored f64 run: {prec}")
    return out


# ---------------------------------------------------------------- phase 4

def _timed_once(fn):
    """(result, device ms) of one call (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _z_csr(win, offs, n):
    """The full-window operator as one sparse matrix, for the library yardstick."""
    import torch

    q = torch.arange(n, device=win.device)
    cols = q[None] + torch.tensor(offs, device=win.device)[:, None]
    ok = (cols >= 0) & (cols < n)
    return _csr(q[None].expand_as(cols)[ok], cols[ok], win[ok], (n, n))


def _true_residual(win64, offs, b64, x) -> float:
    """||b - Z x|| / ||b|| in f64, Z the f32 window table widened to f64."""
    import torch

    from cfd_with_cuda_tpu_torch.ops.fused_cg import window_apply_plain

    r = b64 - window_apply_plain(win64, x.double(), offs)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def phase_cg_modes(tag, cg, window_stencil, win, dinv, b, x0, dims, radius, tol, maxiter,
                   strict=True) -> dict:
    """``cg_solve``, ``cg_init`` + ``cg_iter``, the compensated dot and the
    half window on one pressure system (``win`` the full (W^3, n) window),
    cold and warm, each against its plain version, each solution's f64 true
    residual; per-launch times and bounds.  ``strict=False`` (a small deck,
    whose CG reaches rounding level within the fixed 40 iterations) holds x,
    not |r|, at that depth."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.ops import cuda_lib

    t_phase = time.time()
    n, nw = b.shape[0], win.shape[0]
    offs = window_stencil.window_offsets(dims, radius)
    win64, b64 = win.double(), b.double()
    half = torch.from_numpy(cg.half_window(win.cpu().numpy(), dims, radius)).to(win.device)
    nh = half.shape[0]
    base = dict(dims=dims, radius=radius, tol=tol, maxiter=maxiter)
    modes = {
        "cg_solve": dict(fuse_loop=True),
        "cg_iter": dict(unroll=UNROLL),
        "cg_iter_comp": dict(unroll=UNROLL, dot_mode="compensated"),
        "cg_solve_comp": dict(fuse_loop=True, dot_mode="compensated"),
        "cg_iter_sym": dict(unroll=UNROLL, sym=True),
        "cg_solve_sym": dict(fuse_loop=True, sym=True),
    }
    results = {}
    full_x = {}
    for name, mode in modes.items():
        w = half if mode.get("sym") else win
        group = 1 if mode.get("fuse_loop") else UNROLL
        cap = -(-maxiter // group) * group
        for start, xs in (("cold", None), ("warm", x0)):
            solve = lambda: cg.fused_cg(w, b, dinv, x0=xs, **base, **mode)
            solve()                                     # first launches of this mode
            sol, ms = _timed_once(solve)
            ref, plain_ms = _timed_once(lambda: cg.fused_cg_plain(w, b, dinv, x0=xs, **base, **mode))
            k, k_ref = int(sol.iters), int(ref.iters)
            err = float((sol.x - ref.x).abs().max())
            rel = err / float(ref.x.abs().max())
            bnorm = float(torch.linalg.vector_norm(b))
            what = f"{tag} {name} {start}"
            if abs(k - k_ref) > group or not rel <= CG_X_TOL or not k > 0 or k % group:
                raise AssertionError(f"{what}: k {k} vs {k_ref}, x err {rel:.3e}")
            if not (float(sol.residual) <= tol * bnorm * 1.0001 or k == cap):
                raise AssertionError(f"{what}: stopped unconverged at k={k}")
            rec = dict(max_abs_err=err, err_rel=rel, tol=CG_X_TOL, iters=k, iters_plain=k_ref,
                       ms=ms, ms_per_iter=ms / k, plain_ms=plain_ms,
                       true_res=_true_residual(win64, offs, b64, sol.x),
                       true_res_plain=_true_residual(win64, offs, b64, ref.x),
                       true_res_tol=CG_TRUE_RES_TOL * tol)
            for res, kk in ((rec["true_res"], k), (rec["true_res_plain"], k_ref)):
                if kk < cap and not res <= CG_TRUE_RES_TOL * tol:
                    raise AssertionError(f"{what}: true residual {res:.3e} > "
                                         f"{CG_TRUE_RES_TOL} tol after {kk} iterations")
            if name == "cg_iter":
                full_x[start] = (sol.x, k)
            if mode.get("sym"):
                # the half-window solve against the full-window solve
                x_full, k_full = full_x[start]
                rel_full = float((sol.x - x_full).abs().max()) / float(x_full.abs().max())
                if not rel_full <= CG_X_TOL or abs(k - k_full) > max(group, UNROLL):
                    raise AssertionError(f"{what}: vs the full window: k {k} vs {k_full}, "
                                         f"x err {rel_full:.3e}")
                rec.update(err_rel_vs_full=rel_full, iters_full=k_full)
            results[f"{name}_{start}"] = rec

    # one launch each, held against the plain version at a fixed depth: init
    # alone (maxiter=0), one iteration, and N iterations in one group with
    # tol=0 (never converged); cg_iter is timed as the solvers launch it, one
    # launch a group of UNROLL iterations
    n_it = 40
    for name, mode, w in (("plain", {}, win), ("comp", dict(dot_mode="compensated"), win),
                          ("sym", dict(sym=True), half)):
        kw = dict(dims=dims, radius=radius, tol=0.0, x0=x0, **mode)
        run = lambda solve, k: solve(w, b, dinv, maxiter=k, unroll=max(k, 1), **kw)
        errs = {}
        for k in (0, 1, n_it):
            sol, ref = run(cg.fused_cg, k), run(cg.fused_cg_plain, k)
            x_rel = float((sol.x - ref.x).abs().max()) / float(ref.x.abs().max())
            r_rel = abs(float(sol.residual) - float(ref.residual)) / float(ref.residual)
            what = f"{tag} {name}: {k} iterations against the plain version"
            r_ok = r_rel <= CG_FIXED_R_TOL[k] or (not strict and k == n_it)
            if int(sol.iters) != k or not x_rel <= CG_FIXED_X_TOL or not r_ok:
                raise AssertionError(f"{what}: k {int(sol.iters)}, x {x_rel:.3e}, |r| {r_rel:.3e}")
            errs[k] = dict(x_abs=float((sol.x - ref.x).abs().max()), x_rel=x_rel, r_rel=r_rel)
        init_wall_ms = time_ms(lambda: run(cg.fused_cg, 0), 20)
        _, step = _raw_cg_launches(cg, cuda_lib, w, b, dinv, x0,
                                   offs[nw // 2:] if mode.get("sym") else offs,
                                   mode.get("dot_mode", "plain"), bool(mode.get("sym")))
        launch_ms = queued_ms(step, 20)
        _, init_plain = _timed_once(lambda: run(cg.fused_cg_plain, 0))
        _, loop_plain = _timed_once(lambda: run(cg.fused_cg_plain, n_it))
        rows, nz, nz_full = w.shape[0], nnz(w), nnz(win)
        # init (warm): window + b, dinv, x0 read, x, r, p written; iter: window +
        # x, r, p, dinv read, x, r, p written; the operations of the full window
        # (the half window applies both directions)
        ib, ib_by = bound(4 * (nz + 6 * n), 2 * nz_full + 8 * n)
        tb, tb_by = bound(4 * (nz + 7 * n), 2 * nz_full + 12 * n)
        lb, lb_by = _launch_bound(nz, nz_full, n)
        results[f"launch_{name}"] = dict(
            window_rows=rows, fixed_depth_errs=errs, x_tol=CG_FIXED_X_TOL, r_tol=CG_FIXED_R_TOL,
            # the kernel alone (profiler), and the wrapper's call with its host
            # read of |r0|, |b| (CUDA events)
            init_ms=kernel_device_ms(lambda: run(cg.fused_cg, 0), "cg_init_kernel", 20),
            init_with_host_read_ms=init_wall_ms, init_plain_ms=init_plain,
            init_bound_ms=ib, init_bound_by=ib_by,
            init_abs_err=max(errs[0]["x_abs"], errs[1]["x_abs"]),
            # one cg_iter launch (UNROLL iterations; device time, the
            # launches queued) and the same per iteration
            iter_launch_ms=launch_ms, iter_ms=launch_ms / UNROLL,
            iter_plain_launch_ms=(loop_plain - init_plain) / n_it * UNROLL,
            iter_plain_ms=(loop_plain - init_plain) / n_it,
            iter_abs_err=errs[n_it]["x_abs"], iter_launch_bound_ms=lb, iter_launch_bound_by=lb_by,
            iter_bound_ms=tb, iter_bound_by=tb_by,
            iter_stream_bound_ms=bound(4 * (rows + 7) * n, 0)[0],
        )

    # the half-window apply alone against the full-window apply
    v = x0
    y = cg.window_apply_sym(half, v, dims=dims, radius=radius)
    y_full = cg.window_apply_plain(win, v, offs)
    y_abs = cg.window_apply_plain(win.abs(), v.abs(), offs)
    err, rel = _apply_err(y, y_full, y_abs)
    if not rel <= APPLY_TOL:
        raise AssertionError(f"{tag} sym apply vs the full window: {rel:.3e} > {APPLY_TOL}")
    a_z = _z_csr(win, offs, n)
    sb, sb_by = bound(4 * (nnz(half) + 2 * n), 2 * nnz(win))
    results["sym_apply"] = dict(
        max_abs_err=err, err_rel=rel, tol=APPLY_TOL, window_rows=nh,
        # the kernel's device time: the wrapper's host work outlasts it
        ms=queued_ms(lambda: cg.window_apply_sym(half, v, dims=dims, radius=radius), 20),
        call_ms=time_ms(lambda: cg.window_apply_sym(half, v, dims=dims, radius=radius), 20),
        plain_ms=time_ms(lambda: cg.window_apply_plain(half, v, offs[nw // 2:], True), 3),
        library_ms=time_ms(lambda: torch.mv(a_z, v), 20),
        library_abs_err=float((torch.mv(a_z, v) - y).abs().max()),
        bound_ms=sb, bound_by=sb_by, stream_bound_ms=bound(4 * (nh + 2) * n, 0)[0],
    )
    del a_z

    # the compensated dot alone: the f64 dot of the f32 inputs within 2 ulp (f32)
    rng = np.random.default_rng(11)
    worst = 0.0
    for m in (128, 4096, 29824, n):
        a_h = (rng.standard_normal(m) * 10.0 ** rng.uniform(-3, 3, m)).astype(np.float32)
        b_h = (rng.standard_normal(m) * 10.0 ** rng.uniform(-3, 3, m)).astype(np.float32)
        a_d, b_d = torch.from_numpy(a_h).to(b.device), torch.from_numpy(b_h).to(b.device)
        got = float(cg.comp_dot_f32(a_d, b_d))
        exact = float(np.dot(a_h.astype(np.float64), b_h.astype(np.float64)))
        ulp = float(np.spacing(np.float32(abs(exact)) or np.float32(1.0)))
        if not abs(got - exact) <= 2 * ulp:
            raise AssertionError(f"comp_dot n={m}: {got} vs {exact} (ulp {ulp})")
        worst = max(worst, abs(got - exact) / ulp)
    db, db_by = bound(8 * n + 4, 2 * n)
    results["comp_dot"] = dict(
        max_abs_err=abs(got - exact), err_ulp_worst=worst, tol_ulp=2, n=n,
        ms=queued_ms(lambda: cg.comp_dot_f32(a_d, b_d), 20),
        call_ms=time_ms(lambda: cg.comp_dot_f32(a_d, b_d), 20),
        plain_ms=time_ms(lambda: cg.comp_dot_plain(a_d, b_d), 20),
        library_ms=None, bound_ms=db, bound_by=db_by,
    )
    del win64, b64
    emit(dict(phase="cg_modes", system=tag, n=n, window_rows=nw, half_rows=nh, checks=results,
              seconds=time.time() - t_phase))
    return results


# ---------------------------------------------------------------- phase 5

# the momentum solve's A applies: (for its start, per iteration); BiCGStab: A x0,
# then 2; CR: A x0 and A z0, then 1; CG: A x0, then 1
MOMENTUM_APPLIES = dict(bicgstab=(1, 2), cr=(2, 1), cg=(1, 1))


def _implicit_expect(hist, counts, layout="parity", k_name="parity_apply_k",
                     momentum="bicgstab", **modes):
    """Launch counts a run of the implicit solver implies, per its history,
    layout and momentum solver; ``k_name`` counts the parity layout's M and
    MK + A applies (``parity_apply_k_streamed`` where the rule streams the
    field)."""
    groups = sum(int(h["cg_iters"]) for h in hist) // UNROLL   # one cg_iter launch a group
    mom = sum(int(h["mom_iters"]) for h in hist)
    n = len(hist)
    start, per = MOMENTUM_APPLIES[momentum]
    a_applies = start * n + per * mom
    if layout == "parity":
        on_path = {"cg_init": n, "cg_iter": groups, "div_compact": n, "parity_apply_g": n,
                   k_name: n + a_applies}                   # M u^k, then the A applies
    else:
        # M u^k once a step, then the A applies
        on_path = dict(cg_init=n, cg_iter=groups, div_compact_interleaved=n, grad_window=n,
                       window_spmv_m=n, window_spmv_mk_plus_a=a_applies)
    for name, on in modes.items():
        if on:
            on_path[name] = n + groups                      # every cg_init and cg_iter launch
    return on_path, {k: on_path.get(k, 0) for k in counts}


def _implicit_vs_plain(what, solver, ImplicitGQSolver, cuda_lib, state, n_steps,
                       strict=True, cg_iters_tol=None, k_name="parity_apply_k", **modes) -> dict:
    """``n_steps`` of the kernel path and of the plain path from ``state``; the
    kernel path's launch counts (set to 0 just before) against its history.
    ``strict=False`` (a deck other than NE27000, where a 4^3 mesh's ~25
    BiCGStab iterations in f32 scatter more than the bounds allow) prints
    the comparison and asserts only the counts and finite fields."""
    import numpy as np

    attrs = solver.static_attrs()
    plain = ImplicitGQSolver.from_tables(solver.deck, solver.config, solver.d, attrs,
                                         device=solver.device, plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=n_steps)
    counts = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=n_steps)
    if dict(cuda_lib.launch_counts) != counts:
        raise AssertionError(f"{what}: the plain path launched a kernel")
    on_path, expect = _implicit_expect(h_k, counts, solver.layout, k_name, **modes)
    if min(on_path.values()) <= 0 or counts != expect:
        raise AssertionError(f"{what}: launch counts {counts}, expected {expect}")
    u_k, p_k = solver.fields(st_k)
    u_p, p_p = plain.fields(st_p)
    du, dp = float(np.abs(u_k - u_p).max()), float(np.abs(p_k - p_p).max())
    cg_k, cg_p = [int(r["cg_iters"]) for r in h_k], [int(r["cg_iters"]) for r in h_p]
    mom_k, mom_p = [int(r["mom_iters"]) for r in h_k], [int(r["mom_iters"]) for r in h_p]
    t = dict(IMPLICIT_TOLS, cg_iters=cg_iters_tol or IMPLICIT_TOLS["cg_iters"])
    cmp = dict(phase=what, steps=n_steps, du=du, dp=dp, tols=t,
               cg_iters=[cg_k, cg_p], mom_iters=[mom_k, mom_p], launches=counts,
               u_mon=h_k[-1]["u_mon"])
    emit(cmp)
    if not (np.isfinite(u_k).all() and np.isfinite(p_k).all()
            and all(k % UNROLL == 0 for k in cg_k)):
        raise AssertionError(f"{what}: {cmp}")
    if strict and not (
            du <= t["u"] and dp <= t["p"]
            and all(abs(a - b) <= t["cg_iters"] for a, b in zip(cg_k, cg_p))
            and all(abs(a - b) <= t["mom_iters"] for a, b in zip(mom_k, mom_p))):
        raise AssertionError(f"{what}: kernel path and plain path disagree: {cmp}")
    return cmp


def phase_e2e_implicit(solver, ImplicitGQSolver, cuda_lib, cg, n_steps: int,
                       DTypePolicy, strict: bool, tag: str = "implicit",
                       k_name: str = "parity_apply_k", cg_iters_tol=None,
                       variants: bool = True) -> dict:
    """Warm-up then timed steps from rest with the launch counts held against
    the history; 3 steps against the plain path (CG counts within
    ``cg_iters_tol``, default IMPLICIT_TOLS'); with ``variants``, 10 steps
    each of MIXED and the half window against their plain paths.  ``tag``
    names the phases (``e2e_<tag>``, ``<tag>_kernel_vs_plain_3_steps``, ...);
    ``k_name`` counts the parity layout's M and MK + A applies."""
    import torch

    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    if len(hist) != n_steps:
        raise AssertionError(f"{tag}: ran {len(hist)} of {n_steps} steps")
    on_path, expect = _implicit_expect(hist, counts, solver.layout, k_name)
    if min(on_path.values()) <= 0 or counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {expect}")
    if not (torch.isfinite(state.uk).all() and torch.isfinite(state.pk).all()):
        raise AssertionError(f"{tag}: non-finite fields")
    timed = hist_t
    out = dict(
        phase=f"e2e_{tag}", layout=solver.layout, steps=n_steps, warmup_steps=warm,
        ms_per_step=(t2 - t1) / (n_steps - warm) * 1e3, warmup_s=t1 - t0,
        cg_iters_mean=sum(h["cg_iters"] for h in timed) / len(timed),
        mom_iters_mean=sum(h["mom_iters"] for h in timed) / len(timed),
        cg_iters_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
        mom_iters_first_last=[int(hist[0]["mom_iters"]), int(hist[-1]["mom_iters"])],
        u_mon=hist[-1]["u_mon"], max_acc=hist[-1]["max_acc"], launches=counts,
        launches_per_step=(
            "cg_init 1, cg_iter = cg_iters / 4, div_compact 1, parity_apply_g 1, "
            f"{k_name} 2 + 2 mom_iters" if solver.layout == "parity" else
            "cg_init 1, cg_iter = cg_iters / 4, div_compact_interleaved 1, grad_window 1, "
            "window_spmv_m 1, window_spmv_mk_plus_a 1 + 2 mom_iters"),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)
    out["state"] = state

    _implicit_vs_plain(f"{tag}_kernel_vs_plain_3_steps", solver, ImplicitGQSolver, cuda_lib,
                       state, 3, strict, cg_iters_tol=cg_iters_tol, k_name=k_name)
    if not variants:
        return out
    # MIXED (compensated dots) and the half window share the F32 tables
    attrs = solver.static_attrs()
    cfg = solver.config
    mixed = ImplicitGQSolver.from_tables(
        solver.deck, dataclasses.replace(cfg, dtype_policy=DTypePolicy.MIXED),
        solver.d, attrs, device=solver.device)
    out["mixed"] = _implicit_vs_plain(f"{tag}_mixed_vs_plain_10_steps", mixed,
                                      ImplicitGQSolver, cuda_lib, state, min(10, n_steps),
                                      strict, cg_iters_tol=MIXED_CG_ITERS_TOL, comp_dot=True)
    half = cg.half_window(solver.d["Z_win"].cpu().numpy(), solver.coarse_dims, solver.z_radius)
    sym = ImplicitGQSolver.from_tables(
        solver.deck, dataclasses.replace(cfg, pressure_cg_sym=True),
        {**solver.d, "Z_win": torch.from_numpy(half)}, attrs, device=solver.device)
    out["sym"] = _implicit_vs_plain(
        f"{tag}_sym_vs_plain_10_steps", sym, ImplicitGQSolver, cuda_lib, state,
        min(10, n_steps), strict, sym_apply=True,
        cg_iters_tol=None if solver.layout == "parity" else MIXED_CG_ITERS_TOL)
    return out


def phase_seeded(deck, cfg, ImplicitGQSolver, n_steps: int = 20) -> dict:
    """20 steps at dt = 0.01 from the stored developed state of this deck
    (written by scripts/validate_cavity.py --implicit, t = 250): the
    developed-flow regime.  The state holds no p^{k-1}, so the first steps
    carry a restart transient in max_acc (0.50 falling to the stored run's
    0.063 after ~25 steps on the plain path); u_mon stays within 2e-4."""
    import numpy as np
    import torch

    seed = np.load(REPO / "cfd_with_cuda_tpu" / "validation" / "data"
                   / "cavity_re100_implicit_state.npz")
    deck.dt, deck.max_iter = 0.01, 1
    t0 = time.time()
    solver = ImplicitGQSolver(deck, cfg)
    setup_s = time.time() - t0
    state = solver.state_from_fields(seed["u"], seed["p"])
    u_mon0 = float(solver._monitor_only(state).u_mon)
    state, hist_w = solver.run(state, n_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist = solver.run(state, n_steps=n_steps - WARMUP_STEPS)
    torch.cuda.synchronize()
    ms = (time.time() - t1) / (n_steps - WARMUP_STEPS) * 1e3
    hist = hist_w + hist
    u_mon = [h["u_mon"] for h in hist]
    max_acc = [h["max_acc"] for h in hist]
    out = dict(
        phase="seeded_implicit", steps=n_steps, setup_s=setup_s, ms_per_step=ms,
        u_mon_state=u_mon0, u_mon_stored=SEEDED_U_MON, u_mon_last=u_mon[-1],
        u_mon_max_dev=max(abs(v - SEEDED_U_MON) for v in u_mon), u_mon_bound=5e-3,
        max_acc_first_last=[max_acc[0], max_acc[-1]], max_acc_bound=1.0,
        cg_iters_mean=sum(h["cg_iters"] for h in hist) / len(hist),
        mom_iters_mean=sum(h["mom_iters"] for h in hist) / len(hist),
    )
    emit(out)
    finite = bool(torch.isfinite(state.uk).all() and torch.isfinite(state.pk).all())
    if not (len(hist) == n_steps and finite and abs(u_mon0 - SEEDED_U_MON) < 1e-6
            and out["u_mon_max_dev"] < 5e-3 and max(max_acc) < 1.0):
        raise AssertionError(f"seeded implicit run: {out}")
    phase_ghia_seeded(solver, state)
    return out


def phase_ghia_seeded(solver, state) -> dict:
    """Phase 12 (d): the port's ``centerline_profiles`` and
    ``check_against_ghia`` on the seeded state after its steps, within
    ``BAND_3D`` (the stored state itself read 0.049 / 0.040)."""
    from cfd_with_cuda_tpu_torch.validation.ghia1982 import (
        BAND_3D,
        centerline_profiles,
        check_against_ghia,
    )

    u, _ = solver.fields(state)
    z, u_x, x, u_z = centerline_profiles(solver.mesh.coords, u)
    err_u, err_v = check_against_ghia(z, u_x, x, u_z, re=100)
    out = dict(phase="ghia_seeded", points=[len(z), len(x)], err_ghia_u=err_u,
               err_ghia_v=err_v, band=BAND_3D, stored=[0.04895971, 0.03994228])
    emit(out)
    if not (len(z) > 0 and len(x) > 0 and err_u < BAND_3D and err_v < BAND_3D):
        raise AssertionError(f"ghia_seeded: {out}")
    return out


# ---------------------------------------------------------------- phase 8

def _bfs_deck(bfs_deck, dims, dt):
    return bfs_deck(*dims, dt=dt, **BFS_KW)


def phase_bfs_setup(dims, bfs_deck, ExplicitBCHSolver, cfg):
    """The explicit solver's host setup on the backward-facing step: the
    unstructured path with the banded pressure window."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    deck = _bfs_deck(bfs_deck, dims, 0.002)
    solver = ExplicitBCHSolver(deck, cfg)
    setup_s = time.time() - t0
    offs = solver.z_offs
    if solver.layout != "ell" or offs is None:
        raise AssertionError(f"bfs: layout {solver.layout}, banded {offs is not None}")
    win = solver.d["Z_bwin"]
    out = dict(phase="bfs_setup", deck=f"bfs_deck{dims} {BFS_KW}", ne=int(deck.ne),
               nn=solver.nn, nnp=solver.nnp, offsets=len(offs),
               max_halo=max(abs(o) for o in offs),
               window_mb=win.numel() * win.element_size() / 1e6,
               ell_z_width=int(solver.d["Z_cols"].shape[0]), setup_s=setup_s,
               setup_cache_hit=solver.setup_cache_hit,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(out)
    return solver, out


def phase_banded_cg(solver, cg, cuda_lib) -> dict:
    """``cg_init`` + ``cg_iter`` and ``cg_solve`` on the banded window of the
    BFS pressure operator, each against ``fused_cg_plain``: a converged cold
    solve in both dot modes, and a FIXED 0, 1 and 40 iterations from a warm
    start (tol 0) in both loop forms and dot modes; per-launch device times,
    the byte bound and a CSR ``torch.mv`` of the same Z."""
    import numpy as np
    import torch

    d, cfg = solver.d, solver.config
    win, dinv, offs, n = d["Z_bwin"], d["Z_dinv"], solver.z_offs, solver.nnp
    nw = len(offs)
    rng = np.random.default_rng(20261016)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(solver.device)
    if solver.pin >= 0:
        b[solver.pin] = 0.0
    base = dict(dims=(n, 1, 1), offs=offs)
    results = {}
    win64, b64 = win.double(), b.double()

    # converged cold solves, the default loop (counts within one group)
    cold = None
    for dot_mode in ("plain", "compensated"):
        kw = dict(base, tol=cfg.pressure_cg_tol, maxiter=cfg.pressure_cg_maxiter,
                  unroll=UNROLL, dot_mode=dot_mode)
        cg.fused_cg(win, b, dinv, **kw)
        sol, ms = _timed_once(lambda: cg.fused_cg(win, b, dinv, **kw))
        ref, plain_ms = _timed_once(lambda: cg.fused_cg_plain(win, b, dinv, **kw))
        k, k_ref = int(sol.iters), int(ref.iters)
        rel = float((sol.x - ref.x).abs().max()) / float(ref.x.abs().max())
        tol = cfg.pressure_cg_tol
        rec = dict(iters=k, iters_plain=k_ref, err_rel=rel, tol=CG_X_TOL, solve_ms=ms,
                   ms_per_iter=ms / max(k, 1), plain_solve_ms=plain_ms,
                   true_res=_true_residual(win64, offs, b64, sol.x),
                   true_res_plain=_true_residual(win64, offs, b64, ref.x),
                   true_res_tol=CG_TRUE_RES_TOL * tol)
        if not max(rec["true_res"], rec["true_res_plain"]) <= CG_TRUE_RES_TOL * tol:
            raise AssertionError(f"banded cold solve {dot_mode}: true residual: {rec}")
        if abs(k - k_ref) > UNROLL or not rel <= CG_X_TOL or not k > 0 or k % UNROLL:
            raise AssertionError(f"banded cold solve {dot_mode}: {rec}")
        if not float(sol.residual) <= cfg.pressure_cg_tol * float(torch.linalg.vector_norm(b)) * 1.0001:
            raise AssertionError(f"banded cold solve {dot_mode}: stopped unconverged: {rec}")
        results[f"cold_solve_{dot_mode}"] = rec
        if cold is None:
            cold = sol.x
    del win64, b64
    noise = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(solver.device)
    x0 = (cold * (1 + 0.1 * noise)).contiguous()

    # a fixed depth, where convergence forgives nothing
    forms = {"cg_iter": dict(fuse_loop=False), "cg_solve": dict(fuse_loop=True)}
    for form, fkw in forms.items():
        for dot_mode in ("plain", "compensated"):
            kw = dict(base, tol=0.0, x0=x0, dot_mode=dot_mode, **fkw)
            run = lambda solve, k: solve(win, b, dinv, maxiter=k, unroll=max(k, 1), **kw)
            errs = {}
            for k in BFS_FIXED_DEPTHS:
                sol, ref = run(cg.fused_cg, k), run(cg.fused_cg_plain, k)
                x_abs = float((sol.x - ref.x).abs().max())
                x_rel = x_abs / float(ref.x.abs().max())
                if int(sol.iters) != k or not x_rel <= CG_FIXED_X_TOL:
                    raise AssertionError(f"banded {form} {dot_mode}: {k} iterations: "
                                         f"k {int(sol.iters)}, x {x_rel:.3e}")
                errs[k] = dict(x_abs=x_abs, x_rel=x_rel)
            n_it = BFS_FIXED_DEPTHS[-1]
            t0_ms = time_ms(lambda: run(cg.fused_cg, 0), 5)
            tn_ms = time_ms(lambda: run(cg.fused_cg, n_it), 3)
            _, p0 = _timed_once(lambda: run(cg.fused_cg_plain, 0))
            _, pn = _timed_once(lambda: run(cg.fused_cg_plain, n_it))
            rec = dict(fixed_depth_errs=errs, x_tol=CG_FIXED_X_TOL,
                       ms_per_iter=(tn_ms - t0_ms) / n_it, plain_ms_per_iter=(pn - p0) / n_it,
                       start_ms=t0_ms, plain_start_ms=p0)
            if form == "cg_iter":
                init, step = _raw_cg_launches(cg, cuda_lib, win, b, dinv, x0, offs, dot_mode)
                launch_ms = time_ms(step, n_it // UNROLL)
                rec.update(init_ms=time_ms(init, 20), iter_launch_ms=launch_ms,
                           iter_ms=launch_ms / UNROLL,
                           plain_launch_ms=rec["plain_ms_per_iter"] * UNROLL)
            results[f"{form}_{dot_mode}"] = rec

    nz = nnz(win)
    ib, ib_by = bound(4 * (nz + 6 * n), 2 * nz + 8 * n)
    tb, tb_by = bound(4 * (nz + 7 * n), 2 * nz + 12 * n)
    lb, lb_by = _launch_bound(nz, nz, n)
    a_z = _z_csr(win, offs, n)
    lib_ms = time_ms(lambda: torch.mv(a_z, x0), 20)
    lib_err = float((torch.mv(a_z, x0) - cg.window_apply_plain(win, x0, offs)).abs().max())
    del a_z
    out = dict(phase="banded_cg", n=n, offsets=nw, max_halo=max(abs(o) for o in offs),
               window_mb=4 * nw * n / 1e6, window_nnz=nz, init_bound_ms=ib,
               init_bound_by=ib_by, iter_bound_ms=tb, iter_bound_by=tb_by,
               iter_launch_bound_ms=lb, iter_launch_bound_by=lb_by,
               iter_stream_bound_ms=bound(4 * (nw + 7) * n, 0)[0], library_csr_mv_ms=lib_ms,
               library_abs_err=lib_err, checks=results)
    emit(out)
    return out


def _launch_bound(nz: int, nz_full: int, n: int) -> tuple[float, str]:
    """The bound of one ``cg_iter`` launch of UNROLL iterations: its inputs
    (the window's ``nz`` nonzero weights; x, r, z, p, dinv, ap) read once and
    its outputs written once, against UNROLL iterations' operations (the
    full window's ``nz_full`` weights)."""
    return bound(4 * (nz + 7 * n), UNROLL * (2 * nz_full + 12 * n))


def _raw_cg_launches(cg, cuda_lib, win, b, dinv, x0, offs, dot_mode, sym=False):
    """(init, step): one ``cg_init`` launch and one ``cg_iter`` launch of a
    group of UNROLL iterations, with the wrapper's arguments and no host
    read, for CUDA-event timing of the kernels alone (the wrapper reads |r0|
    and |b| after ``cg_init``).  ``step`` advances one CG in place; tol 0
    keeps it finite.  ``sym``: ``win`` and ``offs`` are the dq >= 0 half."""
    import torch

    comp = int(dot_mode == "compensated")
    n, dev, fn, ptr = b.shape[0], b.device, cuda_lib.function, cuda_lib.ptr
    offs_t = cg._offs_table(tuple(offs), dev)
    stab, stab_ints, svecs = cg._stage_table(tuple(offs), bool(sym), dev)
    rows, ld = cg.cg_work_layout(n)
    x, work = torch.empty_like(b), torch.empty((len(rows), ld), dtype=b.dtype, device=dev)
    part = torch.empty(6 * fn("cg_iter_max_blocks")(),
                       dtype=torch.float64 if comp else torch.float32, device=dev)
    scal = torch.empty(3, dtype=b.dtype, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    init_args = (ptr(win), ptr(offs_t), len(offs), ptr(b), ptr(dinv), ptr(x0), ptr(x),
                 ptr(work), ld, ptr(part), ptr(scal), n, comp, int(sym), ptr(stab), stab_ints,
                 svecs, stream)
    iter_args = (ptr(win), ptr(offs_t), len(offs), ptr(dinv), ptr(x), ptr(work), ld,
                 ptr(part), ptr(scal), n, UNROLL, comp, int(sym), ptr(stab), stab_ints, svecs,
                 stream)
    init = lambda: cuda_lib.check(fn("cg_init_f32")(*init_args), "cg_init")
    step = lambda: cuda_lib.check(fn("cg_iter_f32")(*iter_args), "cg_iter")
    init()
    return init, step


def _rel_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _bfs_vs_plain(what, solver, cls, cuda_lib, state, n_steps, strict) -> dict:
    """``n_steps`` of ``solver`` and of its plain-version twin (``from_tables``
    on the same tables) from ``state``; the kernel run's launch counts."""
    import numpy as np

    plain = cls.from_tables(solver.deck, solver.config, solver.d, solver.static_attrs(),
                            device=solver.device, plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=n_steps)
    counts = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=n_steps)
    if dict(cuda_lib.launch_counts) != counts:
        raise AssertionError(f"{what}: the plain path launched a kernel")
    u_k, p_k = solver.fields(st_k)
    u_p, p_p = plain.fields(st_p)
    col = lambda h, f: [int(r[f]) for r in h]
    cmp = dict(phase=what, steps=n_steps, du_rel=_rel_diff(u_k, u_p), dp_rel=_rel_diff(p_k, p_p),
               tols=BFS_TOLS, sub_iters=[col(h_k, "iters"), col(h_p, "iters")],
               cg_iters=[col(h_k, "cg_iters"), col(h_p, "cg_iters")],
               mom_iters=[col(h_k, "mom_iters"), col(h_p, "mom_iters")], launches=counts)
    emit(cmp)
    within = lambda f, tol: all(abs(a - b) <= tol for a, b in zip(*cmp[f]))
    if not (np.isfinite(u_k).all() and np.isfinite(p_k).all()):
        raise AssertionError(f"{what}: non-finite fields")
    if strict and not (cmp["du_rel"] <= BFS_TOLS["u"] and cmp["dp_rel"] <= BFS_TOLS["p"]
                       and cmp["sub_iters"][0] == cmp["sub_iters"][1]
                       and within("cg_iters", BFS_TOLS["cg_iters"])
                       and within("mom_iters", BFS_TOLS["mom_iters"])):
        raise AssertionError(f"{what}: kernel path and plain path disagree: {cmp}")
    return cmp


def _timed_run(solver, n_steps):
    """(state, history, warm-up s, ms/step of the timed steps) from rest."""
    import torch

    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    hist = hist_w + hist_t
    if len(hist) != n_steps:
        raise AssertionError(f"ran {len(hist)} of {n_steps} steps")
    return state, hist, hist_t, t1 - t0, (t2 - t1) / (n_steps - warm) * 1e3


def phase_e2e_bfs(solver, ExplicitBCHSolver, cuda_lib, n_steps, strict) -> dict:
    """The explicit solver from rest on the BFS: the banded pressure window
    on ``cg_init`` + ``cg_iter``, every other op plain torch."""
    import numpy as np
    import torch

    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, hist, timed, warm_s, ms = _timed_run(solver, n_steps)
    counts = dict(cuda_lib.launch_counts)
    subs = [int(h["iters"]) for h in hist]
    last_cg = sum(int(h["cg_iters"]) for h in hist)
    # one cg_init per solve (one solve a sub-iteration); the history holds each
    # step's last solve only, so cg_iter (one launch a group of UNROLL
    # iterations) is bounded below by those
    on_path = {"cg_init": sum(subs)}
    off_path = {k: v for k, v in counts.items() if k not in ("cg_init", "cg_iter")}
    if (counts["cg_init"] != on_path["cg_init"] or counts["cg_iter"] * UNROLL < last_cg
            or not counts["cg_iter"] > 0 or any(off_path.values())):
        raise AssertionError(f"bfs: launch counts {counts}, cg_init expected {on_path}")
    u, p = solver.fields(state)
    finite = bool(np.isfinite(u).all() and np.isfinite(p).all())
    out = dict(
        phase="e2e_bfs", steps=n_steps, warmup_steps=len(hist) - len(timed), ms_per_step=ms,
        warmup_s=warm_s, sub_iters_hist={str(s): subs.count(s) for s in sorted(set(subs))},
        cg_iters_per_solve=counts["cg_iter"] * UNROLL / counts["cg_init"],
        cg_iters_last_solve_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
        u_mon=hist[-1]["u_mon"], finite=finite, launches=counts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    # the flow reaches the outflow plane (tests/test_bfs.py:67-70): at dt 0.002
    # it shows there (|u_x| > 1e-3) 150-200 steps from rest, so the run goes
    # on, untimed, until it has or BFS_OUTFLOW_STEPS steps have run
    x = solver.mesh.coords[:, 0]
    outflow = np.isclose(x, x.max())
    steps, out_st = n_steps, state
    out_u = float(np.abs(u[outflow, 0]).max())
    while strict and out_u <= 1e-3 and steps < BFS_OUTFLOW_STEPS:
        out_st, _ = solver.run(out_st, n_steps=50)
        steps += 50
        out_u = float(np.abs(solver.fields(out_st)[0][outflow, 0]).max())
    out.update(outflow_max_abs_ux=out_u, outflow_bound=1e-3, outflow_after_steps=steps)
    emit(out)
    if not finite or (strict and not out_u > 1e-3):
        raise AssertionError(f"bfs e2e: {out}")
    out["vs_plain"] = _bfs_vs_plain("bfs_kernel_vs_plain_3_steps", solver, ExplicitBCHSolver,
                                    cuda_lib, state, 3, strict)
    return out


def phase_e2e_bfs_implicit(dims, bfs_deck, ImplicitGQSolver, cuda_lib, cfg, n_steps,
                           strict) -> dict:
    """The implicit ELL step on the BFS at dt 0.01: torch ops only, as the
    JAX package's step is XLA ops only (no launch of this port's kernels).
    Its 3 steps against ``plain=True`` therefore compare the step with
    itself: they hold it to the bounds only once a kernel enters this path,
    and until then guard that the plain flag changes nothing on it."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    solver = ImplicitGQSolver(_bfs_deck(bfs_deck, dims, 0.01), cfg)
    setup_s = time.time() - t0
    if solver.layout != "ell":
        raise AssertionError(f"bfs implicit: layout {solver.layout}")
    cuda_lib.reset_launch_counts()
    state, hist, timed, warm_s, ms = _timed_run(solver, n_steps)
    counts = dict(cuda_lib.launch_counts)
    u, p = solver.fields(state)
    outflow = solver.d["p_mask"] == 0
    p_out = float(state.pk[outflow].abs().max())
    finite = bool(np.isfinite(u).all() and np.isfinite(p).all())
    out = dict(
        phase="e2e_bfs_implicit", steps=n_steps, warmup_steps=len(hist) - len(timed),
        setup_s=setup_s, setup_cache_hit=solver.setup_cache_hit, ms_per_step=ms,
        warmup_s=warm_s,
        cg_iters_mean=sum(h["cg_iters"] for h in timed) / len(timed),
        mom_iters_mean=sum(h["mom_iters"] for h in timed) / len(timed),
        cg_iters_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
        mom_iters_first_last=[int(hist[0]["mom_iters"]), int(hist[-1]["mom_iters"])],
        u_mon=hist[-1]["u_mon"], outflow_rows=int(outflow.sum()), outflow_max_abs_p=p_out,
        finite=finite, launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)
    if not finite or any(counts.values()) or p_out != 0.0 or not outflow.any():
        raise AssertionError(f"bfs implicit e2e: {out}")
    out["vs_plain"] = _bfs_vs_plain("bfs_implicit_vs_plain_3_steps", solver, ImplicitGQSolver,
                                    cuda_lib, state, 3, strict)
    out["solver"] = solver
    return out


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 6

def _window_csr(win, offs, n_in, row_of=None, col_base=0):
    """A window table ``win (D, m)`` as CSR rows ``row_of[s]`` (default s) and
    columns ``col_base + s + offs[k]`` (kept where 0 <= s + off < n_in and the
    weight is not zero): the library yardstick's operator."""
    import torch

    dev = win.device
    m = win.shape[-1]
    s = torch.arange(m, device=dev)
    off = torch.tensor(offs, device=dev)
    cols = s[None] + off[:, None]
    ok = (cols >= 0) & (cols < n_in) & (win != 0)
    rows = (s if row_of is None else row_of)[None].expand_as(cols)
    return rows[ok], (col_base + cols)[ok], win[ok]


def phase_kernels_interleaved(xs, isolver, window_stencil, stencil) -> dict:
    """Every launch form of the window kernel (TPU kernel row 10: the SPMV
    and G on class-compacted tables, the DIV mode on the full window) and
    the compact divergence on an interleaved field (row 11) at the NE27000
    interleaved shapes and the solvers' own tables, against their plain
    versions on the card (f32, and the three forms in f64), with the kernel,
    plain and library times and the bound (of the nonzero weights: the
    compacted tables keep the zeros of the slots that leave the grid, which
    the kernels stream); the compact SPMV also against the full-window SPMV,
    which no solver launches, and both timed."""
    import numpy as np
    import torch

    t0 = time.time()
    ws = window_stencil
    rng = np.random.default_rng(20261017)
    dev = xs.device
    n, nn, fine = xs.s_pad, xs.nn, xs.fine_dims
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    results = {}

    def check(name, kernel, plain, absolute, tol, table, fields, lib=None, queued=False):
        """``table``: the weights the kernel reads; ``fields``: the elements of
        the fields it reads and writes.  Under ``queued`` (the kernels faster
        than their wrappers' host work) ``ms`` and ``library_ms`` are device
        times of back-to-back calls (``queued_ms``), the CUDA-event times per
        call beside them, and ``cold_ms`` / ``library_cold_ms`` the times with
        a cold L2."""
        y, y_plain, y_abs = kernel(), plain(), absolute()
        torch.cuda.synchronize()
        err, rel = _apply_err(y, y_plain, y_abs)
        if not rel <= tol:
            raise AssertionError(f"{name}: kernel vs plain {rel:.3e} > {tol}")
        nz, size, b = nnz(table), table.numel(), table.element_size()
        # one multiply-add per nonzero weight and output channel (the fields
        # of an SPMV share one table: (W, n), or compacted (size,))
        flops = 2 * nz * (y.shape[0] if table.dim() <= 2 else 1)
        b_ms, b_by = bound(b * (nz + fields), flops,
                           FP64_FLOP_PER_S if b == 8 else FP32_FLOP_PER_S)
        out = dict(max_abs_err=err, err_rel=rel, tol=tol, ms=time_ms(kernel, 20),
                   plain_ms=time_ms(plain, 3), bound_ms=b_ms, bound_by=b_by,
                   bytes=b * (nz + fields), flops=flops, table_nnz=nz, table_size=size,
                   stream_bound_ms=bound(b * (size + fields), 0)[0], library_ms=None,
                   library_abs_err=None)
        if lib is not None:
            a, x, post = lib          # post: the sparse product in the kernel's layout
            out["library_ms"] = time_ms(lambda: torch.sparse.mm(a, x), 20)
            out["library_abs_err"] = float((post(torch.sparse.mm(a, x)) - y).abs().max())
        if queued:
            out["event_ms"], out["ms"] = out["ms"], queued_ms(kernel, 20)
            out["cold_ms"] = cold_ms(kernel, 20)
            if lib is not None:
                out["library_event_ms"] = out["library_ms"]
                out["library_ms"] = queued_ms(lambda: torch.sparse.mm(a, x), 20)
                out["library_cold_ms"] = cold_ms(lambda: torch.sparse.mm(a, x), 20)
        results[name] = out
        return out

    def spmv_form(name, full, comp, offs, x, tol, library=True):
        """The compact kernel (what the solvers launch) on ``comp`` against its
        plain version, and against the full-window kernel on ``full`` bit for
        bit up to the sign of an exact zero (``torch.equal``); both kernels
        timed queued (device ms) and with a cold L2, beside the bound of the
        nonzero weights, the compact and the full table's stream bounds and
        cuSPARSE; the compact plain version against the full window's bit
        for bit; ``full`` rebuilt from ``comp`` by ``spmv_window_from_compact``
        bit for bit."""
        c = x.shape[0]
        lib = None
        if library:
            r, cl, v = _window_csr(full, offs, n)
            lib = (_csr(r, cl, v, (n, n)), x.T.contiguous(), lambda r: r.T)
        op = name.removeprefix("f64_")
        kw = dict(offsets=offs, trim=False)
        compact = lambda: ws.window_spmv_compact(comp, x, fine, name=op, **kw)
        window = lambda: ws.window_spmv(full, x, fine, name=op, **kw)
        out = check(name, compact, lambda: ws.window_spmv_compact_plain(comp, x, fine, **kw),
                    lambda: ws.window_spmv_plain(full.abs(), x.abs(), fine, **kw),
                    tol, comp, 2 * c * n, lib, queued=True)
        y_c, y_f = compact(), window()
        ints = torch.int32 if x.dtype == torch.float32 else torch.int64
        b = x.element_size()
        out.update(
            full_window_bit_equal=torch.equal(y_c.view(ints), y_f.view(ints)),
            full_window_value_equal=torch.equal(y_c, y_f),
            plain_equal=torch.equal(ws.window_spmv_compact_plain(comp, x, fine, **kw),
                                    ws.window_spmv_plain(full, x, fine, **kw)),
            from_compact_equal=torch.equal(ws.spmv_window_from_compact(comp, offs, fine, n), full),
            full_window_ms=queued_ms(window, 20), full_window_event_ms=time_ms(window, 20),
            full_window_cold_ms=cold_ms(window, 20), full_window_size=full.numel(),
            full_window_stream_bound_ms=bound(b * (full.numel() + 2 * c * n), 0)[0])
        del y_c, y_f
        same = {k: out[k] for k in ("full_window_value_equal", "plain_equal",
                                    "from_compact_equal")}
        if not all(same.values()):
            raise AssertionError(f"{name}: the compact SPMV differs from the full window's: {same}")
        return out

    d = xs.d
    # ---- K u (the explicit path), (K + A) u (the explicit "assemble" form),
    # the implicit LHS (MK + A, masked, unit diagonal) and M: 3 channels, the
    # compact tables as the solvers build them
    forms = ws.spmv_forms(xs, isolver, rng)
    for form, full, comp, offs, u in forms:
        spmv_form(f"window_spmv_{form}", full, comp, offs, u, WINDOW_TOL)
    _, k_full, k_comp, k_offs, u = forms[0]
    del forms

    # ---- G p on the embedded coarse pressure, G^T u on the fine grid
    g_offs = ws.window_offsets(fine, xs.g_radius)
    pf = torch.nn.functional.pad(
        stencil.coarse_to_fine(rand(xs.nnp), xs.coarse_dims, fine), (0, n - nn))

    def grad_lib(g):
        rows, cols, vals = [], [], []
        for k in range(3):
            r, c, v = _window_csr(g[k], g_offs, n, row_of=torch.arange(n, device=dev) + k * n)
            rows.append(r), cols.append(c), vals.append(v)
        return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (3 * n, n))

    def div_lib(gt):
        rows, cols, vals = [], [], []
        for k in range(3):
            r, c, v = _window_csr(gt[k], g_offs, n, col_base=k * n)
            rows.append(r), cols.append(c), vals.append(v)
        return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n, 3 * n))

    def grad_div(prefix, g, gc, gt, x_p, x_u, tol):
        """G on the class-compacted table ``gc`` (the kernel the solvers and
        ``grad_window`` launch; bound of G's nonzero weights, and of the
        compacted table it reads as ``stream_bound_ms``), its plain version
        against ``grad_window_plain`` on the full window ``g`` bit for bit;
        G^T on the full window in DIV mode."""
        out = check(f"{prefix}grad_window",
                    lambda: ws.grad_window_compact(gc, x_p, fine, xs.g_radius, trim=False),
                    lambda: ws.grad_window_compact_plain(gc, x_p, fine, xs.g_radius, trim=False),
                    lambda: ws.grad_window_plain(g.abs(), x_p.abs(), fine, xs.g_radius,
                                                 trim=False),
                    tol, gc, n + 3 * n,
                    None if prefix else (grad_lib(g), x_p[:, None], lambda r: r.reshape(3, n)),
                    queued=True)
        full = ws.grad_window_plain(g, x_p, fine, xs.g_radius, trim=False)
        if not torch.equal(ws.grad_window_compact_plain(gc, x_p, fine, xs.g_radius, trim=False),
                           full):
            raise AssertionError(f"{prefix}grad_window: the compact plain version differs "
                                 "from the full window's")
        out["full_window_nnz"] = nnz(g)
        out["full_window_stream_bound_ms"] = bound(g.element_size() * (g.numel() + 4 * n), 0)[0]
        del full
        check(f"{prefix}div_window",
              lambda: ws.div_window(gt, x_u, fine, xs.g_radius),
              lambda: ws.div_window_plain(gt, x_u, fine, xs.g_radius),
              lambda: ws.div_window_plain(gt.abs(), x_u.abs(), fine, xs.g_radius),
              tol, gt, 3 * n + n,
              None if prefix else (div_lib(gt), x_u.reshape(-1, 1), lambda r: r[:nn, 0]))

    assert xs.g_radius == 2 and d["GT_win"].shape[1] == len(g_offs)
    grad_div("", d["G_win"], d["G_cwin"], d["GT_win"], pf, u, WINDOW_TOL)

    # ---- the three modes in f64 (the f64 JAX fixtures' own 1e-12)
    u64, pf64 = u.double(), pf.double()
    spmv_form("f64_window_spmv_k", k_full.double(), k_comp.double(), k_offs, u64,
              WINDOW_TOL_F64, library=False)
    del k_full, k_comp
    grad_div("f64_", d["G_win"].double(), d["G_cwin"].double(), d["GT_win"].double(), pf64,
             u64, WINDOW_TOL_F64)
    del u64, pf64

    # ---- row 11: G^T on the interleaved field through the compact coarse rows
    gt = d["GT_cwin"]
    cx, cy, cz = xs.coarse_dims
    fx, fy, _ = fine
    q = torch.arange(gt.shape[-1], device=dev)
    qx, qy, qz = q % cx, (q // cx) % cy, q // (cx * cy)
    emb = (2 * qz * fy + 2 * qy) * fx + 2 * qx       # the fine node of coarse row q
    fcols = emb[None] + torch.tensor(g_offs, device=dev)[:, None]
    rows, cols, vals = [], [], []
    for k in range(3):
        ok = (q < cx * cy * cz)[None] & (fcols >= 0) & (fcols < nn) & (gt[k] != 0)
        rows.append(q[None].expand_as(fcols)[ok])
        cols.append((fcols + k * n)[ok])
        vals.append(gt[k][ok])
    a_c = _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (gt.shape[-1], 3 * n))
    check("div_compact_interleaved",
          lambda: ws.div_compact_interleaved(gt, u, fine, xs.coarse_dims)[:, None],
          lambda: ws.div_compact_interleaved_plain(gt, u, fine, xs.coarse_dims)[:, None],
          lambda: ws.div_compact_interleaved_plain(gt.abs(), u.abs(), fine,
                                                   xs.coarse_dims)[:, None],
          WINDOW_TOL, gt, 3 * n + gt.shape[-1], (a_c, u.reshape(-1, 1), lambda r: r),
          queued=True)
    del a_c
    emit(dict(phase="kernels_interleaved",
              shapes=dict(s_pad=n, nn=nn, nnp=xs.nnp, k_offsets=len(xs.k_offsets),
                          a_offsets=len(isolver.a_offsets), g_window=len(g_offs),
                          gt_compact_rows=int(gt.shape[-1]),
                          spmv_compact_entries=int(d["K_cvals"].numel())),
              tols=dict(f32=WINDOW_TOL, f64=WINDOW_TOL_F64), checks=results,
              seconds=time.time() - t0))
    return results


def phase_window_apply(xs, pstl, window_stencil, stencil, cuda_lib) -> dict:
    """TPU kernel row 12, ``parity_window_apply`` (no solver calls it), on the
    NE27000 interleaved explicit solver's own K (rebuilt from ``K_cvals`` by
    ``spmv_window_from_compact``) and each direction of ``G_win``, split by
    class and compacted as tests/test_parity_stencil.py:46-116 does: the
    kernel against its plain version (APPLY_TOL) and, after
    ``parity_merge``, against ``window_spmv_compact`` / ``grad_window`` of
    the same tables (WINDOW_TOL); device, plain and cuSPARSE CSR times and the byte
    bound of K and of one G direction.  ``launches``: the kernel's launches
    in the merged checks (one for K, one per G direction)."""
    import numpy as np
    import torch

    ws = window_stencil
    rng = np.random.default_rng(20261018)
    dev = xs.device
    fine, n, nn = xs.fine_dims, xs.s_pad, xs.nn
    cdims, sp = pstl.parity_dims(fine)
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def tables(win, offs):
        wp = pstl.parity_window_tables(win.cpu().numpy(), offs, fine)
        wp_c, pairs_c = pstl.compact_class_tables(wp, pstl.parity_pairs(offs, cdims))
        return torch.from_numpy(wp_c).to(dev), pairs_c

    def check(name, wp, x, pairs):
        y = pstl.parity_window_apply(wp, x, pairs=pairs)
        y_plain = pstl.parity_window_apply_plain(wp, x, pairs=pairs)
        y_abs = pstl.parity_window_apply_plain(wp.abs(), x.abs(), pairs=pairs)
        torch.cuda.synchronize()
        err, rel = _apply_err(y, y_plain, y_abs)
        if not rel <= APPLY_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rel:.3e} > {APPLY_TOL}")
        m = wp.shape[1]
        a = _route_csr([wp.reshape(1, 8 * m, sp)], [pstl._class_route(pairs, m)], sp, 8,
                       per_channel=False)
        xt = x.reshape(x.shape[0], 8 * sp).T.contiguous()
        lib_err = float((torch.sparse.mm(a, xt).T.reshape(y.shape) - y).abs().max())
        nz = nnz(wp)
        fields = x.numel() + y.numel()
        b_ms, b_by = bound(4 * (nz + fields), 2 * nz * x.shape[0])
        kernel = lambda: pstl.parity_window_apply(wp, x, pairs=pairs)
        out = dict(max_abs_err=err, err_rel=rel, tol=APPLY_TOL,
                   ms=queued_ms(kernel, 20), event_ms=time_ms(kernel, 20),
                   plain_ms=time_ms(lambda: pstl.parity_window_apply_plain(wp, x, pairs=pairs), 3),
                   library_ms=time_ms(lambda: torch.sparse.mm(a, xt), 20),
                   library_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by, bytes=4 * (nz + fields),
                   flops=2 * nz * x.shape[0], table_nnz=nz, table_size=wp.numel(), slots=m,
                   stream_bound_ms=bound(4 * (wp.numel() + fields), 0)[0])
        del a
        return out

    S = int(np.prod(fine))
    results = {}
    # ---- K: 125 slots, no structural class sparsity (it stays put)
    k_vals = ws.spmv_window_from_compact(xs.d["K_cvals"], xs.k_offsets, fine, n)
    wp, pairs = tables(k_vals, pstl.decode_offsets(xs.k_offsets, fine))
    u = rand(3, 8, sp)
    results["k"] = check("parity_window_apply_k", wp, u, pairs)
    cuda_lib.reset_launch_counts()
    y = pstl.parity_merge(pstl.parity_window_apply(wp, u, pairs=pairs), fine)
    launches_k = cuda_lib.launch_counts["parity_window_apply"]
    uf = torch.nn.functional.pad(pstl.parity_merge(u, fine), (0, n - S))
    ref = ws.window_spmv_compact(xs.d["K_cvals"], uf, fine, offsets=xs.k_offsets, trim=False,
                                 name="window_spmv_k")[:, :S]
    scale = ws.window_spmv_plain(k_vals.abs(), uf.abs(), fine, offsets=xs.k_offsets,
                                 trim=False)[:, :S]
    results["k"]["merged_vs_window_spmv"] = _apply_err(y, ref, scale)
    del wp, u, y, uf, ref, scale, k_vals
    # ---- G, one direction at a time: the coarse pressure as class 0
    r = xs.g_radius
    offs = tuple((dx, dy, dz) for dz in range(-r, r + 1)
                 for dy in range(-r, r + 1) for dx in range(-r, r + 1))
    p = rand(xs.nnp)
    x = torch.zeros(1, 8, sp, device=dev)
    x[0, 0, : xs.nnp] = p
    pf = torch.nn.functional.pad(stencil.coarse_to_fine(p, xs.coarse_dims, fine), (0, n - nn))
    ref = ws.grad_window(xs.d["G_win"], pf, fine, r, trim=False)[:, :S]
    scale = ws.grad_window_plain(xs.d["G_win"].abs(), pf.abs(), fine, r, trim=False)[:, :S]
    merged, launches_g = [], 0
    for dim in range(3):
        wp, pairs = tables(xs.d["G_win"][dim], offs)
        if dim == 0:
            results["g"] = check("parity_window_apply_g", wp, x, pairs)
        cuda_lib.reset_launch_counts()
        y = pstl.parity_merge(pstl.parity_window_apply(wp, x, pairs=pairs), fine)[0]
        launches_g += cuda_lib.launch_counts["parity_window_apply"]
        merged.append(_apply_err(y, ref[dim], scale[dim]))
        del wp, y
    results["g"]["merged_vs_grad_window"] = merged
    for name, errs in (("k", [results["k"]["merged_vs_window_spmv"]]), ("g", merged)):
        if not all(rel <= WINDOW_TOL for _, rel in errs):
            raise AssertionError(f"parity_window_apply {name} after parity_merge vs the window "
                                 f"kernel: {errs} > {WINDOW_TOL}")
    results["k"]["launches"], results["g"]["launches"] = launches_k, launches_g
    emit(dict(phase="window_apply", shapes=dict(sp=sp, k_slots=results["k"]["slots"],
                                                g_slots=results["g"]["slots"]),
              tols=dict(vs_plain=APPLY_TOL, vs_window_kernel=WINDOW_TOL), checks=results))
    return results


def _explicit_interleaved_expect(hist, counts, conv_mode, **modes):
    """Launch counts a run of the explicit interleaved solver implies: per
    step of s sub-iterations, (K + A) u* every sub-iteration and K acc on all
    but the last (matrix-free: window_spmv_k 2s - 1; "assemble":
    window_spmv_k_plus_a s and window_spmv_k s - 1), grad_window s + 1 (G p^n
    once, G pdot each), div_compact_interleaved s, cg_init s; cg_iter (one
    launch a group of the unroll) is checked against the last solve's count
    of each step (the only one the history keeps): at least their sum over
    the unroll."""
    subs = [int(h["iters"]) for h in hist]
    if conv_mode == "assemble":
        spmv = dict(window_spmv_k=sum(s - 1 for s in subs), window_spmv_k_plus_a=sum(subs))
    else:
        spmv = dict(window_spmv_k=sum(2 * s - 1 for s in subs))
    on_path = dict(spmv, grad_window=sum(s + 1 for s in subs),
                   div_compact_interleaved=sum(subs), cg_init=sum(subs),
                   cg_iter=counts.get("cg_iter", 0))
    for name, on in modes.items():
        if on:
            on_path[name] = on_path["cg_init"] + on_path["cg_iter"]
    expect = {k: on_path.get(k, 0) for k in counts}
    last = sum(int(h["cg_iters"]) for h in hist)
    # under "assemble" a run of one-sub-iteration steps applies K alone never
    needed = [v for k, v in on_path.items()
              if not (conv_mode == "assemble" and k == "window_spmv_k")]
    ok = (counts == expect and min(needed) > 0
          and on_path["cg_iter"] * UNROLL >= last)
    return on_path, ok


def _compare_runs(what, h_a, h_b, fields_a, fields_b, tols, cg_tol):
    """The comparison line of two runs from one state; raises past ``tols``."""
    import numpy as np

    (u_a, p_a), (u_b, p_b) = fields_a, fields_b
    du, dp = float(np.abs(u_a - u_b).max()), float(np.abs(p_a - p_b).max())
    mon = max(abs(a[f] - b[f]) for a, b in zip(h_a, h_b)
              for f in ("u_mon", "v_mon", "w_mon", "p_mon"))
    subs = [[int(r["iters"]) for r in h] for h in (h_a, h_b)]
    cg = [[int(r["cg_iters"]) for r in h] for h in (h_a, h_b)]
    cmp = dict(phase=what, du=du, dp=dp, dmon=mon, tols=dict(tols, cg_iters=cg_tol),
               sub_iters=subs, cg_iters=cg, u_mon=h_a[-1]["u_mon"])
    emit(cmp)
    if not (np.isfinite(u_a).all() and np.isfinite(p_a).all() and du <= tols["u"]
            and dp <= tols["p"] and mon <= tols["mon"] and subs[0] == subs[1]
            and all(abs(a - b) <= cg_tol for a, b in zip(*cg))):
        raise AssertionError(f"{what}: runs disagree: {cmp}")
    return cmp


def _explicit_vs_plain(what, solver, cls, cuda_lib, state, n_steps, tols, **modes):
    """``n_steps`` of the kernel path and of the plain path from ``state``, the
    kernel path's launch counts (set to 0 just before) against its history."""
    attrs = solver.static_attrs()
    plain = cls.from_tables(solver.deck, solver.config, solver.d, attrs, device=solver.device,
                            plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=n_steps)
    counts = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=n_steps)
    if dict(cuda_lib.launch_counts) != counts:
        raise AssertionError(f"{what}: the plain path launched a kernel")
    on_path, ok = _explicit_interleaved_expect(h_k, counts, solver.config.conv_mode, **modes)
    if not ok:
        raise AssertionError(f"{what}: launch counts {counts}, expected {on_path}")
    cmp = _compare_runs(what, h_k, h_p, solver.fields(st_k), plain.fields(st_p), tols, UNROLL)
    cmp["launches"] = counts
    return cmp


def phase_e2e_interleaved(solver, ExplicitBCHSolver, cuda_lib, fused_cg, n_steps, DTypePolicy,
                          strict) -> dict:
    """Rung 3 of bench.py's ladder (F32, CG tol 1e-6, warm start, the default
    per-iteration CG, structured_layout="interleaved") from rest: warm-up
    then timed steps with launch counts; 3 steps against the plain path and
    against the port's parity solver from the same state; 10 steps each of
    conv_mode="assemble", MIXED and pressure_cg_sym against their plain
    paths."""
    import torch

    tols = STEP_TOLS if strict else dict(u=float("inf"), p=float("inf"), mon=float("inf"))
    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    if len(hist) != n_steps:
        raise AssertionError(f"interleaved: ran {len(hist)} of {n_steps} steps")
    on_path, ok = _explicit_interleaved_expect(hist, counts, solver.config.conv_mode)
    if not ok:
        raise AssertionError(f"interleaved: launch counts {counts}, expected {on_path}")
    if not (torch.isfinite(state.un).all() and torch.isfinite(state.pn).all()):
        raise AssertionError("interleaved: non-finite fields")
    subs = [int(h["iters"]) for h in hist]
    out = dict(
        phase="e2e_interleaved", layout=solver.layout, steps=n_steps, warmup_steps=warm,
        ms_per_step=(t2 - t1) / (n_steps - warm) * 1e3, warmup_s=t1 - t0,
        sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
        cg_iters_last_solve_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
        u_mon=hist[-1]["u_mon"], launches=counts,
        launches_per_step="s sub-iterations: window_spmv_k 2s - 1, grad_window s + 1, "
                          "div_compact_interleaved s, cg_init s, cg_iter = the solves' iterations",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)
    _explicit_vs_plain("interleaved_kernel_vs_plain_3_steps", solver, ExplicitBCHSolver,
                       cuda_lib, state, 3, tols)

    # ---- the parity layout from the same fields (both states rebuilt from
    # (u, p): the carried sub-iteration and warm-start vectors start at 0)
    cfg = solver.config
    par = ExplicitBCHSolver(solver.deck, dataclasses.replace(cfg, structured_layout="auto"))
    if par.layout != "parity":
        raise AssertionError(f"the parity solver took {par.layout}")
    u, p = solver.fields(state)
    st_i, h_i = solver.run(solver.state_from_fields(u, p), n_steps=3)
    st_p, h_p = par.run(par.state_from_fields(u, p), n_steps=3)
    # the two layouts sum their window applies in other orders; the CG counts
    # may then part by one group of the unroll
    out["vs_parity"] = _compare_runs("interleaved_vs_parity_3_steps", h_i, h_p,
                                     solver.fields(st_i), par.fields(st_p), tols, UNROLL)
    del par
    torch.cuda.empty_cache()

    attrs = solver.static_attrs()
    n10 = min(10, n_steps)
    asm = ExplicitBCHSolver.from_tables(solver.deck, dataclasses.replace(cfg, conv_mode="assemble"),
                                        solver.d, attrs, device=solver.device)
    out["assemble"] = _explicit_vs_plain("interleaved_assemble_vs_plain_10_steps", asm,
                                         ExplicitBCHSolver, cuda_lib, state, n10, tols)
    mixed = ExplicitBCHSolver.from_tables(
        solver.deck, dataclasses.replace(cfg, dtype_policy=DTypePolicy.MIXED), solver.d, attrs,
        device=solver.device)
    out["mixed"] = _explicit_vs_plain("interleaved_mixed_vs_plain_10_steps", mixed,
                                      ExplicitBCHSolver, cuda_lib, state, n10, tols,
                                      comp_dot=True)
    half = fused_cg.half_window(solver.d["Z_win"].cpu().numpy(), solver.coarse_dims,
                                solver.z_radius)
    sym = ExplicitBCHSolver.from_tables(
        solver.deck, dataclasses.replace(cfg, pressure_cg_sym=True),
        {**solver.d, "Z_win": torch.from_numpy(half)}, attrs, device=solver.device)
    out["sym"] = _explicit_vs_plain("interleaved_sym_vs_plain_10_steps", sym, ExplicitBCHSolver,
                                    cuda_lib, state, n10, tols, sym_apply=True)
    return out


def phase_interleaved_vs_parity_implicit(isolver, ImplicitGQSolver, state, strict) -> dict:
    """3 implicit steps of the interleaved solver and of the port's parity
    solver from the same fields (p^{k-1} = p^k in both)."""
    import torch

    par = ImplicitGQSolver(isolver.deck, dataclasses.replace(isolver.config,
                                                             structured_layout="auto"))
    if par.layout != "parity":
        raise AssertionError(f"the parity solver took {par.layout}")
    u, p = isolver.fields(state)
    st_i, h_i = isolver.run(isolver.state_from_fields(u, p), n_steps=3)
    st_p, h_p = par.run(par.state_from_fields(u, p), n_steps=3)
    tols = IMPLICIT_TOLS if strict else dict(u=float("inf"), p=float("inf"))
    tols = dict(u=tols["u"], p=tols["p"], mon=tols["u"])
    out = _compare_runs("interleaved_implicit_vs_parity_3_steps", h_i, h_p, isolver.fields(st_i),
                        par.fields(st_p), tols, IMPLICIT_TOLS["cg_iters"])
    mom = [[int(r["mom_iters"]) for r in h] for h in (h_i, h_p)]
    if strict and any(abs(a - b) > IMPLICIT_TOLS["mom_iters"] for a, b in zip(*mom)):
        raise AssertionError(f"interleaved vs parity implicit: BiCGStab counts {mom}")
    del par
    torch.cuda.empty_cache()
    return out


def interleaved_phases(args, cavity_deck, cuda_lib, fused_cg, parity_stencil, window_stencil,
                       stencil, ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy,
                       SolverConfig) -> list:
    """Phase 6 on the cavity's interleaved layout: the rows of the ``kernels``
    line it measures (TPU kernel rows 10, 11 and, on the interleaved solver's
    tables split by class, 12)."""
    import torch

    full = args.deck_n == 30
    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001)
    t0 = time.time()
    xcfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                        pressure_warm_start=True, structured_layout="interleaved",
                        steps_per_chunk=25)
    xs = ExplicitBCHSolver(deck, xcfg)
    t1 = time.time()
    icfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                        pressure_warm_start=True, structured_layout="interleaved",
                        steps_per_chunk=25)
    isolver = ImplicitGQSolver(cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001),
                               icfg)
    emit(dict(phase="setup_interleaved", layouts=[xs.layout, isolver.layout], nn=xs.nn,
              nnp=xs.nnp, s_pad=xs.s_pad, explicit_setup_s=t1 - t0,
              implicit_setup_s=time.time() - t1,
              table_mb=dict(explicit=sum(v.numel() * v.element_size() for v in xs.d.values()) / 1e6,
                            implicit=sum(v.numel() * v.element_size()
                                         for v in isolver.d.values()) / 1e6)))
    if xs.layout != "interleaved" or isolver.layout != "interleaved":
        raise AssertionError("structured_layout='interleaved' was not taken")
    kint = phase_kernels_interleaved(xs, isolver, window_stencil, stencil)
    torch.cuda.empty_cache()
    # phase 13 (c): the sharded applies on these tables
    skern = phase_spmd_kernels(xs, isolver, window_stencil, stencil, kint)
    torch.cuda.empty_cache()
    wapp = phase_window_apply(xs, parity_stencil, window_stencil, stencil, cuda_lib)
    torch.cuda.empty_cache()
    xe2e = phase_e2e_interleaved(xs, ExplicitBCHSolver, cuda_lib, fused_cg, args.implicit_steps,
                                 DTypePolicy, strict=full)
    # phase 13 (a): spmd_devices=1 over NCCL on these tables
    s1x = phase_spmd1_explicit(xs, ExplicitBCHSolver, cuda_lib, xe2e["ms_per_step"])
    del xs
    torch.cuda.empty_cache()
    ie2e = phase_e2e_implicit(isolver, ImplicitGQSolver, cuda_lib, fused_cg, args.implicit_steps,
                              DTypePolicy, strict=full, tag="interleaved_implicit")
    phase_interleaved_vs_parity_implicit(isolver, ImplicitGQSolver, ie2e.pop("state"), full)
    s1i = phase_spmd1_implicit(isolver, ImplicitGQSolver, cuda_lib, ie2e["ms_per_step"])
    del isolver
    torch.cuda.empty_cache()

    pst = "cfd_with_cuda_tpu/ops/pallas_stencil.py"
    lx, li = xe2e["launches"], ie2e["launches"]
    return [
        ("window_spmv_k", "window_stencil.cu", pst + ":132", lx["window_spmv_k"],
         kint["window_spmv_k"]),
        ("window_spmv_k_plus_a", "window_stencil.cu", pst + ":132",
         xe2e["assemble"]["launches"]["window_spmv_k_plus_a"], kint["window_spmv_k_plus_a"]),
        ("window_spmv_mk_plus_a", "window_stencil.cu", pst + ":132",
         li["window_spmv_mk_plus_a"], kint["window_spmv_mk_plus_a"]),
        ("window_spmv_m", "window_stencil.cu", pst + ":132", li["window_spmv_m"],
         kint["window_spmv_m"]),
        ("grad_window", "window_stencil.cu", pst + ":132", lx["grad_window"],
         kint["grad_window"]),
        ("div_compact_interleaved", "div_compact.cu", pst + ":271",
         lx["div_compact_interleaved"], kint["div_compact_interleaved"]),
        ("parity_window_apply_k", "parity_apply.cu", "cfd_with_cuda_tpu/ops/parity_stencil.py:253",
         wapp["k"]["launches"], wapp["k"]),
        ("parity_window_apply_g", "parity_apply.cu", "cfd_with_cuda_tpu/ops/parity_stencil.py:253",
         wapp["g"]["launches"], wapp["g"]),
        # phase 13: the sharded path's launches on a rank's rows (one rank, NCCL);
        # G^T replaces the DIV mode that parallel/sharded_stencil.py:204-235 reaches
        ("sharded_spmv_k", "window_stencil.cu", pst + ":132", s1x["launches"]["sharded_spmv_k"],
         skern["sharded_spmv_k"]),
        ("sharded_spmv_k_plus_a", "window_stencil.cu", pst + ":132",
         s1x["assemble"]["launches"]["sharded_spmv_k_plus_a"], skern["sharded_spmv_k_plus_a"]),
        ("sharded_spmv_mk_plus_a", "window_stencil.cu", pst + ":132",
         s1i["launches"]["sharded_spmv_mk_plus_a"], skern["sharded_spmv_mk_plus_a"]),
        ("sharded_spmv_m", "window_stencil.cu", pst + ":132", s1i["launches"]["sharded_spmv_m"],
         skern["sharded_spmv_m"]),
        ("sharded_grad", "window_stencil.cu", pst + ":132", s1x["launches"]["sharded_grad"],
         skern["sharded_grad"]),
        ("sharded_div_compact", "div_compact.cu", pst + ":132",
         s1x["launches"]["sharded_div_compact"], skern["sharded_div_compact"]),
    ]


# ---------------------------------------------------------------- phase 7

def _streamed_check(pstl, wc, x, pairs, wc2=None, pairs2=None) -> dict:
    """One launch form of the streamed-field kernel (TPU kernel row 3) on a
    velocity field: bit for bit against the resident form, against the plain
    version within APPLY_TOL; device ms (``queued_ms``) and CUDA-event ms per
    call of the streamed and resident forms, the plain version's ms and
    cuSPARSE CSR's of the same operator; the byte bound counting
    the nonzero weights (the kernels stream the whole tables:
    ``stream_bound_ms``)."""
    import torch

    kw = dict(pairs=pairs, co=3, wc2=wc2, pairs2=pairs2)
    y = pstl.parity_apply(wc, x, stream_x=True, **kw)
    y_res = pstl.parity_apply(wc, x, stream_x=False, **kw)
    y_plain = pstl.parity_apply_plain(wc, x, **kw)
    y_abs = pstl.parity_apply_plain(wc.abs(), x.abs(), pairs=pairs, co=3,
                                    wc2=None if wc2 is None else wc2.abs(), pairs2=pairs2)
    torch.cuda.synchronize()
    err, rel = _apply_err(y, y_plain, y_abs)
    if not torch.equal(y, y_res) or not rel <= APPLY_TOL:
        raise AssertionError(f"streamed parity_apply: bit-equal to resident "
                             f"{torch.equal(y, y_res)}, vs plain {rel:.3e} > {APPLY_TOL}")
    del y_res, y_plain, y_abs
    sp = x.shape[-1]
    tables = [wc] + ([] if wc2 is None else [wc2])
    a = _route_csr(tables, [pairs] + ([] if wc2 is None else [pairs2]), sp, 8, per_channel=False)
    xt = x.reshape(3, 8 * sp).T.contiguous()
    lib_err = float((torch.sparse.mm(a, xt).T.reshape(3, 8, sp) - y).abs().max())
    nz = sum(nnz(t) for t in tables)
    fields = x.numel() + y.numel()
    b_ms, b_by = bound(4 * (nz + fields), 2 * nz * 3)
    streamed = lambda: pstl.parity_apply(wc, x, stream_x=True, **kw)
    resident = lambda: pstl.parity_apply(wc, x, stream_x=False, **kw)
    out = dict(
        bit_equal_resident=True, max_abs_err=err, err_rel=rel, tol=APPLY_TOL,
        ms=queued_ms(streamed, 20), event_ms=time_ms(streamed, 20),
        resident_ms=queued_ms(resident, 20), resident_event_ms=time_ms(resident, 20),
        plain_ms=time_ms(lambda: pstl.parity_apply_plain(wc, x, **kw), 3),
        library_ms=time_ms(lambda: torch.sparse.mm(a, xt), 20), library_abs_err=lib_err,
        bound_ms=b_ms, bound_by=b_by, bytes=4 * (nz + fields), flops=2 * nz * 3, nnz=nz,
        planes=sum(int(t.shape[1]) for t in tables),
        stream_bound_ms=bound(4 * (sum(t.numel() for t in tables) + fields), 0)[0],
    )
    del a
    return out


def _ne85_configs(cache_dir=None):
    """(explicit, implicit) configs of phase 7's NE85184 runs: F32, CG tol 1e-6,
    warm start, chunks of 25 (the explicit one with the fused CG loop);
    ``cache_dir`` their setup cache."""
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    base = dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, pressure_warm_start=True,
                steps_per_chunk=25, setup_cache=cache_dir)
    return SolverConfig(pressure_cg_fuse_loop=True, **base), SolverConfig(**base)


def _ne85_deck(cavity_deck, n):
    return cavity_deck(n, cluster=2.0, viscosity=0.01, dt=NE85_DT)


def phase_e2e_ne85(solver, ExplicitBCHSolver, pstl, cuda_lib, n_steps, finite_steps,
                   strict, deck_n) -> dict:
    """The ``ne85`` row's config (F32, CG tol 1e-6, warm start, fused CG loop)
    from rest: warm-up then timed steps with the launch counts held against
    the sub-iteration history, every K and K + A apply in the form the rule
    picks (streamed at NE85184); 3 steps against the plain path; then on,
    untimed, to ``finite_steps`` with finite fields."""
    import numpy as np
    import torch

    sp = solver.sp_c
    streamed = pstl.stream_field((3, 8, sp), 4, solver.k_pairs, solver.conv_pairs2)
    if streamed != pstl.stream_field((3, 8, sp), 4, solver.k_pairs):
        raise AssertionError("ne85: K and K + A take different field forms")
    sfx = "_streamed" if streamed else ""
    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    on_path, want = _explicit_parity_expect(hist, counts, sfx)
    if len(hist) != n_steps or min(on_path.values()) <= 0 or counts != want:
        raise AssertionError(f"ne85: {len(hist)} steps, launch counts {counts}, expected {want}")
    if not (torch.isfinite(state.un).all() and torch.isfinite(state.pn).all()):
        raise AssertionError("ne85: non-finite fields")
    subs = [int(h["iters"]) for h in hist]
    out = dict(
        phase="e2e_ne85", deck=f"cavity_deck({deck_n}, cluster=2.0, dt={NE85_DT})",
        streamed=streamed, steps=n_steps, warmup_steps=warm,
        ms_per_step=(t2 - t1) / (n_steps - warm) * 1e3, warmup_s=t1 - t0,
        sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
        cg_iters_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
        u_mon=hist[-1]["u_mon"], launches=counts,
        launches_per_step=f"s sub-iterations: parity_apply_k_plus_a{sfx} s, parity_apply_k{sfx} "
                          "s - 1, parity_apply_g s + 1, div_compact s, cg_solve s",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)
    out["state"] = state

    # ---- the kernel path against the plain path, 3 steps from this state
    plain = ExplicitBCHSolver.from_tables(solver.deck, solver.config, solver.d,
                                          solver.static_attrs(), device=solver.device, plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=3)
    counts_k = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=3)
    want = _explicit_parity_expect(h_k, counts_k, sfx)[1]
    if dict(cuda_lib.launch_counts) != counts_k or counts_k != want:
        raise AssertionError(f"ne85 3 steps: launch counts {counts_k}, expected {want}")
    tols = STEP_TOLS if strict else dict(u=float("inf"), p=float("inf"), mon=float("inf"))
    _compare_runs("ne85_kernel_vs_plain_3_steps", h_k, h_p, solver.fields(st_k),
                  plain.fields(st_p), tols, 1)
    del plain, st_p

    # ---- on, untimed, to finite_steps (dt 1e-3 blew up near step 100 here)
    done = n_steps + 3
    st, h = solver.run(st_k, n_steps=max(0, finite_steps - done))
    u, p = solver.fields(st)
    finite = bool(np.isfinite(u).all() and np.isfinite(p).all())
    out["finite_to"] = dict(phase="ne85_finite", steps=max(done, finite_steps), finite=finite,
                            u_mon=(h or h_k)[-1]["u_mon"], max_abs_u=float(np.abs(u).max()))
    emit(out["finite_to"])
    if not finite:
        raise AssertionError(f"ne85: non-finite fields by step {finite_steps}")
    return out


def ne85_phases(args, setup, cavity_deck, cuda_lib, fused_cg, parity_stencil, window_stencil,
                ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy) -> list:
    """Phase 7, the parity layout of both solvers on the NE85184 cavity, where
    the JAX package's rule streams every velocity field: ``kernels_streamed``
    (TPU kernel row 3 in its K, K + A and MK + A forms on the solvers' own
    tables, against the resident form and the plain version; and the compact
    G^T, row 4, at these shapes), ``e2e_ne85``, ``cg_modes`` on the explicit
    solver's 125-slot Z (91,125 rows) and ``e2e_ne85_implicit``.  The rows of
    the ``kernels`` line it measures.  Both host setups ran in the setup
    worker (``setup``: :func:`start_setup_worker`'s process and cache)."""
    import numpy as np
    import torch

    pstl = parity_stencil
    strict = args.ne85_n == NE85_N
    rng = np.random.default_rng(20261019)
    cfg, icfg = _ne85_configs(setup[1])
    worker = wait_for_setup(setup, "ne85_explicit")
    t0 = time.time()
    solver = ExplicitBCHSolver(_ne85_deck(cavity_deck, args.ne85_n), cfg)
    sp = solver.sp_c
    emit(dict(phase="setup_ne85", layout=solver.layout, nn=solver.nn, nnp=solver.nnp, sp=sp,
              k_planes=int(solver.d["Kp"].shape[1]), setup_worker=worker,
              setup_cache_hit=solver.setup_cache_hit, setup_s=time.time() - t0))
    if solver.layout != "parity":
        raise AssertionError(f"ne85: the explicit solver took {solver.layout}")
    e2e = phase_e2e_ne85(solver, ExplicitBCHSolver, pstl, cuda_lib, args.ne85_steps,
                         args.ne85_finite_steps, strict, args.ne85_n)
    if strict and not e2e["streamed"]:
        raise AssertionError("ne85: the velocity field did not stream at NE85184")
    # ---- K and K + A with this step's convection planes, a seeded velocity
    u = torch.from_numpy(rng.standard_normal((3, 8, sp)).astype(np.float32)).to(solver.device)
    ks = {"k": _streamed_check(pstl, solver.d["Kp"], u, solver.k_pairs)}
    planes = pstl.conv_planes_from_ae(solver._parity_conv_ae(solver.d, e2e.pop("state").un, True),
                                      groups=solver.conv_groups)
    ks["k_plus_a"] = _streamed_check(pstl, solver.d["Kp"], u, solver.k_pairs, planes,
                                     solver.conv_pairs2)
    del planes
    # ---- the compact G^T (TPU kernel row 4) at these shapes
    ks["div_compact"] = _div_compact_check(pstl, window_stencil, solver.d["GT_cwin"], u,
                                           solver.coarse_dims)
    # ---- the CG modes on its 125-slot Z (the CG takes 60-64 % of this cell's
    # device time), a divergence-shaped right-hand side as on NE27000
    d = solver.d
    b = pstl.parity_div_apply_plain(d["GT_cwin"], u, solver.coarse_dims)[: solver.nnp].clone()
    if solver.pin_grid >= 0:
        b[solver.pin_grid] = 0.0
    cold = fused_cg.fused_cg(d["Z_win"], b, d["Z_dinv"], dims=solver.coarse_dims,
                             radius=solver.z_radius, tol=cfg.pressure_cg_tol,
                             maxiter=cfg.pressure_cg_maxiter, fuse_loop=True)
    noise = torch.from_numpy(rng.standard_normal(solver.nnp).astype(np.float32)).to(solver.device)
    x0 = (cold.x * (1 + 1e-3 * noise)).contiguous()
    phase_cg_modes("ne85_explicit_z", fused_cg, window_stencil, d["Z_win"], d["Z_dinv"], b, x0,
                   solver.coarse_dims, solver.z_radius, cfg.pressure_cg_tol,
                   cfg.pressure_cg_maxiter, strict=strict)
    del solver, d, b, cold, x0
    torch.cuda.empty_cache()

    worker = wait_for_setup(setup, "ne85_implicit")
    t0 = time.time()
    isolver = ImplicitGQSolver(_ne85_deck(cavity_deck, args.ne85_n), icfg)
    emit(dict(phase="setup_ne85_implicit", layout=isolver.layout, setup_worker=worker,
              setup_cache_hit=isolver.setup_cache_hit, setup_s=time.time() - t0,
              a_planes=int(isolver.d["MKp"].shape[1])))
    if isolver.layout != "parity":
        raise AssertionError(f"ne85: the implicit solver took {isolver.layout}")
    # the M and MK + A applies in the form the rule picks: streamed at NE85184
    streamed = pstl.stream_field((3, 8, isolver.sp_c), 4, isolver.a_pairs)
    if streamed != pstl.stream_field((3, 8, isolver.sp_c), 4, isolver.m_pairs):
        raise AssertionError("ne85 implicit: M and MK + A take different field forms")
    if strict and not streamed:
        raise AssertionError("ne85: the implicit velocity field did not stream at NE85184")
    k_name = "parity_apply_k_streamed" if streamed else "parity_apply_k"
    ie2e = phase_e2e_implicit(isolver, ImplicitGQSolver, cuda_lib, fused_cg,
                              args.ne85_implicit_steps, DTypePolicy, strict, tag="ne85_implicit",
                              k_name=k_name, cg_iters_tol=NE85_CG_ITERS_TOL, variants=False)
    # ---- MK + A of this step's LHS
    a_wc = isolver._parity_lhs(isolver.d, ie2e.pop("state").uk)
    ks["mk_plus_a"] = _streamed_check(pstl, a_wc, u, isolver.a_pairs)
    del isolver, a_wc, u
    torch.cuda.empty_cache()
    emit(dict(phase="kernels_streamed", deck_n=args.ne85_n, sp=sp, checks=ks))

    src = "cfd_with_cuda_tpu/ops/parity_stencil.py:509"
    lx, li = e2e["launches"], ie2e["launches"]
    return [
        ("parity_apply_k_streamed", "parity_apply.cu", src, lx["parity_apply_k_streamed"], ks["k"]),
        ("parity_apply_k_plus_a_streamed", "parity_apply.cu", src,
         lx["parity_apply_k_plus_a_streamed"], ks["k_plus_a"]),
        ("parity_apply_mk_plus_a_streamed", "parity_apply.cu", src,
         li["parity_apply_k_streamed"], ks["mk_plus_a"]),
    ]


def phase_parity_box(pstl, box_cavity_deck, ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy,
                     SolverConfig) -> dict:
    """Both field forms of ``parity_apply`` on the routes of a non-cubic box
    (``box_cavity_deck()``: 5 x 3 x 4 elements, coarse dims (6, 4, 5), so
    its coarse shifts differ by axis), K, G, K + A (explicit parity solver),
    MK + A and M (implicit): each form against its plain version within
    APPLY_TOL, the resident and streamed forms bit for bit; the phase's own
    seconds, setup included."""
    import numpy as np
    import torch

    t0 = time.time()
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32)
    deck = box_cavity_deck(viscosity=0.01, dt=0.01)
    s, i = ExplicitBCHSolver(deck, cfg), ImplicitGQSolver(deck, cfg)
    if s.layout != "parity" or i.layout != "parity":
        raise AssertionError(f"box: the solvers took {s.layout}, {i.layout}")
    checks = {}
    forms = pstl.parity_forms(s, i, np.random.default_rng(20261201))
    for name, wc, x, pairs, wc2, pairs2 in forms:
        kw = dict(pairs=pairs, co=3, wc2=wc2, pairs2=pairs2)
        y = pstl.parity_apply(wc, x, stream_x=False, **kw)
        y_s = pstl.parity_apply(wc, x, stream_x=True, **kw)
        y_plain = pstl.parity_apply_plain(wc, x, **kw)
        y_abs = pstl.parity_apply_plain(wc.abs(), x.abs(), pairs=pairs, co=3,
                                        wc2=None if wc2 is None else wc2.abs(), pairs2=pairs2)
        torch.cuda.synchronize()
        err, rel = _apply_err(y, y_plain, y_abs)
        bits = torch.equal(y.view(torch.int32), y_s.view(torch.int32))
        if not bits or not rel <= APPLY_TOL:
            raise AssertionError(f"box {name}: forms bit-equal {bits}, vs plain {rel:.3e} > "
                                 f"{APPLY_TOL}")
        checks[name] = dict(max_abs_err=err, err_rel=rel, streamed_bit_equal=bits,
                            entries=[len(c) + (0 if pairs2 is None else len(pairs2[p]))
                                     for p, c in enumerate(pairs)])
    out = dict(phase="parity_apply_box", deck="box_cavity_deck() (5 x 3 x 4 elements)",
               coarse_dims=list(s.coarse_dims), sp=s.sp_c, tol=APPLY_TOL, checks=checks,
               seconds=time.time() - t0)
    emit(out)
    return out


# ---------------------------------------------------------------- phase 9

# The XLA structured path (the JAX package's default SolverConfig(): F64 and
# pressure_precond="auto", off the kernel path, so DIA / window-patches
# applies of torch ops, the torch CG and the multigrid V-cycle) against the
# stored f64 run of precision_ne27000.npz (scripts/precision_parity.py:67-76:
# F64, CG tol 1e-6, warm start, chunks of 5, "auto" = multigrid), the JAX
# package's on a TPU, where f64 is emulated.  The aims were 1e-9 absolute for
# the monitor and 1e-8 of max|u| for the field, never above 1e-8 and 1e-6.
# The card read (H100 80GB HBM3, 700 W): every one of the 100 CG counts equal
# to the stored run's, the monitor apart by 8.7e-14 at step 1, over 1e-9 from
# step 20, over 1e-8 from step 78, 2.4e-8 at step 100, the field by 6.1e-7 of
# max|u|.  The monitor misses the 1e-8 cap, and a reading that far off cannot
# tell F64 from F32 (the port's F32 run reads 2.2e-8 against the same rows).
# So against the stored run the CG count of every step and the field (at the
# cap) are held and the monitor is printed; what holds the card's F64 run is
# the port's own CPU path at the same size: the first XLA_F64_CPU_STEPS steps
# on the same tables, monitors and fields within XLA_CARD_CPU_TOL, every count
# equal (read: fields 3.3e-16 / 4.4e-16, monitors 1.3e-18; the F32 run of (c)
# reads 2.8e-7 against the same CPU run, so the bound tells F64 from F32).
# tests/test_torch_xla_solvers.py holds that CPU path against the JAX
# package's on the CPU in this config, with a V-cycle as deep as NE27000's
XLA_F64_FIELD_TOL = 1e-6
# the f32 bounds of the parity path's e2e phase against the same run
XLA_F32_U_MON_TOL, XLA_F32_FIELD_TOL = 1e-5, 1e-2
# the card against the CPU (3 F64 steps of both solvers on cavity_deck(8), and
# the first steps of (a)): two f64 runs of one algorithm whose reductions sum
# in different orders, of max|u| and max|p|
XLA_CARD_CPU_TOL = 1e-11
# depth cut to keep the whole script under 1,100 s (H100 80GB HBM3, 700 W: the
# CPU run took 77.9 s for 20 steps on a slower host, 42.9 s for 6 beside phase
# 14's additions): 3 steps, not 20
XLA_F64_CPU_STEPS = 3
XLA_DECK_N = 8


def _xla_run(solver, cuda_lib, n_steps, what):
    """``n_steps`` from rest with every launch counter set to 0 first: (state,
    history, ms/step after the warm-up, peak device GB).  Raises if a
    hand-written kernel launched (the XLA path runs torch ops only) or a field
    is not finite."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    warm = min(WARMUP_STEPS, n_steps - 1)
    state, h_w = solver.run(solver.initial_state(), n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, h_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    ms = (time.time() - t1) / (n_steps - warm) * 1e3
    launched = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    if launched:
        raise AssertionError(f"{what}: hand-written kernels launched on the XLA path: {launched}")
    fields = state[:2]
    if not all(bool(torch.isfinite(f).all()) for f in fields):
        raise AssertionError(f"{what}: non-finite fields")
    return state, h_w + h_t, ms, torch.cuda.max_memory_allocated() / 2**30


def _vs_stored_f64(solver, state, hist, tols):
    """The run's monitor trace, final velocity and CG counts against the
    stored f64 run's: the largest differences (the monitor's also relative to
    the stored |u_mon| of each step), the first step over each bound, and the
    steps whose CG count differs.  ``tols``: ``field`` (of max|u|) and, where
    the monitor is held, ``u_mon`` (absolute)."""
    import numpy as np

    ref = np.load(REPO / "cfd_with_cuda_tpu" / "validation" / "data" / "precision_ne27000.npz")
    n = len(ref["f64_u_mon"])
    dmon = np.abs(np.asarray([h["u_mon"] for h in hist[:n]]) - ref["f64_u_mon"])
    rmon = dmon / np.abs(ref["f64_u_mon"])
    over = np.flatnonzero(dmon > tols.get("u_mon", np.inf))
    u, _ = solver.fields(state)
    cg = np.asarray([int(h["cg_iters"]) for h in hist[:n]])
    off = np.flatnonzero(cg != ref["f64_cg"])
    return dict(du_mon=float(dmon.max()), du_mon_rel=float(rmon.max()), tols=tols,
                first_step_over_u_mon_bound=int(over[0]) + 1 if over.size else None,
                first_step_over_abs={str(a): next((k + 1 for k, v in enumerate(dmon) if v > a),
                                                  None) for a in (1e-9, 1e-8)},
                du_mon_at=[float(v) for v in dmon[[0, 9, 19, 49, n - 1]]],
                dfield=float(np.abs(u - ref["f64_u"]).max() / np.abs(ref["f64_u"]).max()),
                cg_iters_total=int(cg.sum()), stored_cg_iters_total=int(ref["f64_cg"].sum()),
                cg_steps_differing=[int(i) + 1 for i in off[:10]])


def _vs_cpu(solver, cls, cuda_lib, n_steps, ref=None):
    """The card's first ``n_steps`` from rest against the same steps of the
    port's CPU path on the same tables (or against ``ref``, such a CPU run
    kept from another phase): the largest monitor difference over the steps
    and the final fields' (of max|u| and max|p|), whether the sub-iteration
    and CG counts of every step are equal, the CPU's seconds; and the CPU
    run, ``(u, p, history)``."""
    import numpy as np

    cuda_lib.reset_launch_counts()
    state_c, hist_c = solver.run(n_steps=n_steps)
    if any(cuda_lib.launch_counts.values()):
        raise AssertionError("card against CPU: hand-written kernels launched")
    t0 = time.time()
    if ref is None:
        cpu = cls.from_tables(solver.deck, solver.config,
                              {k: v.cpu() for k, v in solver.d.items()},
                              solver.static_attrs(), device="cpu")
        state_h, hist_h = cpu.run(n_steps=n_steps)
        ref = (*cpu.fields(state_h), hist_h)
    cpu_s = time.time() - t0
    (u_c, p_c), (u_h, p_h, hist_h) = solver.fields(state_c), ref
    u_max, p_max = float(np.abs(u_h).max()), float(np.abs(p_h).max())
    mon = lambda f: max(abs(float(a[f]) - float(b[f])) for a, b in zip(hist_c, hist_h))
    counts = lambda h: [[int(x["iters"]), int(x["cg_iters"])] for x in h]
    return dict(steps=n_steps, tol=XLA_CARD_CPU_TOL,
                du_mon=max(mon(f) for f in ("u_mon", "v_mon", "w_mon")) / u_max,
                dp_mon=mon("p_mon") / p_max,
                du=float(np.abs(u_c - u_h).max()) / u_max,
                dp=float(np.abs(p_c - p_h).max()) / p_max,
                counts_equal=counts(hist_c) == counts(hist_h),
                cg_iters_total=sum(c[1] for c in counts(hist_h)), cpu_s=cpu_s), ref


def _within_card_cpu_tol(r) -> bool:
    return r["counts_equal"] and max(r["du_mon"], r["dp_mon"], r["du"],
                                     r["dp"]) <= XLA_CARD_CPU_TOL


def phase_e2e_xla_explicit(deck, ExplicitBCHSolver, cuda_lib, cfg, n_steps, tag, tols,
                           strict, cpu_steps=0, cpu_ref=None) -> dict:
    """(a) and (c): ``n_steps`` explicit steps from rest on the XLA
    structured path, held against the stored f64 run (at NE27000 and 100
    steps): the final field, under F64 the CG count of every step, and the
    monitor trace where ``tols`` holds it.  Under F64 also the first
    ``cpu_steps`` against the port's CPU path (:func:`_vs_cpu`), whose run
    is returned as ``out["cpu_ref"]``; given that run as ``cpu_ref``, an F32
    run's first steps are read against it, and must fail the card-against-CPU
    bound that holds the F64 run."""
    t0 = time.time()
    solver = ExplicitBCHSolver(deck, cfg)
    setup_s = time.time() - t0
    if not (solver.xla and solver.use_mg and solver.layout == "interleaved"):
        raise AssertionError(f"{tag}: the XLA structured path with multigrid was not taken")
    state, hist, ms, peak = _xla_run(solver, cuda_lib, n_steps, tag)
    subs = [int(h["iters"]) for h in hist]
    out = dict(phase=tag, steps=n_steps, setup_s=setup_s, ms_per_step=ms, peak_mem_gb=peak,
               table_mb=sum(v.numel() * v.element_size() for v in solver.d.values()) / 1e6,
               f64_dia=solver.f64_dia, mg_dims=solver.mg_dims, mg_omegas=solver.mg_omegas,
               sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
               cg_iters_mean=sum(h["cg_iters"] for h in hist) / len(hist),
               u_mon=hist[-1]["u_mon"], launches=0)
    if strict and n_steps >= 100:
        out["vs_stored_f64"] = cmp = _vs_stored_f64(solver, state, hist, tols)
    ref = None
    if solver.f64_dia and cpu_steps:
        out["vs_cpu"], ref = _vs_cpu(solver, ExplicitBCHSolver, cuda_lib, cpu_steps)
    elif cpu_ref is not None:
        out["vs_f64_cpu"], _ = _vs_cpu(solver, ExplicitBCHSolver, cuda_lib,
                                       len(cpu_ref[2]), cpu_ref)
    out["seconds"] = time.time() - t0
    emit(out)
    out["cpu_ref"] = ref
    if strict and n_steps >= 100:
        ok = (cmp["first_step_over_u_mon_bound"] is None
              and (n_steps > 100 or cmp["dfield"] <= tols["field"]))
        if solver.f64_dia:
            ok = ok and not cmp["cg_steps_differing"]
        if not ok:
            raise AssertionError(f"{tag} against the stored f64 run: {cmp}")
    if "vs_cpu" in out and not _within_card_cpu_tol(out["vs_cpu"]):
        raise AssertionError(f"{tag}: card against CPU: {out['vs_cpu']}")
    if "vs_f64_cpu" in out and _within_card_cpu_tol(out["vs_f64_cpu"]):
        raise AssertionError(f"{tag}: the card-against-CPU bound does not tell this run from "
                             f"F64: {out['vs_f64_cpu']}")
    out["solver"] = solver
    return out


# The implicit F64 default config with "mg" against "jacobi".  Both CGs stop
# at 1e-12 of ||b||, so the pressure increments part by about cond(Z) x
# 1e-12 relative: bound 1e-9 of max|p| and max|u| (a condition allowance of
# 1e3) after step 1, where both momentum solves see the same inputs (p = 0)
# and u agrees bit for bit, and after 20 steps, where the momentum BiCGStab
# (2-4 iterations a step here) carries the difference on.  Read on the card
# (H100 80GB HBM3, 700 W): p 1.9e-13 after step 1, u 2.8e-15 and p 5.2e-15
# after 20.  (A BiCGStab of ~30 iterations, as on cavity_deck(6), does not
# track its RHS so closely: there a 1e-13 difference grew to 8e-6 of max|u|
# in two steps.)
XLA_MG_JACOBI_TOLS = dict(p_step1=1e-9, u=1e-9, p=1e-9)


def phase_e2e_xla_implicit(deck, ImplicitGQSolver, cuda_lib, SolverConfig, cfg, n_steps,
                           strict) -> dict:
    """(b): ``n_steps`` implicit steps from rest in the JAX package's default
    F64 config, with ``"mg"`` and with ``"jacobi"`` (the latter on the former's
    tables): counts, ms/step, and the fields held together after step 1 and
    after the run."""
    import numpy as np

    t0 = time.time()
    solver = ImplicitGQSolver(deck, cfg)
    setup_s = time.time() - t0
    if not (solver.xla and solver.use_mg and solver.f64_dia):
        raise AssertionError("e2e_xla_f64_implicit: the XLA path with multigrid was not taken")
    attrs = solver.static_attrs() | {"use_mg": False}
    jac = ImplicitGQSolver.from_tables(solver.deck, SolverConfig(steps_per_chunk=5,
                                                                 pressure_precond="jacobi"),
                                       {k: v for k, v in solver.d.items()
                                        if not k.startswith("mg_")}, attrs)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    runs, first = {}, {}
    for name, s in (("mg", solver), ("jacobi", jac)):
        state, hist, ms, peak = _xla_run(s, cuda_lib, n_steps, f"e2e_xla_f64_implicit {name}")
        first[name] = s.fields(s.run(n_steps=1)[0])
        runs[name] = dict(fields=s.fields(state), ms_per_step=ms, peak_mem_gb=peak,
                          cg_iters=[int(h["cg_iters"]) for h in hist],
                          mom_iters=[int(h["mom_iters"]) for h in hist],
                          u_mon=hist[-1]["u_mon"])
    (u_m, p_m), (u_j, p_j) = runs["mg"].pop("fields"), runs["jacobi"].pop("fields")
    (u1_m, p1_m), (u1_j, p1_j) = first["mg"], first["jacobi"]
    out = dict(phase="e2e_xla_f64_implicit", steps=n_steps, setup_s=setup_s,
               mg_dims=solver.mg_dims, runs=runs, du_step1=rel(u1_m, u1_j),
               dp_step1=rel(p1_m, p1_j), du=rel(u_m, u_j), dp=rel(p_m, p_j),
               tols=XLA_MG_JACOBI_TOLS, launches=0, seconds=time.time() - t0)
    emit(out)
    maxiter = solver.config.pressure_cg_maxiter
    if strict and not (out["du_step1"] == 0.0 and out["dp_step1"] <= XLA_MG_JACOBI_TOLS["p_step1"]
                       and out["du"] <= XLA_MG_JACOBI_TOLS["u"]
                       and out["dp"] <= XLA_MG_JACOBI_TOLS["p"]
                       and max(runs["jacobi"]["cg_iters"]) < maxiter
                       and sum(runs["mg"]["cg_iters"]) < sum(runs["jacobi"]["cg_iters"])):
        raise AssertionError(f"implicit mg against jacobi: {out}")
    out["solver"] = solver
    return out


def phase_xla_card_vs_cpu(cavity_deck, ExplicitBCHSolver, ImplicitGQSolver, SolverConfig,
                          cuda_lib) -> dict:
    """(d): 3 F64 steps of both solvers on ``cavity_deck(8)`` in the default
    config, on the card and on the CPU: fields within XLA_CARD_CPU_TOL of
    max|u| and max|p|, equal sub-iteration, CG and BiCGStab counts."""
    import numpy as np

    t0 = time.time()
    out = dict(phase="xla_card_vs_cpu", deck=f"cavity_deck({XLA_DECK_N})", steps=3,
               tol=XLA_CARD_CPU_TOL)
    for name, cls in (("explicit", ExplicitBCHSolver), ("implicit", ImplicitGQSolver)):
        res = {}
        for dev in ("cuda", "cpu"):
            s = cls(cavity_deck(XLA_DECK_N, viscosity=0.01, dt=0.001),
                    SolverConfig(steps_per_chunk=3), device=dev)
            cuda_lib.reset_launch_counts()
            state, hist = s.run(n_steps=3)
            if any(cuda_lib.launch_counts.values()) or not s.xla:
                raise AssertionError(f"xla_card_vs_cpu {name}: not the XLA path")
            res[dev] = (s.fields(state),
                        [[int(h[f]) for f in ("iters", "cg_iters", "mom_iters")] for h in hist])
        (u_c, p_c), counts_c = res["cuda"]
        (u_h, p_h), counts_h = res["cpu"]
        out[name] = dict(du=float(np.abs(u_c - u_h).max() / np.abs(u_h).max()),
                         dp=float(np.abs(p_c - p_h).max() / np.abs(p_h).max()),
                         counts=[counts_c, counts_h])
    out["seconds"] = time.time() - t0
    emit(out)
    for name in ("explicit", "implicit"):
        r = out[name]
        if not (r["du"] <= XLA_CARD_CPU_TOL and r["dp"] <= XLA_CARD_CPU_TOL
                and r["counts"][0] == r["counts"][1]):
            raise AssertionError(f"xla_card_vs_cpu {name}: {r}")
    return out


def _xla_configs(cache_dir=None):
    """(explicit F64, implicit F64, explicit F32) configs of phase 9's runs on
    the cavity: the stored f64 run's (CG tol 1e-6, warm start, chunks of 5,
    the V-cycle under "auto"), the JAX package's default with "mg", F32
    through the V-cycle; ``cache_dir`` their setup cache."""
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    return (SolverConfig(dtype_policy=DTypePolicy.F64, pressure_cg_tol=1e-6,
                         pressure_warm_start=True, steps_per_chunk=5, pressure_precond="auto",
                         setup_cache=cache_dir),
            SolverConfig(steps_per_chunk=5, pressure_precond="mg", setup_cache=cache_dir),
            SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                         pressure_warm_start=True, steps_per_chunk=25, pressure_precond="mg",
                         setup_cache=cache_dir))


def _xla_deck(cavity_deck, n):
    return cavity_deck(n, cluster=2.0, viscosity=0.01, dt=0.001)


def xla_phases(args, setup, cavity_deck, cuda_lib, ExplicitBCHSolver, ImplicitGQSolver,
               SolverConfig) -> None:
    """Phase 9: the XLA structured path of both solvers on the cavity (the
    three host setups ran in the setup worker, ``setup``)."""
    import torch

    t0 = time.time()
    full = args.deck_n == 30
    deck = lambda: _xla_deck(cavity_deck, args.deck_n)
    f64, icfg, f32 = _xla_configs(setup[1])
    # (a) the stored f64 run's config
    emit(dict(phase="xla_setup_worker", explicit=wait_for_setup(setup, "xla_f64"),
              implicit=wait_for_setup(setup, "xla_f64_implicit"),
              f32=wait_for_setup(setup, "xla_f32")))
    ex = phase_e2e_xla_explicit(deck(), ExplicitBCHSolver, cuda_lib, f64, args.xla_steps,
                                "e2e_xla_f64", dict(field=XLA_F64_FIELD_TOL), full,
                                args.xla_cpu_steps)
    cpu_ref = ex["cpu_ref"]
    # phase 14 (a): the JAX package's default SolverConfig() placed over one NCCL
    # rank against one device, on these tables (the config shapes none of them)
    default = SolverConfig(steps_per_chunk=args.placed_steps)
    s = ex.pop("solver")
    phase_placed_one_rank("placed_xla_f64", ExplicitBCHSolver.from_tables(
        s.deck, default, s.d, s.static_attrs()), ExplicitBCHSolver, cuda_lib,
        args.placed_steps, "explicit")
    del s, ex
    torch.cuda.empty_cache()
    # (b) the implicit solver in the default F64 config, "mg" and "jacobi"
    s = phase_e2e_xla_implicit(deck(), ImplicitGQSolver, cuda_lib, SolverConfig, icfg,
                               args.xla_implicit_steps, full).pop("solver")
    phase_placed_one_rank("placed_xla_f64_implicit", ImplicitGQSolver.from_tables(
        s.deck, default, s.d, s.static_attrs()), ImplicitGQSolver, cuda_lib,
        args.placed_steps, "implicit")
    # and with the CR momentum solve, its dots reduced over the rank: one
    # rank's sum is the whole sum, so bit for bit is required
    phase_placed_one_rank("placed_xla_f64_implicit_cr", ImplicitGQSolver.from_tables(
        s.deck, dataclasses.replace(default, momentum_solver="cr"), s.d, s.static_attrs()),
        ImplicitGQSolver, cuda_lib, args.placed_steps, "implicit", bit_for_bit=True)
    del s
    torch.cuda.empty_cache()
    # (c) F32 through the multigrid V-cycle
    phase_e2e_xla_explicit(deck(), ExplicitBCHSolver, cuda_lib, f32, args.xla_steps,
                           "e2e_xla_f32_mg", dict(u_mon=XLA_F32_U_MON_TOL,
                                                  field=XLA_F32_FIELD_TOL), full,
                           cpu_ref=cpu_ref).pop("solver")
    torch.cuda.empty_cache()
    # (d) the card against the CPU
    phase_xla_card_vs_cpu(cavity_deck, ExplicitBCHSolver, ImplicitGQSolver, SolverConfig,
                          cuda_lib)
    emit(dict(phase="xla_total", seconds=time.time() - t0))


# ---------------------------------------------------------------- phase 10

# The run workflow through the command line, ``python -m
# cfd_with_cuda_tpu_torch`` (``__main__.main`` in-process, its own config:
# F32, CG tol 1e-6, warm start, the default CG loop, chunks of 50,
# setup_cache="auto" pointed at a temporary directory): (a) the NE27000
# cavity written to disk, a fresh run and a setup-cache hit with byte-equal
# products, the library on the same deck, and an isRestart resume; (b) the
# bend at full size, both solvers.
CLI_STEPS = 30
# the resumed run against the uninterrupted one, tests/test_restart.py:31-36's
# explicit bound: the restart file holds u, v, w and p only, so the first
# resumed step re-converges its sub-iterations anew
RESTART_RTOL, RESTART_ATOL = 2e-4, 1e-7
# bendingSquareDuct_49x33x33's class: 48 x 32 x 32 elements, 49 x 33 x 33 corner nodes
BEND_DIMS = (48, 32, 32)
# the explicit run goes on, untimed, until the flow leaves the outflow plane: its mean
# u . n over the plane's interior nodes above tests/test_bending_duct.py:138's 1e-3
BEND_OUTFLOW_UN, BEND_OUTFLOW_STEPS = 1e-3, 1000


def _cli(cli, argv) -> dict:
    """``main(argv)`` in-process; what it ran (``report``)."""
    report = {}
    t0 = time.time()
    rc = cli.main([str(a) for a in argv], report=report)
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    report["cli_s"] = time.time() - t0
    return report


def _cli_launches(what, hist, counts, solver_kind):
    """The field form a CLI run took (the default CG loop), its launch counts
    held against its history: explicit as ``_explicit_parity_expect`` with a
    ``cg_init`` a solve and ``cg_iter`` groups covering at least the last
    solves, implicit as ``_implicit_expect``; every kernel of the path
    launched, nothing else."""
    streamed = any(v for k, v in counts.items() if k.endswith("_streamed"))
    sfx = "_streamed" if streamed else ""
    if solver_kind == "implicit":
        on_path, expect = _implicit_expect(hist, counts, "parity", f"parity_apply_k{sfx}")
    else:
        on_path, _ = _explicit_parity_expect(hist, counts, sfx)
        on_path["cg_init"] = on_path.pop("cg_solve")
        on_path["cg_iter"] = counts["cg_iter"]
        expect = {k: on_path.get(k, 0) for k in counts}
        if counts["cg_iter"] * UNROLL < sum(int(h["cg_iters"]) for h in hist):
            raise AssertionError(f"{what}: cg_iter {counts['cg_iter']} groups for the history")
    if min(on_path.values()) <= 0 or counts != expect:
        raise AssertionError(f"{what}: launch counts {counts}, expected {expect}")
    return "streamed" if streamed else "resident"


def _ms_after_warmup(hist) -> float:
    """Host ms/step of steps WARMUP_STEPS + 1 to the end (the CLI's yardstick)."""
    from cfd_with_cuda_tpu_torch.utils.timers import ms_per_step

    return ms_per_step(hist, WARMUP_STEPS)


def phase_cli_cavity(args, work, cavity_deck, cuda_lib, ExplicitBCHSolver, SolverConfig,
                     DTypePolicy) -> dict:
    """(a) The NE27000 cavity through the command line: runs A (a setup-cache
    miss) and B (a hit) with byte-equal products, the library run D on the
    same file, and the isRestart run C resuming from the step-30 checkpoint."""
    import numpy as np

    from cfd_with_cuda_tpu_torch import __main__ as cli
    from cfd_with_cuda_tpu_torch.io.deck import read_deck, write_fractional_deck
    from cfd_with_cuda_tpu_torch.io.tecplot import read_restart

    n = args.cli_steps
    d = work / "cavity"
    d.mkdir()
    name = f"lidDrivenCavity_NE{args.deck_n ** 3}"
    inp = d / f"{name}.inp"
    write_fractional_deck(inp, cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001))
    (d / "ProblemName.txt").write_text(f"{name}\n")
    dat, restart = d / f"{name}.dat", d / f"{name}_restart.dat"
    argv = [d, "--quiet", "--steps", n, "--tecplot-every", n]

    cuda_lib.reset_launch_counts()
    a = _cli(cli, argv)
    counts = dict(cuda_lib.launch_counts)
    sa = a["solver"]
    form = _cli_launches("cli_cavity A", a["history"], counts, "explicit")
    products = dat.read_bytes(), restart.read_bytes()
    rows = len(products[0].decode().splitlines())
    out = dict(phase="cli_cavity", deck=inp.name, layout=sa.layout, field=form, nn=sa.nn,
               nnp=sa.nnp, steps=n,
               a=dict(setup_s=a["setup_s"], hit=sa.setup_cache_hit,
                      snapshot_bytes=sa.setup_cache_bytes, store_s=sa.setup_cache_store_s,
                      run_s=a["run_s"], ms_per_step=_ms_after_warmup(a["history"]),
                      launches=counts),
               dat_bytes=len(products[0]), dat_rows=rows,
               dat_rows_expected=3 + sa.nn + 8 * sa.deck.ne)
    if sa.setup_cache_hit or not sa.setup_cache_bytes or rows != out["dat_rows_expected"]:
        raise AssertionError(f"cli_cavity A: {out}")

    b = _cli(cli, argv)
    out["b"] = dict(setup_s=b["setup_s"], hit=b["solver"].setup_cache_hit, run_s=b["run_s"])
    out["b_bytes_equal_a"] = (dat.read_bytes(), restart.read_bytes()) == products
    if not (b["solver"].setup_cache_hit and out["b_bytes_equal_a"]):
        raise AssertionError(f"cli_cavity B: {out}")
    del a, b, sa

    # D: the library on the same file, the CLI's config, two runs of n steps
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=50,
                       setup_cache="auto", pressure_warm_start=True)
    t0 = time.time()
    sd = ExplicitBCHSolver(read_deck(inp), cfg)
    setup_d = time.time() - t0
    st, _ = sd.run(n_steps=n)
    t0 = time.time()
    sd.write_tecplot(st, work / "d.dat")
    write_s = time.time() - t0
    (work / "a_restart.dat").write_bytes(products[1])
    t0 = time.time()
    u_r, p_r = read_restart(work / "a_restart.dat", sd.nn, sd.nnp)
    read_s = time.time() - t0
    _, hist_d = sd.run(st, n_steps=n)
    out["d"] = dict(setup_s=setup_d, hit=sd.setup_cache_hit,
                    dat_bytes_equal_a=(work / "d.dat").read_bytes() == products[0],
                    tecplot_write_s=write_s, restart_read_s=read_s)
    if not (sd.setup_cache_hit and out["d"]["dat_bytes_equal_a"]):
        raise AssertionError(f"cli_cavity D: {out}")
    del sd, st

    # C: isRestart, resuming from the step-n checkpoint (a new fingerprint:
    # the flag is deck content, as in the JAX package)
    text = inp.read_text()
    inp.write_text(text.replace("isRestart: 0", "isRestart: 1", 1))
    starts = []
    resolve = ExplicitBCHSolver.resolve_initial_state
    ExplicitBCHSolver.resolve_initial_state = lambda s: starts.append(resolve(s)) or starts[-1]
    try:
        c = _cli(cli, argv)
    finally:
        ExplicitBCHSolver.resolve_initial_state = resolve
    sc = c["solver"]
    u0, p0 = sc.fields(starts[0])
    u_c = np.asarray([h["u_mon"] for h in c["history"]])
    u_d = np.asarray([h["u_mon"] for h in hist_d])
    out["c"] = dict(setup_s=c["setup_s"], hit=sc.setup_cache_hit,
                    first_state_equals_file=bool(
                        np.array_equal(u0, u_r.astype(u0.dtype))
                        and np.array_equal(p0, p_r.astype(p0.dtype))),
                    u_mon_max_rel=float(np.max(np.abs(u_c - u_d) / np.abs(u_d))),
                    rtol=RESTART_RTOL, atol=RESTART_ATOL, u_mon_31_60=[u_c[0], u_c[-1]],
                    library_u_mon_31_60=[u_d[0], u_d[-1]])
    emit(out)
    if not (out["c"]["first_state_equals_file"] and u_c.shape == u_d.shape
            and np.allclose(u_c, u_d, rtol=RESTART_RTOL, atol=RESTART_ATOL)):
        raise AssertionError(f"cli_cavity C: {out['c']}")
    return out


def _outflow_un(solver, state) -> float:
    """Mean u . n over the interior nodes of the bend's outflow plane
    (y = its largest value, normal +y; the walls' nodes left out)."""
    import numpy as np

    c = solver.mesh.coords
    u, _ = solver.fields(state)
    on = np.isclose(c[:, 1], c[:, 1].max())
    x, z = c[on, 0], c[on, 2]
    inner = (x > x.min() + 1e-9) & (x < x.max() - 1e-9) & (z > z.min() + 1e-9) & (z < z.max() - 1e-9)
    return float(u[on, 1][inner].mean())


def _busy_share(solver, state, trace_dir, tag, n_steps=5):
    """(state, device busy share, traced host ms/step) of ``n_steps`` steps
    traced by ``utils/timers.torch_trace`` (``timers.busy_share``: the union
    of the kernel and copy intervals over the host wall time)."""
    import torch

    from cfd_with_cuda_tpu_torch.utils.timers import busy_share, device_spans, torch_trace

    torch.cuda.synchronize()
    with torch_trace(str(trace_dir), f"{tag}.json") as prof:
        t0 = time.perf_counter()
        state, _ = solver.run(state, n_steps=n_steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return state, busy_share(device_spans(prof), wall_us), wall_us / 1e3 / n_steps


def _cg_fixed_depths(s, systems) -> dict:
    """The CG kernels at the fixed depths BFS_FIXED_DEPTHS on a solver's
    pressure systems ``(b, x0, x)`` (the implicit bend's step 1, from zero,
    and step 2, warm-started: Z x0 cancels in r0), against the plain CG,
    beside the plain f32 CG's own rounding there (against the plain CG on
    the f64 widened system at the same depth): {"step<i>_k<k>": (iterations,
    k, kernel vs plain, plain vs f64)}, each of max|x| of the f64 CG."""
    from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg, fused_cg_plain

    win64, dinv64 = s.d["Z_win"].double(), s.d["Z_dinv"].double()
    errs = {}
    for step, (b, x0, _) in enumerate(systems, start=1):
        cold = x0 is None or not bool(x0.abs().max() > 0)
        for k in BFS_FIXED_DEPTHS:
            if k == 0 and cold:
                continue                  # x = 0 on both
            run = lambda solve, win, dinv, bb, xx: solve(
                win, bb, dinv, dims=s.coarse_dims, radius=s.z_radius, tol=0.0, maxiter=k,
                unroll=max(k, 1), x0=xx)
            sol = run(fused_cg, s.d["Z_win"], s.d["Z_dinv"], b, x0)
            ref = run(fused_cg_plain, s.d["Z_win"], s.d["Z_dinv"], b, x0)
            r64 = run(fused_cg_plain, win64, dinv64, b.double(),
                      None if x0 is None else x0.double())
            scale = float(r64.x.abs().max())
            errs[f"step{step}_k{k}"] = (
                int(sol.iters), k, float((sol.x - ref.x).abs().max()) / scale,
                float((ref.x.double() - r64.x).abs().max()) / scale)
    return errs


def _bend_implicit_vs_plain(s, cls, cuda_lib, init, form, strict) -> dict:
    """The implicit bend's first 3 steps, kernel path against plain path.

    On this deck the pressure CG runs 500-600 iterations a step and its
    ||r|| lies flat along tol ||b|| for tens of iterations, so the two
    paths, whose right-hand sides differ by rounding, stop 64 iterations
    apart on step 1 (568 against 504 on an H100) and their fields part by
    ~1e-2 of max|u| after 3 steps: IMPLICIT_TOLS do not apply to the
    fields.  Nor does CG_TRUE_RES_TOL: Z x cancels (||Z|| ||x|| >> ||b||),
    so the f64 true residual of an f32 x stays far above tol however close
    x is to the f64 solve's.  Held instead, on the kernel path's own inputs
    of this run: the first M, MK + A, G and G^T (div_compact) applies on a
    field that is not all zero, each against its plain version on the same
    card tensors (APPLY_TOL, as phase_kernels holds them on the cavity); the
    pressure CG kernels on step 1's and step 2's systems against the plain
    CG at the fixed depths BFS_FIXED_DEPTHS (CG_FIXED_X_TOL, or
    CG_ROUNDING_FACTOR times the plain CG's own f32 rounding there); the launch
    counts, finite fields, step 1's BiCGStab count (both paths start from
    rest), and every pressure solve of both paths against an f64 CG of the
    same system (the f32 table widened, tol 1e-10): x within CG_X_TOL of
    max|x|.  Printed: the fields' differences, and where the kernel CG
    crosses its bound on each path's step-1 system (||r|| / (tol ||b||)
    every UNROLL iterations around both stops)."""
    import torch

    from cfd_with_cuda_tpu_torch.ops import parity_stencil as pstl
    from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg, fused_cg_plain
    from cfd_with_cuda_tpu_torch.solvers import implicit_gq

    systems = {"fused_cg": [], "fused_cg_plain": []}
    saved = {name: getattr(implicit_gq, name) for name in systems}
    apply_k, div_k = pstl.parity_apply, pstl.parity_div_apply
    routes = {"M": s.m_pairs, "MK_plus_A": s.a_pairs, "G": s.g_pairs}
    applies = {}

    def recorder(name):
        def solve(win, b, dinv, **kw):
            sol = saved[name](win, b, dinv, **kw)
            systems[name].append((b.clone(), kw["x0"], sol.x.clone()))
            return sol
        return solve

    # the first call of each route on a field that is not all zero (step 1's
    # G applies to p = 0)
    def apply_recorder(wc, x, **kw):
        y = apply_k(wc, x, **kw)
        for route, pairs in routes.items():
            if kw.get("pairs") is pairs and route not in applies and bool(x.abs().max() > 0):
                applies[route] = (wc.clone(), x.clone(), dict(kw), y.clone())
        return y

    def div_recorder(gt, u, dims):
        y = div_k(gt, u, dims)
        if "div_compact" not in applies and bool(u.abs().max() > 0):
            applies["div_compact"] = (gt, u.clone(), dims, y.clone())
        return y

    for name in systems:
        setattr(implicit_gq, name, recorder(name))
    pstl.parity_apply, pstl.parity_div_apply = apply_recorder, div_recorder
    try:
        cmp = _implicit_vs_plain("cli_bend_implicit_kernel_vs_plain_3_steps", s, cls, cuda_lib,
                                 init, 3, strict=False,
                                 k_name="parity_apply_k" + ("_streamed" if form == "streamed"
                                                            else ""))
    finally:
        for name, fn in saved.items():
            setattr(implicit_gq, name, fn)
        pstl.parity_apply, pstl.parity_div_apply = apply_k, div_k

    # the kernels of the step on the run's own inputs, against their plain versions
    apply_errs = {}
    for route, (wc, x, kw, y) in applies.items():
        if route == "div_compact":
            y_plain = pstl.parity_div_apply_plain(wc, x, kw)
            y_abs = pstl.parity_div_apply_plain(wc.abs(), x.abs(), kw)
        else:
            y_plain = pstl.parity_apply_plain(wc, x, **kw)
            y_abs = pstl.parity_apply_plain(wc.abs(), x.abs(), **kw)
        apply_errs[route] = _apply_err(y, y_plain, y_abs)[1]
    del applies

    cg_errs = _cg_fixed_depths(s, systems["fused_cg"][:2])
    tol = s.config.pressure_cg_tol
    win64, dinv64 = s.d["Z_win"].double(), s.d["Z_dinv"].double()

    def x_err(b, x):
        ref = fused_cg_plain(win64, b.double(), dinv64, dims=s.coarse_dims, radius=s.z_radius,
                             tol=1e-10, maxiter=20000, unroll=UNROLL).x
        return float((x.double() - ref).abs().max() / ref.abs().max())

    x_errs = {name: [x_err(b, x) for b, _, x in solves] for name, solves in systems.items()}
    stops = [k for ks in cmp["cg_iters"] for k in ks[:1]]
    ks = list(range(max(UNROLL, min(stops) - 8 * UNROLL), max(stops) + 2 * UNROLL + 1, UNROLL))
    trace = {}
    for name, solves in systems.items():
        b, x0, _ = solves[0]
        bound = tol * float(torch.linalg.vector_norm(b))
        trace[name] = [float(fused_cg(s.d["Z_win"], b, s.d["Z_dinv"], dims=s.coarse_dims,
                                      radius=s.z_radius, tol=0.0, maxiter=k, x0=x0,
                                      unroll=UNROLL).residual) / bound for k in ks]
    cmp.update(apply_err_rel=apply_errs, apply_tol=APPLY_TOL, cg_fixed_depth=cg_errs,
               cg_fixed_x_tol=CG_FIXED_X_TOL, cg_rounding_factor=CG_ROUNDING_FACTOR, x_err_vs_f64=x_errs, x_err_bound=CG_X_TOL,
               step1_cg_trace=dict(k=ks, kernel_path_system=trace["fused_cg"],
                                   plain_path_system=trace["fused_cg_plain"]))
    emit(dict(phase="cli_bend_implicit_cg", apply_err_rel=apply_errs, cg_fixed_depth=cg_errs,
              x_err_vs_f64=x_errs, step1_cg_trace=cmp["step1_cg_trace"]))
    if sorted(apply_errs) != sorted([*routes, "div_compact"]) or not all(
            e <= APPLY_TOL for e in apply_errs.values()):
        raise AssertionError(f"cli_bend_implicit: kernels vs plain on the run's inputs: "
                             f"{apply_errs}")
    if not all(it == k and e <= max(CG_FIXED_X_TOL, CG_ROUNDING_FACTOR * e64)
               for it, k, e, e64 in cg_errs.values()):
        raise AssertionError(f"cli_bend_implicit: CG at fixed depths (iters, depth, kernel vs "
                             f"plain, plain vs f64): {cg_errs}")
    worst = max(max(v) for v in x_errs.values())
    if strict and not (worst <= CG_X_TOL
                       and cmp["mom_iters"][0][0] == cmp["mom_iters"][1][0]):
        raise AssertionError(f"cli_bend_implicit vs plain: {cmp}")
    return cmp


def phase_cli_bend(args, work, bending_duct_deck, cuda_lib, ExplicitBCHSolver,
                   ImplicitGQSolver) -> list:
    """(b) The bend at full size through the command line: the explicit and
    the implicit solver, each against the plain path over its first 3 steps."""
    import numpy as np

    from cfd_with_cuda_tpu_torch import __main__ as cli
    from cfd_with_cuda_tpu_torch.io.deck import write_fractional_deck
    from cfd_with_cuda_tpu_torch.io.tecplot import read_restart

    dims = tuple(int(v) for v in args.bend_dims.split("x"))
    strict = dims == BEND_DIMS
    d = work / "bend"
    d.mkdir()
    ne = "x".join(str(v + 1) for v in dims)
    inp = d / f"bendingSquareDuct_{ne}.inp"
    write_fractional_deck(inp, bending_duct_deck(*dims))
    outs = []
    for kind, steps, cls in (("explicit", args.bend_steps, ExplicitBCHSolver),
                             ("implicit", args.bend_implicit_steps, ImplicitGQSolver)):
        cuda_lib.reset_launch_counts()
        r = _cli(cli, [inp, "--quiet", "--solver", kind, "--steps", steps])
        counts = dict(cuda_lib.launch_counts)
        s, hist = r["solver"], r["history"]
        form = _cli_launches(f"cli_bend_{kind}", hist, counts, kind)
        u, p = s.fields(r["state"])
        t0 = time.time()
        read_restart(s.restart_path(), s.nn, s.nnp)
        read_s = time.time() - t0
        col = lambda f: [int(h[f]) for h in hist]
        out = dict(phase=f"cli_bend_{kind}", deck=inp.name, layout=s.layout, field=form,
                   nn=s.nn, nnp=s.nnp, setup_s=r["setup_s"], cache_hit=s.setup_cache_hit,
                   snapshot_bytes=s.setup_cache_bytes, store_s=s.setup_cache_store_s,
                   steps=len(hist), run_s=r["run_s"], ms_per_step=_ms_after_warmup(hist),
                   # the run's end: the .dat and the restart file written
                   tecplot_dumps_s=r["run_s"] - hist[-1]["wall"], restart_read_s=read_s,
                   sub_iters=col("iters"), cg_iters=col("cg_iters"), mom_iters=col("mom_iters"),
                   launches=counts, finite=bool(np.isfinite(u).all() and np.isfinite(p).all()),
                   u_mon=hist[-1]["u_mon"])
        # the JAX package's rule: a box (curved coordinates, box topology) whose
        # elements tile it takes the parity layout on the kernel path
        if s.layout != "parity" or not out["finite"] or len(hist) != steps:
            emit(out)
            raise AssertionError(f"cli_bend_{kind}: {out['layout']}, finite {out['finite']}")
        st, busy, traced_ms = _busy_share(s, r["state"], work / "trace", f"bend_{kind}")
        out.update(busy_share=busy, traced_ms_per_step=traced_ms)
        un, ran = _outflow_un(s, st), len(hist) + 5
        while kind == "explicit" and strict and un <= BEND_OUTFLOW_UN and ran < BEND_OUTFLOW_STEPS:
            st, _ = s.run(st, n_steps=50)
            ran += 50
            un = _outflow_un(s, st)
        out.update(outflow_mean_un=un, outflow_after_steps=ran)
        emit(out)
        if not un > (BEND_OUTFLOW_UN if kind == "explicit" and strict else 0.0):
            raise AssertionError(f"cli_bend_{kind}: no flow out of the outflow plane: {un}")
        del st, r
        # the kernel path against the plain path, the first 3 steps from rest
        init = s.initial_state()
        if kind == "explicit":
            plain = cls.from_tables(s.deck, s.config, s.d, s.static_attrs(), device=s.device,
                                    plain=True)
            cuda_lib.reset_launch_counts()
            st_k, h_k = s.run(init, n_steps=3)
            ck = dict(cuda_lib.launch_counts)
            st_p, h_p = plain.run(init, n_steps=3)
            if dict(cuda_lib.launch_counts) != ck:
                raise AssertionError("cli_bend_explicit: the plain path launched a kernel")
            _cli_launches("cli_bend_explicit vs plain", h_k, ck, "explicit")
            out["vs_plain"] = _compare_runs("cli_bend_explicit_kernel_vs_plain_3_steps", h_k, h_p,
                                            s.fields(st_k), plain.fields(st_p), STEP_TOLS, UNROLL)
            del plain
        else:
            out["vs_plain"] = _bend_implicit_vs_plain(s, cls, cuda_lib, init, form, strict)
        outs.append(out)
        del s
    return outs


def cli_phases(args, cavity_deck, bending_duct_deck, cuda_lib, ExplicitBCHSolver,
               ImplicitGQSolver, DTypePolicy, SolverConfig) -> None:
    """Phase 10: the command line, Tecplot output, restart and the setup cache,
    in a temporary problem directory with the setup cache in a temporary
    directory, both removed at the end."""
    import os
    import shutil
    import tempfile

    import torch

    t0 = time.time()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    old = os.environ.get("CFD_TORCH_CACHE_DIR")
    os.environ["CFD_TORCH_CACHE_DIR"] = str(work / "setup_cache")
    try:
        phase_cli_cavity(args, work, cavity_deck, cuda_lib, ExplicitBCHSolver, SolverConfig,
                         DTypePolicy)
        torch.cuda.empty_cache()
        phase_cli_bend(args, work, bending_duct_deck, cuda_lib, ExplicitBCHSolver,
                       ImplicitGQSolver)
        torch.cuda.empty_cache()
    finally:
        if old is None:
            os.environ.pop("CFD_TORCH_CACHE_DIR", None)
        else:
            os.environ["CFD_TORCH_CACHE_DIR"] = old
        shutil.rmtree(work, ignore_errors=True)
    emit(dict(phase="cli_total", seconds=time.time() - t0))


# ---------------------------------------------------------------- phase 11

# The legacy solvers (float64, host assembly, the solves on the card through
# ops/linsolve.py: torch ops and cuSOLVER's dense LU, no hand-written kernel).
# (a) Poisson MMS on the unit cube with zero Dirichlet walls
# (tests/test_poisson.py::_cube_poisson_deck): n = 64, 262,144 hexes and
# 274,625 nodes, 262x the reference's poissonNE1000.inp; n = 32 against the
# port's CPU path and every Krylov backend.  (b) Stokes on
# cavity_legacy_deck(16, viscosity=1.0), 19,652 unknowns, just under
# DENSE_DIRECT_LIMIT: dense_lu on the card and GMRES against host splu.  (c)
# GLS and segregated on cavity_legacy_deck(20, viscosity=1.0), 37,044
# monolithic unknowns (drivenCavityNE8000_hexa_RE1.inp's class), card
# against the port's CPU path.  (d) python -m cfd_with_cuda_tpu_torch on the
# n = 32 Poisson deck and cavity_legacy_deck(10) written to disk.
LEGACY_POISSON_N, LEGACY_STOKES_N, LEGACY_NS_N, LEGACY_CLI_N = 64, 16, 20, 10
# depths cut to keep the phase near 120 s (H100 80GB HBM3, 700 W: 153.7 s at 3
# Picard, 10 outer and 50 CLI iterations, then 126.8 and 139.6 s at 2, 10 and 20,
# the CPU reference runs 52-53 s of it): GLS 2 Picard iterations and segregated
# 6 outer, not 3 and 10, and the CLI deck's iterMax 10, not the generator's 50
# (the segregated run contracts slowly at nu = 1 and runs them all, twice with
# the library run); segregated 4 outer since phase 12 was added
LEGACY_PICARD, LEGACY_OUTER, LEGACY_CLI_ITERMAX = 2, 4, 10
# card against CPU: two f64 runs of one algorithm whose reductions sum in other
# orders, of max|u| (Poisson, a CG to 1e-12) and of max|u|, max|p| (GLS and
# segregated, their Krylov solves to 1e-10 through the Picard / outer iterations)
POISSON_CARD_CPU_TOL, NS_CARD_CPU_TOL = 1e-10, 1e-8
# tests/test_poisson.py: every backend within 1e-6 of cg; the MMS error falls
# 2.5-6x from n/2 to n there (second order: 4x), 3-5x asked of the card
POISSON_BACKEND_TOL, POISSON_MMS_RATIO = 1e-6, (3.0, 5.0)
# dense_lu against splu (two direct f64 solves) of max|u| and max|p|, in at most
# 13 refinement rounds (tests/test_monolithic.py); GMRES to the deck's tolerance
# is held by its f64 true residual within 2 tol ||F|| and, against splu, to what
# tol 1e-10 leaves of the saddle-point system's x (the CPU read 1.1e-7 of
# max|u| and 9.2e-6 of max|p|)
STOKES_LU_TOL, STOKES_LU_ROUNDS, STOKES_GMRES_U_TOL, STOKES_GMRES_P_TOL = 1e-9, 13, 1e-6, 5e-5
# the segregated solver's pressure CG (SCPE, tol 1e-10) stops where ||r|| touches
# its bound after running along it: two summation orders of one system moved the
# stop by up to 3 on the CPU (tests/test_torch_legacy_solvers.py)
SCPE_ITERS_TOL = 3
# the CLI's .dat (12 significant digits) against the in-process solvers on the card
LEGACY_CLI_TOL = 1e-10
# the lid's u = 1 at NE8000: its Dirichlet rows are identity rows of the Krylov
# solves, so they come out to rounding (GLS read exactly 1, segregated within
# 7.8e-16, on an H100 80GB HBM3 at 700 W), not bit for bit the CPU's
LID_TOL = 1e-12


def _legacy_cube_poisson(n, fxy=0.0):
    """tests/test_poisson.py::_cube_poisson_deck (``fxy``: a constant source)."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.io.deck import Deck
    from cfd_with_cuda_tpu_torch.mesh.generators import cube_hex_mesh

    coords, conn = cube_hex_mesh(n + 1)
    ebc = np.flatnonzero((np.isclose(coords, 0.0) | np.isclose(coords, 1.0)).any(axis=1))
    deck = Deck(dialect="poisson", title=f"cube poisson {n}^3")
    deck.etype, deck.ne, deck.nn, deck.ncn = 3, n**3, (n + 1) ** 3, (n + 1) ** 3
    deck.nenv = deck.nenp = deck.ngp = 8
    deck.solver_iter_max, deck.solver_tol = 2000, 1e-12
    deck.axy, deck.fxy = 1.0, fxy
    deck.coords, deck.conn = coords, conn
    deck.bc_type, deck.bc_str = np.array([1.0]), np.array([[0.0, 0.0, 0.0]])
    deck.bc_vel_nodes = np.column_stack([ebc, np.zeros_like(ebc)])
    return deck


def _deck_mesh_lines(deck) -> list:
    lines = ["Node#  x  y  z"]
    lines += [f"{i} {x!r} {y!r} {z!r}" for i, (x, y, z) in enumerate(deck.coords.tolist())]
    lines += ["=" * 20, "Elem#  nodes"]
    lines += [f"{e} " + " ".join(map(str, row)) for e, row in enumerate(deck.conn.tolist())]
    return lines + ["=" * 20]


def _write_legacy_deck(path, deck) -> None:
    """The legacy dialect io/deck.py reads (node BCs, 0-based nodes, 1-based BCs)."""
    f = lambda v: repr(float(v))  # noqa: E731
    lines = [deck.title, "=" * 20, f"eType : {deck.etype}", f"NE : {deck.ne}",
             f"NCN : {deck.ncn}", f"NN : {deck.nn}", f"NENv : {deck.nenv}",
             f"NENp : {deck.nenp}", f"NGP : {deck.ngp}", f"iterMax : {deck.max_iter}",
             f"tolerance : {f(deck.tolerance)}", f"solverIterMax : {deck.solver_iter_max}",
             f"solverTol : {f(deck.solver_tol)}", f"density : {f(deck.density)}",
             f"viscosity : {f(deck.viscosity)}", "=" * 20] + _deck_mesh_lines(deck)
    lines.append(f"nBC : {len(deck.bc_type)}")
    lines += [f"BC {b + 1} : {f(t)} " + " ".join(f(v) for v in deck.bc_str[b])
              for b, t in enumerate(deck.bc_type)]
    lines += [f"nVelNodes : {len(deck.bc_vel_nodes)}",
              f"nPressureNodes : {len(deck.bc_pres_nodes)}", "Velocity BC"]
    lines += [f"{n} {b + 1}" for n, b in deck.bc_vel_nodes.tolist()]
    lines.append("Pressure BC")
    lines += [f"{n} {b + 1}" for n, b in deck.bc_pres_nodes.tolist()]
    lines += ["nMonitorPoints : 1", "Monitor#  x  y  z",
              "0 " + " ".join(f(v) for v in deck.monitor_xyz)]
    path.write_text("\n".join(lines) + "\n")


def _write_poisson_deck(path, deck) -> None:
    """The Poisson dialect io/deck.py reads."""
    f = lambda v: repr(float(v))  # noqa: E731
    lines = [deck.title, "=" * 20, f"eType : {deck.etype}", f"NE : {deck.ne}",
             f"NN : {deck.nn}", f"NEN : {deck.nenv}", f"NGP : {deck.ngp}",
             f"solverIterMax : {deck.solver_iter_max}", f"solverTol : {f(deck.solver_tol)}",
             f"axyFunc : {f(deck.axy)}", f"fxyFunc : {f(deck.fxy)}", "=" * 20]
    lines += _deck_mesh_lines(deck) + [f"nBC : {len(deck.bc_type)}"]
    lines += [f"BC {b + 1} : {f(t)} {f(deck.bc_str[b, 0])}" for b, t in enumerate(deck.bc_type)]
    lines += [f"nEBCnodes : {len(deck.bc_vel_nodes)}", "EBC node  BC#"]
    lines += [f"{n} {b + 1}" for n, b in deck.bc_vel_nodes.tolist()]
    path.write_text("\n".join(lines) + "\n")


def _synced(fn):
    """(result, seconds) of ``fn()`` ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _rel(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_legacy_poisson(args) -> dict:
    """(a) Poisson on the cube: the MMS source (an eigenvector of the uniform
    grid's operator, so CG takes one iteration) and a constant source (the
    deck's ``fxyFunc`` 1: a CG of some hundred iterations).  n on the card;
    n/2 against the port's CPU path, and every backend against cg."""
    from cfd_with_cuda_tpu_torch.solvers.poisson import PoissonSolver, mms_solution

    n = args.legacy_poisson_n
    half = n // 2
    out = dict(phase="legacy_poisson", n=n, hexes=n**3, nodes=(n + 1) ** 3)
    t0 = time.time()
    big = PoissonSolver(_legacy_cube_poisson(n, fxy=1.0))
    out["setup_s"] = time.time() - t0
    (u, k, res), out["mms_solve_s"] = _synced(lambda: big.solve(source="mms"))
    err = float(abs(u - mms_solution(big.deck.coords)).max())
    (_, k_c, res_c), out["const_solve_s"] = _synced(big.solve)
    out.update(mms_iters=k, mms_residual=res, mms_err=err, const_iters=k_c,
               const_residual=res_c, const_ms_per_iter=out["const_solve_s"] / k_c * 1e3,
               ell_slots=int(big._cols.shape[0]))
    del big

    deck = _legacy_cube_poisson(half, fxy=1.0)
    card = {}
    for backend in ("cg", "cr", "bicgstab", "gmres"):
        s = PoissonSolver(deck, solver=backend)
        (u_b, k_b, _), sec = _synced(s.solve)
        card[backend] = (u_b, k_b, sec)
    s = PoissonSolver(deck)
    u_mms, k_mms, _ = s.solve(source="mms")
    t0 = time.time()
    cpu = PoissonSolver(deck, device="cpu")
    u_mms_c, k_mms_c, _ = cpu.solve(source="mms")
    u_c, k_c, _ = cpu.solve()
    cpu_s = time.time() - t0
    u_h, k_h, _ = card["cg"]
    err_h = float(abs(u_mms - mms_solution(deck.coords)).max())
    out["half"] = dict(
        n=half, mms_err=err_h, mms_ratio=err_h / err, cpu_s=cpu_s,
        iters_card_cpu=dict(mms=[k_mms, k_mms_c], const=[k_h, k_c]),
        card_vs_cpu=dict(mms=_rel(u_mms, u_mms_c), const=_rel(u_h, u_c)),
        tol=POISSON_CARD_CPU_TOL,
        backends={b: dict(iters=v[1], solve_s=v[2], vs_cg=float(abs(v[0] - u_h).max()))
                  for b, v in card.items()})
    emit(out)
    lo, hi = POISSON_MMS_RATIO
    h = out["half"]
    bad = [b for b, v in h["backends"].items() if v["vs_cg"] > POISSON_BACKEND_TOL]
    if (max(h["card_vs_cpu"].values()) > POISSON_CARD_CPU_TOL or k_mms != k_mms_c
            or k_h != k_c or bad or not err < 1.0
            or (n == LEGACY_POISSON_N and not lo <= h["mms_ratio"] <= hi)):
        raise AssertionError(f"legacy_poisson: {out}")
    return out


def _count_host_reads(fn):
    """(result, host reads) of ``fn()``: calls of ``Tensor.cpu`` and ``Tensor.item``."""
    import torch

    calls = [0]
    cpu, item = torch.Tensor.cpu, torch.Tensor.item

    def counted(orig):
        def wrapper(self, *a, **kw):
            calls[0] += 1
            return orig(self, *a, **kw)
        return wrapper

    torch.Tensor.cpu, torch.Tensor.item = counted(cpu), counted(item)
    try:
        out = fn()
    finally:
        torch.Tensor.cpu, torch.Tensor.item = cpu, item
    return out, calls[0]


def phase_legacy_stokes(args) -> dict:
    """(b) Stokes at 19,652 unknowns: dense_lu on the card and GMRES against
    host splu; the dense factor's time alone."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_legacy_deck
    from cfd_with_cuda_tpu_torch.solvers.monolithic import StokesSolver

    deck = cavity_legacy_deck(args.legacy_stokes_n, viscosity=1.0)
    out = dict(phase="legacy_stokes", deck=f"cavity_legacy_deck({args.legacy_stokes_n}, "
               "viscosity=1.0)", unknowns=4 * deck.nn)
    t0 = time.time()
    s_lu = StokesSolver(deck, solver="splu")
    (u_s, p_s, _), out["splu_s"] = _synced(s_lu.solve)
    out["setup_s"] = time.time() - t0 - out["splu_s"]
    s_d = StokesSolver(deck, solver="dense_lu")
    (u_d, p_d, rounds), out["dense_lu_s"] = _synced(s_d.solve)
    # the factor alone, on the same matrix (CUDA events)
    K, _ = s_d.assemble(np.zeros((s_d.nn, 3)))
    dense = torch.from_numpy(K.toarray()).cuda()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lu, piv, info = torch.linalg.lu_factor_ex(dense)
    end.record()
    torch.cuda.synchronize()
    out["factor_ms"], out["factor_gb"] = start.elapsed_time(end), dense.numel() * 8 / 1e9
    del dense, lu, piv, info
    torch.cuda.empty_cache()
    s_g = StokesSolver(deck, solver="gmres")
    ((u_g, p_g, its), reads), out["gmres_s"] = _synced(lambda: _count_host_reads(s_g.solve))
    x_g = np.concatenate([u_g.T.ravel(), p_g])
    K, F = s_g.assemble(np.zeros((s_g.nn, 3)))
    cycles = its // s_g.gmres_restart
    out.update(
        dense_lu_rounds=rounds, dense_lu_vs_splu=[_rel(u_d, u_s), _rel(p_d, p_s)],
        dense_lu_tol=STOKES_LU_TOL, gmres_iters=its, gmres_maxiter=s_g.solver_maxiter,
        gmres_true_res=float(np.linalg.norm(F - K @ x_g) / np.linalg.norm(F)),
        gmres_tol=s_g.solver_tol, gmres_vs_splu=[_rel(u_g, u_s), _rel(p_g, p_s)],
        gmres_host_reads=reads, gmres_reads_per_cycle=reads / max(cycles, 1),
        gmres_ms_per_iter=out["gmres_s"] / max(its, 1) * 1e3)
    emit(out)
    if (rounds > STOKES_LU_ROUNDS or max(out["dense_lu_vs_splu"]) > STOKES_LU_TOL
            or out["gmres_true_res"] > 2 * s_g.solver_tol
            or out["gmres_vs_splu"][0] > STOKES_GMRES_U_TOL
            or out["gmres_vs_splu"][1] > STOKES_GMRES_P_TOL):
        raise AssertionError(f"legacy_stokes: {out}")
    return out


def phase_legacy_ns(args) -> dict:
    """(c) GLS (LEGACY_PICARD iterations) and segregated (LEGACY_OUTER) at
    NE8000, the card against the port's CPU path over the same iterations."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_legacy_deck
    from cfd_with_cuda_tpu_torch.solvers.monolithic import GLSNavierStokesSolver
    from cfd_with_cuda_tpu_torch.solvers.segregated import SegregatedSolver

    n = args.legacy_ns_n
    deck = cavity_legacy_deck(n, viscosity=1.0)
    lid = np.isclose(deck.coords[:, 2], 1.0)
    out = dict(phase="legacy_ns", deck=f"cavity_legacy_deck({n}, viscosity=1.0)", nodes=deck.nn,
               unknowns=4 * deck.nn)
    def recorded(solver, name):
        """Each solve's count and f64 true residual ||b - A x|| / ||b||."""
        solves, inner = [], getattr(solver, name)

        def wrapper(A, b, *rest):
            x, k = inner(A, b, *rest)
            bn = float(np.linalg.norm(b))
            solves.append((k, float(np.linalg.norm(b - A @ x)) / bn if bn else 0.0))
            return x, k
        setattr(solver, name, wrapper)
        return solves

    runs = {}
    for dev in ("cuda", "cpu"):
        for kind, cls, method, kw in (
                ("gls", GLSNavierStokesSolver, "_solve_linear", dict(max_picard=args.legacy_picard)),
                ("seg", SegregatedSolver, "_krylov", dict(max_outer=args.legacy_outer))):
            t0 = time.time()
            solver = cls(deck, device=dev)
            setup = time.time() - t0
            solves = recorded(solver, method)
            (u, p, h), sec = _synced(lambda: solver.solve(**kw))
            counts = ([r["lin_iters"] for r in h] if kind == "gls"
                      else [(r["p_iters"], r["mom_iters"]) for r in h])
            runs[(kind, dev)] = (u, p, counts, sec, setup, solves, solver.solver_maxiter)
    bad = []
    for kind in ("gls", "seg"):
        u, p, c, sec, setup, solves, maxiter = runs[(kind, "cuda")]
        u_c, p_c, c_c, sec_c = runs[(kind, "cpu")][:4]
        d = dict(counts=c, cpu_counts=c_c, card_s=sec, cpu_s=sec_c, setup_s=setup,
                 du=_rel(u, u_c), dp=_rel(p, p_c), tol=NS_CARD_CPU_TOL,
                 lid_max_dev=float(abs(u[lid, 0] - 1.0).max()),
                 lid_equal_cpu=bool(np.array_equal(u[lid], u_c[lid])),
                 solves=len(solves), max_true_res=max(r for _, r in solves),
                 # solves that stopped at solver_iter_max, with their true residual
                 at_maxiter=[(k, r) for k, r in solves if k >= maxiter])
        if kind == "gls":
            same = c == c_c
        else:
            same = (len(c) == len(c_c) and [m for _, m in c] == [m for _, m in c_c]
                    and all(abs(a - b) <= SCPE_ITERS_TOL for (a, _), (b, _) in zip(c, c_c)))
        out[kind] = d
        if (not same or d["du"] > NS_CARD_CPU_TOL or d["dp"] > NS_CARD_CPU_TOL
                or d["lid_max_dev"] > LID_TOL):
            bad.append(kind)
    emit(out)
    if bad:
        raise AssertionError(f"legacy_ns {bad}: {out}")
    return out


def phase_legacy_cli(args, work) -> dict:
    """(d) python -m cfd_with_cuda_tpu_torch on deck files: --solver poisson,
    auto (segregated), gls and stokes; each .dat against the in-process
    solver on the card."""
    import numpy as np

    from cfd_with_cuda_tpu_torch import __main__ as cli
    from cfd_with_cuda_tpu_torch.io.deck import read_deck
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_legacy_deck
    from cfd_with_cuda_tpu_torch.solvers.monolithic import GLSNavierStokesSolver, StokesSolver
    from cfd_with_cuda_tpu_torch.solvers.poisson import PoissonSolver
    from cfd_with_cuda_tpu_torch.solvers.segregated import SegregatedSolver

    d = work / "legacy"
    d.mkdir()
    _write_poisson_deck(d / "poisson.inp", _legacy_cube_poisson(args.legacy_poisson_n // 2,
                                                                fxy=1.0))
    _write_legacy_deck(d / "cavity.inp", cavity_legacy_deck(args.legacy_cli_n,
                                                            max_iter=LEGACY_CLI_ITERMAX))
    library = {
        "poisson": lambda deck: PoissonSolver(deck).solve(),
        "segregated": lambda deck: SegregatedSolver(deck).solve(),
        "gls": lambda deck: GLSNavierStokesSolver(deck).solve(),
        "stokes": lambda deck: StokesSolver(deck).solve(),
    }
    out = dict(phase="legacy_cli")
    for kind, inp, argv in (("poisson", "poisson.inp", ["--solver", "poisson"]),
                            ("segregated", "cavity.inp", []),
                            ("gls", "cavity.inp", ["--solver", "gls"]),
                            ("stokes", "cavity.inp", ["--solver", "stokes"])):
        rep = _cli(cli, [d / inp, "--quiet", *argv])
        s = rep["solver"]
        dat = np.loadtxt(d / inp.replace(".inp", ".dat"), skiprows=3, max_rows=s.deck.nn)
        deck = read_deck(d / inp)
        (u, *rest), lib_s = _synced(lambda: library[kind](deck))
        if kind == "poisson":
            u, p = np.column_stack([u, np.zeros((u.shape[0], 2))]), np.zeros(u.shape[0])
        else:
            p = rest[0]
        hist = rep["history"]
        out[kind] = dict(solver=type(s).__name__, dialect=s.deck.dialect, cli_s=rep["cli_s"],
                         run_s=rep["run_s"], library_s=lib_s,
                         count=hist if isinstance(hist, int) else len(hist),
                         du=_rel(dat[:, 3:6], u), dp=_rel(dat[:, 6], p) if kind != "poisson"
                         else float(abs(dat[:, 6]).max()))
    emit(out)
    if (out["segregated"]["solver"] != "SegregatedSolver"
            or any(v["du"] > LEGACY_CLI_TOL or v["dp"] > LEGACY_CLI_TOL
                   for k, v in out.items() if k != "phase")):
        raise AssertionError(f"legacy_cli: {out}")
    return out


def legacy_phases(args, cuda_lib) -> None:
    """Phase 11: the legacy solvers; no hand-written kernel launches."""
    import shutil
    import tempfile

    import torch

    t0 = time.time()
    cuda_lib.reset_launch_counts()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_legacy_"))
    try:
        phase_legacy_poisson(args)
        torch.cuda.empty_cache()
        phase_legacy_stokes(args)
        torch.cuda.empty_cache()
        phase_legacy_ns(args)
        torch.cuda.empty_cache()
        phase_legacy_cli(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launched = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    emit(dict(phase="legacy_total", seconds=time.time() - t0, kernel_launches=launched))
    if launched:
        raise AssertionError(f"legacy phases launched hand-written kernels: {launched}")


# ---------------------------------------------------------------- phase 12
# (a) the NE27000 cavity's corner mesh written as a Gambit .neu and read back
IMPORT_N = 30
# (b) the unit cube split into six tets a hex, n elements an edge: card against
# the port's CPU path (float64, the same summation of one CG), and the P1 MMS
# error's fall from the coarser to the finer mesh (second order: ~4x)
TET_NS = (16, 32)
TET_CARD_CPU_TOL = 1e-10
TET_MMS_RATIO = 3.0
# (c) the "ne125" row of the JAX package's bench matrix (scripts/bench_matrix.py:136-150):
# cavity_deck(50, cluster=2.0, viscosity=0.01, dt=4e-4), 125,000 hexes, 1,030,301 /
# 132,651 nodes, Sp 133,120: over the 100,000 at which the explicit parity step leaves
# the convection planes for the flat gather / einsum / scatter route, and its 12.8 MB
# velocity field over the 6 MiB rule, so every K apply streams
NE125_N = 50
NE125_DT = 4e-4
NE125_SP = 133_120
# Gambit's brick node order from the deck's (converters.GAMBIT_HEX_TO_DECK's inverse)
DECK_HEX_TO_GAMBIT = (0, 1, 4, 5, 3, 2, 7, 6)
# six tets a hex around the diagonal 0-6 (every path 0 -> 6 along the three axes):
# translated copies of one hex split alike, so the faces meet conformingly
HEX_TO_TETS = ((0, 1, 2, 6), (0, 1, 5, 6), (0, 3, 2, 6), (0, 3, 7, 6), (0, 4, 5, 6),
               (0, 4, 7, 6))


def _write_neu(path, coords, conn, groups) -> None:
    """A Gambit neutral file of a hex mesh with node-typed BC groups
    (``groups``: name -> node ids, in this order)."""
    out = ["        CONTROL INFO 2.4.6", "** GAMBIT NEUTRAL FILE", "chip_smoke mesh",
           "PROGRAM:                Gambit     VERSION:  2.4.6", " today",
           "     NUMNP     NELEM     NGRPS    NBSETS     NDFCD     NDFVL",
           f"{len(coords):10d}{len(conn):10d}{1:10d}{len(groups):10d}{3:10d}{3:10d}",
           "ENDOFSECTION", "   NODAL COORDINATES 2.4.6"]
    out += [f"{i + 1:10d}{x:20.11e}{y:20.11e}{z:20.11e}"
            for i, (x, y, z) in enumerate(coords.tolist())]
    out += ["ENDOFSECTION", "      ELEMENTS/CELLS 2.4.6"]
    gambit = conn[:, list(DECK_HEX_TO_GAMBIT)] + 1
    out += [f"{e + 1:8d} {4:2d} {8:2d} " + "".join(f"{v:8d}" for v in row)
            for e, row in enumerate(gambit.tolist())]
    out.append("ENDOFSECTION")
    for name, nodes in groups.items():
        out += ["       BOUNDARY CONDITIONS 2.4.6",
                f"{name:>32s}{0:8d}{len(nodes):8d}{0:8d}{6:8d}"]
        out += [f"{v + 1:10d}" for v in nodes.tolist()]
        out.append("ENDOFSECTION")
    path.write_text("\n".join(out) + "\n")


def _write_unv(path, coords, conn, groups) -> None:
    """An IDEAS universal file: nodes (2411), tets (2412, type 111) and
    node groups (2467)."""
    out = ["    -1", "  2411"]
    for i, (x, y, z) in enumerate(coords.tolist()):
        out.append(f"{i + 1:10d}{1:10d}{1:10d}{11:10d}")
        out.append(f"  {x:.16e}  {y:.16e}  {z:.16e}")
    out += ["    -1", "    -1", "  2412"]
    for e, row in enumerate((conn + 1).tolist()):
        out.append(f"{e + 1:10d}{111:10d}{2:10d}{1:10d}{7:10d}{len(row):10d}")
        out.append("".join(f"{v:10d}" for v in row))
    out += ["    -1", "    -1", "  2467"]
    for g, (name, nodes) in enumerate(groups.items()):
        out.append(f"{g + 1:10d}" + f"{0:10d}" * 6 + f"{len(nodes):10d}")
        out.append(name)
        ids = (nodes + 1).tolist()
        out += ["".join(f"{7:10d}{v:10d}{0:10d}{0:10d}" for v in ids[k:k + 2])
                for k in range(0, len(ids), 2)]
    out.append("    -1")
    path.write_text("\n".join(out) + "\n")


def _tet_cube(n):
    """(coords, conn (6 n^3, 4) positively oriented) of the unit cube."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.mesh.generators import cube_hex_mesh

    coords, hexes = cube_hex_mesh(n + 1)
    conn = hexes[:, np.array(HEX_TO_TETS)].reshape(-1, 4)
    x = coords[conn]
    det = np.linalg.det(x[:, 1:] - x[:, :1])
    conn[det < 0] = conn[det < 0][:, [0, 2, 1, 3]]
    return coords, conn


def _cavity_groups(coords):
    """The lid (z = 1) and the walls without the lid's nodes, walls first so the
    lid wins the edges (tests/test_converters.py:110-140)."""
    import numpy as np

    lid = np.flatnonzero(np.isclose(coords[:, 2], 1.0))
    side = (np.isclose(coords[:, :2], 0.0) | np.isclose(coords[:, :2], 1.0)).any(axis=1)
    walls = np.flatnonzero((side | np.isclose(coords[:, 2], 0.0)) & ~np.isclose(coords[:, 2], 1.0))
    return {"walls": walls, "lid": lid}


def phase_import_neu(args, work, cuda_lib, ExplicitBCHSolver, DTypePolicy, SolverConfig) -> dict:
    """(a) The NE27000 cavity's corner mesh (``cube_hex_mesh(31, cluster=2.0)``)
    written as a Gambit .neu, read back by ``read_neu`` and made a Q2/Q1 deck by
    ``deck_from_mesh(..., quadratic=True)`` at the NE27000 deck's nu 0.01 and
    dt 0.001; rung 1's config (F32, CG tol 1e-6, warm start, fused CG loop) must
    take the parity layout.  The BC tables on the card against the import's host
    tables, and against the generator's ``cavity_deck(30, cluster=2.0)``: equal
    but at the seam of the two node groups, whose side-wall faces in the lid's
    element layer no group claims (the face-claiming defect of ``ADVICE.md``,
    kept as the JAX package has it); 5 + 20 steps with launch counts, then 3
    steps against the plain path at the explicit bounds."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.mesh.converters import deck_from_mesh, read_neu
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck, cube_hex_mesh
    from cfd_with_cuda_tpu_torch.mesh.topology import face_bc_to_node_bc, promote_hex_mesh

    n = args.import_n
    strict = n == IMPORT_N
    t0 = time.time()
    coords, conn = cube_hex_mesh(n + 1, cluster=2.0)
    path = work / f"cavity_{n}.neu"
    _write_neu(path, coords, conn, _cavity_groups(coords))
    t1 = time.time()
    c2, k2, groups = read_neu(path)
    t2 = time.time()
    if not (np.array_equal(k2, conn) and np.abs(c2 - coords).max() < 1e-10
            and list(groups) == ["walls", "lid"]):
        raise AssertionError("import_neu: the mesh read back differs from the one written")
    gen = cavity_deck(n, cluster=2.0, viscosity=0.01, dt=0.001)
    deck = deck_from_mesh(c2, k2, groups, bc_table=[(1.0, (0.0, 0.0, 0.0)),
                                                    (1.0, (1.0, 0.0, 0.0))],
                          group_bc={"walls": 0, "lid": 1}, viscosity=0.01, quadratic=True)
    deck.dt, deck.t_final = gen.dt, gen.t_final
    deck.max_iter, deck.tolerance = gen.max_iter, gen.tolerance
    deck.convergence_criteria = gen.convergence_criteria
    deck.zero_pressure_node, deck.monitor_xyz = gen.zero_pressure_node, gen.monitor_xyz
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                       pressure_warm_start=True, pressure_cg_fuse_loop=True, steps_per_chunk=25)
    t3 = time.time()
    solver = ExplicitBCHSolver(deck, cfg)
    setup_s = time.time() - t3
    if solver.layout != "parity":
        raise AssertionError(f"import_neu: the imported box took the {solver.layout} layout")

    # ---- the BC tables: the card's against the import's host tables ...
    bc_node = solver.bc_of_node
    is_bc = bc_node >= 0
    host_vel = np.where(is_bc[:, None], deck.bc_str[np.maximum(bc_node, 0)], 0.0)
    card_vel, _ = solver.fields(solver.initial_state())
    # ... and the import's against the generator's: the seam nodes lack a BC
    mesh = promote_hex_mesh(gen.conn, gen.coords)
    gen_node = face_bc_to_node_bc(mesh.ltog_node, gen.bc_vel_faces, mesh.nn)
    x = solver.mesh.coords
    z_below = np.unique(coords[:, 2])[-2]
    seam = ((np.isclose(x[:, :2], 0.0) | np.isclose(x[:, :2], 1.0)).any(axis=1)
            & (x[:, 2] > z_below + 1e-12) & (x[:, 2] < 1.0 - 1e-12))
    missing = (gen_node >= 0) & ~is_bc
    bc = dict(bc_nodes=int(is_bc.sum()), generator_bc_nodes=int((gen_node >= 0).sum()),
              seam_nodes=int(seam.sum()), missing_nodes=int(missing.sum()),
              card_vs_host_max_abs=float(np.abs(card_vel - host_vel).max()),
              faces=int(len(deck.bc_vel_faces)), generator_faces=int(len(gen.bc_vel_faces)))
    if not (np.array_equal(card_vel, host_vel) and np.array_equal(missing, seam)
            and seam.sum() > 0 and not (is_bc & (gen_node < 0)).any()
            and np.array_equal(deck.bc_str[bc_node[is_bc]], gen.bc_str[gen_node[is_bc]])):
        raise AssertionError(f"import_neu: BC tables {bc}")

    # ---- 5 + 20 steps with launch counts (rows 1, 2, 4, 5)
    state = solver.initial_state()
    cuda_lib.reset_launch_counts()
    state, hist_w = solver.run(state, n_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    t4 = time.time()
    state, hist_t = solver.run(state, n_steps=args.import_steps)
    torch.cuda.synchronize()
    ms = (time.time() - t4) / args.import_steps * 1e3
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    on_path, want = _explicit_parity_expect(hist, counts)
    if len(hist) != WARMUP_STEPS + args.import_steps or min(on_path.values()) <= 0 \
            or counts != want:
        raise AssertionError(f"import_neu: launch counts {counts}, expected {want}")
    subs = [int(h["iters"]) for h in hist]
    out = dict(phase="import_neu", mesh=f"cube_hex_mesh({n + 1}, cluster=2.0)", ne=len(conn),
               nn=solver.nn, nnp=solver.nnp, layout=solver.layout, neu_bytes=path.stat().st_size,
               write_s=t1 - t0, read_s=t2 - t1, setup_s=setup_s, bc=bc,
               steps=len(hist), ms_per_step=ms, u_mon=hist[-1]["u_mon"],
               sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
               launches={k: v for k, v in counts.items() if v})
    emit(out)

    # ---- 3 steps against the plain path
    tols = STEP_TOLS if strict else dict(u=float("inf"), p=float("inf"), mon=float("inf"))
    plain = ExplicitBCHSolver.from_tables(solver.deck, solver.config, solver.d,
                                          solver.static_attrs(), device=solver.device, plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=3)
    counts_k = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=3)
    if dict(cuda_lib.launch_counts) != counts_k or counts_k != _explicit_parity_expect(
            h_k, counts_k)[1]:
        raise AssertionError(f"import_neu 3 steps: launch counts {counts_k}")
    _compare_runs("import_neu_kernel_vs_plain_3_steps", h_k, h_p, solver.fields(st_k),
                  plain.fields(st_p), tols, UNROLL)
    return out


def phase_import_unv_tet(args, work, cuda_lib) -> dict:
    """(b) The unit cube split into six tets a hex, written as an IDEAS .unv
    (tet 111, one node group of the boundary), read by ``read_unv``, made a
    legacy deck by ``deck_from_mesh`` (etype 4, 4 Gauss points) and solved by
    ``PoissonSolver`` with the MMS source: the card against the port's CPU path
    on the same deck, counts equal; the MMS error at n and 2n.  No hand-written
    kernel launches (float64 torch ops and the torch CG)."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.mesh.converters import deck_from_mesh, read_unv
    from cfd_with_cuda_tpu_torch.solvers.poisson import PoissonSolver, mms_solution

    ns = tuple(int(v) for v in args.tet_ns.split(","))
    strict = ns == TET_NS
    cuda_lib.reset_launch_counts()
    runs = []
    for n in ns:
        t0 = time.time()
        coords, conn = _tet_cube(n)
        boundary = np.flatnonzero((np.isclose(coords, 0.0) | np.isclose(coords, 1.0)).any(axis=1))
        path = work / f"cube_tets_{n}.unv"
        _write_unv(path, coords, conn, {"wall": boundary})
        t1 = time.time()
        c2, k2, groups = read_unv(path)
        t2 = time.time()
        if not (np.array_equal(k2, conn) and np.array_equal(c2, coords)
                and np.array_equal(groups["wall"], boundary)):
            raise AssertionError(f"import_unv_tet n={n}: the mesh read back differs")
        deck = deck_from_mesh(c2, k2, groups, bc_table=[(1.0, (0.0, 0.0, 0.0))],
                              group_bc={"wall": 0})
        if (deck.etype, deck.nenv, deck.ngp) != (4, 4, 4):
            raise AssertionError(f"import_unv_tet: deck etype {deck.etype}, nen {deck.nenv}")
        card, setup_s = _synced(lambda: PoissonSolver(deck))
        (u, it, res), solve_s = _synced(lambda: card.solve("mms"))
        t3 = time.time()
        u_c, it_c, res_c = PoissonSolver(deck, device="cpu").solve("mms")
        cpu_s = time.time() - t3
        rel = _rel(u, u_c)
        err = float(np.abs(u - mms_solution(c2)).max())
        runs.append(dict(n=n, nodes=len(c2), tets=len(k2), unv_bytes=path.stat().st_size,
                         write_s=t1 - t0, read_s=t2 - t1, setup_s=setup_s, solve_s=solve_s,
                         cpu_s=cpu_s, cg_iters=[it, it_c], residual=[res, res_c],
                         card_vs_cpu=rel, mms_err=err))
        if not (np.isfinite(u).all() and it == it_c and rel <= TET_CARD_CPU_TOL):
            raise AssertionError(f"import_unv_tet n={n}: card against CPU {runs[-1]}")
    ratio = runs[0]["mms_err"] / runs[-1]["mms_err"]
    launched = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    out = dict(phase="import_unv_tet", runs=runs, mms_err_ratio=ratio,
               mms_ratio_bound=TET_MMS_RATIO, tol=TET_CARD_CPU_TOL, kernel_launches=launched)
    emit(out)
    if launched or (strict and not ratio > TET_MMS_RATIO):
        raise AssertionError(f"import_unv_tet: {out}")
    return out


def _ne125_solver_args(n, setup_cache):
    """(deck, config) of the "ne125" row: F32, CG tol 1e-6, warm start, chunks
    of 50, the default CG loop."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                       pressure_warm_start=True, steps_per_chunk=50, setup_cache=setup_cache)
    return cavity_deck(n, cluster=2.0, viscosity=0.01, dt=NE125_DT), cfg


def _bfs_configs(cache_dir=None):
    """(explicit, implicit) configs of phase 8's BFS runs: F32, CG tol 1e-6,
    chunks of 25 (the implicit one warm-started); ``cache_dir`` their setup
    cache."""
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    base = dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=25,
                setup_cache=cache_dir)
    return SolverConfig(**base), SolverConfig(pressure_warm_start=True, **base)


def setup_worker(deck_n, ne85_n, ne125_n, bfs_dims, cache_dir) -> None:
    """The host setups of the NE85184 cavity's two solvers (phase 7), the BFS's
    two (phase 8), the XLA path's three on the cavity (phase 9) and the
    NE125000 solver (phase 12) on the CPU, in the order the phases need them,
    into the setup cache ``cache_dir`` (run in a worker process while the
    earlier phases use the card); after each, one JSON line of its seconds and
    a ``<name>.done`` file in ``cache_dir``, the NE125000 line last."""
    from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver

    dims = tuple(int(v) for v in bfs_dims.split("x"))
    bcfg, icfg = _bfs_configs(cache_dir)
    ncfg, nicfg = _ne85_configs(cache_dir)
    xcfg, xicfg, xfcfg = _xla_configs(cache_dir)
    xdeck = lambda: _xla_deck(cavity_deck, deck_n)
    for name, make in (
            ("ne85_explicit", lambda: ExplicitBCHSolver(_ne85_deck(cavity_deck, ne85_n), ncfg,
                                                        device="cpu")),
            ("ne85_implicit", lambda: ImplicitGQSolver(_ne85_deck(cavity_deck, ne85_n), nicfg,
                                                       device="cpu")),
            ("bfs_explicit", lambda: ExplicitBCHSolver(_bfs_deck(bfs_deck, dims, 0.002), bcfg,
                                                       device="cpu")),
            ("bfs_implicit", lambda: ImplicitGQSolver(_bfs_deck(bfs_deck, dims, 0.01), icfg,
                                                      device="cpu")),
            ("xla_f64", lambda: ExplicitBCHSolver(xdeck(), xcfg, device="cpu")),
            ("xla_f64_implicit", lambda: ImplicitGQSolver(xdeck(), xicfg, device="cpu")),
            ("xla_f32", lambda: ExplicitBCHSolver(xdeck(), xfcfg, device="cpu")),
            ("ne125", lambda: ExplicitBCHSolver(*_ne125_solver_args(ne125_n, cache_dir),
                                                device="cpu"))):
        t0 = time.time()
        solver = make()
        emit(dict(worker=name, setup_s=time.time() - t0, store_s=solver.setup_cache_store_s,
                  snapshot_bytes=solver.setup_cache_bytes))
        del solver
        (Path(cache_dir) / f"{name}.done").touch()


def wait_for_setup(setup, name: str, timeout_s: float = 900.0) -> bool:
    """Wait until the setup worker has stored ``name``'s tables (True), or has
    ended without them (False: the phase then sets up itself)."""
    proc, cache = setup
    t0 = time.time()
    while not (Path(cache) / f"{name}.done").exists():
        if proc.poll() is not None or time.time() - t0 > timeout_s:
            return (Path(cache) / f"{name}.done").exists()
        time.sleep(0.5)
    return True


def start_setup_worker(args):
    """Start :func:`setup_worker` in a process of its own: (process, cache
    directory).  The NE85184, BFS, XLA-path and NE125000 setups (~20-90 s of
    host work each) then run beside the earlier phases on the card, and
    phases 7, 8, 9 and 12 (c) load their tables from the setup cache; where
    the worker did not store them, a phase sets up anew."""
    import os
    import tempfile

    cache = tempfile.mkdtemp(prefix="chip_smoke_setup_")
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
            f"chip_smoke.setup_worker({args.deck_n}, {args.ne85_n}, {args.ne125_n}, "
            f"{args.bfs_dims!r}, {cache!r})")
    # no eviction in this cache: its eight snapshots pass the default 8 GB cap
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="",
               CFD_TORCH_CACHE_MAX_GB="0")
    with open(Path(cache) / "worker.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                stderr=err, text=True, env=env)
    return proc, cache


def phase_e2e_ne125(args, ne125_setup, cuda_lib, pstl, ExplicitBCHSolver) -> dict:
    """(c) The "ne125" row's config (F32, CG tol 1e-6, warm start, chunks of 50,
    the default CG loop) from rest: 5 + 25 steps timed with launch counts, the
    convection on the flat route (no K + A launch: A(un) u* by gather, einsum and
    scatter), every K apply streamed (row 3), G resident (row 1), ``div_compact``
    (row 4), ``cg_init`` / ``cg_iter`` (row 6); then 3 steps against the plain
    path at the explicit bounds and finite fields.  The host setup ran in the
    worker process of :func:`start_setup_worker`; its seconds are printed beside
    the cache load's."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import _PLANES_MAX_SP

    n = args.ne125_n
    strict = n == NE125_N
    proc, cache = ne125_setup
    out_w, _ = proc.communicate(timeout=900)
    worker = ([json.loads(line) for line in out_w.strip().splitlines()] if proc.returncode == 0
              else dict(returncode=proc.returncode,
                        stderr=(Path(cache) / "worker.err").read_text()[-2000:]))
    t0 = time.time()
    solver = ExplicitBCHSolver(*_ne125_solver_args(n, cache))
    setup_s = time.time() - t0
    sp = solver.sp_c
    flat = sp > _PLANES_MAX_SP
    streamed = pstl.stream_field((3, 8, sp), 4, solver.k_pairs)
    emit(dict(phase="setup_ne125", layout=solver.layout, nn=solver.nn, nnp=solver.nnp, sp=sp,
              flat_route=flat, k_streamed=streamed, worker=worker,
              setup_cache_hit=solver.setup_cache_hit, setup_s=setup_s))
    if solver.layout != "parity" or (strict and not (sp == NE125_SP and flat and streamed)):
        raise AssertionError(f"ne125: layout {solver.layout}, Sp {sp}, flat {flat}, "
                             f"streamed {streamed}")
    sfx = "_streamed" if streamed else ""

    def expect(hist, counts):
        subs = [int(h["iters"]) for h in hist]
        on_path = {"parity_apply_g": sum(v + 1 for v in subs), "div_compact": sum(subs),
                   "cg_init": sum(subs), "cg_iter": counts.get("cg_iter", 0)}
        if flat:
            on_path[f"parity_apply_k{sfx}"] = sum(2 * v - 1 for v in subs)
        else:
            on_path[f"parity_apply_k_plus_a{sfx}"] = sum(subs)
            on_path[f"parity_apply_k{sfx}"] = sum(v - 1 for v in subs)
        want = {k: on_path.get(k, 0) for k in counts}
        last = sum(int(h["cg_iters"]) for h in hist)
        ok = (counts == want and min(on_path.values()) > 0
              and on_path["cg_iter"] * UNROLL >= last)
        return on_path, ok

    state = solver.initial_state()
    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, hist_w = solver.run(state, n_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=args.ne125_steps)
    torch.cuda.synchronize()
    ms = (time.time() - t1) / args.ne125_steps * 1e3
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    on_path, ok = expect(hist, counts)
    if not ok or len(hist) != WARMUP_STEPS + args.ne125_steps:
        raise AssertionError(f"ne125: launch counts {counts}, expected {on_path}")
    subs = [int(h["iters"]) for h in hist]
    out = dict(phase="e2e_ne125", deck=f"cavity_deck({n}, cluster=2.0, dt={NE125_DT})",
               setup_s=setup_s, flat_route=flat, k_streamed=streamed, steps=len(hist),
               ms_per_step=ms, sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
               cg_iters_first_last=[int(hist[0]["cg_iters"]), int(hist[-1]["cg_iters"])],
               u_mon=hist[-1]["u_mon"], launches={k: v for k, v in counts.items() if v},
               launches_per_step=(f"s sub-iterations: parity_apply_k{sfx} 2s - 1 (K u* inside "
                                  "(K + A) u*, K acc), parity_apply_g s + 1, div_compact s, "
                                  "cg_init s, cg_iter a group of 4 iterations"
                                  if flat else "the planes route"),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(out)

    # ---- 3 steps against the plain path, then finite fields
    tols = STEP_TOLS if strict else dict(u=float("inf"), p=float("inf"), mon=float("inf"))
    plain = ExplicitBCHSolver.from_tables(solver.deck, solver.config, solver.d,
                                          solver.static_attrs(), device=solver.device, plain=True)
    cuda_lib.reset_launch_counts()
    st_k, h_k = solver.run(state, n_steps=3)
    counts_k = dict(cuda_lib.launch_counts)
    st_p, h_p = plain.run(state, n_steps=3)
    if dict(cuda_lib.launch_counts) != counts_k or not expect(h_k, counts_k)[1]:
        raise AssertionError(f"ne125 3 steps: launch counts {counts_k}")
    u_k, p_k = solver.fields(st_k)
    _compare_runs("ne125_kernel_vs_plain_3_steps", h_k, h_p, (u_k, p_k), plain.fields(st_p),
                  tols, UNROLL)
    if not (np.isfinite(u_k).all() and np.isfinite(p_k).all()):
        raise AssertionError("ne125: non-finite fields")
    return out


def import_phases(args, ne125_setup, cuda_lib, parity_stencil, ExplicitBCHSolver, DTypePolicy,
                  SolverConfig) -> None:
    """Phase 12 (a)-(c): mesh import and the NE125000 cavity's flat route
    (``ne125_setup``: :func:`start_setup_worker`'s process and cache); (d), the
    Ghia check of the seeded implicit state, runs after phase 5's seeded
    steps (``phase_seeded``)."""
    import shutil
    import tempfile

    import torch

    t0 = time.time()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_import_"))
    try:
        phase_import_neu(args, work, cuda_lib, ExplicitBCHSolver, DTypePolicy, SolverConfig)
        torch.cuda.empty_cache()
        phase_import_unv_tet(args, work, cuda_lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_e2e_ne125(args, ne125_setup, cuda_lib, parity_stencil, ExplicitBCHSolver)
    torch.cuda.empty_cache()
    emit(dict(phase="import_total", seconds=time.time() - t0))


# ---------------------------------------------------------------- phase 13
# the sharded kernel path (parallel/): (a) one rank over NCCL at NE27000 and
# (c) the sharded K, G and G^T applies run inside phase 6 on its solvers'
# tables; (b) 2 and 4 ranks on the one card (gloo, CUDA tensors) at the end
SPMD_STEPS = (5, 20)                # (a) explicit: warm-up + timed (rung 3's config)
SPMD_IMPLICIT_STEPS = (5, 10)       # (a) implicit (cell 2's config)
SPMD_ASSEMBLE_STEPS = 5             # (a) explicit conv_mode="assemble": K + A on the ranks
# (b): cavity_deck(8): 17^3 fine rows over 2048-row blocks, so 3 of 4 ranks hold
# grid rows and every halo and element slab crosses a rank boundary; the JAX
# package's sharded-step deck parameters (tests/test_sharded_stencil.py:98-106)
SPMD_DECK_N = 8
SPMD_RANK_STEPS = 5
SPMD_RANKS = (2, 4)
# the JAX package's sharded tolerances (tests/test_sharded_stencil.py:124-136,
# 180-189): (rtol, atol) of u and p, abs of u_mon; explicit CG counts equal
SPMD_TOLS = dict(explicit=dict(u=(2e-5, 2e-6), p=(2e-5, 2e-5), mon=1e-6),
                 implicit=dict(u=(1e-4, 1e-5), p=(1e-4, 1e-4), mon=1e-5))
# (b)'s runs: (name, solver kind, config fields); "implicit_cr" sums the CR
# momentum solve's dots over the ranks as "implicit" sums the BiCGStab's
SPMD_KINDS = (("explicit", "explicit", dict(pressure_warm_start=True)),
              ("implicit", "implicit", {}),
              ("implicit_cr", "implicit", dict(momentum_solver="cr")))
# phase 13's seconds by part (its parts run inside phase 6 and at the end)
_SPMD_SECONDS: dict = {}
# sharded launch count -> the single-device name whose count the history implies
_SHARDED_NAMES = dict(sharded_spmv_k="window_spmv_k", sharded_spmv_k_plus_a="window_spmv_k_plus_a",
                      sharded_spmv_mk_plus_a="window_spmv_mk_plus_a",
                      sharded_spmv_m="window_spmv_m", sharded_grad="grad_window",
                      sharded_div_compact="div_compact_interleaved")


def _as_single(counts: dict, what: str) -> dict:
    """A sharded run's launch counts under the single-device names (which
    must be 0 in it), to hold them against what the history implies."""
    if any(counts[v] for v in _SHARDED_NAMES.values()):
        raise AssertionError(f"{what}: a single-device window kernel launched: {counts}")
    return {_SHARDED_NAMES.get(k, k): v for k, v in counts.items()
            if k not in _SHARDED_NAMES.values()}


def _collectives_per_step(n_steps: int) -> dict:
    """The sharded path's collectives a step (calls, bytes this rank sent)."""
    from cfd_with_cuda_tpu_torch.parallel import sharding

    return {k: dict(calls=c / n_steps, bytes=b / n_steps)
            for k, (c, b) in sorted(sharding.collective_counts.items())}


class _OneRankGroup:
    """A one-rank NCCL process group around a block (a file store in a fresh
    temporary directory), destroyed at its end."""

    def __enter__(self):
        import tempfile

        from cfd_with_cuda_tpu_torch.parallel.sharding import init_ranks

        self.tmp = tempfile.TemporaryDirectory()
        self.mesh = init_ranks("nccl", init_method=f"file://{self.tmp.name}/store", rank=0,
                               world_size=1)
        return self.mesh

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self.tmp.cleanup()
        return False


def _spmd_timed(what, solver, cuda_lib, n_warm, n_timed):
    """``n_warm`` + ``n_timed`` steps from rest with the launch and collective
    counts set to 0 just before: (state, history, counts, ms/step of the
    timed steps, collectives a step)."""
    import torch

    from cfd_with_cuda_tpu_torch.parallel import sharding

    cuda_lib.reset_launch_counts()
    sharding.reset_collective_counts()
    torch.cuda.synchronize()
    state, hist_w = solver.run(solver.initial_state(), n_steps=n_warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_timed)
    torch.cuda.synchronize()
    ms = (time.time() - t1) / n_timed * 1e3
    hist = hist_w + hist_t
    if len(hist) != n_warm + n_timed:
        raise AssertionError(f"{what}: ran {len(hist)} of {n_warm + n_timed} steps")
    return state, hist, dict(cuda_lib.launch_counts), ms, _collectives_per_step(len(hist))


def _paired_ms(single, sharded, no_group, state, n_steps: int) -> dict:
    """ms/step of ``n_steps`` from ``state`` on one device, on the sharded path
    over the one-rank group and on the sharded path with no group (its
    collectives identities), in turns (one device, group, no group, no group,
    group, one device): the same steps' work on each, so the machinery's and
    the collectives' shares of the sharded path's cost come apart."""
    import torch

    out = dict(single=[], spmd1=[], spmd1_no_collectives=[])
    for tag, solver in (("single", single), ("spmd1", sharded),
                        ("spmd1_no_collectives", no_group), ("spmd1_no_collectives", no_group),
                        ("spmd1", sharded), ("single", single)):
        torch.cuda.synchronize()
        t0 = time.time()
        solver.run(state, n_steps=n_steps)
        torch.cuda.synchronize()
        out[tag].append((time.time() - t0) / n_steps * 1e3)
    return out


def phase_spmd1_explicit(xs, ExplicitBCHSolver, cuda_lib, ms_single) -> dict:
    """Phase 13 (a), explicit: ``spmd_devices=1`` (the JAX package's "spmd1")
    at rung 3's config on phase 6's NE27000 tables, one rank over NCCL: 5 +
    20 steps from rest, launch counts against the history, ms/step beside
    phase 6's and the collectives a step; 3 steps against the single-device
    interleaved path from the same state (STEP_TOLS, equal CG counts); 5
    steps of ``conv_mode="assemble"`` (K + A on the rank's rows)."""
    import torch

    t0 = time.time()
    cfg = dataclasses.replace(xs.config, spmd_devices=1)
    # the same path with no process group (made before the group starts)
    no_group = ExplicitBCHSolver.from_tables(xs.deck, cfg, xs.d, xs.static_attrs())
    with _OneRankGroup() as mesh:
        sh = ExplicitBCHSolver.from_tables(xs.deck, cfg, xs.d, xs.static_attrs())
        if sh.spmd_mesh is None or sh.spmd_mesh.backend != "nccl" or sh.block.s_loc != xs.s_pad:
            raise AssertionError(f"spmd1: mesh {sh.spmd_mesh}, block {sh.block}")
        state, hist, counts, ms, coll = _spmd_timed("spmd1_explicit", sh, cuda_lib,
                                                    *SPMD_STEPS)
        on_path, ok = _explicit_interleaved_expect(hist, _as_single(counts, "spmd1"),
                                                   cfg.conv_mode)
        if not ok or not (torch.isfinite(state.un).all() and torch.isfinite(state.pn).all()):
            raise AssertionError(f"spmd1_explicit: launch counts {counts}, expected {on_path}")
        subs = [int(h["iters"]) for h in hist]
        out = dict(phase="spmd1_explicit", backend=mesh.backend, ranks=mesh.size,
                   steps=len(hist), warmup_steps=SPMD_STEPS[0], ms_per_step=ms,
                   ms_per_step_single_device_phase6=ms_single,
                   sub_iters_hist={str(v): subs.count(v) for v in sorted(set(subs))},
                   u_mon=hist[-1]["u_mon"], launches=counts, collectives_per_step=coll)
        emit(out)
        st_s, h_s = sh.run(state, n_steps=3)
        st_1, h_1 = xs.run(state, n_steps=3)
        out["vs_single"] = _compare_runs("spmd1_vs_single_device_3_steps", h_s, h_1,
                                         sh.fields(st_s), xs.fields(st_1), STEP_TOLS, 0)
        out["same_steps_ms"] = _paired_ms(xs, sh, no_group, state, 10)
        asm = ExplicitBCHSolver.from_tables(xs.deck, dataclasses.replace(cfg, conv_mode="assemble"),
                                            sh.d, sh.static_attrs())
        st_a, h_a, counts_a, ms_a, _ = _spmd_timed("spmd1_assemble", asm, cuda_lib, 1,
                                                   SPMD_ASSEMBLE_STEPS - 1)
        on_a, ok_a = _explicit_interleaved_expect(h_a, _as_single(counts_a, "spmd1_assemble"),
                                                  "assemble")
        if not ok_a or not torch.isfinite(st_a.un).all():
            raise AssertionError(f"spmd1_assemble: launch counts {counts_a}, expected {on_a}")
        out["assemble"] = dict(steps=len(h_a), ms_per_step=ms_a, launches=counts_a)
    out["seconds"] = _SPMD_SECONDS["spmd1_explicit"] = time.time() - t0
    emit(dict(phase="spmd1_assemble", **out["assemble"], same_steps_ms=out["same_steps_ms"],
              seconds=out["seconds"]))
    return out


def phase_spmd1_implicit(isolver, ImplicitGQSolver, cuda_lib, ms_single) -> dict:
    """Phase 13 (a), implicit: ``spmd_devices=1`` at cell 2's config on phase
    6's NE27000 tables, one rank over NCCL: 5 + 10 steps from rest, launch
    counts against the history, ms/step and collectives a step; 3 steps
    against the single-device interleaved path (IMPLICIT_TOLS)."""
    import numpy as np
    import torch

    t0 = time.time()
    cfg = dataclasses.replace(isolver.config, spmd_devices=1)
    no_group = ImplicitGQSolver.from_tables(isolver.deck, cfg, isolver.d, isolver.static_attrs())
    with _OneRankGroup() as mesh:
        sh = ImplicitGQSolver.from_tables(isolver.deck, cfg, isolver.d, isolver.static_attrs())
        state, hist, counts, ms, coll = _spmd_timed("spmd1_implicit", sh, cuda_lib,
                                                    *SPMD_IMPLICIT_STEPS)
        on_path, expect = _implicit_expect(hist, _as_single(counts, "spmd1_implicit"),
                                           "interleaved")
        if (min(on_path.values()) <= 0 or _as_single(counts, "spmd1_implicit") != expect
                or not torch.isfinite(state.uk).all()):
            raise AssertionError(f"spmd1_implicit: launch counts {counts}, expected {expect}")
        out = dict(phase="spmd1_implicit", backend=mesh.backend, ranks=mesh.size,
                   steps=len(hist), warmup_steps=SPMD_IMPLICIT_STEPS[0], ms_per_step=ms,
                   ms_per_step_single_device_phase6=ms_single,
                   cg_iters_mean=float(np.mean([h["cg_iters"] for h in hist])),
                   mom_iters_mean=float(np.mean([h["mom_iters"] for h in hist])),
                   u_mon=hist[-1]["u_mon"], launches=counts, collectives_per_step=coll)
        emit(out)
        st_s, h_s = sh.run(state, n_steps=3)
        st_1, h_1 = isolver.run(state, n_steps=3)
        tols = dict(u=IMPLICIT_TOLS["u"], p=IMPLICIT_TOLS["p"], mon=IMPLICIT_TOLS["u"])
        out["vs_single"] = _compare_runs("spmd1_implicit_vs_single_device_3_steps", h_s, h_1,
                                         sh.fields(st_s), isolver.fields(st_1), tols,
                                         IMPLICIT_TOLS["cg_iters"])
        out["same_steps_ms"] = _paired_ms(isolver, sh, no_group, state, 10)
    out["seconds"] = _SPMD_SECONDS["spmd1_implicit"] = time.time() - t0
    emit(dict(phase="spmd1_implicit_total", same_steps_ms=out["same_steps_ms"],
              seconds=out["seconds"]))
    return out


def phase_spmd_kernels(xs, isolver, window_stencil, stencil, kint) -> dict:
    """Phase 13 (c): the sharded K, K + A, MK + A, M, G and G^T applies of
    ``parallel/sharded_stencil.py`` at the NE27000 interleaved shapes on the
    solvers' tables.  On 1 and 4 ranks' blocks (the rank-rows kernels of
    ``ops/window_stencil.py`` given each block's halo-extended field, cut
    from the whole field as the halo exchange builds it; no process group)
    the blocks' results joined equal the single-device kernels' bit for
    bit; G^T (the compact kernel on each block's coarse rows) also against
    the full-window DIV mode at the coarse rows.  Each sharded wrapper at
    one rank against its plain version (WINDOW_TOL), timed (device time of
    back-to-back calls, a cold L2, and the kernel alone by the profiler)
    beside the bound of its nonzero weights and phase 6's single-device and
    cuSPARSE times of the same operator."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.parallel import sharded_stencil as sst
    from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh

    t0 = time.time()
    ws = window_stencil
    rng = np.random.default_rng(20261118)
    dev, n, fine, coarse, nnp = xs.device, xs.s_pad, xs.fine_dims, xs.coarse_dims, xs.nnp
    u = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)).to(dev)
    u[:, xs.nn:] = 0
    pf = torch.nn.functional.pad(stencil.coarse_to_fine(
        torch.from_numpy(rng.standard_normal(nnp).astype(np.float32)).to(dev), coarse, fine),
        (0, n - xs.nn))
    forms = {f: (comp, offs) for f, _, comp, offs, _ in ws.spmv_forms(xs, isolver, rng)}
    halo = sst.halo_size(ws.window_offsets(fine, 2))
    one = Mesh(0, 1, dev, None)
    results = {}

    def blocks(ranks, fn):
        """``fn(r0, r1, x_ext of u, p_ext of pf)`` on each of ``ranks`` blocks,
        joined along the last axis."""
        s_loc, w = n // ranks, n // ranks + 2 * halo + 128
        u_p = torch.nn.functional.pad(u, (halo, halo + 128))
        p_p = torch.nn.functional.pad(pf, (halo, halo + 128))
        return torch.cat([fn(r * s_loc, (r + 1) * s_loc, u_p[:, r * s_loc: r * s_loc + w],
                             p_p[r * s_loc: r * s_loc + w]) for r in range(ranks)], dim=-1)

    def row(name, sharded, plain, absolute, table, fields, lib_key, joined, single, kernel_name):
        y, y_plain = sharded(), plain()
        err, rel = _apply_err(y, y_plain, absolute())
        if not rel <= WINDOW_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rel:.3e} > {WINDOW_TOL}")
        equal = {str(k): torch.equal(v, single) for k, v in joined.items()}
        equal["sharded_one_rank"] = torch.equal(y, single)
        if not all(equal.values()):
            raise AssertionError(f"{name}: the ranks' blocks joined differ from the "
                                 f"single-device kernel's: {equal}")
        nz, b = nnz(table), table.element_size()
        b_ms, b_by = bound(b * (nz + fields), 2 * nz * (y.shape[0] if table.dim() <= 2 else 1))
        lib = kint[lib_key]
        results[name] = dict(
            max_abs_err=err, err_rel=rel, tol=WINDOW_TOL, ms=queued_ms(sharded, 20),
            event_ms=time_ms(sharded, 20), cold_ms=cold_ms(sharded, 20),
            kernel_ms=kernel_device_ms(sharded, kernel_name, 20), plain_ms=time_ms(plain, 3),
            bound_ms=b_ms, bound_by=b_by, table_nnz=nz, library_ms=lib["library_ms"],
            single_device_ms=lib["ms"], blocks_bit_equal=equal)
        return results[name]

    # ---- the window SPMV on the compact table of a rank's rows
    for form, name in (("k", "sharded_spmv_k"), ("k_plus_a", "sharded_spmv_k_plus_a"),
                       ("mk_plus_a", "sharded_spmv_mk_plus_a"), ("m", "sharded_spmv_m")):
        comp, offs = forms[form]
        full = ws.spmv_window_from_compact(comp, offs, fine, n)
        joined = {ranks: blocks(ranks, lambda r0, r1, ue, pe: ws.spmv_compact_rows(
            ws.compact_spmv_window(full, offs, fine, rows=(r0, r1)), ue, fine, offs, n,
            (r0, r1), r0 - halo, name=name)) for ranks in (1, 4)}
        sharded = lambda comp=comp, offs=offs, name=name, plain=False: sst.sharded_spmv_compact(
            comp, u, fine, offsets=offs, mesh=one, s_pad=n, name=name, plain=plain)
        row(name, sharded, lambda s=sharded: s(plain=True),
            lambda: ws.window_spmv_plain(full.abs(), u.abs(), fine, offsets=offs, trim=False),
            comp, 2 * 3 * n, f"window_spmv_{form}", joined,
            ws.window_spmv_compact(comp, u, fine, offsets=offs, trim=False, name="window_spmv"),
            "spmv_compact_kernel")
        del full, joined
    # ---- G on the rank's columns of G_cwin, the replicated embedded pressure
    d = xs.d
    gc = d["G_cwin"]
    joined = {ranks: blocks(ranks, lambda r0, r1, ue, pe: ws.grad_rows(
        gc[..., r0:r1], pe, fine, xs.g_radius, (r0, r1), r0 - halo, name="sharded_grad"))
        for ranks in (1, 4)}
    gcall = lambda plain=False: sst.sharded_grad_compact(gc, pf, fine, xs.g_radius, mesh=one,
                                                         plain=plain)
    row("sharded_grad", gcall, lambda: gcall(True),
        lambda: ws.grad_window_plain(d["G_win"].abs(), pf.abs(), fine, xs.g_radius, trim=False),
        gc, 4 * n, "grad_window", joined,
        ws.grad_window_compact(gc, pf, fine, xs.g_radius, trim=False), "grad_compact_kernel")
    # ---- G^T on each block's coarse rows (the blocks joined here, no gather)
    gt = d["GT_cwin"]

    def div_block(r0, r1, ue, pe):
        q0, q1 = ws.coarse_rows(fine, coarse, (r0, r1))
        return ws.div_compact_rows(gt[..., q0:q1], ue, fine, coarse, q0, r0 - halo,
                                   name="sharded_div_compact")

    joined = {ranks: blocks(ranks, div_block) for ranks in (1, 4)}
    gt1 = gt[..., :nnp].contiguous()      # one rank's columns, as the solvers hold them
    dcall = lambda plain=False: sst.sharded_div_compact(gt1, u, fine, coarse, mesh=one,
                                                        s_pad=n, plain=plain)
    single = ws.div_compact_interleaved(gt, u, fine, coarse)[:nnp]
    out = row("sharded_div_compact", dcall, lambda: dcall(True),
              lambda: ws.div_compact_interleaved_plain(gt.abs(), u.abs(), fine, coarse)[:nnp],
              gt1, 3 * n + nnp, "div_compact_interleaved", joined, single,
              "div_compact_interleaved_kernel")
    # against the full-window DIV mode at the coarse rows: the JAX package's
    # sharded divergence computes every fine row so, then keeps these
    div_mode = stencil.fine_to_coarse(ws.div_window(d["GT_win"], u, fine, xs.g_radius),
                                      coarse, fine)
    dm_abs = stencil.fine_to_coarse(ws.div_window_plain(d["GT_win"].abs(), u.abs(), fine,
                                                        xs.g_radius), coarse, fine)
    diff = float((single - div_mode).abs().max())
    out.update(div_mode_bit_equal=torch.equal(single, div_mode), div_mode_abs_err=diff,
               div_mode_err_rel=diff / float(dm_abs.max()), div_mode_ms=kint["div_window"]["ms"],
               div_mode_library_ms=kint["div_window"]["library_ms"],
               div_mode_bound_ms=kint["div_window"]["bound_ms"],
               gathered_rows=nnp, div_mode_gathered_rows=n)
    if not out["div_mode_err_rel"] <= WINDOW_TOL:
        raise AssertionError(f"sharded_div_compact: against the DIV mode {out['div_mode_err_rel']}")
    # the JAX package's full-window forms on a rank's rows (sharded_window_spmv,
    # sharded_div_window: the window kernel's rows entry), joined against one
    # device's window kernel bit for bit
    k_full = ws.spmv_window_from_compact(forms["k"][0], forms["k"][1], fine, n)
    full_rows = dict(
        spmv=torch.equal(
            blocks(4, lambda r0, r1, ue, pe: ws.window_rows(
                k_full[:, r0:r1], ue, forms["k"][1], (r0, r1), r0 - halo,
                name="sharded_window_spmv")),
            ws.window_spmv(k_full, u, fine, offsets=forms["k"][1], trim=False)),
        div=torch.equal(
            blocks(4, lambda r0, r1, ue, pe: ws.window_rows(
                d["GT_win"][..., r0:r1], ue, ws.window_offsets(fine, 2), (r0, r1), r0 - halo,
                div=True, name="sharded_div_window"))[0, : xs.nn],
            ws.div_window(d["GT_win"], u, fine, xs.g_radius)))
    del k_full
    if not all(full_rows.values()):
        raise AssertionError(f"the full-window rows forms differ from one device's: {full_rows}")
    _SPMD_SECONDS["spmd_kernels"] = time.time() - t0
    emit(dict(phase="spmd_kernels", ranks=[1, 4], tols=dict(vs_plain=WINDOW_TOL),
              checks=results, full_window_rows_bit_equal=full_rows,
              seconds=_SPMD_SECONDS["spmd_kernels"]))
    return results


def _spmd_rank_run(deck_n: int, n_steps: int, device) -> dict:
    """One rank of phase 13 (b): ``n_steps`` explicit, implicit and implicit
    CR (``momentum_solver="cr"``) sharded steps from rest on
    ``cavity_deck(deck_n, viscosity=0.1, dt=0.005)`` (the JAX package's
    sharded-step deck), the fields gathered, this rank's launch and
    collective counts, ms/step and seconds with the setup (module-level: the
    spawned ranks import it)."""
    import torch

    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.ops import cuda_lib
    from cfd_with_cuda_tpu_torch.parallel import sharding
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    n = sharding.make_mesh().size
    out = {}
    for kind, solver_kind, extra in SPMD_KINDS:
        t_kind = time.time()
        cls = ExplicitBCHSolver if solver_kind == "explicit" else ImplicitGQSolver
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                           structured_layout="interleaved", spmd_devices=n,
                           steps_per_chunk=n_steps, **extra)
        solver = cls(cavity_deck(deck_n, viscosity=0.1, dt=0.005), cfg, device)
        cuda_lib.reset_launch_counts()
        sharding.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, hist = solver.run(n_steps=n_steps)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / n_steps * 1e3
        u, p = solver.fields(state)
        out[kind] = dict(u=u, p=p, hist=hist, ms_per_step=ms, layout=solver.layout,
                         block=tuple(solver.block), launches=dict(cuda_lib.launch_counts),
                         collectives_per_step=_collectives_per_step(n_steps),
                         seconds=time.time() - t_kind)
    return out


def phase_spmd_ranks(args, cuda_lib) -> dict:
    """Phase 13 (b): 2 and 4 ranks on the one card (gloo, CUDA tensors staged
    through pinned host buffers; every rank's kernels on the card), spawned,
    at ``cavity_deck(SPMD_DECK_N)``: held against one rank (this process, no
    group) within the JAX package's sharded tolerances, explicit CG counts
    equal; rank 0's launch counts against its history."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks

    t0 = time.time()
    ref = _spmd_rank_run(args.spmd_deck_n, args.spmd_rank_steps, None)
    out = dict(phase="spmd_ranks", deck=f"cavity_deck({args.spmd_deck_n}, viscosity=0.1, "
               f"dt=0.005)", steps=args.spmd_rank_steps, backend="gloo", device="cuda:0",
               one_rank=dict(ms_per_step={k: v["ms_per_step"] for k, v in ref.items()},
                             seconds={k: v["seconds"] for k, v in ref.items()}),
               runs={})
    for n in SPMD_RANKS:
        t1 = time.time()
        ranks = run_ranks(_spmd_rank_run, n, (args.spmd_deck_n, args.spmd_rank_steps, "cuda:0"),
                          backend="gloo", device="cuda:0", threads=None)
        run = dict(seconds=time.time() - t1, blocks={}, launches={}, collectives_per_step={},
                   ms_per_step={}, seconds_by_kind={})
        for kind, solver_kind, extra in SPMD_KINDS:
            r0, one = ranks[0][kind], ref[kind]
            t = SPMD_TOLS[solver_kind]
            du = float(np.abs(r0["u"] - one["u"]).max())
            dp = float(np.abs(r0["p"] - one["p"]).max())
            dmon = max(abs(a["u_mon"] - b["u_mon"]) for a, b in zip(r0["hist"], one["hist"]))
            cg = [[int(h["cg_iters"]) for h in x["hist"]] for x in (r0, one)]
            ok_u = np.allclose(r0["u"], one["u"], rtol=t["u"][0], atol=t["u"][1])
            ok_p = np.allclose(r0["p"], one["p"], rtol=t["p"][0], atol=t["p"][1])
            same = all(np.array_equal(x[kind]["u"], r0["u"]) for x in ranks)
            counts = r0["launches"]
            if solver_kind == "explicit":
                on_path, ok_l = _explicit_interleaved_expect(
                    r0["hist"], _as_single(counts, "spmd_ranks"), "auto")
            else:
                on_path, expect = _implicit_expect(
                    r0["hist"], _as_single(counts, "spmd_ranks"), "interleaved",
                    momentum=extra.get("momentum_solver", "bicgstab"))
                ok_l = min(on_path.values()) > 0 and _as_single(counts, "spmd_ranks") == expect
            run[kind] = dict(du=du, dp=dp, dmon=dmon, cg_iters=cg, tols=t, ranks_agree=same)
            run["blocks"][kind] = [x[kind]["block"] for x in ranks]
            run["launches"][kind] = counts
            run["collectives_per_step"][kind] = r0["collectives_per_step"]
            run["ms_per_step"][kind] = r0["ms_per_step"]
            run["seconds_by_kind"][kind] = r0["seconds"]
            if not (ok_u and ok_p and dmon <= t["mon"] and same and ok_l
                    and np.isfinite(r0["u"]).all()
                    and (solver_kind == "implicit" or cg[0] == cg[1])):
                raise AssertionError(f"spmd_ranks {n} {kind}: {run[kind]}, launches {counts}, "
                                     f"expected {on_path}")
        out["runs"][str(n)] = run
    out["seconds"] = _SPMD_SECONDS["spmd_ranks"] = time.time() - t0
    emit(out)
    return out


# ---------------------------------------------------------------- phase 14

# The annotation-placed paths (parallel/placement.py::place: the JAX package's
# shard_params + shard_state, after which GSPMD partitions the XLA structured and
# ELL steps).  (a) one NCCL rank at full size, placed, against the single-device
# path from the same state: the JAX package's default SolverConfig() (F64, the XLA
# path, the V-cycle) at NE27000 on phase 9's tables and the BFS ELL steps on phase
# 8's; (b) 2 and 4 ranks on the one card over gloo on the five decks of
# tests/test_sharding.py against one device there.
PLACED_STEPS = 3
# (b)'s steps: 1 (on the CPU tests/test_torch_placement.py runs 2); at 2 the ELL
# implicit case alone took 4-5 s a step over gloo (its BiCGStab at momentum_tol
# 1e-12 runs ~160 iterations, 329 field all-gathers and 489 all-reduces a step)
PLACED_RANK_STEPS = 1
PLACED_RANKS = (2, 4)
# (a) the placed step against the single-device one: each placed apply sums a row
# as one device does and the pressure solve is replicated, so bit for bit is
# expected; the run fails past the tolerances of tests/test_sharding.py (F64
# explicit u 1e-11 / p 1e-10, implicit 1e-10 / 1e-9) and, on the F32 BFS, past
# BFS_TOLS (of max|u|, max|p|)
PLACED_TOLS = dict(explicit=(1e-11, 1e-10), implicit=(1e-10, 1e-9))
# (b) tests/test_sharding.py's cases and tolerances (u, p, u_mon), absolute
PLACED_CASES = {
    "box_explicit": ("explicit", (3,), dict(viscosity=0.1, dt=0.005),
                     dict(pressure_cg_tol=1e-12), (1e-11, 1e-10, 1e-12)),
    "box_implicit": ("implicit", (4,), dict(viscosity=0.1, dt=0.005),
                     dict(pressure_cg_tol=1e-12), (1e-10, 1e-9, 1e-11)),
    "box_implicit_cr": ("implicit", (4,), dict(viscosity=0.1, dt=0.005),
                        dict(pressure_cg_tol=1e-12, momentum_solver="cr"), (1e-10, 1e-9, 1e-11)),
    "ell_explicit": ("explicit", (12, 4, 4), dict(dt=0.002),
                     dict(pressure_cg_tol=1e-12), (1e-11, 1e-10, 1e-12)),
    "ell_implicit": ("implicit", (12, 4, 4), dict(dt=0.01),
                     dict(pressure_cg_tol=1e-12, momentum_tol=1e-12), (1e-7, 1e-7, 1e-7)),
    "kovasznay": ("implicit", (4, 4, 2), dict(re=40.0, dt=0.02),
                  dict(pressure_cg_tol=1e-10), (1e-10, 1e-8, 1e-11)),
}
_PLACED_BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05)
_PLACED_SECONDS: dict = {}


def phase_placed_one_rank(what, solver, cls, cuda_lib, n_steps, kind, tols=None,
                          bit_for_bit=False) -> dict:
    """Phase 14 (a): ``solver`` (set up whole) and its twin on the same tables
    placed over a one-rank NCCL group, ``n_steps`` from rest each, in turns
    (one device, placed, placed, one device): the placed fields against one
    device's (bit for bit expected, and required with ``bit_for_bit``; the
    gap and the single-device path's own run-to-run gap printed), equal
    counts, launch counts, ms/step of each and the collectives a step
    (calls, bytes)."""
    import numpy as np
    import torch

    from cfd_with_cuda_tpu_torch.interop import state_to_rank
    from cfd_with_cuda_tpu_torch.parallel import sharding
    from cfd_with_cuda_tpu_torch.parallel.placement import place

    t0 = time.time()
    state = solver.initial_state()
    counts = lambda h: [[int(r[f]) for f in ("iters", "cg_iters", "mom_iters")] for r in h]
    with _OneRankGroup() as mesh:
        twin = place(cls.from_tables(solver.deck, solver.config, solver.d,
                                     solver.static_attrs(), device=solver.device), mesh)
        if twin.block is None or twin.block.s_loc != twin.s_pad or twin.ranks != mesh:
            raise AssertionError(f"{what}: block {twin.block}, mesh {twin.ranks}")
        runs, ms, launches, coll = [], [], [], None
        for tag, s in (("single", solver), ("placed", twin), ("placed", twin),
                       ("single", solver)):
            st0 = state_to_rank(state, s) if tag == "placed" else state
            cuda_lib.reset_launch_counts()
            sharding.reset_collective_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            st, hist = s.run(st0, n_steps=n_steps)
            torch.cuda.synchronize()
            ms.append((tag, (time.time() - t1) / n_steps * 1e3))
            launches.append((tag, dict(cuda_lib.launch_counts)))
            if tag == "placed" and coll is None:
                coll = _collectives_per_step(n_steps)
            runs.append((tag, s.fields(st), hist))
    (_, (u_1, p_1), h_1), (_, (u_p, p_p), h_p) = runs[0], runs[1]
    (_, (u_q, _), _), (_, (u_2, p_2), _) = runs[2], runs[3]
    u_max, p_max = float(np.abs(u_1).max()), float(np.abs(p_1).max())
    du, dp = float(np.abs(u_p - u_1).max()), float(np.abs(p_p - p_1).max())
    tu, tp = tols if tols is not None else (PLACED_TOLS[kind][0], PLACED_TOLS[kind][1])
    if tols is not None:                       # relative to max|u|, max|p|
        tu, tp = tu * u_max, tp * p_max
    bit = bool(np.array_equal(u_p, u_1) and np.array_equal(p_p, p_1))
    out = dict(phase=what, backend=mesh.backend, ranks=mesh.size, steps=n_steps, kind=kind,
               bit_equal=bit, du=du, dp=dp, tols=dict(u=tu, p=tp),
               du_mon=max(abs(a["u_mon"] - b["u_mon"]) for a, b in zip(h_p, h_1)),
               single_repeat_bit_equal=bool(np.array_equal(u_1, u_2) and np.array_equal(p_1, p_2)),
               placed_repeat_bit_equal=bool(np.array_equal(u_p, u_q)),
               counts=[counts(h_1), counts(h_p)],
               ms_per_step=dict(single=[m for t, m in ms if t == "single"],
                                placed=[m for t, m in ms if t == "placed"]),
               launches={t: {k: v for k, v in c.items() if v} for t, c in launches[:2]},
               collectives_per_step=coll, u_mon=h_p[-1]["u_mon"])
    if not bit:
        out["cause"] = ("the single-device path's own run-to-run difference"
                        if not out["single_repeat_bit_equal"] else
                        "a placed apply's sums in another order than one device's")
    out["seconds"] = _PLACED_SECONDS[what] = time.time() - t0
    emit(out)
    if not (du <= tu and dp <= tp and out["counts"][0] == out["counts"][1]
            and launches[0][1] == launches[1][1] and np.isfinite(u_p).all()
            and (bit or not bit_for_bit)):
        raise AssertionError(f"{what}: placed against one device: {out}")
    return out


def _placed_case_solver(case: str, device):
    """The port's solver of a ``tests/test_sharding.py`` case (F64,
    ``shard_pad=8``) on ``device``."""
    from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck, kovasznay_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    kind, dims, deck_kw, cfg_kw, _ = PLACED_CASES[case]
    make = dict(box_explicit=cavity_deck, box_implicit=cavity_deck, box_implicit_cr=cavity_deck,
                kovasznay=kovasznay_deck)
    deck = (bfs_deck(*dims, **deck_kw, **_PLACED_BFS) if case.startswith("ell")
            else make[case](*dims, **deck_kw))
    cls = ExplicitBCHSolver if kind == "explicit" else ImplicitGQSolver
    return cls(deck, SolverConfig(dtype_policy=DTypePolicy.F64, steps_per_chunk=1, shard_pad=8,
                                  **cfg_kw), device)


def _placed_rank_run(n_steps: int, device) -> dict:
    """One rank of phase 14 (b) (module-level: the spawned ranks import it):
    each case's solver placed over the group, ``n_steps`` from rest, the
    fields gathered, ms/step and this rank's collectives a step; without a
    group, the single-device run."""
    import torch

    from cfd_with_cuda_tpu_torch.ops import cuda_lib
    from cfd_with_cuda_tpu_torch.parallel import sharding
    from cfd_with_cuda_tpu_torch.parallel.placement import place

    mesh = sharding.make_mesh()
    out = {}
    for case in PLACED_CASES:
        t_case = time.time()
        solver = _placed_case_solver(case, device)
        if mesh.group:
            place(solver, mesh)
        cuda_lib.reset_launch_counts()
        sharding.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, hist = solver.run(n_steps=n_steps)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / n_steps * 1e3
        coll = _collectives_per_step(n_steps)
        u, p = solver.fields(state)
        out[case] = dict(u=u, p=p, mon=[h["u_mon"] for h in hist], ms_per_step=ms,
                         layout=solver.layout, xla=solver.xla,
                         block=None if solver.block is None else tuple(solver.block),
                         launches={k: v for k, v in cuda_lib.launch_counts.items() if v},
                         collectives_per_step=coll, seconds=time.time() - t_case)
    return out


def phase_placed_ranks(args) -> dict:
    """Phase 14 (b): 2 and 4 ranks spawned on the one card (gloo, CUDA tensors
    staged through pinned host buffers), each case of ``tests/test_sharding.py``
    placed, against one device (this process, no group) at that file's
    tolerances; every rank's gathered fields equal rank 0's; no hand-written
    kernel launched (these paths have none)."""
    import numpy as np

    from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks

    t0 = time.time()
    ref = _placed_rank_run(args.placed_rank_steps, None)
    out = dict(phase="placed_ranks", steps=args.placed_rank_steps, backend="gloo",
               device="cuda:0", cases={c: dict(layout=r["layout"], xla=r["xla"],
                                                ms_per_step_one_device=r["ms_per_step"],
                                                seconds_one_device=r["seconds"])
                                       for c, r in ref.items()}, runs={})
    for n in PLACED_RANKS:
        t1 = time.time()
        ranks = run_ranks(_placed_rank_run, n, (args.placed_rank_steps, "cuda:0"),
                          backend="gloo", device="cuda:0", threads=None)
        run = dict(seconds=time.time() - t1)
        for case, (_, _, _, _, (tu, tp, tmon)) in PLACED_CASES.items():
            r0, one = ranks[0][case], ref[case]
            du = float(np.abs(r0["u"] - one["u"]).max())
            dp = float(np.abs(r0["p"] - one["p"]).max())
            dmon = abs(r0["mon"][-1] - one["mon"][-1])
            same = all(np.array_equal(x[case]["u"], r0["u"]) for x in ranks)
            run[case] = dict(du=du, dp=dp, dmon=dmon, tols=(tu, tp, tmon),
                             bit_equal=bool(np.array_equal(r0["u"], one["u"])
                                            and np.array_equal(r0["p"], one["p"])),
                             ranks_agree=same, blocks=[x[case]["block"] for x in ranks],
                             ms_per_step=r0["ms_per_step"], seconds=r0["seconds"],
                             launches=r0["launches"],
                             collectives_per_step=r0["collectives_per_step"])
            if not (du <= tu and dp <= tp and dmon <= tmon and same and not r0["launches"]
                    and np.isfinite(r0["u"]).all()):
                raise AssertionError(f"placed_ranks {n} {case}: {run[case]}")
        out["runs"][str(n)] = run
    out["seconds"] = _PLACED_SECONDS["placed_ranks"] = time.time() - t0
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck-n", type=int, default=30, help="cavity elements per edge (30: NE27000)")
    ap.add_argument("--steps", type=int, default=100, help="explicit e2e steps (warm-up included)")
    ap.add_argument("--implicit-steps", type=int, default=50,
                    help="implicit e2e steps from rest (warm-up included)")
    ap.add_argument("--bfs-dims", default="x".join(map(str, BFS_DIMS)),
                    help="backward-facing step elements NXxNYxNZ before the step block is "
                         "removed (96x40x40: 138,400 hexes; a smaller one asserts launch "
                         "counts and finite fields only)")
    ap.add_argument("--bfs-steps", type=int, default=50,
                    help="explicit BFS steps from rest (warm-up included)")
    ap.add_argument("--bfs-implicit-steps", type=int, default=20,
                    help="implicit BFS steps from rest (warm-up included)")
    ap.add_argument("--ne85-n", type=int, default=NE85_N,
                    help="elements per edge of the NE85184 cavity phases (44; a smaller one "
                         "asserts launch counts and finite fields only: below 39 the field "
                         "stays resident)")
    ap.add_argument("--ne85-steps", type=int, default=65,
                    help="explicit NE85184 steps from rest (5 warm-up + 60 timed)")
    ap.add_argument("--ne85-finite-steps", type=int, default=200,
                    help="explicit NE85184 steps from rest with finite fields (untimed)")
    ap.add_argument("--xla-steps", type=int, default=100,
                    help="explicit steps from rest of the XLA structured path phases (100: "
                         "held against the stored f64 run at NE27000)")
    ap.add_argument("--xla-cpu-steps", type=int, default=XLA_F64_CPU_STEPS,
                    help="first steps of the F64 XLA run repeated on the CPU (0: none)")
    ap.add_argument("--xla-implicit-steps", type=int, default=20,
                    help="implicit steps from rest of the XLA structured path phase")
    ap.add_argument("--ne85-implicit-steps", type=int, default=20,
                    help="implicit NE85184 steps from rest (warm-up included)")
    ap.add_argument("--cli-steps", type=int, default=CLI_STEPS,
                    help="steps of each command-line run on the cavity (phase 10)")
    ap.add_argument("--bend-dims", default="x".join(map(str, BEND_DIMS)),
                    help="bending duct elements NSxNYxNZ of phase 10 (48x32x32: full size; "
                         "a smaller one does not run the explicit solver on to the outflow "
                         "and asserts the implicit plain comparison's counts only)")
    ap.add_argument("--bend-steps", type=int, default=50,
                    help="explicit command-line steps on the bend (phase 10)")
    ap.add_argument("--bend-implicit-steps", type=int, default=20,
                    help="implicit command-line steps on the bend (phase 10)")
    ap.add_argument("--legacy-poisson-n", type=int, default=LEGACY_POISSON_N,
                    help="Poisson cube elements per edge of phase 11 (64; n/2 is held "
                         "against the CPU and every backend, and is the CLI's deck)")
    ap.add_argument("--legacy-stokes-n", type=int, default=LEGACY_STOKES_N,
                    help="Stokes cavity elements per edge of phase 11 (16: 19,652 unknowns)")
    ap.add_argument("--legacy-ns-n", type=int, default=LEGACY_NS_N,
                    help="GLS and segregated cavity elements per edge of phase 11 (20: NE8000)")
    ap.add_argument("--legacy-picard", type=int, default=LEGACY_PICARD,
                    help="GLS Picard iterations of phase 11 (card and CPU)")
    ap.add_argument("--legacy-outer", type=int, default=LEGACY_OUTER,
                    help="segregated outer iterations of phase 11 (card and CPU)")
    ap.add_argument("--legacy-cli-n", type=int, default=LEGACY_CLI_N,
                    help="elements per edge of phase 11's legacy cavity deck file")
    ap.add_argument("--import-n", type=int, default=IMPORT_N,
                    help="elements per edge of phase 12's imported .neu cavity (30: NE27000)")
    ap.add_argument("--import-steps", type=int, default=20,
                    help="timed steps of the imported cavity after 5 warm-up steps")
    ap.add_argument("--tet-ns", default=",".join(map(str, TET_NS)),
                    help="elements per edge of phase 12's tet cubes, coarse then fine")
    ap.add_argument("--ne125-n", type=int, default=NE125_N,
                    help="elements per edge of phase 12's flat-route cavity (50: NE125000; a "
                         "smaller one keeps the planes route and asserts launch counts only)")
    ap.add_argument("--ne125-steps", type=int, default=25,
                    help="timed NE125000 steps after 5 warm-up steps")
    ap.add_argument("--spmd-deck-n", type=int, default=SPMD_DECK_N,
                    help="cavity elements per edge of phase 13's 2- and 4-rank runs")
    ap.add_argument("--spmd-rank-steps", type=int, default=SPMD_RANK_STEPS,
                    help="steps of each solver in phase 13's 2- and 4-rank runs")
    ap.add_argument("--placed-steps", type=int, default=PLACED_STEPS,
                    help="steps of each placed one-rank run of phase 14 (a) and of its "
                         "single-device twin")
    ap.add_argument("--placed-rank-steps", type=int, default=PLACED_RANK_STEPS,
                    help="steps of each case in phase 14's 2- and 4-rank runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from cfd_with_cuda_tpu_torch.ops import cuda_lib

    t_start = time.time()
    phase_toolchain(cuda_lib)
    ne125_setup = start_setup_worker(args)
    try:
        return _main_phases(args, t_start, ne125_setup)
    finally:
        import shutil

        if ne125_setup[0].poll() is None:
            ne125_setup[0].kill()
        ne125_setup[0].communicate()
        shutil.rmtree(ne125_setup[1], ignore_errors=True)


def _main_phases(args, t_start, ne125_setup) -> int:
    """Phases 2-13, the ``kernels`` line and the last lines."""
    import torch

    from cfd_with_cuda_tpu_torch.mesh.generators import (
        bending_duct_deck,
        bfs_deck,
        box_cavity_deck,
        cavity_deck,
    )
    from cfd_with_cuda_tpu_torch.ops import (
        cuda_lib,
        fused_cg,
        parity_stencil,
        stencil,
        window_stencil,
    )
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    rows = cavity_phases(
        args, cavity_deck, cuda_lib, fused_cg, parity_stencil, window_stencil,
        ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy, SolverConfig)
    torch.cuda.empty_cache()
    rows += interleaved_phases(
        args, cavity_deck, cuda_lib, fused_cg, parity_stencil, window_stencil, stencil,
        ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy, SolverConfig)
    torch.cuda.empty_cache()
    rows += ne85_phases(args, ne125_setup, cavity_deck, cuda_lib, fused_cg, parity_stencil,
                        window_stencil, ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy)
    torch.cuda.empty_cache()
    phase_parity_box(parity_stencil, box_cavity_deck, ExplicitBCHSolver, ImplicitGQSolver,
                     DTypePolicy, SolverConfig)

    # ---- the unstructured path of both solvers on the backward-facing step
    dims = tuple(int(v) for v in args.bfs_dims.split("x"))
    strict = dims == BFS_DIMS
    # both setups ran in the setup worker beside the earlier phases
    bcfg, icfg = _bfs_configs(ne125_setup[1])
    emit(dict(phase="bfs_setup_worker", explicit=wait_for_setup(ne125_setup, "bfs_explicit"),
              implicit=wait_for_setup(ne125_setup, "bfs_implicit")))
    bsolver, _ = phase_bfs_setup(dims, bfs_deck, ExplicitBCHSolver, bcfg)
    banded = phase_banded_cg(bsolver, fused_cg, cuda_lib)
    be2e = phase_e2e_bfs(bsolver, ExplicitBCHSolver, cuda_lib, args.bfs_steps, strict)
    # phase 14 (a): the BFS step placed over one NCCL rank, on phase 8's tables
    bfs_tols = (BFS_TOLS["u"], BFS_TOLS["p"])
    phase_placed_one_rank("placed_bfs", bsolver, ExplicitBCHSolver, cuda_lib,
                          args.placed_steps, "explicit", bfs_tols)
    del bsolver
    torch.cuda.empty_cache()
    bi = phase_e2e_bfs_implicit(dims, bfs_deck, ImplicitGQSolver, cuda_lib, icfg,
                                args.bfs_implicit_steps, strict)
    phase_placed_one_rank("placed_bfs_implicit", bi.pop("solver"), ImplicitGQSolver, cuda_lib,
                          args.placed_steps, "implicit", bfs_tols)
    del bi
    torch.cuda.empty_cache()

    # ---- the XLA structured path of both solvers (no hand-written kernel)
    xla_phases(args, ne125_setup, cavity_deck, cuda_lib, ExplicitBCHSolver, ImplicitGQSolver,
               SolverConfig)
    torch.cuda.empty_cache()

    # ---- the command line, Tecplot output, restart and the setup cache
    cli_phases(args, cavity_deck, bending_duct_deck, cuda_lib, ExplicitBCHSolver,
               ImplicitGQSolver, DTypePolicy, SolverConfig)
    torch.cuda.empty_cache()

    # ---- the legacy solvers (Poisson, Stokes, GLS, segregated) and their CLI
    legacy_phases(args, cuda_lib)
    torch.cuda.empty_cache()

    # ---- mesh import (.neu, the tet .unv Poisson path) and the NE125000 flat route
    import_phases(args, ne125_setup, cuda_lib, parity_stencil, ExplicitBCHSolver, DTypePolicy,
                  SolverConfig)
    torch.cuda.empty_cache()

    # ---- phase 13 (b): 2 and 4 ranks on the one card ((a) and (c) ran in phase 6)
    phase_spmd_ranks(args, cuda_lib)
    emit(dict(phase="spmd_total", seconds=sum(_SPMD_SECONDS.values()), parts=_SPMD_SECONDS))

    # ---- phase 14 (b): the placed paths on 2 and 4 ranks ((a) ran in phases 8 and 9)
    phase_placed_ranks(args)
    emit(dict(phase="placed_total", seconds=sum(_PLACED_SECONDS.values()),
              parts=_PLACED_SECONDS))

    # row 9: the CG kernels on the banded window (launches: the explicit BFS
    # run; cg_iter per launch of UNROLL iterations, which no single PyTorch
    # call computes: the CSR mv of Z stays in the banded_cg line)
    pcg = "cfd_with_cuda_tpu/ops/pallas_cg.py"
    it = banded["checks"]["cg_iter_plain"]
    errs = it["fixed_depth_errs"]
    rows += [
        ("cg_init_banded", "cg_iter.cu", pcg + ":478", be2e["launches"]["cg_init"],
         dict(max_abs_err=max(errs[0]["x_abs"], errs[1]["x_abs"]), ms=it["init_ms"],
              plain_ms=it["plain_start_ms"], bound_ms=banded["init_bound_ms"],
              bound_by=banded["init_bound_by"], library_ms=None)),
        ("cg_iter_banded", "cg_iter.cu", pcg + ":478", be2e["launches"]["cg_iter"],
         dict(max_abs_err=errs[BFS_FIXED_DEPTHS[-1]]["x_abs"], ms=it["iter_launch_ms"],
              plain_ms=it["plain_launch_ms"], bound_ms=banded["iter_launch_bound_ms"],
              bound_by=banded["iter_launch_bound_by"], library_ms=None)),
    ]
    csrc = "cfd_with_cuda_tpu_torch/csrc/"
    kernels = []
    for name, src, replaces, launches, c in rows:
        kernels.append(dict(
            name=name, route="cuda", source=csrc + src, replaces=replaces,
            launches=launches, max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
        ))
    emit(dict(phase="total", seconds=time.time() - t_start))
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def cavity_phases(args, cavity_deck, cuda_lib, fused_cg, parity_stencil, window_stencil,
                  ExplicitBCHSolver, ImplicitGQSolver, DTypePolicy, SolverConfig) -> list:
    """Phases 2-5 on the cavity; the rows of the ``kernels`` line they measure."""
    import torch

    full = args.deck_n == 30

    # ---- the explicit path
    t0 = time.time()
    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001)
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                       pressure_warm_start=True, pressure_cg_fuse_loop=True,
                       steps_per_chunk=25)
    solver = ExplicitBCHSolver(deck, cfg)
    emit(dict(phase="setup", deck=f"cavity_deck({args.deck_n}, cluster=2.0)",
              nn=solver.nn, nnp=solver.nnp, sp=solver.sp_c, setup_s=time.time() - t0))

    checks, (b_x, x0_x) = phase_kernels(solver, parity_stencil, cuda_lib, fused_cg, window_stencil)
    e2e = phase_e2e(solver, cuda_lib, args.steps, ExplicitBCHSolver, precision_deck=full)
    # the explicit solver's other CG modes on its 125-slot product Z
    phase_cg_modes("explicit_z", fused_cg, window_stencil, solver.d["Z_win"], solver.d["Z_dinv"],
                   b_x, x0_x, solver.coarse_dims, solver.z_radius, cfg.pressure_cg_tol,
                   cfg.pressure_cg_maxiter, strict=full)
    del solver, b_x, x0_x
    torch.cuda.empty_cache()

    # ---- the implicit path ("implicit" row of the JAX package's bench matrix)
    t0 = time.time()
    icfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                        pressure_warm_start=True, steps_per_chunk=25)
    isolver = ImplicitGQSolver(deck, icfg)
    emit(dict(phase="setup_implicit", nn=isolver.nn, nnp=isolver.nnp, sp=isolver.sp_c,
              z_window_rows=int(isolver.d["Z_win"].shape[0]), setup_s=time.time() - t0))
    # a divergence-shaped right-hand side on the implicit solver's 27-slot Z
    rng = torch.Generator(device="cpu").manual_seed(20260816)
    u = torch.randn(3, 8, isolver.sp_c, generator=rng).to(isolver.device)
    b_i = (-1.0 / isolver.dt) * parity_stencil.parity_div_apply_plain(
        isolver.d["GT_cwin"], u * isolver.d["bc_mask_p"][None], isolver.coarse_dims
    )[: isolver.nnp].contiguous()
    b_i = b_i * 1e-3                      # the size of a step's right-hand side
    if isolver.pin_grid >= 0:
        b_i[isolver.pin_grid] = 0.0
    cold = fused_cg.fused_cg_plain(isolver.d["Z_win"], b_i, isolver.d["Z_dinv"],
                                   dims=isolver.coarse_dims, radius=isolver.z_radius,
                                   tol=icfg.pressure_cg_tol, maxiter=icfg.pressure_cg_maxiter)
    x0_i = (cold.x * (1 + 1e-3 * torch.randn(isolver.nnp, generator=rng).to(isolver.device)))
    modes = phase_cg_modes("implicit_z", fused_cg, window_stencil, isolver.d["Z_win"],
                           isolver.d["Z_dinv"], b_i, x0_i.contiguous(), isolver.coarse_dims,
                           isolver.z_radius, icfg.pressure_cg_tol, icfg.pressure_cg_maxiter,
                           strict=full)
    del u, b_i, x0_i, cold
    ie2e = phase_e2e_implicit(isolver, ImplicitGQSolver, cuda_lib, fused_cg,
                              args.implicit_steps, DTypePolicy, strict=full)
    del isolver
    torch.cuda.empty_cache()
    if full:
        phase_seeded(deck, icfg, ImplicitGQSolver)

    pcg = "cfd_with_cuda_tpu/ops/pallas_cg.py"
    rows = [
        ("parity_apply_k", "parity_apply.cu", "cfd_with_cuda_tpu/ops/parity_stencil.py:432",
         e2e["launches"]["parity_apply_k"], checks["parity_apply_k"]),
        ("parity_apply_g", "parity_apply.cu", "cfd_with_cuda_tpu/ops/parity_stencil.py:432",
         e2e["launches"]["parity_apply_g"], checks["parity_apply_g"]),
        ("parity_apply_k_plus_a", "parity_apply.cu", "cfd_with_cuda_tpu/ops/parity_stencil.py:406",
         e2e["launches"]["parity_apply_k_plus_a"], checks["parity_apply_k_plus_a"]),
        ("div_compact", "div_compact.cu", "cfd_with_cuda_tpu/ops/pallas_stencil.py:307",
         e2e["launches"]["div_compact"], checks["div_compact"]),
        ("cg_solve", "cg_solve.cu", pcg + ":549", e2e["launches"]["cg_solve"],
         checks["cg_solve_warm"]),
    ]
    # the implicit path's CG kernels, at its 27-slot window: one launch each
    ln = modes["launch_plain"]
    rows += [
        ("cg_init", "cg_iter.cu", pcg + ":607", ie2e["launches"]["cg_init"],
         dict(max_abs_err=ln["init_abs_err"], ms=ln["init_ms"], plain_ms=ln["init_plain_ms"],
              bound_ms=ln["init_bound_ms"], bound_by=ln["init_bound_by"], library_ms=None)),
        ("cg_iter", "cg_iter.cu", pcg + ":577", ie2e["launches"]["cg_iter"],
         dict(max_abs_err=ln["iter_abs_err"], ms=ln["iter_launch_ms"],
              plain_ms=ln["iter_plain_launch_ms"], bound_ms=ln["iter_launch_bound_ms"],
              bound_by=ln["iter_launch_bound_by"], library_ms=None)),
        ("comp_dot", "cg_iter.cu", pcg + ":194", ie2e["mixed"]["launches"]["comp_dot"],
         modes["comp_dot"]),
        ("sym_apply", "cg_iter.cu", pcg + ":262", ie2e["sym"]["launches"]["sym_apply"],
         modes["sym_apply"]),
    ]
    return rows


if __name__ == "__main__":
    sys.exit(main())
