"""Where a time step's time goes on the card, in two regimes per solver.

    python -m cfd_with_cuda_tpu_torch.profile_step                # NE27000 cavity
    python -m cfd_with_cuda_tpu_torch.profile_step --deck-n 4 --warm-steps 50
    python -m cfd_with_cuda_tpu_torch.profile_step --solver implicit
    python -m cfd_with_cuda_tpu_torch.profile_step --layout interleaved [--solver implicit]
    python -m cfd_with_cuda_tpu_torch.profile_step --deck bfs [--solver implicit]
    python -m cfd_with_cuda_tpu_torch.profile_step --deck-n 44 [--solver implicit]  # NE85184
    python -m cfd_with_cuda_tpu_torch.profile_step --policy f64 [--solver implicit]  # XLA path
    python -m cfd_with_cuda_tpu_torch.profile_step --layout interleaved --spmd1 [--solver implicit]

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
momentum iterations, the kernel launches per step by launch form (the
parity apply's resident and ``_streamed`` forms apart), and a
``torch.profiler`` trace of 5 steps: device time by kernel name and the
device's busy share of the traced wall time (busy = union of kernel and
copy intervals).  Prints one JSON line per regime, then the card's name and
power limit.  Needs one CUDA card.

``--deck-n`` sets the cavity's elements per edge; the deck's dt is the JAX
package's bench-matrix dt for that size (``scripts/bench_matrix.py:136-150``:
5e-4 at 44, the NE85184 cavity, whose velocity field takes the streamed
form; 4e-4 at 50, the NE125000 cavity; else 1e-3).  Above a coarse size of
``_PLANES_MAX_SP`` (NE125000) the explicit parity step takes the flat
convection route, and each regime adds the device time by PyTorch op, the
host gap, and each op of the step alone: the A(un) build, the flat gather,
einsum and scatter, K in its streamed and its resident form, the whole
(K + A) u, G and G^T.

``--layout interleaved`` runs either solver on the cavity's interleaved
structured layout (``structured_layout="interleaved"``) instead of the
parity layout, and adds each op of the step timed alone at the step's
shapes (CUDA events): the window applies (K or A, M on their
class-compacted tables; G), the compact G^T on the interleaved field, the
elemental gather, the A(u) build (its einsums), and the per-step assembly
of A(u) into the compact table (implicit, and the explicit
``conv_mode="assemble"`` form) or the parity-grouped scatter (explicit
matrix-free form).

``--policy {f32,mixed,f64}``, ``--precond {auto,jacobi,mg}`` and
``--backend {auto,xla}`` set ``dtype_policy``, ``pressure_precond`` and
``pressure_backend`` (defaults F32, "auto", "auto": the kernel path).  Off
the kernel path (F64, "xla" or "mg": the JAX package's default config at
``--policy f64``) a cavity takes the XLA structured path, torch ops only:
each regime then adds the device time by PyTorch op, the host gap, and
each op of the step alone (the DIA apply of K or A, M, G, G^T, the coarse
Z apply, one V-cycle, one pressure solve, the A(u) build).

Every regime also prints the device kernels per step (launches of any
kernel, the trace's count), the host reads per step (the trace's
``aten::_local_scalar_dense`` calls: the CG's and BiCGStab's residual
tests, the sub-iteration and steady flags), the host ms per step by
PyTorch op (self time, the 15 largest) and, where the step runs any, the
collectives (the trace's ``c10d`` / NCCL host ops: calls and host ms per
step).

``--spmd1`` runs the cavity on the sharded kernel path with one rank
(``spmd_devices=1``, the JAX package's "spmd1"): the process starts a
one-rank NCCL group on a file store in a temporary directory, and the
solver runs the sharded step (its halo exchanges, the all-gathered G^T,
the norms, max_acc and the monitor over the group).  It first prints each
of the step's collectives timed alone (host µs a call, device µs a call,
and whether a call waits for the device).  Run it beside the same command
without ``--spmd1`` to see what the collectives cost.

``--deck bfs`` runs the unstructured path instead, on the backward-facing
step ``bfs_deck(96, 40, 40, lengths=(15, 2, 2), step_frac=(0.2, 0.5),
viscosity=0.01)`` (``--bfs-dims`` for another size): the explicit solver at
dt 0.002 (F32, CG tol 1e-6, cold-started per-iteration CG on the banded
window), or with ``--solver implicit`` the ELL step at dt 0.01.  One regime
from rest, and besides the trace's kernels its device time by PyTorch op
(``aten::index`` the gathers, ``aten::bmm`` the elemental products, ...),
the host gap (traced wall less busy time), and each op of the step timed
alone at the step's shapes (CUDA events): the elemental gather, ``bmm``
and reverse-map scatter, a whole elemental apply, the Ae(u) build, G and
G^T, the pressure solve, and for the implicit step the CSR assembly of
A(u), its ELL scatter and the ELL products.
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

from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib, spmv
from cfd_with_cuda_tpu_torch.ops import parity_stencil as pstl
from cfd_with_cuda_tpu_torch.ops.gradient import div_apply, grad_apply
from cfd_with_cuda_tpu_torch.ops.multigrid import make_vcycle
from cfd_with_cuda_tpu_torch.ops.stencil import (
    assemble_compact_values,
    coarse_to_fine,
    convection_elem_matrices,
    gather_elem_stencil,
    patches_spmv,
    scatter_elem_stencil,
)
from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    compact_spmv_oij,
    div_compact_interleaved,
    grad_window_compact,
    window_spmv_compact,
)
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import _PLANES_MAX_SP, ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig
from cfd_with_cuda_tpu_torch.utils.timers import busy_share

PROFILE_STEPS = 5
# dt of the JAX package's bench-matrix cavities by elements per edge (the
# "ne85" and "ne125" rows, scripts/bench_matrix.py:144); 1e-3 otherwise
BENCH_DT = {44: 5e-4, 50: 4e-4}
# the trace's host ops of the collectives (torch.distributed's c10d ops,
# ProcessGroupNCCL's spans)
_COLLECTIVE_WORDS = ("c10d", "nccl", "gloo", "record_param_comms")
# a device sleep of ~25 ms at the H100's clock (_collectives_alone)
_SLEEP_CYCLES = 50_000_000
SEEDED_STATE = (Path(__file__).resolve().parents[1] / "cfd_with_cuda_tpu" / "validation"
                / "data" / "cavity_re100_implicit_state.npz")


def _timed(solver, state, n):
    """(state, history, ms per step run): the run stops early where the
    steady test passes or the flow is no longer finite."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = solver.run(state, n_steps=n)
    torch.cuda.synchronize()
    return state, hist, (time.perf_counter() - t0) / max(len(hist), 1) * 1e3


def _trace(solver, state):
    """(state, {kernel: device ms per step}, busy share, traced wall ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = solver.run(state, n_steps=PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    short = lambda name: name.replace("void ", "").replace("(anonymous namespace)::", "")[:100]
    by_name = defaultdict(float)
    spans = []
    reads = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            reads += e.name == "aten::_local_scalar_dense"
            continue
        start, end = e.time_range.start, e.time_range.end
        by_name[short(e.name)] += (end - start) / 1e3 / PROFILE_STEPS
        spans.append((start, end))
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    by_op = {}
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CPU:
            continue                       # the kernels themselves: by_name above
        us = getattr(a, "self_device_time_total", None)
        us = getattr(a, "self_cuda_time_total", 0.0) if us is None else us
        if us > 0:
            by_op[a.key] = us / 1e3 / PROFILE_STEPS
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:15])
    share = busy_share(spans, wall_us)
    host, coll = {}, {}
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CPU:
            continue
        host[a.key] = a.self_cpu_time_total / 1e3 / PROFILE_STEPS
        if any(w in a.key.lower() for w in _COLLECTIVE_WORDS):
            coll[a.key] = dict(calls=a.count / PROFILE_STEPS,
                               host_ms=a.cpu_time_total / 1e3 / PROFILE_STEPS,
                               self_host_ms=a.self_cpu_time_total / 1e3 / PROFILE_STEPS)
    counts = dict(device_kernels_per_step=len(spans) / PROFILE_STEPS,
                  host_reads_per_step=reads / PROFILE_STEPS,
                  host_ms_per_step_by_op=dict(sorted(host.items(), key=lambda kv: -kv[1])[:15]))
    if coll:
        counts["collectives"] = coll
    return state, top, share, wall_us / 1e3 / PROFILE_STEPS, by_op, counts


def _regime(name, solver, state, n_timed, ops=None):
    cuda_lib.reset_launch_counts()
    state, hist, ms = _timed(solver, state, n_timed)
    launches = {k: v / max(len(hist), 1) for k, v in cuda_lib.launch_counts.items() if v}
    subs = [int(h["iters"]) for h in hist]
    state, top, busy, traced_ms, by_op, counts = _trace(solver, state)
    out = dict(
        regime=name, ms_per_step=ms, timed_steps=n_timed, steps_run=len(hist),
        sub_iters_hist={str(s): subs.count(s) for s in sorted(set(subs))},
        cg_iters_mean=sum(h["cg_iters"] for h in hist) / len(hist),
        mom_iters_mean=sum(h["mom_iters"] for h in hist) / len(hist),
        launches_per_step=launches, traced_ms_per_step=traced_ms, device_busy_share=busy,
        device_ms_per_step_by_kernel=top, device_ms_per_step_by_op=by_op,
        host_gap_ms_per_step=None if busy is None else traced_ms * (1 - busy), **counts,
    )
    if ops is not None:
        out.update(op_ms_alone=ops(state))
    print(json.dumps(out), flush=True)
    return state


def _collectives_alone(reps: int = 200) -> dict:
    """Each collective of the sharded step alone on the one-rank group, at
    its NE27000 size: host µs a call (the calls' return, no sync), µs a call
    to the device's end (host clock, then a sync), device µs a call (CUDA
    events), and host µs of one call issued behind a device sleep of
    ``sleep_ms`` (a call that waits for the device takes the rest of it)."""
    from cfd_with_cuda_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(1)
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = {
        "all_gather Gt rows (29,791 f32)": (lambda t: sharding.all_gather(t, mesh, "alone"), 29791),
        "all_gather norms (2 f32)": (lambda t: sharding.all_gather(t, mesh, "alone"), 2),
        "all_reduce dot (2 f32)": (lambda t: sharding.all_reduce(t, mesh, "sum", "alone"), 2),
        "broadcast monitor (3 f32)": (lambda t: sharding.broadcast(t, 0, mesh, "alone"), 3),
    }
    out = dict(sleep_ms=_event_ms(lambda: torch.cuda._sleep(_SLEEP_CYCLES), 3))
    for name, (fn, n) in cases.items():
        x = torch.ones(n, device=dev)
        call = lambda: fn(x)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        torch.cuda._sleep(_SLEEP_CYCLES)
        t3 = time.perf_counter()
        call()
        t4 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = dict(host_us=(t1 - t0) / reps * 1e6, to_device_end_us=(t2 - t0) / reps * 1e6,
                         device_us=_event_ms(call, reps) * 1e3,
                         host_us_behind_sleep=(t4 - t3) * 1e6)
    return out


def _xla_ops(solver, implicit):
    """The ops of one step on the XLA structured path, each alone at its
    shapes."""
    def ops(state):
        d = solver.d
        if implicit:
            u, p = state.uk, state.pk
            a_mul, m_mul, grad, div, a_diag = solver._xla_operators(d, u)
            # the next step's solve: its momentum solution's divergence,
            # warm-started from the last increment
            r1 = (m_mul(u) - grad(2.0 * p - state.pk_prev)) * d["bc_mask"][None] + d["bc_vel"]
            div_u = div(solver._momentum_solve(a_mul, r1, u, a_diag).x)
            solve = lambda: solver._pressure_update(d, div_u, p, state.pk_prev)
            out = dict(dia_apply_a=_event_ms(lambda: a_mul(u)),
                       dia_apply_m=_event_ms(lambda: m_mul(u)),
                       lhs_build=_event_ms(lambda: solver._xla_operators(d, u), 3))
        else:
            u, p = state.un, state.pn
            (k_mul, ka_mul, grad, div, pressure_solve, _, (mask, md_inv, _),
             pin) = solver._xla_operators(d, u)
            # the first sub-iteration's solve: its right-hand side, warm-started
            # from the carried pdot
            dt = solver.dt
            r2 = div((u - dt * (ka_mul(u) + grad(p)) * mask * md_inv) / (dt * dt))
            if pin >= 0:
                r2[pin] = 0.0
            solve = lambda: pressure_solve(r2, state.pdot)
            out = dict(dia_apply_k=_event_ms(lambda: k_mul(u)),
                       k_plus_a_apply=_event_ms(lambda: ka_mul(u)),
                       ae_build=_event_ms(lambda: convection_elem_matrices(
                           u[:, :solver.nn], d["Sv"], d["gDSv"], d["gq"], solver.elem_dims,
                           solver.fine_dims), 3))
        out |= dict(
            grad=_event_ms(lambda: grad(p)),
            div=_event_ms(lambda: div(u)),
            z_apply=_event_ms(lambda: patches_spmv(d["Z_win"], p, solver.coarse_dims,
                                                   solver.z_radius)),
            pressure_solve=_event_ms(solve, 2),
            pressure_solve_cg_iters=int((solve()[1] if implicit else solve()).iters),
        )
        if solver.use_mg:
            vc = make_vcycle(d, solver.mg_dims, solver.mg_radii, solver.mg_omegas)
            out["vcycle"] = _event_ms(lambda: vc(p))
            out["mg_levels"] = len(solver.mg_radii)
        return out
    return ops


def _padded_size(solver) -> dict:
    """The padded field length of the solver's box layout: Sp per class
    (parity) or s_pad (interleaved)."""
    return dict(sp=solver.sp_c) if solver.layout == "parity" else dict(s_pad=solver.s_pad)


def _event_ms(fn, reps=10):
    """Mean device ms of ``fn`` (CUDA events) after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _explicit_ops(solver):
    """The ops of one explicit unstructured step, each alone at its shapes."""
    def ops(state):
        d, un = solver.d, state.un
        ltog, rev = d["ltog"], d["rev"]
        ka = d["Ke"] + spmv.convection_elemental(un, ltog, d["Sv"], d["gDSv"], d["gq"])
        gathered = spmv._gather_nodes(un, ltog)
        y_e = torch.bmm(ka, gathered)
        k_mul, ka_mul, grad, div, solve, *_ = solver._ell_operators(d, un)
        r2 = div(un)
        if solver.pin >= 0:
            r2[solver.pin] = 0.0
        out = dict(
            gather_nodes=_event_ms(lambda: spmv._gather_nodes(un, ltog)),
            bmm_ke_plus_ae=_event_ms(lambda: torch.bmm(ka, gathered)),
            scatter_rev=_event_ms(lambda: spmv.scatter_nodes_rev(y_e, rev)),
            elem_apply=_event_ms(lambda: ka_mul(un)),
            ae_build=_event_ms(lambda: spmv.convection_elemental(
                un, ltog, d["Sv"], d["gDSv"], d["gq"]), 3),
            grad=_event_ms(lambda: grad(state.pn)),
            div=_event_ms(lambda: div(un)),
            pressure_solve=_event_ms(lambda: solve(r2, state.pdot), 2),
        )
        out["pressure_solve_cg_iters"] = int(solve(r2, state.pdot).iters)
        return out
    return ops


def _implicit_ops(solver):
    """The ops of one implicit ELL step, each alone at its shapes."""
    def ops(state):
        d, uk = solver.d, state.uk
        conv = lambda: spmv.convection_assemble_csr(uk, d["ltog"], d["Sv"], d["gDSv"],
                                                    d["gq"], d["rev_m"])
        a_csr = d["mk_vals_csr"] + conv()
        shape = d["A_cols"].shape

        def to_ell():
            a_ell = a_csr.new_zeros(shape[0] * shape[1])
            a_ell[d["csr_to_ell"]] = a_csr
            return a_ell.reshape(shape)

        a_ell = to_ell()
        return dict(
            convection_assemble_csr=_event_ms(conv, 3),
            csr_to_ell=_event_ms(to_ell),
            ell_spmv_a=_event_ms(lambda: spmv.ell_spmv(a_ell, d["A_cols"], uk)),
            grad=_event_ms(lambda: grad_apply(d["G_vals"], d["G_cols"], state.pk)),
            div=_event_ms(lambda: div_apply(d["GT_vals"], d["GT_cols"], uk)),
            ell_spmv_z=_event_ms(lambda: spmv.ell_spmv(d["Z_vals"], d["Z_cols"], state.pk)),
        )
    return ops


def _parity_flat_ops(solver):
    """The ops of one explicit parity step on the flat convection route
    (coarse size over ``_PLANES_MAX_SP``), each alone at its shapes: the
    A(un) build, the flat gather, einsum and scatter of A(un) u, K in the
    field form the rule picks and in the other (``stream_x`` forced), the
    whole (K + A) u, G and G^T."""
    def ops(state):
        d, un = solver.d, state.un
        _, ka_mul, grad, div, *_ = solver._parity_operators(d, un)
        ae = solver._parity_conv_ae(d, un, False)
        gather = lambda: pstl.parity_gather_elem_flat(un, solver.coarse_dims)
        ue = gather()
        einsum = lambda: torch.einsum("ije,dje->die", ae, ue)
        r1e = einsum()
        k_form = lambda stream: pstl.parity_apply(d["Kp"], un, pairs=solver.k_pairs, co=3,
                                                  stream_x=stream)
        return dict(
            ae_build=_event_ms(lambda: solver._parity_conv_ae(d, un, False), 3),
            gather_elem_flat=_event_ms(gather),
            einsum_ae_u=_event_ms(einsum),
            scatter_elem_flat=_event_ms(lambda: pstl.parity_scatter_elem_flat(
                r1e, solver.coarse_dims)),
            k_apply_streamed=_event_ms(lambda: k_form(True)),
            k_apply_resident=_event_ms(lambda: k_form(False)),
            k_plus_a_flat=_event_ms(lambda: ka_mul(un)),
            grad=_event_ms(lambda: grad(state.pn)),
            div_compact=_event_ms(lambda: div(un)),
        )
    return ops


def _interleaved_ops(solver, implicit):
    """The ops of one interleaved cavity step, each alone at its shapes."""
    def ops(state):
        d = solver.d
        u = state.uk if implicit else state.un
        fine, nn = solver.fine_dims, solver.nn
        table, offs = (d["MK_cvals"], solver.a_offsets) if implicit else (d["K_cvals"],
                                                                           solver.k_offsets)
        ae_build = lambda: convection_elem_matrices(u[:, :nn], d["Sv"], d["gDSv"], d["gq"],
                                                    solver.elem_dims, fine)
        ae = ae_build()
        coij = compact_spmv_oij(solver.conv_oij, solver.local_off, offs, fine)
        assemble = lambda: assemble_compact_values(ae, solver.local_off, coij, offs,
                                                   solver.elem_dims, fine, solver.s_pad)
        pf = torch.nn.functional.pad(coarse_to_fine(state.pk if implicit else state.pn,
                                                    solver.coarse_dims, fine),
                                     (0, solver.s_pad - nn))
        out = dict(
            window_spmv=_event_ms(lambda: window_spmv_compact(table, u, fine, offsets=offs,
                                                              trim=False)),
            grad_window=_event_ms(lambda: grad_window_compact(d["G_cwin"], pf, fine,
                                                              solver.g_radius, trim=False)),
            div_compact_interleaved=_event_ms(lambda: div_compact_interleaved(
                d["GT_cwin"], u, fine, solver.coarse_dims)),
            gather_elem=_event_ms(lambda: gather_elem_stencil(u[:, :nn], solver.elem_dims, fine)),
            ae_build=_event_ms(ae_build, 3),
            assemble_compact_values=_event_ms(assemble, 3),
        )
        if implicit:
            out["window_spmv_m"] = _event_ms(lambda: window_spmv_compact(d["M_cvals"], u, fine,
                                                                         offsets=offs,
                                                                         trim=False))
        else:
            r1e = torch.einsum("ije,dje->die", ae, gather_elem_stencil(u[:, :nn],
                                                                       solver.elem_dims, fine))
            out["scatter_elem"] = _event_ms(lambda: scatter_elem_stencil(
                r1e, solver.local_off, solver.elem_dims, fine))
        return out
    return ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck-n", type=int, default=30)
    ap.add_argument("--warm-steps", type=int, default=1500,
                    help="steps from rest before the warm regime is timed")
    ap.add_argument("--timed-warm", type=int, default=200)
    ap.add_argument("--solver", choices=("explicit", "implicit"), default="explicit")
    ap.add_argument("--state", default=str(SEEDED_STATE),
                    help="npz with u (NN, 3), p (NNp,): the implicit solver's seeded regime")
    ap.add_argument("--deck", choices=("cavity", "bfs"), default="cavity")
    ap.add_argument("--layout", choices=("parity", "interleaved"), default="parity",
                    help="the cavity's structured layout")
    ap.add_argument("--policy", choices=("f32", "mixed", "f64"), default="f32",
                    help="dtype_policy (f64: the XLA structured path)")
    ap.add_argument("--precond", choices=("auto", "jacobi", "mg"), default="auto",
                    help="pressure_precond (mg: the XLA structured path)")
    ap.add_argument("--backend", choices=("auto", "xla"), default="auto",
                    help="pressure_backend (xla: the XLA structured path)")
    ap.add_argument("--bfs-dims", default="96x40x40")
    ap.add_argument("--timed", type=int, default=None,
                    help="timed steps of the BFS regime (default 50 explicit, 15 implicit)")
    ap.add_argument("--spmd1", action="store_true",
                    help="the sharded kernel path on a one-rank NCCL group (spmd_devices=1)")
    args = ap.parse_args()
    dt = BENCH_DT.get(args.deck_n, 1e-3)
    choice = dict(dtype_policy=DTypePolicy(args.policy), pressure_precond=args.precond,
                  pressure_backend=args.backend)
    if args.spmd1:
        if args.deck != "cavity":
            raise SystemExit("--spmd1 runs the cavity (the sharded path is the box's)")
        import atexit
        import shutil
        import tempfile

        import torch.distributed as dist

        from cfd_with_cuda_tpu_torch.parallel.sharding import init_ranks

        store = tempfile.mkdtemp()
        init_ranks("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)

        def close_group():
            # an NCCL group left open holds the process for minutes at exit
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)

        atexit.register(close_group)
        choice["spmd_devices"] = 1
        print(json.dumps(dict(collectives_alone=_collectives_alone())), flush=True)
    # the cavity's layout: "parity" asks for nothing off the kernel path,
    # where the XLA structured path has the interleaved layout
    layout = "auto" if args.layout == "parity" else args.layout

    if args.deck == "bfs":
        dims = tuple(int(v) for v in args.bfs_dims.split("x"))
        implicit = args.solver == "implicit"
        deck = bfs_deck(*dims, lengths=(15.0, 2.0, 2.0), step_frac=(0.2, 0.5),
                        viscosity=0.01, dt=0.01 if implicit else 0.002)
        cfg = SolverConfig(pressure_cg_tol=1e-6, pressure_warm_start=implicit,
                           steps_per_chunk=25, **choice)
        t0 = time.perf_counter()
        solver = (ImplicitGQSolver if implicit else ExplicitBCHSolver)(deck, cfg)
        print(json.dumps(dict(deck=f"bfs_deck{dims}", layout=solver.layout, nn=solver.nn,
                              nnp=solver.nnp, setup_s=time.perf_counter() - t0)), flush=True)
        state, _ = solver.run(n_steps=5)
        _regime("from_rest", solver, state, args.timed or (15 if implicit else 50),
                ops=(_implicit_ops if implicit else _explicit_ops)(solver))
    elif args.solver == "explicit":
        deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=dt)
        cfg = SolverConfig(pressure_cg_tol=1e-6, pressure_warm_start=True,
                           pressure_cg_fuse_loop=True, steps_per_chunk=50,
                           structured_layout=layout, **choice)
        t0 = time.perf_counter()
        solver = ExplicitBCHSolver(deck, cfg)
        print(json.dumps(dict(deck=f"cavity_deck({args.deck_n}, cluster=2.0, dt={dt})",
                              layout=solver.layout, xla=solver.xla, nn=solver.nn,
                              spmd_devices=cfg.spmd_devices, setup_s=time.perf_counter() - t0,
                              **_padded_size(solver))),
              flush=True)
        flat = solver.layout == "parity" and solver.sp_c > _PLANES_MAX_SP
        # the ops alone are the single-device forms: none on the sharded path
        ops = (None if args.spmd1 else _xla_ops(solver, False) if solver.xla else
               _interleaved_ops(solver, False) if args.layout == "interleaved" else
               _parity_flat_ops(solver) if flat else None)
        state, _ = solver.run(n_steps=5)           # warm-up: kernel build and first launches
        state = _regime("spin_up", solver, state, 50, ops=ops)
        done = 5 + 50 + PROFILE_STEPS
        state, _ = solver.run(state, n_steps=max(0, args.warm_steps - done))
        _regime("warm", solver, state, args.timed_warm, ops=ops)
    else:
        deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=dt)
        cfg = SolverConfig(pressure_cg_tol=1e-6, pressure_warm_start=True, steps_per_chunk=25,
                           structured_layout=layout, **choice)
        t0 = time.perf_counter()
        solver = ImplicitGQSolver(deck, cfg)
        print(json.dumps(dict(deck=f"cavity_deck({args.deck_n}, cluster=2.0, dt={dt})",
                              layout=solver.layout, xla=solver.xla, nn=solver.nn,
                              spmd_devices=cfg.spmd_devices, setup_s=time.perf_counter() - t0,
                              **_padded_size(solver))),
              flush=True)
        interleaved_ops = _xla_ops if solver.xla else _interleaved_ops
        ops = (interleaved_ops(solver, True)
               if not args.spmd1 and (solver.xla or args.layout == "interleaved") else None)
        state, _ = solver.run(n_steps=5)
        _regime("from_rest", solver, state, 50, ops=ops)
        seed = np.load(args.state)
        if seed["u"].shape[0] == solver.nn:
            del solver, state
            deck.dt, deck.max_iter = 0.01, 1
            solver = ImplicitGQSolver(deck, cfg)
            state, _ = solver.run(solver.state_from_fields(seed["u"], seed["p"]), n_steps=5)
            _regime("seeded", solver, state, 50, ops=ops and interleaved_ops(solver, True))
        else:
            print(json.dumps(dict(regime="seeded", skipped=f"{args.state} holds "
                                  f"{seed['u'].shape[0]} nodes, the deck {solver.nn}")), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
