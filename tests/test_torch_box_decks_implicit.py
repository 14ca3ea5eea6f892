"""PyTorch port: the implicit Guermond-Quartapelle solver on the box decks
users run, on the parity and interleaved layouts, against the JAX solver.

The decks of ``tests/test_torch_box_decks_explicit.py``: the channel with
its outflow face (the implicit solver holds the pressure increment at 0 on
the outflow pressure nodes), the bend's small size and the 5 x 3 x 4 box
cavity.  The JAX solver runs its kernel path (``pressure_backend="pallas"``,
Pallas in interpret mode); the port runs the plain PyTorch versions of its
kernels (CPU tensors).  F32, the default per-iteration CG loop.

``test_fixed_depth_steps_match_jax`` holds the step as a whole at the JAX
package's cavity bound, 5e-5 (``tests/test_parity_stencil.py:344-354``),
of max|u| and max|p| (the channel's first pressure reaches 3,067 and the
bend's 1,425, where 5e-5 absolute is below the f32 spacing), on inputs that
do not diverge: every step starts from the same state (the JAX solver's own
run on the parity layout gives the state before each of 3 steps, carried to
the interleaved layout through the deck-order fields), and the two Krylov
solves run a fixed depth (tol 0: 2 BiCGStab and 12 CG iterations), so no
stop can fall on another iteration.  Measured, the port sits at 2.8e-6 of
max|u| (the bend's third step) and 2.6e-5 of max|p| (the channel's second
step on the interleaved layout: the pressure right-hand side is the
divergence of a nearly solenoidal u, which cancels) at worst.  Deeper, the
f32 recurrences part in either package: at 5 BiCGStab and 40 CG iterations
the channel's second step reads 4.0e-3 of max|u| between the port and JAX.

``test_steps_match_jax`` runs 3 steps from rest with the solves run to
convergence (CG and BiCGStab tol 1e-6).  There the f32 BiCGStab stops at
1e-6 of ||b|| (inflated by M/dt) after 15-20 (box) to 200-400 (bend)
iterations, and rounding, not the port, sets the fields apart: the JAX
package's own parity and interleaved layouts part after 3 steps by u
9.3e-5 / p 7.6e-5 on the box cavity, 1.1e-2 / 1.5e-3 on the channel and
0.28 / 9.4e-3 on the bend, and from one state the port and JAX read
1.0e-4 / 3.2e-4 of max|u| / max|p| on the box cavity's first step.  So
those fields (and monitors) are held within ``SPREAD_FACTOR`` times the
JAX package's own spread between its two layouts on that deck, never
looser than 5e-5 (measured, the port sits at 1.0-3.0 times that spread),
and the first step's CG count within one unroll group.

What holds the solves on the same inputs:
``test_momentum_solves_match_jax_on_the_same_inputs`` (the LHS planes and
the right-hand side against the JAX step's own, the port's BiCGStab against
the JAX package's at f64 on one operator and at f32 through the JAX kernel,
each at a fixed depth) and ``test_pressure_solves_match_jax_on_the_same_inputs``
(the port's CG run to JAX's count gives JAX's x, and the counts are equal
or the stop fell where the residual touches the bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd_with_cuda_tpu.ops import parity_stencil as jax_pstl
from cfd_with_cuda_tpu.ops.krylov import bicgstab as jax_bicgstab
from cfd_with_cuda_tpu.ops.pallas_cg import fused_cg as jax_fused_cg
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import implicit_state_from_jax
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops.krylov import bicgstab
from cfd_with_cuda_tpu_torch.ops.parity_stencil import parity_apply_plain
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig
from test_torch_box_decks_explicit import DECKS, _decks

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

BASE = dict(pressure_cg_tol=1e-6, steps_per_chunk=1)
# the step's two Krylov solves at a fixed depth: tol 0, maxiter the depth
MOM_DEPTH, CG_DEPTH = 2, 12
MOM_F64_DEPTH = 5
FIXED = dict(steps_per_chunk=1, pressure_cg_tol=0.0, pressure_cg_maxiter=CG_DEPTH,
             momentum_tol=0.0, momentum_abs_tol=0.0, momentum_maxiter=MOM_DEPTH)
N_STEPS = 3
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters",
               "mom_iters")
STEP_TOL = 5e-5             # of max|u| and max|p|, tests/test_parity_stencil.py:344-354
SPREAD_FACTOR = 4
CG_ITERS_TOL = 4            # one unroll group
LAYOUTS = ("parity", "interleaved")


def _solvers(name, layout, cfg):
    """(JAX solver, port solver) of one deck and layout under ``cfg``."""
    port_deck, jax_deck = _decks(name)
    js = JaxSolver(jax_deck, JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                                       setup_cache="off", structured_layout=layout, **cfg))
    ts = ImplicitGQSolver(port_deck, SolverConfig(dtype_policy=DTypePolicy.F32,
                                                  structured_layout=layout, **cfg),
                          device="cpu")
    return js, ts


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _run(name, layout):
    """The JAX solver's 3 steps (its jitted step, as tests/test_torch_implicit.py
    runs it) and the port's, each from rest, on one deck and layout."""
    js, ts = _solvers(name, layout, BASE)
    step = jax.jit(js._time_step)
    st = js.initial_state()
    rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(ts.initial_state(), n_steps=N_STEPS)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    return dict(js=js, ref_rows=np.asarray(rows), ref_fields=js.fields(st), ts=ts,
                rows=np.asarray([[h[f] for f in STAT_FIELDS] for h in hist]),
                fields=ts.fields(state))


@pytest.fixture(scope="module", params=sorted(DECKS))
def deck_runs(request):
    """One deck, both layouts, the solves run to convergence: {layout: run}
    and the JAX package's own spread (u, p) between its two layouts after
    the 3 steps."""
    runs = {layout: _run(request.param, layout) for layout in LAYOUTS}
    (u_a, p_a), (u_b, p_b) = (runs[lay]["ref_fields"] for lay in LAYOUTS)
    spread = (float(np.abs(u_a - u_b).max()), float(np.abs(p_a - p_b).max()))
    return request.param, runs, spread


def _carry_state(js_from, js_to, st):
    """A JAX state of ``js_from``'s layout on ``js_to``'s: u through the
    deck-order fields, p^k and p^{k-1} as they are (both layouts keep the
    pressure in the coarse grid's order)."""
    np.testing.assert_array_equal(js_from.perm_p, js_to.perm_p)
    u, _ = js_from.fields(st)
    uk = js_to.state_from_fields(u, np.zeros(js_to.nnp)).uk
    return type(st)(uk=uk, pk=st.pk, pk_prev=st.pk_prev)


def _record_momentum(js, ts):
    """Install recorders of the momentum solve's inputs on a JAX and a port
    parity solver; returns (records, undo).  Per step, ``records["jax_b"]``
    gets the JAX solve's (b, x0) and ``records["jax_a"]`` the LHS planes
    its BiCGStab applies to x0 for r0 (the first apply on the ``a_pairs``
    route after the solve starts; ``jax.debug.callback`` inside the jitted
    step); ``records["port"]`` gets dict(a_wc, b, x0, rhs_scale), with
    ``rhs_scale`` the larger of max|M u^k| and max|G (2 p^k - p^{k-1})|, the
    two terms whose difference is b."""
    from cfd_with_cuda_tpu_torch.ops import parity_stencil as port_pstl

    rec = {"jax_b": [], "jax_a": [], "port": []}
    pending = []
    jax_solve, port_solve, port_lhs = js._momentum_solver, ts._momentum_solver, ts._parity_lhs
    jax_apply, port_apply = jax_pstl.parity_apply, port_pstl.parity_apply

    def jax_solve_recorder(a_mul, b, x0=None, **kw):
        jax.debug.callback(lambda b, x0: rec["jax_b"].append((np.asarray(b), np.asarray(x0))),
                           b, x0)
        pending.append(True)
        return jax_solve(a_mul, b, x0=x0, **kw)

    def jax_apply_recorder(wc, x, **kw):
        if pending and kw.get("pairs") is js.a_pairs:
            pending.clear()
            jax.debug.callback(lambda w: rec["jax_a"].append(np.asarray(w)), wc)
        return jax_apply(wc, x, **kw)

    def port_lhs_recorder(d, uk_prev):
        a_wc = port_lhs(d, uk_prev)
        rec["port"].append(dict(a_wc=a_wc.numpy().copy(), rhs_scale=0.0))
        return a_wc

    def port_apply_recorder(wc, x, **kw):
        y = port_apply(wc, x, **kw)
        if kw.get("pairs") is ts.m_pairs or kw.get("pairs") is ts.g_pairs:
            last = rec["port"][-1]
            last["rhs_scale"] = max(last["rhs_scale"], float(y.abs().max()))
        return y

    def port_solve_recorder(a_mul, b, x0=None, **kw):
        rec["port"][-1].update(b=b.numpy().copy(), x0=x0.numpy().copy())
        return port_solve(a_mul, b, x0=x0, **kw)

    js._momentum_solver, ts._momentum_solver = jax_solve_recorder, port_solve_recorder
    ts._parity_lhs = port_lhs_recorder
    jax_pstl.parity_apply, port_pstl.parity_apply = jax_apply_recorder, port_apply_recorder

    def undo():
        jax_pstl.parity_apply, port_pstl.parity_apply = jax_apply, port_apply

    return rec, undo


@pytest.fixture(scope="module", params=sorted(DECKS))
def fixed_depth(request):
    """One deck, the solves at a fixed depth: {layout: run} of the steps
    taken from each state of the JAX solver's own 3 steps on the parity
    layout (carried to the interleaved layout), one JAX step and one port
    step on each layout (StepStats rows, deck-order fields); the parity
    run's ``momentum`` holds the momentum solves' inputs of both packages."""
    pair = {lay: _solvers(request.param, lay, FIXED) for lay in LAYOUTS}
    runs = {lay: dict(js=js, ts=ts, ref_rows=[], rows=[], ref_fields=[], fields=[])
            for lay, (js, ts) in pair.items()}
    step = {lay: jax.jit(pair[lay][0]._time_step) for lay in LAYOUTS}
    js_par, js_int = pair["parity"][0], pair["interleaved"][0]
    rec, undo = _record_momentum(*pair["parity"])
    st = js_par.initial_state()
    cuda_lib.reset_launch_counts()
    try:
        for _ in range(N_STEPS):
            start = dict(parity=st, interleaved=_carry_state(js_par, js_int, st))
            for lay, r in runs.items():
                nxt, stats = step[lay](r["js"].d, start[lay])
                carried = implicit_state_from_jax([np.asarray(a) for a in start[lay]])
                state, hist = r["ts"].run(carried, n_steps=1)
                r["ref_rows"].append([float(getattr(stats, f)) for f in STAT_FIELDS])
                r["rows"].append([hist[0][f] for f in STAT_FIELDS])
                r["ref_fields"].append(r["js"].fields(nxt))
                r["fields"].append(r["ts"].fields(state))
                if lay == "parity":
                    st_next = nxt
            st = st_next
    finally:
        undo()
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    for r in runs.values():
        r["ref_rows"], r["rows"] = np.asarray(r["ref_rows"]), np.asarray(r["rows"])
    runs["parity"]["momentum"] = rec
    return runs


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_follows_the_jax_rule(deck_runs, layout):
    name, runs, _ = deck_runs
    js, ts = runs[layout]["js"], runs[layout]["ts"]
    assert js.layout == ts.layout == layout
    assert js.structured and js.elem_structured
    assert (ts.nn, ts.nnp, ts.ppe_project) == (js.nn, js.nnp, js.ppe_project)
    np.testing.assert_array_equal(ts.perm, js.perm)
    np.testing.assert_array_equal(ts.perm_p, js.perm_p)
    # the outflow pressure nodes of the channel and the bend are held (p_mask 0)
    p_mask = ts.d["p_mask"].numpy()
    np.testing.assert_array_equal(p_mask, np.asarray(js.d["p_mask"])[: p_mask.size])
    assert (p_mask.min() == 0.0) == (name != "box")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fixed_depth_steps_match_jax(fixed_depth, layout):
    r = fixed_depth[layout]
    ref_rows, rows = r["ref_rows"], r["rows"]
    assert rows.shape == ref_rows.shape == (N_STEPS, len(STAT_FIELDS))
    np.testing.assert_array_equal(rows[:, 5:], ref_rows[:, 5:])
    np.testing.assert_array_equal(rows[:, 5:], [[1, CG_DEPTH, MOM_DEPTH]] * N_STEPS)
    for k, ((u_j, p_j), (u_t, p_t)) in enumerate(zip(r["ref_fields"], r["fields"])):
        u_max, p_max = np.abs(u_j).max(), np.abs(p_j).max()
        assert _rel(u_t, u_j) <= STEP_TOL, (k, _rel(u_t, u_j))
        assert _rel(p_t, p_j) <= STEP_TOL, (k, _rel(p_t, p_j))
        assert np.abs(rows[k, :3] - ref_rows[k, :3]).max() <= STEP_TOL * u_max
        assert abs(rows[k, 3] - ref_rows[k, 3]) <= STEP_TOL * p_max


@pytest.mark.parametrize("layout", LAYOUTS)
def test_steps_match_jax(deck_runs, layout):
    _, runs, (spread_u, spread_p) = deck_runs
    r = runs[layout]
    ref_rows, rows = r["ref_rows"], r["rows"]
    assert rows.shape == ref_rows.shape == (N_STEPS, len(STAT_FIELDS))
    np.testing.assert_array_equal(rows[:, 5], 1)
    assert (rows[:, 6] % 4 == 0).all() and (rows[:, 7] >= 1).all()
    assert abs(rows[0, 6] - ref_rows[0, 6]) <= CG_ITERS_TOL      # from rest
    (u_j, p_j), (u_t, p_t) = r["ref_fields"], r["fields"]
    assert np.isfinite(u_t).all() and np.isfinite(p_t).all()
    u_tol = max(STEP_TOL, SPREAD_FACTOR * spread_u)
    p_tol = max(STEP_TOL, SPREAD_FACTOR * spread_p)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=u_tol)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=p_tol)
    np.testing.assert_allclose(rows[:, :3], ref_rows[:, :3], rtol=0, atol=u_tol)
    np.testing.assert_allclose(rows[:, 3], ref_rows[:, 3], rtol=0, atol=p_tol)


def test_momentum_solves_match_jax_on_the_same_inputs(fixed_depth):
    """The momentum BiCGStab of the 3 fixed-depth steps on the parity layout,
    each from the JAX solver's state.  Its inputs: the LHS planes equal the
    JAX step's to 1e-6 of their largest value (read: 4.3e-8 at most), the
    right-hand side to 1e-6 of its larger term (read: 1.0e-7; M u^k and
    G (2 p^k - p^{k-1}) cancel in b, which on the bend's third step parts by
    1.6e-6 of max|b|).  The solve: on one operator (the port's plain apply,
    handed to JAX through ``jax.pure_callback``) widened to f64, the port's
    BiCGStab and the JAX package's give x within 1e-10 of max|x| after
    ``MOM_F64_DEPTH`` iterations (read: 1.3e-12 at most); at f32, the JAX
    kernel on the port's planes, within 1e-6 after ``MOM_DEPTH``.  Not to
    convergence: on the channel's second step (warm-started after the
    impulsive first) even the f64 recurrences part, from 1.3e-12 after 5
    iterations to 1.8e-8 after 10 and 1.9e-2 after 20."""
    r = fixed_depth["parity"]
    js, ts, rec = r["js"], r["ts"], r["momentum"]
    assert len(rec["jax_b"]) == len(rec["jax_a"]) == len(rec["port"]) == N_STEPS
    sp, pairs, diag = ts.sp_c, ts.a_pairs, list(ts.diag_planes)

    @jax.jit
    def jax_kernel_solve(a, b, x0, dg):
        mv = lambda x: jax_pstl.parity_apply(a, x.reshape(3, 8, sp), pairs=js.a_pairs,
                                             co=3).reshape(3, -1)
        return jax_bicgstab(mv, b, x0, precond=lambda r: r / dg, tol=0.0, atol=0.0,
                            maxiter=MOM_DEPTH).x

    for (b_j, x0_j), a_j, t in zip(rec["jax_b"], rec["jax_a"], rec["port"]):
        assert _rel(t["a_wc"], a_j) <= 1e-6
        assert np.abs(t["b"] - b_j).max() <= 1e-6 * t["rhs_scale"]
        np.testing.assert_array_equal(t["x0"], x0_j)

        def port_solve(dtype, depth):
            a = torch.from_numpy(t["a_wc"].astype(dtype))
            dg = a[0, diag].reshape(1, -1)
            mv = lambda x: parity_apply_plain(a, x.reshape(3, 8, sp), pairs=pairs,
                                              co=3).reshape(3, -1)
            b, x0 = (torch.from_numpy(t[k].astype(dtype)) for k in ("b", "x0"))
            out = bicgstab(mv, b, x0, precond=lambda r: r / dg, tol=0.0, atol=0.0,
                           maxiter=depth)
            assert int(out.iters) == depth
            return out.x.numpy(), mv, dg.numpy()

        x_t, mv, dg = port_solve(np.float64, MOM_F64_DEPTH)
        cb = lambda x: mv(torch.from_numpy(np.array(x))).numpy()
        mv_j = lambda x: jax.pure_callback(cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
        ref = jax_bicgstab(mv_j, jnp.asarray(t["b"].astype(np.float64)),
                           jnp.asarray(t["x0"].astype(np.float64)),
                           precond=lambda r: r / jnp.asarray(dg), tol=0.0, atol=0.0,
                           maxiter=MOM_F64_DEPTH)
        assert int(ref.iters) == MOM_F64_DEPTH
        assert _rel(x_t, np.asarray(ref.x)) <= 1e-10

        x_t, _, dg = port_solve(np.float32, MOM_DEPTH)
        x_j = jax_kernel_solve(jnp.asarray(t["a_wc"]), jnp.asarray(t["b"]),
                               jnp.asarray(t["x0"]), jnp.asarray(dg))
        assert _rel(x_t, np.asarray(x_j)) <= 1e-6


# where the two CGs stop at other counts on the same inputs, the port's
# recurrence residual at the JAX solver's count lies within this share of the
# bound: the stop falls where ||r|| touches tol ||b|| (on the bend's second
# step the port reads 1.10 tol at JAX's 76 iterations, then 1.8-3.3 tol until
# it crosses at 104)
STOP_BAND = 0.25


@pytest.mark.parametrize("name", sorted(DECKS))
def test_pressure_solves_match_jax_on_the_same_inputs(name):
    """The pressure solves of the port's first 2 steps (parity layout: from
    rest, then warm-started from the first increment), given to the JAX CG
    (the default loop, interpret mode) as they were given to the port's: the
    port's CG run to JAX's count gives JAX's x within 1e-5 of max|x| (two f32
    CGs whose dots sum in other orders), and the counts are equal or the
    stop fell in ``STOP_BAND``."""
    from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg_plain
    from cfd_with_cuda_tpu_torch.solvers import implicit_gq

    js, ts = _solvers(name, "parity", BASE)
    calls = []
    cg = implicit_gq.fused_cg

    def recorded(win, b, dinv, **kw):
        out = cg(win, b, dinv, **kw)
        calls.append((b.clone(), kw.get("x0"), int(out.iters)))
        return out

    implicit_gq.fused_cg = recorded
    try:
        ts.run(n_steps=2)
    finally:
        implicit_gq.fused_cg = cg
    assert len(calls) == 2 and calls[1][1] is not None
    tol = BASE["pressure_cg_tol"]
    for b, x0, iters in calls:
        out = jax_fused_cg(js.d["Z_win_cg"], jnp.asarray(b.numpy()), js.d["Z_dinv_cg"],
                           dims=js.coarse_dims, radius=js.z_radius, tol=tol, maxiter=1000,
                           x0=None if x0 is None else jnp.asarray(x0.numpy()), unroll=4)
        k = int(out.iters)
        at_k = fused_cg_plain(ts.d["Z_win"], b, ts.d["Z_dinv"], dims=ts.coarse_dims,
                              radius=ts.z_radius, tol=0.0, maxiter=k, x0=x0, unroll=4)
        x_j = np.asarray(out.x)[: b.numel()]
        assert np.abs(at_k.x.numpy() - x_j).max() <= 1e-5 * np.abs(x_j).max()
        if k != iters:
            ratio = float(at_k.residual) / (tol * float(b.norm()))
            assert abs(ratio - 1.0) <= STOP_BAND, (k, iters, ratio)
