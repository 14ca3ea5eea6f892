"""PyTorch port: the implicit Guermond-Quartapelle solver on the parity
path against the JAX solver on ``cavity_deck(4, viscosity=0.01, dt=0.01)``.

The setup tables must be bit-equal.  Over a few steps the two solvers agree
within the bounds the JAX package's own tests use between its two layouts
(``tests/test_parity_stencil.py:344-354``): u and p 5e-5, monitors 5e-5 /
rtol 2e-4, pressure-CG counts within one unroll group (4), BiCGStab counts
within 1.  They are not tighter because the f32 BiCGStab stops at a
residual of 1e-6 of ||b|| (inflated by M/dt): two implementations whose
dots sum in another order both meet that bound with solutions ~2e-5 apart.
In these runs the counts are in fact equal; the bounds above are what is
asserted.  The JAX solver runs its Pallas kernels in interpret mode; the
port runs the plain PyTorch versions of its kernels (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import (
    implicit_state_from_jax,
    implicit_tables_from_jax,
)
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

BASE = dict(pressure_cg_tol=1e-6, steps_per_chunk=1)
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters",
               "mom_iters")
U_TOL = P_TOL = MON_ATOL = 5e-5
MON_RTOL = 2e-4
CG_ITERS_TOL, MOM_ITERS_TOL = 4, 1


def _deck():
    return cavity_deck(4, viscosity=0.01, dt=0.01)


def _jax_solver(policy=JaxPolicy.F32, **kw):
    s = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.01),
        JaxConfig(dtype_policy=policy, pressure_backend="pallas", setup_cache="off",
                  **(BASE | kw)),
    )
    assert s.layout == "parity"
    return s


def _jax_run(js, n_steps, state=None):
    step = jax.jit(js._time_step)
    st = js.initial_state() if state is None else state
    rows = []
    for _ in range(n_steps):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    return np.asarray(rows), st


def _port_run(ts, n_steps, state=None):
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(ts.initial_state() if state is None else state, n_steps=n_steps)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    return np.asarray([[h[f] for f in STAT_FIELDS] for h in hist]), state


def _compare(js, ref_rows, ref_state, ts, rows, state):
    assert rows.shape == ref_rows.shape
    np.testing.assert_allclose(rows[:, :5], ref_rows[:, :5], atol=MON_ATOL, rtol=MON_RTOL)
    np.testing.assert_array_equal(rows[:, 5], 1)
    assert np.abs(rows[:, 6] - ref_rows[:, 6]).max() <= CG_ITERS_TOL
    assert np.abs(rows[:, 7] - ref_rows[:, 7]).max() <= MOM_ITERS_TOL
    assert (rows[:, 6] % 4 == 0).all()          # the default unroll
    u_j, p_j = js.fields(ref_state)
    u_t, p_t = ts.fields(state)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_TOL)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=P_TOL)
    return bool(np.array_equal(rows[:, 6:], ref_rows[:, 6:]))


@pytest.fixture(scope="module")
def reference():
    """The JAX F32 solver and its 3-step run: (solver, stats rows, final state)."""
    js = _jax_solver()
    rows, st = _jax_run(js, 3)
    return js, rows, st


@pytest.fixture(scope="module")
def port():
    return ImplicitGQSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **BASE),
                            device="cpu")


def _carried(js, cfg, sym=False):
    attrs = {k: getattr(js, k) for k in ImplicitGQSolver.STATIC_ATTRS}
    tables = implicit_tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs,
                                      sym=sym)
    return ImplicitGQSolver.from_tables(_deck(), cfg, tables, attrs, device="cpu")


def test_setup_tables_bit_equal(reference, port):
    js = reference[0]
    carried = _carried(js, port.config)
    for k in ("MKp", "Mp", "Gp", "GT_cwin", "conv_sel", "bc_mask_p", "bc_mask_e",
              "bc_vel_p", "gDSv_p", "gq_p", "Sv", "p_mask"):
        a, b = np.asarray(js.d[k]), port.d[k].numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the direct-assembly Z is a radius-1 window: 27 slots, not the product
    # operator's 125
    assert port.z_radius == js.z_radius == 1 and port.d["Z_win"].shape == (27, port.nnp)
    for k in ("Z_win", "Z_dinv"):
        np.testing.assert_array_equal(port.d[k].numpy(), carried.d[k].numpy(), err_msg=k)
    assert sorted(port.d) == sorted(carried.d)
    for k in ImplicitGQSolver.STATIC_ATTRS:
        a, b = getattr(js, k), getattr(port, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert a == b, k
    assert port.ppe_project is False


def test_assembled_operators_equal(reference, port):
    """z_mode="direct" (Z = -int grad Sp . grad Sp), the consistent mass
    scaled by 1/dt and K: equal arrays from both packages."""
    jo, to = reference[0].ops, port.ops
    np.testing.assert_array_equal(to.M, jo.M)
    np.testing.assert_array_equal(to.K, jo.K)
    np.testing.assert_array_equal(to.G, jo.G)
    zt, zj = to.Z.tocsr(), jo.Z.tocsr()
    np.testing.assert_array_equal(zt.indptr, zj.indptr)
    np.testing.assert_array_equal(zt.indices, zj.indices)
    np.testing.assert_array_equal(zt.data, zj.data)
    np.testing.assert_array_equal(to.K_csr().toarray(), jo.K_csr().toarray())
    assert (zt.diagonal() < 0).all()            # the implicit sign convention


def test_steps_match_jax_own_setup(reference, port):
    js, ref_rows, ref_state = reference
    rows, state = _port_run(port, 3)
    equal = _compare(js, ref_rows, ref_state, port, rows, state)
    print("iteration counts equal to the JAX solver's:", equal, rows[:, 6:].tolist())
    # the first cavity step's v and w right-hand sides are all zero off the
    # boundary: those columns stay finite through _safe_div
    assert np.isfinite(rows).all()


def test_steps_match_jax_carried_tables(reference, port):
    js, ref_rows, ref_state = reference
    ts = _carried(js, port.config)
    rows, state = _port_run(ts, 3)
    _compare(js, ref_rows, ref_state, ts, rows, state)


def test_state_from_jax_continues_the_run(reference, port):
    js, _, ref_state = reference
    carried = implicit_state_from_jax([np.asarray(a) for a in ref_state])
    assert [tuple(a.shape) for a in carried] == [tuple(np.shape(a)) for a in ref_state]
    ref_rows, ref_next = _jax_run(js, 1, ref_state)
    rows, nxt = _port_run(port, 1, carried)
    _compare(js, ref_rows, ref_next, port, rows, nxt)


def test_mixed_policy_steps_match_jax():
    """MIXED: f64 BiCGStab reductions and compensated CG dots, 2 steps."""
    js = _jax_solver(JaxPolicy.MIXED)
    ts = ImplicitGQSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.MIXED, **BASE),
                          device="cpu")
    assert ts.config.krylov_dot_dtype() is torch.float64
    ref_rows, ref_state = _jax_run(js, 2)
    rows, state = _port_run(ts, 2)
    _compare(js, ref_rows, ref_state, ts, rows, state)
    assert state.uk.dtype == torch.float32


def test_sym_half_window_steps_match_jax():
    """pressure_cg_sym: the stored table is the dq >= 0 half (14 of 27 slots),
    bit-equal to the JAX solver's, and 2 steps agree."""
    js = _jax_solver(pressure_cg_sym=True)
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_sym=True, **BASE)
    ts = ImplicitGQSolver(_deck(), cfg, device="cpu")
    assert ts.d["Z_win"].shape == (14, ts.nnp)
    np.testing.assert_array_equal(ts.d["Z_win"].numpy(),
                                  _carried(js, cfg, sym=True).d["Z_win"].numpy())
    ref_rows, ref_state = _jax_run(js, 2)
    rows, state = _port_run(ts, 2)
    _compare(js, ref_rows, ref_state, ts, rows, state)


def test_forced_ppe_project_matches_jax():
    """Both mean subtractions (RHS and increment), forced on after setup
    (a cavity's own gate measures no thru-flow)."""
    js = _jax_solver()
    ts = ImplicitGQSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **BASE),
                          device="cpu")
    assert js.ppe_project is False and ts.ppe_project is False
    js.ppe_project = ts.ppe_project = True
    ref_rows, ref_state = _jax_run(js, 2)
    rows, state = _port_run(ts, 2)
    _compare(js, ref_rows, ref_state, ts, rows, state)
    # every increment is mean-free now, so the pressure is (to f32 sums);
    # without the projection the pinned solve leaves a mean
    _, plain_state = _port_run(ImplicitGQSolver(_deck(), ts.config, device="cpu"), 2)
    mean, plain_mean = abs(float(state.pk.mean())), abs(float(plain_state.pk.mean()))
    assert mean <= 1e-7 and plain_mean >= 1e-5, (mean, plain_mean)


def test_outflow_faces_eliminate_pressure_rows_as_jax():
    """The outflow branch of the setup (homogeneous Dirichlet on the
    pressure increment at outflow nodes, symmetric row/column elimination
    keeping the diagonal) on a synthetic deck: eight wall faces of the
    cavity declared outflow in both packages.  The tables are bit-equal,
    ``ppe_project`` stays off, and the port's step holds the eliminated
    rows' increments at 0.  (A real open-boundary deck waits on the
    channel generator.)"""
    jd = jax_cavity_deck(4, viscosity=0.01, dt=0.01)
    td = _deck()
    faces = jd.bc_vel_faces[jd.bc_vel_faces[:, 1] == jd.bc_vel_faces[0, 1]][:8]
    jd.bc_out_faces, td.bc_out_faces = faces.copy(), faces.copy()
    js = JaxSolver(jd, JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                                 setup_cache="off", **BASE))
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, **BASE)
    ts = ImplicitGQSolver(td, cfg, device="cpu")
    carried = _carried(js, cfg)
    p_mask = ts.d["p_mask"].numpy()
    assert 0 < (p_mask == 0).sum() < ts.nnp and js.ppe_project is ts.ppe_project is False
    for k in ("p_mask", "Z_win", "Z_dinv", "MKp"):
        np.testing.assert_array_equal(ts.d[k].numpy(), carried.d[k].numpy(), err_msg=k)
    # an eliminated row keeps only its diagonal
    rows = np.flatnonzero(p_mask == 0)
    off_diag = np.delete(ts.d["Z_win"].numpy(), 13, axis=0)[:, rows]
    assert np.all(off_diag == 0.0)
    rows_run, state = _port_run(ts, 2)
    assert np.isfinite(rows_run).all()
    np.testing.assert_array_equal(state.pk.numpy()[rows], 0.0)


def test_state_from_fields_round_trip(reference, port):
    js = reference[0]
    rng = np.random.default_rng(8)
    u = rng.standard_normal((port.nn, 3)).astype(np.float32)
    p = rng.standard_normal(port.nnp).astype(np.float32)
    st = port.state_from_fields(u, p)
    ref = js.state_from_fields(u, p)
    assert st.uk.shape == (3, 8, port.sp_c)
    for a, b in zip(st, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.pk_prev.data_ptr() != st.pk.data_ptr()
    u2, p2 = port.fields(st)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(p2, p)


def test_runs_on_the_card_by_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImplicitGQSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **BASE))


# off the kernel path this box takes the JAX package's XLA structured path:
# F64, the XLA CG or the multigrid preconditioner (held at length in
# tests/test_torch_xla_solvers.py); 3 steps of this file's config with the
# choice, against the JAX solver: F64 at 1e-9 of max|u| and max|p| (that
# file's bound for the implicit step, with its reason), F32 at this file's
# bounds; equal CG counts, BiCGStab counts within MOM_ITERS_TOL
@pytest.mark.parametrize("override", [
    pytest.param(dict(dtype_policy=DTypePolicy.F64), id="f64"),
    pytest.param(dict(pressure_backend="xla"), id="xla"),
    pytest.param(dict(pressure_precond="mg"), id="mg"),
])
def test_xla_path_choices_match_jax(override):
    cfg = dict(dtype_policy=DTypePolicy.F32, **BASE) | override
    pol = cfg.pop("dtype_policy")
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.01),
                   JaxConfig(dtype_policy=JaxPolicy(pol.value), setup_cache="off", **cfg))
    ts = ImplicitGQSolver(_deck(), SolverConfig(dtype_policy=pol, **cfg), device="cpu")
    assert ts.xla and ts.use_mg and js.use_mg and ts.layout == js.layout == "interleaved"
    ref_rows, ref_state = _jax_run(js, 3)
    rows, state = _port_run(ts, 3)
    np.testing.assert_array_equal(rows[:, 6], ref_rows[:, 6])
    assert np.abs(rows[:, 7] - ref_rows[:, 7]).max() <= MOM_ITERS_TOL
    (u_j, p_j), (u_t, p_t) = js.fields(ref_state), ts.fields(state)
    if pol is DTypePolicy.F64:
        assert np.abs(u_t - u_j).max() <= 1e-9 * np.abs(u_j).max()
        assert np.abs(p_t - p_j).max() <= 1e-9 * np.abs(p_j).max()
    else:
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_TOL)
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=P_TOL)


# structured="never" runs (the ELL step: tests/test_torch_unstructured_implicit.py);
# spmd_devices runs (ROADMAP.md queue 1 item 11, ported: tests/test_torch_sharding.py)
# and, without a process group of that many ranks, raises the JAX package's
# make_mesh error rather than running on one device
@pytest.mark.parametrize("override,item,msg", [
    pytest.param(dict(spmd_devices=2), "2-device mesh", "devices are",
                 id="override6-queue 1 item 11"),
])
def test_other_branches_raise_with_roadmap_item(override, item, msg):
    cfg = dict(dtype_policy=DTypePolicy.F32, **BASE) | override
    with pytest.raises(ValueError, match=item) as err:
        ImplicitGQSolver(_deck(), SolverConfig(**cfg), device="cpu")
    assert err.match(msg)


def test_gmres_momentum_solver_raises_the_reference_defect():
    """``momentum_solver="gmres"``: the JAX package's implicit step fails with
    it on every path (``tests/test_torch_legacy_momentum.py`` shows the JAX
    failure), so the port refuses it when the solver is built."""
    cfg = dict(dtype_policy=DTypePolicy.F32, **BASE, momentum_solver="gmres")
    with pytest.raises(ValueError, match="reference defect") as err:
        ImplicitGQSolver(_deck(), SolverConfig(**cfg), device="cpu")
    assert err.match("ops/krylov.py:441") and err.match("implicit_gq.py:752")


# setup_cache="auto" (ROADMAP.md queue 1 item 8, ported): a miss, then a hit
def test_setup_cache_auto_misses_then_hits(tmp_path, monkeypatch):
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", str(tmp_path))
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, setup_cache="auto", **BASE)
    hits = [ImplicitGQSolver(_deck(), cfg, device="cpu").setup_cache_hit for _ in range(2)]
    assert hits == [False, True]


def test_steady_flag_stops_the_run():
    deck = _deck()
    deck.convergence_criteria = 1e6           # steady after the first step
    ts = ImplicitGQSolver(deck, SolverConfig(dtype_policy=DTypePolicy.F32, **BASE),
                          device="cpu")
    _, hist = ts.run(n_steps=4)
    assert len(hist) == 1 and hist[0]["max_acc"] <= 1e6 and hist[0]["mom_iters"] >= 1


def test_cg_trace_tool_traces_a_step_and_restores_the_solver(monkeypatch, capsys):
    """``python -m cfd_with_cuda_tpu_torch.cg_trace`` on the CPU: one JSON
    line per traced step with ||r|| / bound falling with k, both columns
    equal (on CPU tensors the wrapper IS the plain version), the first k at
    or below the bound equal to the step's own count, and the solver
    module's ``fused_cg`` put back."""
    import json
    import sys

    from cfd_with_cuda_tpu_torch import cg_trace
    from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg
    from cfd_with_cuda_tpu_torch.solvers import implicit_gq

    monkeypatch.setattr(sys, "argv", [
        "cg_trace", "--deck-n", "4", "--from-rest", "1", "--steps", "1",
        "--from-k", "4", "--to-k", "40", "--device", "cpu"])
    cg_trace.main()
    assert implicit_gq.fused_cg is fused_cg
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert out["k"] == list(range(4, 41, 4))
    for mode in ("compensated", "plain"):
        rec = out[mode]
        assert rec["kernel"] == rec["plain"] and rec["max_rel_dev"] == 0.0
        assert rec["kernel"][0] > 1.0 > rec["kernel"][-1]
    # the traced step ran MIXED: its count is the compensated trace's crossing
    assert out["compensated"]["stop_kernel"] == out["cg_iters"]
