"""PyTorch port: the implicit GQ solver on the interleaved structured layout
against the JAX solver on ``cavity_deck(4, viscosity=0.01, dt=0.01)``.

The JAX solver runs its kernel path (``pressure_backend="pallas"``, Pallas in
interpret mode); the port runs the plain PyTorch versions of its kernels
(CPU tensors).  The setup tables must be bit-equal.  Over 3 steps the
bounds are the JAX package's own between its two layouts
(``tests/test_parity_stencil.py:344-354``): u and p 5e-5, monitors 5e-5 /
rtol 2e-4, pressure-CG counts within one unroll group (4), BiCGStab counts
within 1 (the f32 BiCGStab stops at 1e-6 of ||b||, which two summation
orders meet with solutions ~2e-5 apart; see ``tests/test_torch_implicit.py``).

Covered: F32 on the port's own setup and on the JAX solver's tables carried
across, MIXED and ``pressure_cg_sym``; and the fallback from the parity
layout to the interleaved one that both packages take on a one-element-thin
box between opposing walls, where the per-step parity LHS assembly cannot
route (``implicit_gq.py:589-598``).
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
    implicit_interleaved_tables_from_jax,
    implicit_state_from_jax,
)
from cfd_with_cuda_tpu_torch.mesh.generators import _boundary_faces, cavity_deck, cube_hex_mesh
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

BASE = dict(dtype_policy="f32", pressure_cg_tol=1e-6, steps_per_chunk=1)
INTERLEAVED = dict(BASE, structured_layout="interleaved")
N_STEPS = 3
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters",
               "mom_iters")
U_TOL = P_TOL = MON_ATOL = 5e-5
MON_RTOL = 2e-4
CG_ITERS_TOL, MOM_ITERS_TOL = 4, 1


def _deck():
    return cavity_deck(4, viscosity=0.01, dt=0.01)


def _configs(cfg):
    pol = cfg["dtype_policy"]
    rest = {k: v for k, v in cfg.items() if k != "dtype_policy"}
    jax_rest = dict(pressure_backend="pallas", setup_cache="off") | rest
    return (JaxConfig(dtype_policy=JaxPolicy(pol), **jax_rest),
            SolverConfig(dtype_policy=DTypePolicy(pol), **rest))


def _jax_run(js, n_steps=N_STEPS, state=None, step=None):
    step = step or jax.jit(js._time_step)
    st = js.initial_state() if state is None else state
    rows = []
    for _ in range(n_steps):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    return np.asarray(rows), st


def _port_run(ts, n_steps=N_STEPS, state=None):
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(ts.initial_state() if state is None else state, n_steps=n_steps)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    return np.asarray([[h[f] for f in STAT_FIELDS] for h in hist]), state


def _compare(js, ref, ts, got, scale_u=1.0, scale_p=1.0):
    (ref_rows, ref_state), (rows, state) = ref, got
    assert rows.shape == ref_rows.shape
    np.testing.assert_allclose(rows[:, :5], ref_rows[:, :5], atol=MON_ATOL, rtol=MON_RTOL)
    np.testing.assert_array_equal(rows[:, 5], 1)
    assert np.abs(rows[:, 6] - ref_rows[:, 6]).max() <= CG_ITERS_TOL
    assert np.abs(rows[:, 7] - ref_rows[:, 7]).max() <= MOM_ITERS_TOL
    assert (rows[:, 6] % 4 == 0).all()          # the default unroll
    u_j, p_j = js.fields(ref_state)
    u_t, p_t = ts.fields(state)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_TOL * scale_u)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=P_TOL * scale_p)


def _carried(js, cfg, deck=None, sym=False):
    attrs = {k: getattr(js, k) for k in ImplicitGQSolver.INTERLEAVED_STATIC_ATTRS}
    attrs["layout"] = "interleaved"
    tables = implicit_interleaved_tables_from_jax(
        {k: np.asarray(v) for k, v in js.d.items()}, attrs, sym=sym)
    return ImplicitGQSolver.from_tables(deck or _deck(), cfg, tables, attrs, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX interleaved F32 solver, its 3-step run and its jitted step."""
    jcfg, _ = _configs(INTERLEAVED)
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.01), jcfg)
    assert js.layout == "interleaved"
    step = jax.jit(js._time_step)
    return js, _jax_run(js, step=step), step


@pytest.fixture(scope="module")
def port():
    ts = ImplicitGQSolver(_deck(), _configs(INTERLEAVED)[1], device="cpu")
    assert ts.layout == "interleaved"
    return ts


def test_setup_tables_bit_equal(reference, port):
    js = reference[0]
    carried = _carried(js, port.config)
    for k in ("MK_vals", "M_vals", "row_mask_grid", "diag_add_grid", "G_win", "GT_win",
              "GT_cwin", "bc_mask", "bc_vel", "Sv", "gDSv", "gq", "p_mask"):
        a, b = np.asarray(js.d[k]), port.d[k].numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # padding rows carry the unit diagonal that keeps the Jacobi division finite
    assert (port.d["diag_add_grid"][port.nn:] == 1.0).all() and port.s_pad > port.nn
    for k in ("Z_win", "Z_dinv"):
        np.testing.assert_array_equal(port.d[k].numpy(), carried.d[k].numpy(), err_msg=k)
    assert port.d["Z_win"].shape == (27, port.nnp)
    assert sorted(port.d) == sorted(carried.d)
    for k in ImplicitGQSolver.INTERLEAVED_STATIC_ATTRS:
        a, b = getattr(js, k), getattr(port, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert a == b, k


def test_steps_match_jax_own_setup(reference, port):
    js, ref, _ = reference
    got = _port_run(port)
    assert np.isfinite(got[0]).all()
    _compare(js, ref, port, got)


def test_steps_match_jax_carried_tables(reference, port):
    js, ref, _ = reference
    ts = _carried(js, port.config)
    _compare(js, ref, ts, _port_run(ts))


def test_state_from_jax_continues_the_run(reference, port):
    """A JAX (3, s_pad) state carried across and stepped once by the port
    against the JAX solver stepping it."""
    js, (_, ref_state), step = reference
    carried = implicit_state_from_jax([np.asarray(a) for a in ref_state])
    assert tuple(carried.uk.shape) == (3, port.s_pad)
    ref = _jax_run(js, 1, ref_state, step)
    _compare(js, ref, port, _port_run(port, 1, carried))


def test_state_from_fields_round_trip(reference, port):
    js = reference[0]
    rng = np.random.default_rng(8)
    u = rng.standard_normal((port.nn, 3)).astype(np.float32)
    p = rng.standard_normal(port.nnp).astype(np.float32)
    st, ref = port.state_from_fields(u, p), js.state_from_fields(u, p)
    assert st.uk.shape == (3, port.s_pad)
    for a, b in zip(st, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u2, p2 = port.fields(st)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(p2, p)


@pytest.mark.parametrize("case", ["mixed", "sym"])
def test_other_cg_modes_match_jax(case):
    """MIXED (f64 BiCGStab reductions, compensated CG dots) and the half
    window (14 of 27 slots, bit-equal to the JAX solver's), 2 steps."""
    extra = dict(dtype_policy="mixed") if case == "mixed" else dict(pressure_cg_sym=True)
    jcfg, tcfg = _configs(INTERLEAVED | extra)
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.01), jcfg)
    ts = ImplicitGQSolver(_deck(), tcfg, device="cpu")
    assert js.layout == ts.layout == "interleaved"
    if case == "sym":
        assert ts.d["Z_win"].shape == (14, ts.nnp)
        np.testing.assert_array_equal(ts.d["Z_win"].numpy(),
                                      _carried(js, tcfg, sym=True).d["Z_win"].numpy())
    _compare(js, _jax_run(js, 2), ts, _port_run(ts, 2))
    assert ts.d["MK_vals"].dtype == torch.float32


def _thin_box(make_deck):
    """A 4 x 1 x 4 cavity built from the port's ``cube_hex_mesh``: one element
    across between the no-slip walls at y = 0 and y = 0.25, lid at z = 1.
    Every node of the even fine y rows is a wall node, so Dirichlet masking
    zeroes whole (class, offset) planes of the parity LHS."""
    deck = make_deck(4, viscosity=0.1, dt=0.01)
    coords, conn = cube_hex_mesh(5, 2, 5, lengths=(1.0, 0.25, 1.0))
    fb = _boundary_faces((4, 1, 4))
    walls = np.concatenate([fb[k] for k in ("zmin", "ymin", "xmax", "ymax", "xmin")])
    lid = fb["zmax"]
    deck.coords, deck.conn = coords, conn
    deck.ne, deck.ncn = conn.shape[0], coords.shape[0]
    deck.bc_vel_faces = np.concatenate([
        np.column_stack([walls, np.zeros(len(walls), np.int64)]),
        np.column_stack([lid, np.ones(len(lid), np.int64)]),
    ]).astype(np.int64)
    deck.zero_pressure_node = int(np.argmin(((coords - [0.5, 0.0, 0.0]) ** 2).sum(axis=1)))
    deck.monitor_xyz = np.array([0.5, 0.125, 0.5])
    return deck


def test_thin_box_falls_back_to_interleaved_as_jax_does():
    jcfg, tcfg = _configs(BASE)
    js = JaxSolver(_thin_box(jax_cavity_deck), jcfg)
    assert js.structured and js.layout == "interleaved"
    ts = ImplicitGQSolver(_thin_box(cavity_deck), tcfg, device="cpu")
    assert ts.layout == "interleaved"
    ref = _jax_run(js)
    # the lid speed 1 and a pressure of order 1: the bounds stay absolute
    _compare(js, ref, ts, _port_run(ts))
    carried = _carried(js, tcfg, deck=_thin_box(cavity_deck))
    for k in ("MK_vals", "diag_add_grid", "GT_cwin", "Z_win"):
        np.testing.assert_array_equal(carried.d[k].numpy(), ts.d[k].numpy(), err_msg=k)
    # structured_layout="parity" there raises the JAX package's own error
    jcfg, tcfg = _configs(dict(BASE, structured_layout="parity"))
    with pytest.raises(ValueError, match="structured_layout='parity'"):
        JaxSolver(_thin_box(jax_cavity_deck), jcfg)
    with pytest.raises(ValueError, match="structured_layout='parity'"):
        ImplicitGQSolver(_thin_box(cavity_deck), tcfg, device="cpu")


# off the kernel path a box mesh is the JAX package's XLA structured path, whose
# layout is the interleaved one: 3 steps with the choice, against the JAX solver
# (F64 at 1e-9 of max|u| and max|p|, the implicit bound of tests/test_torch_xla_solvers.py, F32 at this file's bounds;
# equal CG counts, BiCGStab counts within MOM_ITERS_TOL)
@pytest.mark.parametrize("override", [
    pytest.param(dict(dtype_policy="f64"), id="f64"),
    pytest.param(dict(pressure_backend="xla"), id="xla"),
    pytest.param(dict(pressure_precond="mg"), id="mg"),
])
def test_xla_path_choices_match_jax_on_the_interleaved_layout(override):
    jcfg, tcfg = _configs(dict(INTERLEAVED, **override))
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.01), jcfg)
    ts = ImplicitGQSolver(_deck(), tcfg, device="cpu")
    assert ts.xla and ts.use_mg and js.use_mg and ts.layout == js.layout == "interleaved"
    (ref_rows, ref_state), (rows, state) = _jax_run(js), _port_run(ts)
    np.testing.assert_array_equal(rows[:, 6], ref_rows[:, 6])
    assert np.abs(rows[:, 7] - ref_rows[:, 7]).max() <= MOM_ITERS_TOL
    tol = (1e-9, 1e-9) if override.get("dtype_policy") == "f64" else None
    (u_j, p_j), (u_t, p_t) = js.fields(ref_state), ts.fields(state)
    if tol:
        assert np.abs(u_t - u_j).max() <= tol[0] * np.abs(u_j).max()
        assert np.abs(p_t - p_j).max() <= tol[1] * np.abs(p_j).max()
    else:
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_TOL)
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=P_TOL)
