"""PyTorch port: both solvers on the XLA structured path of a box mesh.

This is the JAX package's default configuration, ``SolverConfig()``: F64,
``pressure_precond="auto"``, off the kernel path, so DIA / window-patches
applies, the torch CG and the multigrid V-cycle.  Held here:

* F64 ``SolverConfig(steps_per_chunk=5)`` on ``cavity_deck(3, viscosity=0.1,
  dt=0.005)``: 10 explicit steps against ``oracle/explicit_oracle.py`` at
  ``tests/test_explicit_solver.py:22-32``'s 1e-12 / 1e-11 with equal
  sub-iteration counts; the implicit config of
  ``tests/test_implicit_solver.py:13-18`` against ``oracle/implicit_oracle.py``
  at its 5e-8 / 5e-6; both against the JAX solver (on the port's own setup
  and on the JAX solver's tables carried across by ``interop``) at 1e-12 of
  max|u| and max|p| with equal sub-iteration, CG and BiCGStab counts, and
  every setup table bit for bit (the multigrid levels included);
* the stored f64 NE27000 run's config (CG tol 1e-6, warm start) against the
  JAX solver on clustered cavities whose V-cycles smooth on two and on three
  levels (NE27000's depth): the monitor of every step at 1e-12 of itself and
  every CG count equal;
* ``"mg"`` against ``"jacobi"`` on ``cavity_deck(6)``, as
  ``tests/test_multigrid.py:95-143`` holds the JAX package;
* F32 and MIXED with ``pressure_backend="xla"`` against the JAX solver at
  the bounds the port's other tests use for each solver and precision;
* the chunked loop's ``test_partial_final_chunk_matches_exact_total`` and
  ``test_steady_flag_carries_across_chunks`` in the default config;
* the 5 x 3 x 4-element box (``box_cavity_deck``) in F64 against both
  oracles;
* ``implicit_warm_start=False`` (the reference's zero initial guesses) in
  F64 against the JAX solver and the oracle, on the box path and the ELL
  path.

The JAX side runs its XLA ops on the CPU (no Pallas).
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.oracle.explicit_oracle import ExplicitOracle
from cfd_with_cuda_tpu.oracle.implicit_oracle import ImplicitOracle
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import implicit_xla_tables_from_jax, xla_tables_from_jax
from cfd_with_cuda_tpu_torch.mesh.generators import box_cavity_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

EXPLICIT_DECK = dict(viscosity=0.1, dt=0.005, t_final=1.0)
IMPLICIT_DECK = dict(viscosity=0.1, dt=0.01, t_final=1.0)
IMPLICIT_CFG = dict(steps_per_chunk=5, pressure_cg_tol=1e-10, momentum_tol=1e-10)
N_EXPLICIT, N_IMPLICIT = 10, 5
# two f64 implementations of one algorithm, summing in different orders: the
# explicit step at 1e-12 of max|u| and max|p|.  The implicit step's BiCGStab
# at tol 1e-10 amplifies rounding: the JAX solver's own fields move by
# 1.3e-11 of max|u| in one step when its state moves by 1e-15 (cavity_deck(3),
# dt 0.01, after two steps), and over the 4 steps after step 1 by 5.5e-11 to
# 4.2e-10 of max|u| and 6.0e-11 to 3.6e-10 of max|p| (ten seeded 1e-15
# changes of u after step 1; two of the ten over 1e-10).  The port's
# elemental matrices part from the JAX package's by 2e-18 of 3e-3, its
# einsums summing in another order, and its fields read 8.3e-11 / 9.0e-11
# from the JAX solver's after 5 steps, inside that spread.  So the implicit
# bound is 1e-9, 2.4 times the largest spread, 50 times under the oracle's
# 5e-8 (1e-10 would sit under the JAX package's own spread)
JAX_TOL = 1e-12
IMPLICIT_JAX_TOL = 1e-9
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters",
               "mom_iters")


def _rows(hist):
    return np.asarray([[h[f] for f in STAT_FIELDS] for h in hist])


def _jax_box_deck(**kw):
    """The JAX package's counterpart of ``box_cavity_deck(**kw)``: its
    ``cavity_deck`` with the port deck's box mesh, faces and nodes."""
    port = box_cavity_deck(**kw)
    deck = jax_cavity_deck(5, lid_velocity=(1.0, 0.3, 0.0), **kw)
    for k in ("title", "coords", "conn", "ne", "ncn", "bc_vel_faces", "zero_pressure_node",
              "monitor_xyz"):
        setattr(deck, k, getattr(port, k))
    return deck


def _same_fields(u_a, p_a, u_b, p_b, tol=JAX_TOL):
    assert np.abs(u_a - u_b).max() <= tol * np.abs(u_b).max()
    assert np.abs(p_a - p_b).max() <= tol * np.abs(p_b).max()


def _same_attrs(a, b, names):
    for k in names:
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def _xla_attrs(js, cls):
    return {k: getattr(js, k, None) for k in cls.XLA_STATIC_ATTRS} | {
        "layout": "interleaved", "xla": True}


def _carried(js, cls, tables_from_jax, deck, cfg):
    attrs = _xla_attrs(js, cls)
    tables = tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs)
    return cls.from_tables(deck, cfg, tables, attrs, device="cpu")


def _jax_run(js, n):
    """``n`` steps of the JAX solver through its jitted step (one compile,
    shorter than its chunk's): (final state, rows)."""
    step = jax.jit(js._time_step)
    st, rows = js.initial_state(), []
    for _ in range(n):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    return st, np.asarray(rows)


def _port_run(ts, n):
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(n_steps=n)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())    # torch ops only
    return state, hist


# ---------------------------------------------------------------- explicit

@pytest.fixture(scope="module")
def explicit_ref():
    """The JAX solver in its default config, its 10-step run, and the oracle's."""
    deck = jax_cavity_deck(3, **EXPLICIT_DECK)
    js = JaxExplicit(deck, JaxConfig(steps_per_chunk=5, setup_cache="off"))
    assert js.structured and js.use_mg and js.f64_dia and js.layout == "interleaved"
    state, rows = _jax_run(js, N_EXPLICIT)
    u_o, p_o, oh = ExplicitOracle(deck).run(N_EXPLICIT)
    return js, rows, js.fields(state), (u_o, p_o, [it for _, it in oh])


@pytest.fixture(scope="module")
def explicit_port():
    ts = ExplicitBCHSolver(cavity_deck(3, **EXPLICIT_DECK), SolverConfig(steps_per_chunk=5),
                           device="cpu")
    assert ts.layout == "interleaved" and ts.xla and ts.use_mg and ts.f64_dia
    return ts


def test_explicit_default_config_matches_oracle(explicit_ref, explicit_port):
    u_o, p_o, o_iters = explicit_ref[3]
    state, hist = _port_run(explicit_port, N_EXPLICIT)
    u, p = explicit_port.fields(state)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p, p_o, rtol=0, atol=1e-11)
    assert [int(h["iters"]) for h in hist] == o_iters


def test_explicit_setup_tables_bit_equal(explicit_ref, explicit_port):
    js = explicit_ref[0]
    carried = _carried(js, ExplicitBCHSolver, xla_tables_from_jax, explicit_port.deck,
                       explicit_port.config)
    assert set(carried.d) == set(explicit_port.d)
    assert "mg_zinv" in carried.d          # 4^3 coarse nodes: the dense inverse alone
    for k, v in carried.d.items():
        np.testing.assert_array_equal(v.numpy(), explicit_port.d[k].numpy(), err_msg=k)
    _same_attrs(explicit_port, carried, ExplicitBCHSolver.XLA_STATIC_ATTRS)


@pytest.mark.parametrize("tables", ["own", "carried"])
def test_explicit_matches_jax(explicit_ref, explicit_port, tables):
    js, ref_rows, (u_j, p_j), _ = explicit_ref
    ts = explicit_port if tables == "own" else _carried(
        js, ExplicitBCHSolver, xla_tables_from_jax, explicit_port.deck, explicit_port.config)
    state, hist = _port_run(ts, N_EXPLICIT)
    rows = _rows(hist)
    np.testing.assert_array_equal(rows[:, 5:], ref_rows[:, 5:])        # sub-iterations, CG
    u, p = ts.fields(state)
    _same_fields(u, p, u_j, p_j)


def _stored_run_config_vs_jax(n, levels, steps):
    """``steps`` steps of the stored run's config on ``cavity_deck(n,
    cluster=2.0)`` in both packages, whose V-cycle smooths on ``levels``
    levels: the monitor at every step to 1e-12 of itself, every CG count
    equal, the fields at JAX_TOL."""
    kw = dict(pressure_cg_tol=1e-6, pressure_warm_start=True, steps_per_chunk=5)
    js = JaxExplicit(jax_cavity_deck(n, cluster=2.0, viscosity=0.01, dt=0.001),
                     JaxConfig(setup_cache="off", **kw))
    ts = ExplicitBCHSolver(cavity_deck(n, cluster=2.0, viscosity=0.01, dt=0.001),
                           SolverConfig(**kw), device="cpu")
    assert ts.mg_dims == js.mg_dims and len(ts.mg_radii) == levels
    j_state, ref = _jax_run(js, steps)
    state, hist = _port_run(ts, steps)
    rows = _rows(hist)
    np.testing.assert_array_equal(rows[:, 5:], ref[:, 5:])
    assert (np.abs(rows[:, 0] - ref[:, 0]) <= JAX_TOL * np.abs(ref[:, 0])).all()
    _same_fields(*ts.fields(state), *js.fields(j_state))


def test_explicit_stored_run_config_matches_jax():
    """The config of the stored f64 NE27000 run (``scripts/precision_parity.py
    :67-76``: CG tol 1e-6, warm start, chunks of 5, multigrid) on a clustered
    cavity whose V-cycle has two levels, over 10 steps: the yardstick the
    card's run is held to through the port's CPU path (``chip_smoke.py``
    phase 9, PERF.md section 6)."""
    _stored_run_config_vs_jax(8, 2, N_EXPLICIT)


def test_explicit_stored_run_config_matches_jax_at_ne27000_depth():
    """The same on ``cavity_deck(16)``, whose ladder (17, 9, 5, then a dense
    3^3 solve) has NE27000's depth (31, 16, 8, then 4^3): three smoothed
    levels, over one chunk."""
    _stored_run_config_vs_jax(16, 3, 5)


# ---------------------------------------------------------------- implicit

@pytest.fixture(scope="module")
def implicit_ref():
    deck = jax_cavity_deck(3, **IMPLICIT_DECK)
    js = JaxImplicit(deck, JaxConfig(setup_cache="off", **IMPLICIT_CFG))
    assert js.structured and js.use_mg and js.f64_dia and js.layout == "interleaved"
    state, rows = _jax_run(js, N_IMPLICIT)
    u_o, p_o, _ = ImplicitOracle(deck).run(N_IMPLICIT)
    return js, rows, js.fields(state), (u_o, p_o)


@pytest.fixture(scope="module")
def implicit_port():
    ts = ImplicitGQSolver(cavity_deck(3, **IMPLICIT_DECK), SolverConfig(**IMPLICIT_CFG),
                          device="cpu")
    assert ts.layout == "interleaved" and ts.xla and ts.use_mg and ts.f64_dia
    return ts


def test_implicit_default_config_matches_oracle(implicit_ref, implicit_port):
    u_o, p_o = implicit_ref[3]
    state, hist = _port_run(implicit_port, N_IMPLICIT)
    u, p = implicit_port.fields(state)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=5e-8)
    np.testing.assert_allclose(p, p_o, rtol=0, atol=5e-6)
    assert all(h["mom_iters"] > 0 and h["cg_iters"] > 0 for h in hist)


def test_implicit_setup_tables_bit_equal(implicit_ref, implicit_port):
    js = implicit_ref[0]
    carried = _carried(js, ImplicitGQSolver, implicit_xla_tables_from_jax, implicit_port.deck,
                       implicit_port.config)
    assert set(carried.d) == set(implicit_port.d)
    for k, v in carried.d.items():
        np.testing.assert_array_equal(v.numpy(), implicit_port.d[k].numpy(), err_msg=k)
    _same_attrs(implicit_port, carried, ImplicitGQSolver.XLA_STATIC_ATTRS)


@pytest.mark.parametrize("tables", ["own", "carried"])
def test_implicit_matches_jax(implicit_ref, implicit_port, tables):
    js, ref_rows, (u_j, p_j), _ = implicit_ref
    ts = implicit_port if tables == "own" else _carried(
        js, ImplicitGQSolver, implicit_xla_tables_from_jax, implicit_port.deck,
        implicit_port.config)
    state, hist = _port_run(ts, N_IMPLICIT)
    rows = _rows(hist)
    np.testing.assert_array_equal(rows[:, 5:], ref_rows[:, 5:])        # CG, BiCGStab
    u, p = ts.fields(state)
    _same_fields(u, p, u_j, p_j, IMPLICIT_JAX_TOL)


# ---------------------------------------------------------------- both solvers

@pytest.mark.parametrize("solver", ["explicit", "implicit"])
def test_mg_matches_jacobi(solver):
    """Three steps with ``pressure_precond="mg"`` reproduce the ``"jacobi"``
    monitors within the CG tolerance, with fewer CG iterations each step
    (``tests/test_multigrid.py:95-143``'s bounds)."""
    cls = ExplicitBCHSolver if solver == "explicit" else ImplicitGQSolver
    u_tol, p_tol = (1e-8, 1e-7) if solver == "explicit" else (1e-7, 1e-6)

    def run(precond):
        cfg = SolverConfig(pressure_precond=precond, pressure_cg_tol=1e-12, steps_per_chunk=1)
        ts = cls(cavity_deck(6, viscosity=0.01, dt=2e-3, t_final=1.0), cfg, device="cpu")
        assert ts.xla and ts.use_mg == (precond == "mg")
        return _port_run(ts, 3)[1]

    for a, b in zip(run("jacobi"), run("mg")):
        assert b["cg_iters"] < a["cg_iters"]
        np.testing.assert_allclose(a["u_mon"], b["u_mon"], atol=u_tol)
        np.testing.assert_allclose(a["p_mon"], b["p_mon"], atol=p_tol)


# f32 state through the XLA path: the bounds of the port's kernel-path tests
# for each solver (tests/test_torch_interleaved_{explicit,implicit}.py)
F32_CASES = {
    "explicit": dict(dt=0.001, cfg=dict(pressure_cg_tol=1e-6, pressure_warm_start=True),
                     u=5e-6, p=5e-5, cg=0, mom=0),
    "implicit": dict(dt=0.01, cfg=dict(pressure_cg_tol=1e-6), u=5e-5, p=5e-5, cg=4, mom=1),
}


@pytest.mark.parametrize("policy", ["f32", "mixed"])
@pytest.mark.parametrize("solver", ["explicit", "implicit"])
def test_f32_xla_backend_matches_jax(solver, policy):
    case = F32_CASES[solver]
    jcls, tcls = ((JaxExplicit, ExplicitBCHSolver) if solver == "explicit"
                  else (JaxImplicit, ImplicitGQSolver))
    kw = dict(pressure_backend="xla", steps_per_chunk=1, **case["cfg"])
    js = jcls(jax_cavity_deck(4, viscosity=0.01, dt=case["dt"]),
              JaxConfig(dtype_policy=JaxPolicy(policy), setup_cache="off", **kw))
    ts = tcls(cavity_deck(4, viscosity=0.01, dt=case["dt"]),
              SolverConfig(dtype_policy=DTypePolicy(policy), **kw), device="cpu")
    assert ts.xla and ts.use_mg and not ts.f64_dia and "G_win" in ts.d
    st, ref = _jax_run(js, 3)
    state, hist = _port_run(ts, 3)
    rows = _rows(hist)
    np.testing.assert_array_equal(rows[:, 5], ref[:, 5])
    assert np.abs(rows[:, 6] - ref[:, 6]).max() <= case["cg"]
    assert np.abs(rows[:, 7] - ref[:, 7]).max() <= case["mom"]
    u_j, p_j = js.fields(st)
    u, p = ts.fields(state)
    np.testing.assert_allclose(u, u_j, rtol=0, atol=case["u"])
    np.testing.assert_allclose(p, p_j, rtol=0, atol=case["p"])


def test_partial_final_chunk_matches_exact_total():
    """``run(n_steps=N)`` with N not a chunk multiple runs exactly N steps
    (``tests/test_explicit_solver.py:119-132`` in the default config)."""
    deck = cavity_deck(2, viscosity=0.1, dt=0.005, t_final=1.0)
    s_big = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=10), device="cpu")
    s_one = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=1), device="cpu")
    assert s_big.xla
    st_big, h_big = s_big.run(n_steps=23)
    st_one, h_one = s_one.run(n_steps=23)
    assert len(h_big) == len(h_one) == 23
    for a, b in zip(s_big.fields(st_big), s_one.fields(st_one)):
        np.testing.assert_array_equal(a, b)


def test_steady_flag_carries_across_chunks():
    """After the steady stop later chunks are monitor-only: the final state
    is the state at the steady step (``tests/test_explicit_solver.py:135-152``
    in the default config)."""
    deck = cavity_deck(2, viscosity=1.0, dt=0.01, t_final=10.0, convergence=1e-3)
    solver = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=7), device="cpu")
    state, hist = solver.run()
    n_done = int(hist[-1]["step"])
    assert n_done % 7 != 0 and n_done < 1000
    solver2 = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=7), device="cpu")
    state2, _ = solver2.run(n_steps=n_done)
    for a, b in zip(solver.fields(state), solver2.fields(state2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("solver", ["explicit", "implicit"])
def test_box_matches_oracle(solver):
    """The non-cubic 5 x 3 x 4-element box (coarse shifts and multigrid
    dims that differ by axis) in F64 against the oracles."""
    if solver == "explicit":
        kw = dict(viscosity=0.1, dt=0.005)
        ts = ExplicitBCHSolver(box_cavity_deck(**kw), SolverConfig(steps_per_chunk=5),
                               device="cpu")
        state, hist = _port_run(ts, N_EXPLICIT)
        u_o, p_o, oh = ExplicitOracle(_jax_box_deck(**kw)).run(N_EXPLICIT)
        assert [int(h["iters"]) for h in hist] == [it for _, it in oh]
        tols = (1e-12, 1e-11)
    else:
        kw = dict(viscosity=0.1, dt=0.01)
        ts = ImplicitGQSolver(box_cavity_deck(**kw), SolverConfig(**IMPLICIT_CFG),
                              device="cpu")
        state, hist = _port_run(ts, N_IMPLICIT)
        u_o, p_o, _ = ImplicitOracle(_jax_box_deck(**kw)).run(N_IMPLICIT)
        tols = (5e-8, 5e-6)
    assert ts.xla and ts.fine_dims == (11, 7, 9)
    u, p = ts.fields(state)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=tols[0])
    np.testing.assert_allclose(p, p_o, rtol=0, atol=tols[1])


@pytest.mark.parametrize("structured", ["auto", "never"], ids=["box", "ell"])
def test_implicit_cold_start_f64_matches_jax_and_oracle(structured):
    """``implicit_warm_start=False`` (the reference's zero initial guesses)
    in F64.  Every momentum solve starts from zero and takes 23-31
    BiCGStab iterations, where rounding moves the stop by one in both
    packages (in F32 such runs part by 6e-4; ROADMAP.md queue 3).  At
    momentum tol 1e-10 a stop one iteration apart parts the fields by 4e-9
    of max|u|; at 1e-12, used here, by at most 6.1e-11 (measured on both
    paths), so the fields keep the 1e-9 bound with counts within one."""
    cfg = dict(IMPLICIT_CFG, implicit_warm_start=False, structured=structured,
               momentum_tol=1e-12)
    deck = jax_cavity_deck(3, **IMPLICIT_DECK)
    js = JaxImplicit(deck, JaxConfig(setup_cache="off", **cfg))
    j_state, j_rows = _jax_run(js, N_IMPLICIT)
    ts = ImplicitGQSolver(cavity_deck(3, **IMPLICIT_DECK), SolverConfig(**cfg), device="cpu")
    assert ts.xla == (structured == "auto")
    state, hist = _port_run(ts, N_IMPLICIT)
    rows = _rows(hist)
    assert rows[:, 7].min() >= 20                                         # from zero
    np.testing.assert_array_equal(rows[:, 6], j_rows[:, 6])             # CG
    assert np.abs(rows[:, 7] - j_rows[:, 7]).max() <= 1                 # BiCGStab
    u, p = ts.fields(state)
    _same_fields(u, p, *js.fields(j_state), IMPLICIT_JAX_TOL)
    u_o, p_o, _ = ImplicitOracle(deck).run(N_IMPLICIT)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=5e-8)
    np.testing.assert_allclose(p, p_o, rtol=0, atol=5e-6)
