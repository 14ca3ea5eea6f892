"""PyTorch port: the explicit BCH solver on the parity path reproduces the
JAX solver over 3 time steps on ``cavity_deck(4)``.

The JAX solver runs its Pallas kernels in interpret mode; the port runs the
plain PyTorch versions of its kernels (CPU tensors).  Tolerances are those
of ``tests/test_parity_stencil.py:285-290`` (two f32 implementations of one
algorithm): u 5e-6, p 5e-5, monitors 5e-6, and equal CG and sub-iteration
counts.  The port runs once with its own setup and once with the JAX
solver's tables carried across by ``interop.tables_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import state_from_jax, tables_from_jax
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

RUNG1 = dict(pressure_cg_tol=1e-6, pressure_cg_fuse_loop=True,
             pressure_warm_start=True, steps_per_chunk=1)
N_STEPS = 3
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters")


def _deck():
    return cavity_deck(4, viscosity=0.01, dt=0.001)


@pytest.fixture(scope="module")
def reference():
    """The JAX solver and its 3-step run: (solver, per-step stats, final state)."""
    js = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.001),
        JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                  structured_layout="parity", setup_cache="off", **RUNG1),
    )
    # the step function itself: the JAX chunk's steady-flag lax.cond
    # rejects the fused CG's int32 iteration count under jax x64 (the
    # monitor-only branch yields int64)
    step = jax.jit(js._time_step)
    st = js.initial_state()
    rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    return js, np.asarray(rows), st


def _run_port(ts):
    st = ts.initial_state()
    state, hist = ts.run(st, n_steps=N_STEPS)
    return state, np.asarray([[h[f] for f in STAT_FIELDS] for h in hist])


def _compare(js, ref_rows, ref_state, ts, state, rows):
    assert rows.shape == ref_rows.shape
    np.testing.assert_array_equal(rows[:, 5], ref_rows[:, 5])          # sub-iterations
    np.testing.assert_array_equal(rows[:, 6], ref_rows[:, 6])          # CG iterations
    np.testing.assert_allclose(rows[:, :5], ref_rows[:, :5], rtol=0, atol=5e-6)
    u_j, p_j = js.fields(ref_state)
    u_t, p_t = ts.fields(state)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=5e-6)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=5e-5)


def test_steps_match_jax_own_setup(reference):
    js, ref_rows, ref_state = reference
    ts = ExplicitBCHSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **RUNG1),
                           device="cpu")
    cuda_lib.reset_launch_counts()
    state, rows = _run_port(ts)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    assert (rows[:, 5] >= 2).all()          # spin-up: K acc applied between sub-iterations
    _compare(js, ref_rows, ref_state, ts, state, rows)


def test_steps_match_jax_carried_tables(reference):
    js, ref_rows, ref_state = reference
    attrs = {k: getattr(js, k) for k in ExplicitBCHSolver.STATIC_ATTRS}
    tables = tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs)
    ts = ExplicitBCHSolver.from_tables(
        _deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **RUNG1), tables, attrs,
        device="cpu",
    )
    state, rows = _run_port(ts)
    _compare(js, ref_rows, ref_state, ts, state, rows)


def test_state_from_jax_continues_the_run(reference):
    """A JAX state carried across and stepped once by the port equals the
    port's own state stepped once (same tables)."""
    js, _, ref_state = reference
    ts = ExplicitBCHSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32, **RUNG1),
                           device="cpu")
    carried = state_from_jax([np.asarray(a) for a in ref_state])
    assert [a.shape for a in carried] == [tuple(np.shape(a)) for a in ref_state]
    st1, stats = ts._time_step(ts.d, carried)
    assert np.isfinite(st1.un.numpy()).all() and int(stats.iters) >= 1


# CG modes the explicit solver reaches beside rung 1: (port overrides, u
# tol, p tol, CG-count tol).  "mixed" and "iter" run the same arithmetic as
# the JAX solver (the bounds of rung 1; counts of the per-iteration loop are
# multiples of the unroll, 4, and must be equal); "sym" sums the half window
# in another order than JAX's scatter form is summed, so it takes the bounds
# of tests/test_parity_stencil.py:611-613 (u, p 1e-5, counts within 4).
CG_MODES = {
    "mixed": (dict(dtype_policy=DTypePolicy.MIXED, pressure_cg_fuse_loop=False), 5e-6, 5e-5, 0),
    "iter": (dict(pressure_cg_fuse_loop=False), 5e-6, 5e-5, 0),
    "sym": (dict(pressure_cg_sym=True, pressure_cg_fuse_loop=False), 1e-5, 1e-5, 4),
}


@pytest.mark.parametrize("mode", sorted(CG_MODES))
def test_steps_match_jax_other_cg_modes(mode):
    """MIXED (compensated dots), the default per-iteration CG loop and the
    symmetric half window, 3 steps each against the JAX solver."""
    override, u_tol, p_tol, cg_tol = CG_MODES[mode]
    cfg = dict(dtype_policy=DTypePolicy.F32, **RUNG1) | override
    jcfg = dict(cfg, dtype_policy=JaxPolicy(cfg["dtype_policy"].value))
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.001),
                   JaxConfig(pressure_backend="pallas", structured_layout="parity",
                             setup_cache="off", **jcfg))
    step = jax.jit(js._time_step)
    st = js.initial_state()
    ref_rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        ref_rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    ref_rows = np.asarray(ref_rows)
    ts = ExplicitBCHSolver(_deck(), SolverConfig(**cfg), device="cpu")
    if mode == "sym":
        attrs = {k: getattr(js, k) for k in ExplicitBCHSolver.STATIC_ATTRS}
        carried = tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs, sym=True)
        assert ts.d["Z_win"].shape == (63, ts.nnp)
        np.testing.assert_array_equal(ts.d["Z_win"].numpy(), carried["Z_win"].numpy())
    state, rows = _run_port(ts)
    np.testing.assert_array_equal(rows[:, 5], ref_rows[:, 5])          # sub-iterations
    assert np.abs(rows[:, 6] - ref_rows[:, 6]).max() <= cg_tol
    assert (rows[:, 6] % 4 == 0).all()
    np.testing.assert_allclose(rows[:, :5], ref_rows[:, :5], rtol=0, atol=max(u_tol, 5e-6))
    u_j, p_j = js.fields(st)
    u_t, p_t = ts.fields(state)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=u_tol)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=p_tol)


def test_assemble_request_takes_the_planes_route_as_jax_does(reference):
    """conv_mode="assemble" on the parity layout: the JAX package streams the
    convection planes for every mode but "matrix-free" up to 100,000 coarse
    nodes (explicit_bch.py:906-909), so its rung-1 run here is the reference.
    (The interleaved layout's assemble form, "matrix-free" on both layouts
    and structured_layout="interleaved": tests/test_torch_interleaved_explicit.py.)"""
    js, ref_rows, ref_state = reference
    ts = ExplicitBCHSolver(_deck(), SolverConfig(dtype_policy=DTypePolicy.F32,
                                                 conv_mode="assemble", **RUNG1), device="cpu")
    assert ts.layout == "parity"
    state, rows = _run_port(ts)
    _compare(js, ref_rows, ref_state, ts, state, rows)


# off the kernel path this box takes the JAX package's XLA structured path:
# F64, the multigrid preconditioner or the XLA CG (held at length in
# tests/test_torch_xla_solvers.py); 3 steps of rung 1's config with the
# choice, against the JAX solver: F64 at 1e-12 of max|u| and max|p|, F32 at
# this file's bounds, equal sub-iteration and CG counts
@pytest.mark.parametrize("override", [
    pytest.param(dict(dtype_policy=DTypePolicy.F64), id="f64"),
    pytest.param(dict(pressure_precond="mg"), id="mg"),
    pytest.param(dict(pressure_backend="xla"), id="xla"),
])
def test_xla_path_choices_match_jax(override):
    cfg = dict(dtype_policy=DTypePolicy.F32, **RUNG1) | override
    pol = cfg.pop("dtype_policy")
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.001),
                   JaxConfig(dtype_policy=JaxPolicy(pol.value), setup_cache="off", **cfg))
    ts = ExplicitBCHSolver(_deck(), SolverConfig(dtype_policy=pol, **cfg), device="cpu")
    assert ts.xla and ts.use_mg and js.use_mg and ts.layout == js.layout == "interleaved"
    step = jax.jit(js._time_step)
    st = js.initial_state()
    ref_rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        ref_rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    state, rows = _run_port(ts)
    np.testing.assert_array_equal(rows[:, 5:], np.asarray(ref_rows)[:, 5:])
    (u_j, p_j), (u_t, p_t) = js.fields(st), ts.fields(state)
    if pol is DTypePolicy.F64:
        assert np.abs(u_t - u_j).max() <= 1e-12 * np.abs(u_j).max()
        assert np.abs(p_t - p_j).max() <= 1e-12 * np.abs(p_j).max()
    else:
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=5e-6)
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=5e-5)


# structured="never" runs (the unstructured path: tests/test_torch_unstructured_*.py);
# spmd_devices runs (ROADMAP.md queue 1 item 11, ported: tests/test_torch_sharding.py)
# and, without a process group of that many ranks, raises the JAX package's
# make_mesh error rather than running on one device
@pytest.mark.parametrize("override,msg", [
    pytest.param(dict(spmd_devices=2), "devices are", id="override6"),
])
def test_other_branches_raise_with_roadmap_item(override, msg):
    cfg = dict(dtype_policy=DTypePolicy.F32, **RUNG1) | override
    with pytest.raises(ValueError, match="2-device mesh") as err:
        ExplicitBCHSolver(_deck(), SolverConfig(**cfg), device="cpu")
    assert err.match(msg)


# setup_cache="auto" (ROADMAP.md queue 1 item 8, ported): a miss, then a hit
def test_setup_cache_auto_misses_then_hits(tmp_path, monkeypatch):
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", str(tmp_path))
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, setup_cache="auto", **RUNG1)
    hits = [ExplicitBCHSolver(_deck(), cfg, device="cpu").setup_cache_hit for _ in range(2)]
    assert hits == [False, True]


def test_steady_flag_carries_across_chunks():
    """Once max_acc drops to the convergence criterion the run stops: the
    flag carries across chunk boundaries (no extra real step)."""
    deck = _deck()
    deck.convergence_criteria = 10.0          # steady after the first step
    ts = ExplicitBCHSolver(deck, SolverConfig(dtype_policy=DTypePolicy.F32, **RUNG1),
                           device="cpu")
    _, hist = ts.run(n_steps=4)
    assert len(hist) == 1 and hist[0]["max_acc"] <= 10.0
