"""PyTorch port: the explicit BCH solver on the interleaved structured layout
(and the parity layout's other convection forms) against the JAX solver on
``cavity_deck(4)``.

The JAX solver runs its kernel path (``pressure_backend="pallas"``, Pallas in
interpret mode); the port runs the plain PyTorch versions of its kernels
(CPU tensors).  The setup tables must be bit-equal.  Over 3 steps the
tolerances are those of ``tests/test_parity_stencil.py:285-290`` (two f32
implementations of one algorithm): u 5e-6, p 5e-5, monitors 5e-6, equal CG
and sub-iteration counts; ``pressure_cg_sym`` sums the half window in
another order than JAX's scatter form, so it takes the bounds of
``tests/test_parity_stencil.py:611-613`` (u, p 1e-5, counts within 4), as
``tests/test_torch_explicit.py`` does.

Covered: the interleaved layout in F32 (``conv_mode`` "auto", which is the
matrix-free form there, "matrix-free" and "planes" against the same run;
"assemble" against its own), MIXED and ``pressure_cg_sym``, on the port's
own setup and on the JAX solver's tables carried across; the parity
layout's matrix-free branch and its "assemble" request (the planes route,
as in the JAX package, held in ``tests/test_torch_explicit.py``); and a
box whose elements do not tile it, where the
explicit solver takes the interleaved layout with elemental convection.
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import interleaved_tables_from_jax, state_from_jax
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

RUNG1 = dict(dtype_policy="f32", pressure_cg_tol=1e-6, pressure_cg_fuse_loop=True,
             pressure_warm_start=True, steps_per_chunk=1)
INTERLEAVED = dict(RUNG1, structured_layout="interleaved")
N_STEPS = 3
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters")
TOLS = dict(u=5e-6, p=5e-5, cg=0)
SYM_TOLS = dict(u=1e-5, p=1e-5, cg=4)


def _deck():
    return cavity_deck(4, viscosity=0.01, dt=0.001)


def _configs(cfg):
    """(JAX config, port config) of one set of choices."""
    pol = cfg["dtype_policy"]
    rest = {k: v for k, v in cfg.items() if k != "dtype_policy"}
    jax_rest = dict(pressure_backend="pallas", setup_cache="off") | rest
    return (JaxConfig(dtype_policy=JaxPolicy(pol), **jax_rest),
            SolverConfig(dtype_policy=DTypePolicy(pol), **rest))


def _jax_run(js, step=None):
    # the step function itself: the JAX chunk's steady-flag lax.cond rejects
    # the fused CG's int32 iteration count under jax x64
    step = step or jax.jit(js._time_step)
    st = js.initial_state()
    rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    return np.asarray(rows), st


def _port_run(ts):
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(ts.initial_state(), n_steps=N_STEPS)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    return np.asarray([[h[f] for f in STAT_FIELDS] for h in hist]), state


def _compare(js, ref, ts, got, tols=TOLS):
    (ref_rows, ref_state), (rows, state) = ref, got
    assert rows.shape == ref_rows.shape
    np.testing.assert_array_equal(rows[:, 5], ref_rows[:, 5])          # sub-iterations
    assert np.abs(rows[:, 6] - ref_rows[:, 6]).max() <= tols["cg"]      # CG iterations
    np.testing.assert_allclose(rows[:, :5], ref_rows[:, :5], rtol=0, atol=max(tols["u"], 5e-6))
    u_j, p_j = js.fields(ref_state)
    u_t, p_t = ts.fields(state)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=tols["u"])
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=tols["p"])


def _attrs(js):
    return {k: getattr(js, k, None) for k in ExplicitBCHSolver.INTERLEAVED_STATIC_ATTRS}


def _carried(js, cfg, deck=None, sym=False):
    attrs = _attrs(js) | {"layout": "interleaved"}
    tables = interleaved_tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs,
                                         sym=sym)
    return ExplicitBCHSolver.from_tables(deck or _deck(), cfg, tables, attrs, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX interleaved solver (rung 1), its 3-step run and its jitted step."""
    jcfg, _ = _configs(INTERLEAVED)
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.001), jcfg)
    assert js.layout == "interleaved" and js.elem_structured
    step = jax.jit(js._time_step)
    return js, _jax_run(js, step), step


@pytest.fixture(scope="module")
def port():
    ts = ExplicitBCHSolver(_deck(), _configs(INTERLEAVED)[1], device="cpu")
    assert ts.layout == "interleaved"
    return ts


def test_setup_tables_bit_equal(reference, port):
    js = reference[0]
    carried = _carried(js, port.config)
    for k in ("K_vals", "G_win", "GT_win", "GT_cwin", "md_inv", "md_orig_inv", "bc_mask",
              "bc_vel", "Sv", "gDSv", "gq"):
        a, b = np.asarray(js.d[k]), port.d[k].numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert port.d["K_vals"].shape == (len(js.k_offsets), js.s_pad) and js.s_pad % 2048 == 0
    for k in ("Z_win", "Z_dinv"):
        np.testing.assert_array_equal(port.d[k].numpy(), carried.d[k].numpy(), err_msg=k)
    assert sorted(port.d) == sorted(carried.d)
    for k, a in _attrs(js).items():
        b = getattr(port, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert a == b, k


@pytest.mark.parametrize("conv_mode", ["auto", "matrix-free", "planes"])
def test_steps_match_jax_own_setup(reference, conv_mode):
    """On the interleaved layout every conv_mode but "assemble" is the
    matrix-free form, in both packages."""
    js, ref, _ = reference
    ts = ExplicitBCHSolver(_deck(), _configs(dict(INTERLEAVED, conv_mode=conv_mode))[1],
                           device="cpu")
    got = _port_run(ts)
    assert (got[0][:, 5] >= 2).all()        # spin-up: K acc applied between sub-iterations
    _compare(js, ref, ts, got)


def test_steps_match_jax_carried_tables(reference, port):
    js, ref, _ = reference
    ts = _carried(js, port.config)
    _compare(js, ref, ts, _port_run(ts))


def test_state_from_jax_continues_the_run(reference, port):
    """A JAX (3, s_pad) state carried across and stepped by the port equals
    the JAX solver stepping it."""
    js, (_, ref_state), step = reference
    carried = state_from_jax([np.asarray(a) for a in ref_state])
    assert tuple(carried.un.shape) == (3, port.s_pad)
    st1, stats = port._time_step(port.d, carried)
    st_j, stats_j = step(js.d, ref_state)
    assert int(stats.iters) == int(stats_j.iters) and int(stats.cg_iters) == int(stats_j.cg_iters)
    np.testing.assert_allclose(port.fields(st1)[0], js.fields(st_j)[0], rtol=0, atol=5e-6)


def test_state_from_fields_round_trip(reference, port):
    js = reference[0]
    rng = np.random.default_rng(8)
    u = rng.standard_normal((port.nn, 3)).astype(np.float32)
    p = rng.standard_normal(port.nnp).astype(np.float32)
    st, ref = port.state_from_fields(u, p), js.state_from_fields(u, p)
    for a, b in zip(st, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u2, p2 = port.fields(st)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(p2, p)


# other choices on a box mesh: (choices, tolerances, layout).  "assemble" on the
# interleaved layout adds A(un) into K's window rows; MIXED and sym run the
# default per-iteration CG loop.  On the parity layout "matrix-free" is the flat
# gather / einsum / parity_scatter_elem_flat branch and "assemble" the planes
# route (the JAX package takes planes for every mode but "matrix-free" up to
# 100,000 coarse nodes; tests/test_torch_explicit.py holds it against the
# JAX solver's default run, which is the same route).
OTHER = {
    "interleaved-assemble": (dict(INTERLEAVED, conv_mode="assemble"), TOLS, "interleaved"),
    "interleaved-mixed": (dict(INTERLEAVED, dtype_policy="mixed", pressure_cg_fuse_loop=False),
                          TOLS, "interleaved"),
    "interleaved-sym": (dict(INTERLEAVED, pressure_cg_sym=True, pressure_cg_fuse_loop=False),
                        SYM_TOLS, "interleaved"),
    "parity-matrix-free": (dict(RUNG1, conv_mode="matrix-free"), TOLS, "parity"),
}


@pytest.mark.parametrize("case", sorted(OTHER))
def test_other_choices_match_jax(case):
    cfg, tols, layout = OTHER[case]
    jcfg, tcfg = _configs(cfg)
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.001), jcfg)
    ts = ExplicitBCHSolver(_deck(), tcfg, device="cpu")
    assert js.layout == ts.layout == layout
    ref = _jax_run(js)
    got = _port_run(ts)
    _compare(js, ref, ts, got, tols)
    if cfg.get("pressure_cg_fuse_loop") is False:
        assert (got[0][:, 6] % 4 == 0).all()                 # groups of the unroll
    if case == "interleaved-sym":
        assert ts.d["Z_win"].shape == (63, ts.nnp)
        np.testing.assert_array_equal(ts.d["Z_win"].numpy(),
                                      _carried(js, tcfg, sym=True).d["Z_win"].numpy())


# a quarter turn about z of a hex's corner labels: local[QUARTER[i]] = R local[i]
QUARTER = [1, 2, 3, 0, 5, 6, 7, 4]


def _turned_box(make_deck):
    """``cavity_deck(3)`` with its one element that has no boundary face
    relabelled by a quarter turn: still a box grid, no longer element-tiled
    (tests/test_torch_unstructured_implicit.py)."""
    deck = make_deck(3, viscosity=0.1, dt=0.01)
    on_bc = set(np.asarray(deck.bc_vel_faces)[:, 0].tolist())
    (inner,) = [e for e in range(deck.conn.shape[0]) if e not in on_bc]
    deck.conn[inner] = deck.conn[inner][QUARTER]
    return deck


def test_box_without_element_structure_runs_interleaved_as_jax_does():
    """The explicit solver keeps the box's window operators and applies the
    convection elementally on grid-order node ids (explicit_bch.py:1105-1110),
    in both packages; the port's own setup and the carried tables."""
    jcfg, tcfg = _configs(RUNG1)
    js = JaxSolver(_turned_box(jax_cavity_deck), jcfg)
    ts = ExplicitBCHSolver(_turned_box(cavity_deck), tcfg, device="cpu")
    assert js.structured and js.layout == ts.layout == "interleaved"
    assert not js.elem_structured and not ts.elem_structured
    ref = _jax_run(js)
    _compare(js, ref, ts, _port_run(ts))
    carried = _carried(js, tcfg, deck=_turned_box(cavity_deck))
    np.testing.assert_array_equal(carried.d["ltog"].numpy(), ts.d["ltog"].numpy())
    np.testing.assert_array_equal(carried.d["gDSv"].numpy(), ts.d["gDSv"].numpy())
    _compare(js, ref, carried, _port_run(carried))


def test_forced_parity_layout_raises_where_jax_does():
    """structured_layout="parity" on a box whose elements do not tile it: the
    JAX package's ValueError."""
    jcfg, tcfg = _configs(dict(RUNG1, structured_layout="parity"))
    with pytest.raises(ValueError, match="structured_layout='parity'"):
        JaxSolver(_turned_box(jax_cavity_deck), jcfg)
    with pytest.raises(ValueError, match="structured_layout='parity'"):
        ExplicitBCHSolver(_turned_box(cavity_deck), tcfg, device="cpu")


# off the kernel path a box mesh is the JAX package's XLA structured path, whose
# layout is the interleaved one: 3 steps with the choice, against the JAX solver
# (F64 at 1e-12 of max|u| and max|p|, F32 at this file's bounds;
# equal sub-iteration and CG counts)
@pytest.mark.parametrize("override", [
    pytest.param(dict(dtype_policy="f64"), id="f64"),
    pytest.param(dict(pressure_backend="xla"), id="xla"),
    pytest.param(dict(pressure_precond="mg"), id="mg"),
])
def test_xla_path_choices_match_jax_on_the_interleaved_layout(override):
    jcfg, tcfg = _configs(dict(INTERLEAVED, **override))
    js = JaxSolver(jax_cavity_deck(4, viscosity=0.01, dt=0.001), jcfg)
    ts = ExplicitBCHSolver(_deck(), tcfg, device="cpu")
    assert ts.xla and ts.use_mg and js.use_mg and ts.layout == js.layout == "interleaved"
    (ref_rows, ref_state), (rows, state) = _jax_run(js), _port_run(ts)
    np.testing.assert_array_equal(rows[:, 5:], ref_rows[:, 5:])
    tol = (1e-12, 1e-12) if override.get("dtype_policy") == "f64" else None
    (u_j, p_j), (u_t, p_t) = js.fields(ref_state), ts.fields(state)
    if tol:
        assert np.abs(u_t - u_j).max() <= tol[0] * np.abs(u_j).max()
        assert np.abs(p_t - p_j).max() <= tol[1] * np.abs(p_j).max()
    else:
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=TOLS['u'])
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=TOLS['p'])
