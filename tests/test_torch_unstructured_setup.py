"""PyTorch port: the unstructured (ELL) path's host setup is array-equal to
the JAX package's.

Two decks reach the path: the small backward-facing step
``bfs_deck(12, 4, 4, lengths=(6, 2, 2), step_frac=(0.25, 0.5))`` (not a box
grid; its corner numbering keeps Z banded, 185 offsets) and
``cavity_deck(4)`` under ``structured="never"``.  Every table the port's
steps read must equal the JAX solver's bit for bit: element tables after
the transpose to the port's element-major layout (``interop`` does the
same), reverse-incidence tables after re-indexing to that layout
(``interop.rev_from_jax``), the banded window against the JAX kernel
layout ``Z_bwin_cg`` cut to ``(D, NNp)``.  The implicit solver's
``rev_m`` is held against the reverse table of the JAX ``scatter_m``.
"""

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu.mesh.generators import bfs_deck as jax_bfs_deck
from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.interop import (
    ell_tables_from_jax,
    implicit_ell_tables_from_jax,
    rev_from_jax,
)
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops.spmv import build_reverse_incidence
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05)
DECKS = {
    "bfs": (lambda mod, dt: mod(12, 4, 4, dt=dt, **BFS), {}),
    "cavity_never": (lambda mod, dt: mod(4, viscosity=0.01, dt=dt), dict(structured="never")),
}
CFG = dict(pressure_cg_tol=1e-6, setup_cache="off")


def _pair(which, solver_pair, dt):
    make, extra = DECKS[which]
    jax_mod, port_mod = ((jax_bfs_deck, bfs_deck) if which == "bfs"
                         else (jax_cavity_deck, cavity_deck))
    jcls, tcls = solver_pair
    js = jcls(make(jax_mod, dt), JaxConfig(dtype_policy=JaxPolicy.F32,
                                           pressure_backend="pallas", **CFG, **extra))
    ts = tcls(make(port_mod, dt), SolverConfig(dtype_policy=DTypePolicy.F32, **CFG, **extra),
              device="cpu")
    assert not js.structured and ts.layout == "ell"
    return js, ts


@pytest.fixture(scope="module", params=sorted(DECKS))
def explicit_pair(request):
    return _pair(request.param, (JaxExplicit, ExplicitBCHSolver), 0.002)


@pytest.fixture(scope="module", params=sorted(DECKS))
def implicit_pair(request):
    return _pair(request.param, (JaxImplicit, ImplicitGQSolver), 0.01)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_bfs_deck_equal():
    a = bfs_deck(12, 4, 4, dt=0.002, **BFS)
    b = jax_bfs_deck(12, 4, 4, dt=0.002, **BFS)
    for f in ("coords", "conn", "bc_vel_faces", "bc_out_faces", "bc_str", "bc_type",
              "monitor_xyz"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("ne", "ncn", "nnp", "zero_pressure_node", "inlet_profile", "title"):
        assert getattr(a, f) == getattr(b, f), f


def test_explicit_tables_equal(explicit_pair):
    js, ts = explicit_pair
    jd = {k: np.asarray(v) for k, v in js.d.items()}
    d = {k: _np(v) for k, v in ts.d.items()}
    ne = d["ltog"].shape[0]
    np.testing.assert_array_equal(d["ltog"], jd["ltog"].T)
    np.testing.assert_array_equal(d["ltog_p"], jd["ltog_p"].T)
    np.testing.assert_array_equal(d["rev"], rev_from_jax(jd["rev"], ne, 27))
    np.testing.assert_array_equal(d["rev_p"], rev_from_jax(jd["rev_p"], ne, 8))
    np.testing.assert_array_equal(d["Ke"], np.transpose(jd["Ke"], (2, 0, 1)))
    np.testing.assert_array_equal(d["Ge"], np.transpose(jd["Ge"], (3, 0, 1, 2)))
    np.testing.assert_array_equal(d["gDSv"], np.transpose(jd["gDSv"], (3, 0, 1, 2)))
    np.testing.assert_array_equal(d["gq"], jd["gq"].T)
    for k in ("Sv", "Z_vals", "Z_cols", "Z_diag", "md_inv", "md_orig_inv", "bc_mask",
              "bc_vel"):
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
        assert d[k].dtype == jd[k].dtype, k
    np.testing.assert_array_equal(d["Z_dinv"], (1.0 / js.d["Z_diag"]).__array__())
    # the banded window: offsets and the JAX kernel layout cut to (D, NNp)
    assert ts.z_offs == js.z_offs and ts.z_offs is not None
    s_pad = -(-ts.nnp // 128) * 128
    cut = jd["Z_bwin_cg"].reshape(-1, s_pad)[: len(ts.z_offs), : ts.nnp]
    np.testing.assert_array_equal(d["Z_bwin"], cut)
    np.testing.assert_array_equal(d["Z_bwin"], jd["Z_bwin"])
    for k in ExplicitBCHSolver.ELL_STATIC_ATTRS:
        assert getattr(ts, k) == getattr(js, k), k
    # interop carries the same tables across
    attrs = {k: getattr(js, k) for k in ExplicitBCHSolver.ELL_STATIC_ATTRS}
    carried = ell_tables_from_jax(jd, attrs)
    assert sorted(carried) == sorted(d)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), d[k], err_msg=k)


def test_implicit_tables_equal(implicit_pair):
    js, ts = implicit_pair
    jd = {k: np.asarray(v) for k, v in js.d.items()}
    d = {k: _np(v) for k, v in ts.d.items()}
    np.testing.assert_array_equal(d["ltog"], jd["ltog"].T)
    np.testing.assert_array_equal(d["gDSv"], np.transpose(jd["gDSv"], (3, 0, 1, 2)))
    np.testing.assert_array_equal(d["gq"], jd["gq"].T)
    # the elemental -> CSR map and its reverse table
    scatter = ts.ops.pattern_m.scatter                    # (NE, 27, 27)
    np.testing.assert_array_equal(np.transpose(scatter, (1, 2, 0)), jd["scatter_m"])
    nnz = jd["mk_vals_csr"].shape[0]
    np.testing.assert_array_equal(
        d["rev_m"], build_reverse_incidence(scatter.reshape(scatter.shape[0], -1), nnz))
    for k in ("Sv", "mk_vals_csr", "m_vals", "row_mask", "diag_add", "csr_to_ell", "A_cols",
              "G_vals", "G_cols", "GT_vals", "GT_cols", "Z_vals", "Z_cols", "Z_diag",
              "p_mask", "bc_mask", "bc_vel", "diag_slots"):
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
        assert d[k].dtype == jd[k].dtype, k
    for k in ImplicitGQSolver.ELL_STATIC_ATTRS:
        assert getattr(ts, k) == getattr(js, k), k
    attrs = {k: getattr(js, k) for k in ImplicitGQSolver.ELL_STATIC_ATTRS}
    carried = implicit_ell_tables_from_jax(jd, attrs)
    assert sorted(carried) == sorted(d)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), d[k], err_msg=k)


def test_bfs_outflow_rows_are_eliminated():
    """The BFS outflow plane gives the implicit solver's pressure rows their
    Dirichlet elimination (``p_mask`` 0 there, nowhere else), and no
    mean projection."""
    js, ts = _pair("bfs", (JaxImplicit, ImplicitGQSolver), 0.01)
    p_mask = ts.d["p_mask"].numpy()
    out = np.isclose(ts.deck.coords[: ts.nnp, 0], 6.0)
    np.testing.assert_array_equal(p_mask == 0.0, out)
    assert out.sum() == 5 * 5 and not ts.ppe_project and not js.ppe_project


def test_state_round_trip_and_from_tables():
    """``state_from_fields`` / ``fields`` on the ELL layout (deck node
    order, no permutation), and a solver built by ``from_tables`` from
    ``static_attrs()`` steps like the original."""
    ts = ExplicitBCHSolver(bfs_deck(12, 4, 4, dt=0.002, **BFS),
                           SolverConfig(dtype_policy=DTypePolicy.F32, **CFG), device="cpu")
    rng = np.random.default_rng(4)
    u = rng.standard_normal((ts.nn, 3)).astype(np.float32)
    p = rng.standard_normal(ts.nnp).astype(np.float32)
    st = ts.state_from_fields(u, p)
    assert st.un.shape == (3, ts.nn) and st.pn.shape == (ts.nnp,)
    u2, p2 = ts.fields(st)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(p2, p)
    attrs = ts.static_attrs()
    assert attrs["layout"] == "ell"
    twin = ExplicitBCHSolver.from_tables(ts.deck, ts.config, ts.d, attrs, device="cpu")
    a, sa = ts._time_step(ts.d, st)
    b, sb = twin._time_step(twin.d, st)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert int(sa.cg_iters) == int(sb.cg_iters) > 0


@pytest.mark.parametrize("solver", [ExplicitBCHSolver, ImplicitGQSolver])
@pytest.mark.parametrize("override,error", [
    (dict(structured="force"), "structured mode forced"),
    (dict(pressure_precond="mg"), "needs the structured fast path"),
    (dict(structured_layout="parity"), "element-structured box grid"),
])
def test_unstructured_mesh_errors_as_jax(solver, override, error):
    """The JAX package's own errors for a mesh that falls back to ELL."""
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, **CFG, **override)
    with pytest.raises(ValueError, match=error):
        solver(bfs_deck(12, 4, 4, dt=0.01, **BFS), cfg, device="cpu")
