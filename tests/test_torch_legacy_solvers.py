"""PyTorch port: the legacy solvers — ``PoissonSolver``, ``StokesSolver``,
``GLSNavierStokesSolver`` and ``SegregatedSolver`` — against the JAX
package on the same generated decks (CPU, float64).

* Poisson on the cube decks of ``tests/test_poisson.py`` (n = 3, 4, 8 with
  zero Dirichlet walls, every Krylov backend, and a nonzero Dirichlet
  case): u within 1e-10 of max|u|, equal iteration counts.
* Stokes (both ``tau_mode``s, GMRES and ``dense_lu``), GLS Picard and the
  segregated solver on ``cavity_legacy_deck(2..4)``, GLS on
  ``kovasznay_legacy_deck()``: u and p within 1e-9 of max|u| and max|p|,
  equal Picard / outer counts and per-solve Krylov counts.

One count is held otherwise, with its trace: the segregated solver's
pressure CG (SCPE, tol 1e-10), whose ||r|| is not monotone near its bound,
so rounding moves its stop.  The JAX package's own CG moves when only the
ELL slot order of its SPMV is reversed (92 / 91, 94 / 95 and 94 / 95 on the
pressure solves of outer iterations 2-4 of ``cavity_legacy_deck(3,
viscosity=0.1)``, x 1.5e-11 to 2.9e-11 of max|x| apart).  On one system
the two packages' CGs read ||r|| / (tol ||b||) 2.20 and 2.56 at k = 93,
0.61 and 2.07 at 94, 0.13 and 0.10 at 95 (that deck, third outer
iteration: stops at 94 and 95), and on the port's third-iteration system
of ``cavity_legacy_deck(4, viscosity=0.1)`` both run 1.07-2.56 from k =
152 to 160, the port's touching the bound at 158 (0.88), JAX's at 161
(0.61): three apart, more than the one the JAX spread shows.  So each of
the port's pressure solves is held against JAX's CG on the same system:
at the port's own depth (JAX run to that count) x within 1e-9 of max|x|,
the port's x converged (f64 true residual within 2 tol ||b||, as
``chip_smoke.py``'s ``CG_TRUE_RES_TOL``, where the solve stopped before
``maxiter``), and the counts within 3, the
window the trace shows.  The whole run holds the outer and momentum
counts equal and the fields to 1e-9.
"""

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu.io.deck import Deck as JaxDeck
from cfd_with_cuda_tpu.mesh import generators as jg
from cfd_with_cuda_tpu.mesh.generators import cube_hex_mesh as jax_cube
from cfd_with_cuda_tpu.ops import linsolve as jl
from cfd_with_cuda_tpu.solvers import monolithic as jm
from cfd_with_cuda_tpu.solvers import poisson as jp
from cfd_with_cuda_tpu.solvers import segregated as js
from cfd_with_cuda_tpu_torch.io.deck import Deck
from cfd_with_cuda_tpu_torch.mesh import generators as tg
from cfd_with_cuda_tpu_torch.mesh.generators import cube_hex_mesh
from cfd_with_cuda_tpu_torch.solvers import monolithic as tm
from cfd_with_cuda_tpu_torch.solvers import poisson as tp
from cfd_with_cuda_tpu_torch.solvers import segregated as ts

torch.set_num_threads(1)

U_TOL = 1e-10       # Poisson, of max|u|
F_TOL = 1e-9        # the Navier-Stokes legacy solvers, of max|u| and of max|p|
P_ITERS_TOL = 3     # the segregated pressure CG on the same system (module docstring)


def _cube_poisson_deck(n, deck_cls=Deck, cube=cube_hex_mesh):
    """``tests/test_poisson.py::_cube_poisson_deck``: an n^3-element cube
    with zero Dirichlet walls."""
    coords, conn = cube(n + 1)
    nn = (n + 1) ** 3
    ebc = np.flatnonzero((np.isclose(coords, 0.0) | np.isclose(coords, 1.0)).any(axis=1))
    deck = deck_cls(dialect="poisson", title="cube poisson")
    deck.etype = 3
    deck.ne = n**3
    deck.nn = deck.ncn = nn
    deck.nenv = deck.nenp = 8
    deck.ngp = 8
    deck.solver_iter_max = 2000
    deck.solver_tol = 1e-12
    deck.axy, deck.fxy = 1.0, 0.0
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0])
    deck.bc_str = np.array([[0.0, 0.0, 0.0]])
    deck.bc_vel_nodes = np.column_stack([ebc, np.zeros_like(ebc)])
    return deck


def _close(got, want, tol):
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n,backend", [
    (3, "cg"), (8, "cg"), (4, "cg"), (4, "cr"), (4, "bicgstab"), (4, "gmres"),
])
def test_poisson_mms_matches_jax(n, backend):
    deck_t, deck_j = _cube_poisson_deck(n), _cube_poisson_deck(n, JaxDeck, jax_cube)
    uj, kj, rj = jp.PoissonSolver(deck_j, solver=backend).solve(source="mms")
    ut, kt, rt = tp.PoissonSolver(deck_t, solver=backend, device="cpu").solve(source="mms")
    assert kt == kj > 0
    _close(ut, uj, U_TOL)
    assert abs(rt - rj) <= 1e-12 * np.abs(tp.PoissonSolver(deck_t, device="cpu").rhs("mms")).max()


def test_poisson_nonzero_dirichlet_matches_jax():
    """u = x on the walls, f = 0 (``test_poisson.py::test_nonzero_dirichlet``):
    the symmetric elimination lifts the columns into the RHS."""
    deck_t, deck_j = _cube_poisson_deck(3), _cube_poisson_deck(3, JaxDeck, jax_cube)
    sj = jp.PoissonSolver(deck_j)
    st = tp.PoissonSolver(deck_t, device="cpu")
    for s in (sj, st):
        s.ebc_vals = deck_t.coords[deck_t.bc_vel_nodes[:, 0], 0]
    np.testing.assert_array_equal(st.rhs("deck"), sj.rhs("deck"))
    uj, kj, _ = sj.solve(source="deck")
    ut, kt, _ = st.solve(source="deck")
    assert kt == kj
    _close(ut, uj, U_TOL)
    np.testing.assert_allclose(ut, deck_t.coords[:, 0], rtol=0, atol=1e-8)


def test_poisson_bicg_raises_as_jax():
    """BiCG through ``PoissonSolver`` gets no transpose apply: the same
    ``ValueError`` in both packages."""
    deck_t, deck_j = _cube_poisson_deck(2), _cube_poisson_deck(2, JaxDeck, jax_cube)
    with pytest.raises(ValueError, match="rmatvec") as ej:
        jp.PoissonSolver(deck_j, solver="bicg").solve(source="mms")
    with pytest.raises(ValueError, match="rmatvec") as et:
        tp.PoissonSolver(deck_t, solver="bicg", device="cpu").solve(source="mms")
    assert str(et.value) == str(ej.value)


def _fields_close(ut, pt, uj, pj):
    _close(ut, uj, F_TOL)
    _close(pt, pj, F_TOL)


@pytest.mark.parametrize("n,tau_mode,solver", [
    (2, "gls_h", "gmres"), (3, "gls_h", "gmres"), (4, "gls_h", "gmres"),
    (3, "reference", "gmres"), (4, "gls_h", "dense_lu"), (3, "reference", "dense_lu"),
])
def test_stokes_matches_jax(n, tau_mode, solver):
    kw = dict(tau_mode=tau_mode, solver=solver, solver_tol=1e-10)
    uj, pj, kj = jm.StokesSolver(jg.cavity_legacy_deck(n, viscosity=1.0), **kw).solve()
    st = tm.StokesSolver(tg.cavity_legacy_deck(n, viscosity=1.0), device="cpu", **kw)
    ut, pt, kt = st.solve()
    assert kt == kj
    _fields_close(ut, pt, uj, pj)
    lid = np.isclose(st.deck.coords[:, 2], 1.0)
    np.testing.assert_allclose(ut[lid, 0], 1.0, rtol=0, atol=1e-9)


def test_monolithic_equal_order_only():
    deck = tg.cavity_legacy_deck(2)
    deck.nenp = 4
    with pytest.raises(ValueError, match="equal-order"):
        tm.StokesSolver(deck, device="cpu")
    with pytest.raises(ValueError, match="equal-order"):
        ts.SegregatedSolver(deck, device="cpu")
    np.testing.assert_array_equal(tm.element_sizes(deck.coords, deck.conn),
                                  jm.element_sizes(deck.coords, deck.conn))


def _history_rows(hist, keys):
    return [tuple(h[k] if not isinstance(h[k], list) else tuple(h[k]) for k in keys)
            for h in hist]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gls_picard_matches_jax(n):
    """Re 10 cavity, 4 Picard iterations: equal GMRES counts per solve, the
    max-change rows to 1e-9, the fields to 1e-9."""
    kw = dict(solver_tol=1e-10)
    uj, pj, hj = jm.GLSNavierStokesSolver(jg.cavity_legacy_deck(n, viscosity=0.1),
                                          **kw).solve(max_picard=4, tol=1e-12)
    ut, pt, ht = tm.GLSNavierStokesSolver(tg.cavity_legacy_deck(n, viscosity=0.1),
                                          device="cpu", **kw).solve(max_picard=4, tol=1e-12)
    assert len(ht) == len(hj) == 4
    assert _history_rows(ht, ("iter", "lin_iters")) == _history_rows(hj, ("iter", "lin_iters"))
    scale = max(np.abs(uj).max(), np.abs(pj).max())
    np.testing.assert_allclose([h["max_change"] for h in ht], [h["max_change"] for h in hj],
                               rtol=0, atol=F_TOL * scale)
    _fields_close(ut, pt, uj, pj)


def test_gls_picard_converges_as_jax():
    """Re 10 on ``cavity_legacy_deck(3)`` run to the deck's tolerance: the
    same number of Picard iterations."""
    uj, pj, hj = jm.GLSNavierStokesSolver(jg.cavity_legacy_deck(3, viscosity=0.1)).solve()
    ut, pt, ht = tm.GLSNavierStokesSolver(tg.cavity_legacy_deck(3, viscosity=0.1),
                                          device="cpu").solve()
    assert len(ht) == len(hj) < 50 and ht[-1]["max_change"] < 1e-6
    assert [h["lin_iters"] for h in ht] == [h["lin_iters"] for h in hj]
    _fields_close(ut, pt, uj, pj)


def test_gls_kovasznay_matches_jax():
    """GLS on ``kovasznay_legacy_deck()`` (8 x 12 x 2, Re 40, the exact
    solution on every boundary node), 3 Picard iterations."""
    uj, pj, hj = jm.GLSNavierStokesSolver(jg.kovasznay_legacy_deck()).solve(max_picard=3)
    ut, pt, ht = tm.GLSNavierStokesSolver(tg.kovasznay_legacy_deck(),
                                          device="cpu").solve(max_picard=3)
    assert [h["lin_iters"] for h in ht] == [h["lin_iters"] for h in hj] and len(ht) == 3
    _fields_close(ut, pt, uj, pj)


@pytest.mark.parametrize("n,outer", [(2, 8), (3, 5), (4, 4)])
def test_segregated_matches_jax(n, outer):
    """Re 10 cavity: equal outer counts and GMRES counts per momentum solve,
    each pressure CG against JAX's on the same system (module docstring),
    the max|dp| and monitor rows and the fields to 1e-9."""
    kw = dict(solver_tol=1e-10)
    uj, pj, hj = js.SegregatedSolver(jg.cavity_legacy_deck(n, viscosity=0.1),
                                     **kw).solve(max_outer=outer, tol=1e-12)
    st = ts.SegregatedSolver(tg.cavity_legacy_deck(n, viscosity=0.1), device="cpu", **kw)
    pressure = []
    krylov = st._krylov

    def recording(A, b, name):
        x, k = krylov(A, b, name)
        if name == "cg":
            pressure.append((A, b, x, k))
        return x, k

    st._krylov = recording
    ut, pt, ht = st.solve(max_outer=outer, tol=1e-12)
    assert len(ht) == len(hj) == outer == len(pressure)
    assert [h["mom_iters"] for h in ht] == [h["mom_iters"] for h in hj]
    for (A, b, x, k), h in zip(pressure, ht):
        _, k_jax = jl.solve_csr(A, b, "cg", tol=st.solver_tol, maxiter=st.solver_maxiter)
        x_depth, _ = jl.solve_csr(A, b, "cg", tol=0.0, maxiter=k)
        assert k == h["p_iters"] and abs(k - k_jax) <= P_ITERS_TOL, (k, k_jax)
        assert np.abs(x - x_depth).max() <= F_TOL * max(np.abs(x_depth).max(), 1e-300)
        if k < st.solver_maxiter:        # n = 4's first b is rounding (~1e-19): maxiter
            assert np.linalg.norm(b - A @ x) <= 2 * st.solver_tol * np.linalg.norm(b)
    scale = max(np.abs(uj).max(), np.abs(pj).max())
    dp_j = np.array([h["max_dp"] for h in hj])
    np.testing.assert_allclose([h["max_dp"] for h in ht], dp_j, rtol=0, atol=F_TOL * scale)
    for a, b in zip(ht, hj):
        assert [m["node"] for m in a["monitors"]] == [m["node"] for m in b["monitors"]]
        for ma, mb in zip(a["monitors"], b["monitors"]):
            for k in "uvwp":
                assert abs(ma[k] - mb[k]) <= F_TOL * scale
    _fields_close(ut, pt, uj, pj)
    lid = np.isclose(st.deck.coords[:, 2], 1.0)
    np.testing.assert_allclose(ut[lid, 0], 1.0, rtol=0, atol=1e-12)


def test_segregated_defaults_and_relaxation_check():
    """The JAX defaults exactly: ``min(solver_iter_max or 1000, 5000)``,
    ``solver_tol or 1e-10``, the deck's relaxation row and its (0, 1) check."""
    deck = tg.cavity_legacy_deck(2)
    deck.solver_iter_max, deck.solver_tol = 9000, None
    deck.relaxation = (0.3, 0.3, 0.3, 0.7)
    s = ts.SegregatedSolver(deck, device="cpu")
    assert (s.solver_maxiter, s.solver_tol) == (5000, 1e-10)
    np.testing.assert_allclose(s.alpha, [0.3, 0.3, 0.3, 0.7])
    assert (s.pressure_solver, s.momentum_solver, s.gmres_restart) == ("cg", "gmres", 100)
    deck.relaxation = (0.5, 1.0, 0.5, 0.5)
    with pytest.raises(ValueError, match=r"relaxation factors must be in \(0, 1\)"):
        ts.SegregatedSolver(deck, device="cpu")


def test_legacy_solvers_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = tg.cavity_legacy_deck(2)
    for make in (lambda: tm.StokesSolver(deck), lambda: tm.GLSNavierStokesSolver(deck),
                 lambda: ts.SegregatedSolver(deck),
                 lambda: tp.PoissonSolver(_cube_poisson_deck(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
