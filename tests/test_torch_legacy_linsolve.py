"""PyTorch port: ``ops/linsolve.py::solve_csr`` (every name), the legacy
deck generators and ``mesh/profiles.py::apply_node_bc_profile`` against the
JAX package on the same numpy inputs (CPU, float64).

``solve_csr``: the Krylov names on the ELL pack (Jacobi, BiCG through its
own pack of A^T, ``gmres_restart`` to GMRES only) give JAX's iteration
count and x within 1e-12 of max|x|; ``"splu"`` is the same scipy call;
``"dense_lu"`` gives JAX's refinement rounds (an f64 factor in both: one
round, or all 13 where the residual stalls above tol) and x within 1e-12
of max|x| (1e-11 on the kappa 1e5 system, whose x the factor fixes only to
kappa * eps).  The per-pattern cache: a second solve on the same
pattern reuses the cached column pack and uploads only the values.  A
singular matrix raises ``LinAlgError`` with the JAX message, and the size
guard the JAX ``ValueError``.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cfd_with_cuda_tpu.mesh import generators as jg
from cfd_with_cuda_tpu.mesh.profiles import apply_node_bc_profile as j_profile
from cfd_with_cuda_tpu.ops import linsolve as jl
from cfd_with_cuda_tpu_torch.mesh import generators as tg
from cfd_with_cuda_tpu_torch.mesh.profiles import apply_node_bc_profile as t_profile
from cfd_with_cuda_tpu_torch.ops import linsolve as tl

torch.set_num_threads(1)


def _sparse_system(symmetric, seed=42, n=60):
    """A banded, diagonally dominant sparse system (nonsymmetric: one clear
    off-diagonal asymmetry)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for k in (-7, -3, -1, 0, 1, 3, 7):
        idx = np.arange(max(0, -k), min(n, n - k))
        a[idx, idx + k] = rng.standard_normal(idx.size)
    if symmetric:
        a = a + a.T
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    if not symmetric:
        a[0, 1] += 7.0
    return sp.csr_matrix(a), rng.standard_normal(n)


@pytest.mark.parametrize("name", ["cg", "cr", "bicg", "bicgstab", "gmres", "splu"])
def test_solve_csr_matches_jax(name):
    A, b = _sparse_system(symmetric=name in ("cg", "cr"))
    kw = dict(tol=1e-12, maxiter=500, gmres_restart=8)
    xj, kj = jl.solve_csr(A, b, name, **kw)
    xt, kt = tl.solve_csr(A, b, name, device="cpu", **kw)
    assert kt == kj and (kt == 1 if name == "splu" else kt > 1)
    if name == "gmres":
        assert kt % 8 == 0                     # whole cycles of gmres_restart
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    np.testing.assert_allclose(A @ xt, b, rtol=0, atol=1e-9 * np.abs(b).max())


def test_solve_csr_bicg_uses_the_transpose():
    """BiCG on a nonsymmetric system needs A^T: with A's own pack in its
    place it would not converge to A's solution."""
    A, b = _sparse_system(symmetric=False)
    cache = {}
    xt, _ = tl.solve_csr(A, b, "bicg", tol=1e-12, maxiter=500, cache=cache, device="cpu")
    assert sorted(cache) == ["A:60x60:%d" % A.nnz, "tA:60x60:%d" % A.nnz]
    np.testing.assert_allclose(xt, np.linalg.solve(A.toarray(), b), rtol=0, atol=1e-10)


def test_solve_csr_cache_hit_refreshes_values():
    """A second solve on the same pattern with new values: the cached column
    pack (the same tensor) serves it, and the answers still match JAX's
    cached solves."""
    A, b = _sparse_system(symmetric=False)
    A2 = A.copy()
    A2.data = A2.data * np.linspace(0.9, 1.1, A2.nnz)
    jc, tc = {}, {}
    for M in (A, A2):
        xj, kj = jl.solve_csr(M, b, "gmres", tol=1e-12, maxiter=400, gmres_restart=10, cache=jc)
        xt, kt = tl.solve_csr(M, b, "gmres", tol=1e-12, maxiter=400, gmres_restart=10,
                              cache=tc, device="cpu")
        assert kt == kj
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
        if M is A:
            cols = tc[f"A:60x60:{A.nnz}"]["cols_dev"]
    assert tc[f"A:60x60:{A.nnz}"]["cols_dev"] is cols and len(tc) == 1
    np.testing.assert_allclose(A2 @ xt, b, rtol=0, atol=1e-9 * np.abs(b).max())


def _conditioned(n, kappa, seed):
    rng = np.random.default_rng(seed)
    d = np.geomspace(1.0, kappa, n)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return sp.csr_matrix((q1 * d) @ q2), rng.standard_normal(n)


@pytest.mark.parametrize("kappa,tol,rounds,x_tol", [
    (1e2, 1e-13, 1, 1e-12),
    (1e5, 1e-12, 13, 1e-11),
], ids=["one_round", "refined_to_the_cap"])
def test_solve_csr_dense_lu_refinement(kappa, tol, rounds, x_tol):
    """Nonsymmetric dense systems: kappa 1e2 meets tol after one round; the
    ``test_krylov.py::test_solve_csr_dense_lu`` system (kappa 1e5, tol
    1e-12) runs all 13 rounds in both packages, its f64 residual stalled at
    1.5e-12 of ||b||, where x is fixed only to kappa * eps (~1e-11 of
    max|x|; the two read 9.9e-13 apart)."""
    A, b = _conditioned(120, kappa, 3)
    xj, rj = jl.solve_csr(A, b, "dense_lu", tol=tol)
    xt, rt = tl.solve_csr(A, b, "dense_lu", tol=tol, device="cpu")
    assert rt == rj == rounds
    np.testing.assert_allclose(xt, xj, rtol=0, atol=x_tol * np.abs(xj).max())
    assert np.linalg.norm(b - A @ xt) <= max(tol, 2e-12) * np.linalg.norm(b)


def test_solve_csr_dense_lu_singular_raises():
    """A missing pressure pin: the JAX factor returns non-finite x, the
    port's factor reports a zero pivot; both raise the same LinAlgError."""
    a = np.eye(6)
    a[3, 3] = 0.0
    A, b = sp.csr_matrix(a), np.ones(6)
    with pytest.raises(np.linalg.LinAlgError) as ej:
        jl.solve_csr(A, b, "dense_lu")
    with pytest.raises(np.linalg.LinAlgError) as et:
        tl.solve_csr(A, b, "dense_lu", device="cpu")
    assert str(et.value) == str(ej.value)


def test_solve_csr_dense_lu_size_guard():
    n = tl.DENSE_DIRECT_LIMIT + 1
    assert n == jl.DENSE_DIRECT_LIMIT + 1
    A = sp.eye(n, format="csr")
    with pytest.raises(ValueError, match="dense_lu: n=20001 exceeds DENSE_DIRECT_LIMIT"):
        jl.solve_csr(A, np.ones(n), "dense_lu")
    with pytest.raises(ValueError, match="dense_lu: n=20001 exceeds DENSE_DIRECT_LIMIT"):
        tl.solve_csr(A, np.ones(n), "dense_lu", device="cpu")
    assert tl.DIRECT_SOLVERS == jl.DIRECT_SOLVERS
    assert tl.HOST_DIRECT_SOLVERS == jl.HOST_DIRECT_SOLVERS


def test_solve_csr_needs_a_card_unless_told_cpu(monkeypatch):
    A, b = _sparse_system(symmetric=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.solve_csr(A, b, "cg")
    x, k = tl.solve_csr(A, b, "splu")                  # the host solve needs none
    assert k == 1 and np.isfinite(x).all()


def _assert_decks_equal(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert type(a) is type(b) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("gen,args,kw", [
    ("cavity_legacy_deck", (2,), {}),
    ("cavity_legacy_deck", (4,), dict(cluster=1.5, viscosity=0.1, lid_velocity=(1.0, 0.5, 0.0))),
    ("kovasznay_legacy_deck", (), {}),
    ("kovasznay_legacy_deck", (4, 6, 2), dict(re=20.0, max_iter=7)),
])
def test_legacy_decks_equal_jax(gen, args, kw):
    _assert_decks_equal(getattr(tg, gen)(*args, **kw), getattr(jg, gen)(*args, **kw))


@pytest.mark.parametrize("deck_fn", [
    lambda g: g.kovasznay_legacy_deck(4, 6, 2),
    lambda g: g.cavity_legacy_deck(3),
], ids=["kovasznay", "cavity"])
def test_apply_node_bc_profile_matches_jax(deck_fn):
    """The Kovasznay legacy deck's exact-solution BC rows (and a deck with no
    profile, whose rows come back as given)."""
    deck = deck_fn(tg)
    vn = deck.bc_vel_nodes
    vals = deck.bc_str[vn[:, 1], :3]
    got = t_profile(deck, deck.coords, vn, vals.copy())
    want = j_profile(deck_fn(jg), deck.coords, vn, vals.copy())
    np.testing.assert_array_equal(got, want)
    if deck.inlet_profile is None:
        np.testing.assert_array_equal(got, vals)
    else:
        assert np.abs(got).max() > 0.5
