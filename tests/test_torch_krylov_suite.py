"""PyTorch port: the rest of the Krylov suite — ``cr``, ``bicg``, ``gmres``
(``_gmres_single`` and its restart) and ``solver_by_name`` — against the JAX
package's ``ops/krylov.py`` on the same numpy systems.

The systems are those of ``tests/test_krylov.py``: small dense SPD and
general ones, a badly scaled SPD one under Jacobi, an ill-conditioned one
for GMRES, 3 I for GMRES's happy breakdown, and the pinned pressure-Poisson
Z of a cube mesh as an ELL operator (``ell_spmv`` in both packages).  In
f64, x agrees to 1e-12 of max|x| with equal ``iters``, and ``residual`` to
1e-12 of ||b|| (a converged residual is rounding: the two read 1e-5 of
itself apart); f32 state with f64 reductions (``dot_dtype``) to 1e-5 of
max|x| (two f32 implementations whose sums run in other orders).

Two systems fix x only to rounding: CR under Jacobi at kappa 1e6 and GMRES
at kappa 1e8 (classical Gram-Schmidt).  There the JAX package parts from
itself when only its matvec's summation order changes (``x @ A^T`` for
``A @ x``): CR's ||r|| / bound reads 0.758 (JAX), 1.074 (JAX, other order)
and 1.083 (port) at k = 196, 0.617, 0.875 and 0.196 at 197, so the stops
fall at 196, 197 and 197, with x 5.5e-12 to 7.8e-12 of max|x| apart
between the two JAX runs; GMRES reads 2.35, 1.16 and 0.089 of its bound
after the 600 iterations of ``maxiter`` (JAX spread 7.2e-6 of max|x|, the
port 4.9e-6 from JAX).  These two are held within that spread: the count
within the two JAX counts widened by one step (one cycle for GMRES), x
within 4x the JAX spread (never under 1e-12 of max|x|).

GMRES counts ``iters`` in whole restart cycles, as the JAX code does
(restart 3, ``maxiter`` 4 gives 6).  A ``(C, N)`` right-hand side is held
column by column against JAX's ``_gmres_single``: the JAX package's own
batched branch raises (its ``vmap``'s ``out_axes`` is no prefix of
``KrylovResult``, ``krylov.py:441``), as the last test shows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu.fem.sparse import ell_from_csr
from cfd_with_cuda_tpu.mesh.generators import cube_hex_mesh
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu.ops import krylov as jk
from cfd_with_cuda_tpu.ops.spmv import ell_spmv as j_ell_spmv
from cfd_with_cuda_tpu_torch.ops import krylov as tk
from cfd_with_cuda_tpu_torch.ops.spmv import ell_spmv as t_ell_spmv

torch.set_num_threads(1)

X_TOL = 1e-12


def _spd(n, rng):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _general(n, rng):
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _scaled_spd(n, rng, top):
    d = np.geomspace(1.0, top, n)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * d) @ q.T + np.diag(d)


def _dense_ops(a):
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    return (lambda x: aj @ x), (lambda x: at @ x)


def _jacobi(a):
    d = np.diag(a).copy()
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    return (lambda r: r / dj), (lambda r: r / dt)


def _both(method, a, b, *, x0=None, precond=False, rmatvec=False, jmethod=None, **kw):
    """(JAX result, port result) of ``method`` on the dense system (a, b)."""
    mj, mt = _dense_ops(a)
    jkw, tkw = dict(kw), dict(kw)
    if precond:
        jkw["precond"], tkw["precond"] = _jacobi(a)
    if rmatvec:
        jkw["rmatvec"], tkw["rmatvec"] = _dense_ops(np.ascontiguousarray(a.T))
    ref = (jmethod or getattr(jk, method))(
        mj, jnp.asarray(b), None if x0 is None else jnp.asarray(x0), **jkw)
    out = getattr(tk, method)(mt, torch.from_numpy(b),
                              None if x0 is None else torch.from_numpy(x0), **tkw)
    return ref, out


def _assert_same(ref, out, b):
    """Equal counts, residuals within 1e-12 of ||b||, x within 1e-12 of max|x|."""
    xr = np.asarray(ref.x)
    assert int(out.iters) == int(ref.iters)
    assert abs(float(out.residual) - float(ref.residual)) <= 1e-12 * np.linalg.norm(b)
    np.testing.assert_allclose(out.x.numpy(), xr, rtol=0, atol=X_TOL * np.abs(xr).max())


def _within_jax_spread(method, a, b, step, **kw):
    """An ill-conditioned system (module docstring): the port against the
    JAX package's own spread under a change of its matvec's summation order."""
    at = jnp.asarray(np.ascontiguousarray(a.T))
    pj, pt = _jacobi(a)
    ref, out = _both(method, a, b, precond=True, **kw)
    other = getattr(jk, method)(lambda x: x @ at, jnp.asarray(b), precond=pj, **kw)
    counts = sorted((int(ref.iters), int(other.iters)))
    assert counts[0] - step <= int(out.iters) <= counts[1] + step, (counts, int(out.iters))
    xr = np.asarray(ref.x)
    spread = np.abs(np.asarray(other.x) - xr).max()
    assert np.abs(out.x.numpy() - xr).max() <= max(4 * spread, X_TOL * np.abs(xr).max())
    return out


@pytest.mark.parametrize("method", ["cg", "cr", "bicg", "bicgstab", "gmres"])
@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
def test_dense_systems_match_jax(method, precond):
    """SPD systems for cg / cr, general ones for bicg (true transpose),
    bicgstab and gmres (restart 20 of 40): equal counts, x to 1e-12."""
    rng = np.random.default_rng(42)
    n = 40
    a = _spd(n, rng) if method in ("cg", "cr") else _general(n, rng)
    b = rng.standard_normal(n)
    kw = dict(tol=1e-12 if method in ("cg", "cr", "bicg") else 1e-10, maxiter=500)
    if method == "gmres":
        kw["restart"] = 20
    ref, out = _both(method, a, b, precond=precond, rmatvec=method == "bicg", **kw)
    _assert_same(ref, out, b)
    assert 0 < int(out.iters) < 500
    np.testing.assert_allclose(out.x.numpy(), np.linalg.solve(a, b), atol=1e-6)


@pytest.mark.parametrize("method", ["cr", "gmres"])
def test_jacobi_on_badly_scaled_spd(method):
    """PCR's (z, Az) inner product and right-preconditioned GMRES under
    Jacobi on kappa ~ 1e6 (``test_krylov.py::test_preconditioned_cr_converges``);
    CR within the JAX spread (module docstring)."""
    rng = np.random.default_rng(7)
    a = _scaled_spd(80, rng, 1e6)
    b = rng.standard_normal(80)
    if method == "cr":
        out = _within_jax_spread("cr", a, b, 1, tol=1e-10, maxiter=3000)
    else:
        ref, out = _both(method, a, b, precond=True, tol=1e-10, maxiter=3000, restart=30)
        _assert_same(ref, out, b)
    assert int(out.iters) < 3000


def test_gmres_ill_conditioned():
    """kappa 1e8 with Jacobi, restart 60 (``test_krylov.py::test_gmres_ill_conditioned``),
    within the JAX spread (module docstring)."""
    rng = np.random.default_rng(8)
    d = np.geomspace(1.0, 1e8, 60)
    q, _ = np.linalg.qr(rng.standard_normal((60, 60)))
    a = (q * d) @ q.T
    b = a @ rng.standard_normal(60)
    out = _within_jax_spread("gmres", a, b, 60, tol=1e-13, maxiter=600, restart=60)
    assert np.linalg.norm(a @ out.x.numpy() - b) / np.linalg.norm(b) < 1e-10


def test_gmres_happy_breakdown():
    """3 I exhausts the Krylov space after one step: the Givens guard keeps
    c = 1, s = 0 and the dead columns' coefficients at 0."""
    rng = np.random.default_rng(9)
    a = np.eye(50) * 3.0
    b = rng.standard_normal(50)
    ref, out = _both("gmres", a, b, tol=1e-12, maxiter=200, restart=30)
    _assert_same(ref, out, b)
    assert int(out.iters) == 30
    np.testing.assert_allclose(out.x.numpy(), b / 3.0, rtol=0, atol=1e-12)


def test_gmres_counts_whole_cycles_past_maxiter():
    """restart 3, maxiter 4: two whole cycles, iters 6 in both packages."""
    rng = np.random.default_rng(10)
    a = _general(30, rng)
    b = rng.standard_normal(30)
    ref, out = _both("gmres", a, b, tol=1e-14, maxiter=4, restart=3, precond=True)
    assert int(ref.iters) == int(out.iters) == 6
    _assert_same(ref, out, b)


@pytest.mark.parametrize("restart,maxiter", [(3, 4), (20, 500)])
def test_gmres_batched_column_by_column(restart, maxiter):
    """A (3, N) right-hand side (one all-zero column, a warm start) against
    JAX's ``_gmres_single`` on each column: x stacks the columns, iters and
    residual are their maxima."""
    rng = np.random.default_rng(11)
    n = 30
    a = _general(n, rng)
    b = rng.standard_normal((3, n))
    b[1] = 0.0
    x0 = rng.standard_normal((3, n)) * 0.1
    mj, mt = _dense_ops(a)
    pj, pt = _jacobi(a)
    kw = dict(tol=1e-10, atol=0.0, maxiter=maxiter, restart=restart)
    cols = [jk._gmres_single(mj, jnp.asarray(b[c]), jnp.asarray(x0[c]), precond=pj, **kw)
            for c in range(3)]
    out = tk.gmres(mt, torch.from_numpy(b), torch.from_numpy(x0), precond=pt, **kw)
    xr = np.stack([np.asarray(c.x) for c in cols])
    assert int(out.iters) == max(int(c.iters) for c in cols)
    np.testing.assert_allclose(out.x.numpy(), xr, rtol=0, atol=X_TOL * np.abs(xr).max())
    res = max(float(c.residual) for c in cols)
    assert abs(float(out.residual) - res) <= 1e-12 * np.linalg.norm(b, axis=1).max()
    for c in range(3):
        one = tk.gmres(mt, torch.from_numpy(b[c]), torch.from_numpy(x0[c]), precond=pt, **kw)
        assert int(one.iters) == int(cols[c].iters)
        np.testing.assert_array_equal(one.x.numpy(), out.x.numpy()[c])


@pytest.mark.parametrize("method", ["cr", "bicg", "gmres"])
def test_dot_dtype_f64_reductions(method):
    """f32 state with f64 reductions (the MIXED policy): equal counts, x to
    1e-5 of max|x|, the state stays f32."""
    rng = np.random.default_rng(12)
    n = 40
    a = (_spd(n, rng) if method == "cr" else _general(n, rng)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    kw = dict(tol=1e-6, maxiter=300)
    if method == "gmres":
        kw["restart"] = 20
    mj, mt = _dense_ops(a)
    pj, pt = _jacobi(a)
    extra_j, extra_t = {}, {}
    if method == "bicg":
        extra_j["rmatvec"], extra_t["rmatvec"] = _dense_ops(np.ascontiguousarray(a.T))
    ref = getattr(jk, method)(mj, jnp.asarray(b), precond=pj, dot_dtype=jnp.float64,
                              **kw, **extra_j)
    out = getattr(tk, method)(mt, torch.from_numpy(b), precond=pt, dot_dtype=torch.float64,
                              **kw, **extra_t)
    assert out.x.dtype == torch.float32
    assert int(out.iters) == int(ref.iters) > 0
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(out.x.numpy(), xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@pytest.mark.parametrize("method", ["cr", "bicg", "gmres"])
def test_miniter_and_atol(method):
    """A warm start inside tol ||b||: 0 iterations and x0 back bitwise;
    ``miniter=1`` forces a step (GMRES: a whole cycle); ``atol`` above the
    relative bound stops the solve early — each as in the JAX package."""
    rng = np.random.default_rng(13)
    n = 24
    a = _spd(n, rng)
    x_true = rng.standard_normal(n)
    b = a @ x_true
    x0 = x_true + 1e-8 * np.linalg.norm(x_true) * rng.standard_normal(n)
    kw = dict(tol=1e-6, maxiter=200, rmatvec=method == "bicg")
    if method == "gmres":
        kw["restart"] = 10
    ref, out = _both(method, a, b, x0=x0, **kw)
    assert int(out.iters) == int(ref.iters) == 0
    np.testing.assert_array_equal(out.x.numpy(), x0)
    ref, out = _both(method, a, b, x0=x0, miniter=1, **kw)
    assert int(out.iters) == int(ref.iters) == (10 if method == "gmres" else 1)
    _assert_same(ref, out, b)
    ref, out = _both(method, a, b, atol=1e-3 * np.linalg.norm(b), **dict(kw, tol=1e-14))
    _assert_same(ref, out, b)
    assert 0 < int(out.iters) < 200


def _pinned_poisson_z():
    """The pinned Z of ``test_krylov.py::test_cg_on_pressure_poisson_with_pin``
    in slot-major ELL, and a compatible right-hand side."""
    coords, conn = cube_hex_mesh(3)
    mesh = promote_hex_mesh(conn, coords)
    tab = build_element_tables(mesh.coords, mesh.ltog_node)
    ops = assemble_operators(tab, mesh.ltog_node, mesh.nn, mesh.ncn, viscosity=0.01,
                             density=1.0)
    z = ops.Z.tocsr().astype(np.float64)
    pin = 13
    z = z.tolil()
    z[pin, pin] = z[pin, pin] * 1000.0
    z = z.tocsr()
    z.sort_indices()
    rng = np.random.default_rng(14)
    b = rng.standard_normal(mesh.ncn)
    b -= b.mean()
    b[pin] = 0.0
    ell = ell_from_csr(z.indptr.astype(np.int64), z.indices.astype(np.int64), z.data,
                       n_cols=mesh.ncn)
    return z, ell, b


@pytest.mark.parametrize("method", ["cg", "cr", "bicg", "bicgstab", "gmres"])
def test_ell_pressure_poisson_matches_jax(method):
    """Every method on the pinned pressure Z as an ELL operator (``bicg``'s
    transpose: Z is symmetric, so the same pack), Jacobi, tol 1e-12."""
    z, ell, b = _pinned_poisson_z()
    vj, cj = jnp.asarray(ell.vals), jnp.asarray(ell.cols)
    vt, ct = torch.from_numpy(ell.vals), torch.from_numpy(ell.cols.astype(np.int64))
    d = z.diagonal()
    kw = dict(tol=1e-12, maxiter=1000)
    jkw = dict(kw, precond=lambda r: r / jnp.asarray(d))
    tkw = dict(kw, precond=lambda r: r / torch.from_numpy(d))
    if method == "gmres":
        jkw["restart"] = tkw["restart"] = 40
    if method == "bicg":
        jkw["rmatvec"] = lambda x: j_ell_spmv(vj, cj, x)
        tkw["rmatvec"] = lambda x: t_ell_spmv(vt, ct, x)
    ref = getattr(jk, method)(lambda x: j_ell_spmv(vj, cj, x), jnp.asarray(b), **jkw)
    out = getattr(tk, method)(lambda x: t_ell_spmv(vt, ct, x), torch.from_numpy(b), **tkw)
    _assert_same(ref, out, b)
    assert np.linalg.norm(z @ out.x.numpy() - b) / np.linalg.norm(b) < 1e-10


def test_bicg_needs_rmatvec_or_declared_symmetry():
    rng = np.random.default_rng(15)
    a = _spd(10, rng)
    b = rng.standard_normal(10)
    mj, mt = _dense_ops(a)
    with pytest.raises(ValueError, match="rmatvec") as ej:
        jk.bicg(mj, jnp.asarray(b), tol=1e-10, maxiter=50)
    with pytest.raises(ValueError, match="rmatvec") as et:
        tk.bicg(mt, torch.from_numpy(b), tol=1e-10, maxiter=50)
    assert str(et.value) == str(ej.value)
    ref, out = _both("bicg", a, b, tol=1e-12, maxiter=200, assume_symmetric=True)
    _assert_same(ref, out, b)
    cg = tk.cg(mt, torch.from_numpy(b), tol=1e-12, maxiter=200)
    np.testing.assert_array_equal(out.x.numpy(), cg.x.numpy())


def test_jax_batched_gmres_raises():
    """The JAX package's batched GMRES branch fails (the reference defect
    the port's column loop does not share)."""
    rng = np.random.default_rng(16)
    a = _general(8, rng)
    b = rng.standard_normal((2, 8))
    with pytest.raises(ValueError, match="out_axes"):
        jk.gmres(lambda x: jnp.asarray(a) @ x, jnp.asarray(b), tol=1e-8, restart=4)
