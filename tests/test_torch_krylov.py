"""PyTorch port: ``ops/krylov.py`` (BiCGStab and CG on batched systems, the MIXED
policy's f64 reductions, the breakdown guard) against the JAX package's
``ops/krylov.py`` on the same seeded systems; CG and CR with ``reduce=``
(the sum over ranks of fields split by rows) against themselves without
it, in one process and on 2 and 4 gloo ranks.

The system is nonsymmetric and strictly diagonally dominant, (3, N) right-
hand sides with one all-zero column (the v/w momentum columns of the first
cavity step): equal iteration counts, x to 1e-5 (f32: two implementations
whose sums run in another order, < 20 iterations) and 1e-12 (f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.ops import krylov as jk
from cfd_with_cuda_tpu_torch.ops import krylov as tk

torch.set_num_threads(1)

N = 96


def _system(dtype):
    rng = np.random.default_rng(20260816)
    a = rng.standard_normal((N, N)) * 0.3
    a[np.arange(N), np.arange(N)] = np.abs(a).sum(axis=1) + 1.0
    b = rng.standard_normal((3, N))
    b[1] = 0.0                                   # an all-zero column
    x0 = rng.standard_normal((3, N)) * 0.1
    return a.astype(dtype), b.astype(dtype), x0.astype(dtype)


def _solve_both(dtype, *, x0=False, **kw):
    a, b, x0_ = _system(dtype)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    dj, dt_ = jnp.asarray(np.diag(a).copy()), torch.from_numpy(np.diag(a).copy())
    calls = []

    def t_matvec(x):
        calls.append(1)
        return x @ at.T

    jkw = dict(kw)
    if "dot_dtype" in kw and kw["dot_dtype"] is not None:
        jkw["dot_dtype"] = jnp.float64
    ref = jk.bicgstab(lambda x: x @ aj.T, jnp.asarray(b),
                      x0=jnp.asarray(x0_) if x0 else None,
                      precond=lambda r: r / dj, **jkw)
    out = tk.bicgstab(t_matvec, torch.from_numpy(b),
                      x0=torch.from_numpy(x0_) if x0 else None,
                      precond=lambda r: r / dt_, **kw)
    return a, b, ref, out, len(calls)


@pytest.mark.parametrize("dtype,x_tol", [(np.float32, 1e-5), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_bicgstab_matches_jax(dtype, x_tol, warm):
    tol = 1e-6 if dtype == np.float32 else 1e-12
    a, b, ref, out, n_calls = _solve_both(dtype, x0=warm, tol=tol, atol=1e-15, maxiter=200)
    k = int(out.iters)
    assert k == int(ref.iters) > 0
    assert n_calls == 1 + 2 * k            # once for r0 (also cold), twice per iteration
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0, atol=x_tol)
    assert out.x.dtype == torch.from_numpy(b).dtype
    if not warm:
        assert np.all(out.x.numpy()[1] == 0.0)    # the zero column stays 0 (_safe_div)
    res = np.linalg.norm(b - out.x.numpy() @ a.T, axis=1).max()
    assert res <= 2 * tol * np.linalg.norm(b, axis=1).max()
    np.testing.assert_allclose(float(out.residual), float(ref.residual),
                               rtol=1e-2 if dtype == np.float32 else 1e-6, atol=1e-14)


def test_bicgstab_miniter_forces_a_step():
    """A converged warm start exits at 0 iterations unless miniter=1."""
    a, b, _ = _system(np.float64)
    x = np.linalg.solve(a, b.T).T
    at = torch.from_numpy(a)
    mv = lambda v: v @ at.T
    out0 = tk.bicgstab(mv, torch.from_numpy(b), x0=torch.from_numpy(x), tol=1e-6)
    out1 = tk.bicgstab(mv, torch.from_numpy(b), x0=torch.from_numpy(x), tol=1e-6, miniter=1)
    ref1 = jk.bicgstab(lambda v: v @ jnp.asarray(a).T, jnp.asarray(b), x0=jnp.asarray(x),
                       tol=1e-6, miniter=1)
    assert int(out0.iters) == 0 and int(out1.iters) == int(ref1.iters) == 1
    assert np.isfinite(out1.x.numpy()).all()
    np.testing.assert_allclose(out1.x.numpy(), x, rtol=0, atol=1e-10)


def test_bicgstab_dot_dtype_f64_reductions():
    """f32 state with f64 reductions (MIXED): equal counts with the JAX
    solver under the same policy, x to 1e-5, state stays f32."""
    _, _, ref, out, _ = _solve_both(np.float32, tol=1e-6, atol=1e-15, maxiter=200,
                                    dot_dtype=torch.float64)
    assert out.x.dtype == torch.float32
    assert int(out.iters) == int(ref.iters) > 0
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-5)


def test_make_dot_and_safe_div():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((2, 4096)) * 10.0 ** rng.uniform(-3, 3, (2, 4096))).astype(np.float32)
    dot, norm = tk._make_dot(torch.float64)
    got = dot(torch.from_numpy(a), torch.from_numpy(a))
    assert got.shape == (2, 1) and got.dtype == torch.float32
    exact = (a.astype(np.float64) ** 2).sum(axis=1)
    np.testing.assert_allclose(got.numpy()[:, 0], exact.astype(np.float32), rtol=2e-7)
    np.testing.assert_allclose(norm(torch.from_numpy(a)).numpy()[:, 0], np.sqrt(exact), rtol=2e-7)
    # |b| < 1e-35 -> 0 (this module's guard tests "<"; the fused CG's tests ">")
    num = torch.tensor([1.0, 2.0, 3.0])
    den = torch.tensor([0.0, 1e-36, 2.0])
    np.testing.assert_array_equal(tk._safe_div(num, den).numpy(), [0.0, 0.0, 1.5])
    np.testing.assert_array_equal(
        tk._safe_div(num, den).numpy(),
        np.asarray(jk._safe_div(jnp.asarray(num.numpy()), jnp.asarray(den.numpy()))),
    )


def _spd_system(dtype):
    rng = np.random.default_rng(20261016)
    m = rng.standard_normal((N, N)) * 0.3
    a = m @ m.T + np.diag(rng.uniform(4.0, 8.0, N))
    b = rng.standard_normal((3, N))
    b[1] = 0.0                                   # an all-zero column
    x0 = rng.standard_normal((3, N)) * 0.1
    return a.astype(dtype), b.astype(dtype), x0.astype(dtype)


@pytest.mark.parametrize("dtype,x_tol,dot_dtype", [
    (np.float32, 1e-5, None), (np.float32, 1e-5, "f64"), (np.float64, 1e-12, None),
], ids=["f32", "f32_f64_dot", "f64"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_matches_jax(dtype, x_tol, warm, dot_dtype):
    """Jacobi CG (the pressure solve of the unstructured path) against the
    JAX ``cg``: equal iteration counts (the ||r|| test every iteration),
    one matvec for r0 (also cold) and one per iteration."""
    a, b, x0 = _spd_system(dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    diag = np.diag(a).copy()
    calls = []

    def t_matvec(x):
        calls.append(1)
        return x @ torch.from_numpy(a).T

    ref = jk.cg(lambda x: x @ jnp.asarray(a).T, jnp.asarray(b),
                jnp.asarray(x0) if warm else None, tol=tol, maxiter=300,
                precond=lambda r: r / jnp.asarray(diag),
                dot_dtype=None if dot_dtype is None else jnp.float64)
    out = tk.cg(t_matvec, torch.from_numpy(b), torch.from_numpy(x0) if warm else None,
                tol=tol, maxiter=300, precond=lambda r: r / torch.from_numpy(diag),
                dot_dtype=None if dot_dtype is None else torch.float64)
    k = int(out.iters)
    assert k == int(ref.iters) > 0 and len(calls) == 1 + k
    assert out.x.dtype == torch.from_numpy(b).dtype
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0, atol=x_tol)
    if not warm:
        assert np.all(out.x.numpy()[1] == 0.0)    # the zero column stays 0 (_safe_div)
    res = np.linalg.norm(b - out.x.numpy() @ a.T, axis=1).max()
    assert res <= 2 * tol * np.linalg.norm(b, axis=1).max()


def test_cg_miniter_and_atol():
    """``miniter`` forces steps past a converged start; ``atol`` stops a
    solve whose relative bound it exceeds, as in the JAX ``cg``."""
    a, b, _ = _spd_system(np.float64)
    x = np.linalg.solve(a, b.T).T
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    for kw in (dict(miniter=2), dict(atol=1e-3), dict(atol=1e-3, miniter=3)):
        out = tk.cg(lambda v: v @ at.T, torch.from_numpy(b), torch.from_numpy(x * 0.9),
                    tol=1e-12, **kw)
        ref = jk.cg(lambda v: v @ aj.T, jnp.asarray(b), jnp.asarray(x * 0.9), tol=1e-12, **kw)
        assert int(out.iters) == int(ref.iters) >= kw.get("miniter", 1), kw
        np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(out.residual), float(ref.residual), rtol=0, atol=1e-11)


@pytest.mark.parametrize("dtype,dot_dtype", [
    (np.float32, None), (np.float32, torch.float64), (np.float64, None),
], ids=["f32", "f32_f64_dot", "f64"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", ["cg", "cr"])
def test_cg_cr_identity_reduce_keeps_the_bits(name, dtype, dot_dtype, warm):
    """``reduce`` batches the dots of a step into one call (one rank's sum
    is the whole sum): with the identity it returns ``reduce=None``'s x,
    residual and iteration count bit for bit, on the same matvecs."""
    a, b, x0 = _spd_system(dtype)
    at, diag = torch.from_numpy(a), torch.from_numpy(np.diag(a).copy())
    tol = 1e-6 if dtype == np.float32 else 1e-12
    outs, calls = [], []
    for reduce in (None, lambda t: t):
        calls.append(0)

        def matvec(x):
            calls[-1] += 1
            return x @ at.T

        outs.append(getattr(tk, name)(
            matvec, torch.from_numpy(b), torch.from_numpy(x0) if warm else None, tol=tol,
            maxiter=300, precond=lambda r: r / diag, dot_dtype=dot_dtype, reduce=reduce))
    plain, reduced = outs
    assert int(plain.iters) == int(reduced.iters) > 0 and calls[0] == calls[1]
    assert torch.equal(plain.x, reduced.x) and torch.equal(plain.residual, reduced.residual)
    assert reduced.x.dtype == torch.from_numpy(b).dtype


def _rank_rows_solve() -> dict:
    """CG and CR on the f64 SPD system of :func:`_spd_system`, this rank
    holding its block of the rows: the matvec all-gathers x, ``reduce`` is
    the sum over the ranks."""
    from cfd_with_cuda_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh()
    a, b, _ = _spd_system(np.float64)
    rows = slice(mesh.rank * N // mesh.size, (mesh.rank + 1) * N // mesh.size)
    a_rows = torch.from_numpy(a[rows])

    def matvec(x):
        full = torch.cat(tuple(sharding.all_gather(x, mesh)), dim=-1)
        return full @ a_rows.T

    diag = torch.from_numpy(np.diag(a)[rows].copy())
    out = {}
    for name in ("cg", "cr"):
        res = getattr(tk, name)(matvec, torch.from_numpy(b[:, rows].copy()), tol=1e-12,
                                maxiter=300, precond=lambda r: r / diag,
                                reduce=lambda t: sharding.all_reduce(t, mesh))
        out[name] = dict(x=res.x.numpy(), iters=int(res.iters), residual=float(res.residual))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_cg_cr_by_rows_over_ranks_match_one_process(n, tmp_path):
    """CG and CR solved by rows on n gloo ranks (``parallel/spawn.py``)
    against the one-process solve: x within 1e-12, equal iterations, and
    the same residual on every rank."""
    from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks

    a, b, _ = _spd_system(np.float64)
    diag = torch.from_numpy(np.diag(a).copy())
    by_rank = run_ranks(_rank_rows_solve, n, (), device="cpu", workdir=tmp_path)
    for name in ("cg", "cr"):
        ref = getattr(tk, name)(lambda x: x @ torch.from_numpy(a).T, torch.from_numpy(b),
                                tol=1e-12, maxiter=300, precond=lambda r: r / diag)
        res = [r[name] for r in by_rank]
        assert all(r["iters"] == int(ref.iters) > 0 for r in res), name
        assert len({r["residual"] for r in res}) == 1, name
        np.testing.assert_allclose(np.concatenate([r["x"] for r in res], axis=-1),
                                   ref.x.numpy(), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("name", ["cr", "bicg", "gmres"])
def test_solver_by_name_returns_the_rest_of_the_suite(name):
    """CR, BiCG and GMRES (held against the JAX package in
    ``tests/test_torch_krylov_suite.py``), with fixed keywords too."""
    assert tk.solver_by_name(name.upper()) is getattr(tk, name)
    fixed = tk.solver_by_name(name, tol=1e-8)
    assert fixed.func is getattr(tk, name) and fixed.keywords == {"tol": 1e-8}
    assert sorted(tk._SOLVERS) == sorted(jk._SOLVERS)


def test_solver_by_name():
    assert tk.solver_by_name("BiCGStab") is tk.bicgstab
    assert tk.solver_by_name("CG") is tk.cg
    fixed = tk.solver_by_name("bicgstab", maxiter=3)
    assert fixed.keywords == {"maxiter": 3}
    with pytest.raises(ValueError, match="unknown solver"):
        tk.solver_by_name("sor")
