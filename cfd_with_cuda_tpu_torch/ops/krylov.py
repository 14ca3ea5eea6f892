"""Krylov solver suite: CG, CR, BiCG, BiCGStab, GMRES(restart) + Jacobi.

Port of ``cfd_with_cuda_tpu/ops/krylov.py``: ``KrylovResult``, the
``dot_dtype`` reductions of the MIXED policy, the breakdown guard and the
five methods.  ``cg`` is the pressure solve of the F64 and
``pressure_backend="xla"`` paths, of the ELL fallback and of the implicit
ELL step, ``bicgstab`` the implicit integrator's momentum solver; every
method is reachable through :func:`solver_by_name` (the implicit
``momentum_solver`` choice, ``ops/linsolve.py`` and the legacy solvers).

The methods accept a ``matvec`` callable and right-hand sides shaped
``(N,)`` or ``(C, N)``: inner products reduce over the minor axis only, so
C independent systems (the 3 momentum directions the reference solves one
after the other, ``guermondQuartapelle.cpp:3972-4033``) share iterations
and converge when the *worst* system converges (GMRES solves the columns
one after the other, see :func:`gmres`).  These are plain torch ops (XLA
ops in the JAX package, no kernel of their own); the loop decision is read
on the host once per iteration (GMRES: once per Arnoldi step).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["KrylovResult", "cg", "cr", "bicg", "bicgstab", "gmres", "solver_by_name"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor       # iterations actually performed (0-d int32)
    residual: torch.Tensor    # final ||r|| (0-d; max over batched columns)


def _dot(a, b):
    """Per-system inner product over the minor axis, keepdim so the
    resulting Krylov scalars broadcast against (C, N) iterates."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _make_dot(dot_dtype):
    """(dot, norm) pair; with ``dot_dtype`` set, products are accumulated
    in that dtype and cast back — the mixed-precision mode (f32 state +
    f64 reductions; the reductions are where f32 Krylov loses
    orthogonality first)."""
    if dot_dtype is None:
        return _dot, _norm

    def dot(a, b):
        acc = torch.sum(a.to(dot_dtype) * b.to(dot_dtype), dim=-1, keepdim=True)
        return acc.to(a.dtype)

    def norm(a):
        return torch.sqrt(dot(a, a))

    return dot, norm


# Smallest safe divisor (as the JAX package, whose floor guards the TPU's
# subnormal-divisor NaN); scalars this small only occur at true Krylov
# breakdown / full convergence, where freezing is the right behaviour.
_DIV_FLOOR = 1e-35


def _safe_div(a, b):
    """a / b with 0 where |b| is (numerically) zero.

    Batched right-hand sides can contain all-zero columns (e.g. the v/w
    momentum RHS on the first symmetric cavity step); their Krylov scalars
    are 0/0 and the column must simply stay at x = 0 instead of NaN-ing
    the whole batch.  Also freezes a column on true breakdown (rho -> 0).
    """
    zero = b.abs() < _DIV_FLOOR
    return torch.where(zero, torch.zeros_like(a), a / torch.where(zero, torch.ones_like(b), b))


def _dots_of(dot_dtype, reduce):
    """``dots(*pairs)``: the per-system inner products of the ``(a, b)``
    pairs, as :func:`_make_dot`'s ``dot`` computes each; with ``reduce`` (a
    sum over ranks of a ``(..., k)`` tensor, the sharded path's
    ``all_reduce``) the local products of all pairs go through one call, and
    the cast back to the state dtype follows the sum."""
    if reduce is None:
        dot, _ = _make_dot(dot_dtype)
        return lambda *pairs: tuple(dot(a, b) for a, b in pairs)

    def dots(*pairs):
        dd = dot_dtype or pairs[0][0].dtype
        acc = torch.cat([torch.sum(a.to(dd) * b.to(dd), dim=-1, keepdim=True)
                         for a, b in pairs], dim=-1)
        return tuple(t.to(pairs[0][0].dtype) for t in reduce(acc).split(1, dim=-1))

    return dots


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Callable | None = None,
    dot_dtype=None,
    miniter: int = 0,
    reduce: Callable | None = None,
) -> KrylovResult:
    """Preconditioned conjugate gradient (SPD systems), ``matvec`` once for
    r0 (also with ``x0=None``), then once per iteration; ||r|| is tested
    on the host every iteration, as the JAX ``while_loop`` tests it.
    ``reduce`` as :func:`bicgstab`'s: one for the start and two an
    iteration."""
    M = precond or (lambda r: r)
    dots = _dots_of(dot_dtype, reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    p = z
    rz, bb, rr = dots((r, z), (b, b), (r, r))
    bound = torch.clamp_min(tol * torch.max(torch.sqrt(bb)), atol)

    k = 0
    rn = torch.max(torch.sqrt(rr))
    # a NaN residual compares False and ends the loop, as lax.while_loop's
    while k < miniter or (k < maxiter and bool(rn > bound)):
        ap = matvec(p)
        alpha = _safe_div(rz, dots((p, ap))[0])
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new, rr = dots((r, z), (r, r))
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
        rn = torch.max(torch.sqrt(rr))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


def cr(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Callable | None = None,
    dot_dtype=None,
    miniter: int = 0,
    reduce: Callable | None = None,
) -> KrylovResult:
    """Preconditioned conjugate residual (symmetric systems), ``matvec``
    twice for the start (r0, A z0), then once per iteration.  ``reduce`` as
    :func:`bicgstab`'s: one for the start and two an iteration."""
    M = precond or (lambda r: r)
    dots = _dots_of(dot_dtype, reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    p = z
    az = matvec(z)
    ap = az
    # the PCR inner product is (z, Az), not (r, Az): the two coincide only
    # for M = I, and with Jacobi M the (r, Az) form diverges
    zaz, bb, rr = dots((z, az), (b, b), (r, r))
    bound = torch.clamp_min(tol * torch.max(torch.sqrt(bb)), atol)

    k = 0
    rn = torch.max(torch.sqrt(rr))
    while k < miniter or (k < maxiter and bool(rn > bound)):
        map_ = M(ap)
        alpha = _safe_div(zaz, dots((ap, map_))[0])
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        az = matvec(z)
        zaz_new, rr = dots((z, az), (r, r))
        beta = _safe_div(zaz_new, zaz)
        p = z + beta * p
        ap = az + beta * ap
        zaz = zaz_new
        k += 1
        rn = torch.max(torch.sqrt(rr))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


def bicg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rmatvec: Callable | None = None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Callable | None = None,
    dot_dtype=None,
    assume_symmetric: bool = False,
    miniter: int = 0,
) -> KrylovResult:
    """BiConjugate gradient (general systems; needs the A^T apply).

    ``rmatvec`` is the transpose apply: ``ops.linsolve`` wires it from a
    host CSR matrix (the reference's CUSP BiCG uses A^T internally,
    ``oldFiles/segregatedSolver/CUSP_BiCG.cu:60``).  Omitting it is an
    error unless ``assume_symmetric=True`` declares the operator symmetric,
    and then the shadow recursion is the primal one and BiCG is :func:`cg`.
    ``matvec`` and ``rmatvec`` are called once each for the start (r0 is
    also the shadow residual, so ``rmatvec`` only from the first
    iteration), then once each per iteration."""
    if rmatvec is None and not assume_symmetric:
        raise ValueError(
            "bicg on a (potentially) nonsymmetric operator needs rmatvec="
            "A^T apply; pass assume_symmetric=True only if A is symmetric"
        )
    if rmatvec is None:
        return cg(
            matvec, b, x0, tol=tol, atol=atol, maxiter=maxiter,
            precond=precond, dot_dtype=dot_dtype, miniter=miniter,
        )
    M = precond or (lambda r: r)
    dot, norm = _make_dot(dot_dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rt = r
    z = M(r)
    p, pt = z, M(rt)
    rz = dot(rt, z)
    bound = torch.clamp_min(tol * torch.max(norm(b)), atol)

    k = 0
    rn = torch.max(norm(r))
    while k < miniter or (k < maxiter and bool(rn > bound)):
        ap = matvec(p)
        atpt = rmatvec(pt)
        alpha = _safe_div(rz, dot(pt, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rt = rt - alpha * atpt
        z = M(r)
        zt = M(rt)
        rz_new = dot(rt, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        pt = zt + beta * pt
        rz = rz_new
        k += 1
        rn = torch.max(norm(r))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    atol: float = 1e-15,
    maxiter: int = 1000,
    precond: Callable | None = None,
    dot_dtype=None,
    miniter: int = 0,
    reduce: Callable | None = None,
) -> KrylovResult:
    """Preconditioned BiCGStab (general systems) — the reference's momentum
    solver (Paralution / cusp::krylov::bicgstab).  ``matvec`` is called
    once for r0 (also with ``x0=None``), then twice per iteration.  On the
    sharded path each rank passes its block of the rows and ``reduce``, the
    sum over ranks: the dots and norms are local sums plus one ``reduce``
    for the start and three an iteration (the pairs that the recurrence
    needs together share one)."""
    M = precond or (lambda r: r)
    dots = _dots_of(dot_dtype, reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    rho, bb, rr = dots((rhat, r), (b, b), (r, r))
    p = r
    bound = torch.clamp_min(tol * torch.max(torch.sqrt(bb)), atol)

    k = 0
    rn = torch.max(torch.sqrt(rr))
    # a NaN residual compares False and ends the loop, as lax.while_loop's
    while k < miniter or (k < maxiter and bool(rn > bound)):
        phat = M(p)
        v = matvec(phat)
        alpha = _safe_div(rho, dots((rhat, v))[0])
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt, ts = dots((t, t), (t, s))
        omega = _safe_div(ts, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new, rr = dots((rhat, r), (r, r))
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        k += 1
        rn = torch.max(torch.sqrt(rr))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)




def _gmres_single(
    matvec, b, x0, *, tol, atol, maxiter, restart, precond, dot_dtype=None,
    miniter: int = 0,
) -> KrylovResult:
    """Restarted GMRES on one ``(N,)`` system, right-preconditioned, as the
    JAX package's ``_gmres_single`` computes it:

    * the orthogonalisation is classical Gram-Schmidt in one product,
      ``h = V[:j+1] @ w`` then ``w -= h @ V[:j+1]`` (``h`` and the norms
      accumulate in ``dot_dtype``);
    * the Hessenberg column is rotated into the triangular factor by Givens
      rotations as it is produced; after a breakdown (``hypot < 1e-35``)
      the new rotation stays ``c = 1, s = 0``;
    * every cycle runs all ``restart`` Arnoldi steps, ``iters`` counts whole
      cycles (so it can pass ``maxiter``), and ``miniter`` > 0 forces one
      whole cycle;
    * the stopping test takes the plain norm of ``b - A x`` before every
      cycle against ``max(tol ||b||, atol)``.

    Where it runs: the basis ``V (restart + 1, N)`` and ``w`` stay on
    ``b``'s device.  The (restart + 1)-long Hessenberg column, its
    rotations, the right-hand side ``g`` and the back substitution live on
    the host in ``b``'s dtype, so each Arnoldi step reads the host once (its
    ``h`` and ``||w||`` together; on the device the rotations would be some
    5,000 scalar launches a cycle of 100), and each cycle once more for the
    stopping test and ``||r0||``, then uploads its ``y`` once.  The cycle
    starts from the residual of the stopping test (the same ``x``, so the
    same ``matvec``), and the final ``residual`` is that of the last test:
    ``matvec`` runs ``restart + 1`` times a cycle and once more at the end.
    """
    M = precond or (lambda r: r)
    dd = dot_dtype or b.dtype
    npdt = torch.zeros(0, dtype=b.dtype).numpy().dtype.type

    def vnorm(v):
        return torch.sqrt(torch.sum(v.to(dd) * v.to(dd))).to(b.dtype)

    n = b.shape[0]
    m = restart
    eps = npdt(_DIV_FLOOR)
    zero, one = npdt(0), npdt(1)
    bound = max(npdt(tol) * npdt(torch.linalg.vector_norm(b).item()), npdt(atol))

    def residual(x):
        """r = b - A x, its plain norm and ||r|| in ``dot_dtype`` (one read)."""
        r = b - matvec(x)
        rn, beta = torch.stack([torch.linalg.vector_norm(r), vnorm(r)]).cpu().numpy()
        return r, rn, beta

    def cycle(x, r, beta):
        V = b.new_zeros((m + 1, n))
        V[0] = r / max(beta, eps)
        rcols = np.zeros((m, m + 1), npdt)     # column j of the rotated factor
        cs = np.ones(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        for j in range(m):
            w = matvec(M(V[j]))
            vj = V[: j + 1]
            hd = (vj.to(dd) @ w.to(dd)).to(b.dtype)
            w = w - hd @ vj
            hj1 = vnorm(w)
            V[j + 1] = w / torch.clamp_min(hj1, float(eps))
            h = np.zeros(m + 1, npdt)
            h[: j + 2] = torch.cat([hd, hj1[None]]).cpu().numpy()
            for i in range(j):             # the earlier rotations, in turn
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
            c, s = (one, zero) if denom < eps else (h[j] / denom, h[j + 1] / denom)
            cs[j], sn[j] = c, s
            h[j] = c * h[j] + s * h[j + 1]
            h[j + 1] = zero
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            rcols[j] = h
        # back substitution T y = g[:m], T[i, j] = rcols[j, i]
        y = np.zeros(m, npdt)
        for i in range(m - 1, -1, -1):
            num = g[i] - rcols[:, i] @ y
            piv = rcols[i, i]
            y[i] = zero if abs(piv) < eps else num / piv
        return x + M(torch.from_numpy(y).to(b.device) @ V[:m])

    x = torch.zeros_like(b) if x0 is None else x0
    k = 0
    r, rn, beta = residual(x)
    # a NaN residual compares False and ends the loop, as lax.while_loop's
    while k < miniter or (k < maxiter and rn > bound):
        x = cycle(x, r, beta)
        k += m
        r, rn, beta = residual(x)
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device),
                        torch.tensor(rn, dtype=b.dtype, device=b.device))


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    restart: int = 100,
    precond: Callable | None = None,
    dot_dtype=None,
    miniter: int = 0,
) -> KrylovResult:
    """Restarted GMRES — the reference's CUSP momentum/monolithic solver
    (``oldFiles/segregatedSolver/CUSP_GMRES.cu:75``, restart=100); see
    :func:`_gmres_single`.

    A ``(C, N)`` ``b`` is C independent length-N systems, as the JAX
    docstring states: each column runs its own loop (one after the other,
    ``matvec`` and ``precond`` called on ``(N,)`` columns), ``x`` stacks
    the columns, ``iters`` and ``residual`` are the maximum over them.
    (The JAX package's batched branch does not run: its ``vmap``'s
    ``out_axes`` is no prefix of ``KrylovResult``, ``krylov.py:441``.)"""
    kw = dict(tol=tol, atol=atol, maxiter=maxiter, restart=restart, precond=precond,
              dot_dtype=dot_dtype, miniter=miniter)
    if b.ndim == 1:
        return _gmres_single(matvec, b, x0, **kw)
    x0 = torch.zeros_like(b) if x0 is None else x0
    cols = [_gmres_single(matvec, b[c], x0[c], **kw) for c in range(b.shape[0])]
    return KrylovResult(torch.stack([c.x for c in cols]),
                        torch.max(torch.stack([c.iters for c in cols])),
                        torch.max(torch.stack([c.residual for c in cols])))


_SOLVERS = {"cg": cg, "cr": cr, "bicg": bicg, "bicgstab": bicgstab, "gmres": gmres}


def solver_by_name(name: str, **fixed) -> Callable:
    """Look up a Krylov method (the runtime analogue of the reference's
    compile-time ``-DCG_CUDA/-DGMRES_CUSP/...`` backend selection)."""
    try:
        fn = _SOLVERS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(_SOLVERS)}"
        ) from None
    return functools.partial(fn, **fixed) if fixed else fn
