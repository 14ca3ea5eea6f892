"""Krylov solvers on batched systems: CG and BiCGStab (+ Jacobi via ``precond``).

Port of ``cfd_with_cuda_tpu/ops/krylov.py`` as far as the port's solvers
reach it: ``KrylovResult``, the ``dot_dtype`` reductions of the MIXED
policy, the breakdown guard, ``cg`` (the pressure solve of the F64 and
``pressure_backend="xla"`` paths, of the ELL fallback and of the implicit
ELL step) and ``bicgstab`` (the implicit integrator's momentum solver).
``cr``/``bicg``/``gmres`` are not ported yet (``ROADMAP.md`` queue 1 item
6) and :func:`solver_by_name` says so.

The methods accept a ``matvec`` callable and right-hand sides shaped
``(N,)`` or ``(C, N)``: inner products reduce over the minor axis only, so
C independent systems (the 3 momentum directions the reference solves one
after the other, ``guermondQuartapelle.cpp:3972-4033``) share iterations
and converge when the *worst* system converges.  These are plain torch ops
(XLA ops in the JAX package, no kernel of their own); the loop decision is
read on the host once per iteration.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

__all__ = ["KrylovResult", "cg", "bicgstab", "solver_by_name"]


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
) -> KrylovResult:
    """Preconditioned conjugate gradient (SPD systems), ``matvec`` once for
    r0 (also with ``x0=None``), then once per iteration; ||r|| is tested
    on the host every iteration, as the JAX ``while_loop`` tests it."""
    M = precond or (lambda r: r)
    dot, norm = _make_dot(dot_dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = dot(r, z)
    bound = torch.clamp_min(tol * torch.max(norm(b)), atol)

    k = 0
    rn = torch.max(norm(r))
    # a NaN residual compares False and ends the loop, as lax.while_loop's
    while k < miniter or (k < maxiter and bool(rn > bound)):
        ap = matvec(p)
        alpha = _safe_div(rz, dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
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
) -> KrylovResult:
    """Preconditioned BiCGStab (general systems) — the reference's momentum
    solver (Paralution / cusp::krylov::bicgstab).  ``matvec`` is called
    once for r0 (also with ``x0=None``), then twice per iteration."""
    M = precond or (lambda r: r)
    dot, norm = _make_dot(dot_dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    rho = dot(rhat, r)
    p = r
    bound = torch.clamp_min(tol * torch.max(norm(b)), atol)

    k = 0
    rn = torch.max(norm(r))
    # a NaN residual compares False and ends the loop, as lax.while_loop's
    while k < miniter or (k < maxiter and bool(rn > bound)):
        phat = M(p)
        v = matvec(phat)
        alpha = _safe_div(rho, dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = _safe_div(dot(t, s), tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        k += 1
        rn = torch.max(norm(r))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


_SOLVERS = {"cg": cg, "bicgstab": bicgstab}
_NOT_PORTED = ("cr", "bicg", "gmres")


def solver_by_name(name: str, **fixed) -> Callable:
    """Look up a Krylov method (the runtime analogue of the reference's
    compile-time ``-DCG_CUDA/-DGMRES_CUSP/...`` backend selection)."""
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"not ported yet: Krylov solver {name!r} (the rest of the Krylov suite: "
            "ROADMAP.md queue 1 item 6(b))"
        )
    try:
        fn = _SOLVERS[key]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(_SOLVERS) + sorted(_NOT_PORTED)}"
        ) from None
    return functools.partial(fn, **fixed) if fixed else fn
