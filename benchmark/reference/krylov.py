"""Krylov solves of the reference and the precisions it runs in.

``pcg`` is Jacobi-preconditioned CG with the stopping rule the solver
configuration states (``||r|| <= tol ||b||``, looked at every ``every``
iterations, as ``SolverConfig.pressure_cg_unroll`` groups them unless the
loop is fused).
"""

from __future__ import annotations

import torch

__all__ = ["Precision", "pcg"]

_FLOOR = 1e-35


class Precision:
    """The arithmetic a reference runs in: ``"f64"`` (the judge), or
    ``"tf32"`` (the control: f32 storage and accumulation, every product's
    operands rounded to TF32's 10-bit mantissa, as a TF32 tensor core takes
    them)."""

    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def rnd(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a product's operand."""
        if self.name != "tf32":
            return t
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)


def _div(a, b):
    return torch.where(torch.abs(b) > _FLOOR, a / torch.where(b == 0, 1, b), 0)


def pcg(matvec, dinv, b, x0=None, *, tol: float, maxiter: int, every: int = 1):
    """(x, iterations) of Jacobi PCG on ``b (n,)``."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x) if x0 is not None else b.clone()
    bound = tol * float(torch.linalg.vector_norm(b))
    if bound == 0.0:
        return x, 0
    z = dinv * r
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter:
        if k % every == 0 and not float(torch.linalg.vector_norm(r)) > bound:
            break
        ap = matvec(p)
        alpha = _div(rz, torch.dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = dinv * r
        rz_new = torch.dot(r, z)
        p = z + _div(rz_new, rz) * p
        rz = rz_new
        k += 1
    return x, k
