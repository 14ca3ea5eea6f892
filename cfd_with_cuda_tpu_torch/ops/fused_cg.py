"""The whole-solve Jacobi-preconditioned CG on a window operator.

Port of ``cfd_with_cuda_tpu/ops/pallas_cg.py::fused_cg`` with the
``fuse_loop=True`` contract (the entire solve, init and convergence loop
included, is ONE launch: ``csrc/cg_solve.cu``) and ``dot_mode="plain"``.
The operator is a plain ``(W^3, n)`` window, ``(Z v)[i] = sum_w win[w, i]
* v[i + off_w]`` with v zero outside [0, n); the TPU kernel's DMA-block
weight layout (``cg_weight_layout``, ``pick_kp``) has no counterpart here.

Math (same as the TPU kernel): warm r0 = b - Z x0 (cold r0 = b); stop when
||r|| <= max(tol * ||b||, 0) or k = maxiter; alpha and beta through
``_safe_div`` (0 when |den| <= 1e-35); returns x, k and ||r||.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops.krylov import KrylovResult
from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets

__all__ = ["fused_cg", "fused_cg_plain", "window_apply_plain"]

_DIV_FLOOR = 1e-35


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ok = b.abs() > _DIV_FLOOR
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def window_apply_plain(win: torch.Tensor, v: torch.Tensor, offs) -> torch.Tensor:
    """``(Z v)[i] = sum_w win[w, i] * v[i + offs[w]]``, slots in order."""
    n = v.shape[0]
    halo = max(abs(o) for o in offs)
    v_ext = F.pad(v, (halo, halo))
    ap = torch.zeros_like(v)
    for w, o in enumerate(offs):
        ap = ap + win[w] * v_ext[halo + o: halo + o + n]
    return ap


def fused_cg_plain(win, b, dinv, *, dims, radius, tol, maxiter, x0=None) -> KrylovResult:
    """Plain PyTorch version of :func:`fused_cg` (the loop decision is read
    on the host every iteration)."""
    offs = window_offsets(dims, radius)
    dot = lambda u, v: torch.sum(u * v)
    if x0 is not None:
        r = b - window_apply_plain(win, x0, offs)
        x = x0.clone()
    else:
        r = b.clone()
        x = torch.zeros_like(b)
    z = r * dinv
    p = z
    rz = dot(r, z)
    rn = torch.sqrt(dot(r, r))
    bound = tol * torch.sqrt(dot(b, b))
    bound = torch.where(bound < 0, torch.zeros_like(bound), bound)
    k = 0
    while k < maxiter and bool(rn > bound):
        ap = window_apply_plain(win, p, offs)
        alpha = _safe_div(rz, dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = r * dinv
        rz_new = dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        k += 1
        rz = rz_new
        rn = torch.sqrt(dot(r, r))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


@functools.lru_cache(maxsize=16)
def _offs_table(offs, device: torch.device) -> torch.Tensor:
    return torch.tensor(offs, dtype=torch.int32, device=device)


def fused_cg(win, b, dinv, *, dims, radius, tol, maxiter, x0=None) -> KrylovResult:
    """Jacobi-PCG solve of Z x = b for the window operator ``win (W^3, n)``
    (W = 2 radius + 1, z-major window scan over the grid ``dims``), ``b``
    and ``dinv (n,)``, optional warm start ``x0 (n,)``.  Returns
    :class:`KrylovResult` with 0-d ``iters`` and ``residual`` left on the
    device.  A CPU tensor runs :func:`fused_cg_plain`; a CUDA tensor
    launches ``csrc/cg_solve.cu`` once."""
    if b.device.type == "cpu":
        return fused_cg_plain(win, b, dinv, dims=dims, radius=radius, tol=tol,
                              maxiter=maxiter, x0=x0)
    if b.device.type != "cuda":
        raise ValueError(f"fused_cg: unsupported device {b.device}")
    offs = window_offsets(dims, radius)
    n = b.shape[0]
    if win.shape != (len(offs), n) or dinv.shape != (n,) or b.shape != (n,):
        raise ValueError(f"fused_cg: shapes win {tuple(win.shape)}, b {tuple(b.shape)}, dinv {tuple(dinv.shape)}")
    if x0 is not None and x0.shape != (n,):
        raise ValueError(f"fused_cg: x0 shape {tuple(x0.shape)}")
    ops = [win, b, dinv] + ([x0] if x0 is not None else [])
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("fused_cg: operands must be f32")
    if any(t.device != b.device or not t.is_contiguous() for t in ops):
        raise ValueError("fused_cg: operands must be contiguous on one device")
    x = torch.empty_like(b)
    work = torch.empty((3, n), dtype=b.dtype, device=b.device)          # r, p, q
    part = torch.empty(6 * cuda_lib.function("cg_solve_max_blocks")(),
                       dtype=b.dtype, device=b.device)
    k = torch.empty((), dtype=torch.int32, device=b.device)
    rn = torch.empty((), dtype=b.dtype, device=b.device)
    err = cuda_lib.function("cg_solve_f32")(
        cuda_lib.ptr(win), cuda_lib.ptr(_offs_table(offs, b.device)), len(offs),
        cuda_lib.ptr(b), cuda_lib.ptr(dinv), cuda_lib.ptr(x0), cuda_lib.ptr(x),
        cuda_lib.ptr(work[0]), cuda_lib.ptr(work[1]), cuda_lib.ptr(work[2]),
        cuda_lib.ptr(part), cuda_lib.ptr(k), cuda_lib.ptr(rn),
        n, int(maxiter), float(tol), cuda_lib.stream_ptr(b.device),
    )
    cuda_lib.check(err, "cg_solve")
    cuda_lib.launch_counts["cg_solve"] += 1
    return KrylovResult(x, k, rn)
