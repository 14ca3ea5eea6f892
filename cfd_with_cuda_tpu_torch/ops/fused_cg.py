"""Jacobi-preconditioned CG of the pressure solve on a window operator.

Port of ``cfd_with_cuda_tpu/ops/pallas_cg.py::fused_cg`` with its
signature less ``_skip_loop``.  The operator is a plain ``(D, n)`` window,
``(Z v)[i] = sum_w win[w, i] * v[i + off_w]`` with v zero outside [0, n):
a box grid's ``W^3`` window, its offsets made from ``dims`` and ``radius``
(z-major scan), or any static offset list given as ``offs`` with
``dims=(n, 1, 1)`` (the banded tables of ``ops/banded.py`` on the
unstructured path; the halo is max |offs|).  The TPU kernel's DMA-block
weight layout (``cg_weight_layout``, ``pick_kp``) has no counterpart here.

Math (same as the TPU kernels): warm r0 = b - Z x0 (cold r0 = b); stop when
||r|| <= max(tol * ||b||, 0) or the iteration cap; alpha and beta through
``_safe_div`` (0 when |den| <= 1e-35); returns x, k and ||r||.

Two loop forms, as in the JAX package:

* ``fuse_loop=False`` (the ``SolverConfig`` default): ``csrc/cg_iter.cu``,
  one ``cg_init`` launch, then one ``cg_iter`` launch per group of
  ``unroll`` iterations (one trip of the JAX loop).  The vectors and r.z,
  ||r||, ||b|| stay on the device; the host reads ||r|| once per launch.
  The loop contract is the JAX ``lax.while_loop``'s: ``maxiter`` rounds UP
  to a multiple of ``unroll``, convergence is looked at only between
  groups, and the reported count is a multiple of ``unroll``.
* ``fuse_loop=True``: ``csrc/cg_solve.cu``, the whole solve in ONE launch
  with convergence looked at every iteration (``unroll`` is ignored).

``dot_mode="compensated"`` (the MIXED policy) makes every inner product
the f64 dot of its f32 inputs, rounded to f32 once (:func:`comp_dot_f32`).
``sym=True`` applies only the dq >= 0 half of a symmetric window, each
positive offset both ways (:func:`window_apply_sym`); ``win`` is then the
full table (its last ``D // 2 + 1`` rows are taken) or that half, and the
offsets must be mirror-symmetric.

The kernels keep their vectors in one ``(5, ld)`` work buffer
(:func:`cg_work_layout`) and stage, per block of 256 rows, the clusters of
p that the block's rows read (:func:`stage_clusters`; the table the kernels
take is :func:`stage_table`); a window whose clusters fit no block is
refused at launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops.krylov import KrylovResult
from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets

__all__ = [
    "fused_cg", "fused_cg_plain", "window_apply_plain", "window_apply_sym",
    "comp_dot_f32", "comp_dot_plain", "half_window", "stage_clusters", "stage_table",
    "cg_work_layout", "WORK_ROWS", "BLOCK_ROWS",
]

_DIV_FLOOR = 1e-35
BLOCK_ROWS = 256                           # rows a block owns (csrc kThreads)
WORK_ROWS = ("r", "z", "ap", "p0", "p1")   # the kernels' work buffer (csrc kWorkRows)
_WORK_ALIGN = 32                           # floats: each work row starts on 128 bytes


def stage_clusters(offs, sym: bool = False, gap: int = 32):
    """(clusters, pos): what the kernels stage per block of 256 rows.  Row t
    of the block starting at i0 reads v at i0 + t + d for each offset d it
    uses (under ``sym`` the dq >= 0 half read both ways); the intervals
    [d, d + 256) are merged (across gaps under ``gap`` values) and widened to
    whole 16-byte vectors.  ``clusters``: ((first, length), ...) relative to
    i0, multiples of 4, back to back in the staged array; ``pos``: d -> the
    place of v(i0 + t + d) in that array, less t."""
    reads = sorted({int(o) for o in offs} | ({-int(o) for o in offs if o > 0} if sym else set()))
    merged = []
    for d in reads:
        lo, hi = d - d % 4, -(-(d + BLOCK_ROWS) // 4) * 4
        if merged and lo <= merged[-1][1] + gap:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    clusters, pos, base = [], {}, 0
    for lo, hi in merged:
        clusters.append((lo, hi - lo))
        pos.update({d: base + d - lo for d in reads if lo <= d < hi})
        base += hi - lo
    return tuple(clusters), pos


def stage_table(offs, sym: bool = False) -> np.ndarray:
    """The int32 table the kernels stage by (``csrc/cg_common.cuh``
    ``StageTab``): K clusters, the staged float4 count, pos(0), the K
    clusters' first columns, their K + 1 starts in the staged array, pos of
    each slot's offset and, under ``sym``, of its mirror (0 for slot 0)."""
    clusters, pos = stage_clusters(offs, sym)
    starts = np.cumsum([0] + [n for _, n in clusters])
    rows = [[len(clusters), int(starts[-1]) // 4, pos[0]], [lo for lo, _ in clusters], starts,
            [pos[int(o)] for o in offs]]
    if sym:
        rows.append([pos[-int(o)] if o > 0 else 0 for o in offs])
    return np.concatenate([np.asarray(r, dtype=np.int32) for r in rows])


def cg_work_layout(n: int) -> tuple[tuple[str, ...], int]:
    """(row names, ld) of the kernels' work buffer: ``len(WORK_ROWS)`` rows
    of n values, each row starting on a 128-byte boundary (ld a multiple of
    32 floats), so the staged loads of p and z are whole 16-byte vectors."""
    return WORK_ROWS, -(-int(n) // _WORK_ALIGN) * _WORK_ALIGN


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ok = b.abs() > _DIV_FLOOR
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def _sym_offsets(offs) -> tuple[int, ...]:
    """The dq >= 0 half of a mirror-symmetric offset set (centre first)."""
    c = len(offs) // 2
    if [-o for o in offs[:c]] != list(reversed(offs[c + 1:])) or offs[c] != 0:
        raise ValueError("sym needs a mirror-symmetric offset set")
    return tuple(offs[c:])


def half_window(win: np.ndarray, dims, radius: int) -> np.ndarray:
    """Host, setup-time: the dq >= 0 half ``(W^3 // 2 + 1, n)`` of a
    SYMMETRIC window table, for ``fused_cg(..., sym=True)``.  Checks the
    symmetry as the JAX package's ``cg_weight_layout(sym=True)`` does:
    ``win[c - m][q] = Z[q, q - dq]`` must equal ``win[c + m][q - dq]``."""
    win = np.asarray(win)
    offs = window_offsets(dims, radius)
    half = _sym_offsets(offs)
    c, s = len(offs) // 2, win.shape[-1]
    for m in range(1, c + 1):
        dq = half[m]
        if not np.allclose(win[c - m, dq:], win[c + m, : s - dq], rtol=1e-6, atol=1e-8):
            raise ValueError(
                f"operator not symmetric at offset {dq}; "
                "sym weight layout needs a symmetric window"
            )
    return np.ascontiguousarray(win[c:])


def window_apply_plain(win: torch.Tensor, v: torch.Tensor, offs, sym: bool = False) -> torch.Tensor:
    """``(Z v)[i] = sum_w win[w, i] * v[i + offs[w]]``, slots in order.
    ``sym``: ``win``/``offs`` are the dq >= 0 half and every positive
    offset is also applied backwards, ``ap[i + dq] += win[m, i] * v[i]``
    (the forward sum in slot order, the back sum in slot order, then their
    sum)."""
    n = v.shape[0]
    halo = max(abs(o) for o in offs)
    v_ext = F.pad(v, (halo, halo))
    ap = torch.zeros_like(v)
    back = torch.zeros_like(v)
    for w, o in enumerate(offs):
        ap = ap + win[w] * v_ext[halo + o: halo + o + n]
        if sym and o > 0:
            back = back + F.pad(win[w] * v, (o, 0))[:n]
    return ap + back if sym else ap


def comp_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`comp_dot_f32`."""
    return (a.double() * b.double()).sum().to(a.dtype)


def _resolve_window(win, dims, radius, sym, offs=None):
    """(offsets, window) as the kernels take them: the box window's offsets
    or ``offs`` (then ``dims`` must be ``(n, 1, 1)``); under ``sym`` the
    half offsets and the ``(D // 2 + 1, n)`` half of ``win``."""
    if offs is None:
        offs = window_offsets(dims, radius)
    else:
        offs = tuple(int(o) for o in offs)
        if tuple(dims[1:]) != (1, 1) or radius is not None:
            raise ValueError(f"offs needs dims=(n, 1, 1) and radius=None, got {dims}, {radius}")
    if not sym:
        return offs, win
    half = _sym_offsets(offs)
    if win.shape[0] == len(offs):
        win = win[-len(half):]
    return half, win


def fused_cg_plain(win, b, dinv, *, dims, radius=None, tol, maxiter, x0=None, unroll=1,
                   dot_mode="plain", sym=False, fuse_loop=False, offs=None) -> KrylovResult:
    """Plain PyTorch version of :func:`fused_cg`, every mode (the loop
    decision is read on the host once per group of ``unroll`` iterations)."""
    offs, win = _resolve_window(win, dims, radius, sym, offs)
    if dot_mode == "compensated":
        dot = comp_dot_plain
    else:
        dot = lambda u, v: torch.sum(u * v)
    if fuse_loop:
        unroll = 1
    if x0 is not None:
        r = b - window_apply_plain(win, x0, offs, sym)
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
    maxiter_eff = -(-int(maxiter) // unroll) * unroll
    k = 0
    while k < maxiter_eff and bool(rn > bound):
        for _ in range(unroll):
            ap = window_apply_plain(win, p, offs, sym)
            alpha = _safe_div(rz, dot(p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            z = r * dinv
            rz_new = dot(r, z)
            beta = _safe_div(rz_new, rz)
            p = z + beta * p
            rz = rz_new
        k += unroll
        rn = torch.sqrt(dot(r, r))
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=b.device), rn)


@functools.lru_cache(maxsize=16)
def _offs_table(offs, device: torch.device) -> torch.Tensor:
    return torch.tensor(offs, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=16)
def _stage_table(offs, sym: bool, device: torch.device) -> tuple[torch.Tensor, int, int]:
    """(table on the device, its length, the float4s it stages a block)."""
    tab = stage_table(offs, sym)
    return torch.from_numpy(tab).to(device), len(tab), int(tab[1])


def _check_f32_cuda(what: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: operands must be f32")
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous on one device")


def comp_dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0-d f32: the dot of two f32 vectors equal to the f64 dot of the same
    inputs rounded to f32 once (the reduction of the CG kernels'
    ``dot_mode="compensated"``).  A CPU tensor runs :func:`comp_dot_plain`;
    a CUDA tensor launches ``comp_dot_f32`` of ``csrc/cg_iter.cu``."""
    if a.device.type == "cpu":
        return comp_dot_plain(a, b)
    _check_f32_cuda("comp_dot_f32", a, b)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"comp_dot_f32: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    part = torch.empty(cuda_lib.function("cg_iter_max_blocks")(), dtype=torch.float64,
                       device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    err = cuda_lib.function("comp_dot_f32")(
        cuda_lib.ptr(a), cuda_lib.ptr(b), cuda_lib.ptr(part), cuda_lib.ptr(out),
        a.shape[0], cuda_lib.stream_ptr(a.device),
    )
    cuda_lib.check(err, "comp_dot_f32")
    cuda_lib.launch_counts["comp_dot"] += 1
    return out


def window_apply_sym(win, v, *, dims, radius) -> torch.Tensor:
    """``Z v`` from the dq >= 0 half of a symmetric window (``win`` the full
    ``(W^3, n)`` table or its half): the apply of the CG kernels'
    ``sym=True``, alone.  A CPU tensor runs ``window_apply_plain(...,
    sym=True)``; a CUDA tensor launches ``window_apply_sym_f32`` of
    ``csrc/cg_iter.cu``."""
    offs, win = _resolve_window(win, dims, radius, True)
    if v.device.type == "cpu":
        return window_apply_plain(win, v, offs, True)
    _check_f32_cuda("window_apply_sym", win, v)
    n = v.shape[0]
    if win.shape != (len(offs), n):
        raise ValueError(f"window_apply_sym: shapes win {tuple(win.shape)}, v {tuple(v.shape)}")
    y = torch.empty_like(v)
    err = cuda_lib.function("window_apply_sym_f32")(
        cuda_lib.ptr(win), cuda_lib.ptr(_offs_table(offs, v.device)), len(offs),
        cuda_lib.ptr(v), cuda_lib.ptr(y), n, cuda_lib.stream_ptr(v.device),
    )
    cuda_lib.check(err, "window_apply_sym")
    cuda_lib.launch_counts["sym_apply"] += 1
    return y


def fused_cg(win, b, dinv, *, dims, radius=None, tol, maxiter, x0=None, unroll=1,
             dot_mode="plain", sym=False, fuse_loop=False, offs=None) -> KrylovResult:
    """Jacobi-PCG solve of Z x = b for the window operator ``win (D, n)``
    (D = W^3, W = 2 radius + 1, z-major window scan over the grid ``dims``;
    or D = len(offs) with ``dims=(n, 1, 1)``), ``b`` and ``dinv (n,)``,
    optional warm start ``x0 (n,)``; modes in the module docstring.  Returns :class:`KrylovResult` with 0-d ``iters`` and
    ``residual`` on the device.  A CPU tensor runs :func:`fused_cg_plain`;
    a CUDA tensor launches the kernels of ``csrc/cg_iter.cu`` or
    ``csrc/cg_solve.cu``."""
    if dot_mode not in ("plain", "compensated"):
        raise ValueError(f"fused_cg: unknown dot_mode {dot_mode!r}")
    if b.device.type == "cpu":
        return fused_cg_plain(win, b, dinv, dims=dims, radius=radius, tol=tol,
                              maxiter=maxiter, x0=x0, unroll=unroll, dot_mode=dot_mode,
                              sym=sym, fuse_loop=fuse_loop, offs=offs)
    offs, win = _resolve_window(win, dims, radius, sym, offs)
    n = b.shape[0]
    if win.shape != (len(offs), n) or dinv.shape != (n,) or b.shape != (n,):
        raise ValueError(f"fused_cg: shapes win {tuple(win.shape)}, b {tuple(b.shape)}, dinv {tuple(dinv.shape)}")
    if x0 is not None and x0.shape != (n,):
        raise ValueError(f"fused_cg: x0 shape {tuple(x0.shape)}")
    _check_f32_cuda("fused_cg", b, win, dinv, *([x0] if x0 is not None else []))
    comp = dot_mode == "compensated"
    mode_counts = [name for name, on in (("comp_dot", comp), ("sym_apply", sym)) if on]

    def count(name: str) -> None:
        for key in (name, *mode_counts):
            cuda_lib.launch_counts[key] += 1

    return _cuda_cg(cuda_lib.function, win, b, dinv, offs, tol=tol, maxiter=maxiter, x0=x0,
                    unroll=unroll, comp=comp, sym=sym, fuse_loop=fuse_loop, count=count)


def _cuda_cg(fn, win, b, dinv, offs, *, tol, maxiter, x0, unroll, comp, sym, fuse_loop,
             count=lambda name: None) -> KrylovResult:
    """The CUDA path of :func:`fused_cg` on checked operands, ``win``/``offs``
    resolved (the half under ``sym``); ``fn(name)`` gives a typed C entry
    point of ``csrc/cg_solve.cu`` / ``csrc/cg_iter.cu`` (this build's, or an
    earlier build's of the same interface); ``count(name)`` is called once
    per launch."""
    ptr = cuda_lib.ptr
    n, dev = b.shape[0], b.device
    part_dtype = torch.float64 if comp else torch.float32
    offs_t = _offs_table(tuple(offs), dev)
    stab, stab_ints, svecs = _stage_table(tuple(offs), bool(sym), dev)
    rows, ld = cg_work_layout(n)
    x = torch.empty_like(b)
    work = torch.empty((len(rows), ld), dtype=b.dtype, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    if fuse_loop:
        part = torch.empty(6 * fn("cg_solve_max_blocks")(), dtype=part_dtype, device=dev)
        k = torch.empty((), dtype=torch.int32, device=dev)
        rn = torch.empty((), dtype=b.dtype, device=dev)
        err = fn("cg_solve_f32")(
            ptr(win), ptr(offs_t), len(offs), ptr(b), ptr(dinv), ptr(x0), ptr(x), ptr(work), ld,
            ptr(part), ptr(k), ptr(rn), n, int(maxiter), float(tol), int(comp), int(sym),
            ptr(stab), stab_ints, svecs, stream,
        )
        cuda_lib.check(err, "cg_solve")
        count("cg_solve")
        return KrylovResult(x, k, rn)

    unroll = max(1, int(unroll))
    part = torch.empty(6 * fn("cg_iter_max_blocks")(), dtype=part_dtype, device=dev)
    scal = torch.empty(3, dtype=b.dtype, device=dev)     # r.z, |r|, |b|
    err = fn("cg_init_f32")(
        ptr(win), ptr(offs_t), len(offs), ptr(b), ptr(dinv), ptr(x0), ptr(x), ptr(work), ld,
        ptr(part), ptr(scal), n, int(comp), int(sym), ptr(stab), stab_ints, svecs, stream,
    )
    cuda_lib.check(err, "cg_init")
    count("cg_init")
    # the JAX loop: bound = max(tol * |b|, 0) in f32; NaN compares False
    rn_h, bn_h = scal[1:3].cpu().numpy()
    bound = np.maximum(np.float32(tol) * bn_h, np.float32(0.0))
    maxiter_eff = -(-int(maxiter) // unroll) * unroll
    iter_fn = fn("cg_iter_f32")
    iter_args = (
        ptr(win), ptr(offs_t), len(offs), ptr(dinv), ptr(x), ptr(work), ld, ptr(part),
        ptr(scal), n, unroll, int(comp), int(sym), ptr(stab), stab_ints, svecs, stream,
    )
    rn_dev = scal[1]
    k = 0
    while k < maxiter_eff and rn_h > bound:
        cuda_lib.check(iter_fn(*iter_args), "cg_iter")
        count("cg_iter")
        k += unroll
        rn_h = np.float32(rn_dev.item())
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=dev), rn_dev)

