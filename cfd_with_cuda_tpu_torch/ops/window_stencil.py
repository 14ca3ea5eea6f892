"""Window-stencil applies: host tables, the window kernel and the compact
divergence kernel's wrappers.

Port of ``cfd_with_cuda_tpu/ops/pallas_stencil.py``: ``window_offsets``,
``div_class_pairs``, ``compact_gt_window`` (host, setup time); the window
applies of the interleaved layout, :func:`window_spmv`, :func:`grad_window`
and :func:`div_window` (the ``_stencil_call`` body, CUDA kernel
``csrc/window_stencil.cu``); and the compact G^T apply
(``div_compact_call``, CUDA kernel ``csrc/div_compact.cu``), on a
class-split field (:func:`div_compact`, the parity layout) or read
straight from an interleaved one (:func:`div_compact_interleaved`,
``pallas_div_compact``).

Layout contract (as in the JAX package): a window table ``win (W^3, S)``
holds per-row weights in z-major window-scan order, ``y[s] = sum_w
win[w, s] * x[s + off(w)]``; field reads outside the field are zero.  The
window applies also take the pre-padded form of the solvers: fields and
weight tables whose last axis is a ``BLK`` multiple (the padded fine axis
s_pad, zero weight columns beyond S).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib

__all__ = [
    "BLK", "window_offsets", "div_class_pairs", "compact_gt_window",
    "window_spmv", "window_spmv_plain", "grad_window", "grad_window_plain",
    "div_window", "div_window_plain", "div_compact", "div_compact_plain",
    "div_compact_interleaved", "div_compact_interleaved_plain",
]

# Class-size padding of the parity layout (Sp = round_up(cx*cy*cz, BLK)) and
# the fine-axis padding of the interleaved layout, kept from the JAX layout
# so both packages' arrays compare element-wise.
BLK = 2048


def window_offsets(dims, radius: int) -> tuple[int, ...]:
    """Flat offsets in window-channel order (z-major window scan)."""
    return _window_offsets(tuple(int(v) for v in dims), int(radius))


@functools.lru_cache(maxsize=64)
def _window_offsets(dims, radius):
    sx, sy, _ = dims
    return tuple(
        dz * sx * sy + dy * sx + dx
        for dz in range(-radius, radius + 1)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    )


def div_class_pairs(coarse_dims, radius: int = 2):
    """(class_index, coarse flat offset) per fine window slot, in the
    z-major window-scan order of ``window_offsets`` (radius 2)."""
    return _div_class_pairs(tuple(int(v) for v in coarse_dims), int(radius))


@functools.lru_cache(maxsize=64)
def _div_class_pairs(coarse_dims, radius):
    cx, cy, _ = coarse_dims
    pairs = []
    for dz in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                p = ((dx % 2), (dy % 2), (dz % 2))
                q = ((dx - p[0]) // 2, (dy - p[1]) // 2, (dz - p[2]) // 2)
                pidx = (p[2] * 2 + p[1]) * 2 + p[0]
                pairs.append((pidx, (q[2] * cy + q[1]) * cx + q[0]))
    return tuple(pairs)


def compact_gt_window(gt_win: np.ndarray, fine_dims, coarse_dims) -> np.ndarray:
    """(3, W^3, S_c_pad) <- fine G^T window sampled at the embedded coarse
    rows (host, setup time): divergence rows exist only at the coarse
    positions, so 7/8 of the fine table is structurally zero."""
    fx, fy, _ = fine_dims
    cx, cy, cz = coarse_dims
    qx, qy, qz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    emb = ((2 * qz * fy + 2 * qy) * fx + 2 * qx).ravel(order="F")
    out = gt_win[..., emb]
    s_c = cx * cy * cz
    s_pad = -(-s_c // BLK) * BLK
    return np.pad(out, ((0, 0), (0, 0), (0, s_pad - s_c)))


def div_compact_plain(gt_cwin: torch.Tensor, up: torch.Tensor, pairs) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y[q] = sum_s sum_d
    gt_cwin[d, s, q] * up[d, cls_s, q + off_s]`` (zero outside [0, Sp)),
    slots in order, the 3 directions summed per slot first."""
    sp = up.shape[-1]
    halo = max(abs(o) for _, o in pairs)
    u_ext = F.pad(up, (halo, halo))
    acc = torch.zeros(sp, dtype=up.dtype, device=up.device)
    for s, (cls, off) in enumerate(pairs):
        xs = u_ext[:, cls, halo + off: halo + off + sp]
        acc = acc + (gt_cwin[:, s] * xs).sum(0)
    return acc


# ------------------------------------------------------------ window applies

_SPMV, _GRAD, _DIV = 0, 1, 2      # csrc/window_stencil.cu modes


def _operands(win, x, dims):
    """``(w (cw, W, n), x (cx, n), s, n)`` as ``pallas_stencil._pad_args``
    takes them: the pre-padded form (both last axes equal, a ``BLK``
    multiple) as it is, else both cut to the grid size S."""
    s = int(np.prod(dims))
    xb = x if x.ndim == 2 else x[None]
    wb = win if win.ndim == 3 else win[None]
    if wb.shape[-1] % BLK == 0 and xb.shape[-1] == wb.shape[-1]:
        return wb, xb, s, wb.shape[-1]
    return wb[..., :s], xb[:, :s], s, s


def _stencil_plain(mode, wb, xb, offsets) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop over the offsets in window
    order on a zero-haloed field."""
    n = xb.shape[-1]
    halo = max(abs(int(o)) for o in offsets)
    x_ext = F.pad(xb, (halo, halo))
    co = (xb.shape[0], 3, 1)[mode]
    acc = xb.new_zeros((co, n))
    for k, off in enumerate(offsets):
        xs = x_ext[:, halo + off: halo + off + n]
        if mode == _SPMV:
            acc = acc + wb[0, k] * xs
        elif mode == _GRAD:
            acc = acc + wb[:, k] * xs
        else:
            acc = acc + (wb[:, k] * xs).sum(0, keepdim=True)
    return acc


@functools.lru_cache(maxsize=32)
def _offsets_table(offsets, device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _stencil(mode, name, wb, xb, offsets, plain) -> torch.Tensor:
    """The window apply of ``mode`` on ``wb (cw, W, n)``, ``xb (cx, n)``: the
    plain version on a CPU tensor (or under ``plain``), the kernel on a CUDA
    tensor."""
    offsets = tuple(int(o) for o in offsets)
    if plain or xb.device.type == "cpu":
        return _stencil_plain(mode, wb, xb, offsets)
    if xb.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xb.device}")
    cx, n = xb.shape
    cw = (1, 3, 3)[mode]
    if wb.shape != (cw, len(offsets), n):
        raise ValueError(f"{name}: shapes {tuple(wb.shape)}, {tuple(xb.shape)}, "
                         f"{len(offsets)} offsets")
    if xb.dtype not in (torch.float32, torch.float64) or wb.dtype != xb.dtype:
        raise ValueError(f"{name}: dtypes {wb.dtype}, {xb.dtype}")
    if wb.device != xb.device:
        raise ValueError(f"{name}: operands on different devices")
    wb, xb = wb.contiguous(), xb.contiguous()
    co = (cx, 3, 1)[mode]
    y = torch.empty((co, n), dtype=xb.dtype, device=xb.device)
    fn = cuda_lib.function("window_stencil_f32" if xb.dtype == torch.float32
                           else "window_stencil_f64")
    err = fn(mode, cuda_lib.ptr(wb), cuda_lib.ptr(xb), cx,
             cuda_lib.ptr(_offsets_table(offsets, xb.device)), len(offsets),
             cuda_lib.ptr(y), n, cuda_lib.stream_ptr(xb.device))
    cuda_lib.check(err, name)
    cuda_lib.launch_counts[name] += 1
    return y


def _trimmed(y, s, n, trim):
    """``[..., :s]`` under ``trim``, else the ``BLK``-padded result (zeros
    beyond S), as the JAX wrappers return it."""
    if trim:
        return y[..., :s]
    s_blk = -(-s // BLK) * BLK
    return F.pad(y, (0, s_blk - n)) if n < s_blk else y


def _window_spmv(win, x, dims, radius, offsets, trim, name, plain):
    if not (name.startswith("window_spmv") and name in cuda_lib.launch_counts):
        raise ValueError(f"window_spmv: no launch count named {name!r}")
    if offsets is None:
        offsets = window_offsets(dims, radius)
    wb, xb, s, n = _operands(win, x, dims)
    y = _trimmed(_stencil(_SPMV, name, wb, xb, offsets, plain), s, n, trim)
    return y[0] if x.ndim == 1 else y


def window_spmv(win, x, dims, radius=None, *, offsets=None, trim=True, name="window_spmv"):
    """y = A x, ``win (W, S)`` the window table of A (one shared table), ``x
    (S,)`` or ``(C, S)``, C <= 3 (``pallas_window_spmv``).  ``offsets`` (a
    static tuple of flat shifts) instead of ``radius`` applies a sparse-offset
    DIA operator (``K_vals`` with its ``flat_offsets``); ``trim=False``
    returns the ``BLK``-padded result.  ``name`` is the launch count the
    launch adds to (the solvers name their operator: ``window_spmv_k``,
    ``window_spmv_k_plus_a``, ``window_spmv_mk_plus_a``, ``window_spmv_m``).
    A CPU tensor runs :func:`window_spmv_plain`; a CUDA tensor launches
    ``csrc/window_stencil.cu``."""
    return _window_spmv(win, x, dims, radius, offsets, trim, name, False)


def window_spmv_plain(win, x, dims, radius=None, *, offsets=None, trim=True,
                      name="window_spmv"):
    """Plain PyTorch version of :func:`window_spmv` on any device (it
    launches nothing; ``name`` is checked as there)."""
    return _window_spmv(win, x, dims, radius, offsets, trim, name, True)


def _grad_window(g_win, p_fine, dims, radius, trim, plain):
    wb, xb, s, n = _operands(g_win, p_fine, dims)
    y = _stencil(_GRAD, "grad_window", wb, xb, window_offsets(dims, radius), plain)
    return _trimmed(y, s, n, trim)


def grad_window(g_win, p_fine, dims, radius, *, trim=True):
    """``(3, S) <- [G1 p, G2 p, G3 p]``; ``g_win (3, W^3, S)``, ``p_fine
    (S,)`` the coarse field embedded on the fine grid
    (``pallas_grad_window``)."""
    return _grad_window(g_win, p_fine, dims, radius, trim, False)


def grad_window_plain(g_win, p_fine, dims, radius, *, trim=True):
    """Plain PyTorch version of :func:`grad_window` on any device."""
    return _grad_window(g_win, p_fine, dims, radius, trim, True)


def _div_window(gt_win, u, dims, radius, plain):
    wb, xb, s, _ = _operands(gt_win, u, dims)
    return _stencil(_DIV, "div_window", wb, xb, window_offsets(dims, radius), plain)[0, :s]


def div_window(gt_win, u, dims, radius):
    """``(S,) <- sum_d Gd^T u_d`` on the fine grid; ``gt_win (3, W^3, S)``,
    ``u (3, S)`` (``pallas_div_window``; the caller strides the result down
    to the coarse grid).  No single-chip solver path calls it: the compact
    form :func:`div_compact_interleaved` takes its place there, as in the
    JAX package."""
    return _div_window(gt_win, u, dims, radius, False)


def div_window_plain(gt_win, u, dims, radius):
    """Plain PyTorch version of :func:`div_window` on any device."""
    return _div_window(gt_win, u, dims, radius, True)


# ----------------------------------------------------------- compact div

@functools.lru_cache(maxsize=16)
def _pairs_table(pairs, device: torch.device) -> torch.Tensor:
    return torch.tensor(pairs, dtype=torch.int32, device=device).reshape(-1)


def div_compact(gt_cwin: torch.Tensor, up: torch.Tensor, pairs) -> torch.Tensor:
    """Compact G^T apply: ``gt_cwin (3, W^3, Sp)``, class-split velocity
    ``up (3, 8, Sp)`` -> ``(Sp,)``.  A CPU tensor runs the plain version; a
    CUDA tensor launches ``csrc/div_compact.cu``."""
    if up.device.type == "cpu":
        return div_compact_plain(gt_cwin, up, pairs)
    if up.device.type != "cuda":
        raise ValueError(f"div_compact: unsupported device {up.device}")
    nw = len(pairs)
    sp = up.shape[-1]
    if up.shape != (3, 8, sp) or gt_cwin.shape != (3, nw, sp):
        raise ValueError(f"div_compact: shapes {tuple(gt_cwin.shape)}, {tuple(up.shape)}")
    if up.dtype != torch.float32 or gt_cwin.dtype != up.dtype:
        raise ValueError(f"div_compact: dtypes {gt_cwin.dtype}, {up.dtype}")
    if gt_cwin.device != up.device:
        raise ValueError("div_compact: operands on different devices")
    if not (up.is_contiguous() and gt_cwin.is_contiguous()):
        raise ValueError("div_compact: operands must be contiguous")
    y = torch.empty(sp, dtype=up.dtype, device=up.device)
    tab = _pairs_table(tuple(pairs), up.device)
    err = cuda_lib.function("div_compact_f32")(cuda_lib.ptr(gt_cwin), nw, cuda_lib.ptr(up), cuda_lib.ptr(tab),
             cuda_lib.ptr(y), sp, cuda_lib.stream_ptr(up.device))
    cuda_lib.check(err, "div_compact")
    cuda_lib.launch_counts["div_compact"] += 1
    return y


def div_compact_interleaved(gt_cwin, u, fine_dims, coarse_dims):
    """``(Sp,)`` coarse-grid divergence of an interleaved velocity ``u (3,
    >= S)`` through the compact tables ``gt_cwin (3, W^3, Sp)``
    (``pallas_div_compact``).  A CPU tensor runs
    :func:`div_compact_interleaved_plain`; a CUDA tensor launches the
    interleaved form of ``csrc/div_compact.cu``, which reads each slot's
    fine node of u directly instead of splitting u into its classes."""
    if u.device.type == "cpu":
        return div_compact_interleaved_plain(gt_cwin, u, fine_dims, coarse_dims)
    if u.device.type != "cuda":
        raise ValueError(f"div_compact_interleaved: unsupported device {u.device}")
    fx, fy, fz = fine_dims
    cx, cy, cz = coarse_dims
    foffs = window_offsets(fine_dims, 2)
    sp, n_u = gt_cwin.shape[-1], u.shape[-1]
    if (gt_cwin.shape != (3, len(foffs), sp) or u.shape != (3, n_u)
            or n_u < fx * fy * fz or sp < cx * cy * cz):
        raise ValueError(f"div_compact_interleaved: shapes {tuple(gt_cwin.shape)}, "
                         f"{tuple(u.shape)}")
    if u.dtype != torch.float32 or gt_cwin.dtype != u.dtype:
        raise ValueError(f"div_compact_interleaved: dtypes {gt_cwin.dtype}, {u.dtype}")
    if gt_cwin.device != u.device:
        raise ValueError("div_compact_interleaved: operands on different devices")
    if not (u.is_contiguous() and gt_cwin.is_contiguous()):
        raise ValueError("div_compact_interleaved: operands must be contiguous")
    y = torch.empty(sp, dtype=u.dtype, device=u.device)
    err = cuda_lib.function("div_compact_interleaved_f32")(
        cuda_lib.ptr(gt_cwin), len(foffs), cuda_lib.ptr(u), n_u,
        cuda_lib.ptr(_offsets_table(foffs, u.device)), cuda_lib.ptr(y), sp, cx, cy,
        cx * cy * cz, fx, fy, cuda_lib.stream_ptr(u.device))
    cuda_lib.check(err, "div_compact_interleaved")
    cuda_lib.launch_counts["div_compact_interleaved"] += 1
    return y


def div_compact_interleaved_plain(gt_cwin, u, fine_dims, coarse_dims):
    """Plain PyTorch version of :func:`div_compact_interleaved` on any device:
    the 8 parity classes of u split out (``parity_split``, the JAX package's
    ``_extract_classes``), then :func:`div_compact_plain`."""
    # parity_stencil imports this module, so its class split is imported here
    from cfd_with_cuda_tpu_torch.ops.parity_stencil import parity_split

    up = parity_split(u, fine_dims, gt_cwin.shape[-1])
    return div_compact_plain(gt_cwin, up, div_class_pairs(coarse_dims))
