"""Window-stencil applies: host tables, the window kernel and the compact
divergence kernel's wrappers.

Port of ``cfd_with_cuda_tpu/ops/pallas_stencil.py``: ``window_offsets``,
``div_class_pairs``, ``compact_gt_window`` (host, setup time); the window
applies of the interleaved layout, :func:`window_spmv`, :func:`grad_window`
and :func:`div_window` (the ``_stencil_call`` body, CUDA kernel
``csrc/window_stencil.cu``), G on the class-compacted window
(:func:`compact_g_window`, :func:`grad_window_compact`: the kernel's GRAD
form, which the solvers call); and the compact G^T apply
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
    "BLK", "window_offsets", "div_class_pairs", "compact_gt_window", "compact_g_slots",
    "compact_g_window", "window_spmv", "window_spmv_plain", "grad_window", "grad_window_plain",
    "grad_window_compact", "grad_window_compact_plain",
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


def compact_g_slots(fine_dims, radius: int):
    """The class-compacted G window's slot table: for each parity class c =
    (z & 1) * 4 + (y & 1) * 2 + (x & 1) of a fine row, the window slots (in
    the z-major scan order of ``window_offsets``) whose offset lands on an
    even node on all three axes, where the embedded coarse pressure lives.
    Returns ``(slots (8, K), offsets (8, K), counts (8,))``, int32 numpy,
    K the largest count (27 at radius 2: 3 slots per even axis, 2 per odd
    one); entries past a class's count are 0."""
    return _compact_g_slots(tuple(int(v) for v in fine_dims), int(radius))


@functools.lru_cache(maxsize=16)
def _compact_g_slots(fine_dims, radius):
    offs = _window_offsets(fine_dims, radius)
    steps = range(-radius, radius + 1)
    scan = [(dx, dy, dz) for dz in steps for dy in steps for dx in steps]
    lists = [[k for k, (dx, dy, dz) in enumerate(scan)
              if (c & 1) == dx % 2 and (c >> 1 & 1) == dy % 2 and (c >> 2 & 1) == dz % 2]
             for c in range(8)]
    width = max(len(ks) for ks in lists)
    slots = np.zeros((8, width), np.int32)
    offsets = np.zeros((8, width), np.int32)
    for c, ks in enumerate(lists):
        slots[c, : len(ks)] = ks
        offsets[c, : len(ks)] = [offs[k] for k in ks]
    counts = np.array([len(ks) for ks in lists], np.int32)
    for a in (slots, offsets, counts):
        a.flags.writeable = False
    return slots, offsets, counts


def _row_classes(fine_dims, n: int, device) -> torch.Tensor:
    """Parity class of each of the ``n`` flat fine rows (int64; rows past the
    grid, the ``BLK`` padding, get the class their flat index gives)."""
    fx, fy, _ = fine_dims
    s = torch.arange(n, device=device)
    return (s // (fx * fy) % 2) * 4 + (s // fx % fy % 2) * 2 + s % fx % 2


def compact_g_window(g_win, fine_dims, radius: int):
    """``(G_cwin (3, K, n), offsets (8, K), counts (8,))`` <- the fine G
    window ``g_win (3, W^3, n)`` (setup time, or a CUDA tensor in
    :func:`grad_window`).  ``G_cwin[d, j, s] = g_win[d, slot_{c(s)}[j], s]``
    over the class slots of :func:`compact_g_slots`, zero past the class's
    count; ``offsets`` and ``counts`` are that function's (int32 numpy).
    ``G_cwin`` is a numpy array for a numpy ``g_win``, else a tensor on its
    device.  Raises ``ValueError`` if a weight it drops is not exactly 0:
    the compact apply then equals the full window's."""
    slots, offsets, counts = compact_g_slots(fine_dims, radius)
    w = torch.as_tensor(g_win)
    if w.ndim != 3 or w.shape[0] != 3 or w.shape[1] != (2 * radius + 1) ** 3:
        raise ValueError(f"compact_g_window: g_win of shape {tuple(w.shape)}")
    n = w.shape[-1]
    cls = _row_classes(fine_dims, n, w.device)
    keep = torch.zeros((8, w.shape[1]), dtype=torch.bool)
    for c in range(8):
        keep[c, slots[c, : counts[c]].tolist()] = True
    dropped = int(torch.count_nonzero((w != 0) & ~keep.to(w.device)[cls].T))
    if dropped:
        raise ValueError(f"compact_g_window: {dropped} nonzero weights lie outside their "
                         "row's parity-class slots")
    k = slots.shape[1]
    idx = torch.from_numpy(slots.astype(np.int64)).to(w.device)[cls].T          # (K, n)
    live = torch.arange(k, device=w.device)[:, None] < torch.from_numpy(
        counts.astype(np.int64)).to(w.device)[cls][None]
    g_cwin = torch.where(live, w.gather(1, idx.expand(3, k, n)), w.new_zeros(()))
    return (g_cwin.numpy() if isinstance(g_win, np.ndarray) else g_cwin), offsets, counts


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

# csrc/window_stencil.cu modes; GRAD is the plain version's only (on the
# card G runs on the class-compacted table, :func:`grad_window_compact`)
_SPMV, _GRAD, _DIV = 0, 1, 2


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
    """The window apply of ``mode`` (SPMV or DIV) on ``wb (cw, W, n)``, ``xb
    (cx, n)``: the plain version on a CPU tensor (or under ``plain``), the
    kernel on a CUDA tensor."""
    offsets = tuple(int(o) for o in offsets)
    if plain or xb.device.type == "cpu":
        return _stencil_plain(mode, wb, xb, offsets)
    if xb.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xb.device}")
    cx, n = xb.shape
    cw = {_SPMV: 1, _DIV: 3}[mode]
    if wb.shape != (cw, len(offsets), n):
        raise ValueError(f"{name}: shapes {tuple(wb.shape)}, {tuple(xb.shape)}, "
                         f"{len(offsets)} offsets")
    if xb.dtype not in (torch.float32, torch.float64) or wb.dtype != xb.dtype:
        raise ValueError(f"{name}: dtypes {wb.dtype}, {xb.dtype}")
    if wb.device != xb.device:
        raise ValueError(f"{name}: operands on different devices")
    wb, xb = wb.contiguous(), xb.contiguous()
    co = cx if mode == _SPMV else 1
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
    if plain or xb.device.type == "cpu":
        y = _stencil_plain(_GRAD, wb, xb, window_offsets(dims, radius))
    else:
        # the card's one GRAD kernel reads the class-compacted table
        y = _grad_compact(compact_g_window(wb, dims, radius)[0], xb, dims, radius, False)
    return _trimmed(y, s, n, trim)


def grad_window(g_win, p_fine, dims, radius, *, trim=True):
    """``(3, S) <- [G1 p, G2 p, G3 p]``; ``g_win (3, W^3, S)``, ``p_fine
    (S,)`` the coarse field embedded on the fine grid
    (``pallas_grad_window``).  A CPU tensor runs :func:`grad_window_plain`;
    a CUDA tensor compacts ``g_win`` (:func:`compact_g_window`) and launches
    the kernel of :func:`grad_window_compact`."""
    return _grad_window(g_win, p_fine, dims, radius, trim, False)


def grad_window_plain(g_win, p_fine, dims, radius, *, trim=True):
    """Plain PyTorch version of :func:`grad_window` on any device."""
    return _grad_window(g_win, p_fine, dims, radius, trim, True)


@functools.lru_cache(maxsize=16)
def _g_slot_tables(fine_dims, radius, device: torch.device):
    _, offsets, counts = compact_g_slots(fine_dims, radius)
    return (torch.from_numpy(np.array(offsets)).to(device),
            torch.from_numpy(np.array(counts)).to(device))


def _grad_compact_plain(g_cwin, xb, dims, offsets) -> torch.Tensor:
    """Plain PyTorch version of the compact GRAD kernel: for j in order,
    ``acc += g_cwin[:, j] * x[s + offsets[c(s), j]]`` on a zero-haloed field
    (entries past a class's count are zero weights at offset 0)."""
    n = xb.shape[-1]
    halo = int(np.abs(offsets).max())
    x_ext = F.pad(xb[0], (halo, halo))
    cls = _row_classes(dims, n, xb.device)
    cols = (torch.from_numpy(offsets.astype(np.int64)).to(xb.device)[cls].T
            + torch.arange(halo, halo + n, device=xb.device))
    acc = xb.new_zeros((3, n))
    for j in range(offsets.shape[1]):
        acc = acc + g_cwin[:, j] * x_ext[cols[j]]
    return acc


def _grad_compact(g_cwin, xb, dims, radius, plain) -> torch.Tensor:
    """G on the class-compacted table ``g_cwin (3, K, n)``, ``xb (1, n)``:
    the plain version on a CPU tensor (or under ``plain``), the kernel on a
    CUDA tensor (launch count ``grad_window``)."""
    dims = tuple(int(v) for v in dims)
    _, offsets, _ = compact_g_slots(dims, radius)
    if plain or xb.device.type == "cpu":
        return _grad_compact_plain(g_cwin, xb, dims, offsets)
    if xb.device.type != "cuda":
        raise ValueError(f"grad_window_compact: unsupported device {xb.device}")
    k, n = offsets.shape[1], xb.shape[-1]
    if g_cwin.shape != (3, k, n) or xb.shape != (1, n):
        raise ValueError(f"grad_window_compact: shapes {tuple(g_cwin.shape)}, "
                         f"{tuple(xb.shape)}, {k} class slots")
    if xb.dtype not in (torch.float32, torch.float64) or g_cwin.dtype != xb.dtype:
        raise ValueError(f"grad_window_compact: dtypes {g_cwin.dtype}, {xb.dtype}")
    if g_cwin.device != xb.device:
        raise ValueError("grad_window_compact: operands on different devices")
    g_cwin, xb = g_cwin.contiguous(), xb.contiguous()
    y = torch.empty((3, n), dtype=xb.dtype, device=xb.device)
    offs_t, counts_t = _g_slot_tables(dims, int(radius), xb.device)
    fn = cuda_lib.function("grad_compact_f32" if xb.dtype == torch.float32
                           else "grad_compact_f64")
    err = fn(cuda_lib.ptr(g_cwin), k, cuda_lib.ptr(xb), cuda_lib.ptr(offs_t),
             cuda_lib.ptr(counts_t), cuda_lib.ptr(y), n, dims[0], dims[1],
             cuda_lib.stream_ptr(xb.device))
    cuda_lib.check(err, "grad_window_compact")
    cuda_lib.launch_counts["grad_window"] += 1
    return y


def _grad_window_compact(g_cwin, p_fine, dims, radius, trim, plain):
    wb, xb, s, n = _operands(g_cwin, p_fine, dims)
    return _trimmed(_grad_compact(wb, xb, dims, radius, plain), s, n, trim)


def grad_window_compact(g_cwin, p_fine, dims, radius, *, trim=True):
    """:func:`grad_window` on the class-compacted table ``g_cwin (3, K, S)``
    of :func:`compact_g_window` (the solvers' ``d["G_cwin"]``).  A CPU
    tensor runs :func:`grad_window_compact_plain`; a CUDA tensor launches
    the GRAD kernel of ``csrc/window_stencil.cu`` (launch count
    ``grad_window``).  Equal to :func:`grad_window` on the full table bit
    for bit, up to the sign of an exact zero."""
    return _grad_window_compact(g_cwin, p_fine, dims, radius, trim, False)


def grad_window_compact_plain(g_cwin, p_fine, dims, radius, *, trim=True):
    """Plain PyTorch version of :func:`grad_window_compact` on any device:
    :func:`grad_window_plain`'s sum without its zero terms, bit for bit."""
    return _grad_window_compact(g_cwin, p_fine, dims, radius, trim, True)


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
