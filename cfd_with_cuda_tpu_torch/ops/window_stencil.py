"""Window-stencil applies: host tables, the window kernel and the compact
divergence kernel's wrappers.

Port of ``cfd_with_cuda_tpu/ops/pallas_stencil.py``: ``window_offsets``,
``div_class_pairs``, ``compact_gt_window`` (host, setup time); the window
applies of the interleaved layout, :func:`window_spmv`, :func:`grad_window`
and :func:`div_window` (the ``_stencil_call`` body, CUDA kernel
``csrc/window_stencil.cu``), G on the class-compacted window
(:func:`compact_g_window`, :func:`grad_window_compact`: the kernel's GRAD
form, which the solvers call), the SPMV on a class-compacted, class-major
table (:func:`compact_spmv_window`, :func:`window_spmv_compact`: the
solvers' K, K + A, MK + A and M applies); and the compact G^T apply
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

Rows and field apart (the sharded path, ``parallel/sharded_stencil.py``):
:func:`window_rows`, :func:`grad_rows`, :func:`spmv_compact_rows` and
:func:`div_compact_rows` apply a rank's contiguous block of rows to its
halo-extended field, ``x_org`` the global position of the field's entry 0
(reads outside the given field are zero, as outside the global one).  Their
kernels are the single-device ones, given the two origins.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib

__all__ = [
    "BLK", "window_offsets", "div_class_pairs", "compact_gt_window", "compact_g_slots",
    "compact_g_window", "compact_spmv_slots", "compact_spmv_window", "spmv_window_from_compact",
    "compact_spmv_rows", "compact_spmv_diag", "compact_spmv_oij", "spmv_layout",
    "window_spmv", "window_spmv_plain", "window_spmv_compact", "window_spmv_compact_plain",
    "spmv_forms",
    "grad_window", "grad_window_plain",
    "grad_window_compact", "grad_window_compact_plain",
    "div_window", "div_window_plain", "div_compact", "div_compact_plain",
    "div_compact_interleaved", "div_compact_interleaved_plain",
    "window_rows", "grad_rows", "spmv_compact_rows", "div_compact_rows", "coarse_rows",
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


def compact_g_window(g_win, fine_dims, radius: int, row0: int = 0):
    """``(G_cwin (3, K, n), offsets (8, K), counts (8,))`` <- the fine G
    window ``g_win (3, W^3, n)`` (setup time, or a CUDA tensor in
    :func:`grad_window`).  ``G_cwin[d, j, s] = g_win[d, slot_{c(s)}[j], s]``
    over the class slots of :func:`compact_g_slots`, zero past the class's
    count; ``offsets`` and ``counts`` are that function's (int32 numpy).
    ``row0``: the global row of ``g_win``'s column 0 (a rank's block).
    ``G_cwin`` is a numpy array for a numpy ``g_win``, else a tensor on its
    device.  Raises ``ValueError`` if a weight it drops is not exactly 0:
    the compact apply then equals the full window's."""
    slots, offsets, counts = compact_g_slots(fine_dims, radius)
    w = torch.as_tensor(g_win)
    if w.ndim != 3 or w.shape[0] != 3 or w.shape[1] != (2 * radius + 1) ** 3:
        raise ValueError(f"compact_g_window: g_win of shape {tuple(w.shape)}")
    n = w.shape[-1]
    cls = _row_classes(fine_dims, row0 + n, w.device)[row0:]
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


# ------------------------------------------------ the compact SPMV layout

SPMV_BLOCKS = 9        # the 8 parity classes, then the padding rows


class SpmvLayout(NamedTuple):
    """The class-compacted, class-major table of a window operator
    (:func:`spmv_layout`).  Block b < 8 holds the rows of parity class b
    (their sub-grid ``dims[b]``, flat order), block 8 the padding rows
    ``S <= s < n``; block b is ``(counts[b], rows[b])``, slot-major, at
    entry ``bases[b]`` of the flat table, its slot j reading
    ``x[s + offsets[b, j]]``."""
    slots: np.ndarray       # (9, K) int32: positions in the operator's offsets tuple
    offsets: np.ndarray     # (9, K) int32: the flat offsets of those slots
    counts: np.ndarray      # (9,) int32
    dims: tuple             # (gx, gy, gz) of each class block; (n - S, 1, 1) the padding's
    rows: np.ndarray        # (9,) int64
    bases: np.ndarray       # (9,) int64
    size: int               # entries of the whole table
    order: tuple            # per block: the flat rows s of its rows, int64
    first: np.ndarray       # (9,) int64: a class block's first row in its sub-grid's flat
    #                         order (0 for the whole grid), the padding block's first row s


def _shifts_of(offsets, fine_dims):
    """The (dx, dy, dz) shifts of a radius-2 window that each flat offset
    names (more than one on a grid under 5 nodes thick, none for an offset
    outside the window)."""
    fx, fy, _ = fine_dims
    steps = range(-2, 3)
    named: dict = {}
    for dz in steps:
        for dy in steps:
            for dx in steps:
                named.setdefault((dz * fy + dy) * fx + dx, []).append((dx, dy, dz))
    return [named.get(int(o), []) for o in offsets]


def compact_spmv_slots(offsets, fine_dims):
    """The compact SPMV's slot table on the operator's own ``offsets`` (its
    order kept, not assumed to be ``window_offsets``'): for each parity class
    c = (z & 1) * 4 + (y & 1) * 2 + (x & 1) of a row, the positions in
    ``offsets`` whose shift a Q2 row of that class couples to: |d| <= 2 on
    an axis where the row's coordinate is even (a node on an element face
    line, shared by two elements), |d| <= 1 where it is odd (inside one
    element); then, as class 8, the padding rows, which keep offset 0 alone
    (the implicit LHS gives them a unit diagonal).  Returns ``(slots (9, K),
    offsets (9, K), counts (9,))``, int32 numpy, K the largest count (125,
    75, 45, 27 for 0 to 3 odd axes on a full radius-2 tuple); entries past a
    class's count are 0.  On a grid under 5 nodes thick a flat offset names
    more than one shift, and it is live where any of them is."""
    return _compact_spmv_slots(tuple(int(o) for o in offsets), tuple(int(v) for v in fine_dims))


@functools.lru_cache(maxsize=16)
def _compact_spmv_slots(offsets, fine_dims):
    shifts = _shifts_of(offsets, fine_dims)
    live = lambda c, d: all(abs(v) <= (1 if c >> a & 1 else 2) for a, v in enumerate(d))
    lists = [[k for k, ds in enumerate(shifts) if any(live(c, d) for d in ds)]
             for c in range(8)]
    lists.append([k for k, o in enumerate(offsets) if o == 0])
    width = max(len(ks) for ks in lists)
    slots = np.zeros((SPMV_BLOCKS, width), np.int32)
    offs = np.zeros((SPMV_BLOCKS, width), np.int32)
    for c, ks in enumerate(lists):
        slots[c, : len(ks)] = ks
        offs[c, : len(ks)] = [offsets[k] for k in ks]
    counts = np.array([len(ks) for ks in lists], np.int32)
    for a in (slots, offs, counts):
        a.flags.writeable = False
    return slots, offs, counts


def spmv_layout(offsets, fine_dims, n: int, rows=None) -> SpmvLayout:
    """The :class:`SpmvLayout` of the operator with flat ``offsets`` on the
    fine grid ``fine_dims`` over ``n >= S`` rows (``S`` the grid's size), or
    over the rows ``[r0, r1)`` of them alone (``rows``, a rank's block): each
    block then holds the block's rows in that range, a contiguous run of its
    order."""
    r0, r1 = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    return _spmv_layout(tuple(int(o) for o in offsets), tuple(int(v) for v in fine_dims), int(n),
                        r0, r1)


@functools.lru_cache(maxsize=64)
def _spmv_layout(offsets, fine_dims, n, r0=0, r1=None):
    fx, fy, fz = fine_dims
    size_s = fx * fy * fz
    r1 = n if r1 is None else r1
    if n < size_s or not 0 <= r0 <= r1 <= n:
        raise ValueError(f"spmv_layout: rows [{r0}, {r1}) of {n} on a grid of {size_s}")
    slots, offs, counts = _compact_spmv_slots(offsets, fine_dims)
    dims, order, first = [], [], []
    for c in range(8):
        px, py, pz = c & 1, c >> 1 & 1, c >> 2 & 1
        g = ((fx - px + 1) // 2, (fy - py + 1) // 2, (fz - pz + 1) // 2)
        k, j, i = np.meshgrid(*(np.arange(v) for v in g[::-1]), indexing="ij")
        o = (((2 * k + pz) * fy + 2 * j + py) * fx + 2 * i + px).reshape(-1)
        lo, hi = np.searchsorted(o, r0), np.searchsorted(o, r1)
        order.append(o[lo:hi])
        first.append(lo)
        dims.append(g)
    dims.append((n - size_s, 1, 1))
    pad0 = max(size_s, r0)
    order.append(np.arange(pad0, max(pad0, r1)))
    first.append(pad0)
    order = tuple(o.astype(np.int64) for o in order)
    rows = np.array([len(o) for o in order], np.int64)
    sizes = rows * counts
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    first = np.array(first, np.int64)
    for a in (*order, rows, bases, first):
        a.flags.writeable = False
    return SpmvLayout(slots, offs, counts, tuple(dims), rows, bases, int(sizes.sum()), order,
                      first)


def _blocks(lay: SpmvLayout):
    """(block, slots, rows) of each block that holds entries."""
    return [(b, lay.slots[b, : lay.counts[b]].astype(np.int64), lay.order[b])
            for b in range(SPMV_BLOCKS) if lay.counts[b] and lay.rows[b]]


def compact_spmv_window(win, offsets, fine_dims, rows=None):
    """The class-compacted, class-major table ``(size,)`` of the window
    operator ``win (W, n)`` with flat ``offsets`` (W of them, the operator's
    own order; setup time, or per step on a CUDA tensor): block b of
    :func:`spmv_layout` holds ``win[slots_b[j], s]`` at ``bases[b] + j *
    rows[b] + r`` for the b-th block's r-th row s; with ``rows = (r0, r1)``
    the table of those rows alone (a rank's block).  A numpy array for a
    numpy ``win``, else a tensor on its device.  Raises ``ValueError`` if a
    weight it drops is not exactly 0: the compact apply then equals the full
    window's.  NE27000 (``s_pad`` 227,328): 14.71 M weights of 28.42 M, and
    347 padding rows."""
    w = torch.as_tensor(win)
    if w.ndim != 2 or w.shape[0] != len(offsets):
        raise ValueError(f"compact_spmv_window: win of shape {tuple(w.shape)}, "
                         f"{len(offsets)} offsets")
    lay = spmv_layout(offsets, fine_dims, w.shape[1], rows)
    parts = [w[torch.tensor(sl, device=w.device)][:, torch.tensor(rw, device=w.device)]
             .reshape(-1) for _, sl, rw in _blocks(lay)]
    out = torch.cat(parts) if parts else w.new_zeros(0)
    if rows is not None:
        w = w[:, rows[0]: rows[1]]
    dropped = int(torch.count_nonzero(w)) - int(torch.count_nonzero(out))
    if dropped:
        raise ValueError(f"compact_spmv_window: {dropped} nonzero weights lie outside their "
                         "row's parity-class slots")
    return out.numpy() if isinstance(win, np.ndarray) else out


def spmv_window_from_compact(cwin, offsets, fine_dims, n: int):
    """The full window table ``(W, n)`` of a compact one (the exact inverse
    of :func:`compact_spmv_window`: the dropped weights 0).  A numpy array for
    a numpy ``cwin``, else a tensor on its device."""
    c = torch.as_tensor(cwin)
    lay = spmv_layout(offsets, fine_dims, n)
    if c.shape != (lay.size,):
        raise ValueError(f"spmv_window_from_compact: {tuple(c.shape)} for a layout of "
                         f"{lay.size} entries")
    out = c.new_zeros((len(offsets), n))
    for b, sl, rw in _blocks(lay):
        blk = c[lay.bases[b]: lay.bases[b] + len(sl) * len(rw)].view(len(sl), len(rw))
        out[torch.tensor(sl, device=c.device)[:, None], torch.tensor(rw, device=c.device)] = blk
    return out.numpy() if isinstance(cwin, np.ndarray) else out


def compact_spmv_rows(v, offsets, fine_dims, rows=None):
    """A per-row vector ``v (n,)`` on the compact table's entries: entry (b,
    j, r) gets ``v`` at the block's r-th row (the LHS's row mask); with
    ``rows`` on the table of those rows alone.  Numpy for numpy, else a
    tensor on its device."""
    t = torch.as_tensor(v)
    lay = spmv_layout(offsets, fine_dims, t.shape[0], rows)
    parts = [t[torch.tensor(rw, device=t.device)][None].expand(len(sl), -1).reshape(-1)
             for _, sl, rw in _blocks(lay)]
    out = torch.cat(parts) if parts else t.new_zeros(0)
    return out.numpy() if isinstance(v, np.ndarray) else out


def compact_spmv_diag(offsets, fine_dims, n: int, rows=None) -> np.ndarray:
    """``(n,)`` int64: the entry of each row's offset-0 slot in the compact
    table (rows in flat order), where the LHS adds its unit diagonal and
    reads the Jacobi diagonal; with ``rows = (r0, r1)``, ``(r1 - r0,)`` in the
    table of those rows alone.  Raises ``ValueError`` without offset 0."""
    lay = spmv_layout(offsets, fine_dims, n, rows)
    r0, r1 = (0, n) if rows is None else rows
    pos = np.full(r1 - r0, -1, np.int64)
    for b, sl, rw in _blocks(lay):
        zero = np.flatnonzero(lay.offsets[b, : len(sl)] == 0)
        if len(zero) == 0:
            raise ValueError("compact_spmv_diag: the operator has no offset 0")
        pos[rw - r0] = lay.bases[b] + zero[0] * len(rw) + np.arange(len(rw))
    if (pos < 0).any():
        raise ValueError("compact_spmv_diag: the operator has no offset 0")
    return pos


def compact_spmv_oij(oij, local_off, offsets, fine_dims) -> tuple:
    """The elemental slot map in the compact table: ``oij[i][j]`` (a position
    in ``offsets``) as the position among the live slots of class c(i), the
    parity of ``local_off[i]``, where local node i of every element lies.
    Raises ``ValueError`` if an entry lands on a slot its class drops."""
    # tuple() of a tuple is the tuple itself: the solvers' per-step call
    # hashes its static tuples and converts nothing
    return _compact_spmv_oij(tuple(map(tuple, oij)), tuple(map(tuple, local_off)),
                             tuple(offsets), tuple(fine_dims))


@functools.lru_cache(maxsize=16)
def _compact_spmv_oij(oij, local_off, offsets, fine_dims):
    slots, _, counts = _compact_spmv_slots(offsets, fine_dims)
    out = []
    for i, (ox, oy, oz) in enumerate(local_off):
        c = (oz & 1) * 4 + (oy & 1) * 2 + (ox & 1)
        where = {int(k): j for j, k in enumerate(slots[c, : counts[c]])}
        if any(int(k) not in where for k in oij[i]):
            raise ValueError(f"compact_spmv_oij: local node {i} reaches a slot that its "
                             f"class {c} drops")
        out.append(tuple(where[int(k)] for k in oij[i]))
    return tuple(out)


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


def _field_over(xb, x_org: int, lo: int, hi: int) -> torch.Tensor:
    """The field ``xb (C, nx)``, whose entry 0 is global position ``x_org``,
    over the global positions ``[lo, hi)``: zero where it holds none."""
    return F.pad(xb, (x_org - lo, hi - x_org - xb.shape[-1]))


def _stencil_plain(mode, wb, xb, offsets, x_org=0, y_org=0, ny=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop over the offsets in window
    order on a zero-haloed field; rows ``y_org + r`` (r < ``ny``, default the
    field's length) of the field whose entry 0 is global position ``x_org``."""
    n = xb.shape[-1] if ny is None else ny
    halo = max(abs(int(o)) for o in offsets)
    x_ext = _field_over(xb, x_org, y_org - halo, y_org + n + halo)
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


def _stencil(mode, name, wb, xb, offsets, plain, x_org=0, y_org=0) -> torch.Tensor:
    """The window apply of ``mode`` (SPMV or DIV) on ``wb (cw, W, ny)``, ``xb
    (cx, nx)``: the rows ``y_org + r`` of the field whose entry 0 is global
    position ``x_org`` (one device: both 0, ``nx = ny``).  The plain version
    on a CPU tensor (or under ``plain``), the kernel on a CUDA tensor."""
    offsets = tuple(int(o) for o in offsets)
    ny = wb.shape[-1]
    if plain or xb.device.type == "cpu":
        return _stencil_plain(mode, wb, xb, offsets, x_org, y_org, ny)
    if xb.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xb.device}")
    cx, nx = xb.shape
    cw = {_SPMV: 1, _DIV: 3}[mode]
    if wb.shape != (cw, len(offsets), ny):
        raise ValueError(f"{name}: shapes {tuple(wb.shape)}, {tuple(xb.shape)}, "
                         f"{len(offsets)} offsets")
    if xb.dtype not in (torch.float32, torch.float64) or wb.dtype != xb.dtype:
        raise ValueError(f"{name}: dtypes {wb.dtype}, {xb.dtype}")
    if wb.device != xb.device:
        raise ValueError(f"{name}: operands on different devices")
    wb, xb = wb.contiguous(), xb.contiguous()
    co = cx if mode == _SPMV else 1
    y = torch.empty((co, ny), dtype=xb.dtype, device=xb.device)
    tag = "f32" if xb.dtype == torch.float32 else "f64"
    err = cuda_lib.function(f"window_stencil_rows_{tag}")(
        mode, cuda_lib.ptr(wb), cuda_lib.ptr(xb), cx,
        cuda_lib.ptr(_offsets_table(offsets, xb.device)), len(offsets), cuda_lib.ptr(y), ny, nx,
        int(x_org), int(y_org), cuda_lib.stream_ptr(xb.device))
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


@functools.lru_cache(maxsize=32)
def _spmv_offsets_table(offsets, fine_dims, n, device: torch.device) -> torch.Tensor:
    """The kernel's (9, K) int32 slot offsets of :func:`spmv_layout` on ``device``."""
    return torch.tensor(_spmv_layout(offsets, fine_dims, n).offsets, device=device)


@functools.lru_cache(maxsize=32)
def _plain_groups(offsets, fine_dims, n, blocks, device: torch.device, r0=0, r1=None):
    """The plain version's work on the rows ``[r0, r1)`` of ``n``: the blocks
    of ``blocks`` grouped by slot count, each group ``(its blocks, count,
    field index (count, rows) into the field over [r0 - halo, r1 + halo),
    halo the layout's largest |offset|, its rows less r0)`` on ``device``:
    one gather and ``count`` multiply-adds a group."""
    lay = _spmv_layout(offsets, fine_dims, n, r0, r1)
    halo = max(int(np.abs(lay.offsets).max()), 1)
    groups = []
    for cnt in sorted({int(lay.counts[b]) for b in blocks}, reverse=True):
        bs = tuple(b for b in blocks if lay.counts[b] == cnt)
        rows = np.concatenate([lay.order[b] for b in bs]) - r0
        idx = np.concatenate([lay.order[b][None] + lay.offsets[b, :cnt, None] for b in bs], 1)
        groups.append((bs, cnt, torch.tensor(idx - r0 + halo, device=device),
                       torch.tensor(rows, device=device)))
    return halo, tuple(groups)


def _spmv_compact_plain(cw, xb, lay, groups, x_org=0, r0=0, ny=None) -> torch.Tensor:
    """Plain PyTorch version of the compact SPMV kernel: for each row, its
    block's slots in order, ``acc = acc + w[j] * x[s + off_j]`` on a
    zero-haloed field (the full window's plain sum without its zero terms);
    rows of blocks with equal slot counts are summed side by side.  ``ny``
    rows from ``r0``, the field from global position ``x_org``."""
    halo, groups = groups
    ny = xb.shape[-1] if ny is None else ny
    x_ext = _field_over(xb, x_org, r0 - halo, r0 + ny + halo)
    y = xb.new_zeros((xb.shape[0], ny))
    for bs, cnt, idx, rows in groups:
        w = torch.cat([cw[lay.bases[b]: lay.bases[b] + cnt * lay.rows[b]].view(cnt, -1)
                       for b in bs], 1)
        xs = x_ext[:, idx]                                  # (cx, cnt, rows)
        acc = xb.new_zeros((xb.shape[0], idx.shape[1]))
        for j in range(cnt):
            acc = acc + w[j] * xs[:, j]
        y[:, rows] = acc
    return y


class _SpmvPlan(NamedTuple):
    """A compact SPMV launch, built once per table, field and grid."""
    n: int                  # rows of the table
    lay: SpmvLayout
    blocks: tuple           # the blocks applied: all for a field of n, the classes for S
    tab: np.ndarray         # per block: rows, slot count, entry base, class (-1: the
    #                         padding rows), gx, gy, first row (the C interface's table)


@functools.lru_cache(maxsize=64)
def _rows_plan(offsets, dims, n: int, r0: int, r1: int) -> _SpmvPlan:
    """The plan of the table of rows ``[r0, r1)`` of ``n`` (a rank's block)."""
    lay = _spmv_layout(offsets, dims, n, r0, r1)
    blocks = tuple(b for b in range(SPMV_BLOCKS) if lay.counts[b] and lay.rows[b])
    return _SpmvPlan(n, lay, blocks, _plan_table(lay, blocks))


@functools.lru_cache(maxsize=64)
def _spmv_plan(offsets, dims, size: int, nx: int) -> _SpmvPlan:
    """The plan of a compact table of ``size`` entries on a field of ``nx``
    rows (the table's n, or the grid's S: then the class blocks alone)."""
    s = int(np.prod(dims))
    extra = size - _spmv_layout(offsets, dims, s).size
    tail = int(_compact_spmv_slots(offsets, dims)[2][SPMV_BLOCKS - 1])
    if extra < 0 or (extra and (not tail or extra % tail)):
        raise ValueError(f"a compact table of {size} entries fits no layout of offsets "
                         f"on {dims}")
    n = s + (extra // tail if tail else 0)
    if nx not in (n, s):
        raise ValueError(f"a compact table over {n} rows and a field of {nx}")
    lay = _spmv_layout(offsets, dims, n)
    blocks = tuple(b for b in range(SPMV_BLOCKS) if lay.counts[b] and lay.rows[b]
                   and (b < 8 or nx == n))
    return _SpmvPlan(n, lay, blocks, _plan_table(lay, blocks))


def _plan_table(lay: SpmvLayout, blocks) -> np.ndarray:
    """The C interface's block table: rows, slot count, entry base, class
    (-1: the padding rows), gx, gy, first row, a line per block."""
    tab = np.array([[lay.rows[b], lay.counts[b], lay.bases[b], b if b < 8 else -1,
                     lay.dims[b][0], lay.dims[b][1], lay.first[b]] for b in blocks], np.int64)
    tab.flags.writeable = False
    return tab


def _spmv_compact(cw, xb, dims, offsets, name, plain) -> torch.Tensor:
    """The compact SPMV of ``cw`` (a :func:`compact_spmv_window` table over
    ``n`` rows) on ``xb (cx, nx)``: every block where ``nx = n``, the 8 class
    blocks alone where ``nx = S`` (an unpadded field).  The plain version on
    a CPU tensor (or under ``plain``), the kernel on a CUDA tensor."""
    cx, nx = xb.shape
    if cw.ndim != 1:
        raise ValueError(f"{name}: a compact table of shape {tuple(cw.shape)}")
    plan = _spmv_plan(offsets, dims, cw.shape[0], nx)
    if plain or xb.device.type == "cpu":
        return _spmv_compact_plain(cw, xb, plan.lay,
                                   _plain_groups(offsets, dims, plan.n, plan.blocks, xb.device))
    if xb.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xb.device}")
    if not 1 <= cx <= 3:
        raise ValueError(f"{name}: {cx} channels")
    if xb.dtype not in (torch.float32, torch.float64) or cw.dtype != xb.dtype:
        raise ValueError(f"{name}: dtypes {cw.dtype}, {xb.dtype}")
    if cw.device != xb.device:
        raise ValueError(f"{name}: operands on different devices")
    cw, xb = cw.contiguous(), xb.contiguous()
    y = torch.empty((cx, nx), dtype=xb.dtype, device=xb.device)
    offs_t = _spmv_offsets_table(offsets, dims, plan.n, xb.device)
    tag = "f32" if xb.dtype == torch.float32 else "f64"
    err = cuda_lib.function(f"spmv_compact_rows_{tag}")(
        cuda_lib.ptr(cw), cuda_lib.ptr(xb), cx, cuda_lib.ptr(offs_t), offs_t.shape[1],
        plan.tab.ctypes.data, len(plan.blocks), cuda_lib.ptr(y), nx, nx, 0, 0, dims[0], dims[1],
        cuda_lib.stream_ptr(xb.device))
    cuda_lib.check(err, name)
    cuda_lib.launch_counts[name] += 1
    return y


def _window_spmv_compact(cwin, x, dims, radius, offsets, trim, name, plain):
    if not (name.startswith("window_spmv") and name in cuda_lib.launch_counts):
        raise ValueError(f"window_spmv_compact: no launch count named {name!r}")
    dims = tuple(int(v) for v in dims)
    offsets = window_offsets(dims, radius) if offsets is None else tuple(offsets)
    s = dims[0] * dims[1] * dims[2]
    xb = x if x.ndim == 2 else x[None]
    if xb.shape[-1] != _spmv_plan(offsets, dims, cwin.shape[-1], s).n:
        xb = xb[:, :s]      # not the table's padded field: the grid's rows alone
    y = _trimmed(_spmv_compact(cwin, xb, dims, offsets, name, plain), s, xb.shape[-1], trim)
    return y[0] if x.ndim == 1 else y


def window_spmv_compact(cwin, x, dims, radius=None, *, offsets=None, trim=True,
                        name="window_spmv"):
    """:func:`window_spmv` on the class-compacted table ``cwin`` of
    :func:`compact_spmv_window` (the solvers' ``K_cvals``, the per-step K + A
    and MK + A, ``M_cvals``), with the same ``offsets`` / ``radius``,
    ``trim`` and launch count ``name``.  A CPU tensor runs
    :func:`window_spmv_compact_plain`; a CUDA tensor launches the compact
    SPMV kernel of ``csrc/window_stencil.cu``.  Equal to :func:`window_spmv`
    on the full table bit for bit, up to the sign of an exact zero."""
    return _window_spmv_compact(cwin, x, dims, radius, offsets, trim, name, False)


def window_spmv_compact_plain(cwin, x, dims, radius=None, *, offsets=None, trim=True,
                              name="window_spmv"):
    """Plain PyTorch version of :func:`window_spmv_compact` on any device:
    :func:`window_spmv_plain`'s sum without its zero terms, bit for bit."""
    return _window_spmv_compact(cwin, x, dims, radius, offsets, trim, name, True)


def spmv_compact_rows(cwin, x_ext, dims, offsets, n: int, rows, x_org: int, *,
                      name: str, plain: bool = False) -> torch.Tensor:
    """The compact SPMV on a rank's rows: ``cwin`` the table of rows ``rows =
    (r0, r1)`` of ``n`` (:func:`compact_spmv_window` with ``rows``), ``x_ext
    (cx, nx)`` the field from global position ``x_org`` (reads outside it are
    zero) -> ``(cx, r1 - r0)``.  The plain version on a CPU tensor (or under
    ``plain``); on a CUDA tensor the compact SPMV kernel
    (``spmv_compact_rows_*``), adding one to the launch count ``name``."""
    if name not in cuda_lib.launch_counts:
        raise ValueError(f"spmv_compact_rows: no launch count named {name!r}")
    dims = tuple(int(v) for v in dims)
    offsets = tuple(int(o) for o in offsets)
    r0, r1 = int(rows[0]), int(rows[1])
    plan = _rows_plan(offsets, dims, int(n), r0, r1)
    if cwin.shape != (plan.lay.size,):
        raise ValueError(f"{name}: a compact table of shape {tuple(cwin.shape)} for "
                         f"{plan.lay.size} entries")
    cx, nx = x_ext.shape
    if plain or x_ext.device.type == "cpu":
        groups = _plain_groups(offsets, dims, int(n), plan.blocks, x_ext.device, r0, r1)
        return _spmv_compact_plain(cwin, x_ext, plan.lay, groups, x_org, r0, r1 - r0)
    if x_ext.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_ext.device}")
    if not 1 <= cx <= 3:
        raise ValueError(f"{name}: {cx} channels")
    if x_ext.dtype not in (torch.float32, torch.float64) or cwin.dtype != x_ext.dtype:
        raise ValueError(f"{name}: dtypes {cwin.dtype}, {x_ext.dtype}")
    if cwin.device != x_ext.device:
        raise ValueError(f"{name}: operands on different devices")
    y = torch.zeros((cx, r1 - r0), dtype=x_ext.dtype, device=x_ext.device)
    if not plan.blocks:
        return y
    cwin, x_ext = cwin.contiguous(), x_ext.contiguous()
    offs_t = _spmv_offsets_table(offsets, dims, int(n), x_ext.device)
    tag = "f32" if x_ext.dtype == torch.float32 else "f64"
    err = cuda_lib.function(f"spmv_compact_rows_{tag}")(
        cuda_lib.ptr(cwin), cuda_lib.ptr(x_ext), cx, cuda_lib.ptr(offs_t), offs_t.shape[1],
        plan.tab.ctypes.data, len(plan.blocks), cuda_lib.ptr(y), r1 - r0, nx, int(x_org), r0,
        dims[0], dims[1], cuda_lib.stream_ptr(x_ext.device))
    cuda_lib.check(err, name)
    cuda_lib.launch_counts[name] += 1
    return y


def window_rows(win, x_ext, offsets, rows, x_org: int, *, div: bool = False,
                name: str, plain: bool = False) -> torch.Tensor:
    """The full-window apply on a rank's rows ``rows = (r0, r1)``: ``win (W,
    r1 - r0)`` (SPMV, ``x_ext (cx, nx)``) or ``(3, W, r1 - r0)`` (``div``:
    the DIV mode, ``x_ext (3, nx)``), the field from global position
    ``x_org`` -> ``(cx | 1, r1 - r0)``.  The plain version on a CPU tensor
    (or under ``plain``); the window kernel (``window_stencil_rows_*``) on a
    CUDA tensor, adding one to the launch count ``name``."""
    if name not in cuda_lib.launch_counts:
        raise ValueError(f"window_rows: no launch count named {name!r}")
    wb = win if win.ndim == 3 else win[None]
    return _stencil(_DIV if div else _SPMV, name, wb, x_ext, offsets, plain, int(x_org),
                    int(rows[0]))


def spmv_forms(xs, isolver, rng):
    """Inputs of every solver form of the window SPMV on the interleaved
    explicit (``xs``) and implicit (``isolver``) solvers' tables, each
    ``(name, full table (W, n), compact table, offsets, x (3, n))``: K, K + A
    (the explicit "assemble" form), MK + A (the implicit LHS, masked, unit
    diagonal) and M, on a field and convection drawn from ``rng`` (A(u) of a
    velocity of 1e-2).  The full K + A and MK + A are built as the parent
    step built them (``assemble_window_values`` into the window rows), the
    compact ones as the solvers build them now (``assemble_compact_values``
    straight into the compact table).  For checking and timing the kernels
    (``compare_build``, ``chip_smoke.py``, the tests); no solver calls it."""
    # stencil imports this module, so its assembly is imported here
    from cfd_with_cuda_tpu_torch.ops.stencil import (
        assemble_compact_values,
        assemble_window_values,
        convection_elem_matrices,
    )

    dev, n, fine, nn = xs.device, xs.s_pad, xs.fine_dims, xs.nn
    dtype = xs.d["K_vals"].dtype
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
    u = rand(3, n)

    def conv(s, offsets):
        ae = convection_elem_matrices(1e-2 * rand(3, nn), s.d["Sv"], s.d["gDSv"], s.d["gq"],
                                      s.elem_dims, fine)
        coij = compact_spmv_oij(s.conv_oij, s.local_off, offsets, fine)
        return (assemble_window_values(ae, s.local_off, s.conv_oij, len(offsets), s.elem_dims,
                                       fine, n),
                assemble_compact_values(ae, s.local_off, coij, offsets, s.elem_dims, fine, n))

    d, di = xs.d, isolver.d
    ka, ka_c = conv(xs, xs.k_offsets)
    a, a_c = conv(isolver, isolver.a_offsets)
    a = (di["MK_vals"] + a) * di["row_mask_grid"][None]
    a[isolver.a_zero_off] += di["diag_add_grid"]
    a_c = (di["MK_cvals"] + a_c) * di["row_mask_c"]
    a_c[di["diag_pos"]] += di["diag_add_grid"]
    return [("k", d["K_vals"], d["K_cvals"], xs.k_offsets, u),
            ("k_plus_a", d["K_vals"] + ka, d["K_cvals"] + ka_c, xs.k_offsets, u),
            ("mk_plus_a", a, a_c, isolver.a_offsets, u),
            ("m", di["M_vals"], di["M_cvals"], isolver.a_offsets, u)]


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


def _grad_compact_plain(g_cwin, xb, dims, offsets, x_org=0, y_org=0) -> torch.Tensor:
    """Plain PyTorch version of the compact GRAD kernel: for j in order,
    ``acc += g_cwin[:, j] * x[s + offsets[c(s), j]]`` on a zero-haloed field
    (entries past a class's count are zero weights at offset 0); rows
    ``y_org + r``, the field from global position ``x_org``."""
    n = g_cwin.shape[-1]
    halo = int(np.abs(offsets).max())
    x_ext = _field_over(xb, x_org, y_org - halo, y_org + n + halo)[0]
    cls = _row_classes(dims, y_org + n, xb.device)[y_org:]
    cols = (torch.from_numpy(offsets.astype(np.int64)).to(xb.device)[cls].T
            + torch.arange(halo, halo + n, device=xb.device))
    acc = xb.new_zeros((3, n))
    for j in range(offsets.shape[1]):
        acc = acc + g_cwin[:, j] * x_ext[cols[j]]
    return acc


def _grad_compact(g_cwin, xb, dims, radius, plain, x_org=0, y_org=0,
                  name="grad_window") -> torch.Tensor:
    """G on the class-compacted table ``g_cwin (3, K, ny)``, ``xb (1, nx)``:
    the rows ``y_org + r`` of the field whose entry 0 is global position
    ``x_org`` (one device: both 0, ``nx = ny``).  The plain version on a CPU
    tensor (or under ``plain``), the kernel on a CUDA tensor (launch count
    ``name``)."""
    dims = tuple(int(v) for v in dims)
    _, offsets, _ = compact_g_slots(dims, radius)
    if plain or xb.device.type == "cpu":
        return _grad_compact_plain(g_cwin, xb, dims, offsets, x_org, y_org)
    if xb.device.type != "cuda":
        raise ValueError(f"grad_window_compact: unsupported device {xb.device}")
    k, ny, nx = offsets.shape[1], g_cwin.shape[-1], xb.shape[-1]
    if g_cwin.shape != (3, k, ny) or xb.shape != (1, nx):
        raise ValueError(f"grad_window_compact: shapes {tuple(g_cwin.shape)}, "
                         f"{tuple(xb.shape)}, {k} class slots")
    if xb.dtype not in (torch.float32, torch.float64) or g_cwin.dtype != xb.dtype:
        raise ValueError(f"grad_window_compact: dtypes {g_cwin.dtype}, {xb.dtype}")
    if g_cwin.device != xb.device:
        raise ValueError("grad_window_compact: operands on different devices")
    g_cwin, xb = g_cwin.contiguous(), xb.contiguous()
    y = torch.empty((3, ny), dtype=xb.dtype, device=xb.device)
    offs_t, counts_t = _g_slot_tables(dims, int(radius), xb.device)
    tag = "f32" if xb.dtype == torch.float32 else "f64"
    err = cuda_lib.function(f"grad_compact_rows_{tag}")(
        cuda_lib.ptr(g_cwin), k, cuda_lib.ptr(xb), cuda_lib.ptr(offs_t), cuda_lib.ptr(counts_t),
        cuda_lib.ptr(y), ny, nx, int(x_org), int(y_org), dims[0], dims[1],
        cuda_lib.stream_ptr(xb.device))
    cuda_lib.check(err, "grad_window_compact")
    cuda_lib.launch_counts[name] += 1
    return y


def grad_rows(g_cwin, x_ext, dims, radius, rows, x_org: int, *, name: str,
              plain: bool = False) -> torch.Tensor:
    """G on the class-compacted table of a rank's rows ``rows = (r0, r1)``
    (``g_cwin (3, K, r1 - r0)``, the columns of :func:`compact_g_window`'s),
    ``x_ext (nx,)`` the embedded pressure from global position ``x_org`` ->
    ``(3, r1 - r0)``.  The plain version on a CPU tensor (or under
    ``plain``); the GRAD kernel (``grad_compact_rows_*``) on a CUDA tensor,
    adding one to the launch count ``name``."""
    if name not in cuda_lib.launch_counts:
        raise ValueError(f"grad_rows: no launch count named {name!r}")
    if g_cwin.shape[-1] != rows[1] - rows[0]:
        raise ValueError(f"grad_rows: {g_cwin.shape[-1]} table rows for rows {tuple(rows)}")
    return _grad_compact(g_cwin, x_ext[None], dims, radius, plain, int(x_org), int(rows[0]),
                         name)


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
    err = cuda_lib.function("div_compact_interleaved_rows_f32")(
        cuda_lib.ptr(gt_cwin), len(foffs), cuda_lib.ptr(u), n_u,
        cuda_lib.ptr(_offsets_table(foffs, u.device)), cuda_lib.ptr(y), sp, cx, cy,
        cx * cy * cz, fx, fy, 0, 0, cuda_lib.stream_ptr(u.device))
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


# ------------------------------------------------- the rank-rows G^T

def coarse_rows(fine_dims, coarse_dims, rows) -> tuple[int, int]:
    """``(q0, q1)``: the coarse rows whose embedded fine row, ``emb(q) = (2 qz
    fy + 2 qy) fx + 2 qx``, lies in the fine rows ``rows = (r0, r1)``; emb
    rises with q, so they are a contiguous run."""
    return _coarse_rows(tuple(int(v) for v in fine_dims), tuple(int(v) for v in coarse_dims),
                        int(rows[0]), int(rows[1]))


@functools.lru_cache(maxsize=64)
def _coarse_rows(fine_dims, coarse_dims, r0, r1):
    emb = _embedded_rows(fine_dims, coarse_dims)
    return int(np.searchsorted(emb, r0)), int(np.searchsorted(emb, r1))


@functools.lru_cache(maxsize=8)
def _embedded_rows(fine_dims, coarse_dims) -> np.ndarray:
    fx, fy, _ = fine_dims
    cx, cy, cz = coarse_dims
    q = np.arange(cx * cy * cz)
    return ((2 * (q // (cx * cy)) * fy + 2 * (q // cx % cy)) * fx + 2 * (q % cx)).astype(np.int64)


def _div_rows_plain(gt, x_ext, fine_dims, coarse_dims, q0, x_org) -> torch.Tensor:
    """Plain PyTorch version of the interleaved compact G^T on the coarse rows
    ``q0 + q``: slot by slot in window order, the 3 directions summed per
    slot first, reading the fine node emb(q) + off of the field from global
    position ``x_org`` (zero outside it); the split form's sum
    (:func:`div_compact_interleaved_plain`) up to the sign of an exact zero
    (a wrapped read meets a zero weight)."""
    nq = gt.shape[-1]
    nx = x_ext.shape[-1]
    emb = _embedded_rows(tuple(fine_dims), tuple(coarse_dims))[q0: q0 + nq] - x_org
    base = torch.from_numpy(emb).to(x_ext.device)
    acc = x_ext.new_zeros(nq)
    for s, off in enumerate(window_offsets(fine_dims, 2)):
        j = base + off
        live = (j >= 0) & (j < nx)
        xs = torch.where(live, x_ext[:, j.clamp(0, nx - 1)], x_ext.new_zeros(()))
        acc = acc + (gt[:, s] * xs).sum(0)
    return acc


def div_compact_rows(gt_cwin, x_ext, fine_dims, coarse_dims, q0: int, x_org: int, *,
                     name: str, plain: bool = False) -> torch.Tensor:
    """The coarse-grid divergence on a rank's coarse rows ``q0 + q``:
    ``gt_cwin (3, W^3, nq)`` the columns ``[q0, q0 + nq)`` of
    :func:`compact_gt_window`'s table, ``x_ext (3, nx)`` the velocity from
    global fine position ``x_org`` -> ``(nq,)``.  The plain version on a CPU
    tensor (or under ``plain``); on a CUDA tensor the interleaved form of
    ``csrc/div_compact.cu`` (``div_compact_interleaved_rows_f32``), adding
    one to the launch count ``name``.  Each row sums the slots of the
    full-window DIV mode's fine row in its order."""
    if name not in cuda_lib.launch_counts:
        raise ValueError(f"div_compact_rows: no launch count named {name!r}")
    fx, fy, _ = fine_dims
    cx, cy, _ = coarse_dims
    foffs = window_offsets(fine_dims, 2)
    nq = gt_cwin.shape[-1]
    if gt_cwin.shape != (3, len(foffs), nq) or x_ext.ndim != 2 or x_ext.shape[0] != 3:
        raise ValueError(f"{name}: shapes {tuple(gt_cwin.shape)}, {tuple(x_ext.shape)}")
    if plain or x_ext.device.type == "cpu":
        return _div_rows_plain(gt_cwin, x_ext, fine_dims, coarse_dims, int(q0), int(x_org))
    if x_ext.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_ext.device}")
    if x_ext.dtype != torch.float32 or gt_cwin.dtype != x_ext.dtype:
        raise ValueError(f"{name}: dtypes {gt_cwin.dtype}, {x_ext.dtype}")
    if gt_cwin.device != x_ext.device:
        raise ValueError(f"{name}: operands on different devices")
    y = torch.zeros(nq, dtype=x_ext.dtype, device=x_ext.device)
    if nq == 0:
        return y
    gt_cwin, x_ext = gt_cwin.contiguous(), x_ext.contiguous()
    err = cuda_lib.function("div_compact_interleaved_rows_f32")(
        cuda_lib.ptr(gt_cwin), len(foffs), cuda_lib.ptr(x_ext), x_ext.shape[-1],
        cuda_lib.ptr(_offsets_table(foffs, x_ext.device)), cuda_lib.ptr(y), nq, cx, cy, nq,
        fx, fy, int(q0), int(x_org), cuda_lib.stream_ptr(x_ext.device))
    cuda_lib.check(err, name)
    cuda_lib.launch_counts[name] += 1
    return y
