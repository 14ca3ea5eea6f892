"""Parity-split (class-major) field layout and its window apply kernel.

Port of ``cfd_with_cuda_tpu/ops/parity_stencil.py`` (the explicit and
implicit main paths' part).  Fine-grid fields are stored CLASS-MAJOR:

    fine node s at (x, y, z)  ->  class p = (x&1, y&1, z&1),
                                  subgrid q = ((z>>1)*cy + (y>>1))*cx + (x>>1)

    field (C, S) -> (C, 8, Sp),  Sp = round_up(cx*cy*cz, 2048)

with the 8 class subgrids zero-padded to the common coarse box
(cx, cy, cz) = ((fx+1)/2, ...).  The coarse pressure grid IS class 0, a
fine-grid window offset decomposes into (input class, coarse shift dq in
[-1, 1]^3), and the K/G window tables compact to their structural
nonzeros (``build_parity_apply_tables``).

Host tables (numpy, setup time) are copies of the JAX package's; the
per-step ops are torch.  :func:`parity_apply` is the one kernel here
(``csrc/parity_apply.cu``), with the field read whole from L2 or staged
block by block through shared memory (the JAX package's 6 MiB rule picks
the form); :func:`parity_window_apply` (per-class tables, no solver calls
it) runs its resident form; :func:`parity_div_apply` reaches the compact
divergence kernel of ``ops/window_stencil.py``.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    BLK,
    div_class_pairs,
    div_compact,
    div_compact_plain,
)

__all__ = [
    "parity_dims",
    "parity_split",
    "parity_merge",
    "parity_split_table",
    "parity_pairs",
    "decode_offsets",
    "parity_window_tables",
    "compact_class_tables",
    "build_parity_apply_tables",
    "stream_field",
    "stream_runs",
    "stream_schedule",
    "parity_apply",
    "parity_apply_plain",
    "parity_forms",
    "parity_window_apply",
    "parity_window_apply_plain",
    "parity_div_apply",
    "parity_div_apply_plain",
    "elem_channel_shifts",
    "embed_elem_table",
    "parity_gather_elem_flat",
    "parity_scatter_elem_flat",
    "build_conv_plane_route",
    "conv_planes_from_ae",
    "conv_plane_merge_matrix",
    "diag_plane_indices",
]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def parity_dims(fine_dims) -> tuple[tuple[int, int, int], int]:
    """((cx, cy, cz), Sp) — the common class box and padded class size."""
    fx, fy, fz = fine_dims
    cx, cy, cz = (fx + 1) // 2, (fy + 1) // 2, (fz + 1) // 2
    return (cx, cy, cz), _round_up(cx * cy * cz, BLK)


def _class_view():
    """Per class: (px, py, pz) in z-major class order."""
    return [(px, py, pz) for pz in (0, 1) for py in (0, 1) for px in (0, 1)]


def parity_split(u: torch.Tensor, fine_dims, sp: int | None = None) -> torch.Tensor:
    """(C, S>=fx*fy*fz) interleaved -> (C, 8, Sp) class-major."""
    fx, fy, fz = fine_dims
    (cx, cy, cz), sp_d = parity_dims(fine_dims)
    sp = sp or sp_d
    c = u.shape[0]
    u3 = u[:, : fx * fy * fz].reshape(c, fz, fy, fx)
    out = u.new_zeros((c, 8, sp))
    for idx, (px, py, pz) in enumerate(_class_view()):
        g = u3[:, pz::2, py::2, px::2]
        buf = u.new_zeros((c, cz, cy, cx))
        buf[:, : g.shape[1], : g.shape[2], : g.shape[3]] = g
        out[:, idx, : cx * cy * cz] = buf.reshape(c, -1)
    return out


def parity_merge(up: torch.Tensor, fine_dims) -> torch.Tensor:
    """(C, 8, Sp) class-major -> (C, S) interleaved z-major (state export;
    the solver never does this per step)."""
    fx, fy, fz = fine_dims
    (cx, cy, cz), _ = parity_dims(fine_dims)
    c = up.shape[0]
    out = up.new_zeros((c, fz, fy, fx))
    for idx, (px, py, pz) in enumerate(_class_view()):
        gx, gy, gz = cx - px, cy - py, cz - pz
        g = up[:, idx, : cx * cy * cz].reshape(c, cz, cy, cx)[:, :gz, :gy, :gx]
        out[:, pz::2, py::2, px::2] = g
    return out.reshape(c, -1)


def parity_split_table(t: np.ndarray, fine_dims, sp: int | None = None):
    """numpy host version of :func:`parity_split` for setup-time tables
    (masks, md_inv, bc values); ``t (..., S)`` -> ``(..., 8, Sp)``."""
    fx, fy, fz = fine_dims
    (cx, cy, cz), sp_d = parity_dims(fine_dims)
    sp = sp or sp_d
    lead = t.shape[:-1]
    t3 = t[..., : fx * fy * fz].reshape(*lead, fz, fy, fx)
    out = np.zeros((*lead, 8, sp), t.dtype)
    for idx, (px, py, pz) in enumerate(_class_view()):
        g = t3[..., pz::2, py::2, px::2]
        gz, gy, gx = g.shape[-3:]
        buf = np.zeros((*lead, cz, cy, cx), t.dtype)
        buf[..., :gz, :gy, :gx] = g
        out[..., idx, : cx * cy * cz] = buf.reshape(*lead, -1)
    return out


def parity_pairs(offsets_xyz, coarse_dims):
    """Static routing for a window apply in parity layout: per output
    class p, a tuple of (slot w, input class p', flat coarse shift dq) —
    the decomposition s + o = 2(q + dq) + p' with p' = (p + o) mod 2."""
    cx, cy, _ = coarse_dims
    pairs = []
    for px, py, pz in _class_view():
        lst = []
        for w, (ox, oy, oz) in enumerate(offsets_xyz):
            pp = ((px + ox) % 2, (py + oy) % 2, (pz + oz) % 2)
            dq = (
                (px + ox - pp[0]) // 2,
                (py + oy - pp[1]) // 2,
                (pz + oz - pp[2]) // 2,
            )
            p_idx = (pp[2] * 2 + pp[1]) * 2 + pp[0]
            lst.append((w, p_idx, (dq[2] * cy + dq[1]) * cx + dq[0]))
        pairs.append(tuple(lst))
    return tuple(pairs)


def parity_window_tables(win: np.ndarray, offsets_xyz, fine_dims,
                         sp: int | None = None) -> np.ndarray:
    """(n_off, S-fine) window values -> (8, n_off, Sp) class-split (host).

    The row axis splits by class exactly like a field; zero weights stay
    zero, so tables with structural class sparsity (G: rows of class p only
    couple offset parities equal to p) compact afterwards by dropping
    all-zero (class, slot) planes (:func:`compact_class_tables`).
    """
    out = parity_split_table(win, fine_dims, sp)       # (n_off, 8, Sp)
    return np.ascontiguousarray(np.moveaxis(out, -2, 0))


def compact_class_tables(wp: np.ndarray, pairs):
    """Drop all-zero (class, slot) planes from ``wp (8, n_off, Sp)``.

    Returns (wp_c (8, m, Sp), pairs_c) with a common per-class slot count m
    (zero-padded where a class has fewer live slots): G tables shrink from
    125 to at most 27 slots, K (no structural sparsity) stays put.
    """
    live = [[t for t in pairs[p] if np.any(wp[p, t[0]])] for p in range(8)]
    m = max(1, max(len(v) for v in live))
    out = np.zeros((8, m, wp.shape[-1]), wp.dtype)
    pairs_c = []
    for p in range(8):
        row = []
        for j, (w, pp, dq) in enumerate(live[p]):
            out[p, j] = wp[p, w]
            row.append((j, pp, dq))
        pairs_c.append(tuple(row))
    return out, tuple(pairs_c)


def build_parity_apply_tables(win, offsets_xyz, fine_dims, dtype=None):
    """Host, setup-time: window table -> concat-slot parity form.

    ``win``: ``(n_off, S)`` (shared weights, K) or ``(cw, n_off, S)``
    (per-output-channel weights, G with cw=3).  Returns ``(wc (cw, m, Sp),
    pairs)`` where ``pairs[p]`` is a tuple of ``(j, p_in, dq)``: output
    class p accumulates ``wc[:, j] * x[:, p_in, q + dq]``.  All-zero
    (class, offset) planes are dropped (exact: they contribute nothing).
    """
    w = np.asarray(win)
    if dtype is not None:
        w = w.astype(dtype)
    if w.ndim == 2:
        w = w[None]
    cdims, sp = parity_dims(fine_dims)
    pairs_full = parity_pairs(offsets_xyz, cdims)
    vals = [[] for _ in range(8)]
    route = [[] for _ in range(8)]
    for wslot in range(w.shape[1]):
        tp = parity_split_table(w[:, wslot], fine_dims, sp)  # (cw, 8, Sp)
        for p in range(8):
            _, pp, dq = pairs_full[p][wslot]
            if np.any(tp[:, p]):
                vals[p].append(tp[:, p])
                route[p].append((pp, dq))
    cols, pairs_c, j = [], [], 0
    for p in range(8):
        row = []
        for v, (pp, dq) in zip(vals[p], route[p]):
            cols.append(v)
            row.append((j, pp, dq))
            j += 1
        pairs_c.append(tuple(row))
    if cols:
        wc = np.ascontiguousarray(np.stack(cols, axis=1))
    else:
        wc = np.zeros((w.shape[0], 1, sp), w.dtype)
    return wc, tuple(pairs_c)


def decode_offsets(flat_offsets, fine_dims, radius: int = 2):
    """Flat fine-grid window offsets -> (dx, dy, dz) triples (|d| <=
    radius per dim; unique for the grids in use since fx > 4*radius)."""
    fx, fy, _ = fine_dims
    fxy = fx * fy
    out = []
    for off in flat_offsets:
        off = int(off)
        dz = min(range(-radius, radius + 1), key=lambda d: abs(off - d * fxy))
        rem = off - dz * fxy
        dy = min(range(-radius, radius + 1), key=lambda d: abs(rem - d * fx))
        dx = rem - dy * fx
        if abs(dx) > radius:
            raise ValueError(f"offset {off} is not a radius-{radius} window offset")
        out.append((dx, dy, dz))
    return tuple(out)


# --------------------------------------------------------- the apply kernel

def _halo(*tables) -> int:
    return max(
        (abs(dq) for prs in tables if prs for cls in prs for (_, _, dq) in cls),
        default=0,
    )


def parity_apply_plain(wc, x, *, pairs, co=None, wc2=None, pairs2=None):
    """Plain PyTorch version of :func:`parity_apply`: the same sum, the
    same order (per class: the first table's pairs, then the second's)."""
    c, _, sp = x.shape
    co = co or max(c, wc.shape[0])
    halo = _halo(pairs, pairs2)
    x_ext = F.pad(x, (halo, halo))
    y = x.new_empty((co, 8, sp))
    for p in range(8):
        acc = x.new_zeros((co, sp))
        for w, prs in ((wc, pairs), (wc2, pairs2)):
            if w is None:
                continue
            for j, pp, dq in prs[p]:
                acc = acc + w[:, j] * x_ext[:, pp, halo + dq: halo + dq + sp]
        y[:, p] = acc
    return y


# the one cache of what is built from a route (the kernels' route tables,
# its halo), by the identity of its (static, setup-time) tuples: a solver
# passes the same tuple objects every call, so a call costs a dict lookup on
# a few ints, not a walk over the ~10^3-entry route.  The tuples are kept
# with the entry so an id cannot be reused while it is cached.  The weights
# are not part of the key.
_routes_by_id: dict = {}


def _cached(key, build, *keep):
    hit = _routes_by_id.get(key)
    if hit is None:
        if len(_routes_by_id) >= 64:
            _routes_by_id.clear()
        hit = (build(), keep)
        _routes_by_id[key] = hit
    return hit[0]


# The JAX package's rule for ``stream_x=None`` (cfd_with_cuda_tpu/ops/
# parity_stencil.py:329, 369-380): the field streams when its halo-extended
# copy (C, P, Sp + 2 halo + 128), halo = max |dq| rounded up to 128, is over
# 6 MiB.  The port takes the same form for the same shapes: NE27000 fields
# stay resident, 39^3 is the first cavity to stream its velocity, NE85184
# and NE125000 stream it; the (1, 1, Sp) coarse pressure of G never streams.
_X_STREAM_BYTES = 6 * 2**20


def stream_field(x_shape, itemsize: int, pairs, pairs2=None) -> bool:
    """Whether :func:`parity_apply` with ``stream_x=None`` streams a field of
    shape ``(C, P, Sp)`` through this route (the JAX package's rule)."""
    c, px, sp = x_shape
    halo = _round_up(_cached(("halo", id(pairs), id(pairs2)), lambda: _halo(pairs, pairs2),
                             pairs, pairs2), 128)
    return c * px * (sp + 2 * halo + 128) * itemsize > _X_STREAM_BYTES


def _route_for(pairs, pairs2, m1: int, m2: int, px: int, device: torch.device,
               streamed: bool = False):
    """The int32 route of the resident kernel, or (route, runs, n_runs,
    chan, schedule) of the streamed one, built at first use and cached with
    the route."""
    build = _stream_tables if streamed else _route_table
    return _cached((id(pairs), id(pairs2), m1, m2, px, device, streamed),
                   lambda: build(pairs, pairs2, m1, m2, px, device), pairs, pairs2)


def _route_entries(pairs, pairs2, m1: int, m2: int, px: int):
    """(class heads, (table, j, p_in, dq) entries): each class's first-table
    entries before its second-table ones.  Raises when a route reads outside
    the weights (m1, m2 planes) or the field (px classes)."""
    heads, ents = [0], []
    for p in range(8):
        for tab, prs, m in ((0, pairs, m1), (1, pairs2, m2)):
            if prs is None:
                continue
            for j, pp, dq in prs[p]:
                if not (0 <= j < m and 0 <= pp < px):
                    raise ValueError("parity_apply: route reads outside the weights or field")
                ents.append((tab, j, pp, dq))
        heads.append(len(ents))
    return heads, ents


def _route_table(pairs, pairs2, m1: int, m2: int, px: int, device: torch.device) -> torch.Tensor:
    """int32 route of csrc/parity_apply.cu: 9 class offsets, then
    (table, j, p_in, dq) per entry."""
    heads, ents = _route_entries(pairs, pairs2, m1, m2, px)
    flat = heads + [v for e in ents for v in e]
    return torch.tensor(flat, dtype=torch.int32, device=device)


# the streamed kernel's geometry (csrc/parity_apply.cu kStreamQ, kRunSpan,
# kStreamWarps, kStreamThreadQ, kHeads): blocks of 64 q, runs of dq in
# [lo, lo + 2], CTAs of 4 warps, 2 consecutive q a thread (a warp's item is
# all 64 q of a class), the route's 17 heads padded to 20 ints (16-byte
# entries)
STREAM_Q = 64
RUN_SPAN = 2
STREAM_WARPS = 4
STREAM_THREAD_Q = 2
STREAM_HEADS = 20


def stream_runs(pairs, pairs2, m1: int, m2: int, px: int):
    """Host half of the streamed kernel: ``(heads, entries, runs, chan)``.

    Each input class's distinct shifts are grouped, in increasing order,
    into runs holding dq in [lo, lo + RUN_SPAN].  Run r is staged as an
    aligned superset: ``runs[r] = (p_in, s, t, L)`` with s = lo - (lo mod 4),
    L = round_up(lo mod 4 + STREAM_Q + RUN_SPAN, 4) values and t the sum of
    the earlier runs' L; a block starting at q0 (a multiple of STREAM_Q)
    stages x[c, p_in, q0 + s + k] at ``c * chan + t + k``, ``chan`` the sum
    of every L, so each run starts 16-byte aligned in the field and in the
    tile.  ``heads[2 p + tab]`` is the first entry of class p's table tab
    (``heads[16]`` the total, padded to STREAM_HEADS ints); every entry is
    ``(j, p_in, dq, spos)``, spos = t + dq - s the staged position of
    x[0, p_in, q0 + dq], in the resident route's order."""
    h9, ents = _route_entries(pairs, pairs2, m1, m2, px)
    heads = []
    for p in range(8):
        heads += [h9[p], h9[p] + sum(1 for e in ents[h9[p]:h9[p + 1]] if e[0] == 0)]
    heads += [h9[8]] * (STREAM_HEADS - len(heads))
    runs, where, chan = [], {}, 0
    for pp in sorted({e[2] for e in ents}):
        lo = None
        for dq in sorted({e[3] for e in ents if e[2] == pp}):
            if lo is None or dq > lo + RUN_SPAN:
                lo = dq
                start, n = lo - lo % 4, _round_up(lo % 4 + STREAM_Q + RUN_SPAN, 4)
                runs.append((pp, start, chan, n))
                chan += n
            where[pp, dq] = runs[-1][2] + dq - runs[-1][1]
    return heads, [(j, pp, dq, where[pp, dq]) for _, j, pp, dq in ents], runs, chan


def stream_schedule(heads):
    """The streamed kernel's warp schedule, the same for every block:
    ``(offsets, items)``.  A block's work is cut into items (class p,
    segment g of a warp's 32 * STREAM_THREAD_Q q), ``item = p * segs + g``
    with segs = STREAM_Q / (32 STREAM_THREAD_Q), of cost len(route p) (both
    tables, from :func:`stream_runs`' heads); the items, longest first (then
    in item order), each go to the one of STREAM_WARPS warps with the least
    cost so far (the lowest such warp).  Warp w sums
    ``items[offsets[w]:offsets[w + 1]]`` in that order."""
    segs, warps = STREAM_Q // (32 * STREAM_THREAD_Q), STREAM_WARPS
    cost = [heads[2 * p + 2] - heads[2 * p] for p in range(8)]
    load, lists = [0] * warps, [[] for _ in range(warps)]
    for item in sorted(range(8 * segs), key=lambda it: (-cost[it // segs], it)):
        w = min(range(warps), key=lambda v: (load[v], v))
        lists[w].append(item)
        load[w] += cost[item // segs]
    offsets = [0]
    for lst in lists:
        offsets.append(offsets[-1] + len(lst))
    return offsets, [it for lst in lists for it in lst]


def _stream_tables(pairs, pairs2, m1: int, m2: int, px: int, device: torch.device):
    heads, ents, runs, chan = stream_runs(pairs, pairs2, m1, m2, px)
    offsets, items = stream_schedule(heads)
    as_t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return (as_t(heads + [v for e in ents for v in e]), as_t([v for r in runs for v in r] or [0]),
            len(runs), chan, as_t(offsets + items))


def _launch_name(x, wc2, streamed: bool) -> str:
    if wc2 is not None:
        name = "parity_apply_k_plus_a"
    else:
        name = "parity_apply_g" if x.shape[1] == 1 else "parity_apply_k"
    return name + "_streamed" if streamed else name


def _apply_kernel(wc, x, pairs, co, wc2, pairs2, stream_x):
    """Check the arguments, launch one form of csrc/parity_apply.cu on CUDA
    tensors, and return (y, streamed)."""
    if x.device.type != "cuda":
        raise ValueError(f"parity_apply: unsupported device {x.device}")
    c, px, sp = x.shape
    cw, m, _ = wc.shape
    co = co or max(c, cw)
    tables = [wc] + ([wc2] if wc2 is not None else [])
    if (wc2 is None) != (pairs2 is None):
        raise ValueError("parity_apply: wc2 and pairs2 go together")
    if not 1 <= co <= 3 or c not in (1, co):
        raise ValueError(f"parity_apply: co={co} with {c} field channels")
    for w in tables:
        if w.ndim != 3 or w.shape[-1] != sp or w.shape[0] not in (1, co):
            raise ValueError(f"parity_apply: weight shape {tuple(w.shape)} for field {tuple(x.shape)}")
        if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
            raise ValueError("parity_apply: weights must match the field's dtype/device and be contiguous")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"parity_apply: field must be contiguous f32, got {x.dtype}")
    if stream_x is None:
        stream_x = stream_field(x.shape, x.element_size(), pairs, pairs2)
    y = torch.empty((co, 8, sp), dtype=x.dtype, device=x.device)
    cw2, m2 = (wc2.shape[0], wc2.shape[1]) if wc2 is not None else (1, 0)
    common = (cuda_lib.ptr(wc), cw, m, cuda_lib.ptr(wc2), cw2, m2, cuda_lib.ptr(x), c, px)
    if stream_x:
        route, runs, n_runs, chan, sched = _route_for(pairs, pairs2, m, m2, px, x.device,
                                                      streamed=True)
        err = cuda_lib.function("parity_apply_streamed_f32")(
            *common, cuda_lib.ptr(route), cuda_lib.ptr(runs), n_runs, chan, cuda_lib.ptr(sched),
            STREAM_Q, STREAM_WARPS, STREAM_THREAD_Q, cuda_lib.ptr(y), co, sp,
            cuda_lib.stream_ptr(x.device),
        )
    else:
        route = _route_for(pairs, pairs2, m, m2, px, x.device)
        err = cuda_lib.function("parity_apply_f32")(
            *common, cuda_lib.ptr(route), cuda_lib.ptr(y), co, sp,
            cuda_lib.stream_ptr(x.device),
        )
    cuda_lib.check(err, "parity_apply (streamed)" if stream_x else "parity_apply")
    return y, bool(stream_x)


def parity_apply(wc, x, *, pairs, co=None, stream_x=None, wc2=None, pairs2=None):
    """y[c, p, q] = sum_{(j, p', dq) in pairs[p]} wc[c|0, j, q] * x[c|0, p', q+dq]

    ``wc (cw, m, Sp)`` concat-slot weights (:func:`build_parity_apply_tables`),
    ``x (C, P, Sp)`` class-split field (P=8, or P=1 when every pair reads
    class 0 — the grad case, where the input IS the coarse pressure).
    Output ``(co, 8, Sp)``, ``co = max(C, cw)`` by default.  ``x`` is zero
    outside [0, Sp).  ``wc2``/``pairs2``: an optional second weight table
    accumulated into the same output after the first (the per-step
    convection planes, giving (K + A(un)) u in one launch).

    ``stream_x``: the field form of the kernel.  ``None`` takes the JAX
    package's rule (:func:`stream_field`: the field is staged from device
    memory block by block above 6 MiB, read whole from L2 below);
    ``True`` / ``False`` force either.  The two forms agree bit for bit.

    A CPU tensor runs :func:`parity_apply_plain` (either form); a CUDA
    tensor launches ``csrc/parity_apply.cu``.
    """
    if x.device.type == "cpu":
        return parity_apply_plain(wc, x, pairs=pairs, co=co, wc2=wc2, pairs2=pairs2)
    y, streamed = _apply_kernel(wc, x, pairs, co, wc2, pairs2, stream_x)
    cuda_lib.launch_counts[_launch_name(x, wc2, streamed)] += 1
    return y


def _no_accumulate(accumulate_in):
    if accumulate_in is not None:
        raise NotImplementedError(
            "accumulate_in is reserved; use parity_div_apply for the "
            "input-channel-summed (divergence) apply"
        )


def parity_window_apply_plain(wp, x, *, pairs, co=None, accumulate_in=None):
    """Plain PyTorch version of :func:`parity_window_apply`: per class, the
    route's terms summed in route order."""
    _no_accumulate(accumulate_in)
    c, _, sp = x.shape
    co = co or c
    halo = _halo(pairs)
    x_ext = F.pad(x, (halo, halo))
    y = x.new_empty((co, 8, sp))
    for p in range(8):
        acc = x.new_zeros((co, sp))
        for w, pp, dq in pairs[p]:
            acc = acc + wp[p, w] * x_ext[:, pp, halo + dq: halo + dq + sp]
        y[:, p] = acc
    return y


def _class_route(pairs, m: int):
    """``pairs`` on per-class tables ``(8, m, Sp)`` as a route on the one
    table ``(1, 8 m, Sp)``: plane p * m + w (cached with the route)."""
    return _cached(("class", id(pairs), m),
                   lambda: tuple(tuple((p * m + w, pp, dq) for w, pp, dq in pairs[p])
                                 for p in range(8)), pairs)


def parity_window_apply(wp, x, *, pairs, co=None, accumulate_in=None):
    """y[:, p, q] = sum_(w, p', dq) wp[p, w, q] * x[:, p', q + dq] for the
    static routing ``pairs`` (from :func:`parity_pairs` /
    :func:`compact_class_tables`): the class-split apply on per-class tables
    with a common slot count, ``wp (8, m, Sp)`` shared over the channels of
    ``x (C, 8, Sp)``; output ``(co, 8, Sp)``, co = C by default.  No solver
    calls it.  ``accumulate_in`` (reserved: sum over the input channels) is
    not implemented, as in the JAX package: :func:`parity_div_apply` is that
    apply.

    A CPU tensor runs :func:`parity_window_apply_plain`; a CUDA tensor
    launches the resident form of ``csrc/parity_apply.cu`` on the one table
    ``wp`` viewed as ``(1, 8 m, Sp)``, route plane p * m + w.
    """
    _no_accumulate(accumulate_in)
    if x.device.type == "cpu":
        return parity_window_apply_plain(wp, x, pairs=pairs, co=co)
    if wp.ndim != 3 or wp.shape[0] != 8:
        raise ValueError(f"parity_window_apply: tables {tuple(wp.shape)}, expected (8, m, Sp)")
    m = wp.shape[1]
    y, _ = _apply_kernel(wp.reshape(1, 8 * m, wp.shape[2]), x, _class_route(pairs, m),
                         co or x.shape[0], None, None, stream_x=False)
    cuda_lib.launch_counts["parity_window_apply"] += 1
    return y


def parity_div_apply(gt_cwin, up, coarse_dims):
    """(Sp,) coarse-grid divergence of a class-split velocity ``up (3, 8,
    Sp)`` through the compact G^T tables ``gt_cwin (3, W^3, Sp)``
    (``window_stencil.compact_gt_window``): the ``div_compact`` kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    return div_compact(gt_cwin, up, div_class_pairs(coarse_dims))


def parity_div_apply_plain(gt_cwin, up, coarse_dims):
    """Plain PyTorch version of :func:`parity_div_apply` on any device."""
    return div_compact_plain(gt_cwin, up, div_class_pairs(coarse_dims))


# ------------------------------------------------- flat elemental ops
#
# The element grid is EMBEDDED in the coarse grid (element (I,J,K) at
# coarse flat q = (K*cy + J)*cx + I; element tables are re-embedded on that
# axis at setup with zeros at non-element positions), so every elemental
# gather channel o = (ox, oy, oz) is ONE minor-axis shift of class (o & 1)
# by dqf = flat(o >> 1).  Row-crossing reads land on non-element
# positions, where the embedded tables are zero.


def elem_channel_shifts(coarse_dims):
    """Per window channel (z-major (ox,oy,oz) scan): (class idx, flat
    coarse shift dqf)."""
    cx, cy, _ = coarse_dims
    out = []
    for oz in range(3):
        for oy in range(3):
            for ox in range(3):
                p_idx = ((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)
                dqf = ((oz >> 1) * cy + (oy >> 1)) * cx + (ox >> 1)
                out.append((p_idx, dqf))
    return tuple(out)


def embed_elem_table(t: np.ndarray, elem_dims, coarse_dims, sp: int):
    """Host, setup-time: re-embed an element table ``t (..., NE)`` (z-major
    element grid) on the coarse-flat axis -> ``(..., sp)`` with zeros at
    non-element positions."""
    ex, ey, ez = elem_dims
    cx, cy, cz = coarse_dims
    lead = t.shape[:-1]
    buf = np.zeros((*lead, cz, cy, cx), t.dtype)
    buf[..., :ez, :ey, :ex] = t.reshape(*lead, ez, ey, ex)
    out = np.zeros((*lead, sp), t.dtype)
    out[..., : cx * cy * cz] = buf.reshape(*lead, -1)
    return out


def _shift_left(x: torch.Tensor, dqf: int) -> torch.Tensor:
    """out[..., q] = x[..., q + dqf], zero-filled tail."""
    return x if dqf == 0 else F.pad(x, (0, dqf))[..., dqf:]


def _shift_right(x: torch.Tensor, dqf: int) -> torch.Tensor:
    """out[..., q] = x[..., q - dqf], zero-filled head."""
    return x if dqf == 0 else F.pad(x, (dqf, 0))[..., : x.shape[-1]]


def parity_gather_elem_flat(u: torch.Tensor, coarse_dims) -> torch.Tensor:
    """(C, 27, Sp) elemental gather from a class-major field (C, 8, Sp)
    on the EMBEDDED element axis — 27 contiguous minor-axis shifts."""
    return torch.stack(
        [_shift_left(u[:, p_idx], dqf) for (p_idx, dqf) in elem_channel_shifts(coarse_dims)],
        dim=1,
    )


def parity_scatter_elem_flat(r_e: torch.Tensor, coarse_dims) -> torch.Tensor:
    """(C, 8, Sp) elemental scatter-add of ``r_e (C, 27, Sp)`` on the
    embedded element axis: per class one sum of right-shifted channels, in
    channel order."""
    acc = [None] * 8
    for c, (p_idx, dqf) in enumerate(elem_channel_shifts(coarse_dims)):
        v = _shift_right(r_e[:, c], dqf)
        acc[p_idx] = v if acc[p_idx] is None else acc[p_idx] + v
    return torch.stack(acc, dim=1)


# ---------------------------------------------- convection weight planes
#
# A(un) as 729 per-pair weight PLANES streamed through parity_apply as its
# second table:  out[p_out(i), q] += ae[i, j, q - di] * u[p_in(j), q + (dj - di)],
# so plane (i, j) is ae's embedded element row shifted RIGHT by flat(di).
# Ordering the i axis grouped by di (``i_order``) makes the per-step plane
# build 8 contiguous shifts of ae's (27*27, Sp) view.


def build_conv_plane_route(local_off, coarse_dims):
    """Host, setup-time.  Returns ``(i_order, groups, pairs2)``:

    * ``i_order (27,)`` — permutation of the local i channels grouped by
      their element-corner offset di = oi >> 1;
    * ``groups`` — tuple of ``(row_start, n_rows, dqf)`` over the 729-row
      plane axis, dqf = flat(di), the shift :func:`conv_planes_from_ae`
      applies;
    * ``pairs2`` — per output class p: tuple of ``(plane, p_in, dq)`` for
      :func:`parity_apply`'s second table.
    """
    cx, cy, _ = coarse_dims
    cls = lambda o: ((o[2] & 1) * 2 + (o[1] & 1)) * 2 + (o[0] & 1)
    di_of = lambda o: (o[0] >> 1, o[1] >> 1, o[2] >> 1)
    flat = lambda d: (d[2] * cy + d[1]) * cx + d[0]
    i_order = sorted(range(len(local_off)), key=lambda i: (di_of(local_off[i]), i))
    groups = []
    pairs2 = [[] for _ in range(8)]
    row = 0
    g_start, g_di = 0, di_of(local_off[i_order[0]])
    for i in i_order:
        oi = local_off[i]
        di = di_of(oi)
        if di != g_di:
            groups.append((g_start, row - g_start, flat(g_di)))
            g_start, g_di = row, di
        for oj in local_off:
            dj = di_of(oj)
            dq = flat((dj[0] - di[0], dj[1] - di[1], dj[2] - di[2]))
            pairs2[cls(oi)].append((row, cls(oj), dq))
            row += 1
    groups.append((g_start, row - g_start, flat(g_di)))
    return tuple(i_order), tuple(groups), tuple(tuple(v) for v in pairs2)


def conv_planes_from_ae(ae: torch.Tensor, *, groups) -> torch.Tensor:
    """(1, 729, Sp) convection weight planes from ``ae (27, 27, Sp)``
    built with the i axis in ``i_order`` on the embedded element axis —
    8 contiguous minor-axis shifts."""
    ni, nj, sp = ae.shape
    ae2 = ae.reshape(ni * nj, sp)
    parts = [_shift_right(ae2[a: a + n], dqf) for (a, n, dqf) in groups]
    return torch.cat(parts, dim=0)[None]


def conv_plane_merge_matrix(local_off, i_order, pairs, coarse_dims):
    """Host, setup-time: 0/1 selection ``sel (n_planes, 27*27)`` merging
    the 729 convection planes (in :func:`build_conv_plane_route` order)
    onto a STATIC concat-slot table's planes:

        merged = sel @ conv_planes    (one matmul per step)

    Each conv plane (i, j) lands on the static plane with the same
    (p_out, p_in, dq) key.  Raises ``ValueError`` when a target plane is
    structurally absent from ``pairs`` (e.g. fully masked by Dirichlet
    rows on a one-element-thin box)."""
    cx, cy, _ = coarse_dims
    cls = lambda o: ((o[2] & 1) * 2 + (o[1] & 1)) * 2 + (o[0] & 1)
    di_of = lambda o: (o[0] >> 1, o[1] >> 1, o[2] >> 1)
    n_planes = 1 + max(j for cls_ in pairs for (j, _, _) in cls_)
    nj = len(local_off)
    sel = np.zeros((n_planes, len(i_order) * nj), np.float32)
    row = 0
    for i in i_order:
        oi = local_off[i]
        di = di_of(oi)
        p_out = cls(oi)
        for oj in local_off:
            dj = di_of(oj)
            dq = ((dj[2] - di[2]) * cy + (dj[1] - di[1])) * cx + (dj[0] - di[0])
            hits = [jj for (jj, pp, dd) in pairs[p_out] if pp == cls(oj) and dd == dq]
            if not hits:
                raise ValueError(
                    f"static plane (p_out={p_out}, p_in={cls(oj)}, dq={dq}) "
                    "absent — cannot merge the convection planes"
                )
            sel[hits[0], row] = 1.0
            row += 1
    return sel


def diag_plane_indices(pairs):
    """Per output class: the concat-slot plane holding the diagonal
    (p_in == p_out, dq == 0)."""
    out = []
    for p in range(8):
        hits = [jj for (jj, pp, dd) in pairs[p] if pp == p and dd == 0]
        assert len(hits) == 1, (p, hits)
        out.append(hits[0])
    return tuple(out)


def parity_forms(s, i, rng):
    """Inputs of every :func:`parity_apply` form of the explicit (``s``) and
    implicit (``i``) parity solvers, each (name, wc, x, pairs, wc2, pairs2)
    on fields and convection planes drawn from ``rng`` on the solvers'
    device: K, G, K + A (explicit), MK + A and M (implicit).  For checking
    and timing the kernels (``compare_build``, ``chip_smoke.py``, the
    tests); no solver calls it."""
    dev, sp = s.device, s.sp_c
    u = torch.from_numpy(rng.standard_normal((3, 8, sp)).astype(np.float32)).to(dev)
    p = torch.zeros(1, 1, sp, device=dev)
    p[0, 0, : s.nnp] = torch.from_numpy(rng.standard_normal(s.nnp).astype(np.float32))
    ae = rng.standard_normal((27, 27, int(np.prod(s.elem_dims)))).astype(np.float32) * 1e-3
    ae_e = embed_elem_table(ae, s.elem_dims, s.coarse_dims, sp)
    planes = conv_planes_from_ae(
        torch.from_numpy(np.ascontiguousarray(ae_e[list(s.conv_i_order)])).to(dev),
        groups=s.conv_groups)
    return [("k", s.d["Kp"], u, s.k_pairs, None, None),
            ("g", s.d["Gp"], p, s.g_pairs, None, None),
            ("k_plus_a", s.d["Kp"], u, s.k_pairs, planes, s.conv_pairs2),
            ("mk_plus_a", i.d["MKp"], u, i.a_pairs, None, None),
            ("m", i.d["Mp"], u, i.m_pairs, None, None)]
