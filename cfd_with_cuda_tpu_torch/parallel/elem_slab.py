"""The element passes of the sharded interleaved steps, on an element slab.

The convection of both interleaved steps is elemental: A_e(u^n) is built
from each element's 27 nodes once a step, then either assembled into the
operator's compact rows (the explicit ``conv_mode="assemble"`` and the
implicit LHS) or applied matrix-free to u* each sub-iteration (gather,
per-element matvec, parity-grouped scatter).  A rank owns the fine rows
``[r0, r1)`` of the flat z-major grid; the elements that reach them are the
z-layers ``[ez_lo, ez_hi]`` whose fine planes ``2 ez .. 2 ez + 2`` meet the
rank's planes.  Those layers form a box of their own (the slab: every x and
y, fine planes ``[2 ez_lo, 2 ez_hi + 3)``), on which the single-device
element ops run unchanged; its elements are a contiguous run of the
element-grid order, so the element tables are cut by column.  The slab's
field comes from an element halo exchange (:func:`slab_field`: the same
width for every rank, the largest any rank needs), and the slab's results
are cut to the rank's rows (:func:`slab_rows`, :func:`slab_to_block`).
Every row of the rank gets every element's term in the same order as on
one device, so the sums are those of the single-device step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.ops.window_stencil import SPMV_BLOCKS, spmv_layout
from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh, halo_exchange

__all__ = ["ElemSlab", "elem_slab", "slab_field", "slab_rows", "slab_to_block"]


class ElemSlab(NamedTuple):
    """A rank's element slab (``e1 == e0``: the rank holds no grid row)."""
    r0: int
    r1: int
    start: int              # first global fine row of the slab
    size: int               # fine rows of the slab
    e0: int                 # first element (element-grid order)
    e1: int
    fine_dims: tuple
    elem_dims: tuple
    left: int               # the element halo exchange's widths (every rank's)
    right: int


def _slab_of(fine_dims, elem_dims, r0, r1):
    """(start, end, ez_lo, ez_hi) of the rows [r0, r1), or None without grid rows."""
    fx, fy, fz = fine_dims
    ex, ey, ez = elem_dims
    size = fx * fy * fz
    if r0 >= min(r1, size):
        return None
    z0, z1 = r0 // (fx * fy), (min(r1, size) - 1) // (fx * fy)
    lo, hi = max(0, (z0 - 1) // 2), min(ez - 1, z1 // 2)
    return 2 * lo * fx * fy, (2 * hi + 3) * fx * fy, lo, hi


def elem_slab(fine_dims, elem_dims, s_pad: int, mesh: Mesh) -> ElemSlab:
    """This rank's :class:`ElemSlab` on the padded fine axis ``s_pad``."""
    fx, fy, _ = fine_dims
    ex, ey, _ = elem_dims
    s_loc = s_pad // mesh.size
    left = right = 0
    for r in range(mesh.size):
        sl = _slab_of(fine_dims, elem_dims, r * s_loc, (r + 1) * s_loc)
        if sl is not None:
            left = max(left, r * s_loc - sl[0])
            right = max(right, sl[1] - (r + 1) * s_loc)
    r0, r1 = mesh.rank * s_loc, (mesh.rank + 1) * s_loc
    sl = _slab_of(fine_dims, elem_dims, r0, r1)
    if sl is None:
        return ElemSlab(r0, r1, r0, 0, 0, 0, (fx, fy, 0), (ex, ey, 0), left, right)
    start, end, lo, hi = sl
    nz = hi - lo + 1
    return ElemSlab(r0, r1, start, end - start, lo * ex * ey, (hi + 1) * ex * ey,
                    (fx, fy, 2 * nz + 1), (ex, ey, nz), left, right)


def slab_field(u_loc: torch.Tensor, slab: ElemSlab, mesh: Mesh,
               what: str = "halo_elem") -> torch.Tensor:
    """``(C, slab.size)``: the slab's part of the node-sharded ``u (C,
    s_loc)`` through one element halo exchange (every rank calls it)."""
    ext, lo = halo_exchange(u_loc, slab.left, slab.right, mesh, what)
    a = slab.start - (slab.r0 - lo)
    return ext[:, a: a + slab.size]


def slab_rows(y_slab: torch.Tensor, slab: ElemSlab) -> torch.Tensor:
    """``(C, r1 - r0)``: the rank's rows of a slab field (zero on the rows
    past the grid)."""
    c = y_slab.shape[0]
    out = y_slab.new_zeros((c, slab.r1 - slab.r0))
    if slab.size:
        a, b = slab.r0 - slab.start, min(slab.r1, slab.start + slab.size) - slab.start
        out[:, : b - a] = y_slab[:, a:b]
    return out


def slab_to_block(c_slab: torch.Tensor, slab: ElemSlab, offsets, fine_dims,
                  s_pad: int) -> torch.Tensor:
    """The rank's compact table (``compact_spmv_window(..., rows=(r0, r1))``)
    of the values ``c_slab`` in the slab's own compact table (the whole slab,
    ``assemble_compact_values`` on its box): each class block's run of the
    rank's rows, the padding rows zero.  A rank without grid rows passes an
    empty ``c_slab`` and gets a zero table."""
    lay = spmv_layout(offsets, fine_dims, s_pad, (slab.r0, slab.r1))
    if not slab.size:
        return c_slab.new_zeros(lay.size)
    lay_s = spmv_layout(offsets, slab.fine_dims, slab.size)
    parts = []
    for b in range(SPMV_BLOCKS):
        cnt, rows = int(lay.counts[b]), int(lay.rows[b])
        if not (cnt and rows):
            continue
        if b == SPMV_BLOCKS - 1:
            parts.append(c_slab.new_zeros(cnt * rows))
            continue
        rows_s = int(lay_s.rows[b])
        lo = int(np.searchsorted(lay_s.order[b] + slab.start, lay.order[b][0]))
        blk = c_slab[lay_s.bases[b]: lay_s.bases[b] + cnt * rows_s].view(cnt, rows_s)
        parts.append(blk[:, lo: lo + rows].reshape(-1))
    return torch.cat(parts)
