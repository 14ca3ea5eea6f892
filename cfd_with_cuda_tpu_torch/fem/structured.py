"""Structured-grid detection and DIA (diagonal) operator construction.

Port of ``cfd_with_cuda_tpu/fem/structured.py``.  Every benchmark deck of
the reference (lid-driven cavity, duct meshes from the structured MATLAB
generators) is topologically a box grid, so after lexicographic
renumbering the FEM operators become *banded*: col - row takes at most
5^3 = 125 distinct values (Q2 hexes).  Stored per offset (DIA), each
operator becomes a set of value planes that the parity-layout kernels
stream (``ops/parity_stencil.py``).

* K:          fine velocity grid (2n+1)^3, <= 125 diagonals.
* Z:          coarse pressure grid (n+1)^3, <= 125 diagonals.
* G / G^T:    mixed fine x coarse — the coarse field is embedded at the
  even fine positions, turning both into fine-grid DIA operators with
  offsets in [-2, 2]^3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

__all__ = [
    "GridIndex", "DiaOperator", "PromotedBoxInfo",
    "detect_structured_grid", "detect_structured_elements",
    "detect_promoted_box", "dia_from_csr", "shard_pad_size",
]


@dataclass(frozen=True)
class GridIndex:
    """Bijection node id <-> lexicographic flat grid id.

    ``flat_of_node (N,)``: grid id (z-major: ((k*Sy)+j)*Sx + i) per node.
    ``dims = (Sx, Sy, Sz)``.
    """

    flat_of_node: np.ndarray
    dims: tuple[int, int, int]

    @property
    def size(self) -> int:
        sx, sy, sz = self.dims
        return sx * sy * sz


def _axis_ranks(values: np.ndarray, tol: float):
    """Map each value to the index of its cluster among sorted uniques.
    Returns (ranks, n_unique) or None if clusters are ambiguous."""
    order = np.argsort(values, kind="stable")
    sorted_vals = values[order]
    gaps = np.diff(sorted_vals) > tol
    cluster_sorted = np.concatenate([[0], np.cumsum(gaps)])
    ranks = np.empty(values.size, dtype=np.int64)
    ranks[order] = cluster_sorted
    return ranks, int(cluster_sorted[-1]) + 1


def detect_structured_grid(coords: np.ndarray, tol: float = 1e-8) -> GridIndex | None:
    """Detect an axis-aligned tensor-product grid; None if unstructured."""
    n = coords.shape[0]
    ranks = []
    dims = []
    for ax in range(3):
        r, s = _axis_ranks(coords[:, ax], tol)
        ranks.append(r)
        dims.append(s)
    sx, sy, sz = dims
    if sx * sy * sz != n:
        return None
    flat = (ranks[2] * sy + ranks[1]) * sx + ranks[0]
    # must be a bijection
    seen = np.zeros(n, dtype=bool)
    seen[flat] = True
    if not seen.all():
        return None
    return GridIndex(flat_of_node=flat, dims=(sx, sy, sz))


@dataclass(frozen=True)
class DiaOperator:
    """Banded operator on a flat 3D grid.

    * ``offsets3 (n, 3)`` — per-diagonal (dz, dy, dx) index deltas.
    * ``flat_offsets`` — tuple of flat deltas dz*Sy*Sx + dy*Sx + dx
      (static, for the roll-based apply).
    * ``vals (n, S)`` — value stream per diagonal, indexed by *row* grid id.
    * ``dims = (Sx, Sy, Sz)`` of the grid the operator acts on.
    """

    offsets3: np.ndarray
    flat_offsets: tuple[int, ...]
    vals: np.ndarray
    dims: tuple[int, int, int]

    @property
    def radius(self) -> int:
        return int(np.abs(self.offsets3).max())

    def window_vals(self, radius: int | None = None,
                    dtype=None) -> np.ndarray:
        """(W^3, S) value array in conv-patches channel order (z-major
        window scan), zero rows for absent offsets — the layout consumed
        by ``ops.stencil.patches_spmv``."""
        r = self.radius if radius is None else radius
        assert r >= self.radius
        w = 2 * r + 1
        out = np.zeros((w * w * w, self.vals.shape[1]),
                       dtype=dtype or self.vals.dtype)
        chan = (
            (self.offsets3[:, 0] + r) * w * w
            + (self.offsets3[:, 1] + r) * w
            + (self.offsets3[:, 2] + r)
        )
        out[chan] = self.vals
        return out


def detect_structured_elements(
    ltog_node: np.ndarray,
    node_flat: np.ndarray,
    fine_dims: tuple[int, int, int],
) -> tuple[np.ndarray, tuple[int, int, int], np.ndarray] | None:
    """Verify elements tile the fine grid; return element-grid ordering.

    For each element, the 27 local nodes must sit at a common origin
    (2I, 2J, 2K) plus the canonical fine-unit offsets (0..2 per axis,
    from the reference local ordering).  Returns
    ``(elem_perm (NE,), elem_dims, local_off (27, 3))`` where
    ``elem_perm[e]`` is element e's flat grid id, or None if any element
    deviates (rotated/mirrored connectivity -> gather fallback).
    """
    from cfd_with_cuda_tpu_torch.fem.shape import HEX27_LOCAL_COORDS

    fx, fy, fz = fine_dims
    ex, ey, ez = (fx - 1) // 2, (fy - 1) // 2, (fz - 1) // 2
    local = (HEX27_LOCAL_COORDS + 1).astype(np.int64)   # (27, 3) in 0..2
    local_flat = local[:, 2] * fy * fx + local[:, 1] * fx + local[:, 0]

    flat = node_flat[ltog_node]                          # (NE, NEN)
    origin = flat[:, 0]                                  # corner 0
    if not np.array_equal(flat, origin[:, None] + local_flat[None, :]):
        return None
    oz = origin // (fx * fy)
    oy = (origin // fx) % fy
    ox = origin % fx
    if (ox % 2).any() or (oy % 2).any() or (oz % 2).any():
        return None
    elem_perm = (oz // 2 * ey + oy // 2) * ex + ox // 2
    return elem_perm, (ex, ey, ez), local


def dia_from_csr(
    A: sp.spmatrix,
    row_grid: np.ndarray,
    col_grid: np.ndarray,
    dims: tuple[int, int, int],
    max_radius: int = 4,
):
    """Convert sparse A to DIA over a common flat 3D grid space.

    ``row_grid (n_rows,)`` / ``col_grid (n_cols,)`` give each matrix
    row/col its flat grid id (z-major) in a grid of ``dims = (Sx,Sy,Sz)``.
    Result satisfies ``y[g] = sum_o vals[o][g] * x[g + flat_offset_o]``.
    Returns None if any per-axis index delta exceeds ``max_radius``
    (unstructured mesh -> caller falls back to ELL).
    """
    sx, sy, sz = dims
    size = sx * sy * sz

    coo = A.tocoo()                    # CSR->COO keeps row-major nnz order
    rg = row_grid[coo.row]
    cg = col_grid[coo.col]
    # per-axis deltas as scalar int arrays (no (nnz,3) stacking — and the
    # offsets are deduplicated through a packed integer key: np.unique on
    # 1-D ints is ~100x faster than unique(axis=0) on row tuples)
    dz = cg // (sx * sy) - rg // (sx * sy)
    dy = (cg // sx) % sy - (rg // sx) % sy
    dx = cg % sx - rg % sx
    if max(
        np.abs(dz).max(initial=0), np.abs(dy).max(initial=0),
        np.abs(dx).max(initial=0),
    ) > max_radius:
        return None
    K = 2 * max_radius + 1
    keys = ((dz + max_radius) * K + (dy + max_radius)) * K + (dx + max_radius)
    # bounded key domain (K^3 <= 729): bincount + lookup table replaces a
    # 20M-element sort entirely
    present = np.bincount(keys, minlength=K * K * K) > 0
    ukeys = np.flatnonzero(present)
    lut = np.zeros(K * K * K, dtype=np.int64)
    lut[ukeys] = np.arange(ukeys.size)
    inverse = lut[keys]
    offsets3 = np.stack(
        [ukeys // (K * K) - max_radius,
         (ukeys // K) % K - max_radius,
         ukeys % K - max_radius], axis=-1,
    )
    vals = np.zeros((offsets3.shape[0], size), dtype=coo.data.dtype)
    vals[inverse, row_grid[coo.row]] = coo.data
    flat = tuple(int(dz) * sy * sx + int(dy) * sx + int(dx)
                 for dz, dy, dx in offsets3)
    return DiaOperator(offsets3=offsets3, flat_offsets=flat, vals=vals, dims=dims)


@dataclass(frozen=True)
class PromotedBoxInfo:
    """A promoted Q2/Q1 mesh recognised as a box grid: the shared
    detection prologue of both fractional-step solvers' structured paths
    (explicit_bch/implicit_gq ``_try_structured``).

    ``perm``/``perm_p``: node id -> fine/coarse flat grid id;
    ``embed``: fine flat id of each coarse node's (2I, 2J, 2K) slot;
    element structure (``elem_*``/``chan_order``/``local_off``) is None
    when the element walk is not itself a box grid.
    """

    fine_dims: tuple[int, int, int]
    coarse_dims: tuple[int, int, int]
    perm: np.ndarray
    perm_p: np.ndarray
    embed: np.ndarray
    elem_perm: np.ndarray | None
    elem_dims: tuple[int, int, int] | None
    chan_order: np.ndarray | None
    local_off: tuple | None

    @property
    def size(self) -> int:
        fx, fy, fz = self.fine_dims
        return fx * fy * fz

    def permute_vec(self, v: np.ndarray) -> np.ndarray:
        """Node order -> fine grid order (last-axis for ndim > 1)."""
        out = np.empty_like(v)
        out[..., self.perm] = v
        return out

    def permute_vec_p(self, v: np.ndarray) -> np.ndarray:
        out = np.empty_like(v)
        out[..., self.perm_p] = v
        return out

    def elem_grid_tables(self, tables):
        """``(Sv (NGP, 27), gDSv (3, 27, NGP, NE), gq (NGP, NE))`` of the
        element tables (``fem/jacobian.ElementTables``) in element-grid order
        with the local-node axis in window-channel order: the layout of both
        solvers' structured steps (element-structured boxes only)."""
        gdsv = np.transpose(tables.gDSv, (3, 2, 1, 0))
        g2 = np.empty_like(gdsv)
        g2[..., self.elem_perm] = gdsv
        q2 = np.empty_like(tables.gq_factor.T)
        q2[..., self.elem_perm] = tables.gq_factor.T
        return tables.Sv[:, self.chan_order], g2[:, self.chan_order], q2


def _element_box_walk(ltog_node: np.ndarray) -> np.ndarray | None:
    """Assign each element an integer (i, j, k) grid position from face
    adjacency alone — no geometry.  Returns ``pos (NE, 3)`` (min 0), or
    None when the element graph is not a consistently-oriented box grid
    (rotated/mirrored connectivity, T-junctions, holes, disconnection).
    """
    from cfd_with_cuda_tpu_torch.fem.shape import HEX8_LOCAL_COORDS

    ne = ltog_node.shape[0]
    corners = ltog_node[:, :8]
    lc = HEX8_LOCAL_COORDS.astype(np.int64)
    # 6 faces in (ax, side) order: f = 2*ax + (side > 0)
    face_locals = [
        np.flatnonzero(lc[:, ax] == side)
        for ax in range(3)
        for side in (-1, 1)
    ]
    keys = np.stack(
        [np.sort(corners[:, idx], axis=1) for idx in face_locals], axis=1
    ).reshape(-1, 4)                       # (NE*6, 4) sorted corner ids
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    if same.size and np.any(same[:-1] & same[1:]):
        return None                        # >= 3 elements share a face
    i1 = np.flatnonzero(same)
    e1, f1 = np.divmod(order[i1], 6)
    e2, f2 = np.divmod(order[i1 + 1], 6)
    # consistent orientation: partners must be OPPOSITE faces of the
    # same axis (my +x face is the neighbour's -x face)
    if np.any(f1 // 2 != f2 // 2) or np.any(f1 % 2 == f2 % 2):
        return None
    adj = np.full((ne, 6), -1, dtype=np.int64)
    adj[e1, f1] = e2
    adj[e2, f2] = e1

    dirvec = np.zeros((6, 3), dtype=np.int64)
    for f in range(6):
        dirvec[f, f // 2] = -1 if f % 2 == 0 else 1
    pos = np.zeros((ne, 3), dtype=np.int64)
    visited = np.zeros(ne, dtype=bool)
    visited[0] = True
    frontier = np.array([0], dtype=np.int64)
    while frontier.size:
        nbrs = adj[frontier]                               # (F, 6)
        cand = pos[frontier][:, None, :] + dirvec[None]    # (F, 6, 3)
        valid = nbrs >= 0
        ids = nbrs[valid]
        cpos = cand[valid]
        new = ~visited[ids]
        pos[ids[new]] = cpos[new]          # duplicates: last write wins,
        visited[ids[new]] = True           # the check below re-verifies all
        if np.any(pos[ids] != cpos):
            return None                    # conflicting assignments
        frontier = np.unique(ids[new])
    if not visited.all():
        return None                        # disconnected element graph
    return pos - pos.min(axis=0)


def _promoted_box_topological(
    nn: int, nnp: int, ltog_node: np.ndarray
) -> PromotedBoxInfo | None:
    """Topological variant of :func:`detect_promoted_box`: recovers the
    box structure from element-face adjacency alone, so *logically*
    structured meshes with curved geometry (the bending duct — a box in
    index space, an annulus in x-y) ride the structured/Pallas fast path
    too.  The DIA/window operator form never needed straight geometry:
    values are per-node streams carrying the true Jacobians."""
    if ltog_node.shape[1] != 27:
        return None
    pos = _element_box_walk(ltog_node)
    if pos is None:
        return None
    ex, ey, ez = (int(v) for v in pos.max(axis=0) + 1)
    if ex * ey * ez != ltog_node.shape[0]:
        return None
    from cfd_with_cuda_tpu_torch.fem.shape import HEX27_LOCAL_COORDS

    fx, fy, fz = 2 * ex + 1, 2 * ey + 1, 2 * ez + 1
    if fx * fy * fz != nn:
        return None
    local = (HEX27_LOCAL_COORDS + 1).astype(np.int64)
    local_flat = local[:, 2] * fy * fx + local[:, 1] * fx + local[:, 0]
    origin = (2 * pos[:, 2] * fy + 2 * pos[:, 1]) * fx + 2 * pos[:, 0]
    flat_all = origin[:, None] + local_flat[None, :]
    perm = np.full(nn, -1, dtype=np.int64)
    perm[ltog_node.reshape(-1)] = flat_all.reshape(-1)
    if not np.array_equal(perm[ltog_node], flat_all):
        return None                        # inconsistent node placement
    seen = np.zeros(nn, dtype=bool)
    seen[perm] = True
    if not seen.all():
        return None
    cx, cy, cz = ex + 1, ey + 1, ez + 1
    if cx * cy * cz != nnp:
        return None
    pf = perm[:nnp]
    pi, pj, pk = pf % fx, (pf // fx) % fy, pf // (fx * fy)
    if np.any((pi & 1) | (pj & 1) | (pk & 1)):
        return None                        # a corner node off the even lattice
    perm_p = ((pk >> 1) * cy + (pj >> 1)) * cx + (pi >> 1)
    seen_p = np.zeros(nnp, dtype=bool)
    seen_p[perm_p] = True
    if not seen_p.all():
        return None
    em = detect_structured_elements(ltog_node, perm, (fx, fy, fz))
    if em is None:
        return None                        # (cannot happen given the walk)
    elem_perm, elem_dims, local8 = em
    chan = (local8[:, 2] * 3 + local8[:, 1]) * 3 + local8[:, 0]
    chan_order = np.argsort(chan)
    local_off = tuple(
        (int(x), int(y), int(z)) for x, y, z in local8[chan_order]
    )
    return PromotedBoxInfo(
        fine_dims=(fx, fy, fz), coarse_dims=(cx, cy, cz),
        perm=perm, perm_p=perm_p, embed=pf.copy(),
        elem_perm=elem_perm, elem_dims=elem_dims,
        chan_order=chan_order, local_off=local_off,
    )


def detect_promoted_box(
    coords: np.ndarray, nnp: int, ltog_node: np.ndarray
) -> PromotedBoxInfo | None:
    """Recognise a promoted mesh as fine (2n+1)^3 over coarse (n+1)^3 box
    grids with the corner nodes exactly at their embedded fine slots.

    Two detectors: the geometric one (axis-aligned coordinate lattice —
    covers every cube/channel/cavity deck) first, then the topological
    element-walk (:func:`_promoted_box_topological`) for logically
    structured meshes with curved coordinates (bending duct)."""
    geo = _promoted_box_geometric(coords, nnp, ltog_node)
    if geo is not None:
        return geo
    return _promoted_box_topological(coords.shape[0], nnp, ltog_node)


def _promoted_box_geometric(
    coords: np.ndarray, nnp: int, ltog_node: np.ndarray
) -> PromotedBoxInfo | None:
    gi = detect_structured_grid(coords)
    if gi is None:
        return None
    gi_p = detect_structured_grid(coords[:nnp])
    if gi_p is None:
        return None
    fx, fy, fz = gi.dims
    cx, cy, cz = gi_p.dims
    if (fx, fy, fz) != (2 * cx - 1, 2 * cy - 1, 2 * cz - 1):
        return None
    perm = gi.flat_of_node
    perm_p = gi_p.flat_of_node
    I = perm_p % cx
    J = (perm_p // cx) % cy
    Kc = perm_p // (cx * cy)
    embed = (2 * Kc * fy + 2 * J) * fx + 2 * I
    if not np.array_equal(perm[:nnp], embed):
        return None
    em = detect_structured_elements(ltog_node, perm, (fx, fy, fz))
    if em is None:
        elem_perm = elem_dims = chan_order = local_off = None
    else:
        elem_perm, elem_dims, local = em
        # local-node axis in window-channel order (z-major window scan)
        # so the stride-2 patches gather needs no permutation
        chan = (local[:, 2] * 3 + local[:, 1]) * 3 + local[:, 0]
        chan_order = np.argsort(chan)
        local_off = tuple(
            (int(x), int(y), int(z)) for x, y, z in local[chan_order]
        )
    return PromotedBoxInfo(
        fine_dims=(fx, fy, fz), coarse_dims=(cx, cy, cz),
        perm=perm, perm_p=perm_p, embed=embed,
        elem_perm=elem_perm, elem_dims=elem_dims,
        chan_order=chan_order, local_off=local_off,
    )


def shard_pad_size(size: int, config, kernel_layout: bool) -> int:
    """Padded fine-axis length: a ``shard_pad`` multiple, lcm'd with the
    window kernels' block size ``BLK`` x the device count on the kernel
    path (the JAX package's padding, so both packages' tables compare
    element-wise; padding rows carry zero operator values)."""
    pad = max(1, int(config.shard_pad))
    if kernel_layout:
        from cfd_with_cuda_tpu_torch.ops.window_stencil import BLK

        pad = int(np.lcm(pad, BLK * max(1, int(config.spmd_devices))))
    return -(-size // pad) * pad
