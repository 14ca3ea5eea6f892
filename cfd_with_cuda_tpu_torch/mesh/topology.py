"""Mesh/topology engine: 8->27 node promotion, DOF maps, BC nodes.

Numpy re-implementation of the reference preprocessing ladder
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp``):

* ``promote_hex_mesh``   <- ``setupNonCornerNodes()`` (:954-1320).  The
  reference deduplicates new mid-edge/mid-face nodes by coordinate matching
  against neighbour elements; here the same numbering is produced directly
  from topological keys (sorted corner tuples) in first-seen order, which is
  equivalent and O(NE) instead of O(NE * neighbours).
* ``face_bc_to_node_bc`` <- ``determineVelBCnodes()`` (:1410-1580).
* ``find_monitor_node``  <- ``findMonitorPoint()`` (:1644-1668).

Port of ``cfd_with_cuda_tpu/mesh/topology.py``.  No mesh coloring is
built: assembly happens once on the host (``fem/assembly.py``), so the
reference's greedy coloring (:853-947) has no role.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_with_cuda_tpu_torch.fem.shape import (
    HEX_EDGES,
    HEX_FACE_ALL_NODES,
    HEX_FACE_CORNERS,
)

__all__ = [
    "PromotedMesh",
    "promote_hex_mesh",
    "face_bc_to_node_bc",
    "find_monitor_node",
]


@dataclass(frozen=True)
class PromotedMesh:
    """27-node hex mesh produced from an 8-corner-node mesh.

    * ``ltog_node (NE, 27)`` — local->global velocity-node map.
    * ``coords (NN, 3)``     — all node coordinates (corners first, then
      mid-edge nodes, then mid-face nodes, then mid-element nodes, in the
      same first-seen order the reference produces).
    * ``ncn`` — number of corner (pressure) nodes; ``nn`` — all nodes.
    """

    ltog_node: np.ndarray
    coords: np.ndarray
    ncn: int
    nn: int


def _pack_rows(keys: np.ndarray) -> np.ndarray:
    """Collision-free int64 scalar key per row of ``keys (n, c)``.

    Plain positional packing (``sum k_i * base**i``) overflows int64 for
    4-column face keys once the corner-node count passes ~55k — well
    inside the NE85k/NE125k deck range — and numpy wraps silently, which
    could merge distinct faces.  When the direct pack would overflow,
    halve the columns recursively and re-densify each half to its unique
    ranks (bounded by the row count) before combining.
    """
    if keys.size == 0:
        return np.zeros(0, np.int64)
    ncols = keys.shape[1]
    if ncols == 1:
        return keys[:, 0].copy()
    base = int(keys.max()) + 1
    if base ** ncols < 2 ** 62:
        packed = keys[:, 0]
        for c in range(1, ncols):
            packed = packed * base + keys[:, c]
        return packed
    mid = ncols // 2
    left = np.unique(_pack_rows(keys[:, :mid]), return_inverse=True)[1]
    right = np.unique(_pack_rows(keys[:, mid:]), return_inverse=True)[1]
    return left * (int(right.max()) + 1) + right


def _first_seen_ids(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Number unique rows of ``keys`` by order of first occurrence.

    Returns (ids (len(keys),), num_unique).  Reproduces the reference's
    incremental first-seen numbering (:1095-1101) without the quadratic
    coordinate search.  Rows are packed into scalar int64 keys; the
    native C++ runtime kernel is used when available.
    """
    keys = np.asarray(keys, dtype=np.int64)
    packed = _pack_rows(keys)
    try:
        from cfd_with_cuda_tpu_torch.runtime import native

        return native.first_seen_ids(packed)
    except ImportError:
        _, first_idx, inverse = np.unique(
            packed, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        return rank[inverse], order.size


def promote_hex_mesh(corner_conn: np.ndarray, corner_coords: np.ndarray) -> PromotedMesh:
    """Promote an 8-node hex mesh to 27 nodes (mid-edge/face/element).

    ``corner_conn (NE, 8)`` int, 0-based; ``corner_coords (NCN, 3)``.
    Node numbering matches the reference exactly: corners keep their ids,
    then mid-edge nodes are numbered in (element, edge) first-seen order,
    then mid-face nodes in (element, face) first-seen order, then one
    mid-element node per element (:976-1259).
    """
    corner_conn = np.asarray(corner_conn, dtype=np.int64)
    corner_coords = np.asarray(corner_coords, dtype=np.float64)
    ne = corner_conn.shape[0]
    ncn = corner_coords.shape[0]

    ltog = np.empty((ne, 27), dtype=np.int64)
    ltog[:, :8] = corner_conn

    # --- mid-edge nodes (local 8..19) ---
    edge_nodes = corner_conn[:, HEX_EDGES]                 # (NE, 12, 2)
    edge_keys = np.sort(edge_nodes.reshape(-1, 2), axis=1)  # undirected edges
    edge_ids, n_edges = _first_seen_ids(edge_keys)
    ltog[:, 8:20] = ncn + edge_ids.reshape(ne, 12)
    edge_coords = corner_coords[edge_keys].mean(axis=1)    # (NE*12, 3)

    # --- mid-face nodes (local 20..25) ---
    face_nodes = corner_conn[:, HEX_FACE_CORNERS]          # (NE, 6, 4)
    face_keys = np.sort(face_nodes.reshape(-1, 4), axis=1)
    face_ids, n_faces = _first_seen_ids(face_keys)
    ltog[:, 20:26] = ncn + n_edges + face_ids.reshape(ne, 6)
    face_coords = corner_coords[face_keys].mean(axis=1)

    # --- mid-element nodes (local 26) ---
    ltog[:, 26] = ncn + n_edges + n_faces + np.arange(ne)
    elem_coords = corner_coords[corner_conn].mean(axis=1)

    nn = ncn + n_edges + n_faces + ne
    coords = np.empty((nn, 3), dtype=np.float64)
    coords[:ncn] = corner_coords
    # Scatter unique mid-node coordinates (duplicates write the same value).
    coords[ncn + edge_ids] = edge_coords
    coords[ncn + n_edges + face_ids] = face_coords
    coords[ncn + n_edges + n_faces :] = elem_coords

    return PromotedMesh(ltog_node=ltog, coords=coords, ncn=ncn, nn=nn)


def face_bc_to_node_bc(
    ltog_node: np.ndarray,
    bc_vel_faces: np.ndarray,
    nn: int,
    *,
    quadratic: bool = True,
) -> np.ndarray:
    """Convert (elem, face, bc#) velocity-BC rows to per-node BC ids.

    Returns ``bc_of_node (NN,)`` int, -1 where no velocity BC applies.
    Later faces overwrite earlier ones at shared nodes, matching the
    reference's sequential assignment loop (:1426-1540).  When ``quadratic``
    the 9-node face table is used (corners + mid-edge + mid-face nodes).
    """
    bc_of_node = np.full(nn, -1, dtype=np.int64)
    if bc_vel_faces is None or len(bc_vel_faces) == 0:
        return bc_of_node
    bc_vel_faces = np.asarray(bc_vel_faces, dtype=np.int64)
    table = HEX_FACE_ALL_NODES if quadratic else HEX_FACE_CORNERS
    elems = bc_vel_faces[:, 0]
    faces = bc_vel_faces[:, 1]
    bcs = bc_vel_faces[:, 2]
    nodes = ltog_node[elems[:, None], table[faces]]        # (nfaces, 4 or 9)
    # Sequential overwrite semantics: numpy fancy assignment applies the
    # *last* write for duplicate indices when flattened in row order.
    np.put(bc_of_node, nodes.reshape(-1), np.repeat(bcs, table.shape[1]))
    return bc_of_node


def find_monitor_node(corner_coords: np.ndarray, monitor_xyz) -> int:
    """Corner node nearest to the requested monitor coordinates (:1644-1668)."""
    d2 = ((corner_coords - np.asarray(monitor_xyz)[None, :]) ** 2).sum(axis=1)
    return int(np.argmin(d2))
