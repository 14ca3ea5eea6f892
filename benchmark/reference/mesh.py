"""Mesh topology of the reference: the 27-node promotion of an 8-node hex
mesh, face velocity BCs onto nodes, and the monitor node.

A frozen numpy copy of the upstream numbering (``blascoCodinaHuerta.cpp``
:976-1259, :1426-1540, :1644-1668), the node order in which the port
returns its fields: corners keep their ids, then mid-edge, mid-face and
mid-element nodes, each in first-seen (element, local) order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HEX_FACE_CORNERS", "HEX_FACE_ALL_NODES", "promote", "node_bcs", "nearest_corner",
           "boundary_velocity"]

HEX_EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 5), (2, 6), (3, 7),
                      (4, 5), (5, 6), (6, 7), (7, 4)], np.int64)
HEX_FACE_CORNERS = np.array([(0, 1, 2, 3), (0, 1, 4, 5), (1, 2, 5, 6), (2, 3, 6, 7),
                             (0, 3, 4, 7), (4, 5, 6, 7)], np.int64)
HEX_FACE_ALL_NODES = np.array([
    (0, 1, 2, 3, 8, 9, 10, 11, 20), (0, 1, 4, 5, 8, 12, 13, 16, 21),
    (1, 2, 5, 6, 9, 13, 14, 17, 22), (2, 3, 6, 7, 10, 14, 15, 18, 23),
    (0, 3, 4, 7, 11, 12, 15, 19, 24), (4, 5, 6, 7, 16, 17, 18, 19, 25)], np.int64)


def _first_seen(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Ids of the rows of ``keys (n, c)`` (sorted node ids, c <= 4) numbered
    by first occurrence, and the number of distinct rows."""
    _, first, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inverse.ravel()], order.size


def promote(conn: np.ndarray, coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ltog (NE, 27), coords (NN, 3)) of the 27-node mesh."""
    conn = np.asarray(conn, np.int64)
    ne, ncn = conn.shape[0], coords.shape[0]
    ltog = np.empty((ne, 27), np.int64)
    ltog[:, :8] = conn
    edge_keys = np.sort(conn[:, HEX_EDGES].reshape(-1, 2), axis=1)
    edge_ids, n_edges = _first_seen(edge_keys)
    ltog[:, 8:20] = ncn + edge_ids.reshape(ne, 12)
    face_keys = np.sort(conn[:, HEX_FACE_CORNERS].reshape(-1, 4), axis=1)
    face_ids, n_faces = _first_seen(face_keys)
    ltog[:, 20:26] = ncn + n_edges + face_ids.reshape(ne, 6)
    ltog[:, 26] = ncn + n_edges + n_faces + np.arange(ne)
    nn = ncn + n_edges + n_faces + ne
    xyz = np.empty((nn, 3))
    xyz[:ncn] = coords
    xyz[ncn + edge_ids] = coords[edge_keys].mean(axis=1)
    xyz[ncn + n_edges + face_ids] = coords[face_keys].mean(axis=1)
    xyz[ncn + n_edges + n_faces:] = coords[conn].mean(axis=1)
    return ltog, xyz


def node_bcs(ltog: np.ndarray, faces: np.ndarray, nn: int, quadratic: bool = True) -> np.ndarray:
    """(NN,) BC id of each node from (elem, face, bc) rows, -1 where none;
    later faces overwrite earlier ones at shared nodes."""
    out = np.full(nn, -1, np.int64)
    if faces is None or len(faces) == 0:
        return out
    faces = np.asarray(faces, np.int64)
    table = HEX_FACE_ALL_NODES if quadratic else HEX_FACE_CORNERS
    nodes = ltog[faces[:, 0][:, None], table[faces[:, 1]]]
    out[nodes.reshape(-1)] = np.repeat(faces[:, 2], table.shape[1])
    return out


def nearest_corner(coords: np.ndarray, xyz) -> int:
    return int(np.argmin(((coords - np.asarray(xyz)[None]) ** 2).sum(axis=1)))


def boundary_velocity(deck, xyz: np.ndarray, bc_of_node: np.ndarray) -> np.ndarray:
    """(NN, 3) Dirichlet velocity of each BC node (zero elsewhere): the
    deck's per-BC triples."""
    is_bc = bc_of_node >= 0
    vel = np.zeros((xyz.shape[0], 3))
    vel[is_bc] = np.asarray(deck.bc_str)[bc_of_node[is_bc]]
    return vel
