"""Shape-function library (Q1 trilinear, Q2 triquadratic hexes; P1 tets).

Reproduces the reference element library (``calcShape()``,
``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:2215-2488``) but built
generically as tensor products of 1D Lagrange polynomials on {-1, 0, +1}
instead of 35 hand-written expressions.  The 27-node local ordering matches
the reference exactly:

* nodes 0-7:   corners (``:2312-2319``),
* nodes 8-19:  mid-edge nodes, edge order of ``setupNonCornerNodes()``
  (``:1002-1054`` — bottom ring, vertical, top ring),
* nodes 20-25: mid-face nodes, face order of the face switch (``:1140-1180``),
* node 26:     mid-element node.

Port of ``cfd_with_cuda_tpu/fem/shape.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "HEX27_LOCAL_COORDS",
    "HEX8_LOCAL_COORDS",
    "HEX_EDGES",
    "HEX_FACE_CORNERS",
    "HEX_FACE_ALL_NODES",
    "shape_hex",
    "shape_functions",
]

# Local (ksi, eta, zeta) coordinates of the 27 velocity nodes, reference order.
HEX27_LOCAL_COORDS = np.array(
    [
        # corners 0-7
        (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
        (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
        # mid-edge 8-19 (bottom ring, vertical, top ring)
        (0, -1, -1), (1, 0, -1), (0, 1, -1), (-1, 0, -1),
        (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
        (0, -1, 1), (1, 0, 1), (0, 1, 1), (-1, 0, 1),
        # mid-face 20-25 (bottom, front, right, back, left, top)
        (0, 0, -1), (0, -1, 0), (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 1),
        # mid-element
        (0, 0, 0),
    ],
    dtype=np.float64,
)

HEX8_LOCAL_COORDS = HEX27_LOCAL_COORDS[:8]

# Edge -> (corner, corner) table of setupNonCornerNodes()
# (blascoCodinaHuerta.cpp:1005-1054).
HEX_EDGES = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (4, 5), (5, 6), (6, 7), (7, 4),
    ],
    dtype=np.int64,
)

# Face -> corner-node table (blascoCodinaHuerta.cpp:1143-1180, also used for
# BC faces at :1433-1470).
HEX_FACE_CORNERS = np.array(
    [
        (0, 1, 2, 3),   # bottom  (zeta = -1)
        (0, 1, 4, 5),   # front   (eta  = -1)
        (1, 2, 5, 6),   # right   (ksi  = +1)
        (2, 3, 6, 7),   # back    (eta  = +1)
        (0, 3, 4, 7),   # left    (ksi  = -1)
        (4, 5, 6, 7),   # top     (zeta = +1)
    ],
    dtype=np.int64,
)

# Face -> all 9 local node indices (4 corners + 4 mid-edges + mid-face), used
# when converting face BCs to node BCs for 27-node elements
# (determineVelBCnodes(), blascoCodinaHuerta.cpp:1485-1527).
HEX_FACE_ALL_NODES = np.array(
    [
        (0, 1, 2, 3, 8, 9, 10, 11, 20),
        (0, 1, 4, 5, 8, 12, 13, 16, 21),
        (1, 2, 5, 6, 9, 13, 14, 17, 22),
        (2, 3, 6, 7, 10, 14, 15, 18, 23),
        (0, 3, 4, 7, 11, 12, 15, 19, 24),
        (4, 5, 6, 7, 16, 17, 18, 19, 25),
    ],
    dtype=np.int64,
)


def _lagrange_quadratic(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values/derivs of the 3 quadratic Lagrange polys on nodes {-1, 0, +1}.

    Returns (vals (..., 3), derivs (..., 3)) indexed by node position
    -1 -> 0, 0 -> 1, +1 -> 2.
    """
    x = np.asarray(x, dtype=np.float64)
    vals = np.stack(
        [0.5 * (x * x - x), 1.0 - x * x, 0.5 * (x * x + x)], axis=-1
    )
    derivs = np.stack(
        [x - 0.5, -2.0 * x, x + 0.5], axis=-1
    )
    return vals, derivs


def _lagrange_linear(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values/derivs of the 2 linear Lagrange polys on nodes {-1, +1}."""
    x = np.asarray(x, dtype=np.float64)
    vals = np.stack([0.5 * (1.0 - x), 0.5 * (1.0 + x)], axis=-1)
    derivs = np.stack(
        [np.full_like(x, -0.5), np.full_like(x, 0.5)], axis=-1
    )
    return vals, derivs


def shape_hex(points: np.ndarray, nen: int) -> tuple[np.ndarray, np.ndarray]:
    """Shape functions of the nen-node hex at local points (NP, 3).

    Returns ``(S (NP, nen), dS (NP, nen, 3))`` where ``dS[..., d]`` is the
    derivative w.r.t. local coordinate d (ksi, eta, zeta).  Matches the
    reference's ``Sv/dSv`` (nen=27, ``calcShape() :2306-2448``) and
    ``Sp/dSp`` (nen=8, ``:2254-2298``) exactly (same formulas via tensor
    product).
    """
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if nen == 27:
        local = HEX27_LOCAL_COORDS
        lag = _lagrange_quadratic
        # position index: -1 -> 0, 0 -> 1, +1 -> 2
        idx = (local + 1).astype(np.int64)
    elif nen == 8:
        local = HEX8_LOCAL_COORDS
        lag = _lagrange_linear
        # position index: -1 -> 0, +1 -> 1
        idx = ((local + 1) // 2).astype(np.int64)
    else:
        raise ValueError(f"unsupported hex element with {nen} nodes (use 8 or 27)")

    # Per-axis 1D values and derivatives at each point: (NP, n1d)
    axes_vals, axes_derivs = zip(*(lag(points[:, d]) for d in range(3)))

    nP = points.shape[0]
    S = np.ones((nP, nen))
    dS = np.empty((nP, nen, 3))
    # Gather per-node factors: f_d (NP, nen) = value of axis-d polynomial
    f = [axes_vals[d][:, idx[:, d]] for d in range(3)]
    g = [axes_derivs[d][:, idx[:, d]] for d in range(3)]
    S = f[0] * f[1] * f[2]
    dS[:, :, 0] = g[0] * f[1] * f[2]
    dS[:, :, 1] = f[0] * g[1] * f[2]
    dS[:, :, 2] = f[0] * f[1] * g[2]
    return S, dS


def shape_functions(etype: int, nen: int, points: np.ndarray):
    """Dispatch on deck element type (1: hex; 2: tet 4-node)."""
    if etype == 1:
        return shape_hex(points, nen)
    if etype == 2:
        if nen != 4:
            raise ValueError("only 4-node tets are supported")
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        ksi, eta, zeta = pts[:, 0], pts[:, 1], pts[:, 2]
        S = np.stack([1.0 - ksi - eta - zeta, ksi, eta, zeta], axis=-1)
        dS = np.broadcast_to(
            np.array(
                [
                    [-1.0, -1.0, -1.0],
                    [1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0],
                    [0.0, 0.0, 1.0],
                ]
            ),
            (pts.shape[0], 4, 3),
        ).copy()
        return S, dS
    raise ValueError(f"unsupported element type {etype}")
