"""Gauss quadrature rules for hexahedral and tetrahedral elements.

Capability parity with the reference's ``setupGQ()``
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:2166-2208``), which
supports 1- and 8-point hex rules (27-point left as a TODO there).  Here all
three tensor-product rules (1, 8, 27) are provided, plus 1/4/5-point
tetrahedral rules used by the legacy tet-capable solvers
(``oldFiles/navierStokes3D.cpp``).  Port of
``cfd_with_cuda_tpu/fem/quadrature.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_quadrature_hex", "gauss_quadrature_tet", "gauss_quadrature"]


def _gauss_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """1D Gauss-Legendre points/weights on [-1, 1] for n in {1, 2, 3}."""
    if n == 1:
        return np.array([0.0]), np.array([2.0])
    if n == 2:
        a = np.sqrt(1.0 / 3.0)
        return np.array([-a, a]), np.array([1.0, 1.0])
    if n == 3:
        a = np.sqrt(3.0 / 5.0)
        return np.array([-a, 0.0, a]), np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0])
    raise ValueError(f"unsupported 1D rule order {n}")


def gauss_quadrature_hex(ngp: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product GQ rule for the reference hexahedron [-1,1]^3.

    Returns (points (NGP, 3), weights (NGP,)).  Point ordering for the
    8-point rule matches the reference (ksi fastest, then eta, then zeta;
    ``blascoCodinaHuerta.cpp:2181-2196``).
    """
    n1d = {1: 1, 8: 2, 27: 3}.get(ngp)
    if n1d is None:
        raise ValueError(f"unsupported hex quadrature NGP={ngp} (use 1, 8 or 27)")
    x, w = _gauss_1d(n1d)
    pts = np.empty((ngp, 3))
    wts = np.empty(ngp)
    k = 0
    for iz in range(n1d):
        for ie in range(n1d):
            for ik in range(n1d):
                pts[k] = (x[ik], x[ie], x[iz])
                wts[k] = w[ik] * w[ie] * w[iz]
                k += 1
    return pts, wts


def gauss_quadrature_tet(ngp: int) -> tuple[np.ndarray, np.ndarray]:
    """GQ rules on the reference tetrahedron (volume coordinates).

    Weights sum to 1/6 (the volume of the unit reference tet).
    """
    if ngp == 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        wts = np.array([1.0 / 6.0])
    elif ngp == 4:
        a = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
        b = (5.0 - np.sqrt(5.0)) / 20.0
        pts = np.array(
            [[a, b, b], [b, a, b], [b, b, a], [b, b, b]]
        )
        wts = np.full(4, 1.0 / 24.0)
    elif ngp == 5:
        pts = np.array(
            [
                [0.25, 0.25, 0.25],
                [0.5, 1.0 / 6.0, 1.0 / 6.0],
                [1.0 / 6.0, 0.5, 1.0 / 6.0],
                [1.0 / 6.0, 1.0 / 6.0, 0.5],
                [1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0],
            ]
        )
        wts = np.array([-2.0 / 15.0, 3.0 / 40.0, 3.0 / 40.0, 3.0 / 40.0, 3.0 / 40.0])
    else:
        raise ValueError(f"unsupported tet quadrature NGP={ngp} (use 1, 4 or 5)")
    return pts, wts


def gauss_quadrature(etype: int, ngp: int) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch on the deck's element type (1: hex, 2: tet)."""
    if etype == 1:
        return gauss_quadrature_hex(ngp)
    if etype == 2:
        return gauss_quadrature_tet(ngp)
    raise ValueError(f"unsupported element type {etype}")
