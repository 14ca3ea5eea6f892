"""Gauss quadrature rules for hexahedral elements.

Capability parity with the reference's ``setupGQ()``
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:2166-2208``), which
supports 1- and 8-point hex rules (27-point left as a TODO there).  Here all
three tensor-product rules (1, 8, 27) are provided.  Port of
``cfd_with_cuda_tpu/fem/quadrature.py`` without its tetrahedral rules (the
port's solver runs hex box grids only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_quadrature_hex", "gauss_quadrature"]


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


def gauss_quadrature(etype: int, ngp: int) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch on the deck's element type (1: hex)."""
    if etype == 1:
        return gauss_quadrature_hex(ngp)
    raise ValueError(f"unsupported element type {etype} (the port runs hexes only)")
