"""Per-element geometry: Jacobians, |J| and physical shape-fn gradients.

Vectorised-over-elements equivalent of the reference's ``calcJacob()``
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:2495-2711``): the
geometry mapping is *trilinear* (built from the 8 corner nodes / pressure
shape functions) even for 27-node velocity elements, and physical-space
derivative tables ``gDSv``/``gDSp`` plus the fused ``GQfactor = detJ * w``
are precomputed once for all elements and all GQ points.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_with_cuda_tpu_torch.fem.quadrature import gauss_quadrature
from cfd_with_cuda_tpu_torch.fem.shape import shape_functions

__all__ = ["ElementTables", "build_element_tables"]


@dataclass(frozen=True)
class ElementTables:
    """Precomputed reference + per-element discretization tables.

    Shapes (NE elements, NGP quadrature points):

    * ``Sv (NGP, NENv)``, ``dSv (NGP, NENv, 3)`` — velocity shape fns at GQ.
    * ``Sp (NGP, NENp)``, ``dSp (NGP, NENp, 3)`` — pressure shape fns at GQ.
    * ``gDSv (NE, NGP, NENv, 3)`` — physical-space velocity gradients.
    * ``gDSp (NE, NGP, NENp, 3)`` — physical-space pressure gradients.
    * ``det_jacob (NE, NGP)`` and ``gq_factor = det_jacob * w (NE, NGP)``.
    """

    points: np.ndarray
    weights: np.ndarray
    Sv: np.ndarray
    dSv: np.ndarray
    Sp: np.ndarray
    dSp: np.ndarray
    gDSv: np.ndarray
    gDSp: np.ndarray
    det_jacob: np.ndarray
    gq_factor: np.ndarray


def build_element_tables(
    coords: np.ndarray,
    ltog_node: np.ndarray,
    *,
    etype: int = 1,
    nenv: int = 27,
    nenp: int = 8,
    ngp: int = 8,
) -> ElementTables:
    """Build all per-element tables from node coords and connectivity.

    ``coords (NN, 3)``, ``ltog_node (NE, NENv)`` (only the first NEC corner
    columns are used for the geometry mapping, like the reference).
    """
    pts, wts = gauss_quadrature(etype, ngp)
    Sv, dSv = shape_functions(etype, nenv, pts)
    Sp, dSp = shape_functions(etype, nenp, pts)

    nec = 8 if etype == 1 else 4
    e_coord = coords[ltog_node[:, :nec]]             # (NE, NEC, 3)

    # Jacobian J[e,k,i,j] = sum_m dSp[k,m,i] * x[e,m,j]  (ref :2566-2574).
    jac = np.einsum("kmi,emj->ekij", dSp[:, :nec], e_coord)
    det = np.linalg.det(jac)                          # (NE, NGP)
    inv = np.linalg.inv(jac)                          # (NE, NGP, 3, 3)

    # gDS[e,k,n,i] = sum_m invJ[e,k,i,m] * dS[k,n,m]  (ref :2597-2615).
    gDSp = np.einsum("ekim,knm->ekni", inv, dSp)
    gDSv = np.einsum("ekim,knm->ekni", inv, dSv)

    gq_factor = det * wts[None, :]
    return ElementTables(
        points=pts,
        weights=wts,
        Sv=Sv,
        dSv=dSv,
        Sp=Sp,
        dSp=dSp,
        gDSv=gDSv,
        gDSp=gDSp,
        det_jacob=det,
        gq_factor=gq_factor,
    )
