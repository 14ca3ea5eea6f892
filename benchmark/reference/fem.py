"""Q2/Q1 hexahedra of the reference, in plain PyTorch: Gauss rules, shape
functions, the per-element geometry (trilinear map), the elemental
matrices, the scatter of element values and the sparse assembly.

The integrals are the upstream ``step0`` ones (``blascoCodinaHuerta.cpp``
:3190-3229, ``guermondQuartapelle.cpp`` :3604-3623).  Nothing here is
assembled into the port's tables: products are gathers, batched matrix
products and scatter-adds over the elements, or sparse CSR matrices that
this module builds itself.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["Elements", "gauss_hex", "shape_hex"]

warnings.filterwarnings("ignore", message=".*[Ss]parse.*")

_LOCAL27 = np.array([
    (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
    (0, -1, -1), (1, 0, -1), (0, 1, -1), (-1, 0, -1),
    (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
    (0, -1, 1), (1, 0, 1), (0, 1, 1), (-1, 0, 1),
    (0, 0, -1), (0, -1, 0), (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 1),
    (0, 0, 0)], np.float64)


def gauss_hex(ngp: int) -> tuple[np.ndarray, np.ndarray]:
    """(points (NGP, 3), weights) of the tensor Gauss rule, ksi fastest."""
    n1 = {1: 1, 8: 2, 27: 3}[ngp]
    x, w = {1: ([0.0], [2.0]),
            2: ([-np.sqrt(1 / 3), np.sqrt(1 / 3)], [1.0, 1.0]),
            3: ([-np.sqrt(0.6), 0.0, np.sqrt(0.6)], [5 / 9, 8 / 9, 5 / 9])}[n1]
    pts = np.array([(x[i], x[j], x[k]) for k in range(n1) for j in range(n1) for i in range(n1)])
    wts = np.array([w[i] * w[j] * w[k] for k in range(n1) for j in range(n1) for i in range(n1)])
    return pts, wts


def shape_hex(points: np.ndarray, nen: int) -> tuple[np.ndarray, np.ndarray]:
    """(S (NP, nen), dS (NP, nen, 3)) of the 27-node (quadratic) or 8-node
    (trilinear) hexahedron at local points."""
    if nen == 27:
        nodes = _LOCAL27
        lag = lambda t: (np.stack([0.5 * (t * t - t), 1 - t * t, 0.5 * (t * t + t)], -1),
                         np.stack([t - 0.5, -2 * t, t + 0.5], -1))
        pos = (nodes + 1).astype(np.int64)
    else:
        nodes = _LOCAL27[:8]
        lag = lambda t: (np.stack([0.5 * (1 - t), 0.5 * (1 + t)], -1),
                         np.stack([np.full_like(t, -0.5), np.full_like(t, 0.5)], -1))
        pos = ((nodes + 1) // 2).astype(np.int64)
    vals, ders = zip(*(lag(points[:, a]) for a in range(3)))
    f = [vals[a][:, pos[:, a]] for a in range(3)]
    g = [ders[a][:, pos[:, a]] for a in range(3)]
    s = f[0] * f[1] * f[2]
    ds = np.stack([g[0] * f[1] * f[2], f[0] * g[1] * f[2], f[0] * f[1] * g[2]], -1)
    return s, ds


class Elements:
    """The element tables of a 27-node mesh on ``device`` in ``dtype``:
    ``sv (K, 27)``, ``sp (K, 8)``, ``gdsv (E, K, 27, 3)``, ``gq (E, K)`` (|J| w),
    with ``ltog (E, 27)`` and ``ltog_p (E, 8)``."""

    def __init__(self, ltog: np.ndarray, xyz: np.ndarray, ngp: int, nn: int, nnp: int,
                 device, dtype=torch.float64):
        self.nn, self.nnp, self.device, self.dtype = nn, nnp, device, dtype
        pts, wts = gauss_hex(ngp)
        sv, dsv = shape_hex(pts, 27)
        sp, dsp = shape_hex(pts, 8)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        self.ltog = torch.as_tensor(ltog, device=device)
        self.ltog_p = self.ltog[:, :8].contiguous()
        corner = t(xyz)[self.ltog_p]                                   # (E, 8, 3)
        jac = torch.einsum("kmi,emj->ekij", t(dsp), corner)
        inv = torch.linalg.inv(jac)
        gq = torch.linalg.det(jac) * t(wts)[None]
        self.sv, self.sp = t(sv).to(dtype), t(sp).to(dtype)
        self.gdsv = torch.einsum("ekim,knm->ekni", inv, t(dsv)).to(dtype)
        self.gq = gq.to(dtype)

    # ---------------------------------------------------------- elemental
    def mass(self) -> torch.Tensor:
        """Me (E, 27, 27)."""
        return torch.einsum("ki,kj,ek->eij", self.sv, self.sv, self.gq)

    def stiffness(self, nu: float) -> torch.Tensor:
        """Ke (E, 27, 27) = nu int grad Sv_i . grad Sv_j."""
        return nu * torch.einsum("ekid,ekjd,ek->eij", self.gdsv, self.gdsv, self.gq)

    def gradient(self, rho: float) -> torch.Tensor:
        """Ge (3, E, 27, 8) = -1/rho int Sp_j dSv_i/dx_d."""
        return (-1.0 / rho) * torch.einsum("kj,ekid,ek->deij", self.sp, self.gdsv, self.gq)

    # ------------------------------------------------------------ applies
    def scatter(self, ye: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
        """Sum element values ``ye (E, m, ...)`` onto ``n`` global rows."""
        out = ye.new_zeros((n,) + tuple(ye.shape[2:]))
        return out.index_add_(0, rows.reshape(-1), ye.reshape((-1,) + tuple(ye.shape[2:])))

    def lumped(self, me: torch.Tensor) -> torch.Tensor:
        """(NN,): the row sums of the assembled element matrices."""
        return self.scatter(me.sum(-1), self.ltog, self.nn)

    # ------------------------------------------------------------- sparse
    def csr(self, vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            shape: tuple[int, int]) -> torch.Tensor:
        """The sparse CSR sum of element blocks ``vals (E, a, b)`` at global
        ``rows (E, a)`` x ``cols (E, b)``."""
        a, b = vals.shape[1], vals.shape[2]
        r = rows[:, :, None].expand(-1, a, b).reshape(-1)
        c = cols[:, None, :].expand(-1, a, b).reshape(-1)
        coo = torch.sparse_coo_tensor(torch.stack([r, c]), vals.reshape(-1), shape)
        return coo.coalesce().to_sparse_csr()
