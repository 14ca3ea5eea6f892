"""Scalar Poisson solver (legacy capability of ``oldFiles/poissonSolver/``).

Port of ``cfd_with_cuda_tpu/solvers/poisson.py``.  Solves
-div(a grad u) = f on 8-node hex meshes with essential BCs, mirroring
``poissonSolver.cpp``: Ke = int a grad S . grad S (:947-961), Fe = int S f,
EBC rows eliminated (:1042-1086).  The reference hardwires the manufactured
source f = 12 pi^2 sin(2 pi x) sin(2 pi y) sin(2 pi z) (exact solution
u = sin(2 pi x) sin(2 pi y) sin(2 pi z), :948) — ``source="mms"`` here;
constant ``fxyFunc`` decks are honoured too.

Deliberate divergence, as the JAX package: the reference sets the EBC
diagonal to ``bigNumber = 200`` while putting the raw BC value in F
(:1053, :1083), so a nonzero EBC lands as value/200; here the elimination
is exact (unit diagonal), identical for the zero-valued EBCs of the shipped
decks.

The stiffness matrix and the Dirichlet elimination are built on the host
(numpy / scipy) once; its ELL pack and diagonal go to the device once, and
each :meth:`PoissonSolver.solve` runs a Krylov method of ``ops.krylov`` on
the device in float64 (the runtime analogue of the reference's
``-DCUSP/-DCUSPARSE/-DCULA/-DMKLCG`` compile-time matrix,
``poissonSolver.cpp:68-82``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu_torch.fem.sparse import build_csr_pattern, ell_from_csr
from cfd_with_cuda_tpu_torch.io.deck import Deck
from cfd_with_cuda_tpu_torch.ops.krylov import solver_by_name
from cfd_with_cuda_tpu_torch.ops.spmv import ell_spmv

__all__ = ["PoissonSolver", "mms_source", "mms_solution"]


def mms_solution(coords: np.ndarray) -> np.ndarray:
    x, y, z = coords.T
    return np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y) * np.sin(2 * np.pi * z)


def mms_source(coords: np.ndarray) -> np.ndarray:
    return 12.0 * np.pi**2 * mms_solution(coords)


class PoissonSolver:
    """Setup once from a deck (host assembly, device ELL operator), then
    :meth:`solve`.  ``device=None`` is the CUDA card (raises without one);
    ``"cpu"`` runs on the CPU."""

    deck: Deck

    def __init__(self, deck: Deck, *, solver: str = "cg",
                 tol: float | None = None, maxiter: int | None = None, device=None):
        self.deck = deck
        self.solver_name = solver
        self.device = resolve_device(device)
        self.tol = tol if tol is not None else (
            deck.solver_tol if deck.solver_tol is not None else 1e-10
        )
        self.maxiter = maxiter if maxiter is not None else (
            deck.solver_iter_max if deck.solver_iter_max is not None else 1000
        )
        self._setup()

    def _setup(self):
        deck = self.deck
        nen = deck.nenv
        self.nn = deck.nn or deck.ncn
        tab = build_element_tables(
            deck.coords, deck.conn, etype=1 if deck.etype in (1, 3) else 2,
            nenv=nen, nenp=nen, ngp=deck.ngp,
        )
        self.tab = tab
        pat = build_csr_pattern(deck.conn, deck.conn, self.nn, self.nn)
        a = deck.axy if deck.axy is not None else 1.0
        ke = a * np.einsum(
            "ekid,ekjd,ek->eij", tab.gDSp, tab.gDSp, tab.gq_factor, optimize=True
        )
        K = pat.to_scipy(pat.assemble(ke))

        # essential BC nodes (deck EBC table).  Symmetric elimination: zero
        # the BC rows AND columns with a unit diagonal (the system stays SPD,
        # so CG stays valid for nonzero Dirichlet data); the columns'
        # contribution is lifted into the RHS at solve time
        ebc = deck.bc_vel_nodes
        self.ebc_nodes = ebc[:, 0] if len(ebc) else np.empty(0, dtype=np.int64)
        self.ebc_vals = (
            deck.bc_str[ebc[:, 1], 0] if len(ebc) else np.empty(0)
        )
        K = K.tocsr()
        self.K_orig = K.copy()
        m = np.ones(self.nn)
        m[self.ebc_nodes] = 0.0
        D = sp.diags(m)
        K = (D @ K @ D + sp.diags(1.0 - m)).tocsr()
        K.sort_indices()
        self.K = K
        ell = ell_from_csr(
            K.indptr.astype(np.int64), K.indices.astype(np.int64), K.data,
            n_cols=self.nn,
        )
        dev = self.device
        self._vals = torch.from_numpy(ell.vals).to(dev)
        self._cols = torch.from_numpy(ell.cols.astype(np.int64)).to(dev)
        self._diag = torch.from_numpy(K.diagonal()).to(dev)
        self._solve = solver_by_name(self.solver_name)

    def rhs(self, source="deck") -> np.ndarray:
        """Assemble F = int S f + EBC overwrites (host)."""
        deck = self.deck
        tab = self.tab
        if source == "mms":
            # the manufactured f at the GQ physical coordinates (the
            # reference does exactly this, poissonSolver.cpp:938-948)
            xyz_gq = np.einsum("ki,eid->ekd", tab.Sp, deck.coords[deck.conn])
            f_gq = mms_source(xyz_gq.reshape(-1, 3)).reshape(xyz_gq.shape[:2])
        elif source == "deck":
            f_gq = np.full(tab.gq_factor.shape, deck.fxy or 0.0)
        elif callable(source):
            # flattened to (NE*NGP, 3) like the mms branch, so sources written
            # as f(coords) with coords.T unpacking work unchanged
            xyz_gq = np.einsum("ki,eid->ekd", tab.Sp, deck.coords[deck.conn])
            f_gq = np.asarray(source(xyz_gq.reshape(-1, 3))).reshape(
                xyz_gq.shape[:2]
            )
        else:
            raise ValueError(f"unknown source {source!r}")
        fe = np.einsum("ki,ek,ek->ei", tab.Sp, f_gq, tab.gq_factor)
        F = np.zeros(self.nn)
        np.add.at(F, deck.conn.ravel(), fe.ravel())
        # lift the Dirichlet columns: F_i -= K_ij u_bc_j, then pin the rows
        u_bc = np.zeros(self.nn)
        u_bc[self.ebc_nodes] = self.ebc_vals
        F -= self.K_orig @ u_bc
        F[self.ebc_nodes] = self.ebc_vals
        return F

    def solve(self, source="deck"):
        """Returns (u (NN,) numpy, iterations, residual)."""
        F = torch.from_numpy(self.rhs(source)).to(self.device)
        vals, cols, diag = self._vals, self._cols, self._diag
        res = self._solve(
            lambda x: ell_spmv(vals, cols, x), F, tol=self.tol, maxiter=self.maxiter,
            precond=lambda r: r / diag,
        )
        return res.x.cpu().numpy(), int(res.iters), float(res.residual)
