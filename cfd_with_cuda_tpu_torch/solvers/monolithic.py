"""Monolithic coupled (u,v,w,p) solvers: GLS Navier-Stokes and steady Stokes.

Port of ``cfd_with_cuda_tpu/solvers/monolithic.py``.  Legacy-capability rebuilds of ``oldFiles/navierStokes3D.cpp`` (Picard
iteration with GLS stabilization) and ``oldFiles/Stokes3D.cpp`` (one
coupled solve), for equal-order 8-node hexes on the legacy node-BC deck
dialect.  The unknown vector is [u(NN), v(NN), w(NN), p(NN)].

Elemental blocks (Picard branch, ``navierStokes3D.cpp:1249-1412``; before
the |J| w factor):

* A_dd   = nu (grad Si . grad Sj + dSi/dd dSj/dd) + rho Si (u0 . grad Sj)
           + tau rho^2 (u0 . grad Si)(u0 . grad Sj)
* A_xy   = nu dSi/dy dSj/dx   (and cyclic); lower blocks are transposes
           (:1512-1597)
* B_d    = -dSi/dd Sp_j + tau rho (u0 . grad Si) dSp_j/dd
* C_d    = (B_d Galerkin part)^T - tau rho (u0 . grad Sj) dSp_i/dd
* D      = -tau grad Sp_i . grad Sp_j
* tau    = (1/12) h_e^2 / nu, h_e = max body diagonal (``calcElemSize``
           :331-431)

Stokes (``Stokes3D.cpp`` calcGlobalSys): same viscous/pressure blocks with
u0 = 0, no momentum GLS, and D applied with tau = (2/12)/nu *twice* (the
reference repeats the subtraction line — reproduced for parity).

Assembly runs on host numpy / scipy (the reference assembles on the host
too); the coupled system goes through ``ops.linsolve.solve_csr`` on the
solver's device, with its per-pattern cache (GMRES by default, mirroring
CUSP ``krylov::gmres`` restart=100, ``oldFiles/CUSPsolver.cu:69``).
Dirichlet BCs: row zeroing with unit diagonal, RHS = value (node-based BC
tables of the legacy dialect; ``applyBC`` :1751-1835).
"""

from __future__ import annotations


import numpy as np
import scipy.sparse as sp

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu_torch.io.deck import Deck
from cfd_with_cuda_tpu_torch.mesh.profiles import apply_node_bc_profile
from cfd_with_cuda_tpu_torch.ops.linsolve import solve_csr

__all__ = ["GLSNavierStokesSolver", "StokesSolver", "element_sizes"]


def element_sizes(coords: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """h_e = max body-diagonal length (calcElemSize, navierStokes3D:331-431)."""
    pts = coords[conn[:, :8]]              # (NE, 8, 3)
    pairs = [(0, 6), (1, 7), (2, 4), (3, 5)]
    d = np.stack(
        [np.linalg.norm(pts[:, a] - pts[:, b], axis=1) for a, b in pairs]
    )
    return d.max(axis=0)


class _MonolithicBase:
    """Setup once from a deck (host tables, the u0-independent elemental
    blocks, the assembly pattern).  ``device=None`` is the CUDA card
    (raises without one); ``"cpu"`` runs the solves on the CPU."""

    def __init__(self, deck: Deck, *, solver: str = "gmres",
                 solver_tol: float | None = None,
                 solver_maxiter: int | None = None,
                 gmres_restart: int = 100, device=None):
        if deck.nenv != deck.nenp:
            raise ValueError("monolithic solvers support equal-order elements")
        self.deck = deck
        self.device = resolve_device(device)
        self.solver_name = solver
        self.solver_tol = solver_tol if solver_tol is not None else (
            deck.solver_tol if deck.solver_tol is not None else 1e-10
        )
        self.solver_maxiter = solver_maxiter if solver_maxiter is not None else (
            deck.solver_iter_max if deck.solver_iter_max is not None else 1000
        )
        self.gmres_restart = gmres_restart
        self._setup()

    def _setup(self):
        deck = self.deck
        self.nn = deck.nn or deck.ncn
        nn = self.nn
        self.ndof = 4 * nn
        tab = build_element_tables(
            deck.coords, deck.conn, etype=1, nenv=deck.nenv,
            nenp=deck.nenp, ngp=deck.ngp,
        )
        self.tab = tab
        self.h_e = element_sizes(deck.coords, deck.conn)
        # velocity BC nodes (legacy node-based tables)
        vn = deck.bc_vel_nodes
        self.vel_nodes = vn[:, 0] if len(vn) else np.empty(0, np.int64)
        self.vel_vals = (
            deck.bc_str[vn[:, 1], :3] if len(vn) else np.empty((0, 3))
        )
        if len(vn):
            self.vel_vals = apply_node_bc_profile(
                deck, deck.coords, vn, self.vel_vals
            )
        pn = deck.bc_pres_nodes
        self.pres_nodes = pn[:, 0] if len(pn) else np.empty(0, np.int64)
        # the legacy deck's pressure BC value is BCstr[...,0] (usually 0)
        self.pres_vals = (
            deck.bc_str[pn[:, 1], 0] if len(pn) else np.empty(0)
        )

        # ---- u0-independent elemental blocks, built once (the Picard loop
        # re-assembles per iteration; only convection and the tau-weighted
        # advective GLS terms depend on u0)
        nu = deck.viscosity
        g = tab.gDSv                                  # (NE, NGP, nen, 3)
        S = tab.Sp                                    # (NGP, nen)
        w = tab.gq_factor                             # (NE, NGP)
        tau = self._tau()                             # (NE, NGP) constant
        lap = np.einsum("ekid,ekjd,ek->eij", g, g, w, optimize=True)
        self._visc_diag = [
            nu * (lap + np.einsum("eki,ekj,ek->eij", g[..., d], g[..., d],
                                  w, optimize=True))
            for d in range(3)
        ]
        self._visc_off = {}
        for d1 in range(3):
            for d2 in range(d1 + 1, 3):
                self._visc_off[(d1, d2)] = nu * np.einsum(
                    "eki,ekj,ek->eij", g[..., d2], g[..., d1], w,
                    optimize=True,
                )
        self._galerkin = [
            -np.einsum("eki,kj,ek->eij", g[..., d], S, w, optimize=True)
            for d in range(3)
        ]
        self._D = -self._d_scale() * np.einsum(
            "ek,ekid,ekjd,ek->eij", tau, g, g, w, optimize=True
        )
        # assembly index pattern: identical for every Picard iteration
        # (13 blocks in the fixed add() order below)
        conn = deck.conn
        ne, nen = conn.shape
        r0 = np.repeat(conn, nen, axis=1).ravel()
        c0 = np.tile(conn, (1, nen)).ravel()
        rows, cols = [], []
        for d1 in range(3):
            for d2 in range(3):
                rows.append(r0 + d1 * nn)
                cols.append(c0 + d2 * nn)
            rows.append(r0 + d1 * nn)
            cols.append(c0 + 3 * nn)
            rows.append(r0 + 3 * nn)
            cols.append(c0 + d1 * nn)
        rows.append(r0 + 3 * nn)
        cols.append(c0 + 3 * nn)
        self._asm_rows = np.concatenate(rows)
        self._asm_cols = np.concatenate(cols)

    # -------------------------------------------------------------- assembly
    def _blocks(self, u0: np.ndarray):
        """All elemental blocks as (NE, nen, nen) arrays, GQ-summed.

        Only convection and the tau-weighted advective GLS terms depend
        on u0; everything else comes from the ``_setup`` cache."""
        tab = self.tab
        deck = self.deck
        rho = deck.density
        g = tab.gDSv                                  # (NE, NGP, nen, 3)
        S = tab.Sp                                    # (NGP, nen)
        w = tab.gq_factor                             # (NE, NGP)
        tau = self._tau()                             # (NE, NGP)

        u0e = u0[deck.conn]                           # (NE, nen, 3)
        u0g = np.einsum("ki,eid->ekd", S, u0e)        # u0 at GQ
        adv = np.einsum("ekd,ekjd->ekj", u0g, g)      # (u0 . grad Sj)

        conv = np.einsum("ki,ekj,ek->eij", S, adv, w, optimize=True)
        gls_ss = np.einsum("ek,eki,ekj,ek->eij", tau, adv, adv, w,
                           optimize=True) * rho**2

        A = {}
        for d in range(3):
            A[(d, d)] = self._visc_diag[d] + rho * conv + gls_ss
        for (d1, d2), blk in self._visc_off.items():  # d1 < d2
            A[(d1, d2)] = blk
            A[(d2, d1)] = np.swapaxes(blk, 1, 2)

        B = []
        C = []
        for d in range(3):
            galerkin = self._galerkin[d]
            adv_g = rho * np.einsum(
                "ek,eki,ekj,ek->eij", tau, adv, g[..., d], w, optimize=True
            )
            B.append(galerkin + adv_g)
            C.append(np.swapaxes(galerkin, 1, 2) - np.swapaxes(adv_g, 1, 2))
        return A, B, C, self._D

    def _tau(self):
        """Constant (NE, NGP) stabilization parameter."""
        raise NotImplementedError

    def _d_scale(self) -> float:
        return 1.0

    def assemble(self, u0: np.ndarray) -> tuple[sp.csr_matrix, np.ndarray]:
        """Monolithic K (4NN x 4NN) with Dirichlet rows applied; RHS F."""
        nn = self.nn
        A, B, C, D = self._blocks(u0)

        # same fixed block order as the _setup index pattern
        vals = []
        for d1 in range(3):
            for d2 in range(3):
                vals.append(A[(d1, d2)].reshape(-1))
            vals.append(B[d1].reshape(-1))
            vals.append(C[d1].reshape(-1))
        vals.append(D.reshape(-1))

        K = sp.csr_matrix(
            (np.concatenate(vals), (self._asm_rows, self._asm_cols)),
            shape=(self.ndof, self.ndof),
        )
        K.sum_duplicates()

        F = np.zeros(self.ndof)
        # Dirichlet rows: zero + unit diagonal, RHS = value (applyBC)
        bc_rows = np.concatenate(
            [self.vel_nodes + d * nn for d in range(3)]
            + [self.pres_nodes + 3 * nn]
        ).astype(np.int64)
        bc_vals = np.concatenate(
            [self.vel_vals[:, d] for d in range(3)] + [self.pres_vals]
        )
        keep = np.ones(self.ndof)
        keep[bc_rows] = 0.0
        K = (sp.diags(keep) @ K + sp.diags(1.0 - keep)).tocsr()
        K.sort_indices()
        F[bc_rows] = bc_vals
        return K, F

    # ---------------------------------------------------------------- solve
    def _solve_linear(self, K: sp.csr_matrix, F: np.ndarray) -> tuple[np.ndarray, int]:
        if not hasattr(self, "_lin_cache"):
            self._lin_cache = {}    # Picard re-solves on one pattern
        return solve_csr(
            K, F, self.solver_name, tol=self.solver_tol,
            maxiter=self.solver_maxiter, gmres_restart=self.gmres_restart,
            cache=self._lin_cache, device=self.device,
        )

    def fields(self, x: np.ndarray):
        nn = self.nn
        u = np.stack([x[:nn], x[nn:2 * nn], x[2 * nn:3 * nn]], axis=1)
        return u, x[3 * nn:]


class GLSNavierStokesSolver(_MonolithicBase):
    """Monolithic GLS NS with Picard iterations (``solve`` :1838-1983)."""

    def _tau(self):
        # tau = (1/12) h^2 / nu  (:1361)
        tau = (self.h_e**2 / (12.0 * self.deck.viscosity))
        return np.broadcast_to(tau[:, None], self.tab.gq_factor.shape)

    def solve(self, *, max_picard: int | None = None, tol: float | None = None,
              verbose: bool = False):
        deck = self.deck
        if max_picard is None:
            max_picard = deck.max_iter if deck.max_iter is not None else 20
        if tol is None:
            tol = deck.tolerance if deck.tolerance is not None else 1e-6
        x = np.zeros(self.ndof)
        # initial guess honours the BC values
        nn = self.nn
        for d in range(3):
            x[self.vel_nodes + d * nn] = self.vel_vals[:, d]
        history = []
        for it in range(1, max_picard + 1):
            u0, _ = self.fields(x)
            K, F = self.assemble(u0)
            x_new, lin_iters = self._solve_linear(K, F)
            max_change = np.abs(x_new - x).max()
            history.append({"iter": it, "max_change": float(max_change),
                            "lin_iters": lin_iters})
            if verbose:
                print(f"picard {it:3d}  maxChange={max_change:.3e} "
                      f"lin_iters={lin_iters}")
            x = x_new
            if max_change < tol:
                break
        u, p = self.fields(x)
        return u, p, history


class StokesSolver(_MonolithicBase):
    """Steady Stokes: one coupled solve, no convection (``Stokes3D.cpp``).

    ``tau_mode``:
    * ``"reference"`` — the reference's pressure stabilization verbatim:
      tau = (2/12)/nu applied twice (``Stokes3D.cpp`` repeats the
      Ke_44 subtraction).  NOTE this has no h^2 scaling and overwhelms
      the physics on unit-size domains at nu >= O(0.1) (no recirculation
      on the coarse cavity) — kept for parity.
    * ``"gls_h"`` (default) — the proper GLS scaling tau = h^2/(12 nu)
      (what the NS solver uses, ``navierStokes3D.cpp:1361``).
    """

    def __init__(self, deck: Deck, *, tau_mode: str = "gls_h", **kw):
        self.tau_mode = tau_mode
        super().__init__(deck, **kw)

    def _tau(self):
        if self.tau_mode == "reference":
            tau = np.full(
                self.h_e.shape, 2.0 * (2.0 / 12.0) / self.deck.viscosity
            )
        elif self.tau_mode == "gls_h":
            tau = self.h_e**2 / (12.0 * self.deck.viscosity)
        else:
            raise ValueError(f"unknown tau_mode {self.tau_mode!r}")
        return np.broadcast_to(tau[:, None], self.tab.gq_factor.shape)

    def solve(self):
        x0 = np.zeros((self.nn, 3))
        K, F = self.assemble(x0)
        x, lin_iters = self._solve_linear(K, F)
        u, p = self.fields(x)
        return u, p, lin_iters
