"""Segregated SIMPLE-like solver (Horoutunian scheme).

Port of ``cfd_with_cuda_tpu/solvers/segregated.py``.  Legacy-capability rebuild of ``oldFiles/segregatedSolver/segregatedSolver.cpp``
(equal-order 8/8 hexes, node-BC legacy decks, steady).  Per outer
iteration (``solve()`` :2195-2509):

* STEP 1 — SCPE pressure correction (:2224-2280):
  LHS = sum_d C_d^T diag(K_d)^{-1} C_d,  RHS = -(Cx^T u + Cy^T v + Cz^T w)
  solved by CG/CR (the reference builds the triple product with CUSP SpMM
  on the GPU, ``CUSP_pC_CUDA_CG.cu:41-397``; here scipy at each outer
  iteration, solved by ``ops.linsolve.solve_csr`` on the device).
* STEP 2 — mass adjustment (:2284-2322): u += diag(K_u)^{-1} C_x dp (and
  cyclic), p += (1 - alpha4) dp, velocity BCs re-imposed.
* STEP 3 — relaxed momentum solves (:2326-2431), sequential phases x,y,z:
  [K_d + alpha/(1-alpha) diag(K_d)] u_d = C_d p - K_coupling u_other
  + alpha/(1-alpha) diag(K_d) u_d, Dirichlet rows, GMRES/BiCG.

Operators (equal-order, ``calcGlobalSys_p`` :1580-1689, ``calcFixedK``
:1263-1330, ``calcPressureGradientOp`` :1422-1490):

* K_d   = nu (factor_d-weighted grad-grad) + rho S_i (u0 . grad S_j),
          factor 2 on the phase direction (stress-divergence diagonal)
* K_d1d2 = nu dS_i/d2 dS_j/d1  (fixed viscous coupling blocks)
* C_d   = int dS_i/dd Sp_j     (pressure gradient; positive, unscaled)

Relaxation factors alpha[0..3] come from the deck (``relaxation`` row).

The outer loop, the SCPE map, the coupling terms and the monitor rows stay
in numpy / scipy on the host; the momentum (GMRES) and pressure (CG) solves
go through ``solve_csr`` with its per-pattern cache.
"""

from __future__ import annotations


import numpy as np
import scipy.sparse as sp

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu_torch.fem.sparse import build_csr_pattern
from cfd_with_cuda_tpu_torch.io.deck import Deck
from cfd_with_cuda_tpu_torch.mesh.profiles import apply_node_bc_profile
from cfd_with_cuda_tpu_torch.mesh.topology import find_monitor_node
from cfd_with_cuda_tpu_torch.ops.linsolve import solve_csr

__all__ = ["SegregatedSolver"]


class SegregatedSolver:
    """Setup once from a deck (host operators, the SCPE map), then
    :meth:`solve`.  ``device=None`` is the CUDA card (raises without one);
    ``"cpu"`` runs the solves on the CPU."""

    def __init__(self, deck: Deck, *,
                 pressure_solver: str = "cg",
                 momentum_solver: str = "gmres",
                 solver_tol: float | None = None,
                 solver_maxiter: int | None = None,
                 gmres_restart: int = 100, device=None):
        if deck.nenv != deck.nenp:
            raise ValueError("the segregated solver is equal-order (8/8)")
        self.deck = deck
        self.device = resolve_device(device)
        self.pressure_solver = pressure_solver
        self.momentum_solver = momentum_solver
        self.solver_tol = solver_tol if solver_tol is not None else (
            deck.solver_tol or 1e-10
        )
        self.solver_maxiter = solver_maxiter if solver_maxiter is not None else min(
            deck.solver_iter_max or 1000, 5000
        )
        self.gmres_restart = gmres_restart
        self.alpha = np.asarray(deck.relaxation or (0.5, 0.5, 0.5, 0.5))
        # the diagonal boost a/(1-a) (ref :1801-1802) needs a in (0, 1):
        # a=1 would poison the momentum matrix with inf
        if not (np.all(self.alpha[:3] > 0) and np.all(self.alpha[:3] < 1)):
            raise ValueError(
                f"momentum relaxation factors must be in (0, 1), got "
                f"{self.alpha[:3]}"
            )
        self._setup()

    # ------------------------------------------------------------------ setup
    def _setup(self):
        deck = self.deck
        self.nn = deck.nn or deck.ncn
        tab = build_element_tables(
            deck.coords, deck.conn, etype=1, nenv=deck.nenv,
            nenp=deck.nenp, ngp=deck.ngp,
        )
        self.tab = tab
        self.pat = build_csr_pattern(deck.conn, deck.conn, self.nn, self.nn)

        g = tab.gDSv
        S = tab.Sp
        w = tab.gq_factor
        nu = deck.viscosity

        # fixed operators: C_d and viscous coupling blocks (sign/scale per ref)
        ce = [np.einsum("eki,kj,ek->eij", g[..., d], S, w, optimize=True)
              for d in range(3)]
        self.C = [self.pat.to_scipy(self.pat.assemble(c)) for c in ce]
        self.CT = [c.T.tocsr() for c in self.C]

        def coupling(da, db):
            # K_uv = nu dS_i/dy dS_j/dx for (u-eq, v-col) etc (:1296-1298)
            return self.pat.to_scipy(self.pat.assemble(
                nu * np.einsum("eki,ekj,ek->eij", g[..., db], g[..., da], w,
                               optimize=True)
            ))

        self.K_uv, self.K_uw = coupling(1, 0), coupling(2, 0)
        self.K_vu, self.K_vw = self.K_uv.T.tocsr(), coupling(2, 1)
        self.K_wu, self.K_wv = self.K_uw.T.tocsr(), self.K_vw.T.tocsr()
        self.coupling = {
            0: [(self.K_uv, 1), (self.K_uw, 2)],
            1: [(self.K_vu, 0), (self.K_vw, 2)],
            2: [(self.K_wu, 0), (self.K_wv, 1)],
        }

        vn = deck.bc_vel_nodes
        self.vel_nodes = vn[:, 0] if len(vn) else np.empty(0, np.int64)
        self.vel_vals = deck.bc_str[vn[:, 1], :3] if len(vn) else np.empty((0, 3))
        if len(vn):
            self.vel_vals = apply_node_bc_profile(
                deck, deck.coords, vn, self.vel_vals
            )
        pn = deck.bc_pres_nodes
        self.pres_nodes = pn[:, 0] if len(pn) else np.empty(0, np.int64)
        self.pres_vals = deck.bc_str[pn[:, 1], 0] if len(pn) else np.empty(0)
        # nodes where delta_p is pinned to zero in the SCPE solve: the
        # pressure-BC list, or — for a deck with none (closed cavity in
        # the fractional-step dialect) — the zero-pressure node, without
        # which the all-Neumann SCPE matrix is singular
        if len(self.pres_nodes):
            self._dp_pin = self.pres_nodes
        elif deck.zero_pressure_node >= 0:
            self._dp_pin = np.asarray([deck.zero_pressure_node])
        else:
            self._dp_pin = np.empty(0, np.int64)

        # viscous+convective grad-grad factors per phase (:1703-1719)
        self._lapw = [
            np.einsum("eki,ekj,ek->eij", g[..., d], g[..., d], w, optimize=True)
            for d in range(3)
        ]
        self._conn = deck.conn
        self._setup_scpe_map()

        # monitor-point LIST: the legacy dialect carries several probe
        # coordinates and the reference prints every one per outer
        # iteration (``segregatedSolver.cpp:2463-2480``); fall back to
        # the single monitor of the fractional-step dialects
        pts = deck.monitor_points
        if pts is None and deck.monitor_xyz is not None:
            pts = np.asarray(deck.monitor_xyz)[None, :]
        self.monitor_nodes = (
            np.asarray([find_monitor_node(deck.coords, xyz) for xyz in pts])
            if pts is not None else np.empty(0, np.int64)
        )

    def _setup_scpe_map(self):
        """Precompute the SCPE LHS as a LINEAR map of the inverse
        momentum diagonals.

        ``(C_d^T diag(kinv_d) C_d)[i, j] = sum_k C_d[k,i] kinv_d[k] C_d[k,j]``
        is linear in ``kinv``, so the whole triple product collapses to
        ONE fixed sparse matrix ``P (nnz_lhs, 3 nn)`` built once at
        setup: per outer iteration the LHS values are ``P @ kinv_cat``
        — one SpMV instead of the reference's per-iteration SpMM chain
        (it rebuilt C^T K^-1 C with CUSP SpMM on the GPU every outer
        iteration, ``CUSP_pC_CUDA_CG.cu:41-397``).

        The pressure-pin row/col elimination is folded in value space
        on the SAME fixed pattern (slot masks + unit pin diagonal), so
        the Krylov backend's ELL pattern cache holds across iterations
        too.
        """
        nn = self.nn
        pat = sum(
            (abs(self.CT[d]) @ abs(self.C[d])).tocsr() for d in range(3)
        )
        pat.sort_indices()
        pat.sum_duplicates()
        self._scpe_indptr = pat.indptr.copy()
        self._scpe_indices = pat.indices.copy()
        nnz = pat.nnz

        # global sorted key per pattern slot (rows ascending, cols sorted
        # within rows) -> slot lookup for a batch of (i, j) pairs is one
        # vectorized searchsorted
        row_of_slot_p = np.repeat(np.arange(nn), np.diff(self._scpe_indptr))
        pat_keys = row_of_slot_p.astype(np.int64) * nn + self._scpe_indices

        rows_all, cols_all, vals_all = [], [], []
        for d in range(3):
            C = self.C[d].tocsr()
            C.sort_indices()
            i_d, j_d, v_d, k_d = [], [], [], []
            for k in range(nn):
                lo, hi = C.indptr[k], C.indptr[k + 1]
                m = hi - lo
                if m == 0:
                    continue
                idx = C.indices[lo:hi].astype(np.int64)
                val = C.data[lo:hi]
                i_d.append(np.repeat(idx, m))       # row of LHS entry
                j_d.append(np.tile(idx, m))         # col of LHS entry
                v_d.append(np.repeat(val, m) * np.tile(val, m))
                k_d.append(np.full(m * m, d * nn + k, np.int64))
            i_d = np.concatenate(i_d)
            j_d = np.concatenate(j_d)
            slot = np.searchsorted(pat_keys, i_d * nn + j_d)
            assert np.array_equal(pat_keys[slot], i_d * nn + j_d)
            rows_all.append(slot)
            cols_all.append(np.concatenate(k_d))
            vals_all.append(np.concatenate(v_d))
        self._scpe_P = sp.csr_matrix(
            (
                np.concatenate(vals_all),
                (np.concatenate(rows_all), np.concatenate(cols_all)),
            ),
            shape=(nnz, 3 * nn),
        )
        # pin masks in value space: zero pinned rows+cols, unit diagonal
        keep = np.ones(nn)
        keep[self._dp_pin] = 0.0
        self._scpe_keep = keep[row_of_slot_p] * keep[self._scpe_indices]
        self._scpe_pin_diag = (
            (row_of_slot_p == self._scpe_indices)
            & (keep[row_of_slot_p] == 0.0)
        ).astype(float)

    def _scpe_lhs(self, kinv) -> sp.csr_matrix:
        """SCPE LHS (pin applied) from the three inverse diagonals."""
        vals = self._scpe_P @ np.concatenate(kinv)
        vals = vals * self._scpe_keep + self._scpe_pin_diag
        return sp.csr_matrix(
            (vals, self._scpe_indices, self._scpe_indptr),
            shape=(self.nn, self.nn),
        )

    def _conv_elemental(self, u: np.ndarray, v, w_):
        """rho S (u0 . grad S): phase-independent, so callers build it
        ONCE per velocity state instead of once per phase (the viscous
        part is the only per-phase term)."""
        tab = self.tab
        g = tab.gDSv
        S = tab.Sp
        w = tab.gq_factor
        uvw = np.stack([u, v, w_], axis=1)           # (NN, 3)
        u0e = uvw[self._conn]
        u0g = np.einsum("ki,eid->ekd", S, u0e)
        adv = np.einsum("ekd,ekjd->ekj", u0g, g)
        return self.deck.density * np.einsum(
            "ki,ekj,ek->eij", S, adv, w, optimize=True
        )

    def _momentum_elemental(self, phase: int, conv: np.ndarray):
        """Ke for the phase momentum equation (calcGlobalSys_mom)."""
        factors = np.ones(3)
        factors[phase] = 2.0
        visc = sum(
            factors[d] * self._lapw[d] for d in range(3)
        ) * self.deck.viscosity
        return visc + conv

    # ------------------------------------------------------------------ solve
    def _krylov(self, A: sp.csr_matrix, b: np.ndarray, name: str):
        if not hasattr(self, "_lin_cache"):
            self._lin_cache = {}    # outer iters re-solve on 2 patterns
        return solve_csr(
            A, b, name, tol=self.solver_tol, maxiter=self.solver_maxiter,
            gmres_restart=self.gmres_restart, cache=self._lin_cache,
            device=self.device,
        )

    def solve(self, *, max_outer: int | None = None, tol: float | None = None,
              verbose: bool = False):
        deck = self.deck
        nn = self.nn
        a = self.alpha
        max_outer = max_outer or deck.max_iter or 100
        tol = tol if tol is not None else (deck.tolerance or 1e-6)

        u = np.zeros(nn)
        v = np.zeros(nn)
        w_ = np.zeros(nn)
        p = np.zeros(nn)
        # impose BCs on the initial field (applyBC / applyBC_p)
        u[self.vel_nodes] = self.vel_vals[:, 0]
        v[self.vel_nodes] = self.vel_vals[:, 1]
        w_[self.vel_nodes] = self.vel_vals[:, 2]
        p[self.pres_nodes] = self.pres_vals

        vel = [u, v, w_]
        history = []
        for it in range(1, max_outer + 1):
            # ---- STEP 1: SCPE  (:2224-2280)
            kdiag = []
            conv_e = self._conv_elemental(*vel)
            for ph in range(3):
                ke = self._momentum_elemental(ph, conv_e)
                diag = np.zeros(nn)
                d_ele = np.einsum("eii->ei", ke)
                np.add.at(diag, self._conn.ravel(), d_ele.ravel())
                kdiag.append(diag)
            kinv = [1.0 / d for d in kdiag]

            # SCPE LHS = sum_d C_d^T diag(kinv_d) C_d via the precomputed
            # linear map (one SpMV on a FIXED pattern; pressure pin by
            # SYMMETRIC row/col elimination + unit diagonal folded into
            # the value masks — see _setup_scpe_map; the eliminated
            # columns multiply dp = 0, so no RHS shift)
            lhs = self._scpe_lhs(kinv)
            rhs = -sum(self.CT[d] @ vel[d] for d in range(3))
            if len(self._dp_pin):
                rhs[self._dp_pin] = 0.0
            dp, p_iters = self._krylov(lhs, rhs, self.pressure_solver)

            # ---- STEP 2: mass adjustment  (:2284-2322)
            for ph in range(3):
                vel[ph] += kinv[ph] * (self.C[ph] @ dp)
                vel[ph][self.vel_nodes] = self.vel_vals[:, ph]
            p += (1.0 - a[3]) * dp
            p[self.pres_nodes] = self.pres_vals

            # ---- STEP 3: momentum solves  (:2326-2431)
            new_vel = []
            mom_iters = []
            conv_e = self._conv_elemental(*vel)
            for ph in range(3):
                ke = self._momentum_elemental(ph, conv_e)
                tempdiag = np.zeros(nn)
                d_ele = np.einsum("eii->ei", ke)
                np.add.at(tempdiag, self._conn.ravel(), d_ele.ravel())
                # relax the elemental diagonal (:1801-1802)
                boost = a[ph] / (1.0 - a[ph])
                idx = np.arange(ke.shape[1])
                ke[:, idx, idx] *= (1.0 + boost)
                K = self.pat.to_scipy(self.pat.assemble(ke))

                F = self.C[ph] @ p
                for mat, other in self.coupling[ph]:
                    F -= mat @ vel[other]
                F += boost * tempdiag * vel[ph]

                # Dirichlet rows (applyBC :1893-1946)
                keep = np.ones(nn)
                keep[self.vel_nodes] = 0.0
                K = (sp.diags(keep) @ K + sp.diags(1.0 - keep)).tocsr()
                F[self.vel_nodes] = self.vel_vals[:, ph]

                x, its = self._krylov(K, F, self.momentum_solver)
                new_vel.append(x)
                mom_iters.append(its)
            vel = new_vel

            max_dp = np.abs(dp).max()
            mons = [
                {
                    "node": int(nd),
                    "u": float(vel[0][nd]), "v": float(vel[1][nd]),
                    "w": float(vel[2][nd]), "p": float(p[nd]),
                }
                for nd in self.monitor_nodes
            ]
            history.append({
                "iter": it, "max_dp": float(max_dp), "p_iters": p_iters,
                "mom_iters": mom_iters, "monitors": mons,
            })
            if verbose:
                print(f"outer {it:3d}  max|dp|={max_dp:.3e} "
                      f"p_it={p_iters} mom_it={mom_iters}")
                for m in mons:  # ref monitor table :2463-2480
                    print(
                        f"    node {m['node']:7d}  {m['u']:12.5f}"
                        f" {m['v']:12.5f} {m['w']:12.5f} {m['p']:12.5f}"
                    )
            # the reference only accepts convergence from iteration 2 on —
            # iteration 1's dp is identically zero for a clean start
            # (:2483 "maxChange < nonlinearTol && iter > 1")
            if max_dp < tol and it > 1:
                break

        u_out = np.stack(vel, axis=1)
        return u_out, p, history
