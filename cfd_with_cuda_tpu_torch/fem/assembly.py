"""Operator assembly: M (lumped), K, G1-3, Z — batched einsum + scatter.

Host (numpy/scipy) port of ``cfd_with_cuda_tpu/fem/assembly.py``, the
reference's L4 assembly layer.  Elemental
matrices are formed for *all* elements at once as batched einsums over
(NE, NGP, NENv, NENv) — exactly the integrals of ``step0()``
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:3190-3229``):

* ``Me[i,j]   =  sum_k Sv[k,i] Sv[k,j] |J| w``                 (:3195)
* ``Ke[i,j]   =  nu sum_k grad Sv_i . grad Sv_j |J| w``         (:3197-3199)
* ``Ge_d[i,j] = -1/rho sum_k Sp[k,j] dSv_i/dx_d |J| w``         (:3205-3207)

and scattered into CSR value arrays through the precomputed scatter maps
(no mesh coloring; deterministic ``bincount``).

Two independent pressure-Poisson operators exist in the reference and both
are provided:

* explicit solver:  ``Z = G^T Md^{-1} G``   (CSparse product, :3385-3451)
* implicit solver:  ``Z = -int grad Sp . grad Sp``  (direct FEM assembly,
  ``guermondQuartapelle.cpp:3604-3623``)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from cfd_with_cuda_tpu_torch.fem.jacobian import ElementTables
from cfd_with_cuda_tpu_torch.fem.sparse import CsrPattern, build_csr_pattern

__all__ = [
    "elemental_mass",
    "elemental_stiffness",
    "elemental_gradient",
    "elemental_pressure_laplacian",
    "AssembledOperators",
    "assemble_operators",
]


def elemental_mass(tab: ElementTables) -> np.ndarray:
    """Me (NE, NENv, NENv)."""
    return np.einsum("ki,kj,ek->eij", tab.Sv, tab.Sv, tab.gq_factor, optimize=True)


def elemental_stiffness(tab: ElementTables, viscosity: float) -> np.ndarray:
    """Ke (NE, NENv, NENv) — viscous diffusion."""
    return viscosity * np.einsum(
        "ekid,ekjd,ek->eij", tab.gDSv, tab.gDSv, tab.gq_factor, optimize=True
    )


def elemental_gradient(tab: ElementTables, density: float) -> np.ndarray:
    """Ge (3, NE, NENv, NENp) — the three pressure-gradient blocks."""
    return (-1.0 / density) * np.einsum(
        "kj,ekid,ek->deij", tab.Sp, tab.gDSv, tab.gq_factor, optimize=True
    )


def elemental_pressure_laplacian(tab: ElementTables) -> np.ndarray:
    """Ze (NE, NENp, NENp) = -int grad Sp_i . grad Sp_j (implicit-solver
    sign convention, guermondQuartapelle.cpp:3609-3611)."""
    return -np.einsum(
        "ekid,ekjd,ek->eij", tab.gDSp, tab.gDSp, tab.gq_factor, optimize=True
    )


@dataclass
class AssembledOperators:
    """Host-side (numpy/scipy) assembled constant operators."""

    pattern_m: CsrPattern          # NN x NN velocity-block pattern (M/K/A)
    pattern_g: CsrPattern          # NN x NNp gradient pattern
    K: np.ndarray                  # CSR values on pattern_m
    G: np.ndarray                  # (3, nnzG) CSR values on pattern_g
    Md: np.ndarray                 # (NN,) lumped mass (no BCs)
    Z: sp.csr_matrix               # pressure-Poisson operator (NNp x NNp)
    M: np.ndarray | None = None    # consistent-mass CSR values (implicit: M/dt)

    def K_csr(self) -> sp.csr_matrix:
        return self.pattern_m.to_scipy(self.K)

    def G_csr(self, d: int) -> sp.csr_matrix:
        return self.pattern_g.to_scipy(self.G[d])


def assemble_operators(
    tab: ElementTables,
    ltog_node: np.ndarray,
    nn: int,
    nnp: int,
    *,
    viscosity: float,
    density: float,
    z_mode: str = "product",
    mass_scale: float = 1.0,
    keep_consistent_mass: bool = False,
) -> AssembledOperators:
    """Assemble the constant operators once (the reference's ``step0``).

    ``z_mode``: "product" -> Z = G^T Md^{-1} G (explicit solver);
    "direct" -> Z = -int grad Sp . grad Sp (implicit solver).
    ``mass_scale``: multiply the consistent mass values (implicit uses 1/dt).
    """
    ltog_p = ltog_node[:, : tab.Sp.shape[1]]

    pat_m = build_csr_pattern(ltog_node, ltog_node, nn, nn)
    pat_g = build_csr_pattern(ltog_node, ltog_p, nn, nnp)

    Me = elemental_mass(tab)
    Ke = elemental_stiffness(tab, viscosity)
    Ge = elemental_gradient(tab, density)

    Mv = pat_m.assemble(Me) * mass_scale
    Kv = pat_m.assemble(Ke)
    Gv = np.stack([pat_g.assemble(Ge[d]) for d in range(3)])

    # Row-sum mass lumping (the reference sums all NNZ of each row,
    # blascoCodinaHuerta.cpp:3263-3266).
    row_ids = np.repeat(np.arange(nn), np.diff(pat_m.indptr))
    Md = np.bincount(row_ids, weights=pat_m.assemble(Me), minlength=nn)

    if z_mode == "product":
        Gs = [pat_g.to_scipy(Gv[d]) for d in range(3)]
        Dinv = sp.diags(1.0 / Md)
        Z = (Gs[0].T @ (Dinv @ Gs[0])
             + Gs[1].T @ (Dinv @ Gs[1])
             + Gs[2].T @ (Dinv @ Gs[2])).tocsr()
        Z.sort_indices()
    elif z_mode == "direct":
        pat_z = build_csr_pattern(ltog_p, ltog_p, nnp, nnp)
        Ze = elemental_pressure_laplacian(tab)
        Z = pat_z.to_scipy(pat_z.assemble(Ze))
        Z.sort_indices()
    else:
        raise ValueError(f"unknown z_mode {z_mode!r}")

    return AssembledOperators(
        pattern_m=pat_m,
        pattern_g=pat_g,
        K=Kv,
        G=Gv,
        Md=Md,
        Z=Z,
        M=Mv if keep_consistent_mass else None,
    )
