"""Carry a JAX solver's tables and state across to the port.

The inputs are plain numpy arrays and Python values (what ``np.asarray``
and ``getattr`` give on a ``cfd_with_cuda_tpu`` solver), so this module
imports nothing of the JAX package.  The outputs are CPU tensors; the
port's solvers move them to their device
(``ExplicitBCHSolver.from_tables``, ``ImplicitGQSolver.from_tables``).
"""

from __future__ import annotations

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitState
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitState

__all__ = [
    "tables_from_jax", "state_from_jax",
    "implicit_tables_from_jax", "implicit_state_from_jax",
]

# tables the parity step reads under the same name in both packages
_SHARED = (
    "Kp", "Gp", "GT_cwin", "md_inv_p", "md_orig_inv_p", "bc_mask_p",
    "bc_vel_p", "gDSv_p", "gq_p", "Sv",
)


# tables the implicit parity step reads under the same name in both packages
_SHARED_IMPLICIT = (
    "MKp", "Mp", "Gp", "GT_cwin", "conv_sel", "bc_mask_p", "bc_mask_e",
    "bc_vel_p", "gDSv_p", "gq_p", "Sv", "p_mask",
)


def _carry(d, names, attrs, sym: bool) -> dict[str, torch.Tensor]:
    """The shared tables copied, the fused CG's DMA-block weights
    ``Z_win_cg (nb, KP, s_pad)`` as the plain ``(W^3, NNp)`` window (under
    ``sym`` the stored dq >= 0 half, ``W^3 // 2 + 1`` rows), and
    ``Z_dinv_cg`` cut to its first NNp rows."""
    nnp = int(attrs["nnp"])
    w3 = (2 * int(attrs["z_radius"]) + 1) ** 3
    if sym:
        w3 = w3 // 2 + 1
    s_pad = -(-nnp // 128) * 128
    out = {k: torch.from_numpy(np.array(d[k])) for k in names}
    out["Z_win"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(d["Z_win_cg"]).reshape(-1, s_pad)[:w3, :nnp])
    )
    out["Z_dinv"] = torch.from_numpy(np.array(np.asarray(d["Z_dinv_cg"])[:nnp]))
    return out


def tables_from_jax(d: dict[str, np.ndarray], attrs: dict, *,
                    sym: bool = False) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX explicit parity solver's ``d``.

    ``attrs`` holds the solver's static values (at least ``nnp`` and
    ``z_radius``; the routes ``k_pairs``, ``g_pairs``, ``conv_pairs2``,
    ``conv_groups``, ``conv_i_order`` and the rest of
    ``ExplicitBCHSolver.STATIC_ATTRS`` go to ``from_tables`` unchanged);
    ``sym`` is the JAX solver's ``pressure_cg_sym``.
    """
    return _carry(d, _SHARED, attrs, sym)


def implicit_tables_from_jax(d: dict[str, np.ndarray], attrs: dict, *,
                             sym: bool = False) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX implicit parity solver's ``d``
    (``attrs`` and ``sym`` as :func:`tables_from_jax`, for
    ``ImplicitGQSolver.STATIC_ATTRS``)."""
    return _carry(d, _SHARED_IMPLICIT, attrs, sym)


def state_from_jax(state) -> ExplicitState:
    """An ``ExplicitState`` of CPU tensors from a JAX ``ExplicitState``
    (the same five fields, given as arrays)."""
    return ExplicitState(*(torch.from_numpy(np.array(a)) for a in state))


def implicit_state_from_jax(state) -> ImplicitState:
    """An ``ImplicitState`` of CPU tensors from a JAX ``ImplicitState``
    (the same three fields, given as arrays)."""
    return ImplicitState(*(torch.from_numpy(np.array(a)) for a in state))
