"""Pressure-gradient blocks G.p and G^T.u in slot-major ELL form (the
implicit solver's ELL step).

Port of ``cfd_with_cuda_tpu/ops/gradient.py``: one G sparsity pattern with
three value arrays (G1/G2/G3, ``blascoCodinaHuerta.cpp:222-229``) sharing
one column gather, and G^T in its own slot-major ELL, so both directions
are gathers.  Layouts: ``g_vals (3, L, NN)`` with ``g_cols (L, NN)``;
``gt_vals (3, L, NNp)`` with ``gt_cols (L, NNp)``; ``p (NNp,)``,
``u (3, NN)``.  Plain torch ops (XLA ops in the JAX package).
"""

from __future__ import annotations

import torch

__all__ = ["grad_apply", "div_apply"]


def grad_apply(g_vals: torch.Tensor, g_cols: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(3, NN) <- [G1.p, G2.p, G3.p]."""
    gathered = p[g_cols]                       # (L, NN)
    return torch.stack([(g_vals[d] * gathered).sum(dim=0) for d in range(g_vals.shape[0])])


def div_apply(gt_vals: torch.Tensor, gt_cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(NNp,) <- G1^T.u_x + G2^T.u_y + G3^T.u_z."""
    out = 0.0
    for d in range(u.shape[0]):
        out = out + (gt_vals[d] * u[d][gt_cols]).sum(dim=0)
    return out
