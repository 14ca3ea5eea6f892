"""Sparse operators of the unstructured path: slot-major ELL SpMV and the
matrix-free FEM operators through elemental matrices.

Port of ``cfd_with_cuda_tpu/ops/spmv.py``.  These are XLA ops in the JAX
package and plain torch ops here (gathers, ``bmm``), not kernels.

**Layouts.**  ELL operators stay slot-major ``(L, N)`` and fields ``(3,
NN)``, as in the JAX package.  Element tables are ELEMENT-MAJOR here, so
each elemental apply is one batched matmul with no copy of the table:
``ltog (NE, NEN)``, ``ke (NE, NEN, NEN)``, ``ge (NE, 3, NENv, NENp)``,
``gDSv (NE, 3, NENv, NGP)``, ``gq (NE, NGP)`` (the JAX package keeps the
element axis last for the TPU's lanes; ``interop`` transposes).

**Deterministic scatter.**  Elemental values reach the nodes through a
reverse-incidence table (:func:`build_reverse_incidence`): ``deg`` plain
gathers summed in a fixed order, the order of the JAX package's
``segment_sum`` (ascending position in its ``(NEN, NE)`` flattening), so a
run repeats bit for bit on the card and the CPU sums equal the JAX
package's.  There is no ``index_add_`` (atomics on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ell_spmv",
    "scatter_nodes",
    "build_reverse_incidence",
    "scatter_nodes_rev",
    "elem_matvec_apply",
    "convection_elemental",
    "elem_grad_apply",
    "elem_div_apply",
    "convection_apply",
    "convection_assemble_csr",
]


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in slot-major ELL form: ``vals/cols (L, N)``, ``x
    (M,)`` or ``(C, M)`` -> ``(N,)`` / ``(C, N)`` (one component at a
    time, so the gathered temporary stays ``(L, N)``)."""
    if x.ndim == 1:
        return (vals * x[cols]).sum(dim=0)
    return torch.stack([(vals * x[d][cols]).sum(dim=0) for d in range(x.shape[0])])


def build_reverse_incidence(ltog: np.ndarray, nn: int) -> np.ndarray:
    """Host, setup-time: ``rev (deg, nn)`` int32 for the elemental scatter.

    ``ltog (NE, S)`` maps each elemental slot to its node (a connectivity,
    or the elemental -> CSR-slot map of an assembly with ``nn`` = nnz).
    ``rev[:, n]`` holds the positions of node ``n``'s contributions in the
    element-major flattening ``e * S + s`` of an ``(NE, S)`` value array,
    padded with the sentinel ``NE * S`` (one appended zero), ordered as the
    JAX package's table (ascending ``s * NE + e``), so the sums below take
    its order.  ``deg`` is the largest node incidence."""
    ltog = np.asarray(ltog)
    ne, s = ltog.shape
    ids = ltog.T.reshape(-1)                     # the JAX flattening: s * NE + e
    order = np.argsort(ids, kind="stable")       # ascending node, then position
    counts = np.bincount(ids, minlength=nn)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    node = ids[order]
    rank = np.arange(ids.size) - starts[node]    # rank within its node
    rev = np.full((int(counts.max()), nn), ne * s, dtype=np.int32)
    rev[rank, node] = (order % ne) * s + order // ne
    return rev


def scatter_nodes_rev(elem_vals: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """Elemental values ``(NE, S, *rest)`` summed onto the nodes of the
    table ``rev`` -> ``(nn, *rest)``: ``deg`` gathers in table order."""
    flat = elem_vals.reshape((-1,) + tuple(elem_vals.shape[2:]))
    flatp = torch.cat([flat, flat.new_zeros((1,) + tuple(flat.shape[1:]))])
    acc = flatp[rev[0]]
    for k in range(1, rev.shape[0]):
        acc = acc + flatp[rev[k]]
    return acc


def scatter_nodes(elem_vals: torch.Tensor, ltog: torch.Tensor, nn: int) -> torch.Tensor:
    """Scatter-add ``elem_vals (NE, NEN, *rest)`` to ``(nn, *rest)`` through
    ``ltog (NE, NEN)`` (the JAX package's ``segment_sum``), deterministic:
    the table of :func:`build_reverse_incidence` is built for the call on
    ``ltog``'s device (one scalar read, its depth), so use
    :func:`scatter_nodes_rev` with a stored table on a hot path."""
    ne, s = ltog.shape
    ids = ltog.T.reshape(-1).long()              # the JAX flattening: s * NE + e
    _, order = torch.sort(ids, stable=True)      # ascending node, then position
    counts = torch.bincount(ids, minlength=nn)
    node = ids[order]
    rank = torch.arange(ids.numel(), device=ids.device) - (counts.cumsum(0) - counts)[node]
    rev = torch.full((int(counts.max()), nn), ne * s, dtype=torch.long, device=ids.device)
    rev[rank, node] = (order % ne) * s + order // ne
    return scatter_nodes_rev(elem_vals, rev)


def _gather_nodes(x: torch.Tensor, ltog: torch.Tensor) -> torch.Tensor:
    """``x (C, NN)`` at the element nodes: ``(NE, NEN, C)``."""
    return x.T[ltog]


def _udotgrad(u0_e: torch.Tensor, sv: torch.Tensor, gdsv: torch.Tensor) -> torch.Tensor:
    """(u0 . grad) Sv_j at each Gauss point: ``(NE, NENv_j, NGP)``.

    ``u0_e (NE, NENv, 3)``, ``sv (NGP, NENv)``, ``gdsv (NE, 3, NENv, NGP)``."""
    u0_gq = torch.matmul(sv, u0_e)                        # (NE, NGP, 3)
    return sum(u0_gq[:, None, :, d] * gdsv[:, d] for d in range(3))


def _stab_term(u0_e, sv, gdsv):
    """Temam's (div u0)_k Sv_j(k) term of (u0 . grad) Sv_j: ``(NE, NENv, NGP)``."""
    div0 = torch.einsum("edjk,ejd->ek", gdsv, u0_e)
    return div0[:, None, :] * sv.T[None]


def _test_weights(sv, gq):
    """Sv_i(k) |J| w_k per element: ``(NE, NENv_i, NGP)``."""
    return sv.T[None] * gq[:, None, :]


def elem_matvec_apply(ke: torch.Tensor, x: torch.Tensor, ltog: torch.Tensor,
                      rev: torch.Tensor) -> torch.Tensor:
    """y = K @ x through the ELEMENTAL matrices: gather -> ``bmm`` ->
    deterministic scatter.  ``ke (NE, NEN, NEN)``, ``x (C, NN)`` -> ``(C, NN)``."""
    y_e = torch.bmm(ke, _gather_nodes(x, ltog))           # (NE, NEN, C)
    return scatter_nodes_rev(y_e, rev).T.contiguous()


def convection_elemental(u0: torch.Tensor, ltog: torch.Tensor, sv: torch.Tensor,
                         gdsv: torch.Tensor, gq: torch.Tensor,
                         stab_coef: float = 0.0) -> torch.Tensor:
    """Elemental convection matrices Ae(u0) ``(NE, NENv_i, NENv_j)``, built
    once per time step and added to the elemental K, so (K + A(u0)) u* is
    one :func:`elem_matvec_apply` per sub-iteration.  ``stab_coef`` adds
    Temam's (div u0) Sv_i Sv_j term."""
    u0_e = _gather_nodes(u0, ltog)
    udotg = _udotgrad(u0_e, sv, gdsv)                     # (NE, NENv_j, NGP)
    if stab_coef:
        udotg = udotg + stab_coef * _stab_term(u0_e, sv, gdsv)
    return torch.bmm(_test_weights(sv, gq), udotg.transpose(1, 2))


def elem_grad_apply(ge: torch.Tensor, p: torch.Tensor, ltog_p: torch.Tensor,
                    rev: torch.Tensor) -> torch.Tensor:
    """``(3, NN)`` = [G1 p, G2 p, G3 p] through the elemental gradient
    blocks ``ge (NE, 3, NENv, NENp)``, ``p (NNp,)``."""
    ne, _, nenv, nenp = ge.shape
    y_e = torch.bmm(ge.reshape(ne, 3 * nenv, nenp), p[ltog_p][:, :, None])
    return scatter_nodes_rev(y_e.reshape(ne, 3, nenv).transpose(1, 2), rev).T.contiguous()


def elem_div_apply(ge: torch.Tensor, u: torch.Tensor, ltog: torch.Tensor,
                   rev_p: torch.Tensor) -> torch.Tensor:
    """``(NNp,)`` = G1^T u_x + G2^T u_y + G3^T u_z, elemental form."""
    ne, _, nenv, nenp = ge.shape
    u_e = u[:, ltog].permute(1, 0, 2).reshape(ne, 1, 3 * nenv)   # (d, i) order
    y_e = torch.bmm(u_e, ge.reshape(ne, 3 * nenv, nenp))         # (NE, 1, NENp)
    return scatter_nodes_rev(y_e.reshape(ne, nenp), rev_p)


def convection_apply(u0: torch.Tensor, uprev: torch.Tensor, ltog: torch.Tensor,
                     sv: torch.Tensor, gdsv: torch.Tensor, gq: torch.Tensor, rev: torch.Tensor,
                     stab_coef: float = 0.0) -> torch.Tensor:
    """R1conv ``(3, NN)`` = A(u0) @ uprev, matrix-free (never forms Ae):
    ``calculateMatrixA`` + the R1e products (``blascoCodinaHuerta.cpp
    :3608-3655``), scattered through the stored reverse table ``rev`` of
    ``ltog`` where the JAX package takes ``nn`` into a ``segment_sum``."""
    u0_e = _gather_nodes(u0, ltog)
    up_e = _gather_nodes(uprev, ltog)                     # (NE, NENv, 3)
    udotg = _udotgrad(u0_e, sv, gdsv)                     # (NE, NENv, NGP)
    conv_gq = torch.bmm(udotg.transpose(1, 2), up_e)      # (NE, NGP, 3)
    if stab_coef:
        div0 = torch.einsum("edjk,ejd->ek", gdsv, u0_e)
        conv_gq = conv_gq + stab_coef * div0[:, :, None] * torch.matmul(sv, up_e)
    r1e = torch.bmm(_test_weights(sv, gq), conv_gq)       # (NE, NENv, 3)
    return scatter_nodes_rev(r1e, rev).T.contiguous()


def convection_assemble_csr(u0: torch.Tensor, ltog: torch.Tensor, sv: torch.Tensor,
                            gdsv: torch.Tensor, gq: torch.Tensor, rev_m: torch.Tensor,
                            stab_coef: float = 0.0) -> torch.Tensor:
    """Assembled CSR values ``(nnz,)`` of A(u0) (the implicit solver's
    convection block), summed through ``rev_m``, the reverse table of the
    elemental -> NNZ map (``build_reverse_incidence(scatter (NE, NENv *
    NENv), nnz)``) where the JAX package takes the map itself into a
    ``segment_sum``."""
    ae = convection_elemental(u0, ltog, sv, gdsv, gq, stab_coef)
    return scatter_nodes_rev(ae.reshape(ae.shape[0], -1), rev_m)
