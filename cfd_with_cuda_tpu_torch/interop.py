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

from cfd_with_cuda_tpu_torch.ops.spmv import build_reverse_incidence
from cfd_with_cuda_tpu_torch.ops.window_stencil import compact_g_window
from cfd_with_cuda_tpu_torch.solvers.base import compact_spmv_tables
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitState
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitState

__all__ = [
    "tables_from_jax", "state_from_jax",
    "implicit_tables_from_jax", "implicit_state_from_jax",
    "interleaved_tables_from_jax", "implicit_interleaved_tables_from_jax",
    "xla_tables_from_jax", "implicit_xla_tables_from_jax",
    "ell_tables_from_jax", "implicit_ell_tables_from_jax", "rev_from_jax",
    "state_to_rank", "gather_state",
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


# tables the interleaved steps read under the same name in both packages
_SHARED_INTERLEAVED = (
    "K_vals", "G_win", "GT_win", "GT_cwin", "md_inv", "md_orig_inv", "bc_mask", "bc_vel",
)
_SHARED_INTERLEAVED_IMPLICIT = (
    "MK_vals", "M_vals", "row_mask_grid", "diag_add_grid", "G_win", "GT_win", "GT_cwin",
    "bc_mask", "bc_vel", "Sv", "gDSv", "gq", "p_mask",
)
# tables the XLA structured steps read under the same name in both packages,
# besides G and G^T (``G_dia{i}`` / ``GT_dia{i}`` under F64, else ``G_win`` /
# ``GT_win``) and the multigrid levels (``mg_win_{l}``, ``mg_diag_{l}``,
# ``mg_zinv``)
_SHARED_XLA = ("K_vals", "Z_win", "Z_diag", "md_inv", "md_orig_inv", "bc_mask", "bc_vel")
_SHARED_XLA_IMPLICIT = (
    "MK_vals", "M_vals", "row_mask_grid", "diag_add_grid", "Z_win", "Z_diag", "p_mask",
    "bc_mask", "bc_vel", "Sv", "gDSv", "gq",
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


def _carry_interleaved(d, names, attrs, sym: bool, offsets) -> dict[str, torch.Tensor]:
    """:func:`_carry`, and the class-compacted tables the port's interleaved
    steps apply: the G window (``G_cwin``, from the carried ``G_win``) and
    the window SPMV's (``compact_spmv_tables``, on the operator ``offsets``)."""
    out = _carry(d, names, attrs, sym)
    out["G_cwin"] = compact_g_window(out["G_win"], attrs["fine_dims"], attrs["g_radius"])[0]
    return out | compact_spmv_tables(out, offsets, attrs["fine_dims"])


def interleaved_tables_from_jax(d: dict[str, np.ndarray], attrs: dict, *,
                                sym: bool = False) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX explicit solver's interleaved ``d``
    (``attrs``: ``ExplicitBCHSolver.INTERLEAVED_STATIC_ATTRS``, with
    ``elem_structured``, ``fine_dims`` and ``g_radius``; ``sym`` as
    :func:`tables_from_jax`).  On a box whose elements do not tile it the
    element tables go element-major and the grid-order ``ltog`` gets its
    reverse table, as the port's elemental convection takes them."""
    out = _carry_interleaved(d, _SHARED_INTERLEAVED, attrs, sym, attrs["k_offsets"])
    if attrs["elem_structured"]:
        out |= _tensors({k: np.asarray(d[k]) for k in ("Sv", "gDSv", "gq")})
    else:
        tabs = _element_tables(d)
        tabs["ltog"] = np.asarray(tabs["ltog"], dtype=np.int32)
        tabs["rev"] = build_reverse_incidence(tabs["ltog"], int(np.prod(attrs["fine_dims"])))
        out |= _tensors(tabs)
    return out


def implicit_interleaved_tables_from_jax(d: dict[str, np.ndarray], attrs: dict, *,
                                         sym: bool = False) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX implicit solver's interleaved ``d``
    (``attrs``: ``ImplicitGQSolver.INTERLEAVED_STATIC_ATTRS``; ``sym`` as
    :func:`tables_from_jax`)."""
    return _carry_interleaved(d, _SHARED_INTERLEAVED_IMPLICIT, attrs, sym, attrs["a_offsets"])


def _carry_xla(d, names) -> dict[str, np.ndarray]:
    """The named tables, G and G^T in the form the solver stored them, and
    every multigrid level, copied."""
    extra = [k for k in d if k.startswith(("G_dia", "GT_dia", "mg_")) or k in ("G_win", "GT_win")]
    return {k: np.asarray(d[k]) for k in (*names, *extra)}


def xla_tables_from_jax(d: dict[str, np.ndarray], attrs: dict) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX explicit solver's ``d`` on its XLA
    structured path (``attrs``: ``ExplicitBCHSolver.XLA_STATIC_ATTRS``, with
    ``elem_structured`` and ``fine_dims``).  On a box whose elements do not
    tile it the element tables go element-major and the grid-order ``ltog``
    gets its reverse table, as :func:`interleaved_tables_from_jax` gives them."""
    out = _carry_xla(d, _SHARED_XLA)
    if attrs["elem_structured"]:
        out |= {k: np.asarray(d[k]) for k in ("Sv", "gDSv", "gq")}
    else:
        tabs = _element_tables(d)
        tabs["ltog"] = np.asarray(tabs["ltog"], dtype=np.int32)
        tabs["rev"] = build_reverse_incidence(tabs["ltog"], int(np.prod(attrs["fine_dims"])))
        out |= tabs
    return _tensors(out)


def implicit_xla_tables_from_jax(d: dict[str, np.ndarray], attrs: dict) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX implicit solver's ``d`` on its XLA
    structured path (``attrs``: ``ImplicitGQSolver.XLA_STATIC_ATTRS``)."""
    return _tensors(_carry_xla(d, _SHARED_XLA_IMPLICIT))


def rev_from_jax(rev: np.ndarray, ne: int, s: int) -> np.ndarray:
    """A JAX reverse-incidence table (positions ``s_i * NE + e`` of a
    ``(S, NE)`` value array) as the port's (positions ``e * S + s_i`` of an
    ``(NE, S)`` array), entries in the same order; sentinel ``NE * S``."""
    rev = np.asarray(rev).astype(np.int64)
    out = (rev % ne) * s + rev // ne
    out[rev == ne * s] = ne * s
    return out.astype(np.int32)


def _element_tables(d) -> dict[str, np.ndarray]:
    """The JAX package's element-minor tables in the port's element-major
    layout: ``ltog (NEN, NE) -> (NE, NEN)``, ``gDSv (3, NENv, NGP, NE) ->
    (NE, 3, NENv, NGP)``, ``gq (NGP, NE) -> (NE, NGP)``."""
    return {
        "ltog": np.asarray(d["ltog"]).T,
        "Sv": np.asarray(d["Sv"]),
        "gDSv": np.transpose(np.asarray(d["gDSv"]), (3, 0, 1, 2)),
        "gq": np.asarray(d["gq"]).T,
    }


def _tensors(out: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def ell_tables_from_jax(d: dict[str, np.ndarray], attrs: dict) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX explicit solver's unstructured ``d``
    (``attrs``: ``ExplicitBCHSolver.ELL_STATIC_ATTRS``, with ``nnp`` and
    ``z_offs``).  Element tables are transposed to element-major, the
    reverse tables re-indexed (:func:`rev_from_jax`), and the banded window
    comes across as the plain ``(D, NNp)`` table: from ``Z_bwin_cg (nb, KP,
    s_pad)`` cut as :func:`tables_from_jax` cuts ``Z_win_cg``, else
    ``Z_bwin``.  ``Z_dinv`` is the f32 reciprocal of ``Z_diag``, as the JAX
    step divides per solve.  The per-node vectors keep their shard padding
    (``s_pad``)."""
    nnp = int(attrs["nnp"])
    out = _element_tables(d)
    ne = out["ltog"].shape[0]
    out["ltog_p"] = np.asarray(d["ltog_p"]).T
    out["rev"] = rev_from_jax(d["rev"], ne, out["ltog"].shape[1])
    out["rev_p"] = rev_from_jax(d["rev_p"], ne, out["ltog_p"].shape[1])
    out["Ke"] = np.transpose(np.asarray(d["Ke"]), (2, 0, 1))
    out["Ge"] = np.transpose(np.asarray(d["Ge"]), (3, 0, 1, 2))
    for k in ("Z_vals", "Z_cols", "Z_diag", "md_inv", "md_orig_inv", "bc_mask", "bc_vel"):
        out[k] = np.asarray(d[k])
    out["Z_dinv"] = np.ones((), out["Z_diag"].dtype) / out["Z_diag"]
    if attrs["z_offs"] is not None:
        if "Z_bwin_cg" in d:
            s_pad = -(-nnp // 128) * 128
            out["Z_bwin"] = np.asarray(d["Z_bwin_cg"]).reshape(-1, s_pad)[
                : len(attrs["z_offs"]), :nnp]
        else:
            out["Z_bwin"] = np.asarray(d["Z_bwin"])
    return _tensors(out)


def implicit_ell_tables_from_jax(d: dict[str, np.ndarray], attrs: dict) -> dict[str, torch.Tensor]:
    """The port's table dict from a JAX implicit solver's ELL ``d``
    (``attrs``: ``ImplicitGQSolver.ELL_STATIC_ATTRS``, with ``nn`` and
    ``s_pad``).  The elemental -> CSR map ``scatter_m (NENv, NENv, NE)``
    becomes its reverse table ``rev_m`` over the element-major ``(NE, NENv *
    NENv)`` values.  The node-rowed tables keep their shard padding, and
    ``csr_to_ell`` addresses the padded ``(L, s_pad)`` table, which the JAX
    step pads in-graph."""
    nn, s_pad = int(attrs["nn"]), int(attrs["s_pad"])
    out = _element_tables(d)
    scatter = np.transpose(np.asarray(d["scatter_m"]), (2, 0, 1))
    out["rev_m"] = build_reverse_incidence(scatter.reshape(scatter.shape[0], -1),
                                           np.asarray(d["mk_vals_csr"]).shape[0])
    for k in ("mk_vals_csr", "row_mask", "diag_add", "GT_vals", "GT_cols", "Z_vals", "Z_cols",
              "Z_diag", "p_mask", "diag_slots", "m_vals", "A_cols", "G_vals", "G_cols",
              "bc_mask", "bc_vel"):
        out[k] = np.asarray(d[k])
    c2e = np.asarray(d["csr_to_ell"])
    out["csr_to_ell"] = (c2e // nn) * s_pad + c2e % nn
    return _tensors(out)


def state_from_jax(state) -> ExplicitState:
    """An ``ExplicitState`` of CPU tensors from a JAX ``ExplicitState``
    (the same five fields, given as arrays)."""
    return ExplicitState(*(torch.from_numpy(np.array(a)) for a in state))


def implicit_state_from_jax(state) -> ImplicitState:
    """An ``ImplicitState`` of CPU tensors from a JAX ``ImplicitState``
    (the same three fields, given as arrays)."""
    return ImplicitState(*(torch.from_numpy(np.array(a)) for a in state))


def state_to_rank(state, solver):
    """This rank's state of a sharded solver from a whole one (a JAX state's
    arrays, or the port's tensors on any device): each node field (last
    axis ``s_pad``) cut to the rank's block, the coarse-grid fields whole;
    the state as the solver's own type, on its device.  On one device the
    fields are only moved."""
    fields = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
              for a in state]
    s_pad = getattr(solver, "s_pad", None)
    placed = [(solver._local(f) if f.ndim == 2 and f.shape[-1] == s_pad else f)
              .to(solver.device) for f in fields]
    return type(solver.initial_state())(*placed)


def gather_state(state, solver):
    """The whole state from every rank's (every rank calls it): each node
    field gathered along its last axis, the coarse-grid fields as they are;
    on one device the state itself."""
    n = getattr(solver.block, "s_loc", None)
    return type(state)(*((solver._full(f) if f.ndim == 2 and f.shape[-1] == n else f)
                         for f in state))
