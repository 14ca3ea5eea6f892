"""Stencil ops of the structured layouts: the stride-2 elemental and
embedding ops of the interleaved layout, and the DIA / window-patches
applies of the XLA structured path.

Port of ``cfd_with_cuda_tpu/ops/stencil.py``.  Fields are flat z-major
fine-grid arrays ``flat = (k*fy + j)*fx + i``; the coarse pressure grid sits
at the even fine positions, and element (I, J, K) is the 3x3x3 fine-node
window at origin (2I, 2J, 2K).  The interleaved layout's kernel path runs the
elemental ops (gather, strided assembly, parity-grouped scatter) on strided
views of the ``(fz, fy, fx)`` grid: no node-index gather and no scatter over
nodes.  The XLA structured path (F64, ``pressure_backend="xla"``, the
multigrid preconditioner; torch ops here as they are XLA ops in the JAX
package) applies its operators in two gather-free forms:

* :func:`dia_spmv` -- a sum of rolled products, one per stored diagonal;
* :func:`patches_spmv` -- every stencil window extracted at once
  (``F.pad`` and three ``unfold``s, the counterpart of
  ``conv_general_dilated_patches``), then one multiply-reduce against the
  spatially varying weights.

Wrap-around (rolls) and zero padding (patches) are both harmless: a
diagonal's value is zero wherever its (row, row + offset) pair is absent.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.ops.window_stencil import spmv_layout

__all__ = [
    "coarse_to_fine", "gather_elem_stencil", "assemble_window_values", "assemble_compact_values",
    "scatter_elem_stencil", "convection_elem_matrices", "convection_apply_elem",
    "dia_spmv", "patches_spmv", "fine_to_coarse", "dia_grad_apply", "dia_div_apply",
    "patches_grad_apply", "patches_div_apply",
]


def dia_spmv(vals: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """``y[g] = sum_o vals[o][g] * x[g + o]`` (indices mod the axis length)
    for ``x (S,)`` or ``(C, S)``, summed in offset order: a roll, a product
    and an add per stored diagonal, each rounded as the JAX package's
    (no fused multiply-add)."""
    acc = None
    for i, o in enumerate(offsets):
        term = vals[i] * torch.roll(x, -int(o), dims=-1)
        if acc is None:
            acc = term
        else:
            acc += term
    return acc


def _extract_patches(x: torch.Tensor, dims, radius: int) -> torch.Tensor:
    """``(C, W^3, S)`` stencil windows of ``x (C, S)`` on a ``(Sx, Sy, Sz)``
    grid, zero outside it: channel k holds x at offset (dz, dy, dx) =
    unravel(k) - radius, the channel order of ``conv_general_dilated_patches``
    and of ``DiaOperator.window_vals``."""
    sx, sy, sz = dims
    w = 2 * radius + 1
    c = x.shape[0]
    x3 = torch.nn.functional.pad(x.reshape(c, sz, sy, sx), (radius,) * 6)
    win = x3.unfold(1, w, 1).unfold(2, w, 1).unfold(3, w, 1)   # (C, sz, sy, sx, kz, ky, kx)
    return win.permute(0, 4, 5, 6, 1, 2, 3).reshape(c, w * w * w, sz * sy * sx)


def patches_spmv(win_vals: torch.Tensor, x: torch.Tensor, dims, radius: int) -> torch.Tensor:
    """``y = A x`` with A as window-ordered stencil values ``(W^3, S)``
    (``DiaOperator.window_vals``), for ``x (S,)`` or ``(C, S)``."""
    single = x.dim() == 1
    xb = x[None] if single else x
    y = torch.einsum("ws,cws->cs", win_vals, _extract_patches(xb, dims, radius))
    return y[0] if single else y


def coarse_to_fine(p: torch.Tensor, coarse_dims, fine_dims) -> torch.Tensor:
    """``p (NNp,)`` in coarse grid order -> ``(S,)`` fine field, zero off the
    even positions."""
    cx, cy, cz = coarse_dims
    fx, fy, fz = fine_dims
    pf = p.new_zeros((fz, fy, fx))
    pf[::2, ::2, ::2] = p.reshape(cz, cy, cx)
    return pf.reshape(-1)


def fine_to_coarse(y: torch.Tensor, coarse_dims, fine_dims) -> torch.Tensor:
    """The even fine-grid positions of ``y (S,)`` in coarse grid order."""
    fx, fy, fz = fine_dims
    return y[: fx * fy * fz].reshape(fz, fy, fx)[::2, ::2, ::2].reshape(-1)


def dia_grad_apply(g_vals, p: torch.Tensor, offsets, coarse_dims, fine_dims,
                   s_pad: int | None = None) -> torch.Tensor:
    """``(3, s_pad)`` <- [G1 p, G2 p, G3 p] with each Gd in fine-grid DIA form
    on its own offset set: ``g_vals[d] (n_d, S)``, ``offsets[d]``.  The
    embedded pressure is zero-padded to ``s_pad`` (default: no padding)."""
    pf = coarse_to_fine(p, coarse_dims, fine_dims)
    if s_pad is not None:
        pf = torch.nn.functional.pad(pf, (0, s_pad - pf.shape[0]))
    return torch.stack([dia_spmv(g_vals[d], pf, offsets[d]) for d in range(3)])


def dia_div_apply(gt_vals, u: torch.Tensor, offsets, coarse_dims, fine_dims) -> torch.Tensor:
    """``(NNp,)`` <- sum_d Gd^T u_d with each Gd^T in fine-grid DIA form on
    its own offset set (``gt_vals[d]``, ``offsets[d]``; its rows live on the
    embedded coarse positions)."""
    acc = dia_spmv(gt_vals[0], u[0], offsets[0])
    for d in (1, 2):
        acc = acc + dia_spmv(gt_vals[d], u[d], offsets[d])
    return fine_to_coarse(acc, coarse_dims, fine_dims)


def patches_grad_apply(g_win: torch.Tensor, p: torch.Tensor, coarse_dims, fine_dims,
                       radius: int) -> torch.Tensor:
    """``(3, S)`` gradient from one window extraction of the embedded
    pressure (``g_win (3, W^3, S)``)."""
    pf = coarse_to_fine(p, coarse_dims, fine_dims)
    pat = _extract_patches(pf[None], fine_dims, radius)[0]        # (W^3, S)
    return torch.einsum("dws,ws->ds", g_win, pat)


def patches_div_apply(gt_win: torch.Tensor, u: torch.Tensor, coarse_dims, fine_dims,
                      radius: int) -> torch.Tensor:
    """``(NNp,)`` divergence from one batched window extraction of ``u (3, S)``."""
    pat = _extract_patches(u, fine_dims, radius)                  # (3, W^3, S)
    return fine_to_coarse(torch.einsum("dws,dws->s", gt_win, pat), coarse_dims, fine_dims)


def gather_elem_stencil(u: torch.Tensor, elem_dims, fine_dims) -> torch.Tensor:
    """``u (C, S)`` -> ``(C, 27, NE)``: each element's 3x3x3 window in
    window-channel order ``(kz*3 + ky)*3 + kx`` (the z-major scan of
    ``conv_general_dilated_patches``), elements in z-major ``(ez, ey, ex)``
    order.  Three stride-2 ``unfold``s over (z, y, x)."""
    ex, ey, ez = elem_dims
    fx, fy, fz = fine_dims
    c = u.shape[0]
    u3 = u[:, : fx * fy * fz].reshape(c, fz, fy, fx)
    win = u3.unfold(1, 3, 2).unfold(2, 3, 2).unfold(3, 3, 2)   # (C, ez, ey, ex, kz, ky, kx)
    return win.permute(0, 4, 5, 6, 1, 2, 3).reshape(c, 27, ez * ey * ex)


def _lattice(t3: torch.Tensor, off, elem_dims) -> torch.Tensor:
    """The view of ``t3 (..., fz, fy, fx)`` at fine nodes (2I+ox, 2J+oy, 2K+oz)."""
    ex, ey, ez = elem_dims
    ox, oy, oz = off
    return t3[..., oz: oz + 2 * ez: 2, oy: oy + 2 * ey: 2, ox: ox + 2 * ex: 2]


def assemble_window_values(ae: torch.Tensor, local_off, oij, n_off: int, elem_dims,
                           fine_dims, s_pad: int) -> torch.Tensor:
    """``(n_off, s_pad)`` window-operator values from the elemental matrices
    ``ae (NEN, NEN, NE)`` (element-grid order).  On a box grid entry (i, j)
    of every element lands at the fixed window slot ``oij[i][j]`` in fine row
    ``2*origin(e) + local_off[i]``.  For one i the 27 slots ``oij[i]`` are
    distinct, so row i of every element is ONE strided index-add of its 27
    values: 27 adds in all, where the JAX package places 27 full fields
    (``place_elem_field``) and chains 729 row adds.  Each output sums its
    terms in i order, as the JAX chains do (bit-equal)."""
    ex, ey, ez = elem_dims
    fx, fy, fz = fine_dims
    s = fx * fy * fz
    nen = len(local_off)
    out = ae.new_zeros((n_off, s_pad))
    grid = out[:, :s].view(n_off, fz, fy, fx)
    slots = torch.as_tensor(np.asarray(oij, dtype=np.int64), device=ae.device)
    for i in range(nen):
        view = _lattice(grid, local_off[i], elem_dims)        # (n_off, ez, ey, ex)
        view[slots[i]] += ae[i].reshape(nen, ez, ey, ex)
    return out


@functools.lru_cache(maxsize=16)
def _slot_table(coij, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(coij, dtype=np.int64), device=device)


def assemble_compact_values(ae: torch.Tensor, local_off, coij, offsets, elem_dims,
                            fine_dims, n: int) -> torch.Tensor:
    """:func:`assemble_window_values` straight into the class-compacted,
    class-major table of ``window_stencil.compact_spmv_window`` over ``n``
    rows (``offsets`` the operator's, ``coij`` the slot map
    ``window_stencil.compact_spmv_oij`` gives).  Local node i of every element
    lands in class c(i), the parity of ``local_off[i]``, on a contiguous
    sub-box of that class's block: the same 27 strided index-adds, in i
    order, so every entry equals the compaction of
    :func:`assemble_window_values`'s bit for bit."""
    ex, ey, ez = elem_dims
    lay = spmv_layout(offsets, fine_dims, n)
    out = ae.new_zeros(lay.size)
    nen = len(local_off)
    slots = _slot_table(coij, ae.device)
    for i, (ox, oy, oz) in enumerate(local_off):
        c = (oz & 1) * 4 + (oy & 1) * 2 + (ox & 1)
        gx, gy, gz = lay.dims[c]
        cnt = int(lay.counts[c])
        blk = out[lay.bases[c]: lay.bases[c] + cnt * lay.rows[c]].view(cnt, gz, gy, gx)
        dx, dy, dz = ox // 2, oy // 2, oz // 2
        view = blk[:, dz: dz + ez, dy: dy + ey, dx: dx + ex]
        view[slots[i]] += ae[i].reshape(nen, ez, ey, ex)
    return out


def scatter_elem_stencil(r_e: torch.Tensor, local_off, elem_dims, fine_dims) -> torch.Tensor:
    """Elemental scatter-add ``r_e (C, NEN, NE)`` -> ``(C, S)``.  Local
    nodes of one parity class land on the same stride-2 lattice shifted by
    whole elements: each class is summed in element space (contiguous
    slice adds, in ``local_off`` order) and written to its lattice once, as
    the JAX function groups them."""
    ex, ey, ez = elem_dims
    fx, fy, fz = fine_dims
    c = r_e.shape[0]
    groups: dict = {}
    for i, off in enumerate(local_off):
        groups.setdefault((off[0] & 1, off[1] & 1, off[2] & 1), []).append((i, off))
    out = r_e.new_zeros((c, fz, fy, fx))
    for (px, py, pz), items in groups.items():
        gx, gy, gz = (fx - px + 1) // 2, (fy - py + 1) // 2, (fz - pz + 1) // 2
        g = r_e.new_zeros((c, gz, gy, gx))
        for i, off in items:
            dx, dy, dz = (off[0] - px) // 2, (off[1] - py) // 2, (off[2] - pz) // 2
            g[:, dz: dz + ez, dy: dy + ey, dx: dx + ex] += r_e[:, i].reshape(c, ez, ey, ex)
        out[:, pz::2, py::2, px::2] = g
    return out.reshape(c, -1)


def convection_elem_matrices(u0, sv, gdsv, gq, elem_dims, fine_dims,
                             stab_coef: float = 0.0) -> torch.Tensor:
    """The elemental convection matrices ``ae (NENv_i, NENv_j, NE)`` of
    A(u0) (``calculateMatrixA``), elements in element-grid order, local
    nodes in window-channel order: the once-per-step build of both solvers'
    interleaved steps (explicit_bch.py:888-924, implicit_gq.py:865-876)."""
    u0_e = gather_elem_stencil(u0, elem_dims, fine_dims)
    u0_gq = torch.einsum("ki,die->dke", sv, u0_e)
    udotg = torch.einsum("dke,djke->jke", u0_gq, gdsv)
    if stab_coef:
        div0 = torch.einsum("djke,dje->ke", gdsv, u0_e)
        udotg = udotg + stab_coef * div0[None] * sv.T[:, :, None]
    return torch.einsum("ki,ke,jke->ije", sv, gq, udotg)


def convection_apply_elem(ae, u, local_off, elem_dims, fine_dims) -> torch.Tensor:
    """Matrix-free A u from the elemental matrices ``ae (NEN, NEN, NE)`` of
    :func:`convection_elem_matrices`: gather -> per-element matvec ->
    parity-grouped scatter, ``(C, S)`` from ``u (C, >= S)``
    (explicit_bch.py:961-977).  On ``convection_elem_matrices(u0, ...)`` it
    is the JAX package's ``convection_apply_stencil(u0, u, ...)``."""
    r_e = torch.einsum("ije,dje->die", ae, gather_elem_stencil(u, elem_dims, fine_dims))
    return scatter_elem_stencil(r_e, local_off, elem_dims, fine_dims)
