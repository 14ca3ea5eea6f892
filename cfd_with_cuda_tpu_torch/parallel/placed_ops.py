"""The XLA structured path's operators on a rank's block of the fine axis.

The JAX package runs its XLA structured step across devices with no code
change: the caller places the arrays (``shard_params`` / ``shard_state``) and
GSPMD partitions the jitted step, turning each ``jnp.roll`` of the DIA
applies into a collective permute and each window extraction into a halo
exchange.  PyTorch has no GSPMD, so these are those partitioned operators
written out, on the block ``[r0, r1)`` of the padded fine axis that a rank
holds (``parallel/placement.py::place``):

* :func:`dia_spmv_placed` -- ``dia_spmv`` (``ops/stencil.py``) on the rank's
  rows after one halo exchange of the largest |offset| (any width: the
  halo comes from as many ranks as hold it); outside the field it reads
  zero, where ``dia_spmv``'s roll wraps onto a zero weight;
* :func:`dia_grad_placed` / :func:`patches_grad_placed` -- G on the rank's
  fine rows from the replicated coarse pressure, no collective;
* :func:`dia_div_placed` / :func:`patches_div_placed` -- G^T on the rank's
  fine rows (one halo exchange), its coarse rows then all-gathered
  (``sharded_stencil.gather_coarse_rows``) into the replicated vector the
  pressure CG reads.

Each DIA row is the single-device row's products summed in the same offset
order, so the DIA forms equal one device's bit for bit; the patches forms
(F32) contract the same windows with the same ``einsum``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.ops.stencil import coarse_to_fine
from cfd_with_cuda_tpu_torch.ops.window_stencil import coarse_rows
from cfd_with_cuda_tpu_torch.parallel.sharded_stencil import Block, gather_coarse_rows
from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh, halo_exchange

__all__ = [
    "rows_of", "dia_rows", "dia_spmv_placed", "dia_grad_placed", "dia_div_placed",
    "patches_grad_placed", "patches_div_placed",
]


def rows_of(x_ext: torch.Tensor, x_org: int, start: int, n: int) -> torch.Tensor:
    """``x`` over the global rows ``[start, start + n)`` of a field whose rows
    ``x_ext`` holds from global row ``x_org`` on; zero where it holds none."""
    a, b = start - x_org, start - x_org + n
    lo, hi = max(a, 0), min(b, x_ext.shape[-1])
    if (lo, hi) == (a, b):
        return x_ext[..., a:b]
    out = x_ext.new_zeros(x_ext.shape[:-1] + (n,))
    if lo < hi:
        out[..., lo - a: hi - a] = x_ext[..., lo:hi]
    return out


def dia_rows(vals: torch.Tensor, x_ext: torch.Tensor, x_org: int, r0: int,
             offsets) -> torch.Tensor:
    """The rows ``[r0, r0 + n)`` of ``dia_spmv(vals_full, x, offsets)`` from
    those rows' diagonals ``vals (n_off, n)`` and ``x_ext``, the field from
    global row ``x_org`` on: a product and an add per diagonal, in offset
    order, as ``dia_spmv`` sums them.  The field's reach is zero-filled once,
    so each diagonal reads a view."""
    n = vals.shape[-1]
    lo = r0 + min(int(o) for o in offsets)
    x = rows_of(x_ext, x_org, lo, n + max(int(o) for o in offsets) + r0 - lo)
    acc = None
    for i, o in enumerate(offsets):
        a = r0 + int(o) - lo
        term = vals[i] * x[..., a: a + n]
        if acc is None:
            acc = term
        else:
            acc += term
    return acc


def _halo(offsets) -> int:
    return max(abs(int(o)) for o in offsets)


def dia_spmv_placed(vals: torch.Tensor, x: torch.Tensor, offsets, mesh: Mesh,
                    what: str = "halo_dia") -> torch.Tensor:
    """This rank's rows of ``y = A x``: ``vals (n_off, s_loc)`` and ``x (C,
    s_loc)`` (or ``(s_loc,)``) its blocks; one halo exchange."""
    xb = x if x.ndim == 2 else x[None]
    h = _halo(offsets)
    x_ext, lo = halo_exchange(xb, h, h, mesh, what)
    r0 = mesh.rank * xb.shape[-1]
    y = dia_rows(vals, x_ext, r0 - lo, r0, offsets)
    return y if x.ndim == 2 else y[0]


def dia_grad_placed(g_vals, p: torch.Tensor, offsets, coarse_dims, fine_dims,
                    block: Block) -> torch.Tensor:
    """``(3, s_loc)``: the rank's rows of ``dia_grad_apply`` (``g_vals[d]
    (n_d, s_loc)`` its rows of Gd) from the replicated coarse pressure ``p``;
    no collective."""
    pf = torch.nn.functional.pad(coarse_to_fine(p, coarse_dims, fine_dims),
                                 (0, block.s_pad - int(np.prod(fine_dims))))
    return torch.stack([dia_rows(g_vals[d], pf, 0, block.r0, offsets[d]) for d in range(3)])


def dia_div_placed(gt_vals, u: torch.Tensor, offsets, coarse_dims, fine_dims,
                   mesh: Mesh) -> torch.Tensor:
    """``(NNp,)`` on every rank: ``dia_div_apply`` from the rank's rows of each
    Gd^T (``gt_vals[d] (n_d, s_loc)``) and ``u (3, s_loc)``: one halo
    exchange, the sum on the rank's fine rows, its coarse rows all-gathered."""
    s_loc = u.shape[-1]
    r0 = mesh.rank * s_loc
    h = max(map(_halo, offsets))
    u_ext, lo = halo_exchange(u, h, h, mesh, "halo_div")
    acc = dia_rows(gt_vals[0], u_ext[0], r0 - lo, r0, offsets[0])
    for d in (1, 2):
        acc = acc + dia_rows(gt_vals[d], u_ext[d], r0 - lo, r0, offsets[d])
    return _coarse_of_rows(acc, coarse_dims, fine_dims, r0, mesh)


def _coarse_of_rows(acc: torch.Tensor, coarse_dims, fine_dims, r0: int, mesh: Mesh):
    """The replicated coarse vector from each rank's fine rows ``acc``: the
    rows at its embedded coarse positions, all-gathered."""
    s_loc = acc.shape[-1]
    q0, q1 = coarse_rows(fine_dims, coarse_dims, (r0, r0 + s_loc))
    y = acc[_embedded(tuple(fine_dims), tuple(coarse_dims), q0, q1, r0, acc.device)]
    return gather_coarse_rows(y, fine_dims, coarse_dims, s_loc, mesh, "gather_div")


@functools.lru_cache(maxsize=32)
def _embedded(fine_dims, coarse_dims, q0, q1, r0, device) -> torch.Tensor:
    """The block positions of the coarse rows ``[q0, q1)``."""
    fx, fy, _ = fine_dims
    cx, cy, _ = coarse_dims
    q = np.arange(q0, q1)
    emb = (2 * (q // (cx * cy)) * fy + 2 * (q // cx % cy)) * fx + 2 * (q % cx)
    return torch.from_numpy(emb - r0).to(device)


@functools.lru_cache(maxsize=32)
def _patch_index(fine_dims, radius: int, r0: int, n: int, x_org: int, device):
    """``(index (W^3, n), valid (W^3, n))``: for each of the global rows
    ``[r0, r0 + n)`` and window channel ``(kz, ky, kx)`` (the order of
    ``ops/stencil.py::_extract_patches``), the position of its neighbour in
    a field held from global row ``x_org`` on, and whether that neighbour
    lies in the box (outside it the window reads zero)."""
    fx, fy, fz = fine_dims
    g = np.arange(r0, r0 + n)
    x, y, z = g % fx, g // fx % fy, g // (fx * fy)
    w = np.arange(-radius, radius + 1)
    dz, dy, dx = (a.reshape(-1, 1) for a in np.meshgrid(w, w, w, indexing="ij"))
    nx, ny, nz = x + dx, y + dy, z + dz
    valid = (nx >= 0) & (nx < fx) & (ny >= 0) & (ny < fy) & (nz >= 0) & (nz < fz)
    idx = np.where(valid, (nz * fy + ny) * fx + nx - x_org, 0)
    return torch.from_numpy(idx).to(device), torch.from_numpy(valid).to(device)


def _patches(x_ext: torch.Tensor, x_org: int, fine_dims, radius: int, r0: int, n: int):
    """``(C, W^3, n)`` windows of the rows ``[r0, r0 + n)`` from ``x_ext (C, m)``."""
    idx, valid = _patch_index(tuple(fine_dims), radius, r0, n, x_org, x_ext.device)
    return torch.where(valid, x_ext[:, idx], x_ext.new_zeros(()))


def _real_rows(fine_dims, r0: int, s_loc: int) -> int:
    """The rank's rows that lie on the grid (the rest are padding)."""
    return max(0, min(s_loc, int(np.prod(fine_dims)) - r0))


def patches_grad_placed(g_win: torch.Tensor, p: torch.Tensor, coarse_dims, fine_dims,
                        radius: int, block: Block) -> torch.Tensor:
    """``(3, s_loc)``: the rank's rows of ``patches_grad_apply`` (``g_win (3,
    W^3, s_loc)`` its columns of the G window), zero on padding rows; no
    collective."""
    n = _real_rows(fine_dims, block.r0, block.s_loc)
    pf = coarse_to_fine(p, coarse_dims, fine_dims)[None]
    pat = _patches(pf, 0, fine_dims, radius, block.r0, n)[0]
    y = torch.einsum("dws,ws->ds", g_win[..., :n], pat)
    return torch.nn.functional.pad(y, (0, block.s_loc - n))


def patches_div_placed(gt_win: torch.Tensor, u: torch.Tensor, coarse_dims, fine_dims,
                       radius: int, mesh: Mesh) -> torch.Tensor:
    """``(NNp,)`` on every rank: ``patches_div_apply`` from the rank's
    columns ``gt_win (3, W^3, s_loc)`` and rows ``u (3, s_loc)``: one halo
    exchange of the window's reach, its coarse rows all-gathered."""
    s_loc = u.shape[-1]
    r0 = mesh.rank * s_loc
    fx, fy, _ = fine_dims
    h = radius * (1 + fx + fx * fy)
    u_ext, lo = halo_exchange(u, h, h, mesh, "halo_div")
    n = _real_rows(fine_dims, r0, s_loc)
    pat = _patches(u_ext, r0 - lo, fine_dims, radius, r0, n)
    acc = torch.nn.functional.pad(torch.einsum("dws,dws->s", gt_win[..., :n], pat),
                                  (0, s_loc - n))
    return _coarse_of_rows(acc, coarse_dims, fine_dims, r0, mesh)
