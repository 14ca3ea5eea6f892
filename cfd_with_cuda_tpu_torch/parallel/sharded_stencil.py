"""The sharded window applies: the multi-device fast path.

Port of ``cfd_with_cuda_tpu/parallel/sharded_stencil.py``.  The flat z-major
grid layout makes any contiguous 1-D partition of the padded fine axis a
valid domain decomposition: a window apply ``y[s] = sum_w win[w, s] *
x[s + off(w)]`` reads at most ``max|off|`` entries past a block's edge, and
the window weights there are zero by construction, so a flat halo exchange
is exact.  Each rank holds its block ``[r0, r1)`` of every fine-grid field
and table (``s_loc = s_pad / n`` rows, ``s_pad`` a multiple of
:func:`shard_blk`) and calls the functions here with its own blocks; they
return its block of the result:

* :func:`sharded_window_spmv` -- field and weights node-sharded: a
  two-sided halo exchange (:func:`_halo_exchange`: the left neighbour's
  last ``halo`` entries, the right neighbour's first ``halo + 128``;
  nothing past a grid edge, which the kernels read as zero, the JAX
  package's zero fill), then the window kernel on the rank's rows reading
  the halo-extended field (``ops/window_stencil.py::window_rows``);
  :func:`sharded_spmv_compact` the same on the class-compacted table of the
  rank's rows (the solvers' K, K + A, M and MK + A);
* :func:`sharded_grad_window` / :func:`sharded_grad_compact` -- the input
  (the pressure embedded on the fine grid) is replicated, so each rank
  slices its block and halo out of it: no collective;
* :func:`sharded_div_window` -- the full-window DIV mode on the rank's rows,
  the result all-gathered (the JAX package's form);
  :func:`sharded_div_compact` -- what the solvers run: the compact G^T
  kernel on the rank's coarse rows alone, then an all-gather of those rows
  (1/8 of the full form's gather) into the replicated coarse vector the
  pressure CG reads.  The coarse-grid CG runs replicated on every rank, as
  in the JAX package (~0.1 MB a vector at NE27000: no collective in its
  loop).

Every apply launches the port's hand-written kernel on a CUDA tensor and
runs its plain version on a CPU one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    BLK,
    coarse_rows,
    compact_g_window,
    div_compact_rows,
    grad_rows,
    spmv_compact_rows,
    window_rows,
)
from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh, all_gather, halo_exchange

__all__ = [
    "halo_size", "shard_blk", "Block", "block_rows", "sharded_window_spmv",
    "sharded_spmv_compact", "sharded_grad_window", "sharded_grad_compact",
    "sharded_div_window", "sharded_div_compact", "gather_coarse_rows",
]


def halo_size(offsets) -> int:
    return max(abs(int(o)) for o in offsets)


def shard_blk(n_devices: int) -> int:
    """Pad multiple for the fine-grid axis under the sharded fast path: every
    rank's block is a whole number of ``BLK`` blocks."""
    return BLK * n_devices


def _check_local(s_pad: int, n: int, halo: int) -> int:
    if s_pad % (BLK * n):
        raise ValueError(
            f"sharded Pallas path needs the padded grid axis ({s_pad}) "
            f"divisible by BLK*n_devices ({BLK}*{n}); set "
            f"SolverConfig.shard_pad accordingly (shard_blk(n))"
        )
    s_loc = s_pad // n
    if s_loc < halo + 128:
        raise ValueError(
            f"local block {s_loc} smaller than stencil halo+tail "
            f"{halo + 128}: too many devices for this grid"
        )
    return s_loc


class Block(NamedTuple):
    """A rank's block of the padded fine axis."""
    s_pad: int
    s_loc: int
    r0: int
    r1: int


def block_rows(s_pad: int, mesh: Mesh) -> Block:
    s_loc = s_pad // mesh.size
    return Block(s_pad, s_loc, mesh.rank * s_loc, (mesh.rank + 1) * s_loc)


def _halo_exchange(x_loc: torch.Tensor, halo: int, mesh: Mesh, what: str = "halo"):
    """``(x_ext, x_org)``: ``[left halo | local | right halo + 128]``, the
    extended block the JAX kernel reads (its 128-lane tail kept; nothing
    past a grid edge, which reads as zero), and the global position of its
    entry 0.  ``halo == 0`` sends no left halo (the JAX package's guard
    against slicing ``[:, -0:]``, the whole block)."""
    x_ext, lo = halo_exchange(x_loc, halo, halo + 128, mesh, what)
    return x_ext, mesh.rank * x_loc.shape[-1] - lo


def _blk(x_loc) -> torch.Tensor:
    return x_loc if x_loc.ndim == 2 else x_loc[None]


def sharded_window_spmv(win, x, dims, *, offsets, mesh: Mesh, name="sharded_window_spmv"):
    """This rank's block of ``y = A x``, A in full window form: ``win (W,
    s_loc)`` and ``x (C, s_loc)`` (or ``(s_loc,)``) the rank's blocks of a
    fine axis laid out at ``s_pad % (BLK * n) == 0``."""
    halo = halo_size(offsets)
    xb = _blk(x)
    s_loc = xb.shape[-1]
    _check_local(s_loc * mesh.size, mesh.size, halo)
    r0 = mesh.rank * s_loc
    x_ext, x_org = _halo_exchange(xb, halo, mesh, "halo_" + name)
    out = window_rows(win, x_ext, offsets, (r0, r0 + s_loc), x_org, name=name)
    return out[0] if x.ndim == 1 else out


def sharded_spmv_compact(cwin, x, dims, *, offsets, mesh: Mesh, s_pad: int, name: str,
                         plain: bool = False):
    """:func:`sharded_window_spmv` on the class-compacted table of the rank's
    rows (``compact_spmv_window(..., rows=(r0, r1))``); ``x (C, s_loc)``."""
    halo = halo_size(offsets)
    s_loc = _check_local(s_pad, mesh.size, halo)
    r0 = mesh.rank * s_loc
    x_ext, x_org = _halo_exchange(_blk(x), halo, mesh, "halo_" + name)
    out = spmv_compact_rows(cwin, x_ext, dims, offsets, s_pad, (r0, r0 + s_loc), x_org,
                            name=name, plain=plain)
    return out[0] if x.ndim == 1 else out


def _pressure_slice(pf, halo: int, mesh: Mesh):
    """This rank's block of the replicated ``pf (s_pad,)`` and up to ``halo``
    entries either side (``halo + 128`` on the right; none past the axis,
    which reads as zero), a view: ``(x_ext, x_org, r0, s_loc)``; no
    collective."""
    s_pad = pf.shape[-1]
    s_loc = _check_local(s_pad, mesh.size, halo)
    r0 = mesh.rank * s_loc
    x_org = max(0, r0 - halo)
    return pf[x_org: min(s_pad, r0 + s_loc + halo + 128)], x_org, r0, s_loc


def sharded_grad_window(g_win, pf, dims, *, offsets, mesh: Mesh, name="sharded_grad"):
    """This rank's block ``(3, s_loc)`` of [G1 p, G2 p, G3 p]: ``g_win (3,
    W, s_loc)`` the rank's block of the full G window, ``pf (s_pad,)`` the
    replicated fine-grid-embedded pressure.  Zero collectives.  On a CUDA
    tensor the window is class-compacted first (as ``grad_window`` does) and
    the compact GRAD kernel runs."""
    halo = halo_size(offsets)
    radius = round((len(offsets) ** (1 / 3) - 1) / 2)
    x_ext, x_org, r0, s_loc = _pressure_slice(pf, halo, mesh)
    if x_ext.device.type == "cpu":
        from cfd_with_cuda_tpu_torch.ops.window_stencil import _GRAD, _stencil_plain

        return _stencil_plain(_GRAD, g_win, x_ext[None], offsets, x_org, r0, s_loc)
    g_cwin = compact_g_window(g_win, dims, radius, row0=r0)[0]
    return grad_rows(g_cwin, x_ext, dims, radius, (r0, r0 + s_loc), x_org, name=name)


def sharded_grad_compact(g_cwin, pf, dims, radius, *, mesh: Mesh, name="sharded_grad",
                         plain: bool = False):
    """G on the rank's columns ``(3, K, s_loc)`` of the class-compacted
    ``G_cwin``, ``pf (s_pad,)`` replicated -> ``(3, s_loc)``; no collective."""
    from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets

    halo = halo_size(window_offsets(dims, radius))
    x_ext, x_org, r0, s_loc = _pressure_slice(pf, halo, mesh)
    return grad_rows(g_cwin, x_ext, dims, radius, (r0, r0 + s_loc), x_org, name=name,
                     plain=plain)


def sharded_div_window(gt_win, u, dims, *, offsets, mesh: Mesh, name="sharded_div_window"):
    """``(s_pad,)`` on every rank <- sum_d Gd^T u_d: ``gt_win (3, W, s_loc)``
    and ``u (3, s_loc)`` the rank's blocks; the full-window DIV mode on the
    rank's rows, then an all-gather (the JAX package's form)."""
    halo = halo_size(offsets)
    s_loc = u.shape[-1]
    _check_local(s_loc * mesh.size, mesh.size, halo)
    r0 = mesh.rank * s_loc
    u_ext, x_org = _halo_exchange(u, halo, mesh, "halo_" + name)
    y = window_rows(gt_win, u_ext, offsets, (r0, r0 + s_loc), x_org, div=True, name=name)[0]
    return all_gather(y, mesh, "gather_" + name).reshape(-1)


def sharded_div_compact(gt_cwin, u, fine_dims, coarse_dims, *, mesh: Mesh, s_pad: int,
                        name="sharded_div_compact", plain: bool = False):
    """``(NNp,)`` on every rank <- the coarse-grid divergence of the
    node-sharded ``u (3, s_loc)``: ``gt_cwin (3, W^3, q1 - q0)`` the
    columns of the compact G^T table at the rank's coarse rows ``[q0, q1)``
    (:func:`coarse_rows`).  The compact G^T kernel runs on those rows alone,
    reading the halo-extended block; the rows are all-gathered (padded to
    the largest rank's count, then cut)."""
    from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets

    halo = halo_size(window_offsets(fine_dims, 2))
    s_loc = _check_local(s_pad, mesh.size, halo)
    r0 = mesh.rank * s_loc
    q0, _ = coarse_rows(fine_dims, coarse_dims, (r0, r0 + s_loc))
    u_ext, x_org = _halo_exchange(u, halo, mesh, "halo_" + name)
    y = div_compact_rows(gt_cwin, u_ext, fine_dims, coarse_dims, q0, x_org, name=name,
                         plain=plain)
    return gather_coarse_rows(y, fine_dims, coarse_dims, s_loc, mesh, "gather_" + name)


def gather_coarse_rows(y: torch.Tensor, fine_dims, coarse_dims, s_loc: int, mesh: Mesh,
                       what: str) -> torch.Tensor:
    """``(NNp,)`` on every rank from each rank's values ``y`` at its coarse
    rows (:func:`coarse_rows` of its fine block): one all-gather, each rank's
    rows padded to the largest rank's count, then cut."""
    if not mesh.group:
        return y
    counts = _coarse_counts(tuple(fine_dims), tuple(coarse_dims), s_loc, mesh.size)
    qmax = max(max(counts), 1)
    if y.shape[0] < qmax:
        y = torch.nn.functional.pad(y, (0, qmax - y.shape[0]))
    parts = all_gather(y, mesh, what)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


@functools.lru_cache(maxsize=16)
def _coarse_counts(fine_dims, coarse_dims, s_loc: int, size: int) -> tuple:
    """Each rank's number of coarse rows."""
    return tuple(np.subtract(*coarse_rows(fine_dims, coarse_dims,
                                          (r * s_loc, (r + 1) * s_loc))[::-1])
                 for r in range(size))
