"""Banded-window form of an unstructured pressure operator.

Port of ``cfd_with_cuda_tpu/ops/banded.py``.  When a deck numbers its
corner (pressure) nodes in a generator's or converter's scan order, the
column offsets ``col - row`` of the assembled Z take a bounded set of
distinct values, and Z is a sparse-DIA ("banded window") matrix: a weight
table ``win (D, N)`` with ``win[k, r] = Z[r, r + offs[k]]``, applied by D
shifted contiguous reads.  The pressure CG kernels (``ops/fused_cg.py``
with ``offs=``) take that table as they take a box grid's window.  When the
numbering is scattered, :func:`rcm_permutation` may restore a band; when
even that exceeds the caps, the solvers keep the ELL path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["banded_from_csr", "rcm_permutation", "banded_spmv"]


def banded_from_csr(A, *, max_offsets: int = 512, max_halo: int | None = None):
    """(offs tuple, win (D, N) ndarray) from a square scipy sparse matrix,
    or None when the numbering is not bounded-banded.

    ``win[k, r] = A[r, r + offs[k]]`` (zero where absent): out-of-range
    reads always meet a zero weight.  ``max_offsets`` caps the distinct
    offset count D; ``max_halo`` caps ``max|offs|`` (default 4N, in effect
    no cap for a square operator)."""
    coo = A.tocoo()
    n = coo.shape[0]
    assert coo.shape[0] == coo.shape[1], coo.shape
    d = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offs = np.unique(d)
    if len(offs) > max_offsets:
        return None
    halo_cap = max_halo if max_halo is not None else 4 * n
    if len(offs) and max(abs(int(offs[0])), abs(int(offs[-1]))) > halo_cap:
        return None
    slot = np.searchsorted(offs, d)
    win = np.zeros((len(offs), n), dtype=coo.data.dtype)
    # duplicate (row, col) entries accumulate, as CSR sums duplicates
    np.add.at(win, (slot, coo.row), coo.data)
    return tuple(int(o) for o in offs), win


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a symmetric-pattern sparse matrix,
    ``perm[new] = old``: build ``A[perm][:, perm]`` and retry
    :func:`banded_from_csr` when the deck's own numbering is not banded."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(csr_matrix(A), symmetric_mode=True))


def banded_spmv(win: torch.Tensor, offs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through shifted contiguous reads, ``win (D, N)``, ``x (N,)``
    or ``(C, N)``.  The JAX package's ``banded_spmv_xla`` reads with
    ``jnp.roll``, which wraps; the wrapped reads meet zero weights, so the
    zero-filled shift here gives the same sums in the same slot order."""
    n = x.shape[-1]
    halo = max(max(abs(int(o)) for o in offs), 1)
    x_ext = F.pad(x, (halo, halo))
    acc = 0.0
    for k, o in enumerate(offs):
        acc = acc + win[k] * x_ext[..., halo + o: halo + o + n]
    return acc
