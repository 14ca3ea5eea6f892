"""The work a step needs, counted from the deck's connectivity, and the
chip's peaks: what the roofline metrics divide by.

Nonzeros are structural: two nodes couple when some element holds both
(the velocity operators K and K + A(u)), a velocity node couples to the
pressure nodes of its elements (G, and G^T), and the pressure operator of
the explicit step, Z = G^T Md^-1 G, couples two pressure nodes when some
velocity node couples to both.  Each nonzero is read once at
the configuration's precision and each input and output vector once,
whatever an implementation reads again or pads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PEAKS", "OperatorCounts", "operator_counts", "pressure_nnz", "cg_iteration_bytes",
           "stencil_step_bytes"]

# NVIDIA H100 SXM (80 GB HBM3) data sheet, at its 700 W limit: every roofline
# here is bandwidth-bound (a sparse product does 2 flops a 4-byte weight)
PEAKS = {"hbm_bytes_per_s": 3.35e12}


class OperatorCounts(NamedTuple):
    nn: int         # velocity nodes
    nnp: int        # pressure nodes
    nnz_k: int      # velocity operator (K, K + A) nonzeros, per component
    nnz_g: int      # one direction's G nonzeros
    nnz_z: int      # the pressure operator's nonzeros


def _incidence(ltog: np.ndarray, n: int, device) -> torch.Tensor:
    """(n x E) CSR incidence of the nodes ``ltog (E, m)``."""
    e, m = ltog.shape
    rows = torch.as_tensor(ltog.reshape(-1), device=device)
    cols = torch.arange(e, device=device).repeat_interleave(m)
    vals = torch.ones(e * m, dtype=torch.float32, device=device)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, e))
    return coo.coalesce().to_sparse_csr()


def _nnz(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(torch.sparse.mm(a, b)._nnz())


def _transpose(a: torch.Tensor) -> torch.Tensor:
    return a.to_sparse_coo().t().coalesce().to_sparse_csr()


def pressure_nnz(conn: np.ndarray, nnp: int, device="cpu") -> int:
    """Structural nonzeros of G^T Md^-1 G on the corner mesh ``conn (E, 8)``:
    pressure nodes of two elements that share a corner."""
    inc = _incidence(np.asarray(conn, np.int64), nnp, device)
    s = torch.sparse.mm(inc, _transpose(inc))
    return _nnz(s, s)


def operator_counts(ltog: np.ndarray, nn: int, conn: np.ndarray, nnp: int,
                    device="cpu") -> OperatorCounts:
    """The counts of a 27-node mesh ``ltog (E, 27)`` with corner mesh ``conn``."""
    with torch.no_grad():
        inc_v = _incidence(np.asarray(ltog, np.int64), nn, device)
        inc_p = _incidence(np.asarray(conn, np.int64), nnp, device)
        inc_pt = _transpose(inc_p)
        nnz_k = _nnz(inc_v, _transpose(inc_v))
        nnz_g = _nnz(inc_v, inc_pt)
        del inc_v
        return OperatorCounts(nn, nnp, nnz_k, nnz_g, pressure_nnz(conn, nnp, device))


def cg_iteration_bytes(c: OperatorCounts, word: int) -> int:
    """Bytes one Jacobi-PCG iteration must move: the operator's nonzeros
    read once; p, x, r and the inverse diagonal read, x, r and p written."""
    return word * (c.nnz_z + 7 * c.nnp)


def stencil_step_bytes(c: OperatorCounts, word: int, iters: int) -> int:
    """Bytes of an explicit step's structured operator products: a velocity
    operator on the three components (nonzeros, 3 NN in, 3 NN out), G (3
    directions' nonzeros, NNp in, 3 NN out), G^T (the same nonzeros, 3 NN
    in, NNp out).  G pn, then each of the ``iters`` sub-iterations
    (K + A) u*, G^T, G pdot, and K acc on all but the last."""
    vel = c.nnz_k + 6 * c.nn
    grad = 3 * c.nnz_g + c.nnp + 3 * c.nn
    return word * (grad + iters * (vel + 2 * grad) + max(iters - 1, 0) * vel)
