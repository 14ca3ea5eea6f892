"""Host-CSR linear-system frontend: device Krylov or direct solve.

Port of ``cfd_with_cuda_tpu/ops/linsolve.py``.  The legacy solvers
(monolithic GLS / Stokes, segregated) assemble scipy CSR matrices on the
host each outer iteration, as the reference does, then pick a backend at
run time.  :func:`solve_csr` is the one entry point:

* a Krylov method of ``ops.krylov`` on the padded ELL pack of the matrix
  on the device (torch gathers, ``ops.spmv.ell_spmv``), Jacobi
  preconditioned (a zero diagonal becomes 1) — the CUSP / MKL-RCI /
  Paralution role;
* BiCG with its true ``A^T`` apply, an ELL pack of ``A.T`` (the
  reference's ``cusp::krylov::bicg`` uses the transpose internally,
  ``oldFiles/segregatedSolver/CUSP_BiCG.cu:60``);
* ``"splu"``: the host scipy sparse LU (the stand-in for the reference's
  MKL PARDISO backend, ``oldFiles/pardisoSolver.cpp:1-94``);
* ``"dense_lu"``: a dense LU factor on the device (``torch.linalg.
  lu_factor_ex``, in the matrix's dtype) with f64 iterative refinement
  against the host CSR — the reference's direct solves at the scale it
  used them (PARDISO on the NE1000 monolithic system, dense Gauss
  elimination in ``oldFiles/Stokes3D.cpp:1674``).

The solves run in the dtype of the host arrays (float64), as the JAX
package computes under x64.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg.splu)
import torch

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.fem.sparse import ell_from_csr
from cfd_with_cuda_tpu_torch.ops.krylov import solver_by_name
from cfd_with_cuda_tpu_torch.ops.spmv import ell_spmv

__all__ = ["solve_csr", "HOST_DIRECT_SOLVERS", "DIRECT_SOLVERS", "DENSE_DIRECT_LIMIT"]

HOST_DIRECT_SOLVERS = ("splu",)
DIRECT_SOLVERS = ("splu", "dense_lu")

# dense_lu refuses above this row count: an n x n factor is 8 n^2 bytes in
# f64 (20k -> 3.0 GiB) and O(n^3) flops, past the point where the Krylov
# suite wins
DENSE_DIRECT_LIMIT = 20_000

_SINGULAR = ("dense_lu: non-finite solution — matrix is singular or "
             "numerically rank-deficient (missing pressure pin?)")


def _dense_lu_solve(A: sp.csr_matrix, b: np.ndarray, *, tol: float, device,
                    max_refine: int = 12) -> tuple[np.ndarray, int]:
    """Dense LU on the device with f64 iterative refinement.

    The factor and the triangular solves run on ``device`` in ``A``'s
    dtype; each refinement round computes r = b - A x in f64 with the host
    CSR and solves for the correction against the same factor.  Returns
    (x, rounds), rounds counting triangular-solve passes.  A zero pivot
    (the factor's ``info``) or a non-finite x raises ``LinAlgError``."""
    n = A.shape[0]
    if n > DENSE_DIRECT_LIMIT:
        raise ValueError(
            f"dense_lu: n={n} exceeds DENSE_DIRECT_LIMIT={DENSE_DIRECT_LIMIT} "
            f"(dense factor alone is {A.dtype.itemsize * n * n / 2**30:.1f} GiB); "
            "use name='splu' (host) or a Krylov method"
        )
    coo = A.tocoo()
    coo.sum_duplicates()
    dense = torch.zeros((n, n), dtype=torch.from_numpy(coo.data).dtype, device=device)
    dense[torch.from_numpy(coo.row.astype(np.int64)).to(device),
          torch.from_numpy(coo.col.astype(np.int64)).to(device)] = (
        torch.from_numpy(coo.data).to(device))
    lu, piv, info = torch.linalg.lu_factor_ex(dense)
    del dense
    if int(info) != 0:
        raise np.linalg.LinAlgError(_SINGULAR)

    bf = np.asarray(b, dtype=np.float64)
    bnorm = float(np.linalg.norm(bf)) or 1.0
    x = np.zeros(n, dtype=np.float64)
    r = bf.copy()
    rounds = 0
    for _ in range(max_refine + 1):
        rd = torch.from_numpy(r).to(device=device, dtype=lu.dtype)
        x += torch.linalg.lu_solve(lu, piv, rd[:, None])[:, 0].double().cpu().numpy()
        rounds += 1
        if not np.isfinite(x).all():
            raise np.linalg.LinAlgError(_SINGULAR)
        r = bf - A @ x
        if float(np.linalg.norm(r)) <= tol * bnorm:
            break
    return x, rounds


def _ell_pack(A: sp.csr_matrix, cache: dict | None, key: str, device):
    """(cols, vals) device tensors of A in slot-major ELL.

    With a caller-owned ``cache`` dict the pattern pack and the cols upload
    happen once per sparsity pattern; a later call on the same pattern
    uploads only the values (``EllMatrix.with_values``)."""
    if cache is not None:
        ent = cache.get(key)
        if (
            ent is not None
            and ent["shape"] == A.shape
            and np.array_equal(ent["indptr"], A.indptr)
            and np.array_equal(ent["indices"], A.indices)
        ):
            return ent["cols_dev"], torch.from_numpy(ent["ell"].with_values(A.data)).to(device)
    ell = ell_from_csr(
        A.indptr.astype(np.int64), A.indices.astype(np.int64), A.data,
        n_cols=A.shape[1],
    )
    # int64 on the device: the gathers take it as is (no widening per call)
    cols_dev = torch.from_numpy(ell.cols.astype(np.int64)).to(device)
    if cache is not None:
        cache[key] = dict(
            shape=A.shape, indptr=A.indptr.copy(),
            indices=A.indices.copy(), ell=ell, cols_dev=cols_dev,
        )
    return cols_dev, torch.from_numpy(ell.vals).to(device)


def solve_csr(
    A: sp.csr_matrix,
    b: np.ndarray,
    name: str = "cg",
    *,
    tol: float = 1e-10,
    maxiter: int = 1000,
    gmres_restart: int = 100,
    cache: dict | None = None,
    device=None,
) -> tuple[np.ndarray, int]:
    """Solve A x = b; returns (x numpy, iterations; 1 for splu, the
    refinement rounds for dense_lu).

    ``name``: any ``ops.krylov`` method (cg/cr/bicg/bicgstab/gmres, on
    ``device`` with Jacobi preconditioning; ``gmres_restart`` goes to GMRES
    only), ``"splu"`` (host scipy LU) or ``"dense_lu"`` (a dense device LU
    with f64 iterative refinement; up to ``DENSE_DIRECT_LIMIT`` rows).

    ``cache``: a caller-owned dict for outer loops that re-solve on the same
    sparsity pattern with fresh values every iteration (Picard, segregated);
    entries are keyed by shape and nnz, so one dict serves the systems an
    outer loop alternates between.  ``device=None`` is the CUDA card (raises
    without one); ``"cpu"`` runs on the CPU."""
    if name == "splu":
        lu = sp.linalg.splu(A.tocsc())
        return lu.solve(np.asarray(b, dtype=np.float64)), 1
    device = resolve_device(device)
    if name == "dense_lu":
        return _dense_lu_solve(A, b, tol=tol, device=device)

    diag = np.asarray(A.diagonal())
    diag = np.where(diag == 0.0, 1.0, diag)
    akey = f"A:{A.shape[0]}x{A.shape[1]}:{A.nnz}"
    cols, vals = _ell_pack(A, cache, akey, device)
    kwargs: dict = dict(tol=float(tol), maxiter=int(maxiter))
    if name == "gmres":
        kwargs["restart"] = int(gmres_restart)
    if name == "bicg":
        # the true transpose apply, see the module docstring
        rcols, rvals = _ell_pack(A.T.tocsr(), cache, "t" + akey, device)
        kwargs["rmatvec"] = lambda x: ell_spmv(rvals, rcols, x)
    diag_dev = torch.from_numpy(diag).to(device)
    res = solver_by_name(name)(
        lambda x: ell_spmv(vals, cols, x), torch.from_numpy(np.ascontiguousarray(b)).to(device),
        precond=lambda r: r / diag_dev, **kwargs,
    )
    return res.x.cpu().numpy(), int(res.iters)
