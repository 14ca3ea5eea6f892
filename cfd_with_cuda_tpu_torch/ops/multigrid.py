"""Geometric multigrid V-cycle preconditioner for the pressure Poisson solve.

Port of ``cfd_with_cuda_tpu/ops/multigrid.py``.  The reference
preconditions its pressure CG with Jacobi only (``blascoCodinaHuerta.cpp
:4013-4018``).  On a structured pressure grid the geometric hierarchy is
free, so the XLA structured path of both solvers builds a Galerkin (RAP)
coarse-grid ladder at setup and applies a V(nu, nu) cycle on the device:

* **Setup (host, scipy):** trilinear prolongation P per level as a kron of
  1-D stencils; ``Z_{l+1} = P^T Z_l P``.  Linear interpolation keeps every
  level's stencil within radius 2, so each level is a ``patches_spmv``
  window operator.  The coarsest level (< ~100 nodes) is inverted densely.
* **Device (torch ops):** smoothing = weighted Jacobi on the window
  stencil; restriction = one stride-2 ``conv3d`` with the fixed trilinear
  kernel; prolongation = zero-stuffing + the same stride-1 ``conv3d``
  (exactly P^T / P, so the cycle is symmetric and CG-safe); coarsest solve
  = one dense matmul with the precomputed inverse.

It serves both pressure operators (explicit ``Z = G^T Md^-1 G``, SPD with
the LARGE pin; implicit direct ``-grad.grad``, SND): smoother and coarse
inverse carry the sign.  The F32 ``conv3d`` and matmul need TF32 off, as
the solvers set it on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from cfd_with_cuda_tpu_torch.fem.structured import dia_from_csr
from cfd_with_cuda_tpu_torch.ops.stencil import coarse_to_fine, patches_spmv

__all__ = [
    "MG_KERNEL", "build_mg_hierarchy", "mg_restrict", "mg_prolong", "make_vcycle",
    "attach_hierarchy",
]

# fixed trilinear transfer kernel: w(d) = prod over axes of (1, 1/2)
_W1 = np.array([0.5, 1.0, 0.5])
MG_KERNEL = (_W1[:, None, None] * _W1[None, :, None] * _W1[None, None, :])


def _prolong_1d(n: int) -> sp.csr_matrix:
    """1-D trilinear prolongation (n fine, ceil(n/2) coarse; coarse j sits
    at fine 2j, odd fine nodes average their coarse neighbours)."""
    m = -(-n // 2)
    rows, cols, vals = [], [], []
    for j in range(m):
        rows.append(2 * j)
        cols.append(j)
        vals.append(1.0)
    for i in range(1, n, 2):
        j = (i - 1) // 2
        rows.append(i)
        cols.append(j)
        vals.append(0.5)
        if j + 1 < m:
            rows.append(i)
            cols.append(j + 1)
            vals.append(0.5)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _prolong_3d(dims) -> sp.csr_matrix:
    """P for a z-major flat grid (flat = (k*Sy + j)*Sx + i)."""
    sx, sy, sz = dims
    return sp.kron(_prolong_1d(sz), sp.kron(_prolong_1d(sy), _prolong_1d(sx))).tocsr()


def build_mg_hierarchy(Z_grid: sp.csr_matrix, dims: tuple[int, int, int], *,
                       min_size: int = 100, max_levels: int = 10, dtype=np.float32) -> dict:
    """Galerkin ladder from the grid-ordered fine operator.

    Returns ``{"wins": [(W_l^3, S_l)...], "diags": [(S_l,)...], "dims":
    [(sx, sy, sz)...], "radii": [r_l...], "omegas": [w_l...], "zinv":
    (S_last, S_last)}`` as numpy arrays.  Raises ``ValueError`` when the
    coarsening stalls far above the dense-solve scale.
    """
    wins, diags, dim_list, radii, omegas = [], [], [], [], []
    Z = Z_grid.tocsr()
    cur = dims
    for _ in range(max_levels):
        size = cur[0] * cur[1] * cur[2]
        if size <= min_size or min(cur) < 5:
            break
        op = dia_from_csr(Z, np.arange(size), np.arange(size), cur, max_radius=2)
        assert op is not None, "MG level stencil exceeded radius 2"
        wins.append(op.window_vals(op.radius, dtype))
        radii.append(op.radius)
        diag = np.asarray(Z.diagonal())
        diags.append(diag.astype(dtype))
        omegas.append(_safe_jacobi_omega(Z, diag))
        dim_list.append(cur)
        P = _prolong_3d(cur)
        Z = (P.T @ Z @ P).tocsr()
        Z.sort_indices()
        cur = tuple(-(-c // 2) for c in cur)
    dim_list.append(cur)
    size = cur[0] * cur[1] * cur[2]
    if size > 16 * min_size:
        # coarsening stalled far above the dense-solve scale (a pseudo-2D
        # slab grid like (129, 129, 3) stops at once on its thin axis with
        # the whole fine operator still in Z): a dense inverse there is
        # O(size^2) memory and O(size^3) flops
        raise ValueError(
            f"MG coarsening stalled at dims {cur} (size {size}): grid too "
            "anisotropic/thin for isotropic 2x coarsening; use the Jacobi "
            "preconditioner for this mesh"
        )
    zinv = np.linalg.inv(Z.toarray()).astype(dtype)
    return {"wins": wins, "diags": diags, "dims": dim_list, "radii": radii,
            "omegas": omegas, "zinv": zinv}


def _safe_jacobi_omega(Z: sp.csr_matrix, diag: np.ndarray, iters: int = 25,
                       seed: int = 7) -> float:
    """Per-level smoother weight omega = 1.2 / rho(D^-1 Z), rho estimated by
    power iteration on the host (~25 SpMVs, the JAX package's seed, so the
    weights are its own bit for bit).  A fixed omega is not safe: on
    sinh-clustered cavity grids rho(D^-1 Z) rises past 2.3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(Z.shape[0])
    dinv = 1.0 / diag
    lam = 1.0
    for _ in range(iters):
        v = dinv * (Z @ v)
        lam = np.linalg.norm(v)
        v /= max(lam, 1e-30)
    return float(1.2 / max(abs(lam), 1e-30))


@functools.lru_cache(maxsize=8)
def _kernel(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(MG_KERNEL, dtype=dtype, device=device).reshape(1, 1, 3, 3, 3)


def _conv3(x: torch.Tensor, dims, stride: int) -> torch.Tensor:
    """3-D convolution of the flat field ``x (S,)`` with the fixed trilinear
    kernel, padding 1."""
    sx, sy, sz = dims
    y = torch.nn.functional.conv3d(x.reshape(1, 1, sz, sy, sx), _kernel(x.dtype, x.device),
                                   stride=stride, padding=1)
    return y.reshape(-1)


def mg_restrict(r: torch.Tensor, fine_dims) -> torch.Tensor:
    """P^T r: the stride-2 trilinear convolution (out dims ceil(fine / 2))."""
    return _conv3(r, fine_dims, 2)


def mg_prolong(xc: torch.Tensor, coarse_dims, fine_dims) -> torch.Tensor:
    """P xc: the coarse field zero-stuffed at the even fine positions
    (``coarse_to_fine``), then the stride-1 trilinear convolution fills the
    nodes between."""
    return _conv3(coarse_to_fine(xc, coarse_dims, fine_dims), fine_dims, 1)


def make_vcycle(params: dict, dims: list, radii: list, omegas: list | None = None, *,
                nu: int = 2, omega: float = 0.6, prefix: str = "mg"):
    """V(nu, nu)-cycle closure over the device tables ``{prefix}_win_l``,
    ``{prefix}_diag_l`` and ``{prefix}_zinv``; usable as a CG ``precond``.
    Symmetric (equal pre and post Jacobi sweeps with one weight per level).
    Pass the hierarchy's ``omegas``: the scalar ``omega`` is safe only on
    mildly stretched grids."""
    n_ops = len(dims) - 1        # number of stencil levels

    def apply_z(lvl, x):
        return patches_spmv(params[f"{prefix}_win_{lvl}"], x, dims[lvl], radii[lvl])

    def diag(lvl):
        return params[f"{prefix}_diag_{lvl}"]

    def om(lvl):
        return omegas[lvl] if omegas is not None else omega

    def vc(lvl, b):
        if lvl == n_ops:
            return params[f"{prefix}_zinv"] @ b
        # pre-smooth from x = 0: the first sweep collapses to omega D^-1 b
        x = om(lvl) * b / diag(lvl)
        for _ in range(nu - 1):
            x = x + om(lvl) * (b - apply_z(lvl, x)) / diag(lvl)
        r = b - apply_z(lvl, x)
        xc = vc(lvl + 1, mg_restrict(r, dims[lvl]))
        x = x + mg_prolong(xc, dims[lvl + 1], dims[lvl])
        for _ in range(nu):
            x = x + om(lvl) * (b - apply_z(lvl, x)) / diag(lvl)
        return x

    return lambda r: vc(0, r)


def attach_hierarchy(solver, d: dict, Z_grid: sp.csr_matrix, dims, dtype) -> bool:
    """Build the Galerkin hierarchy of the pinned, grid-ordered Z and attach
    it: the level tables join ``d`` (``mg_win_l``, ``mg_diag_l``,
    ``mg_zinv``), ``solver.mg_dims`` / ``mg_radii`` / ``mg_omegas`` are set
    and ``solver.use_mg`` turns on.  When the coarsening stalls, False
    (nothing attached: the Jacobi preconditioner) under
    ``pressure_precond="auto"``, and the ``ValueError`` itself under an
    explicit ``"mg"``, as the JAX package decides."""
    try:
        mg = build_mg_hierarchy(Z_grid, dims, dtype=dtype)
    except ValueError:
        if solver.config.pressure_precond == "mg":
            raise
        return False
    solver.mg_dims = mg["dims"]
    solver.mg_radii = mg["radii"]
    solver.mg_omegas = mg["omegas"]
    for lvl, (w, dg) in enumerate(zip(mg["wins"], mg["diags"])):
        d[f"mg_win_{lvl}"] = w
        d[f"mg_diag_{lvl}"] = dg
    d["mg_zinv"] = mg["zinv"]
    solver.use_mg = True
    return True
