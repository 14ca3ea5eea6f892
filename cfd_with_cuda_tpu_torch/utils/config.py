"""Solver configuration: the same fields and defaults as the JAX package.

Port of ``cfd_with_cuda_tpu/utils/config.py``.  The dataclass keeps every
field so one configuration reads the same in both packages.  Where a value
is invalid for a mesh the solvers raise the JAX package's own
``ValueError``; ``momentum_solver="gmres"``, with which the JAX package's
implicit step fails on every path, raises a ``ValueError`` naming that
defect; ``spmd_devices >= 1`` on the kernel path runs the sharded path of
``parallel/`` over the ranks of a ``torch.distributed`` group (raising
without a group of that many ranks).
``setup_cache`` runs: ``"auto"`` caches the host setup under
``$CFD_TORCH_CACHE_DIR`` or ``<repo>/.cache/setup_torch``
(``utils/setup_cache.py``), a path caches it there, None / ``"off"`` not at
all.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

__all__ = ["DTypePolicy", "SolverConfig"]


class DTypePolicy(str, enum.Enum):
    """Precision policy (supersedes the reference's ``-DSINGLE``).

    * ``F64``   — double everywhere (reference parity).
    * ``F32``   — single everywhere (speed mode).
    * ``MIXED`` — f32 state/operators, f64 Krylov reductions.
    """

    F64 = "f64"
    F32 = "f32"
    MIXED = "mixed"

    @property
    def state_dtype(self):
        return np.float64 if self is DTypePolicy.F64 else np.float32


@dataclasses.dataclass
class SolverConfig:
    """Runtime knobs common to all solvers (field docs: the JAX package)."""

    dtype_policy: DTypePolicy = DTypePolicy.F64
    pressure_cg_tol: float = 1e-12
    pressure_cg_maxiter: int = 1000
    momentum_tol: float = 1e-6
    momentum_abs_tol: float = 1e-15
    momentum_maxiter: int = 1000
    pressure_pin_large: float = 1000.0
    momentum_solver: str = "bicgstab"
    pressure_solver: str = "cg"
    gmres_restart: int = 100
    pressure_precond: str = "auto"
    pressure_backend: str = "auto"
    pressure_cg_sym: bool = False
    pressure_cg_fuse_loop: bool = False
    pressure_warm_start: bool = False
    pressure_warm_extrap: bool = False
    implicit_warm_start: bool = True
    conv_mode: str = "auto"
    conv_stab: float = 0.0
    pressure_cg_unroll: int = 4
    structured: str = "auto"
    structured_layout: str = "auto"
    spmd_devices: int = 0
    steps_per_chunk: int = 10
    shard_pad: int = 1
    setup_cache: str | None = None
    verbose: bool = False

    def setup_cache_dir(self) -> str | None:
        """The setup cache's directory, or None when caching is off."""
        if self.setup_cache == "auto":
            from cfd_with_cuda_tpu_torch.utils.setup_cache import default_cache_dir

            return default_cache_dir()
        if self.setup_cache in (None, "", "off", "none", "0"):
            # "off" / "none" read as intent to disable, not as a directory
            return None
        return self.setup_cache

    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype_policy is DTypePolicy.F64 else torch.float32

    def np_dtype(self):
        return self.dtype_policy.state_dtype

    def krylov_dot_dtype(self):
        """f64 accumulation dtype for Krylov inner products under the
        MIXED policy (f32 state + f64 reductions); None otherwise."""
        return torch.float64 if self.dtype_policy is DTypePolicy.MIXED else None
