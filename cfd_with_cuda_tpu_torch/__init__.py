"""cfd_with_cuda_tpu_torch — the PyTorch/CUDA port of ``cfd_with_cuda_tpu``.

The JAX package beside it is the reference.  This package imports torch,
numpy and scipy, never jax and nothing of ``cfd_with_cuda_tpu``.  Host
setup (deck, mesh, FEM operators, parity tables) is numpy; the per-step
path is torch on the CUDA card, with every TPU kernel of the path
replaced by a hand-written Hopper kernel (``csrc/``).  Each kernel has a
plain PyTorch version beside it, which runs on CPU tensors.

Ported so far: the explicit BCH solver (``solvers/explicit_bch.py``,
``ExplicitBCHSolver(deck, config).run(...)``) and the implicit
Guermond-Quartapelle solver (``solvers/implicit_gq.py``,
``ImplicitGQSolver(deck, config).run(...)``), on every layout of the JAX
package (parity, interleaved, the XLA structured path, ELL) in F32, MIXED
and F64.
"""

__version__ = "0.1.0"

from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig  # noqa: F401
