"""Krylov solver results (port of ``KrylovResult`` from
``cfd_with_cuda_tpu/ops/krylov.py``; the solver suite itself is not yet
ported — ``ROADMAP.md`` queue 1 item 6)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["KrylovResult"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor       # iterations actually performed (0-d int32)
    residual: torch.Tensor    # final ||r|| (0-d)
