"""Window-stencil host tables and the compact divergence kernel's wrapper.

Port of the parts of ``cfd_with_cuda_tpu/ops/pallas_stencil.py`` that the
explicit parity path runs: ``window_offsets``, ``div_class_pairs``,
``compact_gt_window`` (host, setup time) and the compact G^T apply
(``div_compact_call``), whose CUDA kernel is ``csrc/div_compact.cu``.

Layout contract (as in the JAX package): a window table ``win (W^3, S)``
holds per-row weights in z-major window-scan order, ``y[s] = sum_w
win[w, s] * x[s + off(w)]``; field reads outside the grid are zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cfd_with_cuda_tpu_torch.ops import cuda_lib

__all__ = [
    "BLK", "window_offsets", "div_class_pairs", "compact_gt_window",
    "div_compact", "div_compact_plain",
]

# Class-size padding of the parity layout (Sp = round_up(cx*cy*cz, BLK)),
# kept from the JAX layout so both packages' arrays compare element-wise.
BLK = 2048


def window_offsets(dims, radius: int) -> tuple[int, ...]:
    """Flat offsets in window-channel order (z-major window scan)."""
    return _window_offsets(tuple(int(v) for v in dims), int(radius))


@functools.lru_cache(maxsize=64)
def _window_offsets(dims, radius):
    sx, sy, _ = dims
    return tuple(
        dz * sx * sy + dy * sx + dx
        for dz in range(-radius, radius + 1)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    )


def div_class_pairs(coarse_dims, radius: int = 2):
    """(class_index, coarse flat offset) per fine window slot, in the
    z-major window-scan order of ``window_offsets`` (radius 2)."""
    return _div_class_pairs(tuple(int(v) for v in coarse_dims), int(radius))


@functools.lru_cache(maxsize=64)
def _div_class_pairs(coarse_dims, radius):
    cx, cy, _ = coarse_dims
    pairs = []
    for dz in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                p = ((dx % 2), (dy % 2), (dz % 2))
                q = ((dx - p[0]) // 2, (dy - p[1]) // 2, (dz - p[2]) // 2)
                pidx = (p[2] * 2 + p[1]) * 2 + p[0]
                pairs.append((pidx, (q[2] * cy + q[1]) * cx + q[0]))
    return tuple(pairs)


def compact_gt_window(gt_win: np.ndarray, fine_dims, coarse_dims) -> np.ndarray:
    """(3, W^3, S_c_pad) <- fine G^T window sampled at the embedded coarse
    rows (host, setup time): divergence rows exist only at the coarse
    positions, so 7/8 of the fine table is structurally zero."""
    fx, fy, _ = fine_dims
    cx, cy, cz = coarse_dims
    qx, qy, qz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    emb = ((2 * qz * fy + 2 * qy) * fx + 2 * qx).ravel(order="F")
    out = gt_win[..., emb]
    s_c = cx * cy * cz
    s_pad = -(-s_c // BLK) * BLK
    return np.pad(out, ((0, 0), (0, 0), (0, s_pad - s_c)))


def div_compact_plain(gt_cwin: torch.Tensor, up: torch.Tensor, pairs) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y[q] = sum_s sum_d
    gt_cwin[d, s, q] * up[d, cls_s, q + off_s]`` (zero outside [0, Sp)),
    slots in order, the 3 directions summed per slot first."""
    sp = up.shape[-1]
    halo = max(abs(o) for _, o in pairs)
    u_ext = F.pad(up, (halo, halo))
    acc = torch.zeros(sp, dtype=up.dtype, device=up.device)
    for s, (cls, off) in enumerate(pairs):
        xs = u_ext[:, cls, halo + off: halo + off + sp]
        acc = acc + (gt_cwin[:, s] * xs).sum(0)
    return acc


@functools.lru_cache(maxsize=16)
def _pairs_table(pairs, device: torch.device) -> torch.Tensor:
    return torch.tensor(pairs, dtype=torch.int32, device=device).reshape(-1)


def div_compact(gt_cwin: torch.Tensor, up: torch.Tensor, pairs) -> torch.Tensor:
    """Compact G^T apply: ``gt_cwin (3, W^3, Sp)``, class-split velocity
    ``up (3, 8, Sp)`` -> ``(Sp,)``.  A CPU tensor runs the plain version; a
    CUDA tensor launches ``csrc/div_compact.cu``."""
    if up.device.type == "cpu":
        return div_compact_plain(gt_cwin, up, pairs)
    if up.device.type != "cuda":
        raise ValueError(f"div_compact: unsupported device {up.device}")
    nw = len(pairs)
    sp = up.shape[-1]
    if up.shape != (3, 8, sp) or gt_cwin.shape != (3, nw, sp):
        raise ValueError(f"div_compact: shapes {tuple(gt_cwin.shape)}, {tuple(up.shape)}")
    if up.dtype != torch.float32 or gt_cwin.dtype != up.dtype:
        raise ValueError(f"div_compact: dtypes {gt_cwin.dtype}, {up.dtype}")
    if gt_cwin.device != up.device:
        raise ValueError("div_compact: operands on different devices")
    if not (up.is_contiguous() and gt_cwin.is_contiguous()):
        raise ValueError("div_compact: operands must be contiguous")
    y = torch.empty(sp, dtype=up.dtype, device=up.device)
    tab = _pairs_table(tuple(pairs), up.device)
    err = cuda_lib.function("div_compact_f32")(cuda_lib.ptr(gt_cwin), nw, cuda_lib.ptr(up), cuda_lib.ptr(tab),
             cuda_lib.ptr(y), sp, cuda_lib.stream_ptr(up.device))
    cuda_lib.check(err, "div_compact")
    cuda_lib.launch_counts["div_compact"] += 1
    return y
