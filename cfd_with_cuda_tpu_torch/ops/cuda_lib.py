"""Build, load and count the port's CUDA kernels.

Each source in ``cfd_with_cuda_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The libraries are built at first use into ``_build/`` next to
the package, named by a hash of the source, the headers (``csrc/*.cuh``)
and the flags so an edited source or header never loads a stale library;
all sources compile in parallel, one ``nvcc`` each.

Every wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts", "nvcc_path", "build_all",
    "function", "check", "stream_ptr", "ptr",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("parity_apply", "div_compact", "cg_solve", "cg_iter", "window_stencil")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launch-count names: one per kernel launch form on the main paths
# (the window SPMV once per operator the solvers apply with it; the parity
# apply per operator shape and field form, "_streamed" where the field is
# staged through shared memory).
# "comp_dot" counts every launch whose reductions are the compensated dot
# (comp_dot_f32 alone, or cg_init / cg_iter / cg_solve in that mode) and
# "sym_apply" every launch that applies the symmetric half window
# (window_apply_sym alone, or a CG kernel in that mode), beside the
# launch's own name.
KERNELS = (
    "parity_apply_k", "parity_apply_g", "parity_apply_k_plus_a",
    "parity_apply_k_streamed", "parity_apply_g_streamed", "parity_apply_k_plus_a_streamed",
    "parity_window_apply",
    "div_compact", "cg_solve", "cg_init", "cg_iter", "comp_dot", "sym_apply",
    "window_spmv", "window_spmv_k", "window_spmv_k_plus_a", "window_spmv_mk_plus_a",
    "window_spmv_m", "grad_window", "div_window", "div_compact_interleaved",
    # the sharded path's launches on a rank's rows (parallel/sharded_stencil.py): the
    # solvers' compact SPMV by operator, G, the compact G^T; the JAX package's
    # full-window forms
    "sharded_spmv_k", "sharded_spmv_k_plus_a", "sharded_spmv_mk_plus_a", "sharded_spmv_m",
    "sharded_grad", "sharded_div_compact", "sharded_window_spmv", "sharded_div_window",
)
launch_counts: dict[str, int] = {k: 0 for k in KERNELS}

# the C interface of csrc/: entry point -> (source, argument types); every
# entry point returns an int (a cudaError_t for the launchers)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "parity_apply_f32": ("parity_apply", [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P]),
    "parity_apply_streamed_f32": ("parity_apply", [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I,
                                                   _I, _P, _I, _I, _I, _P, _I, _I, _P]),
    "div_compact_f32": ("div_compact", [_P, _I, _P, _P, _P, _I, _P]),
    "div_compact_interleaved_f32": ("div_compact", [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                                                    _I, _I, _P]),
    "cg_solve_f32": ("cg_solve", [_P, _P, _I] + [_P] * 5 + [_I, _P, _P, _P, _I, _I, _D, _I,
                                                              _I, _P, _I, _I, _P]),
    "cg_solve_max_blocks": ("cg_solve", []),
    "cg_solve_plan": ("cg_solve", [_I] * 6 + [_P]),
    "cg_init_f32": ("cg_iter", [_P, _P, _I] + [_P] * 5 + [_I, _P, _P] + [_I] * 3
                    + [_P, _I, _I, _P]),
    "cg_iter_f32": ("cg_iter", [_P, _P, _I, _P, _P, _P, _I, _P, _P] + [_I] * 4
                    + [_P, _I, _I, _P]),
    "cg_iter_max_blocks": ("cg_iter", []),
    "cg_iter_plan": ("cg_iter", [_I] * 6 + [_P]),
    "comp_dot_f32": ("cg_iter", [_P, _P, _P, _P, _I, _P]),
    "window_apply_sym_f32": ("cg_iter", [_P, _P, _I, _P, _P, _I, _P]),
    "window_stencil_f32": ("window_stencil", [_I, _P, _P, _I, _P, _I, _P, _I, _P]),
    "window_stencil_f64": ("window_stencil", [_I, _P, _P, _I, _P, _I, _P, _I, _P]),
    "grad_compact_f32": ("window_stencil", [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "grad_compact_f64": ("window_stencil", [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "spmv_compact_f32": ("window_stencil", [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P]),
    "spmv_compact_f64": ("window_stencil", [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P]),
    # the rank-rows forms of the sharded path: rows and field apart
    "window_stencil_rows_f32": ("window_stencil", [_I, _P, _P, _I, _P, _I, _P] + [_I] * 4 + [_P]),
    "window_stencil_rows_f64": ("window_stencil", [_I, _P, _P, _I, _P, _I, _P] + [_I] * 4 + [_P]),
    "grad_compact_rows_f32": ("window_stencil", [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P]),
    "grad_compact_rows_f64": ("window_stencil", [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P]),
    "spmv_compact_rows_f32": ("window_stencil", [_P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 6
                              + [_P]),
    "spmv_compact_rows_f64": ("window_stencil", [_P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 6
                              + [_P]),
    "div_compact_interleaved_rows_f32": ("div_compact", [_P, _I, _P, _I, _P, _P] + [_I] * 8
                                         + [_P]),
}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns each build's compiler output (``-Xptxas -v``
    in ``extra_flags`` makes it report registers and spills).  Raises with
    the compiler's message when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists() and not extra_flags:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def function(name: str):
    """The C entry point ``name`` with its argument types declared."""
    if name not in _fns:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(_library(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return _fns[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
