"""ctypes loader for the native host-runtime kernels (kernels.cpp).

Compiles the shared library on first use (g++ -O3, cached next to the
source) and exposes numpy-friendly wrappers.  Import raises ImportError
when no toolchain/library is available, and every caller falls back to
its pure-numpy path — the native runtime is an accelerator, not a
dependency.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "kernels.cpp"
_LIB = _HERE / "libcfd_torch_runtime.so"


def _build() -> Path:
    if _LIB.exists() and (
        not _SRC.exists() or _LIB.stat().st_mtime >= _SRC.stat().st_mtime
    ):
        return _LIB
    if not _SRC.exists():
        raise ImportError(f"native runtime source missing: {_SRC}")
    # compile to a temp name and os.replace into place: a killed build or
    # two processes building concurrently must never leave a corrupt .so
    # whose fresh mtime permanently disables the native runtime
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(
        dir=_HERE, prefix=_LIB.name + ".", suffix=".tmp.so"
    )
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    except (OSError, subprocess.CalledProcessError) as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        detail = getattr(e, "stderr", "") or str(e)
        raise ImportError(f"native runtime build failed: {detail}") from e
    return _LIB


try:
    _lib = ctypes.CDLL(str(_build()))
except ImportError:
    raise
except OSError as e:
    # e.g. a stale -march=native .so copied from another machine: callers
    # catch ImportError for the numpy fallback, so speak that language
    raise ImportError(f"native runtime unloadable: {e}") from e

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_lib.coalesce_pattern.restype = ctypes.c_int64
_lib.coalesce_pattern.argtypes = [
    _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    _i64p, _i64p, _i64p,
]
_lib.first_seen_ids.restype = ctypes.c_int64
_lib.first_seen_ids.argtypes = [_i64p, ctypes.c_int64, _i64p]


def coalesce_pattern(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                     n_cols: int):
    """Sorted CSR pattern + elemental scatter map from (row, col) pairs."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    n = rows.size
    indptr = np.empty(n_rows + 1, dtype=np.int64)
    indices = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    nnz = _lib.coalesce_pattern(rows, cols, n, n_rows, n_cols,
                                indptr, indices, inverse)
    return indptr, indices[:nnz].copy(), inverse


def first_seen_ids(keys: np.ndarray):
    """First-occurrence numbering of integer keys -> (ids, n_unique)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    ids = np.empty(keys.size, dtype=np.int64)
    n_unique = _lib.first_seen_ids(keys, keys.size, ids)
    return ids, int(n_unique)
