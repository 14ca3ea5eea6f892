"""Sparse-operator setup: CSR patterns and elemental scatter maps (host).

Port of ``cfd_with_cuda_tpu/fem/sparse.py`` (the reference's L3 layer,
``setupSparseM``/``setupSparseG`` at
``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:1675-2159``): patterns
are coalesced on the host once, and each elemental entry (e, i, j) gets a
precomputed scatter slot into the NNZ value array (the reference's
``sparseMapM``/``sparseMapG``, :1860-1905).  Operators of the
unstructured path are stored as padded slot-major ELL (:func:`ell_from_csr`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

__all__ = ["CsrPattern", "EllMatrix", "build_csr_pattern", "ell_pad_width", "ell_from_csr"]


@dataclass(frozen=True)
class CsrPattern:
    """CSR sparsity pattern + elemental scatter map.

    * ``indptr (n_rows+1,)``, ``indices (nnz,)`` — standard CSR pattern
      with sorted column indices per row.
    * ``scatter (NE, a, b)`` — flat NNZ slot of elemental entry (e, i, j)
      (rows from ``row_conn[e, i]``, cols from ``col_conn[e, j]``).
    """

    n_rows: int
    n_cols: int
    indptr: np.ndarray
    indices: np.ndarray
    scatter: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def to_scipy(self, values: np.ndarray) -> sp.csr_matrix:
        return sp.csr_matrix(
            (values, self.indices, self.indptr), shape=(self.n_rows, self.n_cols)
        )

    def assemble(self, elemental: np.ndarray) -> np.ndarray:
        """Host-side scatter-add of elemental (NE, a, b) into NNZ values."""
        return np.bincount(
            self.scatter.ravel(), weights=elemental.ravel(), minlength=self.nnz
        )


def build_csr_pattern(
    row_conn: np.ndarray, col_conn: np.ndarray, n_rows: int, n_cols: int
) -> CsrPattern:
    """Pattern of sum_e scatter(row_conn[e] x col_conn[e]) + scatter map.

    Mirrors ``setupSparseM`` (square, row_conn == col_conn == LtoGnode) and
    ``setupSparseG`` (rows velocity nodes, cols pressure corner nodes).
    """
    row_conn = np.asarray(row_conn, dtype=np.int64)
    col_conn = np.asarray(col_conn, dtype=np.int64)
    ne, a = row_conn.shape
    b = col_conn.shape[1]

    rows = np.repeat(row_conn, b, axis=1).ravel()
    cols = np.tile(col_conn, (1, a)).ravel()
    # One sort does everything: unique packed (row, col) keys are already
    # in row-major CSR order, and the inverse indices ARE the elemental
    # scatter map.  (Replaces a scipy coalesce + per-entry searchsorted
    # that cost ~50 s at NE27000; the native runtime accelerates this
    # further when built.)
    try:
        from cfd_with_cuda_tpu_torch.runtime import native

        indptr, indices, inverse = native.coalesce_pattern(
            rows, cols, n_rows, n_cols
        )
    except ImportError:
        keys = rows * n_cols + cols
        ukeys, inverse = np.unique(keys, return_inverse=True)
        indices = ukeys % n_cols
        row_of = ukeys // n_cols
        counts = np.bincount(row_of, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
    scatter = inverse.reshape(ne, a, b)
    return CsrPattern(
        n_rows=n_rows, n_cols=n_cols, indptr=indptr, indices=indices, scatter=scatter
    )


def ell_pad_width(indptr: np.ndarray, multiple: int = 8) -> int:
    max_row = int(np.diff(indptr).max()) if indptr.size > 1 else 0
    return -(-max_row // multiple) * multiple


@dataclass(frozen=True)
class EllMatrix:
    """Padded *slot-major* ELL sparse matrix: cols/vals shaped (L, n_rows).
    Padding slots have col 0 and value 0, so gathers stay in bounds and
    contribute nothing."""

    n_rows: int
    n_cols: int
    cols: np.ndarray          # (L, n_rows) int32
    vals: np.ndarray          # (L, n_rows)
    # map from CSR nnz slot -> flat (L, n_rows) ELL slot, for value refresh
    csr_to_ell: np.ndarray

    @property
    def pad(self) -> int:
        return self.cols.shape[0]

    def with_values(self, csr_values: np.ndarray) -> np.ndarray:
        """A new (L, n_rows) ELL value array from CSR values."""
        out = np.zeros(self.pad * self.n_rows, dtype=csr_values.dtype)
        out[self.csr_to_ell] = csr_values
        return out.reshape(self.pad, self.n_rows)


def ell_from_csr(
    pattern_or_indptr,
    indices: np.ndarray | None = None,
    values: np.ndarray | None = None,
    *,
    n_cols: int | None = None,
    pad_multiple: int = 8,
) -> EllMatrix:
    """Convert a CSR pattern (+ optional values) to slot-major ELL."""
    if isinstance(pattern_or_indptr, CsrPattern):
        pat = pattern_or_indptr
        indptr, indices, n_cols = pat.indptr, pat.indices, pat.n_cols
    else:
        indptr = np.asarray(pattern_or_indptr)
        assert indices is not None and n_cols is not None
    n_rows = indptr.size - 1
    L = ell_pad_width(indptr, pad_multiple)
    row_len = np.diff(indptr)
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), row_len)
    # position of each nnz within its row
    within = np.arange(indices.size, dtype=np.int64) - np.repeat(indptr[:-1], row_len)
    flat = within * n_rows + row_ids          # slot-major (L, n_rows) flat index
    cols = np.zeros(L * n_rows, dtype=np.int32)
    cols[flat] = indices.astype(np.int32)
    vals = np.zeros(L * n_rows, dtype=np.float64)
    if values is not None:
        vals[flat] = values
    return EllMatrix(
        n_rows=n_rows,
        n_cols=int(n_cols),
        cols=cols.reshape(L, n_rows),
        vals=vals.reshape(L, n_rows),
        csr_to_ell=flat,
    )
