"""PyTorch port: the host-side layout of the pressure-CG kernels
(``csrc/cg_solve.cu``, ``csrc/cg_iter.cu``, ``csrc/cg_common.cuh``).

The kernels give each block 256 rows and stage in shared memory the
clusters of p those rows read through the window (a window whose clusters
fit no block is refused at launch); their vectors live in one ``(5, ld)``
work buffer.  Here, against
brute force on the explicit (125-slot) and implicit (27-slot) Z windows of
``cavity_deck(4)`` and on the banded window of a small matrix
(``banded_from_csr``):

* every column a block's rows read (full window and dq >= 0 half, ``sym``)
  lies in its staged clusters;
* ``stage_clusters`` / ``stage_table``: whole 16-byte vectors holding
  every entry the block reads, the table the kernels take, and an apply
  that reads only the staged clusters (zeros outside [0, n)) gives
  ``window_apply_plain`` bit for bit;
* ``cg_work_layout``: five rows, each on a 128-byte boundary;
* ``fused_cg_plain``'s group contract: counts are whole groups of the
  unroll and ``maxiter`` rounds up to one;
* on a card (marker ``cuda``; skipped here): every kernel form at a fixed
  depth against the plain version, one ``cg_iter`` launch a group.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import fused_cg as tcg
from cfd_with_cuda_tpu_torch.ops.banded import banded_from_csr
from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

ROWS = tcg.BLOCK_ROWS
# a kernel against its plain version after a FIXED number of iterations: the
# two sum their dots in different orders (chip_smoke.py CG_FIXED_X_TOL)
FIXED_X_TOL = 1e-5


def _banded():
    """(win, offs, n): the band of a symmetric matrix with a 3-D 7-point
    sparsity on 9 x 7 x 6 nodes, through ``banded_from_csr``."""
    dims = (9, 7, 6)
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims[::-1])
    rows, cols = [idx.ravel()], [idx.ravel()]
    for axis in range(3):
        a, b = np.take(idx, range(idx.shape[axis] - 1), axis), np.take(idx, range(1, idx.shape[axis]), axis)
        rows += [a.ravel(), b.ravel()]
        cols += [b.ravel(), a.ravel()]
    r, c = np.concatenate(rows), np.concatenate(cols)
    rng = np.random.default_rng(7)
    vals = np.where(r == c, 6.5, -1.0) * (1 + 0.01 * rng.standard_normal(len(r)))
    a = sp.coo_matrix((vals, (r, c)), shape=(n, n)).tocsr()
    a = (a + a.T) * 0.5
    offs, win = banded_from_csr(a)
    return win.astype(np.float32), offs, n


@pytest.fixture(scope="module")
def windows():
    """name -> (win (D, n) f32, offsets, n): both solvers' Z on cavity_deck(4)
    and a small band."""
    deck = cavity_deck(4, viscosity=0.01, dt=0.001)
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32)
    out = {}
    for name, cls in (("explicit_z125", ExplicitBCHSolver), ("implicit_z27", ImplicitGQSolver)):
        s = cls(deck, cfg, device="cpu")
        win = s.d["Z_win"].numpy()
        out[name] = (win, window_offsets(s.coarse_dims, s.z_radius), win.shape[1])
    out["band"] = _banded()
    return out


CASES = [(w, sym) for w in ("explicit_z125", "implicit_z27", "band") for sym in (False, True)]


def _offsets(windows, name, sym):
    win, offs, n = windows[name]
    if sym:
        half = tcg._sym_offsets(tuple(offs))
        return win[len(offs) - len(half):], half, n
    return win, tuple(offs), n


def _reads(i, offs, sym):
    """The entries of v that row i reads, by brute force."""
    cols = [i + o for o in offs]
    if sym:
        cols += [i - o for o in offs if o > 0]
    return cols


@pytest.mark.parametrize("name,sym", CASES)
def test_every_block_reads_inside_its_clusters(windows, name, sym):
    """Block by block, every column its rows read through the window lies
    in the columns its clusters stage."""
    _, offs, n = _offsets(windows, name, sym)
    clusters, _ = tcg.stage_clusters(offs, sym)
    for tile in range(-(-n // ROWS)):
        i0 = tile * ROWS
        staged = {i0 + c for lo, k in clusters for c in range(lo, lo + k)}
        read = {c for i in range(i0, i0 + ROWS) for c in _reads(i, offs, sym)}
        assert read <= staged


@pytest.mark.parametrize("name,sym", CASES)
def test_stage_clusters_hold_every_read(windows, name, sym):
    """The clusters are whole 16-byte vectors, back to back, in order, and
    every entry a block's rows read has its place in them."""
    _, offs, n = _offsets(windows, name, sym)
    clusters, pos = tcg.stage_clusters(offs, sym)
    ends = [lo + k for lo, k in clusters]
    assert all(lo % 4 == 0 and k % 4 == 0 and k >= ROWS for lo, k in clusters)
    assert all(e < lo for e, (lo, _) in zip(ends, clusters[1:]))
    starts = np.cumsum([0] + [k for _, k in clusters])
    for d in set(_reads(0, offs, sym)):
        c = next(j for j, (lo, k) in enumerate(clusters) if lo <= d and d + ROWS <= lo + k)
        assert pos[d] == starts[c] + d - clusters[c][0]


@pytest.mark.parametrize("name,sym", CASES)
def test_stage_table_layout(windows, name, sym):
    """The int32 table the kernels read (csrc/cg_common.cuh StageTab)."""
    _, offs, n = _offsets(windows, name, sym)
    clusters, pos = tcg.stage_clusters(offs, sym)
    tab = tcg.stage_table(offs, sym)
    k, nw = len(clusters), len(offs)
    assert tab.dtype == np.int32 and len(tab) == 4 + 2 * k + nw * (2 if sym else 1)
    starts = np.cumsum([0] + [c for _, c in clusters])
    assert (tab[0], tab[1], tab[2]) == (k, starts[-1] // 4, pos[0])
    assert list(tab[3:3 + k]) == [lo for lo, _ in clusters]
    assert list(tab[3 + k:4 + 2 * k]) == list(starts)
    assert list(tab[4 + 2 * k:4 + 2 * k + nw]) == [pos[o] for o in offs]
    if sym:
        assert list(tab[4 + 2 * k + nw:]) == [pos[-o] if o > 0 else 0 for o in offs]


@pytest.mark.parametrize("name,sym", CASES)
def test_apply_from_the_staged_clusters_is_the_plain_apply(windows, name, sym):
    """Each block's rows summed from its staged clusters alone (zeros outside
    [0, n)), in the kernels' term order (forward chain, back chain, then
    their sum), equal ``window_apply_plain`` bit for bit (f32, rounded
    product then add, as the plain version sums)."""
    win, offs, n = _offsets(windows, name, sym)
    clusters, pos = tcg.stage_clusters(offs, sym)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(n).astype(np.float32)
    want = tcg.window_apply_plain(torch.from_numpy(win), torch.from_numpy(v), offs, sym).numpy()
    got = np.empty(n, np.float32)
    for tile in range(-(-n // ROWS)):
        c = np.concatenate([tile * ROWS + np.arange(lo, lo + k) for lo, k in clusters])
        sv = np.where((c >= 0) & (c < n), v[np.clip(c, 0, n - 1)], np.float32(0))
        for i in range(tile * ROWS, min(tile * ROWS + ROWS, n)):
            t = i - tile * ROWS
            fwd = back = np.float32(0)
            for m, dq in enumerate(offs):
                fwd = np.float32(fwd + np.float32(win[m, i] * sv[t + pos[dq]]))
                if sym and dq > 0 and i - dq >= 0:
                    back = np.float32(back + np.float32(win[m, i - dq] * sv[t + pos[-dq]]))
            got[i] = np.float32(fwd + back) if sym else fwd
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 125, 29791, 91125, 147477])
def test_work_layout(n):
    rows, ld = tcg.cg_work_layout(n)
    assert rows == ("r", "z", "ap", "p0", "p1") == tcg.WORK_ROWS
    assert ld >= n and ld % 32 == 0 and ld - n < 32
    # row k starts k * ld floats past the buffer's (card allocations: 512-byte aligned)
    assert all(k * ld * 4 % 128 == 0 for k in range(len(rows)))


@pytest.mark.parametrize("unroll", [1, 3, 4])
@pytest.mark.parametrize("maxiter", [1, 5, 8])
def test_plain_counts_are_whole_groups(windows, unroll, maxiter):
    """tol 0 never converges: the count is maxiter rounded up to the unroll;
    a converged solve's count is a multiple of the unroll too."""
    win, offs, n = windows["implicit_z27"]
    rng = np.random.default_rng(11)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    dinv = torch.from_numpy((1.0 / np.abs(win[len(offs) // 2]).clip(1e-3)).astype(np.float32))
    kw = dict(dims=(n, 1, 1), offs=offs, unroll=unroll)
    w = torch.from_numpy(win)
    cuda_lib.reset_launch_counts()
    fixed = tcg.fused_cg(w, b, dinv, tol=0.0, maxiter=maxiter, **kw)
    assert int(fixed.iters) == -(-maxiter // unroll) * unroll
    done = tcg.fused_cg(w, b, dinv, tol=1e-4, maxiter=500, **kw)
    assert 0 < int(done.iters) < 500 and int(done.iters) % unroll == 0
    assert not any(cuda_lib.launch_counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["explicit_z125", "implicit_z27", "band"])
def test_kernels_at_fixed_depth_against_plain(windows, name):
    """On the card: every form (both loops, full and half window, plain and
    compensated dots) after 0, 1 and 8 iterations against the plain
    version, and one cg_iter launch per group of the unroll."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CG kernels have no CPU form")
    win, offs, n = windows[name]
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    x0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).cuda()
    dinv = torch.from_numpy((1.0 / np.abs(win[len(offs) // 2]).clip(1e-3)).astype(np.float32)).cuda()
    half = tcg._sym_offsets(tuple(offs))
    tables = {False: (torch.from_numpy(win).cuda(), tuple(offs)),
              True: (torch.from_numpy(win[len(offs) - len(half):]).cuda(), tuple(offs))}
    for fuse_loop in (False, True):
        for sym in (False, True):
            for dot_mode in ("plain", "compensated"):
                w, o = tables[sym]
                for k in (0, 1, 8):
                    kw = dict(dims=(n, 1, 1), offs=o, tol=0.0, maxiter=k, x0=x0, unroll=4,
                              dot_mode=dot_mode, sym=sym, fuse_loop=fuse_loop)
                    cuda_lib.reset_launch_counts()
                    sol = tcg.fused_cg(w, b, dinv, **kw)
                    torch.cuda.synchronize()
                    counts = dict(cuda_lib.launch_counts)
                    ref = tcg.fused_cg_plain(w, b, dinv, **kw)
                    assert int(sol.iters) == int(ref.iters)
                    scale = float(ref.x.abs().max())
                    assert float((sol.x - ref.x).abs().max()) <= FIXED_X_TOL * scale
                    if fuse_loop:
                        assert counts["cg_solve"] == 1
                    else:
                        assert counts["cg_init"] == 1
                        assert counts["cg_iter"] == int(sol.iters) // 4
