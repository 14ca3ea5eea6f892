"""The port's sharded window applies against the JAX package's and its own.

``parallel/sharded_stencil.py``'s three applies (the window SPMV with 3
channels and 1, G from a replicated pressure, G^T all-gathered) run on 2 and
8 ranks spawned over gloo on the CPU (a file store in ``tmp_path``: no port,
so concurrent test workers never clash), on ``tests/test_sharded_stencil.py``'s
operands (DIMS 8^3, radius 1, seed 7, ``s_pad`` a multiple of
``shard_blk(8)``), and are held within 1e-6 against the JAX package's
``sharded_*`` on its 8-device virtual mesh (Pallas in interpret mode) and
against the port's single-device plain applies.  Those operands hold data in
the first 512 rows only, all on rank 0; a dense variant (every row drawn)
makes every halo cross a rank boundary and is held against the JAX
package's applies on the same operands and bit for bit against the
single-device plain applies.  Also: the JAX package's ``halo == 0`` guard,
both ``_check_local`` errors, and the solvers' compact G^T on a rank's
coarse rows (``sharded_div_compact``) against ``div_compact_interleaved``.

The ranks run this module's ``_rank_applies`` (module-level, importable by
the spawned processes, which import no JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.ops import window_stencil as ws
from cfd_with_cuda_tpu_torch.parallel import sharded_stencil as sst
from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh, block_of, gather, make_mesh
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks

DIMS = (8, 8, 8)
RADIUS = 1
N_DEV = 8
TOL = 1e-6


def _operands(dense: bool = False):
    """``test_sharded_stencil.py``'s operands (the same draws), as numpy;
    ``dense``: every row of ``s_pad`` drawn."""
    rng = np.random.default_rng(7)
    s = int(np.prod(DIMS))
    s_pad = -(-s // sst.shard_blk(N_DEV)) * sst.shard_blk(N_DEV)
    offsets = ws.window_offsets(DIMS, RADIUS)
    w3 = len(offsets)
    n = s_pad if dense else s
    win = np.zeros((w3, s_pad), np.float32)
    win[:, :n] = rng.standard_normal((w3, n)).astype(np.float32)
    x = np.zeros((3, s_pad), np.float32)
    x[:, :n] = rng.standard_normal((3, n)).astype(np.float32)
    g_win = np.zeros((3, w3, s_pad), np.float32)
    g_win[..., :n] = rng.standard_normal((3, w3, n)).astype(np.float32)
    return offsets, win, x, g_win, s


def _rank_applies(dense: bool) -> dict:
    """Every sharded apply on this rank's blocks, gathered to whole arrays."""
    mesh = make_mesh()
    offsets, win, x, g_win, _ = _operands(dense)
    win, x, g_win = (torch.from_numpy(a) for a in (win, x, g_win))
    blk = lambda t: block_of(t, mesh).contiguous()
    y3 = sst.sharded_window_spmv(blk(win), blk(x), DIMS, offsets=offsets, mesh=mesh)
    y1 = sst.sharded_window_spmv(blk(win), blk(x[0]), DIMS, offsets=offsets, mesh=mesh)
    g = sst.sharded_grad_window(blk(g_win), x[0], DIMS, offsets=offsets, mesh=mesh)
    div = sst.sharded_div_window(blk(g_win), blk(x), DIMS, offsets=offsets, mesh=mesh)
    # the halo == 0 guard: a one-slot window at offset 0
    y0 = sst.sharded_window_spmv(blk(win[:1]), blk(x), DIMS, offsets=(0,), mesh=mesh)
    return dict(spmv3=gather(y3, mesh).numpy(), spmv1=gather(y1[None], mesh)[0].numpy(),
                grad=gather(g, mesh).numpy(), div=div.numpy(), halo0=gather(y0, mesh).numpy())


def _plain(dense: bool) -> dict:
    """The port's single-device plain applies on the same operands."""
    offsets, win, x, g_win, s = _operands(dense)
    win, x, g_win = (torch.from_numpy(a) for a in (win, x, g_win))
    y3 = ws.window_spmv_plain(win, x, DIMS, offsets=offsets, trim=False)
    return dict(spmv3=y3.numpy(), spmv1=y3[0].numpy(),
                grad=ws.grad_window_plain(g_win, x[0], DIMS, RADIUS, trim=False).numpy(),
                # every row of the divergence, as the sharded form gathers it
                div=ws._stencil_plain(ws._DIV, g_win, x, offsets)[0].numpy(),
                halo0=(win[:1] * x).numpy())


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's sharded applies on its 8-device virtual mesh, on
    the sparse operands (False) and the dense ones (True)."""
    import jax
    import jax.numpy as jnp

    if len(jax.devices()) < N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from cfd_with_cuda_tpu.parallel.sharded_stencil import (
        sharded_div_window,
        sharded_grad_window,
        sharded_window_spmv,
    )
    from cfd_with_cuda_tpu.parallel.sharding import make_mesh as jax_mesh

    mesh = jax_mesh(N_DEV)
    out = {}
    for dense in (False, True):
        offsets, win, x, g_win, _ = _operands(dense)
        win, x, g_win = jnp.asarray(win), jnp.asarray(x), jnp.asarray(g_win)
        out[dense] = dict(
            spmv3=np.asarray(sharded_window_spmv(win, x, DIMS, offsets=offsets, mesh=mesh)),
            spmv1=np.asarray(sharded_window_spmv(win, x[0], DIMS, offsets=offsets, mesh=mesh)),
            grad=np.asarray(sharded_grad_window(g_win, x[0], DIMS, offsets=offsets, mesh=mesh)),
            div=np.asarray(sharded_div_window(g_win, x, DIMS, offsets=offsets, mesh=mesh)),
        )
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's sharded applies on 2 and 8 ranks, sparse and dense
    operands: rank 0's gathered arrays (every rank's are checked equal)."""
    out = {}
    for n in (2, N_DEV):
        for dense in (False, True):
            ranks = run_ranks(_rank_applies, n, (dense,), device="cpu",
                              workdir=tmp_path_factory.mktemp(f"ranks{n}"))
            for r in ranks[1:]:
                for k, v in r.items():
                    np.testing.assert_array_equal(v, ranks[0][k])
            out[n, dense] = ranks[0]
    return out


@pytest.mark.parametrize("n", [2, N_DEV])
@pytest.mark.parametrize("what", ["spmv3", "spmv1", "grad", "div"])
def test_sharded_apply_matches_jax_sharded(jax_ref, port_runs, what, n):
    """Within 1e-6 of the largest |result| (the window kernels' bound in
    ``chip_smoke.py``, WINDOW_TOL): in f32 the packages round G^T's per-slot
    3-direction sums apart (read 2.0e-6 on values up to 15, 1.3e-7 of the
    scale), where the SPMV and G agree element by element at 1e-6."""
    got, ref = port_runs[n, False][what], jax_ref[False][what]
    s = int(np.prod(DIMS))
    if what == "div":
        got, ref = got[:s], ref[:s]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("n", [2, N_DEV])
@pytest.mark.parametrize("what", ["spmv3", "spmv1", "grad", "div"])
def test_dense_sharded_apply_matches_jax_sharded(jax_ref, port_runs, what, n):
    """The dense operands (every row of ``s_pad`` drawn, so every rank's
    rows read its neighbours' halos, and G^T's gather carries every rank's
    rows) against the JAX package's applies on the same operands, every row,
    at the bound above."""
    got, ref = port_runs[n, True][what], jax_ref[True][what]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("dense", [False, True], ids=["jax_operands", "dense"])
@pytest.mark.parametrize("n", [2, N_DEV])
@pytest.mark.parametrize("what", ["spmv3", "spmv1", "grad", "div", "halo0"])
def test_sharded_apply_matches_single_device_plain(port_runs, what, n, dense):
    """The ranks' plain applies read the same terms in the same order as
    one device's: equal bit for bit (within 1e-6 is what is asked)."""
    got, ref = port_runs[n, dense][what], _plain(dense)[what]
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got, ref)


def test_check_local_errors():
    """Both of the JAX package's ``_check_local`` errors, with its messages."""
    offsets = ws.window_offsets(DIMS, RADIUS)
    x = torch.zeros((3, 1000))
    with pytest.raises(ValueError, match="divisible by BLK"):
        sst.sharded_window_spmv(torch.zeros((27, 1000)), x, DIMS, offsets=offsets,
                                mesh=Mesh(0, 8, torch.device("cpu"), None))
    wide = ws.window_offsets((64, 64, 64), 2)       # halo 8322 > a 2048-row block
    with pytest.raises(ValueError, match="too many devices"):
        sst.sharded_window_spmv(torch.zeros((125, 2048)), torch.zeros((3, 2048)), (64, 64, 64),
                                offsets=wide, mesh=Mesh(0, 8, torch.device("cpu"), None))
    assert sst.halo_size((0,)) == 0 and sst.shard_blk(4) == 4 * ws.BLK


def _field(s_pad: int, size: int) -> torch.Tensor:
    """A random velocity on the grid's rows, zero on the padding rows."""
    u = np.random.default_rng(3).standard_normal((3, size)).astype(np.float32)
    return torch.nn.functional.pad(torch.from_numpy(u), (0, s_pad - size))


def _rank_div_compact(n_el: int) -> np.ndarray:
    """The solvers' sharded G^T (compact, the rank's coarse rows) on the
    interleaved explicit solver's tables of ``cavity_deck(n_el)`` at this
    rank count, on a random field: the gathered coarse vector."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    mesh = make_mesh()
    s = ExplicitBCHSolver(cavity_deck(n_el), SolverConfig(
        dtype_policy=DTypePolicy.F32, structured_layout="interleaved",
        spmd_devices=mesh.size), device="cpu")
    u = _field(s.s_pad, int(np.prod(s.fine_dims)))
    y = sst.sharded_div_compact(s.d["GT_cwin"], s._local(u), s.fine_dims, s.coarse_dims,
                                mesh=mesh, s_pad=s.s_pad)
    return y.numpy()


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_div_compact_matches_single_device(n, tmp_path):
    """cavity_deck(8): 17^3 fine rows over 4 ranks' 2048-row blocks, so
    three ranks hold coarse rows; their gathered G^T equals the single-device
    compact form bit for bit."""
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    y = run_ranks(_rank_div_compact, n, (8,), device="cpu", workdir=tmp_path)[0]
    s0 = ExplicitBCHSolver(cavity_deck(8), SolverConfig(
        dtype_policy=DTypePolicy.F32, structured_layout="interleaved"), device="cpu")
    u = _field(s0.s_pad, int(np.prod(s0.fine_dims)))
    ref = ws.div_compact_interleaved_plain(s0.d["GT_cwin"], u, s0.fine_dims,
                                           s0.coarse_dims)[: s0.nnp]
    assert y.shape == (s0.nnp,)
    np.testing.assert_array_equal(y, ref.numpy())
