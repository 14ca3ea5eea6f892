"""PyTorch port: every mode of ``fused_cg`` in its plain version against
the JAX ``fused_cg`` (Pallas kernels in interpret mode) on the pinned Z of
``cavity_deck(5)`` (the system of ``tests/test_pallas_cg.py:26-46``).

The per-iteration loop contract is the JAX one: convergence is looked at
only between groups of ``unroll`` iterations, ``maxiter`` rounds up to a
multiple of ``unroll``, and the count reported is a multiple of ``unroll``
— so the counts must be EQUAL to the JAX package's.  The CUDA kernels run
only on the card; here the wrappers take CPU tensors and run the plain
versions, and the launch counters must not move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu.fem.structured import detect_structured_grid, dia_from_csr
from cfd_with_cuda_tpu.mesh.generators import cavity_deck
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu.ops import krylov as jax_krylov
from cfd_with_cuda_tpu.ops.pallas_cg import fused_cg as jax_fused_cg
from cfd_with_cuda_tpu.ops.stencil import patches_spmv
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import fused_cg as tcg
from cfd_with_cuda_tpu_torch.ops.window_stencil import window_offsets

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

# two f32 CGs with the same iterates up to the order of their sums, <= 60
# iterations on a system of condition ~1e3: x to 2e-4 relative + 2e-5
# absolute (the bounds of tests/test_pallas_cg.py:130-132)
X_RTOL, X_ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def pinned_z():
    """Pinned Z of a small cavity in grid order + its DIA window form."""
    deck = cavity_deck(5, cluster=1.0, viscosity=0.01, dt=1e-3)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    tab = build_element_tables(
        mesh.coords, mesh.ltog_node, etype=deck.etype,
        nenv=deck.nenv, nenp=deck.nenp, ngp=deck.ngp,
    )
    ops = assemble_operators(
        tab, mesh.ltog_node, mesh.nn, deck.nnp,
        viscosity=deck.viscosity, density=deck.density, z_mode="product",
    )
    Z = ops.Z.tocsr().copy()
    pin = deck.zero_pressure_node
    Z[pin, pin] = Z[pin, pin] * 1000.0
    gi_p = detect_structured_grid(mesh.coords[: deck.nnp])
    dia = dia_from_csr(Z, gi_p.flat_of_node, gi_p.flat_of_node, gi_p.dims)
    win = np.asarray(dia.window_vals(dtype=np.float64), dtype=np.float32)
    diag = np.zeros(gi_p.size, np.float32)
    diag[gi_p.flat_of_node] = Z.diagonal()
    return win, diag, tuple(int(v) for v in gi_p.dims), int(dia.radius)


def _system(pinned_z, seed):
    win, diag, dims, radius = pinned_z
    rng = np.random.default_rng(seed)
    s = int(np.prod(dims))
    b = rng.standard_normal(s).astype(np.float32)
    b[0] = 0.0
    x0 = rng.standard_normal(s).astype(np.float32) * 0.1
    return win, (1.0 / diag).astype(np.float32), b, x0, dims, radius


def _both(win, dinv, b, x0, dims, radius, **kw):
    """(JAX result, port result) of one fused_cg call on the same arrays."""
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = jax_fused_cg(j(win), j(b), j(dinv), dims=dims, radius=radius, x0=j(x0), **kw)
    cuda_lib.reset_launch_counts()
    out = tcg.fused_cg(t(win), t(b), t(dinv), dims=dims, radius=radius, x0=t(x0), **kw)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    return ref, out


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_per_iteration_loop_equal_counts(pinned_z, unroll, warm):
    win, dinv, b, x0, dims, radius = _system(pinned_z, 3)
    ref, out = _both(win, dinv, b, x0 if warm else None, dims, radius,
                     tol=1e-6, maxiter=200, unroll=unroll)
    assert int(out.iters) == int(ref.iters) > 0
    assert int(out.iters) % unroll == 0
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=X_RTOL, atol=X_ATOL)
    # the residual both report is the same quantity: 1e-3 relative, for sums
    # in another order
    np.testing.assert_allclose(float(out.residual), float(ref.residual), rtol=1e-3)


def test_maxiter_rounds_up_to_the_unroll(pinned_z):
    """maxiter=6 with unroll=4 stops at 8 iterations (a soft cap)."""
    win, dinv, b, _, dims, radius = _system(pinned_z, 3)
    ref, out = _both(win, dinv, b, None, dims, radius, tol=1e-12, maxiter=6, unroll=4)
    assert int(out.iters) == int(ref.iters) == 8
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=X_RTOL, atol=X_ATOL)


@pytest.mark.parametrize("fuse_loop", [False, True], ids=["iter", "solve"])
def test_zero_rhs(pinned_z, fuse_loop):
    """b = 0: x = 0 after 0 iterations cold (the breakdown guards); warm the
    bound is 0, so it iterates toward 0 and stays finite."""
    win, dinv, _, _, dims, radius = _system(pinned_z, 3)
    b = np.zeros_like(dinv)
    ref, out = _both(win, dinv, b, None, dims, radius, tol=1e-6, maxiter=50,
                     unroll=4, fuse_loop=fuse_loop)
    assert int(out.iters) == int(ref.iters) == 0
    assert np.all(out.x.numpy() == 0.0)
    x0 = np.full_like(dinv, 0.3)
    ref, out = _both(win, dinv, b, x0, dims, radius, tol=1e-6, maxiter=50,
                     unroll=4, fuse_loop=fuse_loop)
    assert np.isfinite(out.x.numpy()).all()
    # both drive x toward 0 until the breakdown guards freeze it; where that
    # happens depends on rounding, so only the cap binds both
    assert int(out.iters) <= 52 and int(ref.iters) <= 52


def test_fuse_loop_checks_every_iteration(pinned_z):
    """fuse_loop=True ignores unroll: counts equal JAX's fused-loop kernel
    and the per-iteration path at unroll=1."""
    win, dinv, b, x0, dims, radius = _system(pinned_z, 13)
    for warm in (None, x0):
        ref, out = _both(win, dinv, b, warm, dims, radius, tol=1e-6, maxiter=200,
                         unroll=4, fuse_loop=True)
        _, it1 = _both(win, dinv, b, warm, dims, radius, tol=1e-6, maxiter=200, unroll=1)
        assert int(out.iters) == int(ref.iters) == int(it1.iters)
        np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=X_RTOL, atol=X_ATOL)


def test_compensated_equal_counts_to_f64_dot_cg(pinned_z):
    """dot_mode='compensated' reproduces the CG with f64 reductions: the
    same iteration count as JAX's compensated kernel and as its XLA CG with
    dot_dtype=f64, and x at least as close to that iterate as plain dots
    (tests/test_pallas_cg.py:247-274)."""
    win, dinv, b, _, dims, radius = _system(pinned_z, 13)
    winj = jnp.asarray(win)
    mv = lambda p: patches_spmv(winj, p.astype(jnp.float32), dims, radius).astype(p.dtype)
    ref64 = jax_krylov.cg(
        mv, jnp.asarray(b), tol=2e-7, maxiter=400,
        precond=lambda r: r * jnp.asarray(dinv), dot_dtype=jnp.float64,
    )
    errs = {}
    for mode in ("plain", "compensated"):
        ref, out = _both(win, dinv, b, None, dims, radius, tol=2e-7, maxiter=400,
                         dot_mode=mode)
        assert int(out.iters) == int(ref.iters) == int(ref64.iters), mode
        errs[mode] = float(np.abs(out.x.numpy().astype(np.float64)
                                  - np.asarray(ref64.x, np.float64)).max())
    assert errs["compensated"] <= errs["plain"] + 1e-12, errs


@pytest.mark.parametrize("fuse_loop", [False, True], ids=["iter", "solve"])
def test_sym_half_window_matches_full(pinned_z, fuse_loop):
    """sym=True applies only the dq >= 0 half, each positive offset both
    ways: the sums run in another order than the full window, so counts may
    move by one group and x by FP-order noise (the bounds of
    tests/test_pallas_cg.py:102-135), cold and warm, from the full table and
    from the stored half."""
    win, dinv, b, x0, dims, radius = _system(pinned_z, 11)
    unroll = 1
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    half = tcg.half_window(win, dims, radius)
    assert half.shape == (win.shape[0] // 2 + 1, win.shape[1])
    offs = window_offsets(dims, radius)
    for warm in (None, x0):
        kw = dict(dims=dims, radius=radius, tol=1e-6, maxiter=200, unroll=unroll,
                  fuse_loop=fuse_loop)
        ref_jax = jax_fused_cg(jnp.asarray(win), jnp.asarray(b), jnp.asarray(dinv),
                               x0=None if warm is None else jnp.asarray(warm), sym=True, **kw)
        full = tcg.fused_cg(t(win), t(b), t(dinv), x0=t(warm), **kw)
        for w in (win, half):
            out = tcg.fused_cg(t(w), t(b), t(dinv), x0=t(warm), sym=True, **kw)
            assert abs(int(out.iters) - int(full.iters)) <= 1
            assert abs(int(out.iters) - int(ref_jax.iters)) <= 1
            np.testing.assert_allclose(out.x.numpy(), full.x.numpy(), rtol=X_RTOL, atol=X_ATOL)
            np.testing.assert_allclose(out.x.numpy(), np.asarray(ref_jax.x),
                                       rtol=X_RTOL, atol=X_ATOL)
            r = b - tcg.window_apply_plain(t(win), out.x, offs).numpy()
            assert np.linalg.norm(r) <= 1.5e-6 * np.linalg.norm(b)


def test_sym_apply_matches_full_apply(pinned_z):
    """The half-window apply alone: APPLY tolerance 2e-6 of the largest
    sum |w x| (125 terms, summed in another order)."""
    win, _, b, _, dims, radius = _system(pinned_z, 5)
    offs = window_offsets(dims, radius)
    full = tcg.window_apply_plain(torch.from_numpy(win), torch.from_numpy(b), offs)
    scale = tcg.window_apply_plain(torch.from_numpy(np.abs(win)), torch.from_numpy(np.abs(b)), offs)
    for w in (win, tcg.half_window(win, dims, radius)):
        got = tcg.window_apply_sym(torch.from_numpy(np.array(w)), torch.from_numpy(b),
                                   dims=dims, radius=radius)
        assert float((got - full).abs().max()) <= 2e-6 * float(scale.max())


def test_half_window_rejects_asymmetric(pinned_z):
    win, _, _, _, dims, radius = _system(pinned_z, 5)
    bad = np.array(win, copy=True)
    bad[0] += 1.0          # break symmetry at the most-negative offset
    with pytest.raises(ValueError, match="not symmetric"):
        tcg.half_window(bad, dims, radius)


@pytest.mark.parametrize("n", [128, 4096, 29824])
def test_comp_dot_plain_within_2_ulp(n):
    """The compensated dot's plain version against the exact f64 dot of the
    f32 inputs, spread over 6 decades: within 2 ulp (f32) of the result
    (tests/test_pallas_cg.py:227-244)."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    got = tcg.comp_dot_f32(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.ndim == 0
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    ulp = float(np.spacing(np.float32(abs(exact)) or np.float32(1.0)))
    assert abs(float(got) - exact) <= 2 * ulp, (n, float(got), exact)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Argument checks that run before any launch (no card needed)."""
    with pytest.raises(ValueError, match="dot_mode"):
        tcg.fused_cg(torch.zeros(27, 8), torch.zeros(8), torch.ones(8), dims=(2, 2, 2),
                     radius=1, tol=1e-6, maxiter=4, dot_mode="kahan")
    with pytest.raises(ValueError, match="mirror-symmetric"):
        tcg._sym_offsets((-1, 0, 2))
