"""PyTorch port: ``fused_cg(offs=...)``, the pressure CG on a banded window
(the unstructured path's Z), in its plain version against the JAX
``fused_cg(offs=...)`` (Pallas kernels in interpret mode) on the banded Z
of ``tests/test_banded.py:21-35`` (``cavity_deck(4, cluster=1.3)``, 125
offsets in the generator's scan order).

Both loop forms, both dot modes, cold and warm: iteration counts EQUAL to
the JAX package's (the per-iteration loop reports multiples of ``unroll``)
and x to rtol 2e-4, atol 2e-5, the contract of
``tests/test_banded.py:86-114``.  The CUDA kernels run only on the card;
here the wrappers take CPU tensors and run the plain versions, and the
launch counters must not move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu.mesh.generators import cavity_deck
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu.ops.banded import banded_from_csr, banded_spmv_xla
from cfd_with_cuda_tpu.ops.pallas_cg import cg_weight_layout
from cfd_with_cuda_tpu.ops.pallas_cg import fused_cg as jax_fused_cg
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import fused_cg as tcg

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

X_RTOL, X_ATOL = 2e-4, 2e-5      # tests/test_banded.py:113


@pytest.fixture(scope="module")
def system():
    deck = cavity_deck(4, cluster=1.3, viscosity=0.01, dt=1e-3)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    tab = build_element_tables(mesh.coords, mesh.ltog_node, etype=deck.etype,
                               nenv=deck.nenv, nenp=deck.nenp, ngp=deck.ngp)
    ops = assemble_operators(tab, mesh.ltog_node, mesh.nn, deck.nnp,
                             viscosity=deck.viscosity, density=deck.density,
                             z_mode="product")
    z = ops.Z.tocsr().copy()
    pin = deck.zero_pressure_node
    z[pin, pin] = z[pin, pin] * 1000.0
    offs, win = banded_from_csr(z)
    n = z.shape[0]
    win32 = win.astype(np.float32)
    dinv = (np.float32(1.0) / z.diagonal().astype(np.float32)).astype(np.float32)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n).astype(np.float32)
    b[pin] = 0.0
    x0 = (rng.standard_normal(n) * 0.1).astype(np.float32)
    laid = cg_weight_layout(win32, (n, 1, 1), None, offs=offs)
    return dict(n=n, offs=offs, win=win32, laid=laid, dinv=dinv, b=b, x0=x0)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dot_mode", ["plain", "compensated"])
@pytest.mark.parametrize("fuse_loop", [False, True], ids=["cg_iter", "cg_solve"])
def test_banded_fused_cg_matches_jax(system, fuse_loop, dot_mode, warm):
    s = system
    n, offs = s["n"], s["offs"]
    assert len(offs) == 125 and max(abs(o) for o in offs) == 62
    kw = dict(dims=(n, 1, 1), offs=offs, tol=1e-6, maxiter=200, unroll=4,
              fuse_loop=fuse_loop, dot_mode=dot_mode)
    ref = jax_fused_cg(jnp.asarray(s["laid"]), jnp.asarray(s["b"]), jnp.asarray(s["dinv"]),
                       x0=jnp.asarray(s["x0"]) if warm else None, **kw)
    before = dict(cuda_lib.launch_counts)
    out = tcg.fused_cg(torch.from_numpy(s["win"]), torch.from_numpy(s["b"]),
                       torch.from_numpy(s["dinv"]),
                       x0=torch.from_numpy(s["x0"]) if warm else None, **kw)
    assert dict(cuda_lib.launch_counts) == before
    k = int(out.iters)
    assert k == int(ref.iters) > 0
    if not fuse_loop:
        assert k % 4 == 0
    assert out.x.dtype == torch.float32
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=X_RTOL, atol=X_ATOL)
    # the solution of the banded operator itself
    res = s["b"] - np.asarray(banded_spmv_xla(jnp.asarray(s["win"]), offs,
                                              jnp.asarray(out.x.numpy())))
    assert np.linalg.norm(res) <= 2e-6 * np.linalg.norm(s["b"])


def test_banded_offsets_contract(system):
    """``offs`` needs ``dims=(n, 1, 1)`` and no radius; the plain apply
    with the offset list equals the JAX banded apply; ``sym`` takes the
    dq >= 0 half of a mirror-symmetric offset set."""
    s = system
    n, offs = s["n"], s["offs"]
    b, win, dinv = (torch.from_numpy(s[k]) for k in ("b", "win", "dinv"))
    with pytest.raises(ValueError, match="offs needs dims"):
        tcg.fused_cg(win, b, dinv, dims=(5, 5, 5), offs=offs, tol=1e-6, maxiter=10)
    with pytest.raises(ValueError, match="offs needs dims"):
        tcg.fused_cg(win, b, dinv, dims=(n, 1, 1), radius=2, offs=offs, tol=1e-6, maxiter=10)
    x = torch.from_numpy(s["x0"])
    y = tcg.window_apply_plain(win, x, offs)
    ref = np.asarray(banded_spmv_xla(jnp.asarray(s["win"]), offs, jnp.asarray(s["x0"])))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    half_offs, half = tcg._resolve_window(win, (n, 1, 1), None, True, offs)
    assert half_offs == tuple(o for o in offs if o >= 0) and half.shape[0] == len(half_offs)
    with pytest.raises(ValueError, match="mirror-symmetric"):
        tcg._resolve_window(win[:-1], (n, 1, 1), None, True, offs[:-1])
