"""PyTorch port: the ops of the XLA structured path against the JAX package.

The DIA and window-patches applies of ``ops/stencil.py`` (``dia_spmv``,
``patches_spmv`` on one and on C channels, both grad / div forms,
``fine_to_coarse``) on random f64 data over a non-cubic grid, at 1e-12 of
the output's scale; the multigrid transfers ``mg_restrict`` / ``mg_prolong``
(and that one is the other's adjoint, the counterpart of
``tests/test_multigrid.py::test_transfer_operators_are_adjoint``); the
Galerkin ladder ``build_mg_hierarchy`` of both pressure operators of an 8^3
cavity, bit for bit (windows, diagonals, dims, radii, omegas, the coarsest
inverse); one V-cycle against the JAX package's ``make_vcycle`` at 1e-12;
and the "coarsening stalled" ``ValueError`` of a thin slab.  The JAX side
runs its own XLA ops on the CPU (no Pallas).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu.fem.structured import detect_structured_grid
from cfd_with_cuda_tpu.mesh.generators import cavity_deck
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu.ops import multigrid as jmg
from cfd_with_cuda_tpu.ops import stencil as jst
from cfd_with_cuda_tpu_torch.ops import multigrid as tmg
from cfd_with_cuda_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

FINE = (9, 7, 11)                                 # a non-cubic fine grid (odd sides)
COARSE = tuple((c + 1) // 2 for c in FINE)
S = int(np.prod(FINE))
TOL = 1e-12                                       # of the output's largest magnitude


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= TOL * scale


def _offsets(rng, n, radius=2):
    """``n`` distinct flat offsets of the radius window on FINE, 0 among them."""
    fx, fy, _ = FINE
    r = range(-radius, radius + 1)
    flat = sorted({dz * fy * fx + dy * fx + dx for dz in r for dy in r for dx in r} - {0})
    pick = rng.choice(len(flat), n - 1, replace=False)
    return (0,) + tuple(int(flat[i]) for i in sorted(pick))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20261017)
    return dict(
        rng=rng,
        offs=_offsets(rng, 27),
        vals=rng.standard_normal((27, S)),
        g_vals=rng.standard_normal((3, 27, S)),
        x=rng.standard_normal(S),
        u=rng.standard_normal((3, S)),
        p=rng.standard_normal(int(np.prod(COARSE))),
    )


@pytest.mark.parametrize("channels", [1, 3], ids=["one", "three"])
def test_dia_spmv_matches_jax(data, channels):
    x = data["x"] if channels == 1 else data["u"]
    want = jst.dia_spmv(jnp.asarray(data["vals"]), jnp.asarray(x), data["offs"])
    _close(tst.dia_spmv(torch.from_numpy(data["vals"]), torch.from_numpy(x), data["offs"]), want)


@pytest.mark.parametrize("channels,radius", [(1, 1), (1, 2), (3, 2)],
                         ids=["one-r1", "one-r2", "three-r2"])
def test_patches_spmv_matches_jax(data, channels, radius):
    w3 = (2 * radius + 1) ** 3
    win = data["rng"].standard_normal((w3, S))
    x = data["x"] if channels == 1 else data["u"]
    want = jst.patches_spmv(jnp.asarray(win), jnp.asarray(x), FINE, radius)
    _close(tst.patches_spmv(torch.from_numpy(win), torch.from_numpy(x), FINE, radius), want)


def test_patch_channels_follow_the_dia_window_order(data):
    """Channel k of the extracted patches holds x at (dz, dy, dx) =
    unravel(k) - radius: a window table with one live channel applies that
    offset, as ``dia_spmv`` does on the same diagonal (away from the rolls'
    wrap-around)."""
    fx, fy, fz = FINE
    x = torch.from_numpy(data["x"])
    for dz, dy, dx in [(1, 0, 0), (0, -2, 1), (-1, 1, -2)]:
        win = torch.zeros(125, S, dtype=torch.float64)
        win[((dz + 2) * 5 + dy + 2) * 5 + dx + 2] = 1.0
        got = tst.patches_spmv(win, x, FINE, 2).reshape(fz, fy, fx)
        ref = tst.dia_spmv(torch.ones(1, S, dtype=torch.float64), x,
                           (dz * fy * fx + dy * fx + dx,)).reshape(fz, fy, fx)
        inner = (slice(2, -2),) * 3
        torch.testing.assert_close(got[inner], ref[inner], rtol=0, atol=0)


def test_fine_to_coarse_matches_jax_and_inverts_coarse_to_fine(data):
    want = jst.fine_to_coarse(jnp.asarray(data["x"]), COARSE, FINE)
    got = tst.fine_to_coarse(torch.from_numpy(data["x"]), COARSE, FINE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = torch.from_numpy(data["p"])
    np.testing.assert_array_equal(
        tst.fine_to_coarse(tst.coarse_to_fine(p, COARSE, FINE), COARSE, FINE).numpy(), data["p"])


def test_dia_grad_and_div_match_jax(data):
    """One offset set shared by the three directions (the JAX package's
    ``dia_grad_apply`` / ``dia_div_apply``)."""
    g = jnp.asarray(data["g_vals"])
    offs = (data["offs"],) * 3
    want = jst.dia_grad_apply(g, jnp.asarray(data["p"]), data["offs"], COARSE, FINE)
    got = tst.dia_grad_apply(torch.from_numpy(data["g_vals"]), torch.from_numpy(data["p"]),
                             offs, COARSE, FINE)
    _close(got, want)
    want = jst.dia_div_apply(g, jnp.asarray(data["u"]), data["offs"], COARSE, FINE)
    got = tst.dia_div_apply(torch.from_numpy(data["g_vals"]), torch.from_numpy(data["u"]),
                            offs, COARSE, FINE)
    _close(got, want)


def test_dia_grad_and_div_per_direction_match_jax(data):
    """Each direction on its own offset set and table height, zero-padded
    to s_pad: the form the solvers run under F64 (the JAX package's
    ``explicit_bch.py:676-695``, ``dia_spmv`` per direction)."""
    rng = np.random.default_rng(20261018)
    offs = tuple(_offsets(rng, n) for n in (27, 18, 9))
    g = [rng.standard_normal((len(o), S)) for o in offs]
    s_pad = S + 5
    g_pad = [np.pad(v, ((0, 0), (0, 5))) for v in g]
    pf = jnp.pad(jst.coarse_to_fine(jnp.asarray(data["p"]), COARSE, FINE), (0, 5))
    want = jnp.stack([jst.dia_spmv(jnp.asarray(g_pad[i]), pf, offs[i]) for i in range(3)])
    got = tst.dia_grad_apply([torch.from_numpy(v) for v in g_pad], torch.from_numpy(data["p"]),
                             offs, COARSE, FINE, s_pad)
    _close(got, want)
    u = jnp.asarray(data["u"])
    acc = sum(jst.dia_spmv(jnp.asarray(g[i]), u[i], offs[i]) for i in range(3))
    want = jst.fine_to_coarse(acc, COARSE, FINE)
    got = tst.dia_div_apply([torch.from_numpy(v) for v in g], torch.from_numpy(data["u"]),
                            offs, COARSE, FINE)
    _close(got, want)


@pytest.mark.parametrize("radius", [1, 2])
def test_patches_grad_and_div_match_jax(data, radius):
    win = data["rng"].standard_normal((3, (2 * radius + 1) ** 3, S))
    want = jst.patches_grad_apply(jnp.asarray(win), jnp.asarray(data["p"]), COARSE, FINE, radius)
    got = tst.patches_grad_apply(torch.from_numpy(win), torch.from_numpy(data["p"]), COARSE,
                                 FINE, radius)
    _close(got, want)
    want = jst.patches_div_apply(jnp.asarray(win), jnp.asarray(data["u"]), COARSE, FINE, radius)
    got = tst.patches_div_apply(torch.from_numpy(win), torch.from_numpy(data["u"]), COARSE,
                                FINE, radius)
    _close(got, want)


def test_transfers_match_jax_and_are_adjoint(data):
    r, xc = data["x"], data["p"]
    _close(tmg.mg_restrict(torch.from_numpy(r), FINE), jmg.mg_restrict(jnp.asarray(r), FINE))
    _close(tmg.mg_prolong(torch.from_numpy(xc), COARSE, FINE),
           jmg.mg_prolong(jnp.asarray(xc), COARSE, FINE))
    lhs = float(torch.dot(tmg.mg_prolong(torch.from_numpy(xc), COARSE, FINE),
                          torch.from_numpy(r)))
    rhs = float(torch.dot(torch.from_numpy(xc), tmg.mg_restrict(torch.from_numpy(r), FINE)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def _pinned_grid_z(n, z_mode):
    """(Z grid-ordered CSR, dims, pin grid id) of an n^3-element cavity, as
    ``tests/test_multigrid.py`` builds it."""
    deck = cavity_deck(n, viscosity=0.01, dt=1e-3)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    tab = build_element_tables(mesh.coords, mesh.ltog_node, etype=deck.etype,
                               nenv=deck.nenv, nenp=deck.nenp, ngp=deck.ngp)
    ops = assemble_operators(tab, mesh.ltog_node, mesh.nn, deck.nnp,
                             viscosity=deck.viscosity, density=deck.density, z_mode=z_mode)
    Z = ops.Z.tocsr().copy()
    pin = deck.zero_pressure_node
    Z[pin, pin] = Z[pin, pin] * 1000.0
    perm_p = detect_structured_grid(mesh.coords[: deck.nnp]).flat_of_node
    inv_p = np.argsort(perm_p)
    return Z[inv_p][:, inv_p].tocsr(), detect_structured_grid(mesh.coords[: deck.nnp]).dims, \
        int(perm_p[pin])


@pytest.fixture(scope="module", params=["product", "direct"])
def ladder(request):
    """Both packages' hierarchies of one pinned Z (f64), and the Z."""
    Zg, dims, pin = _pinned_grid_z(8, request.param)
    return (Zg, dims, pin, jmg.build_mg_hierarchy(Zg, dims, dtype=np.float64),
            tmg.build_mg_hierarchy(Zg, dims, dtype=np.float64))


def test_hierarchy_bit_equal(ladder):
    _, _, _, ref, got = ladder
    assert len(ref["wins"]) >= 2
    assert got["dims"] == ref["dims"] and got["radii"] == ref["radii"]
    assert got["omegas"] == ref["omegas"]
    for key in ("wins", "diags"):
        assert len(got[key]) == len(ref[key])
        for a, b in zip(got[key], ref[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["zinv"], ref["zinv"])


def test_hierarchy_f32_tables_bit_equal():
    Zg, dims, _ = _pinned_grid_z(6, "product")
    ref = jmg.build_mg_hierarchy(Zg, dims)
    got = tmg.build_mg_hierarchy(Zg, dims)
    assert got["zinv"].dtype == np.float32
    for a, b in zip(got["wins"] + got["diags"] + [got["zinv"]],
                    ref["wins"] + ref["diags"] + [ref["zinv"]]):
        np.testing.assert_array_equal(a, b)


def test_vcycle_matches_jax(ladder):
    Zg, dims, pin, ref, got = ladder
    jp = {}
    tp = {}
    for lvl, (w, dg) in enumerate(zip(ref["wins"], ref["diags"])):
        jp[f"mg_win_{lvl}"], jp[f"mg_diag_{lvl}"] = jnp.asarray(w), jnp.asarray(dg)
        tp[f"mg_win_{lvl}"], tp[f"mg_diag_{lvl}"] = torch.from_numpy(w), torch.from_numpy(dg)
    jp["mg_zinv"], tp["mg_zinv"] = jnp.asarray(ref["zinv"]), torch.from_numpy(ref["zinv"])
    b = np.random.default_rng(3).standard_normal(Zg.shape[0])
    b[pin] = 0.0
    want = jmg.make_vcycle(jp, ref["dims"], ref["radii"], ref["omegas"])(jnp.asarray(b))
    _close(tmg.make_vcycle(tp, got["dims"], got["radii"], got["omegas"])(torch.from_numpy(b)),
           want)


def test_attach_hierarchy_follows_the_precond_choice():
    """A thin slab stalls the coarsening: under "auto" nothing is attached
    (Jacobi), under "mg" the ValueError is raised, as the JAX package does."""
    class _Solver:
        def __init__(self, precond):
            self.config = type("cfg", (), {"pressure_precond": precond})()
            self.use_mg = False

    dims = (33, 33, 3)
    Z = sp.identity(int(np.prod(dims)), format="csr")
    auto, d = _Solver("auto"), {}
    assert not tmg.attach_hierarchy(auto, d, Z, dims, np.float64)
    assert not auto.use_mg and d == {}
    with pytest.raises(ValueError, match="coarsening stalled"):
        tmg.attach_hierarchy(_Solver("mg"), {}, Z, dims, np.float64)


def test_mg_hierarchy_raises_on_thin_slab_grid():
    """The counterpart of ``tests/test_multigrid.py::
    test_mg_hierarchy_raises_on_thin_slab_grid``."""
    dims = (33, 33, 3)
    Z = sp.identity(int(np.prod(dims)), format="csr")
    with pytest.raises(ValueError, match="coarsening stalled"):
        tmg.build_mg_hierarchy(Z, dims)
