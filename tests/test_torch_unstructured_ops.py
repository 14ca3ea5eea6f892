"""PyTorch port: the unstructured path's ops (``ops/spmv.py``,
``ops/gradient.py``, ``ops/banded.py``) against the JAX package's on the
same seeded inputs.

The connectivity is a real one (the promoted mesh of a small
backward-facing step); tables and fields are seeded random values.  Each
op is held to 1e-6 (f32) and 1e-12 (f64) of its largest |term| (the op
run on |inputs| in f64): two implementations of one sum, taken in another
order where the port batches through ``bmm``.  The reverse-incidence
scatter sums in the JAX package's order, so it is bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators as jax_assemble
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables as jax_tables
from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh as jax_promote
from cfd_with_cuda_tpu.ops import banded as jb
from cfd_with_cuda_tpu.ops import gradient as jg
from cfd_with_cuda_tpu.ops import spmv as js
from cfd_with_cuda_tpu_torch.fem.sparse import build_csr_pattern, ell_from_csr
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck
from cfd_with_cuda_tpu_torch.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu_torch.ops import banded as tb
from cfd_with_cuda_tpu_torch.ops import gradient as tg
from cfd_with_cuda_tpu_torch.ops import spmv as ts

torch.set_num_threads(1)

DTYPES = [(np.float32, 1e-6), (np.float64, 1e-12)]
IDS = ["f32", "f64"]


@pytest.fixture(scope="module")
def mesh():
    deck = bfs_deck(6, 2, 2, lengths=(6.0, 2.0, 2.0), step_frac=(0.34, 0.5))
    m = promote_hex_mesh(deck.conn, deck.coords)
    ltog = np.asarray(m.ltog_node, dtype=np.int32)             # (NE, 27)
    return dict(nn=m.nn, nnp=deck.nnp, ltog=ltog, ltog_p=np.ascontiguousarray(ltog[:, :8]),
                ne=ltog.shape[0])


def _rand(rng, dtype, *shape):
    return rng.standard_normal(shape).astype(dtype)


def _check(got, ref, scale, rel):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = float(np.asarray(scale).max())
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_reverse_incidence_scatter_is_bit_equal(mesh):
    """Same positions, same order as the JAX table: equal sums bit for bit,
    in f32 as in f64."""
    rng = np.random.default_rng(0)
    ltog = mesh["ltog"]
    rev_t = ts.build_reverse_incidence(ltog, mesh["nn"])
    rev_j = js.build_reverse_incidence(ltog.T, mesh["nn"])
    assert rev_t.shape == rev_j.shape and rev_t.dtype == np.int32
    for dtype in (np.float32, np.float64):
        vals = _rand(rng, dtype, mesh["ne"], 27, 3)
        got = ts.scatter_nodes_rev(_t(vals), _t(rev_t)).numpy()
        ref = js.scatter_nodes_rev(jnp.asarray(np.transpose(vals, (2, 1, 0))), jnp.asarray(rev_j))
        np.testing.assert_array_equal(got.T, np.asarray(ref))
        got2 = ts.scatter_nodes(_t(vals), _t(ltog), mesh["nn"]).numpy()
        ref2 = js.scatter_nodes(jnp.asarray(np.transpose(vals, (2, 1, 0))), jnp.asarray(ltog.T),
                                mesh["nn"])
        np.testing.assert_array_equal(got2.T, np.asarray(ref2))


@pytest.mark.parametrize("dtype,rel", DTYPES, ids=IDS)
def test_elemental_applies_match_jax(mesh, dtype, rel):
    rng = np.random.default_rng(1)
    ne, nn, nnp = mesh["ne"], mesh["nn"], mesh["nnp"]
    ltog, ltog_p = mesh["ltog"], mesh["ltog_p"]
    rev = ts.build_reverse_incidence(ltog, nn)
    rev_p = ts.build_reverse_incidence(ltog_p, nnp)
    rev_j = js.build_reverse_incidence(ltog.T, nn)
    rev_pj = js.build_reverse_incidence(ltog_p.T, nnp)
    ke = _rand(rng, dtype, ne, 27, 27)
    ge = _rand(rng, dtype, ne, 3, 27, 8)
    x = _rand(rng, dtype, 3, nn)
    p = _rand(rng, dtype, nnp)
    T = lambda *a: [_t(v) for v in a]
    A = lambda *a: [_t(np.abs(v).astype(np.float64)) for v in a]

    got = ts.elem_matvec_apply(*T(ke), _t(x), _t(ltog), _t(rev))
    ref = js.elem_matvec_apply(jnp.asarray(np.transpose(ke, (1, 2, 0))), jnp.asarray(x),
                               jnp.asarray(ltog.T), jnp.asarray(rev_j))
    scale = ts.elem_matvec_apply(*A(ke), *A(x), _t(ltog), _t(rev))
    _check(got, ref, scale, rel)
    assert got.dtype == torch.from_numpy(x).dtype

    ge_j = jnp.asarray(np.transpose(ge, (1, 2, 3, 0)))
    got = ts.elem_grad_apply(_t(ge), _t(p), _t(ltog_p), _t(rev))
    ref = js.elem_grad_apply(ge_j, jnp.asarray(p), jnp.asarray(ltog_p.T), jnp.asarray(rev_j))
    _check(got, ref, ts.elem_grad_apply(*A(ge), *A(p), _t(ltog_p), _t(rev)), rel)

    got = ts.elem_div_apply(_t(ge), _t(x), _t(ltog), _t(rev_p))
    ref = js.elem_div_apply(ge_j, jnp.asarray(x), jnp.asarray(ltog.T), jnp.asarray(rev_pj))
    _check(got, ref, ts.elem_div_apply(*A(ge), *A(x), _t(ltog), _t(rev_p)), rel)


def _conv_inputs(mesh, dtype, seed):
    rng = np.random.default_rng(seed)
    ne, nn = mesh["ne"], mesh["nn"]
    sv = _rand(rng, dtype, 8, 27)
    gdsv = _rand(rng, dtype, ne, 3, 27, 8)
    gq = np.abs(_rand(rng, dtype, ne, 8))
    u0 = _rand(rng, dtype, 3, nn)
    port = (_t(sv), _t(gdsv), _t(gq))
    jax_ = (jnp.asarray(sv), jnp.asarray(np.transpose(gdsv, (1, 2, 3, 0))), jnp.asarray(gq.T))
    absd = tuple(_t(np.abs(v).astype(np.float64)) for v in (sv, gdsv, gq))
    return rng, u0, port, jax_, absd


@pytest.mark.parametrize("stab", [0.0, 0.5], ids=["plain", "conv_stab"])
@pytest.mark.parametrize("dtype,rel", DTYPES, ids=IDS)
def test_convection_matches_jax(mesh, dtype, rel, stab):
    """Ae(u0) (elemental), A(u0) uprev (matrix-free) and the assembled CSR
    values of A(u0), with and without Temam's term."""
    rng, u0, port, jax_, absd = _conv_inputs(mesh, dtype, 2)
    ltog = mesh["ltog"]
    u0_abs = _t(np.abs(u0).astype(np.float64))
    got = ts.convection_elemental(_t(u0), _t(ltog), *port, stab_coef=stab)
    ref = js.convection_elemental(jnp.asarray(u0), jnp.asarray(ltog.T), *jax_, stab_coef=stab)
    scale = ts.convection_elemental(u0_abs, _t(ltog), *absd, stab_coef=stab)
    _check(got, np.transpose(np.asarray(ref), (2, 0, 1)), scale, rel)

    up = _rand(rng, dtype, 3, mesh["nn"])
    rev = _t(ts.build_reverse_incidence(ltog, mesh["nn"]))
    got = ts.convection_apply(_t(u0), _t(up), _t(ltog), *port, rev, stab_coef=stab)
    ref = js.convection_apply(jnp.asarray(u0), jnp.asarray(up), jnp.asarray(ltog.T), *jax_,
                              mesh["nn"], stab_coef=stab)
    scale = ts.convection_apply(u0_abs, _t(np.abs(up).astype(np.float64)), _t(ltog), *absd,
                                rev, stab_coef=stab)
    _check(got, ref, scale, rel)

    pat = build_csr_pattern(ltog, ltog, mesh["nn"], mesh["nn"])
    scatter = pat.scatter.reshape(mesh["ne"], -1)
    rev_m = _t(ts.build_reverse_incidence(scatter, pat.nnz))
    got = ts.convection_assemble_csr(_t(u0), _t(ltog), *port, rev_m, stab_coef=stab)
    ref = js.convection_assemble_csr(jnp.asarray(u0), jnp.asarray(ltog.T), *jax_,
                                     jnp.asarray(np.transpose(pat.scatter, (1, 2, 0))),
                                     pat.nnz, stab_coef=stab)
    scale = ts.convection_assemble_csr(u0_abs, _t(ltog), *absd, rev_m, stab_coef=stab)
    _check(got, ref, scale, rel)


@pytest.mark.parametrize("dtype,rel", DTYPES, ids=IDS)
def test_ell_ops_match_jax(mesh, dtype, rel):
    """ELL SpMV (one and three components), G p and G^T u on ELL tables of
    the mesh's patterns with seeded values."""
    rng = np.random.default_rng(3)
    nn, nnp, ltog, ltog_p = mesh["nn"], mesh["nnp"], mesh["ltog"], mesh["ltog_p"]
    pat = build_csr_pattern(ltog, ltog, nn, nn)
    ell = ell_from_csr(pat, values=_rand(rng, np.float64, pat.nnz))
    vals, cols = ell.vals.astype(dtype), ell.cols
    x = _rand(rng, dtype, 3, nn)
    for xx in (x, x[1]):
        got = ts.ell_spmv(_t(vals), _t(cols), _t(xx))
        ref = js.ell_spmv(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(xx))
        _check(got, ref, ts.ell_spmv(_t(np.abs(vals).astype(np.float64)), _t(cols),
                                     _t(np.abs(xx).astype(np.float64))), rel)

    pg = build_csr_pattern(ltog, ltog_p, nn, nnp)
    g_ell = ell_from_csr(pg)
    g_vals = np.stack([g_ell.with_values(_rand(rng, np.float64, pg.nnz))
                       for _ in range(3)]).astype(dtype)
    p = _rand(rng, dtype, nnp)
    got = tg.grad_apply(_t(g_vals), _t(g_ell.cols), _t(p))
    ref = jg.grad_apply(jnp.asarray(g_vals), jnp.asarray(g_ell.cols), jnp.asarray(p))
    _check(got, ref, tg.grad_apply(_t(np.abs(g_vals).astype(np.float64)), _t(g_ell.cols),
                                   _t(np.abs(p).astype(np.float64))), rel)

    pgt = build_csr_pattern(ltog_p, ltog, nnp, nn)
    gt_ell = ell_from_csr(pgt)
    gt_vals = np.stack([gt_ell.with_values(_rand(rng, np.float64, pgt.nnz))
                        for _ in range(3)]).astype(dtype)
    got = tg.div_apply(_t(gt_vals), _t(gt_ell.cols), _t(x))
    ref = jg.div_apply(jnp.asarray(gt_vals), jnp.asarray(gt_ell.cols), jnp.asarray(x))
    _check(got, ref, tg.div_apply(_t(np.abs(gt_vals).astype(np.float64)), _t(gt_ell.cols),
                                  _t(np.abs(x).astype(np.float64))), rel)


def _product_z(n, cluster, scramble_seed=None):
    """The explicit solver's pinned product Z of ``cavity_deck(n)``, from
    the JAX package's setup, optionally with its numbering scrambled."""
    deck = jax_cavity_deck(n, cluster=cluster, viscosity=0.01, dt=1e-3)
    mesh = jax_promote(deck.conn, deck.coords)
    tab = jax_tables(mesh.coords, mesh.ltog_node, etype=deck.etype, nenv=deck.nenv,
                     nenp=deck.nenp, ngp=deck.ngp)
    ops = jax_assemble(tab, mesh.ltog_node, mesh.nn, deck.nnp, viscosity=deck.viscosity,
                       density=deck.density, z_mode="product")
    z = ops.Z.tocsr().copy()
    z[deck.zero_pressure_node, deck.zero_pressure_node] *= 1000.0
    if scramble_seed is not None:
        perm = np.random.default_rng(scramble_seed).permutation(z.shape[0])
        z = z[perm][:, perm].tocsr()
    return z


@pytest.mark.parametrize("dtype,rel", DTYPES, ids=IDS)
def test_banded_matches_jax(dtype, rel):
    """``banded_from_csr`` equal to the JAX package's; ``banded_spmv``
    (zero-filled shifts) against ``banded_spmv_xla`` (``jnp.roll``) on the
    generator numbering and on the scrambled -> RCM numbering of
    ``tests/test_banded.py:52-80`` (on ``cavity_deck(6)``, whose RCM band
    keeps the JAX apply's compile short), and against the CSR product."""
    z = _product_z(4, 1.3)
    zs = _product_z(6, 0.0, scramble_seed=1)
    assert tb.banded_from_csr(zs, max_offsets=512) is None
    assert jb.banded_from_csr(zs, max_offsets=512) is None
    r = tb.rcm_permutation(zs)
    np.testing.assert_array_equal(r, jb.rcm_permutation(zs))
    zr = zs[r][:, r]
    rng = np.random.default_rng(4)
    # the JAX apply of the RCM band (437 rolls) compiles for ~30 s: once, in f64
    for a, cap, vs_jax in ((z, 512, True), (zr, 1024, dtype == np.float64)):
        offs, win = tb.banded_from_csr(a, max_offsets=cap)
        offs_j, win_j = jb.banded_from_csr(a, max_offsets=cap)
        assert offs == offs_j
        np.testing.assert_array_equal(win, win_j)
        w = win.astype(dtype)
        x = _rand(rng, dtype, a.shape[0])
        got = tb.banded_spmv(_t(w), offs, _t(x))
        scale = tb.banded_spmv(_t(np.abs(w).astype(np.float64)), offs,
                               _t(np.abs(x).astype(np.float64)))
        if vs_jax:
            ref = jb.banded_spmv_xla(jnp.asarray(w), offs, jnp.asarray(x))
            _check(got, ref, scale, rel)
        _check(got, a @ x.astype(np.float64), scale, max(rel, 1e-6))
        # a (C, N) batch applies per row
        xb = np.stack([x, 2 * x])
        np.testing.assert_allclose(tb.banded_spmv(_t(w), offs, _t(xb))[1].numpy(),
                                   2 * got.numpy(), rtol=0, atol=rel * float(np.asarray(scale).max()))
