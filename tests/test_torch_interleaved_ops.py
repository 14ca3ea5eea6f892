"""PyTorch port: the ops of the interleaved structured layout match the JAX
package's on the same inputs.

* The window applies (``window_spmv``, ``grad_window``, ``div_window``, and
  ``window_spmv_compact`` on the class-compacted K table; CUDA
  kernel ``csrc/window_stencil.cu``) in their plain versions against the
  Pallas kernels in interpret mode, on the ``cavity_deck(5)`` operators of
  ``tests/test_pallas_stencil.py:35-49``, in f64 at that file's 1e-12.
* ``div_compact_interleaved`` against ``pallas_div_compact``, and the class
  split it runs (``parity_split``) against ``_extract_classes``.
* The stride-2 elemental ops of ``ops/stencil.py`` and
  ``parity_scatter_elem_flat`` against their JAX functions: bit-equal where
  both sum the same terms in the same order.

Inputs are made from a numpy seed.  The wrappers take CPU tensors, so they
run the plain versions and the launch counters must not move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.fem.assembly import assemble_operators
from cfd_with_cuda_tpu.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu.fem.structured import detect_structured_grid, dia_from_csr
from cfd_with_cuda_tpu.fem.structured import shard_pad_size as jax_shard_pad_size
from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu.ops import parity_stencil as jps
from cfd_with_cuda_tpu.ops import pallas_stencil as jpst
from cfd_with_cuda_tpu.ops import stencil as jst
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.fem.structured import shard_pad_size
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import parity_stencil as tps
from cfd_with_cuda_tpu_torch.ops import stencil as tst
from cfd_with_cuda_tpu_torch.ops import window_stencil as tws
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

F64_TOL = 1e-12          # tests/test_pallas_stencil.py:71, 84, 116, 123
# f32 tolerance of a window apply: both sides sum the same terms in the same
# order; XLA:CPU may contract a multiply-add into an FMA where torch rounds
# the product, so each of up to 125 terms can differ by one rounding
APPLY_REL = 2e-6


@pytest.fixture(scope="module")
def cavity_ops():
    """The f64 operators of tests/test_pallas_stencil.py:35-49, as numpy."""
    deck = jax_cavity_deck(5, cluster=1.0, viscosity=0.01, dt=1e-3)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    tab = build_element_tables(mesh.coords, mesh.ltog_node, etype=deck.etype,
                               nenv=deck.nenv, nenp=deck.nenp, ngp=deck.ngp)
    ops = assemble_operators(tab, mesh.ltog_node, mesh.nn, deck.nnp,
                             viscosity=deck.viscosity, density=deck.density,
                             z_mode="product")
    gi = detect_structured_grid(mesh.coords)
    gi_p = detect_structured_grid(mesh.coords[: deck.nnp])
    return deck, mesh, ops, gi, gi_p


@pytest.fixture(scope="module")
def g_tables(cavity_ops):
    """(G window, G^T window, their radii) on the fine grid, f64."""
    _, _, ops, gi, gi_p = cavity_ops
    cx, cy, _ = gi_p.dims
    fx, fy, _ = gi.dims
    perm_p = gi_p.flat_of_node
    embed = (2 * (perm_p // (cx * cy)) * fy + 2 * ((perm_p // cx) % cy)) * fx + 2 * (perm_p % cx)
    g = [dia_from_csr(ops.G_csr(d), gi.flat_of_node, embed, gi.dims) for d in range(3)]
    gt = [dia_from_csr(ops.G_csr(d).T.tocsr(), embed, gi.flat_of_node, gi.dims) for d in range(3)]
    g_r, gt_r = max(x.radius for x in g), max(x.radius for x in gt)
    return (np.stack([x.window_vals(g_r, np.float64) for x in g]),
            np.stack([x.window_vals(gt_r, np.float64) for x in gt]), g_r, gt_r)


@pytest.fixture(scope="module")
def js():
    """The JAX explicit solver on its interleaved layout (cavity_deck(4), F32)."""
    s = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.001),
        JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                  structured_layout="interleaved", setup_cache="off"),
    )
    assert s.layout == "interleaved" and s.elem_structured
    return s


@pytest.fixture(autouse=True)
def no_launches():
    cuda_lib.reset_launch_counts()
    yield
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain versions on CPU


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_check(got, ref, rel, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (what, err, scale)


# ------------------------------------------------------------ window applies

def test_window_spmv_matches_pallas_z(cavity_ops):
    """Z = G^T Md^-1 G on the coarse grid (radius 2), f64."""
    _, _, ops, _, gi_p = cavity_ops
    dia = dia_from_csr(ops.Z.tocsr(), gi_p.flat_of_node, gi_p.flat_of_node, gi_p.dims)
    win = dia.window_vals(dtype=np.float64)
    p = np.random.default_rng(0).standard_normal(gi_p.size)
    ref = jpst.pallas_window_spmv(jnp.asarray(win), jnp.asarray(p), gi_p.dims, dia.radius)
    out = tws.window_spmv(_t(win), _t(p), gi_p.dims, dia.radius)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)


def test_window_spmv_matches_pallas_k_batched(cavity_ops):
    """Viscous K on the fine grid, 3 velocity channels, through its
    sparse-offset DIA form and its full window, f64."""
    _, _, ops, gi, _ = cavity_ops
    dia = dia_from_csr(ops.pattern_m.to_scipy(ops.K), gi.flat_of_node, gi.flat_of_node, gi.dims)
    u = np.random.default_rng(1).standard_normal((3, gi.size))
    win = dia.window_vals(dtype=np.float64)
    ref = jpst.pallas_window_spmv(jnp.asarray(win), jnp.asarray(u), gi.dims, dia.radius)
    out = tws.window_spmv(_t(win), _t(u), gi.dims, dia.radius)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)
    ref_o = jpst.pallas_window_spmv(jnp.asarray(dia.vals), jnp.asarray(u), gi.dims,
                                    offsets=dia.flat_offsets)
    out_o = tws.window_spmv(_t(dia.vals), _t(u), gi.dims, offsets=dia.flat_offsets)
    np.testing.assert_allclose(out_o.numpy(), np.asarray(ref_o), rtol=0, atol=F64_TOL)


def test_window_spmv_compact_matches_pallas(cavity_ops):
    """Viscous K on the fine grid on its class-compacted, class-major table
    (``window_spmv_compact``, what the interleaved solvers apply), 3 velocity
    channels, from the sparse-offset DIA form and from the full window,
    against ``pallas_window_spmv`` on the full tables, f64."""
    _, _, ops, gi, _ = cavity_ops
    dia = dia_from_csr(ops.pattern_m.to_scipy(ops.K), gi.flat_of_node, gi.flat_of_node, gi.dims)
    u = np.random.default_rng(2).standard_normal((3, gi.size))
    win = dia.window_vals(dtype=np.float64)
    for table, kw, jkw in ((dia.vals, dict(offsets=dia.flat_offsets),
                            dict(offsets=dia.flat_offsets)),
                           (win, dict(radius=dia.radius), dict(radius=dia.radius))):
        offs = kw.get("offsets") or tws.window_offsets(gi.dims, dia.radius)
        compact = tws.compact_spmv_window(np.asarray(table), offs, gi.dims)
        assert compact.size < np.asarray(table).size
        ref = jpst.pallas_window_spmv(jnp.asarray(table), jnp.asarray(u), gi.dims, **jkw)
        out = tws.window_spmv_compact(_t(compact), _t(u), gi.dims, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)


def test_grad_window_matches_pallas(cavity_ops, g_tables):
    _, _, _, gi, gi_p = cavity_ops
    g_win, _, g_r, _ = g_tables
    p = np.random.default_rng(2).standard_normal(gi_p.size)
    pf = np.asarray(jst.coarse_to_fine(jnp.asarray(p), gi_p.dims, gi.dims))
    ref = jpst.pallas_grad_window(jnp.asarray(g_win), jnp.asarray(pf), gi.dims, g_r)
    out = tws.grad_window(_t(g_win), _t(pf), gi.dims, g_r)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)
    # the plain twin is the same function on any device
    np.testing.assert_array_equal(tws.grad_window_plain(_t(g_win), _t(pf), gi.dims, g_r).numpy(),
                                  out.numpy())


def test_div_window_matches_pallas(cavity_ops, g_tables):
    _, _, _, gi, gi_p = cavity_ops
    _, gt_win, _, gt_r = g_tables
    u = np.random.default_rng(3).standard_normal((3, gi.size))
    ref = jpst.pallas_div_window(jnp.asarray(gt_win), jnp.asarray(u), gi.dims, gt_r)
    out = tws.div_window(_t(gt_win), _t(u), gi.dims, gt_r)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)
    # and onto the coarse grid, against the patches form of the JAX package
    ref_c = jst.patches_div_apply(jnp.asarray(gt_win), jnp.asarray(u), gi_p.dims, gi.dims, gt_r)
    out_c = np.asarray(jst.fine_to_coarse(jnp.asarray(out.numpy()), gi_p.dims, gi.dims))
    np.testing.assert_allclose(out_c, np.asarray(ref_c), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("trim", [True, False])
def test_prepadded_form_matches_pallas(js, trim):
    """The solver's pre-padded f32 tables (fields and tables at s_pad, zero
    weight columns beyond S), trimmed or BLK-padded."""
    d = {k: np.asarray(v) for k, v in js.d.items()}
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, js.s_pad)).astype(np.float32)
    u[:, js.nn:] = 0.0
    ref = jpst.pallas_window_spmv(jnp.asarray(d["K_vals"]), jnp.asarray(u), js.fine_dims,
                                  offsets=js.k_offsets, trim=trim)
    out = tws.window_spmv(_t(d["K_vals"]), _t(u), js.fine_dims, offsets=js.k_offsets, trim=trim)
    assert out.shape == ref.shape == ((3, js.nn) if trim else (3, js.s_pad))
    _rel_check(out.numpy(), np.asarray(ref), APPLY_REL, "K u")
    p = rng.standard_normal(js.nnp).astype(np.float32)
    pf = np.pad(np.asarray(jst.coarse_to_fine(jnp.asarray(p), js.coarse_dims, js.fine_dims)),
                (0, js.s_pad - js.nn))
    ref_g = jpst.pallas_grad_window(jnp.asarray(d["G_win"]), jnp.asarray(pf), js.fine_dims,
                                    js.g_radius, trim=trim)
    out_g = tws.grad_window(_t(d["G_win"]), _t(pf), js.fine_dims, js.g_radius, trim=trim)
    assert out_g.shape == ref_g.shape
    _rel_check(out_g.numpy(), np.asarray(ref_g), APPLY_REL, "G p")


def test_unpadded_field_is_padded_when_untrimmed(cavity_ops):
    """An S-length operand with trim=False comes back BLK-padded with zeros."""
    _, _, ops, _, gi_p = cavity_ops
    dia = dia_from_csr(ops.Z.tocsr(), gi_p.flat_of_node, gi_p.flat_of_node, gi_p.dims)
    p = np.random.default_rng(5).standard_normal(gi_p.size)
    out = tws.window_spmv(_t(dia.window_vals(dtype=np.float64)), _t(p), gi_p.dims, dia.radius,
                          trim=False)
    assert out.shape == (tws.BLK,)
    assert not out[gi_p.size:].any()


@pytest.mark.parametrize("name", ["window_spmv", "window_spmv_k", "window_spmv_k_plus_a",
                                  "window_spmv_mk_plus_a", "window_spmv_m"])
def test_window_spmv_counts_under_the_operator_name(cavity_ops, name):
    """Each operator the solvers apply has its own launch count; a name
    without one is refused before anything runs (both twins)."""
    _, _, ops, _, gi_p = cavity_ops
    dia = dia_from_csr(ops.Z.tocsr(), gi_p.flat_of_node, gi_p.flat_of_node, gi_p.dims)
    win = _t(dia.window_vals(dtype=np.float64))
    p = _t(np.random.default_rng(5).standard_normal(gi_p.size))
    assert name in cuda_lib.launch_counts
    np.testing.assert_array_equal(tws.window_spmv(win, p, gi_p.dims, dia.radius, name=name),
                                  tws.window_spmv(win, p, gi_p.dims, dia.radius))
    for fn in (tws.window_spmv, tws.window_spmv_plain):
        with pytest.raises(ValueError, match="no launch count"):
            fn(win, p, gi_p.dims, dia.radius, name=name + "_x")


# -------------------------------------------------------------- compact div

def test_parity_split_equals_extract_classes(js):
    """The class split of div_compact_interleaved is exactly _extract_classes
    (rows 3p + d of its halo-extended array)."""
    rng = np.random.default_rng(6)
    u = rng.standard_normal((3, js.s_pad)).astype(np.float32)
    s_cpad = np.asarray(js.d["GT_cwin"]).shape[-1]
    halo = 128
    ref = np.asarray(jpst._extract_classes(jnp.asarray(u), js.fine_dims, js.coarse_dims,
                                           s_cpad, halo))
    up = tps.parity_split(_t(u), js.fine_dims, s_cpad).numpy()          # (3, 8, Sp)
    got = up.transpose(1, 0, 2).reshape(24, s_cpad)                     # rows 3p + d
    np.testing.assert_array_equal(got, ref[:, halo: halo + s_cpad])
    assert not ref[:, :halo].any() and not ref[:, halo + s_cpad:].any()


def test_div_compact_interleaved_matches_pallas(js):
    d = {k: np.asarray(v) for k, v in js.d.items()}
    u = np.random.default_rng(7).standard_normal((3, js.s_pad)).astype(np.float32)
    ref = jpst.pallas_div_compact(jnp.asarray(d["GT_cwin"]), jnp.asarray(u), js.fine_dims,
                                  js.coarse_dims)
    out = tws.div_compact_interleaved(_t(d["GT_cwin"]), _t(u), js.fine_dims, js.coarse_dims)
    _rel_check(out.numpy(), np.asarray(ref), APPLY_REL, "div_compact_interleaved")
    np.testing.assert_array_equal(
        tws.div_compact_interleaved_plain(_t(d["GT_cwin"]), _t(u), js.fine_dims,
                                          js.coarse_dims).numpy(), out.numpy())
    # = the fine-grid window form strided down to the coarse rows
    fine = tws.div_window(_t(d["GT_win"]), _t(u), js.fine_dims, js.gt_radius)
    coarse = np.asarray(jst.fine_to_coarse(jnp.asarray(fine.numpy()), js.coarse_dims,
                                           js.fine_dims))
    _rel_check(out[: js.nnp].numpy(), coarse, APPLY_REL, "compact vs window form")


# ------------------------------------------------------------ elemental ops

def _elem_field(js, rng, c=3):
    return rng.standard_normal((c, js.nn)).astype(np.float32)


def test_gather_elem_stencil_bit_equal(js):
    u = _elem_field(js, np.random.default_rng(8))
    ref = np.asarray(jst.gather_elem_stencil(jnp.asarray(u), js.elem_dims, js.fine_dims))
    out = tst.gather_elem_stencil(_t(u), js.elem_dims, js.fine_dims)
    assert out.shape == ref.shape == (3, 27, int(np.prod(js.elem_dims)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_scatter_elem_stencil_bit_equal(js):
    ne = int(np.prod(js.elem_dims))
    r_e = np.random.default_rng(9).standard_normal((3, 27, ne)).astype(np.float32)
    ref = np.asarray(jst.scatter_elem_stencil(jnp.asarray(r_e), js.local_off, js.elem_dims,
                                              js.fine_dims))
    out = tst.scatter_elem_stencil(_t(r_e), js.local_off, js.elem_dims, js.fine_dims)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("i", [0, 13, 26])
def test_scatter_of_one_local_node_is_place_elem_field(js, i):
    """The scatter of values at local node i alone is the JAX package's
    placement of them at that node's lattice (``place_elem_field``)."""
    ne = int(np.prod(js.elem_dims))
    v = np.random.default_rng(10 + i).standard_normal((2, ne)).astype(np.float32)
    r_e = np.zeros((2, 27, ne), np.float32)
    r_e[:, i] = v
    ref = np.asarray(jst.place_elem_field(jnp.asarray(v), js.local_off[i], js.elem_dims,
                                          js.fine_dims))
    out = tst.scatter_elem_stencil(_t(r_e), js.local_off, js.elem_dims, js.fine_dims)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_assemble_window_values_bit_equal(js):
    """27 strided index-adds give the JAX package's 27 placements and 729
    row adds bit for bit (each output sums its terms in the same i order)."""
    ne = int(np.prod(js.elem_dims))
    ae = np.random.default_rng(11).standard_normal((27, 27, ne)).astype(np.float32)
    n_off = len(js.k_offsets)
    ref = np.asarray(jst.assemble_window_values(jnp.asarray(ae), js.local_off, js.conv_oij,
                                                n_off, js.elem_dims, js.fine_dims, js.s_pad))
    out = tst.assemble_window_values(_t(ae), js.local_off, js.conv_oij, n_off, js.elem_dims,
                                     js.fine_dims, js.s_pad)
    assert out.shape == ref.shape == (n_off, js.s_pad)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_coarse_fine_embedding_bit_equal(js):
    p = np.random.default_rng(12).standard_normal(js.nnp).astype(np.float32)
    ref = np.asarray(jst.coarse_to_fine(jnp.asarray(p), js.coarse_dims, js.fine_dims))
    out = tst.coarse_to_fine(_t(p), js.coarse_dims, js.fine_dims)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jst.fine_to_coarse(jnp.asarray(out.numpy()), js.coarse_dims, js.fine_dims)), p)


@pytest.mark.parametrize("stab", [0.0, 0.5])
def test_convection_apply_stencil_matches(js, stab):
    """The solvers' matrix-free convection (elemental matrices of u0 once,
    then gather, matvec, scatter per apply) against the JAX package's
    ``convection_apply_stencil``."""
    d = {k: np.asarray(v) for k, v in js.d.items()}
    rng = np.random.default_rng(13)
    u0, up = _elem_field(js, rng), _elem_field(js, rng)
    ref = np.asarray(jst.convection_apply_stencil(
        jnp.asarray(u0), jnp.asarray(up), jnp.asarray(d["Sv"]), jnp.asarray(d["gDSv"]),
        jnp.asarray(d["gq"]), js.local_off, js.elem_dims, js.fine_dims, stab_coef=stab))
    ae = tst.convection_elem_matrices(_t(u0), _t(d["Sv"]), _t(d["gDSv"]), _t(d["gq"]),
                                      js.elem_dims, js.fine_dims, stab_coef=stab)
    out = tst.convection_apply_elem(ae, _t(up), js.local_off, js.elem_dims, js.fine_dims)
    # einsums of up to 27 x 27 terms summed in another order: a few f32 roundings
    _rel_check(out.numpy(), ref, 1e-5, "convection")


def test_parity_scatter_elem_flat_bit_equal():
    coarse = (5, 5, 5)
    sp = 2048
    r_e = np.random.default_rng(14).standard_normal((3, 27, sp)).astype(np.float32)
    ref = np.asarray(jps.parity_scatter_elem_flat(jnp.asarray(r_e), coarse))
    out = tps.parity_scatter_elem_flat(_t(r_e), coarse)
    assert out.shape == (3, 8, sp)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("size,shard_pad,spmd,kernel", [
    (729, 1, 0, True), (729, 1, 0, False), (226981, 1, 0, True), (226981, 3, 0, True),
    (226981, 7, 2, True), (226981, 5, 0, False),
])
def test_shard_pad_size_matches(size, shard_pad, spmd, kernel):
    jcfg = JaxConfig(shard_pad=shard_pad, spmd_devices=spmd, setup_cache="off")
    cfg = SolverConfig(shard_pad=shard_pad, spmd_devices=spmd)
    assert shard_pad_size(size, cfg, kernel) == jax_shard_pad_size(size, jcfg, kernel)
