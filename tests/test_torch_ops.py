"""PyTorch port: each op with a kernel, in its plain version, matches the
JAX function (its Pallas kernel in interpret mode) on the same inputs.

Inputs are made from a seed with numpy at the ``cavity_deck(4)`` parity
shapes (Sp = 2048) and handed to both packages as f32 arrays.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers take CPU tensors, so they run the plain versions, and the launch
counters must not move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.ops import parity_stencil as jps
from cfd_with_cuda_tpu.ops.pallas_cg import fused_cg as jax_fused_cg
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch import device as port_device
from cfd_with_cuda_tpu_torch.interop import tables_from_jax
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import parity_stencil as tps
from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg
from cfd_with_cuda_tpu_torch.ops.window_stencil import div_class_pairs, div_compact

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def js():
    s = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.001),
        JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                  structured_layout="parity", setup_cache="off",
                  pressure_cg_fuse_loop=True, pressure_warm_start=True),
    )
    assert s.layout == "parity"
    return s


@pytest.fixture(scope="module")
def tabs(js):
    attrs = {"nnp": js.nnp, "z_radius": js.z_radius}
    return tables_from_jax({k: np.asarray(v) for k, v in js.d.items()}, attrs)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(got, ref, rel, what):
    """max |got - ref| <= rel * max|ref| (both f32)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32, what
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (what, err, scale)


# f32 tolerance of the window applies: both sides sum the same terms in the
# same order; XLA:CPU may contract a multiply-add into an FMA where torch
# rounds the product, so each of up to 1241 terms can differ by one
# rounding — 2e-6 of the output scale covers that with margin.
APPLY_REL = 2e-6


def test_parity_apply_k_matches(js):
    rng = np.random.default_rng(1)
    u = _f32(rng, (3, 8, js.sp_c))
    ref = jps.parity_apply(js.d["Kp"], jnp.asarray(u), pairs=js.k_pairs, co=3)
    before = dict(cuda_lib.launch_counts)
    got = tps.parity_apply(_t(np.asarray(js.d["Kp"])), _t(u), pairs=js.k_pairs, co=3)
    assert cuda_lib.launch_counts == before
    _check(got.numpy(), ref, APPLY_REL, "K u")


def test_parity_apply_grad_matches(js):
    rng = np.random.default_rng(2)
    p = np.zeros((1, 1, js.sp_c), np.float32)
    p[0, 0, : js.nnp] = _f32(rng, js.nnp)
    ref = jps.parity_apply(js.d["Gp"], jnp.asarray(p), pairs=js.g_pairs, co=3)
    got = tps.parity_apply(_t(np.asarray(js.d["Gp"])), _t(p), pairs=js.g_pairs, co=3)
    _check(got.numpy(), ref, APPLY_REL, "G p")


def _conv_planes(js, seed):
    rng = np.random.default_rng(seed)
    ne = int(np.prod(js.elem_dims))
    ae = _f32(rng, (27, 27, ne))
    ae_e = jps.embed_elem_table(ae, js.elem_dims, js.coarse_dims, js.sp_c)
    return np.ascontiguousarray(ae_e[np.asarray(js.conv_i_order)])


def test_conv_planes_from_ae_matches(js):
    ae = _conv_planes(js, 3)
    ref = jps.conv_planes_from_ae(jnp.asarray(ae), groups=js.conv_groups)
    got = tps.conv_planes_from_ae(_t(ae), groups=js.conv_groups)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))   # pure data movement


def test_parity_apply_k_plus_planes_matches(js):
    rng = np.random.default_rng(4)
    u = _f32(rng, (3, 8, js.sp_c))
    ae = _conv_planes(js, 5)
    planes_j = jps.conv_planes_from_ae(jnp.asarray(ae), groups=js.conv_groups)
    ref = jps.parity_apply(js.d["Kp"], jnp.asarray(u), pairs=js.k_pairs, co=3,
                           wc2=planes_j, pairs2=js.conv_pairs2, blk=512)
    planes_t = tps.conv_planes_from_ae(_t(ae), groups=js.conv_groups)
    got = tps.parity_apply(_t(np.asarray(js.d["Kp"])), _t(u), pairs=js.k_pairs, co=3,
                           wc2=planes_t, pairs2=js.conv_pairs2)
    _check(got.numpy(), ref, APPLY_REL, "(K + A) u")


def test_parity_div_apply_matches(js):
    rng = np.random.default_rng(6)
    u = _f32(rng, (3, 8, js.sp_c))
    ref = jps.parity_div_apply(js.d["GT_cwin"], jnp.asarray(u), js.coarse_dims)
    got = tps.parity_div_apply(_t(np.asarray(js.d["GT_cwin"])), _t(u), js.coarse_dims)
    _check(got.numpy(), ref, APPLY_REL, "G^T u")


def test_div_compact_plain_is_the_kernel_sum():
    """Independent float64 reference of the compact divergence: the
    explicit triple loop over (slot, direction) with zero outside [0, Sp)."""
    rng = np.random.default_rng(7)
    cdims, sp = (5, 5, 5), 256
    pairs = div_class_pairs(cdims)
    gt = rng.standard_normal((3, 125, sp))
    u = rng.standard_normal((3, 8, sp))
    ref = np.zeros(sp)
    for s, (cls, off) in enumerate(pairs):
        for q in range(sp):
            if 0 <= q + off < sp:
                ref[q] += sum(gt[d, s, q] * u[d, cls, q + off] for d in range(3))
    got = div_compact(_t(gt), _t(u), pairs).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_parity_gather_elem_flat_matches(js):
    rng = np.random.default_rng(8)
    u = _f32(rng, (3, 8, js.sp_c))
    ref = jps.parity_gather_elem_flat(jnp.asarray(u), js.coarse_dims)
    got = tps.parity_gather_elem_flat(_t(u), js.coarse_dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_split_merge_match(js):
    rng = np.random.default_rng(9)
    s = int(np.prod(js.fine_dims))
    u = _f32(rng, (3, s))
    ref = jps.parity_split(jnp.asarray(u), js.fine_dims)
    got = tps.parity_split(_t(u), js.fine_dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tps.parity_merge(got, js.fine_dims).numpy(), u)
    np.testing.assert_array_equal(tps.parity_split_table(u, js.fine_dims), got.numpy())


# ------------------------------------------------------------ pressure CG

def _cg_pair(js, tabs, b, x0):
    """(JAX fused_cg(fuse_loop=True) on the DMA-block layout, port fused_cg
    on the plain window) for the solver's pinned Z."""
    ref = jax_fused_cg(
        js.d["Z_win_cg"], jnp.asarray(b), js.d["Z_dinv_cg"], dims=js.coarse_dims,
        radius=js.z_radius, tol=1e-6, maxiter=1000, fuse_loop=True,
        x0=None if x0 is None else jnp.asarray(x0),
    )
    got = fused_cg(
        tabs["Z_win"], _t(b), tabs["Z_dinv"], dims=js.coarse_dims, radius=js.z_radius,
        tol=1e-6, maxiter=1000, x0=None if x0 is None else _t(x0),
    )
    return ref, got


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fused_cg_matches(js, tabs, start):
    """Same iterates up to f32 summation order: equal iteration counts,
    x to 1e-5 of its scale (the dots sum in another order on each side,
    and a CG of tens of iterations amplifies that round-off)."""
    rng = np.random.default_rng(10)
    b = _f32(rng, js.nnp)
    b[js.pin_grid] = 0.0
    x0 = None
    if start == "warm":
        cold, _ = _cg_pair(js, tabs, b, None)
        x0 = (np.asarray(cold.x) + 1e-3 * _f32(rng, js.nnp)).astype(np.float32)
    ref, got = _cg_pair(js, tabs, b, x0)
    assert int(got.iters) == int(ref.iters) > 0
    _check(got.x.numpy(), ref.x, 1e-5, f"x ({start})")
    assert float(got.residual) <= 1e-6 * float(np.linalg.norm(b)) * (1 + 1e-5)


def test_fused_cg_zero_rhs(js, tabs):
    """b = 0: x = 0 after 0 iterations cold; warm-started it iterates
    toward 0 and stays finite (bound = tol * ||b|| = 0)."""
    b = np.zeros(js.nnp, np.float32)
    ref, got = _cg_pair(js, tabs, b, None)
    assert int(got.iters) == int(ref.iters) == 0
    np.testing.assert_array_equal(got.x.numpy(), b)
    x0 = np.full(js.nnp, 0.3, np.float32)
    ref, got = _cg_pair(js, tabs, b, x0)
    assert int(got.iters) == int(ref.iters)
    assert np.isfinite(got.x.numpy()).all()


# ------------------------------------------------------------ wrappers

def test_wrappers_take_plain_path_on_cpu(js, tabs):
    """A CPU tensor goes to the plain version: equal results, counters unmoved."""
    rng = np.random.default_rng(11)
    u = _t(_f32(rng, (3, 8, js.sp_c)))
    kp = _t(np.asarray(js.d["Kp"]))
    cuda_lib.reset_launch_counts()
    y = tps.parity_apply(kp, u, pairs=js.k_pairs, co=3)
    torch.testing.assert_close(y, tps.parity_apply_plain(kp, u, pairs=js.k_pairs, co=3),
                               rtol=0, atol=0)
    gt = _t(np.asarray(js.d["GT_cwin"]))
    torch.testing.assert_close(tps.parity_div_apply(gt, u, js.coarse_dims),
                               tps.parity_div_apply_plain(gt, u, js.coarse_dims),
                               rtol=0, atol=0)
    b = tabs["Z_dinv"].clone()
    fused_cg(tabs["Z_win"], b, tabs["Z_dinv"], dims=js.coarse_dims, radius=2,
             tol=1e-6, maxiter=5)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())


def test_wrappers_reject_other_devices(js):
    u = torch.empty((3, 8, js.sp_c), device="meta")
    kp = torch.empty((1, 512, js.sp_c), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tps.parity_apply(kp, u, pairs=js.k_pairs, co=3)
    with pytest.raises(ValueError, match="unsupported device"):
        tps.parity_div_apply(torch.empty((3, 125, js.sp_c), device="meta"), u, js.coarse_dims)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_route_table_layout_and_bounds(js):
    """The kernel's route: 9 class offsets, then (table, j, p_in, dq) per
    entry, the first table's entries of a class before the second's; a
    route reading outside the weights or the field is refused."""
    m = int(js.d["Kp"].shape[1])
    route = tps._route_table(js.k_pairs, js.conv_pairs2, m, 729, 8, torch.device("cpu"))
    heads = route[:9].tolist()
    ents = route[9:].reshape(-1, 4).tolist()
    assert heads[0] == 0 and heads[8] == len(ents) == m + 729
    for p in range(8):
        cls = ents[heads[p]: heads[p + 1]]
        n1 = len(js.k_pairs[p])
        assert [tuple(e[1:]) for e in cls[:n1]] == list(js.k_pairs[p])
        assert [tuple(e[1:]) for e in cls[n1:]] == list(js.conv_pairs2[p])
        assert [e[0] for e in cls] == [0] * n1 + [1] * (len(cls) - n1)
    with pytest.raises(ValueError, match="outside"):
        tps._route_table(js.k_pairs, None, m - 1, 0, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="outside"):
        tps._route_table(js.k_pairs, None, m, 0, 1, torch.device("cpu"))


def test_route_cache_keyed_by_route_identity_not_weights(js):
    """A solver passes the same route tuples every call (new weights every
    step on the implicit path): the route table is looked up by the tuples'
    identity, without hashing the ~10^3-entry route, and the weights are no
    part of the key."""
    m = int(js.d["Kp"].shape[1])
    dev = torch.device("cpu")
    tps._routes_by_id.clear()
    first = tps._route_for(js.k_pairs, None, m, 0, 8, dev)
    assert tps._route_for(js.k_pairs, None, m, 0, 8, dev) is first
    assert len(tps._routes_by_id) == 1
    # an equal route in another tuple object: a second entry, the same table
    copy = tuple(tuple(cls) for cls in js.k_pairs)
    assert copy is not js.k_pairs and copy == js.k_pairs
    assert torch.equal(tps._route_for(copy, None, m, 0, 8, dev), first)
    assert len(tps._routes_by_id) == 2
    # the entry holds its tuples, so their ids cannot be reused while cached
    assert all(hit[1] is not None for hit in tps._routes_by_id.values())


def test_merge_matrix_and_diag_planes_match_jax(js):
    """The implicit path's host half: conv_plane_merge_matrix and
    diag_plane_indices equal the JAX package's on the explicit solver's K
    route, and a route with a plane missing is refused."""
    local_off = js.local_off
    sel_j = jps.conv_plane_merge_matrix(local_off, js.conv_i_order, js.k_pairs, js.coarse_dims)
    sel_t = tps.conv_plane_merge_matrix(local_off, js.conv_i_order, js.k_pairs, js.coarse_dims)
    np.testing.assert_array_equal(sel_t, sel_j)
    assert sel_t.dtype == np.float32 and (sel_t.sum(axis=0) == 1.0).all()
    assert tps.diag_plane_indices(js.k_pairs) == jps.diag_plane_indices(js.k_pairs)
    short = (js.k_pairs[0][:-1],) + tuple(js.k_pairs[1:])
    with pytest.raises(ValueError, match="absent"):
        tps.conv_plane_merge_matrix(local_off, js.conv_i_order, short, js.coarse_dims)
