"""PyTorch port: the class-split window apply ``parity_window_apply`` (TPU
kernel ``cfd_with_cuda_tpu/ops/parity_stencil.py:213``, pallas_call at
:253) and its host tables.

On the interleaved ``cavity_deck(4)`` JAX solver's own ``K_vals`` and each
direction of ``G_win`` (as ``tests/test_parity_stencil.py:46-116``):

* ``parity_window_tables`` and ``compact_class_tables`` are bit-equal to the
  JAX package's;
* ``parity_window_apply`` (its plain version: CPU tensors) agrees with the
  JAX kernel in interpret mode, and after ``parity_merge`` with the port's
  ``window_spmv`` / ``grad_window`` on the same tables;
* the kernel's form, the resident ``parity_apply`` on the one table
  ``(1, 8 m, Sp)`` with plane p * m + w, is the same sum as the plain
  version, bit for bit;
* ``accumulate_in`` raises, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.ops import parity_stencil as jps
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import parity_stencil as tps
from cfd_with_cuda_tpu_torch.ops import window_stencil as tws
from cfd_with_cuda_tpu_torch.ops.stencil import coarse_to_fine

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

# f32, against the JAX kernel: the same terms in the same order, up to one
# rounding per term (XLA:CPU may fuse a multiply-add that torch rounds)
APPLY_REL = 2e-6
# the compacted G classes sum their live slots in another order than the
# window kernel's 125 slots: f32 noise (tests/test_parity_stencil.py:110)
G_ATOL = 1e-7
TABLES = ["k", "g0", "g1", "g2"]


@pytest.fixture(scope="module")
def js():
    s = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.001),
        JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                  setup_cache="off", structured_layout="interleaved"),
    )
    assert s.structured
    return s


def _offsets_xyz(s, table):
    """The window offsets of ``table``: K's decoded flat offsets, or the
    radius-g cube of the G windows (z-major scan)."""
    if table == "k":
        return jps.decode_offsets(s.k_offsets, s.fine_dims)
    r = s.g_radius
    return tuple((dx, dy, dz) for dz in range(-r, r + 1)
                 for dy in range(-r, r + 1) for dx in range(-r, r + 1))


def _window(s, table):
    return np.array(s.d["K_vals"] if table == "k" else s.d["G_win"][int(table[1])])


def _class_tables(mod, s, table):
    """(wp, pairs) of ``table`` in package ``mod``: K split whole, each G
    direction compacted (``tests/test_parity_stencil.py:48-116``)."""
    offs = _offsets_xyz(s, table)
    cdims, sp = mod.parity_dims(s.fine_dims)
    wp = mod.parity_window_tables(_window(s, table), offs, s.fine_dims)
    pairs = mod.parity_pairs(offs, cdims)
    return (wp, pairs) if table == "k" else mod.compact_class_tables(wp, pairs)


def _field(s, table, seed):
    """The class-split input: a velocity (3, 8, Sp) for K, the coarse
    pressure as class 0 of (1, 8, Sp) for G; numpy f32."""
    rng = np.random.default_rng(seed)
    _, sp = jps.parity_dims(s.fine_dims)
    if table == "k":
        return rng.standard_normal((3, 8, sp)).astype(np.float32)
    x = np.zeros((1, 8, sp), np.float32)
    x[0, 0, : s.nnp] = rng.standard_normal(s.nnp).astype(np.float32)
    return x


@pytest.mark.parametrize("table", TABLES)
def test_window_tables_bit_equal_to_jax(js, table):
    offs = _offsets_xyz(js, table)
    wp_t = tps.parity_window_tables(_window(js, table), offs, js.fine_dims)
    wp_j = jps.parity_window_tables(_window(js, table), offs, js.fine_dims)
    np.testing.assert_array_equal(wp_t, wp_j)
    assert wp_t.dtype == wp_j.dtype and wp_t.flags.c_contiguous
    pairs = tps.parity_pairs(offs, tps.parity_dims(js.fine_dims)[0])
    got, got_pairs = tps.compact_class_tables(wp_t, pairs)
    want, want_pairs = jps.compact_class_tables(wp_j, pairs)
    np.testing.assert_array_equal(got, want)
    assert got_pairs == want_pairs
    if table != "k":
        assert got.shape[1] <= 27                    # the G compaction
        assert all(pp == 0 for cls in got_pairs for (_, pp, _) in cls)


@pytest.mark.parametrize("table", TABLES)
def test_window_apply_matches_jax(js, table):
    wp, pairs = _class_tables(jps, js, table)
    x = _field(js, table, {"k": 1, "g0": 2, "g1": 3, "g2": 4}[table])
    ref = np.asarray(jps.parity_window_apply(jnp.asarray(wp), jnp.asarray(x), pairs=pairs))
    before = dict(cuda_lib.launch_counts)
    got = tps.parity_window_apply(torch.from_numpy(wp), torch.from_numpy(x), pairs=pairs)
    assert cuda_lib.launch_counts == before
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(got.numpy() - ref).max()) <= APPLY_REL * scale


def test_window_apply_merged_matches_window_ops(js):
    """After parity_merge: K u equals the port's window_spmv on K_vals, and
    the three G directions the port's grad_window on G_win."""
    s = js
    S = int(np.prod(s.fine_dims))
    u = _field(s, "k", 5)
    wp, pairs = _class_tables(tps, s, "k")
    y = tps.parity_window_apply(torch.from_numpy(wp), torch.from_numpy(u), pairs=pairs)
    uf = torch.nn.functional.pad(tps.parity_merge(torch.from_numpy(u), s.fine_dims),
                                 (0, s.s_pad - S))
    ref = tws.window_spmv(torch.from_numpy(_window(s, "k")), uf, s.fine_dims,
                          offsets=s.k_offsets, trim=False)
    # K: every slot of the window in the window's order on both sides
    torch.testing.assert_close(tps.parity_merge(y, s.fine_dims), ref[:, :S], rtol=0, atol=0)

    x = _field(s, "g0", 6)
    p = torch.from_numpy(x[0, 0, : s.nnp].copy())
    pf = torch.nn.functional.pad(coarse_to_fine(p, s.coarse_dims, s.fine_dims), (0, s.s_pad - S))
    ref = tws.grad_window(torch.from_numpy(np.asarray(s.d["G_win"])), pf, s.fine_dims,
                          s.g_radius, trim=False)
    for d in range(3):
        wp, pairs = _class_tables(tps, s, f"g{d}")
        y = tps.parity_window_apply(torch.from_numpy(wp), torch.from_numpy(x), pairs=pairs)
        torch.testing.assert_close(tps.parity_merge(y, s.fine_dims)[0], ref[d, :S],
                                   rtol=0, atol=G_ATOL)


@pytest.mark.parametrize("table", ["k", "g1"])
def test_class_route_is_the_one_table_form(js, table):
    """The kernel applies ``wp (8, m, Sp)`` as the one table (1, 8 m, Sp)
    with route plane p * m + w: on CPU tensors the same sum, bit for bit."""
    wp, pairs = _class_tables(tps, js, table)
    x = torch.from_numpy(_field(js, table, 7))
    wp_t = torch.from_numpy(wp)
    m = wp.shape[1]
    route = tps._class_route(pairs, m)
    assert tps._class_route(pairs, m) is route            # cached with the route
    one = tps.parity_apply_plain(wp_t.reshape(1, 8 * m, -1), x, pairs=route, co=x.shape[0])
    assert torch.equal(one, tps.parity_window_apply_plain(wp_t, x, pairs=pairs))


def test_accumulate_in_raises(js):
    wp, pairs = _class_tables(tps, js, "g0")
    x = torch.from_numpy(_field(js, "g0", 8))
    for fn in (tps.parity_window_apply, tps.parity_window_apply_plain):
        with pytest.raises(NotImplementedError, match="accumulate_in"):
            fn(torch.from_numpy(wp), x, pairs=pairs, accumulate_in=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tps.parity_window_apply(torch.empty(wp.shape, device="meta"),
                                torch.empty(x.shape, device="meta"), pairs=pairs)
