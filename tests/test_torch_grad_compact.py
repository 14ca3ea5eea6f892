"""PyTorch port: G on the class-compacted window (``compact_g_window``,
``grad_window_compact``; the GRAD kernel of ``csrc/window_stencil.cu``).

The interleaved solvers' G window reads the coarse pressure embedded on the
even fine nodes, so a row of parity class c keeps only the slots whose
offset lands on an even node on all three axes.  On the interleaved
``G_win`` of both port solvers, on ``cavity_deck(4)`` and on a non-cubic
5 x 3 x 4-element box:

* the class slot table (counts and window order);
* the compact plain version equal to ``grad_window_plain`` bit for bit in
  f32 and f64 (a dropped term adds an exact zero);
* the compact apply against the JAX package's ``pallas_grad_window`` in
  interpret mode, at ``tests/test_torch_interleaved_ops.py``'s 1e-12;
* a weight planted outside its class's slots raises ``ValueError``.

The wrappers take CPU tensors, so they run the plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_with_cuda_tpu.ops import pallas_stencil as jpst
from cfd_with_cuda_tpu_torch.mesh.generators import _boundary_faces, cavity_deck, cube_hex_mesh
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import window_stencil as tws
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

F64_TOL = 1e-12          # test_torch_interleaved_ops.py::test_grad_window_matches_pallas
SOLVERS = {"explicit": ExplicitBCHSolver, "implicit": ImplicitGQSolver}


def _box_deck():
    """The 5 x 3 x 4-element box (1 x 0.6 x 0.8) of ``ROADMAP.md`` queue 3
    finding 1: the cavity's walls and lid, the lid moving at (1, 0.3, 0),
    the zero-pressure node nearest (0.3, 0.2, 0)."""
    deck = cavity_deck(4, viscosity=0.01, dt=0.01, lid_velocity=(1.0, 0.3, 0.0))
    coords, conn = cube_hex_mesh(6, 4, 5, lengths=(1.0, 0.6, 0.8))
    fb = _boundary_faces((5, 3, 4))
    walls = np.concatenate([fb[k] for k in ("zmin", "ymin", "xmax", "ymax", "xmin")])
    lid = fb["zmax"]
    deck.coords, deck.conn = coords, conn
    deck.ne, deck.ncn = conn.shape[0], coords.shape[0]
    deck.bc_vel_faces = np.concatenate([
        np.column_stack([walls, np.zeros(len(walls), np.int64)]),
        np.column_stack([lid, np.ones(len(lid), np.int64)]),
    ]).astype(np.int64)
    deck.zero_pressure_node = int(np.argmin(((coords - [0.3, 0.2, 0.0]) ** 2).sum(axis=1)))
    deck.monitor_xyz = np.array([0.5, 0.3, 0.4])
    return deck


DECKS = {"cavity4": lambda: cavity_deck(4, viscosity=0.01, dt=0.01), "box534": _box_deck}
CASES = [(s, k) for k in DECKS for s in SOLVERS]


@pytest.fixture(scope="module")
def solvers():
    """Each port solver on each deck, interleaved, F32 (set up lazily)."""
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, structured_layout="interleaved")
    built = {}

    def get(solver, deck):
        if (solver, deck) not in built:
            s = SOLVERS[solver](DECKS[deck](), cfg, device="cpu")
            assert s.layout == "interleaved"
            built[solver, deck] = s
        return built[solver, deck]
    return get


def _pressure(s, dtype):
    """A seeded coarse pressure embedded on the fine grid, padded to s_pad."""
    p = np.random.default_rng(11).standard_normal(s.nnp)
    cx, cy, cz = s.coarse_dims
    fx, fy, fz = s.fine_dims
    pf = np.zeros((fz, fy, fx))
    pf[::2, ::2, ::2] = p.reshape(cz, cy, cx)
    return torch.from_numpy(np.pad(pf.ravel(), (0, s.s_pad - pf.size))).to(dtype)


def test_class_slots_in_window_order():
    slots, offsets, counts = tws.compact_g_slots((11, 7, 9), 2)
    np.testing.assert_array_equal(counts, [27, 18, 18, 12, 18, 12, 12, 8])
    scan = [(dx, dy, dz) for dz in range(-2, 3) for dy in range(-2, 3) for dx in range(-2, 3)]
    flat = tws.window_offsets((11, 7, 9), 2)
    for c in range(8):
        par = (c & 1, c >> 1 & 1, c >> 2 & 1)
        # the class's slots: offsets landing on an even node, in window order
        want = [k for k, d in enumerate(scan) if all((p + o) % 2 == 0 for p, o in zip(par, d))]
        assert slots[c, : counts[c]].tolist() == want
        assert offsets[c, : counts[c]].tolist() == [flat[k] for k in want]
        assert not slots[c, counts[c]:].any() and not offsets[c, counts[c]:].any()


@pytest.mark.parametrize("solver,deck", CASES)
def test_solver_table_is_the_compacted_window(solvers, solver, deck):
    s = solvers(solver, deck)
    g, gc = s.d["G_win"], s.d["G_cwin"]
    slots, _, counts = tws.compact_g_slots(s.fine_dims, s.g_radius)
    assert gc.shape == (3, 27, s.s_pad) and gc.dtype == g.dtype
    fx, fy, _ = s.fine_dims
    q = np.arange(s.s_pad)
    cls = (q // (fx * fy) % 2) * 4 + (q // fx % fy % 2) * 2 + q % fx % 2
    for j in range(27):
        live = j < counts[cls]
        np.testing.assert_array_equal(gc[:, j, live].numpy(),
                                      g[:, slots[cls[live], j], q[live]].numpy())
        assert not gc[:, j, ~live].any()
    # every dropped weight is an exact zero, the BLK padding columns included
    assert int(torch.count_nonzero(g)) == int(torch.count_nonzero(gc))
    assert not g[..., int(np.prod(s.fine_dims)):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("solver,deck", CASES)
def test_compact_plain_equals_full_window_bit_for_bit(solvers, solver, deck, dtype):
    s = solvers(solver, deck)
    g = s.d["G_win"].to(dtype)
    gc = tws.compact_g_window(g, s.fine_dims, s.g_radius)[0]
    pf = _pressure(s, dtype)
    before = dict(cuda_lib.launch_counts)
    for trim in (True, False):
        full = tws.grad_window_plain(g, pf, s.fine_dims, s.g_radius, trim=trim)
        assert torch.equal(tws.grad_window_compact_plain(gc, pf, s.fine_dims, s.g_radius,
                                                         trim=trim), full)
        # the wrapper runs the plain version on a CPU tensor and launches nothing
        assert torch.equal(tws.grad_window_compact(gc, pf, s.fine_dims, s.g_radius,
                                                   trim=trim), full)
    assert cuda_lib.launch_counts == before


@pytest.mark.parametrize("solver,deck", CASES)
def test_compact_apply_matches_pallas(solvers, solver, deck):
    s = solvers(solver, deck)
    g = s.d["G_win"].double()
    gc = tws.compact_g_window(g, s.fine_dims, s.g_radius)[0]
    pf = _pressure(s, torch.float64)
    ref = jpst.pallas_grad_window(jnp.asarray(g.numpy()), jnp.asarray(pf.numpy()),
                                  s.fine_dims, s.g_radius)
    out = tws.grad_window_compact(gc, pf, s.fine_dims, s.g_radius)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("deck", list(DECKS))
def test_weight_outside_the_class_slots_raises(solvers, deck):
    s = solvers("explicit", deck)
    g = s.d["G_win"].clone()
    # row 0 is class 0 (all even): slot 1, offset dx = -1, lands on an odd node
    assert g[:, 1, 0].eq(0).all()
    g[2, 1, 0] = 0.5
    with pytest.raises(ValueError, match="1 nonzero weights lie outside"):
        tws.compact_g_window(g, s.fine_dims, s.g_radius)
    with pytest.raises(ValueError, match="1 nonzero weights lie outside"):
        tws.compact_g_window(g.numpy(), s.fine_dims, s.g_radius)
