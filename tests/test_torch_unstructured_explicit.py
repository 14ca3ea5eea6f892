"""PyTorch port: the explicit BCH solver on the unstructured (ELL) path.

* F32 on the small backward-facing step ``bfs_deck(12, 4, 4, lengths=(6,
  2, 2), step_frac=(0.25, 0.5))`` (not a box grid; its banded Z has 185
  offsets), 3 steps against the JAX solver with ``pressure_backend=
  "pallas"`` (its banded fused CG in interpret mode), under both CG loop
  forms: equal sub-iteration counts, CG counts within 4 (one group of the
  per-iteration loop), u within 5e-6 and p within 5e-5 of max|.| (the
  bounds of ``tests/test_parity_stencil.py:285-290``).
* The same deck with a scrambled node numbering, where ``banded_from_csr``
  gives up and both packages take the ELL Z and the XLA/torch CG; and with
  ``pressure_backend="xla"``, the XLA/torch CG on the banded window.
* F64 under ``structured="never"`` on ``cavity_deck(3)`` against the numpy
  oracle (``tests/test_explicit_solver.py:36-67``): u to 1e-12, p to 1e-11,
  equal sub-iteration counts, with and without ``conv_stab``.

The JAX solver is stepped with ``jax.jit(solver._time_step)`` (its chunk
cannot run the fused CG under jax x64, the test session's setting).
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import bfs_deck as jax_bfs_deck
from cfd_with_cuda_tpu.oracle.explicit_oracle import ExplicitOracle
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05, dt=0.002)
CFG = dict(pressure_cg_tol=1e-6, steps_per_chunk=1, setup_cache="off")
N_STEPS = 3
U_TOL, P_TOL, CG_TOL = 5e-6, 5e-5, 4


def _scrambled(deck, seed=1):
    """The same deck with its corner nodes renumbered at random (faces and
    elements keep their numbers), so Z's offsets are no longer bounded."""
    perm = np.random.default_rng(seed).permutation(deck.coords.shape[0])
    coords = np.empty_like(deck.coords)
    coords[perm] = deck.coords
    deck.coords, deck.conn = coords, perm[deck.conn]
    deck.zero_pressure_node = int(perm[deck.zero_pressure_node])
    return deck


def _jax_run(js, n):
    step = jax.jit(js._time_step)
    st, rows = js.initial_state(), []
    for _ in range(n):
        st, stats = step(js.d, st)
        rows.append((int(stats.iters), int(stats.cg_iters)))
    u, p = js.fields(st)
    return np.asarray(rows), u, p


def _port_run(ts, n):
    st, rows = ts.initial_state(), []
    for _ in range(n):
        st, stats = ts._time_step(ts.d, st)
        rows.append((int(stats.iters), int(stats.cg_iters)))
    u, p = ts.fields(st)
    return np.asarray(rows), u, p


def _pair(deck_of, jax_kw, port_kw):
    js = JaxSolver(deck_of(jax_bfs_deck), JaxConfig(dtype_policy=JaxPolicy.F32, **CFG, **jax_kw))
    ts = ExplicitBCHSolver(deck_of(bfs_deck), SolverConfig(dtype_policy=DTypePolicy.F32, **CFG,
                                                           **port_kw), device="cpu")
    assert not js.structured and ts.layout == "ell"
    assert js.z_offs == ts.z_offs
    return js, ts


def _compare(js, ts, cg_tol=CG_TOL):
    before = dict(cuda_lib.launch_counts)
    rows, u, p = _port_run(ts, N_STEPS)
    assert dict(cuda_lib.launch_counts) == before        # CPU tensors: plain versions
    ref_rows, u_j, p_j = _jax_run(js, N_STEPS)
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])           # sub-iterations
    assert np.abs(rows[:, 1] - ref_rows[:, 1]).max() <= cg_tol
    assert (rows[:, 1] > 0).all()
    assert np.abs(u - u_j).max() <= U_TOL * np.abs(u_j).max()
    assert np.abs(p - p_j).max() <= P_TOL * np.abs(p_j).max()
    return rows


@pytest.mark.parametrize("fuse_loop", [False, True], ids=["cg_iter", "cg_solve"])
def test_bfs_banded_matches_jax(fuse_loop):
    deck_of = lambda mod: mod(12, 4, 4, **BFS)
    js, ts = _pair(deck_of, dict(pressure_backend="pallas", pressure_cg_fuse_loop=fuse_loop),
                   dict(pressure_cg_fuse_loop=fuse_loop))
    assert "Z_bwin_cg" in js.d and len(ts.z_offs) == 185
    rows = _compare(js, ts)
    if not fuse_loop:
        assert (rows[:, 1] % 4 == 0).all()


def test_bfs_ell_fallback_matches_jax():
    """A scrambled numbering: no band within 512 offsets, so both packages
    run the ELL Z under the XLA / torch CG (the ||r|| test every
    iteration: counts within 1)."""
    deck_of = lambda mod: _scrambled(mod(12, 4, 4, **BFS))
    js, ts = _pair(deck_of, dict(pressure_backend="pallas"), {})
    assert ts.z_offs is None and "Z_bwin" not in ts.d
    _compare(js, ts, cg_tol=1)


def test_bfs_xla_backend_matches_jax():
    """``pressure_backend="xla"`` on the unstructured path: the XLA / torch
    CG on the banded window (it raises only on a box mesh)."""
    deck_of = lambda mod: mod(12, 4, 4, **BFS)
    js, ts = _pair(deck_of, dict(pressure_backend="xla"), dict(pressure_backend="xla"))
    assert "Z_bwin_cg" not in js.d and ts.z_offs is not None
    _compare(js, ts, cg_tol=1)


@pytest.mark.parametrize("conv_stab", [0.0, 0.5], ids=["plain", "conv_stab"])
def test_f64_never_structured_matches_oracle(conv_stab):
    """F64 on the ELL path of a box mesh (``structured="never"``) against
    the numpy oracle over 10 steps."""
    deck = cavity_deck(3, viscosity=0.1, dt=0.005, t_final=1.0)
    ts = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=5, structured="never",
                                              conv_stab=conv_stab), device="cpu")
    assert ts.layout == "ell" and ts.d["Ke"].dtype == torch.float64
    state, hist = ts.run(n_steps=10)
    u, p = ts.fields(state)
    u_o, p_o, oh = ExplicitOracle(deck, conv_stab=conv_stab).run(10)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p, p_o, rtol=0, atol=1e-11)
    assert [int(h["iters"]) for h in hist] == [it for _, it in oh]
