"""The implicit step's CR and CG momentum solves on fields placed over ranks
(``parallel/placement.py::place``).

The JAX package's momentum solve sits outside ``shard_map``, so GSPMD sums
every dot of its ``cr`` and ``cg`` over the devices of a placed step; the
port's ``cr`` and ``cg`` take ``reduce=`` (the sum over ranks) as its
BiCGStab does.  On ``tests/test_sharding.py:62``'s implicit F64 box
(``cavity_deck(4, viscosity=0.1, dt=0.005)``, ``pressure_cg_tol=1e-12``,
``shard_pad=8``) with ``momentum_solver`` ``"cr"`` and ``"cg"``, 2 steps:

* placed on 2 and 8 gloo ranks against the JAX package's step placed over
  its 8 virtual CPU devices (``shard_params`` / ``shard_state``, the jitted
  chunk), at that file's tolerances: u 1e-10, p 1e-9, u_mon 1e-11;
* the same runs against the port's one-device step, at the same tolerances
  (only the dots' order differs);
* placed on a one-rank mesh, bit for bit the port's one-device step, with
  equal momentum and CG counts: one rank's local sum is the whole sum;
* the momentum solve's all-reduces: one for the start and two an iteration.

And ``tests/test_sharding.py:164``'s implicit ELL deck (``bfs_deck(12, 4,
4)``, ``momentum_tol=1e-12``) with ``"cr"``, placed on 2 ranks for one
step, against the port's one device and the JAX package's placed step at
1e-7 (``chip_smoke.py``'s ``ell_implicit`` tolerances).

Ranks are spawned (``parallel/spawn.py``) on a file store under
``tmp_path``; they run this module's ``_rank_steps`` and import no JAX.
About 60-100 s serial on an 8-core CPU (the machine's load moves it), most
of it the JAX package's two placed box steps (~50-100 s: their compiles).
"""

from __future__ import annotations

import numpy as np
import pytest

from cfd_with_cuda_tpu_torch.interop import gather_state
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.parallel import sharding
from cfd_with_cuda_tpu_torch.parallel.placement import place
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05)

# case -> (deck maker (either package's generators), config fields, steps,
# tolerances u / p / u_mon)
CASES = {
    "box_cr": (lambda g: g["cavity_deck"](4, viscosity=0.1, dt=0.005),
               dict(momentum_solver="cr"), 2, (1e-10, 1e-9, 1e-11)),
    "box_cg": (lambda g: g["cavity_deck"](4, viscosity=0.1, dt=0.005),
               dict(momentum_solver="cg"), 2, (1e-10, 1e-9, 1e-11)),
    "ell_cr": (lambda g: g["bfs_deck"](12, 4, 4, dt=0.01, **BFS),
               dict(momentum_solver="cr", momentum_tol=1e-12), 1, (1e-7, 1e-7, 1e-7)),
}
BOX = ("box_cr", "box_cg")
PORT_GENERATORS = dict(cavity_deck=cavity_deck, bfs_deck=bfs_deck)


def _config(case: str) -> SolverConfig:
    return SolverConfig(dtype_policy=DTypePolicy.F64, steps_per_chunk=1, shard_pad=8,
                        pressure_cg_tol=1e-12, **CASES[case][1])


def _steps(case: str, mesh) -> dict:
    """The port's steps of ``case`` from rest (placed over ``mesh`` unless it
    is None): the whole state, u_mon, the momentum and CG counts and the
    momentum solve's all-reduces by step."""
    deck, _, n_steps, _ = CASES[case]
    solver = ImplicitGQSolver(deck(PORT_GENERATORS), _config(case), device="cpu")
    if mesh is not None:
        place(solver, mesh)
    state = solver.initial_state()
    mon, mom, cg, dots = [], [], [], []
    for _ in range(n_steps):
        sharding.reset_collective_counts()
        state, stats = solver._time_step(solver.d, state)
        mon.append(float(stats.u_mon))
        mom.append(int(stats.mom_iters))
        cg.append(int(stats.cg_iters))
        dots.append(sharding.collective_counts.get("reduce_dot", [0])[0])
    full = gather_state(state, solver)
    return dict(u=full[0].numpy(), p=full[1].numpy(), mon=mon, mom=mom, cg=cg, dots=dots,
                layout=solver.layout, s_pad=solver.s_pad)


def _rank_steps(cases) -> dict:
    mesh = sharding.make_mesh()
    return {case: _steps(case, mesh) for case in cases}


@pytest.fixture(scope="module")
def single():
    return {case: _steps(case, None) for case in CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's gathered states by rank count (every rank's checked equal)."""
    out = {}
    for n, cases in ((2, tuple(CASES)), (8, BOX)):
        res = run_ranks(_rank_steps, n, (cases,), device="cpu",
                        workdir=tmp_path_factory.mktemp(f"split{n}"))
        for r in res[1:]:
            for case in cases:
                np.testing.assert_array_equal(r[case]["u"], res[0][case]["u"])
                assert r[case]["mom"] == res[0][case]["mom"]
        out[n] = res[0]
    return out


@pytest.fixture(scope="module")
def jax_placed():
    """The JAX package's steps of each case, placed over its 8 virtual CPU
    devices as ``tests/test_sharding.py`` places them."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from cfd_with_cuda_tpu.mesh import generators as jg
    from cfd_with_cuda_tpu.parallel.sharding import make_mesh, shard_params, shard_state
    from cfd_with_cuda_tpu.solvers.base import unpack_chunk_stats
    from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig

    gens = dict(cavity_deck=jg.cavity_deck, bfs_deck=jg.bfs_deck)
    mesh = make_mesh(8)
    out = {}
    for case, (deck, fields, n_steps, _) in CASES.items():
        solver = JaxImplicit(deck(gens), JaxConfig(dtype_policy=JaxPolicy.F64, steps_per_chunk=1,
                                                   shard_pad=8, pressure_cg_tol=1e-12,
                                                   **fields))
        big = (solver.s_pad, int(solver.d["gq"].shape[-1]))
        params = shard_params(solver.d, mesh, big)
        state = shard_state(solver.initial_state(), mesh, big)
        fn = jax.jit(solver._chunk_fn(1))
        mon = []
        for _ in range(n_steps):
            state, packed = fn(params, state)
            st, _ = unpack_chunk_stats(packed)
            mon.append(float(st.u_mon[0]))
        out[case] = dict(u=np.asarray(state[0]), p=np.asarray(state[1]), mon=mon,
                         s_pad=solver.s_pad)
    return out


def _close(got: dict, ref: dict, case: str) -> None:
    tu, tp, tmon = CASES[case][3]
    assert got["u"].shape == ref["u"].shape
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=tu)
    np.testing.assert_allclose(got["p"], ref["p"], rtol=0, atol=tp)
    assert got["mon"][-1] == pytest.approx(ref["mon"][-1], abs=tmon)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", BOX)
def test_placed_box_matches_jax_placed(jax_placed, ranks, case, n):
    got, ref = ranks[n][case], jax_placed[case]
    assert got["s_pad"] == ref["s_pad"] and got["layout"] == "interleaved"
    _close(got, ref, case)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", BOX)
def test_placed_box_matches_port_single_device(single, ranks, case, n):
    got, ref = ranks[n][case], single[case]
    _close(got, ref, case)
    assert min(got["mom"]) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_mesh_is_bit_for_bit_one_device(single, case):
    """Placed on a one-rank mesh (this process, no group): every placed
    operator and every dot sums as one device does."""
    got, ref = _steps(case, sharding.make_mesh(1)), single[case]
    np.testing.assert_array_equal(got["u"], ref["u"])
    np.testing.assert_array_equal(got["p"], ref["p"])
    assert got["mon"] == ref["mon"]
    assert got["mom"] == ref["mom"] and got["cg"] == ref["cg"]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", BOX)
def test_placed_momentum_all_reduces(ranks, case, n):
    """CR and CG reduce their dots once for the start and twice an
    iteration (the BiCGStab three times)."""
    got = ranks[n][case]
    assert got["dots"] == [1 + 2 * k for k in got["mom"]]


def test_placed_ell_cr_matches_port_and_jax(single, ranks, jax_placed):
    got = ranks[2]["ell_cr"]
    assert got["layout"] == "ell" and got["s_pad"] == jax_placed["ell_cr"]["s_pad"]
    assert got["dots"] == [1 + 2 * k for k in got["mom"]]
    _close(got, single["ell_cr"], "ell_cr")
    _close(got, jax_placed["ell_cr"], "ell_cr")
