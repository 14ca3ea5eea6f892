"""The implicit step's CR and CG momentum solves on the sharded kernel path
(``SolverConfig(spmd_devices=n)`` on the interleaved layout).

Each rank holds its block of the fine axis; the momentum solve's dots are
its local sums plus one all-reduce for the start and two an iteration
(``ops/krylov.py``'s ``reduce=``), as the BiCGStab's are plus three.  The
F32 configuration of ``tests/test_torch_sharding.py`` (``_config
("implicit", n, momentum_solver=...)``), 2 steps from rest, with
``momentum_solver`` ``"cr"`` and ``"cg"``:

* on ``cavity_deck(3, viscosity=0.1, dt=0.005)`` and 2 ranks against the
  JAX package's ``spmd_devices=2`` step (Pallas in interpret mode) at the
  bound the port's implicit step keeps against the JAX package's
  (``JAX_IMPLICIT_TOLS``: u, p and u_mon 5e-5), and bit for bit against
  the port's one device with equal momentum counts: every grid row of that
  deck lies on rank 0, so rank 1 adds zeros to each dot;
* on ``cavity_deck(8, viscosity=0.1, dt=0.005)`` and 2 ranks (grid rows on
  both) against the port's one device within the JAX package's sharded
  implicit tolerances (``TOLS["implicit"]`` of that file), with equal
  momentum counts;
* the collectives of each step against the BiCGStab's on the same deck:
  ``reduce_dot`` one for the start and two an iteration (three for the
  BiCGStab), the A apply's halo exchange once for r0 and once an iteration
  (CR: twice for the start; the BiCGStab: twice an iteration), every other
  collective as many times.

Ranks are spawned (``parallel/spawn.py``) on a file store under
``tmp_path``; they run this module's ``_rank_steps`` and import no JAX.
About 30-40 s serial on an 8-core CPU, most of it the JAX package's two
sharded steps in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest

from cfd_with_cuda_tpu_torch.interop import gather_state
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.parallel import sharding
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

N_RANKS = 2
N_STEPS = 2
SPLIT = ("cr", "cg")
DECKS = (3, 8)
# tests/test_torch_sharding.py: the JAX package's sharded implicit
# tolerances (rtol, atol) and the port's implicit bound against the JAX
# package's (tests/test_torch_interleaved_implicit.py)
TOLS = dict(u=(1e-4, 1e-5), p=(1e-4, 1e-4), mon=1e-5)
JAX_IMPLICIT_TOLS = dict(u=(0.0, 5e-5), p=(0.0, 5e-5), mon=5e-5)
# the momentum solve's all-reduces and A applies: (start, per iteration)
DOTS = dict(bicgstab=(1, 3), cr=(1, 2), cg=(1, 2))
APPLIES = dict(bicgstab=(1, 2), cr=(2, 1), cg=(1, 1))
A_HALO = "halo_sharded_spmv_mk_plus_a"


def _config(spmd: int, momentum_solver: str) -> SolverConfig:
    """``tests/test_torch_sharding.py``'s implicit sharded configuration."""
    return SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=1,
                        pressure_backend="pallas", structured_layout="interleaved",
                        spmd_devices=spmd, momentum_solver=momentum_solver)


def _steps(deck_n: int, spmd: int, momentum_solver: str) -> dict:
    """N_STEPS of the port's step: the whole state, u_mon, the momentum
    counts and each step's collectives by name."""
    solver = ImplicitGQSolver(cavity_deck(deck_n, viscosity=0.1, dt=0.005),
                              _config(spmd, momentum_solver), device="cpu")
    assert solver.layout == "interleaved" and (solver.spmd_mesh is not None) == (spmd >= 1)
    state = solver.initial_state()
    mon, mom, calls = [], [], []
    for _ in range(N_STEPS):
        sharding.reset_collective_counts()
        state, stats = solver._time_step(solver.d, state)
        mon.append(float(stats.u_mon))
        mom.append(int(stats.mom_iters))
        calls.append({k: v[0] for k, v in sharding.collective_counts.items()})
    full = gather_state(state, solver)
    return dict(u=full[0].numpy(), p=full[1].numpy(), mon=mon, mom=mom, calls=calls)


def _rank_steps() -> dict:
    n = sharding.make_mesh().size
    out = {(deck_n, ms): _steps(deck_n, n, ms) for deck_n in DECKS for ms in SPLIT}
    out[3, "bicgstab"] = _steps(3, n, "bicgstab")
    return out


@pytest.fixture(scope="module")
def single():
    return {(deck_n, ms): _steps(deck_n, 0, ms) for deck_n in DECKS for ms in SPLIT}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's gathered states (every rank's checked equal to rank 0's)."""
    res = run_ranks(_rank_steps, N_RANKS, (), device="cpu",
                    workdir=tmp_path_factory.mktemp("split_spmd"))
    for r in res[1:]:
        for key in r:
            np.testing.assert_array_equal(r[key]["u"], res[0][key]["u"])
            assert r[key]["mom"] == res[0][key]["mom"]
    return res[0]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's ``spmd_devices=2`` steps on ``cavity_deck(3)``, one
    per momentum solver (``tests/test_torch_sharding.py``'s recipe)."""
    import jax

    if len(jax.devices()) < N_RANKS:
        pytest.skip("needs the virtual CPU mesh")
    from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_deck
    from cfd_with_cuda_tpu.parallel.sharding import make_mesh, shard_params, shard_state
    from cfd_with_cuda_tpu.solvers.base import unpack_chunk_stats
    from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig

    mesh = make_mesh(N_RANKS)
    out = {}
    for ms in SPLIT:
        cfg = _config(N_RANKS, ms)
        solver = JaxImplicit(jax_deck(3, viscosity=0.1, dt=0.005),
                             JaxConfig(**{**cfg.__dict__, "dtype_policy": JaxPolicy.F32,
                                          "setup_cache": "off"}))
        assert solver.spmd_mesh is not None
        big = (solver.s_pad, int(solver.d["gq"].shape[-1]))
        params = shard_params(solver.d, mesh, big)
        state = shard_state(solver.initial_state(), mesh, big)
        fn = jax.jit(solver._chunk_fn(1))
        mon = []
        for _ in range(N_STEPS):
            state, packed = fn(params, state)
            st, _ = unpack_chunk_stats(packed)
            mon.append(float(st.u_mon[0]))
        out[ms] = dict(u=np.asarray(state[0]), p=np.asarray(state[1]), mon=mon)
    return out


def _close(got: dict, ref: dict, tols: dict) -> None:
    cols = ref["u"].shape[-1]
    np.testing.assert_allclose(got["u"][:, :cols], ref["u"], rtol=tols["u"][0],
                               atol=tols["u"][1])
    np.testing.assert_allclose(got["p"], ref["p"], rtol=tols["p"][0], atol=tols["p"][1])
    assert got["mon"][-1] == pytest.approx(ref["mon"][-1], abs=tols["mon"])


@pytest.mark.parametrize("ms", SPLIT)
def test_spmd_matches_jax_spmd(jax_ref, ranks, ms):
    got = ranks[3, ms]
    assert got["u"].shape == jax_ref[ms]["u"].shape
    _close(got, jax_ref[ms], JAX_IMPLICIT_TOLS)


@pytest.mark.parametrize("ms", SPLIT)
@pytest.mark.parametrize("deck_n", DECKS)
def test_spmd_matches_port_single_device(single, ranks, deck_n, ms):
    got, ref = ranks[deck_n, ms], single[deck_n, ms]
    assert got["mom"] == ref["mom"] and min(got["mom"]) > 0
    cols = ref["u"].shape[-1]
    if deck_n == 3:
        np.testing.assert_array_equal(got["u"][:, :cols], ref["u"])
        np.testing.assert_array_equal(got["p"], ref["p"])
        assert got["mon"] == ref["mon"]
        assert not np.any(got["u"][:, cols:])
    else:
        _close(got, ref, TOLS)


@pytest.mark.parametrize("ms", SPLIT)
def test_spmd_momentum_collectives(ranks, ms):
    """Each step's collectives against the BiCGStab's: only the momentum
    solve's dots and its A applies' halo exchanges move."""
    base = ranks[3, "bicgstab"]
    got = ranks[3, ms]
    for step in range(N_STEPS):
        calls, ref = dict(got["calls"][step]), dict(base["calls"][step])
        for name, counts in (("reduce_dot", DOTS), (A_HALO, APPLIES)):
            start, per = counts[ms]
            assert calls.pop(name) == start + per * got["mom"][step], name
            start, per = counts["bicgstab"]
            assert ref.pop(name) == start + per * base["mom"][step], name
        assert calls == ref
