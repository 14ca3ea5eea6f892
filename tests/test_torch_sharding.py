"""The port's multi-device path: ranks over torch.distributed (gloo, CPU).

* ``make_mesh`` raises the JAX package's "devices are" ``ValueError`` when
  more ranks are asked for than the process group has;
* the placement rule (``_spec_for``, ``shard_params``, ``shard_state``)
  equals the JAX package's on a table of shapes;
* explicit and implicit sharded steps on ``cavity_deck(3, viscosity=0.1,
  dt=0.005)``, 2 steps on 8 ranks, against the JAX package's
  ``spmd_devices=8`` steps on its 8-device virtual mesh (Pallas in interpret
  mode): the explicit ones with the JAX package's own tolerances
  (``tests/test_sharded_stencil.py:124-136``: u 2e-5 / 2e-6, p 2e-5,
  ``u_mon`` 1e-6, equal CG counts); the implicit ones with the bound the
  port's single-device implicit step keeps against the JAX package's
  (``tests/test_torch_interleaved_implicit.py``: u, p and monitors 5e-5,
  the JAX package's own between its two layouts), since the two packages'
  f32 BiCGStabs stop at 1e-6 of |b| with solutions ~2e-5 apart: on this
  deck the single-device steps part by 3.19e-5 in u, and the sharded ones
  by the same 3.19e-5, so JAX's sharded 1e-4 / 1e-5 (made for its two runs
  of one arithmetic) holds the port's sharded step against its own
  single-device step below instead.  On that deck every grid row lies on
  rank 0, so the same steps also run on ``cavity_deck(8, viscosity=0.1,
  dt=0.005)`` on 4 ranks against the JAX package's ``spmd_devices=4``
  steps, at the same tolerances: there three ranks hold grid rows, and
  every halo, element slab and gather crosses a rank boundary in both
  packages;
* the same steps on 2 and 4 ranks against the port's single-device
  interleaved step, within the JAX package's sharded tolerances (explicit
  as above; implicit 1e-4 / 1e-5, 1e-4, 1e-5), on that deck (every grid row
  on rank 0) and on ``cavity_deck(8)`` (17^3 fine rows over 2048-row blocks:
  three ranks hold grid rows, so every halo and element slab crosses a rank
  boundary);
* ``spmd_devices`` 1 against 0 on ``cavity_deck(6)`` over 4 steps, rel 1e-6
  (``tests/test_sharding.py:262-284``; one process, no group);
* ``dryrun_multichip(2)`` at ``cavity_deck(4)``;
* ``interop.gather_state`` / ``state_to_rank``: each rank's state gathered
  whole, and the whole state carried back to the rank's block.

Ranks are spawned (``parallel/spawn.py``) on a file store under ``tmp_path``;
they run this module's module-level ``_rank_*`` functions and import no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.interop import gather_state, state_to_rank
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.parallel import sharding
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

N_DEV = 8
N_STEPS = 2
# tests/test_sharded_stencil.py:124-136 (explicit) and :180-189 (implicit)
TOLS = dict(explicit=dict(u=(2e-5, 2e-6), p=(2e-5, 2e-5), mon=1e-6, cg=True),
            implicit=dict(u=(1e-4, 1e-5), p=(1e-4, 1e-4), mon=1e-5, cg=False))
# the port's implicit step against the JAX package's on one device
# (tests/test_torch_interleaved_implicit.py: U_TOL = P_TOL = MON_ATOL = 5e-5)
JAX_IMPLICIT_TOLS = dict(u=(0.0, 5e-5), p=(0.0, 5e-5), mon=5e-5, cg=False)
SOLVERS = dict(explicit=ExplicitBCHSolver, implicit=ImplicitGQSolver)


def _config(kind: str, spmd: int, **extra) -> SolverConfig:
    """The JAX package's sharded-step configuration (test_sharded_stencil.py)."""
    base = dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, steps_per_chunk=1,
                pressure_backend="pallas", structured_layout="interleaved",
                spmd_devices=spmd, **extra)
    if kind == "explicit":
        base["pressure_warm_start"] = True
    return SolverConfig(**base)


def _steps(kind: str, deck_n: int, spmd: int) -> dict:
    """N_STEPS of the port's step on ``cavity_deck(deck_n, 0.1, 0.005)``:
    the whole state (gathered from the ranks), u_mon and the CG counts."""
    solver = SOLVERS[kind](cavity_deck(deck_n, viscosity=0.1, dt=0.005), _config(kind, spmd),
                           device="cpu")
    assert solver.layout == "interleaved" and (solver.spmd_mesh is not None) == (spmd >= 1)
    state = solver.initial_state()
    mon, cg = [], []
    for _ in range(N_STEPS):
        state, stats = solver._time_step(solver.d, state)
        mon.append(float(stats.u_mon))
        cg.append(int(stats.cg_iters))
    full = gather_state(state, solver)
    # and back: the whole state carried to this rank's block is its own
    back = state_to_rank(full, solver)
    assert all(torch.equal(a, b) for a, b in zip(back, state))
    return dict(u=full[0].numpy(), p=full[1].numpy(), mon=mon, cg=cg, s_pad=solver.s_pad)


def _rank_steps(deck_n: int, kinds=("explicit", "implicit")) -> dict:
    n = sharding.make_mesh().size
    return {k: _steps(k, deck_n, n) for k in kinds}


def _close(got: dict, ref: dict, kind: str, cols: int | None = None, tols=None) -> None:
    t = tols or TOLS[kind]
    u_g, u_r = got["u"][:, :cols], ref["u"][:, :cols]
    np.testing.assert_allclose(u_g, u_r, rtol=t["u"][0], atol=t["u"][1])
    np.testing.assert_allclose(got["p"], ref["p"], rtol=t["p"][0], atol=t["p"][1])
    assert got["mon"][-1] == pytest.approx(ref["mon"][-1], abs=t["mon"])
    if t["cg"]:
        assert got["cg"][-1] == ref["cg"][-1]


# (deck, ranks) of the comparisons with the JAX package's sharded steps
JAX_CASES = ((3, N_DEV), (8, 4))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's sharded steps (its test's recipe), one per solver
    kind, by (deck, devices) of :data:`JAX_CASES`."""
    import jax

    if len(jax.devices()) < N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_deck
    from cfd_with_cuda_tpu.parallel.sharding import make_mesh, shard_params, shard_state
    from cfd_with_cuda_tpu.solvers.base import unpack_chunk_stats
    from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
    from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig

    out = {}
    for deck_n, n_dev in JAX_CASES:
        mesh = make_mesh(n_dev)
        for kind, cls in (("explicit", JaxExplicit), ("implicit", JaxImplicit)):
            cfg = _config(kind, n_dev)
            jcfg = JaxConfig(**{**cfg.__dict__, "dtype_policy": JaxPolicy.F32,
                                "setup_cache": "off"})
            solver = cls(jax_deck(deck_n, viscosity=0.1, dt=0.005), jcfg)
            assert solver.spmd_mesh is not None
            big = (solver.s_pad,) if kind == "explicit" else (solver.s_pad,
                                                              int(solver.d["gq"].shape[-1]))
            params = shard_params(solver.d, mesh, big)
            state = shard_state(solver.initial_state(), mesh, big)
            fn = jax.jit(solver._chunk_fn(1))
            mon, cg = [], []
            for _ in range(N_STEPS):
                state, packed = fn(params, state)
                st, _ = unpack_chunk_stats(packed)
                mon.append(float(st.u_mon[0]))
                cg.append(int(st.cg_iters[0]))
            out[deck_n, n_dev, kind] = dict(u=np.asarray(state[0]), p=np.asarray(state[1]),
                                            mon=mon, cg=cg, s_pad=solver.s_pad)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's sharded steps: rank 0's gathered states, by (deck, ranks)
    (every rank's gathered state checked equal to rank 0's)."""
    out = {}
    for deck_n, counts in ((3, (2, 4, N_DEV)), (8, (2, 4))):
        for n in counts:
            res = run_ranks(_rank_steps, n, (deck_n,), device="cpu",
                            workdir=tmp_path_factory.mktemp(f"steps{deck_n}_{n}"))
            for r in res[1:]:
                for kind in r:
                    np.testing.assert_array_equal(r[kind]["u"], res[0][kind]["u"])
            out[deck_n, n] = res[0]
    return out


def test_make_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="devices are"):
        sharding.make_mesh(10_000)
    mesh = sharding.make_mesh(1)          # no process group: this one process
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)


_SHAPES = [(), (7,), (3, 16384), (16384,), (27, 27, 16384), (3, 16383), (16384, 5),
           (4, 40), (40,), (2, 3, 40)]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_placement_rule_matches_jax(n):
    """``_spec_for`` on a table of shapes equals the JAX package's, and
    ``shard_params`` / ``shard_state`` hold the block that spec names."""
    from cfd_with_cuda_tpu.parallel.sharding import _spec_for as jax_spec_for

    big = (16384, 40)
    mesh = sharding.Mesh(n - 1, n, torch.device("cpu"), None)
    for shape in _SHAPES:
        arr = np.zeros(shape, np.float32)
        assert sharding._spec_for(arr, big, "shard", n) == tuple(
            jax_spec_for(arr, big, "shard", n)), shape
    params = {f"a{i}": torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
              for i, s in enumerate(_SHAPES)}
    placed = sharding.shard_params(params, mesh, big)
    state = sharding.shard_state(tuple(params.values()), mesh, big)
    for (k, v), s in zip(params.items(), state):
        spec = sharding._spec_for(v, big, "shard", n)
        want = v[..., -(v.shape[-1] // n):] if spec else v
        assert torch.equal(placed[k], want) and torch.equal(s, want), k


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_sharded_steps_match_jax_spmd8(jax_ref, ranks, kind):
    got, ref = ranks[3, N_DEV][kind], jax_ref[3, N_DEV, kind]
    assert got["s_pad"] == ref["s_pad"] and got["u"].shape == ref["u"].shape
    _close(got, ref, kind, tols=JAX_IMPLICIT_TOLS if kind == "implicit" else None)


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_sharded_steps_across_ranks_match_jax_spmd4(jax_ref, ranks, kind):
    """cavity_deck(8) on 4 ranks against the JAX package's spmd_devices=4
    steps: the grid's rows span three ranks in both packages."""
    got, ref = ranks[8, 4][kind], jax_ref[8, 4, kind]
    assert got["s_pad"] == ref["s_pad"] and got["u"].shape == ref["u"].shape
    _close(got, ref, kind, tols=JAX_IMPLICIT_TOLS if kind == "implicit" else None)


@pytest.mark.parametrize("deck_n,n", [(3, 2), (3, 4), (8, 2), (8, 4)])
@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_sharded_steps_match_single_device(ranks, kind, deck_n, n):
    ref = _steps(kind, deck_n, 0)
    cols = int(np.prod(SOLVERS[kind](cavity_deck(deck_n), _config(kind, 0),
                                     device="cpu").fine_dims))
    _close(ranks[deck_n, n][kind], ref, kind, cols)


def test_spmd1_one_device_mesh_matches_plain_path():
    """spmd_devices=1 (the JAX package's "spmd1" opt-in) runs the sharded
    path on a one-rank mesh; its physics matches the plain single-device path
    (tests/test_sharding.py:262-284's deck and tolerance)."""
    deck = lambda: cavity_deck(6, viscosity=0.01, dt=0.002)
    mons = {}
    for sd in (0, 1):
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_backend="pallas",
                           pressure_warm_start=True, spmd_devices=sd, pressure_cg_tol=1e-6,
                           steps_per_chunk=2, setup_cache=None)
        solver = ExplicitBCHSolver(deck(), cfg, device="cpu")
        assert (solver.spmd_mesh is not None) == (sd == 1)
        _, hist = solver.run(n_steps=4)
        mons[sd] = hist[-1]["u_mon"]
    assert np.isfinite(mons[0]) and np.isfinite(mons[1])
    assert mons[0] == pytest.approx(mons[1], rel=1e-6, abs=1e-12)


def test_dryrun_multichip_two_ranks(capsys):
    from cfd_with_cuda_tpu_torch.graft_entry import dryrun_multichip

    lines = dryrun_multichip(2, "cpu", deck_n=4)
    assert len(lines) == 4 and lines[0].startswith("dryrun_multichip[explicit]:")
    assert "explicit fused sharded" in lines[1] and "implicit fused sharded" in lines[2]
    assert lines[3].startswith("dryrun_multichip[implicit]:") and "mom_iters=" in lines[3]
    assert all("2 devices OK" in ln for ln in lines)
    assert not any("not ported" in ln for ln in lines)
    assert lines[0] in capsys.readouterr().out


def test_dryrun_multichip_runs_on_the_card_by_default(monkeypatch):
    """With no device named the dry run's ranks take the cards, and with no
    card it raises before it spawns a rank: it never falls back to the CPU."""
    from cfd_with_cuda_tpu_torch.graft_entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2, deck_n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(_rank_steps, 2, (3,), backend="gloo", device="cuda:0")


def test_off_the_kernel_layout():
    """On the kernel path a mesh that takes the unstructured layout runs the
    ELL step under ``spmd_devices`` as the JAX package does
    (explicit_bch.py:996-1005: its fields whole on every rank until the
    caller places them, the torch CG on the banded window); off the kernel
    path (F64) nothing changes, as the JAX package's ``spmd_mesh`` is None
    there."""
    from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck

    deck = bfs_deck(12, 4, 4, lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5),
                    viscosity=0.05, dt=0.002)
    ell = ExplicitBCHSolver(deck, SolverConfig(dtype_policy=DTypePolicy.F32, spmd_devices=1),
                            device="cpu")
    assert ell.layout == "ell" and ell.spmd_mesh is not None and ell.block is None
    state, stats = ell._time_step(ell.d, ell.initial_state())
    assert torch.isfinite(state.un).all() and int(stats.cg_iters) > 0
    solver = ExplicitBCHSolver(cavity_deck(3), SolverConfig(spmd_devices=2), device="cpu")
    assert solver.spmd_mesh is None and solver.xla and solver.block is None
