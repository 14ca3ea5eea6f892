"""The annotation-placed paths across ranks: ``parallel/placement.py::place``.

The JAX package runs its XLA structured step and its ELL step sharded with no
code change: the caller places the arrays (``shard_params`` /
``shard_state``) and GSPMD partitions the jitted step.  ``tests/
test_sharding.py`` holds five such cases against the single-device step;
here the same decks, configs and ``shard_pad=8`` go through the port's
``place`` on gloo CPU ranks (spawned on a file store under ``tmp_path``):

* on 8 ranks against the JAX package's single-device jitted step (that file
  holds JAX sharded against JAX single, so one JAX step per case is the
  reference), at that file's tolerances: explicit box u 1e-11 / p 1e-10 /
  u_mon 1e-12; implicit box 1e-10 / 1e-9 / 1e-11; ELL explicit as the box;
  ELL implicit 1e-7 (``momentum_tol`` 1e-12); Kovasznay 1e-10 / 1e-8 /
  1e-11.  These hold as they are: the port's single-device implicit F64 XLA
  step keeps a wider stated bound against the JAX package's (1e-9 of max|u|
  and max|p|, ``tests/test_torch_xla_solvers.py``), which is not needed on
  these decks (the largest gaps read here: implicit box u 2.4e-13,
  Kovasznay u 2.7e-11, p 6.4e-11, ELL implicit u 4.5e-9).  The states'
  shapes and ``s_pad`` equal the JAX package's;
* on 2, 4 and 8 ranks against the port's own single-device step: the
  explicit steps bit for bit (every placed apply sums each row as one device
  does, and the pressure solve is replicated), the implicit ones at the
  same tolerances (the momentum solve's dots are summed over the ranks);
* the ELL ``shard_pad`` repair on one device: ``s_pad``, the padded tables
  and the state shape against the JAX package's on ``bfs_deck(12, 4, 4)``
  with ``shard_pad=8``, both solvers, and the 2 steps within the F64 ELL
  bounds of ``tests/test_torch_unstructured_{explicit,implicit}.py``;
* ``spmd_devices`` on the unstructured layout (the JAX package's ELL step
  under an spmd mesh: the torch CG on the banded window in place of the CG
  kernels, fields whole on every rank) against the JAX package's, and on a
  box whose elements do not tile it (the sharded kernels on the rank's rows,
  the elemental convection of the elements that touch them) on 2 ranks
  against the JAX package's ``spmd_devices=2`` step and, bit for bit, the
  port's one device;
* ``place`` refuses what it cannot place; the ``"bicg"`` momentum solver,
  which the implicit step gives no ``rmatvec``, places and raises its own
  error at the first step, as on one device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.interop import gather_state, state_to_rank
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck, kovasznay_deck
from cfd_with_cuda_tpu_torch.parallel import sharding
from cfd_with_cuda_tpu_torch.parallel.placement import place
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

N_STEPS = 2
BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05)

# case -> (kind, deck maker (either package's generators), config fields,
# tolerances u / p / u_mon of tests/test_sharding.py)
CASES = {
    "box_explicit": ("explicit", lambda g: g["cavity_deck"](3, viscosity=0.1, dt=0.005),
                     dict(pressure_cg_tol=1e-12), (1e-11, 1e-10, 1e-12)),
    "box_implicit": ("implicit", lambda g: g["cavity_deck"](4, viscosity=0.1, dt=0.005),
                     dict(pressure_cg_tol=1e-12), (1e-10, 1e-9, 1e-11)),
    "ell_explicit": ("explicit", lambda g: g["bfs_deck"](12, 4, 4, dt=0.002, **BFS),
                     dict(pressure_cg_tol=1e-12), (1e-11, 1e-10, 1e-12)),
    "ell_implicit": ("implicit", lambda g: g["bfs_deck"](12, 4, 4, dt=0.01, **BFS),
                     dict(pressure_cg_tol=1e-12, momentum_tol=1e-12), (1e-7, 1e-7, 1e-7)),
    "kovasznay": ("implicit", lambda g: g["kovasznay_deck"](4, 4, 2, re=40.0, dt=0.02),
                  dict(pressure_cg_tol=1e-10), (1e-10, 1e-8, 1e-11)),
}
PORT_GENERATORS = dict(cavity_deck=cavity_deck, bfs_deck=bfs_deck,
                       kovasznay_deck=kovasznay_deck)
SOLVERS = dict(explicit=ExplicitBCHSolver, implicit=ImplicitGQSolver)


def _config(case: str, **extra) -> SolverConfig:
    return SolverConfig(dtype_policy=DTypePolicy.F64, steps_per_chunk=1, shard_pad=8,
                        **CASES[case][2], **extra)


def _solver(case: str) -> object:
    kind, deck, _, _ = CASES[case]
    return SOLVERS[kind](deck(PORT_GENERATORS), _config(case), device="cpu")


def _steps(case: str, placed: bool) -> dict:
    """N_STEPS of the port's step from rest, whole state and monitors (on a
    rank of a group when ``placed``)."""
    solver = _solver(case)
    if placed:
        place(solver, sharding.make_mesh())
    state = solver.initial_state()
    mon = []
    for _ in range(N_STEPS):
        state, stats = solver._time_step(solver.d, state)
        mon.append(float(stats.u_mon))
    full = gather_state(state, solver)
    back = state_to_rank(full, solver)
    assert all(torch.equal(a, b) for a, b in zip(back, state))
    return dict(u=full[0].numpy(), p=full[1].numpy(), mon=mon, s_pad=solver.s_pad,
                layout=solver.layout, xla=solver.xla)


def _rank_steps() -> dict:
    return {case: _steps(case, True) for case in CASES}


@pytest.fixture(scope="module")
def single():
    return {case: _steps(case, False) for case in CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's gathered states by rank count (every rank's checked equal)."""
    out = {}
    for n in (2, 4, 8):
        res = run_ranks(_rank_steps, n, (), device="cpu",
                        workdir=tmp_path_factory.mktemp(f"placed{n}"))
        for r in res[1:]:
            for case in CASES:
                np.testing.assert_array_equal(r[case]["u"], res[0][case]["u"])
        out[n] = res[0]
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's single-device jitted steps of the five cases, and
    the tables of its two ELL solvers."""
    import jax

    from cfd_with_cuda_tpu.mesh import generators as jg
    from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
    from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig

    gens = dict(cavity_deck=jg.cavity_deck, bfs_deck=jg.bfs_deck,
                kovasznay_deck=jg.kovasznay_deck)
    out = {}
    for case, (kind, deck, fields, _) in CASES.items():
        cls = JaxExplicit if kind == "explicit" else JaxImplicit
        solver = cls(deck(gens), JaxConfig(dtype_policy=JaxPolicy.F64, steps_per_chunk=1,
                                           shard_pad=8, **fields))
        fn = jax.jit(solver._time_step)
        state, mon = solver.initial_state(), []
        for _ in range(N_STEPS):
            state, stats = fn(solver.d, state)
            mon.append(float(stats.u_mon))
        out[case] = dict(u=np.asarray(state[0]), p=np.asarray(state[1]), mon=mon,
                         s_pad=solver.s_pad, structured=solver.structured, solver=solver)
    return out


def _close(got: dict, ref: dict, case: str) -> None:
    tu, tp, tmon = CASES[case][3]
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=tu)
    np.testing.assert_allclose(got["p"], ref["p"], rtol=0, atol=tp)
    assert got["mon"][-1] == pytest.approx(ref["mon"][-1], abs=tmon)


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_8_ranks_match_jax_single_device(jax_ref, ranks, case):
    got, ref = ranks[8][case], jax_ref[case]
    assert got["s_pad"] == ref["s_pad"] and got["u"].shape == ref["u"].shape
    assert (got["layout"] == "ell") == (not ref["structured"])
    assert got["xla"] == ref["structured"]
    _close(got, ref, case)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_matches_port_single_device(single, ranks, case, n):
    got, ref = ranks[n][case], single[case]
    if CASES[case][0] == "explicit":
        np.testing.assert_array_equal(got["u"], ref["u"])
        np.testing.assert_array_equal(got["p"], ref["p"])
        assert got["mon"] == ref["mon"]
    else:
        _close(got, ref, case)


@pytest.mark.parametrize("case", ["ell_explicit", "ell_implicit"])
def test_ell_shard_pad_matches_jax(jax_ref, single, case):
    """The ELL tables' node axis padded as the JAX package pads it
    (explicit_bch.py:293-311, implicit_gq.py:311-322), and 2 steps within the
    F64 ELL bounds: explicit 1e-12 / 1e-11 (tests/test_torch_unstructured_
    explicit.py), implicit 1e-6 of max|u| and max|p|
    (tests/test_torch_unstructured_implicit.py)."""
    js, ts = jax_ref[case]["solver"], _solver(case)
    assert ts.layout == "ell" and ts.s_pad == js.s_pad and ts.s_pad % 8 == 0
    assert ts.s_pad > ts.nn
    jd = {k: np.asarray(v) for k, v in js.d.items()}
    if case == "ell_explicit":
        padded = ("md_inv", "md_orig_inv", "bc_mask", "bc_vel")
    else:
        padded = ("m_vals", "A_cols", "G_vals", "G_cols", "bc_mask", "bc_vel")
        # the JAX map addresses the unpadded (L, NN) table, the port's the padded one
        c2e = jd["csr_to_ell"]
        np.testing.assert_array_equal(ts.d["csr_to_ell"].numpy(),
                                      (c2e // ts.nn) * ts.s_pad + c2e % ts.nn)
    for k in padded:
        assert jd[k].shape[-1] == ts.s_pad, k
        np.testing.assert_array_equal(ts.d[k].numpy(), jd[k], err_msg=k)
    state, jstate = ts.initial_state(), js.initial_state()
    assert [tuple(f.shape) for f in state] == [tuple(np.shape(f)) for f in jstate]
    got, ref = single[case], jax_ref[case]
    if case == "ell_explicit":
        np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["p"], ref["p"], rtol=0, atol=1e-11)
    else:
        assert np.abs(got["u"] - ref["u"]).max() <= 1e-6 * np.abs(ref["u"]).max()
        assert np.abs(got["p"] - ref["p"]).max() <= 1e-6 * np.abs(ref["p"]).max()
    assert np.all(got["u"][:, ts.nn:] == 0.0)


def _ell_spmd1_config(**extra) -> dict:
    return dict(dtype_policy="f32", pressure_backend="pallas", pressure_cg_tol=1e-6,
                steps_per_chunk=1, spmd_devices=1, **extra)


def test_spmd_devices_on_the_unstructured_layout_matches_jax(monkeypatch):
    """``spmd_devices=1`` on the kernel path over the BFS deck: as in the JAX
    package (explicit_bch.py:996-1005) the ELL step runs, its fields whole,
    with the torch CG on the banded window in place of the CG kernels; 2
    steps of both against the JAX package's at the F32 ELL bounds
    (tests/test_torch_unstructured_explicit.py: u 5e-6 and p 5e-5 of
    max|.|)."""
    from cfd_with_cuda_tpu.mesh.generators import bfs_deck as jax_bfs_deck
    from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
    from cfd_with_cuda_tpu_torch.solvers import explicit_bch

    import jax

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CG kernels ran under spmd_devices on the ELL layout")

    monkeypatch.setattr(explicit_bch, "fused_cg", no_kernel)
    monkeypatch.setattr(explicit_bch, "fused_cg_plain", no_kernel)

    cfg = _ell_spmd1_config()
    ts = ExplicitBCHSolver(bfs_deck(12, 4, 4, dt=0.002, **BFS),
                           SolverConfig(**{**cfg, "dtype_policy": DTypePolicy.F32}),
                           device="cpu")
    assert ts.layout == "ell" and ts.spmd_mesh is not None and ts.block is None
    assert ts.z_offs is not None
    js = JaxExplicit(jax_bfs_deck(12, 4, 4, dt=0.002, **BFS),
                     JaxConfig(**{**cfg, "dtype_policy": JaxPolicy.F32}))
    assert js.spmd_mesh is not None and "Z_bwin_cg" in js.d
    fn = jax.jit(js._time_step)
    state, jstate = ts.initial_state(), js.initial_state()
    for _ in range(N_STEPS):
        state, stats = ts._time_step(ts.d, state)
        jstate, jstats = fn(js.d, jstate)
    u_j, p_j = np.asarray(jstate[0]), np.asarray(jstate[1])
    assert np.abs(state.un.numpy() - u_j).max() <= 5e-6 * np.abs(u_j).max()
    assert np.abs(state.pn.numpy() - p_j).max() <= 5e-5 * np.abs(p_j).max()
    assert abs(int(stats.cg_iters) - int(jstats.cg_iters)) <= 1
    # the implicit ELL step runs under spmd_devices as on one device
    deck = lambda: bfs_deck(12, 4, 4, dt=0.01, **BFS)
    one = ImplicitGQSolver(deck(), SolverConfig(dtype_policy=DTypePolicy.F32,
                                                pressure_cg_tol=1e-6), device="cpu")
    spmd = ImplicitGQSolver.from_tables(deck(), SolverConfig(dtype_policy=DTypePolicy.F32,
                                                             pressure_cg_tol=1e-6,
                                                             spmd_devices=1),
                                        one.d, one.static_attrs(), device="cpu")
    assert spmd.spmd_mesh is not None and spmd.block is None
    a, _ = one._time_step(one.d, one.initial_state())
    b, _ = spmd._time_step(spmd.d, spmd.initial_state())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


QUARTER = [1, 2, 3, 0, 5, 6, 7, 4]


def _turned_box(make=cavity_deck):
    """``cavity_deck(8)`` (of either package's generators) with its first
    inner element relabelled by a quarter turn: a box grid whose elements do
    not tile it (tests/test_torch_interleaved_explicit.py).  Its 17^3 fine
    rows fill more than one rank's block, so on 2 ranks the owned elements,
    the halos and the norms cross a rank boundary."""
    deck = make(8, viscosity=0.1, dt=0.01)
    on_bc = set(np.asarray(deck.bc_vel_faces)[:, 0].tolist())
    inner = min(e for e in range(deck.conn.shape[0]) if e not in on_bc)
    deck.conn[inner] = deck.conn[inner][QUARTER]
    return deck


# the JAX package's sharded-step configuration (tests/test_sharded_stencil.py)
ELEMENTAL_CFG = dict(pressure_backend="pallas", pressure_cg_tol=1e-6, pressure_warm_start=True,
                     steps_per_chunk=1)


def _elemental_box_steps(spmd: int) -> dict:
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, spmd_devices=spmd, **ELEMENTAL_CFG)
    solver = ExplicitBCHSolver(_turned_box(), cfg, device="cpu")
    assert solver.layout == "interleaved" and not solver.elem_structured
    assert (solver.block is not None) == (spmd > 0) and solver.slab is None
    assert spmd < 2 or solver.block.s_loc < solver.nn      # rows on both ranks
    state, mon, cg = solver.initial_state(), [], []
    for _ in range(N_STEPS):
        state, stats = solver._time_step(solver.d, state)
        mon.append(float(stats.u_mon))
        cg.append(int(stats.cg_iters))
    u, p = solver.fields(state)
    return dict(u=u, p=p, mon=mon, cg=cg)


def _rank_elemental_box() -> dict:
    return _elemental_box_steps(sharding.make_mesh().size)


def _jax_elemental_box_steps(spmd: int) -> dict:
    """The JAX package's explicit step on the same box under ``spmd_devices``
    on its virtual CPU mesh, the arrays placed by its own caller's rule
    (tests/test_torch_sharding.py)."""
    import jax

    from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_deck
    from cfd_with_cuda_tpu.parallel.sharding import make_mesh, shard_params, shard_state
    from cfd_with_cuda_tpu.solvers.base import unpack_chunk_stats
    from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
    from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
    from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig

    solver = JaxExplicit(_turned_box(jax_deck),
                         JaxConfig(dtype_policy=JaxPolicy.F32, spmd_devices=spmd,
                                   setup_cache="off", **ELEMENTAL_CFG))
    assert solver.spmd_mesh is not None and not solver.elem_structured
    mesh = make_mesh(spmd)
    params = shard_params(solver.d, mesh, (solver.s_pad,))
    state = shard_state(solver.initial_state(), mesh, (solver.s_pad,))
    fn = jax.jit(solver._chunk_fn(1))
    mon, cg = [], []
    for _ in range(N_STEPS):
        state, packed = fn(params, state)
        st, _ = unpack_chunk_stats(packed)
        mon.append(float(st.u_mon[0]))
        cg.append(int(st.cg_iters[0]))
    u, p = solver.fields(state)
    return dict(u=u, p=p, mon=mon, cg=cg)


def test_spmd_devices_on_a_box_without_element_tiling(tmp_path):
    """The explicit solver's interleaved layout on a box whose elements do not
    tile it, under ``spmd_devices=2`` on 2 ranks: K, G and G^T through the
    sharded kernels on the rank's rows, the convection from the elements that
    touch them (the JAX package runs its shard_map kernels there and GSPMD
    places the elemental convection, explicit_bch.py:1101-1110).  Held
    against the JAX package's ``spmd_devices=2`` step on its virtual CPU
    mesh at the JAX package's sharded tolerances
    (tests/test_sharded_stencil.py:124-136: u 2e-5 / 2e-6, p 2e-5, u_mon
    1e-6, equal CG counts), as tests/test_torch_sharding.py holds the tiled
    box; and bit for bit against the port's one device: the sharded kernels'
    plain forms are one device's applies on the rank's rows, each owned row
    sums its convection terms in one device's order, and the rank-summed
    norms only steer the stopping tests."""
    ref = _elemental_box_steps(0)
    got = run_ranks(_rank_elemental_box, 2, (), device="cpu", workdir=tmp_path)[0]
    np.testing.assert_array_equal(got["u"], ref["u"])
    np.testing.assert_array_equal(got["p"], ref["p"])
    assert got["mon"] == ref["mon"] and got["cg"] == ref["cg"]
    jref = _jax_elemental_box_steps(2)
    assert got["u"].shape == jref["u"].shape
    np.testing.assert_allclose(got["u"], jref["u"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["p"], jref["p"], rtol=2e-5, atol=2e-5)
    assert got["mon"][-1] == pytest.approx(jref["mon"][-1], abs=1e-6)
    assert got["cg"] == jref["cg"]


def test_place_refuses_what_it_cannot_place():
    mesh = sharding.Mesh(0, 2, torch.device("cpu"), None)
    kernel = ExplicitBCHSolver(cavity_deck(3), SolverConfig(dtype_policy=DTypePolicy.F32),
                               device="cpu")
    with pytest.raises(ValueError, match="spmd_devices"):
        place(kernel, mesh)
    odd = ExplicitBCHSolver(cavity_deck(3), SolverConfig(), device="cpu")
    with pytest.raises(ValueError, match="shard_pad"):
        place(odd, mesh)
    # "bicg" places, and its first step raises its own error (the implicit
    # step passes no rmatvec), placed as on one device
    errors = []
    for placed in (False, True):
        bicg = ImplicitGQSolver(cavity_deck(3), SolverConfig(momentum_solver="bicg",
                                                             shard_pad=2), device="cpu")
        if placed:
            place(bicg, sharding.make_mesh(1))
        with pytest.raises(ValueError, match="rmatvec") as err:
            bicg._time_step(bicg.d, bicg.initial_state())
        errors.append(str(err.value))
    assert errors[0] == errors[1]
