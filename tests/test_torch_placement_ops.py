"""Each placed operator against its single-device operator, on 2 and 8 ranks.

Every rank builds the same small solvers twice, places one
(``parallel/placement.py::place``), applies both to the same inputs (made
from a seed with numpy) and holds the placed result, its block of the rows
(or the whole replicated vector), against the single-device one:

* the halo exchange with halos wider than a block (several ranks give
  their rows) against the slice of the whole field;
* the XLA structured path's operators (``_xla_operators``) on
  ``cavity_deck(3)`` with ``shard_pad=8``: explicit F64 (K and K + A(un) by
  DIA and the slab convection, G and G^T in roll form), explicit F32 (G and
  G^T in window-patches form, run in f64 here), implicit F64 (the LHS
  assembled on the rank's slab, A and M), and the explicit F64 step on a
  box whose elements do not tile it (the convection of the elements that
  touch the rank's rows, ``ops/spmv.py::convection_apply``);
* the ELL path's (``_ell_operators``, ``_ell_lhs``) on ``bfs_deck(12, 4,
  4)`` with ``shard_pad=8``: K, K + A(un), G, G^T, and the implicit LHS
  (CSR assembly, the csr -> ELL scatter, its diagonal);
* ``placed_ops`` alone: ``dia_spmv_placed`` on a 1-D field.

The DIA and elemental forms sum each row as one device does: bit for bit.
The window-patches forms contract the same windows with ``einsum`` over
fewer columns: within 1e-14 of the largest value.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.parallel import sharding
from cfd_with_cuda_tpu_torch.parallel.placed_ops import dia_spmv_placed
from cfd_with_cuda_tpu_torch.parallel.placement import place
from cfd_with_cuda_tpu_torch.parallel.spawn import run_ranks
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05)
QUARTER = [1, 2, 3, 0, 5, 6, 7, 4]
PATCHES_TOL = 1e-14


def _turned_box():
    """A box grid whose elements do not tile it (tests/test_torch_interleaved_
    explicit.py)."""
    deck = cavity_deck(3, viscosity=0.1, dt=0.01)
    on_bc = set(np.asarray(deck.bc_vel_faces)[:, 0].tolist())
    (inner,) = [e for e in range(deck.conn.shape[0]) if e not in on_bc]
    deck.conn[inner] = deck.conn[inner][QUARTER]
    return deck


# solver -> (class, deck, config fields)
SOLVER_CASES = {
    "xla_f64_explicit": (ExplicitBCHSolver, lambda: cavity_deck(3, viscosity=0.1, dt=0.005),
                         dict(dtype_policy=DTypePolicy.F64)),
    "xla_f32_explicit": (ExplicitBCHSolver, lambda: cavity_deck(3, viscosity=0.1, dt=0.005),
                         dict(dtype_policy=DTypePolicy.F32, pressure_backend="xla")),
    "xla_f64_implicit": (ImplicitGQSolver, lambda: cavity_deck(3, viscosity=0.1, dt=0.005),
                         dict(dtype_policy=DTypePolicy.F64)),
    "xla_f64_elemental": (ExplicitBCHSolver, _turned_box, dict(dtype_policy=DTypePolicy.F64)),
    "ell_explicit": (ExplicitBCHSolver, lambda: bfs_deck(12, 4, 4, dt=0.002, **BFS),
                     dict(dtype_policy=DTypePolicy.F64)),
    "ell_implicit": (ImplicitGQSolver, lambda: bfs_deck(12, 4, 4, dt=0.01, **BFS),
                     dict(dtype_policy=DTypePolicy.F64)),
}
# op name -> whether its placed form equals one device's bit for bit
OPS = {
    "halo_exchange": True, "dia_spmv_1d": True,
    "xla_f64_explicit.k": True, "xla_f64_explicit.ka": True,
    "xla_f64_explicit.grad": True, "xla_f64_explicit.div": True,
    "xla_f32_explicit.grad": False, "xla_f32_explicit.div": False,
    "xla_f64_implicit.a": True, "xla_f64_implicit.m": True, "xla_f64_implicit.a_diag": True,
    "xla_f64_elemental.ka": True,
    "ell_explicit.k": True, "ell_explicit.ka": True, "ell_explicit.grad": True,
    "ell_explicit.div": True,
    "ell_implicit.a_ell": True, "ell_implicit.a_diag": True,
}


def _pair(case: str):
    cls, deck, fields = SOLVER_CASES[case]
    cfg = SolverConfig(steps_per_chunk=1, shard_pad=8, **fields)
    one = cls(deck(), cfg, device="cpu")
    placed = cls(deck(), cfg, device="cpu")
    return one, place(placed, sharding.make_mesh())


def _field(rng, solver, c: int = 3) -> torch.Tensor:
    """A field on the padded node axis, zero on the padding rows."""
    n = solver.nn if solver.layout == "ell" else int(np.prod(solver.fine_dims))
    x = np.zeros((c, solver.s_pad))
    x[:, :n] = rng.standard_normal((c, n))
    return torch.from_numpy(x).to(solver.config.torch_dtype())


def _cmp(placed: torch.Tensor, whole: torch.Tensor, bit: bool) -> dict:
    a, b = placed.double().numpy(), whole.double().numpy()
    err = float(np.abs(a - b).max()) if a.size else 0.0
    return dict(bit=bool(np.array_equal(a, b)), err=err,
                scale=float(np.abs(b).max()) if b.size else 0.0)


def _rank_ops() -> dict:
    mesh = sharding.make_mesh()
    rng = np.random.default_rng(20261018)
    out = {}

    # the halo exchange, halos wider than a block
    x = torch.from_numpy(rng.standard_normal((2, 8 * mesh.size)))
    blk = x[:, mesh.rank * 8: (mesh.rank + 1) * 8].contiguous()
    ext, lo = sharding.halo_exchange(blk, 19, 13, mesh)
    r0 = mesh.rank * 8
    out["halo_exchange"] = _cmp(ext, x[:, r0 - lo: min(x.shape[1], r0 + 8 + 13)], True)
    offs = (-19, -1, 0, 3, 13)
    vals = torch.from_numpy(rng.standard_normal((len(offs), x.shape[1])))
    from cfd_with_cuda_tpu_torch.ops.stencil import dia_spmv

    whole = dia_spmv(vals * _no_wrap(offs, x.shape[1]), x[0], offs)
    out["dia_spmv_1d"] = _cmp(
        dia_spmv_placed((vals * _no_wrap(offs, x.shape[1]))[:, r0: r0 + 8].contiguous(),
                        blk[0].contiguous(), offs, mesh), whole[r0: r0 + 8], True)

    for case in ("xla_f64_explicit", "xla_f32_explicit", "xla_f64_elemental"):
        one, pl = _pair(case)
        if case == "xla_f32_explicit":
            # the patches forms in f64: their sums, not the storage's rounding
            one.d = {k: v.double() if v.is_floating_point() else v for k, v in one.d.items()}
            pl.d = {k: v.double() if v.is_floating_point() else v for k, v in pl.d.items()}
        un, u = _field(rng, one).double(), _field(rng, one).double()
        p = torch.from_numpy(rng.standard_normal(one.nnp))
        k1, ka1, g1, dv1 = one._xla_operators(one.d, un)[:4]
        k2, ka2, g2, dv2 = pl._xla_operators(pl.d, pl._local(un))[:4]
        bit = case != "xla_f32_explicit"
        if case == "xla_f64_explicit":
            out[case + ".k"] = _cmp(k2(pl._local(u)), pl._local(k1(u)), bit)
        if case != "xla_f32_explicit":
            out[case + ".ka"] = _cmp(ka2(pl._local(u)), pl._local(ka1(u)), bit)
        if case != "xla_f64_elemental":
            out[case + ".grad"] = _cmp(g2(p), pl._local(g1(p)), bit)
            out[case + ".div"] = _cmp(dv2(pl._local(u)), dv1(u), bit)

    one, pl = _pair("xla_f64_implicit")
    uk, x = _field(rng, one), _field(rng, one)
    a1, m1, _, _, ad1 = one._xla_operators(one.d, uk)
    a2, m2, _, _, ad2 = pl._xla_operators(pl.d, pl._local(uk))
    out["xla_f64_implicit.a"] = _cmp(a2(pl._local(x)), pl._local(a1(x)), True)
    out["xla_f64_implicit.m"] = _cmp(m2(pl._local(x)), pl._local(m1(x)), True)
    out["xla_f64_implicit.a_diag"] = _cmp(ad2, pl._local(ad1), True)

    one, pl = _pair("ell_explicit")
    un, u = _field(rng, one), _field(rng, one)
    p = torch.from_numpy(rng.standard_normal(one.nnp))
    k1, ka1, g1, dv1 = one._ell_operators(one.d, un)[:4]
    k2, ka2, g2, dv2 = pl._ell_operators(pl.d, pl._local(un))[:4]
    out["ell_explicit.k"] = _cmp(k2(pl._local(u)), pl._local(k1(u)), True)
    out["ell_explicit.ka"] = _cmp(ka2(pl._local(u)), pl._local(ka1(u)), True)
    out["ell_explicit.grad"] = _cmp(g2(p), pl._local(g1(p)), True)
    out["ell_explicit.div"] = _cmp(dv2(pl._local(u)), dv1(u), True)

    one, pl = _pair("ell_implicit")
    uk = _field(rng, one)
    a1, d1 = one._ell_lhs(one.d, uk)
    a2, d2 = pl._ell_lhs(pl.d, pl._local(uk))
    out["ell_implicit.a_ell"] = _cmp(a2, pl._local(a1), True)
    out["ell_implicit.a_diag"] = _cmp(d2, pl._local(d1), True)
    return out


def _no_wrap(offs, n: int) -> torch.Tensor:
    """Zero every diagonal entry whose column falls off the axis (a DIA
    table's structure: dia_spmv's roll then wraps onto zero weights)."""
    g = torch.arange(n)
    return torch.stack([((g + o >= 0) & (g + o < n)).double() for o in offs])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's comparisons, by rank count."""
    return {n: run_ranks(_rank_ops, n, (), device="cpu",
                         workdir=tmp_path_factory.mktemp(f"ops{n}")) for n in (2, 8)}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("n", [2, 8])
def test_placed_op_matches_single_device(ranks, n, op):
    for rank, res in enumerate(ranks[n]):
        r = res[op]
        if OPS[op]:
            assert r["bit"], (rank, r)
        else:
            assert r["err"] <= PATCHES_TOL * r["scale"], (rank, r)
