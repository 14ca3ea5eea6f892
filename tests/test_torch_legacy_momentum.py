"""PyTorch port: the implicit solver's ``momentum_solver`` choices beyond
BiCGStab, against the JAX package on ``cavity_deck(3)`` (CPU).

* ``"cr"``: 3 F64 steps on the ELL path (``structured="never"``) and on the
  XLA structured path (the default ``SolverConfig()``: F64, the V-cycle),
  at the tolerances of ``tests/test_torch_xla_solvers.py`` (CG and momentum
  tol 1e-10): u and p within 1e-9 of max|u| and max|p| (that file's
  implicit F64 bound, set by the JAX solver's own spread), equal CG and CR
  counts every step.
* ``"cr"`` on the parity and interleaved layouts (F32): runs, the two
  layouts within the implicit F32 bound of each other.
* ``"bicg"``: the implicit step passes no transpose apply, so its first
  step raises the JAX package's ``ValueError`` in both packages.
* ``"gmres"``: the JAX package's step fails with it (its batched GMRES,
  ``ops/krylov.py:441``), shown here on the ELL path; the port raises a
  ``ValueError`` naming that defect when the solver is built.
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxImplicit
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

DECK = dict(viscosity=0.1, dt=0.01, t_final=1.0)
CFG = dict(steps_per_chunk=5, pressure_cg_tol=1e-10, momentum_tol=1e-10, setup_cache="off")
PATHS = {"ell": dict(structured="never"), "xla": {}}
N_STEPS = 3
F64_TOL = 1e-9


def _run(solver, step, n):
    st, rows = solver.initial_state(), []
    for _ in range(n):
        st, stats = step(solver.d, st)
        rows.append((int(stats.cg_iters), int(stats.mom_iters)))
    return st, rows


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cr_momentum_solver_matches_jax(path):
    cfg = dict(CFG, momentum_solver="cr", **PATHS[path])
    js = JaxImplicit(jax_cavity_deck(3, **DECK), JaxConfig(**cfg))
    ts = ImplicitGQSolver(cavity_deck(3, **DECK), SolverConfig(**cfg), device="cpu")
    if path == "ell":
        assert not js.structured and ts.layout == "ell"
    else:
        assert ts.xla and ts.layout == js.layout == "interleaved"
    st_j, rows_j = _run(js, jax.jit(js._time_step), N_STEPS)
    st_t, rows_t = _run(ts, ts._time_step, N_STEPS)
    assert rows_t == rows_j and min(min(r) for r in rows_t) > 0
    (u_j, p_j), (u_t, p_t) = js.fields(st_j), ts.fields(st_t)
    assert np.abs(u_t - u_j).max() <= F64_TOL * np.abs(u_j).max()
    assert np.abs(p_t - p_j).max() <= F64_TOL * np.abs(p_j).max()


def test_bicg_momentum_solver_raises_as_jax():
    cfg = dict(CFG, momentum_solver="bicg", structured="never")
    js = JaxImplicit(jax_cavity_deck(3, **DECK), JaxConfig(**cfg))
    ts = ImplicitGQSolver(cavity_deck(3, **DECK), SolverConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="rmatvec") as ej:
        jax.jit(js._time_step)(js.d, js.initial_state())
    with pytest.raises(ValueError, match="rmatvec") as et:
        ts._time_step(ts.d, ts.initial_state())
    assert str(et.value) == str(ej.value)


def test_gmres_momentum_solver_fails_in_jax_and_is_refused():
    cfg = dict(CFG, momentum_solver="gmres", structured="never")
    js = JaxImplicit(jax_cavity_deck(3, **DECK), JaxConfig(**cfg))
    with pytest.raises(ValueError, match="out_axes"):
        jax.jit(js._time_step)(js.d, js.initial_state())
    with pytest.raises(ValueError, match="ops/krylov.py:441"):
        ImplicitGQSolver(cavity_deck(3, **DECK), SolverConfig(**cfg), device="cpu")


def test_cr_momentum_solver_runs_on_the_kernel_layouts():
    """F32 on the two kernel layouts (their plain versions here), 2 steps:
    finite fields, CR iterations every step, and the two layouts' runs of
    one algorithm (they read 2.0e-7 / 2.8e-6 apart, counts equal) within
    the implicit F32 bound of
    ``tests/test_torch_implicit.py`` (5e-5 of max|u| and max|p|).  The JAX
    package runs these layouts in Pallas interpret mode only, so they are
    not held against it here."""
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy

    fields = []
    for layout in ("parity", "interleaved"):
        cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                           structured_layout=layout, momentum_solver="cr", setup_cache="off")
        ts = ImplicitGQSolver(cavity_deck(3, viscosity=0.01, dt=0.01), cfg, device="cpu")
        assert ts.layout == layout and not ts.xla
        st, rows = _run(ts, ts._time_step, 2)
        u, p = ts.fields(st)
        assert np.isfinite(u).all() and np.isfinite(p).all() and min(r[1] for r in rows) > 0
        fields.append((u, p, rows))
    (u_a, p_a, rows_a), (u_b, p_b, rows_b) = fields
    assert np.abs(u_a - u_b).max() <= 5e-5 * np.abs(u_b).max()
    assert np.abs(p_a - p_b).max() <= 5e-5 * np.abs(p_b).max()
