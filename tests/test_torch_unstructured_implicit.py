"""PyTorch port: the implicit GQ solver's ELL step (any mesh that is not an
element-structured box grid, or ``structured="never"``) against the JAX
solver's ELL step (XLA ops only, as the port's is torch ops only).

On the small backward-facing step ``bfs_deck(12, 4, 4, lengths=(6, 2, 2),
step_frac=(0.25, 0.5))`` at dt 0.01 (``tests/test_bfs.py:75-89``):

* the first step from rest, where both packages solve the same systems:
  F64 to 1e-12 of max|.| with equal counts; F32 and MIXED within the
  implicit bound 5e-5 of max|.|, CG and BiCGStab counts within 1;
* three steps.  From step 2 the momentum BiCGStab needs 60-90 iterations
  and its ||r|| is not monotone there, so where it crosses 1e-6 ||b||
  hangs on rounding: even in F64 the two packages stop 2 iterations apart
  and their u differ by 7e-4 of max|u| after 3 steps; the JAX BiCGStab
  departs as far from itself when b moves by 1e-15 (the test of that
  below), while the port tracks it over the first 10 iterations to 1e-10.
  So three steps are
  held in F64 at tolerance 1e-10 (u, p to 1e-6 of max|.|, BiCGStab counts
  within 10 %), and in F32 / MIXED at the default tolerances to what that
  sensitivity allows (u 1e-2, p 5e-4 of max|.|, BiCGStab within 15 %).
  CG counts stay within 1 everywhere.  The deck's natural-outflow plane
  gives the pressure rows their Dirichlet elimination (``p_mask``): the
  pressure stays exactly 0 there in both packages.

And F64 under ``structured="never"`` on ``cavity_deck(3)`` against the
scipy direct-solve oracle, with the deck, config and bounds of
``tests/test_implicit_solver.py:12-28``.

A box mesh whose elements do not tile the grid (one element's corners
relabelled by a quarter turn) takes the ELL step in both packages, as the
per-step assembly of the structured step needs element-grid structure;
the explicit solver takes the interleaved layout there
(``tests/test_torch_interleaved_explicit.py`` holds it against the JAX
package).
"""

import numpy as np
import pytest
import torch

import jax

from cfd_with_cuda_tpu.mesh.generators import bfs_deck as jax_bfs_deck
from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.oracle.implicit_oracle import ImplicitOracle
from cfd_with_cuda_tpu.solvers.implicit_gq import ImplicitGQSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.mesh.generators import bfs_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

BFS = dict(lengths=(6.0, 2.0, 2.0), step_frac=(0.25, 0.5), viscosity=0.05, dt=0.01)
CFG = dict(pressure_cg_tol=1e-6, pressure_warm_start=True, steps_per_chunk=1,
           setup_cache="off")
N_STEPS = 3
TOL = 5e-5


def _run(solver, step, n):
    st, rows = solver.initial_state(), []
    for _ in range(n):
        st, stats = step(solver.d, st)
        rows.append((int(stats.mom_iters), int(stats.cg_iters)))
    return st, np.asarray(rows)


def _pair(policy, **extra):
    cfg = dict(CFG, **extra)
    js = JaxSolver(jax_bfs_deck(12, 4, 4, **BFS),
                   JaxConfig(dtype_policy=getattr(JaxPolicy, policy), **cfg))
    ts = ImplicitGQSolver(bfs_deck(12, 4, 4, **BFS),
                          SolverConfig(dtype_policy=getattr(DTypePolicy, policy), **cfg),
                          device="cpu")
    assert not js.structured and ts.layout == "ell"
    return js, ts


def _compare(js, ts, n_steps):
    """(port rows, JAX rows, du, dp of max|.|) after ``n_steps``; the
    outflow rows of p stay 0 in both."""
    before = dict(cuda_lib.launch_counts)
    st, rows = _run(ts, ts._time_step, n_steps)
    assert dict(cuda_lib.launch_counts) == before
    st_j, ref_rows = _run(js, jax.jit(js._time_step), n_steps)
    assert (rows > 0).all() and np.abs(rows[:, 1] - ref_rows[:, 1]).max() <= 1      # CG
    u, p = ts.fields(st)
    u_j, p_j = js.fields(st_j)
    assert u.dtype == np.dtype(ts.config.np_dtype())
    outflow = ts.d["p_mask"].numpy() == 0.0
    assert outflow.sum() == 25 and not ts.ppe_project
    for pk in (st.pk.numpy(), st.pk_prev.numpy(), p_j):
        assert np.all(pk[outflow] == 0.0)
    assert np.abs(p).max() > 0.0
    du = np.abs(u - u_j).max() / np.abs(u_j).max()
    dp = np.abs(p - p_j).max() / np.abs(p_j).max()
    return rows, ref_rows, du, dp


@pytest.mark.parametrize("policy", ["F32", "MIXED", "F64"])
def test_bfs_ell_first_step_matches_jax(policy):
    rows, ref_rows, du, dp = _compare(*_pair(policy), 1)
    if policy == "F64":
        np.testing.assert_array_equal(rows, ref_rows)
        assert du <= 1e-12 and dp <= 1e-12
    else:
        assert np.abs(rows[:, 0] - ref_rows[:, 0]).max() <= 1                     # BiCGStab
        assert du <= TOL and dp <= TOL


@pytest.mark.parametrize("policy,mom_rel,u_tol,p_tol,extra", [
    ("F32", 0.15, 1e-2, 5e-4, {}),
    ("MIXED", 0.15, 1e-2, 5e-4, {}),
    ("F64", 0.10, 1e-6, 1e-6, dict(momentum_tol=1e-10, pressure_cg_tol=1e-10)),
], ids=["F32", "MIXED", "F64_tight"])
def test_bfs_ell_three_steps_match_jax(policy, mom_rel, u_tol, p_tol, extra):
    rows, ref_rows, du, dp = _compare(*_pair(policy, **extra), N_STEPS)
    assert np.all(np.abs(rows[:, 0] - ref_rows[:, 0]) <= mom_rel * ref_rows[:, 0])
    assert du <= u_tol and dp <= p_tol


def test_bfs_ell_momentum_solve_tracks_jax_as_far_as_jax_tracks_itself():
    """Why three steps are held loosely.  On the second step's momentum
    system (from the JAX state after one F64 step, so both sides see the
    same operator, right-hand side and start), the port's BiCGStab tracks
    the JAX one to 1e-10 of max|x| over 10 iterations; the JAX BiCGStab
    itself, with b perturbed by 1e-15 of its size, departs from its own
    iterate by more than 1e-3 of max|x| at 40 iterations."""
    from cfd_with_cuda_tpu.ops import krylov as jk
    from cfd_with_cuda_tpu.ops.spmv import ell_spmv as jax_ell_spmv
    from cfd_with_cuda_tpu_torch.interop import implicit_state_from_jax
    from cfd_with_cuda_tpu_torch.ops import krylov as tk
    from cfd_with_cuda_tpu_torch.ops import spmv
    from cfd_with_cuda_tpu_torch.ops.gradient import grad_apply

    js, ts = _pair("F64")
    st_j, _ = jax.jit(js._time_step)(js.d, js.initial_state())
    st, d = implicit_state_from_jax(st_j), ts.d
    conv = spmv.convection_assemble_csr(st.uk, d["ltog"], d["Sv"], d["gDSv"], d["gq"],
                                        d["rev_m"])
    a_csr = (d["mk_vals_csr"] + conv) * d["row_mask"] + d["diag_add"]
    a_ell = a_csr.new_zeros(d["A_cols"].numel())
    a_ell[d["csr_to_ell"]] = a_csr
    a_ell = a_ell.reshape(d["A_cols"].shape)
    b = spmv.ell_spmv(d["m_vals"], d["A_cols"], st.uk)
    b = b - grad_apply(d["G_vals"], d["G_cols"], 2.0 * st.pk - st.pk_prev)
    b = b * d["bc_mask"][None] + d["bc_vel"]
    diag = a_csr[d["diag_slots"]]
    vals_j, cols_j, diag_j = (jax.numpy.asarray(t.numpy()) for t in (a_ell, d["A_cols"], diag))

    def jax_solve(rhs, k):
        return np.asarray(jk.bicgstab(
            lambda x: jax_ell_spmv(vals_j, cols_j, x), jax.numpy.asarray(rhs), x0=st_j.uk,
            tol=1e-6, atol=0.0, maxiter=k, miniter=1, precond=lambda r: r / diag_j).x)

    x10 = tk.bicgstab(lambda x: spmv.ell_spmv(a_ell, d["A_cols"], x), b, x0=st.uk, tol=1e-6,
                      atol=0.0, maxiter=10, miniter=1, precond=lambda r: r / diag).x.numpy()
    ref10 = jax_solve(b.numpy(), 10)
    scale = np.abs(ref10).max()
    assert np.abs(x10 - ref10).max() <= 1e-10 * scale
    eps = 1e-15 * np.random.default_rng(0).standard_normal(b.shape)
    drift = np.abs(jax_solve(b.numpy() * (1 + eps), 40) - jax_solve(b.numpy(), 40)).max()
    assert drift > 1e-3 * scale


def test_f64_never_structured_matches_oracle():
    deck = cavity_deck(3, viscosity=0.1, dt=0.01, t_final=1.0)
    cfg = SolverConfig(steps_per_chunk=5, pressure_cg_tol=1e-10, momentum_tol=1e-10,
                       structured="never")
    ts = ImplicitGQSolver(deck, cfg, device="cpu")
    assert ts.layout == "ell" and ts.d["m_vals"].dtype == torch.float64
    state, hist = ts.run(n_steps=5)
    u, p = ts.fields(state)
    u_o, p_o, _ = ImplicitOracle(deck).run(5)
    np.testing.assert_allclose(u, u_o, rtol=0, atol=5e-8)
    np.testing.assert_allclose(p, p_o, rtol=0, atol=5e-6)
    assert all(h["mom_iters"] > 0 and h["cg_iters"] > 0 for h in hist)


# a quarter turn about z of a hex's corner labels: local[QUARTER[i]] = R local[i]
QUARTER = [1, 2, 3, 0, 5, 6, 7, 4]


def _turned_box(make_deck):
    """``cavity_deck(3)`` with its one element that has no boundary face
    relabelled by a quarter turn: still a box grid, no longer element-tiled."""
    deck = make_deck(3, viscosity=0.1, dt=0.01)
    on_bc = set(np.asarray(deck.bc_vel_faces)[:, 0].tolist())
    (inner,) = [e for e in range(deck.conn.shape[0]) if e not in on_bc]
    deck.conn[inner] = deck.conn[inner][QUARTER]
    return deck


@pytest.mark.parametrize("policy,tol", [("F32", TOL), ("F64", 1e-12)])
def test_box_without_element_structure_takes_the_ell_step_as_jax_does(policy, tol):
    cfg = dict(CFG, dtype_policy=policy)
    js = JaxSolver(_turned_box(jax_cavity_deck),
                   JaxConfig(**cfg | dict(dtype_policy=getattr(JaxPolicy, policy))))
    ts = ImplicitGQSolver(_turned_box(cavity_deck),
                          SolverConfig(**cfg | dict(dtype_policy=getattr(DTypePolicy, policy))),
                          device="cpu")
    assert not js.structured and ts.layout == "ell"
    st, rows = _run(ts, ts._time_step, N_STEPS)
    st_j, ref_rows = _run(js, jax.jit(js._time_step), N_STEPS)
    np.testing.assert_array_equal(rows, ref_rows)
    (u, p), (u_j, p_j) = ts.fields(st), js.fields(st_j)
    assert np.abs(u - u_j).max() <= tol * np.abs(u_j).max()
    assert np.abs(p - p_j).max() <= tol * np.abs(p_j).max()
