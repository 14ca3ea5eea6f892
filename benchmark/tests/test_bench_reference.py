"""The frozen reference against the port's plain path on the CPU.

The port runs in float64 with the Jacobi pressure CG (``pressure_precond=
"jacobi"``), the same algorithm as the reference's, so the two differ only
by the order of their sums.  At the cell's CG tolerance 1e-6 the fields
agree to 1e-10 of their max norm (a float64 CG amplifies the summation-order
differences of its operator by its iteration count, some 1e-13 each) and
every iteration count is equal, from rest and from a state whose previous
sub-iterate and pressure increment are set, as a developed start's are.
The box decks take the port's structured XLA path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import decks
from benchmark.reference.explicit import ExplicitReference

torch.set_num_threads(2)
OPTS = dict(pressure_cg_tol=1e-6, pressure_cg_maxiter=1000, pressure_pin_large=1000.0,
            pressure_cg_every=1)


def _port(bdeck, warm: bool):
    from cfd_with_cuda_tpu_torch.io.deck import Deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    cfg = SolverConfig(dtype_policy=DTypePolicy.F64, pressure_cg_tol=1e-6,
                       pressure_precond="jacobi", pressure_warm_start=warm)
    return ExplicitBCHSolver(Deck(dialect="fractional", **bdeck.as_kwargs()), cfg, device="cpu")


def _start(ref, seed, full: bool):
    """(u, p, u_prev, pdot): the boundary velocities with noise off the
    walls, and (``full``) a previous sub-iterate and a pressure increment."""
    rng = np.random.default_rng(seed)
    u0 = ref.bc_vel.cpu().numpy().astype(np.float64).copy()
    free = ~ref.is_bc.cpu().numpy()
    u0[free] += 0.01 * rng.standard_normal((int(free.sum()), 3))
    u_prev, pdot = np.zeros_like(u0), np.zeros(ref.nnp)
    if full:
        u_prev = u0.copy()
        u_prev[free] += 1e-3 * rng.standard_normal((int(free.sum()), 3))
        pdot = rng.standard_normal(ref.nnp)
    return u0, 0.01 * rng.standard_normal(ref.nnp) if full else np.zeros(ref.nnp), u_prev, pdot


@pytest.mark.parametrize("warm,full", [(True, False), (True, True), (False, True)],
                         ids=["warm-rest", "warm-full", "cold-full"])
def test_reference_matches_port(warm, full):
    from benchmark.harness import _program_state

    bdeck = decks.cavity(4, cluster=2.0, dt=5e-4)
    ref = ExplicitReference(bdeck, dict(OPTS, pressure_warm_start=warm), "cpu")
    port = _port(bdeck, warm)
    start = _start(ref, 7, full)
    state, hist = port.run(_program_state(port, start), n_steps=3)
    rs = ref.state(*start)
    for row in hist:
        rs, out = ref.step(rs)
        assert out.iters == row["iters"]
        assert out.cg_iters[-1] == row["cg_iters"]
        assert abs(out.max_acc - row["max_acc"]) <= 1e-10 * out.max_acc
    u, p = port.fields(state)
    ur, pr = ref.fields(rs)
    assert np.abs(u - ur).max() <= 1e-10 * np.abs(ur).max()
    assert np.abs(p - pr).max() <= 1e-10 * np.abs(pr).max()


def test_node_order_and_boundary_match_port():
    """The reference's promoted mesh and BC nodes are the port's, node for
    node (the order the port returns its fields in)."""
    from cfd_with_cuda_tpu_torch.mesh.topology import face_bc_to_node_bc, promote_hex_mesh

    from benchmark.reference.mesh import boundary_velocity, node_bcs, promote

    bdeck = decks.cavity(5, cluster=2.0)
    ltog, xyz = promote(bdeck.conn, bdeck.coords)
    mesh = promote_hex_mesh(bdeck.conn, bdeck.coords)
    assert np.array_equal(ltog, mesh.ltog_node) and np.array_equal(xyz, mesh.coords)
    bc = node_bcs(ltog, bdeck.bc_vel_faces, xyz.shape[0])
    assert np.array_equal(bc, face_bc_to_node_bc(mesh.ltog_node, bdeck.bc_vel_faces, mesh.nn))
    vel = np.zeros((mesh.nn, 3))
    vel[bc >= 0] = bdeck.bc_str[bc[bc >= 0]]
    assert np.array_equal(boundary_velocity(bdeck, xyz, bc), vel)


def test_decks_match_port_generators():
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck

    mine, port = decks.cavity(5, cluster=2.0, dt=5e-4), cavity_deck(5, cluster=2.0, dt=5e-4)
    for k, v in mine.as_kwargs().items():
        assert np.array_equal(np.asarray(v), np.asarray(getattr(port, k))), k
