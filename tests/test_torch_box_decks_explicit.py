"""PyTorch port: the explicit BCH solver on the box decks users run, on the
parity and interleaved layouts, against the JAX solver.

The decks: ``channel_deck(6, 2, 2, lengths=(3, 1, 1),
inlet_profile="duct_developed")`` (a non-cubic box with an outflow face),
the bend's small size ``bending_duct_deck(12, 6, 6, dt=0.005)`` (curved
coordinates on a box topology) and ``box_cavity_deck()`` (5 x 3 x 4
elements, coarse shifts that differ by axis).  The JAX solver runs its
kernel path (``pressure_backend="pallas"``, Pallas in interpret mode) on
its own generator's deck (the box cavity: the port's deck's fields, as the
JAX package has no such generator); the port runs the plain PyTorch
versions of its kernels (CPU tensors) on its own setup.

Over 3 steps of rung 1 (F32, CG tol 1e-6, warm start, fused CG loop) the
bounds are ``tests/test_parity_stencil.py:285-290``'s: u 5e-6, p 5e-5, the
u, v, w and p monitors 5e-6, equal sub-iteration counts; ``max_acc``, a rate
of order max|u| / dt (2,250 on the channel's first step), to 5e-6 of itself.

The CG counts of a step are held within one group of 4 iterations
(``chip_smoke.py``'s bound between the kernel and plain paths), not one:
the right-hand sides of the two packages differ by ~2e-5 of max|b| (the
divergence of u* cancels), and a warm-started solve stops near that level.
On the box cavity's first step the third solve took 3 iterations in JAX and
5 in the port, while the port's CG on JAX's own (b, x0) takes 3.  What
holds the CG itself is ``test_pressure_solves_match_jax_on_the_same_inputs``:
the JAX fused CG, given the port's right-hand side and warm start of every
solve of a step, takes the port's count.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd_with_cuda_tpu.io.deck import Deck as JaxDeck
from cfd_with_cuda_tpu.mesh import generators as jax_gen
from cfd_with_cuda_tpu.ops.pallas_cg import fused_cg as jax_fused_cg
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.mesh import generators as port_gen
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

pytestmark = pytest.mark.pallas  # the JAX side runs Pallas in interpret mode

torch.set_num_threads(1)

RUNG1 = dict(pressure_cg_tol=1e-6, pressure_cg_fuse_loop=True, pressure_warm_start=True,
             steps_per_chunk=1)
N_STEPS = 3
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters")
U_TOL, P_TOL, MON_TOL, CG_TOL = 5e-6, 5e-5, 5e-6, 4

# deck name -> (generator, args, kwargs), the same in both packages
DECKS = {
    "channel": ("channel_deck", (6, 2, 2),
                dict(lengths=(3.0, 1.0, 1.0), inlet_profile="duct_developed")),
    "bend": ("bending_duct_deck", (12, 6, 6), dict(dt=0.005)),
    "box": ("box_cavity_deck", (), {}),
}
CASES = [(d, lay) for d in DECKS for lay in ("parity", "interleaved")]


def _decks(name):
    """(port deck, JAX deck) of one name."""
    gen, args, kw = DECKS[name]
    port = getattr(port_gen, gen)(*args, **kw)
    if hasattr(jax_gen, gen):
        return port, getattr(jax_gen, gen)(*args, **kw)
    return port, JaxDeck(**{f.name: getattr(port, f.name) for f in dataclasses.fields(port)})


@pytest.fixture(scope="module", params=CASES, ids=[f"{d}-{lay}" for d, lay in CASES])
def case(request):
    """One deck on one layout: the JAX solver's 3 steps (jitted step: the JAX
    chunk's steady-flag lax.cond rejects the fused CG's int32 count under
    jax x64) and the port's."""
    name, layout = request.param
    port_deck, jax_deck = _decks(name)
    js = JaxSolver(jax_deck, JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                                       setup_cache="off", structured_layout=layout, **RUNG1))
    step = jax.jit(js._time_step)
    st = js.initial_state()
    rows = []
    for _ in range(N_STEPS):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    ts = ExplicitBCHSolver(port_deck, SolverConfig(dtype_policy=DTypePolicy.F32,
                                                   structured_layout=layout, **RUNG1),
                           device="cpu")
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(ts.initial_state(), n_steps=N_STEPS)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    got = np.asarray([[h[f] for f in STAT_FIELDS] for h in hist])
    return dict(layout=layout, js=js, ref_rows=np.asarray(rows), ref_state=st, ts=ts,
                rows=got, state=state)


def test_layout_follows_the_jax_rule(case):
    js, ts = case["js"], case["ts"]
    assert js.layout == ts.layout == case["layout"]
    assert js.structured and js.elem_structured
    assert (ts.nn, ts.nnp) == (js.nn, js.nnp)
    np.testing.assert_array_equal(ts.perm, js.perm)
    np.testing.assert_array_equal(ts.perm_p, js.perm_p)


def test_steps_match_jax(case):
    ref_rows, rows = case["ref_rows"], case["rows"]
    assert rows.shape == ref_rows.shape == (N_STEPS, len(STAT_FIELDS))
    np.testing.assert_array_equal(rows[:, 5], ref_rows[:, 5])          # sub-iterations
    assert np.abs(rows[:, 6] - ref_rows[:, 6]).max() <= CG_TOL           # CG iterations
    np.testing.assert_allclose(rows[:, :4], ref_rows[:, :4], rtol=0, atol=MON_TOL)
    np.testing.assert_allclose(rows[:, 4], ref_rows[:, 4], rtol=MON_TOL, atol=0)
    u_j, p_j = case["js"].fields(case["ref_state"])
    u_t, p_t = case["ts"].fields(case["state"])
    assert np.isfinite(u_t).all() and np.isfinite(p_t).all()
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_TOL)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=P_TOL)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_pressure_solves_match_jax_on_the_same_inputs(case_solves, name):
    """Every pressure solve of the port's first step (parity layout), given
    to the JAX fused CG (interpret mode) as it was given to the port's: the
    same count, x within 1e-5 of max|x| (two f32 CGs whose dots sum in
    other orders)."""
    js, calls = case_solves(name)
    assert len(calls) >= 2
    win = js.d["Z_win_cg"]
    for b, x0, x, iters in calls:
        r = jax_fused_cg(win, jnp.asarray(b), js.d["Z_dinv_cg"], dims=js.coarse_dims,
                         radius=js.z_radius, tol=RUNG1["pressure_cg_tol"], maxiter=1000,
                         x0=None if x0 is None else jnp.asarray(x0), fuse_loop=True)
        assert int(r.iters) == iters
        x_j = np.asarray(r.x)[: x.size]
        assert np.abs(x - x_j).max() <= 1e-5 * np.abs(x_j).max()


@pytest.fixture(scope="module")
def case_solves():
    """name -> (JAX parity solver, the port's pressure solves of one step as
    (b, x0, x, iters) numpy arrays)."""
    from cfd_with_cuda_tpu_torch.solvers import explicit_bch

    def solves(name):
        port_deck, jax_deck = _decks(name)
        js = JaxSolver(jax_deck, JaxConfig(dtype_policy=JaxPolicy.F32,
                                           pressure_backend="pallas", setup_cache="off",
                                           structured_layout="parity", **RUNG1))
        calls = []
        cg = explicit_bch.fused_cg

        def recorded(win, b, dinv, **kw):
            r = cg(win, b, dinv, **kw)
            x0 = kw.get("x0")
            calls.append((b.numpy().copy(), None if x0 is None else x0.numpy().copy(),
                          r.x.numpy().copy(), int(r.iters)))
            return r

        ts = ExplicitBCHSolver(port_deck, SolverConfig(dtype_policy=DTypePolicy.F32,
                                                       structured_layout="parity", **RUNG1),
                               device="cpu")
        explicit_bch.fused_cg = recorded
        try:
            ts.run(n_steps=1)
        finally:
            explicit_bch.fused_cg = cg
        return js, calls

    return solves
