"""The metric arithmetic: busy and idle shares, the structural nonzeros the
rooflines count against scipy counts of the reference's own assembled
operators (Z = G^T Md^-1 G and K exactly), the roofline bytes against a hand
count, each step's last pressure solve paired with its reported count, and
the seed's perturbation (divergence-free, zero on the walls)."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import decks, yardstick
from benchmark.harness import MetricContext, metric_reader
from benchmark.reference.fem import Elements
from benchmark.reference.mesh import promote
from benchmark.trace import Span, TraceData, busy_share


def test_busy_share_unions_overlaps():
    assert busy_share([(0, 10), (5, 15), (20, 30)], 40) == pytest.approx(25 / 40)
    assert busy_share([(0, 10), (2, 3)], 20) == pytest.approx(0.5)
    assert busy_share([], 10) is None


def _ctx(device, rows=(), counts=None):
    return MetricContext(trace=TraceData(device, [], 1000.0), rows=list(rows),
                         steps=max(len(rows), 1),
                         kernels={"cg_solve_kernel": "cg_solve", "cg_iter_kernel": "cg_iter",
                                  "cg_init_kernel": "cg_iter",
                                  "parity_apply_kernel": "parity_apply"},
                         word=4, host_setup_s=1.5, _counts=lambda: counts)


def test_device_idle_pct():
    spans = [Span("a", 0, 100), Span("b", 50, 250), Span("c", 500, 600)]
    assert metric_reader("device_idle_pct")(_ctx(spans)) == pytest.approx(100 * (1 - 0.35))
    assert metric_reader("device_idle_pct")(_ctx([])) is None


def _scipy(vals, rows, cols, shape):
    a, b = vals.shape[1], vals.shape[2]
    r = np.repeat(rows[:, :, None], b, 2).reshape(-1)
    c = np.repeat(cols[:, None, :], a, 1).reshape(-1)
    m = sp.coo_matrix((vals.reshape(-1), (r, c)), shape=shape).tocsr()
    m.sum_duplicates()
    return m


def test_structural_counts_match_assembled():
    bd = decks.cavity(3, cluster=2.0)
    ltog, xyz = promote(bd.conn, bd.coords)
    nn, nnp = xyz.shape[0], bd.nnp
    el = Elements(ltog, xyz, bd.ngp, nn, nnp, "cpu")
    md = el.lumped(el.mass()).numpy()
    ge = el.gradient(1.0).numpy()
    g = [_scipy(ge[d], ltog, ltog[:, :8], (nn, nnp)) for d in range(3)]
    z = sum(gd.T @ sp.diags(1 / md) @ gd for gd in g).tocsr()
    k = _scipy(el.stiffness(0.01).numpy(), ltog, ltog, (nn, nn))
    nz = lambda m: int(np.count_nonzero(m.data))
    c = yardstick.operator_counts(ltog, nn, bd.conn, nnp)
    assert c.nnz_z == nz(z) == yardstick.pressure_nnz(bd.conn, nnp)
    assert c.nnz_k == nz(k)
    # G's structure holds a few entries that vanish by symmetry in an
    # element (under 1 %); the roofline counts them
    assert max(nz(gd) for gd in g) <= c.nnz_g <= 1.01 * max(nz(gd) for gd in g)


def test_roofline_bytes_by_hand():
    # one element: 27 velocity and 8 pressure nodes, every pair coupled
    c = yardstick.operator_counts(promote(decks.cavity(1).conn, decks.cavity(1).coords)[0], 27,
                                  decks.cavity(1).conn, 8)
    assert c == yardstick.OperatorCounts(27, 8, 729, 216, 64)
    assert yardstick.cg_iteration_bytes(c, 4) == 4 * (64 + 7 * 8)
    vel, grad = 729 + 6 * 27, 3 * 216 + 8 + 3 * 27
    assert yardstick.stencil_step_bytes(c, 4, 2) == 4 * (grad + 2 * (vel + 2 * grad) + vel)
    assert yardstick.stencil_step_bytes(c, 4, 1) == 4 * (grad + vel + 2 * grad)


CG = "void (anonymous namespace)::cg_solve_kernel<false, false, 1>(cgk::CgArgs)"


def test_roofline_readers():
    c = yardstick.OperatorCounts(27, 8, 729, 216, 64)
    # two steps of two sub-iterations: four fused solves, the second and the
    # fourth the steps' last, reporting 10 and 12 iterations
    rows = [{"iters": 2, "cg_iters": 10}, {"iters": 2, "cg_iters": 12}]
    spans = [Span(CG, 0, 900), Span(CG, 1000, 1500), Span(CG, 2000, 2900), Span(CG, 3000, 3600),
             Span("void parity_apply_kernel<1>(float const*)", 4000, 4500),
             Span("void at::native::elementwise_kernel<128>(int)", 4500, 4600)]
    ctx = _ctx(spans, rows, counts=c)
    need = 22 * yardstick.cg_iteration_bytes(c, 4) / yardstick.PEAKS["hbm_bytes_per_s"]
    assert metric_reader("pressure_cg.roofline_pct")(ctx) == pytest.approx(100 * need / 1.1e-3)
    assert metric_reader("pressure_cg.device_ms_per_step")(ctx) == pytest.approx(1.45)
    need = sum(yardstick.stencil_step_bytes(c, 4, 2) for _ in rows) / 3.35e12
    assert metric_reader("stencil.roofline_pct")(ctx) == pytest.approx(100 * need / 0.5e-3)
    assert metric_reader("torch_ops.device_ms_per_step")(ctx) == pytest.approx(0.05)
    assert metric_reader("cg_iters_last_solve")(ctx) == 11
    assert metric_reader("sub_iters_per_step")(ctx) == 2
    assert metric_reader("host_setup_s")(ctx) == 1.5
    assert metric_reader("pressure_cg.roofline_pct")(_ctx(spans[4:], rows, counts=c)) is None
    # a solve missing from the trace: no pairing, no share
    assert metric_reader("pressure_cg.roofline_pct")(_ctx(spans[1:], rows, counts=c)) is None


def test_last_solves_of_the_cg_loop():
    """On the loop path a solve is a cg_init launch and the cg_iter launches
    that follow it."""
    init = "void (anonymous namespace)::cg_init_kernel<false, false, 1>(cgk::CgArgs)"
    it = "void (anonymous namespace)::cg_iter_kernel<false, false, 1>(cgk::CgArgs)"
    spans = [Span(init, 0, 10), Span(it, 10, 50), Span(it, 60, 100),
             Span(init, 200, 210), Span(it, 210, 240)]
    ctx = _ctx(spans, [{"iters": 2, "cg_iters": 4}])
    assert ctx.last_solves(("cg_solve_kernel", "cg_init_kernel"), ("cg_iter",)) == [
        (4, pytest.approx(0.04))]


def test_perturbation_is_divergence_free_and_zero_on_walls():
    import torch

    from benchmark import traffic
    from benchmark.reference.explicit import ExplicitReference

    bd = decks.cavity(6, cluster=2.0)
    ref = ExplicitReference(bd, dict(pressure_cg_tol=1e-6, pressure_cg_maxiter=100,
                                     pressure_warm_start=True, pressure_pin_large=1e3,
                                     pressure_cg_every=1), "cpu")
    ltog, xyz = promote(bd.conn, bd.coords)
    is_bc = ref.is_bc.numpy()
    spec = {"amplitude": 1e-3, "speed": 1.0, "modes": 4, "max_wavenumber": 2}
    f = traffic.perturbation(xyz, is_bc, 123, spec)
    assert np.abs(f).max() == pytest.approx(1e-3) and not f[is_bc].any()
    assert np.array_equal(f, traffic.perturbation(xyz, is_bc, 123, spec))
    assert not np.array_equal(f, traffic.perturbation(xyz, is_bc, 124, spec))
    # the discrete divergence G^T f against that of a smooth field of the
    # same peak that is not divergence-free (on this coarse mesh; the cell's
    # 44^3 resolves its wavenumbers far better)
    s = np.prod(np.sin(np.pi * xyz), axis=1)
    g = np.where(is_bc[:, None], 0.0, np.stack([s, -s, s], axis=1))
    g *= 1e-3 / np.abs(g).max()
    div = lambda v: float(torch.linalg.vector_norm(ref.div(torch.as_tensor(v))))
    assert div(f) < 0.03 * div(g)
