"""PyTorch port: the host tables of ``csrc/parity_apply.cu`` (TPU kernels
``cfd_with_cuda_tpu/ops/parity_stencil.py`` :406, :432 and ``kernel_s``
:456), on the K, G, K + A, MK + A and M routes of both parity solvers on
``cavity_deck(4)`` and on the non-cubic 5 x 3 x 4-element box, whose coarse
shifts differ by axis:

* the streamed kernel's warp schedule (``stream_schedule``) deals every
  (class, 32-q segment) item of a block to exactly one warp, longest first,
  and its slowest warp stays within one item of the mean;
* the aligned runs (``stream_runs``) start 16-byte aligned and cover every
  read of every route, each class's first table before its second, and the
  staged tiles of 3 CTAs fit an SM's shared memory at NE85184 and
  NE125000;
* an emulation of the streamed kernel in torch (stage each block's runs,
  sum each warp's items in the schedule's order from the staged tile, the
  plain version's rounding) equals ``parity_apply_plain`` bit for bit;
* on a card (marker ``cuda``; skipped without one) both kernels against
  the plain version, and against each other bit for bit, on those routes.

No JAX here: ``python -m pytest --noconftest tests/test_torch_parity_apply_layout.py``
also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import box_cavity_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import parity_stencil as tps
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

DECKS = {
    "cavity4": lambda: cavity_deck(4, viscosity=0.01, dt=0.001),
    "box534": lambda: box_cavity_deck(viscosity=0.01, dt=0.01),
}
FORMS = ("k", "g", "k_plus_a", "mk_plus_a", "m")
CASES = [(d, f) for d in DECKS for f in FORMS]
# a Hopper SM's shared memory (228 KB), 1 KB of it reserved per resident
# CTA; the streamed kernel runs 3 CTAs an SM (csrc/parity_apply.cu
# kStreamBlocks), each staging one tile
SMEM_PER_SM, SMEM_CTA_RESERVE, STREAM_CTAS = 233_472, 1024, 3
# kernel against plain version: the same terms in the same order, a shared
# weight's term one FMA in the kernel and a rounded product then an add in
# the plain version (chip_smoke.py APPLY_TOL), of the largest sum |w x|
APPLY_TOL = 1e-5


@pytest.fixture(scope="module")
def solvers():
    """Both parity solvers on each deck, on the CPU (set up lazily)."""
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32)
    built = {}

    def get(deck):
        if deck not in built:
            s = ExplicitBCHSolver(DECKS[deck](), cfg, device="cpu")
            i = ImplicitGQSolver(DECKS[deck](), cfg, device="cpu")
            assert s.layout == i.layout == "parity"
            built[deck] = (s, i)
        return built[deck]
    return get


def _form(s, i, form, seed):
    """(wc, x, pairs, wc2, pairs2) of one form on seeded fields and planes."""
    return {f[0]: f[1:] for f in tps.parity_forms(s, i, np.random.default_rng(seed))}[form]


def _tables(wc, x, pairs, wc2, pairs2):
    m2 = 0 if wc2 is None else wc2.shape[1]
    return tps.stream_runs(pairs, pairs2, wc.shape[1], m2, x.shape[1])


@pytest.mark.parametrize("deck,form", CASES)
def test_schedule_deals_every_item_once(solvers, deck, form):
    wc, x, pairs, wc2, pairs2 = _form(*solvers(deck), form, 1)
    heads = _tables(wc, x, pairs, wc2, pairs2)[0]
    segs = tps.STREAM_Q // (32 * tps.STREAM_THREAD_Q)
    offsets, items = tps.stream_schedule(heads)
    assert len(offsets) == tps.STREAM_WARPS + 1 and offsets[0] == 0
    assert offsets[-1] == len(items) and sorted(items) == list(range(8 * segs))
    cost = [heads[2 * p + 2] - heads[2 * p] for p in range(8)]
    assert cost == [len(pairs[p]) + (0 if pairs2 is None else len(pairs2[p])) for p in range(8)]
    loads = [sum(cost[it // segs] for it in items[offsets[w]:offsets[w + 1]])
             for w in range(tps.STREAM_WARPS)]
    # longest first: no warp ends more than one item above the mean
    assert max(loads) <= sum(loads) / len(loads) + max(cost)
    for w in range(tps.STREAM_WARPS):
        mine = [cost[it // segs] for it in items[offsets[w]:offsets[w + 1]]]
        assert mine == sorted(mine, reverse=True)


def test_schedule_balances_the_k_route(solvers):
    """K (class lengths 125, 75, 75, 45, 75, 45, 45, 27): the slowest warp of
    a CTA sums 147 entries of a block against a mean of 128 (one class a
    warp, as before the schedule: 125 against 64)."""
    s, _ = solvers("cavity4")
    heads = tps.stream_runs(s.k_pairs, None, int(s.d["Kp"].shape[1]), 0, 8)[0]
    offsets, items = tps.stream_schedule(heads)
    segs = tps.STREAM_Q // (32 * tps.STREAM_THREAD_Q)
    cost = [heads[2 * p + 2] - heads[2 * p] for p in range(8)]
    loads = [sum(cost[it // segs] for it in items[offsets[w]:offsets[w + 1]])
             for w in range(tps.STREAM_WARPS)]
    assert cost == [125, 75, 75, 45, 75, 45, 45, 27]
    assert sum(loads) == segs * 512 and sum(loads) / len(loads) == 128 and max(loads) == 147


def _stage(x, runs, chan, q0):
    """The staged tile of the block at q0 (NaN where nothing is copied)."""
    c, _, sp = x.shape
    tile = torch.full((c, chan), float("nan"))
    for pp, s, t, n in runs:
        g = torch.arange(q0 + s, q0 + s + n)
        ok = (g >= 0) & (g < sp)
        tile[:, t + torch.nonzero(ok).flatten()] = x[:, pp, g[ok]]
    return tile


@pytest.mark.parametrize("deck,form", CASES)
def test_aligned_runs_cover_every_read(solvers, deck, form):
    wc, x, pairs, wc2, pairs2 = _form(*solvers(deck), form, 2)
    heads, ents, runs, chan = _tables(wc, x, pairs, wc2, pairs2)
    h9, plain = tps._route_entries(pairs, pairs2, wc.shape[1],
                                   0 if wc2 is None else wc2.shape[1], x.shape[1])
    assert [(j, pp, dq) for j, pp, dq, _ in ents] == [(j, pp, dq) for _, j, pp, dq in plain]
    for p in range(8):          # each class: its first table, then its second
        assert heads[2 * p] == h9[p] and heads[2 * p + 2] == h9[p + 1]
        assert [e[0] for e in plain[h9[p]:h9[p + 1]]] == (
            [0] * (heads[2 * p + 1] - h9[p]) + [1] * (h9[p + 1] - heads[2 * p + 1]))
    assert all(s % 4 == 0 and t % 4 == 0 and n % 4 == 0 for _, s, t, n in runs)
    assert chan == sum(n for *_, n in runs)
    sp, i = x.shape[-1], torch.arange(tps.STREAM_Q)
    for q0 in range(0, sp, tps.STREAM_Q):
        tile = _stage(x, runs, chan, q0)
        for j, pp, dq, spos in ents:
            qs = q0 + i + dq
            ok = (qs >= 0) & (qs < sp)
            assert 0 <= spos and spos + tps.STREAM_Q <= chan
            assert torch.equal(tile[:, spos + i[ok]], x[:, pp, qs[ok]])


@pytest.mark.parametrize("n_elem", [44, 50])
def test_staged_tiles_fit_shared_memory(n_elem):
    """At NE85184 and NE125000 (the cavities whose velocity streams), the
    K + A route's tile (every shift of a radius-2 window and the 27 x 27
    convection planes of a Q2 element, 72 runs) fits an SM's shared memory
    once for each of the 3 CTAs an SM, and so does the pressure's."""
    local_off = tuple((ox, oy, oz) for oz in range(3) for oy in range(3) for ox in range(3))
    fine = (2 * n_elem + 1,) * 3
    cdims, sp = tps.parity_dims(fine)
    offs = tuple((dx, dy, dz) for dz in range(-2, 3) for dy in range(-2, 3) for dx in range(-2, 3))
    pairs = tps.parity_pairs(offs, cdims)
    _, _, pairs2 = tps.build_conv_plane_route(local_off, cdims)
    _, _, runs, chan = tps.stream_runs(pairs, pairs2, 125, 729, 8)
    assert len(runs) == 72
    assert STREAM_CTAS * (3 * chan * 4 + SMEM_CTA_RESERVE) <= SMEM_PER_SM
    g_pairs = tuple(tuple((j, 0, dq) for j, _, dq in cls) for cls in pairs)
    _, _, runs_g, chan_g = tps.stream_runs(g_pairs, None, 125, 0, 1)
    assert len(runs_g) == 9
    assert STREAM_CTAS * (chan_g * 4 + SMEM_CTA_RESERVE) <= SMEM_PER_SM


def _emulate_streamed(wc, x, pairs, wc2, pairs2, co=3):
    """The streamed kernel's sum in torch: per block, stage the runs, then
    each warp's items in the schedule's order, each item's 32 outputs summed
    over the class's entries (first table, then second) from the staged
    tile, skipping a term whose q + dq lies outside [0, Sp); the plain
    version's arithmetic (rounded product, then add)."""
    heads, ents, runs, chan = _tables(wc, x, pairs, wc2, pairs2)
    offsets, items = tps.stream_schedule(heads)
    seg_q = 32 * tps.STREAM_THREAD_Q
    segs, sp = tps.STREAM_Q // seg_q, x.shape[-1]
    y = torch.full((co, 8, sp), float("nan"))
    lane = torch.arange(seg_q)
    for q0 in range(0, sp, tps.STREAM_Q):
        tile = _stage(x, runs, chan, q0)
        for it in items:
            p, i = it // segs, (it % segs) * seg_q + lane
            q = q0 + i
            acc = torch.zeros(co, seg_q)
            for tab, w in ((0, wc), (1, wc2)):
                for j, _, dq, spos in ents[heads[2 * p + tab]:heads[2 * p + tab + 1]]:
                    ok = (q + dq >= 0) & (q + dq < sp)
                    term = w[:, j, q] * tile[:, spos + i]
                    acc = torch.where(ok, acc + term, acc)
            y[:, p, q] = acc
    return y


@pytest.mark.parametrize("deck,form", CASES)
def test_staged_sum_equals_plain_bit_for_bit(solvers, deck, form):
    wc, x, pairs, wc2, pairs2 = _form(*solvers(deck), form, 3)
    want = tps.parity_apply_plain(wc, x, pairs=pairs, co=3, wc2=wc2, pairs2=pairs2)
    got = _emulate_streamed(wc, x, pairs, wc2, pairs2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("deck", list(DECKS))
def test_kernels_match_plain_and_each_other(solvers, deck):
    """On the card: each form in both field forms against the plain version
    (APPLY_TOL of the largest sum |w x|) and the two forms bit for bit, each
    launch counted under its form's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU form")
    s, i = solvers(deck)
    names = dict(k="parity_apply_k", g="parity_apply_g", k_plus_a="parity_apply_k_plus_a",
                 mk_plus_a="parity_apply_k", m="parity_apply_k")
    for form in FORMS:
        wc, x, pairs, wc2, pairs2 = (None if t is None else t.cuda() if torch.is_tensor(t) else t
                                     for t in _form(s, i, form, 4))
        kw = dict(pairs=pairs, co=3, wc2=wc2, pairs2=pairs2)
        cuda_lib.reset_launch_counts()
        resident = tps.parity_apply(wc, x, stream_x=False, **kw)
        streamed = tps.parity_apply(wc, x, stream_x=True, **kw)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts[names[form]] == 1
        assert cuda_lib.launch_counts[names[form] + "_streamed"] == 1
        assert torch.equal(resident.view(torch.int32), streamed.view(torch.int32)), form
        plain = tps.parity_apply_plain(wc, x, **kw)
        scale = tps.parity_apply_plain(wc.abs(), x.abs(), pairs=pairs, co=3,
                                       wc2=None if wc2 is None else wc2.abs(), pairs2=pairs2)
        err = float((resident - plain).abs().max()) / float(scale.abs().max())
        assert err <= APPLY_TOL, (form, err)
