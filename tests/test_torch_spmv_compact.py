"""PyTorch port: the window SPMV on a class-compacted, class-major table
(``compact_spmv_window``, ``window_spmv_compact``; the compact SPMV kernel of
``csrc/window_stencil.cu``, TPU kernel ``cfd_with_cuda_tpu/ops/
pallas_stencil.py`` ``_stencil_call`` in its SPMV mode).

The interleaved solvers' K, K + A, MK + A and M are Q2 operators: a row of
parity class c couples to shifts -2..2 on an axis where its fine coordinate
is even and -1..1 where it is odd, so it keeps 125, 75, 45 or 27 of the 125
window slots; the padding rows keep offset 0 alone.  On the interleaved
tables of both port solvers, on ``cavity_deck(4)`` and on the non-cubic
5 x 3 x 4-element box ``box_cavity_deck()``, whose class blocks differ in
size on every axis:

* the class slot tables on K's and A's own offsets (counts 125 / 75 / 45 /
  27 and the padding's 1, the operator's order kept);
* a weight planted on a dropped slot raises ``ValueError``;
* ``window_spmv_compact_plain`` equals ``window_spmv_plain`` on the full
  table bit for bit (a dropped term adds an exact zero) for K, K + A, the
  masked MK + A with its unit diagonal and padding rows, and M, in f32 and
  f64, padded and unpadded fields;
* the per-step assembly straight into the compact table equals the
  compaction of ``assemble_window_values``, bit for bit, and the solvers'
  compact tables (with the LHS's row mask and diagonal entries) are the
  compaction of their full ones;
* ``spmv_window_from_compact`` is the exact inverse;
* on a card (marker ``cuda``; skipped without one) the kernel against the
  plain version and against the full-window kernel bit for bit, up to the
  sign of an exact zero.

No JAX here: ``python -m pytest --noconftest tests/test_torch_spmv_compact.py``
also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import box_cavity_deck, cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import stencil as tst
from cfd_with_cuda_tpu_torch.ops import window_stencil as tws
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

DECKS = {
    "cavity4": lambda: cavity_deck(4, viscosity=0.01, dt=0.001),
    "box534": lambda: box_cavity_deck(viscosity=0.01, dt=0.01),
}
FORMS = ("k", "k_plus_a", "mk_plus_a", "m")
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# the kernel against its plain version (chip_smoke.py WINDOW_TOL /
# WINDOW_TOL_F64): the same <= 125 terms in the same order, the kernel's FMA
# against torch's rounded product, of the largest sum |w x|
TOLS = {torch.float32: 1e-6, torch.float64: 1e-12}
COUNTS = [125, 75, 75, 45, 75, 45, 45, 27, 1]     # classes 0..7 (x, y, z odd bits), padding


@pytest.fixture(scope="module")
def solvers():
    """Both interleaved solvers on each deck, on the CPU (set up lazily)."""
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, structured_layout="interleaved")
    built = {}

    def get(deck):
        if deck not in built:
            s = ExplicitBCHSolver(DECKS[deck](), cfg, device="cpu")
            i = ImplicitGQSolver(DECKS[deck](), cfg, device="cpu")
            assert s.layout == i.layout == "interleaved" and s.elem_structured
            built[deck] = (s, i)
        return built[deck]
    return get


def _forms(solvers, deck, seed=0):
    s, i = solvers(deck)
    return s, {f[0]: f[1:] for f in tws.spmv_forms(s, i, np.random.default_rng(seed))}


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("operator", ["k", "a"])
def test_class_slot_tables(solvers, deck, operator):
    """Counts by class, each slot's shift inside its class's bounds, every
    shift inside them kept, the operator's own order, the padding's offset 0."""
    s, i = solvers(deck)
    offsets = s.k_offsets if operator == "k" else i.a_offsets
    slots, offs, counts = tws.compact_spmv_slots(offsets, s.fine_dims)
    assert counts.tolist() == COUNTS
    fx, fy, _ = s.fine_dims
    for c in range(8):
        ks = slots[c, : counts[c]].tolist()
        assert ks == sorted(ks)                      # the tuple's order
        assert offs[c, : counts[c]].tolist() == [offsets[k] for k in ks]
        lim = [1 if c >> a & 1 else 2 for a in range(3)]
        live = {(dz * fy + dy) * fx + dx for dz in range(-lim[2], lim[2] + 1)
                for dy in range(-lim[1], lim[1] + 1) for dx in range(-lim[0], lim[0] + 1)}
        assert {offsets[k] for k in ks} == live
    assert offs[8, 0] == 0 and offsets[slots[8, 0]] == 0


@pytest.mark.parametrize("deck", list(DECKS))
def test_dropped_nonzero_weight_raises(solvers, deck):
    s, _ = solvers(deck)
    win = s.d["K_vals"].clone()
    slots, _, counts = tws.compact_spmv_slots(s.k_offsets, s.fine_dims)
    dropped = sorted(set(range(len(s.k_offsets))) - set(slots[7, : counts[7]].tolist()))
    fx, fy, _ = s.fine_dims
    row = (fy + 1) * fx + 1                          # (1, 1, 1): class 7
    win[dropped[0], row] = 1.0
    with pytest.raises(ValueError, match="outside their row's parity-class slots"):
        tws.compact_spmv_window(win, s.k_offsets, s.fine_dims)
    win = s.d["K_vals"].clone()
    off_diag = next(k for k, o in enumerate(s.k_offsets) if o != 0)
    win[off_diag, s.nn] = 1.0                        # a padding row off its diagonal
    with pytest.raises(ValueError, match="outside their row's parity-class slots"):
        tws.compact_spmv_window(win, s.k_offsets, s.fine_dims)


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_compact_plain_equals_full_plain(solvers, deck, form, dtype):
    """Bit for bit, on the padded field (every block, the padding rows
    included) and on the unpadded one, trimmed and not."""
    s, forms = _forms(solvers, deck, 1)
    full, comp, offs, x = forms[form]
    dt = DTYPES[dtype]
    full, comp, x = full.to(dt), comp.to(dt), x.to(dt)
    for xx, trim in ((x, False), (x, True), (x[:, : s.nn], True), (x[:, : s.nn], False),
                     (x[0], False)):
        want = tws.window_spmv_plain(full, xx, s.fine_dims, offsets=offs, trim=trim)
        got = tws.window_spmv_compact_plain(comp, xx, s.fine_dims, offsets=offs, trim=trim)
        assert got.shape == want.shape and got.dtype == dt
        assert torch.equal(got, want), (form, tuple(xx.shape), trim)


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("solver", ["explicit", "implicit"])
def test_compact_assembly_equals_compacted_assembly(solvers, deck, solver):
    """assemble_compact_values == compact_spmv_window(assemble_window_values)
    bit for bit, on the solver's own convection of a seeded velocity."""
    s = dict(zip(("explicit", "implicit"), solvers(deck)))[solver]
    offs = s.k_offsets if solver == "explicit" else s.a_offsets
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((3, s.nn)).astype(np.float32))
    ae = tst.convection_elem_matrices(u, s.d["Sv"], s.d["gDSv"], s.d["gq"], s.elem_dims,
                                      s.fine_dims, stab_coef=0.1)
    full = tst.assemble_window_values(ae, s.local_off, s.conv_oij, len(offs), s.elem_dims,
                                      s.fine_dims, s.s_pad)
    coij = tws.compact_spmv_oij(s.conv_oij, s.local_off, offs, s.fine_dims)
    got = tst.assemble_compact_values(ae, s.local_off, coij, offs, s.elem_dims, s.fine_dims,
                                      s.s_pad)
    want = tws.compact_spmv_window(full, offs, s.fine_dims)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("deck", list(DECKS))
def test_solver_tables_are_the_compaction_of_the_full_ones(solvers, deck):
    s, i = solvers(deck)
    fine = s.fine_dims
    assert torch.equal(s.d["K_cvals"], tws.compact_spmv_window(s.d["K_vals"], s.k_offsets, fine))
    for full, comp in (("MK_vals", "MK_cvals"), ("M_vals", "M_cvals")):
        assert torch.equal(i.d[comp], tws.compact_spmv_window(i.d[full], i.a_offsets, fine))
    mask = tws.spmv_window_from_compact(i.d["row_mask_c"], i.a_offsets, fine, i.s_pad)
    live = tws.spmv_window_from_compact(torch.ones_like(i.d["row_mask_c"]), i.a_offsets, fine,
                                        i.s_pad) != 0
    assert torch.equal(mask[live], i.d["row_mask_grid"][None].expand_as(mask)[live])
    pos = i.d["diag_pos"]
    assert pos.shape == (i.s_pad,) and len(set(pos.tolist())) == i.s_pad
    assert torch.equal(i.d["MK_cvals"][pos], i.d["MK_vals"][i.a_zero_off])
    assert (i.d["MK_cvals"][pos[i.nn:]] == 0).all()


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("form", FORMS)
def test_from_compact_is_the_exact_inverse(solvers, deck, form):
    s, forms = _forms(solvers, deck, 2)
    full, comp, offs, _ = forms[form]
    back = tws.spmv_window_from_compact(comp, offs, s.fine_dims, s.s_pad)
    assert torch.equal(back.view(torch.int32), full.view(torch.int32))
    assert torch.equal(tws.compact_spmv_window(back, offs, s.fine_dims), comp)
    back_np = tws.spmv_window_from_compact(comp.numpy(), offs, s.fine_dims, s.s_pad)
    assert isinstance(back_np, np.ndarray) and np.array_equal(back_np, full.numpy())


@pytest.mark.parametrize("deck", list(DECKS))
def test_compact_layout_sizes(solvers, deck):
    """The class blocks' rows and entries: (sum over classes of count x
    rows) = prod over axes of (5 x even nodes + 3 x odd nodes), then the
    padding rows, one entry each."""
    s, _ = solvers(deck)
    lay = tws.spmv_layout(s.k_offsets, s.fine_dims, s.s_pad)
    per_axis = [5 * ((f + 1) // 2) + 3 * (f // 2) for f in s.fine_dims]
    assert lay.size == int(np.prod(per_axis)) + (s.s_pad - s.nn)
    assert sorted(np.concatenate(lay.order).tolist()) == list(range(s.s_pad))
    assert lay.bases.tolist() == np.concatenate([[0], np.cumsum(lay.rows * lay.counts)[:-1]]).tolist()


def test_wrapper_refuses_a_table_of_another_layout(solvers):
    s, _ = solvers("cavity4")
    x = torch.zeros(3, s.s_pad)
    with pytest.raises(ValueError, match="fits no layout"):
        tws.window_spmv_compact(s.d["K_cvals"][:100], x, s.fine_dims, offsets=s.k_offsets)
    with pytest.raises(ValueError, match="no launch count"):
        tws.window_spmv_compact(s.d["K_cvals"], x, s.fine_dims, offsets=s.k_offsets,
                                name="window_spmv_nope")


@pytest.mark.cuda
@pytest.mark.parametrize("deck", list(DECKS))
def test_kernel_matches_plain_and_full_window_kernel(solvers, deck):
    """On the card: each form, f32 and f64, against the plain version (TOLS of
    the largest sum |w x|) and the full-window kernel bit for bit up to the
    sign of an exact zero, each launch counted under its operator's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU form")
    s, forms = _forms(solvers, deck, 3)
    names = dict(k="window_spmv_k", k_plus_a="window_spmv_k_plus_a",
                 mk_plus_a="window_spmv_mk_plus_a", m="window_spmv_m")
    for form in FORMS:
        for dt in DTYPES.values():
            full, comp, offs, x = (t.to("cuda", dt) if torch.is_tensor(t) else t
                                   for t in forms[form])
            for xx in (x, x[:1], x[:, : s.nn]):
                kw = dict(offsets=offs, trim=False, name=names[form])
                cuda_lib.reset_launch_counts()
                got = tws.window_spmv_compact(comp, xx, s.fine_dims, **kw)
                torch.cuda.synchronize()
                assert cuda_lib.launch_counts[names[form]] == 1
                want = tws.window_spmv(full, xx, s.fine_dims, **kw)
                assert torch.equal(got, want), (form, dt, tuple(xx.shape))
                plain = tws.window_spmv_compact_plain(comp, xx, s.fine_dims, **kw)
                scale = tws.window_spmv_plain(full.abs(), xx.abs(), s.fine_dims, **kw)
                err = float((got - plain).abs().max()) / float(scale.abs().max())
                assert err <= TOLS[dt], (form, dt, err)
