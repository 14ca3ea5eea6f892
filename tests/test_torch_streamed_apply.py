"""PyTorch port: the streamed-field form of ``parity_apply`` (TPU kernel
``kernel_s``, ``cfd_with_cuda_tpu/ops/parity_stencil.py:456``).

* The port's ``stream_x=None`` decision equals the JAX package's, read from
  the form its ``parity_apply`` traces to (the streamed ``pallas_call`` has
  two scratch operands, the resident one none), on the K, K + A, MK + A, M
  and G shapes and routes of the NE27000, 39^3, NE85184 and NE125000
  cavities; nothing is built at those sizes but the routes.
* ``stream_x=True`` on CPU tensors (the plain version) equals the JAX
  streamed kernel in interpret mode on ``cavity_deck(4)``'s tables.
* The host half of the streamed kernel (its run table and staged
  positions) reproduces every read of the route, emulated in numpy.
* On a card (marker ``cuda``; skipped without one) the streamed kernel
  equals the resident kernel bit for bit.  It imports no JAX, so it also
  runs where JAX is not installed:
  ``python -m pytest --noconftest -m cuda tests/test_torch_streamed_apply.py``.
"""

import functools

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import parity_stencil as tps

torch.set_num_threads(1)

# f32 tolerance against the JAX kernel, as tests/test_torch_ops.py: the same
# terms in the same order, up to one rounding per term (FMA or not)
APPLY_REL = 2e-6
# the staged block of csrc/parity_apply.cu must fit a Hopper SM's shared
# memory (228 KB, 1 KB of it reserved per resident CTA) once for each of
# the 3 CTAs an SM that the streamed kernel runs (kStreamBlocks)
SMEM_PER_SM, SMEM_CTA_RESERVE, STREAM_CTAS = 233_472, 1024, 3


@pytest.fixture(scope="module")
def jax_side():
    """(JAX parity_stencil module, the JAX parity solver on cavity_deck(4))."""
    import jax  # noqa: F401  (on the CPU with x64: tests/conftest.py)
    from cfd_with_cuda_tpu.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu.ops import parity_stencil as jps
    from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu.utils.config import DTypePolicy, SolverConfig

    s = ExplicitBCHSolver(
        cavity_deck(4, viscosity=0.01, dt=0.001),
        SolverConfig(dtype_policy=DTypePolicy.F32, pressure_backend="pallas",
                     structured_layout="parity", setup_cache="off"),
    )
    assert s.layout == "parity"
    return jps, s


@functools.lru_cache(maxsize=None)
def _jax_streams(jps, wc_shape, x_shape, pairs, co, pairs2=None, wc2_shape=None) -> bool:
    """Which form the JAX package's parity_apply takes with stream_x=None,
    from its traced pallas_call (no array of these shapes is made; K, MK + A
    and M share their shapes and route, so one trace answers for the three)."""
    import jax
    import jax.numpy as jnp

    args = [jax.ShapeDtypeStruct(wc_shape, jnp.float32), jax.ShapeDtypeStruct(x_shape, jnp.float32)]
    if pairs2 is None:
        fn = lambda w, x: jps.parity_apply(w, x, pairs=pairs, co=co)
    else:
        args.append(jax.ShapeDtypeStruct(wc2_shape, jnp.float32))
        fn = lambda w, x, w2: jps.parity_apply(w, x, pairs=pairs, co=co, wc2=w2, pairs2=pairs2)

    def calls(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                yield eqn
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    yield from calls(getattr(sub, "jaxpr", sub))

    (eqn,) = calls(jax.make_jaxpr(fn)(*args).jaxpr)
    return eqn.params["grid_mapping"].num_scratch_operands == 2


def _window_route(mod, n_elem, radius):
    """The full radius-``radius`` window route of the (2n+1)^3 cavity (a
    superset of the compacted K / MK + A / M / G routes with the same
    shifts) in package ``mod``, and the coarse dims and Sp."""
    fine = (2 * n_elem + 1,) * 3
    cdims, sp = mod.parity_dims(fine)
    offs = tuple((dx, dy, dz) for dz in range(-radius, radius + 1)
                 for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1))
    return mod.parity_pairs(offs, cdims), cdims, sp


# (deck, elements per edge): NE27000 resident; 39^3 the first cavity whose
# velocity streams; NE85184 (scripts/bench_matrix.py "ne85") and NE125000 stream
SIZES = {"ne27000": 30, "39cubed": 39, "ne85184": 44, "ne125000": 50}
STREAMS = {"ne27000": False, "39cubed": True, "ne85184": True, "ne125000": True}


@pytest.mark.pallas
@pytest.mark.parametrize("form", ["k", "k_plus_a", "mk_plus_a", "m", "g"])
@pytest.mark.parametrize("deck", list(SIZES))
def test_stream_rule_matches_jax(jax_side, deck, form):
    jps, js = jax_side
    pairs, cdims, sp = _window_route(tps, SIZES[deck], 2)
    assert pairs == _window_route(jps, SIZES[deck], 2)[0]
    pairs2 = wc2_shape = None
    if form == "g":
        # per-channel weights (3, m, Sp) on the coarse pressure (1, 1, Sp):
        # every pair of the G route reads class 0
        pairs = tuple(tuple((j, 0, dq) for j, _, dq in cls) for cls in pairs)
        wc_shape, x_shape = (3, 125, sp), (1, 1, sp)
    else:
        # K, MK + A and M: one table shared over the 3 velocity channels
        wc_shape, x_shape = (1, 125, sp), (3, 8, sp)
    if form == "k_plus_a":
        _, _, pairs2 = tps.build_conv_plane_route(js.local_off, cdims)
        assert pairs2 == jps.build_conv_plane_route(js.local_off, cdims)[2]
        wc2_shape = (1, 729, sp)
    want = _jax_streams(jps, wc_shape, x_shape, pairs, 3, pairs2, wc2_shape)
    got = tps.stream_field(x_shape, 4, pairs, pairs2)
    assert got == want
    assert got == (STREAMS[deck] and form != "g")


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _conv_planes(mod, s, seed):
    rng = np.random.default_rng(seed)
    ae = _f32(rng, (27, 27, int(np.prod(s.elem_dims))))
    ae_e = mod.embed_elem_table(ae, s.elem_dims, s.coarse_dims, s.sp_c)
    return np.ascontiguousarray(ae_e[np.asarray(s.conv_i_order)])


def _fields(s, rng):
    """A velocity (3, 8, Sp) and a coarse pressure (1, 1, Sp), numpy f32."""
    u = _f32(rng, (3, 8, s.sp_c))
    p = np.zeros((1, 1, s.sp_c), np.float32)
    p[0, 0, : s.nnp] = _f32(rng, s.nnp)
    return u, p


@pytest.mark.pallas
@pytest.mark.parametrize("form", ["k", "g", "k_plus_a"])
def test_forced_stream_matches_jax_streamed(jax_side, form):
    """stream_x=True on CPU tensors runs the plain version, which equals the
    JAX streamed kernel (interpret mode); stream_x=False gives the same
    array; no launch is counted."""
    import jax.numpy as jnp

    jps, s = jax_side
    rng = np.random.default_rng({"k": 21, "g": 22, "k_plus_a": 23}[form])
    u, p = _fields(s, rng)
    kw, kw_t = dict(pairs=s.k_pairs, co=3), dict(pairs=s.k_pairs, co=3)
    wc, x = np.asarray(s.d["Kp"]), u
    if form == "g":
        wc, x = np.asarray(s.d["Gp"]), p
        kw = kw_t = dict(pairs=s.g_pairs, co=3)
    elif form == "k_plus_a":
        ae = _conv_planes(jps, s, 24)
        planes_j = jps.conv_planes_from_ae(jnp.asarray(ae), groups=s.conv_groups)
        planes_t = tps.conv_planes_from_ae(torch.from_numpy(ae), groups=s.conv_groups)
        kw = dict(kw, wc2=planes_j, pairs2=s.conv_pairs2)
        kw_t = dict(kw_t, wc2=planes_t, pairs2=s.conv_pairs2)
    ref = np.asarray(jps.parity_apply(jnp.asarray(wc), jnp.asarray(x), stream_x=True, **kw))
    before = dict(cuda_lib.launch_counts)
    wc_t, x_t = torch.from_numpy(np.array(wc)), torch.from_numpy(x)
    got = tps.parity_apply(wc_t, x_t, stream_x=True, **kw_t)
    resident = tps.parity_apply(wc_t, x_t, stream_x=False, **kw_t)
    assert cuda_lib.launch_counts == before
    assert torch.equal(got, resident)
    scale = float(np.abs(ref).max())
    assert got.dtype == torch.float32 and got.shape == ref.shape and scale > 0
    assert float(np.abs(got.numpy() - ref).max()) <= APPLY_REL * scale


def _emulate_staged_reads(pairs, pairs2, m1, m2, px, sp, c, seed, blocks=None):
    """Stage each block (default: all) as csrc/parity_apply.cu does (numpy)
    and check that every route entry's staged value is x[c, p_in, q + dq]
    for each q of the block where that lies inside [0, sp); the entries keep
    the resident route's order, each class's first table before its second.
    Returns the runs and the staged values per channel."""
    heads, ents, runs, chan = tps.stream_runs(pairs, pairs2, m1, m2, px)
    plain_heads, plain_ents = tps._route_entries(pairs, pairs2, m1, m2, px)
    assert heads[16] == len(ents) == len(plain_ents) and len(heads) == tps.STREAM_HEADS
    for p in range(8):
        assert heads[2 * p] == plain_heads[p] <= heads[2 * p + 1] <= plain_heads[p + 1]
        assert all(e[0] == (k >= heads[2 * p + 1])
                   for k, e in enumerate(plain_ents[plain_heads[p]:plain_heads[p + 1]],
                                         plain_heads[p]))
    assert chan == sum(n for _, _, _, n in runs) and chan % 4 == 0
    assert all(s % 4 == 0 and t % 4 == 0 for _, s, t, _ in runs)
    x = np.random.default_rng(seed).standard_normal((c, px, sp)).astype(np.float32)
    i = np.arange(tps.STREAM_Q)
    for q0 in range(0, sp, tps.STREAM_Q) if blocks is None else blocks:
        tile = np.full((c, chan), np.nan, np.float32)
        for pp, s, t, n in runs:
            k = np.arange(n)
            g = q0 + s + k
            ok = (g >= 0) & (g < sp)
            tile[:, t + k[ok]] = x[:, pp, g[ok]]
        for (j, pp, dq, spos), (_, j0, pp0, dq0) in zip(ents, plain_ents):
            assert (j, pp, dq) == (j0, pp0, dq0)
            qs = q0 + i + dq
            ok = (qs >= 0) & (qs < sp)
            np.testing.assert_array_equal(tile[:, spos + i[ok]], x[:, pp, qs[ok]])
    return runs, chan


def test_stream_runs_cover_every_read_small(jax_side):
    """cavity_deck(4)'s K, K + A and G routes (Sp = 2048): every staged read
    is the value the resident kernel reads."""
    _, s = jax_side
    m = int(s.d["Kp"].shape[1])
    _emulate_staged_reads(s.k_pairs, None, m, 0, 8, s.sp_c, 3, 31)
    _emulate_staged_reads(s.k_pairs, s.conv_pairs2, m, 729, 8, s.sp_c, 3, 32)
    _emulate_staged_reads(s.g_pairs, None, int(s.d["Gp"].shape[1]), 0, 1, s.sp_c, 1, 33)


def test_stream_runs_at_ne85184_fit_shared_memory(jax_side):
    """At NE85184 every coarse shift dq = dx + dy cx + dz cx cy groups into
    9 runs per input class (72 for the velocity, 9 for the pressure), the
    staged reads are right on the first, a middle and the last block, and
    the tiles of 3 CTAs fit an SM's shared memory."""
    _, s = jax_side
    pairs, cdims, sp = _window_route(tps, 44, 2)
    _, _, pairs2 = tps.build_conv_plane_route(s.local_off, cdims)
    blocks = (0, sp // 2, sp - tps.STREAM_Q)
    assert len(_emulate_staged_reads(pairs, None, 125, 0, 8, sp, 3, 34, blocks)[0]) == 72
    runs, chan = _emulate_staged_reads(pairs, pairs2, 125, 729, 8, sp, 3, 35, blocks)
    assert len(runs) == 72
    assert STREAM_CTAS * (3 * chan * 4 + SMEM_CTA_RESERVE) <= SMEM_PER_SM
    g_pairs = tuple(tuple((j, 0, dq) for j, _, dq in cls) for cls in pairs)
    assert len(_emulate_staged_reads(g_pairs, None, 125, 0, 1, sp, 1, 36, blocks)[0]) == 9


@pytest.mark.cuda
def test_streamed_kernel_bit_equal_to_resident():
    """On the card: the streamed kernel equals the resident kernel bit for
    bit in its three forms (K, G, K + A) on cavity_deck(4)'s tables, each
    launch counted under its form's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the streamed kernel has no CPU form")
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    s = ExplicitBCHSolver(cavity_deck(4, viscosity=0.01, dt=0.001),
                          SolverConfig(dtype_policy=DTypePolicy.F32), device="cuda")
    assert s.layout == "parity"
    rng = np.random.default_rng(41)
    u, p = (torch.from_numpy(a).cuda() for a in _fields(s, rng))
    planes = tps.conv_planes_from_ae(torch.from_numpy(_conv_planes(tps, s, 42)).cuda(),
                                     groups=s.conv_groups)
    cases = (
        ("parity_apply_k", s.d["Kp"], u, dict(pairs=s.k_pairs, co=3)),
        ("parity_apply_g", s.d["Gp"], p, dict(pairs=s.g_pairs, co=3)),
        ("parity_apply_k_plus_a", s.d["Kp"], u,
         dict(pairs=s.k_pairs, co=3, wc2=planes, pairs2=s.conv_pairs2)),
    )
    for name, wc, x, kw in cases:
        cuda_lib.reset_launch_counts()
        resident = tps.parity_apply(wc, x, stream_x=False, **kw)
        streamed = tps.parity_apply(wc, x, stream_x=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(streamed, resident), name
        assert cuda_lib.launch_counts[name] == 1
        assert cuda_lib.launch_counts[name + "_streamed"] == 1
