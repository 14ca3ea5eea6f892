"""PyTorch port: the run workflow's numpy modules against the JAX package's.

The port keeps its own copies of the Tecplot writer and restart reader
(``io/tecplot.py``), the fractional deck writer (``io/deck.py``), the
channel, bending-duct and Kovasznay generators (``mesh/generators.py``),
the monitor table (``utils/timers.py``) and the setup-cache fingerprint
(``utils/setup_cache.py``).  The same inputs give the same bytes, arrays
and strings as the JAX package's; no tolerance.
"""

import dataclasses

import numpy as np
import pytest

from cfd_with_cuda_tpu.io import deck as jax_deck
from cfd_with_cuda_tpu.io import tecplot as jax_tecplot
from cfd_with_cuda_tpu.mesh import generators as jax_gen
from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh as jax_promote
from cfd_with_cuda_tpu.utils import timers as jax_timers
from cfd_with_cuda_tpu_torch.io import deck as port_deck
from cfd_with_cuda_tpu_torch.io import tecplot as port_tecplot
from cfd_with_cuda_tpu_torch.mesh import generators as port_gen
from cfd_with_cuda_tpu_torch.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu_torch.utils import setup_cache, timers
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig


def _fields(n, seed):
    deck = port_gen.cavity_deck(n)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    rng = np.random.default_rng(seed)
    return deck, mesh, rng.standard_normal((mesh.nn, 3)), rng.standard_normal(mesh.ncn)


@pytest.mark.parametrize("n", [2, 3])
def test_tecplot_bytes_equal_jax(tmp_path, n):
    deck, mesh, u, p = _fields(n, 20261018 + n)
    jmesh = jax_promote(deck.conn, deck.coords)
    np.testing.assert_array_equal(mesh.ltog_node, jmesh.ltog_node)
    np.testing.assert_array_equal(mesh.coords, jmesh.coords)
    port_tecplot.write_tecplot(tmp_path / "port.dat", deck.title, mesh.coords,
                               mesh.ltog_node, u, p)
    jax_tecplot.write_tecplot(tmp_path / "jax.dat", deck.title, jmesh.coords,
                              jmesh.ltog_node, u, p)
    port_bytes = (tmp_path / "port.dat").read_bytes()
    assert port_bytes == (tmp_path / "jax.dat").read_bytes()
    # header + NN data rows + 8 sub-hexes of each element
    assert len(port_bytes.decode().splitlines()) == 3 + mesh.nn + 8 * deck.ne
    # no temporary file left beside the product
    assert sorted(f.name for f in tmp_path.iterdir()) == ["jax.dat", "port.dat"]


def test_linear_tecplot_bytes_equal_jax(tmp_path):
    """The 8-node (linear) branch: one brick an element, corner pressure."""
    deck = port_gen.cavity_deck(2)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((deck.coords.shape[0], 3))
    p = rng.standard_normal(deck.coords.shape[0])
    port_tecplot.write_tecplot(tmp_path / "a.dat", "lin", deck.coords, deck.conn, u, p)
    jax_tecplot.write_tecplot(tmp_path / "b.dat", "lin", deck.coords, deck.conn, u, p)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()


def test_read_restart_and_interpolation_equal_jax(tmp_path):
    deck, mesh, u, p = _fields(3, 11)
    np.testing.assert_array_equal(port_tecplot.SUB_HEXES, jax_tecplot.SUB_HEXES)
    np.testing.assert_array_equal(
        port_tecplot.interpolate_pressure_to_all_nodes(p, mesh.ltog_node, mesh.nn),
        jax_tecplot.interpolate_pressure_to_all_nodes(p, mesh.ltog_node, mesh.nn),
    )
    path = tmp_path / "r.dat"
    port_tecplot.write_tecplot(path, "r", mesh.coords, mesh.ltog_node, u, p)
    (u_t, p_t), (u_j, p_j) = (port_tecplot.read_restart(path, mesh.nn, mesh.ncn),
                              jax_tecplot.read_restart(path, mesh.nn, mesh.ncn))
    np.testing.assert_array_equal(u_t, u_j)
    np.testing.assert_array_equal(p_t, p_j)
    # %.11e keeps 12 significant digits
    np.testing.assert_allclose(u_t, u, rtol=1e-11, atol=0)
    np.testing.assert_allclose(p_t, p, rtol=1e-11, atol=0)


def _same_deck(a, b):
    """Every field of two decks (either package's) equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


# (generator name, args, kwargs) of the decks users write
DECKS = {
    "cavity": ("cavity_deck", (3,), dict(cluster=2.0, viscosity=0.01, dt=0.001)),
    "channel": ("channel_deck", (6, 2, 2),
                dict(lengths=(3.0, 1.0, 1.0), inlet_profile="duct_developed")),
    "bend": ("bending_duct_deck", (12, 6, 6), dict(dt=0.005)),
    "kovasznay": ("kovasznay_deck", (4, 6, 2), {}),
    "bfs": ("bfs_deck", (12, 4, 4), {}),
}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_written_deck_bytes_equal_jax_and_read_back(tmp_path, name):
    gen, args, kw = DECKS[name]
    port, jax = getattr(port_gen, gen)(*args, **kw), getattr(jax_gen, gen)(*args, **kw)
    _same_deck(port, jax)
    port_deck.write_fractional_deck(tmp_path / "port.inp", port)
    jax_deck.write_fractional_deck(tmp_path / "jax.inp", jax)
    assert (tmp_path / "port.inp").read_bytes() == (tmp_path / "jax.inp").read_bytes()
    # each package reads the other's file, and both read what the port wrote
    # to the same deck
    back_j = jax_deck.read_deck(tmp_path / "port.inp")
    back_t = port_deck.read_deck(tmp_path / "jax.inp")
    for f in dataclasses.fields(back_t):
        if f.name != "source_path":
            x, y = getattr(back_t, f.name), getattr(back_j, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    assert back_t.inlet_profile == port.inlet_profile
    np.testing.assert_array_equal(back_t.conn, port.conn)
    np.testing.assert_allclose(back_t.coords, port.coords, rtol=0, atol=5e-8)


@pytest.mark.parametrize("gen,sizes", [
    ("channel_deck", [(4, 2, 2), (10, 3, 5)]),
    ("bending_duct_deck", [(12, 6, 6), (20, 5, 7)]),
    ("kovasznay_deck", [(4, 6, 2), (8, 12, 2)]),
])
def test_generators_equal_jax(gen, sizes):
    for args in sizes:
        _same_deck(getattr(port_gen, gen)(*args), getattr(jax_gen, gen)(*args))
    # the keyword choices of each generator
    kw = {"channel_deck": dict(lengths=(3.0, 1.0, 2.0), cluster=1.5, inlet_profile="duct_series",
                               inlet_velocity=(2.0, 0.0, 0.0), viscosity=0.02),
          "bending_duct_deck": dict(r_mean=1.5, cluster=1.0, inlet_velocity=2.0,
                                    inlet_profile=None, t_final=3.0),
          "kovasznay_deck": dict(re=20.0, dt=0.01)}[gen]
    _same_deck(getattr(port_gen, gen)(*sizes[0], **kw), getattr(jax_gen, gen)(*sizes[0], **kw))


def test_bending_duct_rejects_a_radius_inside_the_duct():
    with pytest.raises(ValueError, match="r_mean"):
        port_gen.bending_duct_deck(4, 2, 2, r_mean=0.5)


def test_monitor_strings_equal_jax():
    assert timers.monitor_header() == jax_timers.monitor_header()
    rows = [(1, 3, 0.001, -1.5e-4, 2e-6, -3e-7, 0.0125, 0.37, 0.36014),
            (12345, 1, 12.5, 1.0, -0.25, 0.0, -123.456, 1234.5, 1e-7)]
    for r in rows:
        assert timers.monitor_row(*r) == jax_timers.monitor_row(*r)


def test_phase_timer_accumulates(capsys):
    t = timers.PhaseTimer()
    for _ in range(2):
        with t.phase("setup"):
            pass
    assert list(t.phases) == ["setup"] and t.phases["setup"] >= 0.0
    assert capsys.readouterr().out.count("setup") == 2
    assert t.report().startswith("setup")


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with timers.torch_trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    with timers.torch_trace(None) as off:
        assert off is None
    assert timers.device_spans(prof) == []          # no device here


def test_busy_share_is_the_union_of_the_spans():
    # [0, 4] and [2, 6] overlap, [8, 9] stands alone: 7 us busy of 10
    assert timers.busy_share([(8.0, 9.0), (0.0, 4.0), (2.0, 6.0)], 10.0) == 0.7
    assert timers.busy_share([(0.0, 5.0), (1.0, 2.0)], 10.0) == 0.5   # nested
    assert timers.busy_share([], 10.0) is None


def test_ms_per_step_leaves_out_the_warm_steps():
    hist = [dict(wall=w) for w in (1.0, 1.5, 1.75, 1.875)]
    assert timers.ms_per_step(hist, 2) == (1.875 - 1.5) / 2 * 1e3
    assert timers.ms_per_step(hist, 4) is None


# a value of each fingerprinted config field other than its default
_CFG_CHANGES = dict(
    dtype_policy=DTypePolicy.F32, pressure_pin_large=10.0, pressure_precond="jacobi",
    structured="never", shard_pad=128, spmd_devices=2, structured_layout="interleaved",
    pressure_cg_sym=True,
)


def test_fingerprint_stable_and_keyed_by_each_config_field():
    deck = port_gen.cavity_deck(2)
    base = setup_cache.deck_fingerprint(deck, SolverConfig(), "ExplicitBCHSolver", True, False)
    again = setup_cache.deck_fingerprint(port_gen.cavity_deck(2), SolverConfig(),
                                         "ExplicitBCHSolver", True, False)
    assert base == again and len(base) == 32
    assert sorted(_CFG_CHANGES) == sorted(setup_cache._CFG_INCLUDE)
    keys = {base}
    for name, value in _CFG_CHANGES.items():
        cfg = dataclasses.replace(SolverConfig(), **{name: value})
        keys.add(setup_cache.deck_fingerprint(deck, cfg, "ExplicitBCHSolver", True, False))
    # runtime knobs do not enter; the extras (class, kernel path, plain) do
    knobs = SolverConfig(pressure_cg_tol=1e-3, steps_per_chunk=3, pressure_warm_start=True,
                         verbose=True)
    assert setup_cache.deck_fingerprint(deck, knobs, "ExplicitBCHSolver", True, False) == base
    for extra in (("ImplicitGQSolver", True, False), ("ExplicitBCHSolver", False, False),
                  ("ExplicitBCHSolver", True, True)):
        keys.add(setup_cache.deck_fingerprint(deck, SolverConfig(), *extra))
    # the deck's contents enter, its provenance does not
    moved = port_gen.cavity_deck(2)
    moved.source_path = "/elsewhere/cavity.inp"
    assert setup_cache.deck_fingerprint(moved, SolverConfig(), "ExplicitBCHSolver", True,
                                        False) == base
    restart = port_gen.cavity_deck(2)
    restart.is_restart = True
    keys.add(setup_cache.deck_fingerprint(restart, SolverConfig(), "ExplicitBCHSolver", True,
                                          False))
    assert len(keys) == 1 + len(_CFG_CHANGES) + 3 + 1


def test_cache_dir_choices(monkeypatch, tmp_path):
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", str(tmp_path))
    assert SolverConfig(setup_cache="auto").setup_cache_dir() == str(tmp_path)
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", "")
    assert SolverConfig(setup_cache="auto").setup_cache_dir() is None
    monkeypatch.delenv("CFD_TORCH_CACHE_DIR")
    auto = SolverConfig(setup_cache="auto").setup_cache_dir()
    assert auto.endswith(".cache/setup_torch")
    for off in (None, "", "off", "none", "0"):
        assert SolverConfig(setup_cache=off).setup_cache_dir() is None
    assert SolverConfig(setup_cache=str(tmp_path)).setup_cache_dir() == str(tmp_path)


def test_snapshot_store_load_and_evict(tmp_path):
    snap = {"d": {"a": np.arange(1000, dtype=np.float32)}, "attrs": {"layout": "ell"}}
    nbytes = setup_cache.snapshot_store(str(tmp_path), "k1", snap)
    assert nbytes == (tmp_path / "k1.pkl").stat().st_size > 4000
    back = setup_cache.snapshot_load(str(tmp_path), "k1")
    np.testing.assert_array_equal(back["d"]["a"], snap["d"]["a"])
    assert setup_cache.snapshot_load(str(tmp_path), "absent") is None
    assert setup_cache.snapshot_load(None, "k1") is None
    (tmp_path / "bad.pkl").write_bytes(b"not a pickle")
    assert setup_cache.snapshot_load(str(tmp_path), "bad") is None
    # the oldest snapshots go first once the directory is over the cap
    import os

    setup_cache.snapshot_store(str(tmp_path), "k2", snap)
    os.utime(tmp_path / "k1.pkl", (1, 1))
    setup_cache.evict_lru(tmp_path, max_bytes=nbytes + 100)
    assert not (tmp_path / "k1.pkl").exists() and (tmp_path / "k2.pkl").exists()
    assert setup_cache.snapshot_store(None, "k3", snap) == 0
