"""PyTorch port: the run workflow — ``python -m cfd_with_cuda_tpu_torch``,
Tecplot output, ``isRestart`` and the setup cache — on the CPU.

Mirrors ``tests/test_cli.py``, ``tests/test_restart.py`` and
``tests/test_tecplot_io.py::test_solver_tecplot_integration`` on the port
(``--device cpu``), then holds the port against the JAX package:

* both CLIs under ``--dtype f64`` take the XLA structured path: the ``.dat``
  fields agree to 1e-11 of max|u| and max|p| (two f64 runs of one algorithm
  whose reductions sum in other orders; ``chip_smoke.py`` holds the card
  against the CPU at the same bound), the monitor tables and the CG counts
  of every step are equal;
* the F64 restart round trip: from the same restart file both packages'
  resumed ``u_mon`` agree to 1e-12 of max|u_mon|;
* a setup-cache hit gives the tables of a fresh setup and 3 steps bit for
  bit, on every layout (parity, interleaved, XLA, ELL) of both solvers.

Every deck is ``cavity_deck(3)``; the setup cache of every run goes to a
temporary directory (``CFD_TORCH_CACHE_DIR``, ``CFD_TPU_CACHE_DIR``).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu import __main__ as jax_main
from cfd_with_cuda_tpu.io.deck import write_fractional_deck as jax_write_deck
from cfd_with_cuda_tpu.solvers import base as jax_base
from cfd_with_cuda_tpu.utils import setup_cache as jax_setup_cache
from cfd_with_cuda_tpu_torch.__main__ import _resolve_deck, main
from cfd_with_cuda_tpu_torch.io.deck import write_fractional_deck
from cfd_with_cuda_tpu_torch.io.tecplot import read_restart
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.implicit_gq import ImplicitGQSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

NN, NNP, NE = 343, 64, 27          # cavity_deck(3): 7^3 velocity, 4^3 pressure nodes
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters", "mom_iters")
F64_TOL = 1e-11
RESTART_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cache_dirs(tmp_path, monkeypatch):
    """Both packages' setup caches in this test's directory; the JAX CLI's
    persistent XLA compile cache left off (it would outlive the test)."""
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", str(tmp_path / "cache_torch"))
    monkeypatch.setenv("CFD_TPU_CACHE_DIR", str(tmp_path / "cache_jax"))
    monkeypatch.setattr(jax_setup_cache, "enable_compilation_cache", lambda path=None: None)


def make_problem_dir(path, writer=write_fractional_deck, **kw):
    path.mkdir(exist_ok=True)
    deck = cavity_deck(3, viscosity=0.01, dt=0.001, t_final=0.01, **kw)
    writer(path / "tinyCavity.inp", deck)
    (path / "ProblemName.txt").write_text("tinyCavity\n")
    return path


def _flip_restart(d):
    inp = d / "tinyCavity.inp"
    inp.write_text(re.sub(r"(isRestart\s*:\s*)0", r"\g<1>1", inp.read_text(), count=1))


def test_resolve_deck(tmp_path):
    make_problem_dir(tmp_path)
    assert _resolve_deck(str(tmp_path)).name == "tinyCavity.inp"
    assert _resolve_deck(str(tmp_path / "ProblemName.txt")).name == "tinyCavity.inp"
    assert _resolve_deck(str(tmp_path / "tinyCavity.inp")).name == "tinyCavity.inp"


def test_resolve_deck_missing_pointer_names_the_problem(tmp_path):
    out = _resolve_deck(str(tmp_path))
    assert "<missing-ProblemName.txt>" in out.name
    (tmp_path / "ProblemName.txt").write_text("")
    out = _resolve_deck(str(tmp_path))
    assert "<empty-ProblemName.txt>" in out.name
    with pytest.raises(SystemExit):
        main([str(tmp_path), "--device", "cpu"])       # "deck not found"


def test_cli_run_and_restart_roundtrip(tmp_path, capsys, monkeypatch):
    """Run via ProblemName.txt: the products appear under the reference's
    names, a second run hits the setup cache and writes the same bytes, and
    flipping isRestart resumes from the written checkpoint."""
    d = make_problem_dir(tmp_path / "p")
    cuda_lib.reset_launch_counts()
    first = {}
    assert main([str(d), "--quiet", "--chunk", "5", "--steps", "10", "--device", "cpu"],
                report=first) == 0
    assert all(v == 0 for v in cuda_lib.launch_counts.values())   # plain path on CPU
    out = capsys.readouterr().out
    assert "setup_cache=miss" in out and "layout=parity" in out
    assert "10 steps in" in out and "steps 6-10" in out
    dat, restart = d / "tinyCavity.dat", d / "tinyCavity_restart.dat"
    assert dat.exists() and restart.exists()
    lines = dat.read_text().splitlines()
    assert len(lines) == 3 + NN + 8 * NE
    rows = np.loadtxt(dat, skiprows=3, max_rows=NN)
    assert np.isfinite(rows).all()
    assert [h["step"] for h in first["history"]] == list(range(1, 11))
    walls = [h["wall"] for h in first["history"]]
    assert walls == sorted(walls) and walls[0] > 0
    # the product is the final state's dump
    u, p = first["solver"].fields(first["state"])
    u_f, p_f = read_restart(dat, NN, NNP)
    np.testing.assert_allclose(u_f, u, rtol=1e-11, atol=1e-300)
    np.testing.assert_allclose(p_f, p, rtol=1e-11, atol=1e-300)

    # the same command again: a cache hit, byte-equal products
    products = dat.read_bytes(), restart.read_bytes()
    again = {}
    main([str(d), "--quiet", "--chunk", "5", "--steps", "10", "--device", "cpu"], report=again)
    assert again["solver"].setup_cache_hit and "setup_cache=hit" in capsys.readouterr().out
    assert (dat.read_bytes(), restart.read_bytes()) == products

    _flip_restart(d)
    u_r, p_r = read_restart(restart, NN, NNP)
    starts = []
    resolve = ExplicitBCHSolver.resolve_initial_state
    monkeypatch.setattr(ExplicitBCHSolver, "resolve_initial_state",
                        lambda self: starts.append(resolve(self)) or starts[-1])
    resumed = {}
    assert main([str(d), "--quiet", "--chunk", "5", "--steps", "5", "--device", "cpu"],
                report=resumed) == 0
    assert not resumed["solver"].setup_cache_hit          # isRestart is deck content
    assert len(resumed["history"]) == 5
    # the resumed run started from the checkpoint's fields (f32 state)
    (start,) = starts
    u0, p0 = resumed["solver"].fields(start)
    np.testing.assert_array_equal(u0, u_r.astype(np.float32))
    np.testing.assert_array_equal(p0, p_r.astype(np.float32))


def test_cli_monitor_table_and_implicit(tmp_path, capsys):
    d = make_problem_dir(tmp_path / "p")
    assert main([str(d), "--solver", "implicit", "--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    head = [i for i, line in enumerate(out) if line.split()[:2] == ["step", "iter"]]
    assert len(head) == 1
    table = [line.split() for line in out[head[0] + 1: head[0] + 4]]
    assert [int(r[0]) for r in table] == [1, 2, 3] and all(r[1] == "1" for r in table)


@pytest.mark.parametrize("choice", ["poisson", "segregated", "gls", "stokes"])
def test_legacy_solver_choice_raises_item_9(tmp_path, choice):
    d = make_problem_dir(tmp_path / "p")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 9") as err:
        main([str(d), "--solver", choice, "--device", "cpu"])
    assert err.match(choice)


@pytest.mark.parametrize("dialect,solver", [("legacy", "segregated"), ("poisson", "poisson")])
def test_legacy_deck_under_auto_raises_item_9(tmp_path, monkeypatch, dialect, solver):
    d = make_problem_dir(tmp_path / "p")
    from cfd_with_cuda_tpu_torch.io import deck as deck_mod

    read = deck_mod.read_deck
    monkeypatch.setattr(deck_mod, "read_deck",
                        lambda p: dataclasses.replace(read(p), dialect=dialect))
    with pytest.raises(NotImplementedError, match=f"the {solver} solver .*item 9"):
        main([str(d), "--device", "cpu"])


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    d = make_problem_dir(tmp_path / "p")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(d), "--quiet", "--steps", "1"])
    assert not (d / "tinyCavity.dat").exists()


def _restart_cfg():
    return SolverConfig(pressure_cg_tol=1e-12, steps_per_chunk=1)


@pytest.mark.parametrize("cls,rtol", [(ExplicitBCHSolver, 2e-4), (ImplicitGQSolver, 5e-2)])
def test_restart_roundtrip(cls, rtol, tmp_path):
    """tests/test_restart.py on the port: 3 steps, a dump, 3 resumed steps
    against 6 uninterrupted ones, at the JAX package's bounds (the restart
    stores u, v, w and p only)."""
    deck = cavity_deck(5, viscosity=0.01, dt=2e-3, t_final=1.0)
    deck.title = "cavity_rt"
    deck.source_path = str(tmp_path / "cavity_rt.inp")
    _, hist_full = cls(deck, _restart_cfg(), "cpu").run(n_steps=6)
    cls(deck, _restart_cfg(), "cpu").run(n_steps=3, tecplot_path=tmp_path / "out.dat")
    assert (tmp_path / "cavity_rt_restart.dat").exists() and (tmp_path / "out.dat").exists()
    deck2 = dataclasses.replace(deck, is_restart=True)
    _, hist_res = cls(deck2, _restart_cfg(), "cpu").run(n_steps=3)
    np.testing.assert_allclose([h["u_mon"] for h in hist_res],
                               [h["u_mon"] for h in hist_full[3:]], rtol=rtol, atol=1e-7)


def test_restart_missing_file_raises(tmp_path):
    deck = cavity_deck(3, viscosity=0.01, dt=2e-3, t_final=1.0)
    deck.title = "nowhere"
    deck.source_path = str(tmp_path / "nowhere.inp")
    deck.is_restart = True
    s = ExplicitBCHSolver(deck, _restart_cfg(), "cpu")
    with pytest.raises(FileNotFoundError, match="isRestart"):
        s.run(n_steps=1)


def test_restart_path_of_a_generated_deck():
    s = ExplicitBCHSolver(cavity_deck(2), _restart_cfg(), "cpu")
    assert str(s.restart_path()) == f"{cavity_deck(2).title}_restart.dat"


def test_dump_cadence(tmp_path, monkeypatch):
    """Dumps at the end of each chunk that reaches the cadence, and once at
    the end (JAX solvers/base.py:228-245)."""
    deck = cavity_deck(2, dt=2e-3)
    deck.source_path = str(tmp_path / "c.inp")
    s = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=2), "cpu")
    steps = []
    monkeypatch.setattr(s, "write_tecplot", lambda st, path: steps.append(str(path)))
    s.run(n_steps=7, tecplot_path=tmp_path / "c.dat", tecplot_every=3)
    dat, rst = str(tmp_path / "c.dat"), str(tmp_path / "c_restart.dat")
    # chunks end at 2, 4, 6, 7: the cadence is met at 4 and at 6, then the end
    assert steps == [dat, rst] * 3


def test_solver_tecplot_integration(tmp_path):
    """tests/test_tecplot_io.py::test_solver_tecplot_integration on the
    port, with the dump byte-equal to the JAX writer's of the same fields."""
    from cfd_with_cuda_tpu.io.tecplot import write_tecplot as jax_write_tecplot
    from cfd_with_cuda_tpu.mesh.topology import promote_hex_mesh as jax_promote

    deck = cavity_deck(2, viscosity=0.5, dt=0.01)
    solver = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=2), "cpu")
    state, _ = solver.run(n_steps=4)
    path = tmp_path / "out.dat"
    solver.write_tecplot(state, path)
    state2 = solver.state_from_restart(path)
    (u1, p1), (u2, p2) = solver.fields(state), solver.fields(state2)
    np.testing.assert_allclose(u1, u2, atol=1e-10)
    np.testing.assert_allclose(p1, p2, atol=1e-10)
    m = jax_promote(deck.conn, deck.coords)
    jax_write_tecplot(tmp_path / "jax.dat", deck.title, m.coords, m.ltog_node, u1, p1)
    assert path.read_bytes() == (tmp_path / "jax.dat").read_bytes()
    # a solver made from tables promotes the mesh when it first writes
    twin = ExplicitBCHSolver.from_tables(deck, solver.config, solver.d, solver.static_attrs(),
                                         device="cpu")
    twin.write_tecplot(state, tmp_path / "twin.dat")
    assert (tmp_path / "twin.dat").read_bytes() == path.read_bytes()


# ---------------------------------------------------------------- against JAX

def _monitor_table(out: str) -> np.ndarray:
    """The per-step rows the CLI prints (step, iter, time, u, v, w, p, maxAcc)."""
    rows = [line.split() for line in out.splitlines()]
    return np.asarray([[float(v) for v in r] for r in rows
                       if len(r) == 8 and r[0].isdigit()])


def _dat_fields(path):
    rows = np.loadtxt(path, skiprows=3, max_rows=NN)
    return rows[:, 3:6], rows[:, 6]


@pytest.fixture()
def jax_history(monkeypatch):
    """Records the history rows of every JAX ``run()``."""
    runs = []
    run = jax_base.ChunkedTimeLoop.run

    def recorded(self, *a, **kw):
        out = run(self, *a, **kw)
        runs.append(out[1])
        return out

    monkeypatch.setattr(jax_base.ChunkedTimeLoop, "run", recorded)
    return runs


def test_f64_cli_and_restart_match_jax(tmp_path, capsys, jax_history):
    args = ["--chunk", "5", "--steps", "10", "--dtype", "f64"]
    pd = make_problem_dir(tmp_path / "port")
    jd = make_problem_dir(tmp_path / "jax", writer=jax_write_deck)
    port = {}
    assert main([str(pd), *args, "--device", "cpu"], report=port) == 0
    port_out = capsys.readouterr().out
    assert jax_main.main([str(jd), *args]) == 0
    jax_out = capsys.readouterr().out
    assert port["solver"].xla and port["solver"].layout == "interleaved"

    # the products: u and p (interpolated to every node) at 1e-11 of their max
    (u_t, p_t), (u_j, p_j) = _dat_fields(pd / "tinyCavity.dat"), _dat_fields(jd / "tinyCavity.dat")
    assert np.abs(u_t - u_j).max() <= F64_TOL * np.abs(u_j).max()
    assert np.abs(p_t - p_j).max() <= F64_TOL * np.abs(p_j).max()
    # the monitor tables (5 decimals) and every step's counts
    tab_t, tab_j = _monitor_table(port_out), _monitor_table(jax_out)
    assert tab_t.shape == tab_j.shape == (10, 8)
    np.testing.assert_array_equal(tab_t[:, :3], tab_j[:, :3])
    np.testing.assert_allclose(tab_t[:, 3:], tab_j[:, 3:], rtol=0, atol=1.5e-5)
    (hist_j,) = jax_history
    rows_t = np.asarray([[h[f] for f in STAT_FIELDS] for h in port["history"]])
    rows_j = np.asarray([[h[f] for f in STAT_FIELDS] for h in hist_j])
    np.testing.assert_array_equal(rows_t[:, 5:], rows_j[:, 5:])
    mon = np.abs(rows_j[:, :4]).max()
    assert np.abs(rows_t[:, :4] - rows_j[:, :4]).max() <= F64_TOL * mon

    # resume both from the SAME restart file (the port's), 3 steps
    (jd / "tinyCavity_restart.dat").write_bytes((pd / "tinyCavity_restart.dat").read_bytes())
    _flip_restart(pd)
    _flip_restart(jd)
    resumed = {}
    main([str(pd), "--quiet", "--chunk", "5", "--steps", "3", "--dtype", "f64",
          "--device", "cpu"], report=resumed)
    jax_main.main([str(jd), "--quiet", "--chunk", "5", "--steps", "3", "--dtype", "f64"])
    u_res_t = np.asarray([h["u_mon"] for h in resumed["history"]])
    u_res_j = np.asarray([h["u_mon"] for h in jax_history[-1]])
    assert u_res_t.shape == u_res_j.shape == (3,)
    assert np.abs(u_res_t - u_res_j).max() <= RESTART_TOL * np.abs(u_res_j).max()
    assert [h["cg_iters"] for h in resumed["history"]] == [h["cg_iters"] for h in
                                                          jax_history[-1]]


# ---------------------------------------------------------------- setup cache

LAYOUTS = {
    "parity": (dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6), "parity", False),
    "interleaved": (dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                         structured_layout="interleaved"), "interleaved", False),
    "xla": (dict(), "interleaved", True),
    "ell": (dict(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6, structured="never"),
            "ell", False),
}


@pytest.mark.parametrize("cls", [ExplicitBCHSolver, ImplicitGQSolver],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_setup_cache_hit_is_bit_equal(tmp_path, cls, layout):
    kw, want_layout, xla = LAYOUTS[layout]
    cfg = SolverConfig(setup_cache=str(tmp_path / "c"), steps_per_chunk=3, **kw)
    deck = cavity_deck(3, viscosity=0.01, dt=0.002)
    fresh = cls(deck, dataclasses.replace(cfg, setup_cache=None), "cpu")
    miss = cls(deck, cfg, "cpu")
    hit = cls(cavity_deck(3, viscosity=0.01, dt=0.002), cfg, "cpu")
    assert (miss.setup_cache_hit, hit.setup_cache_hit) == (False, True)
    assert miss.setup_cache_bytes > 0 and hit.setup_cache_bytes == 0
    assert (hit.layout, hit.xla) == (want_layout, xla) == (fresh.layout, fresh.xla)
    assert hit.tables is None and hit.ops is None
    assert sorted(hit.d) == sorted(fresh.d)
    for k in fresh.d:
        assert hit.d[k].dtype == fresh.d[k].dtype, k
        assert torch.equal(hit.d[k], fresh.d[k]), k
    assert hit.static_attrs().keys() == fresh.static_attrs().keys()
    np.testing.assert_array_equal(hit.mesh.ltog_node, fresh.mesh.ltog_node)
    (s_f, h_f), (s_h, h_h) = fresh.run(n_steps=3), hit.run(n_steps=3)
    for a, b in zip(s_f, s_h):
        assert torch.equal(a, b)
    assert [[h[f] for f in STAT_FIELDS] for h in h_f] == [[h[f] for f in STAT_FIELDS]
                                                          for h in h_h]
    # plain=True shares the snapshot (the setup does not branch on it),
    # another class misses
    assert cls(deck, cfg, "cpu", plain=True).setup_cache_hit
    other = ImplicitGQSolver if cls is ExplicitBCHSolver else ExplicitBCHSolver
    assert not other(deck, cfg, "cpu").setup_cache_hit


def test_setup_cache_in_the_cli_default_directory(tmp_path, monkeypatch, capsys):
    """``setup_cache="auto"`` with ``CFD_TORCH_CACHE_DIR`` unset writes under
    ``<repo>/.cache/setup_torch``; here the module's notion of the repo root
    is moved to this test's directory."""
    from cfd_with_cuda_tpu_torch.utils import setup_cache

    monkeypatch.delenv("CFD_TORCH_CACHE_DIR")
    fake = tmp_path / "repo" / "cfd_with_cuda_tpu_torch" / "utils" / "setup_cache.py"
    monkeypatch.setattr(setup_cache, "__file__", str(fake))
    d = make_problem_dir(tmp_path / "p")
    main([str(d), "--quiet", "--steps", "2", "--device", "cpu"])
    assert list((tmp_path / "repo" / ".cache" / "setup_torch").glob("*.pkl"))
