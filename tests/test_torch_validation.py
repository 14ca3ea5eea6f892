"""PyTorch port: the Ghia validation (``validation/ghia1982.py``) and the
cavity validation runs (``validation/validate_cavity.py``).

* the Ghia tables, ``centerline_profiles`` and ``check_against_ghia`` equal
  to the JAX package's;
* the port's ``centerline_profiles`` on the JAX package's stored t = 250
  state (``cavity_re100_implicit_state.npz``) at the promoted coordinates of
  ``cavity_deck(30, cluster=2.0)`` (226,981 nodes) reproduces the stored
  profile: ``u_x`` and ``u_z`` bit for bit, ``z`` and ``x`` within 1e-7 (the
  stored run's coordinates were float32);
* each artifact the port wrote on the card (``cfd_with_cuda_tpu_torch/
  validation/data/``) against ``tests/test_validation.py``'s own criteria
  for its JAX counterpart, and the Re = 100 implicit profile against the JAX
  package's stored one within 2e-3 at every point, ``u_mon`` within 5e-4;
* the driver's loop on ``cavity_deck(4)`` on the CPU: two chunks, the JAX
  artifact's keys, the state file, a continued run and a seeded one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu.validation import ghia1982 as jghia
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu_torch.validation import ghia1982 as tghia
from cfd_with_cuda_tpu_torch.validation import validate_cavity
from cfd_with_cuda_tpu_torch.validation.ghia1982 import (
    BAND_3D,
    GHIA_U,
    GHIA_V,
    centerline_profiles,
    check_against_ghia,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_DATA = REPO / "cfd_with_cuda_tpu_torch" / "validation" / "data"
JAX_DATA = REPO / "cfd_with_cuda_tpu" / "validation" / "data"
JAX_KEYS = ("z", "u_x", "x", "u_z", "steps", "max_acc", "u_mon", "err_ghia_u", "err_ghia_v",
            "u_mon_tail", "drift_per_kstep")
ARTIFACTS = ("cavity_re100_implicit", "cavity_re100_explicit_stab", "cavity_re100_explicit",
             "cavity_re1000_implicit")
# the port's Re = 100 implicit run against the JAX package's (both from rest,
# 25,000 steps at dt 0.01, f32): two converged runs of one discretization
PROFILE_TOL, U_MON_TOL = 2e-3, 5e-4


def _port(name):
    return np.load(PORT_DATA / f"{name}.npz")


def _errs(d, re):
    return check_against_ghia(d["z"], d["u_x"], d["x"], d["u_z"], re=re)


# ---------------------------------------------------------------- ghia1982

def test_ghia_tables_match_jax():
    np.testing.assert_array_equal(tghia.GHIA_U, jghia.GHIA_U)
    np.testing.assert_array_equal(tghia.GHIA_V, jghia.GHIA_V)
    assert tghia.BAND_3D == jghia.BAND_3D
    assert tghia.__all__ == jghia.__all__


@pytest.mark.parametrize("re", [100, 1000])
def test_profile_functions_match_jax(rng, re):
    deck = cavity_deck(6, cluster=1.5)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    u = rng.standard_normal((mesh.nn, 3))
    ours = tghia.centerline_profiles(mesh.coords, u)
    theirs = jghia.centerline_profiles(mesh.coords, u)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(ours[0]) == len(ours[2]) == 13
    assert tghia.check_against_ghia(*ours, re=re) == jghia.check_against_ghia(*theirs, re=re)
    with pytest.raises(KeyError):
        tghia.check_against_ghia(*ours, re=400)


def test_profiles_reproduce_stored_jax_artifact():
    """The stored t = 250 state through the port's extraction gives the
    stored profile (the state's nodes: the promoted NE27000 mesh)."""
    state = np.load(JAX_DATA / "cavity_re100_implicit_state.npz")
    stored = np.load(JAX_DATA / "cavity_re100_implicit.npz")
    deck = cavity_deck(30, cluster=2.0, viscosity=0.01)
    mesh = promote_hex_mesh(deck.conn, deck.coords)
    assert mesh.nn == state["u"].shape[0] == 226_981
    z, u_x, x, u_z = centerline_profiles(mesh.coords, state["u"])
    np.testing.assert_array_equal(u_x, stored["u_x"])
    np.testing.assert_array_equal(u_z, stored["u_z"])
    np.testing.assert_allclose(z, stored["z"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(x, stored["x"], rtol=0, atol=1e-7)
    err_u, err_v = check_against_ghia(z, u_x, x, u_z)
    assert abs(err_u - float(stored["err_ghia_u"])) < 1e-6
    assert err_v == float(stored["err_ghia_v"])


# ---------------------------------------------------------------- the card's artifacts

@pytest.mark.parametrize("name", ARTIFACTS)
def test_port_artifact_records_its_run(name):
    d = _port(name)
    for k in JAX_KEYS + ("seed", "t_start", "t_end", "dt", "wall_s", "card", "device"):
        assert k in d.files, k
    assert str(d["device"]) == "cuda" and "H100" in str(d["card"])
    for k in ("z", "u_x", "x", "u_z", "u_mon_tail"):
        assert np.isfinite(d[k]).all(), k
    assert abs(float(d["t_end"]) - float(d["t_start"]) - int(d["steps"]) * float(d["dt"])) < 1e-6
    assert (float(d["err_ghia_u"]), float(d["err_ghia_v"])) == pytest.approx(
        _errs(d, 1000 if "re1000" in name else 100), abs=1e-12)


def _corr_u(d, col):
    return np.corrcoef(np.interp(GHIA_U[:, 0], d["z"], d["u_x"]), GHIA_U[:, col])[0, 1]


def _corr_v(d, col):
    return np.corrcoef(np.interp(GHIA_V[:, 0], d["x"], d["u_z"]), GHIA_V[:, col])[0, 1]


# tests/test_validation.py's criteria for each JAX artifact, one case each, on
# the port's artifact of the same run.  Its docs/VALIDATION.md checks read the
# JAX package's documents, not a run, and are not repeated
CRITERIA = {
    # test_stored_re100_profiles_within_ghia_band, test_stored_re100_was_steady
    "cavity_re100_implicit": {
        "from_rest_25000_steps": lambda d: str(d["seed"]) == "none" and int(d["steps"]) == 25_000,
        "ghia_band": lambda d: max(_errs(d, 100)) < BAND_3D,
        "profile_shape": lambda d: _corr_u(d, 1) > 0.995 and _corr_v(d, 1) > 0.99,
        "u_mon_near_ghia": lambda d: abs(float(d["u_mon"]) - (-0.20581)) < 0.02,
        "steady_by_drift": lambda d: float(d["drift_per_kstep"]) < 5e-5,
    },
    # test_stored_re100_explicit_documented_behavior
    "cavity_re100_explicit": {
        "from_rest_250000_steps": lambda d: str(d["seed"]) == "none"
        and int(d["steps"]) == 250_000,
        "erosion_envelope": lambda d: max(_errs(d, 100)) < 0.25,
        "profile_shape": lambda d: _corr_u(d, 1) > 0.99,
    },
    # test_stored_re100_explicit_stabilized_measured_envelope
    "cavity_re100_explicit_stab": {
        "seeded_50000_steps": lambda d: "cavity_re100_implicit_state.npz" in str(d["seed"])
        and int(d["steps"]) >= 50_000,
        "envelope": lambda d: max(_errs(d, 100)) < 0.15,
        "profile_shape": lambda d: _corr_u(d, 1) > 0.99,
        "drift_envelope": lambda d: 5e-5 < float(d["drift_per_kstep"]) < 1e-3,
    },
    # test_stored_re1000_measured_envelope
    "cavity_re1000_implicit": {
        "from_rest_30000_steps": lambda d: str(d["seed"]) == "none" and int(d["steps"]) >= 30_000,
        "finite": lambda d: np.isfinite(d["u_x"]).all() and np.isfinite(d["u_z"]).all(),
        "envelope": lambda d: _errs(d, 1000)[0] < 0.35 and _errs(d, 1000)[1] < 0.40,
        "structure": lambda d: _corr_u(d, 2) > 0.90 and _corr_v(d, 2) > 0.90,
        "oscillating_not_diverging": lambda d: 0.05 < float(d["max_acc"]) < 5.0,
    },
}


@pytest.mark.parametrize("name,criterion", [(n, c) for n, cs in CRITERIA.items() for c in cs])
def test_port_artifact_meets_jax_criterion(name, criterion):
    d = _port(name)
    assert CRITERIA[name][criterion](d), {
        k: float(d[k]) for k in ("steps", "max_acc", "u_mon", "err_ghia_u", "err_ghia_v",
                                 "drift_per_kstep")}


@pytest.mark.parametrize("what", ["profile", "u_mon"])
def test_port_re100_implicit_matches_jax_run(what):
    """The port's run from rest against the JAX package's stored one: the
    profiles within 2e-3 at every point, u_mon within 5e-4."""
    ours, theirs = _port("cavity_re100_implicit"), np.load(JAX_DATA / "cavity_re100_implicit.npz")
    assert int(ours["steps"]) == int(theirs["steps"])
    np.testing.assert_allclose(ours["z"], theirs["z"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(ours["x"], theirs["x"], rtol=0, atol=1e-7)
    if what == "profile":
        gap = max(np.abs(ours["u_x"] - theirs["u_x"]).max(),
                  np.abs(ours["u_z"] - theirs["u_z"]).max())
        assert gap < PROFILE_TOL, gap
    else:
        gap = abs(float(ours["u_mon"]) - float(theirs["u_mon"]))
        assert gap < U_MON_TOL, gap


# ---------------------------------------------------------------- the driver

def test_driver_runs_chunks_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("CFD_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    base = ["--deck-n", "4", "--device", "cpu", "--chunk-steps", "2",
            "--out-dir", str(tmp_path / "out"), "--state-dir", str(tmp_path / "state")]
    out = validate_cavity.main(base + ["--implicit", "--steps", "4"])
    d = np.load(out)
    assert out.name == "cavity_re100_implicit.npz"
    assert set(JAX_KEYS) <= set(d.files)
    assert int(d["steps"]) == 4 and str(d["seed"]) == "none" and str(d["card"]) == "cpu"
    assert float(d["t_end"]) == pytest.approx(0.04) and float(d["dt"]) == 0.01
    assert len(d["z"]) == len(d["x"]) == 9 and np.isfinite(d["u_x"]).all()
    assert (float(d["err_ghia_u"]), float(d["err_ghia_v"])) == _errs(d, 100)
    state = np.load(tmp_path / "state" / "cavity_re100_implicit_state.npz")
    assert state["u"].shape == (729, 3) and float(state["t"]) == pytest.approx(0.04)

    # a second call continues from the state file
    d2 = np.load(validate_cavity.main(base + ["--implicit", "--steps", "2"]))
    assert float(d2["t_start"]) == pytest.approx(0.04) and "(t=0.04)" in str(d2["seed"])

    # the explicit integrator seeded from the implicit state, stabilized
    d3 = np.load(validate_cavity.main(base + ["--seed-implicit", "--stab", "0.5", "--steps",
                                              "2"]))
    assert "cavity_re100_implicit_state.npz" in str(d3["seed"])
    assert float(d3["t_start"]) == 0.0 and float(d3["dt"]) == 0.001
    assert (tmp_path / "out" / "cavity_re100_explicit_stab.npz").exists()


def test_driver_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_cavity.main(["--deck-n", "2", "--steps", "1"])
