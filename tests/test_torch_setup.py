"""PyTorch port: host setup is array-equal to the JAX package's, and the
port imports nothing of JAX.

Both packages build the explicit solver's parity-path setup from the same
generated deck (``cavity_deck(4)``); every table the port's step reads
must equal the JAX solver's bit for bit (same numpy arithmetic, same f32
casts), and every static route must be the same tuple.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu.mesh.generators import cavity_deck as jax_cavity_deck
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxSolver
from cfd_with_cuda_tpu.utils.config import DTypePolicy as JaxPolicy
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RUNG1 = dict(pressure_cg_tol=1e-6, pressure_cg_fuse_loop=True, pressure_warm_start=True)


@pytest.fixture(scope="module")
def pair():
    js = JaxSolver(
        jax_cavity_deck(4, viscosity=0.01, dt=0.001),
        JaxConfig(dtype_policy=JaxPolicy.F32, pressure_backend="pallas",
                  structured_layout="parity", setup_cache="off", **RUNG1),
    )
    ts = ExplicitBCHSolver(
        cavity_deck(4, viscosity=0.01, dt=0.001),
        SolverConfig(dtype_policy=DTypePolicy.F32, **RUNG1), device="cpu",
    )
    assert js.layout == "parity"
    return js, ts


def test_deck_equal(pair):
    js, ts = pair
    for f in ("coords", "conn", "bc_vel_faces", "bc_str"):
        np.testing.assert_array_equal(getattr(ts.deck, f), getattr(js.deck, f))
    for f in ("ne", "ncn", "nnp", "dt", "max_iter", "tolerance",
              "zero_pressure_node", "viscosity", "density"):
        assert getattr(ts.deck, f) == getattr(js.deck, f), f


def test_mesh_equal(pair):
    js, ts = pair
    assert (ts.mesh.nn, ts.mesh.ncn) == (js.mesh.nn, js.mesh.ncn)
    np.testing.assert_array_equal(ts.mesh.coords, js.mesh.coords)
    np.testing.assert_array_equal(ts.mesh.ltog_node, js.mesh.ltog_node)
    np.testing.assert_array_equal(ts.bc_of_node, js.bc_of_node)


@pytest.mark.parametrize("field", ["Sv", "dSv", "Sp", "dSp", "gDSv", "gDSp",
                                   "det_jacob", "gq_factor"])
def test_element_tables_equal(pair, field):
    js, ts = pair
    np.testing.assert_array_equal(getattr(ts.tables, field), getattr(js.tables, field))


def test_assembled_operators_equal(pair):
    js, ts = pair
    np.testing.assert_array_equal(ts.ops.K, js.ops.K)
    np.testing.assert_array_equal(ts.ops.G, js.ops.G)
    np.testing.assert_array_equal(ts.ops.Md, js.ops.Md)
    zt, zj = ts.ops.Z.tocsr(), js.ops.Z.tocsr()
    np.testing.assert_array_equal(zt.indptr, zj.indptr)
    np.testing.assert_array_equal(zt.indices, zj.indices)
    np.testing.assert_array_equal(zt.data, zj.data)


@pytest.mark.parametrize("key", ["Kp", "Gp", "GT_cwin", "md_inv_p", "md_orig_inv_p",
                                 "bc_mask_p", "bc_vel_p", "gDSv_p", "gq_p", "Sv"])
def test_parity_tables_equal(pair, key):
    js, ts = pair
    ref = np.asarray(js.d[key])
    got = ts.d[key].numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_pressure_cg_tables_equal(pair):
    """The port's plain (125, NNp) window is the JAX DMA-block layout
    ``(nb, KP, s_pad)`` read back; the inverse diagonal its first NNp."""
    js, ts = pair
    s_pad = -(-js.nnp // 128) * 128
    win = np.asarray(js.d["Z_win_cg"]).reshape(-1, s_pad)[:125, : js.nnp]
    np.testing.assert_array_equal(ts.d["Z_win"].numpy(), win)
    np.testing.assert_array_equal(ts.d["Z_dinv"].numpy(), np.asarray(js.d["Z_dinv_cg"])[: js.nnp])


@pytest.mark.parametrize("attr", ExplicitBCHSolver.STATIC_ATTRS)
def test_static_routes_equal(pair, attr):
    js, ts = pair
    got, ref = getattr(ts, attr), getattr(js, attr)
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_initial_state_equal(pair):
    js, ts = pair
    sj, st = js.initial_state(), ts.initial_state()
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_state_roundtrip(pair):
    _, ts = pair
    rng = np.random.default_rng(8)
    u = rng.standard_normal((ts.nn, 3)).astype(np.float32)
    p = rng.standard_normal(ts.nnp).astype(np.float32)
    st = ts.state_from_fields(u, p)
    assert st.un.shape == (3, 8, ts.sp_c)
    u2, p2 = ts.fields(st)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(p2, p)


# ------------------------------------------------------------ no JAX in the port

def _port_files():
    return sorted((REPO / "cfd_with_cuda_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "cfd_with_cuda_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    assert not bad, bad


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import cfd_with_cuda_tpu_torch.solvers.explicit_bch, cfd_with_cuda_tpu_torch.interop\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cfd_with_cuda_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
