"""PyTorch port: mesh import (Gambit .neu, IDEAS .unv) and the tet element.

Held against the JAX package on files each test writes itself:

* ``read_neu`` (hex and tet, node- and face-typed groups) and ``read_unv``
  (tet 111 and hex 115, a surface element the reader skips, two groups):
  coordinates, connectivity and groups equal bit for bit;
* ``deck_from_mesh``, field by field, in the legacy dialect (hex, tet, a
  pressure group) and with ``quadratic=True``; and the face-claiming defect
  of ``ADVICE.md`` (a face is claimed for a group only when all four of its
  corners lie in that group, so the side-wall faces of the lid's element
  layer, whose corners span the walls and lid groups, get no row): the port
  keeps it as the JAX package has it, and the test counts the missing faces;
* the tet rules (1, 4, 5 points) and the P1 tet shapes bit for bit, and the
  same ``ValueError`` for other rules and node counts;
* ``PoissonSolver`` on a tet ``.unv`` deck (the unit cube, six tets a hex)
  against the JAX solver to 1e-12 of max|u| with equal CG counts;
* a ``.neu``-imported ``cube_hex_mesh(4)`` through the explicit solver in
  F64 on the XLA structured path against the JAX solver on the same file:
  3 steps, u within 1e-12 and p within 1e-11 of their largest values, the
  sub-iteration and CG counts equal (``tests/test_torch_xla_solvers.py``'s
  bounds).
"""

import jax
import numpy as np
import pytest
import torch

from cfd_with_cuda_tpu.fem.quadrature import gauss_quadrature as jax_gauss_quadrature
from cfd_with_cuda_tpu.fem.quadrature import gauss_quadrature_tet as jax_gauss_quadrature_tet
from cfd_with_cuda_tpu.fem.shape import shape_functions as jax_shape_functions
from cfd_with_cuda_tpu.mesh import converters as jconv
from cfd_with_cuda_tpu.solvers.explicit_bch import ExplicitBCHSolver as JaxExplicit
from cfd_with_cuda_tpu.solvers.poisson import PoissonSolver as JaxPoisson
from cfd_with_cuda_tpu.utils.config import SolverConfig as JaxConfig
from cfd_with_cuda_tpu_torch.fem.quadrature import gauss_quadrature, gauss_quadrature_tet
from cfd_with_cuda_tpu_torch.fem.shape import HEX_FACE_CORNERS, shape_functions
from cfd_with_cuda_tpu_torch.mesh import converters as tconv
from cfd_with_cuda_tpu_torch.mesh.generators import cube_hex_mesh
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.solvers.poisson import PoissonSolver, mms_solution
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

# inverse of converters.GAMBIT_HEX_TO_DECK: deck-order hex -> Gambit order
DECK_HEX_TO_GAMBIT = np.array([0, 1, 4, 5, 3, 2, 7, 6])
# six tets a hex around the diagonal 0-6: translated hexes split alike meet conformingly
HEX_TO_TETS = np.array([(0, 1, 2, 6), (0, 1, 5, 6), (0, 3, 2, 6), (0, 3, 7, 6), (0, 4, 5, 6),
                        (0, 4, 7, 6)])
DECK_FIELDS = ("dialect", "title", "etype", "ne", "ncn", "nn", "nenv", "nenp", "ngp",
               "max_iter", "tolerance", "t_ini", "solver_iter_max", "solver_tol", "density",
               "viscosity", "coords", "conn", "bc_type", "bc_str", "bc_vel_faces",
               "bc_out_faces", "bc_vel_nodes", "bc_pres_nodes", "zero_pressure_node", "dt",
               "t_final", "convergence_criteria", "monitor_xyz")
JAX_TOL = 1e-12
STAT_FIELDS = ("u_mon", "v_mon", "w_mon", "p_mon", "max_acc", "iters", "cg_iters")


def _write_neu(path, coords, conn, node_groups, face_groups=()):
    """A Gambit neutral file (tests/test_converters.py's writer with several
    groups): ``node_groups`` name -> node ids, ``face_groups`` (name, [(elem,
    face 1-based), ...]) in Gambit's face numbering."""
    out = ["        CONTROL INFO 2.4.6", "** GAMBIT NEUTRAL FILE", "test mesh",
           "PROGRAM:                Gambit     VERSION:  2.4.6", " today",
           "     NUMNP     NELEM     NGRPS    NBSETS     NDFCD     NDFVL",
           f"{len(coords):10d}{len(conn):10d}{1:10d}"
           f"{len(node_groups) + len(face_groups):10d}{3:10d}{3:10d}",
           "ENDOFSECTION", "   NODAL COORDINATES 2.4.6"]
    for i, (x, y, z) in enumerate(coords):
        out.append(f"{i + 1:10d}{x:20.11e}{y:20.11e}{z:20.11e}")
    out += ["ENDOFSECTION", "      ELEMENTS/CELLS 2.4.6"]
    for e, row in enumerate(conn):
        if len(row) == 8:           # deck order -> Gambit brick order
            row = np.asarray(row)[DECK_HEX_TO_GAMBIT]
        nodes = "".join(f"{v + 1:8d}" for v in row)
        out.append(f"{e + 1:8d} {4 if len(row) == 8 else 6:2d} {len(row):2d} {nodes}")
    out.append("ENDOFSECTION")
    for name, nodes in node_groups.items():
        out += ["       BOUNDARY CONDITIONS 2.4.6", f"{name:>32s}{0:8d}{len(nodes):8d}{0:8d}{6:8d}"]
        out += [f"{nid + 1:10d}" for nid in nodes]
        out.append("ENDOFSECTION")
    for name, pairs in face_groups:
        out += ["       BOUNDARY CONDITIONS 2.4.6", f"{name:>32s}{1:8d}{len(pairs):8d}{0:8d}{6:8d}"]
        out += [f"{e + 1:10d}{4:10d}{f:10d}" for e, f in pairs]
        out.append("ENDOFSECTION")
    path.write_text("\n".join(out))


def _write_unv(path, coords, conn, groups, fe_type=111, surface=None):
    """An IDEAS universal file (tests/test_converters.py's writer with several
    groups, any volume type, and optionally one surface element first)."""
    out = ["    -1", "  2411"]
    for i, (x, y, z) in enumerate(coords):
        out.append(f"{i + 1:10d}{1:10d}{1:10d}{11:10d}")
        out.append(f"  {x:.16e}  {y:.16e}  {z:.16e}")
    out += ["    -1", "    -1", "  2412"]
    rows = ([(91, surface)] if surface is not None else []) + [(fe_type, r) for r in conn]
    for e, (t, row) in enumerate(rows):
        out.append(f"{e + 1:10d}{t:10d}{2:10d}{1:10d}{7:10d}{len(row):10d}")
        out.append("".join(f"{v + 1:10d}" for v in row))
    out += ["    -1", "    -1", "  2467"]
    for g, (name, group) in enumerate(groups.items()):
        out.append(f"{g + 1:10d}{0:10d}{0:10d}{0:10d}{0:10d}{0:10d}{0:10d}{len(group):10d}")
        out.append(name)
        for k in range(0, len(group), 2):
            out.append("".join(f"{7:10d}{v + 1:10d}{0:10d}{0:10d}" for v in group[k:k + 2]))
    out.append("    -1")
    path.write_text("\n".join(out))


def _tet_cube(n):
    """The unit cube, n elements an edge, six positively oriented tets a hex."""
    coords, hexes = cube_hex_mesh(n + 1)
    conn = hexes[:, HEX_TO_TETS].reshape(-1, 4)
    x = coords[conn]
    flip = np.linalg.det(x[:, 1:] - x[:, :1]) < 0
    conn[flip] = conn[flip][:, [0, 2, 1, 3]]
    return coords, conn


def _boundary(coords):
    return np.flatnonzero((np.isclose(coords, 0.0) | np.isclose(coords, 1.0)).any(axis=1))


def _cavity_groups(coords):
    """Walls without the lid's nodes, then the lid (tests/test_converters.py:110-140)."""
    lid = np.flatnonzero(np.isclose(coords[:, 2], 1.0))
    walls = np.setdiff1d(_boundary(coords), lid)
    return {"walls": walls, "lid": lid}


def _same_mesh(a, b):
    (ca, ka, ga), (cb, kb, gb) = a, b
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(ka, kb)
    assert ka.dtype == kb.dtype and ca.dtype == cb.dtype
    assert list(ga) == list(gb)
    for name in ga:
        np.testing.assert_array_equal(ga[name], gb[name], err_msg=name)


def _same_deck(a, b):
    for f in DECK_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray) or isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f
        else:
            assert va == vb, f
    assert a.nnp == b.nnp


# ---------------------------------------------------------------- readers

@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_read_neu_matches_jax(tmp_path, kind):
    if kind == "hex":
        coords, conn = cube_hex_mesh(4, cluster=1.5)
        # Gambit faces 1 and 6 of two elements (bottom, top of deck order)
        faces = ("wall", [(0, 1), (5, 1), (len(conn) - 1, 6)])
    else:
        coords, conn = _tet_cube(2)
        faces = ("wall", [(0, 1), (3, 2), (7, 4)])
    inlet = np.flatnonzero(np.isclose(coords[:, 0], 0.0))
    outlet = np.flatnonzero(np.isclose(coords[:, 0], 1.0))[::-1]
    p = tmp_path / "m.neu"
    _write_neu(p, coords, conn, {"inlet": inlet, "outlet": outlet}, [faces])
    mesh = tconv.read_neu(p)
    _same_mesh(mesh, jconv.read_neu(p))
    np.testing.assert_array_equal(mesh[1], conn)
    np.testing.assert_allclose(mesh[0], coords, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(mesh[2]["outlet"], np.sort(outlet))


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_read_unv_matches_jax(tmp_path, kind):
    coords, conn = _tet_cube(2) if kind == "tet" else cube_hex_mesh(3)
    groups = {"wall": _boundary(coords), "inlet": np.flatnonzero(np.isclose(coords[:, 0], 0))}
    p = tmp_path / "m.unv"
    _write_unv(p, coords, conn, groups, fe_type=111 if kind == "tet" else 115,
               surface=conn[0, :3])
    mesh = tconv.read_unv(p)
    _same_mesh(mesh, jconv.read_unv(p))
    np.testing.assert_array_equal(mesh[0], coords)
    np.testing.assert_array_equal(mesh[1], conn)


def test_read_neu_missing_section_raises(tmp_path):
    p = tmp_path / "bad.neu"
    p.write_text("not a neutral file\n")
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="NUMNP"):
            mod.read_neu(p)


# ---------------------------------------------------------------- deck_from_mesh

def _decks(coords, conn, groups, table, group_bc, **kw):
    return (tconv.deck_from_mesh(coords, conn, groups, table, group_bc, **kw),
            jconv.deck_from_mesh(coords, conn, groups, table, group_bc, **kw))


@pytest.mark.parametrize("case", ["legacy_hex", "legacy_tet", "pressure_group", "quadratic"])
def test_deck_from_mesh_matches_jax(case):
    if case == "legacy_tet":
        coords, conn = _tet_cube(2)
    else:
        coords, conn = cube_hex_mesh(4, cluster=1.0)
    groups = _cavity_groups(coords)
    table = [(1.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 0.0, 0.0))]
    group_bc = {"walls": 0, "lid": 1}
    kw = dict(title=f"case {case}", viscosity=0.01, density=1.2)
    if case == "pressure_group":
        groups["outlet"] = np.flatnonzero(np.isclose(coords[:, 0], 1.0))
        groups["ignored"] = np.arange(3)
        table.append((2.0, (0.0, 0.0, 0.0)))
        group_bc["outlet"] = 2
    if case == "quadratic":
        kw["quadratic"] = True
    ours, theirs = _decks(coords, conn, groups, table, group_bc, **kw)
    _same_deck(ours, theirs)
    want = {"legacy_hex": (3, 8, 8), "legacy_tet": (4, 4, 4), "pressure_group": (3, 8, 8),
            "quadratic": (1, 27, 8)}[case]
    assert (ours.etype, ours.nenv, ours.ngp) == want
    if case == "pressure_group":
        assert ours.zero_pressure_node == groups["outlet"][0]
        assert len(ours.bc_pres_nodes) == len(groups["outlet"])
    if case == "legacy_tet":
        assert len(ours.bc_vel_faces) == 0          # faces are reconstructed for hexes only


def test_deck_from_mesh_quadratic_needs_hexes():
    coords, conn = _tet_cube(1)
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="8-node hex"):
            mod.deck_from_mesh(coords, conn, {"w": _boundary(coords)}, [(1.0, (0, 0, 0))],
                               {"w": 0}, quadratic=True)


def test_face_claiming_seam_defect_kept():
    """ADVICE.md item one, kept on purpose as the JAX package has it: with the
    walls group excluding the lid's nodes, the side-wall faces of the lid's
    element layer (two corners in each group) are claimed by neither group,
    so after promotion their mid-face and vertical mid-edge nodes carry no
    velocity BC.  Both packages drop the same 4 n faces."""
    n = 4
    coords, conn = cube_hex_mesh(n + 1)
    groups = _cavity_groups(coords)
    table = [(1.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 0.0, 0.0))]
    ours, theirs = _decks(coords, conn, groups, table, {"walls": 0, "lid": 1}, quadratic=True)
    _same_deck(ours, theirs)
    # every boundary face of the box: its 4 corners on one cube face
    fc = coords[conn[:, HEX_FACE_CORNERS]]                       # (NE, 6, 4, 3)
    on_plane = ((np.isclose(fc, 0.0) | np.isclose(fc, 1.0)).all(axis=2)).any(axis=2)
    boundary_faces = int(on_plane.sum())
    assert boundary_faces == 6 * n * n
    claimed = {(int(e), int(f)) for e, f, _ in ours.bc_vel_faces}
    assert len(claimed) == len(ours.bc_vel_faces) == boundary_faces - 4 * n
    e, f = np.nonzero(on_plane)
    missing = [(a, b) for a, b in zip(e.tolist(), f.tolist()) if (a, b) not in claimed]
    # each missing face is a side face spanning the top grid plane and the one below
    for e_, f_ in missing:
        z = coords[conn[e_, HEX_FACE_CORNERS[f_]], 2]
        assert np.isclose(z.max(), 1.0) and z.min() < 1.0


# ---------------------------------------------------------------- tet element

@pytest.mark.parametrize("ngp", [1, 4, 5])
def test_tet_rules_and_shapes_match_jax(ngp):
    pts, wts = gauss_quadrature_tet(ngp)
    jpts, jwts = jax_gauss_quadrature_tet(ngp)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(wts, jwts)
    for a, b in zip(gauss_quadrature(2, ngp), jax_gauss_quadrature(2, ngp)):
        np.testing.assert_array_equal(a, b)
    assert abs(wts.sum() - 1.0 / 6.0) < 1e-15
    S, dS = shape_functions(2, 4, pts)
    jS, jdS = jax_shape_functions(2, 4, jpts)
    np.testing.assert_array_equal(S, jS)
    np.testing.assert_array_equal(dS, jdS)
    np.testing.assert_allclose(S.sum(axis=1), 1.0, rtol=0, atol=1e-15)


@pytest.mark.parametrize("call", ["rule_2", "rule_8", "etype_3", "tet_nen_10", "shape_etype_5"])
def test_element_errors_match_jax(call):
    args = {"rule_2": (gauss_quadrature, jax_gauss_quadrature, (2, 2)),
            "rule_8": (gauss_quadrature, jax_gauss_quadrature, (2, 8)),
            "etype_3": (gauss_quadrature, jax_gauss_quadrature, (3, 8)),
            "tet_nen_10": (shape_functions, jax_shape_functions, (2, 10, np.zeros((1, 3)))),
            "shape_etype_5": (shape_functions, jax_shape_functions, (5, 4, np.zeros((1, 3))))}
    ours, theirs, a = args[call]
    with pytest.raises(ValueError) as e_ours:
        ours(*a)
    with pytest.raises(ValueError) as e_jax:
        theirs(*a)
    assert str(e_ours.value) == str(e_jax.value)


# ---------------------------------------------------------------- tet Poisson

@pytest.mark.parametrize("n", [3, 6])
def test_tet_unv_poisson_matches_jax(tmp_path, n):
    coords, conn = _tet_cube(n)
    p = tmp_path / "cube.unv"
    _write_unv(p, coords, conn, {"wall": _boundary(coords)})
    table, group_bc = [(1.0, (0.0, 0.0, 0.0))], {"wall": 0}
    deck = tconv.deck_from_mesh(*tconv.read_unv(p), table, group_bc)
    jdeck = jconv.deck_from_mesh(*jconv.read_unv(p), table, group_bc)
    assert (deck.etype, deck.nenv, deck.ngp) == (4, 4, 4)
    ours, theirs = PoissonSolver(deck, device="cpu"), JaxPoisson(jdeck)
    np.testing.assert_array_equal(ours.tab.gq_factor, theirs.tab.gq_factor)
    assert (ours.tab.det_jacob > 0).all()
    np.testing.assert_allclose(ours.tab.gq_factor.sum(), 1.0, rtol=1e-13)
    for source in ("mms", lambda x: 1.0 + x[:, 0]):
        u, it, res = ours.solve(source)
        ju, jit_, jres = theirs.solve(source)
        assert it == jit_
        assert np.abs(u - ju).max() <= JAX_TOL * np.abs(ju).max()


def test_tet_poisson_mms_converges():
    """P1 tets: the nodal MMS error falls ~4x when h halves (n = 4 -> 8: 3.2x)."""
    errs = []
    for n in (4, 8):
        coords, conn = _tet_cube(n)
        deck = tconv.deck_from_mesh(coords, conn, {"wall": _boundary(coords)},
                                    [(1.0, (0.0, 0.0, 0.0))], {"wall": 0})
        u, _, _ = PoissonSolver(deck, device="cpu").solve("mms")
        errs.append(np.abs(u - mms_solution(coords)).max())
    assert errs[0] / errs[1] > 3.0


# ---------------------------------------------------------------- .neu into the explicit solver

@pytest.fixture(scope="module")
def neu_cavity(tmp_path_factory):
    """A .neu of cube_hex_mesh(4), imported by both packages as the Q2/Q1 cavity
    of tests/test_converters.py:110-157 (walls first, the lid wins the edges)."""
    coords, conn = cube_hex_mesh(4)
    p = tmp_path_factory.mktemp("neu") / "cavity.neu"
    _write_neu(p, coords, conn, _cavity_groups(coords))
    table = [(1.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 0.0, 0.0))]
    decks = []
    for mod in (tconv, jconv):
        deck = mod.deck_from_mesh(*mod.read_neu(p), table, {"walls": 0, "lid": 1},
                                  viscosity=0.1, quadratic=True)
        deck.dt, deck.t_final, deck.zero_pressure_node = 0.005, 1.0, 0
        deck.max_iter, deck.tolerance, deck.convergence_criteria = 4, 1e-3, 1e-6
        decks.append(deck)
    return decks


def test_neu_import_explicit_f64_matches_jax(neu_cavity):
    deck, jdeck = neu_cavity
    _same_deck(deck, jdeck)
    js = JaxExplicit(jdeck, JaxConfig(steps_per_chunk=5, setup_cache="off"))
    ts = ExplicitBCHSolver(deck, SolverConfig(steps_per_chunk=5), device="cpu")
    assert js.structured and ts.xla and ts.layout == js.layout == "interleaved"
    step = jax.jit(js._time_step)
    st, rows = js.initial_state(), []
    for _ in range(3):
        st, stats = step(js.d, st)
        rows.append([float(getattr(stats, f)) for f in STAT_FIELDS])
    cuda_lib.reset_launch_counts()
    state, hist = ts.run(n_steps=3)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())
    ours = np.asarray([[h[f] for f in STAT_FIELDS] for h in hist])
    np.testing.assert_array_equal(ours[:, 5:], np.asarray(rows)[:, 5:])
    u, p = ts.fields(state)
    ju, jp = js.fields(st)
    assert np.abs(u - ju).max() <= JAX_TOL * np.abs(ju).max()
    assert np.abs(p - jp).max() <= 1e-11 * np.abs(jp).max()
    # the lid drives the flow; the walls hold it
    assert np.abs(u).max() == pytest.approx(1.0) and np.abs(u[:, 1]).max() > 0
