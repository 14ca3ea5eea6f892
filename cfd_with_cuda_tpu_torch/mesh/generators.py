"""Structured hexahedral mesh generators (cube / cavity / channel / duct).

Rebuilds the reference's MATLAB tooling
(``oldFiles/meshGenerators&Converters/cavityMeshGenerator.m``,
``HexaMeshGeneratorInACube_GeneratesCornerNodes.m``,
``HexaMeshGeneratorInAChannel...m``) as numpy functions producing the same
deck data: corner coordinates, 8-node connectivity, face-based velocity BC
tables, zero-pressure node, monitor point.  The sinh() wall clustering of
``cavityMeshGenerator.m:48-60`` is reproduced exactly.  Port of the cube,
cavity, channel, bending-duct, Kovasznay and backward-facing step part of
``cfd_with_cuda_tpu/mesh/generators.py``.
"""

from __future__ import annotations

import numpy as np

from cfd_with_cuda_tpu_torch.io.deck import Deck

__all__ = [
    "clustered_axis", "cube_hex_mesh", "cavity_deck", "box_cavity_deck", "channel_deck",
    "bending_duct_deck", "kovasznay_deck", "bfs_deck",
]


def clustered_axis(n_nodes: int, length: float = 1.0, cluster: float = 0.0) -> np.ndarray:
    """1D node coordinates on [0, L], sinh-clustered toward both ends.

    Mirrors ``cavityMeshGenerator.m:42-60``: for cluster == 0 the spacing is
    uniform; otherwise the first half follows L/2 * sinh(c*x)/sinh(c) and the
    second half is its mirror image (requires odd n_nodes for an exact
    mirror, like the MATLAB tool's prompt).
    """
    if cluster == 0.0:
        return np.linspace(0.0, length, n_nodes)
    half = (n_nodes + 1) // 2
    xx = np.arange(half) / ((n_nodes - 1) / 2.0)
    coord = np.empty(n_nodes)
    coord[:half] = length / 2.0 / np.sinh(cluster) * np.sinh(cluster * xx)
    coord[half:] = length - coord[: n_nodes - half][::-1]
    return coord


def cube_hex_mesh(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    lengths=(1.0, 1.0, 1.0),
    cluster: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Structured hex mesh of a box: returns (coords (NCN,3), conn (NE,8)).

    ``nx/ny/nz`` are *node* counts per direction.  Node numbering is
    x-fastest, then y, then z (the ordering the reference decks use); the
    element corner ordering matches the reference hexahedron (bottom face
    counter-clockwise, then top face).
    """
    ny = ny or nx
    nz = nz or nx
    xs = clustered_axis(nx, lengths[0], cluster)
    ys = clustered_axis(ny, lengths[1], cluster)
    zs = clustered_axis(nz, lengths[2], cluster)

    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def nid(i, j, k):  # node id at (x-index i, y-index j, z-index k)
        return (k * ny + j) * nx + i

    ex, ey, ez = nx - 1, ny - 1, nz - 1
    I, J, K = np.meshgrid(
        np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij"
    )
    i, j, k = I.ravel(order="F"), J.ravel(order="F"), K.ravel(order="F")
    # order="F" on the (ex, ey, ez) meshgrid gives x-fastest element order.
    conn = np.stack(
        [
            nid(i, j, k),
            nid(i + 1, j, k),
            nid(i + 1, j + 1, k),
            nid(i, j + 1, k),
            nid(i, j, k + 1),
            nid(i + 1, j, k + 1),
            nid(i + 1, j + 1, k + 1),
            nid(i, j + 1, k + 1),
        ],
        axis=-1,
    ).astype(np.int64)
    return coords, conn


def _boundary_faces(ne_xyz: tuple[int, int, int]) -> dict[str, np.ndarray]:
    """(elem, face) pairs for each of the 6 box boundaries.

    Face numbering follows ``HEX_FACE_CORNERS``: 0 bottom (z-), 1 front
    (y-), 2 right (x+), 3 back (y+), 4 left (x-), 5 top (z+).
    """
    ex, ey, ez = ne_xyz

    def eid(i, j, k):
        return (k * ey + j) * ex + i

    J, K = np.meshgrid(np.arange(ey), np.arange(ez), indexing="ij")
    I2, K2 = np.meshgrid(np.arange(ex), np.arange(ez), indexing="ij")
    I3, J3 = np.meshgrid(np.arange(ex), np.arange(ey), indexing="ij")
    return {
        "xmin": np.stack([eid(0, J, K).ravel(), np.full(ey * ez, 4)], -1),
        "xmax": np.stack([eid(ex - 1, J, K).ravel(), np.full(ey * ez, 2)], -1),
        "ymin": np.stack([eid(I2, 0, K2).ravel(), np.full(ex * ez, 1)], -1),
        "ymax": np.stack([eid(I2, ey - 1, K2).ravel(), np.full(ex * ez, 3)], -1),
        "zmin": np.stack([eid(I3, J3, 0).ravel(), np.full(ex * ey, 0)], -1),
        "zmax": np.stack([eid(I3, J3, ez - 1).ravel(), np.full(ex * ey, 5)], -1),
    }


def cavity_deck(
    n_elem: int,
    *,
    cluster: float = 0.0,
    lid_velocity=(1.0, 0.0, 0.0),
    dt: float = 0.001,
    t_final: float = 1.0,
    max_iter: int = 4,
    tolerance: float = 1e-3,
    convergence: float = 1e-6,
    density: float = 1.0,
    viscosity: float = 0.01,
    ngp: int = 8,
) -> Deck:
    """3D lid-driven cavity deck: n_elem^3 hexes, lid at z=zmax moving in +x.

    Matches the canonical ``lidDrivenCavity_NE27000.inp`` setup: BC 1 is the
    no-slip walls, BC 2 the moving lid; the zero-pressure node sits at the
    center of the bottom face; monitor point at the cavity center.
    """
    nx = n_elem + 1
    coords, conn = cube_hex_mesh(nx, cluster=cluster)
    fb = _boundary_faces((n_elem, n_elem, n_elem))
    walls = np.concatenate([fb[k] for k in ("zmin", "ymin", "xmax", "ymax", "xmin")])
    lid = fb["zmax"]
    vel_faces = np.concatenate(
        [
            np.column_stack([walls, np.zeros(len(walls), dtype=np.int64)]),
            np.column_stack([lid, np.ones(len(lid), dtype=np.int64)]),
        ]
    ).astype(np.int64)

    # Zero-pressure node: corner node nearest the bottom-face center,
    # matching the NE27000 deck's node 481 (0.5, 0.5, 0).
    target = np.array([0.5, 0.5, 0.0])
    zp = int(np.argmin(((coords - target) ** 2).sum(axis=1)))

    deck = Deck(dialect="fractional", title=f"3D Lid-driven cavity {n_elem}^3")
    deck.etype = 1
    deck.ne = n_elem**3
    deck.ncn = nx**3
    deck.nenv, deck.nenp, deck.ngp = 27, 8, ngp
    deck.alpha = 1.0
    deck.dt = dt
    deck.t_ini = 0.0
    deck.t_final = t_final
    deck.max_iter = max_iter
    deck.tolerance = tolerance
    deck.convergence_criteria = convergence
    deck.density = density
    deck.viscosity = viscosity
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0, 1.0])
    deck.bc_str = np.array([[0.0, 0.0, 0.0], list(lid_velocity)])
    deck.bc_vel_faces = vel_faces
    deck.zero_pressure_node = zp
    deck.monitor_xyz = np.array([0.5, 0.5, 0.5])
    return deck


def box_cavity_deck(
    ne_xyz=(5, 3, 4),
    lengths=(1.0, 0.6, 0.8),
    *,
    lid_velocity=(1.0, 0.3, 0.0),
    zero_pressure_xyz=(0.3, 0.2, 0.0),
    monitor_xyz=(0.5, 0.3, 0.4),
    **kw,
) -> Deck:
    """:func:`cavity_deck` on a box of ``ne_xyz`` elements and ``lengths``
    (uniform spacing): the same walls, the lid at z = zmax moving at
    ``lid_velocity``, the zero-pressure node the corner node nearest
    ``zero_pressure_xyz``.  The default is a 5 x 3 x 4-element box, whose
    coarse parity shifts differ by axis (a cube's are symmetric)."""
    ex, ey, ez = ne_xyz
    deck = cavity_deck(max(ne_xyz), lid_velocity=lid_velocity, **kw)
    coords, conn = cube_hex_mesh(ex + 1, ey + 1, ez + 1, lengths=lengths)
    fb = _boundary_faces((ex, ey, ez))
    walls = np.concatenate([fb[k] for k in ("zmin", "ymin", "xmax", "ymax", "xmin")])
    lid = fb["zmax"]
    deck.title = f"3D Lid-driven cavity {ex}x{ey}x{ez}"
    deck.coords, deck.conn = coords, conn
    deck.ne, deck.ncn = conn.shape[0], coords.shape[0]
    deck.bc_vel_faces = np.concatenate([
        np.column_stack([walls, np.zeros(len(walls), np.int64)]),
        np.column_stack([lid, np.ones(len(lid), np.int64)]),
    ]).astype(np.int64)
    deck.zero_pressure_node = int(np.argmin(((coords - np.asarray(zero_pressure_xyz)) ** 2)
                                            .sum(axis=1)))
    deck.monitor_xyz = np.asarray(monitor_xyz, dtype=np.float64)
    return deck


def channel_deck(
    ne_x: int,
    ne_y: int,
    ne_z: int,
    *,
    lengths=(10.0, 1.0, 1.0),
    cluster: float = 0.0,
    inlet_velocity=(1.0, 0.0, 0.0),
    dt: float = 0.001,
    t_final: float = 1.0,
    max_iter: int = 4,
    tolerance: float = 1e-3,
    convergence: float = 1e-6,
    density: float = 1.0,
    viscosity: float = 0.01,
    inlet_profile: str | None = None,
) -> Deck:
    """Rectangular channel/duct deck: inflow at x=0, outflow at x=L, no-slip
    walls (rebuilds ``HexaMeshGeneratorInAChannel...m``).

    ``inlet_profile="duct_developed"`` replaces the plug inlet with the
    reference's fully-developed separable profile (mean = |inlet_velocity|;
    ``blascoCodinaHuerta.cpp:4086-4102``); ``"duct_series"`` uses the exact
    analytic series profile (mesh/profiles.py).  Outflow faces carry the
    natural (do-nothing) BC: their nodes are simply absent from the
    velocity-BC set, exactly as in the reference (which parses
    ``BCoutFaces`` at :684-693 and never constrains them).
    """
    coords, conn = cube_hex_mesh(
        ne_x + 1, ne_y + 1, ne_z + 1, lengths=lengths, cluster=cluster
    )
    fb = _boundary_faces((ne_x, ne_y, ne_z))
    walls = np.concatenate([fb[k] for k in ("zmin", "zmax", "ymin", "ymax")])
    inlet = fb["xmin"]
    outlet = fb["xmax"]
    vel_faces = np.concatenate(
        [
            np.column_stack([walls, np.zeros(len(walls), dtype=np.int64)]),
            np.column_stack([inlet, np.ones(len(inlet), dtype=np.int64)]),
        ]
    ).astype(np.int64)
    out_faces = np.column_stack(
        [outlet, np.full(len(outlet), 2, dtype=np.int64)]
    ).astype(np.int64)

    target = np.array([lengths[0], lengths[1] / 2, lengths[2] / 2])
    zp = int(np.argmin(((coords - target) ** 2).sum(axis=1)))

    deck = Deck(dialect="fractional", title=f"3D channel {ne_x}x{ne_y}x{ne_z}")
    deck.etype = 1
    deck.ne = ne_x * ne_y * ne_z
    deck.ncn = (ne_x + 1) * (ne_y + 1) * (ne_z + 1)
    deck.nenv, deck.nenp, deck.ngp = 27, 8, 8
    deck.alpha = 1.0
    deck.dt = dt
    deck.t_ini = 0.0
    deck.t_final = t_final
    deck.max_iter = max_iter
    deck.tolerance = tolerance
    deck.convergence_criteria = convergence
    deck.density = density
    deck.viscosity = viscosity
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0, 1.0, 3.0])
    deck.bc_str = np.array([[0.0, 0.0, 0.0], list(inlet_velocity), [0.0, 0.0, 0.0]])
    deck.bc_vel_faces = vel_faces
    deck.bc_out_faces = out_faces
    deck.zero_pressure_node = zp
    deck.monitor_xyz = np.array([lengths[0] / 2, lengths[1] / 2, lengths[2] / 2])
    if inlet_profile is not None:
        # (kind, bc_index=1 (inlet), axis=0 (x flow), scale=mean speed)
        deck.inlet_profile = (
            inlet_profile, 1, 0, float(np.abs(inlet_velocity[0]))
        )
    return deck


def bending_duct_deck(
    ne_s: int = 48,
    ne_y: int = 32,
    ne_z: int = 32,
    *,
    r_mean: float = 2.3,
    inlet_len: float = 2.0,
    outlet_len: float = 2.0,
    cluster: float = 0.0,
    inlet_velocity: float = 1.0,
    dt: float = 0.002,
    t_final: float = 20.0,
    max_iter: int = 4,
    tolerance: float = 1e-3,
    convergence: float = 1e-6,
    density: float = 1.0,
    viscosity: float = 0.01,
    inlet_profile: str | None = "duct_developed",
) -> Deck:
    """90-degree bending square duct (the reference's stripped
    ``bendingSquareDuct_49x33x33.inp`` benchmark class,
    ``.MISSING_LARGE_BLOBS``; its fully-developed inlet survives as the
    commented profile at ``blascoCodinaHuerta.cpp:4086-4102`` — mean 1.0).

    Geometry (unit duct width D=1, all lengths in D): a straight inlet
    run of ``inlet_len`` along +x, a 90-degree circular bend of mean
    centerline radius ``r_mean`` turning the flow from +x to +y (the
    classic laminar Dean-/secondary-flow configuration, e.g. Humphrey,
    Taylor & Whitelaw 1977 used Rc/D = 2.3), then a straight outlet run
    of ``outlet_len`` along +y with natural outflow.  The bend is in the
    x-y plane; z is the vertical cross-section axis.  Streamwise
    stations are uniform in centerline arc length; ``cluster`` applies
    the cavity generator's sinh wall-clustering to both cross-section
    axes.

    The coordinates are curved, but the mesh is topologically a box: the
    solvers detect it as an element-structured box grid and take the box
    layouts (``structured="never"`` forces the unstructured path).
    ``ne_s, ne_y, ne_z = 48, 32, 32`` rebuilds the reference's
    49x33x33-node deck geometry.
    """
    if r_mean <= 0.5:
        raise ValueError("r_mean must exceed D/2 = 0.5 (inner radius > 0)")
    arc = 0.5 * np.pi * r_mean
    total = inlet_len + arc + outlet_len
    s = np.linspace(0.0, total, ne_s + 1)

    # centerline position c(s) and in-plane lateral normal n(s) such that
    # (tangent, n, z) is right-handed (positive Jacobians)
    cx = np.empty_like(s)
    cy = np.empty_like(s)
    nx_ = np.empty_like(s)
    ny_ = np.empty_like(s)
    a = s <= inlet_len
    cx[a] = s[a] - inlet_len
    cy[a] = 0.0
    nx_[a] = 0.0
    ny_[a] = 1.0
    b = (s > inlet_len) & (s < inlet_len + arc)
    phi = (s[b] - inlet_len) / r_mean
    cx[b] = r_mean * np.sin(phi)
    cy[b] = r_mean * (1.0 - np.cos(phi))
    nx_[b] = -np.sin(phi)
    ny_[b] = np.cos(phi)
    c = s >= inlet_len + arc
    cx[c] = r_mean
    cy[c] = r_mean + (s[c] - inlet_len - arc)
    nx_[c] = -1.0
    ny_[c] = 0.0

    # cross-section offsets: lateral r in [-1/2, 1/2], vertical z in [0, 1]
    r = clustered_axis(ne_y + 1, 1.0, cluster) - 0.5
    zs = clustered_axis(ne_z + 1, 1.0, cluster)

    # node ordering must match cube_hex_mesh: streamwise (i) fastest,
    # then lateral (j), then vertical (k)
    X = cx[None, None, :] + r[None, :, None] * nx_[None, None, :]
    Y = cy[None, None, :] + r[None, :, None] * ny_[None, None, :]
    Z = np.broadcast_to(zs[:, None, None], (ne_z + 1, ne_y + 1, ne_s + 1))
    coords = np.stack(
        [X + 0.0 * Z, Y + 0.0 * Z, Z + 0.0 * X], axis=-1
    ).reshape(-1, 3)

    # connectivity of the index-space box (ignore its coords)
    _, conn = cube_hex_mesh(ne_s + 1, ne_y + 1, ne_z + 1)

    fb = _boundary_faces((ne_s, ne_y, ne_z))
    walls = np.concatenate([fb[k] for k in ("zmin", "zmax", "ymin", "ymax")])
    inlet = fb["xmin"]
    outlet = fb["xmax"]
    vel_faces = np.concatenate(
        [
            np.column_stack([walls, np.zeros(len(walls), dtype=np.int64)]),
            np.column_stack([inlet, np.ones(len(inlet), dtype=np.int64)]),
        ]
    ).astype(np.int64)
    out_faces = np.column_stack(
        [outlet, np.full(len(outlet), 2, dtype=np.int64)]
    ).astype(np.int64)

    # zero-pressure pin at the outlet cross-section center
    target = np.array([r_mean, r_mean + outlet_len, 0.5])
    zp = int(np.argmin(((coords - target) ** 2).sum(axis=1)))

    deck = Deck(
        dialect="fractional",
        title=f"3D bending square duct {ne_s}x{ne_y}x{ne_z}",
    )
    deck.etype = 1
    deck.ne = ne_s * ne_y * ne_z
    deck.ncn = (ne_s + 1) * (ne_y + 1) * (ne_z + 1)
    deck.nenv, deck.nenp, deck.ngp = 27, 8, 8
    deck.alpha = 1.0
    deck.dt = dt
    deck.t_ini = 0.0
    deck.t_final = t_final
    deck.max_iter = max_iter
    deck.tolerance = tolerance
    deck.convergence_criteria = convergence
    deck.density = density
    deck.viscosity = viscosity
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0, 1.0, 3.0])
    deck.bc_str = np.array(
        [[0.0, 0.0, 0.0], [float(inlet_velocity), 0.0, 0.0], [0.0, 0.0, 0.0]]
    )
    deck.bc_vel_faces = vel_faces
    deck.bc_out_faces = out_faces
    deck.zero_pressure_node = zp
    # monitor at the mid-bend cross-section center (phi = 45 deg), where
    # the secondary (Dean) circulation peaks
    deck.monitor_xyz = np.array(
        [
            r_mean * np.sin(np.pi / 4),
            r_mean * (1.0 - np.cos(np.pi / 4)),
            0.5,
        ]
    )
    if inlet_profile is not None:
        deck.inlet_profile = (inlet_profile, 1, 0, float(abs(inlet_velocity)))
    return deck


def kovasznay_deck(
    ne_x: int = 8,
    ne_y: int = 12,
    ne_z: int = 2,
    *,
    re: float = 40.0,
    dt: float = 0.05,
    t_final: float = 20.0,
    max_iter: int = 4,
    tolerance: float = 1e-3,
    convergence: float = 1e-7,
) -> Deck:
    """Kovasznay-flow MMS deck: the exact steady NS solution
    (``mesh.profiles.kovasznay_uv``) imposed as Dirichlet data on ALL
    boundary faces of the box [-0.5, 1] x [-0.5, 1.5] x [0, 0.25]
    (z-thin: the 2-D solution extends with w = 0, d/dz = 0).

    Running any integrator to steady state must reproduce the exact
    interior field to discretisation error — a full-NS manufactured-
    solution test WITH convection active, which none of the reference's
    benchmark decks provide (SURVEY.md section 4: the reference
    validates by eyeballing benchmark-deck Tecplot output only).
    """
    lengths = (1.5, 2.0, 0.25)
    coords, conn = cube_hex_mesh(
        ne_x + 1, ne_y + 1, ne_z + 1, lengths=lengths
    )
    coords = coords + np.array([-0.5, -0.5, 0.0])
    fb = _boundary_faces((ne_x, ne_y, ne_z))
    faces = np.concatenate([fb[k] for k in sorted(fb)])
    vel_faces = np.column_stack(
        [faces, np.zeros(len(faces), dtype=np.int64)]
    ).astype(np.int64)

    # zero-pressure pin at the (x_max, y_max, z=0) corner — NOT the
    # first corner: node id 0 means "no pin" in the reference's 1-based
    # deck convention, which would leave the all-Neumann Z singular.
    # The exact p there is known (p = (1 - exp(2 lam x)) / 2), so the
    # pin only fixes the additive constant.
    zp = int(np.argmin(((coords - np.array([1.0, 1.5, 0.0])) ** 2).sum(axis=1)))
    assert zp > 0

    deck = Deck(
        dialect="fractional",
        title=f"Kovasznay Re={re:g} {ne_x}x{ne_y}x{ne_z}",
    )
    deck.etype = 1
    deck.ne = ne_x * ne_y * ne_z
    deck.ncn = (ne_x + 1) * (ne_y + 1) * (ne_z + 1)
    deck.nenv, deck.nenp, deck.ngp = 27, 8, 8
    deck.alpha = 1.0
    deck.dt = dt
    deck.t_ini = 0.0
    deck.t_final = t_final
    deck.max_iter = max_iter
    deck.tolerance = tolerance
    deck.convergence_criteria = convergence
    deck.density = 1.0
    deck.viscosity = 1.0 / re
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0])
    deck.bc_str = np.array([[0.0, 0.0, 0.0]])
    deck.bc_vel_faces = vel_faces
    deck.zero_pressure_node = zp
    deck.monitor_xyz = np.array([0.25, 0.5, lengths[2] / 2])
    # full-vector exact-solution BC ("axis" slot carries Re)
    deck.inlet_profile = ("kovasznay", 0, float(re), 1.0)
    return deck


def bfs_deck(
    ne_x: int = 30,
    ne_y: int = 8,
    ne_z: int = 8,
    *,
    lengths=(15.0, 2.0, 2.0),
    step_frac=(0.2, 0.5),
    inlet_velocity: float = 1.0,
    dt: float = 0.002,
    t_final: float = 20.0,
    max_iter: int = 4,
    tolerance: float = 1e-3,
    convergence: float = 1e-6,
    density: float = 1.0,
    viscosity: float = 0.01,
    inlet_profile: str | None = "duct_developed",
) -> Deck:
    """Backward-facing step deck (the ``backwardFacingStepNE144600`` class
    from the reference's stripped large decks, ``.MISSING_LARGE_BLOBS``).

    Domain: x in [0, L], y in [0, H] wall-normal, z in [0, W] span.  The
    solid step occupies ``x < step_frac[0]*L`` and ``y < step_frac[1]*H``;
    flow enters at x=0 through the channel ABOVE the step (developed duct
    profile by default), expands over the step edge, and leaves at x=L
    (natural outflow — nodes absent from the velocity-BC set, like the
    reference's ``BCoutFaces``).  The mesh is a box grid with the step
    block of elements REMOVED and nodes compacted, so the resulting hex
    mesh is NOT a box grid: it exercises the unstructured ELL path of the
    fractional-step solvers at any size (ne defaults give 2,304 kept
    hexes; 96x40x40 rebuilds the NE144600 class).
    """
    ex, ey, ez = ne_x, ne_y, ne_z
    coords, conn = cube_hex_mesh(
        ex + 1, ey + 1, ez + 1, lengths=lengths,
    )
    # element-grid step mask (element (i,j,k) solid iff fully inside step)
    i_step = max(1, int(round(step_frac[0] * ex)))
    j_step = max(1, int(round(step_frac[1] * ey)))
    I, J, K = np.meshgrid(
        np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij"
    )
    # element order must match cube_hex_mesh: x-fastest (order="F")
    ei = I.ravel(order="F")
    ej = J.ravel(order="F")
    ek = K.ravel(order="F")
    keep = ~((ei < i_step) & (ej < j_step))

    keep3 = np.zeros((ex, ey, ez), bool)
    keep3[ei[keep], ej[keep], ek[keep]] = True

    # boundary faces of the kept region: a face is boundary iff the
    # neighbour element is absent (outside the grid or solid).  Face ids
    # follow HEX_FACE_CORNERS: 0 z-, 1 y-, 2 x+, 3 y+, 4 x-, 5 z+.
    def absent(di, dj, dk):
        nb = np.zeros_like(keep3)
        src = keep3
        sl_dst = [slice(None)] * 3
        sl_src = [slice(None)] * 3
        for ax, d in enumerate((di, dj, dk)):
            if d == 1:
                sl_dst[ax] = slice(0, -1)
                sl_src[ax] = slice(1, None)
            elif d == -1:
                sl_dst[ax] = slice(1, None)
                sl_src[ax] = slice(0, -1)
        nb[tuple(sl_dst)] = src[tuple(sl_src)]
        return keep3 & ~nb

    eid3 = -np.ones((ex, ey, ez), np.int64)
    eid3[ei[keep], ej[keep], ek[keep]] = np.arange(int(keep.sum()))

    face_dirs = [
        ((0, 0, -1), 0), ((0, -1, 0), 1), ((1, 0, 0), 2),
        ((0, 1, 0), 3), ((-1, 0, 0), 4), ((0, 0, 1), 5),
    ]
    inlet, outlet, walls = [], [], []
    for (di, dj, dk), face in face_dirs:
        ii, jj, kk = np.nonzero(absent(di, dj, dk))
        eids = eid3[ii, jj, kk]
        pairs = np.stack([eids, np.full(len(eids), face)], -1)
        if face == 4:
            is_in = ii == 0  # x- faces at the domain inlet plane
            inlet.append(pairs[is_in])
            walls.append(pairs[~is_in])  # step's vertical face
        elif face == 2:
            is_out = ii == ex - 1
            outlet.append(pairs[is_out])
            walls.append(pairs[~is_out])
        else:
            walls.append(pairs)
    inlet = np.concatenate(inlet)
    outlet = np.concatenate(outlet)
    walls = np.concatenate(walls)

    # compact nodes to those used by kept elements
    conn = conn[keep]
    used = np.zeros(coords.shape[0], bool)
    used[conn.ravel()] = True
    new_id = -np.ones(coords.shape[0], np.int64)
    new_id[used] = np.arange(int(used.sum()))
    conn = new_id[conn]
    coords = coords[used]

    vel_faces = np.concatenate(
        [
            np.column_stack([walls, np.zeros(len(walls), dtype=np.int64)]),
            np.column_stack([inlet, np.ones(len(inlet), dtype=np.int64)]),
        ]
    ).astype(np.int64)
    out_faces = np.column_stack(
        [outlet, np.full(len(outlet), 2, dtype=np.int64)]
    ).astype(np.int64)

    L, H, W = lengths
    target = np.array([L, H / 2, W / 2])
    zp = int(np.argmin(((coords - target) ** 2).sum(axis=1)))

    deck = Deck(
        dialect="fractional",
        title=f"3D backward-facing step {ne_x}x{ne_y}x{ne_z}",
    )
    deck.etype = 1
    deck.ne = int(keep.sum())
    deck.ncn = coords.shape[0]
    deck.nenv, deck.nenp, deck.ngp = 27, 8, 8
    deck.alpha = 1.0
    deck.dt = dt
    deck.t_ini = 0.0
    deck.t_final = t_final
    deck.max_iter = max_iter
    deck.tolerance = tolerance
    deck.convergence_criteria = convergence
    deck.density = density
    deck.viscosity = viscosity
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([1.0, 1.0, 3.0])
    deck.bc_str = np.array(
        [[0.0, 0.0, 0.0], [float(inlet_velocity), 0.0, 0.0], [0.0, 0.0, 0.0]]
    )
    deck.bc_vel_faces = vel_faces
    deck.bc_out_faces = out_faces
    deck.zero_pressure_node = zp
    # monitor just downstream of the step edge, behind the expansion
    # (the recirculation bubble the BFS benchmark is about)
    deck.monitor_xyz = np.array(
        [step_frac[0] * L + 0.15 * L, step_frac[1] * H / 2, W / 2]
    )
    if inlet_profile is not None:
        deck.inlet_profile = (inlet_profile, 1, 0, float(abs(inlet_velocity)))
    return deck
