"""Mesh-format converters: Gambit `.neu` and IDEAS `.unv` -> Deck.

Rebuilds the reference's MATLAB converter tooling
(``oldFiles/meshGenerators&Converters/neuToInp.m`` and ``unvToInp.m``) as
library functions.  The MATLAB tools are interactive and rely on fixed
line offsets; these parsers follow the documented section structure
instead (`ENDOFSECTION` markers in .neu, `-1`-delimited datasets 2411/
2412/2467 in .unv) so they survive format variations, while producing the
same legacy-dialect deck data (node-based BC tables).

Port of ``cfd_with_cuda_tpu/mesh/converters.py`` (numpy, host side): the
same parsers, permutation tables and deck fields.  Like the JAX package,
the face-BC reconstruction of :func:`deck_from_mesh` claims a hex face for
a node group only when all four of its corners lie in that group, so a
boundary face whose corners span two groups (a seam between mutually
exclusive groups) gets no face row and, after Q2 promotion, its mid-face
and mid-edge nodes no velocity BC.  Give node groups that share their seam
nodes where that matters.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cfd_with_cuda_tpu_torch.fem.shape import HEX_FACE_CORNERS
from cfd_with_cuda_tpu_torch.io.deck import Deck

__all__ = ["read_neu", "read_unv", "deck_from_mesh"]

# Gambit neutral-file brick nodes are numbered binary-counter style
# ((0,0,0),(1,0,0),(0,1,0),(1,1,0),...); the deck convention is the
# bottom-face loop then the top-face loop.  The reference converter writes
# hex connectivity as LtoG[[1,2,6,5,3,4,8,7]] (neuToInp.m:223-224); this is
# the same permutation, 0-based.
GAMBIT_HEX_TO_DECK = np.array([0, 1, 5, 4, 2, 3, 7, 6], dtype=np.int64)

# Gambit's own brick face->corner table (local 0-based, Gambit node order),
# used to resolve element/face-typed BOUNDARY CONDITIONS records *before*
# the connectivity is permuted into deck order.
GAMBIT_HEX_FACES = np.array(
    [
        (0, 1, 5, 4),
        (1, 3, 7, 5),
        (3, 2, 6, 7),
        (2, 0, 4, 6),
        (1, 0, 2, 3),
        (4, 5, 7, 6),
    ],
    dtype=np.int64,
)


def deck_from_mesh(
    coords: np.ndarray,
    conn: np.ndarray,
    bc_groups: dict[str, np.ndarray],
    bc_table: list[tuple[float, tuple[float, float, float]]],
    group_bc: dict[str, int],
    *,
    title: str = "converted mesh",
    viscosity: float = 1.0,
    density: float = 1.0,
    quadratic: bool = False,
) -> Deck:
    """Assemble a Deck from raw mesh + BC group data.

    ``bc_groups``: group name -> node ids; ``bc_table``: list of
    (bc_type, (vx, vy, vz)); ``group_bc``: group name -> index into
    bc_table.

    Default: the legacy equal-order dialect (etype 3 hex / 4 tet — the
    role of ``neuToInp.m``/``unvToInp.m``, feeding the legacy solvers).
    ``quadratic=True`` declares the fractionalStep Q2/Q1 hex pair
    instead (etype 1, NENv 27 / NENp 8 — the corner mesh is promoted to
    27-node elements inside the solver), so the SAME import runs the
    flagship explicit/implicit integrators.
    """
    nen = conn.shape[1]
    deck = Deck(dialect="legacy", title=title)
    deck.ne = conn.shape[0]
    deck.ncn = deck.nn = coords.shape[0]
    if quadratic:
        if nen != 8:
            raise ValueError("quadratic promotion needs 8-node hex input")
        deck.etype = 1
        deck.nenv, deck.nenp, deck.ngp = 27, 8, 8
    else:
        deck.etype = 3 if nen == 8 else 4
        deck.nenv = deck.nenp = nen
        deck.ngp = 8 if nen == 8 else 4
    deck.max_iter = 100
    deck.tolerance = 1e-6
    deck.t_ini = 0.0
    deck.solver_iter_max = 2000
    deck.solver_tol = 1e-10
    deck.density = density
    deck.viscosity = viscosity
    deck.coords = coords
    deck.conn = conn
    deck.bc_type = np.array([t for t, _ in bc_table])
    deck.bc_str = np.array([list(v) for _, v in bc_table])

    vel_rows = []
    pres_rows = []
    for name, nodes in bc_groups.items():
        if name not in group_bc:
            continue
        b = group_bc[name]
        btype = bc_table[b][0]
        rows = np.column_stack([nodes, np.full(nodes.size, b)])
        if btype == 2:      # pressure BC
            pres_rows.append(rows)
        else:               # velocity / wall
            vel_rows.append(rows)
    deck.bc_vel_nodes = (
        np.concatenate(vel_rows) if vel_rows else np.zeros((0, 2), np.int64)
    ).astype(np.int64)
    deck.bc_pres_nodes = (
        np.concatenate(pres_rows) if pres_rows else np.zeros((0, 2), np.int64)
    ).astype(np.int64)
    if len(deck.bc_pres_nodes):
        deck.zero_pressure_node = int(deck.bc_pres_nodes[0, 0])

    # Reconstruct FACE-typed velocity BCs from the node groups: a hex
    # face belongs to a group when all 4 of its corner nodes do.  The
    # fractional-step solvers consume ``bc_vel_faces`` (the reference's
    # deck dialect lists faces, ``blascoCodinaHuerta.cpp:1410-1580``) so
    # without this a converter-imported mesh could only feed the legacy
    # solvers; with it the SAME .neu/.unv import runs the flagship
    # explicit/implicit integrators (mid-edge/face nodes of the promoted
    # 27-node element inherit the BC through face_bc_to_node_bc).
    if nen == 8 and vel_rows:
        face_rows = []
        for name, nodes in bc_groups.items():
            b = group_bc.get(name)
            if b is None or bc_table[b][0] == 2:
                continue
            in_group = np.zeros(deck.nn, bool)
            in_group[np.asarray(nodes, np.int64)] = True
            fn = conn[:, HEX_FACE_CORNERS]                 # (NE, 6, 4)
            hit = in_group[fn].all(axis=2)                 # (NE, 6)
            e, f = np.nonzero(hit)
            face_rows.append(
                np.column_stack([e, f, np.full(e.size, b)])
            )
        if face_rows:
            deck.bc_vel_faces = np.concatenate(face_rows).astype(np.int64)
    return deck


# --------------------------------------------------------------------- .neu
def read_neu(path: str | Path):
    """Parse a Gambit neutral file.

    Returns (coords (NN,3), conn (NE,nen) 0-based, groups: name->node ids).
    Boundary-condition sections list (element, face) pairs; they are
    resolved to node sets through the element connectivity, like the
    MATLAB tool's face tables (neuToInp.m).
    """
    lines = Path(path).read_text().splitlines()
    i = 0

    def find(tag, start):
        for k in range(start, len(lines)):
            if tag in lines[k]:
                return k
        raise ValueError(f".neu file is missing section {tag!r}")

    hdr = find("NUMNP", 0)                     # column header line
    counts = lines[hdr + 1].split()
    nn, ne = int(counts[0]), int(counts[1])

    i = find("NODAL COORDINATES", 0)
    coords = np.empty((nn, 3))
    r = 0
    k = i + 1
    while r < nn:
        toks = lines[k].split()
        k += 1
        if not toks or "ENDOFSECTION" in lines[k - 1]:
            continue
        coords[int(toks[0]) - 1] = [float(t) for t in toks[1:4]]
        r += 1

    i = find("ELEMENTS/CELLS", k - 1)
    rows = []
    k = i + 1
    while len(rows) < ne:
        toks = lines[k].split()
        k += 1
        if not toks or "ENDOFSECTION" in lines[k - 1]:
            continue
        # GAMBIT: elem_id, type, nnodes, node ids... (may wrap lines)
        nodes = [int(t) for t in toks[3:]]
        want = int(toks[2])
        while len(nodes) < want:
            nodes.extend(int(t) for t in lines[k].split())
            k += 1
        rows.append(nodes[:want])
    conn = np.asarray(rows, dtype=np.int64) - 1

    # boundary-condition sections (resolved on the raw Gambit node order,
    # with Gambit's face tables — the connectivity is permuted afterwards)
    groups: dict[str, np.ndarray] = {}

    TET_FACES = np.array([[1, 0, 2], [0, 1, 3], [1, 2, 3], [2, 0, 3]])
    start = k - 1
    while True:
        try:
            i = find("BOUNDARY CONDITIONS", start)
        except ValueError:
            break
        hdr_toks = lines[i + 1].split()
        name = hdr_toks[0]
        itype = int(hdr_toks[1])           # 1 = element/face data, 0 = nodes
        count = int(hdr_toks[2])
        nodes = set()
        k = i + 2
        read = 0
        while read < count:
            toks = lines[k].split()
            k += 1
            if not toks:
                continue
            if itype == 0:
                nodes.add(int(toks[0]) - 1)
            else:
                e = int(toks[0]) - 1
                f = int(toks[2]) - 1
                table = GAMBIT_HEX_FACES if conn.shape[1] == 8 else TET_FACES
                nodes.update(int(x) for x in conn[e, table[f]])
            read += 1
        groups[name] = np.array(sorted(nodes), dtype=np.int64)
        start = k
    if conn.shape[1] == 8:
        conn = conn[:, GAMBIT_HEX_TO_DECK]
    return coords, conn, groups


# --------------------------------------------------------------------- .unv
def read_unv(path: str | Path):
    """Parse an IDEAS universal file (datasets 2411 nodes, 2412 elements,
    2467/757 node groups).  Returns (coords, conn (0-based), groups)."""
    lines = Path(path).read_text().splitlines()
    i = 0
    n = len(lines)
    coords_map: dict[int, list[float]] = {}
    elems: list[list[int]] = []
    groups: dict[str, np.ndarray] = {}

    def is_delim(s: str) -> bool:
        return s.strip() == "-1"

    while i < n:
        if not is_delim(lines[i]):
            i += 1
            continue
        i += 1
        if i >= n:
            break
        ds = lines[i].strip()
        i += 1
        if ds == "2411":                     # nodes
            while i < n and not is_delim(lines[i]):
                rec = lines[i].split()
                node_id = int(rec[0])
                i += 1
                xyz = [float(t.replace("D", "E")) for t in lines[i].split()]
                coords_map[node_id] = xyz[:3]
                i += 1
        elif ds == "2412":                   # elements
            while i < n and not is_delim(lines[i]):
                rec = lines[i].split()
                nnodes = int(rec[5])
                fe_type = int(rec[1])
                i += 1
                nodes = []
                while len(nodes) < nnodes:
                    nodes.extend(int(t) for t in lines[i].split())
                    i += 1
                # keep only volume elements (tet 111, hex 115)
                if fe_type in (111, 115):
                    elems.append(nodes[:nnodes])
        elif ds in ("2467", "2477", "757"):  # groups
            while i < n and not is_delim(lines[i]):
                rec = lines[i].split()
                n_entities = int(rec[-1])
                i += 1
                name = lines[i].strip()
                i += 1
                ids = []
                while len(ids) < n_entities and i < n and not is_delim(lines[i]):
                    toks = lines[i].split()
                    # records: (type, tag, 0, 0) x2 per line; tag at idx 1, 5
                    for pos in range(0, len(toks), 4):
                        ids.append(int(toks[pos + 1]))
                    i += 1
                groups[name] = np.array(ids, dtype=np.int64)
        else:
            while i < n and not is_delim(lines[i]):
                i += 1
        i += 1                                # closing -1

    node_ids = sorted(coords_map)
    renum = {nid: k for k, nid in enumerate(node_ids)}
    coords = np.array([coords_map[nid] for nid in node_ids])
    conn = np.array(
        [[renum[v] for v in e] for e in elems], dtype=np.int64
    )
    groups = {
        name: np.array(sorted(renum[v] for v in ids if v in renum),
                       dtype=np.int64)
        for name, ids in groups.items()
    }
    return coords, conn, groups
