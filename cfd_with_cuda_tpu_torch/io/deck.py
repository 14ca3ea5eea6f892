"""Input-deck (`.inp`) readers — byte-compatible with the reference decks.

Three deck dialects exist in the reference and all are supported here
(auto-detected from header keys):

* ``fractional`` — the fractionalStep solvers' dialect: face-based velocity
  BCs, 1-based indices (reader:
  ``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:528-725``).
* ``legacy`` — the old NS / segregated dialect: node-based velocity and
  pressure BCs, 0-based indices, relaxation factors + monitor lists
  (reader: ``oldFiles/segregatedSolver/segregatedSolver.cpp`` readInput;
  deck: ``oldFiles/segregatedSolver/fem3dCavityInputNE1000.inp:1-21``).
* ``poisson`` — the scalar Poisson dialect: EBC nodes / NBC faces
  (reader: ``oldFiles/poissonSolver/poissonSolver.cpp``; deck:
  ``oldFiles/poissonSolver/poissonNE1000.inp``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["Deck", "read_deck", "write_fractional_deck"]


@dataclass
class Deck:
    """Parsed input deck (superset of all three dialects)."""

    dialect: str
    title: str
    # header scalars (missing entries stay None)
    etype: int | None = None
    ne: int = 0
    ncn: int = 0
    nn: int | None = None
    nenv: int = 8
    nenp: int = 8
    ngp: int = 8
    alpha: float | None = None
    dt: float | None = None
    t_ini: float | None = None
    t_final: float | None = None
    max_iter: int | None = None
    tolerance: float | None = None
    convergence_criteria: float | None = None
    is_restart: bool = False
    density: float = 1.0
    viscosity: float = 1.0
    fx: float = 0.0
    fy: float = 0.0
    fz: float = 0.0
    # legacy dialect extras
    solver_iter_max: int | None = None
    solver_tol: float | None = None
    n_dat_iter: int | None = None
    relaxation: tuple | None = None
    # poisson dialect extras
    axy: float | None = None
    fxy: float | None = None
    # mesh
    coords: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    conn: np.ndarray = field(default_factory=lambda: np.zeros((0, 8), dtype=np.int64))
    # BCs
    bc_type: np.ndarray = field(default_factory=lambda: np.zeros(0))
    bc_str: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    bc_vel_faces: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.int64)
    )
    bc_out_faces: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.int64)
    )
    bc_vel_nodes: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64)
    )
    bc_pres_nodes: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64)
    )
    zero_pressure_node: int = -1
    monitor_xyz: np.ndarray | None = None
    monitor_points: np.ndarray | None = None
    # optional space-varying velocity-BC profile (generated decks only;
    # the reference hard-codes its bending-duct fully-developed inlet in
    # commented-out applyBC code, ``blascoCodinaHuerta.cpp:4086-4102``):
    # (kind, bc_index, params...) consumed by mesh/profiles.py — kept a
    # plain tuple so the setup-cache fingerprint stays stable
    inlet_profile: tuple | None = None
    # provenance: where the deck was read from (None for generated decks);
    # anchors the `<title>_restart.dat` auto-load next to the deck file
    # (ref readRestartFile, blascoCodinaHuerta.cpp:2793-2799)
    source_path: str | None = None

    @property
    def nnp(self) -> int:
        """Pressure-node count: NE for NENp==1 else NCN (ref :718-723)."""
        return self.ne if self.nenp == 1 else self.ncn


def _header_fields(text: str) -> dict[str, str]:
    """Parse ``key : value`` header lines into a dict (lowercased keys)."""
    fields = {}
    for line in text.splitlines():
        m = re.match(r"\s*([A-Za-z_][A-Za-z0-9_ ]*?)\s*:\s*(.*)", line)
        if m:
            key = m.group(1).strip().lower()
            if key not in fields:
                fields[key] = m.group(2).strip()
    return fields


def _tokens_after(lines: list[str], start: int, n_rows: int, n_cols: int):
    """Read n_rows of whitespace-separated numbers starting at line start
    (skipping blank and ``====`` separator lines, which some legacy decks
    interleave with section headers)."""
    out = np.empty((n_rows, n_cols))
    r = 0
    i = start
    while r < n_rows:
        toks = lines[i].split()
        i += 1
        if not toks or toks[0].startswith("="):
            continue
        out[r] = [float(t) for t in toks[:n_cols]]
        r += 1
    return out, i


def _find_line(lines: list[str], pattern: str, start: int = 0) -> int:
    rx = re.compile(pattern)
    for i in range(start, len(lines)):
        if rx.search(lines[i]):
            return i
    raise ValueError(f"deck is missing a line matching {pattern!r}")


def read_deck(path: str | Path) -> Deck:
    """Read a `.inp` deck, auto-detecting its dialect."""
    path = Path(path)
    text = path.read_text()
    lines = text.splitlines()
    fields = _header_fields(text)

    if "nen" in fields and "nenv" not in fields:
        deck = _read_poisson(lines, fields)
    elif "maxiter" in fields:
        deck = _read_fractional(lines, fields)
    elif "itermax" in fields:
        deck = _read_legacy(lines, fields)
    else:
        raise ValueError(f"cannot identify deck dialect of {path}")
    deck.source_path = str(path)
    return deck


def _read_fractional(lines: list[str], fields: dict[str, str]) -> Deck:
    d = Deck(dialect="fractional", title=lines[0].strip())
    d.etype = int(fields["etype"])
    d.ne = int(fields["ne"])
    d.ncn = int(fields["ncn"])
    d.nenv = int(fields["nenv"])
    d.nenp = int(fields["nenp"])
    d.ngp = int(fields["ngp"])
    d.alpha = float(fields["alpha"])
    d.dt = float(fields["dt"])
    d.t_ini = float(fields["t_ini"])
    d.t_final = float(fields["t_final"])
    d.max_iter = int(fields["maxiter"])
    d.tolerance = float(fields["tolerance"])
    d.convergence_criteria = float(fields["converge"])
    d.is_restart = bool(int(fields["isrestart"]))
    d.density = float(fields["density"])
    d.viscosity = float(fields["viscosity"])
    d.fx = float(fields["fx"])
    d.fy = float(fields["fy"])

    nec = 8 if d.etype == 1 else 4

    i = _find_line(lines, r"Corner Node No|Node#")
    coords, i = _tokens_after(lines, i + 1, d.ncn, 4)
    d.coords = coords[:, 1:4]

    i = _find_line(lines, r"Elem No|corner1", i)
    conn, i = _tokens_after(lines, i + 1, d.ne, 1 + nec)
    d.conn = conn[:, 1:].astype(np.int64) - 1          # 1-based -> 0-based

    i = _find_line(lines, r"nBC\s*:", i)
    nbc = int(lines[i].split(":")[1])
    d.bc_type = np.empty(nbc)
    d.bc_str = np.zeros((nbc, 3))
    for b in range(nbc):
        # "BC 1      : 1  0.0 : 0.0 : 0.0"
        rhs = lines[i + 1 + b].split(":", 1)[1]
        parts = [p for p in re.split(r"[:\s]+", rhs.strip()) if p]
        d.bc_type[b] = float(parts[0])
        vals = [float(p) for p in parts[1:4]]
        d.bc_str[b, : len(vals)] = vals
    i += nbc

    i = _find_line(lines, r"nVelFaces\s*:", i)
    n_vel_faces = int(lines[i].split(":")[1])
    i = _find_line(lines, r"nOutFaces\s*:", i)
    n_out_faces = int(lines[i].split(":")[1])

    i = _find_line(lines, r"Velocity BC", i)
    if n_vel_faces:
        vf, i = _tokens_after(lines, i + 1, n_vel_faces, 3)
        d.bc_vel_faces = vf.astype(np.int64) - 1        # 1-based -> 0-based
    i = _find_line(lines, r"Outflow BC", i)
    if n_out_faces:
        of, i = _tokens_after(lines, i + 1, n_out_faces, 3)
        d.bc_out_faces = of.astype(np.int64) - 1

    i = _find_line(lines, r"pressure is taken to be zero", i)
    zp, i = _tokens_after(lines, i + 1, 1, 1)
    d.zero_pressure_node = int(zp[0, 0]) - 1            # 1-based -> 0-based

    i = _find_line(lines, r"Monitor point", i)
    mon, i = _tokens_after(lines, i + 1, 1, 3)
    d.monitor_xyz = mon[0]

    # OPTIONAL trailing extension (written by write_fractional_deck for
    # generated profile decks; the reference's reader stops at the
    # monitor point, so its decks never carry it and it never sees it):
    #   inletProfile : <kind> <bc_index> <param> <scale>
    for line in lines[i:]:
        if line.strip().startswith("inletProfile"):
            toks = line.split(":", 1)[1].split()
            d.inlet_profile = (
                toks[0], int(toks[1]), float(toks[2]), float(toks[3])
            )
            break
    return d


def _read_legacy(lines: list[str], fields: dict[str, str]) -> Deck:
    d = Deck(dialect="legacy", title=lines[0].strip())
    d.etype = int(fields["etype"])
    d.ne = int(fields["ne"])
    d.ncn = int(fields.get("ncn", fields["nn"]))
    d.nn = int(fields["nn"])
    d.nenv = int(fields.get("nenv", 8))
    d.nenp = int(fields.get("nenp", 8))
    d.ngp = int(fields["ngp"])
    d.max_iter = int(fields["itermax"])
    d.tolerance = float(fields["tolerance"])
    d.solver_iter_max = (
        int(fields["solveritermax"]) if "solveritermax" in fields else None
    )
    d.solver_tol = float(fields["solvertol"]) if "solvertol" in fields else None
    if "relaxation" in fields:
        d.relaxation = tuple(float(t) for t in fields["relaxation"].split())
    d.n_dat_iter = int(fields["ndatiter"]) if "ndatiter" in fields else None
    d.is_restart = bool(int(fields.get("isrestart", "0")))
    d.density = float(fields["density"])
    d.viscosity = float(fields["viscosity"])
    d.fx = float(fields.get("fx", "0"))
    d.fy = float(fields.get("fy", "0"))

    nen = d.nenv

    i = _find_line(lines, r"Node#")
    coords, i = _tokens_after(lines, i + 1, d.nn, 4)
    d.coords = coords[:, 1:4]

    i = _find_line(lines, r"Elem#", i)
    conn, i = _tokens_after(lines, i + 1, d.ne, 1 + nen)
    d.conn = conn[:, 1:].astype(np.int64)               # already 0-based

    i = _find_line(lines, r"nBC\s*:", i)
    nbc = int(lines[i].split(":")[1])
    d.bc_type = np.empty(nbc)
    d.bc_str = np.zeros((nbc, 3))
    for b in range(nbc):
        rhs = lines[i + 1 + b].split(":", 1)[1]
        parts = [p for p in re.split(r"[:\s]+", rhs.strip()) if p]
        d.bc_type[b] = float(parts[0])
        vals = [float(p) for p in parts[1:4]]
        d.bc_str[b, : len(vals)] = vals
    i += nbc

    i = _find_line(lines, r"nVelNodes\s*:", i)
    n_vel_nodes = int(lines[i].split(":")[1])
    i = _find_line(lines, r"nPressureNodes\s*:", i)
    n_pres_nodes = int(lines[i].split(":")[1])

    i = _find_line(lines, r"Velocity BC", i)
    if n_vel_nodes:
        vn, i = _tokens_after(lines, i + 1, n_vel_nodes, 2)
        vn = vn.astype(np.int64)
        vn[:, 1] -= 1                                   # BC number 1-based
        d.bc_vel_nodes = vn
    i = _find_line(lines, r"Pressure BC", i)
    if n_pres_nodes:
        pn, i = _tokens_after(lines, i + 1, n_pres_nodes, 2)
        pn = pn.astype(np.int64)
        pn[:, 1] -= 1
        d.bc_pres_nodes = pn
        d.zero_pressure_node = int(pn[0, 0])

    try:
        i = _find_line(lines, r"nMonitorPoints\s*:", i)
    except ValueError:
        return d        # optional section absent: monitor default point
    # the section IS declared: malformed data must fail loudly here, not
    # silently fall back to monitoring the default (0.5, 0.5, 0.5)
    nmon = int(lines[i].split(":")[1])
    if nmon:
        mon, i = _tokens_after(lines, i + 2, nmon, 4)
        d.monitor_points = mon[:, 1:]
        d.monitor_xyz = d.monitor_points[0]
    return d


def _read_poisson(lines: list[str], fields: dict[str, str]) -> Deck:
    d = Deck(dialect="poisson", title=lines[0].strip())
    d.etype = int(fields["etype"])
    d.ne = int(fields["ne"])
    d.nn = int(fields["nn"])
    d.ncn = d.nn
    d.nenv = d.nenp = int(fields["nen"])
    d.ngp = int(fields["ngp"])
    d.solver_iter_max = int(fields["solveritermax"])
    d.solver_tol = float(fields["solvertol"])
    d.axy = float(fields.get("axyfunc", "1.0"))
    d.fxy = float(fields.get("fxyfunc", "0.0"))

    i = _find_line(lines, r"Node#")
    coords, i = _tokens_after(lines, i + 1, d.nn, 4)
    d.coords = coords[:, 1:4]

    i = _find_line(lines, r"Elem#", i)
    conn, i = _tokens_after(lines, i + 1, d.ne, 1 + d.nenv)
    d.conn = conn[:, 1:].astype(np.int64)

    i = _find_line(lines, r"nBC\s*:", i)
    nbc = int(lines[i].split(":")[1])
    d.bc_type = np.empty(nbc)
    d.bc_str = np.zeros((nbc, 3))
    for b in range(nbc):
        rhs = lines[i + 1 + b].split(":", 1)[1]
        parts = [p for p in re.split(r"[:\s]+", rhs.strip()) if p]
        d.bc_type[b] = float(parts[0])
        vals = [float(p) for p in parts[1:2]]
        d.bc_str[b, : len(vals)] = vals
    i += nbc

    i = _find_line(lines, r"nEBCnodes\s*:", i)
    n_ebc = int(lines[i].split(":")[1])
    i = _find_line(lines, r"EBC", i + 1)
    if n_ebc:
        en, i = _tokens_after(lines, i + 1, n_ebc, 2)
        en = en.astype(np.int64)
        en[:, 1] -= 1
        d.bc_vel_nodes = en                              # scalar EBC nodes
    return d


def write_fractional_deck(path: str | Path, deck: Deck) -> None:
    """Write a fractionalStep-dialect deck the reference reader can parse."""
    p = Path(path)
    out = []
    out.append(deck.title or "Generated by cfd_with_cuda_tpu")
    out.append("=" * 48)
    out.append(f"eType    : {deck.etype} ")
    out.append(f"NE       : {deck.ne} ")
    out.append(f"NCN      : {deck.ncn} ")
    out.append(f"NENv     : {deck.nenv} ")
    out.append(f"NENp     : {deck.nenp} ")
    out.append(f"NGP      : {deck.ngp} ")
    out.append(f"alpha    : {deck.alpha if deck.alpha is not None else 1.0:.10g}")
    out.append(f"dt       : {deck.dt:.10g}")
    out.append(f"t_ini    : {deck.t_ini:.10g} ")
    out.append(f"t_final  : {deck.t_final:.10g} ")
    out.append(f"maxIter  : {deck.max_iter} ")
    out.append(f"tolerance: {deck.tolerance:.10g}")
    out.append(f"converge : {deck.convergence_criteria:.10g} ")
    out.append(f"isRestart: {int(deck.is_restart)}")
    out.append(f"density  : {deck.density:.10g} ")
    out.append(f"viscosity: {deck.viscosity:.10g} ")
    out.append(f"fx       : {deck.fx} ")
    out.append(f"fy       : {deck.fy} ")
    out.append("=" * 48)
    out.append("Corner Node No         x                y                z")
    for i, (x, y, z) in enumerate(deck.coords):
        out.append(f"{i + 1:9d}   {x:16.7f} {y:16.7f} {z:16.7f}")
    out.append("=" * 48)
    out.append(
        "Elem No   corner1  corner2  corner3  corner4  corner5  corner6  corner7  corner8"
    )
    for e, row in enumerate(deck.conn):
        out.append(f"{e + 1:6d}  " + "  ".join(f"{n + 1:7d}" for n in row))
    out.append("=" * 48)
    out.append("BCs (Number of specified BCs, their types and strings) ")
    out.append(f"nBC       : {len(deck.bc_type)} ")
    for b in range(len(deck.bc_type)):
        s = deck.bc_str[b]
        out.append(
            f"BC {b + 1}      : {int(deck.bc_type[b])}  {s[0]} : {s[1]} : {s[2]}"
        )
    out.append("=" * 48)
    out.append(f"nVelFaces : {len(deck.bc_vel_faces)} ")
    out.append(f"nOutFaces : {len(deck.bc_out_faces)} ")
    out.append("=" * 48)
    out.append("Velocity BC (Elem# Face# BC#)")
    for e, f, b in deck.bc_vel_faces:
        out.append(f"{e + 1:5d} {f + 1:4d} {b + 1:4d}")
    out.append("=" * 48)
    out.append("Outflow BC (Elem# Face# BC#)")
    for e, f, b in deck.bc_out_faces:
        out.append(f"{e + 1:5d} {f + 1:4d} {b + 1:4d}")
    out.append("=" * 48)
    out.append("Node number where pressure is taken to be zero")
    out.append(f"{deck.zero_pressure_node + 1}")
    out.append("=" * 48)
    out.append("Monitor point coordinates")
    mx = deck.monitor_xyz if deck.monitor_xyz is not None else (0.5, 0.5, 0.5)
    out.append(f"{mx[0]}  {mx[1]}  {mx[2]}")
    if deck.inlet_profile is not None:
        # extension section AFTER everything the reference reads (its
        # reader stops at the monitor point, so reference compatibility
        # is preserved); round-tripped by _read_fractional
        kind, bc_index, param, scale = deck.inlet_profile
        out.append("=" * 48)
        out.append(f"inletProfile : {kind} {int(bc_index)} {param} {scale}")
    out.append("")
    p.write_text("\n".join(out))
