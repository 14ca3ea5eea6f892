"""The benchmark's own deck generators: a frozen numpy copy of the port's
``mesh/generators.py`` ``cavity_deck`` (corner coordinates,
8-node connectivity, face velocity BCs, pressure pin, monitor point).

The benchmark makes every deck itself and hands the same one to the port
(as the port's ``Deck``) and to the reference, so a change to the port's
generators can never move the work a cell measures.  A configuration file
names its generator and the generator's keyword arguments.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = ["BenchDeck", "make_deck", "GENERATORS"]


@dataclass
class BenchDeck:
    """A fractional-step deck, the fields the time integrators read (the
    names of the port's ``io.deck.Deck``, so :meth:`as_kwargs` builds one)."""

    title: str
    etype: int
    ne: int
    ncn: int
    nenv: int
    nenp: int
    ngp: int
    alpha: float
    dt: float
    t_ini: float
    t_final: float
    max_iter: int
    tolerance: float
    convergence_criteria: float
    density: float
    viscosity: float
    coords: np.ndarray
    conn: np.ndarray
    bc_type: np.ndarray
    bc_str: np.ndarray
    bc_vel_faces: np.ndarray
    zero_pressure_node: int
    monitor_xyz: np.ndarray

    @property
    def nnp(self) -> int:
        return self.ncn

    def as_kwargs(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def clustered_axis(n_nodes: int, length: float = 1.0, cluster: float = 0.0) -> np.ndarray:
    """Node coordinates on [0, L], sinh-clustered toward both ends."""
    if cluster == 0.0:
        return np.linspace(0.0, length, n_nodes)
    half = (n_nodes + 1) // 2
    xx = np.arange(half) / ((n_nodes - 1) / 2.0)
    coord = np.empty(n_nodes)
    coord[:half] = length / 2.0 / np.sinh(cluster) * np.sinh(cluster * xx)
    coord[half:] = length - coord[: n_nodes - half][::-1]
    return coord


def cube_hex_mesh(nx: int, ny: int, nz: int, lengths=(1.0, 1.0, 1.0), cluster: float = 0.0):
    """(coords (NCN, 3), conn (NE, 8)) of a box of nx x ny x nz nodes,
    x fastest; corners in the reference hexahedron's order."""
    xs = clustered_axis(nx, lengths[0], cluster)
    ys = clustered_axis(ny, lengths[1], cluster)
    zs = clustered_axis(nz, lengths[2], cluster)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)

    def nid(i, j, k):
        return (k * ny + j) * nx + i

    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    i, j, k = ii.ravel(order="F"), jj.ravel(order="F"), kk.ravel(order="F")
    conn = np.stack([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k), nid(i, j + 1, k),
                     nid(i, j, k + 1), nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1),
                     nid(i, j + 1, k + 1)], axis=-1).astype(np.int64)
    return coords, conn


def _box_faces(ex: int, ey: int, ez: int) -> dict:
    """(elem, face) pairs of the six box boundaries; faces 0 z-, 1 y-,
    2 x+, 3 y+, 4 x-, 5 z+."""
    eid = lambda i, j, k: (k * ey + j) * ex + i
    j1, k1 = np.meshgrid(np.arange(ey), np.arange(ez), indexing="ij")
    i2, k2 = np.meshgrid(np.arange(ex), np.arange(ez), indexing="ij")
    i3, j3 = np.meshgrid(np.arange(ex), np.arange(ey), indexing="ij")
    pair = lambda e, f: np.stack([e.ravel(), np.full(e.size, f)], -1)
    return {"xmin": pair(eid(0, j1, k1), 4), "xmax": pair(eid(ex - 1, j1, k1), 2),
            "ymin": pair(eid(i2, 0, k2), 1), "ymax": pair(eid(i2, ey - 1, k2), 3),
            "zmin": pair(eid(i3, j3, 0), 0), "zmax": pair(eid(i3, j3, ez - 1), 5)}


def _with_bc(pairs: np.ndarray, bc: int) -> np.ndarray:
    return np.column_stack([pairs, np.full(len(pairs), bc, np.int64)]).astype(np.int64)


def cavity(n_elem: int, *, cluster: float = 0.0, lid_velocity=(1.0, 0.0, 0.0),
           dt: float = 0.001, t_final: float = 1.0, max_iter: int = 4,
           tolerance: float = 1e-3, convergence: float = 1e-6, density: float = 1.0,
           viscosity: float = 0.01, ngp: int = 8) -> BenchDeck:
    """Lid-driven cavity, n_elem^3 hexes on the unit cube, the lid (BC 1) at
    z = 1 moving along x, the other walls no-slip (BC 0), the pressure pin at
    the corner node nearest the bottom face's centre, the monitor at the
    cube's centre."""
    nx = n_elem + 1
    coords, conn = cube_hex_mesh(nx, nx, nx, cluster=cluster)
    fb = _box_faces(n_elem, n_elem, n_elem)
    walls = np.concatenate([fb[k] for k in ("zmin", "ymin", "xmax", "ymax", "xmin")])
    vel_faces = np.concatenate([_with_bc(walls, 0), _with_bc(fb["zmax"], 1)])
    zp = int(np.argmin(((coords - np.array([0.5, 0.5, 0.0])) ** 2).sum(axis=1)))
    return BenchDeck(
        title=f"3D Lid-driven cavity {n_elem}^3", etype=1, ne=n_elem ** 3, ncn=nx ** 3,
        nenv=27, nenp=8, ngp=ngp, alpha=1.0, dt=dt, t_ini=0.0, t_final=t_final,
        max_iter=max_iter, tolerance=tolerance, convergence_criteria=convergence,
        density=density, viscosity=viscosity, coords=coords, conn=conn,
        bc_type=np.array([1.0, 1.0]), bc_str=np.array([[0.0, 0.0, 0.0], list(lid_velocity)]),
        bc_vel_faces=vel_faces, zero_pressure_node=zp, monitor_xyz=np.array([0.5, 0.5, 0.5]))


GENERATORS = {"cavity": cavity}


def make_deck(spec: dict) -> BenchDeck:
    """The deck of a configuration's ``"deck"`` entry: ``{"generator": name,
    "args": [...], "kwargs": {...}}``."""
    return GENERATORS[spec["generator"]](*spec.get("args", ()), **spec.get("kwargs", {}))
