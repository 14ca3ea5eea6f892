"""Tecplot `.dat` writer and restart reader — byte-compatible with the
reference's ``createTecplot()``/``readRestartFile()``
(``fractionalStep/explicit/Cpp/blascoCodinaHuerta.cpp:4249-4482, 4214-4242``):

* each 27-node hex is emitted as 8 linear FEBRICK sub-elements (the exact
  sub-element node tables of :4455-4469),
* pressure (known only at corner nodes) is linearly interpolated to
  mid-edge/face/element nodes (:4299-4436),
* restart files are prior `.dat` files re-read as initial conditions.

Port of ``cfd_with_cuda_tpu/io/tecplot.py`` (numpy only): the same arrays
give the same bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cfd_with_cuda_tpu_torch.fem.shape import HEX_EDGES, HEX_FACE_CORNERS

__all__ = ["SUB_HEXES", "interpolate_pressure_to_all_nodes", "write_tecplot", "read_restart"]

# 8 sub-hexes of a 27-node hex, local node indices (ref :4455-4469).
SUB_HEXES = np.array(
    [
        (0, 8, 20, 11, 12, 21, 26, 24),
        (8, 1, 9, 20, 21, 13, 22, 26),
        (11, 20, 10, 3, 24, 26, 23, 15),
        (20, 9, 2, 10, 26, 22, 14, 23),
        (12, 21, 26, 24, 4, 16, 25, 19),
        (21, 13, 22, 26, 16, 5, 17, 25),
        (24, 26, 23, 15, 19, 25, 18, 7),
        (26, 22, 14, 23, 25, 17, 6, 18),
    ],
    dtype=np.int64,
)


def interpolate_pressure_to_all_nodes(
    p: np.ndarray, ltog_node: np.ndarray, nn: int
) -> np.ndarray:
    """Extend corner-node pressure (NNp,) to all NN nodes by averaging
    (mid-edge: 2 corners; mid-face: 4; mid-element: 8), like ref
    :4299-4436 (later elements overwrite shared nodes with equal values)."""
    out = np.zeros(nn)
    nnp = p.shape[0]
    out[:nnp] = p
    corners = ltog_node[:, :8]
    # mid-edge nodes
    edge_vals = out[corners[:, HEX_EDGES]].mean(axis=2)         # (NE, 12)
    out[ltog_node[:, 8:20].ravel()] = edge_vals.ravel()
    # mid-face nodes
    face_vals = out[corners[:, HEX_FACE_CORNERS]].mean(axis=2)  # (NE, 6)
    out[ltog_node[:, 20:26].ravel()] = face_vals.ravel()
    # mid-element nodes
    out[ltog_node[:, 26]] = out[corners].mean(axis=1)
    return out


def write_tecplot(
    path: str | Path,
    title: str,
    coords: np.ndarray,
    ltog_node: np.ndarray,
    u: np.ndarray,
    p: np.ndarray,
) -> None:
    """Write the FEBRICK `.dat` file (u (NN,3), p (NNp,) corner pressure)."""
    path = Path(path)
    nn = coords.shape[0]
    ne = ltog_node.shape[0]
    quadratic = ltog_node.shape[1] == 27
    p_all = (
        interpolate_pressure_to_all_nodes(p, ltog_node, nn) if quadratic
        else np.asarray(p)
    )
    # write-temp-then-rename: this writer also produces the auto-loaded
    # restart checkpoint (solvers/base._write_restart_next_to), so a crash
    # mid-dump must not truncate the previous good file
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(
        dir=str(path.parent), prefix=path.name + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(f"TITLE = {title}\n")
            f.write("VARIABLES = x,  y,  z,  u, v, w, p\n")
            n_out = 8 * ne if quadratic else ne
            f.write(f"ZONE N={nn}, E={n_out}, F=FEPOINT, ET=BRICK\n")
            data = np.column_stack([coords, u, p_all])
            np.savetxt(f, data, fmt="%.11e")
            if quadratic:
                sub = ltog_node[:, SUB_HEXES] + 1    # (NE, 8, 8), 1-based
                np.savetxt(f, sub.reshape(-1, 8), fmt="%d")
            else:
                np.savetxt(f, ltog_node[:, :8] + 1, fmt="%d")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_restart(
    path: str | Path, nn: int, nnp: int
) -> tuple[np.ndarray, np.ndarray]:
    """Read a prior `.dat` file as (u (NN,3), p (NNp,)) initial condition
    (ref ``readRestartFile`` :4214-4242: u/v/w from all NN rows, pressure
    only from the first NNp corner rows)."""
    rows = np.loadtxt(path, skiprows=3, max_rows=nn)
    u = rows[:, 3:6]
    p = rows[:nnp, 6]
    return u, p
