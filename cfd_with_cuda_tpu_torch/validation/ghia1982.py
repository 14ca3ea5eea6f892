"""Ghia, Ghia & Shin (1982) lid-driven-cavity benchmark profiles.

U. Ghia, K.N. Ghia, C.T. Shin, "High-Re solutions for incompressible
flow using the Navier-Stokes equations and a multigrid method",
J. Comput. Phys. 48 (1982) 387-411 — Tables I/II: velocity along the
vertical / horizontal lines through the geometric center, 129x129 grid.
Transcribed to ~5 significant digits; used only inside tolerance bands.

This is the canonical EXTERNAL ground truth for the reference's own
benchmark problem (``inputFiles/lidDrivenCavity/lidDrivenCavity_NE27000
.inp``: Re=100 cavity; the reference verified by eyeballing exactly these
profiles, SURVEY.md §4 item 1).  Ghia's cavity is 2-D; the reference and
this framework solve the 3-D cubic cavity whose mid-plane (y=0.5)
profiles are attenuated by the side-wall drag — published 3-D cubic
cavity studies (Ku, Hirsh & Taylor 1987; Jiang, Lin & Povinelli 1994)
place the Re=100 mid-plane extrema within ~0.05 of the 2-D values.  Use
:data:`BAND_3D` as the acceptance band for 3-D mid-plane comparisons.

Port of ``cfd_with_cuda_tpu/validation/ghia1982.py`` (numpy; the port
keeps its own copy of the tables).

Axis mapping (our deck: lid at z=1 moving +x; Ghia: lid at y=1):
Ghia u(y) -> our u(z) at (x,y)=(0.5,0.5); Ghia v(x) -> our w(x) at
(y,z)=(0.5,0.5).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "GHIA_U", "GHIA_V", "BAND_3D", "centerline_profiles",
    "check_against_ghia",
]

# acceptance band (absolute) for 3-D mid-plane vs 2-D Ghia comparison
BAND_3D = 0.06

# Table I: u through the geometric center, columns = y, Re=100, Re=1000
GHIA_U = np.array([
    # y       u(Re=100)   u(Re=1000)
    [1.0000,  1.00000,  1.00000],
    [0.9766,  0.84123,  0.65928],
    [0.9688,  0.78871,  0.57492],
    [0.9609,  0.73722,  0.51117],
    [0.9531,  0.68717,  0.46604],
    [0.8516,  0.23151,  0.33304],
    [0.7344,  0.00332,  0.18719],
    [0.6172, -0.13641,  0.05702],
    [0.5000, -0.20581, -0.06080],
    [0.4531, -0.21090, -0.10648],
    [0.2813, -0.15662, -0.27805],
    [0.1719, -0.10150, -0.38289],
    [0.1016, -0.06434, -0.29730],
    [0.0703, -0.04775, -0.22220],
    [0.0625, -0.04192, -0.20196],
    [0.0547, -0.03717, -0.18109],
    [0.0000,  0.00000,  0.00000],
])

# Table II: v through the geometric center, columns = x, Re=100, Re=1000
GHIA_V = np.array([
    # x       v(Re=100)   v(Re=1000)
    [1.0000,  0.00000,  0.00000],
    [0.9688, -0.05906, -0.21388],
    [0.9609, -0.07391, -0.27669],
    [0.9531, -0.08864, -0.33714],
    [0.9453, -0.10313, -0.39188],
    [0.9063, -0.16914, -0.51550],
    [0.8594, -0.22445, -0.42665],
    [0.8047, -0.24533, -0.31966],
    [0.5000,  0.05454,  0.02526],
    [0.2344,  0.17527,  0.32235],
    [0.2266,  0.17507,  0.33075],
    [0.1563,  0.16077,  0.37095],
    [0.0938,  0.12317,  0.32627],
    [0.0781,  0.10890,  0.30353],
    [0.0703,  0.10091,  0.29012],
    [0.0625,  0.09233,  0.27485],
    [0.0000,  0.00000,  0.00000],
])


def centerline_profiles(coords: np.ndarray, u: np.ndarray, tol: float = 1e-9):
    """Extract the two mid-plane centerline profiles from a cavity field.

    ``coords (NN, 3)`` deck node order, ``u (NN, 3)`` velocity.  Returns
    ``(z, u_x(z), x, u_z(x))``: the x-velocity along the vertical line
    (x=y=0.5) and the z-velocity along the horizontal line (y=z=0.5) —
    the 3-D analogue of Ghia's Tables I/II.  Structured cavity grids
    always carry these nodes exactly (odd node counts per axis).
    """
    coords = np.asarray(coords)
    u = np.asarray(u)
    mid = 0.5
    on_vert = (np.abs(coords[:, 0] - mid) < tol) & (np.abs(coords[:, 1] - mid) < tol)
    on_horz = (np.abs(coords[:, 1] - mid) < tol) & (np.abs(coords[:, 2] - mid) < tol)
    iv = np.flatnonzero(on_vert)
    ih = np.flatnonzero(on_horz)
    iv = iv[np.argsort(coords[iv, 2])]
    ih = ih[np.argsort(coords[ih, 0])]
    return coords[iv, 2], u[iv, 0], coords[ih, 0], u[ih, 2]


def check_against_ghia(z, u_x, x, u_z, re: int = 100):
    """Max |3-D mid-plane profile - Ghia 2-D| at Ghia's sample points
    (linear interpolation onto them).  Returns (max_err_u, max_err_v);
    the acceptance decision (vs e.g. ``BAND_3D``) is the caller's."""
    col = {100: 1, 1000: 2}[re]
    u_interp = np.interp(GHIA_U[:, 0], z, u_x)
    v_interp = np.interp(GHIA_V[:, 0], x, u_z)
    return (
        float(np.max(np.abs(u_interp - GHIA_U[:, col]))),
        float(np.max(np.abs(v_interp - GHIA_V[:, col]))),
    )
