"""Space-varying velocity-BC profiles (fully-developed duct inlets).

The reference imposes constant per-BC velocity triples; its bending-
square-duct runs used a hard-coded fully-developed inlet in (commented)
``applyBC`` code — ``blascoCodinaHuerta.cpp:4086-4102``:

    velocity = 2.25 * (4*y - 4*y*y) * (4*z - 4*z*z);   // Average u is 1.0

Here the same capability is a first-class deck field: ``deck.inlet_profile
= (kind, bc_index, *params)`` (a plain tuple so the setup-cache
fingerprint hashes it stably), applied to the per-node BC-velocity table
after face->node conversion — so it covers the Q2 mid-edge/face nodes the
reference's node loop also hits.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "apply_inlet_profile",
    "duct_developed_profile", "duct_series_profile", "kovasznay_uv",
]


def duct_developed_profile(eta: np.ndarray, zeta: np.ndarray) -> np.ndarray:
    """The reference's separable developed-duct profile on the unit
    cross-section (mean 1.0): ``2.25 (4y-4y^2)(4z-4z^2)``
    (``blascoCodinaHuerta.cpp:4094``)."""
    return 2.25 * (4 * eta - 4 * eta**2) * (4 * zeta - 4 * zeta**2)


def duct_series_profile(eta: np.ndarray, zeta: np.ndarray, terms: int = 50) -> np.ndarray:
    """EXACT fully-developed laminar profile in a square duct (the
    analytic series solution of ``-lap u = const`` with no-slip walls;
    e.g. White, *Viscous Fluid Flow* §3-3), normalised to mean 1.0.
    Used as the ground truth for the straight-duct regression test."""
    eta = np.asarray(eta, dtype=np.float64)
    zeta = np.asarray(zeta, dtype=np.float64)
    u = np.zeros(np.broadcast(eta, zeta).shape)
    for k in range(terms):
        n = 2 * k + 1
        npi = n * np.pi
        u += (
            (4.0 / npi**3)
            * (1.0 - np.cosh(npi * (zeta - 0.5)) / np.cosh(npi / 2.0))
            * np.sin(npi * eta)
        )
    # normalise by the analytic mean of the same truncated series
    mean = sum(
        (4.0 / ((2 * k + 1) * np.pi) ** 3)
        * (1.0 - 2.0 / ((2 * k + 1) * np.pi) * np.tanh((2 * k + 1) * np.pi / 2.0))
        * (2.0 / ((2 * k + 1) * np.pi))
        for k in range(terms)
    )
    return u / mean


def kovasznay_uv(x: np.ndarray, y: np.ndarray, re: float) -> tuple[np.ndarray, np.ndarray]:
    """EXACT steady Navier-Stokes solution of Kovasznay (1948): the
    laminar wake behind a periodic array,

        u = 1 - exp(lam x) cos(2 pi y)
        v = (lam / 2 pi) exp(lam x) sin(2 pi y)
        lam = Re/2 - sqrt(Re^2/4 + 4 pi^2)

    (divergence-free, satisfies the full nonlinear NS with nu = 1/Re and
    no forcing).  Extends trivially to 3-D with w = 0, d/dz = 0.  Used
    as the manufactured-solution ground truth for the full-NS MMS test
    (SURVEY.md section 4: the reference verifies only via benchmark
    decks; the rebuild adds exact-solution validation with convection
    active)."""
    lam = re / 2.0 - np.sqrt(re * re / 4.0 + 4.0 * np.pi * np.pi)
    ex = np.exp(lam * np.asarray(x, np.float64))
    u = 1.0 - ex * np.cos(2.0 * np.pi * y)
    v = lam / (2.0 * np.pi) * ex * np.sin(2.0 * np.pi * y)
    return u, v


_PROFILES = {
    "duct_developed": duct_developed_profile,
    "duct_series": duct_series_profile,
}


def apply_inlet_profile(deck, coords: np.ndarray, bc_of_node: np.ndarray,
                        bc_vel: np.ndarray) -> np.ndarray:
    """Overwrite ``bc_vel`` rows of nodes carrying ``bc_index`` with the
    deck's profile evaluated at the (promoted) node coordinates.

    ``deck.inlet_profile = (kind, bc_index, axis, scale)``: ``axis`` is
    the flow direction (0/1/2); the two cross-section axes are normalised
    to [0,1] by the mesh bounding box.  Returns ``bc_vel`` (modified in
    place).
    """
    spec = getattr(deck, "inlet_profile", None)
    if spec is None:
        return bc_vel
    kind, bc_index, axis, scale = spec
    sel = bc_of_node == int(bc_index)
    if not sel.any():
        return bc_vel
    if kind == "kovasznay":
        # full-vector exact-solution BC at ABSOLUTE (x, y) node
        # coordinates ("axis" slot carries Re); w = 0
        u, v = kovasznay_uv(coords[sel, 0], coords[sel, 1], float(axis))
        vals = np.zeros((int(sel.sum()), 3))
        vals[:, 0] = float(scale) * u
        vals[:, 1] = float(scale) * v
        bc_vel[sel] = vals
        return bc_vel
    fn = _PROFILES[kind]
    cross = [a for a in range(3) if a != int(axis)]
    # normalise by the INLET PATCH's own extent (not the whole mesh):
    # identical for full-cross-section ducts, and correct when the inlet
    # covers only part of the section (backward-facing step)
    lo = coords[sel].min(axis=0)
    hi = coords[sel].max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    eta = (coords[sel, cross[0]] - lo[cross[0]]) / span[cross[0]]
    zeta = (coords[sel, cross[1]] - lo[cross[1]]) / span[cross[1]]
    vals = np.zeros((int(sel.sum()), 3))
    vals[:, int(axis)] = float(scale) * fn(eta, zeta)
    bc_vel[sel] = vals
    return bc_vel
