"""The one generator of the benchmark's traffic: what a traffic file's
parameters and the seed make of a deck.

A traffic file (``traffic/<name>.json``) names the solver options it sets,
the segment length, the warm-up, which steps the check reads, the start
state and the seed's perturbation of it.  The start state is developed: the
float64 reference run ``start.developed_steps`` steps from rest (the deck's
boundary velocities, zero elsewhere), the same for every seed
(:func:`rest_fields`; the harness makes and keeps it).  From the seed come a
divergence-free perturbation of the velocity on top of it (zero on every
wall of the deck's bounding box and on every Dirichlet node) and the
sampled steps of the check.  The deck itself never changes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rng_of", "rest_fields", "perturbation", "start_fields", "sampled_steps"]


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def rest_fields(bc_vel: np.ndarray, nnp: int) -> tuple:
    """``(u, p, u_prev, pdot)`` at rest: the boundary velocities, the rest zero."""
    zero_p = np.zeros(nnp)
    return bc_vel.copy(), zero_p, np.zeros_like(bc_vel), zero_p.copy()


def perturbation(xyz: np.ndarray, is_bc: np.ndarray, seed: int, spec: dict) -> np.ndarray:
    """(NN, 3): the curl of a vector potential whose components are sums of
    ``spec["modes"]`` products ``prod_i sin^2(pi k_i xi_i)`` (wavenumbers 1
    to ``spec["max_wavenumber"]`` on the bounding box, ``xi`` in [0, 1]),
    drawn from the seed, scaled to a peak of ``spec["amplitude"] *
    spec["speed"]``; zero on the Dirichlet nodes.  Divergence-free, and zero
    with the potential's gradient on the box's walls, so it starts no
    pressure transient of its own."""
    rng = rng_of(seed, 0)
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    ext = np.where(hi > lo, hi - lo, 1.0)
    xi = (xyz - lo) / ext
    kmax = int(spec["max_wavenumber"])
    # sin(pi k xi) and cos(pi k xi), k = 1..kmax: (kmax, NN, 3)
    ks = np.arange(1, kmax + 1)[:, None, None]
    sin, cos = np.sin(np.pi * ks * xi), np.cos(np.pi * ks * xi)
    grad_psi = np.zeros((3, 3, xyz.shape[0]))      # [component c, direction j]
    for c in range(3):
        for _ in range(int(spec["modes"])):
            k = rng.integers(1, kmax + 1, size=3)
            a = rng.standard_normal()
            sq = np.stack([sin[k[i] - 1, :, i] ** 2 for i in range(3)], axis=1)
            for j in range(3):
                # d/dx_j sin^2(pi k xi_j) = 2 pi k sin cos / extent
                d = 2 * np.pi * k[j] * sin[k[j] - 1, :, j] * cos[k[j] - 1, :, j] / ext[j]
                grad_psi[c, j] += a * d * sq[:, (j + 1) % 3] * sq[:, (j + 2) % 3]
    f = np.stack([grad_psi[2, 1] - grad_psi[1, 2], grad_psi[0, 2] - grad_psi[2, 0],
                  grad_psi[1, 0] - grad_psi[0, 1]], axis=1)
    f[is_bc] = 0.0
    peak = np.abs(f).max()
    return (float(spec["amplitude"]) * float(spec["speed"]) / peak) * f if peak > 0 else f


def start_fields(developed: tuple, xyz: np.ndarray, is_bc: np.ndarray, seed: int,
                 spec: dict) -> tuple:
    """``(u, p, u_prev, pdot)`` in float32 values: the developed state with
    the seed's :func:`perturbation` added to ``u`` and ``u_prev`` alike."""
    u, p, u_prev, pdot = developed
    f = perturbation(xyz, is_bc, seed, spec)
    return tuple(np.asarray(a, np.float32) for a in (u + f, p, u_prev + f, pdot))


def sampled_steps(seed: int, first: int, segment: int, count: int) -> list[int]:
    """``count`` distinct steps of a segment after the first ``first``
    (1-based), drawn from the seed."""
    pool = np.arange(first + 1, segment + 1)
    return sorted(int(s) for s in rng_of(seed, 1).choice(pool, size=min(count, pool.size),
                                                         replace=False))
