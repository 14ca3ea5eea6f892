"""The explicit fractional step (Blasco, Codina and Huerta 1998) of the
reference: ``blascoCodinaHuerta.cpp`` ``timeLoop`` :2859-3040 and ``step1``,
``step2``, ``step3`` :3692-3974, with the lumped mass, Z = G^T Md^-1 G and
the pressure pin, at most ``maxIter`` nonlinear sub-iterations a step.

State: ``(u (NN, 3), p (NNp,), u_prev (NN, 3), pdot (NNp,))`` in deck node
order; ``u_prev`` is the last sub-iterate the convergence test compared
against, ``pdot`` the last pressure increment (the warm start of the next
solve when the configuration asks for one).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.fem import Elements
from benchmark.reference.krylov import Precision, pcg
from benchmark.reference.mesh import boundary_velocity, nearest_corner, node_bcs, promote

__all__ = ["ExplicitReference", "StepOut", "decide"]

# where the convergence test's ratio max(norm1, norm2) / tolerance lies this
# close to 1, the reference takes the sub-iteration count of the run it
# checks (a rounding-level tie; outside it the reference decides itself)
TIE_BAND = 0.02


class StepOut(NamedTuple):
    iters: int
    cg_iters: list          # one count a pressure solve
    max_acc: float
    monitor: np.ndarray     # (u, v, w, p) at the monitor node


def decide(ratio: float, it: int, follow: int | None) -> bool:
    """Whether sub-iteration ``it`` ends the step: the convergence test
    (``ratio < 1``), or, on a tie within :data:`TIE_BAND`, the checked run's
    own count ``follow``."""
    if follow is not None and abs(ratio - 1.0) <= TIE_BAND:
        return it >= follow
    return ratio < 1.0


class ExplicitReference:
    """The explicit step on ``deck`` (a ``benchmark.decks.BenchDeck``) with
    the solver options ``opts`` of the configuration (``pressure_cg_tol``,
    ``pressure_cg_maxiter``, ``pressure_warm_start``, ``pressure_pin_large``,
    ``pressure_cg_every``), in ``precision`` (``Precision`` name)."""

    def __init__(self, deck, opts: dict, device, precision: str = "f64"):
        self.deck, self.opts = deck, opts
        self.prec = Precision(precision)
        dt_, r = self.prec.dtype, self.prec.rnd
        ltog, xyz = promote(deck.conn, deck.coords)
        self.nn, self.nnp = xyz.shape[0], deck.nnp
        el = Elements(ltog, xyz, deck.ngp, self.nn, self.nnp, device)
        self.el = el
        me = el.mass()
        md = el.lumped(me)
        ge = el.gradient(deck.density)
        bc = node_bcs(ltog, deck.bc_vel_faces, self.nn)
        self.is_bc = torch.as_tensor(bc >= 0, device=device)
        self.bc_vel = torch.as_tensor(boundary_velocity(deck, xyz, bc), device=device)
        mdb = torch.where(self.is_bc, torch.ones_like(md), md)
        self.md_inv = (1.0 / mdb).to(dt_)
        self.md_orig_inv = (1.0 / md).to(dt_)
        # Z = sum_d G_d^T Md^-1 G_d, assembled from this module's own G
        shape = (self.nn, self.nnp)
        z = None
        for d in range(3):
            g = el.csr(ge[d], el.ltog, el.ltog_p, shape)
            gt_dinv = el.csr((ge[d] * (1.0 / md)[el.ltog][:, :, None]).transpose(1, 2),
                             el.ltog_p, el.ltog, shape[::-1])
            zd = torch.sparse.mm(gt_dinv, g)
            z = zd if z is None else z + zd
        z = z.to_sparse_coo().coalesce()
        idx = z.indices()
        diag = torch.zeros(self.nnp, dtype=torch.float64, device=device)
        on_diag = idx[0] == idx[1]
        diag.index_add_(0, idx[0][on_diag], z.values()[on_diag])
        self.pin = int(deck.zero_pressure_node)
        self.pin_extra = 0.0
        if self.pin >= 0:
            self.pin_extra = float(diag[self.pin]) * (opts["pressure_pin_large"] - 1.0)
            diag[self.pin] += self.pin_extra
        self.z = torch.sparse_coo_tensor(idx, r(z.values().to(dt_)), z.shape).to_sparse_csr()
        self.z_dinv = (1.0 / diag).to(dt_)
        self.ke = r(el.stiffness(deck.viscosity).to(dt_))
        self.ge = r(ge.to(dt_))
        self.sv, self.gq, self.gdsv = r(el.sv.to(dt_)), r(el.gq.to(dt_)), r(el.gdsv.to(dt_))
        self.mon = nearest_corner(deck.coords, deck.monitor_xyz)
        del me

    # ------------------------------------------------------------ operators
    def k_mul(self, u):
        el = self.el
        return el.scatter(torch.bmm(self.ke, self.prec.rnd(u)[el.ltog]), el.ltog, self.nn)

    def grad(self, p):
        el = self.el
        ye = torch.einsum("deij,ej->eid", self.ge, self.prec.rnd(p)[el.ltog_p])
        return el.scatter(ye, el.ltog, self.nn)

    def div(self, u):
        el = self.el
        ye = torch.einsum("deij,eid->ej", self.ge, self.prec.rnd(u)[el.ltog])
        return el.scatter(ye, el.ltog_p, self.nnp)

    def z_mul(self, p):
        y = torch.mv(self.z, self.prec.rnd(p))
        if self.pin >= 0:
            y[self.pin] += self.pin_extra * p[self.pin]
        return y

    def convection(self, un):
        """The apply u -> A(un) u (calculateMatrixA, :3608-3655), un fixed."""
        el, r = self.el, self.prec.rnd
        u0gq = torch.einsum("ki,eid->ekd", self.sv, r(un)[el.ltog])
        w = r(torch.einsum("ekd,ekjd->ekj", r(u0gq), self.gdsv))

        def apply(u):
            conv = torch.einsum("ekj,ejd->ekd", w, r(u)[el.ltog])
            ye = torch.einsum("ki,ek,ekd->eid", self.sv, self.gq, r(conv))
            return el.scatter(ye, el.ltog, self.nn)
        return apply

    # ------------------------------------------------------------ the step
    def state(self, u, p, u_prev, pdot):
        """The state of four numpy fields: ``u (NN, 3)``, ``p (NNp,)``,
        ``u_prev (NN, 3)``, ``pdot (NNp,)``."""
        dt_, dev = self.prec.dtype, self.el.device
        return tuple(torch.as_tensor(np.asarray(a), dtype=dt_, device=dev)
                     for a in (u, p, u_prev, pdot))

    def step(self, state, follow: int | None = None):
        """One time step; ``follow``: the checked run's sub-iteration count
        for this step, taken on a tie (:func:`decide`)."""
        deck, o = self.deck, self.opts
        dt = float(deck.dt)
        un, pn, unp1_prev, pdot_prev = state
        mask = (~self.is_bc)[:, None].to(un.dtype)
        ka = self.convection(un)
        g_pn = self.grad(pn)
        uhp, pnp1_prev = un, pn
        k_acc = torch.zeros_like(un)
        unp1, pnp1, cg_counts, it = un, pn, [], 0
        x0 = pdot_prev if o["pressure_warm_start"] else None
        for it in range(1, deck.max_iter + 1):
            r1 = -(self.k_mul(uhp) + ka(uhp)) - g_pn
            unp_half = un + dt * (r1 * mask) * self.md_inv[:, None]
            r2 = self.div(unp_half / (dt * dt) - self.md_orig_inv[:, None] * k_acc)
            if self.pin >= 0:
                r2[self.pin] = 0.0
            pdot, k = pcg(self.z_mul, self.z_dinv, r2, x0, tol=o["pressure_cg_tol"],
                          maxiter=o["pressure_cg_maxiter"], every=o["pressure_cg_every"])
            cg_counts.append(k)
            pnp1 = pn + dt * pdot
            acc = (-dt * (self.grad(pdot) + k_acc)) * mask * self.md_inv[:, None]
            unp1 = unp_half + dt * acc
            norm1 = float(torch.linalg.vector_norm(unp1 - unp1_prev)
                          / torch.linalg.vector_norm(unp1))
            norm2 = float(torch.linalg.vector_norm(pnp1 - pnp1_prev)
                          / torch.linalg.vector_norm(pnp1))
            done = decide(max(norm1, norm2) / deck.tolerance, it, follow)
            if not (done or it >= deck.max_iter):
                k_acc = self.k_mul(acc)
            if not done:
                uhp, unp1_prev, pnp1_prev = unp_half, unp1, pnp1
            x0 = pdot if o["pressure_warm_start"] else None
            pdot_prev = pdot
            if done:
                break
        max_acc = float(torch.max(torch.abs(unp1 - un))) / dt
        mon = np.array([*unp1[self.mon].tolist(), float(pnp1[self.mon])])
        return (unp1, pnp1, unp1_prev, pdot_prev), StepOut(it, cg_counts, max_acc, mon)

    def fields(self, state) -> tuple[np.ndarray, np.ndarray]:
        return state[0].cpu().double().numpy(), state[1].cpu().double().numpy()
