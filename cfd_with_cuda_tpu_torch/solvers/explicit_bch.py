"""Explicit fractional-step solver (Blasco-Codina-Huerta 1998).

Port of ``cfd_with_cuda_tpu/solvers/explicit_bch.py``: Q2/Q1 hexes (27-node
velocity, 8-node pressure), lumped-mass explicit predictor, pressure-Poisson
solve on Z = G^T Md^-1 G, projection, with ``maxIter`` nonlinear
sub-iterations per time step (reference ``blascoCodinaHuerta.cpp``
``timeLoop`` :2815-3120, ``step1/2/3`` :3692-3974).  Two layouts:

* ``"parity"``, an element-structured box grid: fields in the class-major
  layout ``(3, 8, Sp)``; per sub-iteration the CUDA kernels
  ``parity_apply`` ((K + A(un)) u*, G p, K acc) and ``div_compact`` (G^T
  onto the coarse pressure grid); once per step plain torch ops build the
  convection planes A(un).  Above 6 MiB (NE85184 and up, the JAX package's
  rule) ``parity_apply`` stages the velocity field through shared memory.
  ``conv_mode="matrix-free"`` (and any deck whose coarse grid exceeds
  100,000 nodes, as in the JAX package) applies A(un) matrix-free instead:
  flat gather, one einsum, ``parity_scatter_elem_flat``.
* ``"interleaved"``, a box mesh with ``structured_layout="interleaved"`` or
  one whose elements do not tile it: fields ``(3, s_pad)`` in flat z-major
  grid order (the fine axis padded to a ``BLK`` multiple); per
  sub-iteration the CUDA kernels ``window_stencil`` (K u on the 125-offset
  DIA table, G p on the class-compacted window of at most 27 slots a row)
  and ``div_compact`` in its
  interleaved form (G^T onto the coarse grid).  Convection:
  ``conv_mode="assemble"`` adds A(un) into K's window rows once per step
  (one apply of K + A); otherwise the stride-2 elemental gather, one
  einsum and the parity-grouped scatter (``ops/stencil.py``); on a box
  whose elements do not tile it, the elemental convection of
  ``ops/spmv.py`` on grid-order node tables.
  Under ``spmd_devices >= 1`` (the sharded kernel path, as in the JAX
  package a box takes this layout then) each rank of a ``torch.distributed``
  group holds its block of the fine axis: K, K + A and G on its rows through
  ``parallel/sharded_stencil.py`` (a flat halo exchange, the same kernels
  given a field origin), G^T on its coarse rows then all-gathered, the
  coarse CG replicated on every rank, the convection on its element slab
  (``parallel/elem_slab.py``), the norms, max_acc and the monitor over the
  ranks.
* ``"ell"``, any other mesh or ``structured="never"`` (the JAX package's
  unstructured branch): fields ``(3, NN)``; K, (K + A(un)), G and G^T
  apply through the elemental matrices (torch gathers and ``bmm``,
  ``ops/spmv.py``), Ae(un) built once per step.  The pressure operator is
  the banded window of ``ops/banded.py`` when the numbering bounds its
  offsets, else slot-major ELL.

The pressure CG is ``cg_solve`` (the whole solve in one launch,
``pressure_cg_fuse_loop``) or ``cg_init`` + one ``cg_iter`` per iteration
(the default), with compensated dots under ``DTypePolicy.MIXED`` and, on
the box layouts, the half window under ``pressure_cg_sym``; on the ELL
layout they take the banded offsets.  F64, ``pressure_backend="xla"`` and
an ELL pressure operator run the torch ``cg`` (``ops/krylov.py``), as the
JAX package runs its XLA CG there.  The sub-iteration convergence flag is
read on the host once per sub-iteration.

Off the kernel path (F64, ``pressure_backend="xla"`` or
``pressure_precond="mg"``: the JAX package's default ``SolverConfig()``) a
box mesh takes the XLA structured path, whose layout is the interleaved one
(``xla`` set): torch ops only, K by ``dia_spmv`` (a roll and a
multiply-add per diagonal), G and G^T as per-direction DIA tables under F64
and as window patches otherwise, A(un) u* matrix-free per sub-iteration,
and the torch CG on the coarse Z window (``patches_spmv``) with the
multigrid V-cycle of ``ops/multigrid.py`` (``pressure_precond="auto"`` or
``"mg"``) or Jacobi.  A choice invalid for the mesh raises the JAX
package's ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.fem.assembly import (
    assemble_operators,
    elemental_gradient,
    elemental_stiffness,
)
from cfd_with_cuda_tpu_torch.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu_torch.fem.sparse import ell_from_csr
from cfd_with_cuda_tpu_torch.fem.structured import (
    detect_promoted_box,
    dia_from_csr,
    shard_pad_size,
)
from cfd_with_cuda_tpu_torch.mesh.profiles import apply_inlet_profile
from cfd_with_cuda_tpu_torch.mesh.topology import (
    face_bc_to_node_bc,
    find_monitor_node,
    promote_hex_mesh,
)
from cfd_with_cuda_tpu_torch.ops import parity_stencil as pstl
from cfd_with_cuda_tpu_torch.ops import spmv
from cfd_with_cuda_tpu_torch.ops.banded import banded_from_csr, banded_spmv
from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg, fused_cg_plain, half_window
from cfd_with_cuda_tpu_torch.ops.krylov import cg
from cfd_with_cuda_tpu_torch.ops.multigrid import make_vcycle
from cfd_with_cuda_tpu_torch.ops.stencil import (
    assemble_compact_values,
    coarse_to_fine,
    convection_apply_elem,
    convection_elem_matrices,
    dia_spmv,
    patches_spmv,
)
from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    compact_g_window,
    compact_gt_window,
    compact_spmv_oij,
    div_compact_interleaved,
    div_compact_interleaved_plain,
    grad_window_compact,
    grad_window_compact_plain,
    window_spmv_compact,
    window_spmv_compact_plain,
)
from cfd_with_cuda_tpu_torch.parallel.elem_slab import slab_field, slab_rows, slab_to_block
from cfd_with_cuda_tpu_torch.parallel.placed_ops import dia_spmv_placed
from cfd_with_cuda_tpu_torch.parallel.sharded_stencil import (
    sharded_div_compact,
    sharded_grad_compact,
    sharded_spmv_compact,
)
from cfd_with_cuda_tpu_torch.solvers.base import (
    ChunkedTimeLoop,
    StepStats,
    compact_spmv_tables,
    kernel_path,
    xla_attach_multigrid,
    xla_g_tables,
    xla_grad_div,
)
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

__all__ = ["ExplicitState", "StepStats", "ExplicitBCHSolver"]


class ExplicitState(NamedTuple):
    """Solution state (device tensors), as the JAX package's.

    ``unp1_prev`` persists across steps (the reference resets only
    ``UnpHalf_prev``/``Acc_prev`` per step, ``timeLoop`` :2872-2880);
    ``pdot``/``pdot_nm1`` warm-start the next step's first pressure solve.
    """

    un: torch.Tensor         # (3, 8, Sp) parity / (3, s_pad) interleaved / (3, NN) ell
    pn: torch.Tensor         # (NNp,) pressure at time n (coarse grid order on a box)
    unp1_prev: torch.Tensor
    pdot: torch.Tensor
    pdot_nm1: torch.Tensor


# on the parity layout the convection planes stream through parity_apply up
# to this coarse size; above it the flat matrix-free form (explicit_bch.py:906)
_PLANES_MAX_SP = 100_000


class ExplicitBCHSolver(ChunkedTimeLoop):
    """Setup once from a deck, then run chunks of time steps.

    ``device=None`` runs on the CUDA card (raises without one);
    ``device="cpu"`` runs every kernel's plain PyTorch version.
    ``plain=True`` runs the plain versions on any device (the reference
    path the kernels are held against on the card).
    """

    # static attributes that define a set-up solver besides its tables, by
    # layout (interop carries the JAX solver's across)
    STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims",
        "coarse_dims", "elem_dims", "z_radius", "sp_c", "k_pairs", "g_pairs",
        "mon_cls", "mon_q", "monitor_node_p", "conv_i_order", "conv_groups",
        "conv_pairs2",
    )
    INTERLEAVED_STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims",
        "coarse_dims", "elem_dims", "elem_structured", "local_off", "k_offsets",
        "z_radius", "g_radius", "s_pad", "conv_oij", "monitor_node", "monitor_node_p",
    )
    XLA_STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims", "coarse_dims",
        "elem_dims", "elem_structured", "local_off", "k_offsets", "z_radius", "g_radius",
        "gt_radius", "s_pad", "monitor_node", "monitor_node_p", "f64_dia", "g_dia_off",
        "gt_dia_off", "use_mg", "mg_dims", "mg_radii", "mg_omegas",
    )
    ELL_STATIC_ATTRS = ("nn", "nnp", "dt", "pin", "monitor_node", "monitor_node_p", "z_offs",
                        "s_pad")

    # ------------------------------------------------------------------ setup
    def _setup(self) -> None:
        deck = self.deck
        cfg = self.config

        mesh = promote_hex_mesh(deck.conn, deck.coords)
        self.mesh = mesh
        self.nn, self.nnp = mesh.nn, deck.nnp
        tab = build_element_tables(
            mesh.coords, mesh.ltog_node, etype=deck.etype,
            nenv=deck.nenv, nenp=deck.nenp, ngp=deck.ngp,
        )
        self.tables = tab
        ops = assemble_operators(
            tab, mesh.ltog_node, mesh.nn, self.nnp,
            viscosity=deck.viscosity, density=deck.density,
        )
        self.ops = ops

        bc_of_node = face_bc_to_node_bc(
            mesh.ltog_node, deck.bc_vel_faces, mesh.nn,
            quadratic=deck.nenv != deck.nenp,
        )
        self.bc_of_node = bc_of_node
        is_bc = bc_of_node >= 0
        bc_vel = np.zeros((mesh.nn, 3))
        bc_vel[is_bc] = deck.bc_str[bc_of_node[is_bc]]
        apply_inlet_profile(deck, mesh.coords, bc_of_node, bc_vel)

        # lumped mass with/without BC rows (ref step0 :3281-3295)
        md = ops.Md.copy()
        md_orig_inv = 1.0 / md
        md[is_bc] = 1.0
        md_inv = 1.0 / md

        # pressure pin: LARGE * Z[pin, pin]  (ref applyBC_Step2(1))
        Z = ops.Z.tocsr().copy()
        pin = deck.zero_pressure_node
        if pin >= 0:
            Z[pin, pin] = Z[pin, pin] * cfg.pressure_pin_large

        # ---- box-grid structure (_try_structured): the parity layout on an
        # element-structured box, the interleaved layout on another box or
        # when asked for, else the unstructured ELL path
        box = None
        if cfg.structured != "never":
            box = detect_promoted_box(mesh.coords, self.nnp, mesh.ltog_node)
        dias = None
        if box is not None:
            dias = (
                dia_from_csr(ops.pattern_m.to_scipy(ops.K), box.perm, box.perm, box.fine_dims),
                dia_from_csr(Z, box.perm_p, box.perm_p, box.coarse_dims),
                [dia_from_csr(ops.G_csr(d), box.perm, box.embed, box.fine_dims)
                 for d in range(3)],
                [dia_from_csr(ops.G_csr(d).T.tocsr(), box.embed, box.perm, box.fine_dims)
                 for d in range(3)],
            )
            if any(x is None for x in [dias[0], dias[1], *dias[2], *dias[3]]):
                dias = None
        if dias is None:
            d = self._setup_ell
        elif not kernel_path(cfg):
            d = self._setup_xla
        elif (box.elem_perm is not None and cfg.structured_layout != "interleaved"
              and self.spmd_mesh is None):
            d = self._setup_parity
        else:
            d = self._setup_interleaved
        # host tables; the base class snapshots them and moves them to the device
        self.d = d(tab, box, dias, Z, is_bc, bc_vel, md_inv, md_orig_inv)
        self.dt = float(deck.dt)

    def _setup_parity(self, tab, box, dias, Z, is_bc, bc_vel, md_inv, md_orig_inv) -> dict:
        """Tables of the parity layout (the parity branch of the JAX
        package's ``_try_structured``, explicit_bch.py:320-591)."""
        self._set_layout("parity")
        deck, cfg, mesh = self.deck, self.config, self.mesh
        dtype = cfg.np_dtype()
        pin = deck.zero_pressure_node
        # the JAX package asserts both (explicit_bch.py:521, :544)
        not_box = ValueError("this box mesh has no parity route")
        k_dia, z_dia, g_dias, gt_dias = dias
        fx, fy, fz = box.fine_dims
        cx, cy, cz = box.coarse_dims
        perm, perm_p = box.perm, box.perm_p
        self.perm, self.perm_p = perm, perm_p
        self.fine_dims, self.coarse_dims = box.fine_dims, box.coarse_dims
        self.elem_dims = box.elem_dims
        self.z_radius = z_dia.radius
        g_radius = max(g.radius for g in g_dias)
        gt_radius = max(g.radius for g in gt_dias)

        permute_vec = box.permute_vec
        dev = lambda x: np.asarray(x, dtype=dtype)
        z_diag = box.permute_vec_p(np.asarray(Z.diagonal()))
        sv_t, gDSv_t, gq_t = box.elem_grid_tables(tab)

        (pcx, pcy, pcz), sp_c = pstl.parity_dims(box.fine_dims)
        if (pcx, pcy, pcz) != (cx, cy, cz):
            raise not_box
        self.sp_c = sp_c
        offs_k = pstl.decode_offsets(k_dia.flat_offsets, box.fine_dims)
        kc, self.k_pairs = pstl.build_parity_apply_tables(
            dev(k_dia.vals), offs_k, box.fine_dims
        )
        offs_g = tuple(
            (dx, dy, dz)
            for dz in range(-g_radius, g_radius + 1)
            for dy in range(-g_radius, g_radius + 1)
            for dx in range(-g_radius, g_radius + 1)
        )
        g_win = dev(np.stack([g.window_vals(g_radius, dtype) for g in g_dias]))
        gc, self.g_pairs = pstl.build_parity_apply_tables(g_win, offs_g, box.fine_dims)
        # grad reads ONLY the coarse pressure (class 0): the step passes it
        # as a (1, 1, Sp) plane
        if any(pp != 0 for cls in self.g_pairs for (_, pp, _) in cls):
            raise not_box
        gt_win = dev(np.stack([g.window_vals(gt_radius, dtype) for g in gt_dias]))
        split = lambda v: pstl.parity_split_table(dev(v), box.fine_dims, sp_c)
        d = {
            "Kp": dev(kc),
            "Gp": dev(gc),
            "GT_cwin": dev(compact_gt_window(gt_win, box.fine_dims, box.coarse_dims)),
            "md_inv_p": split(permute_vec(md_inv)),
            "md_orig_inv_p": split(permute_vec(md_orig_inv)),
            "bc_mask_p": split(permute_vec(np.where(is_bc, 0.0, 1.0))),
            "bc_vel_p": split(np.stack([permute_vec(bc_vel[:, i]) for i in range(3)])),
            "Sv": dev(sv_t),
            # element tables re-embedded on the coarse-flat axis
            "gDSv_p": pstl.embed_elem_table(dev(gDSv_t), box.elem_dims, box.coarse_dims, sp_c),
            "gq_p": pstl.embed_elem_table(dev(gq_t), box.elem_dims, box.coarse_dims, sp_c),
            # the pressure CG's plain (W^3, NNp) window and inverse diagonal
            "Z_win": dev(z_dia.window_vals(dtype=dtype)),
            "Z_dinv": dev(1.0 / z_diag),
        }
        if cfg.pressure_cg_sym:
            # only the dq >= 0 half is kept (symmetry checked here)
            d["Z_win"] = half_window(d["Z_win"], box.coarse_dims, z_dia.radius)
        self.pin_grid = int(perm_p[pin]) if pin >= 0 else -1
        mon = find_monitor_node(
            deck.coords,
            deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3,
        )
        monitor_node = int(perm[mon])
        # pressure lives on the COARSE grid in perm_p order
        self.monitor_node_p = int(perm_p[mon])
        mx, my, mz = monitor_node % fx, (monitor_node // fx) % fy, monitor_node // (fx * fy)
        self.mon_cls = ((mz & 1) * 2 + (my & 1)) * 2 + (mx & 1)
        self.mon_q = ((mz >> 1) * cy + (my >> 1)) * cx + (mx >> 1)
        (self.conv_i_order, self.conv_groups,
         self.conv_pairs2) = pstl.build_conv_plane_route(box.local_off, box.coarse_dims)
        return d

    def _setup_interleaved(self, tab, box, dias, Z, is_bc, bc_vel, md_inv, md_orig_inv) -> dict:
        """Tables of the interleaved layout (the JAX package's
        ``_try_structured`` on its kernel path, explicit_bch.py:320-505,
        less the multigrid branch :497-504, which that path never takes):
        the K DIA table, the G and G^T windows, the compact G^T rows and the
        coarse Z window, every fine-grid table padded to s_pad; the element
        tables in element-grid order (element-major node tables on a box
        whose elements do not tile it)."""
        self._set_layout("interleaved")
        deck, cfg, mesh = self.deck, self.config, self.mesh
        dtype = cfg.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        k_dia, z_dia, g_dias, gt_dias = dias
        fx, fy, _ = box.fine_dims
        self.perm, self.perm_p = box.perm, box.perm_p
        self.fine_dims, self.coarse_dims = box.fine_dims, box.coarse_dims
        self.elem_structured = box.elem_perm is not None
        self.elem_dims, self.local_off = box.elem_dims, box.local_off
        self.k_offsets = k_dia.flat_offsets
        self.z_radius = z_dia.radius
        self.g_radius = max(g.radius for g in g_dias)
        gt_radius = max(g.radius for g in gt_dias)
        size = box.size
        self.s_pad = shard_pad_size(size, cfg, True)
        pad = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, self.s_pad - size)])
        permute_vec = box.permute_vec
        z_diag = box.permute_vec_p(np.asarray(Z.diagonal()))
        gt_win = dev(np.stack([g.window_vals(gt_radius, dtype) for g in gt_dias]))
        g_win = pad(dev(np.stack([g.window_vals(self.g_radius, dtype) for g in g_dias])))
        d = {
            "K_vals": pad(dev(k_dia.vals)),
            "G_win": g_win,
            # G's rows read the even fine nodes only: the class-compacted window
            "G_cwin": compact_g_window(g_win, box.fine_dims, self.g_radius)[0],
            "GT_win": pad(gt_win),
            # divergence rows exist only at the embedded coarse positions
            "GT_cwin": dev(compact_gt_window(gt_win, box.fine_dims, box.coarse_dims)),
            "Z_win": dev(z_dia.window_vals(dtype=dtype)),
            "Z_dinv": dev(1.0 / z_diag),
            "md_inv": pad(dev(permute_vec(md_inv))),
            "md_orig_inv": pad(dev(permute_vec(md_orig_inv))),
            "bc_mask": pad(dev(permute_vec(np.where(is_bc, 0.0, 1.0)))),
            "bc_vel": pad(dev(np.stack([permute_vec(bc_vel[:, i]) for i in range(3)]))),
        }
        if cfg.pressure_cg_sym:
            d["Z_win"] = half_window(d["Z_win"], box.coarse_dims, z_dia.radius)
        if self.elem_structured:
            d |= dict(zip(("Sv", "gDSv", "gq"), map(dev, box.elem_grid_tables(tab))))
            # entry (i, j) of every element lands at the fixed K offset
            # fo(j) - fo(i): the "assemble" form adds A(un) into K's rows
            fo = [ox + fx * (oy + fy * oz) for (ox, oy, oz) in self.local_off]
            slot = {o: k for k, o in enumerate(self.k_offsets)}
            self.conv_oij = tuple(tuple(slot[fo[j] - fo[i]] for j in range(len(fo)))
                                  for i in range(len(fo)))
            # every entry lands on a slot its row's class keeps (raises if not)
            compact_spmv_oij(self.conv_oij, self.local_off, self.k_offsets, box.fine_dims)
        else:
            # the elemental convection of ops/spmv.py on grid-order node ids
            ltog = np.asarray(box.perm[mesh.ltog_node], dtype=np.int32)     # (NE, 27)
            d |= {"ltog": ltog, "rev": spmv.build_reverse_incidence(ltog, size),
                  "Sv": dev(tab.Sv), "gDSv": dev(np.transpose(tab.gDSv, (0, 3, 2, 1))),
                  "gq": dev(tab.gq_factor)}
            self.conv_oij = None
        # K on its class-compacted, class-major table (the window SPMV's)
        d |= compact_spmv_tables(d, self.k_offsets, box.fine_dims)
        pin = deck.zero_pressure_node
        self.pin_grid = int(box.perm_p[pin]) if pin >= 0 else -1
        mon = find_monitor_node(
            deck.coords,
            deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3,
        )
        self.monitor_node = int(box.perm[mon])
        # pressure lives on the COARSE grid in perm_p order
        self.monitor_node_p = int(box.perm_p[mon])
        return d

    def _setup_xla(self, tab, box, dias, Z, is_bc, bc_vel, md_inv, md_orig_inv) -> dict:
        """Tables of the XLA structured path (the JAX package's
        ``_try_structured`` off its kernel path, explicit_bch.py:320-503):
        the K DIA table, the coarse Z window and diagonal, G and G^T as
        per-direction DIA tables under F64 (``f64_dia``: the window-patches
        form would extract a (3, 125, S) patch tensor per apply) or as
        windows otherwise, the mass and BC vectors, every fine-grid table
        padded to ``s_pad`` (a ``shard_pad`` multiple, no block padding),
        the element tables as the interleaved layout has them, and the
        multigrid ladder of the pinned, grid-ordered Z under
        ``pressure_precond="auto"`` or ``"mg"``."""
        self._set_layout("interleaved", xla=True)
        deck, cfg, mesh = self.deck, self.config, self.mesh
        dtype = cfg.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        k_dia, z_dia, g_dias, gt_dias = dias
        fx, fy, _ = box.fine_dims
        self.perm, self.perm_p = box.perm, box.perm_p
        self.fine_dims, self.coarse_dims = box.fine_dims, box.coarse_dims
        self.elem_structured = box.elem_perm is not None
        self.elem_dims, self.local_off = box.elem_dims, box.local_off
        self.k_offsets = k_dia.flat_offsets
        self.z_radius = z_dia.radius
        self.g_radius = max(g.radius for g in g_dias)
        self.gt_radius = max(g.radius for g in gt_dias)
        size = box.size
        self.s_pad = shard_pad_size(size, cfg, False)
        pad = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, self.s_pad - size)])
        permute_vec = box.permute_vec
        gw = xla_g_tables(self, g_dias, gt_dias, dtype, pad)
        d = gw | {
            "K_vals": pad(dev(k_dia.vals)),
            "Z_win": dev(z_dia.window_vals(dtype=dtype)),
            "Z_diag": dev(box.permute_vec_p(np.asarray(Z.diagonal()))),
            "md_inv": pad(dev(permute_vec(md_inv))),
            "md_orig_inv": pad(dev(permute_vec(md_orig_inv))),
            "bc_mask": pad(dev(permute_vec(np.where(is_bc, 0.0, 1.0)))),
            "bc_vel": pad(dev(np.stack([permute_vec(bc_vel[:, i]) for i in range(3)]))),
        }
        if self.elem_structured:
            d |= dict(zip(("Sv", "gDSv", "gq"), map(dev, box.elem_grid_tables(tab))))
        else:
            # the elemental convection of ops/spmv.py on grid-order node ids
            ltog = np.asarray(box.perm[mesh.ltog_node], dtype=np.int32)     # (NE, 27)
            d |= {"ltog": ltog, "rev": spmv.build_reverse_incidence(ltog, size),
                  "Sv": dev(tab.Sv), "gDSv": dev(np.transpose(tab.gDSv, (0, 3, 2, 1))),
                  "gq": dev(tab.gq_factor)}
        pin = deck.zero_pressure_node
        self.pin_grid = int(box.perm_p[pin]) if pin >= 0 else -1
        mon = find_monitor_node(
            deck.coords,
            deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3,
        )
        self.monitor_node = int(box.perm[mon])
        # pressure lives on the COARSE grid in perm_p order
        self.monitor_node_p = int(box.perm_p[mon])
        # the V-cycle on the pinned Z in grid order (explicit_bch.py:491-503)
        xla_attach_multigrid(self, d, Z, box, dtype, cfg.pressure_precond in ("auto", "mg"))
        return d

    def _setup_ell(self, tab, box, dias, Z, is_bc, bc_vel, md_inv, md_orig_inv) -> dict:
        """Tables of the unstructured path (explicit_bch.py:209-310):
        element-major elemental K and G with their reverse-incidence
        scatter tables, the ELL Z, and the banded window of Z when the
        numbering bounds its offsets.  The node axis of the per-node vectors
        is padded to ``s_pad``, a ``shard_pad`` multiple (explicit_bch.py:
        293-311): padded rows carry ``md_inv`` 1 and ``bc_mask`` 0, so the
        fields stay zero there."""
        self._set_layout("ell")
        deck, cfg, mesh = self.deck, self.config, self.mesh
        dtype = cfg.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        z_ell = ell_from_csr(Z.indptr.astype(np.int64), Z.indices.astype(np.int64), Z.data,
                             n_cols=self.nnp)
        ltog = np.asarray(mesh.ltog_node, dtype=np.int32)               # (NE, 27)
        ltog_p = np.ascontiguousarray(ltog[:, : deck.nenp])             # (NE, 8)
        d = {
            "ltog": ltog,
            "ltog_p": ltog_p,
            "rev": spmv.build_reverse_incidence(ltog, mesh.nn),
            "rev_p": spmv.build_reverse_incidence(ltog_p, self.nnp),
            "Sv": dev(tab.Sv),
            "gDSv": dev(np.transpose(tab.gDSv, (0, 3, 2, 1))),         # (NE, 3, 27, NGP)
            "gq": dev(tab.gq_factor),                                  # (NE, NGP)
            "Ke": dev(elemental_stiffness(tab, deck.viscosity)),       # (NE, 27, 27)
            "Ge": dev(np.transpose(elemental_gradient(tab, deck.density), (1, 0, 2, 3))),
            "Z_vals": dev(z_ell.vals),
            "Z_cols": np.asarray(z_ell.cols),
            "Z_diag": dev(Z.diagonal()),
            "md_inv": dev(md_inv),
            "md_orig_inv": dev(md_orig_inv),
            "bc_mask": dev(np.where(is_bc, 0.0, 1.0)),
            "bc_vel": dev(bc_vel.T),
        }
        # the f32 reciprocal of the f32 diagonal, as the JAX package divides
        # per solve
        d["Z_dinv"] = np.ones((), dtype) / d["Z_diag"]
        self.pin = deck.zero_pressure_node
        self.monitor_node = find_monitor_node(
            deck.coords, deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3
        )
        # pressure monitor: corner node ids < NNp index pn directly
        self.monitor_node_p = self.monitor_node
        banded = banded_from_csr(Z, max_offsets=512)
        self.z_offs = None
        if banded is not None:
            self.z_offs, z_bwin = banded
            d["Z_bwin"] = dev(z_bwin)
        self.s_pad = shard_pad_size(mesh.nn, cfg, False)
        e = self.s_pad - mesh.nn
        for k in ("md_inv", "md_orig_inv", "bc_mask", "bc_vel"):
            fill = 1.0 if k.startswith("md") else 0.0
            d[k] = np.pad(d[k], [(0, 0)] * (d[k].ndim - 1) + [(0, e)], constant_values=fill)
        return d

    def _spmv_offsets(self):
        return self.k_offsets

    # ----------------------------------------------------------- initial state
    def initial_state(self) -> ExplicitState:
        """Zero field with BC velocities imposed (``applyBC_initial``)."""
        un = self.d["bc_vel_p" if self.layout == "parity" else "bc_vel"].clone()
        pn = torch.zeros(self.nnp, dtype=un.dtype, device=self.device)
        return ExplicitState(un, pn, torch.zeros_like(un), torch.zeros_like(pn),
                             torch.zeros_like(pn))

    def state_from_fields(self, u: np.ndarray, p: np.ndarray) -> ExplicitState:
        """u as (NN, 3) and p as (NNp,) in deck node order."""
        dtype = self.config.np_dtype()
        u = np.asarray(u).T
        p = np.asarray(p)
        if self.layout != "ell":
            n = self.s_pad if self.layout == "interleaved" else int(np.prod(self.fine_dims))
            ug = np.zeros((3, n), dtype=u.dtype)
            ug[:, self.perm] = u
            pg = np.empty_like(p)
            pg[self.perm_p] = p
            u, p = ug, pg
            if self.layout == "parity":
                u = pstl.parity_split_table(u, self.fine_dims, self.sp_c)
        else:
            u = np.pad(u, ((0, 0), (0, self.s_pad - self.nn)))      # the shard padding
        un = self._local(torch.from_numpy(np.ascontiguousarray(u, dtype=dtype))).to(self.device)
        pn = torch.from_numpy(np.ascontiguousarray(p, dtype=dtype)).to(self.device)
        return ExplicitState(un, pn, torch.zeros_like(un), torch.zeros_like(pn),
                             torch.zeros_like(pn))

    # ------------------------------------------------------------- one step
    def _box_pressure_solve(self, d):
        """The pressure CG of the box layouts: the CG kernels on the coarse
        Z window (its dq >= 0 half under ``pressure_cg_sym``)."""
        cfg = self.config
        cg_solve = fused_cg_plain if self.plain else fused_cg

        def pressure_solve(r2, x0):
            return cg_solve(
                d["Z_win"], r2, d["Z_dinv"], dims=self.coarse_dims,
                radius=self.z_radius, tol=cfg.pressure_cg_tol,
                maxiter=cfg.pressure_cg_maxiter,
                x0=x0 if cfg.pressure_warm_start else None,
                unroll=max(1, int(cfg.pressure_cg_unroll)),
                fuse_loop=cfg.pressure_cg_fuse_loop,
                sym=cfg.pressure_cg_sym,
                # MIXED policy: f64-accumulated dots inside the kernels
                dot_mode="compensated" if cfg.krylov_dot_dtype() is not None else "plain",
            )
        return pressure_solve

    def _parity_operators(self, d, un):
        """(K, K + A(un), G, G^T, pressure solve, probe) of the parity layout."""
        cfg = self.config
        sp_c = self.sp_c
        # the wrappers run the kernels on CUDA tensors and the plain
        # versions on CPU tensors; `plain` forces the plain versions
        apply = pstl.parity_apply_plain if self.plain else pstl.parity_apply
        div_apply = pstl.parity_div_apply_plain if self.plain else pstl.parity_div_apply

        k_mul = lambda u: apply(d["Kp"], u, pairs=self.k_pairs, co=3)

        def grad(p):
            xp = torch.nn.functional.pad(p, (0, sp_c - p.shape[0]))[None, None]
            return apply(d["Gp"], xp, pairs=self.g_pairs, co=3)

        div = lambda u: div_apply(d["GT_cwin"], u, self.coarse_dims)[: self.nnp]

        # convection A(un), once per step (un is fixed across the
        # sub-iterations; ref calculateMatrixA uses Un :3520-3685): as 729
        # weight planes streamed through parity_apply with K, or matrix-free
        # (flat gather, einsum, scatter) under conv_mode="matrix-free" and
        # above _PLANES_MAX_SP (explicit_bch.py:888-936)
        planes = cfg.conv_mode == "planes" or (
            cfg.conv_mode != "matrix-free" and sp_c <= _PLANES_MAX_SP)
        gather = lambda u: pstl.parity_gather_elem_flat(u, self.coarse_dims)
        ae = self._parity_conv_ae(d, un, planes)
        if planes:
            conv_wc = pstl.conv_planes_from_ae(ae, groups=self.conv_groups)
            ka_mul = lambda u: apply(d["Kp"], u, pairs=self.k_pairs, co=3,
                                     wc2=conv_wc, pairs2=self.conv_pairs2)
        else:
            def ka_mul(u):
                r1e = torch.einsum("ije,dje->die", ae, gather(u))
                return k_mul(u) + pstl.parity_scatter_elem_flat(r1e, self.coarse_dims)

        probe = lambda u: u[:, self.mon_cls, self.mon_q]
        masks = tuple(d[k][None] for k in ("bc_mask_p", "md_inv_p", "md_orig_inv_p"))
        return (k_mul, ka_mul, grad, div, self._box_pressure_solve(d), probe, masks,
                self.pin_grid)

    def _parity_conv_ae(self, d, un, planes: bool):
        """A(un) per element, ``ae (27, 27, Sp)`` on the embedded element
        axis; its i axis in ``conv_i_order`` for the planes route."""
        cfg = self.config
        sv, gtab, qtab = d["Sv"], d["gDSv_p"], d["gq_p"]
        u0_e = pstl.parity_gather_elem_flat(un, self.coarse_dims)
        u0_gq = torch.einsum("ki,die->dke", sv, u0_e)
        udotg = torch.einsum("dke,djke->jke", u0_gq, gtab)
        if cfg.conv_stab:
            # Temam (div u0) Sv_i Sv_j stabilization
            div0 = torch.einsum("djke,dje->ke", gtab, u0_e)
            udotg = udotg + cfg.conv_stab * div0[None] * sv.T[:, :, None]
        sv_i = sv[:, list(self.conv_i_order)] if planes else sv
        return torch.einsum("ki,ke,jke->ije", sv_i, qtab, udotg)

    def _interleaved_operators(self, d, un):
        """The same on the interleaved layout (explicit_bch.py:839-867,
        937-977, 1105-1110): K and K + A through ``window_spmv_compact`` on
        the class-compacted table (K + A assembled straight into it), G through
        ``grad_window_compact`` on the embedded pressure, G^T through
        ``div_compact_interleaved``."""
        cfg = self.config
        fine, nn, s_pad = self.fine_dims, self.nn, self.s_pad
        pad = lambda y: torch.nn.functional.pad(y, (0, s_pad - y.shape[-1]))
        # the wrappers run the kernels on CUDA tensors and the plain
        # versions on CPU tensors; `plain` forces the plain versions
        spmv_w = window_spmv_compact_plain if self.plain else window_spmv_compact
        grad_w = grad_window_compact_plain if self.plain else grad_window_compact
        div_c = div_compact_interleaved_plain if self.plain else div_compact_interleaved

        k_mul = lambda u: spmv_w(d["K_cvals"], u, fine, offsets=self.k_offsets, trim=False,
                                 name="window_spmv_k")

        def grad(p):
            pf = pad(coarse_to_fine(p, self.coarse_dims, fine))
            return grad_w(d["G_cwin"], pf, fine, self.g_radius, trim=False)

        div = lambda u: div_c(d["GT_cwin"], u, fine, self.coarse_dims)[: self.nnp]

        if not self.elem_structured:
            # no element tiling: the elemental convection on grid-order ids
            conv = self._elemental_convection(d, un)
            ka_mul = lambda u: k_mul(u) + conv(u)
        else:
            # A_e(un) once per step (elements in element-grid order)
            ae = convection_elem_matrices(un[:, :nn], d["Sv"], d["gDSv"], d["gq"],
                                          self.elem_dims, fine, stab_coef=cfg.conv_stab)
            if cfg.conv_mode == "assemble":
                # A_e into K's compact rows: (K + A) u* is ONE window apply
                coij = compact_spmv_oij(self.conv_oij, self.local_off, self.k_offsets, fine)
                ka_vals = d["K_cvals"] + assemble_compact_values(
                    ae, self.local_off, coij, self.k_offsets, self.elem_dims, fine, s_pad)
                ka_mul = lambda u: spmv_w(ka_vals, u, fine, offsets=self.k_offsets, trim=False,
                                          name="window_spmv_k_plus_a")
            else:
                # matrix-free: gather -> per-element matvec -> parity-grouped scatter
                ka_mul = lambda u: k_mul(u) + pad(convection_apply_elem(
                    ae, u[:, :nn], self.local_off, self.elem_dims, fine))

        probe = lambda u: u[:, self.monitor_node]
        masks = tuple(d[k][None] for k in ("bc_mask", "md_inv", "md_orig_inv"))
        return (k_mul, ka_mul, grad, div, self._box_pressure_solve(d), probe, masks,
                self.pin_grid)

    def _sharded_operators(self, d, un):
        """The same on the sharded kernel path (explicit_bch.py:805-850,
        947-960, 1042-1060 of the JAX package), on this rank's block ``un (3,
        s_loc)``: K and K + A through ``sharded_spmv_compact`` on the compact
        table of the rank's rows (a halo exchange a call), G through
        ``sharded_grad_compact`` on its columns of ``G_cwin`` (the replicated
        embedded pressure, no collective), G^T through
        ``sharded_div_compact`` (the rank's coarse rows, then an all-gather);
        A_e(un) once a step on the rank's element slab (an element halo
        exchange), assembled into the rank's compact rows or applied
        matrix-free (another element halo exchange a sub-iteration); the
        pressure CG replicated; the monitor broadcast from its rank."""
        cfg, mesh, slab, plain = self.config, self.ranks, self.slab, self.plain
        fine, coarse, s_pad = self.fine_dims, self.coarse_dims, self.s_pad

        def spmv(tab, u, name):
            return sharded_spmv_compact(tab, u, fine, offsets=self.k_offsets, mesh=mesh,
                                        s_pad=s_pad, name=name, plain=plain)

        k_mul = lambda u: spmv(d["K_cvals"], u, "sharded_spmv_k")

        def grad(p):
            pf = torch.nn.functional.pad(coarse_to_fine(p, coarse, fine),
                                         (0, s_pad - self.nn))
            return sharded_grad_compact(d["G_cwin"], pf, fine, self.g_radius, mesh=mesh,
                                        plain=plain)

        div = lambda u: sharded_div_compact(d["GT_cwin"], u, fine, coarse, mesh=mesh,
                                            s_pad=s_pad, plain=plain)
        if not self.elem_structured:
            # no element tiling: the elements that touch the rank's rows
            conv = self._elemental_convection(d, un)
            ka_mul = lambda u: k_mul(u) + conv(u)
        elif cfg.conv_mode == "assemble":
            ae, _ = self._slab_convection(d, un)
            coij = compact_spmv_oij(self.conv_oij, self.local_off, self.k_offsets, fine)
            conv = assemble_compact_values(ae, self.local_off, coij, self.k_offsets,
                                           slab.elem_dims, slab.fine_dims,
                                           slab.size) if slab.size else un.new_zeros(0)
            ka_vals = d["K_cvals"] + slab_to_block(conv, slab, self.k_offsets, fine, s_pad)
            ka_mul = lambda u: spmv(ka_vals, u, "sharded_spmv_k_plus_a")
        else:
            _, conv = self._slab_convection(d, un)
            ka_mul = lambda u: k_mul(u) + conv(u)
        probe = lambda u: self._probe(u, self.monitor_node)
        masks = tuple(d[k][None] for k in ("bc_mask", "md_inv", "md_orig_inv"))
        return (k_mul, ka_mul, grad, div, self._box_pressure_solve(d), probe, masks,
                self.pin_grid)

    def _slab_convection(self, d, un):
        """``(ae, apply)``: A_e(un) on this rank's element slab and the
        matrix-free A(un) u of the rank's rows from its block ``u``, each an
        element halo exchange that every rank takes part in (a rank without
        grid rows has no elements)."""
        slab, mesh = self.slab, self.ranks
        u_slab = slab_field(un, slab, mesh)
        ae = None if not slab.size else convection_elem_matrices(
            u_slab, d["Sv"], d["gDSv"], d["gq"], slab.elem_dims, slab.fine_dims,
            stab_coef=self.config.conv_stab)

        def apply(u):
            u_s = slab_field(u, slab, mesh)
            if not slab.size:
                return torch.zeros_like(u)
            return slab_rows(convection_apply_elem(ae, u_s, self.local_off, slab.elem_dims,
                                                   slab.fine_dims), slab)
        return ae, apply

    def _elemental_convection(self, d, un):
        """A(un) u of the rows this process holds, matrix-free through the
        element tables of ``ops/spmv.py`` on grid-order node ids (a box whose
        elements do not tile it): on split fields the elements that touch
        the rank's rows, applied to the all-gathered fields (owner computes)."""
        un_f = self._full(un)
        return lambda u: self._pad_rows(spmv.convection_apply(
            un_f, self._full(u), d["ltog"], d["Sv"], d["gDSv"], d["gq"], d["rev"],
            stab_coef=self.config.conv_stab))

    def _xla_operators(self, d, un):
        """The same on the XLA structured path (explicit_bch.py:655-743,
        1086-1110): K by ``dia_spmv``, Z by ``patches_spmv``, G and G^T in
        roll form under F64 and in window-patches form otherwise, A(un) u*
        matrix-free per sub-iteration, and the torch CG with the V-cycle
        (or Jacobi) preconditioner.  Placed across ranks
        (``parallel/placement.py``): K, G and G^T on the rank's rows
        (``parallel/placed_ops.py``), the convection on its element slab,
        the pressure solve replicated."""
        cfg = self.config
        fine, coarse, nn, s_pad = self.fine_dims, self.coarse_dims, self.nn, self.s_pad
        pad = lambda y: torch.nn.functional.pad(y, (0, s_pad - y.shape[-1]))
        if self.block is None:
            k_mul = lambda u: dia_spmv(d["K_vals"], u, self.k_offsets)
        else:
            k_mul = lambda u: dia_spmv_placed(d["K_vals"], u, self.k_offsets, self.ranks)
        z_mul = lambda p: patches_spmv(d["Z_win"], p, coarse, self.z_radius)
        grad, div = xla_grad_div(self, d, nn)
        if not self.elem_structured:
            conv = self._elemental_convection(d, un)
        elif self.block is not None:
            _, conv = self._slab_convection(d, un)
        else:
            # A_e(un) once per step; A(un) u* matrix-free per sub-iteration
            # (the JAX package's convection_apply_stencil)
            ae = convection_elem_matrices(un[:, :nn], d["Sv"], d["gDSv"], d["gq"],
                                          self.elem_dims, fine, stab_coef=cfg.conv_stab)
            conv = lambda u: pad(convection_apply_elem(ae, u[:, :nn], self.local_off,
                                                       self.elem_dims, fine))
        ka_mul = lambda u: k_mul(u) + conv(u)
        if self.use_mg:
            precond = make_vcycle(d, self.mg_dims, self.mg_radii, self.mg_omegas)
        else:
            precond = lambda r: r / d["Z_diag"]
        warm = cfg.pressure_warm_start

        def pressure_solve(r2, x0):
            return cg(z_mul, r2, x0 if warm else None, tol=cfg.pressure_cg_tol,
                      maxiter=cfg.pressure_cg_maxiter, precond=precond,
                      dot_dtype=cfg.krylov_dot_dtype())

        probe = lambda u: self._probe(u, self.monitor_node)
        masks = tuple(d[k][None] for k in ("bc_mask", "md_inv", "md_orig_inv"))
        return k_mul, ka_mul, grad, div, pressure_solve, probe, masks, self.pin_grid

    def _ell_operators(self, d, un):
        """The same on the unstructured path (explicit_bch.py:707-743,
        978-1068): elemental applies, Ke + Ae(un) built once per step, and
        the banded-window CG kernels or the torch CG (under ``spmd_devices``
        the torch CG on the banded window, explicit_bch.py:996-1005).  Fields
        are ``(3, s_pad)``, their padding rows zero.  Placed across ranks
        (``parallel/placement.py``, owner computes): K, K + A and G apply the
        elements that touch the rank's rows to the all-gathered field, G^T
        onto the replicated pressure runs whole on every rank."""
        cfg, nn = self.config, self.nn
        full = lambda u: self._full(u)[:, :nn]
        pad = self._pad_rows
        ltog, rev = d["ltog"], d["rev"]
        k_mul = lambda u: pad(spmv.elem_matvec_apply(d["Ke"], full(u), ltog, rev))
        grad = lambda p: pad(spmv.elem_grad_apply(d["Ge"], p, d["ltog_p"], rev))
        ge_div, ltog_div = (d["Ge_div"], d["ltog_div"]) if "Ge_div" in d else (d["Ge"], ltog)
        div = lambda u: spmv.elem_div_apply(ge_div, full(u), ltog_div, d["rev_p"])
        # (K + A(un)) u* is ONE elemental apply per sub-iteration (conv_mode
        # is ignored here, as in the JAX package)
        ka = d["Ke"] + spmv.convection_elemental(full(un), ltog, d["Sv"], d["gDSv"], d["gq"],
                                                 stab_coef=cfg.conv_stab)
        ka_mul = lambda u: pad(spmv.elem_matvec_apply(ka, full(u), ltog, rev))
        warm = cfg.pressure_warm_start

        if self.z_offs is not None and kernel_path(cfg) and self.spmd_mesh is None:
            cg_solve = fused_cg_plain if self.plain else fused_cg

            def pressure_solve(r2, x0):
                # the banded window on the CG kernels; pressure_cg_sym is
                # dropped here, as the JAX package drops it
                return cg_solve(
                    d["Z_bwin"], r2, d["Z_dinv"], dims=(self.nnp, 1, 1), offs=self.z_offs,
                    tol=cfg.pressure_cg_tol, maxiter=cfg.pressure_cg_maxiter,
                    x0=x0 if warm else None, unroll=max(1, int(cfg.pressure_cg_unroll)),
                    fuse_loop=cfg.pressure_cg_fuse_loop,
                    dot_mode="compensated" if cfg.krylov_dot_dtype() is not None else "plain",
                )
        else:
            if self.z_offs is not None:
                z_mul = lambda p: banded_spmv(d["Z_bwin"], self.z_offs, p)
            else:
                z_mul = lambda p: spmv.ell_spmv(d["Z_vals"], d["Z_cols"], p)

            def pressure_solve(r2, x0):
                return cg(z_mul, r2, x0 if warm else None, tol=cfg.pressure_cg_tol,
                          maxiter=cfg.pressure_cg_maxiter, precond=lambda r: r / d["Z_diag"],
                          dot_dtype=cfg.krylov_dot_dtype())

        probe = lambda u: self._probe(u, self.monitor_node)
        masks = tuple(d[k][None] for k in ("bc_mask", "md_inv", "md_orig_inv"))
        return k_mul, ka_mul, grad, div, pressure_solve, probe, masks, self.pin

    def _time_step(self, d, state: ExplicitState) -> tuple[ExplicitState, StepStats]:
        deck = self.deck
        dt = self.dt
        un, pn, unp1_prev0, pdot0, pdot_nm1 = state
        if self.config.pressure_warm_extrap and self.config.pressure_warm_start:
            pdot_init = pdot0 + (pdot0 - pdot_nm1)
        else:
            pdot_init = pdot0
        if self.spmd_mesh is not None and self.layout == "interleaved":
            operators = self._sharded_operators
        else:
            operators = self._xla_operators if self.xla else {
                "parity": self._parity_operators, "interleaved": self._interleaved_operators,
                "ell": self._ell_operators}[self.layout]
        (k_mul, ka_mul, grad, div, pressure_solve, probe,
         (mask, md_inv_b, md_orig_inv_b), pin) = operators(d, un)
        g_pn = grad(pn)                     # loop-invariant: pn is fixed

        it, conv = 1, False
        unp_half_prev, unp1_prev, pnp1_prev = un, unp1_prev0, pn
        k_acc_prev = torch.zeros_like(un)
        unp1, pnp1, cgit, pdot_prev = un, pn, 0, pdot_init
        while it <= deck.max_iter and not conv:
            # ---- step1: R1 = -(K + A(un)) u* - G pn  (ref :3712-3783)
            r1 = -ka_mul(unp_half_prev)
            r1 = r1 - g_pn
            r1 = r1 * mask
            unp_half = un + dt * r1 * md_inv_b
            # ---- step2: R2 = G^T (u*/dt^2 - MdOrigInv K acc_prev)  (:3813-3868)
            dummy = unp_half / (dt * dt) - md_orig_inv_b * k_acc_prev
            r2 = div(dummy)
            if pin >= 0:
                r2[pin] = 0.0
            sol = pressure_solve(r2, pdot_prev)
            pdot = sol.x
            pnp1 = pn + dt * pdot
            # ---- step3: R3 = -dt (G pdot + K acc_prev)  (:3917-3967)
            r3 = -dt * (grad(pdot) + k_acc_prev)
            r3 = r3 * mask
            acc = r3 * md_inv_b
            unp1 = unp_half + dt * acc
            # ---- convergence (ref :2936-2961); NaN compares False
            du, u1 = self._field_norms(unp1 - unp1_prev, unp1)
            norm1 = du / u1
            norm2 = torch.linalg.vector_norm(pnp1 - pnp1_prev) / torch.linalg.vector_norm(pnp1)
            conv = bool((norm1 < deck.tolerance) & (norm2 < deck.tolerance))
            # K acc feeds only the next sub-iteration: skipped on the
            # exiting trip (converged, or the max_iter-th)
            if not (conv or it >= deck.max_iter):
                k_acc_prev = k_mul(acc)
            if not conv:
                unp_half_prev, unp1_prev, pnp1_prev = unp_half, unp1, pnp1
            cgit, pdot_prev = sol.iters, pdot
            it += 1

        max_acc = self._field_max(torch.abs(unp1 - un)) / dt
        p_mon = self.monitor_node_p
        mon = probe(unp1)
        stats = StepStats(
            u_mon=mon[0], v_mon=mon[1], w_mon=mon[2],
            p_mon=pnp1[p_mon], max_acc=max_acc, iters=it - 1, cg_iters=cgit, mom_iters=0,
        )
        return ExplicitState(unp1, pnp1, unp1_prev, pdot_prev, pdot0), stats

    def _monitor_only(self, state: ExplicitState) -> StepStats:
        if self.layout == "parity":
            mon = state.un[:, self.mon_cls, self.mon_q]
        else:
            mon = self._probe(state.un, self.monitor_node)    # grid id on interleaved
        zero = torch.zeros((), dtype=state.un.dtype, device=self.device)
        return StepStats(mon[0], mon[1], mon[2], state.pn[self.monitor_node_p], zero, 0, 0, 0)

    # ------------------------------------------------------------------- io
    def fields(self, state: ExplicitState) -> tuple[np.ndarray, np.ndarray]:
        """(u (NN,3), p (NNp,)) as numpy, deck node order."""
        if self.layout == "ell":
            return self._full(state.un)[:, : self.nn].cpu().numpy().T, state.pn.cpu().numpy()
        if self.layout == "parity":
            u = pstl.parity_merge(state.un, self.fine_dims).cpu().numpy()
        else:
            u = self._full(state.un)[:, : self.nn].cpu().numpy()
        p = state.pn.cpu().numpy()
        return u[:, self.perm].T, p[self.perm_p]
