"""Implicit fractional-step solver (Guermond-Quartapelle incremental
pressure-correction).

Port of ``cfd_with_cuda_tpu/solvers/implicit_gq.py`` on its class-major
("parity"), interleaved and ELL branches — the rebuild of
``fractionalStep/implicit/Cpp/guermondQuartapelle.cpp``: one pass per time
step (no inner iterations, ``timeLoop`` :3308-3416),

* step1 (:3906-4083): momentum LHS  A = M/dt + K + A(u^k)  re-assembled on
  the device every step; RHS = (M/dt) u^k - G (2 p^k - p^{k-1}); Dirichlet
  rows zeroed with unit diagonal (:4622-4632) and RHS set to the BC value
  (:4634-4642); solved by Jacobi-BiCGStab.  The reference solves the three
  directions sequentially (:3972-4033) — here they ride as one batched
  (3, N) solve sharing iterations, since the LHS is identical.
* step2 (:4090-4176): R2 = -(1/dt) G^T u; CG on the *directly assembled*
  Z = -int grad Sp . grad Sp (:3579-3670) with the LARGE pressure pin;
  p^{k+1} = p^k + Pdiff.

On the parity layout (an element-structured box grid) the CUDA kernels of
a step are ``parity_apply`` (M u^k, G p, and A x twice per BiCGStab
iteration plus once for its r0), ``div_compact`` and the pressure CG
(``cg_init`` + one ``cg_iter`` per iteration by default, ``cg_solve`` with
``pressure_cg_fuse_loop``); plain torch ops build the convection planes and
merge them onto the static planes with one matmul.  Above 6 MiB (NE85184
and up, the JAX package's rule) the M and A applies stage the velocity
field through shared memory.  On the interleaved
layout (a box mesh with ``structured_layout="interleaved"``, or one where
the parity LHS assembly cannot route, as on a one-element-thin box between
opposing walls) fields are ``(3, s_pad)`` in flat grid order and the
kernels are ``window_stencil`` (M u^k, A x, and G p on the class-compacted
window) and ``div_compact`` in its
interleaved form, around the same CG; torch ops assemble A(u^k) into
the window rows (27 strided index-adds).  Under ``spmd_devices >= 1`` (the
sharded kernel path) each rank of a ``torch.distributed`` group holds its
block of the fine axis and runs that step on it (``parallel/``): the LHS
assembled from its element slab into its compact rows, A, M and G on its
rows, G^T on its coarse rows then all-gathered, the momentum solve's dots
(BiCGStab, CR or CG) summed over the ranks, the pressure CG replicated.
On the ELL layout (any other mesh, or ``structured="never"``; the JAX
package's ``_time_step_ell``) a step is torch ops only, as it is XLA ops
only in the JAX package: A(u^k) assembled into CSR values through a
reverse-incidence table, scattered into slot-major ELL, the batched
BiCGStab on the ELL SpMV and the torch CG on the ELL Z.

Deliberate divergence (kept from the JAX package): the reference's steady
check at :3347-3353 assigns ``maxAcc`` *signed* (a bug — its own explicit
solver takes |.| at ``blascoCodinaHuerta.cpp:3049-3061``), which can
spuriously stop the run; this rebuild uses the correct |.| semantics.

Off the kernel path (F64, ``pressure_backend="xla"`` or
``pressure_precond="mg"``: the JAX package's default ``SolverConfig()``) an
element-structured box takes the XLA structured path, whose layout is the
interleaved one (``xla`` set): A(u^k) assembled into the full A DIA table
each step, A and M by ``dia_spmv``, G and G^T as per-direction DIA tables
under F64 and as window patches otherwise, BiCGStab, and the torch CG on the
direct Z window with the multigrid V-cycle (``pressure_precond="mg"``, or
``"auto"`` when Z is regular) or Jacobi.  A choice invalid for the mesh
raises the JAX package's ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sps
import torch

from cfd_with_cuda_tpu_torch.fem.assembly import assemble_operators
from cfd_with_cuda_tpu_torch.fem.jacobian import build_element_tables
from cfd_with_cuda_tpu_torch.fem.sparse import ell_from_csr
from cfd_with_cuda_tpu_torch.fem.shape import HEX_FACE_ALL_NODES, HEX_FACE_CORNERS
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
from cfd_with_cuda_tpu_torch.ops.fused_cg import fused_cg, fused_cg_plain, half_window
from cfd_with_cuda_tpu_torch.ops.gradient import div_apply, grad_apply
from cfd_with_cuda_tpu_torch.ops.krylov import bicg, cg, solver_by_name
from cfd_with_cuda_tpu_torch.ops.multigrid import make_vcycle
from cfd_with_cuda_tpu_torch.ops.stencil import (
    assemble_compact_values,
    assemble_window_values,
    coarse_to_fine,
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

__all__ = ["ImplicitState", "ImplicitGQSolver"]

class ImplicitState(NamedTuple):
    uk: torch.Tensor         # (3, 8, Sp) parity / (3, s_pad) interleaved / (3, NN) ell: u^k
    pk: torch.Tensor         # (NNp,)     p^k (coarse grid order on a box)
    pk_prev: torch.Tensor    # (NNp,)     p^{k-1}


# The momentum solve passes (3, N) right-hand sides, and the JAX package's
# batched GMRES does not run: the port does not run a configuration the
# reference cannot run
_GMRES_DEFECT = (
    "momentum_solver='gmres': the JAX package's implicit step fails with it on "
    "every path (its batched GMRES, ops/krylov.py:441, vmaps with out_axes that are "
    "no prefix of KrylovResult; on the parity layout its a_mul, "
    "solvers/implicit_gq.py:752, first reshapes a single column) - a reference "
    "defect, so the port does not run it; use 'bicgstab' or 'cr'"
)


class ImplicitGQSolver(ChunkedTimeLoop):
    """Setup once from a deck, then run chunks of time steps (``device`` and
    ``plain`` as :class:`ChunkedTimeLoop`)."""

    STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims",
        "coarse_dims", "elem_dims", "z_radius", "sp_c", "a_pairs", "m_pairs",
        "g_pairs", "diag_planes", "mon_cls", "mon_q", "monitor_node_p",
        "conv_i_order", "conv_groups", "ppe_project",
    )
    INTERLEAVED_STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims", "coarse_dims",
        "elem_dims", "local_off", "a_offsets", "a_zero_off", "z_radius", "g_radius",
        "s_pad", "conv_oij", "monitor_node", "monitor_node_p", "ppe_project",
    )
    XLA_STATIC_ATTRS = (
        "nn", "nnp", "dt", "pin_grid", "perm", "perm_p", "fine_dims", "coarse_dims",
        "elem_dims", "local_off", "a_offsets", "a_zero_off", "z_radius", "g_radius",
        "gt_radius", "s_pad", "conv_oij", "monitor_node", "monitor_node_p", "ppe_project",
        "f64_dia", "g_dia_off", "gt_dia_off", "use_mg", "mg_dims", "mg_radii", "mg_omegas",
    )
    ELL_STATIC_ATTRS = ("nn", "nnp", "dt", "pin", "monitor_node", "monitor_node_p",
                        "ppe_project", "s_pad")

    def _configure(self, deck, config, device, plain) -> None:
        super()._configure(deck, config, device, plain)
        if config.momentum_solver.lower() == "gmres":
            raise ValueError(_GMRES_DEFECT)
        self._momentum_solver = solver_by_name(config.momentum_solver)

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

        # M/dt + K + direct-assembly Z (step0, guermondQuartapelle.cpp:3425-3572)
        ops = assemble_operators(
            tab, mesh.ltog_node, mesh.nn, self.nnp,
            viscosity=deck.viscosity, density=deck.density,
            z_mode="direct", mass_scale=1.0 / deck.dt, keep_consistent_mass=True,
        )
        self.ops = ops

        bc_of_node = face_bc_to_node_bc(
            mesh.ltog_node, deck.bc_vel_faces, mesh.nn,
            quadratic=deck.nenv != deck.nenp,
        )
        is_bc = bc_of_node >= 0
        bc_vel = np.zeros((mesh.nn, 3))
        bc_vel[is_bc] = deck.bc_str[bc_of_node[is_bc]]
        apply_inlet_profile(deck, mesh.coords, bc_of_node, bc_vel)

        Z = ops.Z.tocsr().copy()
        pin = deck.zero_pressure_node
        if pin >= 0:
            Z[pin, pin] = Z[pin, pin] * cfg.pressure_pin_large

        # Outflow faces -> homogeneous Dirichlet on the pressure INCREMENT
        # at outflow pressure nodes (symmetric row/col elimination keeping
        # the original diagonal).  The direct-assembly Z is the all-Neumann
        # Laplacian: consistent only when the RHS sums to zero, i.e. when
        # the flux across the whole boundary balances — always true for
        # enclosed flows, violated during open-boundary transients (the
        # JAX package's capability extension over the reference, which
        # parses its outflow faces and never consumes them).
        p_mask = np.ones(self.nnp)
        if deck.bc_out_faces is not None and len(deck.bc_out_faces):
            ob = face_bc_to_node_bc(
                mesh.ltog_node, deck.bc_out_faces, mesh.nn, quadratic=False
            )
            out_p = np.flatnonzero(ob[: self.nnp] >= 0)
            if out_p.size:
                p_mask[out_p] = 0.0
                d0 = Z.diagonal()
                Dm = sps.diags(p_mask)
                Z = (Dm @ Z @ Dm
                     + sps.diags(np.where(p_mask == 0.0, d0, 0.0))).tocsr()
                Z.sort_indices()

        # All-Neumann pressure problems with flow THROUGH the boundary
        # (every face Dirichlet with nonzero normal velocity): each step's
        # PPE RHS carries a small inconsistent component along the constant
        # null vector, which CG must push through the pinned near-null
        # eigenvalue.  Gate: geometric thru-flow detection — any
        # velocity-BC face whose mean BC velocity has a normal component.
        # Enclosed tangential-flow decks (cavity: lid moves along its own
        # plane) measure exactly zero and keep the reference-exact
        # behaviour; when detected, the RHS is mean-projected every solve.
        self.ppe_project = False
        if (
            p_mask.min() == 1.0           # no outflow Dirichlet rows
            and deck.bc_vel_faces is not None
            and len(deck.bc_vel_faces)
        ):
            fc = np.asarray(deck.bc_vel_faces, np.int64)
            corners = deck.conn[fc[:, 0][:, None], HEX_FACE_CORNERS[fc[:, 1]]]
            c = mesh.coords[corners]                     # (nf, 4, 3)
            nrm = np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
            nn_ = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = nrm / np.maximum(nn_, 1e-300)
            # probe the MID-FACE node (HEX_FACE_ALL_NODES[:, 8]): it
            # belongs to exactly one boundary face, so the sequential
            # corner-node BC overwrite (lid value leaking onto side-wall
            # faces at shared edges) cannot fake a normal component
            mid = mesh.ltog_node[fc[:, 0], HEX_FACE_ALL_NODES[fc[:, 1], 8]]
            thru = float(np.abs((bc_vel[mid] * nrm).sum(axis=1)).max())
            umax = float(np.abs(bc_vel).max()) or 1.0
            self.ppe_project = thru > 1e-9 * umax

        mk_vals = ops.M + ops.K          # M/dt + K CSR values (:3921-3923)
        if cfg.structured == "never" or not self._setup_box(
                mesh, ops, Z, pin, is_bc, bc_vel, mk_vals, p_mask):
            self._setup_ell(mesh, ops, Z, pin, is_bc, bc_vel, mk_vals, p_mask)
        # self.d holds the host tables; the base class snapshots them and moves
        # them to the device
        self.dt = float(deck.dt)

    def _setup_box(self, mesh, ops, Z, pin, is_bc, bc_vel, mk_vals, p_mask) -> bool:
        """DIA operators of a box grid and the per-step assembly maps of its
        parity layout, or of its interleaved layout when asked for or when
        the parity LHS assembly cannot route (``_try_structured`` of the JAX
        package, :339-663; off the kernel path the XLA structured path's tables,
:func:`_xla_tables`, with its multigrid branch, which the kernel path
        never takes).  False, with nothing set, for a mesh that the JAX
        package runs on its ELL step."""
        deck = self.deck
        cfg = self.config
        dtype = cfg.np_dtype()
        pat = ops.pattern_m
        box = detect_promoted_box(mesh.coords, self.nnp, mesh.ltog_node)
        if box is None or box.elem_perm is None:
            # as in the JAX package (implicit_gq.py:351-354): the per-step
            # LHS assembly needs element-grid structure, so a box whose
            # elements do not tile it takes the ELL step, where the explicit
            # solver takes its interleaved layout
            return False
        perm, perm_p, embed = box.perm, box.perm_p, box.embed

        mk_dia = dia_from_csr(pat.to_scipy(mk_vals), perm, perm, box.fine_dims)
        m_dia = dia_from_csr(pat.to_scipy(ops.M), perm, perm, box.fine_dims)
        z_dia = dia_from_csr(Z, perm_p, perm_p, box.coarse_dims)
        g_dias = [dia_from_csr(ops.G_csr(d), perm, embed, box.fine_dims) for d in range(3)]
        gt_dias = [
            dia_from_csr(ops.G_csr(d).T.tocsr(), embed, perm, box.fine_dims)
            for d in range(3)
        ]
        # M and MK must share the DIA offset layout
        if (any(x is None for x in [mk_dia, m_dia, z_dia, *g_dias, *gt_dias])
                or m_dia.flat_offsets != mk_dia.flat_offsets):
            return False

        self.perm, self.perm_p = perm, perm_p
        self.fine_dims, self.coarse_dims = box.fine_dims, box.coarse_dims
        self.elem_dims = box.elem_dims
        self.a_offsets = mk_dia.flat_offsets
        self.a_zero_off = self.a_offsets.index(0)
        self.z_radius = z_dia.radius
        self.g_radius = max(g.radius for g in g_dias)
        gt_radius = max(g.radius for g in gt_dias)

        dev = lambda x: np.asarray(x, dtype=dtype)
        sv_t, gdsv_t, gq_t = map(dev, box.elem_grid_tables(self.tables))
        self.pin_grid = int(perm_p[pin]) if pin >= 0 else -1
        mon = find_monitor_node(
            deck.coords,
            deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3,
        )
        self.monitor_node = int(perm[mon])
        # the pressure field lives on the COARSE grid in perm_p order
        self.monitor_node_p = int(perm_p[mon])
        bc_mask = dev(box.permute_vec(np.where(is_bc, 0.0, 1.0)))
        bc_vel = dev(np.stack([box.permute_vec(bc_vel[:, i]) for i in range(3)]))
        if not kernel_path(cfg):
            self._set_layout("interleaved", xla=True)
            self.d = self._xla_tables(box, is_bc, Z, p_mask, mk_dia, m_dia, z_dia, g_dias,
                                      gt_dias, sv_t, gdsv_t, gq_t, bc_mask, bc_vel)
            return True
        z_diag = dev(box.permute_vec_p(np.asarray(Z.diagonal())))
        z_win = dev(z_dia.window_vals(dtype=dtype))
        if cfg.pressure_cg_sym:
            # only the dq >= 0 half is kept (symmetry checked here)
            z_win = half_window(z_win, box.coarse_dims, z_dia.radius)
        gt_win = dev(np.stack([g.window_vals(gt_radius, dtype) for g in gt_dias]))
        common = {
            "GT_cwin": dev(compact_gt_window(gt_win, box.fine_dims, box.coarse_dims)),
            "Sv": sv_t,
            "p_mask": dev(box.permute_vec_p(p_mask)),
            # the pressure CG's plain (W^3, NNp) window (its dq >= 0 half
            # under pressure_cg_sym) and inverse diagonal
            "Z_win": z_win,
            "Z_dinv": dev(1.0 / z_diag),
        }
        tabs = dict(
            box=box, mk_dia=mk_dia, m_dia=m_dia, gt_win=gt_win, gDSv=gdsv_t,
            gq=gq_t, g_win=dev(np.stack([g.window_vals(self.g_radius, dtype) for g in g_dias])),
            bc_mask=bc_mask, bc_vel=bc_vel,
        )

        d = None
        if cfg.structured_layout != "interleaved" and self.spmd_mesh is None:
            self._set_layout("parity")
            d = self._parity_tables(is_bc, **tabs)
        if d is None:
            # the interleaved layout, asked for or the parity route's fallback
            # (implicit_gq.py:589-598); a forced "parity" raises here
            self._set_layout("interleaved")
            d = self._interleaved_tables(is_bc, **tabs)
        self.d = common | d
        return True

    def _parity_tables(self, is_bc, *, box, mk_dia, m_dia, g_win, gt_win, gDSv, gq,
                       bc_mask, bc_vel) -> dict | None:
        """The parity layout's tables (implicit_gq.py:544-663), or None when
        the per-step parity LHS assembly cannot route: Dirichlet masking
        zeroed an entire (class, offset) plane, as on a one-element-thin box
        between opposing walls."""
        dtype = self.config.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        fine, coarse = box.fine_dims, box.coarse_dims
        not_box = ValueError("this box mesh has no parity route")    # asserted by JAX
        (pcx, pcy, pcz), sp_c = pstl.parity_dims(fine)
        if (pcx, pcy, pcz) != coarse:
            raise not_box
        offs_a = pstl.decode_offsets(self.a_offsets, fine)
        # static LHS part pre-masked (BC rows zeroed, unit diagonal there):
        # the per-step device work is ONLY the masked convection add
        diag_add = np.zeros(box.size)
        diag_add[box.perm[is_bc]] = 1.0
        mk_masked = dev(mk_dia.vals) * bc_mask[None]
        mk_masked[self.a_zero_off] += dev(diag_add)
        mkp, a_pairs = pstl.build_parity_apply_tables(mk_masked, offs_a, fine)
        diag_planes = pstl.diag_plane_indices(a_pairs)
        # class-box pad slots carry no row: unit diagonal keeps the Jacobi
        # division finite (their residuals are identically 0)
        for p in range(8):
            col = mkp[0, diag_planes[p]]
            mkp[0, diag_planes[p]] = np.where(col == 0.0, 1.0, col)
        try:
            # scatter-free per-step LHS assembly: the 729 convection planes
            # (8 contiguous shifts of the embedded-axis ae) merge onto the
            # static MKp planes with ONE matmul (conv_plane_merge_matrix)
            conv_i_order, conv_groups, _unused_pairs2 = pstl.build_conv_plane_route(
                box.local_off, coarse)
            conv_sel = pstl.conv_plane_merge_matrix(box.local_off, conv_i_order, a_pairs, coarse)
        except ValueError:
            return None
        self.sp_c, self.a_pairs, self.diag_planes = sp_c, a_pairs, diag_planes
        self.conv_i_order, self.conv_groups = conv_i_order, conv_groups
        mp, self.m_pairs = pstl.build_parity_apply_tables(dev(m_dia.vals), offs_a, fine)
        r = self.g_radius
        offs_g = tuple(
            (dx, dy, dz)
            for dz in range(-r, r + 1)
            for dy in range(-r, r + 1)
            for dx in range(-r, r + 1)
        )
        gp, self.g_pairs = pstl.build_parity_apply_tables(g_win, offs_g, fine)
        # grad reads ONLY the coarse pressure (class 0): the step passes it
        # as a (1, 1, Sp) plane
        if any(pp != 0 for cls_ in self.g_pairs for (_, pp, _) in cls_):
            raise not_box
        bc_mask_p = pstl.parity_split_table(bc_mask, fine, sp_c)
        # elemental Dirichlet row mask on the EMBEDDED flat axis, i channels
        # pre-permuted to conv_i_order (it multiplies ae's i axis, which the
        # step builds permuted); gathered ONCE at setup
        mask_e = np.zeros((27, sp_c), dtype)
        for c, (p_idx, dqf) in enumerate(pstl.elem_channel_shifts(coarse)):
            mask_e[c, : sp_c - dqf] = bc_mask_p[p_idx, dqf:]
        fx, fy, _ = fine
        cx, cy, _ = coarse
        mon = self.monitor_node
        mx, my, mz = mon % fx, (mon // fx) % fy, mon // (fx * fy)
        self.mon_cls = ((mz & 1) * 2 + (my & 1)) * 2 + (mx & 1)
        self.mon_q = ((mz >> 1) * cy + (my >> 1)) * cx + (mx >> 1)
        return {
            "MKp": dev(mkp),
            "Mp": dev(mp),
            "Gp": dev(gp),
            "bc_mask_p": bc_mask_p,
            "bc_mask_e": mask_e[np.asarray(conv_i_order)],
            "bc_vel_p": pstl.parity_split_table(bc_vel, fine, sp_c),
            "conv_sel": dev(conv_sel),
            # element tables re-embedded on the coarse-flat axis
            "gDSv_p": pstl.embed_elem_table(gDSv, box.elem_dims, coarse, sp_c),
            "gq_p": pstl.embed_elem_table(gq, box.elem_dims, coarse, sp_c),
        }

    def _interleaved_tables(self, is_bc, *, box, mk_dia, m_dia, g_win, gt_win, gDSv, gq,
                            bc_mask, bc_vel) -> dict:
        """The interleaved layout's tables (implicit_gq.py:392-480): the MK
        and M DIA tables, the row mask and unit-diagonal add of the per-step
        LHS (padding rows get the unit diagonal), the G and G^T windows, all
        padded to s_pad, and the element tables in element-grid order."""
        cfg = self.config
        dtype = cfg.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        size = box.size
        self.s_pad = shard_pad_size(size, cfg, True)
        pad = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, self.s_pad - size)])
        diag_add = np.zeros(self.s_pad)
        diag_add[box.perm[is_bc]] = 1.0
        diag_add[size:] = 1.0          # padding rows -> identity (keeps Jacobi finite)
        fx, fy, _ = box.fine_dims
        self.local_off = box.local_off
        # channel pair (i, j) -> the fixed A offset fo(j) - fo(i) it lands at
        fo = [ox + fx * (oy + fy * oz) for (ox, oy, oz) in box.local_off]
        slot = {o: k for k, o in enumerate(self.a_offsets)}
        self.conv_oij = tuple(tuple(slot[fo[j] - fo[i]] for j in range(len(fo)))
                              for i in range(len(fo)))
        # every entry lands on a slot its row's class keeps (raises if not)
        compact_spmv_oij(self.conv_oij, self.local_off, self.a_offsets, box.fine_dims)
        d = {
            "MK_vals": pad(dev(mk_dia.vals)),
            "M_vals": pad(dev(m_dia.vals)),
            "row_mask_grid": pad(bc_mask),
            "diag_add_grid": dev(diag_add),
            "G_win": pad(g_win),
            # G's rows read the even fine nodes only: the class-compacted window
            "G_cwin": compact_g_window(pad(g_win), box.fine_dims, self.g_radius)[0],
            "GT_win": pad(gt_win),
            "bc_mask": pad(bc_mask),
            "bc_vel": pad(bc_vel),
            "gDSv": gDSv,
            "gq": gq,
        }
        # MK, M and the LHS's row mask and diagonal on the class-compacted,
        # class-major table of the window SPMV
        return d | compact_spmv_tables(d, self.a_offsets, box.fine_dims)

    def _xla_tables(self, box, is_bc, Z, p_mask, mk_dia, m_dia, z_dia, g_dias, gt_dias, sv,
                    gdsv, gq, bc_mask, bc_vel) -> dict:
        """The XLA structured path's tables (implicit_gq.py:339-537 off the
        kernel path): the MK and M DIA tables with the LHS's row mask and
        unit-diagonal add (padding rows get the unit diagonal), the direct
        27-slot Z window and diagonal, G and G^T as per-direction DIA tables
        under F64 and as windows otherwise, every fine-grid table padded to
        ``s_pad`` (a ``shard_pad`` multiple, no block padding), and the
        multigrid ladder of the pinned, grid-ordered Z under "mg", or under
        "auto" when Z is regular (a pin or outflow rows)."""
        cfg = self.config
        dtype = cfg.np_dtype()
        dev = lambda x: np.asarray(x, dtype=dtype)
        size = box.size
        self.s_pad = shard_pad_size(size, cfg, False)
        pad = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, self.s_pad - size)])
        self.gt_radius = max(g.radius for g in gt_dias)
        fx, fy, _ = box.fine_dims
        self.local_off = box.local_off
        # channel pair (i, j) -> the fixed A offset fo(j) - fo(i) it lands at
        fo = [ox + fx * (oy + fy * oz) for (ox, oy, oz) in box.local_off]
        slot = {o: k for k, o in enumerate(self.a_offsets)}
        self.conv_oij = tuple(tuple(slot[fo[j] - fo[i]] for j in range(len(fo)))
                              for i in range(len(fo)))
        diag_add = np.zeros(self.s_pad)
        diag_add[box.perm[is_bc]] = 1.0
        diag_add[size:] = 1.0          # padding rows -> identity (keeps Jacobi finite)
        d = xla_g_tables(self, g_dias, gt_dias, dtype, pad)
        d |= {
            "Sv": sv,
            "gDSv": gdsv,
            "gq": gq,
            "MK_vals": pad(dev(mk_dia.vals)),
            "M_vals": pad(dev(m_dia.vals)),
            "row_mask_grid": pad(bc_mask),
            "diag_add_grid": dev(diag_add),
            "Z_win": dev(z_dia.window_vals(dtype=dtype)),
            "Z_diag": dev(box.permute_vec_p(np.asarray(Z.diagonal()))),
            "p_mask": dev(box.permute_vec_p(p_mask)),
            "bc_mask": pad(bc_mask),
            "bc_vel": pad(bc_vel),
        }
        # the V-cycle needs a nonsingular Z: the Galerkin coarse solve of the
        # unpinned all-Neumann Laplacian inverts a singular matrix
        # (implicit_gq.py:515-537)
        z_regular = self.deck.zero_pressure_node >= 0 or float(np.min(p_mask)) == 0.0
        if cfg.pressure_precond == "mg" and not z_regular:
            raise ValueError(
                "pressure_precond='mg' needs a nonsingular Z (a pressure "
                "pin node > 0 or outflow Dirichlet rows); this deck's "
                "all-Neumann Z is singular"
            )
        xla_attach_multigrid(self, d, Z, box, dtype, cfg.pressure_precond == "mg" or (
            cfg.pressure_precond == "auto" and z_regular))
        return d

    def _setup_ell(self, mesh, ops, Z, pin, is_bc, bc_vel, mk_vals, p_mask) -> None:
        """Slot-major ELL operators and the per-step assembly maps of the
        ELL step (implicit_gq.py:224-337): Dirichlet row masks on the CSR
        values, the CSR -> ELL slot map, and the reverse-incidence table of
        the elemental -> CSR map (``rev_m``, where the JAX package keeps the
        map itself, ``scatter_m``, for a ``segment_sum``).  The node axis of
        the node-rowed tables is padded to ``s_pad``, a ``shard_pad``
        multiple (implicit_gq.py:311-322): zero values, column 0, ``bc_mask``
        0; the CSR -> ELL map addresses the padded ``(L, s_pad)`` table, which
        the JAX package pads in its step."""
        self._set_layout("ell")
        deck = self.deck
        dev = lambda x: np.asarray(x, dtype=self.config.np_dtype())
        pat = ops.pattern_m
        # Dirichlet row-zeroing masks on the CSR value array (:4622-4632):
        # entries in BC rows -> 0, then +1 on their diagonal slots
        row_ids = np.repeat(np.arange(mesh.nn), np.diff(pat.indptr))
        diag_all_slots = np.flatnonzero(row_ids == pat.indices)
        assert diag_all_slots.size == mesh.nn
        diag_add = np.zeros(pat.nnz)
        diag_add[diag_all_slots[is_bc]] = 1.0
        mk_ell = ell_from_csr(pat, values=mk_vals)
        m_ell = ell_from_csr(pat, values=ops.M)
        g_ells = [ell_from_csr(ops.pattern_g, values=ops.G[d]) for d in range(3)]
        gt_ells = []
        for d in range(3):
            m = ops.G_csr(d).T.tocsr()
            m.sort_indices()
            gt_ells.append(ell_from_csr(m.indptr.astype(np.int64), m.indices.astype(np.int64),
                                        m.data, n_cols=mesh.nn))
        z_ell = ell_from_csr(Z.indptr.astype(np.int64), Z.indices.astype(np.int64), Z.data,
                             n_cols=self.nnp)
        tab = self.tables
        self.d = {
            "ltog": np.asarray(mesh.ltog_node, dtype=np.int32),        # (NE, 27)
            "Sv": dev(tab.Sv),
            "gDSv": dev(np.transpose(tab.gDSv, (0, 3, 2, 1))),        # (NE, 3, 27, NGP)
            "gq": dev(tab.gq_factor),                                 # (NE, NGP)
            "rev_m": spmv.build_reverse_incidence(
                pat.scatter.reshape(pat.scatter.shape[0], -1), pat.nnz),
            "mk_vals_csr": dev(mk_vals),
            "m_vals": dev(m_ell.vals),
            "row_mask": dev(np.where(is_bc[row_ids], 0.0, 1.0)),
            "diag_add": dev(diag_add),
            "csr_to_ell": np.asarray(mk_ell.csr_to_ell),
            "A_cols": np.asarray(mk_ell.cols),
            "G_vals": dev(np.stack([g.vals for g in g_ells])),
            "G_cols": np.asarray(g_ells[0].cols),
            "GT_vals": dev(np.stack([g.vals for g in gt_ells])),
            "GT_cols": np.asarray(gt_ells[0].cols),
            "Z_vals": dev(z_ell.vals),
            "Z_cols": np.asarray(z_ell.cols),
            "Z_diag": dev(Z.diagonal()),
            "p_mask": dev(p_mask),
            "bc_mask": dev(np.where(is_bc, 0.0, 1.0)),
            "bc_vel": dev(bc_vel.T),
            "diag_slots": np.asarray(diag_all_slots),
        }
        self.s_pad = shard_pad_size(mesh.nn, self.config, False)
        e = self.s_pad - mesh.nn
        for k in ("m_vals", "A_cols", "G_vals", "G_cols", "bc_mask", "bc_vel"):
            self.d[k] = np.pad(self.d[k], [(0, 0)] * (self.d[k].ndim - 1) + [(0, e)])
        c2e = self.d["csr_to_ell"]
        self.d["csr_to_ell"] = (c2e // mesh.nn) * self.s_pad + c2e % mesh.nn
        self.pin = pin
        self.monitor_node = find_monitor_node(
            deck.coords, deck.monitor_xyz if deck.monitor_xyz is not None else (0.5,) * 3
        )
        # pressure monitor: corner node ids < NNp index pk directly
        self.monitor_node_p = self.monitor_node

    def _spmv_offsets(self):
        return self.a_offsets

    # ----------------------------------------------------------------- state
    def initial_state(self) -> ImplicitState:
        """Zero field with BC velocities imposed."""
        uk = self.d["bc_vel_p" if self.layout == "parity" else "bc_vel"].clone()
        pk = torch.zeros(self.nnp, dtype=uk.dtype, device=self.device)
        return ImplicitState(uk=uk, pk=pk, pk_prev=torch.zeros_like(pk))

    def state_from_fields(self, u: np.ndarray, p: np.ndarray) -> ImplicitState:
        """u as (NN, 3) and p as (NNp,) in deck node order; p^{k-1} = p^k."""
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
        uk = self._local(torch.from_numpy(np.ascontiguousarray(u, dtype=dtype))).to(self.device)
        pk = torch.from_numpy(np.ascontiguousarray(p, dtype=dtype)).to(self.device)
        return ImplicitState(uk=uk, pk=pk, pk_prev=pk.clone())

    # ------------------------------------------------------------- one step
    def _time_step(self, d, state: ImplicitState) -> tuple[ImplicitState, StepStats]:
        if self.xla:
            return self._time_step_xla(d, state)
        return {"parity": self._time_step_parity, "interleaved": self._time_step_interleaved,
                "ell": self._time_step_ell}[self.layout](d, state)

    def _pressure_update(self, d, div_uk, pk_prev, pk_prevprev):
        """step2 of the box layouts: R2 = -(1/dt) G^T u^k, the pressure CG on
        the coarse Z window (the CG kernels, or on the XLA path the torch CG
        with the V-cycle or Jacobi), p^{k+1} = p^k + Pdiff.  Returns (p^{k+1},
        CG result)."""
        cfg = self.config
        r2 = (-1.0 / self.dt) * div_uk * d["p_mask"]
        if self.ppe_project:
            # all-Neumann + boundary thru-flow: remove the null-space
            # (constant) component the discrete BC flux defect injects
            r2 = r2 - torch.mean(r2)
        if self.pin_grid >= 0:
            r2[self.pin_grid] = 0.0
        warm = bool(cfg.implicit_warm_start)
        x0 = (pk_prev - pk_prevprev) if warm else None
        if self.xla:
            if self.use_mg:
                precond = make_vcycle(d, self.mg_dims, self.mg_radii, self.mg_omegas)
            else:
                precond = lambda r: r / d["Z_diag"]
            sol = cg(lambda p: patches_spmv(d["Z_win"], p, self.coarse_dims, self.z_radius),
                     r2, x0=x0, tol=cfg.pressure_cg_tol, maxiter=cfg.pressure_cg_maxiter,
                     dot_dtype=cfg.krylov_dot_dtype(), precond=precond)
        else:
            cg_solve = fused_cg_plain if self.plain else fused_cg
            sol = cg_solve(
                d["Z_win"], r2, d["Z_dinv"],
                dims=self.coarse_dims, radius=self.z_radius,
                tol=cfg.pressure_cg_tol, maxiter=cfg.pressure_cg_maxiter,
                x0=x0,
                unroll=max(1, int(cfg.pressure_cg_unroll)),
                fuse_loop=cfg.pressure_cg_fuse_loop,
                sym=cfg.pressure_cg_sym,
                # MIXED policy: f64-accumulated dots inside the kernels
                dot_mode="compensated" if cfg.krylov_dot_dtype() is not None else "plain",
            )
        pdiff = sol.x
        if self.ppe_project:
            # singular all-Neumann solve: pick the mean-zero representative
            # so the arbitrary pressure level cannot drift across steps
            pdiff = pdiff - torch.mean(pdiff)
        return pk_prev + pdiff, sol

    def _momentum_solve(self, a_mul, r1, uk_prev, a_diag):
        """The batched 3-direction momentum solve of step1, Jacobi
        preconditioned (with the fields split over ranks its dots summed
        over them)."""
        cfg = self.config
        warm = bool(cfg.implicit_warm_start)
        # bicg takes no reduce: given no rmatvec here, it raises its own
        # error at the first solve, on split fields as on one device
        reduce = None if self._momentum_solver is bicg else self._momentum_reduce()
        return self._momentum_solver(
            a_mul,
            r1,
            x0=uk_prev if warm else None,
            tol=cfg.momentum_tol,
            atol=cfg.momentum_abs_tol,
            maxiter=cfg.momentum_maxiter,
            # warm-started solves take AT LEAST one Krylov step: the
            # ||b||-relative bound is inflated by the M/dt term and lets a
            # warm solve exit at 0 iterations, freezing the time loop at an
            # unconverged state; miniter keeps the reference's exact bound
            # and merely forbids the zero-iteration exit
            miniter=1 if warm else 0,
            dot_dtype=cfg.krylov_dot_dtype(),
            precond=lambda r: r / a_diag,
            **({} if reduce is None else {"reduce": reduce}),
        )

    def _parity_lhs(self, d, uk_prev):
        """The per-step LHS planes, A = (M/dt + K)|masked + masked A(u^k),
        on the MKp route ``a_pairs`` (1, m, Sp)."""
        cfg = self.config
        # Flat ae build (embedded element axis, minor-axis shift gathers)
        # -> 729 convection weight planes (8 contiguous shifts) -> ONE
        # matmul merges them onto the static MKp planes.
        sv, gtab, qtab = d["Sv"], d["gDSv_p"], d["gq_p"]
        u0_e = pstl.parity_gather_elem_flat(uk_prev, self.coarse_dims)
        u0_gq = torch.einsum("ki,die->dke", sv, u0_e)
        udotg = torch.einsum("dke,djke->jke", u0_gq, gtab)
        if cfg.conv_stab:
            # Temam (div u0) Sv_i Sv_j term (SolverConfig.conv_stab; the
            # ref carries it with coefficient 0.0, :3864-3865)
            div0 = torch.einsum("djke,dje->ke", gtab, u0_e)
            udotg = udotg + cfg.conv_stab * div0[None] * sv.T[:, :, None]
        sv_i = sv[:, list(self.conv_i_order)]
        ae = torch.einsum("ki,ke,jke->ije", sv_i, qtab, udotg)
        # Dirichlet row-zeroing in ELEMENT space: contributions whose
        # output node is a BC node vanish (the static MKp already carries
        # the unit diagonal there)
        ae = ae * d["bc_mask_e"][:, None, :]
        conv_wc = pstl.conv_planes_from_ae(ae, groups=self.conv_groups)
        # 0/1 selection in full f32 (TF32 is off): it must not round the planes
        conv_p = torch.matmul(d["conv_sel"], conv_wc[0])[None]
        return d["MKp"] + conv_p

    def _time_step_parity(self, d, state: ImplicitState) -> tuple[ImplicitState, StepStats]:
        """Class-major layout (ops/parity_stencil): the per-step LHS is the
        static masked MKp planes plus the convection planes merged by one
        matmul, the momentum BiCGStab applies the compacted table, and
        grad/div read/emit the coarse pressure grid directly."""
        cfg = self.config
        dt = self.dt
        sp_c = self.sp_c
        # the wrappers run the kernels on CUDA tensors and the plain
        # versions on CPU tensors; `plain` forces the plain versions
        apply = pstl.parity_apply_plain if self.plain else pstl.parity_apply
        div_apply = pstl.parity_div_apply_plain if self.plain else pstl.parity_div_apply

        uk_prev, pk_prev, pk_prevprev = state       # uk (3, 8, Sp)

        a_wc = self._parity_lhs(d, uk_prev)
        a_diag = a_wc[0, list(self.diag_planes)].reshape(1, -1)     # (1, 8*Sp)

        a_mul = lambda x: apply(
            a_wc, x.reshape(3, 8, sp_c), pairs=self.a_pairs, co=3
        ).reshape(3, -1)
        m_mul = lambda x: apply(d["Mp"], x, pairs=self.m_pairs, co=3)

        def grad(p):
            xp = torch.nn.functional.pad(p, (0, sp_c - p.shape[0]))[None, None]
            return apply(d["Gp"], xp, pairs=self.g_pairs, co=3)

        div = lambda u: div_apply(d["GT_cwin"], u, self.coarse_dims)[: self.nnp]

        # ---- RHS = (M/dt) u^k - G (2 p^k - p^{k-1}); BC rows = BC values
        pdiff2 = 2.0 * pk_prev - pk_prevprev
        r1 = m_mul(uk_prev) - grad(pdiff2)
        r1 = r1 * d["bc_mask_p"][None] + d["bc_vel_p"]

        mom = self._momentum_solve(a_mul, r1.reshape(3, -1), uk_prev.reshape(3, -1), a_diag)
        uk = mom.x.reshape(3, 8, sp_c)

        # ---- step2: pressure CG on the coarse grid (the pressure grid IS
        # class 0)
        pk, sol = self._pressure_update(d, div(uk), pk_prev, pk_prevprev)

        max_acc = torch.max(torch.abs(uk - uk_prev)) / dt
        probe = lambda c: uk[c, self.mon_cls, self.mon_q]
        stats = StepStats(
            u_mon=probe(0), v_mon=probe(1), w_mon=probe(2),
            p_mon=pk[self.monitor_node_p], max_acc=max_acc,
            iters=1, cg_iters=sol.iters, mom_iters=mom.iters,
        )
        return ImplicitState(uk=uk, pk=pk, pk_prev=pk_prev), stats

    def _time_step_interleaved(self, d, state: ImplicitState) -> tuple[ImplicitState, StepStats]:
        """Flat grid-order layout (implicit_gq.py:836-1107, the kernel
        branch): the per-step LHS assembled into the A window rows
        (``assemble_compact_values``, straight into the class-compacted
        table), the momentum BiCGStab and M u^k through
        ``window_spmv_compact``, G through ``grad_window_compact``, G^T through
        ``div_compact_interleaved``."""
        cfg = self.config
        dt = self.dt
        fine, nn, s_pad = self.fine_dims, self.nn, self.s_pad
        uk_prev, pk_prev, pk_prevprev = state       # uk (3, s_pad); a rank: (3, s_loc)

        # ---- per-step LHS: A = M/dt + K + A(u^k), BC rows zeroed with a
        # unit diagonal (padding rows too), on the class-compacted table; each
        # element's (i, j) entry lands at the fixed slot conv_oij[i][j], the
        # unit diagonal at each row's offset-0 entry diag_pos
        coij = compact_spmv_oij(self.conv_oij, self.local_off, self.a_offsets, fine)
        if self.ranks is None:
            ae = convection_elem_matrices(uk_prev[:, :nn], d["Sv"], d["gDSv"], d["gq"],
                                          self.elem_dims, fine, stab_coef=cfg.conv_stab)
            conv_vals = assemble_compact_values(ae, self.local_off, coij, self.a_offsets,
                                                self.elem_dims, fine, s_pad)
            a_mul, m_mul, grad, div = self._interleaved_applies(d)
        else:
            # this rank's element slab, assembled into its compact rows
            # (every rank takes part in the element halo exchange; a rank
            # without grid rows has no elements)
            slab = self.slab
            u_slab = slab_field(uk_prev, slab, self.ranks)
            conv = uk_prev.new_zeros(0)
            if slab.size:
                ae = convection_elem_matrices(u_slab, d["Sv"], d["gDSv"], d["gq"],
                                              slab.elem_dims, slab.fine_dims,
                                              stab_coef=cfg.conv_stab)
                conv = assemble_compact_values(ae, self.local_off, coij, self.a_offsets,
                                               slab.elem_dims, slab.fine_dims, slab.size)
            conv_vals = slab_to_block(conv, slab, self.a_offsets, fine, s_pad)
            a_mul, m_mul, grad, div = self._sharded_applies(d)
        a_vals = (d["MK_cvals"] + conv_vals) * d["row_mask_c"]
        a_vals[d["diag_pos"]] += d["diag_add_grid"]
        a_diag = a_vals[d["diag_pos"]]

        # ---- RHS = (M/dt) u^k - G (2 p^k - p^{k-1}); BC rows = BC values
        pdiff2 = 2.0 * pk_prev - pk_prevprev
        r1 = m_mul(d["M_cvals"], uk_prev) - grad(pdiff2)
        r1 = r1 * d["bc_mask"][None, :] + d["bc_vel"]
        mom = self._momentum_solve(lambda x: a_mul(a_vals, x), r1, uk_prev, a_diag)
        uk = mom.x

        # ---- step2: pressure CG on the coarse grid
        pk, sol = self._pressure_update(d, div(uk), pk_prev, pk_prevprev)

        max_acc = self._field_max(torch.abs(uk - uk_prev)) / dt
        mon = self._probe(uk, self.monitor_node)
        stats = StepStats(
            u_mon=mon[0], v_mon=mon[1], w_mon=mon[2],
            p_mon=pk[self.monitor_node_p], max_acc=max_acc,
            iters=1, cg_iters=sol.iters, mom_iters=mom.iters,
        )
        return ImplicitState(uk=uk, pk=pk, pk_prev=pk_prev), stats

    def _interleaved_applies(self, d):
        """(A, M, G, G^T) of the interleaved step on one device: the compact
        SPMV of a table, G on ``G_cwin``, the compact G^T; the kernels on CUDA
        tensors, the plain versions on CPU tensors or under ``plain``."""
        fine, nn, s_pad = self.fine_dims, self.nn, self.s_pad
        spmv_w = window_spmv_compact_plain if self.plain else window_spmv_compact
        grad_w = grad_window_compact_plain if self.plain else grad_window_compact
        div_c = div_compact_interleaved_plain if self.plain else div_compact_interleaved
        a_mul = lambda tab, x: spmv_w(tab, x, fine, offsets=self.a_offsets, trim=False,
                                      name="window_spmv_mk_plus_a")
        m_mul = lambda tab, x: spmv_w(tab, x, fine, offsets=self.a_offsets, trim=False,
                                      name="window_spmv_m")

        def grad(p):
            pf = torch.nn.functional.pad(coarse_to_fine(p, self.coarse_dims, fine),
                                         (0, s_pad - nn))
            return grad_w(d["G_cwin"], pf, fine, self.g_radius, trim=False)

        div = lambda u: div_c(d["GT_cwin"], u, fine, self.coarse_dims)[: self.nnp]
        return a_mul, m_mul, grad, div

    def _sharded_applies(self, d):
        """The same on the sharded kernel path (implicit_gq.py:889-925 of the
        JAX package), on this rank's block: A and M through
        ``sharded_spmv_compact`` on the compact tables of its rows (a halo
        exchange a call), G through ``sharded_grad_compact`` (no collective),
        G^T through ``sharded_div_compact`` (its coarse rows, all-gathered)."""
        fine, mesh, s_pad, plain = self.fine_dims, self.ranks, self.s_pad, self.plain

        def spmv(name):
            return lambda tab, x: sharded_spmv_compact(tab, x, fine, offsets=self.a_offsets,
                                                       mesh=mesh, s_pad=s_pad, name=name,
                                                       plain=plain)

        def grad(p):
            pf = torch.nn.functional.pad(coarse_to_fine(p, self.coarse_dims, fine),
                                         (0, s_pad - self.nn))
            return sharded_grad_compact(d["G_cwin"], pf, fine, self.g_radius, mesh=mesh,
                                        plain=plain)

        div = lambda u: sharded_div_compact(d["GT_cwin"], u, fine, self.coarse_dims, mesh=mesh,
                                            s_pad=s_pad, plain=plain)
        return spmv("sharded_spmv_mk_plus_a"), spmv("sharded_spmv_m"), grad, div

    def _xla_operators(self, d, uk_prev):
        """(A, M, G, G^T, diag(A)) of the XLA structured step
        (implicit_gq.py:836-870, 955-990): the per-step LHS assembled into
        the full A DIA table (``assemble_window_values``), A and M by
        ``dia_spmv``, G and G^T in roll form under F64 and in window-patches
        form otherwise.  Placed across ranks (``parallel/placement.py``): the
        LHS assembled on the rank's element slab and cut to its rows (every
        row gets every element's terms, in the single-device order), A, M, G
        and G^T on its rows (``parallel/placed_ops.py``)."""
        cfg = self.config
        fine, s_pad = self.fine_dims, self.s_pad
        size = int(np.prod(fine))               # real fine-grid size (<= s_pad)
        n_off = len(self.a_offsets)
        # A = M/dt + K + A(u^k), BC rows zeroed with a unit diagonal (padding
        # rows too); each element's (i, j) entry lands at the fixed offset
        # conv_oij[i][j]
        if self.block is None:
            ae = convection_elem_matrices(uk_prev[:, :size], d["Sv"], d["gDSv"], d["gq"],
                                          self.elem_dims, fine, stab_coef=cfg.conv_stab)
            conv_vals = assemble_window_values(ae, self.local_off, self.conv_oij, n_off,
                                               self.elem_dims, fine, s_pad)
            a_mul = lambda x: dia_spmv(a_vals, x, self.a_offsets)
            m_mul = lambda x: dia_spmv(d["M_vals"], x, self.a_offsets)
        else:
            # every rank takes part in the element halo exchange
            slab, mesh = self.slab, self.ranks
            u_slab = slab_field(uk_prev, slab, mesh)
            conv_vals = uk_prev.new_zeros((n_off, self.block.s_loc))
            if slab.size:
                ae = convection_elem_matrices(u_slab, d["Sv"], d["gDSv"], d["gq"],
                                              slab.elem_dims, slab.fine_dims,
                                              stab_coef=cfg.conv_stab)
                conv_vals = slab_rows(assemble_window_values(
                    ae, self.local_off, self.conv_oij, n_off, slab.elem_dims, slab.fine_dims,
                    slab.size), slab)
            a_mul = lambda x: dia_spmv_placed(a_vals, x, self.a_offsets, mesh)
            m_mul = lambda x: dia_spmv_placed(d["M_vals"], x, self.a_offsets, mesh)
        a_vals = (d["MK_vals"] + conv_vals) * d["row_mask_grid"][None, :]
        a_vals[self.a_zero_off] += d["diag_add_grid"]
        grad, div = xla_grad_div(self, d, size)
        return a_mul, m_mul, grad, div, a_vals[self.a_zero_off]

    def _time_step_xla(self, d, state: ImplicitState) -> tuple[ImplicitState, StepStats]:
        """The XLA structured step (implicit_gq.py:836-870, 955-990,
        1073-1091): :meth:`_xla_operators`, the Jacobi BiCGStab and the
        torch pressure CG."""
        dt = self.dt
        uk_prev, pk_prev, pk_prevprev = state   # uk (3, s_pad)
        a_mul, m_mul, grad, div, a_diag = self._xla_operators(d, uk_prev)

        # ---- RHS = (M/dt) u^k - G (2 p^k - p^{k-1}); BC rows = BC values
        pdiff2 = 2.0 * pk_prev - pk_prevprev
        r1 = m_mul(uk_prev) - grad(pdiff2)
        r1 = r1 * d["bc_mask"][None, :] + d["bc_vel"]
        mom = self._momentum_solve(a_mul, r1, uk_prev, a_diag)
        uk = mom.x

        # ---- step2: pressure CG on the coarse grid
        pk, sol = self._pressure_update(d, div(uk), pk_prev, pk_prevprev)

        max_acc = self._field_max(torch.abs(uk - uk_prev)) / dt
        mon = self._probe(uk, self.monitor_node)
        stats = StepStats(
            u_mon=mon[0], v_mon=mon[1], w_mon=mon[2],
            p_mon=pk[self.monitor_node_p], max_acc=max_acc,
            iters=1, cg_iters=sol.iters, mom_iters=mom.iters,
        )
        return ImplicitState(uk=uk, pk=pk, pk_prev=pk_prev), stats

    def _ell_lhs(self, d, uk_prev):
        """``(a_ell (L, rows), a_diag (rows,))``: step1's LHS A = M/dt + K +
        A(u^k) with its BC rows zeroed (:3916-3929), assembled into CSR values
        and scattered into slot-major ELL, and its Jacobi diagonal (1 on the
        padding rows), on the rows this process holds."""
        rows = self._rows()
        conv_vals = spmv.convection_assemble_csr(
            self._full(uk_prev), d["ltog"], d["Sv"], d["gDSv"], d["gq"], d["rev_m"],
            stab_coef=self.config.conv_stab,
        )
        a_csr = (d["mk_vals_csr"] + conv_vals) * d["row_mask"] + d["diag_add"]
        n_slots = d["A_cols"].shape[0]
        a_ell = a_csr.new_zeros(n_slots * rows)
        a_ell[d["csr_to_ell"]] = a_csr          # distinct slots: no accumulation
        a_diag = a_csr[d["diag_slots"]]
        if a_diag.shape[0] < rows:          # the padding rows' unit diagonal
            a_diag = torch.nn.functional.pad(a_diag, (0, rows - a_diag.shape[0]), value=1.0)
        return a_ell.reshape(n_slots, rows), a_diag

    def _time_step_ell(self, d, state: ImplicitState) -> tuple[ImplicitState, StepStats]:
        """The ELL step (implicit_gq.py:1109-1203): torch ops only, on fields
        ``(3, s_pad)`` whose padding rows stay zero (zero LHS rows there, unit
        Jacobi diagonal).  Placed across ranks (``parallel/placement.py``,
        owner computes): the CSR values of the rank's rows assembled from the
        elements that touch them and scattered into its ``(L, s_loc)`` ELL
        table, its ELL rows applied to the all-gathered field, the
        BiCGStab's dots summed over the ranks, G^T onto the replicated
        pressure whole on every rank."""
        cfg = self.config
        dt = self.dt
        uk_prev, pk_prev, pk_prevprev = state           # uk (3, s_pad); a rank: (3, s_loc)
        full = self._full
        a_ell, a_diag = self._ell_lhs(d, uk_prev)

        # ---- step1 RHS: (M/dt) u^k - G (2 p^k - p^{k-1})  (:3937-4005)
        pdiff2 = 2.0 * pk_prev - pk_prevprev
        r1 = spmv.ell_spmv(d["m_vals"], d["A_cols"], full(uk_prev))
        r1 = r1 - grad_apply(d["G_vals"], d["G_cols"], pdiff2)
        r1 = r1 * d["bc_mask"][None, :] + d["bc_vel"]        # RHS = BC value

        # ---- momentum solve, 3 directions batched (:3972-4033); Jacobi
        mom = self._momentum_solve(lambda x: spmv.ell_spmv(a_ell, d["A_cols"], full(x)), r1,
                                   uk_prev, a_diag)
        uk = mom.x

        # ---- step2: R2 = -(1/dt) G^T u^k  (:4096-4127)
        r2 = (-1.0 / dt) * div_apply(d["GT_vals"], d["GT_cols"], full(uk)) * d["p_mask"]
        if self.ppe_project:
            r2 = r2 - torch.mean(r2)
        if self.pin >= 0:
            r2[self.pin] = 0.0
        # CG on the (negative-definite) direct Z, Jacobi-scaled
        sol = cg(
            lambda p: spmv.ell_spmv(d["Z_vals"], d["Z_cols"], p),
            r2,
            x0=(pk_prev - pk_prevprev) if cfg.implicit_warm_start else None,
            tol=cfg.pressure_cg_tol,
            maxiter=cfg.pressure_cg_maxiter,
            dot_dtype=cfg.krylov_dot_dtype(),
            precond=lambda r: r / d["Z_diag"],
        )
        pdiff = sol.x
        if self.ppe_project:
            pdiff = pdiff - torch.mean(pdiff)
        pk = pk_prev + pdiff                                 # (:4162-4165)

        max_acc = self._field_max(torch.abs(uk - uk_prev)) / dt
        mon = self._probe(uk, self.monitor_node)
        stats = StepStats(
            u_mon=mon[0], v_mon=mon[1], w_mon=mon[2],
            p_mon=pk[self.monitor_node_p], max_acc=max_acc,
            iters=1, cg_iters=sol.iters, mom_iters=mom.iters,
        )
        return ImplicitState(uk=uk, pk=pk, pk_prev=pk_prev), stats

    def _monitor_only(self, state: ImplicitState) -> StepStats:
        if self.layout == "parity":
            mon = state.uk[:, self.mon_cls, self.mon_q]
        else:
            mon = self._probe(state.uk, self.monitor_node)    # grid id on interleaved
        zero = torch.zeros((), dtype=state.uk.dtype, device=self.device)
        return StepStats(mon[0], mon[1], mon[2], state.pk[self.monitor_node_p], zero, 0, 0, 0)

    # ------------------------------------------------------------------- io
    def fields(self, state: ImplicitState) -> tuple[np.ndarray, np.ndarray]:
        """(u (NN,3), p (NNp,)) as numpy, deck node order."""
        if self.layout == "ell":
            return self._full(state.uk)[:, : self.nn].cpu().numpy().T, state.pk.cpu().numpy()
        if self.layout == "parity":
            u = pstl.parity_merge(state.uk, self.fine_dims).cpu().numpy()
        else:
            u = self._full(state.uk)[:, : self.nn].cpu().numpy()
        p = state.pk.cpu().numpy()
        return u[:, self.perm].T, p[self.perm_p]
