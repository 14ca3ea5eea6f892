"""Shared chunked time-loop runner for the fractional-step solvers.

Port of ``cfd_with_cuda_tpu/solvers/base.py``.  A solver provides one time
step ``state -> (state, StepStats)``; this base runs ``steps_per_chunk`` of
them per chunk, packs each chunk's monitor scalars into ONE device matrix
that the host pulls once, and reproduces the reference's monitor table /
steady-stop behaviour (``blascoCodinaHuerta.cpp:2859-3118``).

The JAX package fuses a chunk into one ``lax.scan`` with an in-graph steady
flag.  PyTorch runs eagerly, so here the chunk is a Python loop and the
steady flag (``max_acc > convergence_criteria``) is read on the host once
per step; the solver's sub-iteration loop reads its convergence flag once
per sub-iteration too.  The history rows and the flag carried across
chunks are the same as the JAX package's.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.io.tecplot import read_restart, write_tecplot
from cfd_with_cuda_tpu_torch.mesh.topology import promote_hex_mesh
from cfd_with_cuda_tpu_torch.ops.multigrid import attach_hierarchy
from cfd_with_cuda_tpu_torch.ops.stencil import (
    dia_div_apply,
    dia_grad_apply,
    patches_div_apply,
    patches_grad_apply,
)
from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    coarse_rows,
    compact_spmv_diag,
    compact_spmv_rows,
    compact_spmv_window,
)
from cfd_with_cuda_tpu_torch.parallel.elem_slab import elem_slab
from cfd_with_cuda_tpu_torch.parallel.placed_ops import (
    dia_div_placed,
    dia_grad_placed,
    patches_div_placed,
    patches_grad_placed,
)
from cfd_with_cuda_tpu_torch.parallel.placement import ell_tables, owner_tables
from cfd_with_cuda_tpu_torch.parallel.sharded_stencil import block_rows
from cfd_with_cuda_tpu_torch.parallel.sharding import (
    all_gather,
    all_reduce,
    broadcast,
    gather,
    make_mesh,
    shard_params,
)
from cfd_with_cuda_tpu_torch.utils import setup_cache as sc
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

__all__ = [
    "StepStats", "ChunkedTimeLoop", "unpack_chunk_stats",
    "kernel_path", "compact_spmv_tables", "xla_g_tables", "xla_grad_div",
    "xla_attach_multigrid",
]

# the interleaved steps' full window tables (the JAX package's, kept under
# its names) and the class-compacted tables the steps apply instead
_COMPACT = (("K_vals", "K_cvals"), ("MK_vals", "MK_cvals"), ("M_vals", "M_cvals"))


def compact_spmv_tables(d: dict, offsets, fine_dims) -> dict:
    """The compact SPMV tables of an interleaved solver's ``d`` (numpy arrays
    or tensors): each full window table of ``_COMPACT`` in
    ``compact_spmv_window``'s class-major form; for the implicit LHS also
    its row mask on the compact entries (``row_mask_c``) and the entry of
    each row's offset-0 slot (``diag_pos``), where the step adds the unit
    diagonal and reads the Jacobi diagonal."""
    out = {c: compact_spmv_window(d[f], offsets, fine_dims) for f, c in _COMPACT if f in d}
    if "row_mask_grid" in d:
        mask = d["row_mask_grid"]
        out["row_mask_c"] = compact_spmv_rows(mask, offsets, fine_dims)
        pos = compact_spmv_diag(offsets, fine_dims, mask.shape[-1])
        out["diag_pos"] = pos if isinstance(mask, np.ndarray) else torch.from_numpy(pos)
    return out


class StepStats(NamedTuple):
    u_mon: torch.Tensor
    v_mon: torch.Tensor
    w_mon: torch.Tensor
    p_mon: torch.Tensor
    max_acc: torch.Tensor
    iters: torch.Tensor | int       # nonlinear sub-iterations used
    cg_iters: torch.Tensor | int    # pressure-solver iterations
    mom_iters: torch.Tensor | int   # momentum-solver iterations (0 for explicit)


def kernel_path(cfg) -> bool:
    """Whether a box mesh (or a banded pressure operator) takes the kernel
    path: the JAX package's ``fused_pressure_eligible`` on its own chip,
    f32 storage (F32 or MIXED), a backend other than ``"xla"`` and a
    preconditioner other than ``"mg"`` (the fused CG is Jacobi-only).
    Otherwise a box takes the XLA structured path: DIA / window-patches
    applies of torch ops, the torch CG and, under ``pressure_precond="auto"``
    or ``"mg"``, the multigrid V-cycle."""
    return (cfg.dtype_policy.value != "f64" and cfg.pressure_backend != "xla"
            and cfg.pressure_precond != "mg")


def xla_g_tables(solver, g_dias, gt_dias, dtype, pad) -> dict:
    """G and G^T of the XLA structured path from their per-direction DIA
    operators, padded by ``pad``: under F64 (``solver.f64_dia``) the DIA
    tables ``G_dia{i}`` / ``GT_dia{i}`` with their offsets
    (``solver.g_dia_off`` / ``gt_dia_off``), applied in roll form; otherwise
    the windows ``G_win`` / ``GT_win`` at ``solver.g_radius`` /
    ``gt_radius``, applied in window-patches form (explicit_bch.py:385-402:
    the patches form of G^T extracts a (3, W^3, S) tensor per apply)."""
    solver.f64_dia = np.dtype(dtype) == np.float64
    if solver.f64_dia:
        solver.g_dia_off = tuple(g.flat_offsets for g in g_dias)
        solver.gt_dia_off = tuple(g.flat_offsets for g in gt_dias)
        out = {f"G_dia{i}": pad(np.asarray(g_dias[i].vals, dtype=dtype)) for i in range(3)}
        return out | {f"GT_dia{i}": pad(np.asarray(gt_dias[i].vals, dtype=dtype))
                      for i in range(3)}
    solver.g_dia_off = solver.gt_dia_off = None
    return {
        "G_win": pad(np.stack([g.window_vals(solver.g_radius, dtype) for g in g_dias])),
        "GT_win": pad(np.stack([g.window_vals(solver.gt_radius, dtype) for g in gt_dias])),
    }


def xla_grad_div(solver, d: dict, size: int):
    """(G, G^T) applies of the XLA structured path on the tables of
    :func:`xla_g_tables`: ``grad(p) (3, s_pad)`` from the coarse pressure,
    ``div(u) (NNp,)`` from ``u (3, s_pad)``; ``size`` is the real fine-grid
    size (<= s_pad).  On a solver placed across ranks, the rank's rows of
    ``grad`` and the replicated ``div`` from its rows (``placed_ops``)."""
    fine, coarse, s_pad = solver.fine_dims, solver.coarse_dims, solver.s_pad
    pad = lambda y: torch.nn.functional.pad(y, (0, s_pad - y.shape[-1]))
    if solver.block is not None:
        # placed across ranks: the rank's fine rows, G^T's coarse rows gathered
        mesh, block = solver.ranks, solver.block
        if solver.f64_dia:
            g = [d[f"G_dia{i}"] for i in range(3)]
            gt = [d[f"GT_dia{i}"] for i in range(3)]
            grad = lambda p: dia_grad_placed(g, p, solver.g_dia_off, coarse, fine, block)
            div = lambda u: dia_div_placed(gt, u, solver.gt_dia_off, coarse, fine, mesh)
        else:
            grad = lambda p: patches_grad_placed(d["G_win"], p, coarse, fine, solver.g_radius,
                                                 block)
            div = lambda u: patches_div_placed(d["GT_win"], u, coarse, fine, solver.gt_radius,
                                               mesh)
    elif solver.f64_dia:
        g = [d[f"G_dia{i}"] for i in range(3)]
        gt = [d[f"GT_dia{i}"] for i in range(3)]
        grad = lambda p: dia_grad_apply(g, p, solver.g_dia_off, coarse, fine, s_pad)
        div = lambda u: dia_div_apply(gt, u, solver.gt_dia_off, coarse, fine)
    else:
        grad = lambda p: pad(patches_grad_apply(d["G_win"][..., :size], p, coarse, fine,
                                                solver.g_radius))
        div = lambda u: patches_div_apply(d["GT_win"][..., :size], u[:, :size], coarse, fine,
                                          solver.gt_radius)
    return grad, div


def xla_attach_multigrid(solver, d: dict, Z, box, dtype, wanted: bool) -> None:
    """``solver.use_mg`` and the multigrid levels of the pinned Z in grid
    order when ``wanted`` (``ops/multigrid.attach_hierarchy``); the mg
    attributes stay None otherwise."""
    solver.use_mg, solver.mg_dims, solver.mg_radii, solver.mg_omegas = False, None, None, None
    if wanted:
        inv_p = np.argsort(box.perm_p)          # flat grid id -> node id
        attach_hierarchy(solver, d, Z[inv_p][:, inv_p].tocsr(), box.coarse_dims, dtype)


# fine-grid tables a rank holds as its block of rows; tables it no longer
# needs once its compact rows are built
_ROW_TABLES = ("md_inv", "md_orig_inv", "bc_mask", "bc_vel", "diag_add_grid")
_FULL_ONLY = ("K_vals", "MK_vals", "M_vals", "G_win", "GT_win", "row_mask_grid", "K_cvals",
              "MK_cvals", "M_cvals", "row_mask_c", "diag_pos")
# the element tables of a box, which a rank holds for its slab or owned elements
_ELEM_TABLES = ("ltog", "rev", "gDSv", "gq")


def shard_tables(d: dict, offsets, fine_dims, coarse_dims, s_pad: int, block) -> dict:
    """A rank's tables from an interleaved solver's full ``d`` (tensors),
    but for the element tables (``ChunkedTimeLoop._elem_tables``): the
    compact SPMV tables of its rows (``compact_spmv_window(..., rows=)``,
    for the implicit LHS its row mask and diagonal entries there), its
    columns of ``G_cwin`` and of ``GT_cwin`` (at its coarse rows), its block
    of the per-row vectors; the coarse-grid tables (Z, its diagonal, the
    pressure mask) and ``Sv`` whole (replicated)."""
    rows = (block.r0, block.r1)
    q0, q1 = coarse_rows(fine_dims, coarse_dims, rows)
    out = {k: v for k, v in d.items()
           if k not in _FULL_ONLY + _ROW_TABLES + ("G_cwin", "GT_cwin") + _ELEM_TABLES}
    for f, c in _COMPACT:
        if f in d:
            out[c] = compact_spmv_window(d[f], offsets, fine_dims, rows)
    if "row_mask_grid" in d:
        out["row_mask_c"] = compact_spmv_rows(d["row_mask_grid"], offsets, fine_dims, rows)
        out["diag_pos"] = torch.from_numpy(compact_spmv_diag(offsets, fine_dims, s_pad, rows)
                                           ).to(d["row_mask_grid"].device)
    out |= {k: d[k][..., block.r0: block.r1] for k in _ROW_TABLES if k in d}
    out["G_cwin"] = d["G_cwin"][..., block.r0: block.r1]
    out["GT_cwin"] = d["GT_cwin"][..., q0: q1]
    return {k: v.contiguous() for k, v in out.items()}


def unpack_chunk_stats(packed) -> tuple[StepStats, bool]:
    """(StepStats of (n_steps,) arrays, done flag) from a chunk's packed
    monitor matrix (rows: the StepStats fields, then the done flag)."""
    mat = packed.cpu().numpy()
    return StepStats(*mat[:-1]), bool(mat[-1, -1])


class ChunkedTimeLoop:
    """Base of the solvers: setup once from a deck, then run chunks of
    time steps.  Subclasses provide ``STATIC_ATTRS``,
    ``INTERLEAVED_STATIC_ATTRS``, ``XLA_STATIC_ATTRS`` and
    ``ELL_STATIC_ATTRS``, ``_setup``, ``_time_step``, ``_monitor_only`` and
    ``initial_state``.  ``layout`` is ``"parity"`` (a box mesh, class-major
    fields), ``"interleaved"`` (a box mesh, flat grid-order fields) or
    ``"ell"`` (any other mesh, or ``structured="never"``), as the JAX
    package names it.  ``xla`` marks the XLA structured path of a box (off
    the kernel path, :func:`kernel_path`), whose layout reads
    ``"interleaved"`` as in the JAX package.

    ``device=None`` runs on the CUDA card (raises without one);
    ``device="cpu"`` runs every kernel's plain PyTorch version.
    ``plain=True`` runs the plain versions on any device (the reference
    path the kernels are held against on the card).

    With ``config.setup_cache`` set (``"auto"`` or a directory) the host
    setup goes through the on-disk cache of ``utils/setup_cache.py``:
    ``setup_cache_hit`` says whether the tables came from a snapshot, and
    on a miss ``setup_cache_bytes`` / ``setup_cache_store_s`` what storing
    the new one took.
    """

    # static attributes that define a set-up solver besides its tables, by
    # layout (the interop module carries the JAX solver's across)
    STATIC_ATTRS: tuple[str, ...] = ()
    INTERLEAVED_STATIC_ATTRS: tuple[str, ...] = ()
    XLA_STATIC_ATTRS: tuple[str, ...] = ()
    ELL_STATIC_ATTRS: tuple[str, ...] = ()

    def __init__(self, deck, config=None, device=None, *, plain: bool = False):
        self._configure(deck, config or SolverConfig(), device, plain)
        self._setup_cached()
        d = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in self.d.items()}
        self.d = {k: v.to(self.device) for k, v in self._shard(d).items()}

    def _setup_cached(self) -> None:
        """``_setup`` (host tables in ``self.d``) through the setup cache: a
        hit restores a snapshot's tables, static values and mesh; a miss
        runs the setup and stores one.  The key covers the deck's contents,
        the config fields that shape the tables, the solver class and
        whether the config takes the kernel path (``plain`` picks the step
        functions only, so a plain and a kernel solver share a snapshot)."""
        cache_dir = self.config.setup_cache_dir()
        self.setup_cache_hit = False
        self.setup_cache_bytes, self.setup_cache_store_s = 0, 0.0
        if cache_dir:
            key = sc.deck_fingerprint(self.deck, self.config, type(self).__name__,
                                      kernel_path(self.config))
            snap = sc.snapshot_load(cache_dir, key)
            if snap is not None:
                sc.solver_restore(self, snap)
                self.setup_cache_hit = True
                return
        self._setup()
        if cache_dir:
            t0 = time.perf_counter()
            self.setup_cache_bytes = sc.snapshot_store(cache_dir, key, sc.solver_snapshot(self))
            self.setup_cache_store_s = time.perf_counter() - t0

    @classmethod
    def from_tables(cls, deck, config, tables: dict, attrs: dict, device=None, *,
                    plain: bool = False):
        """A solver from ready tables (the interop module's, or another
        solver's ``d``) and the static values of its layout
        (:meth:`static_attrs`; ``attrs["layout"]`` defaults to
        ``"parity"``, ``attrs["xla"]`` to False), skipping the host setup."""
        self = cls.__new__(cls)
        self._configure(deck, config, device, plain)
        self._set_layout(attrs.get("layout", "parity"), xla=attrs.get("xla", False))
        for k in self._layout_attrs():
            setattr(self, k, attrs[k])
        # a sharded solver's tables are its rank's already
        local = attrs.get("block") is not None
        self.d = {k: v.to(self.device) for k, v in self._shard(dict(tables), local).items()}
        return self

    def _layout_attrs(self) -> tuple[str, ...]:
        if self.xla:
            return self.XLA_STATIC_ATTRS
        return {"parity": self.STATIC_ATTRS, "interleaved": self.INTERLEAVED_STATIC_ATTRS,
                "ell": self.ELL_STATIC_ATTRS}[self.layout]

    def static_attrs(self) -> dict:
        """The layout and its static values, for :meth:`from_tables`
        (``block``: a sharded solver's rank block, its tables its rank's)."""
        return {"layout": self.layout, "xla": self.xla, "block": self.block,
                **{k: getattr(self, k) for k in self._layout_attrs()}}

    # ------------------------------------------------------- the sharded path
    def _shard(self, d: dict, local: bool = False) -> dict:
        """The tables this rank holds: ``d`` itself on one device; on the
        sharded kernel path (``spmd_mesh`` on the interleaved layout), its
        rank's (:meth:`_place`; ``local``: ``d`` holds them already).  The
        ELL step under ``spmd_devices`` runs whole on every rank, as the JAX
        package's does until its caller places the arrays
        (``parallel/placement.py``)."""
        self.block = self.slab = self.ranks = None
        mesh = self.spmd_mesh
        if mesh is None or self.layout == "ell":
            return d
        return self._place(mesh, d, kernel=True, local=local)

    def _place(self, mesh, d: dict, *, kernel: bool, local: bool = False) -> dict:
        """Split the fields over the ranks of ``mesh``: keep ``ranks``, this
        rank's ``block`` of the padded node axis and, on a box whose elements
        tile it, its element ``slab``; return this rank's tables of ``d``
        (``local``: ``d`` holds them already).  ``kernel``: the sharded kernel
        path's (:func:`shard_tables`), else the annotation-placed paths'
        (``parallel/placement.py::place``): every table whose last axis is
        ``s_pad`` cut to the block (``shard_params``), the rest whole.  The
        element tables are :meth:`_elem_tables` either way."""
        self.ranks = mesh
        self.block = block_rows(self.s_pad, mesh)
        self.slab = None
        if self.layout != "ell" and getattr(self, "elem_structured", True):
            self.slab = elem_slab(self.fine_dims, self.elem_dims, self.s_pad, mesh)
        if local:
            return d
        own = self._elem_tables(d)
        if kernel:
            rest = shard_tables(d, self._spmv_offsets(), self.fine_dims, self.coarse_dims,
                                self.s_pad, self.block)
        else:
            rest = shard_params({k: v for k, v in d.items() if k not in own}, mesh,
                                (self.s_pad,))
        return rest | own

    def _elem_tables(self, d: dict) -> dict:
        """This rank's element tables: on the ELL layout the elements that
        touch its node rows (``placement.ell_tables``); on a box whose
        elements tile it the slab's columns of ``gDSv`` and ``gq``; on any
        other box the elements that touch its grid rows
        (``placement.owner_tables``)."""
        block = self.block
        if self.layout == "ell":
            return ell_tables(d, self.nn, self.s_pad, block)
        if self.slab is not None:
            return {k: d[k][..., self.slab.e0: self.slab.e1].contiguous() for k in ("gDSv", "gq")}
        size = int(np.prod(self.fine_dims))
        return owner_tables(d, "rev", ("ltog", "gDSv", "gq"),
                            (block.r0, max(block.r0, min(block.r1, size))), 27)

    def _spmv_offsets(self):
        raise NotImplementedError

    def _field_norms(self, *vs) -> tuple:
        """The 2-norms of the node fields ``vs``: with the fields split over
        ranks (``ranks``) each rank's norms all-gathered (one call) and normed
        over the ranks, so one rank reads its own norm exactly."""
        if self.ranks is None:
            return tuple(torch.linalg.vector_norm(v) for v in vs)
        loc = torch.stack([torch.linalg.vector_norm(v) for v in vs])
        parts = all_gather(loc, self.ranks, "gather_norm")
        return tuple(torch.linalg.vector_norm(parts[:, i]) for i in range(len(vs)))

    def _field_max(self, v) -> torch.Tensor:
        """max(v) over the node field, over every rank when it is split."""
        m = torch.max(v)
        return m if self.ranks is None else all_reduce(m, self.ranks, "max", "reduce_max")

    def _momentum_reduce(self):
        """The momentum solve's sum of its dots over ranks (None on one
        device)."""
        mesh = self.ranks
        return None if mesh is None else (lambda t: all_reduce(t, mesh, "sum", "reduce_dot"))

    def _probe(self, u, node: int) -> torch.Tensor:
        """``(3,)``: the node field ``u`` at the row ``node``; with the field
        split over ranks broadcast from the rank that holds it."""
        if self.ranks is None:
            return u[:, node]
        owner = node // self.block.s_loc
        mine = owner == self.ranks.rank
        vals = u[:, node - self.block.r0] if mine else u.new_zeros(u.shape[0])
        return broadcast(vals.contiguous(), owner, self.ranks, "bcast_mon")

    def _rows(self) -> int:
        """The node rows this process holds: its block, or the padded axis."""
        return self.s_pad if self.block is None else self.block.s_loc

    def _pad_rows(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` on the real rows it covers, zero-padded to :meth:`_rows`."""
        rows = self._rows()
        return y if y.shape[-1] == rows else torch.nn.functional.pad(y, (0, rows - y.shape[-1]))

    def _local(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full node field (itself on one device)."""
        return u if self.block is None else u[..., self.block.r0: self.block.r1].contiguous()

    def _full(self, u: torch.Tensor) -> torch.Tensor:
        """The full node field from every rank's block (itself on one device)."""
        return u if self.block is None else gather(u, self.ranks, "gather_field")

    def _set_layout(self, layout: str, *, xla: bool = False) -> None:
        """Take a box mesh's parity or interleaved layout (``xla``: the XLA
        structured path, whose layout is ``"interleaved"``) or the
        unstructured ELL path, raising the JAX package's errors for what
        that path cannot run."""
        cfg = self.config
        if layout in ("parity", "interleaved"):
            if layout == "interleaved" and cfg.structured_layout == "parity":
                # the JAX package's own error (explicit_bch.py:202-207)
                raise ValueError(
                    "structured_layout='parity' needs the fused Pallas path "
                    "(single chip, f32/pallas backend) on an element-structured box grid"
                )
        elif layout == "ell":
            # the JAX package's own errors for a mesh that fell back to ELL
            if cfg.structured == "force":
                raise ValueError("structured mode forced but mesh is not a box grid")
            if cfg.pressure_precond == "mg":
                raise ValueError(
                    "pressure_precond='mg' needs the structured fast path "
                    "(geometric hierarchy); this mesh fell back to ELL"
                )
            if cfg.structured_layout == "parity":
                raise ValueError(
                    "structured_layout='parity' needs an element-structured box grid"
                )
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self.layout = layout
        self.xla = xla

    def _configure(self, deck, config, device, plain) -> None:
        self.deck = deck
        self.config = config
        self.device = resolve_device(device)
        self.plain = plain
        # the sharded kernel path (spmd_devices >= 1 on the kernel path), as the
        # JAX package's spmd_mesh (base.py:50-68): a mesh of that many ranks,
        # which raises without a process group of that many; off the kernel
        # path nothing changes
        self.spmd_mesh = None
        self.block = self.slab = self.ranks = None
        if int(config.spmd_devices or 0) >= 1 and kernel_path(config):
            self.spmd_mesh = make_mesh(int(config.spmd_devices))
            if self.spmd_mesh.backend == "nccl" and self.device.type != "cuda":
                raise ValueError(f"spmd_devices: an NCCL group and a solver on {self.device}")
        if self.device.type == "cuda":
            # the einsums and matmuls that build A(u) stay in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _setup(self) -> None:
        raise NotImplementedError

    def _time_step(self, params, state):
        raise NotImplementedError

    def _monitor_only(self, state) -> StepStats:
        raise NotImplementedError

    # ------------------------------------------------------------------- io
    def restart_path(self) -> Path:
        """``<deck file stem>_restart.dat`` next to the deck file (the
        reference's ``<whichProblem>_restart.dat``,
        ``blascoCodinaHuerta.cpp:4223``), or ``<title>_restart.dat`` in the
        working directory for a generated deck."""
        src = getattr(self.deck, "source_path", None)
        if src:
            return Path(src).parent / f"{Path(src).stem}_restart.dat"
        return Path(".") / f"{self.deck.title}_restart.dat"

    def resolve_initial_state(self):
        """``initial_state()``, or the restart file when the deck says
        ``isRestart`` (ref ``blascoCodinaHuerta.cpp:2793-2799``)."""
        if getattr(self.deck, "is_restart", False):
            path = self.restart_path()
            if not path.exists():
                raise FileNotFoundError(
                    f"deck requests isRestart but {path} does not exist"
                )
            return self.state_from_restart(path)
        return self.initial_state()

    def _promoted_mesh(self):
        """The 27-node mesh (a solver made by ``from_tables`` promotes it
        here, once)."""
        if getattr(self, "mesh", None) is None:
            self.mesh = promote_hex_mesh(self.deck.conn, self.deck.coords)
        return self.mesh

    def write_tecplot(self, state, path) -> None:
        """FEBRICK ``.dat`` dump of ``state`` (ref ``createTecplot``
        :4249-4482); on the sharded path every rank gathers, rank 0 writes."""
        mesh = self._promoted_mesh()
        u, p = self.fields(state)
        if self.ranks is None or self.ranks.rank == 0:
            write_tecplot(path, self.deck.title, mesh.coords, mesh.ltog_node, u, p)

    def state_from_restart(self, path):
        """The state of a prior ``.dat`` (ref ``readRestartFile``: u, v, w
        and the corner pressure only)."""
        u, p = read_restart(path, self.nn, self.nnp)
        return self.state_from_fields(u, p)

    def _write_restart_next_to(self, tecplot_path, state) -> None:
        """Checkpoint at :meth:`restart_path`, the file an ``isRestart`` deck
        reads, whichever directory the Tecplot product goes to (the
        reference makes the user copy the periodic dump,
        ``blascoCodinaHuerta.cpp:3107-3114``)."""
        self.write_tecplot(state, self.restart_path())

    # ------------------------------------------------------------- the loop
    def chunk(self, state, n_steps: int, done: bool = False, clock: list | None = None):
        """Run ``n_steps`` steps (monitor-only once steady).  Returns
        ``(state, packed)``: ``packed`` is a ``(9, n_steps)`` device matrix
        in the state dtype, the 8 StepStats rows and the final steady flag,
        as the JAX package's chunk returns it.  ``clock``: a list that gets
        the host clock (``time.perf_counter()``) after each step, once the
        host has read its steady flag."""
        conv_crit = self.deck.convergence_criteria
        rows = []
        for _ in range(n_steps):
            if done:
                stats = self._monitor_only(state)
            else:
                state, stats = self._time_step(self.d, state)
            # reference steady test: maxAcc > criteria -> keep going
            done = done or not bool(stats.max_acc > conv_crit)
            if clock is not None:
                clock.append(time.perf_counter())
            rows.append(stats)
        dt = self.config.torch_dtype()
        packed = torch.stack(
            [torch.stack([torch.as_tensor(getattr(s, f), dtype=dt, device=self.device)
                          for s in rows]) for f in StepStats._fields]
            + [torch.full((n_steps,), float(done), dtype=dt, device=self.device)]
        )
        return state, packed

    def run(self, state=None, *, n_steps: int | None = None,
            tecplot_path=None, tecplot_every: int = 1000):
        """Run until t_final or steady.  Returns (state, history rows); a
        row holds the StepStats fields, ``time``, ``step`` and ``wall``,
        the host seconds from the start of the run to the step's end.

        When ``tecplot_path`` is given, the solution and the restart
        checkpoint are dumped in the reference's cadence: every
        ``tecplot_every`` steps (at the end of the chunk that reaches it)
        and once at the end (``blascoCodinaHuerta.cpp:3097-3114``).
        """
        deck = self.deck
        state = state if state is not None else self.resolve_initial_state()
        total = n_steps if n_steps is not None else int(
            round((deck.t_final - deck.t_ini) / deck.dt)
        )
        chunk_len = max(1, min(self.config.steps_per_chunk, total))
        history = []
        done_steps = 0
        done = False
        next_dump = tecplot_every
        t = deck.t_ini
        t0 = time.perf_counter()
        while done_steps < total and not done:
            this_len = min(chunk_len, total - done_steps)
            clock = []
            state, packed = self.chunk(state, this_len, done, clock)
            stats, done = unpack_chunk_stats(packed)
            for k in range(this_len):
                if stats.iters[k] == 0:      # skipped (already steady)
                    break
                t += deck.dt
                row = {f: float(getattr(stats, f)[k]) for f in StepStats._fields}
                row["time"] = t
                row["step"] = done_steps + k + 1
                row["wall"] = clock[k] - t0
                history.append(row)
                if self.config.verbose:
                    print(
                        f"{row['step']:6d} {int(row['iters']):4d} {t:10.5f}"
                        f" {row['u_mon']:13.5f} {row['v_mon']:13.5f}"
                        f" {row['w_mon']:13.5f} {row['p_mon']:13.5f}"
                        f" {row['max_acc']:12.5f}"
                    )
            done_steps += this_len
            if tecplot_path is not None and done_steps >= next_dump:
                self.write_tecplot(state, tecplot_path)
                self._write_restart_next_to(tecplot_path, state)
                next_dump += tecplot_every
        if tecplot_path is not None:
            self.write_tecplot(state, tecplot_path)
            self._write_restart_next_to(tecplot_path, state)
        return state, history
