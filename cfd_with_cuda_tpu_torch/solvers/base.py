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

from typing import NamedTuple

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.device import resolve_device
from cfd_with_cuda_tpu_torch.ops.window_stencil import (
    compact_spmv_diag,
    compact_spmv_rows,
    compact_spmv_window,
)
from cfd_with_cuda_tpu_torch.utils.config import SolverConfig

__all__ = [
    "StepStats", "ChunkedTimeLoop", "unpack_chunk_stats", "unsupported_config",
    "unsupported_on_box", "compact_spmv_tables",
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


def unsupported_on_box(cfg) -> str | None:
    """The ``ROADMAP.md`` item of the first ``SolverConfig`` choice that the
    port does not run on a box mesh that the JAX package takes onto its
    structured path (None when there is none): off its kernel path (F32 or
    MIXED, backend not ``"xla"``, preconditioner not ``"mg"``) it runs its
    XLA DIA operators and multigrid preconditioner, which are not ported.
    On the ELL path (any other mesh, and for the implicit solver a box whose
    elements do not tile it, as in the JAX package) F64 and
    ``pressure_backend="xla"`` run (the torch CG)."""
    if cfg.dtype_policy.value == "f64":
        return ("dtype_policy=F64 on a box mesh (the XLA DIA / multigrid path: "
                "ROADMAP.md queue 1 item 6)")
    if cfg.pressure_backend == "xla" or cfg.pressure_precond == "mg":
        return ("the XLA pressure CG / multigrid preconditioner on a box mesh "
                "(ROADMAP.md queue 1 item 6)")
    return None


def unsupported_config(cfg) -> str | None:
    """The ``ROADMAP.md`` item of the first ``SolverConfig`` choice that no
    solver of the port runs on any mesh yet (None when there is none)."""
    if int(cfg.spmd_devices or 0) >= 1:
        return "spmd_devices (multi-device: ROADMAP.md queue 1 item 11)"
    if cfg.setup_cache not in (None, "", "off", "none", "0"):
        return "setup_cache (ROADMAP.md queue 1 item 8)"
    return None


def unpack_chunk_stats(packed) -> tuple[StepStats, bool]:
    """(StepStats of (n_steps,) arrays, done flag) from a chunk's packed
    monitor matrix (rows: the StepStats fields, then the done flag)."""
    mat = packed.cpu().numpy()
    return StepStats(*mat[:-1]), bool(mat[-1, -1])


class ChunkedTimeLoop:
    """Base of the solvers: setup once from a deck, then run chunks of
    time steps.  Subclasses provide ``STATIC_ATTRS``,
    ``INTERLEAVED_STATIC_ATTRS`` and ``ELL_STATIC_ATTRS``, ``_setup``,
    ``_time_step``, ``_monitor_only`` and ``initial_state``.  ``layout`` is
    ``"parity"`` (a box mesh, class-major fields), ``"interleaved"`` (a box
    mesh, flat grid-order fields) or ``"ell"`` (any other mesh, or
    ``structured="never"``).

    ``device=None`` runs on the CUDA card (raises without one);
    ``device="cpu"`` runs every kernel's plain PyTorch version.
    ``plain=True`` runs the plain versions on any device (the reference
    path the kernels are held against on the card).
    """

    # static attributes that define a set-up solver besides its tables, by
    # layout (the interop module carries the JAX solver's across)
    STATIC_ATTRS: tuple[str, ...] = ()
    INTERLEAVED_STATIC_ATTRS: tuple[str, ...] = ()
    ELL_STATIC_ATTRS: tuple[str, ...] = ()

    def __init__(self, deck, config=None, device=None, *, plain: bool = False):
        self._configure(deck, config or SolverConfig(), device, plain)
        self._setup()

    @classmethod
    def from_tables(cls, deck, config, tables: dict, attrs: dict, device=None, *,
                    plain: bool = False):
        """A solver from ready tables (the interop module's, or another
        solver's ``d``) and the static values of its layout
        (:meth:`static_attrs`; ``attrs["layout"]`` defaults to
        ``"parity"``), skipping the host setup."""
        self = cls.__new__(cls)
        self._configure(deck, config, device, plain)
        self._set_layout(attrs.get("layout", "parity"))
        for k in self._layout_attrs():
            setattr(self, k, attrs[k])
        self.d = {k: v.to(self.device) for k, v in tables.items()}
        return self

    def _layout_attrs(self) -> tuple[str, ...]:
        return {"parity": self.STATIC_ATTRS, "interleaved": self.INTERLEAVED_STATIC_ATTRS,
                "ell": self.ELL_STATIC_ATTRS}[self.layout]

    def static_attrs(self) -> dict:
        """The layout and its static values, for :meth:`from_tables`."""
        return {"layout": self.layout, **{k: getattr(self, k) for k in self._layout_attrs()}}

    def _set_layout(self, layout: str) -> None:
        """Take a box mesh's parity or interleaved layout or the unstructured
        ELL path, raising for what that path does not run."""
        cfg = self.config
        if layout in ("parity", "interleaved"):
            why = unsupported_on_box(cfg)
            if why is not None:
                raise NotImplementedError(f"not ported yet: {why}")
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

    def _configure(self, deck, config, device, plain) -> None:
        self.deck = deck
        self.config = config
        self.device = resolve_device(device)
        self.plain = plain
        why = self._unsupported(config)
        if why is not None:
            raise NotImplementedError(f"not ported yet: {why}")
        if self.device.type == "cuda":
            # the einsums and matmuls that build A(u) stay in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @staticmethod
    def _unsupported(config) -> str | None:
        return unsupported_config(config)

    def _setup(self) -> None:
        raise NotImplementedError

    def _time_step(self, params, state):
        raise NotImplementedError

    def _monitor_only(self, state) -> StepStats:
        raise NotImplementedError

    def resolve_initial_state(self):
        if getattr(self.deck, "is_restart", False):
            raise NotImplementedError(
                "restart decks need the Tecplot restart reader "
                "(ROADMAP.md queue 1 item 8)"
            )
        return self.initial_state()

    def chunk(self, state, n_steps: int, done: bool = False):
        """Run ``n_steps`` steps (monitor-only once steady).  Returns
        ``(state, packed)``: ``packed`` is a ``(9, n_steps)`` device matrix
        in the state dtype, the 8 StepStats rows and the final steady flag,
        as the JAX package's chunk returns it."""
        conv_crit = self.deck.convergence_criteria
        rows = []
        for _ in range(n_steps):
            if done:
                stats = self._monitor_only(state)
            else:
                state, stats = self._time_step(self.d, state)
            # reference steady test: maxAcc > criteria -> keep going
            done = done or not bool(stats.max_acc > conv_crit)
            rows.append(stats)
        dt = self.config.torch_dtype()
        packed = torch.stack(
            [torch.stack([torch.as_tensor(getattr(s, f), dtype=dt, device=self.device)
                          for s in rows]) for f in StepStats._fields]
            + [torch.full((n_steps,), float(done), dtype=dt, device=self.device)]
        )
        return state, packed

    def run(self, state=None, *, n_steps: int | None = None):
        """Run until t_final or steady.  Returns (state, history rows)."""
        deck = self.deck
        state = state if state is not None else self.resolve_initial_state()
        total = n_steps if n_steps is not None else int(
            round((deck.t_final - deck.t_ini) / deck.dt)
        )
        chunk_len = max(1, min(self.config.steps_per_chunk, total))
        history = []
        done_steps = 0
        done = False
        t = deck.t_ini
        while done_steps < total and not done:
            this_len = min(chunk_len, total - done_steps)
            state, packed = self.chunk(state, this_len, done)
            stats, done = unpack_chunk_stats(packed)
            for k in range(this_len):
                if stats.iters[k] == 0:      # skipped (already steady)
                    break
                t += deck.dt
                row = {f: float(getattr(stats, f)[k]) for f in StepStats._fields}
                row["time"] = t
                row["step"] = done_steps + k + 1
                history.append(row)
                if self.config.verbose:
                    print(
                        f"{row['step']:6d} {int(row['iters']):4d} {t:10.5f}"
                        f" {row['u_mon']:13.5f} {row['v_mon']:13.5f}"
                        f" {row['w_mon']:13.5f} {row['p_mon']:13.5f}"
                        f" {row['max_acc']:12.5f}"
                    )
            done_steps += this_len
        return state, history
