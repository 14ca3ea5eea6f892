"""Place a solver's tables across ranks: the annotation-placed paths.

Counterpart of the JAX caller's ``shard_params(solver.d, mesh, big)`` +
``shard_state(state, mesh, big)`` (``cfd_with_cuda_tpu/parallel/
sharding.py:53-78``), after which GSPMD runs the XLA structured step and
the ELL step of both solvers across devices with no code change.  PyTorch
has no GSPMD, so :func:`place` cuts the tables (``ChunkedTimeLoop._place``,
which the sharded kernel path of ``spmd_devices`` shares) and the solver's
steps run the rank-decomposed operators in its place, through its normal
entry points (``run``, ``_time_step``, ``fields``, ``interop.gather_state``
/ ``state_to_rank``):

* every table whose last axis is the padded node axis ``s_pad`` becomes the
  rank's contiguous block of it (the JAX package's rule, ``_spec_for``, with
  ``s_pad`` the big axis: it must divide by the rank count);
  ``initial_state`` then gives the rank's block of the state;
* the element tables become the elements the rank's rows need, built once
  at placement: on a box whose elements tile it the rank's element slab
  (``parallel/elem_slab.py``: the z-layers of elements that meet its rows),
  elsewhere the elements that touch its rows (:func:`owner_tables`,
  :func:`ell_tables`, with the reverse-incidence tables re-indexed onto
  them, so every owned row sums its terms in the order one device does).
  The JAX caller may also name the element axis big; the port cuts the
  element tables to the rank's elements either way, so ``place`` takes no
  axes;
* the pressure-rowed tables (Z, its multigrid levels, G^T on the ELL path)
  stay whole: the small pressure solve runs replicated on every rank, as
  in the JAX package.

The collectives (``parallel/sharding.py``, counted by name in
``collective_counts``): a halo exchange per DIA / window apply and element
slab field, an all-gather of a field where an elemental apply reads it
(owner computes), an all-gather of the coarse rows after each G^T, the
fine-axis norms, ``max_acc``, the monitor and the momentum solve's dots
reduced over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.parallel.sharding import Mesh

__all__ = ["place", "owned_elements", "owner_tables", "ell_tables"]


def owned_elements(rev: np.ndarray, cols, ne: int, width: int):
    """``(elems, rev_own)``: the elements (sorted) whose entries reach the
    columns ``cols = (c0, c1)`` of the reverse-incidence table ``rev (deg,
    N)`` (positions ``e * width + s`` of an element-major ``(NE, width)``
    array, sentinel ``NE * width``), and those columns of the table
    re-indexed onto ``elems`` (sentinel ``len(elems) * width``), in the same
    order."""
    sub = np.asarray(rev)[:, cols[0]: cols[1]].astype(np.int64)
    real = sub != ne * width
    elems = np.unique(sub[real] // width)
    loc = np.searchsorted(elems, sub // width)
    own = np.where(real, loc * width + sub % width, len(elems) * width)
    return elems, own.astype(np.int32)


def owner_tables(d: dict, rev: str, names, cols, width: int) -> dict:
    """The element-major tables ``names`` of ``d`` cut to the elements that
    reach the columns ``cols`` of ``d[rev]`` (the table's nodes or CSR
    slots), and ``d[rev]`` re-indexed onto them (:func:`owned_elements`);
    the tables themselves when the columns are all of them (one rank)."""
    if tuple(cols) == (0, d[rev].shape[1]):
        return {k: d[k] for k in (*names, rev)}
    ne = d[names[0]].shape[0]
    elems, own = owned_elements(d[rev].cpu().numpy(), cols, ne, width)
    dev = d[rev].device
    idx = torch.from_numpy(elems).to(dev)
    out = {k: d[k].index_select(0, idx).contiguous() for k in names}
    out[rev] = torch.from_numpy(own).to(dev)
    return out


def ell_tables(d: dict, nn: int, s_pad: int, block) -> dict:
    """The ELL step's rank tables (owner computes: each rank applies the
    elements that touch its node rows, ``block`` of the ``s_pad`` axis
    whose first ``nn`` rows are real, to the all-gathered field).
    Explicit: Ke, Ge, the node tables and ``rev`` of those elements; the
    whole Ge, ltog and ``rev_p`` under ``Ge_div`` / ``ltog_div`` / ``rev_p``
    for G^T onto the replicated pressure.  Implicit: the CSR slots of the
    rank's rows (``mk_vals_csr``, ``row_mask``, ``diag_add``), ``rev_m`` on
    them, the CSR -> ELL map onto the rank's ``(L, s_loc)`` table and its
    rows' diagonal slots."""
    rows = (block.r0, max(block.r0, min(block.r1, nn)))
    if "rev_m" not in d:
        out = owner_tables(d, "rev", ("Ke", "Ge", "ltog", "ltog_p", "gDSv", "gq"), rows, 27)
        return out | {"Ge_div": d["Ge"], "ltog_div": d["ltog"]}
    c2e = d["csr_to_ell"].cpu().numpy().astype(np.int64)
    row_of = c2e % s_pad
    a, b = (int(np.searchsorted(row_of, r)) for r in rows)
    nen = d["ltog"].shape[1]
    out = owner_tables(d, "rev_m", ("ltog", "gDSv", "gq"), (a, b), nen * nen)
    dev = d["csr_to_ell"].device
    own = c2e[a:b]
    out["csr_to_ell"] = torch.from_numpy((own // s_pad) * block.s_loc
                                         + own % s_pad - block.r0).to(dev)
    out |= {k: d[k][a:b].contiguous() for k in ("mk_vals_csr", "row_mask", "diag_add")}
    out["diag_slots"] = (d["diag_slots"][rows[0]: rows[1]] - a).contiguous()
    return out


def place(solver, mesh: Mesh):
    """Place ``solver`` (set up whole, on this rank's device) over the ranks
    of ``mesh``, as the JAX caller's ``shard_params`` / ``shard_state`` with
    the padded node axis among their big axes: its tables become this
    rank's (module docstring, ``ChunkedTimeLoop._place``), and its steps run
    the rank-decomposed operators; ``solver.initial_state()``,
    ``interop.state_to_rank`` give the rank's state.  Takes the paths the
    JAX package places by annotation, the XLA structured path of a box and
    the ELL path; the kernel path runs across ranks through
    ``SolverConfig.spmd_devices``.  Returns ``solver``."""
    if solver.block is not None:
        raise ValueError("place: this solver's fields are split over ranks already")
    if not (solver.xla or solver.layout == "ell"):
        raise ValueError(
            "place: the kernel path's layouts run across ranks through "
            "SolverConfig.spmd_devices (the JAX package's shard_map path); place takes the "
            "XLA structured path and the ELL path")
    if solver.s_pad % mesh.size:
        raise ValueError(
            f"place: the padded node axis ({solver.s_pad}) must divide by the {mesh.size} "
            "ranks; set SolverConfig.shard_pad to a multiple of the rank count")
    solver.d = solver._place(mesh, solver.d, kernel=False)
    return solver
