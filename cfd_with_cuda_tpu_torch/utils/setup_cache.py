"""On-disk setup cache: skip the host setup on warm starts.

Port of ``cfd_with_cuda_tpu/utils/setup_cache.py``.  The reference re-runs
its full setup (deck parse, 27-node promotion, CSR pattern construction,
step0 assembly) on every launch (``blascoCodinaHuerta.cpp:383-508``).  Here
a solver snapshots its finished host tables (the numpy arrays of ``d``,
taken before they move to the device), its static attributes
(``static_attrs()``) and the mesh arrays, keyed by a fingerprint of the deck
*contents*, the config fields that shape the tables and the port's own
choices (the package, the solver class, whether the config takes the kernel
path), so a warm start is one pickle load.  The setup does not branch on
``plain`` (it picks the step functions only) nor on the device (the tables
are built on the host and moved after), so neither is in the key.

The port keeps its own ``SCHEMA``, its own default directory
``<repo>/.cache/setup_torch`` and its own environment variables
(``CFD_TORCH_CACHE_DIR``, ``CFD_TORCH_CACHE_MAX_GB``), so a snapshot of the
JAX package is never read.  The JAX module's ``enable_compilation_cache``
has no counterpart: there is no XLA compile here, and the port's kernels
are built once into ``_build/`` (``ops/cuda_lib.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np

__all__ = [
    "deck_fingerprint",
    "snapshot_load",
    "snapshot_store",
    "evict_lru",
    "cache_max_bytes",
    "default_cache_dir",
    "solver_snapshot",
    "solver_restore",
]

# bump when solver snapshot layouts change: stale entries just miss
SCHEMA = 1
PACKAGE = "cfd_with_cuda_tpu_torch"


def default_cache_dir() -> str | None:
    """Cache dir from $CFD_TORCH_CACHE_DIR (empty: caching off), else
    ``<repo>/.cache/setup_torch``."""
    env = os.environ.get("CFD_TORCH_CACHE_DIR")
    if env == "":
        return None
    if env:
        return env
    root = Path(__file__).resolve().parents[2]
    return str(root / ".cache" / "setup_torch")


def _hash_update(h, obj) -> None:
    if isinstance(obj, np.ndarray):
        h.update(str(obj.dtype).encode())
        h.update(str(obj.shape).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        h.update(f"seq{len(obj)}(".encode())
        for item in obj:
            _hash_update(h, item)
        h.update(b")")
    else:
        # length-framed so adjacent scalars cannot collide
        # (repr(12)+repr(3) == repr(1)+repr(23))
        r = repr(obj).encode()
        h.update(f"v{len(r)}:".encode())
        h.update(r)


# Config fields that SHAPE the setup tables (the JAX package's include-list:
# runtime knobs like tolerances, chunk sizes and warm starts stay out, so
# tuning them never re-runs the setup).  The backend choice enters through
# the solvers' ``extra`` arguments (whether the config takes the kernel path).
_CFG_INCLUDE = (
    "dtype_policy",      # array dtypes
    "pressure_pin_large",  # baked into Z values
    "pressure_precond",  # MG hierarchy built (or not) at setup
    "structured",        # box layouts vs ELL
    "shard_pad",         # device-array padding
    "spmd_devices",      # sharded fast path changes the pad multiple
    "structured_layout",  # parity-split vs interleaved tables
    "pressure_cg_sym",   # half vs full CG window
)
# deck fields that are provenance, not content
_DECK_EXCLUDE = frozenset({"source_path"})


def deck_fingerprint(deck, config, *extra) -> str:
    """Content hash of everything that shapes a solver's setup products."""
    h = hashlib.sha256()
    h.update(f"package={PACKAGE} schema={SCHEMA}".encode())
    for f in dataclasses.fields(deck):
        if f.name in _DECK_EXCLUDE:
            continue
        h.update(f.name.encode())
        _hash_update(h, getattr(deck, f.name))
    for name in _CFG_INCLUDE:
        h.update(name.encode())
        _hash_update(h, getattr(config, name))
    for item in extra:
        _hash_update(h, item)
    return h.hexdigest()[:32]


def snapshot_load(cache_dir: str | None, key: str) -> dict | None:
    """The snapshot stored under ``key``, or None (no file, or a file that
    does not unpickle: a miss)."""
    if not cache_dir:
        return None
    path = Path(cache_dir) / f"{key}.pkl"
    if not path.exists():
        return None
    try:
        with open(path, "rb") as f:
            snap = pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ValueError):
        return None             # corrupt / partial / stale file: a miss
    try:
        os.utime(path)          # LRU recency for evict_lru
    except OSError:             # read-only dir: keep the hit anyway
        pass
    return snap


def cache_max_bytes() -> int:
    """Setup-cache size cap: $CFD_TORCH_CACHE_MAX_GB (default 8 GB; 0
    disables eviction)."""
    return int(float(os.environ.get("CFD_TORCH_CACHE_MAX_GB", "8")) * 1e9)


def evict_lru(cache_dir: str | Path, max_bytes: int | None = None) -> None:
    """Delete least-recently-used snapshots until the dir fits the cap."""
    max_bytes = cache_max_bytes() if max_bytes is None else max_bytes
    if max_bytes <= 0:
        return
    entries = []
    for p in Path(cache_dir).glob("*.pkl"):
        try:
            st = p.stat()
            entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            continue
    # orphaned mkstemp leftovers (writer killed mid-dump): a live writer's
    # tmp is seconds old
    for p in Path(cache_dir).glob("*.tmp"):
        try:
            if time.time() - p.stat().st_mtime > 3600:
                p.unlink()
        except OSError:
            continue
    total = sum(sz for _, sz, _ in entries)
    for _, sz, p in sorted(entries):            # oldest first
        if total <= max_bytes:
            break
        try:
            p.unlink()
            total -= sz
        except OSError:
            pass


def snapshot_store(cache_dir: str | None, key: str, snap: dict) -> int:
    """Publish ``snap`` under ``key`` atomically; returns the bytes written
    (0 when caching is off or the directory is not writable: a read-only
    install runs without the cache)."""
    if not cache_dir:
        return 0
    d = Path(cache_dir)
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    except OSError:
        return 0
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(snap, f, protocol=5)
        os.replace(tmp, d / f"{key}.pkl")
    except BaseException as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if isinstance(e, OSError):      # disk full, directory gone: no cache
            return 0
        raise
    nbytes = (d / f"{key}.pkl").stat().st_size
    evict_lru(d)
    return nbytes


def solver_snapshot(solver) -> dict:
    """A solver's host tables, static attributes and mesh arrays.

    Called while ``solver.d`` still holds the host numpy arrays (the solvers
    move them to the device after the snapshot)."""
    return {
        "d": {k: np.asarray(v) for k, v in solver.d.items()},
        "attrs": solver.static_attrs(),
        "mesh": {
            "ltog_node": solver.mesh.ltog_node,
            "coords": solver.mesh.coords,
            "ncn": solver.mesh.ncn,
            "nn": solver.mesh.nn,
        },
    }


def solver_restore(solver, snap: dict) -> None:
    """Restore a solver from :func:`solver_snapshot` output, as
    ``from_tables`` builds one: the layout and its static values, the host
    tables in ``d`` (moved to the device by the caller) and the mesh.
    ``solver.ops`` / ``solver.tables`` stay None on a hit: they are setup
    intermediates that no step reads."""
    from cfd_with_cuda_tpu_torch.mesh.topology import PromotedMesh

    attrs = snap["attrs"]
    solver._set_layout(attrs["layout"], xla=attrs["xla"])
    for k in solver._layout_attrs():
        setattr(solver, k, attrs[k])
    solver.d = dict(snap["d"])
    m = snap["mesh"]
    solver.mesh = PromotedMesh(
        ltog_node=m["ltog_node"], coords=m["coords"], ncn=m["ncn"], nn=m["nn"]
    )
    solver.ops = None
    solver.tables = None
