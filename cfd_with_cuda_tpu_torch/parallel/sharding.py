"""Ranks, the mesh over them, the placement rule and the collectives.

Port of ``cfd_with_cuda_tpu/parallel/sharding.py``.  The JAX package's mesh
is a set of devices under one program; here it is the default
``torch.distributed`` process group, one process a rank, each running the
same program on its own block of the padded fine axis:

* :func:`init_ranks` starts this process's rank, from ``torchrun``'s
  environment or from a file store (``init_method="file://..."``).  The
  backend is NCCL when every rank has a CUDA card of its own, gloo on the
  CPU; gloo with CUDA tensors (several ranks on one card, which NCCL
  refuses) only when the caller passes ``backend="gloo"``;
* :func:`make_mesh` is the mesh over that group (:class:`Mesh`: rank, size,
  device, backend), or over this one process when no group is started;
* :func:`shard_params` and :func:`shard_state` keep the JAX package's rule
  (:func:`_spec_for`): the last axis is cut into contiguous rank blocks only
  when its size is one of ``big_axes`` and divisible by the rank count;
  everything else is replicated (every rank holds it whole: a process a
  rank needs no call for that);
* :func:`gather` rebuilds a full tensor on every rank;
* the collectives of the sharded path (:func:`halo_exchange`,
  :func:`all_gather`, :func:`all_reduce`, :func:`broadcast`), each under a
  name that :data:`collective_counts` counts with its bytes.  Over gloo a
  CUDA tensor is staged through a pinned host buffer, explicitly, since
  gloo's send, receive and collectives are run on host tensors here.
  Without a process group (one process) they are identities; with one,
  every rank calls them, at size 1 too, but for the halo exchange, which
  has nothing to send or receive at a grid edge.

No fallback hides a rank: a mesh of n ranks needs a group of n.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "init_ranks", "make_mesh", "shard_params", "shard_state", "gather",
    "block_of", "halo_exchange", "all_gather", "all_reduce", "broadcast", "collective_counts",
    "reset_collective_counts",
]

# collective name -> [calls, bytes sent by this rank]
collective_counts: dict[str, list[int]] = {}

# the device init_ranks chose for this rank
_rank_device: torch.device | None = None

# how long a rank waits for the others in a collective before it fails
_TIMEOUT = datetime.timedelta(seconds=300)

# the partition spec's name of the rank axis (the JAX package's mesh axis)
_AXIS = "shard"


def reset_collective_counts() -> None:
    collective_counts.clear()


def _count(what: str, nbytes: int) -> None:
    c = collective_counts.setdefault(what, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the sharded path: this process's ``rank`` of ``size``,
    its ``device``, the group's ``backend`` (None: no process group, one
    process)."""
    rank: int
    size: int
    device: torch.device
    backend: str | None

    @property
    def group(self) -> bool:
        return self.backend is not None


def init_ranks(backend: str | None = None, *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None, device=None) -> Mesh:
    """Start this process's rank of the default process group and return the
    mesh over it.  ``init_method`` None reads ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a ``file://`` path is a file store, with ``rank`` and
    ``world_size`` given.  ``device``: None is this rank's CUDA card (raises
    without one), ``"cpu"`` the CPU.  ``backend`` None: ``"nccl"`` on CUDA,
    which takes a card a rank (cuda:LOCAL_RANK; raises when the ranks
    outnumber the cards), ``"gloo"`` on the CPU.  ``backend="gloo"`` with a
    CUDA device puts every rank on ``device`` (cuda:0 for None) and stages
    the collectives through host buffers."""
    global _rank_device
    if init_method is None:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        init_method = "env://"
    else:
        # a file store's ranks share this host: their transports use loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if rank is None or world_size is None:
        raise ValueError("init_ranks: a file store needs rank and world_size")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"init_ranks: backend {backend!r} on the CPU (gloo runs there)")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_ranks: no CUDA device is available; pass device='cpu' to "
                               "run the ranks on the CPU over gloo")
        backend = backend or "nccl"
        if backend == "nccl":
            if device is not None:
                dev = torch.device(device)
            else:
                if local >= torch.cuda.device_count():
                    raise ValueError(
                        f"init_ranks: rank {rank} (local {local}) finds "
                        f"{torch.cuda.device_count()} CUDA cards; NCCL takes a card a rank, "
                        "pass backend='gloo' for several ranks on one card")
                dev = torch.device("cuda", local)
        elif backend == "gloo":
            dev = torch.device(device if device is not None else "cuda:0")
        else:
            raise ValueError(f"init_ranks: unknown backend {backend!r}")
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=_TIMEOUT, **kw)
    _rank_device = dev
    return make_mesh(world_size)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the default process group (or over this one process
    when none is started).  Raises ``ValueError`` when more ranks are asked
    for than the group has, or fewer (every rank runs the same program)."""
    if dist.is_available() and dist.is_initialized():
        size, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
        dev = _rank_device or (torch.device("cuda", torch.cuda.current_device())
                               if backend == "nccl" else torch.device("cpu"))
    else:
        size, rank, backend, dev = 1, 0, None, _rank_device or torch.device("cpu")
    n = int(n_devices or size)
    if size < n:
        raise ValueError(
            f"requested a {n}-device mesh but only {size} devices are visible (ranks of the "
            "default process group); start n ranks: torchrun --nproc-per-node n, or "
            "cfd_with_cuda_tpu_torch.parallel.sharding.init_ranks in each of n processes"
        )
    if size > n:
        raise ValueError(f"requested a {n}-device mesh in a group of {size} ranks: every rank "
                         "runs the same program, so the mesh takes them all")
    return Mesh(rank, size, dev, backend)


# ------------------------------------------------------------ placement

def _spec_for(arr, big_axes, axis_name: str, n_shards: int) -> tuple:
    """The JAX package's placement rule as a partition spec: the last axis
    cut (``axis_name``) iff its size is one of ``big_axes`` and divisible by
    ``n_shards``, else ``()`` (replicated)."""
    shape = tuple(arr.shape)
    if len(shape) == 0 or shape[-1] not in big_axes or shape[-1] % n_shards:
        return ()
    return (None,) * (len(shape) - 1) + (axis_name,)


def block_of(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the last axis of ``t``."""
    n = t.shape[-1] // mesh.size
    return t[..., mesh.rank * n: (mesh.rank + 1) * n]


def _place(v, big_axes, mesh: Mesh):
    if not isinstance(v, torch.Tensor):
        return v
    spec = _spec_for(v, big_axes, _AXIS, mesh.size)
    return (block_of(v, mesh) if spec else v).contiguous()


def shard_params(params: dict, mesh: Mesh, big_axes) -> dict:
    """Every tensor of ``params`` as this rank holds it: its block of the last
    axis when that axis's size is in ``big_axes``, else the whole tensor."""
    return {k: _place(v, tuple(big_axes), mesh) for k, v in params.items()}


def shard_state(state, mesh: Mesh, big_axes):
    """A state (a NamedTuple or tuple of tensors) placed the same way."""
    placed = [_place(v, tuple(big_axes), mesh) for v in state]
    return type(state)(*placed) if hasattr(state, "_fields") else type(state)(placed)


def gather(t: torch.Tensor, mesh: Mesh, what: str = "gather") -> torch.Tensor:
    """The full tensor from every rank's block of its last axis (equal
    blocks), on every rank."""
    if not mesh.group:
        return t
    parts = all_gather(t, mesh, what)                     # (size, ..., n)
    return parts.movedim(0, -2).reshape(*t.shape[:-1], mesh.size * t.shape[-1])


# ------------------------------------------------------------ collectives

_pinned: dict = {}


def _host(t: torch.Tensor, key) -> torch.Tensor:
    """``t`` copied into a pinned host buffer kept under ``key``."""
    buf = _pinned.get(key)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        _pinned[key] = buf
    buf.copy_(t)
    return buf


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _halo_plan(rank: int, size: int, n: int, left: int, right: int) -> list:
    """``[(peer, (a, b) of this rank's block to send, (a, b) to receive), ...]``
    in peer order, global rows: every rank's window is its block widened by
    ``left`` / ``right`` and cut to the axis ``[0, size * n)``; what it lacks
    comes from whichever ranks hold it (the neighbours alone when the halos
    fit in a block)."""
    total = size * n
    win = lambda q: (max(0, q * n - left), min(total, (q + 1) * n + right))
    cut = lambda a, b: (a, b) if a < b else None
    m0, m1 = rank * n, (rank + 1) * n
    w0, w1 = win(rank)
    plan = []
    for q in range(size):
        if q == rank:
            continue
        q0, q1 = q * n, (q + 1) * n
        v0, v1 = win(q)
        if q < rank:
            send, recv = cut(max(m0, q1), min(m1, v1)), cut(max(q0, w0), min(q1, m0))
        else:
            send, recv = cut(max(m0, v0), min(m1, q0)), cut(max(q0, m1), min(q1, w1))
        if send or recv:
            plan.append((q, send, recv))
    return plan


def halo_exchange(x_loc: torch.Tensor, left: int, right: int, mesh: Mesh,
                  what: str = "halo") -> tuple[torch.Tensor, int]:
    """``([left halo | x_loc | right halo], lo)`` along the last axis: the
    ``left`` entries before the block and the ``right`` after it, from the
    ranks that hold them (the neighbours' when the halos fit in a block),
    ``lo`` the entries before ``x_loc`` (``left``, or fewer at the start of
    the axis).  Past a grid edge the block is not extended: the kernels read
    zero outside the field they are given, which is the JAX package's zero
    fill (one rank: ``x_loc`` itself, no copy).  Every rank calls it with the
    same halos; its sends and receives are one ``dist.batch_isend_irecv``
    call."""
    c, n = x_loc.shape
    r = mesh.rank
    plan = _halo_plan(r, mesh.size, n, left, right)
    lo = min(left, r * n)
    hi = min(right, (mesh.size - 1 - r) * n)
    staged = _staged(mesh, x_loc)
    ops, parts = [], []
    for i, (peer, send, recv) in enumerate(plan):
        if send:
            snd = x_loc[:, send[0] - r * n: send[1] - r * n]
            snd = _host(snd, (what, "s", i)) if staged else snd.contiguous()
            ops.append(dist.P2POp(dist.isend, snd, peer))
            _count(what, snd.numel() * snd.element_size())
        if recv:
            buf = x_loc.new_empty((c, recv[1] - recv[0]))
            rcv = _host(buf, (what, "r", i)) if staged else buf
            ops.append(dist.P2POp(dist.irecv, rcv, peer))
            parts.append((peer, rcv, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if not (lo or hi):
        return x_loc, 0
    if staged:
        for _, rcv, buf in parts:
            buf.copy_(rcv)
    before = [buf for peer, _, buf in parts if peer < r]
    after = [buf for peer, _, buf in parts if peer > r]
    return torch.cat([*before, x_loc, *after], dim=-1), lo


# the all-gather into one flat tensor (newer releases rename it)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, mesh: Mesh, what: str = "all_gather") -> torch.Tensor:
    """``(size, *t.shape)``: every rank's ``t`` (equal shapes), in rank
    order, on every rank; one collective into one tensor."""
    if not mesh.group:
        return t[None]
    _count(what, t.numel() * t.element_size())
    src = (_host(t, (what, "s")) if _staged(mesh, t) else t.contiguous()).view(-1)
    out = src.new_empty(mesh.size * src.numel())
    _all_gather_flat(out, src)
    return out.view(mesh.size, *t.shape).to(t.device)


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum",
               what: str = "all_reduce") -> torch.Tensor:
    """The sum (``op="sum"``) or maximum (``"max"``) of every rank's ``t``,
    on every rank (a new tensor)."""
    if not mesh.group:
        return t
    _count(what, t.numel() * t.element_size())
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged(mesh, t):
        h = _host(t, (what, "r"))
        dist.all_reduce(h, rop)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, rop)
    return out


def broadcast(t: torch.Tensor, src: int, mesh: Mesh, what: str = "broadcast") -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor)."""
    if not mesh.group:
        return t
    _count(what, t.numel() * t.element_size() if mesh.rank == src else 0)
    if _staged(mesh, t):
        h = _host(t, (what, "b"))
        dist.broadcast(h, src)
        return h.to(t.device)
    out = t.clone()
    dist.broadcast(out, src)
    return out
