"""Reading a ``torch.profiler`` trace of the traced segments: device spans,
host spans, the busy share, kernel names by the CUDA source that defines
them, and the breakdown the result line carries.

``busy_share`` is a copy of the port's ``utils/timers.busy_share`` (the
union of the device spans over the host wall), kept here so that a change
to the port cannot move the yardstick.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

__all__ = ["Span", "TraceData", "busy_share", "kernel_sources", "kernel_name", "reduce_profile",
           "breakdown"]

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


class Span(NamedTuple):
    name: str
    start: float    # microseconds
    end: float


class TraceData(NamedTuple):
    device: list        # Span of every device event (kernel, copy, set)
    host: list          # Span of every host event
    wall_us: float      # the host wall of the traced segments


def busy_share(spans, wall_us: float) -> float | None:
    """The union of the ``(start, end)`` spans over ``wall_us`` (None with
    no span)."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted((s[-2], s[-1]) for s in spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy / wall_us if spans else None


def kernel_sources(csrc: Path) -> dict:
    """``{kernel function name: source stem}`` of every ``__global__``
    function in the ``.cu`` files of ``csrc``."""
    out = {}
    for src in sorted(Path(csrc).glob("*.cu")):
        for name in _GLOBAL.findall(src.read_text()):
            out[name] = src.stem
    return out


def kernel_name(event_name: str) -> str:
    """The unqualified function name of a device event's (demangled) name:
    ``"void (anonymous namespace)::cg_iter_kernel<false, false, 1>(cgk::CgArgs)"``
    -> ``"cg_iter_kernel"``."""
    name = event_name[5:] if event_name.startswith("void ") else event_name
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(\s]", name, maxsplit=1)[0].split("::")[-1]


def reduce_profile(prof, wall_us: float) -> TraceData:
    """The spans of a finished ``torch.profiler.profile``."""
    import torch

    dev, host = [], []
    for e in prof.events():
        span = Span(e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(span)
    return TraceData(dev, host, wall_us)


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def breakdown(trace: TraceData, top: int = 10) -> dict:
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[host op, s], ...]}``:
    device time by op name, and the device's idle time by the innermost host
    op running at the middle of each gap (``"python"`` where none is)."""
    ops = defaultdict(float)
    for s in trace.device:
        ops[_short(s.name)] += (s.end - s.start) * 1e-6
    gaps = defaultdict(float)
    dev = sorted(trace.device, key=lambda s: s.start)
    host = sorted(trace.host, key=lambda s: s.start)
    last = dev[0].end if dev else 0.0
    hi = 0
    for s in dev[1:]:
        if s.start > last:
            mid = 0.5 * (s.start + last)
            while hi < len(host) and host[hi].start <= mid:
                hi += 1
            inner = None
            for h in reversed(host[max(0, hi - 400):hi]):
                if h.end >= mid and (inner is None or h.end - h.start < inner.end - inner.start):
                    inner = h
            gaps[_short(inner.name) if inner else "python"] += (s.start - last) * 1e-6
        last = max(last, s.end)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
