"""Observability: phase wall-clock timers, the monitor table and a trace.

Port of ``cfd_with_cuda_tpu/utils/timers.py``.  Replaces the reference's
``getHighResolutionTime``/``PRINT_TIMES`` ladder
(``blascoCodinaHuerta.cpp:4489-4518``, per-phase prints at :415-507 and the
per-step ``TimeSpend`` column :3084-3093).  :func:`torch_trace` takes the
place of the JAX package's ``jax_trace``: a ``torch.profiler`` trace of a
region, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["PhaseTimer", "monitor_header", "monitor_row", "ms_per_step", "torch_trace",
           "device_spans", "busy_share"]


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; prints like the reference."""

    verbose: bool = True
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if self.verbose:
                print(f"{name:<24s} took {dt:9.3f} seconds.")

    def report(self) -> str:
        lines = [f"{k:<24s} {v:9.3f} s" for k, v in self.phases.items()]
        return "\n".join(lines)


def monitor_header() -> str:
    """The reference's monitor table header (:2855-2856)."""
    return (
        "Time step  Iter     Time       u_monitor     v_monitor     "
        "w_monitor     p_monitor     TimeSpend      maxAcc \n"
        + "-" * 109
    )


def monitor_row(step, iters, t, u, v, w, p, wall, max_acc) -> str:
    return (
        f"{step:6d}  {iters:6d}  {t:10.5f}  {u:12.5f}  {v:12.5f}  "
        f"{w:12.5f}  {p:12.5f} {wall:12.5f} {max_acc:12.5f}"
    )


@contextlib.contextmanager
def torch_trace(log_dir: str | None, file_name: str = "trace.json"):
    """Optional ``torch.profiler`` trace around a region: host ops, and the
    card's kernels and copies when a CUDA device is visible, exported as a
    Chrome trace to ``<log_dir>/<file_name>``.  Yields the profiler (None
    when ``log_dir`` is empty)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / file_name))


def ms_per_step(history, warm: int) -> float | None:
    """Host ms/step of steps ``warm + 1`` to the end of a run's history
    (``warm >= 1``), from its ``wall`` column: each step's end, once the
    host has read its steady flag.  None when no step follows ``warm``."""
    if len(history) <= warm:
        return None
    return (history[-1]["wall"] - history[warm - 1]["wall"]) / (len(history) - warm) * 1e3


def device_spans(prof) -> list:
    """The (start, end) microseconds of every device event (kernel, copy,
    set) of a finished ``torch.profiler`` trace."""
    import torch

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_share(spans, wall_us: float) -> float | None:
    """The card's busy share of a traced region: the union of the device
    ``spans`` over the host wall time ``wall_us`` (None with no span)."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy / wall_us if spans else None
