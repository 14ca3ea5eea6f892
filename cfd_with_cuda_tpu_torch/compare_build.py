"""Hold the G and compact G^T kernels against an earlier build of the same
functions, on the same inputs, on the card.

    git archive <commit> cfd_with_cuda_tpu_torch/csrc | tar -x -C <dir>
    python -m cfd_with_cuda_tpu_torch.compare_build --against <dir>

Builds ``<dir>/cfd_with_cuda_tpu_torch/csrc/{window_stencil,div_compact}.cu``
with this checkout's ``nvcc`` flags into ``_build/against/`` and, on the
interleaved explicit solver's tables of the NE27000 cavity
``cavity_deck(30, cluster=2.0)`` and seeded fields, calls both builds:

* G p: the earlier build's full-window GRAD mode (``window_stencil_f32`` /
  ``_f64`` mode 1 on ``G_win``) against this checkout's
  ``grad_window_compact`` on ``G_cwin`` (TPU kernel row 10), f32 and f64;
* G^T u: ``div_compact_f32`` on the class split of u (row 4) and
  ``div_compact_interleaved_f32`` (row 11), the same C entry points in
  both builds.

For each: the largest |difference|, whether the results are equal bit for
bit and, where they are not, whether they are equal as values (the sign of
an exact zero apart); and each build's device ms (profiler) and ms per call
(CUDA events) over REPS launches, timed in turns: earlier, this,
this, earlier.  Prints one JSON line, then the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
from cfd_with_cuda_tpu_torch.ops import cuda_lib
from cfd_with_cuda_tpu_torch.ops import window_stencil as ws
from cfd_with_cuda_tpu_torch.ops.parity_stencil import parity_split
from cfd_with_cuda_tpu_torch.ops.stencil import coarse_to_fine
from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

_SOURCES = ("window_stencil", "div_compact")
DECK_N = 30         # cavity elements per edge: NE27000
REPS = 20           # launches per timing
_GRAD_MODE = 1      # the full-window GRAD mode of the earlier window_stencil.cu


def build_against(checkout: Path) -> dict[str, ctypes.CDLL]:
    """The earlier checkout's two kernel libraries, built in parallel."""
    out = cuda_lib.BUILD_DIR / "against"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in _SOURCES:
        src = checkout / "cfd_with_cuda_tpu_torch" / "csrc" / f"{name}.cu"
        lib = out / f"lib{name}.so"
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _entry(libs, name: str):
    """An entry point of the earlier build, typed as this checkout's."""
    source, argtypes = cuda_lib._SIGNATURES[name]
    fn = getattr(libs[source], name)
    fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return fn


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int) -> float:
    """Mean device time of one call: the summed spans of the kernels that
    ``reps`` calls run (torch.profiler), over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3


def _compare(earlier, this, reps: int) -> dict:
    """Both builds' results and times on the same inputs: device time
    (profiler) and time per call (CUDA events, which also read the host's
    launch rate), each in turns earlier, this, this, earlier."""
    a, b = earlier(), this()
    torch.cuda.synchronize()
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    order = (earlier, this, this, earlier)
    dev = [_device_ms(fn, reps) for fn in order]
    ev = [_event_ms(fn, reps) for fn in order]
    return dict(max_abs_diff=float((a - b).abs().max()),
                bit_equal=torch.equal(a.view(ints), b.view(ints)),
                value_equal=torch.equal(a, b),
                earlier_device_ms=[dev[0], dev[3]], this_device_ms=[dev[1], dev[2]],
                earlier_event_ms=[ev[0], ev[3]], this_event_ms=[ev[1], ev[2]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="an earlier checkout (at least its cfd_with_cuda_tpu_torch/csrc)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_build: no CUDA device available")

    libs = build_against(args.against)
    cuda_lib.build_all()
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, structured_layout="interleaved")
    s = ExplicitBCHSolver(cavity_deck(DECK_N, cluster=2.0, viscosity=0.01, dt=0.001), cfg)
    d, fine, coarse, n = s.d, s.fine_dims, s.coarse_dims, s.s_pad
    rng = np.random.default_rng(20261020)
    dev = s.device
    pf = torch.nn.functional.pad(
        coarse_to_fine(torch.from_numpy(rng.standard_normal(s.nnp).astype(np.float32)).to(dev),
                       coarse, fine), (0, n - s.nn))
    u = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)).to(dev)
    stream = cuda_lib.stream_ptr(dev)
    ptr = cuda_lib.ptr
    out = {}

    # ---- G p, f32 and f64
    offs = torch.tensor(ws.window_offsets(fine, s.g_radius), dtype=torch.int32, device=dev)
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        g, gc, x = d["G_win"].to(dt), d["G_cwin"].to(dt), pf.to(dt)
        fn = _entry(libs, f"window_stencil_{tag}")
        y = torch.empty((3, n), dtype=dt, device=dev)

        def earlier(g=g, x=x, y=y, fn=fn):
            cuda_lib.check(fn(_GRAD_MODE, ptr(g), ptr(x), 1, ptr(offs), len(offs), ptr(y), n,
                              stream), "earlier GRAD")
            return y

        out[f"grad_{tag}"] = _compare(
            earlier, lambda gc=gc, x=x: ws.grad_window_compact(gc, x, fine, s.g_radius,
                                                               trim=False), REPS)
        del g, gc, x, y

    # ---- G^T u, class-major (row 4) and interleaved (row 11)
    gt = d["GT_cwin"]
    sp = gt.shape[-1]
    pairs = ws.div_class_pairs(coarse)
    pairs_t = torch.tensor(pairs, dtype=torch.int32, device=dev).reshape(-1)
    up = parity_split(u, fine, sp).contiguous()
    y_c = torch.empty(sp, device=dev)
    fn_c = _entry(libs, "div_compact_f32")

    def earlier_c():
        cuda_lib.check(fn_c(ptr(gt), len(pairs), ptr(up), ptr(pairs_t), ptr(y_c), sp, stream),
                       "earlier div_compact")
        return y_c

    out["div_compact"] = _compare(earlier_c, lambda: ws.div_compact(gt, up, pairs), REPS)
    foffs = torch.tensor(ws.window_offsets(fine, 2), dtype=torch.int32, device=dev)
    (cx, cy, cz), (fx, fy, _) = coarse, fine
    y_i = torch.empty(sp, device=dev)
    fn_i = _entry(libs, "div_compact_interleaved_f32")

    def earlier_i():
        cuda_lib.check(fn_i(ptr(gt), len(foffs), ptr(u), n, ptr(foffs), ptr(y_i), sp, cx, cy,
                            cx * cy * cz, fx, fy, stream), "earlier div_compact_interleaved")
        return y_i

    out["div_compact_interleaved"] = _compare(
        earlier_i, lambda: ws.div_compact_interleaved(gt, u, fine, coarse), REPS)

    print(json.dumps(dict(deck_n=DECK_N, s_pad=n, sp=sp, against=str(args.against),
                          checks=out)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
