#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # the NE27000 cavity, 100 steps
    python3 chip_smoke.py --deck-n 4 --steps 6   # a quick small run

Drives the port's main path — the explicit BCH solver on the parity layout,
``ExplicitBCHSolver(deck, config).run(...)`` — on the generated NE27000
lid-driven cavity (``cavity_deck(30, cluster=2.0)``, 61^3 velocity and 31^3
pressure nodes) with the F32 / CG tol 1e-6 / warm-started, fused-CG
configuration, and checks it:

1. toolchain: card, power limit, CUDA, nvcc, triton, and the kernel build
   (every ``csrc/*.cu`` compiled from the checkout, in parallel);
2. kernels: every launch form of the path (K, G, K + A planes, G^T, and the
   CG cold and warm) at the path's shapes and tables, against its plain
   PyTorch version on the card, with each tolerance and its reason, the
   kernel, plain and library times, and the roofline bound;
3. e2e: warm-up then timed steps with the launch counters set to 0 just
   before, every count > 0 and equal to what the sub-iteration history
   implies, finite fields; then 3 steps of the kernel path and of the plain
   path from the same state, which must agree; and on the NE27000 deck the
   100-step monitor trace and final velocity against the stored f64 run
   (``cfd_with_cuda_tpu/validation/data/precision_ne27000.npz``, bounds of
   ``tests/test_validation.py:194-195``).

Each phase prints one JSON line.  Any failure raises (non-zero exit, no
result line).  The last lines are the ``kernels`` summary, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32, outside the tensor cores
WARMUP_STEPS = 5
APPLY_TOL = 1e-5   # of the largest sum |w x|: FMA vs rounded product over <= 1241 terms, same order
CG_X_TOL = 1e-3    # of max|x|: two f32 CGs whose dots sum in different orders, ~40 iterations
STEP_TOLS = dict(u=5e-6, p=5e-5, mon=5e-6)   # tests/test_parity_stencil.py:285-289


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------- phase 1

def phase_toolchain(cuda_lib) -> dict:
    import torch

    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_info = triton.__version__
    except ImportError as e:
        triton_info = f"not importable: {e}"
    t0 = time.time()
    logs = cuda_lib.build_all(extra_flags=("-Xptxas", "-v"))
    build_s = time.time() - t0
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    out = dict(phase="toolchain", card=smi_line(), torch=torch.__version__,
               torch_cuda=torch.version.cuda, nvcc=nvcc[-1], triton=triton_info,
               kernel_build_s=build_s, ptxas=ptxas)
    emit(out)
    return out


# ---------------------------------------------------------------- phase 2

def _csr(rows, cols, vals, shape):
    import torch

    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                check_invariants=False).coalesce()
    return a.to_sparse_csr()


def _route_csr(tables, routes, sp, n_in_classes, per_channel):
    """The parity apply as one sparse matrix, for the library yardstick.

    ``tables``: weight tensors (cw, m_t, Sp); ``routes``: pairs tuples, one
    per table.  Shared weights (cw = 1): rows p*Sp + q, cols p_in*Sp + q + dq.
    Per-channel weights (cw = 3, one input channel): rows (c*8 + p)*Sp + q.
    """
    import torch

    dev = tables[0].device
    q = torch.arange(sp, device=dev)
    rows, cols, vals = [], [], []
    for w, pairs in zip(tables, routes):
        for p, cls in enumerate(pairs):
            if not cls:
                continue
            e = torch.tensor(cls, device=dev)              # (E, 3): j, p_in, dq
            j, pp, dq = e[:, 0], e[:, 1], e[:, 2]
            qs = q[None] + dq[:, None]
            ok = (qs >= 0) & (qs < sp)
            chans = range(w.shape[0]) if per_channel else (0,)
            for c in chans:
                r = (c * 8 + p) * sp + q[None].expand_as(qs) if per_channel else p * sp + q[None].expand_as(qs)
                rows.append(r[ok])
                cols.append((pp[:, None] * sp + qs)[ok])
                vals.append(w[c][j][ok])
    n_rows = (tables[0].shape[0] if per_channel else 1) * 8 * sp
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n_rows, n_in_classes * sp))


def _div_csr(gt, pairs, sp):
    import torch

    dev = gt.device
    q = torch.arange(sp, device=dev)
    e = torch.tensor(pairs, device=dev)
    cls, off = e[:, 0], e[:, 1]
    qs = q[None] + off[:, None]
    ok = (qs >= 0) & (qs < sp)
    rows, cols, vals = [], [], []
    for d in range(3):
        rows.append(q[None].expand_as(qs)[ok])
        cols.append(((d * 8 + cls[:, None]) * sp + qs)[ok])
        vals.append(gt[d][ok])
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (sp, 24 * sp))


def _apply_err(y, y_plain, y_abs):
    """(max |y - y_plain|, its ratio to the largest sum |w x|)."""
    err = float((y - y_plain).abs().max())
    return err, err / float(y_abs.abs().max())


def phase_kernels(solver, pstl, cuda_lib, fused_cg_mod, window_stencil) -> dict:
    import numpy as np
    import torch

    d, sp = solver.d, solver.sp_c
    rng = np.random.default_rng(20260816)
    dev = solver.device
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    results = {}

    def apply_check(name, wc, x, pairs, co, wc2=None, pairs2=None, lib_fn=None, lib_out=None):
        kw = dict(pairs=pairs, co=co, wc2=wc2, pairs2=pairs2)
        y = pstl.parity_apply(wc, x, **kw)
        y_plain = pstl.parity_apply_plain(wc, x, **kw)
        y_abs = pstl.parity_apply_plain(wc.abs(), x.abs(), pairs=pairs, co=co,
                                        wc2=None if wc2 is None else wc2.abs(), pairs2=pairs2)
        torch.cuda.synchronize()
        err, rel = _apply_err(y, y_plain, y_abs)
        if not rel <= APPLY_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rel:.3e} > {APPLY_TOL}")
        ms = time_ms(lambda: pstl.parity_apply(wc, x, **kw), 20)
        plain_ms = time_ms(lambda: pstl.parity_apply_plain(wc, x, **kw), 3)
        lib_ms, lib_err = None, None
        if lib_fn is not None:
            lib_ms = time_ms(lib_fn, 20)
            lib_err = float((lib_out() - y).abs().max())
        m_all = wc.shape[1] * wc.shape[0] + (0 if wc2 is None else wc2.shape[1] * wc2.shape[0])
        nbytes = 4 * (m_all * sp + x.numel() + co * 8 * sp)
        flops = 2 * co * sp * (wc.shape[1] + (0 if wc2 is None else wc2.shape[1]))
        b_ms, b_by = bound(nbytes, flops)
        results[name] = dict(max_abs_err=err, err_rel=rel, tol=APPLY_TOL, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, library_abs_err=lib_err,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        del y, y_plain, y_abs

    # K u (one table, shared weights over 3 channels)
    u = rand(3, 8, sp)
    a_k = _route_csr([d["Kp"]], [solver.k_pairs], sp, 8, per_channel=False)
    ut = u.reshape(3, 8 * sp).T.contiguous()
    apply_check("parity_apply_k", d["Kp"], u, solver.k_pairs, 3,
                lib_fn=lambda: torch.sparse.mm(a_k, ut),
                lib_out=lambda: torch.sparse.mm(a_k, ut).T.reshape(3, 8, sp))
    del a_k
    # G p (one table, per-channel weights, the coarse pressure as (1, 1, Sp))
    p = torch.zeros(1, 1, sp, device=dev)
    p[0, 0, : solver.nnp] = rand(solver.nnp)
    a_g = _route_csr([d["Gp"]], [solver.g_pairs], sp, 1, per_channel=True)
    pv = p.reshape(sp)
    apply_check("parity_apply_g", d["Gp"], p, solver.g_pairs, 3,
                lib_fn=lambda: torch.mv(a_g, pv),
                lib_out=lambda: torch.mv(a_g, pv).reshape(3, 8, sp))
    del a_g
    # (K + A) u with convection planes from a seeded ae
    ne = int(np.prod(solver.elem_dims))
    ae = rng.standard_normal((27, 27, ne)).astype(np.float32) * 1e-3
    ae_e = pstl.embed_elem_table(ae, solver.elem_dims, solver.coarse_dims, sp)
    ae_t = torch.from_numpy(np.ascontiguousarray(ae_e[list(solver.conv_i_order)])).to(dev)
    planes = pstl.conv_planes_from_ae(ae_t, groups=solver.conv_groups)
    del ae_t
    a_ka = _route_csr([d["Kp"], planes], [solver.k_pairs, solver.conv_pairs2], sp, 8,
                      per_channel=False)
    apply_check("parity_apply_k_plus_a", d["Kp"], u, solver.k_pairs, 3,
                wc2=planes, pairs2=solver.conv_pairs2,
                lib_fn=lambda: torch.sparse.mm(a_ka, ut),
                lib_out=lambda: torch.sparse.mm(a_ka, ut).T.reshape(3, 8, sp))
    del a_ka, planes

    # G^T u (compact divergence)
    gt = d["GT_cwin"]
    y = pstl.parity_div_apply(gt, u, solver.coarse_dims)
    y_plain = pstl.parity_div_apply_plain(gt, u, solver.coarse_dims)
    y_abs = pstl.parity_div_apply_plain(gt.abs(), u.abs(), solver.coarse_dims)
    err, rel = _apply_err(y, y_plain, y_abs)
    if not rel <= APPLY_TOL:
        raise AssertionError(f"div_compact: kernel vs plain {rel:.3e} > {APPLY_TOL}")
    pairs = window_stencil.div_class_pairs(solver.coarse_dims)
    a_d = _div_csr(gt, pairs, sp)
    uf = u.reshape(-1)
    nbytes = 4 * (3 * len(pairs) * sp + u.numel() + sp)
    b_ms, b_by = bound(nbytes, 6 * len(pairs) * sp)
    results["div_compact"] = dict(
        max_abs_err=err, err_rel=rel, tol=APPLY_TOL,
        ms=time_ms(lambda: pstl.parity_div_apply(gt, u, solver.coarse_dims), 20),
        plain_ms=time_ms(lambda: pstl.parity_div_apply_plain(gt, u, solver.coarse_dims), 3),
        library_ms=time_ms(lambda: torch.mv(a_d, uf), 20),
        library_abs_err=float((torch.mv(a_d, uf) - y).abs().max()),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=6 * len(pairs) * sp,
    )
    del a_d

    # pressure CG, cold and warm, on a divergence-shaped right-hand side
    nnp = solver.nnp
    b = y_plain[:nnp].clone()
    if solver.pin_grid >= 0:
        b[solver.pin_grid] = 0.0
    cfg = solver.config
    kw = dict(dims=solver.coarse_dims, radius=solver.z_radius, tol=cfg.pressure_cg_tol,
              maxiter=cfg.pressure_cg_maxiter)
    win, dinv = d["Z_win"], d["Z_dinv"]
    cold = fused_cg_mod.fused_cg(win, b, dinv, **kw)
    x0 = (cold.x * (1 + 1e-3 * rand(nnp))).contiguous()
    for start, xs in (("cold", None), ("warm", x0)):
        sol = fused_cg_mod.fused_cg(win, b, dinv, x0=xs, **kw)
        ref = fused_cg_mod.fused_cg_plain(win, b, dinv, x0=xs, **kw)
        k, k_ref = int(sol.iters), int(ref.iters)
        err = float((sol.x - ref.x).abs().max())
        rel = err / float(ref.x.abs().max())
        true_res = float(torch.linalg.vector_norm(
            b.double() - fused_cg_mod.window_apply_plain(
                win.double(), sol.x.double(),
                window_stencil.window_offsets(solver.coarse_dims, solver.z_radius))
        ) / torch.linalg.vector_norm(b.double()))
        if abs(k - k_ref) > 1 or not rel <= CG_X_TOL or not k > 0:
            raise AssertionError(f"cg_solve {start}: k {k} vs {k_ref}, x err {rel:.3e}")
        if not (float(sol.residual) <= cfg.pressure_cg_tol * float(torch.linalg.vector_norm(b)) * 1.0001
                or k == cfg.pressure_cg_maxiter):
            raise AssertionError(f"cg_solve {start}: stopped unconverged at k={k}")
        ms = time_ms(lambda: fused_cg_mod.fused_cg(win, b, dinv, x0=xs, **kw), 20)
        plain_ms = time_ms(lambda: fused_cg_mod.fused_cg_plain(win, b, dinv, x0=xs, **kw), 2)
        w3 = win.shape[0]
        nbytes = 4 * (w3 * nnp + (3 if xs is None else 4) * nnp) + 4 * w3 + 8
        flops = k * (2 * w3 + 12) * nnp + (2 * w3 * nnp if xs is not None else 0) + 6 * nnp
        b_ms, b_by = bound(nbytes, flops)
        results[f"cg_solve_{start}"] = dict(
            max_abs_err=err, err_rel=rel, tol=CG_X_TOL, iters=k, iters_plain=k_ref,
            true_rel_residual=true_res, ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
        )
    emit(dict(phase="kernels", shapes=dict(sp=sp, nnp=nnp, k_planes=int(d["Kp"].shape[1]),
                                           g_planes=int(d["Gp"].shape[1]),
                                           conv_planes=27 * 27),
              checks=results))
    return results


# ---------------------------------------------------------------- phase 3

def phase_e2e(solver, cuda_lib, n_steps: int, ExplicitBCHSolver, precision_deck: bool) -> dict:
    import numpy as np
    import torch

    state = solver.initial_state()
    warm = min(WARMUP_STEPS, n_steps - 1)
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    state, hist_w = solver.run(state, n_steps=warm)
    torch.cuda.synchronize()
    t1 = time.time()
    state, hist_t = solver.run(state, n_steps=n_steps - warm)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = dict(cuda_lib.launch_counts)
    hist = hist_w + hist_t
    if len(hist) != n_steps:
        raise AssertionError(f"ran {len(hist)} of {n_steps} steps")
    subs = [int(h["iters"]) for h in hist]
    expect = dict(
        parity_apply_k_plus_a=sum(subs), parity_apply_k=sum(s - 1 for s in subs),
        parity_apply_g=sum(s + 1 for s in subs), div_compact=sum(subs), cg_solve=sum(subs),
    )
    if any(v <= 0 for v in counts.values()) or counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    if not (torch.isfinite(state.un).all() and torch.isfinite(state.pn).all()):
        raise AssertionError("non-finite fields")
    h = hist[-1]
    out = dict(
        phase="e2e", steps=n_steps, warmup_steps=warm,
        ms_per_step=(t2 - t1) / (n_steps - warm) * 1e3, warmup_s=t1 - t0,
        sub_iters=int(h["iters"]), cg_iters=int(h["cg_iters"]), u_mon=h["u_mon"],
        sub_iters_hist={str(s): subs.count(s) for s in sorted(set(subs))},
        cg_iters_first_last=[int(hist[0]["cg_iters"]), int(h["cg_iters"])],
        launches=counts, launches_per_step=dict(
            warm_1_sub_iter=dict(parity_apply_k_plus_a=1, parity_apply_k=0,
                                 parity_apply_g=2, div_compact=1, cg_solve=1),
            spin_up_2_sub_iters=dict(parity_apply_k_plus_a=2, parity_apply_k=1,
                                     parity_apply_g=3, div_compact=2, cg_solve=2),
        ),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(out)

    # ---- the kernel path against the plain-version path, 3 steps from this state
    attrs = {k: getattr(solver, k) for k in ExplicitBCHSolver.STATIC_ATTRS}
    plain = ExplicitBCHSolver.from_tables(solver.deck, solver.config, solver.d, attrs,
                                          device=solver.device, plain=True)
    st_k, h_k = solver.run(state, n_steps=3)
    st_p, h_p = plain.run(state, n_steps=3)
    u_k, p_k = solver.fields(st_k)
    u_p, p_p = plain.fields(st_p)
    du, dp = float(np.abs(u_k - u_p).max()), float(np.abs(p_k - p_p).max())
    mon = max(abs(a[f] - b[f]) for a, b in zip(h_k, h_p)
              for f in ("u_mon", "v_mon", "w_mon", "p_mon"))
    subs_k, subs_p = [r["iters"] for r in h_k], [r["iters"] for r in h_p]
    cg_k, cg_p = [r["cg_iters"] for r in h_k], [r["cg_iters"] for r in h_p]
    cmp = dict(phase="kernel_vs_plain_3_steps", du=du, dp=dp, dmon=mon, tols=STEP_TOLS,
               sub_iters=[subs_k, subs_p], cg_iters=[cg_k, cg_p])
    emit(cmp)
    if not (du <= STEP_TOLS["u"] and dp <= STEP_TOLS["p"] and mon <= STEP_TOLS["mon"]
            and subs_k == subs_p and all(abs(a - b) <= 1 for a, b in zip(cg_k, cg_p))):
        raise AssertionError(f"kernel path and plain path disagree: {cmp}")

    # ---- the stored f64 run of the same deck (100 steps from rest)
    if precision_deck and n_steps >= 100:
        ref = np.load(REPO / "cfd_with_cuda_tpu" / "validation" / "data" / "precision_ne27000.npz")
        u_mon = np.asarray([r["u_mon"] for r in hist[:100]])
        du_mon = float(np.max(np.abs(u_mon - ref["f64_u_mon"])))
        u_now, _ = solver.fields(state)           # the state after n_steps
        scale = float(np.abs(ref["f64_u"]).max())
        dfield = float(np.max(np.abs(u_now - ref["f64_u"]))) / scale if n_steps == 100 else None
        prec = dict(phase="precision_vs_stored_f64", du_mon=du_mon, du_mon_bound=1e-5,
                    dfield=dfield, dfield_bound=1e-2)
        emit(prec)
        if not du_mon < 1e-5 or (dfield is not None and not dfield < 1e-2):
            raise AssertionError(f"f32 port vs stored f64 run: {prec}")
    return out


# ---------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck-n", type=int, default=30, help="cavity elements per edge (30: NE27000)")
    ap.add_argument("--steps", type=int, default=100, help="e2e steps (warm-up included)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from cfd_with_cuda_tpu_torch.mesh.generators import cavity_deck
    from cfd_with_cuda_tpu_torch.ops import cuda_lib, fused_cg, parity_stencil, window_stencil
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver
    from cfd_with_cuda_tpu_torch.utils.config import DTypePolicy, SolverConfig

    phase_toolchain(cuda_lib)

    t0 = time.time()
    deck = cavity_deck(args.deck_n, cluster=2.0, viscosity=0.01, dt=0.001)
    cfg = SolverConfig(dtype_policy=DTypePolicy.F32, pressure_cg_tol=1e-6,
                       pressure_warm_start=True, pressure_cg_fuse_loop=True,
                       steps_per_chunk=25)
    solver = ExplicitBCHSolver(deck, cfg)
    emit(dict(phase="setup", deck=f"cavity_deck({args.deck_n}, cluster=2.0)",
              nn=solver.nn, nnp=solver.nnp, sp=solver.sp_c, setup_s=time.time() - t0))

    checks = phase_kernels(solver, parity_stencil, cuda_lib, fused_cg, window_stencil)
    e2e = phase_e2e(solver, cuda_lib, args.steps, ExplicitBCHSolver,
                    precision_deck=args.deck_n == 30)

    csrc = "cfd_with_cuda_tpu_torch/csrc/"
    rows = [
        ("parity_apply_k", "parity_apply_k", "parity_apply.cu",
         "cfd_with_cuda_tpu/ops/parity_stencil.py:432"),
        ("parity_apply_g", "parity_apply_g", "parity_apply.cu",
         "cfd_with_cuda_tpu/ops/parity_stencil.py:432"),
        ("parity_apply_k_plus_a", "parity_apply_k_plus_a", "parity_apply.cu",
         "cfd_with_cuda_tpu/ops/parity_stencil.py:406"),
        ("div_compact", "div_compact", "div_compact.cu",
         "cfd_with_cuda_tpu/ops/pallas_stencil.py:307"),
        ("cg_solve", "cg_solve_warm", "cg_solve.cu", "cfd_with_cuda_tpu/ops/pallas_cg.py:549"),
    ]
    kernels = []
    for name, check, src, replaces in rows:
        c = checks[check]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + src, replaces=replaces,
            launches=e2e["launches"][name], max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
        ))
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
