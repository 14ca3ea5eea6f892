// cg_solve: the whole Jacobi-preconditioned CG solve of Z x = b in ONE launch.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_cg.py::
// _cg_solve_kernel (pallas_call at :549, fused_cg(fuse_loop=True)), with
// _apply_window in its full and symmetric modes (:230) and _plain_dot (:226)
// or _comp_dot (:194); the apply, the reductions and the iteration are in
// cg_common.cuh.
//
//   warm: r0 = b - Z x0, x = x0;  cold: r0 = b, x = 0
//   z0 = r0 * dinv, p = z0, rz = r0.z0, rn = |r0|, bound = max(tol |b|, 0)
//   while k < maxiter and rn > bound:
//     ap = Z p;  alpha = rz / (p.ap);  x += alpha p;  r -= alpha ap
//     z = r * dinv;  rz' = r.z;  beta = rz' / rz;  p = z + beta p
//     k += 1;  rz = rz';  rn = |r|
//
// alpha and beta go through safe_div (0 when |den| <= 1e-35, :136-138), and
// a NaN residual ends the loop (the comparison is false), as on the TPU.
//
// What bounds it (H100 80GB HBM3, 700 W; python -m
// cfd_with_cuda_tpu_torch.compare_build, PERF.md section 6): an iteration is
// the apply plus a fixed part.  The fixed part (the window cut to its centre
// slot) is 5-6 us at 117 blocks (NE27000) and 8-9 us at 356 (NE85184): two
// grid barriers (1.2 us each at 117 blocks, 1.5 at 356), the two reductions
// (1.0-1.1 us, 2.4) and the vector phase's L2 round trips.  The apply reads the
// (nw, n) window: from L2 on the box windows (125 x 29,791 f32 = 14.9 MB,
// 6-8 us with one block an SM), from HBM on the BFS band (162 MB: 49.7 us at
// 3.35 TB/s; ~73 us).  The per-iteration build spent 27.5 of its 35.6 us
// there (NE27000, 125 slots): one thread a row walked the slots as a chain
// of dependent loads, and a third barrier ordered the new p.  Design: the
// iteration of cg_common.cuh (offsets, weight ring and p's clusters in
// shared memory; p formed while staged, two barriers an iteration) in one
// cooperative launch, grid = min(co-resident blocks, ceil(n / 256)), each
// thread owning rows i in a grid-stride loop.  Every block holds bitwise the
// same alpha, beta, |r| and loop decision.  k and |r| are written once,
// after the loop.

#include "cg_common.cuh"

namespace {

using namespace cgk;

template <bool COMP, bool SYM, int FORM>
__global__ void __launch_bounds__(kThreads, FORM == kStaged3 ? 3 : 5)
    cg_solve_kernel(const __grid_constant__ CgArgs a) {
  __shared__ typename Acc<COMP>::type red[3 * kThreads];
  __shared__ float bcast[3];
  Engine<COMP, SYM> eng(a, red, bcast);
  eng.prefetch();
  float tot[3];
  eng.start(true, tot);
  float rz = tot[0];
  float rn = sqrtf(tot[1]);
  const float bnd = a.tol * sqrtf(tot[2]);
  const float bound = bnd < 0.0f ? 0.0f : bnd;  // max(., 0) keeping NaN, as jnp.maximum
  float beta = 0.0f;
  int k = 0;
  while (k < a.maxiter && rn > bound) {
    eng.iteration(k, true, rz, beta, rn);
    ++k;
  }
  __pipeline_wait_prior(0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = k;
    *a.rn_out = rn;
  }
}

using Kernel = void (*)(CgArgs);

template <bool COMP, bool SYM>
KernelSet<Kernel> forms() {
  return {{cg_solve_kernel<COMP, SYM, kStaged5>, cg_solve_kernel<COMP, SYM, kStaged3>}};
}

KernelSet<Kernel> pick(int comp, int sym) {
  if (comp) return sym ? forms<true, true>() : forms<true, false>();
  return sym ? forms<false, true>() : forms<false, false>();
}

}  // namespace

extern "C" int cg_solve_max_blocks() { return kMaxBlocks; }
extern "C" int cg_work_rows() { return kWorkRows; }

// `work` holds cg_work_rows() rows of stride ld >= n (r, z, ap, p0, p1);
// `part` 6 * cg_solve_max_blocks() partials: f32 when comp == 0, f64 when
// comp != 0.  sym != 0: `win`/`offs` are the dq >= 0 half.  stab: the
// window's stage table (ops/fused_cg.py::stage_table; required), stab_ints
// its length, svecs the float4s it stages a block.  Returns
// cudaErrorInvalidConfiguration where the staged clusters fit no block.
extern "C" int cg_solve_f32(const float* win, const int* offs, int nw, const float* b,
                            const float* dinv, const float* x0, float* x, float* work, int ld,
                            void* part, int* k_out, float* rn_out, int n, int maxiter,
                            double tol, int comp, int sym, const int* stab, int stab_ints,
                            int svecs, void* stream) {
  CgArgs a{};
  a.win = win;
  a.offs = offs;
  a.stab = stab;
  a.b = b;
  a.dinv = dinv;
  a.x0 = x0;
  a.x = x;
  a.work = work;
  a.part = part;
  a.k_out = k_out;
  a.rn_out = rn_out;
  a.nw = nw;
  a.n = n;
  a.ld = ld;
  a.maxiter = maxiter;
  a.stab_ints = stab_ints;
  a.svecs = svecs;
  a.tol = static_cast<float>(tol);
  return cg_launch(pick(comp, sym), a, stream);
}

// out[0] = the block count, out[1] = the form (0: built for 5 blocks an SM,
// 1: for 3), out[2] = the ring depth
extern "C" int cg_solve_plan(int n, int nw, int stab_ints, int svecs, int comp, int sym,
                             int* out) {
  return report_plan(pick(comp, sym), n, nw, stab_ints, svecs, out);
}
