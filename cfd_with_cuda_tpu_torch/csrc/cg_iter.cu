// cg_init + cg_iter: the Jacobi-preconditioned CG of Z x = b with ONE launch
// for the initialisation and ONE launch per group of `iters` iterations; the
// loop and its convergence test run on the host between groups.
//
// Replaces the TPU kernels cfd_with_cuda_tpu/ops/pallas_cg.py::
// _cg_init_kernel (:402, pallas_call at :607) and _cg_iter_kernel (:287,
// pallas_call at :577) — fused_cg's default path (fuse_loop=False) — with
// _apply_window in its full and symmetric modes and _plain_dot or _comp_dot
// (cg_common.cuh).
//
//   cg_init:  warm: r = b - Z x0, x = x0;  cold: r = b, x = 0
//             z = r * dinv, p = z;  scal = (r.z, |r|, |b|)
//   cg_iter:  rz = scal[0]; `iters` times:
//             ap = Z p;  alpha = rz / (p.ap);  x += alpha p;  r -= alpha ap
//             z = r * dinv;  rz' = r.z;  beta = rz' / rz;  p = z + beta p;  rz = rz'
//             scal[0] = rz, scal[1] = |r|
//
// One cg_iter launch is one trip of the JAX loop (lax.while_loop over groups
// of `unroll` iterations, convergence looked at between trips,
// pallas_cg.py:641-654), so the host reads |r| once per launch.  alpha and
// beta go through safe_div (0 when |den| <= 1e-35, :136-138).  Unlike the
// functional TPU kernels (x, r, p_ext in -> out) the vectors are updated in
// place: x, the work rows and the three scalars stay on the device between
// launches.  There are no DMA blocks, no 128-lane padding and no halo copy.
//
// What bounds it (H100 80GB HBM3, 700 W; python -m
// cfd_with_cuda_tpu_torch.compare_build, PERF.md section 6): per iteration,
// the fixed part of cg_solve.cu's note (5-6 us at 117 blocks) and the apply
// (27 slots: 3.2 MB at NE27000, in L2, ~1 us); per launch, the cooperative
// launch and the host's read of |r|.  The per-iteration build paid a launch
// and a ctypes call an iteration (the loop read 17-20 us an iteration on
// the host clock at 27 slots against 11.4 us of kernel).  Design: the
// iteration of cg_common.cuh and one launch per group of `iters`; p_{k+1} =
// z + beta p_k is formed into p0 at the end of a launch, the state the next
// launch starts from.  scal[0] is read by every block before the first
// barrier and written by block 0 after the last, so no block can see the
// new value early.

#include "cg_common.cuh"

namespace {

using namespace cgk;

template <bool COMP, bool SYM, int FORM>
__global__ void __launch_bounds__(kThreads, FORM == kStaged3 ? 3 : 5)
    cg_init_kernel(const __grid_constant__ CgArgs a) {
  __shared__ typename Acc<COMP>::type red[3 * kThreads];
  __shared__ float bcast[3];
  Engine<COMP, SYM> eng(a, red, bcast);
  if (a.x0 != nullptr) eng.prefetch();
  float tot[3];
  eng.start(false, tot);
  __pipeline_wait_prior(0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scal[0] = tot[0];
    a.scal[1] = sqrtf(tot[1]);
    a.scal[2] = sqrtf(tot[2]);
  }
}

template <bool COMP, bool SYM, int FORM>
__global__ void __launch_bounds__(kThreads, FORM == kStaged3 ? 3 : 5)
    cg_iter_kernel(const __grid_constant__ CgArgs a) {
  __shared__ typename Acc<COMP>::type red[2 * kThreads];
  __shared__ float bcast[2];
  Engine<COMP, SYM> eng(a, red, bcast);
  eng.prefetch();
  float rz = __ldcg(a.scal);
  float beta = 0.0f, rn = 0.0f;
  for (int j = 0; j < a.iters; ++j) eng.iteration(j, j + 1 < a.iters, rz, beta, rn);
  eng.finish_direction(a.iters - 1, beta);
  __pipeline_wait_prior(0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scal[0] = rz;
    a.scal[1] = rn;
  }
}

// the dot of two f32 vectors: f64 accumulation, rounded to f32 once
__global__ void __launch_bounds__(kThreads) comp_dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, double* part,
    float* out, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[kThreads];
  __shared__ float bcast[1];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  double v[1] = {0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    v[0] = dot_fma(a[i], b[i], v[0]);
  block_partials<double, 1>(v, red, part + blockIdx.x, nb);
  grid.sync();
  if (blockIdx.x == 0) {
    float tot[1];
    grid_totals<double, 1>(part, nb, bcast, tot);
    if (threadIdx.x == 0) *out = tot[0];
  }
}

// y = Z v from the symmetric half window alone (the apply of the CG kernels'
// sym mode, v read directly; exported so it can be held against the full
// window)
__global__ void __launch_bounds__(kThreads) window_apply_sym_kernel(
    const float* __restrict__ win, const int* __restrict__ offs, int nw,
    const float* __restrict__ v, float* __restrict__ y, int n) {
  const Window<true> zw(win, nw, n, 0, offs_at(0, 0));
  int* so = reinterpret_cast<int*>(cg_dsm);
  for (int j = threadIdx.x; j < nw; j += kThreads) so[j] = offs[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = zw.apply_direct(i, v);
}

using Kernel = void (*)(CgArgs);

template <bool COMP, bool SYM>
KernelSet<Kernel> init_forms() {
  return {{cg_init_kernel<COMP, SYM, kStaged5>, cg_init_kernel<COMP, SYM, kStaged3>}};
}

template <bool COMP, bool SYM>
KernelSet<Kernel> iter_forms() {
  return {{cg_iter_kernel<COMP, SYM, kStaged5>, cg_iter_kernel<COMP, SYM, kStaged3>}};
}

KernelSet<Kernel> pick_init(int comp, int sym) {
  if (comp) return sym ? init_forms<true, true>() : init_forms<true, false>();
  return sym ? init_forms<false, true>() : init_forms<false, false>();
}

KernelSet<Kernel> pick_iter(int comp, int sym) {
  if (comp) return sym ? iter_forms<true, true>() : iter_forms<true, false>();
  return sym ? iter_forms<false, true>() : iter_forms<false, false>();
}

CgArgs args(const float* win, const int* offs, int nw, const float* dinv, float* x,
            float* work, int ld, void* part, float* scal, int n, const int* stab, int stab_ints,
            int svecs) {
  CgArgs a{};
  a.win = win;
  a.offs = offs;
  a.stab = stab;
  a.dinv = dinv;
  a.x = x;
  a.work = work;
  a.part = part;
  a.scal = scal;
  a.nw = nw;
  a.n = n;
  a.ld = ld;
  a.stab_ints = stab_ints;
  a.svecs = svecs;
  return a;
}

}  // namespace

extern "C" int cg_iter_max_blocks() { return kMaxBlocks; }
extern "C" int cg_work_rows() { return kWorkRows; }

// `work` holds cg_work_rows() rows of stride ld >= n (r, z, ap, p0, p1),
// `part` 6 * cg_iter_max_blocks() partials (f32 when comp == 0, f64 when
// comp != 0), `scal` 3 floats: r.z, |r|, |b|.  sym != 0: `win`/`offs` are the
// dq >= 0 half.  x0 may be null (cold start).  stab: the window's stage table
// (ops/fused_cg.py::stage_table; required), stab_ints its length, svecs the
// float4s it stages a block.  Returns cudaErrorInvalidConfiguration where
// the staged clusters fit no block.
extern "C" int cg_init_f32(const float* win, const int* offs, int nw, const float* b,
                           const float* dinv, const float* x0, float* x, float* work, int ld,
                           void* part, float* scal, int n, int comp, int sym, const int* stab,
                           int stab_ints, int svecs, void* stream) {
  CgArgs a = args(win, offs, nw, dinv, x, work, ld, part, scal, n, stab, stab_ints, svecs);
  a.b = b;
  a.x0 = x0;
  return cg_launch(pick_init(comp, sym), a, stream);
}

// `iters` >= 1 CG iterations in place on x, the work rows and scal[0:2].
extern "C" int cg_iter_f32(const float* win, const int* offs, int nw, const float* dinv,
                           float* x, float* work, int ld, void* part, float* scal, int n,
                           int iters, int comp, int sym, const int* stab, int stab_ints,
                           int svecs, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  CgArgs a = args(win, offs, nw, dinv, x, work, ld, part, scal, n, stab, stab_ints, svecs);
  a.iters = iters;
  return cg_launch(pick_iter(comp, sym), a, stream);
}

// out[0] = the block count, out[1] = the form (0: built for 5 blocks an SM,
// 1: for 3), out[2] = the ring depth (cg_init's plan is the same but for its own
// kernels' occupancy)
extern "C" int cg_iter_plan(int n, int nw, int stab_ints, int svecs, int comp, int sym,
                            int* out) {
  return report_plan(pick_iter(comp, sym), n, nw, stab_ints, svecs, out);
}

// out = f32(sum_i f64(a[i]) * f64(b[i])); `part` holds cg_iter_max_blocks()
// doubles.
extern "C" int comp_dot_f32(const float* a, const float* b, double* part,
                            float* out, int n, void* stream) {
  void* kargs[] = {&a, &b, &part, &out, &n};
  return plain_coop_launch(comp_dot_kernel, n, 0, kargs, stream);
}

// y[i] = sum_{m>=0} win[m, i] v[i + offs[m]] + sum_{m>0} win[m, i - offs[m]]
// v[i - offs[m]]: `win` (nw, n) and `offs` are the dq >= 0 half.
extern "C" int window_apply_sym_f32(const float* win, const int* offs, int nw,
                                    const float* v, float* y, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  window_apply_sym_kernel<<<blocks, kThreads, smem_bytes(0, nw, 0, 0),
                            static_cast<cudaStream_t>(stream)>>>(win, offs, nw, v, y, n);
  return static_cast<int>(cudaGetLastError());
}
