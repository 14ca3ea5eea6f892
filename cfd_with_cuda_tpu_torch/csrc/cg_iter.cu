// cg_init + cg_iter: the Jacobi-preconditioned CG of Z x = b with ONE launch
// for the initialisation and ONE launch per iteration; the loop and its
// convergence test run on the host between groups of iterations.
//
// Replaces the TPU kernels cfd_with_cuda_tpu/ops/pallas_cg.py::
// _cg_init_kernel (:402, pallas_call at :607) and _cg_iter_kernel (:287,
// pallas_call at :577) — fused_cg's default path (fuse_loop=False) — with
// _apply_window in its full and symmetric modes and _plain_dot or _comp_dot
// (cg_common.cuh).
//
//   cg_init:  warm: r = b - Z x0, x = x0;  cold: r = b, x = 0
//             z = r * dinv, p = z;  scal = (r.z, |r|, |b|)
//   cg_iter:  rz = scal[0]
//             ap = Z p;  alpha = rz / (p.ap);  x += alpha p;  r -= alpha ap
//             z = r * dinv;  rz' = r.z;  beta = rz' / rz;  p = z + beta p
//             scal[0] = rz', scal[1] = |r|
//
// alpha and beta go through safe_div (0 when |den| <= 1e-35, :136-138).
// Unlike the functional TPU kernels (x, r, p_ext in -> out) the vectors are
// updated in place: x, r, p and the three scalars stay on the device between
// launches, and the host reads |r| (one scalar) once per group of `unroll`
// iterations.  There are no DMA blocks, no 128-lane padding and no halo copy
// of p.
//
// What bounds it: one iteration reads the (nw, n) window once (NE27000 f32:
// 14.9 MB full, 7.5 MB symmetric half; it stays in the 50 MB L2 between
// iterations) and the vectors a few times; the two reductions each gate the
// next phase (p.ap before x/r; r.z before p).  Design: one cooperative launch
// per iteration with two grid.sync() inside (cg_solve.cu's loop body), so an
// iteration pays one launch plus two grid barriers; at this size it is bound
// by that latency, not by bytes.  The banded window of the NE144600-class
// backward-facing step (275 slots x 147,477 rows, 162 MB) does not fit L2:
// there an iteration streams the window from HBM and bytes set its pace
// (bound 49.7 us at 3.35 TB/s).  scal[0] is read by every block before the
// first barrier and written by block 0 after the second, so no block can see
// the new value early.

#include "cg_common.cuh"

namespace {

using namespace cgk;

template <bool COMP, bool SYM>
__global__ void __launch_bounds__(kThreads) cg_init_kernel(
    const float* __restrict__ win, const int* __restrict__ offs, int nw,
    const float* __restrict__ b, const float* __restrict__ dinv,
    const float* __restrict__ x0, float* x, float* r, float* p,
    typename Acc<COMP>::type* part, float* scal, int n) {
  using A = typename Acc<COMP>::type;
  cg::grid_group grid = cg::this_grid();
  __shared__ A smem[3 * kThreads];
  __shared__ float bcast[3];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  A v[3] = {A(0), A(0), A(0)};  // r.z, r.r, b.b
  for (int i = first; i < n; i += stride) {
    const float bi = b[i];
    float ri;
    if (x0 != nullptr) {
      ri = bi - apply_row<SYM>(win, offs, nw, x0, i, n);
      x[i] = x0[i];
    } else {
      ri = bi;
      x[i] = 0.0f;
    }
    const float zi = ri * dinv[i];
    r[i] = ri;
    p[i] = zi;
    v[0] += prod<A>(ri, zi);
    v[1] += prod<A>(ri, ri);
    v[2] += prod<A>(bi, bi);
  }
  block_partials<A, 3>(v, smem, part + blockIdx.x, nb);
  grid.sync();
  if (blockIdx.x == 0) {
    float tot[3];
    grid_totals<A, 3>(part, nb, bcast, tot);
    if (threadIdx.x == 0) {
      scal[0] = tot[0];
      scal[1] = sqrtf(tot[1]);
      scal[2] = sqrtf(tot[2]);
    }
  }
}

template <bool COMP, bool SYM>
__global__ void __launch_bounds__(kThreads) cg_iter_kernel(
    const float* __restrict__ win, const int* __restrict__ offs, int nw,
    const float* __restrict__ dinv, float* x, float* r, float* p, float* q,
    typename Acc<COMP>::type* part, float* scal, int n) {
  using A = typename Acc<COMP>::type;
  cg::grid_group grid = cg::this_grid();
  __shared__ A smem[2 * kThreads];
  __shared__ float bcast[2];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // partial slots: [0, nb) p.ap, [nb, 3nb) r.z and r.r
  A* part_pap = part;
  A* part_rz = part + nb;
  const float rz = __ldcg(scal);

  {  // ---- ap = Z p, p.ap
    A v[1] = {A(0)};
    for (int i = first; i < n; i += stride) {
      const float api = apply_row<SYM>(win, offs, nw, p, i, n);
      q[i] = api;
      v[0] += prod<A>(__ldcg(p + i), api);
    }
    block_partials<A, 1>(v, smem, part_pap + blockIdx.x, nb);
  }
  grid.sync();
  float pap[1];
  grid_totals<A, 1>(part_pap, nb, bcast, pap);
  const float alpha = safe_div(rz, pap[0]);
  {  // ---- x, r, z = r * dinv (kept in q), r.z, r.r
    A v[2] = {A(0), A(0)};
    for (int i = first; i < n; i += stride) {
      const float pi = __ldcg(p + i);
      x[i] = __ldcg(x + i) + alpha * pi;
      const float ri = __ldcg(r + i) - alpha * __ldcg(q + i);
      r[i] = ri;
      const float zi = ri * dinv[i];
      q[i] = zi;
      v[0] += prod<A>(ri, zi);
      v[1] += prod<A>(ri, ri);
    }
    block_partials<A, 2>(v, smem, part_rz + blockIdx.x, nb);
  }
  grid.sync();
  float rr[2];
  grid_totals<A, 2>(part_rz, nb, bcast, rr);
  const float beta = safe_div(rr[0], rz);
  // each thread updates only its own rows of p, and every neighbour read of
  // p (the apply) lies before the first barrier
  for (int i = first; i < n; i += stride) p[i] = __ldcg(q + i) + beta * __ldcg(p + i);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[0] = rr[0];
    scal[1] = sqrtf(rr[1]);
  }
}

// the dot of two f32 vectors: f64 accumulation, rounded to f32 once
__global__ void __launch_bounds__(kThreads) comp_dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, double* part,
    float* out, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double smem[kThreads];
  __shared__ float bcast[1];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  double v[1] = {0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    v[0] += prod<double>(a[i], b[i]);
  block_partials<double, 1>(v, smem, part + blockIdx.x, nb);
  grid.sync();
  if (blockIdx.x == 0) {
    float tot[1];
    grid_totals<double, 1>(part, nb, bcast, tot);
    if (threadIdx.x == 0) *out = tot[0];
  }
}

// y = Z v from the symmetric half window alone (the apply of the three CG
// kernels' sym mode, exported so it can be held against the full window)
__global__ void __launch_bounds__(kThreads) window_apply_sym_kernel(
    const float* __restrict__ win, const int* __restrict__ offs, int nw,
    const float* __restrict__ v, float* __restrict__ y, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = apply_row<true>(win, offs, nw, v, i, n);
}

template <bool COMP, bool SYM>
int launch_init(const float* win, const int* offs, int nw, const float* b,
                const float* dinv, const float* x0, float* x, float* r,
                float* p, void* part_v, float* scal, int n, void* stream) {
  static int resident[kMaxDev] = {0};
  auto* part = static_cast<typename Acc<COMP>::type*>(part_v);
  void* args[] = {&win, &offs, &nw, &b, &dinv, &x0, &x, &r, &p, &part, &scal, &n};
  return coop_launch(cg_init_kernel<COMP, SYM>, resident, n, args, stream);
}

template <bool COMP, bool SYM>
int launch_iter(const float* win, const int* offs, int nw, const float* dinv,
                float* x, float* r, float* p, float* q, void* part_v,
                float* scal, int n, void* stream) {
  static int resident[kMaxDev] = {0};
  auto* part = static_cast<typename Acc<COMP>::type*>(part_v);
  void* args[] = {&win, &offs, &nw, &dinv, &x, &r, &p, &q, &part, &scal, &n};
  return coop_launch(cg_iter_kernel<COMP, SYM>, resident, n, args, stream);
}

}  // namespace

extern "C" int cg_iter_max_blocks() { return kMaxBlocks; }

// `part` holds 3 * cg_iter_max_blocks() partials (f32 when comp == 0, f64
// when comp != 0), `scal` 3 floats: r.z, |r|, |b|.  sym != 0: `win`/`offs` are
// the dq >= 0 half.  x0 may be null (cold start).
extern "C" int cg_init_f32(const float* win, const int* offs, int nw,
                           const float* b, const float* dinv, const float* x0,
                           float* x, float* r, float* p, void* part,
                           float* scal, int n, int comp, int sym, void* stream) {
#define CG_INIT_GO(C, S) \
  return launch_init<C, S>(win, offs, nw, b, dinv, x0, x, r, p, part, scal, n, stream)
  if (comp) {
    if (sym) CG_INIT_GO(true, true);
    CG_INIT_GO(true, false);
  }
  if (sym) CG_INIT_GO(false, true);
  CG_INIT_GO(false, false);
#undef CG_INIT_GO
}

// One CG iteration in place on x, r, p (q is scratch) and scal[0:2].
extern "C" int cg_iter_f32(const float* win, const int* offs, int nw,
                           const float* dinv, float* x, float* r, float* p,
                           float* q, void* part, float* scal, int n, int comp,
                           int sym, void* stream) {
#define CG_ITER_GO(C, S) \
  return launch_iter<C, S>(win, offs, nw, dinv, x, r, p, q, part, scal, n, stream)
  if (comp) {
    if (sym) CG_ITER_GO(true, true);
    CG_ITER_GO(true, false);
  }
  if (sym) CG_ITER_GO(false, true);
  CG_ITER_GO(false, false);
#undef CG_ITER_GO
}

// out = f32(sum_i f64(a[i]) * f64(b[i])); `part` holds cg_iter_max_blocks()
// doubles.
extern "C" int comp_dot_f32(const float* a, const float* b, double* part,
                            float* out, int n, void* stream) {
  static int resident[kMaxDev] = {0};
  void* args[] = {&a, &b, &part, &out, &n};
  return coop_launch(comp_dot_kernel, resident, n, args, stream);
}

// y[i] = sum_{m>=0} win[m, i] v[i + offs[m]] + sum_{m>0} win[m, i - offs[m]]
// v[i - offs[m]]: `win` (nw, n) and `offs` are the dq >= 0 half.
extern "C" int window_apply_sym_f32(const float* win, const int* offs, int nw,
                                    const float* v, float* y, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  window_apply_sym_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      win, offs, nw, v, y, n);
  return static_cast<int>(cudaGetLastError());
}
