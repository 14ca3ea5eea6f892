// cg_solve: the whole Jacobi-preconditioned CG solve of Z x = b in ONE launch.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_cg.py::
// _cg_solve_kernel (pallas_call at :549, fused_cg(fuse_loop=True)), with
// _apply_window in its full and symmetric modes (:230) and _plain_dot (:226)
// or _comp_dot (:194); the apply and the reductions are in cg_common.cuh.
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
// What bounds it: each iteration reads the (nw, n) window (NE27000 f32:
// 125 x 29791 = 14.9 MB, 63 planes = 7.5 MB in the symmetric mode, which
// the 50 MB L2 holds across iterations) and does two grid-wide reductions;
// at that size the solve is latency-bound by the three grid-wide barriers
// per iteration, not by bytes.  Design: a cooperative persistent kernel,
// grid = min(co-resident blocks, ceil(n / 256)), each thread owning rows i
// in a grid-stride loop.  grid.sync() separates the Z p apply, the two
// reduction phases and the p update.  Every block holds bitwise the same
// alpha, beta, |r| and loop decision (cg_common.cuh).  k and |r| are written
// to device memory once, after the loop; the host reads them after the
// solve.

#include "cg_common.cuh"

namespace {

using namespace cgk;

template <bool COMP, bool SYM>
__global__ void __launch_bounds__(kThreads) cg_solve_kernel(
    const float* __restrict__ win, const int* __restrict__ offs, int nw,
    const float* __restrict__ b, const float* __restrict__ dinv,
    const float* __restrict__ x0, float* x, float* r, float* p, float* q,
    typename Acc<COMP>::type* part, int* k_out, float* rn_out, int n,
    int maxiter, float tol) {
  using A = typename Acc<COMP>::type;
  cg::grid_group grid = cg::this_grid();
  __shared__ A smem[3 * kThreads];
  __shared__ float bcast[3];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // partial slots: [0, nb) p.ap, [nb, 3nb) r.z and r.r, [3nb, 6nb) init
  A* part_pap = part;
  A* part_rz = part + nb;
  A* part_init = part + 3 * nb;

  {  // ---- init
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
    block_partials<A, 3>(v, smem, part_init + blockIdx.x, nb);
  }
  grid.sync();
  float tot[3];
  grid_totals<A, 3>(part_init, nb, bcast, tot);
  float rz = tot[0];
  float rn = sqrtf(tot[1]);
  const float bnd = tol * sqrtf(tot[2]);
  const float bound = bnd < 0.0f ? 0.0f : bnd;  // max(., 0) keeping NaN, as jnp.maximum

  int k = 0;
  while (k < maxiter && rn > bound) {
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
    for (int i = first; i < n; i += stride) p[i] = __ldcg(q + i) + beta * __ldcg(p + i);
    ++k;
    rz = rr[0];
    rn = sqrtf(rr[1]);
    grid.sync();  // p complete before the next apply reads its neighbours
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *k_out = k;
    *rn_out = rn;
  }
}

template <bool COMP, bool SYM>
int launch(const float* win, const int* offs, int nw, const float* b,
           const float* dinv, const float* x0, float* x, float* r, float* p,
           float* q, void* part_v, int* k_out, float* rn_out, int n,
           int maxiter, double tol, void* stream) {
  static int resident[kMaxDev] = {0};
  auto* part = static_cast<typename Acc<COMP>::type*>(part_v);
  float tol_f = static_cast<float>(tol);
  void* args[] = {&win, &offs, &nw, &b, &dinv, &x0, &x, &r, &p, &q, &part,
                  &k_out, &rn_out, &n, &maxiter, &tol_f};
  return coop_launch(cg_solve_kernel<COMP, SYM>, resident, n, args, stream);
}

}  // namespace

extern "C" int cg_solve_max_blocks() { return kMaxBlocks; }

// `part` holds 6 * cg_solve_max_blocks() partials: f32 when comp == 0, f64
// when comp != 0.  sym != 0: `win`/`offs` are the dq >= 0 half.
extern "C" int cg_solve_f32(const float* win, const int* offs, int nw,
                            const float* b, const float* dinv, const float* x0,
                            float* x, float* r, float* p, float* q, void* part,
                            int* k_out, float* rn_out, int n, int maxiter,
                            double tol, int comp, int sym, void* stream) {
#define CG_SOLVE_GO(C, S) \
  return launch<C, S>(win, offs, nw, b, dinv, x0, x, r, p, q, part, k_out, \
                      rn_out, n, maxiter, tol, stream)
  if (comp) {
    if (sym) CG_SOLVE_GO(true, true);
    CG_SOLVE_GO(true, false);
  }
  if (sym) CG_SOLVE_GO(false, true);
  CG_SOLVE_GO(false, false);
#undef CG_SOLVE_GO
}
