// cg_solve: the whole Jacobi-preconditioned CG solve of Z x = b in ONE launch.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_cg.py::
// _cg_solve_kernel (pallas_call at :549, fused_cg(fuse_loop=True)), with
// _apply_window in full mode (:230) and _plain_dot (:226).
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
// Z is a window operator: (Z v)[i] = sum_w win[w, i] * v[i + offs[w]], v
// read as zero outside [0, n), slots summed in order.
//
// What bounds it: each iteration reads the (nw, n) window (NE27000 f32:
// 125 x 29791 = 14.9 MB, which the 50 MB L2 holds across iterations) and
// does two grid-wide reductions; at that size the solve is latency-bound
// by the three grid-wide barriers per iteration, not by bytes.  Design: a
// cooperative persistent kernel (cudaLaunchCooperativeKernel), grid =
// min(co-resident blocks, ceil(n / 256)), each thread owning rows i in a
// grid-stride loop.  grid.sync() separates the Z p apply, the two
// reduction phases and the p update.  Reductions are deterministic: each
// block reduces its rows in a fixed tree, writes its partial to a fixed
// slot, and after the barrier EVERY block sums all partials in the same
// order, so alpha, beta, |r| and the loop decision are bitwise equal on all
// blocks and in every run.  k and |r| are written to device memory once,
// after the loop; the host reads them after the solve.  The mutable vectors
// are read with __ldcg (through L2, not the incoherent L1) because other
// blocks write them between barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;   // the wrapper allocates 6 * kMaxBlocks partials

template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  return fabs(b) > T(1e-35) ? a / b : T(0);
}

// (Z v)[i]; `v` is read through L2 because other blocks write it.
template <typename T>
__device__ __forceinline__ T apply_row(const T* __restrict__ win,
                                       const int* __restrict__ offs, int nw,
                                       const T* v, int i, int n) {
  T acc = T(0);
  for (int w = 0; w < nw; ++w) {
    const int c = i + offs[w];
    const T vv = (c >= 0 && c < n) ? __ldcg(v + c) : T(0);
    acc += win[static_cast<size_t>(w) * n + i] * vv;
  }
  return acc;
}

// Sum NV per-thread values over the block in a fixed tree; thread 0 writes
// value k to out[k * stride].
template <typename T, int NV>
__device__ __forceinline__ void block_partials(const T (&v)[NV], T* smem,
                                               T* out, int stride) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NV; ++k) smem[k * kThreads + t] = v[k];
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < NV; ++k) smem[k * kThreads + t] += smem[k * kThreads + t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) out[k * stride] = smem[k * kThreads];
  }
  __syncthreads();
}

// Every block: total of NV partial arrays (nb entries each, stride nb), in
// a fixed order (lane-strided sums, then a fixed shuffle tree).  Result
// broadcast to all threads through shared memory.
template <typename T, int NV>
__device__ __forceinline__ void grid_totals(const T* part, int nb, T* bcast,
                                            T (&res)[NV]) {
  const int t = threadIdx.x;
  if (t < 32) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      T s = T(0);
      for (int b = t; b < nb; b += 32) s += __ldcg(part + k * nb + b);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (t == 0) bcast[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) res[k] = bcast[k];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_solve_kernel(
    const T* __restrict__ win, const int* __restrict__ offs, int nw,
    const T* __restrict__ b, const T* __restrict__ dinv,
    const T* __restrict__ x0, T* x, T* r, T* p, T* q, T* part,
    int* k_out, T* rn_out, int n, int maxiter, T tol) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T smem[3 * kThreads];
  __shared__ T bcast[3];
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // partial slots: [0, nb) p.ap, [nb, 3nb) r.z and r.r, [3nb, 6nb) init
  T* part_pap = part;
  T* part_rz = part + nb;
  T* part_init = part + 3 * nb;

  {  // ---- init
    T v[3] = {T(0), T(0), T(0)};  // r.z, r.r, b.b
    for (int i = first; i < n; i += stride) {
      const T bi = b[i];
      T ri;
      if (x0 != nullptr) {
        ri = bi - apply_row(win, offs, nw, x0, i, n);
        x[i] = x0[i];
      } else {
        ri = bi;
        x[i] = T(0);
      }
      const T zi = ri * dinv[i];
      r[i] = ri;
      p[i] = zi;
      v[0] += ri * zi;
      v[1] += ri * ri;
      v[2] += bi * bi;
    }
    block_partials<T, 3>(v, smem, part_init + blockIdx.x, nb);
  }
  grid.sync();
  T tot[3];
  grid_totals<T, 3>(part_init, nb, bcast, tot);
  T rz = tot[0];
  T rn = sqrt(tot[1]);
  const T bnd = tol * sqrt(tot[2]);
  const T bound = bnd < T(0) ? T(0) : bnd;  // max(., 0) keeping NaN, as jnp.maximum

  int k = 0;
  while (k < maxiter && rn > bound) {
    {  // ---- ap = Z p, p.ap
      T v[1] = {T(0)};
      for (int i = first; i < n; i += stride) {
        const T api = apply_row(win, offs, nw, p, i, n);
        q[i] = api;
        v[0] += __ldcg(p + i) * api;
      }
      block_partials<T, 1>(v, smem, part_pap + blockIdx.x, nb);
    }
    grid.sync();
    T pap[1];
    grid_totals<T, 1>(part_pap, nb, bcast, pap);
    const T alpha = safe_div(rz, pap[0]);
    {  // ---- x, r, z = r * dinv (kept in q), r.z, r.r
      T v[2] = {T(0), T(0)};
      for (int i = first; i < n; i += stride) {
        const T pi = __ldcg(p + i);
        x[i] = __ldcg(x + i) + alpha * pi;
        const T ri = __ldcg(r + i) - alpha * __ldcg(q + i);
        r[i] = ri;
        const T zi = ri * dinv[i];
        q[i] = zi;
        v[0] += ri * zi;
        v[1] += ri * ri;
      }
      block_partials<T, 2>(v, smem, part_rz + blockIdx.x, nb);
    }
    grid.sync();
    T rr[2];
    grid_totals<T, 2>(part_rz, nb, bcast, rr);
    const T beta = safe_div(rr[0], rz);
    for (int i = first; i < n; i += stride) p[i] = __ldcg(q + i) + beta * __ldcg(p + i);
    ++k;
    rz = rr[0];
    rn = sqrt(rr[1]);
    grid.sync();  // p complete before the next apply reads its neighbours
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *k_out = k;
    *rn_out = rn;
  }
}

template <typename T>
int launch(const T* win, const int* offs, int nw, const T* b, const T* dinv,
           const T* x0, T* x, T* r, T* p, T* q, T* part, int* k_out,
           T* rn_out, int n, int maxiter, double tol, void* stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_solve_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = per_sm * sms;
  const int need = (n + kThreads - 1) / kThreads;
  if (blocks > need) blocks = need;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  T tol_t = static_cast<T>(tol);
  void* args[] = {&win, &offs, &nw, &b, &dinv, &x0, &x, &r, &p, &q, &part,
                  &k_out, &rn_out, &n, &maxiter, &tol_t};
  e = cudaLaunchCooperativeKernel((void*)cg_solve_kernel<T>,
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cg_solve_max_blocks() { return kMaxBlocks; }

extern "C" int cg_solve_f32(const float* win, const int* offs, int nw,
                            const float* b, const float* dinv, const float* x0,
                            float* x, float* r, float* p, float* q, float* part,
                            int* k_out, float* rn_out, int n, int maxiter,
                            double tol, void* stream) {
  return launch<float>(win, offs, nw, b, dinv, x0, x, r, p, q, part, k_out,
                       rn_out, n, maxiter, tol, stream);
}
