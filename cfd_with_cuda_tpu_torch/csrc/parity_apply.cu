// parity_apply: the class-major (parity-split) window apply on Hopper.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/parity_stencil.py::
// parity_apply, resident-field form: one weight table (pallas_call at
// :432, the K u* and G p applies) and two weight tables (pallas_call at
// :406, (K + A(un)) u* with the per-step convection planes as the second
// table).
//
//   y[c, p, q] = sum over (table, j, p_in, dq) in route[p] of
//                w_table[c | 0, j, q] * x[c | 0, p_in, q + dq]
//
// with x read as zero outside [0, sp) (the TPU kernel's zero halo pad).
// Output classes accumulate their routes in the route order: the first
// table's pairs, then the second's, as the Pallas body does (:395-403).
//
// What bounds it: the weight stream.  Every weight plane is read once
// (NE27000 f32: 512 planes x 30720 = 63 MB for K, 125 x 3 planes = 46 MB
// for G, 1241 planes = 152 MB for K + A), while the field (3 x 8 x 30720 =
// 2.9 MB) stays in the 50 MB L2 and is re-read per plane from there.
// Design: one thread per (class p, coarse q); neighbouring threads take
// neighbouring q, so every weight-plane read and every shifted field read
// is coalesced along q.  A thread keeps its (up to 3) output channels in
// registers and reads each shared weight once for all channels.  The route
// (a few hundred int entries per class) is read uniformly by a warp, so it
// is served by broadcast from L1.  Simple and correct first; tiling the
// field through shared memory is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCo = 3;
constexpr int kClasses = 8;

// route: int32 [0 .. 8] = start of each class's entries (route[8] = total),
// then 4 ints per entry: (table 0|1, plane j, input class p_in, shift dq).
template <typename T>
__global__ void __launch_bounds__(kThreads) parity_apply_kernel(
    const T* __restrict__ w1, int cw1, int m1,
    const T* __restrict__ w2, int cw2, int m2,
    const T* __restrict__ x, int cx, int px,
    const int* __restrict__ route,
    T* __restrict__ y, int co, int sp) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int p = blockIdx.y;
  if (q >= sp) return;
  T acc[kMaxCo];
#pragma unroll
  for (int c = 0; c < kMaxCo; ++c) acc[c] = T(0);
  const size_t plane = static_cast<size_t>(sp);
  const size_t xstride = static_cast<size_t>(px) * plane;  // channel stride of x
  const int e_end = route[p + 1];
  for (int e = route[p]; e < e_end; ++e) {
    const int* r = route + (kClasses + 1) + 4 * e;
    const int tab = r[0], j = r[1], pp = r[2], dq = r[3];
    const int qs = q + dq;
    if (qs < 0 || qs >= sp) continue;  // zero field outside [0, sp)
    const T* w = tab ? w2 : w1;
    const int cw = tab ? cw2 : cw1;
    const size_t wstride = static_cast<size_t>(tab ? m2 : m1) * plane;
    const T* wj = w + static_cast<size_t>(j) * plane + q;
    const T* xq = x + static_cast<size_t>(pp) * plane + qs;
    const T w0 = wj[0];
    const T x0 = xq[0];
#pragma unroll
    for (int c = 0; c < kMaxCo; ++c) {
      if (c < co) {
        const T wv = (cw == 1) ? w0 : wj[c * wstride];
        const T xv = (cx == 1) ? x0 : xq[c * xstride];
        acc[c] += wv * xv;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCo; ++c) {
    if (c < co) y[(static_cast<size_t>(c) * kClasses + p) * plane + q] = acc[c];
  }
}

template <typename T>
int launch(const T* w1, int cw1, int m1, const T* w2, int cw2, int m2,
           const T* x, int cx, int px, const int* route, T* y, int co,
           int sp, void* stream) {
  if (co < 1 || co > kMaxCo) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((sp + kThreads - 1) / kThreads, kClasses);
  parity_apply_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w1, cw1, m1, w2, cw2, m2, x, cx, px, route, y, co, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int parity_apply_f32(const float* w1, int cw1, int m1,
                                const float* w2, int cw2, int m2,
                                const float* x, int cx, int px,
                                const int* route, float* y, int co, int sp,
                                void* stream) {
  return launch<float>(w1, cw1, m1, w2, cw2, m2, x, cx, px, route, y, co, sp, stream);
}
