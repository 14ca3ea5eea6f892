// div_compact: the coarse-grid divergence G^T u from a class-major field.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_stencil.py::
// div_compact_call (pallas_call at :307), reached on the main path through
// ops/parity_stencil.py::parity_div_apply (:528).
//
//   y[q] = sum over slots s < nw (in order) of
//          sum_d GT[d, s, q] * u[d, cls_s, q + off_s]      (d = 0, 1, 2)
//
// with u read as zero outside [0, sp).  The slots are the 125 (class,
// coarse offset) pairs of div_class_pairs (the radius-2 fine window seen
// from the coarse rows).  The field is read in its (3, 8, sp) layout: the
// TPU path's transpose to rows 3p + d (parity_stencil.py:544) is not
// needed.
//
// What bounds it: the compact G^T weight stream, 3 x 125 planes (NE27000
// f32: 46 MB per apply); the 2.9 MB field stays in L2.  Design: one thread
// per coarse q, neighbouring threads on neighbouring q, so each weight
// plane and each shifted field row is read coalesced; the slot table is
// read uniformly by the warp.  Per slot the three directions are summed
// first ((d0 + d1) + d2), then added to the running sum, as the Pallas body
// does (jnp.sum over the 3 rows, then acc + ...).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClasses = 8;

// pairs: int32, 2 per slot: (class, flat coarse offset)
template <typename T>
__global__ void __launch_bounds__(kThreads) div_compact_kernel(
    const T* __restrict__ gt, int nw, const T* __restrict__ u,
    const int* __restrict__ pairs, T* __restrict__ y, int sp) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= sp) return;
  const size_t plane = static_cast<size_t>(sp);
  const size_t dstride_w = static_cast<size_t>(nw) * plane;   // GT direction stride
  const size_t dstride_u = kClasses * plane;                  // u direction stride
  T acc = T(0);
  for (int s = 0; s < nw; ++s) {
    const int cls = pairs[2 * s];
    const int qs = q + pairs[2 * s + 1];
    if (qs < 0 || qs >= sp) continue;  // zero field outside [0, sp)
    const T* g = gt + static_cast<size_t>(s) * plane + q;
    const T* x = u + static_cast<size_t>(cls) * plane + qs;
    const T t = g[0] * x[0] + g[dstride_w] * x[dstride_u];
    acc += t + g[2 * dstride_w] * x[2 * dstride_u];
  }
  y[q] = acc;
}

template <typename T>
int launch(const T* gt, int nw, const T* u, const int* pairs, T* y, int sp,
           void* stream) {
  div_compact_kernel<T><<<(sp + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(gt, nw, u, pairs, y, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int div_compact_f32(const float* gt, int nw, const float* u,
                               const int* pairs, float* y, int sp, void* stream) {
  return launch<float>(gt, nw, u, pairs, y, sp, stream);
}
