// div_compact: the coarse-grid divergence G^T u from a class-major field,
// or from an interleaved one.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_stencil.py::
// div_compact_call (pallas_call at :307), reached on the parity path through
// ops/parity_stencil.py::parity_div_apply (:528) and on the interleaved path
// through pallas_div_compact (:271), which first splits u into its 8 parity
// classes (_extract_classes :244).
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

// The interleaved form reads u (3, n_u), flat fine-grid order, where the
// class-major form reads its class split: slot s of coarse row q is the fine
// node emb(q) + foff_s, emb(q) = (2 qz fy + 2 qy) fx + 2 qx, foff_s the
// slot's fine window offset (the same z-major radius-2 scan as the pairs).
// It reads the value the split would hold there, or, where the fine offset
// leaves the grid and wraps a row end, some other node's value under a
// zero weight (the 3-D neighbour is absent, so G^T has no entry); the sum
// runs in the same order, so the result equals the split form's without
// the split's ~24 copies.  Rows q >= nq (the class box padding) are 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) div_compact_interleaved_kernel(
    const T* __restrict__ gt, int nw, const T* __restrict__ u, int n_u,
    const int* __restrict__ foffs, T* __restrict__ y, int sp, int cx, int cy,
    int nq, int fx, int fy) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= sp) return;
  if (q >= nq) {
    y[q] = T(0);
    return;
  }
  const int qx = q % cx, qy = (q / cx) % cy, qz = q / (cx * cy);
  const int e = (2 * qz * fy + 2 * qy) * fx + 2 * qx;
  const size_t plane = static_cast<size_t>(sp);
  const size_t dstride_w = static_cast<size_t>(nw) * plane;   // GT direction stride
  const size_t dstride_u = static_cast<size_t>(n_u);          // u direction stride
  T acc = T(0);
  for (int s = 0; s < nw; ++s) {
    const int j = e + foffs[s];
    if (j < 0 || j >= n_u) continue;   // zero field outside [0, n_u)
    const T* g = gt + static_cast<size_t>(s) * plane + q;
    const T* x = u + j;
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

// coarse dims (cx, cy, nq = cx cy cz), fine dims (fx, fy); u (3, n_u)
extern "C" int div_compact_interleaved_f32(const float* gt, int nw, const float* u, int n_u,
                                           const int* foffs, float* y, int sp, int cx,
                                           int cy, int nq, int fx, int fy, void* stream) {
  div_compact_interleaved_kernel<float><<<(sp + kThreads - 1) / kThreads, kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      gt, nw, u, n_u, foffs, y, sp, cx, cy, nq, fx, fy);
  return static_cast<int>(cudaGetLastError());
}
