// window_stencil: the interleaved layout's window applies on Hopper.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/pallas_stencil.py::
// _stencil_call (pallas_call at :132), reached through pallas_window_spmv
// (:151), pallas_grad_window (:175) and pallas_div_window (:189).
//
//   y[c, s] = sum over window slots k < nw (in order) of
//             combine(W[., k, s], x[., s + off_k])
//
// with x read as zero outside [0, n) (the TPU kernel's zero halo).  The
// offsets are flat: a window offset crosses grid-row ends, and only the
// zero weights there make the result right, so every read is bounds-checked
// against the field length and none leaves the tensor.  Three modes, one
// template:
//
//   SPMV  W (nw, n), shared over the cx = C channels of x (1 or 3):
//         y[c, s] += W[k, s] * x[c, s + off]           (K, K + A, MK + A, M)
//   GRAD  W (3, nw, n), x (1, n):  y[d, s] += W[d, k, s] * x[0, s + off]
//   DIV   W (3, nw, n), x (3, n):
//         y[0, s] += (W[0,k,s] x[0,.] + W[1,k,s] x[1,.]) + W[2,k,s] x[2,.]
//
// (the directions summed first, then added to the running sum, as the
// Pallas body's jnp.sum then acc + ...).
//
// What bounds it: the weight stream.  Every weight plane is read once
// (NE27000 at n = 227,328, f32: K 125 planes = 113.7 MB, G and G^T 3 x 125
// planes = 341 MB), while the field (<= 3 x 0.9 MB) stays in the 50 MB L2
// and its shifted rows are re-read from there.  Design: one thread per
// output row s; neighbouring threads take neighbouring s, so every weight
// load and every shifted field load is coalesced.  A thread keeps its (up
// to 3) outputs in registers and reads each shared SPMV weight once for all
// channels.  The offsets table is read uniformly by a warp (broadcast).
// Templated on float and double.  Simple and correct first: compacting G's
// structurally zero 7/8 and staging through shared memory are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 3;
enum Mode { kSpmv = 0, kGrad = 1, kDiv = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) window_stencil_kernel(
    const T* __restrict__ w, const T* __restrict__ x, int cx,
    const int* __restrict__ offs, int nw, T* __restrict__ y, int n) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const size_t plane = static_cast<size_t>(n);
  const size_t wdir = static_cast<size_t>(nw) * plane;   // direction stride of W
  T acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = T(0);
  for (int k = 0; k < nw; ++k) {
    const int j = s + offs[k];
    if (j < 0 || j >= n) continue;   // zero field outside [0, n)
    const T* wk = w + static_cast<size_t>(k) * plane + s;
    if (kMode == kSpmv) {
      const T wv = wk[0];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < cx) acc[c] += wv * x[c * plane + j];
      }
    } else if (kMode == kGrad) {
      const T xv = x[j];
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d] += wk[d * wdir] * xv;
    } else {
      const T t = wk[0] * x[j] + wk[wdir] * x[plane + j];
      acc[0] += t + wk[2 * wdir] * x[2 * plane + j];
    }
  }
  const int co = kMode == kSpmv ? cx : (kMode == kGrad ? 3 : 1);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < co) y[c * plane + s] = acc[c];
  }
}

template <typename T>
int launch(int mode, const T* w, const T* x, int cx, const int* offs, int nw,
           T* y, int n, void* stream) {
  const bool ok = (mode == kSpmv && cx >= 1 && cx <= kMaxC) ||
                  (mode == kGrad && cx == 1) || (mode == kDiv && cx == 3);
  if (!ok || nw < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kSpmv) {
    window_stencil_kernel<T, kSpmv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, n);
  } else if (mode == kGrad) {
    window_stencil_kernel<T, kGrad><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, n);
  } else {
    window_stencil_kernel<T, kDiv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SPMV, 1 GRAD, 2 DIV.  w, x, y, offs device pointers; y has
// (cx | 3 | 1) x n entries by mode.
extern "C" int window_stencil_f32(int mode, const float* w, const float* x, int cx,
                                  const int* offs, int nw, float* y, int n, void* stream) {
  return launch<float>(mode, w, x, cx, offs, nw, y, n, stream);
}

extern "C" int window_stencil_f64(int mode, const double* w, const double* x, int cx,
                                  const int* offs, int nw, double* y, int n, void* stream) {
  return launch<double>(mode, w, x, cx, offs, nw, y, n, stream);
}
