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
// against the field length and none leaves the tensor.  Two modes of one
// template, and the gradient on a class-compacted table:
//
//   SPMV  W (nw, n), shared over the cx = C channels of x (1 or 3):
//         y[c, s] += W[k, s] * x[c, s + off]           (K, K + A, MK + A, M)
//   DIV   W (3, nw, n), x (3, n):
//         y[0, s] += (W[0,k,s] x[0,.] + W[1,k,s] x[1,.]) + W[2,k,s] x[2,.]
//   GRAD  (grad_compact_kernel) W (3, nk, n), x (1, n):
//         y[d, s] += W[d, j, s] * x[0, s + off_{c(s), j}],  j < count_{c(s)}
//
// (DIV: the directions summed first, then added to the running sum, as the
// Pallas body's jnp.sum then acc + ...).
//
// What bounds it: the weight stream.  Every weight plane is read once
// (NE27000 at n = 227,328, f32: K 125 planes = 113.7 MB), while the field
// (<= 3 x 0.9 MB) stays in the 50 MB L2 and its shifted rows are re-read
// from there.  Design: one thread per output row s; neighbouring threads
// take neighbouring s, so every weight load and every shifted field load is
// coalesced.  A thread keeps its (up to 3) outputs in registers and reads
// each shared SPMV weight once for all channels.  The offsets table is read
// uniformly by a warp (broadcast).  Templated on float and double.
//
// GRAD on the compacted table.  G's rows read the coarse pressure embedded
// on the even fine nodes, so the full window table (3 x 125 planes, 341 MB
// at NE27000 f32) is 88 % structural zeros.  A row s of parity class c(s)
// (the parities of its x, y, z) keeps the slots whose offset lands on an
// even node on all three axes, in window order: 3 per even axis, 2 per odd
// one, 27 / 18 / 12 / 8 slots (ops/window_stencil.py::compact_g_window,
// which checks that every dropped weight is 0).  The table is (3, nk, n),
// entries past a class's count zero: 73.7 MB at NE27000 f32.  Neighbouring
// lanes belong to different classes, so the (8, nk) offsets table sits in
// shared memory (constant memory would serialize the reads).  The slot
// loop is unrolled to the fixed maximum of 27, in chunks of 9: a chunk's
// weight and field loads, predicated on the class count and on the field
// bounds, are all issued before its multiply-adds, which then run in window
// order.  A dropped term of the full window was fma(0, x, acc) = acc, so
// the result is the full-window sum's bit for bit (up to the sign of an
// exact zero).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 3;
constexpr int kClasses = 8;
constexpr int kMaxSlots = 27;   // the even class of a radius-2 window: 3 x 3 x 3
constexpr int kChunk = 9;       // slots whose loads are issued together
enum Mode { kSpmv = 0, kDiv = 2 };   // the wrapper's mode numbers; GRAD is grad_compact_kernel

// the multiply-add of a GRAD term, rounded once, as the full window's
// acc += w * x compiles, so the compact sum keeps that sum's bits
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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
    } else {
      const T t = wk[0] * x[j] + wk[wdir] * x[plane + j];
      acc[0] += t + wk[2 * wdir] * x[2 * plane + j];
    }
  }
  const int co = kMode == kSpmv ? cx : 1;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < co) y[c * plane + s] = acc[c];
  }
}

// offs (8, nk) flat offsets by class, counts (8,): slot j < counts[c] of a
// class-c row reads x[s + offs[c, j]] with the weights w[., j, s]
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_compact_kernel(
    const T* __restrict__ w, int nk, const T* __restrict__ x,
    const int* __restrict__ offs, const int* __restrict__ counts, T* __restrict__ y,
    int n, int fx, int fy) {
  __shared__ int s_offs[kClasses * kMaxSlots];
  __shared__ int s_count[kClasses];
  for (int i = threadIdx.x; i < kClasses * nk; i += kThreads) s_offs[i] = offs[i];
  if (threadIdx.x < kClasses) s_count[threadIdx.x] = counts[threadIdx.x];
  __syncthreads();
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const int cls = (((s / (fx * fy)) & 1) << 2) | ((((s / fx) % fy) & 1) << 1) | ((s % fx) & 1);
  const int cnt = s_count[cls];
  const int* o = s_offs + cls * nk;
  const size_t plane = static_cast<size_t>(n);
  const size_t wdir = static_cast<size_t>(nk) * plane;   // direction stride of W
  const T* ws = w + s;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int j0 = 0; j0 < kMaxSlots; j0 += kChunk) {
    T w0[kChunk], w1[kChunk], w2[kChunk], xv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int j = j0 + i;
      const int jj = j < cnt ? s + o[j] : -1;
      const bool live = jj >= 0 && jj < n;   // zero field outside [0, n)
      const T* wj = ws + static_cast<size_t>(j) * plane;
      xv[i] = live ? x[jj] : T(0);
      w0[i] = live ? wj[0] : T(0);
      w1[i] = live ? wj[wdir] : T(0);
      w2[i] = live ? wj[2 * wdir] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      acc0 = fma_rn(w0[i], xv[i], acc0);
      acc1 = fma_rn(w1[i], xv[i], acc1);
      acc2 = fma_rn(w2[i], xv[i], acc2);
    }
  }
  y[s] = acc0;
  y[plane + s] = acc1;
  y[2 * plane + s] = acc2;
}

template <typename T>
int launch(int mode, const T* w, const T* x, int cx, const int* offs, int nw,
           T* y, int n, void* stream) {
  const bool ok = (mode == kSpmv && cx >= 1 && cx <= kMaxC) || (mode == kDiv && cx == 3);
  if (!ok || nw < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kSpmv) {
    window_stencil_kernel<T, kSpmv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, n);
  } else {
    window_stencil_kernel<T, kDiv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const T* w, int nk, const T* x, const int* offs, const int* counts, T* y,
                int n, int fx, int fy, void* stream) {
  if (nk < 1 || nk > kMaxSlots || n < 1 || fx < 1 || fy < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grad_compact_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(w, nk, x, offs, counts, y,
                                                                n, fx, fy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SPMV, 2 DIV.  w, x, y, offs device pointers; y has (cx | 1) x n
// entries by mode.
extern "C" int window_stencil_f32(int mode, const float* w, const float* x, int cx,
                                  const int* offs, int nw, float* y, int n, void* stream) {
  return launch<float>(mode, w, x, cx, offs, nw, y, n, stream);
}

extern "C" int window_stencil_f64(int mode, const double* w, const double* x, int cx,
                                  const int* offs, int nw, double* y, int n, void* stream) {
  return launch<double>(mode, w, x, cx, offs, nw, y, n, stream);
}

// G on the class-compacted window: w (3, nk, n), x (n,), offs (8, nk),
// counts (8,), y (3, n); (fx, fy) the fine grid's x and y sizes
extern "C" int grad_compact_f32(const float* w, int nk, const float* x, const int* offs,
                                const int* counts, float* y, int n, int fx, int fy,
                                void* stream) {
  return launch_grad<float>(w, nk, x, offs, counts, y, n, fx, fy, stream);
}

extern "C" int grad_compact_f64(const double* w, int nk, const double* x, const int* offs,
                                const int* counts, double* y, int n, int fx, int fy,
                                void* stream) {
  return launch_grad<double>(w, nk, x, offs, counts, y, n, fx, fy, stream);
}
