// Shared device code of the pressure-CG kernels (cg_solve.cu, cg_iter.cu):
// the window apply in its full and symmetric-half forms, the deterministic
// grid-wide reductions in their plain (f32) and compensated (f64) forms, and
// the cooperative launch.
//
// Window apply, full form (replaces pallas_cg.py::_apply_window, :230):
//   (Z v)[i] = sum_w win[w, i] * v[i + offs[w]],  v zero outside [0, n),
// slots summed in order.  There is no halo copy of v: a bounds check.  The
// offsets are any static list: a box grid's W^3 window, or the banded window
// of an unstructured pressure operator (ops/banded.py; replaces
// pallas_cg.py::fused_cg(offs=...), :478-492, at NE144600 BFS scale 275 slots
// up to +-7,390 over n = 147,477 rows).  Indices stay in int except the weight
// row offset, a size_t (275 x 147,477 = 40.6M entries per table).
//
// Symmetric-half form (replaces _apply_window's sym branch, :262-283): the
// weights are the (nw, n) dq >= 0 half of a symmetric window, offs[0] = 0 and
// offs[m] > 0 after it, and each positive offset is used both ways.  The
// TPU body scatters w[q] * x[q] into a back-buffer at q + dq; here every row
// GATHERS its own terms, so there are no atomics and the order is fixed:
//   ap[i] =  sum_{m>=0} win[m, i]      * v[i + dq_m]       (i + dq_m < n)
//          + sum_{m>0}  win[m, i-dq_m] * v[i - dq_m]       (i - dq_m >= 0)
// forward sum in slot order, back sum in slot order, then fwd + back (the
// order of the TPU body: its back-buffer is added once at the end).  It
// reads 63 instead of 125 weight planes per apply at radius 2.
//
// Reductions (replace _plain_dot :226 and _comp_dot :194): each thread
// accumulates its rows, each block reduces in a fixed tree and writes its
// partial to a fixed slot, and after a grid barrier EVERY block sums all
// partials in the same order, so every block holds bitwise the same scalar
// and a run repeats bit for bit.  COMP = false accumulates in f32.  COMP =
// true is _comp_dot's contract, not its double-single tree: the product of
// two f32 values is exact in f64 (24 + 24 <= 53 bits), so f64 thread
// accumulators, an f64 block tree and f64 partials, rounded to f32 once at
// the end, give the f64 dot of the f32 inputs (what the TPU, with no f64 in a
// kernel, needed two-prod/two-sum for).  Vectors that other blocks write are
// read with __ldcg (through L2; L1 is not coherent across SMs).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgk {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;   // wrappers size the partial buffers by it

template <bool COMP> struct Acc { using type = float; };
template <> struct Acc<true> { using type = double; };

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-35f ? a / b : 0.0f;
}

template <bool SYM>
__device__ __forceinline__ float apply_row(const float* __restrict__ win,
                                           const int* __restrict__ offs, int nw,
                                           const float* v, int i, int n) {
  if (SYM) {
    float fwd = 0.0f, back = 0.0f;
    for (int m = 0; m < nw; ++m) {
      const int dq = offs[m];
      const size_t row = static_cast<size_t>(m) * n;
      const int c = i + dq;
      const float vf = c < n ? __ldcg(v + c) : 0.0f;
      fwd += win[row + i] * vf;
      const int j = i - dq;
      if (dq > 0 && j >= 0) back += win[row + j] * __ldcg(v + j);
    }
    return fwd + back;
  }
  float acc = 0.0f;
  for (int w = 0; w < nw; ++w) {
    const int c = i + offs[w];
    const float vv = (c >= 0 && c < n) ? __ldcg(v + c) : 0.0f;
    acc += win[static_cast<size_t>(w) * n + i] * vv;
  }
  return acc;
}

// one term of a dot product in the accumulator's type
template <typename A>
__device__ __forceinline__ A prod(float a, float b) {
  return static_cast<A>(a) * static_cast<A>(b);
}

// Sum NV per-thread values over the block in a fixed tree; thread 0 writes
// value k to out[k * stride].
template <typename A, int NV>
__device__ __forceinline__ void block_partials(const A (&v)[NV], A* smem,
                                               A* out, int stride) {
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
// a fixed order (lane-strided sums, then a fixed shuffle tree), rounded to
// f32 once.  Result broadcast to all threads through shared memory.
template <typename A, int NV>
__device__ __forceinline__ void grid_totals(const A* part, int nb, float* bcast,
                                            float (&res)[NV]) {
  const int t = threadIdx.x;
  if (t < 32) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      A s = A(0);
      for (int b = t; b < nb; b += 32) s += __ldcg(part + k * nb + b);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (t == 0) bcast[k] = static_cast<float>(s);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) res[k] = bcast[k];
  __syncthreads();
}

// Cooperative launch on min(co-resident blocks, ceil(n / kThreads)) blocks.
// `resident` is the caller's per-kernel cache (kMaxDev zeros at first) of
// the co-resident block count, asked once per device.
constexpr int kMaxDev = 16;

template <typename K>
int coop_launch(K kernel, int* resident, int n, void** args, void* stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDev) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  int blocks = resident[dev];
  const int need = (n + kThreads - 1) / kThreads;
  if (blocks > need) blocks = need;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgk
