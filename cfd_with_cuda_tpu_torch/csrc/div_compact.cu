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
// needed.  Per slot the three directions are summed first ((d0 + d1) + d2),
// then added to the running sum, as the Pallas body does (jnp.sum over the
// 3 rows, then acc + ...).
//
// What bounds it: the compact G^T weight stream, 3 x 125 planes (NE27000
// f32: 46 MB per apply); the 2.9 MB field stays in L2.  A thread per row
// walking its 125 slots in turn is latency-bound (125 dependent rounds of
// HBM latency, ~0.065 ms at NE27000 on an H100 against a 0.013 ms byte
// bound), so a block takes 32 coarse rows (one warp's width: weight and
// field loads stay coalesced) with 8 warps, in two phases:
//   1. each warp takes every 8th slot and, for its 32 rows, computes the
//      slot's term v[s][r] = (g0 x0 + g1 x1) + g2 x2 (the Pallas body's
//      per-slot sum) into shared memory, 4 slots' loads issued together
//      (at most 64 registers a thread, so 4 blocks share an SM); a slot
//      whose field index leaves the field writes -0.0f, which leaves any
//      running sum exactly as skipping the slot would;
//   2. warp 0 adds v[0..nw) in slot order to an accumulator that starts at
//      +0 and writes y.
// The sum runs over the same terms in slot order, each term the same
// expression, so the result is that of a thread walking its row's slots in
// turn, bit for bit, while a block keeps its 125 x 32 slot terms' loads in
// flight together.
//
// The sharded divergence (parallel/sharded_stencil.py::sharded_div_compact)
// runs the interleaved form on a rank's coarse rows: rows q0 + q of the
// global coarse grid (GT and y indexed by q), reading the rank's
// halo-extended velocity block, whose entry j holds the global fine node
// x_org + j (zero outside the block).  Each row sums the same slots in the
// same order as the full-window DIV mode of window_stencil.cu at its fine
// row, whose weights at the other 7/8 of the fine rows are structurally 0;
// the rank computes 1/8 of the rows and all-gathers only those.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                        // coarse rows of a block
constexpr int kWarps = 8;
constexpr int kThreads = kRows * kWarps;
constexpr int kMaxSlots = 128;                   // 125 for the radius-2 window
constexpr int kSlotsPerWarp = kMaxSlots / kWarps;
constexpr int kChunk = 4;                        // slots whose loads are issued together
constexpr int kBlocksPerSm = 4;                  // 64 registers a thread at most
constexpr int kClasses = 8;

// The class-major field u (3, 8, sp): slot (cls, off) of row q reads
// u[d, cls, q + off], zero outside [0, sp).
struct ClassMajor {
  int sp;
  static __device__ int2 slot(const int* tab, int s) {
    return make_int2(tab[2 * s], tab[2 * s + 1]);
  }
  __device__ int base(int q) const { return q; }
  __device__ long long at(int base, int2 slot) const {
    const int qs = base + slot.y;
    return (qs < 0 || qs >= sp) ? -1 : static_cast<long long>(slot.x) * sp + qs;
  }
};

// The interleaved field u (3, n_u), flat fine-grid order, where the
// class-major form reads its class split: slot s of coarse row q is the fine
// node emb(q) + foff_s, emb(q) = (2 qz fy + 2 qy) fx + 2 qx, foff_s the
// slot's fine window offset (the same z-major radius-2 scan as the pairs).
// It reads the value the split would hold there, or, where the fine offset
// leaves the grid and wraps a row end, some other node's value under a zero
// weight (the 3-D neighbour is absent, so G^T has no entry); the sum runs in
// the same order, so the result equals the split form's without the
// split's ~24 copies.
struct Interleaved {
  int n_u, cx, cy, fx, fy, q0, x_org;
  static __device__ int2 slot(const int* tab, int s) { return make_int2(0, tab[s]); }
  __device__ int base(int q) const {
    const int qg = q0 + q;
    const int qx = qg % cx, qy = (qg / cx) % cy, qz = qg / (cx * cy);
    return (2 * qz * fy + 2 * qy) * fx + 2 * qx - x_org;
  }
  __device__ long long at(int base, int2 slot) const {
    const int j = base + slot.y;
    return (j < 0 || j >= n_u) ? -1 : j;
  }
};

// y[q] for the block's 32 rows; rows q >= nrows (the interleaved form's
// class box padding) are 0.  dstride_u: u's direction stride.
template <class Field>
__device__ __forceinline__ void div_rows(const float* __restrict__ gt, int nw,
                                         const float* __restrict__ u, size_t dstride_u,
                                         const int* __restrict__ tab, const Field field,
                                         float* __restrict__ y, int sp, int nrows) {
  __shared__ float v[kMaxSlots][kRows];
  __shared__ int2 slots[kMaxSlots];
  for (int s = threadIdx.x; s < nw; s += kThreads) slots[s] = Field::slot(tab, s);
  __syncthreads();
  const int lane = threadIdx.x % kRows, warp = threadIdx.x / kRows;
  const int q = blockIdx.x * kRows + lane;
  const bool row = q < nrows;
  const int base = row ? field.base(q) : 0;
  const size_t plane = static_cast<size_t>(sp);
  const size_t dstride_w = static_cast<size_t>(nw) * plane;   // GT direction stride

  // phase 1: this warp's slots warp, warp + 8, ...; a chunk's loads are all
  // issued before its sums
#pragma unroll
  for (int i0 = 0; i0 < kSlotsPerWarp; i0 += kChunk) {
    float g0[kChunk], g1[kChunk], g2[kChunk], x0[kChunk], x1[kChunk], x2[kChunk];
    bool live[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int s = warp + kWarps * (i0 + i);
      const long long a = (row && s < nw) ? field.at(base, slots[s]) : -1;
      live[i] = a >= 0;
      const float* g = gt + static_cast<size_t>(s) * plane + q;
      const float* x = u + a;
      g0[i] = live[i] ? g[0] : 0.0f;
      g1[i] = live[i] ? g[dstride_w] : 0.0f;
      g2[i] = live[i] ? g[2 * dstride_w] : 0.0f;
      x0[i] = live[i] ? x[0] : 0.0f;
      x1[i] = live[i] ? x[dstride_u] : 0.0f;
      x2[i] = live[i] ? x[2 * dstride_u] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int s = warp + kWarps * (i0 + i);
      if (s < nw) {
        const float t = g0[i] * x0[i] + g1[i] * x1[i];
        v[s][lane] = live[i] ? t + g2[i] * x2[i] : -0.0f;
      }
    }
  }
  __syncthreads();

  // phase 2: the slot terms in slot order
  if (warp == 0 && q < sp) {
    float acc = 0.0f;
    for (int s = 0; s < nw; ++s) acc += v[s][lane];
    y[q] = row ? acc : 0.0f;
  }
}

// pairs: int32, 2 per slot: (class, flat coarse offset)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) div_compact_kernel(
    const float* __restrict__ gt, int nw, const float* __restrict__ u,
    const int* __restrict__ pairs, float* __restrict__ y, int sp) {
  div_rows(gt, nw, u, kClasses * static_cast<size_t>(sp), pairs, ClassMajor{sp}, y, sp, sp);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) div_compact_interleaved_kernel(
    const float* __restrict__ gt, int nw, const float* __restrict__ u, int n_u,
    const int* __restrict__ foffs, float* __restrict__ y, int sp, int cx, int cy,
    int nq, int fx, int fy, int q0, int x_org) {
  div_rows(gt, nw, u, static_cast<size_t>(n_u), foffs,
           Interleaved{n_u, cx, cy, fx, fy, q0, x_org}, y, sp, nq);
}

int launch_interleaved(const float* gt, int nw, const float* u, int n_u, const int* foffs,
                       float* y, int sp, int cx, int cy, int nq, int fx, int fy, int q0,
                       int x_org, void* stream) {
  if (nw < 1 || nw > kMaxSlots || sp < 1 || nq > sp || n_u < 1 || q0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  div_compact_interleaved_kernel<<<(sp + kRows - 1) / kRows, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      gt, nw, u, n_u, foffs, y, sp, cx, cy, nq, fx, fy, q0, x_org);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int div_compact_f32(const float* gt, int nw, const float* u,
                               const int* pairs, float* y, int sp, void* stream) {
  if (nw < 1 || nw > kMaxSlots || sp < 1) return static_cast<int>(cudaErrorInvalidValue);
  div_compact_kernel<<<(sp + kRows - 1) / kRows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(gt, nw, u, pairs, y, sp);
  return static_cast<int>(cudaGetLastError());
}

// coarse dims (cx, cy, nq = cx cy cz), fine dims (fx, fy); u (3, n_u).  The
// wrapper calls the _rows form below at q0 = x_org = 0; this one stays as a
// forwarder for compare_build.py, which calls a build's C symbols directly.
extern "C" int div_compact_interleaved_f32(const float* gt, int nw, const float* u, int n_u,
                                           const int* foffs, float* y, int sp, int cx,
                                           int cy, int nq, int fx, int fy, void* stream) {
  return launch_interleaved(gt, nw, u, n_u, foffs, y, sp, cx, cy, nq, fx, fy, 0, 0, stream);
}

// the same on a rank's coarse rows q0 + q (q < nq; GT (3, nw, sp) and y (sp)
// indexed by q), u (3, n_u) the velocity from global fine position x_org
extern "C" int div_compact_interleaved_rows_f32(const float* gt, int nw, const float* u,
                                                int n_u, const int* foffs, float* y, int sp,
                                                int cx, int cy, int nq, int fx, int fy, int q0,
                                                int x_org, void* stream) {
  return launch_interleaved(gt, nw, u, n_u, foffs, y, sp, cx, cy, nq, fx, fy, q0, x_org,
                            stream);
}
