// parity_apply: the class-major (parity-split) window apply on Hopper.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/parity_stencil.py::
// parity_apply in both of its field forms:
//
// * resident field (parity_apply_kernel): one weight table (pallas_call at
//   :432, the K u* and G p applies) and two weight tables (pallas_call at
//   :406, (K + A(un)) u* with the per-step convection planes as the second
//   table); parity_window_apply (:253) runs on it too;
// * streamed field (parity_apply_streamed_kernel): kernel_s (:456, pallas_call
//   at :509), one and two tables, which the JAX package takes when the
//   halo-extended field is over 6 MiB (NE85184 and up: every K, K + A, MK + A
//   and M apply of both parity solvers there).
//
//   y[c, p, q] = sum over (table, j, p_in, dq) in route[p] of
//                w_table[c | 0, j, q] * x[c | 0, p_in, q + dq]
//
// with x read as zero outside [0, sp) (the TPU kernel's zero halo pad).
// Output classes accumulate their routes in the route order: the first
// table's pairs, then the second's, as the Pallas body does (:395-403,
// :489-496).  Both kernels take each term with the same arithmetic (madd
// below) in that order and skip the same out-of-range terms, so the two
// forms agree bit for bit, as the two Pallas forms do.  Each output is one
// thread's sum: no route is cut across threads, no atomics.
//
// What bounds both: the weight stream.  Every weight plane is read once
// (NE27000 f32: 512 planes x 30720 = 63 MB for K, 125 x 3 planes = 46 MB
// for G, 1241 planes = 152 MB for K + A; NE85184 at Sp = 92160: 189 MB for
// K, 457 MB for K + A), coalesced along q: at 3.35 TB/s, 0.019 ms for K at
// NE27000 and 0.056 ms at NE85184.  A thread owns an output (its sum is one
// FMA chain in route order), so the loads of a route entry are a chain too
// (entry, then weight and field value); streaming near that rate needs tens
// of KB of loads in flight on each SM, where one weight load a thread, as
// the first forms kept, gives a few.  So both kernels load the weights and
// field values of kUnroll route entries before any of those entries' FMAs,
// then add the terms in route order.  On an H100 (compare_build) the
// weights then arrive at 1.4-1.9 TB/s, about half the HBM rate.  Tried and
// slower there: a per-thread ring of 4-byte cp.async weight copies, 16
// entries a batch, 2 q a thread in the resident form (registers spilled,
// or too few warps an SM).
//
// Resident design: a block is one output class p and 256 consecutive q, a
// thread one (p, q), 3 blocks an SM (80 registers: 8 entries' weights and 3
// field values each in flight; ptxas -v on an H100 build reports 8-20 bytes
// of spill stores and 20-24 bytes of spill loads for the two instantiations,
// chip_smoke.py's toolchain line).  The block stages its class's
// route entries in shared memory (a 16-byte read, uniform across the warp)
// and runs the first table's entries, then the second's: two loops, no
// per-entry choice of table.  The field (NE27000: 3 x 8 x 30720 = 2.9 MB)
// stays in the 50 MB L2.
//
// Streamed design.  The TPU kernel DMAs the whole halo-extended block
// x[:, :, s0 : s0 + blk + 2 halo + 128] into VMEM per grid step: at NE85184
// that is 454 KB even at blk 256, twice what a Hopper block may hold (227
// KB).  What the route reads is much less: every shift is a coarse shift dq
// = dx + dy cx + dz cx cy with dx, dy, dz in {-1, 0, 1}, so a block of
// kStreamQ consecutive q reads, per input class, at most 9 runs of kStreamQ
// + 2 values per channel.  The wrapper groups each input class's shifts
// into runs [lo, lo + kRunSpan] and stages each as an aligned superset:
// from q0 + lo - a, a = lo mod 4 (q0 is a multiple of kStreamQ, so the start
// is 16-byte aligned), round_up(a + kStreamQ + kRunSpan, 4) values, copied
// with 16-byte cp.async (4-byte copies at the field's edges).  A CTA of
// kStreamWarps warps walks the q blocks blockIdx.x, +gridDim.x, ...; all 8
// output classes share one staged tile, so each run is read from L2 once
// per block.  A thread takes 2 consecutive q (8-byte weight loads), so a
// warp's item is one class's 64 q of the block.  The routes differ in
// length by class (K: 125 entries for class 0, 27 for class 7; K + A 341
// to 54), and a CTA waits at a barrier per block for its slowest warp, so a
// static schedule, built once per route on the host, deals the 8 items to
// the 4 warps longest first (K: the slowest warp sums 147 entries against
// a mean of 128; one class a warp waited 125 against 64).  On an H100 at
// NE85184 (compare_build) the schedule reads K in 0.131 ms and K + A in
// 0.246, against 0.146 and 0.312 with warp w summing classes w and w + 4,
// and 0.128 and 0.259 with classes w and 7 - w.  The field comes
// from shared memory; the weights stream once from HBM, coalesced along q.
// A CTA stages one tile at a time: the velocity routes stage 72 runs at
// every size (3 x 4992 floats = 58.5 KB a tile), so a second buffer would
// leave one CTA on an SM where one buffer leaves 3, and one CTA's staging
// overlaps the other CTAs' sums.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kResBlocks = 3;                      // resident: blocks an SM (register cap)
constexpr int kChunk = kThreads;                   // route entries staged a pass
constexpr int kMaxCo = 3;
constexpr int kClasses = 8;
constexpr int kHeads = 20;                         // streamed route: 2 x 8 + 1 heads, padded
constexpr int kStreamQ = 64;                       // q per staged block
constexpr int kStreamThreadQ = 2;                  // streamed: consecutive q a thread
constexpr int kSegQ = 32 * kStreamThreadQ;         // q of an item (a warp's outputs of a class)
constexpr int kSegs = kStreamQ / kSegQ;            // items per class and block
constexpr int kRunSpan = 2;                        // a run holds dq in [lo, lo + 2]
constexpr int kStreamWarps = 4;
constexpr int kStreamThreads = kStreamWarps * 32;
constexpr int kStreamBlocks = 3;                   // streamed: CTAs an SM (register cap)
constexpr int kMaxDev = 16;

// One term of a route, the same arithmetic in both forms: a weight shared
// over the channels (cw = 1: K, K + A, MK + A, M) as one fused multiply-add,
// a per-channel weight (G) as the product rounded, then added.  That is what
// the resident kernel's first source compiled to, so its results are kept
// bit for bit.
template <bool kShared>
__device__ __forceinline__ float madd(float acc, float w, float x) {
  return kShared ? __fmaf_rn(w, x, acc) : __fadd_rn(acc, __fmul_rn(w, x));
}

// kQ consecutive weights of a plane, one load (the plane offset and q are
// multiples of kQ).  kStream: the load does not allocate in L1.  A shared
// weight table is read once; cached in L1 it would evict what is read
// again, the resident form's field lines and the streamed form's route
// entries (on an H100 the K forms read faster so, the per-channel G tables
// slower: those load through L1).
template <int kQ> struct Vec;
template <> struct Vec<1> {
  float v[1];
  template <bool kStream>
  __device__ __forceinline__ void load(const float* a) {
    if constexpr (kStream) {
      asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v[0]) : "l"(a));
    } else {
      v[0] = __ldg(a);
    }
  }
};
template <> struct Vec<2> {
  float v[2];
  template <bool kStream>
  __device__ __forceinline__ void load(const float* a) {
    if constexpr (kStream) {
      asm volatile("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];"
                   : "=f"(v[0]), "=f"(v[1]) : "l"(a));
    } else {
      const float2 t = __ldg(reinterpret_cast<const float2*>(a));
      v[0] = t.x;
      v[1] = t.y;
    }
  }
};

template <bool kLdg>
__device__ __forceinline__ float load_x(const float* a) {
  if constexpr (kLdg) {
    return __ldg(a);
  } else {
    return *a;
  }
}

// The terms of kN route entries for the outputs (., q + k), k < kQ: entry
// ents[u] = (plane j, input class p_in, shift dq, field offset o), its field
// value x[c, p_in, q + k + dq] at xsrc[o + qx + k + c * xchan] where q + k +
// dq lies in [0, sp) (else the term is skipped).  Resident: xsrc the field
// in device memory, o = p_in * sp + dq, qx = q; streamed: xsrc the staged
// tile, o the staged position, qx = q - q0.  kShared: the table's weight is
// shared over the channels, else channel c's weight is at + c * wstride.
// kCx: field channels (1: every output channel reads channel 0).  kLdg: the
// field is read through the read-only data cache (device memory), else
// with plain loads (shared memory).  The weights and field values of the kN
// entries are all loaded before their FMAs, which then run in entry order.
template <int kN, int kCx, bool kShared, int kQ, bool kLdg>
__device__ __forceinline__ void sum_entries(float (&acc)[kQ][kMaxCo],
                                            const int4* __restrict__ ents,
                                            const float* __restrict__ w, size_t plane,
                                            size_t wstride, int q, const float* xsrc,
                                            size_t xchan, int qx, int sp, int co) {
  constexpr int kW = kShared ? 1 : kMaxCo;
  Vec<kQ> wv[kN][kW];
  float xv[kN][kQ][kCx];
  bool ok[kN][kQ];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int4 r = ents[u];
    const float* wj = w + static_cast<size_t>(r.x) * plane + q;
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      if (c < co) wv[u][c].template load<kShared>(wj + c * wstride);
    }
    const float* xq = xsrc + (static_cast<ptrdiff_t>(r.w) + qx);
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      ok[u][k] = static_cast<unsigned>(q + k + r.z) < static_cast<unsigned>(sp);
#pragma unroll
      for (int c = 0; c < kCx; ++c) {
        xv[u][k][c] = ok[u][k] ? load_x<kLdg>(xq + k + c * xchan) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      if (!ok[u][k]) continue;                  // zero field outside [0, sp)
#pragma unroll
      for (int c = 0; c < kMaxCo; ++c) {
        if (c < co) {
          acc[k][c] = madd<kShared>(acc[k][c], wv[u][kShared ? 0 : c].v[k],
                                    xv[u][k][kCx == 1 ? 0 : c]);
        }
      }
    }
  }
}

// Route entries [0, n) of one table: kUnroll at a time, then one by one.
template <int kUnroll, int kCx, bool kShared, int kQ, bool kLdg>
__device__ __forceinline__ void sum_table(float (&acc)[kQ][kMaxCo], const int4* __restrict__ ents,
                                          int n, const float* __restrict__ w, size_t plane,
                                          size_t wstride, int q, const float* xsrc, size_t xchan,
                                          int qx, int sp, int co) {
  int e = 0;
  for (; e + kUnroll <= n; e += kUnroll) {
    sum_entries<kUnroll, kCx, kShared, kQ, kLdg>(acc, ents + e, w, plane, wstride, q, xsrc, xchan,
                                                 qx, sp, co);
  }
  for (; e < n; ++e) {
    sum_entries<1, kCx, kShared, kQ, kLdg>(acc, ents + e, w, plane, wstride, q, xsrc, xchan, qx,
                                           sp, co);
  }
}

template <int kQ>
__device__ __forceinline__ void store(float* __restrict__ y, const float (&acc)[kQ][kMaxCo], int p,
                                      int q, size_t plane, int co) {
#pragma unroll
  for (int c = 0; c < kMaxCo; ++c) {
    if (c >= co) continue;
    float* yc = y + (static_cast<size_t>(c) * kClasses + p) * plane + q;
#pragma unroll
    for (int k = 0; k < kQ; ++k) yc[k] = acc[k][c];
  }
}

// route: int32 [0 .. 8] = start of each class's entries (route[8] = total),
// then 4 ints per entry: (table 0|1, plane j, input class p_in, shift dq),
// each class's first-table entries before its second-table ones.  Block
// (x, p) takes class p and q from x * kThreads.  One instantiation per field
// channel count (1: G and the class-window directions; 3: velocity).
template <int kCx>
__global__ void __launch_bounds__(kThreads, kResBlocks) parity_apply_kernel(
    const float* __restrict__ w1, int cw1, int m1,
    const float* __restrict__ w2, int cw2, int m2,
    const float* __restrict__ x, int px,
    const int* __restrict__ route,
    float* __restrict__ y, int co, int sp) {
  constexpr int kUnroll = 8;
  __shared__ int4 ents[kChunk];
  const int p = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < sp;
  const size_t plane = static_cast<size_t>(sp);
  const size_t xchan = static_cast<size_t>(px) * plane;
  const int e0 = route[p], e1 = route[p + 1];
  const int* rt = route + (kClasses + 1);
  // the first table's entries come first: count them
  int n1 = 0;
  for (int b = e0; b < e1; b += kThreads) {
    const int e = b + threadIdx.x;
    n1 += __syncthreads_count(e < e1 && rt[4 * e] == 0);
  }
  float acc[1][kMaxCo] = {};
  for (int tab = 0; tab < 2; ++tab) {
    const int lo = tab ? e0 + n1 : e0, hi = tab ? e1 : e0 + n1;
    const float* w = tab ? w2 : w1;
    const bool shared_w = (tab ? cw2 : cw1) == 1;
    const size_t wstride = static_cast<size_t>(tab ? m2 : m1) * plane;
    for (int b = lo; b < hi; b += kChunk) {
      const int n = min(kChunk, hi - b);
      __syncthreads();                          // the last chunk's reads are done
      if (threadIdx.x < n) {
        const int* r = rt + 4 * (b + threadIdx.x);
        ents[threadIdx.x] = make_int4(r[1], r[2], r[3], r[2] * sp + r[3]);
      }
      __syncthreads();
      if (!active) continue;
      if (shared_w) {
        sum_table<kUnroll, kCx, true, 1, true>(acc, ents, n, w, plane, 0, q, x, xchan, q, sp, co);
      } else {
        sum_table<kUnroll / 2, kCx, false, 1, true>(acc, ents, n, w, plane, wstride, q, x, xchan,
                                                    q, sp, co);
      }
    }
  }
  if (active) store<1>(y, acc, p, q, plane, co);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy the runs of the block starting at q0 into buf: run r = (p_in, start
// offset s_r, tile offset t_r, length L_r) puts x[c, p_in, q0 + s_r + k] at
// buf[c * chan + t_r + k] for k in [0, L_r), one warp per (channel, run),
// its lanes along 16-byte chunks.  Values outside [0, sp) are not copied:
// no route entry reads them (the sum skips those terms).  vec: 16-byte
// copies are aligned (the field's base is, and sp is a multiple of 4).
template <int kCx>
__device__ __forceinline__ void stage_runs(float* buf, const float* __restrict__ x,
                                           size_t xchan, const int4* __restrict__ runs,
                                           int nruns, int chan, int q0, int sp, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < kCx * nruns; u += kStreamWarps) {
    const int c = u / nruns;
    const int4 r = runs[u - c * nruns];
    const float* src = x + c * xchan + static_cast<size_t>(r.x) * sp;
    float* dst = buf + c * chan + r.z;
    const int g0 = q0 + r.y;
    for (int k = 4 * lane; k < r.w; k += 128) {
      const int g = g0 + k;
      if (vec && g >= 0 && g + 4 <= sp) {
        cp_async16(dst + k, src + g);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (g + v >= 0 && g + v < sp) cp_async4(dst + k + v, src + g + v);
        }
      }
    }
  }
}

// sroute: kHeads ints, heads[2 p + t] .. heads[2 p + t + 1] the entries of
// class p's table t (t = 0, 1; heads[16] = total), then per entry (plane j,
// input class p_in, shift dq, spos) as an int4, spos the staged position
// of x[0, p_in, q0 + dq] (channel c at + c * chan).  runs: (p_in, s, t, L)
// per run (stage_runs).  sched: kStreamWarps + 1 offsets, then the items
// p * kSegs + g (class p, its g-th kSegQ q of the block); warp w sums items
// [sched[w], sched[w + 1]) of the list.
template <int kCx, int kCw>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocks) parity_apply_streamed_kernel(
    const float* __restrict__ w1, int cw1, int m1,
    const float* __restrict__ w2, int cw2, int m2,
    const float* __restrict__ x, int px,
    const int* __restrict__ sroute, const int4* __restrict__ runs, int nruns, int chan,
    const int* __restrict__ sched,
    float* __restrict__ y, int co, int sp) {
  extern __shared__ __align__(16) float tile[];
  const int n_blocks = (sp + kStreamQ - 1) / kStreamQ;
  int b = blockIdx.x;
  if (b >= n_blocks) return;                  // whole CTA: no barrier is left waiting
  const size_t plane = static_cast<size_t>(sp);
  const size_t xchan = static_cast<size_t>(px) * plane;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (sp & 3) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = sched[warp], k1 = sched[warp + 1];
  const int* items = sched + kStreamWarps + 1;
  const int4* ents = reinterpret_cast<const int4*>(sroute + kHeads);
  // route entries loaded together: 8 shared weights, or 4 x 3 per-channel ones
  constexpr int kUnroll = kCw == 1 ? 8 : 4;

  for (; b < n_blocks; b += gridDim.x) {
    stage_runs<kCx>(tile, x, xchan, runs, nruns, chan, b * kStreamQ, sp, vec);
    cp_async_commit();
    cp_async_wait_all();                      // this thread's copies
    __syncthreads();                          // ... and every other thread's
    for (int k = k0; k < k1; ++k) {
      const int item = items[k];
      const int p = item / kSegs;
      const int i = (item - p * kSegs) * kSegQ + lane * kStreamThreadQ;   // q - q0
      const int q = b * kStreamQ + i;
      if (q >= sp) continue;
      float acc[kStreamThreadQ][kMaxCo] = {};
      for (int tab = 0; tab < 2; ++tab) {
        const int lo = sroute[2 * p + tab], n = sroute[2 * p + tab + 1] - lo;
        const float* w = tab ? w2 : w1;
        if (kCw == 1 || (tab ? cw2 : cw1) == 1) {
          sum_table<kUnroll, kCx, true, kStreamThreadQ, false>(acc, ents + lo, n, w, plane, 0, q,
                                                               tile, chan, i, sp, co);
        } else {
          sum_table<kUnroll, kCx, false, kStreamThreadQ, false>(
              acc, ents + lo, n, w, plane, static_cast<size_t>(tab ? m2 : m1) * plane, q, tile,
              chan, i, sp, co);
        }
      }
      store<kStreamThreadQ>(y, acc, p, q, plane, co);
    }
    __syncthreads();                          // every read of the tile is done before
  }                                           // it is restaged
}

// Whether the weight tables hold kQ-float vectors at q multiples of kQ.
template <int kQ>
bool vector_aligned(const float* w1, const float* w2, int sp) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  return sp % kQ == 0 && a % (kQ * sizeof(float)) == 0;
}

int launch(const float* w1, int cw1, int m1, const float* w2, int cw2, int m2,
           const float* x, int cx, int px, const int* route, float* y, int co,
           int sp, void* stream) {
  if (co < 1 || co > kMaxCo || (cx != 1 && cx != co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((sp + kThreads - 1) / kThreads, kClasses);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cx == 1) {
    parity_apply_kernel<1><<<grid, kThreads, 0, s>>>(w1, cw1, m1, w2, cw2, m2, x, px, route, y,
                                                     co, sp);
  } else {
    parity_apply_kernel<kMaxCo><<<grid, kThreads, 0, s>>>(w1, cw1, m1, w2, cw2, m2, x, px,
                                                          route, y, co, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int parity_apply_f32(const float* w1, int cw1, int m1,
                                const float* w2, int cw2, int m2,
                                const float* x, int cx, int px,
                                const int* route, float* y, int co, int sp,
                                void* stream) {
  return launch(w1, cw1, m1, w2, cw2, m2, x, cx, px, route, y, co, sp, stream);
}

namespace {

// The streamed launch of one instantiation.  Per device and instantiation:
// the dynamic shared memory it is allowed so far, and the grid (CTAs an SM
// x SMs) of the last staged-tile size asked for.
template <int kCx, int kCw>
int launch_streamed(const float* w1, int cw1, int m1, const float* w2, int cw2, int m2,
                    const float* x, int px, const int* sroute, const int* runs,
                    int nruns, int chan, const int* sched, float* y, int co, int sp,
                    void* stream) {
  static int smem_allowed[kMaxDev], plan_stage[kMaxDev], plan_blocks[kMaxDev];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDev) return static_cast<int>(cudaErrorInvalidDevice);
  const int stage = kCx * chan * static_cast<int>(sizeof(float));
  if (plan_blocks[dev] == 0 || plan_stage[dev] != stage) {
    int optin = 0, sms = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (stage > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (smem_allowed[dev] < optin) {
      e = cudaFuncSetAttribute(parity_apply_streamed_kernel<kCx, kCw>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_allowed[dev] = optin;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, parity_apply_streamed_kernel<kCx, kCw>, kStreamThreads, stage);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    plan_blocks[dev] = per_sm * sms;
    plan_stage[dev] = stage;
  }
  const int n_blocks = (sp + kStreamQ - 1) / kStreamQ;
  const int grid = n_blocks < plan_blocks[dev] ? n_blocks : plan_blocks[dev];
  if (grid < 1) return static_cast<int>(cudaSuccess);
  parity_apply_streamed_kernel<kCx, kCw><<<grid, kStreamThreads, stage,
                                           static_cast<cudaStream_t>(stream)>>>(
      w1, cw1, m1, w2, cw2, m2, x, px, sroute, reinterpret_cast<const int4*>(runs), nruns,
      chan, sched, y, co, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The streamed form.  stream_q, warps and thread_q must be the kernel's
// kStreamQ, kStreamWarps and kStreamThreadQ (the wrapper built the staged
// positions and the schedule with them); the launch is refused otherwise,
// and when one staged tile does not fit a block's shared memory.  chan: the
// staged values per channel (a multiple of 4).
extern "C" int parity_apply_streamed_f32(const float* w1, int cw1, int m1,
                                         const float* w2, int cw2, int m2,
                                         const float* x, int cx, int px,
                                         const int* sroute, const int* runs, int nruns,
                                         int chan, const int* sched, int stream_q, int warps,
                                         int thread_q, float* y, int co, int sp, void* stream) {
  if (co < 1 || co > kMaxCo || (cx != 1 && cx != co) || nruns < 0 || (chan & 3) != 0 ||
      stream_q != kStreamQ || warps != kStreamWarps || thread_q != kStreamThreadQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!vector_aligned<kStreamThreadQ>(w1, w2, sp)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const bool shared = cw1 == 1 && (m2 == 0 || cw2 == 1);
  if (cx == 1) {
    return shared ? launch_streamed<1, 1>(w1, cw1, m1, w2, cw2, m2, x, px, sroute, runs, nruns,
                                          chan, sched, y, co, sp, stream)
                  : launch_streamed<1, kMaxCo>(w1, cw1, m1, w2, cw2, m2, x, px, sroute, runs,
                                               nruns, chan, sched, y, co, sp, stream);
  }
  return shared ? launch_streamed<kMaxCo, 1>(w1, cw1, m1, w2, cw2, m2, x, px, sroute, runs,
                                             nruns, chan, sched, y, co, sp, stream)
                : launch_streamed<kMaxCo, kMaxCo>(w1, cw1, m1, w2, cw2, m2, x, px, sroute, runs,
                                                  nruns, chan, sched, y, co, sp, stream);
}
