// parity_apply: the class-major (parity-split) window apply on Hopper.
//
// Replaces the TPU kernel cfd_with_cuda_tpu/ops/parity_stencil.py::
// parity_apply in both of its field forms:
//
// * resident field (parity_apply_kernel): one weight table (pallas_call at
//   :432, the K u* and G p applies) and two weight tables (pallas_call at
//   :406, (K + A(un)) u* with the per-step convection planes as the second
//   table);
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
// forms agree bit for bit, as the two Pallas forms do.
//
// What bounds both: the weight stream.  Every weight plane is read once
// (NE27000 f32: 512 planes x 30720 = 63 MB for K, 125 x 3 planes = 46 MB
// for G, 1241 planes = 152 MB for K + A; NE85184 at Sp = 92160: 189 MB for
// K, 457 MB for K + A), coalesced along q.
//
// Resident design: one thread per (class p, coarse q); neighbouring threads
// take neighbouring q, so every weight-plane read and every shifted field
// read is coalesced along q.  The field (NE27000: 3 x 8 x 30720 = 2.9 MB)
// stays in the 50 MB L2 and is re-read per plane from there.  A thread
// keeps its (up to 3) output channels in registers and reads each shared
// weight once for all channels.  The route (a few hundred int entries per
// class) is read uniformly by a warp, so it is served by broadcast from L1.
//
// Streamed design.  The TPU kernel DMAs the whole halo-extended block
// x[:, :, s0 : s0 + blk + 2 halo + 128] into VMEM per grid step: at NE85184
// that is 3 x 8 x (256 + 4352 + 128) x 4 B = 454 KB even at blk 256, twice
// what a Hopper block may hold (227 KB).  What the route reads is much
// less: every shift is a coarse shift dq = dx + dy cx + dz cx cy with dx,
// dy, dz in {-1, 0, 1}, so a block of kStreamQ consecutive q reads, per
// input class, at most 9 runs of kStreamQ + 2 values per channel.  The
// wrapper groups each input class's shifts into runs [lo, lo + kRunSpan]
// (any route: a run is only a staging unit) and rewrites every route entry
// as (table, j, dq, position of x[., p_in, q0 + dq] in the staged runs).
// Mapping: one CTA of 8 x kStreamQ threads (thread = (output class p, q)
// as in the resident kernel) walks the q blocks blockIdx.x, +gridDim.x, ...;
// it copies the runs of the next block into the other half of a
// double-buffered shared tile with cp.async (4-byte copies: a run starts at
// any q) while it sums the current block from shared memory.  All 8 output
// classes share one staged tile, so each run is read from L2 once per
// block.  At kStreamQ = 64 the K and K + A routes stage 72 runs: 3 x 72 x
// 66 x 4 B = 57 KB a buffer, 114 KB both, two CTAs (1024 threads) per SM.
// The weights still stream once from HBM, coalesced along q; the field now
// comes from shared memory instead of L1/L2.  With half the resident
// kernel's threads per SM (the tile's shared memory allows two CTAs), a
// thread keeps more weight loads in flight instead: it loads the weights
// of kUnroll route entries together, then adds the terms in route order.
// Simple and correct first: the 8 output classes of a CTA meet at a
// barrier per block while their routes differ in length (K: 125 entries
// for class 0, 27 for class 7), so the CTA runs at its longest class;
// balancing the classes across warps is tuning work, as are the 4-byte
// copies.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCo = 3;
constexpr int kClasses = 8;
constexpr int kStreamQ = 64;                       // q per staged block
constexpr int kRunSpan = 2;                        // a run holds dq in [lo, lo + 2]
constexpr int kRunLen = kStreamQ + kRunSpan;       // staged values per run and channel
constexpr int kStreamThreads = kClasses * kStreamQ;
constexpr int kMaxDev = 16;

// One term of a route, the same arithmetic in both forms: a weight shared
// over the channels (cw = 1: K, K + A, MK + A, M) as one fused multiply-add,
// a per-channel weight (G) as the product rounded, then added.  That is what
// the resident kernel's earlier source compiled to, so its results are kept
// bit for bit.  Both kernels branch on the table's kind per route entry
// (uniform over a warp).
template <bool kShared>
__device__ __forceinline__ float madd(float acc, float w, float x) {
  return kShared ? __fmaf_rn(w, x, acc) : __fadd_rn(acc, __fmul_rn(w, x));
}

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
    if (cw == 1) {
#pragma unroll
      for (int c = 0; c < kMaxCo; ++c) {
        if (c < co) acc[c] = madd<true>(acc[c], w0, (cx == 1) ? x0 : xq[c * xstride]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kMaxCo; ++c) {
        if (c < co) {
          acc[c] = madd<false>(acc[c], wj[c * wstride], (cx == 1) ? x0 : xq[c * xstride]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCo; ++c) {
    if (c < co) y[(static_cast<size_t>(c) * kClasses + p) * plane + q] = acc[c];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy the runs of the block starting at q0 into buf: staged value
// (c, run r, k) at buf[(c * nruns + r) * kRunLen + k] = x[c, p_in_r, q0 +
// lo_r + k], one warp per (channel, run), its lanes along k.  Values outside
// [0, sp) are not copied: no route entry uses them (the sum skips those
// terms, as the resident kernel does).
__device__ __forceinline__ void stage_runs(float* buf, const float* __restrict__ x,
                                           size_t xstride, const int* __restrict__ runs,
                                           int nruns, int cx, int q0, int sp) {
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < cx * nruns; u += kStreamThreads / 32) {
    const int c = u / nruns;
    const int r = u - c * nruns;
    const float* src = x + c * xstride + static_cast<size_t>(runs[2 * r]) * sp;
    const int g0 = q0 + runs[2 * r + 1];
    for (int k = lane; k < kRunLen; k += 32) {
      const int g = g0 + k;
      if (g >= 0 && g < sp) cp_async4(buf + u * kRunLen + k, src + g);
    }
  }
}

// One route entry of the streamed kernel with its weights loaded (kCw of
// them: 1 where every table shares its weights over the channels, as K,
// K + A, MK + A and M do), the staged position of its field value, and
// whether q + dq lies in [0, sp).  The weight load is in bounds whatever dq
// (it is read at q); the staged value is read when the term is added.
template <int kCw>
struct Term {
  float w[kCw];
  int spos;
  bool ok;
  bool shared;                                // cw == 1 for this term's table
};

template <int kCw>
__device__ __forceinline__ Term<kCw> load_term(const int* __restrict__ r, int q, int sp,
                                               size_t plane, const float* __restrict__ w1,
                                               int cw1, int m1, const float* __restrict__ w2,
                                               int cw2, int m2, int co) {
  Term<kCw> t;
  const int tab = r[0], j = r[1], dq = r[2];
  t.spos = r[3];
  t.ok = static_cast<unsigned>(q + dq) < static_cast<unsigned>(sp);
  const float* wj = (tab ? w2 : w1) + static_cast<size_t>(j) * plane + q;
  t.shared = kCw == 1 || (tab ? cw2 : cw1) == 1;
  t.w[0] = wj[0];
#pragma unroll
  for (int c = 1; c < kCw; ++c) {
    const size_t wstride = static_cast<size_t>(tab ? m2 : m1) * plane;
    if (c < co) t.w[c] = t.shared ? t.w[0] : wj[c * wstride];
  }
  return t;
}

template <int kCw>
__device__ __forceinline__ void add_term(float* acc, const Term<kCw>& t, const float* xs,
                                         int i, int chan, int cx, int co) {
  if (!t.ok) return;                          // zero field outside [0, sp)
  const float* xq = xs + t.spos + i;
  const float x0 = xq[0];
  if (t.shared) {
#pragma unroll
    for (int c = 0; c < kMaxCo; ++c) {
      if (c < co) acc[c] = madd<true>(acc[c], t.w[0], (cx == 1) ? x0 : xq[c * chan]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kMaxCo; ++c) {
      if (c < co) {
        acc[c] = madd<false>(acc[c], t.w[kCw == 1 ? 0 : c], (cx == 1) ? x0 : xq[c * chan]);
      }
    }
  }
}

// sroute: the route as the resident kernel's, each entry (table, j, dq,
// spos) with spos the staged position of x[., p_in, q0 + dq] in channel 0;
// runs: (p_in, lo) per run.  The entries' weights are loaded kUnroll at a
// time (their loads in flight together) and the terms summed in route order.
template <int kCw>
__global__ void __launch_bounds__(kStreamThreads, 2) parity_apply_streamed_kernel(
    const float* __restrict__ w1, int cw1, int m1,
    const float* __restrict__ w2, int cw2, int m2,
    const float* __restrict__ x, int cx, int px,
    const int* __restrict__ sroute, const int* __restrict__ runs, int nruns,
    float* __restrict__ y, int co, int sp) {
  extern __shared__ float tile[];
  const int n_blocks = (sp + kStreamQ - 1) / kStreamQ;
  int b = blockIdx.x;
  if (b >= n_blocks) return;                  // whole CTA: no barrier is left waiting
  const int chan = nruns * kRunLen;           // channel stride of a staged buffer
  const int stage = cx * chan;                // one buffer; buffer k at tile + k * stage
  const size_t plane = static_cast<size_t>(sp);
  const size_t xstride = static_cast<size_t>(px) * plane;
  const int p = threadIdx.x / kStreamQ;
  const int i = threadIdx.x - p * kStreamQ;
  const int e_begin = sroute[p], e_end = sroute[p + 1];
  const int* ents = sroute + (kClasses + 1);
  // route entries loaded together: 8 shared weights, or 4 x 3 per-channel
  // ones, within the 64-register cap of two CTAs per SM without spills
  constexpr int kUnroll = kCw == 1 ? 8 : 4;

  stage_runs(tile, x, xstride, runs, nruns, cx, b * kStreamQ, sp);
  cp_async_commit();
  for (int it = 0; b < n_blocks; ++it, b += gridDim.x) {
    const int nb = b + gridDim.x;
    if (nb < n_blocks) stage_runs(tile + ((it + 1) & 1) * stage, x, xstride, runs, nruns, cx,
                                  nb * kStreamQ, sp);
    cp_async_commit();                        // possibly empty: the wait below stays uniform
    cp_async_wait_all_but_one();              // this block's runs (this thread's copies)
    __syncthreads();                          // ... and every other thread's
    const float* xs = tile + (it & 1) * stage;
    const int q = b * kStreamQ + i;
    if (q < sp) {
      float acc[kMaxCo];
#pragma unroll
      for (int c = 0; c < kMaxCo; ++c) acc[c] = 0.0f;
      int e = e_begin;
      for (; e + kUnroll <= e_end; e += kUnroll) {
        Term<kCw> t[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          t[u] = load_term<kCw>(ents + 4 * (e + u), q, sp, plane, w1, cw1, m1, w2, cw2, m2, co);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_term<kCw>(acc, t[u], xs, i, chan, cx, co);
      }
      for (; e < e_end; ++e) {
        add_term<kCw>(acc, load_term<kCw>(ents + 4 * e, q, sp, plane, w1, cw1, m1, w2, cw2, m2,
                                          co), xs, i, chan, cx, co);
      }
#pragma unroll
      for (int c = 0; c < kMaxCo; ++c) {
        if (c < co) y[(static_cast<size_t>(c) * kClasses + p) * plane + q] = acc[c];
      }
    }
    __syncthreads();                          // every read of this buffer is done before
  }                                           // the next iteration restages it
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

// The streamed launch of one instantiation.  Per device: the dynamic shared
// memory it is allowed so far, and the grid of the last shared-memory size
// asked for.
template <int kCw>
int launch_streamed(const float* w1, int cw1, int m1, const float* w2, int cw2, int m2,
                    const float* x, int cx, int px, const int* sroute, const int* runs,
                    int nruns, float* y, int co, int sp, void* stream) {
  static int smem_allowed[kMaxDev], grid_smem[kMaxDev], grid_blocks[kMaxDev];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDev) return static_cast<int>(cudaErrorInvalidDevice);
  const int smem = 2 * cx * nruns * kRunLen * static_cast<int>(sizeof(float));
  if (smem > smem_allowed[dev]) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaFuncSetAttribute(parity_apply_streamed_kernel<kCw>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed[dev] = optin;
  }
  if (grid_blocks[dev] == 0 || grid_smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, parity_apply_streamed_kernel<kCw>,
                                                      kStreamThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_blocks[dev] = per_sm * sms;
    grid_smem[dev] = smem;
  }
  const int n_blocks = (sp + kStreamQ - 1) / kStreamQ;
  const int grid = n_blocks < grid_blocks[dev] ? n_blocks : grid_blocks[dev];
  if (grid < 1) return static_cast<int>(cudaSuccess);
  parity_apply_streamed_kernel<kCw><<<grid, kStreamThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      w1, cw1, m1, w2, cw2, m2, x, cx, px, sroute, runs, nruns, y, co, sp);
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

// The streamed form.  run_len must be the kernel's kRunLen (the wrapper
// built the staged positions with it); the launch is refused otherwise, and
// when the staged tile does not fit a block's shared memory.
extern "C" int parity_apply_streamed_f32(const float* w1, int cw1, int m1,
                                         const float* w2, int cw2, int m2,
                                         const float* x, int cx, int px,
                                         const int* sroute, const int* runs, int nruns,
                                         int run_len, float* y, int co, int sp,
                                         void* stream) {
  if (co < 1 || co > kMaxCo || cx < 1 || cx > kMaxCo || nruns < 0 || run_len != kRunLen) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cw1 == 1 && (m2 == 0 || cw2 == 1)) {
    return launch_streamed<1>(w1, cw1, m1, w2, cw2, m2, x, cx, px, sroute, runs, nruns, y, co,
                              sp, stream);
  }
  return launch_streamed<kMaxCo>(w1, cw1, m1, w2, cw2, m2, x, cx, px, sroute, runs, nruns, y,
                                 co, sp, stream);
}
