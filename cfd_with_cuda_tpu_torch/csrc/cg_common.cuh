// Shared device code of the pressure-CG kernels (cg_solve.cu, cg_iter.cu):
// the window apply in its full and symmetric-half forms, the deterministic
// grid-wide reductions in their plain (f32) and compensated (f64) forms, one
// CG iteration, and the cooperative launch.
//
// Window apply, full form (replaces pallas_cg.py::_apply_window, :230):
//   (Z v)[i] = sum_w win[w, i] * v[i + offs[w]],  v zero outside [0, n),
// one FMA a slot, acc = fma(win[w, i], v, acc) in slot order (what the
// per-iteration build's `acc += w * v` compiled to).  The offsets are any
// static list: a box grid's W^3 window, or the banded window of an
// unstructured pressure operator (ops/banded.py; replaces
// pallas_cg.py::fused_cg(offs=...), :478-492, at NE144600 BFS scale 275 slots
// up to +-7,390 over n = 147,477 rows).  The weight row offset is a size_t
// (275 x 147,477 = 40.6M entries per table).
//
// Symmetric-half form (replaces _apply_window's sym branch, :262-283): the
// weights are the (nw, n) dq >= 0 half of a symmetric window, offs[0] = 0 and
// offs[m] > 0 after it, and each positive offset is used both ways.  The
// TPU body scatters w[q] * x[q] into a back-buffer at q + dq; here every row
// GATHERS its own terms, so there are no atomics and the order is fixed:
//   ap[i] =  sum_{m>=0} win[m, i]      * v[i + dq_m]       (i + dq_m < n)
//          + sum_{m>0}  win[m, i-dq_m] * v[i - dq_m]       (i - dq_m >= 0)
// a forward FMA chain in slot order, a back chain in slot order, then
// fwd + back (the order of the TPU body: its back-buffer is added once at
// the end).
//
// How the apply is fed.  One thread owns a row (the FMA chain is serial), so
// the slot loop is a chain of loads; the offsets sit in shared memory,
// loaded once per launch.  The columns of p that a block's 256 rows read,
// merged into clusters (5 for a 125-slot box window: 1,920 floats at
// NE27000 and 2,200 at NE85184, against spans of 4,228 and 8,540; 5 for the
// BFS band, 3,256), are staged once per apply in shared memory with 16-byte
// __ldcg loads (through L2: other blocks wrote p in this launch, and L1 is
// not coherent across SMs), and every slot reads v there; the weights
// stream through a per-thread ring in shared memory (4 or 2 stages of
// kRingVals weights, the deeper where it keeps the grid's block count;
// 4-byte cp.async: the table is read-only, so going through L1 is safe),
// (stages - 1) * kRingVals weights in flight a thread, the next apply's
// first stages issued before the grid barrier that precedes it.  The CG
// kernels always stage: a window whose clusters fit no block is refused at
// launch.  The apply alone (window_apply_sym) reads v and the weights from
// global memory, a chunk's loads before its FMAs (Window::apply_direct).
// Reductions (replace _plain_dot :226 and _comp_dot :194): each thread
// accumulates its rows (one FMA a term), each block reduces in a fixed tree
// and writes its partial to a fixed slot, and after a grid barrier EVERY
// block sums all partials in the same order, so every block holds bitwise
// the same scalar and a run repeats bit for bit.  COMP = false accumulates in
// f32.  COMP = true is _comp_dot's contract, not its double-single tree: the
// product of two f32 values is exact in f64 (24 + 24 <= 53 bits), so f64
// thread accumulators, an f64 block tree and f64 partials, rounded to f32
// once at the end, give the f64 dot of the f32 inputs.  The block tree's last
// five levels run as warp shuffles, and the grid total's loads are issued in
// batches, each sum kept in its order.
//
// One iteration (Engine::iteration) is cg_solve's loop body and cg_iter's:
//   ap = Z p_k, p_k.ap        | grid barrier | alpha = rz / p.ap
//   x += alpha p_k, r -= alpha ap, z = r dinv, r.z, r.r | grid barrier
//   beta = rz' / rz           (p_{k+1} = z + beta p_k is formed by the next)
// p ping-pongs between two rows of the work buffer by iteration parity.
// Each block forms p_k = fma(beta, p_{k-1}, z) over its clusters while
// staging them (every block holds beta bitwise, so a neighbour's values are
// the owner's), and writes only its own rows of p_k: two grid barriers an
// iteration.  The races, iteration k:
// * p_k is written (own rows, P[k%2]) in phase A(k) and read in phase B(k)
//   by its owner only; P[k%2] last held p_{k-2}, read in phase A(k-1),
//   which barrier B1(k-1) ends;
// * p_{k-1} (P[(k-1)%2]) and z_k are read across clusters in phase A(k), after
//   B2(k-1) ordered their writes (phases A(k-1) and B(k-1));
// * z_{k+1} overwrites z_k in phase B(k), after B1(k) ended every read of z_k;
// * ap has a row of its own, so writing it in phase A(k) touches no value a
//   neighbour still reads; x and r are only ever touched by their owner;
// * partials: p.ap in [0, nb), r.z and r.r in [nb, 3nb), the start's three
//   in [3nb, 6nb); a range is written only after the barrier that ends the
//   reads of its last totals.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cgk {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;   // wrappers size the partial buffers by it
constexpr int kWorkRows = 5;       // work buffer rows: r, z, ap, p0, p1 (stride ld)
constexpr int kRingVals = 8;       // weights a thread copies per ring stage
constexpr int kStageFloats = kRingVals * kThreads;   // one ring stage: 8 KB
constexpr int kPrefetch = 3;       // ring stages issued before the barrier ahead of an apply
// ring depths a launch may take (the deeper where it keeps the grid's blocks)
constexpr int kRingDepths[2] = {4, 2};

// wait until at most the `stages - 1` newest copy groups of the thread are
// in flight (cp.async.wait_group takes an immediate)
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages == 4) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <bool COMP> struct Acc { using type = float; };
template <> struct Acc<true> { using type = double; };

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-35f ? a / b : 0.0f;
}

// acc + a * b, one rounding: f32 one FMA; f64 the exact product added once
__device__ __forceinline__ float dot_fma(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}
__device__ __forceinline__ double dot_fma(float a, float b, double acc) {
  return __fma_rn(static_cast<double>(a), static_cast<double>(b), acc);
}

// Sum NV per-thread values over the block in a fixed tree (h = 128, 64, 32,
// ..., 1: value[t] += value[t + h]); thread 0 writes value k to out[k * stride].
template <typename A, int NV>
__device__ __forceinline__ void block_partials(const A (&v)[NV], A* red, A* out, int stride) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NV; ++k) red[k * kThreads + t] = v[k];
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 64; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < NV; ++k) red[k * kThreads + t] += red[k * kThreads + t + h];
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      A s = red[k * kThreads + t] + red[k * kThreads + t + 32];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (t == 0) out[k * stride] = s;
    }
  }
  __syncthreads();
}

// Every block: total of NV partial arrays (nb entries each, stride nb), in
// a fixed order (lane t sums entries t, t + 32, ... in turn, then a fixed
// shuffle tree), rounded to f32 once.  Broadcast to all threads.
template <typename A, int NV>
__device__ __forceinline__ void grid_totals(const A* part, int nb, float* bcast,
                                            float (&res)[NV]) {
  constexpr int kBatch = 8 / NV;
  const int t = threadIdx.x;
  if (t < 32) {
    A s[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) s[k] = A(0);
    for (int b0 = t; b0 < nb; b0 += 32 * kBatch) {
      A v[NV][kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          v[k][u] = b0 + 32 * u < nb ? __ldcg(part + k * nb + b0 + 32 * u) : A(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (b0 + 32 * u < nb) s[k] += v[k][u];
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
      if (t == 0) bcast[k] = static_cast<float>(s[k]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) res[k] = bcast[k];
  __syncthreads();
}

// The staged clusters of a window (ops/fused_cg.py::stage_clusters builds the
// table).  Row t of a block of rows [i0, i0 + 256) reads v at i0 + t + d for
// every offset d it uses; those columns, merged into K clusters of whole
// 16-byte vectors, are staged back to back, and v(i0 + t + d) sits at
// sv[t + pos(d)].  The table (ints): K, the staged float4 count, pos(0),
// the K clusters' first columns relative to i0, their K + 1 starts in the
// staged array, pos of each slot's offset, and under SYM pos of each slot's
// mirrored offset.
struct StageTab {
  const int* t;
  __device__ __forceinline__ int clusters() const { return t[0]; }
  __device__ __forceinline__ int vecs() const { return t[1]; }
  __device__ __forceinline__ int center() const { return t[2]; }
  __device__ __forceinline__ const int* first() const { return t + 3; }
  __device__ __forceinline__ const int* base() const { return t + 3 + t[0]; }
  __device__ __forceinline__ const int* fwd() const { return t + 4 + 2 * t[0]; }
  __device__ __forceinline__ const int* back(int nw) const { return t + 4 + 2 * t[0] + nw; }
};

// Stage v over the block's clusters into sv (zero outside [0, n)):
// UPDATE = false: v = a; UPDATE = true: v = fma(beta, a, z), the CG direction
// p_k from p_{k-1} and z_k.  vec: a and z 16-byte aligned.
template <bool UPDATE>
__device__ __forceinline__ float stage_one(const float* a, const float* z, float beta, int c) {
  return UPDATE ? __fmaf_rn(beta, __ldcg(a + c), __ldcg(z + c)) : __ldcg(a + c);
}

template <bool UPDATE>
__device__ void stage(float* sv, int i0, StageTab st, const float* a, const float* z,
                      float beta, int n, bool vec) {
  constexpr int kU = 4;
  const int nvec = st.vecs();
  const int* first = st.first();
  const int* base = st.base();
  int k = 0;   // the cluster of this thread's current vector (indices rise)
  for (int q0 = threadIdx.x; q0 < nvec; q0 += kU * kThreads) {
    float4 val[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q4 = q0 + u * kThreads;
      if (q4 >= nvec) continue;
      while (4 * q4 >= base[k + 1]) ++k;
      const int q = i0 + first[k] + 4 * q4 - base[k];
      if (vec && q >= 0 && q + 4 <= n) {
        const float4 pa = __ldcg(reinterpret_cast<const float4*>(a + q));
        if (UPDATE) {
          const float4 zz = __ldcg(reinterpret_cast<const float4*>(z + q));
          val[u] = make_float4(__fmaf_rn(beta, pa.x, zz.x), __fmaf_rn(beta, pa.y, zz.y),
                               __fmaf_rn(beta, pa.z, zz.z), __fmaf_rn(beta, pa.w, zz.w));
        } else {
          val[u] = pa;
        }
      } else {
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          e[j] = (q + j >= 0 && q + j < n) ? stage_one<UPDATE>(a, z, beta, q + j) : 0.0f;
        val[u] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q0 + u * kThreads < nvec) reinterpret_cast<float4*>(sv)[q0 + u * kThreads] = val[u];
  }
}

// The launch's dynamic shared memory: the weight ring (stages x kStageFloats),
// the staged clusters, the offsets, the stage table.
extern __shared__ __align__(16) unsigned char cg_dsm[];

// The window of a launch: the weight table, the offsets in shared memory and
// the thread's weight ring.
template <bool SYM>
struct Window {
  static constexpr int kVals = SYM ? 2 : 1;           // weights a slot: forward (, back)
  static constexpr int kSlots = kRingVals / kVals;    // slots a ring stage
  const float* __restrict__ win;
  int nw, n, chunks, stages, offs_byte;     // stages: ring depth; offs_byte: the offsets in cg_dsm

  __device__ Window(const float* w, int nw_, int n_, int stages_, int offs_byte_)
      : win(w), nw(nw_), n(n_), chunks((nw_ + kSlots - 1) / kSlots), stages(stages_),
        offs_byte(offs_byte_) {}

  __device__ __forceinline__ float* ring() const { return reinterpret_cast<float*>(cg_dsm); }
  __device__ __forceinline__ const int* soffs() const {
    return reinterpret_cast<const int*>(cg_dsm + offs_byte);
  }

  // copy chunk c's weights of row i into its ring stage: one commit group
  // (empty past the last chunk or for a row past n)
  __device__ __forceinline__ void issue(int c, int i) const {
    if (c < chunks && i < n) {
      float* dst = ring() + (c & (stages - 1)) * kStageFloats + threadIdx.x;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int w = c * kSlots + s;
        if (w < nw) {
          const float* row = win + static_cast<size_t>(w) * n;
          __pipeline_memcpy_async(dst + kVals * s * kThreads, row + i, sizeof(float));
          if (SYM) {
            const int dq = soffs()[w];
            if (dq > 0 && i - dq >= 0)
              __pipeline_memcpy_async(dst + (2 * s + 1) * kThreads, row + i - dq, sizeof(float));
          }
        }
      }
    }
    __pipeline_commit();
  }

  // chunks [from, to) of row i, to <= stages - 1 (the ring's prologue is
  // chunks [0, stages - 1))
  __device__ __forceinline__ void prologue(int i, int from, int to) const {
    for (int c = from; c < to; ++c) issue(c, i);
  }

  // chunk c + stages - 1 issued (into the stage chunk c - 1 left), chunk
  // c's weights arrived; its stage returned
  __device__ __forceinline__ const float* next(int c, int i) const {
    issue(c + stages - 1, i);
    wait_ring(stages);
    return ring() + (c & (stages - 1)) * kStageFloats + threadIdx.x;
  }

  // (Z v)[i] for v staged in shared memory: v(i + d) = svt[pos(d)], svt the
  // staged array advanced by the row's place in its block
  __device__ float apply_staged(int i, const float* svt, StageTab st) const {
    const int* fpos = st.fwd();
    const int* bpos = st.back(nw);
    float fwd = 0.0f, back = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const float* wr = next(c, i);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int w = c * kSlots + s;
        if (w < nw) {
          fwd = __fmaf_rn(wr[kVals * s * kThreads], svt[fpos[w]], fwd);
          if (SYM) {
            const int dq = soffs()[w];
            if (dq > 0 && i - dq >= 0) back = __fmaf_rn(wr[(2 * s + 1) * kThreads], svt[bpos[w]], back);
          }
        }
      }
    }
    return SYM ? fwd + back : fwd;
  }

  // (Z v)[i] reading the weights (__ldg: the table is read-only) and v
  // (__ldcg) from global memory, a chunk's loads issued before its FMAs (the
  // apply alone; no ring, stages = 0)
  __device__ float apply_direct(int i, const float* v) const {
    float fwd = 0.0f, back = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      float wv[kRingVals], vv[kRingVals];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int w = c * kSlots + s;
        wv[kVals * s] = vv[kVals * s] = 0.0f;
        if (SYM) wv[2 * s + 1] = vv[2 * s + 1] = 0.0f;
        if (w < nw) {
          const float* row = win + static_cast<size_t>(w) * n;
          const int dq = soffs()[w];
          wv[kVals * s] = __ldg(row + i);
          if (i + dq >= 0 && i + dq < n) vv[kVals * s] = __ldcg(v + i + dq);
          if (SYM && dq > 0 && i - dq >= 0) {
            wv[2 * s + 1] = __ldg(row + i - dq);
            vv[2 * s + 1] = __ldcg(v + i - dq);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int w = c * kSlots + s;
        if (w < nw) {
          fwd = __fmaf_rn(wv[kVals * s], vv[kVals * s], fwd);
          if (SYM) {
            const int dq = soffs()[w];
            if (dq > 0 && i - dq >= 0) back = __fmaf_rn(wv[2 * s + 1], vv[2 * s + 1], back);
          }
        }
      }
    }
    return SYM ? fwd + back : fwd;
  }
};

// Everything a CG kernel is given (one __grid_constant__ argument, read in
// place from the parameter space).
struct CgArgs {
  const float* win;
  const int* offs;
  const int* stab;       // the stage table
  const float* b;
  const float* dinv;
  const float* x0;       // null: cold start
  float* x;
  float* work;           // kWorkRows rows of stride ld
  void* part;            // 6 * kMaxBlocks partials (f64 under COMP)
  float* scal;           // cg_init / cg_iter: r.z, |r|, |b|
  int* k_out;            // cg_solve
  float* rn_out;         // cg_solve
  int nw, n, ld, maxiter, iters;
  int stab_ints, svecs;  // the stage table's length, the staged float4 count
  int stages;            // ring depth, set by the launcher
  float tol;
};

// Dynamic shared memory of a launch: the ring, the staged clusters, the
// offsets, the stage table.
__host__ __device__ __forceinline__ int offs_at(int stages, int svecs) {
  return static_cast<int>(sizeof(float)) * (stages * kStageFloats + 4 * svecs);
}
__host__ __device__ __forceinline__ int stab_at(int stages, int svecs, int nw) {
  return offs_at(stages, svecs) + static_cast<int>(sizeof(int)) * ((nw + 3) & ~3);
}
__host__ __device__ __forceinline__ size_t smem_bytes(int stages, int nw, int stab_ints, int svecs) {
  return stab_at(stages, svecs, nw) + sizeof(int) * stab_ints;
}

template <bool COMP, bool SYM>
struct Engine {
  using A = typename Acc<COMP>::type;
  const CgArgs& a;
  A* red;
  float* bcast;
  Window<SYM> zw;
  int pre;     // chunks of the block's first row already in the ring

  __device__ Engine(const CgArgs& args, A* red_, float* bcast_)
      : a(args), red(red_), bcast(bcast_),
        zw(args.win, args.nw, args.n, args.stages, offs_at(args.stages, args.svecs)), pre(0) {
    int* so = reinterpret_cast<int*>(cg_dsm + offs_at(args.stages, args.svecs));
    for (int j = threadIdx.x; j < args.nw; j += kThreads) so[j] = args.offs[j];
    int* st = reinterpret_cast<int*>(cg_dsm + stab_at(args.stages, args.svecs, args.nw));
    for (int j = threadIdx.x; j < args.stab_ints; j += kThreads) st[j] = args.stab[j];
    __syncthreads();
  }

  __device__ __forceinline__ float* row(int k) const { return a.work + static_cast<size_t>(k) * a.ld; }
  __device__ __forceinline__ float* pdir(int j) const { return row(3 + (j & 1)); }   // p0, p1
  __device__ __forceinline__ float* sv() const {
    return reinterpret_cast<float*>(cg_dsm) + a.stages * kStageFloats;
  }
  __device__ __forceinline__ StageTab tab() const {
    return StageTab{reinterpret_cast<const int*>(cg_dsm + stab_at(a.stages, a.svecs, a.nw))};
  }
  __device__ __forceinline__ int first_row() const { return blockIdx.x * kThreads + threadIdx.x; }
  __device__ __forceinline__ bool vec() const {
    return ((reinterpret_cast<uintptr_t>(a.work) | (static_cast<uintptr_t>(a.ld) * 4)) & 15) == 0;
  }

  // the first chunks of the block's next apply, issued ahead of what
  // precedes it (a few: what is issued before a grid barrier delays it)
  __device__ __forceinline__ void prefetch() {
    pre = min(kPrefetch, zw.stages - 1);
    zw.prologue(first_row(), 0, pre);
  }

  __device__ __forceinline__ void start_apply(int i) {
    zw.prologue(i, i == first_row() ? pre : 0, zw.stages - 1);
    pre = 0;
  }

  // r0 = b - Z x0 (x = x0) or r0 = b (x = 0); z0 = r0 dinv = p_0 (row p0);
  // tot = r.z, r.r, b.b (every block bitwise the same)
  __device__ void start(bool prefetch_next, float (&tot)[3]) {
    const float* __restrict__ x0 = a.x0;
    A v[3] = {A(0), A(0), A(0)};
    const int n = a.n, nb = gridDim.x;
    for (int tile = blockIdx.x; tile * kThreads < n; tile += nb) {
      const int i = tile * kThreads + threadIdx.x;
      float zx = 0.0f;
      if (x0 != nullptr) {
        stage<false>(sv(), tile * kThreads, tab(), x0, nullptr, 0.0f, n,
                     (reinterpret_cast<uintptr_t>(x0) & 15) == 0);
        __syncthreads();
        if (i < n) {
          start_apply(i);
          zx = zw.apply_staged(i, sv() + threadIdx.x, tab());
        }
        __syncthreads();
      }
      if (i < n) {
        const float bi = a.b[i];
        float ri;
        if (x0 != nullptr) {
          ri = bi - zx;
          a.x[i] = x0[i];
        } else {
          ri = bi;
          a.x[i] = 0.0f;
        }
        const float zi = ri * a.dinv[i];
        row(0)[i] = ri;
        pdir(0)[i] = zi;
        v[0] = dot_fma(ri, zi, v[0]);
        v[1] = dot_fma(ri, ri, v[1]);
        v[2] = dot_fma(bi, bi, v[2]);
      }
    }
    if (prefetch_next && x0 != nullptr) prefetch();
    A* part = static_cast<A*>(a.part);
    block_partials<A, 3>(v, red, part + 3 * nb + blockIdx.x, nb);
    cg::this_grid().sync();
    grid_totals<A, 3>(part + 3 * nb, nb, bcast, tot);
  }

  // Iteration j of this launch (j = 0: p_j is complete in p0); updates rz,
  // beta and rn (module note).
  __device__ void iteration(int j, bool prefetch_next, float& rz, float& beta, float& rn) {
    const int n = a.n, nb = gridDim.x;
    float* pc = pdir(j);
    const float* po = pdir(j + 1);
    const float* z = row(1);
    A* part = static_cast<A*>(a.part);
    const bool first = j == 0;
    {  // ---- phase A: ap = Z p_k, p_k.ap
      A v[1] = {A(0)};
      const int tiles = (n + kThreads - 1) / kThreads;
      for (int tile = blockIdx.x; tile < tiles; tile += nb) {
        const int i = tile * kThreads + threadIdx.x;
        if (first) stage<false>(sv(), tile * kThreads, tab(), pc, nullptr, 0.0f, n, vec());
        else stage<true>(sv(), tile * kThreads, tab(), po, z, beta, n, vec());
        __syncthreads();
        if (i < n) {
          start_apply(i);
          const float* svt = sv() + threadIdx.x;
          const float pk = svt[tab().center()];
          if (!first) pc[i] = pk;
          const float api = zw.apply_staged(i, svt, tab());
          row(2)[i] = api;
          v[0] = dot_fma(pk, api, v[0]);
        }
        if (tile + nb < tiles) __syncthreads();
      }
      block_partials<A, 1>(v, red, part + blockIdx.x, nb);
    }
    cg::this_grid().sync();
    float pap[1];
    grid_totals<A, 1>(part, nb, bcast, pap);
    const float alpha = safe_div(rz, pap[0]);
    {  // ---- phase B: x, r, z = r * dinv, r.z, r.r
      A v[2] = {A(0), A(0)};
      float* x = a.x;
      float* r = row(0);
      float* zr = row(1);
      const float* ap = row(2);
      for (int i = first_row(); i < n; i += nb * kThreads) {
        x[i] = __fmaf_rn(alpha, __ldcg(pc + i), __ldcg(x + i));
        const float ri = __fmaf_rn(-alpha, __ldcg(ap + i), __ldcg(r + i));
        r[i] = ri;
        const float zi = ri * a.dinv[i];
        zr[i] = zi;
        v[0] = dot_fma(ri, zi, v[0]);
        v[1] = dot_fma(ri, ri, v[1]);
      }
      if (prefetch_next) prefetch();
      block_partials<A, 2>(v, red, part + nb + blockIdx.x, nb);
    }
    cg::this_grid().sync();
    float rr[2];
    grid_totals<A, 2>(part + nb, nb, bcast, rr);
    beta = safe_div(rr[0], rz);
    rz = rr[0];
    rn = sqrtf(rr[1]);
  }

  // p_{k+1} = z + beta p_k into p0, own rows, after iteration j (the state
  // the next cg_iter launch starts from)
  __device__ void finish_direction(int j, float beta) {
    const float* pc = pdir(j);
    const float* z = row(1);
    float* p0 = pdir(0);
    for (int i = first_row(); i < a.n; i += gridDim.x * kThreads)
      p0[i] = __fmaf_rn(beta, __ldcg(pc + i), __ldcg(z + i));
  }
};

// The forms a CG kernel is built in: for 5 blocks an SM (<= 48 registers:
// the BFS band's 577 blocks on 132 SMs) and for 3 (<= 80 registers: no
// spills).
enum Form { kStaged5 = 0, kStaged3 = 1 };
constexpr int kForms[2] = {kStaged3, kStaged5};   // the plan's order of preference

// Launch plan: the grid is min(co-resident blocks, ceil(n / kThreads)) (the
// block count sets the dots' order).  Of the forms and ring depths (4 or 2
// stages) that keep the most blocks, the first in the order kStaged3,
// kStaged5, deeper rings first, is taken; a window whose stage table fits
// no block is refused.  Cached per kernel and shape.
struct Plan {
  int blocks = 0, form = kStaged3, stages = 0;
  size_t smem = 0;
};

template <typename K>
int occupancy_blocks(K kernel, size_t smem, int need, int sms, int dev, int* blocks) {
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  *blocks = 0;
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem + fa.sharedSizeBytes > static_cast<size_t>(optin)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *blocks = per_sm * sms < need ? per_sm * sms : need;
  return static_cast<int>(e);
}

// a CG kernel's two forms, by Form
template <typename K>
struct KernelSet {
  K k[2];
};

template <typename K>
int plan_launch(const KernelSet<K>& ks, int n, int nw, int stab_ints, int svecs, Plan* out) {
  const K* kernels = ks.k;
  struct Entry {
    const void* fn;
    int dev, n, nw, stab_ints, svecs;
    Plan plan;
  };
  constexpr int kCache = 16;
  static Entry cache[kCache];
  static int filled = 0, next = 0;
  if (svecs <= 0 || stab_ints <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* fn = reinterpret_cast<const void*>(kernels[0]);
  for (int c = 0; c < filled; ++c) {
    const Entry& en = cache[c];
    if (en.fn == fn && en.dev == dev && en.n == n && en.nw == nw && en.stab_ints == stab_ints &&
        en.svecs == svecs) {
      *out = en.plan;
      return 0;
    }
  }
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int need = (n + kThreads - 1) / kThreads;
  if (need > kMaxBlocks) need = kMaxBlocks;
  if (need < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  Plan best;
  for (int form : kForms) {
    for (int depth : kRingDepths) {
      const size_t smem = smem_bytes(depth, nw, stab_ints, svecs);
      int blocks = 0;
      const int err = occupancy_blocks(kernels[form], smem, need, sms, dev, &blocks);
      if (err != 0) return err;
      if (blocks > best.blocks) {
        best.blocks = blocks;
        best.form = form;
        best.stages = depth;
        best.smem = smem;
      }
    }
  }
  if (best.blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cache[next] = {fn, dev, n, nw, stab_ints, svecs, best};
  next = (next + 1) % kCache;
  if (filled < kCache) ++filled;
  *out = best;
  return 0;
}

// Cooperative launch of a CG kernel (its two forms, by Form), in the form,
// ring depth and grid of its plan.
template <typename K>
int cg_launch(const KernelSet<K>& ks, CgArgs a, void* stream) {
  if (a.stab == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int e = plan_launch(ks, a.n, a.nw, a.stab_ints, a.svecs, &p);
  if (e != 0) return e;
  a.stages = p.stages;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)ks.k[p.form], dim3(p.blocks),
                                                dim3(kThreads), args, p.smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, form, ring depth) of a CG kernel's plan, for the tools
template <typename K>
int report_plan(const KernelSet<K>& ks, int n, int nw, int stab_ints, int svecs, int* out) {
  Plan p;
  const int e = plan_launch(ks, n, nw, stab_ints, svecs, &p);
  if (e != 0) return e;
  out[0] = p.blocks;
  out[1] = p.form;
  out[2] = p.stages;
  return 0;
}

// Cooperative launch of a kernel without dynamic shared memory on
// min(co-resident blocks, ceil(n / kThreads), kMaxBlocks) blocks, or on
// exactly `blocks` when blocks > 0.
template <typename K>
int plain_coop_launch(K kernel, int n, int blocks, void** args, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int resident = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  if (blocks <= 0) {
    const int need = (n + kThreads - 1) / kThreads;
    blocks = need < resident ? need : resident;
  }
  if (blocks < 1 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgk
