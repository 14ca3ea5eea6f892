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
// Rows and field apart (the sharded path, parallel/sharded_stencil.py):
// every kernel writes ny rows s = y_org + r (r < ny; the weights and y are
// indexed by r) and reads the field x as the global positions x_org + j,
// j in [0, nx), zero outside: a rank's rows read its halo-extended block,
// whose x_org is its first row less the halo.  The single-device entry
// points pass x_org = y_org = 0 and nx = ny = n.
//
//   SPMV  W (nw, n), shared over the cx = C channels of x (1 or 3):
//         y[c, s] += W[k, s] * x[c, s + off]           (K, K + A, MK + A, M)
//   DIV   W (3, nw, n), x (3, n):
//         y[0, s] += (W[0,k,s] x[0,.] + W[1,k,s] x[1,.]) + W[2,k,s] x[2,.]
//   GRAD  (grad_compact_kernel) W (3, nk, n), x (1, n):
//         y[d, s] += W[d, j, s] * x[0, s + off_{c(s), j}],  j < count_{c(s)}
//   SPMV on the class-compacted, class-major table (spmv_compact_kernel,
//         what the solvers launch for K, K + A, MK + A and M):
//         y[c, s] += W_b[j, r] * x[c, s + off_{b, j}],  j < count_b
//         for the r-th row s of block b (below)
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
//
// SPMV on the class-compacted, class-major table.  The solvers' K, K + A,
// MK + A and M are Q2 operators: a row whose fine coordinate is even on an
// axis (a node on an element face line) couples to shifts -2..2 there, an
// odd one (inside one element) to -1..1, so a row of parity class c keeps
// 125, 75, 45 or 27 of the 125 slots for 0 to 3 odd axes, 51 % of the full
// table at NE27000 (ops/window_stencil.py::compact_spmv_window, which
// checks that every dropped weight is 0; the padding rows s >= S keep
// offset 0 alone).  The table is class-major: block b < 8 holds class b's
// rows (its sub-grid, flat order) as (count_b, rows_b), slot-major, block 8
// the padding rows, 58.8 MB at NE27000 f32 against the full 113.7 MB: that
// stream bounds it (0.0192 ms at 3.35 TB/s, the fields included).  A CTA
// takes kSpmvThreads consecutive rows of one block, so its slot count is
// uniform and its (<= 125) offsets sit in shared memory, read by a warp as
// one broadcast; neighbouring lanes take neighbouring rows, so the weight
// loads are coalesced (and bypass L1: each weight is read once) and the
// field loads stride 2 along x, from L2 (3 x 0.9 MB).  A thread's sum is
// one chain of up to 125 multiply-adds, so its loads are issued well ahead
// of them: the slot loop runs in batches of kBatch, and
// a batch issues its cx x kBatch field loads (zero outside [0, nx)) and
// the next batch's kBatch weight loads before its own multiply-adds, which
// run in slot order, each rounded once (fma_rn), as the full window's
// acc += w * x compiles (its SASS has one FFMA / DFMA a term).  On an H100
// this reads faster than the same loop that loads a batch's weights after
// the previous batch's multiply-adds; tuning builds (not kept) that held 2
// or 3 batches of weights ahead, the next batch's field values too, 4 to 32
// slots a batch, or loaded the weights with ld.global.cs or through L1 read
// no faster, and 128 threads a CTA about as fast as 256.  A dropped slot
// was fma(0, x, acc) = acc there, so the result is the full window's bit
// for bit, up to the sign of an exact zero.  The output is written at the
// row's own position s in the interleaved field.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 3;
constexpr int kClasses = 8;
constexpr int kMaxSlots = 27;   // the even class of a radius-2 window: 3 x 3 x 3
constexpr int kChunk = 9;       // slots whose loads are issued together
constexpr int kSpmvThreads = 128;  // the compact SPMV's CTA
constexpr int kBatch = 8;       // compact SPMV slots whose loads are issued together
constexpr int kSpmvBlocks = 9;  // the compact SPMV table's blocks: 8 classes, the padding rows
constexpr int kMaxWindow = 125; // slots of a radius-2 window
enum Mode { kSpmv = 0, kDiv = 2 };   // the wrapper's mode numbers; GRAD is grad_compact_kernel

// the multiply-add of a GRAD term, rounded once, as the full window's
// acc += w * x compiles, so the compact sum keeps that sum's bits
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) window_stencil_kernel(
    const T* __restrict__ w, const T* __restrict__ x, int cx,
    const int* __restrict__ offs, int nw, T* __restrict__ y, int ny, int nx, int x_org,
    int y_org) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= ny) return;
  const int s = y_org + r - x_org;   // the row in the field's indices
  const size_t plane = static_cast<size_t>(ny);
  const size_t xplane = static_cast<size_t>(nx);
  const size_t wdir = static_cast<size_t>(nw) * plane;   // direction stride of W
  T acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = T(0);
  for (int k = 0; k < nw; ++k) {
    const int j = s + offs[k];
    if (j < 0 || j >= nx) continue;   // zero field outside [0, nx)
    const T* wk = w + static_cast<size_t>(k) * plane + r;
    if (kMode == kSpmv) {
      const T wv = wk[0];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < cx) acc[c] += wv * x[c * xplane + j];
      }
    } else {
      const T t = wk[0] * x[j] + wk[wdir] * x[xplane + j];
      acc[0] += t + wk[2 * wdir] * x[2 * xplane + j];
    }
  }
  const int co = kMode == kSpmv ? cx : 1;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < co) y[c * plane + r] = acc[c];
  }
}

// offs (8, nk) flat offsets by class, counts (8,): slot j < counts[c] of a
// class-c row reads x[s + offs[c, j]] with the weights w[., j, s]
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_compact_kernel(
    const T* __restrict__ w, int nk, const T* __restrict__ x,
    const int* __restrict__ offs, const int* __restrict__ counts, T* __restrict__ y,
    int ny, int nx, int x_org, int y_org, int fx, int fy) {
  __shared__ int s_offs[kClasses * kMaxSlots];
  __shared__ int s_count[kClasses];
  for (int i = threadIdx.x; i < kClasses * nk; i += kThreads) s_offs[i] = offs[i];
  if (threadIdx.x < kClasses) s_count[threadIdx.x] = counts[threadIdx.x];
  __syncthreads();
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= ny) return;
  const int sg = y_org + r;          // the global row: its parity class
  const int cls = (((sg / (fx * fy)) & 1) << 2) | ((((sg / fx) % fy) & 1) << 1) | ((sg % fx) & 1);
  const int s = sg - x_org;          // the row in the field's indices
  const int cnt = s_count[cls];
  const int* o = s_offs + cls * nk;
  const size_t plane = static_cast<size_t>(ny);
  const size_t wdir = static_cast<size_t>(nk) * plane;   // direction stride of W
  const T* ws = w + r;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int j0 = 0; j0 < kMaxSlots; j0 += kChunk) {
    T w0[kChunk], w1[kChunk], w2[kChunk], xv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int j = j0 + i;
      const int jj = j < cnt ? s + o[j] : -1;
      const bool live = jj >= 0 && jj < nx;   // zero field outside [0, nx)
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
  y[r] = acc0;
  y[plane + r] = acc1;
  y[2 * plane + r] = acc2;
}

// one block of the compact SPMV table: entry base, rows, slot count, class
// (-1: the padding rows, s = row0 + r), the class sub-grid's x and y sizes,
// its first row (a class block: the sub-grid's flat row of its row 0, 0 on
// one device; a rank's rows of a class are a contiguous run of that order),
// its first CTA
struct SpmvBlock {
  long long base;
  int rows, count, cls, gx, gy, row0, cta0;
};
struct SpmvLayout {
  SpmvBlock b[kSpmvBlocks];
  int nb;
};

// a weight that is read once: past L1
__device__ __forceinline__ float ld_stream(const float* a) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(a));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* a) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(a));
  return v;
}

// w the flat table, offs (9, kmax) the slot offsets of each class and of the
// padding rows (row 8), x (CX, nx) the field from global position x_org,
// y (CX, ny) the rows from global row y_org; (fx, fy) the fine grid's x and
// y sizes
template <typename T, int CX>
__global__ void __launch_bounds__(kSpmvThreads) spmv_compact_kernel(
    const T* __restrict__ w, const T* __restrict__ x, const int* __restrict__ offs, int kmax,
    const SpmvLayout lay, T* __restrict__ y, int ny, int nx, int x_org, int y_org, int fx,
    int fy) {
  __shared__ int s_off[kMaxWindow];
  // this CTA's block: the last whose first CTA is not past it (static
  // indices, so the layout stays in the parameter bank)
  SpmvBlock blk = lay.b[0];
#pragma unroll
  for (int k = 1; k < kSpmvBlocks; ++k) {
    if (k < lay.nb && static_cast<int>(blockIdx.x) >= lay.b[k].cta0) blk = lay.b[k];
  }
  const int cnt = blk.count;
  const int* o = offs + (blk.cls < 0 ? kSpmvBlocks - 1 : blk.cls) * kmax;
  for (int j = threadIdx.x; j < cnt; j += kSpmvThreads) s_off[j] = o[j];
  __syncthreads();
  const int r = (static_cast<int>(blockIdx.x) - blk.cta0) * kSpmvThreads + threadIdx.x;
  if (r >= blk.rows) return;
  int s;   // the global row
  if (blk.cls < 0) {
    s = blk.row0 + r;
  } else {
    const int rg = blk.row0 + r;
    const int gxy = blk.gx * blk.gy;
    const int k = rg / gxy;
    const int j = (rg - k * gxy) / blk.gx;
    const int i = rg - k * gxy - j * blk.gx;
    s = ((2 * k + (blk.cls >> 2 & 1)) * fy + 2 * j + (blk.cls >> 1 & 1)) * fx + 2 * i +
        (blk.cls & 1);
  }
  const int sy = s - y_org;
  s -= x_org;             // in the field's indices
  const size_t plane = static_cast<size_t>(nx);
  const size_t yplane = static_cast<size_t>(ny);
  const size_t rows = static_cast<size_t>(blk.rows);
  const T* wr = w + blk.base + r;
  T acc[CX];
#pragma unroll
  for (int c = 0; c < CX; ++c) acc[c] = T(0);
  // the weights of the batch after the current one, loaded before the
  // current batch's multiply-adds
  T wn[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) wn[i] = i < cnt ? ld_stream(wr + i * rows) : T(0);
  for (int j0 = 0; j0 < cnt; j0 += kBatch) {
    T wv[kBatch], xv[CX][kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) wv[i] = wn[i];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = j0 + i;
      const int jj = j < cnt ? s + s_off[j] : -1;
      const bool live = jj >= 0 && jj < nx;   // zero field outside [0, nx)
      const T* xj = x + (live ? jj : 0);
#pragma unroll
      for (int c = 0; c < CX; ++c) xv[c][i] = live ? __ldg(xj + c * plane) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = j0 + kBatch + i;
      wn[i] = j < cnt ? ld_stream(wr + j * rows) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int c = 0; c < CX; ++c) acc[c] = fma_rn(wv[i], xv[c][i], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CX; ++c) y[c * yplane + sy] = acc[c];
}

template <typename T>
int launch_spmv_compact(const T* w, const T* x, int cx, const int* offs, int kmax,
                        const long long* blocks, int nb, T* y, int ny, int nx, int x_org,
                        int y_org, int fx, int fy, void* stream) {
  if (cx < 1 || cx > kMaxC || kmax < 1 || kmax > kMaxWindow || nb < 1 || nb > kSpmvBlocks ||
      ny < 1 || nx < 1 || fx < 1 || fy < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpmvLayout lay = {};
  int ctas = 0;
  for (int b = 0; b < nb; ++b) {
    const long long* t = blocks + 7 * b;   // rows, count, base, class, gx, gy, row0
    if (t[0] < 1 || t[1] < 1 || t[1] > kmax) return static_cast<int>(cudaErrorInvalidValue);
    lay.b[b] = SpmvBlock{t[2], static_cast<int>(t[0]), static_cast<int>(t[1]),
                         static_cast<int>(t[3]), static_cast<int>(t[4]),
                         static_cast<int>(t[5]), static_cast<int>(t[6]), ctas};
    ctas += static_cast<int>((t[0] + kSpmvThreads - 1) / kSpmvThreads);
  }
  lay.nb = nb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cx == 1) {
    spmv_compact_kernel<T, 1><<<ctas, kSpmvThreads, 0, st>>>(w, x, offs, kmax, lay, y, ny, nx,
                                                                 x_org, y_org, fx, fy);
  } else if (cx == 2) {
    spmv_compact_kernel<T, 2><<<ctas, kSpmvThreads, 0, st>>>(w, x, offs, kmax, lay, y, ny, nx,
                                                                 x_org, y_org, fx, fy);
  } else {
    spmv_compact_kernel<T, 3><<<ctas, kSpmvThreads, 0, st>>>(w, x, offs, kmax, lay, y, ny, nx,
                                                                 x_org, y_org, fx, fy);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int mode, const T* w, const T* x, int cx, const int* offs, int nw,
           T* y, int ny, int nx, int x_org, int y_org, void* stream) {
  const bool ok = (mode == kSpmv && cx >= 1 && cx <= kMaxC) || (mode == kDiv && cx == 3);
  if (!ok || nw < 1 || ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ny + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kSpmv) {
    window_stencil_kernel<T, kSpmv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, ny, nx,
                                                               x_org, y_org);
  } else {
    window_stencil_kernel<T, kDiv><<<grid, kThreads, 0, st>>>(w, x, cx, offs, nw, y, ny, nx,
                                                              x_org, y_org);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const T* w, int nk, const T* x, const int* offs, const int* counts, T* y,
                int ny, int nx, int x_org, int y_org, int fx, int fy, void* stream) {
  if (nk < 1 || nk > kMaxSlots || ny < 1 || nx < 1 || fx < 1 || fy < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grad_compact_kernel<T><<<(ny + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(w, nk, x, offs, counts, y,
                                                                ny, nx, x_org, y_org, fx, fy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SPMV, 2 DIV.  w, x, y, offs device pointers; y has (cx | 1) x n
// entries by mode.  The wrappers call the _rows forms below (at x_org =
// y_org = 0 on one device); this form and the one-device grad_compact_* and
// spmv_compact_* stay as forwarders for compare_build.py, which calls a
// build's C symbols directly.
extern "C" int window_stencil_f32(int mode, const float* w, const float* x, int cx,
                                  const int* offs, int nw, float* y, int n, void* stream) {
  return launch<float>(mode, w, x, cx, offs, nw, y, n, n, 0, 0, stream);
}

extern "C" int window_stencil_f64(int mode, const double* w, const double* x, int cx,
                                  const int* offs, int nw, double* y, int n, void* stream) {
  return launch<double>(mode, w, x, cx, offs, nw, y, n, n, 0, 0, stream);
}

// the same on a rank's rows: w (., nw, ny), y (., ny) for the global rows
// y_org + r; x (cx, nx) the field from global position x_org
extern "C" int window_stencil_rows_f32(int mode, const float* w, const float* x, int cx,
                                       const int* offs, int nw, float* y, int ny, int nx,
                                       int x_org, int y_org, void* stream) {
  return launch<float>(mode, w, x, cx, offs, nw, y, ny, nx, x_org, y_org, stream);
}

extern "C" int window_stencil_rows_f64(int mode, const double* w, const double* x, int cx,
                                       const int* offs, int nw, double* y, int ny, int nx,
                                       int x_org, int y_org, void* stream) {
  return launch<double>(mode, w, x, cx, offs, nw, y, ny, nx, x_org, y_org, stream);
}

// G on the class-compacted window: w (3, nk, n), x (n,), offs (8, nk),
// counts (8,), y (3, n); (fx, fy) the fine grid's x and y sizes
extern "C" int grad_compact_f32(const float* w, int nk, const float* x, const int* offs,
                                const int* counts, float* y, int n, int fx, int fy,
                                void* stream) {
  return launch_grad<float>(w, nk, x, offs, counts, y, n, n, 0, 0, fx, fy, stream);
}

extern "C" int grad_compact_f64(const double* w, int nk, const double* x, const int* offs,
                                const int* counts, double* y, int n, int fx, int fy,
                                void* stream) {
  return launch_grad<double>(w, nk, x, offs, counts, y, n, n, 0, 0, fx, fy, stream);
}

// the same on a rank's rows: w (3, nk, ny), y (3, ny) for the global rows
// y_org + r, x (nx,) the field from global position x_org
extern "C" int grad_compact_rows_f32(const float* w, int nk, const float* x, const int* offs,
                                     const int* counts, float* y, int ny, int nx, int x_org,
                                     int y_org, int fx, int fy, void* stream) {
  return launch_grad<float>(w, nk, x, offs, counts, y, ny, nx, x_org, y_org, fx, fy, stream);
}

extern "C" int grad_compact_rows_f64(const double* w, int nk, const double* x,
                                     const int* offs, const int* counts, double* y, int ny,
                                     int nx, int x_org, int y_org, int fx, int fy,
                                     void* stream) {
  return launch_grad<double>(w, nk, x, offs, counts, y, ny, nx, x_org, y_org, fx, fy, stream);
}

// SPMV on the class-compacted, class-major table: w the flat table, x (cx,
// nx), offs (9, kmax) device; blocks (nb, 7) int64 on the host (rows, slot
// count, entry base, class or -1, gx, gy, first row: of the class sub-grid's
// flat order, 0 for a whole class, or the padding block's first row s); y
// (cx, nx); (fx, fy) the fine grid's x and y sizes
extern "C" int spmv_compact_f32(const float* w, const float* x, int cx, const int* offs,
                                int kmax, const long long* blocks, int nb, float* y, int nx,
                                int fx, int fy, void* stream) {
  return launch_spmv_compact<float>(w, x, cx, offs, kmax, blocks, nb, y, nx, nx, 0, 0, fx, fy,
                                    stream);
}

extern "C" int spmv_compact_f64(const double* w, const double* x, int cx, const int* offs,
                                int kmax, const long long* blocks, int nb, double* y, int nx,
                                int fx, int fy, void* stream) {
  return launch_spmv_compact<double>(w, x, cx, offs, kmax, blocks, nb, y, nx, nx, 0, 0, fx, fy,
                                     stream);
}

// the same on a rank's rows: the blocks of its rows, x (cx, nx) the field
// from global position x_org, y (cx, ny) for the global rows y_org + r
extern "C" int spmv_compact_rows_f32(const float* w, const float* x, int cx, const int* offs,
                                     int kmax, const long long* blocks, int nb, float* y,
                                     int ny, int nx, int x_org, int y_org, int fx, int fy,
                                     void* stream) {
  return launch_spmv_compact<float>(w, x, cx, offs, kmax, blocks, nb, y, ny, nx, x_org, y_org,
                                    fx, fy, stream);
}

extern "C" int spmv_compact_rows_f64(const double* w, const double* x, int cx,
                                     const int* offs, int kmax, const long long* blocks, int nb,
                                     double* y, int ny, int nx, int x_org, int y_org, int fx,
                                     int fy, void* stream) {
  return launch_spmv_compact<double>(w, x, cx, offs, kmax, blocks, nb, y, ny, nx, x_org, y_org,
                                     fx, fy, stream);
}
