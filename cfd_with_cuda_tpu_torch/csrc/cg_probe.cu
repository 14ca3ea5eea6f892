// A timing probe for cfd_with_cuda_tpu_torch/compare_build.py, no part of
// a solve and not built into the solver libraries: `reps` rounds of what a
// CG iteration does across the grid besides its vector work, on exactly
// `blocks` co-resident blocks.  mode 0: one grid.sync() a round; mode 1: the
// two reductions of an iteration as cg_iter runs them (block_partials of
// one value, grid.sync(), grid_totals; then of two).  `part` holds 3 *
// blocks partials (f64 when comp != 0), `sink` one float.

#include "cg_common.cuh"

namespace {

using namespace cgk;

template <bool COMP>
__global__ void __launch_bounds__(kThreads) cg_probe_kernel(
    typename Acc<COMP>::type* part, int reps, int mode, float* sink) {
  using A = typename Acc<COMP>::type;
  cg::grid_group grid = cg::this_grid();
  __shared__ A red[2 * kThreads];
  __shared__ float bcast[2];
  const int nb = gridDim.x;
  float acc = 0.0f;
  for (int k = 0; k < reps; ++k) {
    if (mode == 0) {
      grid.sync();
      continue;
    }
    A v1[1] = {A(threadIdx.x + k)};
    block_partials<A, 1>(v1, red, part + blockIdx.x, nb);
    grid.sync();
    float t1[1];
    grid_totals<A, 1>(part, nb, bcast, t1);
    A v2[2] = {A(t1[0]), A(threadIdx.x)};
    block_partials<A, 2>(v2, red, part + nb + blockIdx.x, nb);
    grid.sync();
    float t2[2];
    grid_totals<A, 2>(part + nb, nb, bcast, t2);
    acc += t2[0];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = acc;
}

}  // namespace

extern "C" int cg_probe_f32(int blocks, int reps, int mode, int comp, void* part,
                            float* sink, void* stream) {
  void* kargs[] = {&part, &reps, &mode, &sink};
  if (comp) return plain_coop_launch(cg_probe_kernel<true>, 0, blocks, kargs, stream);
  return plain_coop_launch(cg_probe_kernel<false>, 0, blocks, kargs, stream);
}

