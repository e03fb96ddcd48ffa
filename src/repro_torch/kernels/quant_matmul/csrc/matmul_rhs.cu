// matmul_rhs: h = x · dequant(A)ᵀ straight from LoRAQuant packed codes, for
// Hopper (sm_90a). The first pass of the two-pass single-adapter apply.
//
// Replaces the Pallas TPU kernel `matmul_rhs`
// (src/repro/kernels/quant_matmul/kernel.py:157, pallas_call at :176).
//
// What it computes: x (T, K) bf16 or fp32, any T; A (R, NG·Wg) packed as in
// cluster_lora.cuh (RTN of 2/3/4/8 bits or binary 1-bit), any R → h (T, R)
// fp32.
// Columns of A past K (the last group's padding) never count.
//
// What bounds it on an H100: latency, not bytes or operations. A decode
// call (T = 16, K = 3072, R = 16) moves ~0.1 MB and needs ~1.6 MFLOP
// (bound < 0.1 µs); what a design must shorten is the chain of dependent
// memory steps.
//
// Design (cluster_lora.cuh, the phase 1 of fused_lora): one thread-block
// cluster of C blocks per token tile of TR rows (1/2/4/8, chosen by the
// launch plan so that a decode batch of 16 rows still runs 16 clusters).
// Block b owns a K slice of whole quant groups, issues every load of it up
// front with cp.async and reduces it word by word into a partial h; after
// cluster.sync() the tile's h elements are split among the blocks, each
// summed from the C partials in distributed shared memory in rank order
// and stored once. No float atomics, so two launches give the same bits.
// The TPU kernel's sequential K grid axis, which carries the sum in the
// output block, becomes the cluster's split of K and that one reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_lora.cuh"

namespace {

namespace cl = loraquant::cluster;
using loraquant::QSide;

template <int TR, typename XT>
__global__ void __launch_bounds__(cl::kThreads, 1)
    matmul_rhs_kernel(const cl::Params p) {
  const int row0 = (blockIdx.x / p.plan.cluster) * TR;
  const QSide sd[4] = {p.side[0], p.side[1], p.side[2], p.side[3]};
  cl::lora_tile<TR, XT, cl::Mode::kRhs>(p, sd, row0, min(TR, p.T - row0));
}

template <typename XT>
int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  switch (tr) {
    case 1: return cl::launch<matmul_rhs_kernel<1, XT>>(p, 1, sizeof(XT), tiles, s);
    case 2: return cl::launch<matmul_rhs_kernel<2, XT>>(p, 2, sizeof(XT), tiles, s);
    case 4: return cl::launch<matmul_rhs_kernel<4, XT>>(p, 4, sizeof(XT), tiles, s);
    default: return cl::launch<matmul_rhs_kernel<8, XT>>(p, 8, sizeof(XT), tiles, s);
  }
}

}  // namespace

extern "C" {

// Launches matmul_rhs on `stream` with the A-only launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). Shapes
// are validated by the Python wrapper; the checks here guard the kernel's
// own limits.
int matmul_rhs_launch(const void* x, int x_is_bf16, const void* codes,
                      const float* scale, const int32_t* zero, float* out,
                      int T, int K, int R, int bits, int binary, int group,
                      int ng, int wpg, const int* plan, void* stream) {
  const int tile_rows = plan[1];
  if (R < 1 || T < 0 || K < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const cl::Params p = cl::rhs_params(
      x, QSide{codes, scale, zero, bits, binary, group, ng, wpg}, nullptr,
      out, T, K, 1, R, tile_rows, plan);
  if (!cl::plan_ok(p, tile_rows, x_is_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  const int tiles = (T + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_rows<__nv_bfloat16>(p, tile_rows, tiles, s)
                   : launch_rows<float>(p, tile_rows, tiles, s);
}

}  // extern "C"
