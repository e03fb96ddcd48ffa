// sgmv_rhs: segment-gathered h = x · dequant(A[seg])ᵀ straight from
// LoRAQuant packed codes, for Hopper (sm_90a). The first pass of the
// two-pass multi-adapter apply (shrink).
//
// Replaces the Pallas TPU kernel `sgmv_rhs`
// (src/repro/kernels/quant_matmul/kernel.py:250, pallas_call at :276).
//
// What it computes: x (T, K) bf16 or fp32, a stack A (NA, R, NG·Wg) packed
// as in cluster_lora.cuh (RTN of 2/3/4/8 bits or binary 1-bit, whose
// zero-points may be absent), any R, and seg_map (T / kt,) int32 → h
// (T, R) fp32, where token tile i (rows [i·kt, (i+1)·kt)) uses adapter
// seg_map[i] (clamped to [0, NA)). Columns of A past K (the last group's
// padding) never count.
//
// What bounds it on an H100: latency, not bytes or operations. A decode
// call (16 one-row tiles, K = 3072, R = 16) moves ~0.2 MB and needs
// ~1.6 MFLOP (bound < 0.1 µs); what a design must shorten is the chain of
// dependent memory steps each tile takes.
//
// Design (cluster_lora.cuh, the phase 1 of sgmv_fused): one thread-block
// cluster of C blocks per token tile, TR = kt rounded up to 1/2/4/8 rows (a
// template parameter, so a decode tile does no work for dead rows), with A
// offset to the tile's adapter. Block b owns a K slice of whole quant
// groups, issues every load of it up front with cp.async and reduces it
// word by word into a partial h; after cluster.sync() the tile's h
// elements are split among the blocks, each summed from the C partials in
// distributed shared memory in rank order and stored once. No float
// atomics, so two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_lora.cuh"

namespace {

namespace cl = loraquant::cluster;
using loraquant::QSide;

template <int TR, typename XT>
__global__ void __launch_bounds__(cl::kThreads, 1)
    sgmv_rhs_kernel(const cl::Params p) {
  const int tile = blockIdx.x / p.plan.cluster;
  const int seg = min(max(p.seg_map[tile], 0), p.NA - 1);
  const QSide sd[4] = {loraquant::adapter_side(p.side[0], p.r_hi, seg),
                       p.side[1], p.side[2], p.side[3]};
  cl::lora_tile<TR, XT, cl::Mode::kRhs>(p, sd, tile * p.kt, p.kt);
}

template <typename XT>
int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  switch (tr) {
    case 1: return cl::launch<sgmv_rhs_kernel<1, XT>>(p, 1, sizeof(XT), tiles, s);
    case 2: return cl::launch<sgmv_rhs_kernel<2, XT>>(p, 2, sizeof(XT), tiles, s);
    case 4: return cl::launch<sgmv_rhs_kernel<4, XT>>(p, 4, sizeof(XT), tiles, s);
    default: return cl::launch<sgmv_rhs_kernel<8, XT>>(p, 8, sizeof(XT), tiles, s);
  }
}

}  // namespace

extern "C" {

// Launches sgmv_rhs on `stream` with the A-only launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). Shapes
// are validated by the Python wrapper; the checks here guard the kernel's
// own limits.
int sgmv_rhs_launch(const void* x, int x_is_bf16, const void* codes,
                    const float* scale, const int32_t* zero,
                    const int32_t* seg_map, float* out, int T, int K, int R,
                    int NA, int kt, int bits, int binary, int group, int ng,
                    int wpg, const int* plan, void* stream) {
  const int tile_rows = plan[1];
  if (R < 1 || kt < 1 || kt > tile_rows ||
      T < 0 || T % kt != 0 || K < 1 || NA < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const cl::Params p = cl::rhs_params(
      x, QSide{codes, scale, zero, bits, binary, group, ng, wpg}, seg_map,
      out, T, K, NA, R, kt, plan);
  if (!cl::plan_ok(p, tile_rows, x_is_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_rows<__nv_bfloat16>(p, tile_rows, T / kt, s)
                   : launch_rows<float>(p, tile_rows, T / kt, s);
}

}  // extern "C"
