// sgmv_rhs: segment-gathered h = x · dequant(A[seg])ᵀ straight from
// LoRAQuant packed codes, for Hopper (sm_90a). The first pass of the
// two-pass multi-adapter apply (shrink).
//
// Replaces the Pallas TPU kernel `sgmv_rhs`
// (src/repro/kernels/quant_matmul/kernel.py:250, pallas_call at :276).
//
// What it computes: x (T, K) bf16 or fp32, a stack A (NA, R, NG·Wg) packed
// as in unpack.cuh (RTN of 2/3/4/8 bits or binary 1-bit) and seg_map
// (T / kt,) int32 → h (T, R) fp32, where token tile i (rows [i·kt,
// (i+1)·kt)) uses adapter seg_map[i] (clamped to [0, NA)). Columns of A past
// K (the last group's padding) never count.
//
// What bounds it on an H100: bytes, and at these sizes latency. The work is
// 2·T·R·K flops against x, the packed A of the adapters the tiles touch and
// the fp32 h; R is a padded split rank (≤ 64), so there are a few flops per
// byte of x. The design reads x and the packed codes once per token tile and
// never writes a dequantized A to device memory.
//
// Design (simple and correct first): one block per token tile walks all of
// K (tile_rhs in unpack.cuh, the staging matmul_rhs uses), with the side
// offset to the tile's adapter; the TPU's whole-K block becomes that loop.
// Known cost: at decode (kt = 1) each block holds one row and walks K alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

template <typename XT>
__global__ void __launch_bounds__(loraquant::kMaxThreads)
    sgmv_rhs_kernel(const XT* __restrict__ x, QSide a,
                    const int32_t* __restrict__ seg_map, float* out, int K,
                    int R, int NA, int kt) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ws = xs + kTileRows * loraquant::kChunk;
  float* hs = ws + R * loraquant::kChunk;
  const int tile = blockIdx.x;
  const int row0 = tile * kt;
  const int seg = min(max(seg_map[tile], 0), NA - 1);
  const QSide as = loraquant::adapter_side(a, R, seg);
  loraquant::tile_rhs(x, row0 + kt, K, row0, as, R, as, R, xs, ws, hs);
  for (int i = threadIdx.x; i < R * kt; i += blockDim.x) {
    const int t = i / R, s = i - t * R;
    out[static_cast<size_t>(row0 + t) * R + s] = hs[s * kTileRows + t];
  }
}

}  // namespace

extern "C" {

// Launches sgmv_rhs on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Shapes are validated by the Python wrapper; the
// checks here guard the kernel's own limits.
int sgmv_rhs_launch(const void* x, int x_is_bf16, const void* codes,
                    const float* scale, const int32_t* zero,
                    const int32_t* seg_map, float* out, int T, int K, int R,
                    int NA, int kt, int bits, int binary, int group, int ng,
                    int wpg, void* stream) {
  if (R < 1 || R > loraquant::kMaxSlots || kt < 1 || kt > kTileRows ||
      T < 0 || T % kt != 0 || K < 1 || NA < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const QSide a{codes, scale, zero, bits, binary, group, ng, wpg};
  const dim3 grid(T / kt);
  const dim3 block(loraquant::threads_for(R));
  const size_t smem = loraquant::rhs_smem_bytes(R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    sgmv_rhs_kernel<<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, seg_map, out, K, R, NA, kt);
  else
    sgmv_rhs_kernel<<<grid, block, smem, s>>>(
        static_cast<const float*>(x), a, seg_map, out, K, R, NA, kt);
  return cudaGetLastError();
}

}  // extern "C"
