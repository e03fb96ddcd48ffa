// sgmv_out: segment-gathered y = h · dequant(Bᵀ[seg])[:, :m] straight from
// LoRAQuant packed codes, for Hopper (sm_90a). The second pass of the
// two-pass multi-adapter apply (expand).
//
// Replaces the Pallas TPU kernel `sgmv_out`
// (src/repro/kernels/quant_matmul/kernel.py:293, pallas_call at :320).
//
// What it computes: h (T, R) fp32, a stack Bᵀ (NA, R, NG·Wg) packed as in
// unpack.cuh and seg_map (T / kt,) int32 → y (T, m) fp32, where token tile i
// uses adapter seg_map[i] (clamped to [0, NA)) and m ≤ NG·group. Exactly m
// columns are computed and written: unlike matmul_out, the caller slices
// nothing. Zero-scale pad rows add exactly 0.
//
// What bounds it on an H100: bytes. The work is 2·T·R·m flops against h,
// the packed Bᵀ of the adapters the tiles touch and the T×m fp32 output,
// which dominates: R ≤ 64 flops per output element written. Each output
// element is written once, consecutive threads on consecutive columns, and
// Bᵀ is dequantized in registers, never written out.
//
// Design (simple and correct first): grid = (token tiles) × (column chunks
// of blockDim). A block stages its tile's h rows in shared memory; each
// thread owns one output column of the tile's adapter, dequantizes its R
// codes and writes kt outputs. Known cost: every token tile dequantizes its
// adapter's Bᵀ again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sgmv_out_kernel(const float* __restrict__ h, QSide b,
                    const int32_t* __restrict__ seg_map, float* out, int R,
                    int M, int NA, int kt) {
  __shared__ float hs[loraquant::kMaxSlots * kTileRows];
  const int tile = blockIdx.x;
  const int row0 = tile * kt;
  for (int i = threadIdx.x; i < R * kTileRows; i += blockDim.x) {
    const int s = i / kTileRows, t = i - s * kTileRows;
    hs[i] = t < kt ? h[static_cast<size_t>(row0 + t) * R + s] : 0.f;
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const int seg = min(max(seg_map[tile], 0), NA - 1);
  const QSide bs = loraquant::adapter_side(b, R, seg);
  float y[kTileRows];
#pragma unroll
  for (int t = 0; t < kTileRows; ++t) y[t] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float w = loraquant::dequant_at(bs, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      y[t] = fmaf(hs[r * kTileRows + t], w, y[t]);
  }
#pragma unroll
  for (int t = 0; t < kTileRows; ++t)
    if (t < kt) out[static_cast<size_t>(row0 + t) * M + c] = y[t];
}

}  // namespace

extern "C" {

// Launches sgmv_out on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Shapes are validated by the Python wrapper; the
// checks here guard the kernel's own limits.
int sgmv_out_launch(const float* h, const void* codes, const float* scale,
                    const int32_t* zero, const int32_t* seg_map, float* out,
                    int T, int R, int M, int NA, int kt, int bits, int binary,
                    int group, int ng, int wpg, void* stream) {
  if (R < 1 || R > loraquant::kMaxSlots || kt < 1 || kt > kTileRows ||
      T < 0 || T % kt != 0 || M < 1 || M > ng * group || NA < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const QSide b{codes, scale, zero, bits, binary, group, ng, wpg};
  const dim3 grid(T / kt, (M + kThreads - 1) / kThreads);
  sgmv_out_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, b, seg_map, out, R, M, NA, kt);
  return cudaGetLastError();
}

}  // extern "C"
