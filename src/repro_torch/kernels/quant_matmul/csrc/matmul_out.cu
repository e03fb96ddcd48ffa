// matmul_out: y = h · dequant(Bᵀ) straight from LoRAQuant packed codes, for
// Hopper (sm_90a). The second pass of the two-pass single-adapter apply.
//
// Replaces the Pallas TPU kernel `matmul_out`
// (src/repro/kernels/quant_matmul/kernel.py:204, pallas_call at :222).
//
// What it computes: h (T, R) fp32, Bᵀ (R, NG·Wg) packed as in unpack.cuh →
// y (T, Mp) fp32 over the group-padded width Mp = NG·group, as the TPU
// kernel does (the caller slices [:, :m]).
//
// What bounds it on an H100: bytes. The work is 2·T·R·Mp flops against h,
// the packed Bᵀ and the T×Mp fp32 output, which dominates: R ≤ 64 flops per
// output element written. The design writes each output element once, with
// consecutive threads on consecutive columns, and dequantizes Bᵀ in
// registers, so device memory sees packed codes and never a dequantized B.
//
// Design (simple and correct first): grid = (token tiles of kTileRows rows)
// × (column chunks of blockDim). A block stages its h tile in shared memory;
// each thread owns one output column, dequantizes its R codes and writes
// kTileRows outputs. Known cost: every token tile dequantizes Bᵀ again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    matmul_out_kernel(const float* __restrict__ h, QSide b, float* out, int T,
                      int R, int Mp) {
  __shared__ float hs[loraquant::kMaxSlots * kTileRows];
  const int row0 = blockIdx.x * kTileRows;
  for (int i = threadIdx.x; i < R * kTileRows; i += blockDim.x) {
    const int s = i / kTileRows, t = i - s * kTileRows;
    hs[i] = row0 + t < T ? h[static_cast<size_t>(row0 + t) * R + s] : 0.f;
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= Mp) return;
  float y[kTileRows];
#pragma unroll
  for (int t = 0; t < kTileRows; ++t) y[t] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float w = loraquant::dequant_at(b, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      y[t] = fmaf(hs[r * kTileRows + t], w, y[t]);
  }
#pragma unroll
  for (int t = 0; t < kTileRows; ++t)
    if (row0 + t < T) out[static_cast<size_t>(row0 + t) * Mp + c] = y[t];
}

}  // namespace

extern "C" {

// Launches matmul_out on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Shapes are validated by the Python wrapper; the
// checks here guard the kernel's own limits.
int matmul_out_launch(const float* h, const void* codes, const float* scale,
                      const int32_t* zero, float* out, int T, int R, int Mp,
                      int bits, int binary, int group, int ng, int wpg,
                      void* stream) {
  if (R < 1 || R > loraquant::kMaxSlots || T < 0 || Mp < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const QSide b{codes, scale, zero, bits, binary, group, ng, wpg};
  const dim3 grid((T + kTileRows - 1) / kTileRows,
                  (Mp + kThreads - 1) / kThreads);
  matmul_out_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, b, out, T, R, Mp);
  return cudaGetLastError();
}

}  // extern "C"
