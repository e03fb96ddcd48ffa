// matmul_rhs: h = x · dequant(A)ᵀ straight from LoRAQuant packed codes, for
// Hopper (sm_90a). The first pass of the two-pass single-adapter apply.
//
// Replaces the Pallas TPU kernel `matmul_rhs`
// (src/repro/kernels/quant_matmul/kernel.py:157, pallas_call at :176).
//
// What it computes: x (T, K) bf16 or fp32, A (R, NG·Wg) packed as in
// unpack.cuh (RTN of 2/3/4/8 bits or binary 1-bit) → h (T, R) fp32. Columns
// of A past K (the last group's padding) are never read.
//
// What bounds it on an H100: bytes, and at these sizes latency. The work is
// 2·T·R·K flops against x, the packed A and the fp32 h; R is a padded split
// rank (≤ 64), so there are a few flops per byte of x. The design reads x and
// the packed codes once per token tile and never writes a dequantized A to
// device memory: codes are dequantized into shared memory chunk by chunk.
//
// Design (simple and correct first): one block per tile of kTileRows token
// rows walks all of K (tile_rhs in unpack.cuh); the TPU's sequential K grid
// axis, which carries the sum in the output block, becomes that loop.
// Known cost: at decode (T = 16) only two blocks run, so each walks K alone;
// splitting K across blocks with a second reduction pass is the obvious next
// step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

template <typename XT>
__global__ void __launch_bounds__(loraquant::kMaxThreads)
    matmul_rhs_kernel(const XT* __restrict__ x, QSide a, float* out, int T,
                      int K, int R) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ws = xs + kTileRows * loraquant::kChunk;
  float* hs = ws + R * loraquant::kChunk;
  const int row0 = blockIdx.x * kTileRows;
  loraquant::tile_rhs(x, T, K, row0, a, R, a, R, xs, ws, hs);
  for (int i = threadIdx.x; i < R * kTileRows; i += blockDim.x) {
    const int t = i / R, s = i - t * R;
    if (row0 + t < T)
      out[static_cast<size_t>(row0 + t) * R + s] = hs[s * kTileRows + t];
  }
}

}  // namespace

extern "C" {

// Launches matmul_rhs on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Shapes are validated by the Python wrapper; the
// checks here guard the kernel's own limits.
int matmul_rhs_launch(const void* x, int x_is_bf16, const void* codes,
                      const float* scale, const int32_t* zero, float* out,
                      int T, int K, int R, int bits, int binary, int group,
                      int ng, int wpg, void* stream) {
  if (R < 1 || R > loraquant::kMaxSlots || T < 0 || K < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const QSide a{codes, scale, zero, bits, binary, group, ng, wpg};
  const dim3 grid((T + kTileRows - 1) / kTileRows);
  const dim3 block(loraquant::threads_for(R));
  const size_t smem = loraquant::rhs_smem_bytes(R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    matmul_rhs_kernel<<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, out, T, K, R);
  else
    matmul_rhs_kernel<<<grid, block, smem, s>>>(
        static_cast<const float*>(x), a, out, T, K, R);
  return cudaGetLastError();
}

}  // extern "C"
