// fused_lora: one adapter's LoRAQuant apply straight from packed codes in a
// single launch, for Hopper (sm_90a):
//     y = (x · A_hiᵀ) · B_hi + (x · A_loᵀ) · B_lo                     (fp32)
// with the low side optional. h_hi and h_lo never reach device memory.
//
// Replaces the Pallas TPU kernel `fused_lora`
// (src/repro/kernels/quant_matmul/kernel.py:348, pallas_call at :466).
//
// What it computes: x (T, K) bf16 or fp32; each side packed as in
// unpack.cuh with its own bit width, grouping and padded row count (the
// high side RTN of 2/3/4/8 bits or binary, the low side usually binary);
// A_hi (R_hi, ·) and B_hiᵀ (R_hi, ·), A_lo and B_loᵀ (R_lo, ·). The output
// has exactly M columns: B's last-group padding is never computed. (The
// TPU kernel writes the group-padded width into an M-wide block and fails
// when M is not a multiple of B's group; this kernel does not.)
//
// What bounds it on an H100: bytes. Per call the work is
// 2·T·(R_hi + R_lo)·(K + M) flops against x, the packed codes and the T×M
// fp32 output. The design keeps those bytes packed: codes are dequantized
// in shared memory / registers, and the (kTileRows × R) h tiles stay in
// shared memory between the two products, so device memory sees only x,
// packed bytes and y.
//
// Design (simple and correct first): grid = (token tiles of kTileRows rows)
// × (output chunks of blockDim columns). Phase 1 (tile_rhs in unpack.cuh):
// the block computes its tile's h_hi and h_lo over all of K into shared
// memory; the loop over K takes the place of the TPU's sequential K grid
// axis and its VMEM scratch. Phase 2: each thread owns one output column,
// dequantizes its B_hi and B_lo column and writes kTileRows outputs.
// Known cost, the first thing a later PR removes: every output chunk of a
// tile recomputes h, so x and A are read ceil(M / blockDim) times per tile
// (from L2 after the first).

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

struct Params {
  const void* x;
  QSide ah, bh, al, bl;
  float* out;
  int T, K, M, r_hi, r_lo;
};

template <typename XT>
__global__ void __launch_bounds__(loraquant::kMaxThreads)
    fused_lora_kernel(const Params p) {
  extern __shared__ float smem[];
  const int slots = p.r_hi + p.r_lo;  // A_hi rows, then A_lo rows
  float* xs = smem;
  float* ws = xs + kTileRows * loraquant::kChunk;
  float* hs = ws + slots * loraquant::kChunk;  // [slots][kTileRows]
  const int row0 = blockIdx.x * kTileRows;

  // ---- phase 1: h_hi / h_lo = x_tile · A_{hi,lo}ᵀ over K -----------------
  loraquant::tile_rhs(static_cast<const XT*>(p.x), p.T, p.K, row0, p.ah,
                      p.r_hi, p.al, slots, xs, ws, hs);

  // ---- phase 2: y[:, c] = h_hi · B_hi[:, c] + h_lo · B_lo[:, c] ----------
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= p.M) return;
  float yh[kTileRows], yl[kTileRows];
#pragma unroll
  for (int t = 0; t < kTileRows; ++t) yh[t] = yl[t] = 0.f;
  for (int r = 0; r < p.r_hi; ++r) {
    const float w = loraquant::dequant_at(p.bh, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      yh[t] = fmaf(hs[r * kTileRows + t], w, yh[t]);
  }
  for (int r = 0; r < p.r_lo; ++r) {
    const float w = loraquant::dequant_at(p.bl, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      yl[t] = fmaf(hs[(p.r_hi + r) * kTileRows + t], w, yl[t]);
  }
#pragma unroll
  for (int t = 0; t < kTileRows; ++t)
    if (row0 + t < p.T)
      p.out[static_cast<size_t>(row0 + t) * p.M + c] = yh[t] + yl[t];
}

}  // namespace

extern "C" {

// Launches fused_lora on `stream`; returns cudaGetLastError() after the
// launch (0 on success). r_lo = 0 means no low side (its pointers are not
// read). Shapes are validated by the Python wrapper; the checks here guard
// the kernel's own limits.
int fused_lora_launch(const void* x, int x_is_bf16,
                      const void* ah_codes, const float* ah_scale,
                      const int32_t* ah_zero,
                      const void* bh_codes, const float* bh_scale,
                      const int32_t* bh_zero,
                      const void* al_codes, const float* al_scale,
                      const int32_t* al_zero,
                      const void* bl_codes, const float* bl_scale,
                      const int32_t* bl_zero, float* out,
                      int T, int K, int M, int r_hi, int r_lo,
                      int bits_hi, int binary_hi, int bits_lo, int binary_lo,
                      int group_ah, int ng_ah, int wpg_ah,
                      int group_bh, int ng_bh, int wpg_bh,
                      int group_al, int ng_al, int wpg_al,
                      int group_bl, int ng_bl, int wpg_bl, void* stream) {
  const int slots = r_hi + r_lo;
  if (r_hi < 1 || r_lo < 0 || slots > loraquant::kMaxSlots || T < 0 ||
      K < 1 || M < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  Params p;
  p.x = x;
  p.ah = QSide{ah_codes, ah_scale, ah_zero, bits_hi, binary_hi, group_ah,
               ng_ah, wpg_ah};
  p.bh = QSide{bh_codes, bh_scale, bh_zero, bits_hi, binary_hi, group_bh,
               ng_bh, wpg_bh};
  p.al = QSide{al_codes, al_scale, al_zero, bits_lo, binary_lo, group_al,
               ng_al, wpg_al};
  p.bl = QSide{bl_codes, bl_scale, bl_zero, bits_lo, binary_lo, group_bl,
               ng_bl, wpg_bl};
  p.out = out;
  p.T = T; p.K = K; p.M = M; p.r_hi = r_hi; p.r_lo = r_lo;

  const int threads = loraquant::threads_for(slots);
  const size_t smem = loraquant::rhs_smem_bytes(slots);
  const dim3 grid((T + kTileRows - 1) / kTileRows,
                  (M + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    fused_lora_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(p);
  else
    fused_lora_kernel<float><<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
