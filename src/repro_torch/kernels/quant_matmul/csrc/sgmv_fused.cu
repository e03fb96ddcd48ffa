// sgmv_fused: heterogeneous multi-adapter LoRA apply straight from
// LoRAQuant packed codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sgmv_fused`
// (src/repro/kernels/quant_matmul/kernel.py:481, pallas_call at :568),
// including its in-kernel unpack `_unpack_dequant_grouped` (kernel.py:110),
// whose device code it shares with the other kernels through unpack.cuh.
//
// What it computes, per token tile of `kt` rows that all use adapter
// a = seg_map[tile] (clamped to [0, NA)):
//     y = (x · A_hi[a]ᵀ) · B_hi[a] (+ (x · A_lo[a]ᵀ) · B_lo[a])        (fp32)
// The full contract of the TPU kernel: every side carries its own bit width
// (RTN of 2/3/4/8 bits, `scale·(q − zero)`, or binary 1-bit,
// `scale·(2q − 1)`, zero never read) and its own quant groups, read at run
// time (unpack.cuh's QSide); A_hi and B_hi may differ in width; the low
// side is optional and has its own padded rank R_lo. Rows padded with zero
// scales (adapters with a smaller split h) give exactly 0. Columns of B past
// `M` (the last group's padding) are never computed.
//
// Layout (the JAX package's kernel layout, unchanged): each side a stack
// (NA, R, NG·Wg) of codes — Wg words per quant group, `per` little-endian
// codes per word (8/bits per uint8 word; 10 per int32 word for 3-bit, 2
// bits unused) —, scale (NA, R, NG) fp32 and zero (NA, R, NG) int32.
//
// What bounds it on an H100: bytes. Per call the work is tiny
// (2·T·(R_hi + R_lo)·(K + M) flops) next to the bytes it must move: x
// (T·K), the packed codes, scales and zeros of the adapters the tiles touch,
// and the T×M fp32 output. The design keeps those bytes packed: codes are
// dequantized in shared memory / registers and the (kt × R) h_hi and h_lo
// never leave shared memory, so device memory sees only packed bytes, x and
// y.
//
// Design (simple and correct first): grid = (T / kt token tiles) ×
// ceil(M / blockDim) output chunks. Phase 1 (tile_rhs in unpack.cuh): the
// block offsets every side to its tile's adapter and computes h_hi / h_lo
// over all of K into shared memory; the loop over K takes the place of the
// TPU's sequential K grid axis. Phase 2: each thread owns one output column,
// dequantizes its B_hi / B_lo column for all rank rows and writes kt
// outputs. A block whose low side is absent (r_lo = 0) reads no pointer of
// it and stages no row of it.
// Known cost, the first thing a later PR removes: every output chunk of a
// tile recomputes h, so x and A are read ceil(M / blockDim) times per tile
// (from L2 after the first). Splitting h into its own pass or sharing it
// across a cluster's blocks removes that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

using loraquant::QSide;
using loraquant::kTileRows;

struct Params {
  const void* x;
  QSide ah, bh, al, bl;  // adapter 0 of each stack
  const int32_t* seg_map;
  float* out;
  int T, K, M, NA, r_hi, r_lo, kt;
};

template <typename XT>
__global__ void __launch_bounds__(loraquant::kMaxThreads)
    sgmv_fused_kernel(const Params p) {
  extern __shared__ float smem[];
  const int slots = p.r_hi + p.r_lo;  // A_hi rows, then A_lo rows
  float* xs = smem;
  float* ws = xs + kTileRows * loraquant::kChunk;
  float* hs = ws + slots * loraquant::kChunk;  // [slots][kTileRows]

  const int tile = blockIdx.x;
  const int row0 = tile * p.kt;  // the tile's rows: [row0, row0 + kt)
  const int seg = min(max(p.seg_map[tile], 0), p.NA - 1);
  const QSide ah = loraquant::adapter_side(p.ah, p.r_hi, seg);
  const QSide bh = loraquant::adapter_side(p.bh, p.r_hi, seg);
  QSide al = p.al, bl = p.bl;
  if (p.r_lo > 0) {
    al = loraquant::adapter_side(p.al, p.r_lo, seg);
    bl = loraquant::adapter_side(p.bl, p.r_lo, seg);
  }

  // ---- phase 1: h_hi / h_lo = x_tile · A[seg]ᵀ over K --------------------
  loraquant::tile_rhs(static_cast<const XT*>(p.x), row0 + p.kt, p.K, row0,
                      ah, p.r_hi, al, slots, xs, ws, hs);

  // ---- phase 2: y[:, c] = h_hi · B_hi[:, c] + h_lo · B_lo[:, c] ----------
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= p.M) return;
  float yh[kTileRows], yl[kTileRows];
#pragma unroll
  for (int t = 0; t < kTileRows; ++t) yh[t] = yl[t] = 0.f;
  for (int r = 0; r < p.r_hi; ++r) {
    const float w = loraquant::dequant_at(bh, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      yh[t] = fmaf(hs[r * kTileRows + t], w, yh[t]);
  }
  for (int r = 0; r < p.r_lo; ++r) {
    const float w = loraquant::dequant_at(bl, r, c);
#pragma unroll
    for (int t = 0; t < kTileRows; ++t)
      yl[t] = fmaf(hs[(p.r_hi + r) * kTileRows + t], w, yl[t]);
  }
#pragma unroll
  for (int t = 0; t < kTileRows; ++t)
    if (t < p.kt)
      p.out[static_cast<size_t>(row0 + t) * p.M + c] = yh[t] + yl[t];
}

}  // namespace

extern "C" {

// Launches sgmv_fused on `stream`; returns cudaGetLastError() after the
// launch (0 on success). r_lo = 0 means no low side (its pointers are not
// read). Shapes are validated by the Python wrapper; the checks here guard
// the kernel's own limits.
int sgmv_fused_launch(const void* x, int x_is_bf16,
                      const void* ah_codes, const float* ah_scale,
                      const int32_t* ah_zero,
                      const void* bh_codes, const float* bh_scale,
                      const int32_t* bh_zero,
                      const void* al_codes, const float* al_scale,
                      const int32_t* al_zero,
                      const void* bl_codes, const float* bl_scale,
                      const int32_t* bl_zero,
                      const int32_t* seg_map, float* out,
                      int T, int K, int M, int NA, int r_hi, int r_lo, int kt,
                      int bits_a, int binary_a, int bits_b, int binary_b,
                      int bits_lo, int binary_lo,
                      int group_ah, int ng_ah, int wpg_ah,
                      int group_bh, int ng_bh, int wpg_bh,
                      int group_al, int ng_al, int wpg_al,
                      int group_bl, int ng_bl, int wpg_bl, void* stream) {
  const int slots = r_hi + r_lo;
  if (kt < 1 || kt > kTileRows || T < 0 || T % kt != 0 || K < 1 || M < 1 ||
      NA < 1 || r_hi < 1 || r_lo < 0 || slots > loraquant::kMaxSlots)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  Params p;
  p.x = x;
  p.ah = QSide{ah_codes, ah_scale, ah_zero, bits_a, binary_a, group_ah,
               ng_ah, wpg_ah};
  p.bh = QSide{bh_codes, bh_scale, bh_zero, bits_b, binary_b, group_bh,
               ng_bh, wpg_bh};
  p.al = QSide{al_codes, al_scale, al_zero, bits_lo, binary_lo, group_al,
               ng_al, wpg_al};
  p.bl = QSide{bl_codes, bl_scale, bl_zero, bits_lo, binary_lo, group_bl,
               ng_bl, wpg_bl};
  p.seg_map = seg_map;
  p.out = out;
  p.T = T; p.K = K; p.M = M; p.NA = NA;
  p.r_hi = r_hi; p.r_lo = r_lo; p.kt = kt;

  const int threads = loraquant::threads_for(slots);
  const size_t smem = loraquant::rhs_smem_bytes(slots);
  const dim3 grid(T / kt, (M + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    sgmv_fused_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(p);
  else
    sgmv_fused_kernel<float><<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// The message of a CUDA error code returned by any launch of this library.
const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
