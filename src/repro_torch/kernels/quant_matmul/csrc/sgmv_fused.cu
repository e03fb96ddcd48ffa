// sgmv_fused: heterogeneous multi-adapter LoRA apply straight from
// LoRAQuant packed codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sgmv_fused`
// (src/repro/kernels/quant_matmul/kernel.py:481), including its in-kernel
// unpack `_unpack_dequant_grouped` (kernel.py:110), whose device code
// (`code_at`) it shares with the other kernels through unpack.cuh.
//
// What it computes, per token tile of `kt` rows that all use adapter
// a = seg_map[tile]:
//     y = (x · A_hi[a]ᵀ) · B_hi[a] + (x · A_lo[a]ᵀ) · B_lo[a]        (fp32)
// with A_hi/B_hi RTN codes of BITS ∈ {2, 3, 4, 8} (`scale·(q − zero)`) and
// A_lo/B_lo binary 1-bit codes (`scale·(2q − 1)`, zero never read). Rows
// padded with zero scales (adapters with a smaller split h) give exactly 0.
// Columns of B past `M` (the last group's padding) are never computed.
//
// Layout (the JAX package's kernel layout, unchanged): codes
// (NA, Rp, NG·Wg) — Wg words per quant group, `per` little-endian codes per
// word (8/BITS per uint8 word; 10 per int32 word for 3-bit, 2 bits unused),
// padded per group to whole words; scale (NA, Rp, NG) fp32; zero
// (NA, Rp, NG) int32.
//
// What bounds it on an H100: bytes. Per call the work is tiny
// (2·T·Rp·(K + M)·2 flops) next to the bytes it must move: x (T·K), the
// packed codes, scales and zeros of the adapters the tiles touch, and the
// T×M fp32 output. The design keeps those bytes packed: codes are unpacked
// and dequantized in shared memory / registers and the (kt × Rp) h_hi and
// h_lo never leave shared memory, so device memory sees only packed bytes,
// x and y.
//
// Design (simple and correct first):
//   grid = (T / kt token tiles) × ceil(M / blockDim) output chunks.
//   Phase 1: the block walks K in chunks of whole A quant groups; each step
//     stages x[tile, chunk] and the dequantized A_hi/A_lo columns of the
//     chunk in shared memory, and each warp accumulates 4 (side, rank-row)
//     slots × kt token rows in registers (lanes split the chunk's columns),
//     reduced across lanes into h_hi/h_lo in shared memory.
//   Phase 2: each thread owns one output column, dequantizes its B_hi/B_lo
//     column for all Rp rows and writes kt outputs.
// Known cost, the first thing a later PR removes: every output chunk of a
// tile recomputes h, so x and A are read ceil(M / blockDim) times per tile
// (from L2 after the first). Splitting h into its own pass or sharing it
// across a cluster's blocks removes that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "unpack.cuh"

namespace {

constexpr int kMaxTileRows = 8;   // token rows per block (kt <= 8)
constexpr int kSlotsPerWarp = 4;  // (side, rank-row) slots per warp
constexpr int kMaxThreads = 512;  // 2·Rp <= 4·16 slots → Rp <= 32

struct Params {
  const void* x;
  const void* ah_codes;
  const float* ah_scale;
  const int32_t* ah_zero;
  const void* bh_codes;
  const float* bh_scale;
  const int32_t* bh_zero;
  const uint8_t* al_codes;
  const float* al_scale;
  const uint8_t* bl_codes;
  const float* bl_scale;
  const int32_t* seg_map;
  float* out;
  int T, K, M, NA, Rp, kt;
  int group_a, ng_a, wpg_ah, wpg_al;
  int group_b, ng_b, wpg_bh, wpg_bl;
  int chunk;  // K columns staged per step: a whole number of A groups
};

using loraquant::code_at;
using loraquant::load_x;

template <int BITS, typename XT>
__global__ void __launch_bounds__(kMaxThreads)
    sgmv_fused_kernel(const Params p) {
  using CodeT = typename std::conditional<BITS == 3, int32_t, uint8_t>::type;
  extern __shared__ float smem[];
  const int kt = p.kt, Rp = p.Rp, CH = p.chunk;
  const int slots = 2 * Rp;           // A_hi rows, then A_lo rows
  float* xs = smem;                   // [kt][CH]
  float* ws = xs + kt * CH;           // [slots][CH] dequantized A columns
  float* hs = ws + slots * CH;        // [slots][kt] h_hi, then h_lo

  const int tile = blockIdx.x;
  const int row0 = tile * kt;
  const int seg = min(max(p.seg_map[tile], 0), p.NA - 1);
  const size_t arow0 = static_cast<size_t>(seg) * Rp;

  const XT* x = static_cast<const XT*>(p.x);
  const CodeT* ah = static_cast<const CodeT*>(p.ah_codes);
  const CodeT* bh = static_cast<const CodeT*>(p.bh_codes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int slot0 = warp * kSlotsPerWarp;

  // ---- phase 1: h_hi / h_lo = x_tile · A[seg]ᵀ over K --------------------
  float acc[kMaxTileRows][kSlotsPerWarp];
#pragma unroll
  for (int t = 0; t < kMaxTileRows; ++t)
#pragma unroll
    for (int s = 0; s < kSlotsPerWarp; ++s) acc[t][s] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += CH) {
    for (int i = tid; i < kt * CH; i += nthreads) {
      const int t = i / CH, k = k0 + (i - t * CH);
      xs[i] = k < p.K ? load_x(x, static_cast<size_t>(row0 + t) * p.K + k)
                      : 0.f;
    }
    for (int i = tid; i < slots * CH; i += nthreads) {
      const int s = i / CH, k = k0 + (i - s * CH);
      const int g = k / p.group_a, j = k - g * p.group_a;
      float v = 0.f;
      if (g < p.ng_a) {
        if (s < Rp) {
          const size_t gi = (arow0 + s) * p.ng_a + g;
          const int q = code_at<BITS>(ah + gi * p.wpg_ah, j);
          v = p.ah_scale[gi] *
              (static_cast<float>(q) - static_cast<float>(p.ah_zero[gi]));
        } else {
          const size_t gi = (arow0 + (s - Rp)) * p.ng_a + g;
          const int q = code_at<1>(p.al_codes + gi * p.wpg_al, j);
          v = p.al_scale[gi] * (static_cast<float>(q) * 2.f - 1.f);
        }
      }
      ws[i] = v;
    }
    __syncthreads();
    for (int j = lane; j < CH; j += 32) {
      float xv[kMaxTileRows];
#pragma unroll
      for (int t = 0; t < kMaxTileRows; ++t)
        xv[t] = t < kt ? xs[t * CH + j] : 0.f;
#pragma unroll
      for (int s = 0; s < kSlotsPerWarp; ++s) {
        if (slot0 + s < slots) {
          const float w = ws[(slot0 + s) * CH + j];
#pragma unroll
          for (int t = 0; t < kMaxTileRows; ++t)
            acc[t][s] = fmaf(xv[t], w, acc[t][s]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kSlotsPerWarp; ++s) {
#pragma unroll
    for (int t = 0; t < kMaxTileRows; ++t) {
      float v = acc[t][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && t < kt && slot0 + s < slots) hs[(slot0 + s) * kt + t] = v;
    }
  }
  __syncthreads();

  // ---- phase 2: y[:, c] = h_hi · B_hi[:, c] + h_lo · B_lo[:, c] ----------
  const int c = blockIdx.y * nthreads + tid;
  if (c >= p.M) return;
  const int gb = c / p.group_b, jb = c - gb * p.group_b;
  float yh[kMaxTileRows], yl[kMaxTileRows];
#pragma unroll
  for (int t = 0; t < kMaxTileRows; ++t) yh[t] = yl[t] = 0.f;
  for (int r = 0; r < Rp; ++r) {
    const size_t gi = (arow0 + r) * p.ng_b + gb;
    const int q = code_at<BITS>(bh + gi * p.wpg_bh, jb);
    const float w = p.bh_scale[gi] *
                    (static_cast<float>(q) - static_cast<float>(p.bh_zero[gi]));
    const int ql = code_at<1>(p.bl_codes + gi * p.wpg_bl, jb);
    const float wl = p.bl_scale[gi] * (static_cast<float>(ql) * 2.f - 1.f);
#pragma unroll
    for (int t = 0; t < kMaxTileRows; ++t) {
      if (t < kt) {
        yh[t] = fmaf(hs[r * kt + t], w, yh[t]);
        yl[t] = fmaf(hs[(Rp + r) * kt + t], wl, yl[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTileRows; ++t)
    if (t < kt) p.out[static_cast<size_t>(row0 + t) * p.M + c] = yh[t] + yl[t];
}

template <typename XT>
void* pick_kernel(int bits) {
  switch (bits) {
    case 2: return reinterpret_cast<void*>(&sgmv_fused_kernel<2, XT>);
    case 3: return reinterpret_cast<void*>(&sgmv_fused_kernel<3, XT>);
    case 4: return reinterpret_cast<void*>(&sgmv_fused_kernel<4, XT>);
    case 8: return reinterpret_cast<void*>(&sgmv_fused_kernel<8, XT>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches sgmv_fused on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Shapes are validated by the Python wrapper; the
// checks here only guard the kernel's compile-time limits.
int sgmv_fused_launch(const void* x, int x_is_bf16,
                      const void* ah_codes, const float* ah_scale,
                      const int32_t* ah_zero,
                      const void* bh_codes, const float* bh_scale,
                      const int32_t* bh_zero,
                      const uint8_t* al_codes, const float* al_scale,
                      const uint8_t* bl_codes, const float* bl_scale,
                      const int32_t* seg_map, float* out,
                      int T, int K, int M, int NA, int Rp, int kt, int bits,
                      int group_a, int ng_a, int wpg_ah, int wpg_al,
                      int group_b, int ng_b, int wpg_bh, int wpg_bl,
                      void* stream) {
  if (kt < 1 || kt > kMaxTileRows || T % kt != 0) return cudaErrorInvalidValue;
  const int nwarps_needed = (2 * Rp + kSlotsPerWarp - 1) / kSlotsPerWarp;
  const int nwarps = nwarps_needed > 8 ? nwarps_needed : 8;
  const int threads = nwarps * 32;
  if (Rp < 1 || threads > kMaxThreads) return cudaErrorInvalidValue;
  void* fn = x_is_bf16 ? pick_kernel<__nv_bfloat16>(bits)
                       : pick_kernel<float>(bits);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (T == 0 || M == 0) return cudaSuccess;

  Params p;
  p.x = x;
  p.ah_codes = ah_codes; p.ah_scale = ah_scale; p.ah_zero = ah_zero;
  p.bh_codes = bh_codes; p.bh_scale = bh_scale; p.bh_zero = bh_zero;
  p.al_codes = al_codes; p.al_scale = al_scale;
  p.bl_codes = bl_codes; p.bl_scale = bl_scale;
  p.seg_map = seg_map; p.out = out;
  p.T = T; p.K = K; p.M = M; p.NA = NA; p.Rp = Rp; p.kt = kt;
  p.group_a = group_a; p.ng_a = ng_a; p.wpg_ah = wpg_ah; p.wpg_al = wpg_al;
  p.group_b = group_b; p.ng_b = ng_b; p.wpg_bh = wpg_bh; p.wpg_bl = wpg_bl;
  p.chunk = group_a * (group_a >= 256 ? 1 : 256 / group_a);

  const size_t smem =
      (static_cast<size_t>(kt) * p.chunk + 2 * Rp * p.chunk + 2 * Rp * kt) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(T / kt, (M + threads - 1) / threads);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(threads), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The message of a CUDA error code returned by any launch of this library.
const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
