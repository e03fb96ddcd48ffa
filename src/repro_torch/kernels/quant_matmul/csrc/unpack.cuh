// Group-aware unpack and dequant of LoRAQuant packed codes, shared by the
// Hopper kernels of this directory.
//
// Replaces the in-kernel helper `_unpack_dequant_grouped` of the Pallas TPU
// kernels (src/repro/kernels/quant_matmul/kernel.py:110). The TPU version
// unpacks a whole VMEM tile with lane shifts; here each thread dequantizes
// the elements it needs, by (quant group, code within the group), never by
// flat code index, so the per-group word padding of 3-bit packing is skipped
// exactly as `_unpack_dequant_grouped` slices it off.
//
// Layout (the JAX package's kernel layout, unchanged): codes (R, NG·Wg) —
// Wg words per quant group, `per` little-endian codes per word (8/bits per
// uint8 word; 10 per int32 word for 3-bit, 2 bits unused); scale (R, NG)
// fp32; zero (R, NG) int32, read only for RTN. RTN dequantizes to
// `scale·(q − zero)`, binary 1-bit to `scale·(2q − 1)`.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace loraquant {

__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// One packed factor in the kernel layout, with its bit width and grouping
// known only at run time (one build serves every recipe).
struct QSide {
  const void* codes;
  const float* scale;
  const int32_t* zero;
  int bits;    // 1, 2, 3, 4 or 8
  int binary;  // 1: scale·(2q − 1), zero never read
  int group;   // codes per quant group
  int ng;      // quant groups per row
  int wpg;     // storage words per group
};

// The side of adapter `a` in a stack (NA, rows, ·) of sides that share one
// layout: every array offset by `a · rows · ng` groups. A binary side may
// carry no zero-points (nullptr), which are then never read.
__device__ __forceinline__ QSide adapter_side(QSide s, int rows, int a) {
  const size_t groups = static_cast<size_t>(a) * rows * s.ng;
  const size_t word_bytes = s.bits == 3 ? 4 : 1;
  s.codes = static_cast<const char*>(s.codes) + groups * s.wpg * word_bytes;
  s.scale += groups;
  if (s.zero != nullptr) s.zero += groups;
  return s;
}

// Dequantized element (r, c) of a side whose width is BITS, c < ng·group:
// the codes per word are a compile-time constant, so the word and shift of
// code j need no run-time division.
template <int BITS>
__device__ __forceinline__ float dequant_bits(const QSide& s, int r, int c) {
  const int g = c / s.group, j = c - g * s.group;
  const size_t gi = static_cast<size_t>(r) * s.ng + g;
  int q;
  if constexpr (BITS == 3) {
    const int32_t* w = static_cast<const int32_t*>(s.codes) + gi * s.wpg;
    q = (w[j / 10] >> ((j % 10) * 3)) & 7;
  } else {
    constexpr int kPer = 8 / BITS;
    const uint8_t* w = static_cast<const uint8_t*>(s.codes) + gi * s.wpg;
    q = (w[j / kPer] >> ((j % kPer) * BITS)) & ((1 << BITS) - 1);
  }
  const float qf = static_cast<float>(q);
  return s.binary ? s.scale[gi] * (qf * 2.f - 1.f)
                  : s.scale[gi] * (qf - static_cast<float>(s.zero[gi]));
}

// Dequantized element (r, c) of a side, c < ng·group: one switch on the
// side's run-time width (uniform across a warp) picks the compiled width.
__device__ __forceinline__ float dequant_at(const QSide& s, int r, int c) {
  switch (s.bits) {
    case 1: return dequant_bits<1>(s, r, c);
    case 2: return dequant_bits<2>(s, r, c);
    case 3: return dequant_bits<3>(s, r, c);
    case 4: return dequant_bits<4>(s, r, c);
    default: return dequant_bits<8>(s, r, c);
  }
}

// ---------------------------------------------------------------------------
// h[s][t] = Σ_k x[row0 + t][k] · W_s[k] for one tile of kTileRows token rows
// and `slots` dequantized rows W_s (slot s < rows0 is row s of side 0, the
// rest rows of side 1), over all of K. The loop over K inside the block
// takes the place of the TPU's sequential K grid axis.
//
// Each step stages x[tile, chunk] and the dequantized W columns of the
// chunk in shared memory; each warp owns kSlotsPerWarp slots × kTileRows
// rows in registers, its lanes splitting the chunk's columns, and the lane
// partial sums are reduced with shuffles at the end. Rows past T read 0:
// they are zeroed once and never staged, so a tile of one row (SGMV decode)
// stages one row per chunk. Needs blockDim.x >= 32·ceil(slots /
// kSlotsPerWarp) and the shared arrays xs [kTileRows·kChunk],
// ws [slots·kChunk], hs [slots·kTileRows].
// ---------------------------------------------------------------------------

constexpr int kTileRows = 8;     // token rows per block
constexpr int kSlotsPerWarp = 4; // dequantized rows per warp
constexpr int kChunk = 128;      // K columns staged per step
constexpr int kMaxSlots = 64;    // 16 warps of 4 slots
constexpr int kMaxThreads = 32 * kMaxSlots / kSlotsPerWarp;

inline int threads_for(int slots) {
  const int warps = (slots + kSlotsPerWarp - 1) / kSlotsPerWarp;
  return 32 * (warps > 8 ? warps : 8);
}

inline size_t rhs_smem_bytes(int slots) {
  return (static_cast<size_t>(kTileRows) * kChunk +
          static_cast<size_t>(slots) * kChunk +
          static_cast<size_t>(slots) * kTileRows) * sizeof(float);
}

template <typename XT>
__device__ void tile_rhs(const XT* x, int T, int K, int row0,
                         const QSide& side0, int rows0, const QSide& side1,
                         int slots, float* xs, float* ws, float* hs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int slot0 = warp * kSlotsPerWarp;

  float acc[kTileRows][kSlotsPerWarp];
#pragma unroll
  for (int t = 0; t < kTileRows; ++t)
#pragma unroll
    for (int s = 0; s < kSlotsPerWarp; ++s) acc[t][s] = 0.f;

  const int live = min(kTileRows, T - row0);  // token rows of the tile
  for (int i = live * kChunk + tid; i < kTileRows * kChunk; i += nthreads)
    xs[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = tid; i < live * kChunk; i += nthreads) {
      const int t = i / kChunk, k = k0 + (i - t * kChunk);
      xs[i] = k < K ? load_x(x, static_cast<size_t>(row0 + t) * K + k) : 0.f;
    }
    for (int i = tid; i < slots * kChunk; i += nthreads) {
      const int s = i / kChunk, k = k0 + (i - s * kChunk);
      float v = 0.f;
      if (k < K)
        v = s < rows0 ? dequant_at(side0, s, k)
                      : dequant_at(side1, s - rows0, k);
      ws[i] = v;
    }
    __syncthreads();
    for (int j = lane; j < kChunk; j += 32) {
      float xv[kTileRows];
#pragma unroll
      for (int t = 0; t < kTileRows; ++t) xv[t] = xs[t * kChunk + j];
#pragma unroll
      for (int s = 0; s < kSlotsPerWarp; ++s) {
        if (slot0 + s < slots) {
          const float w = ws[(slot0 + s) * kChunk + j];
#pragma unroll
          for (int t = 0; t < kTileRows; ++t)
            acc[t][s] = fmaf(xv[t], w, acc[t][s]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kSlotsPerWarp; ++s) {
#pragma unroll
    for (int t = 0; t < kTileRows; ++t) {
      float v = acc[t][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && slot0 + s < slots) hs[(slot0 + s) * kTileRows + t] = v;
    }
  }
  __syncthreads();
}

}  // namespace loraquant
