// The packed-code side of LoRAQuant's kernel layout (QSide, adapter_side)
// shared by the Hopper kernels of this directory, and the element-wise
// dequant of the out kernels (matmul_out, sgmv_out).
//
// Replaces the in-kernel helper `_unpack_dequant_grouped` of the Pallas TPU
// kernels (src/repro/kernels/quant_matmul/kernel.py:110). The TPU version
// unpacks a whole VMEM tile with lane shifts; `dequant_at` here dequantizes
// one element by (quant group, code within the group), never by flat code
// index, so the per-group word padding of 3-bit packing is skipped exactly
// as `_unpack_dequant_grouped` slices it off. The cluster kernels
// (cluster_lora.cuh) expand whole storage words instead.
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

// The out kernels (matmul_out, sgmv_out): token rows per block, and the
// rank rows (high + low) every kernel of this directory holds at most.
constexpr int kTileRows = 8;
constexpr int kMaxSlots = 64;

}  // namespace loraquant
