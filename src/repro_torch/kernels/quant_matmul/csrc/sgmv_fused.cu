// sgmv_fused: heterogeneous multi-adapter LoRA apply straight from
// LoRAQuant packed codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sgmv_fused`
// (src/repro/kernels/quant_matmul/kernel.py:481, pallas_call at :568),
// including its in-kernel unpack `_unpack_dequant_grouped` (kernel.py:110).
//
// What it computes, per token tile of `kt` rows that all use adapter
// a = seg_map[tile] (clamped to [0, NA)):
//     y = (x · A_hi[a]ᵀ) · B_hi[a] (+ (x · A_lo[a]ᵀ) · B_lo[a])        (fp32)
// The full contract of the TPU kernel: every side carries its own bit width
// (RTN of 2/3/4/8 bits, `scale·(q − zero)`, or binary 1-bit,
// `scale·(2q − 1)`, zero never read) and its own quant groups, read at run
// time (cluster_lora.cuh's QSide); A_hi and B_hi may differ in width; the
// low side is optional (r_lo = 0 never touches its pointers) and has its
// own padded rank R_lo. Rows padded with zero scales (adapters with a
// smaller split h) give exactly 0. The output has exactly `M` columns.
//
// Layout (the JAX package's kernel layout, unchanged): each side a stack
// (NA, R, NG·Wg) of codes — Wg words per quant group, `per` little-endian
// codes per word (8/bits per uint8 word; 10 per int32 word for 3-bit, 2
// bits unused) —, scale (NA, R, NG) fp32 and zero (NA, R, NG) int32.
//
// What bounds it on an H100: latency, not bytes or operations. A decode
// call (16 one-row tiles) moves a few hundred KB and needs a few MFLOP
// (bound < 1 µs); what a design must shorten is the chain of dependent
// memory steps each tile takes.
//
// Design (cluster_lora.cuh): one thread-block cluster of C blocks per
// token tile, TR = tile_t rounded up to 1/2/4/8 rows (a template
// parameter, so a decode tile does no work for dead rows). Each block
// stages its K and M slices of x and the tile's adapter with cp.async up
// front, reduces its K slice into a partial h, and after cluster.sync()
// sums the C partials from distributed shared memory in rank order, then
// writes its M slice of y. h is computed once per tile and never reaches
// device memory; no float atomics, so the result is the same bits on every
// launch. fp32 FMA on the CUDA cores, not wgmma: the largest serve call is
// ~0.37 GFLOP (5.5 µs at the fp32 peak), and bf16/TF32 tensor-core
// operands would break the fp32 parity the serve checks hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_lora.cuh"

namespace {

namespace cl = loraquant::cluster;
using loraquant::QSide;

template <int TR, typename XT>
__global__ void __launch_bounds__(cl::kThreads, 1)
    sgmv_fused_kernel(const cl::Params p) {
  const int tile = blockIdx.x / p.plan.cluster;
  const int seg = min(max(p.seg_map[tile], 0), p.NA - 1);
  QSide sd[4];
  for (int s = 0; s < 4; ++s) {
    const int rows = cl::side_rows(p, s);
    sd[s] = rows > 0 ? loraquant::adapter_side(p.side[s], rows, seg)
                     : p.side[s];
  }
  cl::lora_tile<TR, XT, cl::Mode::kFused>(p, sd, tile * p.kt, p.kt);
}

template <typename XT>
int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  switch (tr) {
    case 1: return cl::launch<sgmv_fused_kernel<1, XT>>(p, 1, sizeof(XT), tiles, s);
    case 2: return cl::launch<sgmv_fused_kernel<2, XT>>(p, 2, sizeof(XT), tiles, s);
    case 4: return cl::launch<sgmv_fused_kernel<4, XT>>(p, 4, sizeof(XT), tiles, s);
    default: return cl::launch<sgmv_fused_kernel<8, XT>>(p, 8, sizeof(XT), tiles, s);
  }
}

}  // namespace

extern "C" {

// Launches sgmv_fused on `stream` with the launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). r_lo = 0
// means no low side (its pointers are not read). Shapes are validated by
// the Python wrapper; the checks here guard the kernel's own limits.
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
                      int group_bl, int ng_bl, int wpg_bl,
                      const int* plan, void* stream) {
  const int tile_rows = plan[1];
  if (kt < 1 || kt > tile_rows || T < 0 || T % kt != 0 || K < 1 || M < 1 ||
      NA < 1 || r_hi < 1 || r_lo < 0)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  cl::Params p;
  p.x = x;
  p.side[0] = QSide{ah_codes, ah_scale, ah_zero, bits_a, binary_a, group_ah,
                    ng_ah, wpg_ah};
  p.side[1] = QSide{bh_codes, bh_scale, bh_zero, bits_b, binary_b, group_bh,
                    ng_bh, wpg_bh};
  p.side[2] = QSide{al_codes, al_scale, al_zero, bits_lo, binary_lo,
                    group_al, ng_al, wpg_al};
  p.side[3] = QSide{bl_codes, bl_scale, bl_zero, bits_lo, binary_lo,
                    group_bl, ng_bl, wpg_bl};
  p.seg_map = seg_map;
  p.out = out;
  p.T = T; p.K = K; p.M = M; p.NA = NA;
  p.r_hi = r_hi; p.r_lo = r_lo; p.kt = kt;
  p.plan = cl::make_plan(plan);
  if (!cl::plan_ok(p, tile_rows, x_is_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_rows<__nv_bfloat16>(p, tile_rows, T / kt, s)
                   : launch_rows<float>(p, tile_rows, T / kt, s);
}

// The message of a CUDA error code returned by any launch of this library.
const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dynamic shared memory a block of this library's kernels takes for one
// call, make_layout(...).total: `sides` holds bits, binary, group and words
// per group of A_hi, B_hi, A_lo, B_lo (group 1 for a side the call lacks),
// `plan` the launch plan as the launchers take it. kernel.py's
// `_smem_bytes` mirrors this sum; the CUDA tests hold the two equal.
long long quant_matmul_layout_bytes(int x_bytes, int K, int M, int r_hi,
                                    int r_lo, const int* sides,
                                    const int* plan) {
  cl::Params p = {};
  for (int s = 0; s < 4; ++s)
    p.side[s] = QSide{nullptr, nullptr, nullptr, sides[4 * s],
                      sides[4 * s + 1], sides[4 * s + 2], 0,
                      sides[4 * s + 3]};
  p.K = K; p.M = M; p.r_hi = r_hi; p.r_lo = r_lo;
  p.plan = cl::make_plan(plan);
  return static_cast<long long>(cl::make_layout(p, plan[1], x_bytes).total);
}

}  // extern "C"
