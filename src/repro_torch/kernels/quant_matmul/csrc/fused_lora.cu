// fused_lora: one adapter's LoRAQuant apply straight from packed codes in a
// single launch, for Hopper (sm_90a):
//     y = (x · A_hiᵀ) · B_hi + (x · A_loᵀ) · B_lo                     (fp32)
// with the low side optional. h_hi and h_lo never reach device memory.
//
// Replaces the Pallas TPU kernel `fused_lora`
// (src/repro/kernels/quant_matmul/kernel.py:348, pallas_call at :466).
//
// What it computes: x (T, K) bf16 or fp32, any T; each side packed as in
// cluster_lora.cuh with its own bit width, grouping and padded row count
// (the high side RTN of 2/3/4/8 bits or binary, the low side usually
// binary); A_hi (R_hi, ·) and B_hiᵀ (R_hi, ·), A_lo and B_loᵀ (R_lo, ·).
// The output has exactly M columns: B's last-group padding is never
// computed. (The TPU kernel writes the group-padded width into an M-wide
// block and fails when M is not a multiple of B's group; this kernel does
// not.)
//
// What bounds it on an H100: latency, not bytes or operations. A decode
// call (T = 16) moves ~100 KB and needs ~6 MFLOP (bound < 1 µs); what a
// design must shorten is the chain of dependent memory steps.
//
// Design (cluster_lora.cuh): one thread-block cluster of C blocks per
// token tile of TR rows (1/2/4/8, a template parameter chosen by the
// launch plan so that a decode batch of 16 rows still fills the card). Each
// block stages its K and M slices with cp.async up front, reduces its K
// slice into a partial h, and after cluster.sync() sums the C partials from
// distributed shared memory in rank order, then writes its M slice of y. h
// is computed once per tile and never reaches device memory; no float
// atomics, so the result is the same bits on every launch. fp32 FMA on the
// CUDA cores, not wgmma: the largest serve call is ~0.37 GFLOP (5.5 µs at
// the fp32 peak), and bf16/TF32 tensor-core operands would break the fp32
// parity the serve checks hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_lora.cuh"

namespace {

namespace cl = loraquant::cluster;
using loraquant::QSide;

template <int TR, typename XT>
__global__ void __launch_bounds__(cl::kThreads, 1)
    fused_lora_kernel(const cl::Params p) {
  const int row0 = (blockIdx.x / p.plan.cluster) * TR;
  const QSide sd[4] = {p.side[0], p.side[1], p.side[2], p.side[3]};
  cl::lora_tile<TR, XT, cl::Mode::kFused>(p, sd, row0, min(TR, p.T - row0));
}

template <typename XT>
int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  switch (tr) {
    case 1: return cl::launch<fused_lora_kernel<1, XT>>(p, 1, sizeof(XT), tiles, s);
    case 2: return cl::launch<fused_lora_kernel<2, XT>>(p, 2, sizeof(XT), tiles, s);
    case 4: return cl::launch<fused_lora_kernel<4, XT>>(p, 4, sizeof(XT), tiles, s);
    default: return cl::launch<fused_lora_kernel<8, XT>>(p, 8, sizeof(XT), tiles, s);
  }
}

}  // namespace

extern "C" {

// Launches fused_lora on `stream` with the launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). r_lo = 0
// means no low side (its pointers are not read). Shapes are validated by
// the Python wrapper; the checks here guard the kernel's own limits.
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
                      int group_bl, int ng_bl, int wpg_bl,
                      const int* plan, void* stream) {
  const int tile_rows = plan[1];
  if (r_hi < 1 || r_lo < 0 || T < 0 || K < 1 || M < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  cl::Params p;
  p.x = x;
  p.side[0] = QSide{ah_codes, ah_scale, ah_zero, bits_hi, binary_hi,
                    group_ah, ng_ah, wpg_ah};
  p.side[1] = QSide{bh_codes, bh_scale, bh_zero, bits_hi, binary_hi,
                    group_bh, ng_bh, wpg_bh};
  p.side[2] = QSide{al_codes, al_scale, al_zero, bits_lo, binary_lo,
                    group_al, ng_al, wpg_al};
  p.side[3] = QSide{bl_codes, bl_scale, bl_zero, bits_lo, binary_lo,
                    group_bl, ng_bl, wpg_bl};
  p.seg_map = nullptr;
  p.out = out;
  p.T = T; p.K = K; p.M = M; p.NA = 1;
  p.r_hi = r_hi; p.r_lo = r_lo; p.kt = tile_rows;
  p.plan = cl::make_plan(plan);
  if (!cl::plan_ok(p, tile_rows, x_is_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  const int tiles = (T + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_rows<__nv_bfloat16>(p, tile_rows, tiles, s)
                   : launch_rows<float>(p, tile_rows, tiles, s);
}

}  // extern "C"
