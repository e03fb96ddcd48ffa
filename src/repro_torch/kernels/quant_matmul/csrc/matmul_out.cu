// matmul_out: y = h · dequant(Bᵀ) straight from LoRAQuant packed codes, for
// Hopper (sm_90a). The second pass of the two-pass single-adapter apply.
//
// Replaces the Pallas TPU kernel `matmul_out`
// (src/repro/kernels/quant_matmul/kernel.py:204, pallas_call at :222).
//
// What it computes: h (T, R) fp32, any T; Bᵀ (R, NG·Wg) packed as in
// cluster_lora.cuh (RTN of 2/3/4/8 bits or binary 1-bit), any R → y (T, Mp)
// fp32 over the group-padded width Mp = NG·group, as the TPU kernel does
// (the caller slices [:, :m]).
//
// What bounds it on an H100: latency. The byte bound is the T×Mp fp32
// output (2·R flops per element written), but a decode call (T = 16,
// Mp ≤ 8192) writes at most 0.5 MB, ~0.2 µs at 3.35 TB/s; what a design must
// shorten is each block's chain of dependent steps from its first
// instruction to its last store.
//
// Design (cluster_lora.cuh, the phase 2 of fused_lora, a B-only call of
// lora_tile): plain blocks, C per token tile of TR rows (1/2/4/8, chosen by
// the launch plan as for matmul_rhs, so a 16-row decode runs 128 blocks; a
// prefill's M split is halved until the grid fits about two blocks per
// SM), block b owning an M slice of whole quant groups. A block computes
// only side 1's shared-memory layout (out_layout), loads its h rows into
// registers, issues the cp.async copies of its first slice chunk (codes,
// scales, zeros) while they arrive, expands each code word in registers at
// its compile-time width with the word's scale and zero loaded once, and
// writes y with float4 stores where Mp allows. Each output element is
// computed and written by one thread with no float atomics, so two
// launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_lora.cuh"

namespace {

namespace cl = loraquant::cluster;
using loraquant::QSide;

template <int TR>
__global__ void __launch_bounds__(cl::kThreads, 1)
    matmul_out_kernel(const cl::Params p) {
  const int row0 = (blockIdx.x / p.plan.cluster) * TR;
  const QSide sd[4] = {p.side[0], p.side[1], p.side[2], p.side[3]};
  cl::lora_tile<TR, float, cl::Mode::kOut>(p, sd, row0, min(TR, p.T - row0));
}

int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  constexpr int kB = sizeof(float);
  switch (tr) {
    case 1: return cl::launch<matmul_out_kernel<1>>(p, 1, kB, tiles, s, false);
    case 2: return cl::launch<matmul_out_kernel<2>>(p, 2, kB, tiles, s, false);
    case 4: return cl::launch<matmul_out_kernel<4>>(p, 4, kB, tiles, s, false);
    default: return cl::launch<matmul_out_kernel<8>>(p, 8, kB, tiles, s, false);
  }
}

}  // namespace

extern "C" {

// Launches matmul_out on `stream` with the B-only launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). Shapes
// are validated by the Python wrapper; the checks here guard the kernel's
// own limits.
int matmul_out_launch(const float* h, const void* codes, const float* scale,
                      const int32_t* zero, float* out, int T, int R, int Mp,
                      int bits, int binary, int group, int ng, int wpg,
                      const int* plan, void* stream) {
  const int tile_rows = plan[1];
  if (R < 1 || T < 0 || Mp < 1 || Mp != ng * group)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const cl::Params p = cl::out_params(
      h, QSide{codes, scale, zero, bits, binary, group, ng, wpg}, nullptr,
      out, T, Mp, 1, R, tile_rows, plan);
  if (!cl::plan_ok(p, tile_rows, 4)) return cudaErrorInvalidValue;
  const int tiles = (T + tile_rows - 1) / tile_rows;
  return launch_rows(p, tile_rows, tiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
