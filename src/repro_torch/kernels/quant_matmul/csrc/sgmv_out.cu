// sgmv_out: segment-gathered y = h · dequant(Bᵀ[seg])[:, :m] straight from
// LoRAQuant packed codes, for Hopper (sm_90a). The second pass of the
// two-pass multi-adapter apply (expand).
//
// Replaces the Pallas TPU kernel `sgmv_out`
// (src/repro/kernels/quant_matmul/kernel.py:293, pallas_call at :320).
//
// What it computes: h (T, R) fp32, a stack Bᵀ (NA, R, NG·Wg) packed as in
// cluster_lora.cuh (RTN of 2/3/4/8 bits or binary 1-bit, whose zero-points
// may be absent), any R, and seg_map (T / kt,) int32 → y (T, m) fp32,
// where token tile i uses adapter seg_map[i] (clamped to [0, NA)) and
// m ≤ NG·group. Exactly m columns are computed and written: unlike
// matmul_out, the caller slices nothing. Zero-scale pad rows add exactly 0.
//
// What bounds it on an H100: latency. The byte bound is the T×m fp32
// output (2·R flops per element written), but a decode call (16 one-row
// tiles, m ≤ 8192) writes at most 0.5 MB, ~0.2 µs at 3.35 TB/s; what a
// design must shorten is each block's chain of dependent steps from its
// first instruction to its last store.
//
// Design (cluster_lora.cuh, the phase 2 of sgmv_fused, a B-only call of
// lora_tile): plain blocks, C per token tile, TR = kt rounded up to
// 1/2/4/8 rows (a template parameter, so a decode tile does no work for
// dead rows), with Bᵀ offset to the tile's adapter; block b owns an M slice
// of whole quant groups, and a prefill's M split is halved until the grid
// fits about two blocks per SM. A block computes only side 1's
// shared-memory layout (out_layout), loads its h rows into registers,
// issues the cp.async copies of its first slice chunk (codes, scales,
// zeros) while they arrive, expands each code word in registers at its
// compile-time width with the word's scale and zero loaded once, and
// writes y with float4 stores where m allows. Each output element is
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
    sgmv_out_kernel(const cl::Params p) {
  const int tile = blockIdx.x / p.plan.cluster;
  const int seg = min(max(p.seg_map[tile], 0), p.NA - 1);
  const QSide sd[4] = {p.side[0],
                       loraquant::adapter_side(p.side[1], p.r_hi, seg),
                       p.side[2], p.side[3]};
  cl::lora_tile<TR, float, cl::Mode::kOut>(p, sd, tile * p.kt, p.kt);
}

int launch_rows(const cl::Params& p, int tr, int tiles, cudaStream_t s) {
  constexpr int kB = sizeof(float);
  switch (tr) {
    case 1: return cl::launch<sgmv_out_kernel<1>>(p, 1, kB, tiles, s, false);
    case 2: return cl::launch<sgmv_out_kernel<2>>(p, 2, kB, tiles, s, false);
    case 4: return cl::launch<sgmv_out_kernel<4>>(p, 4, kB, tiles, s, false);
    default: return cl::launch<sgmv_out_kernel<8>>(p, 8, kB, tiles, s, false);
  }
}

}  // namespace

extern "C" {

// Launches sgmv_out on `stream` with the B-only launch plan of kernel.py's
// `_cluster_plan`; returns the launch's CUDA error (0 on success). Shapes
// are validated by the Python wrapper; the checks here guard the kernel's
// own limits.
int sgmv_out_launch(const float* h, const void* codes, const float* scale,
                    const int32_t* zero, const int32_t* seg_map, float* out,
                    int T, int R, int M, int NA, int kt, int bits, int binary,
                    int group, int ng, int wpg, const int* plan,
                    void* stream) {
  const int tile_rows = plan[1];
  if (R < 1 || kt < 1 || kt > tile_rows ||
      T < 0 || T % kt != 0 || M < 1 || M > ng * group || NA < 1)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const cl::Params p = cl::out_params(
      h, QSide{codes, scale, zero, bits, binary, group, ng, wpg}, seg_map,
      out, T, M, NA, R, kt, plan);
  if (!cl::plan_ok(p, tile_rows, 4)) return cudaErrorInvalidValue;
  return launch_rows(p, tile_rows, T / kt, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
