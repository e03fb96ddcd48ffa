// One thread-block cluster per token tile: the device code shared by all
// six LoRAQuant kernels of this directory, for Hopper (sm_90a): the fused
// kernels sgmv_fused.cu and fused_lora.cu, the first passes of the two-pass
// routes, matmul_rhs.cu and sgmv_rhs.cu, and their second passes,
// matmul_out.cu and sgmv_out.cu.
//
// What a cluster computes, for one tile of `live` token rows (at most TR,
// a compile-time row count) and one adapter's packed sides:
//     fused:  y[tile] = (x[tile] · A_hiᵀ) · B_hi + (x[tile] · A_loᵀ) · B_lo
//     rhs:    h[tile] =  x[tile] · Aᵀ                                  (fp32)
//     out:    y[tile] =  h[tile] · B                 (h fp32, device memory)
//
// Packed layout (the JAX package's kernel layout, unchanged): codes (R,
// NG·Wg) — Wg words per quant group, `per` little-endian codes per word
// (8/bits per uint8 word; 10 per int32 word for 3-bit, 2 bits unused);
// scale (R, NG) fp32; zero (R, NG) int32, read only for RTN. RTN
// dequantizes to `scale·(q − zero)`, binary 1-bit to `scale·(2q − 1)`. This
// replaces the in-kernel helper `_unpack_dequant_grouped` of the Pallas TPU
// kernels (src/repro/kernels/quant_matmul/kernel.py:110), which unpacks a
// whole VMEM tile with lane shifts; here a thread expands whole storage
// words (below), and the per-group word padding of 3-bit packing is skipped
// by code index within the group, as `_unpack_dequant_grouped` slices it.
//
// What bounds it on an H100: latency. A decode call moves a few hundred KB
// and needs a few MFLOP, so the design's job is a short chain of dependent
// steps, not bandwidth:
//
// * Block b of the cluster's C blocks owns a K slice and an M slice, both
//   whole units of `lcm(group_A_hi, group_A_lo)` (resp. of B's groups), so
//   every side's quant groups split cleanly. It issues every load of its
//   slices up front with cp.async (16-byte copies where every group start
//   is 16-byte aligned, 4-byte copies otherwise, plain loads where neither
//   is): the x rows, the A and B code words, scales and zeros. Slices wider
//   than the plan's chunk are staged chunk by chunk.
// * Any rank: nothing here holds a fixed number of rank rows. Shared
//   memory grows with them (h, and every staged side: make_layout), so
//   the launch plan shrinks its K and M chunks until one block's layout
//   fits the card's opt-in shared memory (_cluster_plan in kernel.py),
//   and plan_ok refuses a plan whose layout does not fit.
// * Phase 1, the one path of the four kernels that read x (`lora_tile`):
//   the block reduces its K slice into a partial h (slots × TR fp32, slots
//   = R_hi + R_lo) in shared memory; a warp owns a slot and its lanes walk
//   the slice word by word.
// * cluster.sync(), then h is the sum of the C partials read out of the
//   blocks' shared memory (distributed shared memory, map_shared_rank) in
//   rank order 0..C-1. No float atomics are used, and the same inputs give
//   the same bits on every launch. The fused kernels sum all of h in every
//   block, so h never reaches device memory (the TPU kernel's VMEM
//   scratch); the rhs kernels (an A-only call: M = 0, no low side) split
//   the tile's live × R elements of h among the blocks, each summed and
//   stored to device memory by one block.
// * Phase 2 (fused and out): the block computes its M slice: a work item is
//   one code word of B (`per` consecutive output columns) and two of the
//   tile's rows; it loops over the side's rank rows and keeps 2 × per sums
//   in registers; the high side's sums are stored to shared memory, the low
//   side's added, and y is written with float4 stores where M allows.
// * A final cluster barrier keeps every block's partial h alive until its
//   neighbours have read it.
// * An out call (matmul_out, sgmv_out: a B-only call, K = 0, no A sides)
//   has no phase 1 and nothing to reduce, so it launches plain blocks (a
//   cluster of 1), the plan's C blocks of a tile splitting M as above. A
//   block lays out only side 1 (out_layout), loads its first element of
//   the tile's h rows into a register, issues the cp.async copies of its
//   first B chunk, stores h slot-major for phase 2 (rows past `live` read
//   0; any further elements in a strided loop) and runs phase 2 as the
//   fused kernels do.
//
// Dequant is word-wise: a thread loads one storage word and its group's
// scale and zero once and expands every code of it in registers with the
// compile-time width (BITS, dispatched once per side); the group index is
// computed per word, never per element.
//
// Arithmetic is fp32 FMA on the CUDA cores, not wgmma: the largest call on
// the serve path (a prefill at (8192, 3072), 32 rank rows, 512 rows) is
// ~0.37 GFLOP, 5.5 µs at the 67 TFLOP/s fp32 peak, and wgmma's bf16/TF32
// operands would break the fp32 parity that the serve checks hold.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

namespace cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size (MAX_CLUSTER)

// The launch plan, chosen by `_cluster_plan` in kernel.py. Columns are cut
// in units of `k_unit` (resp. `m_unit`), a multiple of every A (resp. B)
// side's group: block b of a cluster owns units
// [b·k_units, min(NU, (b+1)·k_units)) of the NU = ceil(K / k_unit) and
// stages them `k_chunk` units at a time. An A-only plan (M = 0) has
// m_units = m_chunk = 0, a B-only plan (K = 0) k_units = k_chunk = 0.
struct Plan {
  int cluster;                       // C, blocks per token tile
  int k_unit, k_units, k_chunk;
  int m_unit, m_units, m_chunk;
  int vec_x;                         // bytes per copy of x: 16, 4 or 1
  int vec_y;                         // 4: float4 stores of y, else 1
  int vec[4];                        // bytes per copy of each side's codes
};

// sides: 0 A_hi, 1 B_hi, 2 A_lo, 3 B_lo (adapter 0 of each stack). An
// A-only call (matmul_rhs, sgmv_rhs) has M = 0 and r_lo = 0: side 0 is its
// A, out its h (T, r_hi). A B-only call (matmul_out, sgmv_out) has K = 0
// and r_lo = 0: x is its h (T, r_hi) fp32, side 1 its B.
struct Params {
  const void* x;
  QSide side[4];
  const int32_t* seg_map;            // sgmv_*
  float* out;
  int T, K, M, NA, r_hi, r_lo, kt;   // kt: live rows per tile (sgmv_*)
  Plan plan;
};

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int word_bytes(const QSide& s) {
  return s.bits == 3 ? 4 : 1;
}

__host__ __device__ inline int side_rows(const Params& p, int s) {
  return s < 2 ? p.r_hi : p.r_lo;
}

// Byte offsets of the dynamic shared memory, the same in every block (a
// neighbour's partial h is found at `hp` of its shared memory).
struct Layout {
  size_t hp, hf, xs, ys, codes[4], scale[4], zero[4], total;
  int xs_stride;                     // bytes per staged x row
  int ys_stride;                     // floats per staged y row
  int code_stride[4];                // bytes per staged code row
  int gpc[4];                        // quant groups per staged chunk
};

__host__ __device__ inline Layout make_layout(const Params& p, int tr,
                                              int x_bytes) {
  Layout l;
  const int slots = p.r_hi + p.r_lo;
  const int k_cols = p.plan.k_chunk * p.plan.k_unit;
  const int m_cols = p.plan.m_chunk * p.plan.m_unit;
  size_t off = 0;
  l.hp = off;
  off = align16(off + sizeof(float) * slots * tr);
  l.hf = off;
  off = align16(off + sizeof(float) * slots * tr);
  l.xs_stride = static_cast<int>(align16(static_cast<size_t>(k_cols) * x_bytes));
  l.xs = off;
  off = align16(off + static_cast<size_t>(l.xs_stride) * tr);
  l.ys_stride = (m_cols + 3) & ~3;
  l.ys = off;
  off = align16(off + sizeof(float) * l.ys_stride * tr);
  for (int s = 0; s < 4; ++s) {
    const int rows = side_rows(p, s);
    const int cols = (s & 1) ? m_cols : k_cols;
    const QSide& q = p.side[s];
    l.gpc[s] = rows > 0 ? cols / q.group : 0;
    l.code_stride[s] = static_cast<int>(
        align16(static_cast<size_t>(l.gpc[s]) * q.wpg * (rows > 0 ? word_bytes(q) : 0)));
    l.codes[s] = off;
    off = align16(off + static_cast<size_t>(l.code_stride[s]) * rows);
    l.scale[s] = off;
    off = align16(off + sizeof(float) * l.gpc[s] * rows);
    l.zero[s] = off;
    off = align16(off + (q.binary ? 0 : sizeof(int32_t) * l.gpc[s] * rows));
  }
  l.total = off;
  return l;
}

// make_layout of an out call (K = 0, r_lo = 0: side 1 only): the same
// offsets without the loop over four sides, whose divisions and 64-bit
// offsets every block of an out kernel would otherwise compute before its
// first load.
__host__ __device__ inline Layout out_layout(const Params& p, int tr) {
  Layout l = {};
  const QSide& q = p.side[1];
  const int rows = p.r_hi;
  const int m_cols = p.plan.m_chunk * p.plan.m_unit;
  size_t off = align16(sizeof(float) * rows * tr);
  l.hf = off;
  off = align16(off + sizeof(float) * rows * tr);
  l.xs = l.ys = off;
  l.ys_stride = (m_cols + 3) & ~3;
  off = align16(off + sizeof(float) * l.ys_stride * tr);
  l.gpc[1] = m_cols / q.group;
  l.code_stride[1] = static_cast<int>(
      align16(static_cast<size_t>(l.gpc[1]) * q.wpg * word_bytes(q)));
  l.codes[1] = off;
  off = align16(off + static_cast<size_t>(l.code_stride[1]) * rows);
  l.scale[1] = off;
  off = align16(off + sizeof(float) * l.gpc[1] * rows);
  l.zero[1] = off;
  off = align16(off + (q.binary ? 0 : sizeof(int32_t) * l.gpc[1] * rows));
  l.total = off;
  return l;
}

// ---- asynchronous copies and the cluster barrier ---------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Copy `rows` rows of `row_bytes` (a multiple of `vec`) from device memory
// into shared memory, all threads of the block sharing the pieces.
__device__ __forceinline__ void copy_rows(void* dst, int dst_stride,
                                          const void* src, size_t src_stride,
                                          int rows, int row_bytes, int vec) {
  if (rows <= 0 || row_bytes <= 0) return;
  const int per_row = row_bytes / vec;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    char* d = static_cast<char*>(dst) + static_cast<size_t>(r) * dst_stride + c;
    const char* s = static_cast<const char*>(src) + r * src_stride + c;
    if (vec == 16)
      cp_async16(d, s);
    else if (vec == 4)
      cp_async4(d, s);
    else
      *d = *s;
  }
}

// Stage quant groups [g0, g1) of every row of one side.
__device__ __forceinline__ void stage_side(const QSide& q, int rows, int g0,
                                           int g1, unsigned char* smem,
                                           const Layout& l, int s, int vec) {
  if (rows <= 0 || g1 <= g0) return;
  const int wb = word_bytes(q);
  const size_t row_words = static_cast<size_t>(q.ng) * q.wpg;
  copy_rows(smem + l.codes[s], l.code_stride[s],
            static_cast<const char*>(q.codes) + static_cast<size_t>(g0) * q.wpg * wb,
            row_words * wb, rows, (g1 - g0) * q.wpg * wb, vec);
  copy_rows(smem + l.scale[s], l.gpc[s] * 4, q.scale + g0,
            static_cast<size_t>(q.ng) * 4, rows, (g1 - g0) * 4, 4);
  if (!q.binary)
    copy_rows(smem + l.zero[s], l.gpc[s] * 4, q.zero + g0,
              static_cast<size_t>(q.ng) * 4, rows, (g1 - g0) * 4, 4);
}

// The staged view of one side's chunk.
struct Staged {
  const unsigned char* codes;
  const float* scale;
  const int32_t* zero;
  int code_stride, gpc, ngroups, ncols;  // ncols: valid columns of the chunk
};

__device__ __forceinline__ Staged staged(const unsigned char* smem,
                                         const Layout& l, int s, int g0,
                                         int g1, int ncols) {
  return Staged{smem + l.codes[s],
                reinterpret_cast<const float*>(smem + l.scale[s]),
                reinterpret_cast<const int32_t*>(smem + l.zero[s]),
                l.code_stride[s], l.gpc[s], g1 - g0, ncols};
}

template <int BITS>
__device__ __forceinline__ unsigned load_word(const unsigned char* row,
                                              int wi) {
  if constexpr (BITS == 3)
    return reinterpret_cast<const uint32_t*>(row)[wi];
  else
    return row[wi];
}

// ---- phase 1: partial h over the chunk -------------------------------------
// hp[r·TR + t] += Σ_c x[t][c] · A[r][c] over the chunk's columns, for the
// side's `rows` rank rows; warp w owns rows w, w + kWarps, ..., its lanes
// walk the row's words.
template <int BITS, int TR, typename XT>
__device__ void rhs_side(const QSide& q, const Staged& st, int rows,
                         const XT* xs, int xs_stride, float* hp) {
  constexpr int kPer = BITS == 3 ? 10 : 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwords = st.ngroups * q.wpg;
  const float mul = q.binary ? 2.f : 1.f;
  for (int r = warp; r < rows; r += kWarps) {
    float acc[TR];
#pragma unroll
    for (int t = 0; t < TR; ++t) acc[t] = 0.f;
    const unsigned char* crow = st.codes + static_cast<size_t>(r) * st.code_stride;
    for (int wi = lane; wi < nwords; wi += 32) {
      const int g = wi / q.wpg, w = wi - g * q.wpg;
      const unsigned word = load_word<BITS>(crow, wi);
      const float sc = st.scale[r * st.gpc + g];
      const float z = q.binary ? 1.f : static_cast<float>(st.zero[r * st.gpc + g]);
      const int j0 = w * kPer;          // first code of the word in its group
      const int c0 = g * q.group + j0;  // its column in the chunk
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j0 + j < q.group && c0 + j < st.ncols) {
          const float qf = static_cast<float>((word >> (j * BITS)) & kMask);
          const float v = sc * (qf * mul - z);
#pragma unroll
          for (int t = 0; t < TR; ++t)
            acc[t] = fmaf(load_x(xs, static_cast<size_t>(t) * xs_stride + c0 + j),
                          v, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      float v = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) hp[r * TR + t] += v;
    }
  }
}

template <int TR, typename XT>
__device__ void rhs_dispatch(const QSide& q, const Staged& st, int rows,
                             const XT* xs, int xs_stride, float* hp) {
  switch (q.bits) {
    case 1: rhs_side<1, TR>(q, st, rows, xs, xs_stride, hp); break;
    case 2: rhs_side<2, TR>(q, st, rows, xs, xs_stride, hp); break;
    case 3: rhs_side<3, TR>(q, st, rows, xs, xs_stride, hp); break;
    case 4: rhs_side<4, TR>(q, st, rows, xs, xs_stride, hp); break;
    default: rhs_side<8, TR>(q, st, rows, xs, xs_stride, hp); break;
  }
}

// ---- phase 2: y over the chunk -----------------------------------------------
// ys[t][c] (= or +=) Σ_r h[r][t] · B[r][c]. A work item is one code word of
// the side's rows (`per` consecutive columns) and TG of the tile's rows:
// the TR rows are split in TR / TG groups, so a thread keeps TG × per sums
// and a prefill tile spreads over up to TR / TG times more threads.
template <int BITS, int TR>
__device__ void out_side(const QSide& q, const Staged& st, int rows,
                         const float* hf, float* ys, int ys_stride,
                         bool accumulate) {
  constexpr int kPer = BITS == 3 ? 10 : 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  constexpr int TG = TR < 2 ? TR : 2;  // token rows per work item
  constexpr int kGroups = TR / TG;
  const int nwords = st.ngroups * q.wpg;
  const float mul = q.binary ? 2.f : 1.f;
  for (int item = threadIdx.x; item < nwords * kGroups; item += blockDim.x) {
    const int wi = item / kGroups, t0 = (item - wi * kGroups) * TG;
    const int g = wi / q.wpg, w = wi - g * q.wpg;
    const int j0 = w * kPer, c0 = g * q.group + j0;
    float acc[TG][kPer];
#pragma unroll
    for (int t = 0; t < TG; ++t)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[t][j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const unsigned word =
          load_word<BITS>(st.codes + static_cast<size_t>(r) * st.code_stride, wi);
      const float sc = st.scale[r * st.gpc + g];
      const float z = q.binary ? 1.f : static_cast<float>(st.zero[r * st.gpc + g]);
      float v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[j] = sc * (static_cast<float>((word >> (j * BITS)) & kMask) * mul - z);
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const float h = hf[r * TR + t0 + t];
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[t][j] = fmaf(h, v[j], acc[t][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j0 + j < q.group && c0 + j < st.ncols) {
#pragma unroll
        for (int t = 0; t < TG; ++t) {
          float* d = ys + (t0 + t) * ys_stride + c0 + j;
          *d = accumulate ? *d + acc[t][j] : acc[t][j];
        }
      }
    }
  }
}

template <int TR>
__device__ void out_dispatch(const QSide& q, const Staged& st, int rows,
                             const float* hf, float* ys, int ys_stride,
                             bool accumulate) {
  switch (q.bits) {
    case 1: out_side<1, TR>(q, st, rows, hf, ys, ys_stride, accumulate); break;
    case 2: out_side<2, TR>(q, st, rows, hf, ys, ys_stride, accumulate); break;
    case 3: out_side<3, TR>(q, st, rows, hf, ys, ys_stride, accumulate); break;
    case 4: out_side<4, TR>(q, st, rows, hf, ys, ys_stride, accumulate); break;
    default: out_side<8, TR>(q, st, rows, hf, ys, ys_stride, accumulate); break;
  }
}

// Quant groups [g0, g1) of side q that a chunk of columns [c0, c1) covers
// (c0 a group boundary of q; the last group may run past the dimension).
__device__ __forceinline__ void chunk_groups(const QSide& q, int c0, int c1,
                                             int* g0, int* g1) {
  *g0 = c0 / q.group;
  *g1 = min(q.ng, c1 / q.group);
}

// ---- the tile ----------------------------------------------------------------
// What a lora_tile instantiation computes: kFused (sgmv_fused, fused_lora)
// y (T, M) from x; kRhs (matmul_rhs, sgmv_rhs: an A-only call) h (T, r_hi)
// from x; kOut (matmul_out, sgmv_out: a B-only call) y (T, M) from h.
enum class Mode { kFused, kRhs, kOut };

// One cluster's work for token rows [row0, row0 + live) with the sides `sd`
// (already offset to the tile's adapter); live <= TR. Phase 1 and the
// rank-order reduction of h are the one path of kFused and kRhs. kFused
// adds phase 2 and writes y (T, M); kRhs stores h (T, r_hi) to p.out, the
// tile's live × r_hi elements split among the C blocks in row-major order,
// so each is summed and stored by one block, consecutive threads on
// consecutive addresses. kOut (plain blocks, block b of a tile being
// blockIdx.x mod C) loads the tile's h rows from p.x in place of phase 1
// and the reduction, then runs the same phase 2. (A compile-time mode, not
// a function per phase: a phase-1 function of its own cost the fused
// kernels up to 15 registers and 6 % at a prefill shape on an H100.)
template <int TR, typename XT, Mode MODE>
__device__ void lora_tile(const Params& p, const QSide (&sd)[4], int row0,
                          int live) {
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  unsigned char* smem = cluster_smem;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = MODE == Mode::kOut
                       ? static_cast<int>(blockIdx.x % p.plan.cluster)
                       : static_cast<int>(cl.block_rank());
  const Plan& pl = p.plan;
  const Layout l = MODE == Mode::kOut
                       ? out_layout(p, TR)
                       : make_layout(p, TR, static_cast<int>(sizeof(XT)));
  constexpr int kSides = MODE == Mode::kOut ? 2 : 4;  // an out call: side 1
  const int slots = p.r_hi + p.r_lo;
  float* hp = reinterpret_cast<float*>(smem + l.hp);
  float* hf = reinterpret_cast<float*>(smem + l.hf);
  XT* xs = reinterpret_cast<XT*>(smem + l.xs);
  float* ys = reinterpret_cast<float*>(smem + l.ys);
  const int xs_stride = l.xs_stride / static_cast<int>(sizeof(XT));
  const XT* x = static_cast<const XT*>(p.x);

  // this block's K and M units
  const int nu_k = MODE == Mode::kOut ? 0 : (p.K + pl.k_unit - 1) / pl.k_unit;
  const int nu_m = (p.M + pl.m_unit - 1) / pl.m_unit;
  const int ku0 = rank * pl.k_units, ku1 = min(nu_k, ku0 + pl.k_units);
  const int mu0 = rank * pl.m_units, mu1 = min(nu_m, mu0 + pl.m_units);

  auto stage_k = [&](int u) {         // x rows and A sides of K chunk u
    const int c0 = u * pl.k_unit;
    const int c1 = min(u + pl.k_chunk, ku1) * pl.k_unit;
    const int ncols = min(p.K, c1) - c0;
    copy_rows(xs, l.xs_stride, x + static_cast<size_t>(row0) * p.K + c0,
              static_cast<size_t>(p.K) * sizeof(XT), live,
              ncols * static_cast<int>(sizeof(XT)), pl.vec_x);
    for (int s = 0; s < 4; s += 2) {
      int g0, g1;
      if (side_rows(p, s) == 0) continue;
      chunk_groups(sd[s], c0, c1, &g0, &g1);
      stage_side(sd[s], side_rows(p, s), g0, g1, smem, l, s, pl.vec[s]);
    }
  };
  auto stage_m = [&](int u) {         // B sides of M chunk u
    const int c0 = u * pl.m_unit;
    const int c1 = min(u + pl.m_chunk, mu1) * pl.m_unit;
    for (int s = 1; s < kSides; s += 2) {
      int g0, g1;
      if (side_rows(p, s) == 0) continue;
      chunk_groups(sd[s], c0, c1, &g0, &g1);
      stage_side(sd[s], side_rows(p, s), g0, g1, smem, l, s, pl.vec[s]);
    }
  };

  if constexpr (MODE == Mode::kOut) {
    // every load up front: the thread's first element of the tile's h rows
    // (read row-major into a register first, so its latency overlaps the
    // staging), then B's first chunk (cp.async); h is stored slot-major
    // (hf[r·TR + t]), rows past `live` 0. The R·TR elements beyond the
    // first kThreads (R·TR > 256: 32 rank rows at 8 token rows) follow in
    // a strided loop.
    const int R = p.r_hi, n = R * TR, n_live = live * R;
    const float* h =
        static_cast<const float*>(p.x) + static_cast<size_t>(row0) * R;
    const int i0 = threadIdx.x;
    const float h0 = i0 < n_live ? h[i0] : 0.f;
    if (mu0 < mu1) stage_m(mu0);
    cp_async_commit();
    for (int i = i0; i < n; i += kThreads) {
      const float v = i == i0 ? h0 : (i < n_live ? h[i] : 0.f);
      const int t = i / R;
      hf[(i - t * R) * TR + t] = v;
    }
  } else {
    // every load of the first chunks up front: A and x (group 0), B (group 1)
    if (ku0 < ku1) stage_k(ku0);
    cp_async_commit();
    if constexpr (MODE == Mode::kFused) {
      if (mu0 < mu1) stage_m(mu0);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < slots * TR; i += blockDim.x) hp[i] = 0.f;
    // rows past the tile's live rows read 0 (never staged)
    for (int i = threadIdx.x; i < (TR - live) * l.xs_stride; i += blockDim.x)
      (reinterpret_cast<unsigned char*>(xs) + static_cast<size_t>(live) * l.xs_stride)[i] = 0;

    // ---- phase 1: partial h over this block's K slice ----------------------
    for (int u = ku0; u < ku1; u += pl.k_chunk) {
      if (u != ku0) {
        __syncthreads();                // the previous chunk is consumed
        stage_k(u);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();
      const int c0 = u * pl.k_unit;
      const int c1 = min(u + pl.k_chunk, ku1) * pl.k_unit;
      const int ncols = min(p.K, c1) - c0;
      for (int s = 0; s < 4; s += 2) {
        const int rows = side_rows(p, s);
        if (rows == 0) continue;
        int g0, g1;
        chunk_groups(sd[s], c0, c1, &g0, &g1);
        rhs_dispatch<TR>(sd[s], staged(smem, l, s, g0, g1, ncols), rows, xs,
                         xs_stride, hp + (s == 0 ? 0 : p.r_hi * TR));
      }
    }

    // ---- h = Σ over the cluster's partials, in rank order ---------------------
    cl.sync();
    if constexpr (MODE == Mode::kRhs) {
      const int R = p.r_hi, n = live * R, C = pl.cluster;
      const int share = (n + C - 1) / C;
      const int i1 = min(n, (rank + 1) * share);
      float* out = p.out + static_cast<size_t>(row0) * R;
      for (int i = rank * share + threadIdx.x; i < i1; i += blockDim.x) {
        const int t = i / R, r = i - t * R;
        float v = 0.f;
        for (int b = 0; b < C; ++b)
          v += cl.map_shared_rank(hp, b)[r * TR + t];
        out[i] = v;
      }
      cl.sync();                        // the neighbours are done reading hp
      return;
    }
    if (mu0 < mu1) {
      for (int i = threadIdx.x; i < slots * TR; i += blockDim.x) {
        float v = 0.f;
        for (int r = 0; r < pl.cluster; ++r)
          v += cl.map_shared_rank(hp, r)[i];
        hf[i] = v;
      }
    }
    cluster_arrive();                   // done reading the neighbours' hp
  }

  // ---- phase 2: y over this block's M slice ----------------------------------
  cp_async_wait<0>();
  __syncthreads();
  for (int u = mu0; u < mu1; u += pl.m_chunk) {
    if (u != mu0) {
      __syncthreads();                // the previous chunk is stored
      stage_m(u);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int c0 = u * pl.m_unit;
    const int c1 = min(u + pl.m_chunk, mu1) * pl.m_unit;
    const int ncols = min(p.M, c1) - c0;
    for (int s = 1; s < kSides; s += 2) {
      const int rows = side_rows(p, s);
      if (rows == 0) continue;
      int g0, g1;
      chunk_groups(sd[s], c0, c1, &g0, &g1);
      if (s == 3) __syncthreads();    // the high side's sums are stored
      out_dispatch<TR>(sd[s], staged(smem, l, s, g0, g1, ncols), rows,
                       hf + (s == 1 ? 0 : p.r_hi * TR), ys, l.ys_stride,
                       s == 3);
    }
    __syncthreads();
    float* out = p.out + static_cast<size_t>(row0) * p.M + c0;
    if (pl.vec_y == 4) {
      const int n4 = ncols / 4;
      for (int i = threadIdx.x; i < live * n4; i += blockDim.x) {
        const int t = i / n4, c = (i - t * n4) * 4;
        *reinterpret_cast<float4*>(out + static_cast<size_t>(t) * p.M + c) =
            *reinterpret_cast<const float4*>(ys + t * l.ys_stride + c);
      }
    } else {
      for (int i = threadIdx.x; i < live * ncols; i += blockDim.x) {
        const int t = i / ncols, c = i - t * ncols;
        out[static_cast<size_t>(t) * p.M + c] = ys[t * l.ys_stride + c];
      }
    }
  }
  if constexpr (MODE == Mode::kFused)
    cluster_wait();                   // the neighbours are done reading hp
}

// ---- host side -----------------------------------------------------------------

// The dynamic shared memory a block may opt in to on the current device
// (232448 bytes on an H100), read once per device; 0 if it cannot be read.
inline size_t smem_optin() {
  constexpr int kMaxDevices = 64;
  static int limit[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (limit[dev] == 0 &&
      cudaDeviceGetAttribute(&limit[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    limit[dev] = 0;
  return static_cast<size_t>(limit[dev]);
}

// Checks of the plan and shapes that the kernel relies on; true if they
// hold. `x_bytes` is the size of one element of x (4 for an out call's
// fp32 h): the layout make_layout gives the plan, which must fit the
// device's opt-in shared memory, the limit `launch` raises the kernel's
// attribute to.
inline bool plan_ok(const Params& p, int tr, int x_bytes) {
  const Plan& pl = p.plan;
  if (pl.cluster < 1 || pl.cluster > kMaxCluster || pl.k_unit < 1 ||
      pl.m_unit < 1 || tr < 1 || tr > 8 || (p.K == 0 && p.M == 0))
    return false;
  if (p.K > 0 && (pl.k_units < 1 || pl.k_chunk < 1)) return false;
  if (p.M > 0 && (pl.m_units < 1 || pl.m_chunk < 1)) return false;
  // A-only and B-only: one side
  if ((p.K == 0 || p.M == 0) && p.r_lo != 0) return false;
  // an out call's blocks lay out shared memory by out_layout
  if (p.K == 0 && out_layout(p, tr).total != make_layout(p, tr, 4).total)
    return false;
  if (static_cast<long long>(pl.cluster) * pl.k_units * pl.k_unit < p.K ||
      static_cast<long long>(pl.cluster) * pl.m_units * pl.m_unit < p.M)
    return false;
  for (int s = 0; s < 4; ++s) {
    if (side_rows(p, s) == 0 || ((s & 1) ? p.M == 0 : p.K == 0)) continue;
    const int unit = (s & 1) ? pl.m_unit : pl.k_unit;
    const int v = pl.vec[s];
    if (unit % p.side[s].group != 0 || (v != 16 && v != 4 && v != 1) ||
        (p.side[s].wpg * word_bytes(p.side[s])) % v != 0)
      return false;
  }
  if (make_layout(p, tr, x_bytes).total > smem_optin()) return false;
  return pl.vec_x == 16 || pl.vec_x == 4 || pl.vec_x == 1;
}

// Launch `Kernel` over `tiles` clusters of plan.cluster blocks (or, for a
// kernel that reads no neighbour's shared memory, `cluster` false, as many
// plain blocks); returns the launch's CUDA error (0 on success). The
// function attributes are set once per kernel and only raised, up to the
// opt-in limit that plan_ok holds the layout to, so a launch captured into
// a CUDA graph after a first launch of the same or a larger layout makes
// no attribute call.
template <auto Kernel>
inline int launch(const Params& p, int tr, int x_bytes, int tiles,
                  cudaStream_t stream, bool cluster = true) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = make_layout(p, tr, x_bytes).total;
  cudaError_t e = cudaSuccess;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * p.plan.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, Kernel, p);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// The plan as `ClusterPlan.args()` in kernel.py orders it: cluster,
// tile_rows, k_unit, k_units, k_chunk, m_unit, m_units, m_chunk, vec_x,
// vec_y, vec of A_hi B_hi A_lo B_lo (tile_rows is the launcher's).
inline Plan make_plan(const int* a) {
  return Plan{a[0], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
              {a[10], a[11], a[12], a[13]}};
}

// The Params of an A-only call (matmul_rhs, sgmv_rhs): side 0 is A (NA
// stacked adapters of R rows), h (T, R) goes to `out`. B_hi is never read:
// with M = 0 it has no columns, and a group of 1 gives it no shared memory
// (make_layout).
inline Params rhs_params(const void* x, const QSide& a,
                         const int32_t* seg_map, float* out, int T, int K,
                         int NA, int R, int kt, const int* plan) {
  Params p = {};
  p.x = x;
  p.side[0] = a;
  p.side[1].group = 1;
  p.seg_map = seg_map;
  p.out = out;
  p.T = T; p.K = K; p.M = 0; p.NA = NA;
  p.r_hi = R; p.r_lo = 0; p.kt = kt;
  p.plan = make_plan(plan);
  return p;
}

// The Params of a B-only call (matmul_out, sgmv_out): h (T, R) fp32 is
// read from `h`, side 1 is Bᵀ (NA stacked adapters of R rows), y (T, M)
// goes to `out`. A_hi is never read: with K = 0 it has no columns, and a
// group of 1 gives it no shared memory (make_layout).
inline Params out_params(const float* h, const QSide& b,
                         const int32_t* seg_map, float* out, int T, int M,
                         int NA, int R, int kt, const int* plan) {
  Params p = {};
  p.x = h;
  p.side[0].group = 1;
  p.side[1] = b;
  p.seg_map = seg_map;
  p.out = out;
  p.T = T; p.K = 0; p.M = M; p.NA = NA;
  p.r_hi = R; p.r_lo = 0; p.kt = kt;
  p.plan = make_plan(plan);
  return p;
}

}  // namespace cluster
}  // namespace loraquant
