// Tile helpers shared by the K2 forward (short_attention_fwd.cu) and the K2
// backward (short_attention_bwd.cu): mma.sync m16n8k16 bf16 fragments of
// a warp's 16 rows against 64-row tiles held in shared memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4g + t;
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):       b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-wide k-step: the probabilities (or dS) a warp computes
// feed its next product straight from registers.
#pragma once

#include "common.cuh"

namespace mm {
namespace sa {

constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;  // rows of a block's own tile (queries or keys)
constexpr int TILE = 64;          // rows of a streamed tile (keys or queries)

// Shared-memory row stride in elements: rows padded by 8 bf16 so that the
// 32-bit fragment loads of the 8 row groups g of a warp fall on distinct
// banks, and the 16-bit loads of two neighbouring rows do too.
template <int DH> __host__ __device__ constexpr int ld() { return DH + 8; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// `rows` rows of DH bf16 from global (row r at src + (base + r) * ld_src)
// into shared memory (row stride ld<DH>()), 16 bytes per cp.async; rows at
// or past `valid` are zero-filled. Commits one group.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int ld_src,
                                          size_t base, int rows, int valid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += WARPS * 32) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * ld<DH>() + c, src + (base + (ok ? r : 0)) * (size_t)ld_src + c, ok);
  }
  cp_async_commit();
}

// A fragments of a warp's 16 rows (r0 = its first row, g/g+8 inside it)
// straight from global: row r at src + (base + r) * ld_src; rows at or past
// `valid` read as zero.
template <int DH>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[DH / 16][4], const bf16* src,
                                              int ld_src, size_t base, int r0, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  const bf16* pa = src + (base + (ra < valid ? ra : 0)) * (size_t)ld_src;
  const bf16* pb = src + (base + (rb < valid ? rb : 0)) * (size_t)ld_src;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ra < valid ? ld32(pa + c) : 0u;
    a[kk][1] = rb < valid ? ld32(pb + c) : 0u;
    a[kk][2] = ra < valid ? ld32(pa + c + 8) : 0u;
    a[kk][3] = rb < valid ? ld32(pb + c + 8) : 0u;
  }
}

// acc (16 x TILE) = A (16 x DH) . S^T, S a shared-memory tile of TILE rows
// of DH: the product of a warp's rows with every row of the tile
// (contracting the head width). B[k][n] = S[n][k]: two contiguous bf16.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[TILE / 8][4],
                                                  const uint32_t (&a)[DH / 16][4],
                                                  const bf16* s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
      const bf16* p = s + (nt * 8 + g) * ld<DH>() + kk * 16 + 2 * t;
      const uint32_t b[2] = {ld32(p), ld32(p + 8)};
      mma_16816(acc[nt], a[kk], b);
    }
}

// acc (16 x DH) += P (16 x TILE, A fragments pa) . S, S a shared-memory tile
// of TILE rows of DH (contracting the tile's rows). B[k][n] = S[k][n]: two
// 16-bit loads from neighbouring rows, packed.
template <int DH>
__device__ __forceinline__ void probs_times_tile(float (&acc)[DH / 8][4],
                                                 const uint32_t (&pa)[TILE / 16][4],
                                                 const bf16* s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const bf16* r = s + (kk * 16 + 2 * t) * ld<DH>() + g;
#pragma unroll
    for (int ot = 0; ot < DH / 8; ++ot) {
      const bf16* p = r + ot * 8;
      const uint32_t b[2] = {pack2(p[0], p[ld<DH>()]),
                             pack2(p[8 * ld<DH>()], p[9 * ld<DH>()])};
      mma_16816(acc[ot], pa[kk], b);
    }
  }
}

// The C fragments v (16 x TILE, fp32) as bf16 A fragments of TILE/16 k-steps.
__device__ __forceinline__ void to_a(uint32_t (&a)[TILE / 16][4], const float (&v)[TILE / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    a[kk][0] = pack_f2(v[2 * kk][0], v[2 * kk][1]);
    a[kk][1] = pack_f2(v[2 * kk][2], v[2 * kk][3]);
    a[kk][2] = pack_f2(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    a[kk][3] = pack_f2(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

// Rows r0 + g and r0 + g + 8 of acc (16 x DH) to global as bf16: row r at
// dst + (base + r) * ld_dst; rows at or past `valid` are not written.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, int ld_dst, size_t base, int r0,
                                           int valid, const float (&acc)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= valid) continue;
    bf16* row = dst + (base + r) * (size_t)ld_dst + 2 * t;
#pragma unroll
    for (int ot = 0; ot < DH / 8; ++ot)
      *reinterpret_cast<__nv_bfloat162*>(row + ot * 8) =
          __floats2bfloat162_rn(acc[ot][2 * h], acc[ot][2 * h + 1]);
  }
}

// Max and sum over the 4 lanes (t) that share a row of a C fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace sa
}  // namespace mm
