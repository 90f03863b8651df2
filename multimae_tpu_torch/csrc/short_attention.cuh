// Tile helpers of the K2 backward (short_attention_bwd.cu), and of the K2
// forward (short_attention_fwd.cu) around its wgmma products: mma.sync
// m16n8k16 bf16 products of a warp's 16 rows against row tiles held in
// shared memory, with every operand fragment taken from shared memory by
// ldmatrix (.trans where the tile's rows are the product's k), the softmax
// helpers, and cp.async copies that fill a ring of shared-memory stages
// while the tensor cores work on another.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4g + t;
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):       b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// ldmatrix.x4 hands lane 4g + t the pair (row g, columns 2t, 2t+1) of each
// of four 8 x 8 matrices whose row addresses lanes 8i..8i+7 give; with
// .trans, the pair (rows 2t, 2t+1, column g). So one x4 load gives an A
// fragment, or the B fragments of two neighbouring n-tiles.
// The C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-wide k-step: the probabilities (or dS) a warp computes
// feed its next product straight from registers.
#pragma once

#include "common.cuh"

namespace mm {
namespace sa {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a block's own tile (queries or keys)
constexpr int TILE = 64;          // rows of a streamed tile (keys or queries)
constexpr double LOG2E = 1.4426950408889634074;
constexpr float LN2 = 0.69314718055994530942f;

// Shared-memory row stride in elements: rows padded by 8 bf16 (16 bytes),
// so the eight 16-byte rows an ldmatrix phase reads fall on distinct banks
// at every head width (32, 64, 96, 128).
template <int DH> __host__ __device__ constexpr int ld() { return DH + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 2^x on the MUFU unit, subnormal results flushed to zero (exp2f adds a
// range check and two multiplies around the same instruction to keep them;
// a probability below 2^-126 is zero to every sum it enters).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lo and hi rounded to bf16 and packed (lo in the low half) by one
// cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// `rows` rows of DH bf16 from global (row r at src + r * ld_src) into
// shared memory (row stride ld<DH>()), 16 bytes per cp.async, by all the
// block's threads; rows at or past `valid` are zero-filled. Commits nothing:
// the caller groups the copies of one stage.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int ld_src, int rows,
                                          int valid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * ld<DH>() + c, src + (size_t)(ok ? r : 0) * ld_src + c, ok);
  }
}

// The A fragment of k-step kk of rows r0..r0+15 of a shared tile s whose
// rows are the product's m.
template <int DH>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, s + (r0 + (lane & 15)) * ld<DH>() + kk * 16 + (lane >> 4) * 8);
}

// B fragments of k-step kk and n-tiles n0..n0+7 (b[0], b[1]) and
// n0+8..n0+15 (b[2], b[3]) where B[k][n] = s[n][k]: the tile's rows are n.
template <int DH>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int n0, int kk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4(b, s + (n0 + (mi >> 1) * 8 + (lane & 7)) * ld<DH>() + kk * 16 + (mi & 1) * 8);
}

// B fragments of the 16-wide k-step at row k0 and n-tiles n0.. and n0+8..
// where B[k][n] = s[k][n]: the tile's rows are k (ldmatrix .trans).
template <int DH>
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* s, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (mi & 1) * 8 + (lane & 7)) * ld<DH>() + n0 + (mi >> 1) * 8);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc (16 x TILE) = A (16 x DH) . S^T, S a shared tile of TILE rows of DH:
// the warp's rows r0..r0+15 of the shared tile sa_ against every row of
// the tile (contracting the head width); A's fragments are loaded one
// k-step at a time.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[TILE / 8][4], const bf16* sa_,
                                                  int r0, const bf16* s) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    frag_a<DH>(a, sa_, r0, kk);
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      uint32_t b[4];
      frag_b<DH>(b, s, np * 16, kk);
      mma_16816(acc[2 * np], a, b);
      mma_16816(acc[2 * np + 1], a, b + 2);
    }
  }
}

// acc (16 x DH) += P (16 x TILE, A fragments pa) . S, S a shared tile of
// TILE rows of DH (contracting the tile's rows).
template <int DH>
__device__ __forceinline__ void probs_times_tile(float (&acc)[DH / 8][4],
                                                 const uint32_t (&pa)[TILE / 16][4],
                                                 const bf16* s) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t b[4];
      frag_b_t<DH>(b, s, kk * 16, np * 16);
      mma_16816(acc[2 * np], pa[kk], b);
      mma_16816(acc[2 * np + 1], pa[kk], b + 2);
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
