// short_attention backward (K2 bwd): dq, dk and dv of the K2 forward.
//
// Replaces: multimae_tpu/ops/short_attention_pallas.py
// `_short_attention_bwd` -> `_bwd` (Pallas programs `_bwd_kernel_h`
// (heads-batched) and `_bwd_kernel_ph` (per head)).
//
// What it computes, rounding where the TPU kernel rounds (:146-173), from
// the forward's fp32 lse and delta = rowsum(do * o) (fp32, computed by the
// caller outside the kernel as the JAX package does in XLA):
//   p  = exp(s * scale - lse)           s = q . k^T in fp32
//   dv = bf16(p)^T . do                 fp32 sums, rounded to bf16
//   dp = do . v^T                       fp32
//   ds = bf16(p * (dp - delta) * scale)
//   dq = ds . k,  dk = ds^T . q         fp32 sums, rounded to bf16
//
// What bounds it on the H100: five products of N^2 * dh per (sample, head),
// 129 GFLOP at the 512-px fine-tune shape (B=4, N=2049, 12 heads of 64):
// 130 us at the bf16 peak; its 7 slabs of (B, N, H*dh) bf16 are 44 MB
// (13 us at 3.35 TB/s). Tensor-core bound.
//
// Design: deterministic, no float atomics. The TPU kernel holds a head's
// whole (Nq, Nk) fp32 tiles in VMEM; here two kernels stream 64-row tiles:
//   dkdv  one block per (key tile, head, sample), four warps of 16 keys;
//         it walks every query tile in order, recomputes s^T and dp^T for
//         its keys (k and v fragments stay in registers), and accumulates
//         dv += bf16(p)^T . do and dk += ds^T . q in registers;
//   dq    one block per (query tile, head, sample), four warps of 16
//         queries; it walks every key tile in order, recomputes s and dp,
//         and accumulates dq += ds . k.
// Each output element is summed by one thread in a fixed order, so two
// runs give bit-equal results. The recompute makes 7 products of N^2 * dh
// instead of the minimal 5; sharing s and dp across the two passes
// (atomics or a second reduction) is later work, as are ldmatrix and wgmma.

#include "short_attention.cuh"

namespace {

using namespace mm;

constexpr int QT = 32;  // query rows per step of the dkdv kernel

// dk and dv for one block of 64 keys.
template <int DH>
__global__ void __launch_bounds__(sa::WARPS * 32)
dkdv_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp, int ldk,
            const bf16* __restrict__ Vp, int ldv, const bf16* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dK, bf16* __restrict__ dV, int heads, int nq, int nk,
            float scale) {
  constexpr int LD = sa::ld<DH>();
  constexpr int NT = QT / 8;    // n-tiles of a query step
  constexpr int KS = QT / 16;   // k-steps of a query step
  __shared__ __align__(16) bf16 sQ[QT * LD];
  __shared__ __align__(16) bf16 sDO[QT * LD];
  __shared__ float sL[QT], sD[QT];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * sa::ROWS + warp * 16;  // the warp's first key
  const int ld_o = heads * DH;
  const float* lse_bh = lse + (size_t)(b * heads + h) * nq;
  const float* delta_bh = delta + (size_t)(b * heads + h) * nq;

  uint32_t ka[DH / 16][4], va[DH / 16][4];
  sa::load_a_global<DH>(ka, Kp + h * DH, ldk, (size_t)b * nk, j0, nk);
  sa::load_a_global<DH>(va, Vp + h * DH, ldv, (size_t)b * nk, j0, nk);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int ot = 0; ot < DH / 8; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[ot][e] = dv[ot][e] = 0.f;

  for (int i0 = 0; i0 < nq; i0 += QT) {
    sa::load_rows<DH>(sQ, Q + h * DH + (size_t)i0 * ldq, ldq, (size_t)b * nq, QT, nq - i0);
    sa::load_rows<DH>(sDO, dO + h * DH + (size_t)i0 * ld_o, ld_o, (size_t)b * nq, QT, nq - i0);
    for (int r = threadIdx.x; r < QT; r += sa::WARPS * 32) {
      const bool ok = i0 + r < nq;
      sL[r] = ok ? lse_bh[i0 + r] : 0.f;
      sD[r] = ok ? delta_bh[i0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // s^T and dp^T (16 keys x QT queries): C fragments of the warp's keys
    // against the tile's query rows.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* pq = sQ + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* pd = sDO + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t bq[2] = {sa::ld32(pq), sa::ld32(pq + 8)};
        const uint32_t bd[2] = {sa::ld32(pd), sa::ld32(pd + 8)};
        mma_16816(st[nt], ka[kk], bq);
        mma_16816(dpt[nt], va[kk], bd);
      }
    // p^T = exp(s^T * scale - lse) (0 for queries past nq), and
    // ds^T = p^T * (dp^T - delta) * scale.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * t + (e & 1);
        const float p = i0 + i < nq ? expf(st[nt][e] * scale - sL[i]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sD[i]) * scale;
      }
    uint32_t pa[KS][4], dsa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      pa[kk][0] = sa::pack_f2(st[2 * kk][0], st[2 * kk][1]);
      pa[kk][1] = sa::pack_f2(st[2 * kk][2], st[2 * kk][3]);
      pa[kk][2] = sa::pack_f2(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[kk][3] = sa::pack_f2(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      dsa[kk][0] = sa::pack_f2(dpt[2 * kk][0], dpt[2 * kk][1]);
      dsa[kk][1] = sa::pack_f2(dpt[2 * kk][2], dpt[2 * kk][3]);
      dsa[kk][2] = sa::pack_f2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      dsa[kk][3] = sa::pack_f2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
    }
    // dv += bf16(p)^T . do and dk += ds^T . q, contracting the QT queries.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bf16* rq = sQ + (kk * 16 + 2 * t) * LD + g;
      const bf16* rd = sDO + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int ot = 0; ot < DH / 8; ++ot) {
        const bf16* pq = rq + ot * 8;
        const bf16* pd = rd + ot * 8;
        const uint32_t bq[2] = {pack2(pq[0], pq[LD]), pack2(pq[8 * LD], pq[9 * LD])};
        const uint32_t bd[2] = {pack2(pd[0], pd[LD]), pack2(pd[8 * LD], pd[9 * LD])};
        mma_16816(dv[ot], pa[kk], bd);
        mma_16816(dk[ot], dsa[kk], bq);
      }
    }
    __syncthreads();  // the tile is refilled next
  }
  sa::store_rows<DH>(dK + h * DH, ld_o, (size_t)b * nk, j0, nk, dk);
  sa::store_rows<DH>(dV + h * DH, ld_o, (size_t)b * nk, j0, nk, dv);
}

// dq for one block of 64 queries.
template <int DH>
__global__ void __launch_bounds__(sa::WARPS * 32)
dq_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp, int ldk,
          const bf16* __restrict__ Vp, int ldv, const bf16* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dQ, int heads, int nq, int nk, float scale) {
  constexpr int LD = sa::ld<DH>();
  __shared__ __align__(16) bf16 sK[sa::TILE * LD];
  __shared__ __align__(16) bf16 sV[sa::TILE * LD];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * sa::ROWS + warp * 16;  // the warp's first query
  const int ld_o = heads * DH;
  const size_t bh = (size_t)(b * heads + h) * nq;
  const int ra = r0 + g, rb = ra + 8;
  // Rows past nq: lse and delta 0, q and do zero; their dq is not written.
  const float row_lse[2] = {ra < nq ? lse[bh + ra] : 0.f, rb < nq ? lse[bh + rb] : 0.f};
  const float row_delta[2] = {ra < nq ? delta[bh + ra] : 0.f, rb < nq ? delta[bh + rb] : 0.f};

  uint32_t qa[DH / 16][4], da[DH / 16][4];
  sa::load_a_global<DH>(qa, Q + h * DH, ldq, (size_t)b * nq, r0, nq);
  sa::load_a_global<DH>(da, dO + h * DH, ld_o, (size_t)b * nq, r0, nq);
  float dq[DH / 8][4];
#pragma unroll
  for (int ot = 0; ot < DH / 8; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[ot][e] = 0.f;

  float s[sa::TILE / 8][4], dp[sa::TILE / 8][4];
  for (int j0 = 0; j0 < nk; j0 += sa::TILE) {
    sa::load_rows<DH>(sK, Kp + h * DH + (size_t)j0 * ldk, ldk, (size_t)b * nk, sa::TILE, nk - j0);
    sa::load_rows<DH>(sV, Vp + h * DH + (size_t)j0 * ldv, ldv, (size_t)b * nk, sa::TILE, nk - j0);
    cp_async_wait<0>();
    __syncthreads();
    sa::rows_times_tile_t<DH>(s, qa, sK);
    sa::rows_times_tile_t<DH>(dp, da, sV);
#pragma unroll
    for (int nt = 0; nt < sa::TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t + (e & 1);
        const float p = j < nk ? expf(s[nt][e] * scale - row_lse[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]) * scale;
      }
    uint32_t dsa[sa::TILE / 16][4];
    sa::to_a(dsa, s);
    sa::probs_times_tile<DH>(dq, dsa, sK);
    __syncthreads();  // sK and sV are refilled next
  }
  sa::store_rows<DH>(dQ + h * DH, ld_o, (size_t)b * nq, r0, nq, dq);
}

template <int DH>
cudaError_t launch(const bf16* Q, int ldq, const bf16* Kp, int ldk, const bf16* Vp, int ldv,
                   const bf16* dO, const float* lse, const float* delta, bf16* dQ, bf16* dK,
                   bf16* dV, int batch, int heads, int nq, int nk, cudaStream_t s) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  dkdv_kernel<DH><<<dim3((nk + sa::ROWS - 1) / sa::ROWS, heads, batch), sa::WARPS * 32, 0, s>>>(
      Q, ldq, Kp, ldk, Vp, ldv, dO, lse, delta, dK, dV, heads, nq, nk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<DH><<<dim3((nq + sa::ROWS - 1) / sa::ROWS, heads, batch), sa::WARPS * 32, 0, s>>>(
      Q, ldq, Kp, ldk, Vp, ldv, dO, lse, delta, dQ, heads, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Nq, H, dh), k and v (B, Nk, H, dh) bf16 with unit stride over (H, dh)
// and row strides ldq, ldk, ldv; do (B, Nq, H*dh) bf16; lse and delta
// (B, H, Nq) fp32 -> dq (B, Nq, H*dh), dk and dv (B, Nk, H*dh) bf16.
extern "C" int mm_short_attention_bwd_bf16(const void* q, int ldq, const void* k, int ldk,
                                           const void* v, int ldv, const void* dout,
                                           const void* lse, const void* delta, void* dq,
                                           void* dk, void* dv, int batch, int nq, int nk,
                                           int heads, int dh, void* stream) {
  using mm::bf16;
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto D = static_cast<const float*>(delta);
  auto dQ = static_cast<bf16*>(dq);
  auto dK = static_cast<bf16*>(dk);
  auto dV = static_cast<bf16*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (dh) {
    case 32: e = launch<32>(Q, ldq, K, ldk, V, ldv, dO, L, D, dQ, dK, dV, batch, heads, nq, nk, s); break;
    case 64: e = launch<64>(Q, ldq, K, ldk, V, ldv, dO, L, D, dQ, dK, dV, batch, heads, nq, nk, s); break;
    case 128: e = launch<128>(Q, ldq, K, ldk, V, ldv, dO, L, D, dQ, dK, dV, batch, heads, nq, nk, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
