// short_attention forward (K2 fwd): softmax(q . k^T * scale) . v per
// (sample, head), with the fp32 row logsumexp for the backward.
//
// Replaces: multimae_tpu/ops/short_attention_pallas.py `short_attention`
// forward (`_fwd`, Pallas programs `_fwd_kernel_h` / `_fwd_lse_kernel_h`
// (heads-batched) and `_fwd_kernel_ph` / `_fwd_lse_kernel_ph` (per head)).
//
// What bounds it on the H100: at the 512-px fine-tune shape (B=4, N=2049
// tokens, 12 heads of 64, bf16) the two products are 4*B*H*N^2*dh = 51.6
// GFLOP, 52 us at the 989 TFLOP/s bf16 peak, against 4*2049*768*2*4 bytes
// of q, k, v and o (25 MB, 8 us at 3.35 TB/s): tensor-core bound.
//
// The TPU kernel holds whole (Nq, Nk) fp32 rows of a head in VMEM; one
// head's rows at 2049 keys are 16.8 MB, and a block here has 227 KB. So
// this kernel streams 64-key tiles past a block's 64 query rows (one block
// per (query tile, head, sample), four warps of 16 rows), in two passes
// over the keys, so that it rounds where the TPU kernel rounds:
//   pass 1: s = q . k^T * scale (fp32, mma.sync bf16 tiles), the running
//           row max and the row sum of exp(s - max), rescaled as the max
//           grows; lse = max + log(sum);
//   pass 2: s again, p = exp(s - max) / sum in fp32, rounded to bf16, and
//           o += p . v in fp32; o rounded to bf16 once at the end.
// Pass 2 recomputes q . k^T, so the kernel does 1.5x the minimal products.
// q, k and v are read in place from the strided (B, N, 3, H, dh) qkv
// buffer (row strides ldq, ldk, ldv), o is written to (B, N, H*dh): no
// transposes are materialised, the reason for the TPU kernel's BNHD layout.
// Keys past nk are masked to -inf in both passes; query rows past nq read
// as zero and are not written. Faster forms (one online-softmax pass,
// ldmatrix, wgmma with TMA-fed tiles) are later work.

#include "short_attention.cuh"

namespace {

using namespace mm;

// s (16 x TILE) = scale * q . k^T for the warp's rows against key tile j0;
// keys at or past nk are -inf.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[sa::TILE / 8][4],
                                       const uint32_t (&qa)[DH / 16][4], const bf16* sK,
                                       int j0, int nk, float scale) {
  const int t = threadIdx.x & 3;
  sa::rows_times_tile_t<DH>(s, qa, sK);
#pragma unroll
  for (int nt = 0; nt < sa::TILE / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + nt * 8 + 2 * t + (e & 1);
      s[nt][e] = j < nk ? s[nt][e] * scale : -INFINITY;
    }
}

template <int DH>
__global__ void __launch_bounds__(sa::WARPS * 32)
short_attention_fwd_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp,
                           int ldk, const bf16* __restrict__ Vp, int ldv,
                           bf16* __restrict__ O, int ldo, float* __restrict__ lse,
                           int heads, int nq, int nk, float scale) {
  constexpr int LD = sa::ld<DH>();
  __shared__ __align__(16) bf16 sK[sa::TILE * LD];
  __shared__ __align__(16) bf16 sV[sa::TILE * LD];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * sa::ROWS + warp * 16;  // the warp's first query row
  const bf16* kbase = Kp + h * DH;
  const bf16* vbase = Vp + h * DH;

  uint32_t qa[DH / 16][4];
  sa::load_a_global<DH>(qa, Q + h * DH, ldq, (size_t)b * nq, r0, nq);

  // Pass 1: row max m and row sum l of exp(s - m) over all keys, for rows
  // g (u = 0) and g + 8 (u = 1).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[sa::TILE / 8][4];
  for (int j0 = 0; j0 < nk; j0 += sa::TILE) {
    sa::load_rows<DH>(sK, kbase + (size_t)j0 * ldk, ldk, (size_t)b * nk, sa::TILE, nk - j0);
    cp_async_wait<0>();
    __syncthreads();
    scores<DH>(s, qa, sK, j0, nk, scale);
    __syncthreads();  // sK is refilled next
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < sa::TILE / 8; ++nt)
        tm = fmaxf(tm, fmaxf(s[nt][2 * u], s[nt][2 * u + 1]));
      const float mn = fmaxf(m[u], sa::quad_max(tm));
      float ts = 0.f;
#pragma unroll
      for (int nt = 0; nt < sa::TILE / 8; ++nt)
        ts += expf(s[nt][2 * u] - mn) + expf(s[nt][2 * u + 1] - mn);
      l[u] = l[u] * expf(m[u] - mn) + sa::quad_sum(ts);
      m[u] = mn;
    }
  }
  if (lse != nullptr && t == 0) {
    float* out = lse + (size_t)(b * heads + h) * nq;
    if (r0 + g < nq) out[r0 + g] = m[0] + logf(l[0]);
    if (r0 + g + 8 < nq) out[r0 + g + 8] = m[1] + logf(l[1]);
  }

  // Pass 2: o = sum over key tiles of bf16(exp(s - m) / l) . v.
  float o[DH / 8][4];
#pragma unroll
  for (int ot = 0; ot < DH / 8; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;
  for (int j0 = 0; j0 < nk; j0 += sa::TILE) {
    sa::load_rows<DH>(sK, kbase + (size_t)j0 * ldk, ldk, (size_t)b * nk, sa::TILE, nk - j0);
    sa::load_rows<DH>(sV, vbase + (size_t)j0 * ldv, ldv, (size_t)b * nk, sa::TILE, nk - j0);
    cp_async_wait<0>();
    __syncthreads();
    scores<DH>(s, qa, sK, j0, nk, scale);
#pragma unroll
    for (int nt = 0; nt < sa::TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];
    uint32_t pa[sa::TILE / 16][4];
    sa::to_a(pa, s);
    sa::probs_times_tile<DH>(o, pa, sV);
    __syncthreads();  // sK and sV are refilled next
  }
  sa::store_rows<DH>(O + h * DH, ldo, (size_t)b * nq, r0, nq, o);
}

template <int DH>
cudaError_t launch(const bf16* Q, int ldq, const bf16* Kp, int ldk, const bf16* Vp, int ldv,
                   bf16* O, int ldo, float* lse, int batch, int heads, int nq, int nk,
                   cudaStream_t s) {
  dim3 grid((nq + sa::ROWS - 1) / sa::ROWS, heads, batch);
  // dh ** -0.5 in double, rounded once to fp32, as the Python side does.
  const float scale = (float)(1.0 / sqrt((double)DH));
  short_attention_fwd_kernel<DH><<<grid, sa::WARPS * 32, 0, s>>>(
      Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, heads, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace

namespace mm {

cudaError_t short_attention_fwd(const bf16* Q, int ldq, const bf16* Kp, int ldk,
                                const bf16* Vp, int ldv, bf16* O, int ldo, float* lse,
                                int batch, int heads, int nq, int nk, int dh,
                                cudaStream_t s) {
  if (nq < 1 || nk < 1) return cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch<32>(Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, batch, heads, nq, nk, s);
    case 64: return launch<64>(Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, batch, heads, nq, nk, s);
    case 96: return launch<96>(Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, batch, heads, nq, nk, s);
    case 128: return launch<128>(Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm

// q (B, Nq, H, dh), k and v (B, Nk, H, dh) bf16 with unit stride over (H, dh)
// and row strides ldq, ldk, ldv -> o (B, Nq, H*dh) bf16, lse (B, H, Nq) fp32.
extern "C" int mm_short_attention_fwd_bf16(const void* q, int ldq, const void* k, int ldk,
                                           const void* v, int ldv, void* o, void* lse,
                                           int batch, int nq, int nk, int heads, int dh,
                                           void* stream) {
  return static_cast<int>(mm::short_attention_fwd(
      static_cast<const mm::bf16*>(q), ldq, static_cast<const mm::bf16*>(k), ldk,
      static_cast<const mm::bf16*>(v), ldv, static_cast<mm::bf16*>(o), heads * dh,
      static_cast<float*>(lse), batch, heads, nq, nk, dh, static_cast<cudaStream_t>(stream)));
}
