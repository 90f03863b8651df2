// short_attention backward (K2 bwd): dq, dk and dv of the K2 forward.
//
// Replaces: multimae_tpu/ops/short_attention_pallas.py
// `_short_attention_bwd` -> `_bwd` (Pallas programs `_bwd_kernel_h`
// (heads-batched) and `_bwd_kernel_ph` (per head)), and the XLA reduction
// delta = rowsum(do * o) that the JAX package computes before it (:352-355).
//
// What it computes, rounding where the TPU kernel rounds (:146-173), from
// the forward's o and fp32 lse:
//   delta = rowsum(do * o)              fp32
//   p  = exp(s * scale - lse)           s = q . k^T in fp32
//   dv = bf16(p)^T . do                 fp32 sums, rounded to bf16
//   dp = do . v^T                       fp32
//   ds = bf16(p * (dp - delta) * scale)
//   dq = ds . k,  dk = ds^T . q         fp32 sums, rounded to bf16
// Exponentials are 2^x of x = s * (scale * log2 e) - lse * log2 e.
//
// What bounds it on the H100: five products of N^2 * dh per (sample, head),
// 129 GFLOP at the 512-px fine-tune shape (B=4, N=2049, 12 heads of 64):
// 130 us at the bf16 peak; its 8 slabs of (B, N, H*dh) bf16 are 50 MB
// (15 us at 3.35 TB/s). Tensor-core bound.
//
// Design (Hopper, mma.sync + ldmatrix; wgmma is later work): deterministic,
// no float atomics. The TPU kernel holds a head's whole (Nq, Nk) fp32 tiles
// in VMEM; here three launches, prep then dkdv on the caller's stream and
// dq beside dkdv on a second stream that the caller's stream waits for:
//   prep  delta = rowsum(do * o) and lse * log2 e per (sample, head, query),
//         into a workspace whose rows are padded to a multiple of 128 with
//         delta 0 and lse +inf (so padded queries get p = 0);
//   dkdv  one block of 8 warps per (128-key tile, head, sample), a warp 16
//         keys; it walks every 64-query step in order, with q, do, lse and
//         delta streaming through a 2-stage cp.async ring, recomputes s^T
//         and dp^T for its keys, and accumulates dv += bf16(p)^T . do and
//         dk += ds^T . q in registers;
//   dq    one block of 8 warps per (128-query tile, head, sample), a warp
//         16 queries; it walks every 64-key tile in order, k and v
//         streaming through a 2-stage ring, recomputes s and dp, and
//         accumulates dq += ds . k.
// A warp whose rows all lie past the end (the ragged last tile: 2049 =
// 16 * 128 + 1) only helps with the copies.
// Every fragment comes from shared memory through ldmatrix (.trans for the
// products that contract the tile's rows). Each output element is summed
// by one thread in a fixed order, so two runs give bit-equal results. The
// recompute makes 7 products of N^2 * dh instead of the minimal 5; one
// dK/dV pass whose blocks add their dQ partials in key-tile order would
// make 5.

#include "short_attention.cuh"

namespace {

using namespace mm;

constexpr int QT = sa::TILE;  // query rows per step of the dkdv kernel
constexpr int STAGES = 2;
constexpr int QPAD = sa::ROWS;  // workspace rows are padded to this multiple

inline int padded_rows(int nq) { return (nq + QPAD - 1) / QPAD * QPAD; }

// delta[(b*heads + h)*nq_pad + i] = sum over the head's dh columns of
// do * o, and lse2[...] = lse * log2 e; rows i in [nq, nq_pad) get delta 0
// and lse2 +inf. A group of DH/8 neighbouring lanes (one 16-byte chunk
// each) takes one (sample, query, head).
template <int DH>
__global__ void __launch_bounds__(256)
prep_kernel(const bf16* __restrict__ O, const bf16* __restrict__ dO,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ delta, int batch, int heads, int nq, int nq_pad) {
  constexpr int G = DH / 8;
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t item = idx / G;
  const int c = (int)(idx % G);
  const bool valid = item < (size_t)batch * nq_pad * heads;
  const int h = (int)(item % heads);
  const size_t bi = item / heads;
  const int i = (int)(bi % nq_pad), b = (int)(bi / nq_pad);
  float acc = 0.f;
  if (valid && i < nq) {
    const size_t off = ((size_t)(b * nq + i) * heads + h) * DH + c * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(O + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dO + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]), d = __bfloat1622float2(d2[e]);
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (valid && c == 0) {
    const size_t dst = (size_t)(b * heads + h) * nq_pad + i;
    delta[dst] = i < nq ? acc : 0.f;
    lse2[dst] = i < nq ? lse[(size_t)(b * heads + h) * nq + i] * (float)sa::LOG2E : INFINITY;
  }
}

template <int DH> __host__ __device__ constexpr int rows_elems(int rows) {
  return rows * sa::ld<DH>();
}

// Shared memory of the dkdv kernel: k and v of the block's keys, then
// STAGES stages of {q, do (QT rows each), lse2, delta (QT floats each)}.
template <int DH> __host__ __device__ constexpr size_t dkdv_stage_bytes() {
  return 2 * rows_elems<DH>(QT) * sizeof(bf16) + 2 * QT * sizeof(float);
}
template <int DH> constexpr size_t dkdv_smem() {
  return 2 * rows_elems<DH>(sa::ROWS) * sizeof(bf16) + STAGES * dkdv_stage_bytes<DH>();
}

// dk and dv for one block of 128 keys. c = scale * log2 e.
template <int DH>
__global__ void __launch_bounds__(sa::THREADS)
dkdv_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp, int ldk,
            const bf16* __restrict__ Vp, int ldv, const bf16* __restrict__ dO,
            const float* __restrict__ lse2, const float* __restrict__ delta,
            bf16* __restrict__ dK, bf16* __restrict__ dV, int heads, int nq, int nk,
            int nq_pad, float c, float scale) {
  constexpr int NT = QT / 8;  // n-tiles of a query step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + rows_elems<DH>(sa::ROWS);
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + rows_elems<DH>(sa::ROWS));
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * sa::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = warp * 16;  // the warp's first key in the block's tile
  const bool active = r0 < nk - k0;  // the warp has a key to compute
  const int ld_o = heads * DH;
  const size_t bh = (size_t)(b * heads + h) * nq_pad;
  const int steps = (nq + QT - 1) / QT;

  auto stage = [&](int st, bf16*& q, bf16*& d, float*& L, float*& D) {
    unsigned char* p = ring + (size_t)st * dkdv_stage_bytes<DH>();
    q = reinterpret_cast<bf16*>(p);
    d = q + rows_elems<DH>(QT);
    L = reinterpret_cast<float*>(d + rows_elems<DH>(QT));
    D = L + QT;
  };
  auto issue = [&](int i) {
    if (i < steps) {
      const int i0 = i * QT;
      bf16 *q, *d;
      float *L, *D;
      stage(i % STAGES, q, d, L, D);
      sa::copy_rows<DH>(q, Q + ((size_t)b * nq + i0) * ldq + h * DH, ldq, QT, nq - i0);
      sa::copy_rows<DH>(d, dO + ((size_t)b * nq + i0) * ld_o + h * DH, ld_o, QT, nq - i0);
      // lse2 and delta: QT / 4 16-byte chunks each; the padded workspace
      // always holds them.
      if (threadIdx.x < QT / 2) {
        const int j = (threadIdx.x % (QT / 4)) * 4;
        const bool is_l = threadIdx.x < QT / 4;
        cp_async_16((is_l ? L : D) + j, (is_l ? lse2 : delta) + bh + i0 + j, true);
      }
    }
    cp_async_commit();
  };

  sa::copy_rows<DH>(sK, Kp + ((size_t)b * nk + k0) * ldk + h * DH, ldk, sa::ROWS, nk - k0);
  sa::copy_rows<DH>(sV, Vp + ((size_t)b * nk + k0) * ldv + h * DH, ldv, sa::ROWS, nk - k0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // k and v ride in the first group

  float dk[DH / 8][4], dv[DH / 8][4];
  sa::zero(dk);
  sa::zero(dv);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i's stage has landed; step i-1's is free
    issue(i + STAGES - 1);
    if (!active) continue;
    bf16 *sQ, *sDO;
    float *sL, *sD;
    stage(i % STAGES, sQ, sDO, sL, sD);

    // s^T and dp^T (16 keys x QT queries): the warp's keys against the
    // step's query rows.
    float st[NT][4], dpt[NT][4];
    sa::zero(st);
    sa::zero(dpt);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ak[4], av[4];
      sa::frag_a<DH>(ak, sK, r0, kk);
      sa::frag_a<DH>(av, sV, r0, kk);
#pragma unroll
      for (int np = 0; np < QT / 16; ++np) {
        uint32_t bq[4], bd[4];
        sa::frag_b<DH>(bq, sQ, np * 16, kk);
        sa::frag_b<DH>(bd, sDO, np * 16, kk);
        mma_16816(st[2 * np], ak, bq);
        mma_16816(st[2 * np + 1], ak, bq + 2);
        mma_16816(dpt[2 * np], av, bd);
        mma_16816(dpt[2 * np + 1], av, bd + 2);
      }
    }
    // p^T = exp2(s^T * c - lse2) (0 for padded queries, whose lse2 is
    // +inf), and ds^T = p^T * (dp^T - delta) * scale.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 lq = *reinterpret_cast<const float2*>(sL + nt * 8 + 2 * t);
      const float2 dq = *reinterpret_cast<const float2*>(sD + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sa::exp2_ftz(fmaf(st[nt][e], c, -((e & 1) ? lq.y : lq.x)));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dq.y : dq.x)) * scale;
      }
    }
    uint32_t pa[QT / 16][4], dsa[QT / 16][4];
    sa::to_a(pa, st);
    sa::to_a(dsa, dpt);
    // dv += bf16(p)^T . do and dk += ds^T . q, contracting the QT queries.
    sa::probs_times_tile<DH>(dv, pa, sDO);
    sa::probs_times_tile<DH>(dk, dsa, sQ);
  }
  sa::store_rows<DH>(dK + h * DH, ld_o, (size_t)b * nk + k0, r0, nk - k0, dk);
  sa::store_rows<DH>(dV + h * DH, ld_o, (size_t)b * nk + k0, r0, nk - k0, dv);
}

// Shared memory of the dq kernel: q and do of the block's queries, then
// STAGES stages of {k, v (TILE rows each)}.
template <int DH> constexpr size_t dq_smem() {
  return (2 * rows_elems<DH>(sa::ROWS) + STAGES * 2 * rows_elems<DH>(sa::TILE)) * sizeof(bf16);
}

// dq for one block of 128 queries, two blocks per SM at head widths up to
// 64. c = scale * log2 e.
template <int DH>
__global__ void __launch_bounds__(sa::THREADS, DH <= 64 ? 2 : 1)
dq_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp, int ldk,
          const bf16* __restrict__ Vp, int ldv, const bf16* __restrict__ dO,
          const float* __restrict__ lse2, const float* __restrict__ delta,
          bf16* __restrict__ dQ, int heads, int nq, int nk, int nq_pad, float c,
          float scale) {
  constexpr int NT = sa::TILE / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + rows_elems<DH>(sa::ROWS);
  bf16* ring = sDO + rows_elems<DH>(sa::ROWS);  // stage st: k, then v
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * sa::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's first query in the block's tile
  const bool active = r0 < nq - q0;  // the warp has a query to compute
  const int ld_o = heads * DH;
  const int tiles = (nk + sa::TILE - 1) / sa::TILE;
  // Rows g and g + 8; padded rows (past nq) have lse2 +inf and delta 0,
  // and zero q and do; their dq is not written.
  const size_t bh = (size_t)(b * heads + h) * nq_pad + q0 + r0 + g;
  const float row_lse2[2] = {lse2[bh], lse2[bh + 8]};
  const float row_delta[2] = {delta[bh], delta[bh + 8]};

  auto issue = [&](int i) {
    if (i < tiles) {
      const int j0 = i * sa::TILE;
      bf16* k = ring + (size_t)(i % STAGES) * 2 * rows_elems<DH>(sa::TILE);
      sa::copy_rows<DH>(k, Kp + ((size_t)b * nk + j0) * ldk + h * DH, ldk, sa::TILE, nk - j0);
      sa::copy_rows<DH>(k + rows_elems<DH>(sa::TILE), Vp + ((size_t)b * nk + j0) * ldv + h * DH,
                        ldv, sa::TILE, nk - j0);
    }
    cp_async_commit();
  };

  sa::copy_rows<DH>(sQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, sa::ROWS, nq - q0);
  sa::copy_rows<DH>(sDO, dO + ((size_t)b * nq + q0) * ld_o + h * DH, ld_o, sa::ROWS, nq - q0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // q and do ride in the first group

  float dq[DH / 8][4];
  sa::zero(dq);
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; tile i-1's stage is free
    issue(i + STAGES - 1);
    if (!active) continue;
    const bf16* sK = ring + (size_t)(i % STAGES) * 2 * rows_elems<DH>(sa::TILE);
    const bf16* sV = sK + rows_elems<DH>(sa::TILE);
    const int j0 = i * sa::TILE;
    float s[NT][4], dp[NT][4];
    sa::rows_times_tile_t<DH>(s, sQ, r0, sK);
    sa::rows_times_tile_t<DH>(dp, sDO, r0, sV);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t + (e & 1);
        const float p = j < nk ? sa::exp2_ftz(fmaf(s[nt][e], c, -row_lse2[e >> 1])) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]) * scale;
      }
    uint32_t dsa[sa::TILE / 16][4];
    sa::to_a(dsa, s);
    sa::probs_times_tile<DH>(dq, dsa, sK);
  }
  sa::store_rows<DH>(dQ + h * DH, ld_o, (size_t)b * nq + q0, r0, nq - q0, dq);
}

// A second stream per device, with the two events that fork the dQ pass
// onto it after prep and join it back before the caller's stream goes on:
// the dK/dV and dQ passes read the same inputs and write disjoint outputs,
// so they run side by side and each fills the other's last, ragged wave.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

cudaError_t side_stream(Side*& out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (sd.stream == nullptr) {
    if ((e = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking)) != cudaSuccess ||
        (e = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming)) != cudaSuccess ||
        (e = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming)) != cudaSuccess)
      return e;
  }
  out = &sd;
  return cudaSuccess;
}

template <int DH>
cudaError_t launch(const bf16* Q, int ldq, const bf16* Kp, int ldk, const bf16* Vp, int ldv,
                   const bf16* O, const bf16* dO, const float* lse, float* ws, bf16* dQ,
                   bf16* dK, bf16* dV, int batch, int heads, int nq, int nk, cudaStream_t s) {
  const int nq_pad = padded_rows(nq);
  float* lse2 = ws;
  float* delta = ws + (size_t)batch * heads * nq_pad;
  const size_t threads = (size_t)batch * nq_pad * heads * (DH / 8);
  prep_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      O, dO, lse, lse2, delta, batch, heads, nq, nq_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)DH));
  const float c = (float)(sa::LOG2E / sqrt((double)DH));
  constexpr size_t smem_kv = dkdv_smem<DH>(), smem_q = dq_smem<DH>();
  if ((e = cudaFuncSetAttribute(dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_kv)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_q)) != cudaSuccess)
    return e;
  Side* side = nullptr;
  if ((e = side_stream(side)) != cudaSuccess) return e;
  if ((e = cudaEventRecord(side->fork, s)) != cudaSuccess ||
      (e = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess)
    return e;
  dq_kernel<DH><<<dim3((nq + sa::ROWS - 1) / sa::ROWS, heads, batch), sa::THREADS, smem_q,
                  side->stream>>>(Q, ldq, Kp, ldk, Vp, ldv, dO, lse2, delta, dQ, heads, nq, nk,
                                  nq_pad, c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaEventRecord(side->join, side->stream)) != cudaSuccess) return e;
  dkdv_kernel<DH><<<dim3((nk + sa::ROWS - 1) / sa::ROWS, heads, batch), sa::THREADS, smem_kv, s>>>(
      Q, ldq, Kp, ldk, Vp, ldv, dO, lse2, delta, dK, dV, heads, nq, nk, nq_pad, c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return cudaStreamWaitEvent(s, side->join, 0);
}

}  // namespace

// The fp32 workspace the backward needs at (batch, nq, heads): lse * log2 e
// and delta for every (sample, head) on rows padded to a multiple of 128.
extern "C" int mm_short_attention_bwd_workspace(int batch, int nq, int heads,
                                                long long* elems) {
  *elems = 2LL * batch * heads * padded_rows(nq);
  return 0;
}

// q (B, Nq, H, dh), k and v (B, Nk, H, dh) bf16 with unit stride over (H, dh)
// and row strides ldq, ldk, ldv; o and do (B, Nq, H*dh) bf16; lse (B, H, Nq)
// fp32; ws the workspace above -> dq (B, Nq, H*dh), dk and dv (B, Nk, H*dh)
// bf16.
extern "C" int mm_short_attention_bwd_bf16(const void* q, int ldq, const void* k, int ldk,
                                           const void* v, int ldv, const void* o,
                                           const void* dout, const void* lse, void* ws,
                                           void* dq, void* dk, void* dv, int batch, int nq,
                                           int nk, int heads, int dh, void* stream) {
  using mm::bf16;
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<const bf16*>(o);
  auto dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto W = static_cast<float*>(ws);
  auto dQ = static_cast<bf16*>(dq);
  auto dK = static_cast<bf16*>(dk);
  auto dV = static_cast<bf16*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (dh) {
    case 32: e = launch<32>(Q, ldq, K, ldk, V, ldv, O, dO, L, W, dQ, dK, dV, batch, heads, nq, nk, s); break;
    case 64: e = launch<64>(Q, ldq, K, ldk, V, ldv, O, dO, L, W, dQ, dK, dV, batch, heads, nq, nk, s); break;
    case 128: e = launch<128>(Q, ldq, K, ldk, V, ldv, O, dO, L, W, dQ, dK, dV, batch, heads, nq, nk, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
