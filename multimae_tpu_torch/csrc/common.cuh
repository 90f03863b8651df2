// Device building blocks shared by the kernel chains, for Hopper (sm_90a):
// the bf16 / fp32 conversions and roundings, warp reductions, the GELU and
// its derivative, cp.async copies and the m16n8k16 mma.sync product, the
// weight-pointer order of the decoder body (K1), and
//
//   layer_norm  one warp per row, fp32 two-pass statistics, eps 1e-6,
//               output in the compute dtype; optionally writes each row's
//               mean and 1/sigma (the backward's recompute keeps them). Any
//               width up to 1024: decoder_tc.cuh falls back to it at widths
//               its vectorised rows do not take.
//   attention   one block per (query tile, head, sample); the sample-head's
//               whole K and V rows sit in shared memory; a warp works on
//               four query rows at once; fp32 logits x scale and softmax,
//               probabilities rounded to the compute dtype before P . V,
//               fp32 accumulation. q, k and v are read in place from the
//               fused projection outputs with row strides, each head a
//               contiguous run of dh columns. Key sets too long for shared
//               memory go to the key-tiled K2 forward (bf16 only). K1's
//               fp32 attention falls back to it where its own kernel's
//               shared memory does not fit.
//
// The GEMMs and the vectorised LayerNorms of K1, K3 and K4 live in
// decoder_tc.cuh; their roundings follow the JAX package's kernels
// (fused_decoder_pallas.py `_dense`, `_attend_fwd_2d`): a GEMM's fp32 sum
// is rounded to the compute dtype, then the bias is added in that dtype,
// then GELU (in fp32) or the residual add, each rounded to the compute
// dtype.
//
// Every launcher enqueues on the caller's stream and returns the CUDA
// error of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mm {

typedef __nv_bfloat16 bf16;

// Weight pointers of the decoder body in DecoderCoreWeights order
// (ops/fused_decoder.py), shared by fused_decoder_fwd.cu and
// fused_decoder_bwd.cu.
enum DecoderField {
  QN_G, QN_B, CN_G, CN_B, ON_G, ON_B, WQ, BQ, WKV, BKV, WXP, BXP, W1, B1, W2, B2,
  N1_G, N1_B, WQKV, BQKV, WP, BP, N2_G, N2_B, WF1, BF1, WF2, BF2, NUM_DECODER_FIELDS
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- LayerNorm

constexpr int LN_MAX_PER_LANE = 32;  // rows of up to 1024 elements
constexpr int LN_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, T* __restrict__ y, int rows, int d,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  float v[LN_MAX_PER_LANE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    v[i] = c < d ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    const float t = c < d ? v[i] - mean : 0.f;
    q += t * t;
  }
  const float inv = rsqrtf(warp_sum(q) / d + 1e-6f);
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < d) yr[c] = from_f<T>((v[i] - mean) * inv * g[c] + b[c]);
  }
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = inv;
  }
}

template <typename T>
cudaError_t layer_norm(const T* x, const float* g, const float* b, T* y,
                       int rows, int d, cudaStream_t s,
                       float* mean_out = nullptr, float* rstd_out = nullptr) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  layer_norm_kernel<T><<<blocks, LN_WARPS * 32, 0, s>>>(x, g, b, y, rows, d,
                                                        mean_out, rstd_out);
  return cudaGetLastError();
}

// ------------------------------------------------------ shared pieces

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

// d/dx [x Phi(x)] = Phi(x) + x phi(x), the exact-erf GELU's derivative.
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752440f)) +
         x * expf(-0.5f * x * x) * 0.39894228040143267794f;
}

// One m16n8k16 bf16 tensor-core product with fp32 accumulation.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy; rows past the matrix edge are zero-filled
// (source size 0, so nothing is read from `src`).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------- attention

constexpr int ATT_WARPS = 8;
constexpr int ATT_QTILE = 64;  // query rows per block
constexpr int ATT_ROWS = 4;    // query rows a warp works on together

// Shared memory: per warp, the query rows (DH float4: the 4 rows' values
// at each column) and their scores (nk float4); then K and V rows in the
// compute dtype, padded to DH+2 elements so that lanes reading
// neighbouring keys fall on distinct banks.
template <typename T>
inline size_t attention_smem_bytes(int nk, int dh) {
  return 16 * (size_t)ATT_WARPS * (dh + nk) + 2 * (size_t)nk * (dh + 2) * sizeof(T);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row i of sample b, head h: Q + (b*nq + i)*ldq + h*DH (K and V likewise
// with nk, ldkv); output row at O + (b*nq + i)*ldo + h*DH. A warp takes
// ATT_ROWS query rows at a time, so every K and V element it reads from
// shared memory serves four rows: lanes own keys for the scores and
// output columns for P . V.
template <typename T, int DH>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const T* __restrict__ Q, int ldq, const T* __restrict__ Kp,
                 const T* __restrict__ Vp, int ldkv, T* __restrict__ O, int ldo,
                 int nq, int nk, float scale) {
  constexpr int KST = DH + 2;
  constexpr int DPL = DH / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sQ = reinterpret_cast<float4*>(smem_raw);
  float4* sS = sQ + ATT_WARPS * DH;
  T* sK = reinterpret_cast<T*>(sS + ATT_WARPS * nk);
  T* sV = sK + (size_t)nk * KST;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_QTILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < nk * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const size_t off = (size_t)(b * nk + j) * ldkv + h * DH + d;
    sK[j * KST + d] = Kp[off];
    sV[j * KST + d] = Vp[off];
  }
  __syncthreads();

  float4* q = sQ + warp * DH;
  float4* s = sS + warp * nk;
  const int q_end = min(q0 + ATT_QTILE, nq);
  for (int i0 = q0 + warp * ATT_ROWS; i0 < q_end; i0 += ATT_WARPS * ATT_ROWS) {
    // q[d] = the 4 rows' values at column d (rows past the end are zero).
#pragma unroll
    for (int r = 0; r < DPL; ++r) {
      const int d = lane + 32 * r;
      float v[ATT_ROWS];
#pragma unroll
      for (int u = 0; u < ATT_ROWS; ++u)
        v[u] = i0 + u < q_end ? to_f(Q[(size_t)(b * nq + i0 + u) * ldq + h * DH + d]) : 0.f;
      q[d] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();

    float mx[ATT_ROWS] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int j = lane; j < nk; j += 32) {
      const T* kr = sK + j * KST;
      float a[ATT_ROWS] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DH; d += 2) {
        const float2 k2 = load_pair(kr + d);
        const float4 qa = q[d], qb = q[d + 1];
        a[0] = fmaf(qa.x, k2.x, a[0]); a[0] = fmaf(qb.x, k2.y, a[0]);
        a[1] = fmaf(qa.y, k2.x, a[1]); a[1] = fmaf(qb.y, k2.y, a[1]);
        a[2] = fmaf(qa.z, k2.x, a[2]); a[2] = fmaf(qb.z, k2.y, a[2]);
        a[3] = fmaf(qa.w, k2.x, a[3]); a[3] = fmaf(qb.w, k2.y, a[3]);
      }
#pragma unroll
      for (int u = 0; u < ATT_ROWS; ++u) {
        a[u] *= scale;
        mx[u] = fmaxf(mx[u], a[u]);
      }
      s[j] = make_float4(a[0], a[1], a[2], a[3]);
    }
    float sum[ATT_ROWS];
#pragma unroll
    for (int u = 0; u < ATT_ROWS; ++u) {
      mx[u] = warp_max(mx[u]);
      sum[u] = 0.f;
    }
    for (int j = lane; j < nk; j += 32) {
      const float4 v = s[j];
      const float e[ATT_ROWS] = {expf(v.x - mx[0]), expf(v.y - mx[1]),
                                 expf(v.z - mx[2]), expf(v.w - mx[3])};
#pragma unroll
      for (int u = 0; u < ATT_ROWS; ++u) sum[u] += e[u];
      s[j] = make_float4(e[0], e[1], e[2], e[3]);
    }
#pragma unroll
    for (int u = 0; u < ATT_ROWS; ++u) sum[u] = warp_sum(sum[u]);
    for (int j = lane; j < nk; j += 32) {
      const float4 v = s[j];
      s[j] = make_float4(rnd<T>(v.x / sum[0]), rnd<T>(v.y / sum[1]),
                         rnd<T>(v.z / sum[2]), rnd<T>(v.w / sum[3]));
    }
    __syncwarp();

    float o[ATT_ROWS][DPL];
#pragma unroll
    for (int u = 0; u < ATT_ROWS; ++u)
#pragma unroll
      for (int r = 0; r < DPL; ++r) o[u][r] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float4 p = s[j];
      const T* vr = sV + j * KST + lane;
#pragma unroll
      for (int r = 0; r < DPL; ++r) {
        const float v = to_f(vr[32 * r]);
        o[0][r] = fmaf(p.x, v, o[0][r]);
        o[1][r] = fmaf(p.y, v, o[1][r]);
        o[2][r] = fmaf(p.z, v, o[2][r]);
        o[3][r] = fmaf(p.w, v, o[3][r]);
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_ROWS; ++u) {
      if (i0 + u < q_end) {
        T* orow = O + (size_t)(b * nq + i0 + u) * ldo + h * DH;
#pragma unroll
        for (int r = 0; r < DPL; ++r) orow[lane + 32 * r] = from_f<T>(o[u][r]);
      }
    }
    __syncwarp();
  }
}

template <typename T, int DH>
cudaError_t attention_dh(const T* Q, int ldq, const T* Kp, const T* Vp, int ldkv,
                         T* O, int ldo, int batch, int heads, int nq, int nk,
                         cudaStream_t s) {
  const size_t smem = attention_smem_bytes<T>(nk, DH);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + ATT_QTILE - 1) / ATT_QTILE, heads, batch);
  // dh ** -0.5 in double, rounded once to fp32, as the Python side does.
  const float scale = (float)(1.0 / sqrt((double)DH));
  attention_kernel<T, DH><<<grid, ATT_WARPS * 32, smem, s>>>(
      Q, ldq, Kp, Vp, ldkv, O, ldo, nq, nk, scale);
  return cudaGetLastError();
}

constexpr size_t SMEM_LIMIT = 232448;  // shared memory one block may use on sm_90

// The key-tiled K2 forward (short_attention_fwd.cu): bf16 q, k and v rows
// read in place with row strides ldq, ldk and ldv (elements), o written with
// row stride ldo; `lse` (batch, heads, nq) fp32 is written unless it is null.
// Head widths 32, 64, 96 and 128.
cudaError_t short_attention_fwd(const bf16* Q, int ldq, const bf16* Kp, int ldk,
                                const bf16* Vp, int ldv, bf16* O, int ldo, float* lse,
                                int batch, int heads, int nq, int nk, int dh,
                                cudaStream_t s);

// Head widths 32, 64, 96 and 128 (checked by the Python wrappers). Where one
// sample-head's K and V rows do not fit in shared memory (more than ~340
// keys of width 64 in bf16), bf16 attention runs the key-tiled K2 forward
// instead; fp32 has no such path and is refused by the wrappers.
template <typename T>
cudaError_t attention(const T* Q, int ldq, const T* Kp, const T* Vp, int ldkv,
                      T* O, int ldo, int batch, int heads, int nq, int nk, int dh,
                      cudaStream_t s) {
  if (attention_smem_bytes<T>(nk, dh) > SMEM_LIMIT) {
    if constexpr (sizeof(T) == 2)
      return short_attention_fwd(Q, ldq, Kp, ldkv, Vp, ldkv, O, ldo, nullptr, batch, heads,
                                 nq, nk, dh, s);
    return cudaErrorInvalidValue;
  }
  switch (dh) {
    case 32: return attention_dh<T, 32>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 64: return attention_dh<T, 64>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 96: return attention_dh<T, 96>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 128: return attention_dh<T, 128>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
