// Hopper (sm_90a) tiles shared by the kernel chains of K1 (fused_decoder_
// fwd.cu, fused_decoder_bwd.cu), K3a and K3b (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu) and K4 (fused_block_infer.cu): their GEMMs and
// LayerNorms run here, and K4 runs K1's bf16 attention forward; the
// attention backward and the fp32 kernels are K1's alone (K2 keeps its own
// tiles in short_attention*.cu).
//
//   gemm         bf16 C = A . B on wgmma in three forms: the forward's
//                Y = X . W^T (NT), the backward's dX = G . W (NN) and
//                dW = G^T . X (TN, fp32 partial sums over row slices).
//                Block tiles of 64 or 128 rows x 128 columns; k-steps of
//                64 through a 3-stage cp.async ring of 128-byte-swizzled
//                tiles. A's fragments come from shared memory by ldmatrix
//                (.trans where A's rows are the k index), B goes to wgmma
//                through a descriptor: K-major for W's rows (NT), with the
//                transpose bit where B's rows are k (NN, TN), one 64-column
//                group at a time. Rows of K (and of N) are read in 16-byte
//                chunks, so both are multiples of 8; a ragged last k-step
//                is zero-filled. Epilogues fused: bias, bias + GELU
//                (writing the pre-activation beside it), bias + residual,
//                none, GELU'; the TN form adds the column sums of G (db)
//                in the same pass over G.
//   gemm (fp32)  the same three forms and epilogues on true fp32 FMA (no
//                TF32): 128 x 128 block tiles, 8 x 8 outputs a thread,
//                k-steps of 8 double-buffered in shared memory, 16-byte
//                global loads.
//   attention    bf16 forward on mma.sync m16n8k16: one block of 4 warps
//                per (64 queries, head, sample) holds the head's K and V
//                in shared memory; a warp's 16 query rows keep their score
//                tile in registers, 64 keys at a time, in two passes (the
//                row max and sum, then p = exp(s - m) / l rounded to bf16
//                before P . V, as the TPU kernel rounds).
//   attention    bf16 backward on mma.sync, two launches:
//     bwd        rows: a block per (64 queries, head, sample); pass 1
//                gives each row's max, sum and delta = sum dP * P (the fp32
//                P, accumulated beside the sum and rescaled with it);
//                pass 2 forms P, dP, dS = bf16(P (dP - delta) scale) and
//                dQ = dS . K, and writes the row statistics;
//                keys: a block per (64 keys, head, sample) holds all of
//                the head's Q and dO rows; it forms P^T and dS^T from the
//                statistics and sums dV = bf16(P)^T . dO and dK = dS^T . Q
//                over the queries in order.
//   attention    fp32 forward and backward: the same blocks and passes on
//     (fp32)     register-tiled FMA, each thread 8 rows x 4 columns of a
//                64 x 64 score tile, probabilities staged in shared memory
//                for the products that contract the keys.
//   layer_norm,  one warp per row as common.cuh's LayerNorm, each
//   ln_backward  lane a contiguous run of the row in 16-byte pieces (d of
//                128 to 1024; 384, the ConvNeXt head's, in 8-byte pieces);
//                dgamma / dbeta from partial sums over 128-row slices (one
//                block per slice: the whole card, not 25 blocks), added in
//                order.
//
// Roundings follow fused_decoder_pallas.py `_core_fwd` / `_core_bwd` (see
// epi_value below for the epilogues). Every sum that reaches an output is taken
// in a fixed order by one thread or one fixed reduction; no atomics. The
// definitions sit in an anonymous namespace: each translation unit that
// includes the header gets its own copy, so the shared library links
// without duplicate symbols.
#pragma once

#include "short_attention.cuh"

namespace mm {
namespace dtc {
namespace {

using sa::ldsm_x4;
using sa::ldsm_x4_t;
using sa::smem_addr;

#define DTC_TRY(expr)                           \
  do {                                          \
    const cudaError_t e_ = (expr);              \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

// The dynamic shared memory a kernel may use, set once per kernel and
// device (later launches asking for no more skip the host call).
template <auto KERN>
cudaError_t smem_attr(size_t bytes) {
  static size_t set[64] = {};
  int dev = 0;
  DTC_TRY(cudaGetDevice(&dev));
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (set[dev] >= bytes) return cudaSuccess;
  DTC_TRY(cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  set[dev] = bytes;
  return cudaSuccess;
}

// out1[e] = sum over z < S of part1[z * n1 + e] (e < n1), and likewise
// out2 from part2 (n2 may be 0), each in slice order: two column
// reductions in one launch.
__global__ void sum_slices2_kernel(const float* __restrict__ part1, size_t n1,
                                   float* __restrict__ out1, const float* __restrict__ part2,
                                   size_t n2, float* __restrict__ out2, int S) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n1 + n2;
       e += (size_t)gridDim.x * blockDim.x) {
    const bool first = e < n1;
    const float* p = first ? part1 + e : part2 + (e - n1);
    const size_t n = first ? n1 : n2;
    float acc = 0.f;
    for (int z = 0; z < S; ++z) acc += p[(size_t)z * n];
    (first ? out1[e] : out2[e - n1]) = acc;
  }
}

inline cudaError_t sum_slices2(const float* part1, size_t n1, float* out1, const float* part2,
                               size_t n2, float* out2, int S, cudaStream_t s) {
  const size_t n = n1 + n2;
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  sum_slices2_kernel<<<blocks, 256, 0, s>>>(part1, n1, out1, part2, n2, out2, S);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The descriptor of a 128-byte-swizzled shared-memory tile at p (1024-byte
// aligned groups of 8 rows of 128 bytes): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// wgmma.mma_async m64nNk16 bf16 -> fp32, A from registers (each warp's 16
// rows in the mma.sync A-fragment layout), B by descriptor; d[4 j + e] is
// C fragment e of n-tile j of the warp's rows. TNSP = 1: B's rows are k.
template <int N> struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TNSP));
  }
};

template <>
struct Wgmma<128> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TNSP));
  }
};

// ------------------------------------------------------------- epilogues

// What a GEMM writes: the rounded product with bias (BIAS), GELU of it
// with the pre-activation in Y2 (GELU2), the residual R added (RES), alone
// (NONE), times GELU'(R) with R the pre-activation (DGELU), or fp32
// partial sums of a row slice (PART, the TN form).
enum Epi { BIAS = 0, GELU = 1, GELU2 = 2, RES = 3, NONE = 4, DGELU = 5, PART = 6 };

template <typename T>
struct GemmArgs {
  const T* A;      // NT, NN: (M, K) rows of lda; TN: (K, M) rows of lda
  const T* B;      // NT: (N, K) rows of ldb; NN, TN: (K, N) rows of ldb
  int lda, ldb;
  int M, N, K;     // output M x N, reduction over K
  int kslice;      // TN: rows of K per slice (blockIdx.z); else K
  const T* bias;   // (N,)
  const T* R;      // (M, N): residual or pre-activation; may alias Y
  T* Y;            // (M, N)
  T* Y2;           // GELU2: the pre-activation (M, N)
  float* part;     // PART: (slices, M, N) fp32
  float* colsum;   // PART: (slices, M) fp32 column sums of the TN form's A, or null
};

// The epilogue of one output element at (m, n) from the fp32 sum `acc`;
// returns the value to store in Y (rounded to T by the caller's store).
template <typename T, int EPI>
__device__ __forceinline__ float epi_value(const GemmArgs<T>& p, int m, int n, float acc) {
  float v = rnd<T>(acc);
  const size_t off = (size_t)m * p.N + n;
  if (EPI == DGELU) {
    v = v * gelu_grad(to_f(p.R[off]));
  } else if (EPI != NONE) {
    v = rnd<T>(v + to_f(p.bias[n]));
    if (EPI == GELU2) p.Y2[off] = from_f<T>(v);
    if (EPI == GELU || EPI == GELU2) v = gelu_f(v);
    if (EPI == RES) v = to_f(p.R[off]) + v;
  }
  return v;
}

// Eight bf16 at p (16-byte aligned) as floats, and back (rounded).
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x, v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// epi_value for the eight outputs (m, n..n+7) whose rounded sums sit at c.
template <int EPI>
__device__ __forceinline__ void epi8(const GemmArgs<bf16>& p, int m, int n, const bf16* c) {
  const size_t off = (size_t)m * p.N + n;
  float v[8], r[8];
  load8(c, v);
  if (EPI == DGELU) {
    load8(p.R + off, r);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] * gelu_grad(r[e]);
  } else if (EPI != NONE) {
    load8(p.bias + n, r);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = rnd<bf16>(v[e] + r[e]);
    if (EPI == GELU2) store8(p.Y2 + off, v);
    if (EPI == GELU || EPI == GELU2) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gelu_f(v[e]);
    }
    if (EPI == RES) {
      load8(p.R + off, r);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = r[e] + v[e];
    }
  }
  store8(p.Y + off, v);
}

// --------------------------------------------------------- bf16 on wgmma

constexpr int GBN = 128, GBK = 64, GSTAGES = 3;

// A group of `rows` rows of 64 bf16 (128 bytes) in shared memory, 16-byte
// chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle; groups are
// 1024-byte aligned). Fills it from global, row r at src + r * ld,
// chunk c at + 8c; rows at or past `vrows` and chunks at or past `vchunks`
// are zero-filled. Commits nothing.
template <int THREADS>
__device__ __forceinline__ void copy_group(bf16* dst, const bf16* src, int ld, int rows,
                                           int vrows, int vchunks) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r < vrows && c < vchunks;
    cp_async_16(dst + r * 64 + ((c ^ (r & 7)) << 3), ok ? src + (size_t)r * ld + c * 8 : src,
                ok);
  }
}

// Element (r, c8 * 8) of a swizzled group (c8 the 16-byte chunk).
__device__ __forceinline__ const bf16* sw_at(const bf16* g, int r, int c8) {
  return g + r * 64 + ((c8 ^ (r & 7)) << 3);
}

template <int WG>
__host__ __device__ constexpr int gemm_stage_elems() {
  return 64 * WG * GBK + GBN * GBK;
}

template <int WG>
constexpr size_t gemm_smem() {
  return (size_t)GSTAGES * gemm_stage_elems<WG>() * sizeof(bf16);
}

// One block: 64 * WG output rows (a warpgroup each) x GBN columns, over
// the reduction range of its slice. A_T: A's rows are k (the TN form);
// B_T: B's rows are k (NN and TN).
template <int EPI, int WG, bool A_T, bool B_T>
__global__ void __launch_bounds__(128 * WG)
tc_gemm_kernel(const GemmArgs<bf16> p) {
  constexpr int THREADS = 128 * WG, BM = 64 * WG;
  constexpr int A_ELEMS = BM * GBK, STAGE = gemm_stage_elems<WG>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * GBN;
  const int k_begin = blockIdx.z * p.kslice;
  const int k_end = min(p.K, k_begin + p.kslice);
  const int steps = (k_end - k_begin + GBK - 1) / GBK;

  auto issue = [&](int i) {
    if (i < steps) {
      bf16* sA = ring + (size_t)(i % GSTAGES) * STAGE;
      bf16* sB = sA + A_ELEMS;
      const int k0 = k_begin + i * GBK, kv = k_end - k0;
      if constexpr (!A_T) {
        copy_group<THREADS>(sA, p.A + (size_t)m0 * p.lda + k0, p.lda, BM, p.M - m0, kv / 8);
      } else {
#pragma unroll
        for (int gm = 0; gm < BM / 64; ++gm)
          copy_group<THREADS>(sA + gm * 64 * 64, p.A + (size_t)k0 * p.lda + m0 + gm * 64, p.lda,
                              64, kv, (p.M - m0 - gm * 64) / 8);
      }
      if constexpr (!B_T) {
        copy_group<THREADS>(sB, p.B + (size_t)n0 * p.ldb + k0, p.ldb, GBN, p.N - n0, kv / 8);
      } else {
#pragma unroll
        for (int gn = 0; gn < GBN / 64; ++gn)
          copy_group<THREADS>(sB + gn * 64 * 64, p.B + (size_t)k0 * p.ldb + n0 + gn * 64, p.ldb,
                              64, kv, (p.N - n0 - gn * 64) / 8);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < GSTAGES - 1; ++i) issue(i);

  float acc[GBN / 8][4];
  sa::zero(acc);
  float csum = 0.f;  // PART: this thread's column of A (threadIdx.x < BM)
  const bool do_colsum = EPI == PART && p.colsum != nullptr && blockIdx.x == 0;
  const int r0 = warp * 16;  // the warp's first row in the block's tile

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<GSTAGES - 2>();
    // the copies (generic proxy) become visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step i's tiles have landed; step i-1's stage is free
    issue(i + GSTAGES - 1);
    const bf16* sA = ring + (size_t)(i % GSTAGES) * STAGE;
    const bf16* sB = sA + A_ELEMS;

    uint32_t a[GBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      if constexpr (!A_T) {
        const int r = r0 + (lane & 15);
        ldsm_x4(a[kk], sw_at(sA, r, kk * 2 + (lane >> 4)));
      } else {
        // A[m][k] = sA[k][m]: lanes 8i..8i+7 address k rows of matrix i
        // (i & 1: m + 8; i & 2: k + 8), transposed on the way in.
        const int k = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int m = r0 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(a[kk], sw_at(sA + (m >> 6) * 64 * 64, k, (m & 63) >> 3));
      }
    }
    if (do_colsum && threadIdx.x < BM) {
      const int m = threadIdx.x;
      const bf16* grp = sA + (m >> 6) * 64 * 64;
      for (int k = 0; k < GBK; ++k)
        csum += to_f(sw_at(grp, k, (m & 63) >> 3)[m & 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      if constexpr (!B_T) {
        Wgmma<GBN>::template run<0>(&acc[0][0], a[kk], desc_sw128(sB + kk * 16, 16, 1024));
      } else {
#pragma unroll
        for (int gn = 0; gn < GBN / 64; ++gn)
          Wgmma<64>::template run<1>(&acc[gn * 8][0], a[kk],
                                     desc_sw128(sB + gn * 64 * 64 + kk * 16 * 64, 16, 1024));
      }
    }
    wg_commit_wait();
  }

  // C fragments: rows g and g + 8 of the warp's 16, columns 8j + 2t, +1.
  if constexpr (EPI == PART) {
#pragma unroll
    for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + g + 8 * h, n = n0 + j * 8 + 2 * t;
        if (m < p.M && n < p.N)
          *reinterpret_cast<float2*>(p.part + ((size_t)blockIdx.z * p.M + m) * p.N + n) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
  } else {
    // The tile, rounded to bf16 (the epilogue's first rounding), through
    // shared memory, so the epilogue reads R and bias and writes Y in
    // 16-byte pieces, a row's 256 bytes by 16 neighbouring threads.
    constexpr int CLD = GBN + 8;  // padded: the fragment stores hit distinct banks
    bf16* sC = ring;
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(sC + (r0 + g + 8 * h) * CLD + j * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * (GBN / 8); idx += THREADS) {
      const int r = idx / (GBN / 8), c = (idx % (GBN / 8)) * 8;
      const int m = m0 + r, n = n0 + c;
      if (m < p.M && n < p.N) epi8<EPI>(p, m, n, sC + r * CLD + c);
    }
  }
  if (do_colsum && threadIdx.x < BM && m0 + (int)threadIdx.x < p.M)
    p.colsum[(size_t)blockIdx.z * p.M + m0 + threadIdx.x] = csum;
}

template <int EPI, int WG, bool A_T, bool B_T>
cudaError_t launch_tc(const GemmArgs<bf16>& p, int slices, cudaStream_t s) {
  constexpr size_t smem = gemm_smem<WG>();
  DTC_TRY((smem_attr<tc_gemm_kernel<EPI, WG, A_T, B_T>>(smem)));
  dim3 grid((p.N + GBN - 1) / GBN, (p.M + 64 * WG - 1) / (64 * WG), slices);
  tc_gemm_kernel<EPI, WG, A_T, B_T><<<grid, 128 * WG, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------- fp32 on FMA

constexpr int FT = 128, FK = 8, FLD = FT + 4;

// One block of 256 threads: a 128 x 128 output tile, thread (ty, tx) the
// rows ty*4 + i and 64 + ty*4 + i, the columns tx*4 + j and 64 + tx*4 + j
// (i, j < 4); both operands staged k-major ([k][m], [k][n]) in two shared
// buffers, the next k-step's 16-byte loads held in registers meanwhile.
template <int EPI, bool A_T, bool B_T>
__global__ void __launch_bounds__(256)
f32_gemm_kernel(const GemmArgs<float> p) {
  __shared__ __align__(16) float sA[2][FK][FLD];
  __shared__ __align__(16) float sB[2][FK][FLD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int k_begin = blockIdx.z * p.kslice;
  const int k_end = min(p.K, k_begin + p.kslice);
  const int steps = (k_end - k_begin + FK - 1) / FK;
  const bool do_colsum = EPI == PART && p.colsum != nullptr && blockIdx.x == 0;

  // One float4 of each operand per thread and k-step. Not transposed
  // (rows m or n, k contiguous): row tid / 2, k (tid % 2) * 4. Transposed
  // (rows k): k row tid / 32, columns (tid % 32) * 4.
  auto load = [&](const float* X, int ld, int x0, int xmax, bool trans, int k0, float4& v) {
    int r, k;
    if (!trans) {
      r = tid >> 1, k = k0 + (tid & 1) * 4;
      v = (x0 + r < xmax && k < k_end)
              ? *reinterpret_cast<const float4*>(X + (size_t)(x0 + r) * ld + k)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      k = k0 + (tid >> 5), r = (tid & 31) * 4;
      v = (x0 + r < xmax && k < k_end)
              ? *reinterpret_cast<const float4*>(X + (size_t)k * ld + x0 + r)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](float (*S)[FLD], bool trans, const float4& v) {
    if (!trans) {
      const int r = tid >> 1, k = (tid & 1) * 4;
      S[k][r] = v.x;
      S[k + 1][r] = v.y;
      S[k + 2][r] = v.z;
      S[k + 3][r] = v.w;
    } else {
      *reinterpret_cast<float4*>(&S[tid >> 5][(tid & 31) * 4]) = v;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float csum = 0.f;

  float4 va, vb;
  if (steps > 0) {
    load(p.A, p.lda, m0, p.M, A_T, k_begin, va);
    load(p.B, p.ldb, n0, p.N, B_T, k_begin, vb);
    store(sA[0], A_T, va);
    store(sB[0], B_T, vb);
  }
  __syncthreads();
  for (int i = 0; i < steps; ++i) {
    const int cur = i & 1;
    if (i + 1 < steps) {
      load(p.A, p.lda, m0, p.M, A_T, k_begin + (i + 1) * FK, va);
      load(p.B, p.ldb, n0, p.N, B_T, k_begin + (i + 1) * FK, vb);
    }
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[cur][k][64 + tx * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    }
    if (do_colsum && tid < FT) {
#pragma unroll
      for (int k = 0; k < FK; ++k) csum += sA[cur][k][tid];
    }
    if (i + 1 < steps) {
      store(sA[cur ^ 1], A_T, va);
      store(sB[cur ^ 1], B_T, vb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int m = m0 + (ii >> 2) * 64 + ty * 4 + (ii & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= p.N) continue;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if constexpr (EPI == PART) v[jj] = acc[ii][jh * 4 + jj];
        else v[jj] = epi_value<float, EPI>(p, m, n + jj, acc[ii][jh * 4 + jj]);
      }
      float* dst = EPI == PART ? p.part + ((size_t)blockIdx.z * p.M + m) * p.N + n
                               : p.Y + (size_t)m * p.N + n;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (do_colsum && tid < FT && m0 + tid < p.M)
    p.colsum[(size_t)blockIdx.z * p.M + m0 + tid] = csum;
}

// ------------------------------------------------------------- launchers

// The slices of a TN product over R rows into an Mo x Ni output: enough
// (slice, tile) blocks to fill the card twice, slices of a multiple of 64
// rows and at least 256 of them. Fixed by the shape, so the sum order is.
inline int tn_slice_rows(int R, int Mo, int Ni) {
  const int tiles = ((Mo + FT - 1) / FT) * ((Ni + FT - 1) / FT);
  int s = (2 * 132 + tiles - 1) / tiles;
  const int most = (R + 255) / 256;
  s = s < 1 ? 1 : (s > most ? most : s);
  const int rows = (R + s - 1) / s;
  return (rows + 63) / 64 * 64;
}
inline int tn_slices(int R, int Mo, int Ni) {
  const int rows = tn_slice_rows(R, Mo, Ni);
  return (R + rows - 1) / rows;
}

template <int EPI, bool A_T, bool B_T>
cudaError_t launch_gemm(const GemmArgs<bf16>& p, int slices, cudaStream_t s) {
  // 128-row tiles where they fill the 132 SMs, else 64-row tiles.
  const long big = (long)((p.M + 127) / 128) * ((p.N + GBN - 1) / GBN) * slices;
  if (A_T || big >= 132) return launch_tc<EPI, 2, A_T, B_T>(p, slices, s);
  return launch_tc<EPI, 1, A_T, B_T>(p, slices, s);
}

template <int EPI, bool A_T, bool B_T>
cudaError_t launch_gemm(const GemmArgs<float>& p, int slices, cudaStream_t s) {
  dim3 grid((p.N + FT - 1) / FT, (p.M + FT - 1) / FT, slices);
  f32_gemm_kernel<EPI, A_T, B_T><<<grid, 256, 0, s>>>(p);
  return cudaGetLastError();
}

// Y (M, N) = epilogue(X (M, K) . W^T), W (N, K): the forward's dense.
template <int EPI, typename T>
cudaError_t dense(const T* X, const T* W, const T* bias, const T* R, T* Y, int M, int N, int K,
                  cudaStream_t s, T* Y2 = nullptr) {
  GemmArgs<T> p{X, W, K, K, M, N, K, K, bias, R, Y, Y2, nullptr, nullptr};
  return launch_gemm<EPI, false, false>(p, 1, s);
}

// dX (M, n_in) = epilogue(G (M, n_out) . W), W (n_out, n_in) read as it
// lies (no transpose): EPI NONE or DGELU (R the pre-activation).
template <int EPI, typename T>
cudaError_t input_grad(const T* G, const T* W, const T* R, T* Y, int M, int n_in, int n_out,
                       cudaStream_t s) {
  GemmArgs<T> p{G, W, n_out, n_in, M, n_in, n_out, n_out, nullptr, R, Y, nullptr, nullptr,
                nullptr};
  return launch_gemm<EPI, false, true>(p, 1, s);
}

// dW (Mo, Ni) fp32 = G^T . X over R rows and db (Mo,) fp32 = column sums
// of G (db may be null), G (R, Mo), X (R, Ni): fp32 partial sums per row
// slice into `part` (tn_slices * Mo * Ni) and `part_b` (tn_slices * Mo),
// then the slices added in order.
template <typename T>
cudaError_t weight_grad(const T* G, const T* X, int R, int Mo, int Ni, float* part,
                        float* part_b, float* dW, float* db, cudaStream_t s) {
  const int rows = tn_slice_rows(R, Mo, Ni), S = (R + rows - 1) / rows;
  GemmArgs<T> p{G, X, Mo, Ni, Mo, Ni, R, rows, nullptr, nullptr, nullptr, nullptr, part,
                db != nullptr ? part_b : nullptr};
  DTC_TRY((launch_gemm<PART, true, true>(p, S, s)));
  return sum_slices2(part, (size_t)Mo * Ni, dW, part_b, db != nullptr ? (size_t)Mo : 0, db, S,
                     s);
}


// --------------------------------------------------------------- LayerNorm

// VPL contiguous elements of a row (16-byte loads and stores where they fit,
// else 8-byte ones where VPL is a multiple of 4).
template <int VPL>
__device__ __forceinline__ void loadv(const bf16* p, float (&v)[VPL]) {
  if constexpr (VPL % 8 == 0) {
#pragma unroll
    for (int e = 0; e < VPL; e += 8) {
      float w[8];
      load8(p + e, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[e + k] = w[k];
    }
  } else if constexpr (VPL % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VPL; e += 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + e);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[e] = lo.x, v[e + 1] = lo.y, v[e + 2] = hi.x, v[e + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VPL; e += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
      v[e] = f.x, v[e + 1] = f.y;
    }
  }
}
template <int VPL>
__device__ __forceinline__ void loadv(const float* p, float (&v)[VPL]) {
#pragma unroll
  for (int e = 0; e < VPL; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + e);
    v[e] = f.x, v[e + 1] = f.y, v[e + 2] = f.z, v[e + 3] = f.w;
  }
}
template <int VPL>
__device__ __forceinline__ void storev(bf16* p, const float (&v)[VPL]) {
  if constexpr (VPL % 8 == 0) {
#pragma unroll
    for (int e = 0; e < VPL; e += 8) {
      float w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = v[e + k];
      store8(p + e, w);
    }
  } else if constexpr (VPL % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VPL; e += 4) {
      uint2 u;
      *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[e], v[e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[e + 2], v[e + 3]);
      *reinterpret_cast<uint2*>(p + e) = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VPL; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(p + e) = __floats2bfloat162_rn(v[e], v[e + 1]);
  }
}
template <int VPL>
__device__ __forceinline__ void storev(float* p, const float (&v)[VPL]) {
#pragma unroll
  for (int e = 0; e < VPL; e += 4)
    *reinterpret_cast<float4*>(p + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
}

// LayerNorm forward, one warp per row of d = 32 * VPL, lane l holding
// elements VPL*l..VPL*l+VPL-1: common.cuh's arithmetic (fp32 two-pass
// statistics, eps 1e-6) with the row read and written in 16-byte pieces;
// the row's mean and 1/sigma written where asked.
template <typename T, int VPL>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
              T* __restrict__ y, int rows, float* __restrict__ mean_out,
              float* __restrict__ rstd_out) {
  constexpr int D = 32 * VPL;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t at = (size_t)row * D + lane * VPL;
  float v[VPL], gv[VPL], bv[VPL];
  loadv(x + at, v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) s += v[e];
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) q += (v[e] - mean) * (v[e] - mean);
  const float inv = rsqrtf(warp_sum(q) / D + 1e-6f);
  loadv(g + lane * VPL, gv);
  loadv(b + lane * VPL, bv);
#pragma unroll
  for (int e = 0; e < VPL; ++e) v[e] = (v[e] - mean) * inv * gv[e] + bv[e];
  storev(y + at, v);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = inv;
  }
}

// LayerNorm backward, one warp per row of any width up to 1024, lane l
// holding elements l, l + 32, ... (fused_decoder_pallas._ln_bwd):
//   xhat = (x - mean) * rstd, dxhat = dy * gamma,
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// out = T(res + dx) where res is given (it may alias out), else T(dx).
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gamma, const T* res, T* out, int rows, int d) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  const float mu = mean[row], inv = rstd[row];
  float xh[LN_MAX_PER_LANE], dxh[LN_MAX_PER_LANE];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < d) {
      xh[i] = (to_f(x[base + c]) - mu) * inv;
      dxh[i] = to_f(dy[base + c]) * gamma[c];
    } else {
      xh[i] = 0.f;
      dxh[i] = 0.f;
    }
    s1 += dxh[i];
    s2 += dxh[i] * xh[i];
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < d) {
      float v = inv * (dxh[i] - m1 - xh[i] * m2);
      if (res != nullptr) v = to_f(res[base + c]) + v;
      out[base + c] = from_f<T>(v);
    }
  }
}

// LayerNorm backward of one row per warp of d = 32 * VPL in VPL-element
// pieces (ln_bwd_kernel's arithmetic): out = T(res + dx), or T(dx) where
// res is null; res may alias out.
template <typename T, int VPL>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_row_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const float* __restrict__ gamma, const T* res, T* out, int rows) {
  constexpr int D = 32 * VPL;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t at = (size_t)row * D + lane * VPL;
  const float mu = mean[row], inv = rstd[row];
  float xh[VPL], dxh[VPL], gv[VPL];
  loadv(x + at, xh);
  loadv(dy + at, dxh);
  loadv(gamma + lane * VPL, gv);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) {
    xh[e] = (xh[e] - mu) * inv;
    dxh[e] = dxh[e] * gv[e];
    s1 += dxh[e];
    s2 += dxh[e] * xh[e];
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  float r[VPL];
  if (res != nullptr) loadv(res + at, r);
#pragma unroll
  for (int e = 0; e < VPL; ++e) {
    const float v = inv * (dxh[e] - m1 - xh[e] * m2);
    xh[e] = res != nullptr ? r[e] + v : v;
  }
  storev(out + at, xh);
}

#define DTC_LN_WIDTHS(X) X(4) X(8) X(12) X(16) X(24) X(32)

// LayerNorm forward of rows (rows, d) on the vectorised kernel where d is
// 128, 256, 384, 512, 768 or 1024, else common.cuh's.
template <typename T>
cudaError_t layer_norm(const T* x, const float* g, const float* b, T* y, int rows, int d,
                       cudaStream_t s, float* mean_out = nullptr, float* rstd_out = nullptr) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  switch (d) {
#define DTC_LN_CASE(V)                                                                    \
  case 32 * V:                                                                           \
    ln_fwd_kernel<T, V><<<blocks, LN_WARPS * 32, 0, s>>>(x, g, b, y, rows, mean_out,     \
                                                          rstd_out);                     \
    return cudaGetLastError();
    DTC_LN_WIDTHS(DTC_LN_CASE)
#undef DTC_LN_CASE
    default: return mm::layer_norm<T>(x, g, b, y, rows, d, s, mean_out, rstd_out);
  }
}

constexpr int LN_SLICE = 128;  // rows per partial sum of dgamma and dbeta

// part_g[z*d + col] = sum over the rows of slice z of dy * xhat,
// part_b[z*d + col] = sum of dy; one thread per column, in row order.
template <typename T>
__global__ void __launch_bounds__(256)
ln_param_partial_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        const float* __restrict__ mean, const float* __restrict__ rstd, int rows,
                        int d, float* __restrict__ part_g, float* __restrict__ part_b) {
  const int col = blockIdx.x * 256 + threadIdx.x, z = blockIdx.y;
  if (col >= d) return;
  const int r1 = min(rows, (z + 1) * LN_SLICE);
  float ag = 0.f, ab = 0.f;
  for (int r = z * LN_SLICE; r < r1; ++r) {
    const size_t off = (size_t)r * d + col;
    const float g = to_f(dy[off]);
    ag = fmaf(g, (to_f(x[off]) - mean[r]) * rstd[r], ag);
    ab += g;
  }
  part_g[(size_t)z * d + col] = ag;
  part_b[(size_t)z * d + col] = ab;
}

inline int ln_slices(int rows) { return (rows + LN_SLICE - 1) / LN_SLICE; }

// LayerNorm backward of rows (rows, d): out = T(res + dx) (or T(dx) when
// res is null; res may alias out), one warp per row (vectorised where d
// is 128, 256, 384, 512, 768 or 1024, else ln_bwd_kernel), and fp32
// dgamma, dbeta (d,) from partial sums over slices of LN_SLICE rows
// (2 * ln_slices(rows) * d floats of `part`), added in order.
template <typename T>
cudaError_t ln_backward(const T* dy, const T* x, const float* mean, const float* rstd,
                        const float* gamma, const T* res, T* out, float* dgamma, float* dbeta,
                        float* part, int rows, int d, cudaStream_t s) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  switch (d) {
#define DTC_LN_CASE(V)                                                                    \
  case 32 * V:                                                                           \
    ln_bwd_row_kernel<T, V><<<blocks, LN_WARPS * 32, 0, s>>>(dy, x, mean, rstd, gamma, res, \
                                                              out, rows);                \
    break;
    DTC_LN_WIDTHS(DTC_LN_CASE)
#undef DTC_LN_CASE
    default:
      ln_bwd_kernel<T><<<blocks, LN_WARPS * 32, 0, s>>>(dy, x, mean, rstd, gamma, res, out,
                                                        rows, d);
  }
  DTC_TRY(cudaGetLastError());
  const int S = ln_slices(rows);
  float* part_b = part + (size_t)S * d;
  ln_param_partial_kernel<T><<<dim3((d + 255) / 256, S), 256, 0, s>>>(dy, x, mean, rstd, rows,
                                                                      d, part, part_b);
  DTC_TRY(cudaGetLastError());
  return sum_slices2(part, d, dgamma, part_b, d, dbeta, S, s);
}

// ------------------------------------------------------- bf16 attention

constexpr int AT_WARPS = 4, AT_THREADS = 32 * AT_WARPS;
constexpr int AT_ROWS = 16 * AT_WARPS;  // query rows (or keys) of a block
constexpr int AT_CHUNK = sa::TILE;      // keys (or queries) per step: 64

__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// `rows` rows of DH bf16 from global (row r at src + r * ld) into shared
// memory rows of sa::ld<DH>() elements, by the block's AT_THREADS threads;
// rows at or past `valid` are zero-filled. Commits nothing.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int ld, int rows,
                                          int valid) {
  constexpr int CH = DH / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += AT_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * sa::ld<DH>() + c, src + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

// Scores (C fragments of a 64-key chunk at j0) of keys at or past nk to -inf.
__device__ __forceinline__ void mask_keys(float (&s)[AT_CHUNK / 8][4], int j0, int nk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < AT_CHUNK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + nt * 8 + 2 * t + (e & 1) >= nk) s[nt][e] = -INFINITY;
}

template <int DH>
inline size_t attn_fwd_smem(int nk) {
  return (size_t)(2 * pad64(nk) + AT_ROWS) * sa::ld<DH>() * sizeof(bf16);
}

// O = softmax(Q K^T * scale) V for one block of 64 query rows of one
// (sample, head). Rows of Q at Q + (b*nq + i)*ldq + h*DH, K and V at
// (b*nk + j)*ldkv + h*DH, O at (b*nq + i)*ldo + h*DH. c = scale * log2 e:
// exp(s * scale - m') = exp2(s * c - m), m in log2 units.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_fwd_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp,
                const bf16* __restrict__ Vp, int ldkv, bf16* __restrict__ O, int ldo, int nq,
                int nk, float c) {
  constexpr int NT = AT_CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkp = pad64(nk);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + nkp * sa::ld<DH>();
  bf16* sQ = sV + nkp * sa::ld<DH>();
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AT_ROWS;
  const int warp = threadIdx.x >> 5, r0 = warp * 16;
  copy_rows<DH>(sK, Kp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  copy_rows<DH>(sV, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  copy_rows<DH>(sQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, AT_ROWS, nq - q0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + r0 >= nq) return;  // the warp has no query row

  // Rows g (u = 0) and g + 8 (u = 1): running max m and this lane's share
  // of the row sum l.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < nkp; j0 += AT_CHUNK) {
    float s[NT][4];
    sa::rows_times_tile_t<DH>(s, sQ, r0, sK + j0 * sa::ld<DH>());
    if (j0 + AT_CHUNK > nk) mask_keys(s, j0, nk);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tm = fmaxf(tm, fmaxf(s[nt][2 * u], s[nt][2 * u + 1]));
      const float mn = fmaxf(m[u], sa::quad_max(tm) * c);
      float ts = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ts += sa::exp2_ftz(fmaf(s[nt][2 * u], c, -mn)) +
              sa::exp2_ftz(fmaf(s[nt][2 * u + 1], c, -mn));
      l[u] = l[u] * sa::exp2_ftz(m[u] - mn) + ts;
      m[u] = mn;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) l[u] = 1.f / sa::quad_sum(l[u]);

  float o[DH / 8][4];
  sa::zero(o);
  for (int j0 = 0; j0 < nkp; j0 += AT_CHUNK) {
    float s[NT][4];
    sa::rows_times_tile_t<DH>(s, sQ, r0, sK + j0 * sa::ld<DH>());
    if (j0 + AT_CHUNK > nk) mask_keys(s, j0, nk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = sa::exp2_ftz(fmaf(s[nt][e], c, -m[e >> 1])) * l[e >> 1];
    uint32_t pa[AT_CHUNK / 16][4];
    sa::to_a(pa, s);
    sa::probs_times_tile<DH>(o, pa, sV + j0 * sa::ld<DH>());
  }
  sa::store_rows<DH>(O + h * DH, ldo, (size_t)b * nq + q0, r0, nq - q0, o);
}

template <int DH>
inline size_t attn_rows_smem(int nk) {
  return (size_t)(2 * pad64(nk) + 2 * AT_ROWS) * sa::ld<DH>() * sizeof(bf16);
}

// Backward, rows: dQ for 64 query rows of one (sample, head), and per row
// its max m (log2 units), 1/l and delta = sum_j dP_j P_j (fp32 P) into
// stats + {0, 1, 2} * n_stats at (b*heads + h)*nq + i. dO and dQ rows as
// Q's with lddo and lddq.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_rows_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp,
                     const bf16* __restrict__ Vp, int ldkv, const bf16* __restrict__ dO,
                     int lddo, bf16* __restrict__ dQ, int lddq, float* __restrict__ stats,
                     size_t n_stats, int heads, int nq, int nk, float c, float scale) {
  constexpr int NT = AT_CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkp = pad64(nk);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + nkp * sa::ld<DH>();
  bf16* sQ = sV + nkp * sa::ld<DH>();
  bf16* sDO = sQ + AT_ROWS * sa::ld<DH>();
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AT_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  copy_rows<DH>(sK, Kp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  copy_rows<DH>(sV, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  copy_rows<DH>(sQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, AT_ROWS, nq - q0);
  copy_rows<DH>(sDO, dO + ((size_t)b * nq + q0) * lddo + h * DH, lddo, AT_ROWS, nq - q0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + r0 >= nq) return;

  // Pass 1: row max m, sum l and d = sum dP * exp2(s c - m), the last two
  // rescaled together as m grows; delta = d / l.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < nkp; j0 += AT_CHUNK) {
    float s[NT][4], dp[NT][4];
    sa::rows_times_tile_t<DH>(s, sQ, r0, sK + j0 * sa::ld<DH>());
    sa::rows_times_tile_t<DH>(dp, sDO, r0, sV + j0 * sa::ld<DH>());
    if (j0 + AT_CHUNK > nk) mask_keys(s, j0, nk);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tm = fmaxf(tm, fmaxf(s[nt][2 * u], s[nt][2 * u + 1]));
      const float mn = fmaxf(m[u], sa::quad_max(tm) * c);
      float ts = 0.f, td = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = sa::exp2_ftz(fmaf(s[nt][2 * u + e], c, -mn));
          ts += ex;
          td = fmaf(ex, dp[nt][2 * u + e], td);
        }
      const float r = sa::exp2_ftz(m[u] - mn);
      l[u] = l[u] * r + ts;
      d[u] = d[u] * r + td;
      m[u] = mn;
    }
  }
  float inv[2], delta[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    inv[u] = 1.f / sa::quad_sum(l[u]);
    delta[u] = sa::quad_sum(d[u]) * inv[u];
  }

  // Pass 2: P, dP, dS = bf16(P (dP - delta) scale), dQ += dS . K.
  float dq[DH / 8][4];
  sa::zero(dq);
  for (int j0 = 0; j0 < nkp; j0 += AT_CHUNK) {
    float s[NT][4], dp[NT][4];
    sa::rows_times_tile_t<DH>(s, sQ, r0, sK + j0 * sa::ld<DH>());
    sa::rows_times_tile_t<DH>(dp, sDO, r0, sV + j0 * sa::ld<DH>());
    if (j0 + AT_CHUNK > nk) mask_keys(s, j0, nk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const float p = sa::exp2_ftz(fmaf(s[nt][e], c, -m[u])) * inv[u];
        s[nt][e] = p * (dp[nt][e] - delta[u]) * scale;
      }
    uint32_t dsa[AT_CHUNK / 16][4];
    sa::to_a(dsa, s);
    sa::probs_times_tile<DH>(dq, dsa, sK + j0 * sa::ld<DH>());
  }
  sa::store_rows<DH>(dQ + h * DH, lddq, (size_t)b * nq + q0, r0, nq - q0, dq);
  if (t == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = q0 + r0 + g + 8 * u;
      if (i < nq) {
        const size_t at = (size_t)(b * heads + h) * nq + i;
        stats[at] = m[u];
        stats[n_stats + at] = inv[u];
        stats[2 * n_stats + at] = delta[u];
      }
    }
  }
}

template <int DH>
inline size_t attn_keys_smem(int nq) {
  return (size_t)(2 * AT_ROWS + 2 * pad64(nq)) * sa::ld<DH>() * sizeof(bf16) +
         3 * (size_t)pad64(nq) * sizeof(float);
}

// Backward, keys: dK and dV for 64 keys of one (sample, head), from every
// query row of the head and the rows' statistics. dK and dV rows as K's
// with lddkv.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_keys_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp,
                     const bf16* __restrict__ Vp, int ldkv, const bf16* __restrict__ dO,
                     int lddo, const float* __restrict__ stats, size_t n_stats,
                     bf16* __restrict__ dK, bf16* __restrict__ dV, int lddkv, int heads,
                     int nq, int nk, float c, float scale) {
  constexpr int NT = AT_CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nqp = pad64(nq);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + AT_ROWS * sa::ld<DH>();
  bf16* sQ = sV + AT_ROWS * sa::ld<DH>();
  bf16* sDO = sQ + nqp * sa::ld<DH>();
  float* sM = reinterpret_cast<float*>(sDO + nqp * sa::ld<DH>());
  float* sI = sM + nqp;
  float* sD = sI + nqp;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * AT_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = warp * 16;
  copy_rows<DH>(sK, Kp + ((size_t)b * nk + k0) * ldkv + h * DH, ldkv, AT_ROWS, nk - k0);
  copy_rows<DH>(sV, Vp + ((size_t)b * nk + k0) * ldkv + h * DH, ldkv, AT_ROWS, nk - k0);
  copy_rows<DH>(sQ, Q + (size_t)b * nq * ldq + h * DH, ldq, nqp, nq);
  copy_rows<DH>(sDO, dO + (size_t)b * nq * lddo + h * DH, lddo, nqp, nq);
  cp_async_commit();
  // Padded query rows (zero q and do) get p = 0: m = +inf, 1/l = 0.
  const size_t base = (size_t)(b * heads + h) * nq;
  for (int i = threadIdx.x; i < nqp; i += AT_THREADS) {
    const bool ok = i < nq;
    sM[i] = ok ? stats[base + i] : INFINITY;
    sI[i] = ok ? stats[n_stats + base + i] : 0.f;
    sD[i] = ok ? stats[2 * n_stats + base + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (k0 + r0 >= nk) return;  // the warp has no key

  uint32_t ak[DH / 16][4], av[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    sa::frag_a<DH>(ak[kk], sK, r0, kk);
    sa::frag_a<DH>(av[kk], sV, r0, kk);
  }
  float dk[DH / 8][4], dv[DH / 8][4];
  sa::zero(dk);
  sa::zero(dv);
  for (int i0 = 0; i0 < nqp; i0 += AT_CHUNK) {
    const bf16* q = sQ + i0 * sa::ld<DH>();
    const bf16* o = sDO + i0 * sa::ld<DH>();
    // s^T and dp^T: the warp's 16 keys against the step's 64 queries.
    float st[NT][4], dpt[NT][4];
    sa::zero(st);
    sa::zero(dpt);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < AT_CHUNK / 16; ++np) {
        uint32_t bq[4], bo[4];
        sa::frag_b<DH>(bq, q, np * 16, kk);
        sa::frag_b<DH>(bo, o, np * 16, kk);
        mma_16816(st[2 * np], ak[kk], bq);
        mma_16816(st[2 * np + 1], ak[kk], bq + 2);
        mma_16816(dpt[2 * np], av[kk], bo);
        mma_16816(dpt[2 * np + 1], av[kk], bo + 2);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + nt * 8 + 2 * t + (e & 1);
        const float p = sa::exp2_ftz(fmaf(st[nt][e], c, -sM[i])) * sI[i];
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sD[i]) * scale;
      }
    uint32_t pa[AT_CHUNK / 16][4], dsa[AT_CHUNK / 16][4];
    sa::to_a(pa, st);
    sa::to_a(dsa, dpt);
    sa::probs_times_tile<DH>(dv, pa, o);
    sa::probs_times_tile<DH>(dk, dsa, q);
  }
  sa::store_rows<DH>(dK + h * DH, lddkv, (size_t)b * nk + k0, r0, nk - k0, dk);
  sa::store_rows<DH>(dV + h * DH, lddkv, (size_t)b * nk + k0, r0, nk - k0, dv);
}

// ------------------------------------------------------- fp32 attention
//
// The same blocks and passes as bf16, on register-tiled FMA: 128 threads
// (256 for the backward's 128-row pass), thread (ty, tx) = (tid / 16,
// tid % 16) owning rows 8ty..8ty+7 and
// columns 4tx..4tx+3 of each 64 x 64 score tile (or dh/16 columns of a
// 64 x dh product). Both operands of every product lie k-major in shared
// memory ([k][row], [k][column]), so per k a thread reads its 8 rows as
// two float4 and its columns as one float4 or float2: a few shared-memory
// wavefronts per 32 FMAs. Tiles whose k is the head width are transposed
// as they are loaded; P and dS are written transposed by the threads that
// compute them. Row sums by shuffles over the 16 lanes of a row; expf,
// and p = exp(s - m) * (1 / l), 1 / l taken once per row.

constexpr int FA_ROWS = 64;

// Row stride of a k-major tile n wide (a multiple of 4: float4 reads).
__host__ __device__ constexpr int fa_ld(int n) { return n + 4; }
constexpr int FA_LD = fa_ld(FA_ROWS);

// Copies of `rows` rows of DH floats from global (row r at src + r * ldsrc,
// 16-byte aligned) into shared memory, rows at or past `valid` zero: four
// 16-byte loads in flight per thread before their stores. T = true: the
// head width becomes k, dst[c * ld + r]; else dst[r * DH + c].
template <int DH, bool T>
__device__ __forceinline__ void fa_copy(float* dst, int ld, const float* src, int ldsrc,
                                        int rows, int valid) {
  constexpr int C4 = DH / 4, U = 4;
  const int total = rows * C4;
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < total; base += U * nt) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * nt, r = idx / C4, c = (idx % C4) * 4;
      v[u] = idx < total && r < valid
                 ? *reinterpret_cast<const float4*>(src + (size_t)r * ldsrc + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * nt, r = idx / C4, c = (idx % C4) * 4;
      if (idx >= total) continue;
      if (T) {
        dst[c * ld + r] = v[u].x;
        dst[(c + 1) * ld + r] = v[u].y;
        dst[(c + 2) * ld + r] = v[u].z;
        dst[(c + 3) * ld + r] = v[u].w;
      } else {
        *reinterpret_cast<float4*>(dst + r * DH + c) = v[u];
      }
    }
  }
}
template <int DH>
__device__ __forceinline__ void fa_load_t(float* dst, int ld, const float* src, int ldsrc,
                                          int rows, int valid) {
  fa_copy<DH, true>(dst, ld, src, ldsrc, rows, valid);
}
template <int DH>
__device__ __forceinline__ void fa_load(float* dst, const float* src, int ldsrc, int rows,
                                        int valid) {
  fa_copy<DH, false>(dst, DH, src, ldsrc, rows, valid);
}

// acc[i][j] += sum over k < kn of A[k * lda + 8ty + i] * B[k * ldb + NJ tx + j].
template <int NJ>
__device__ __forceinline__ void fa_mm(float (&acc)[8][NJ], const float* A, int lda,
                                      const float* B, int ldb, int kn) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = A + 8 * ty;
  const float* b = B + NJ * tx;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * lda + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[NJ];
    if constexpr (NJ % 4 == 0) {
#pragma unroll
      for (int j = 0; j < NJ; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(b + k * ldb + j);
        bv[j] = v.x, bv[j + 1] = v.y, bv[j + 2] = v.z, bv[j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + j);
        bv[j] = v.x, bv[j + 1] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void fa_zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// Max and sum over the 16 lanes (tx) that share a row.
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s (the block's rows x the 64 keys at j0) = (Qt^T . Kt) * scale from
// k-major Qt (DH x ldq) and Kt (DH x ldk); keys at or past nk -inf.
template <int DH>
__device__ __forceinline__ void fa_scores(float (&s)[8][4], const float* Qt, int ldq,
                                          const float* Kt, int ldk, int j0, int nk, float scale) {
  const int tx = threadIdx.x & 15;
  fa_zero(s);
  fa_mm<4>(s, Qt, ldq, Kt + j0, ldk, DH);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = j0 + 4 * tx + j < nk ? s[i][j] * scale : -INFINITY;
}

// The running max m, sum l and d = sum dp * exp(s - m) of each of the
// thread's 8 rows over one 64-key chunk of scores s and dp.
__device__ __forceinline__ void fa_online(float (&m)[8], float (&l)[8], float (&d)[8],
                                          const float (&s)[8][4], const float (&dp)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float mn =
        fmaxf(m[i], row16_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
    float ts = 0.f, td = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = expf(s[i][j] - mn);
      ts += e;
      td = fmaf(e, dp[i][j], td);
    }
    const float r = expf(m[i] - mn);
    l[i] = l[i] * r + ts;
    d[i] = d[i] * r + td;
    m[i] = mn;
  }
}

template <int DH, int RR>
inline size_t fa_fwd_smem(int nk) {
  const int nkp = pad64(nk);
  return ((size_t)DH * fa_ld(nkp) + (size_t)nkp * DH + DH * fa_ld(RR) + FA_ROWS * fa_ld(RR)) *
         sizeof(float);
}

// fp32 forward for RR query rows (128 with 256 threads where the shared
// memory allows, else 64 with 128) of one (sample, head); layout as
// attn_fwd_kernel's. One pass over 64-key chunks: o and the row sum l
// are rescaled as the row max m grows, and o / l is taken at the end (in
// fp32 P is not rounded, so the TPU kernel's second pass, which exists to
// round the normalised P, buys nothing here). Shared: Kt (DH x ldk), V
// (nkp x DH), Qt (DH x fa_ld(RR)), Pt (64 keys x fa_ld(RR): the chunk's
// exp(s - m), k-major).
template <int DH, int RR>
__global__ void __launch_bounds__(2 * RR)
fa_fwd_kernel(const float* __restrict__ Q, int ldq, const float* __restrict__ Kp,
              const float* __restrict__ Vp, int ldkv, float* __restrict__ O, int ldo, int nq,
              int nk, float scale) {
  constexpr int NJ = DH / 16, LDQ = fa_ld(RR);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkp = pad64(nk), ldk = fa_ld(nkp);
  float* sKt = reinterpret_cast<float*>(smem_raw);
  float* sV = sKt + DH * ldk;
  float* sQt = sV + nkp * DH;
  float* sPt = sQt + DH * LDQ;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * RR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  fa_load_t<DH>(sKt, ldk, Kp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  fa_load<DH>(sV, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  fa_load_t<DH>(sQt, LDQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, RR, nq - q0);
  __syncthreads();

  float m[8], l[8], o[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, l[i] = 0.f;
  fa_zero(o);
  for (int j0 = 0; j0 < nkp; j0 += 64) {
    float s[8][4];
    fa_scores<DH>(s, sQt, LDQ, sKt, ldk, j0, nk, scale);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mn =
          fmaxf(m[i], row16_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
      const float r = expf(m[i] - mn);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        ts += e;
        sPt[(4 * tx + j) * LDQ + 8 * ty + i] = e;
      }
      l[i] = l[i] * r + ts;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= r;
    }
    __syncthreads();
    fa_mm<NJ>(o, sPt, LDQ, sV + j0 * DH, DH, 64);
    __syncthreads();  // before the next chunk's P
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + 8 * ty + i;
    const float inv = 1.f / row16_sum(l[i]);
    if (r >= nq) continue;
    float* row = O + ((size_t)b * nq + r) * ldo + h * DH + NJ * tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[j] = o[i][j] * inv;
  }
}

// The mean over the nk keys of each of the DH columns of one (sample,
// head)'s V (at V, rows ldkv apart) into vm, by threads below DH: the same
// sums in the same order in both backward passes. dP = dO . V^T less dO .
// mean(V) differs from dP by a constant in each query row, which
// dS = P (dP - delta) does not see; taking the mean out of V first keeps
// dP's fp32 rounding on the part of V that varies over the keys (where
// the context tokens share most of their value, dP - delta cancels).
template <int DH>
__device__ __forceinline__ void fa_key_mean(float* vm, const float* V, int ldkv, int nk) {
  for (int c = threadIdx.x; c < DH; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < nk; ++r) s += V[(size_t)r * ldkv + c];
    vm[c] = s / (float)nk;
  }
}

// Vt[c * ld + r] -= vm[c] for the first `valid` keys r of k-major Vt.
template <int DH>
__device__ __forceinline__ void fa_center(float* Vt, int ld, const float* vm, int valid) {
  for (int idx = threadIdx.x; idx < DH * valid; idx += blockDim.x) {
    const int c = idx / valid, r = idx - c * valid;
    Vt[c * ld + r] -= vm[c];
  }
}

template <int DH, int RR>
inline size_t fa_rows_smem(int nk) {
  const int nkp = pad64(nk);
  return ((size_t)2 * DH * fa_ld(nkp) + (size_t)nkp * DH + 2 * DH * fa_ld(RR) +
          FA_ROWS * fa_ld(RR)) * sizeof(float);
}

// fp32 backward, rows: dQ for RR query rows (128 with 256 threads where
// the shared memory allows, else 64 with 128), and per row its max m,
// 1 / l and delta into stats + {0, 1, 2} * n_stats. Shared: Kt and Vt
// (DH x ldk; Vt less the keys' mean, fa_key_mean), K (nkp x DH), Qt and
// dOt (DH x fa_ld(RR)), dSt (64 keys x fa_ld(RR); its first DH floats
// hold the mean before pass 2).
template <int DH, int RR>
__global__ void __launch_bounds__(2 * RR)
fa_bwd_rows_kernel(const float* __restrict__ Q, int ldq, const float* __restrict__ Kp,
                   const float* __restrict__ Vp, int ldkv, const float* __restrict__ dO,
                   int lddo, float* __restrict__ dQ, int lddq, float* __restrict__ stats,
                   size_t n_stats, int heads, int nq, int nk, float scale) {
  constexpr int NJ = DH / 16, LDQ = fa_ld(RR);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkp = pad64(nk), ldk = fa_ld(nkp);
  float* sKt = reinterpret_cast<float*>(smem_raw);
  float* sVt = sKt + DH * ldk;
  float* sK = sVt + DH * ldk;
  float* sQt = sK + nkp * DH;
  float* sDOt = sQt + DH * LDQ;
  float* sDSt = sDOt + DH * LDQ;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * RR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kb = Kp + (size_t)b * nk * ldkv + h * DH;
  fa_load_t<DH>(sKt, ldk, kb, ldkv, nkp, nk);
  fa_load_t<DH>(sVt, ldk, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nkp, nk);
  fa_load<DH>(sK, kb, ldkv, nkp, nk);
  fa_load_t<DH>(sQt, LDQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, RR, nq - q0);
  fa_load_t<DH>(sDOt, LDQ, dO + ((size_t)b * nq + q0) * lddo + h * DH, lddo, RR, nq - q0);
  fa_key_mean<DH>(sDSt, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nk);
  __syncthreads();
  fa_center<DH>(sVt, ldk, sDSt, nk);
  __syncthreads();

  // Pass 1: row max m, sum l and d = sum dP * exp(s - m), rescaled with l;
  // delta = d / l.
  float m[8], l[8], d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, l[i] = 0.f, d[i] = 0.f;
  for (int j0 = 0; j0 < nkp; j0 += 64) {
    float s[8][4], dp[8][4];
    fa_scores<DH>(s, sQt, LDQ, sKt, ldk, j0, nk, scale);
    fa_zero(dp);
    fa_mm<4>(dp, sDOt, LDQ, sVt + j0, ldk, DH);
    fa_online(m, l, d, s, dp);
  }
  float delta[8], inv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = row16_sum(l[i]);
    inv[i] = 1.f / l[i];
    delta[i] = row16_sum(d[i]) * inv[i];
  }

  // Pass 2: P, dP, dS = P (dP - delta) scale, dQ += dS . K.
  float dq[8][NJ];
  fa_zero(dq);
  for (int j0 = 0; j0 < nkp; j0 += 64) {
    float s[8][4], dp[8][4];
    fa_scores<DH>(s, sQt, LDQ, sKt, ldk, j0, nk, scale);
    fa_zero(dp);
    fa_mm<4>(dp, sDOt, LDQ, sVt + j0, ldk, DH);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]) * inv[i];
        sDSt[(4 * tx + j) * LDQ + 8 * ty + i] = p * (dp[i][j] - delta[i]) * scale;
      }
    __syncthreads();
    fa_mm<NJ>(dq, sDSt, LDQ, sK + j0 * DH, DH, 64);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + 8 * ty + i;
    if (r >= nq) continue;
    float* row = dQ + ((size_t)b * nq + r) * lddq + h * DH + NJ * tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[j] = dq[i][j];
    if (tx == 0) {
      const size_t at = (size_t)(b * heads + h) * nq + r;
      stats[at] = m[i];
      stats[n_stats + at] = inv[i];
      stats[2 * n_stats + at] = delta[i];
    }
  }
}

template <int DH, int KR>
inline size_t fa_keys_smem() {
  return ((size_t)2 * DH * fa_ld(KR) + 2 * DH * FA_LD + 2 * FA_ROWS * DH +
          2 * FA_ROWS * fa_ld(KR) + 3 * FA_ROWS) * sizeof(float);
}

// fp32 backward, keys: dK and dV for KR keys (128 with 256 threads), from
// every query row of the head (64 at a time) and the rows' statistics.
// Shared: Kt and Vt of the block's keys (DH x fa_ld(KR); Vt less the mean
// of all the head's keys, as the rows pass takes it), then per query chunk
// Qt and dOt (DH x FA_LD), Q and dO (64 x DH), P and dS (64 queries x
// fa_ld(KR): k-major in the query; P's first DH floats hold the mean
// before the first chunk) and the chunk's statistics.
template <int DH, int KR>
__global__ void __launch_bounds__(2 * KR)
fa_bwd_keys_kernel(const float* __restrict__ Q, int ldq, const float* __restrict__ Kp,
                   const float* __restrict__ Vp, int ldkv, const float* __restrict__ dO,
                   int lddo, const float* __restrict__ stats, size_t n_stats,
                   float* __restrict__ dK, float* __restrict__ dV, int lddkv, int heads, int nq,
                   int nk, float scale) {
  constexpr int NJ = DH / 16, LDK = fa_ld(KR);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sKt = reinterpret_cast<float*>(smem_raw);
  float* sVt = sKt + DH * LDK;
  float* sQt = sVt + DH * LDK;
  float* sDOt = sQt + DH * FA_LD;
  float* sQ = sDOt + DH * FA_LD;
  float* sDO = sQ + FA_ROWS * DH;
  float* sP = sDO + FA_ROWS * DH;
  float* sDS = sP + FA_ROWS * LDK;
  float* sM = sDS + FA_ROWS * LDK;
  float* sL = sM + FA_ROWS;
  float* sD = sL + FA_ROWS;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kv0 = ((size_t)b * nk + k0) * ldkv + h * DH;
  fa_load_t<DH>(sKt, LDK, Kp + kv0, ldkv, KR, nk - k0);
  fa_load_t<DH>(sVt, LDK, Vp + kv0, ldkv, KR, nk - k0);
  fa_key_mean<DH>(sP, Vp + (size_t)b * nk * ldkv + h * DH, ldkv, nk);
  __syncthreads();
  fa_center<DH>(sVt, LDK, sP, min(KR, nk - k0));
  const size_t base = (size_t)(b * heads + h) * nq;

  float dk[8][NJ], dv[8][NJ];
  fa_zero(dk);
  fa_zero(dv);
  for (int i0 = 0; i0 < nq; i0 += FA_ROWS) {
    __syncthreads();  // the previous chunk's products are done
    const int valid = nq - i0;
    const float* qb = Q + ((size_t)b * nq + i0) * ldq + h * DH;
    const float* ob = dO + ((size_t)b * nq + i0) * lddo + h * DH;
    fa_load_t<DH>(sQt, FA_LD, qb, ldq, FA_ROWS, valid);
    fa_load_t<DH>(sDOt, FA_LD, ob, lddo, FA_ROWS, valid);
    fa_load<DH>(sQ, qb, ldq, FA_ROWS, valid);
    fa_load<DH>(sDO, ob, lddo, FA_ROWS, valid);
    // Padded query rows (zero q and do) get p = 0: m = +inf, 1 / l = 0.
    if (threadIdx.x < FA_ROWS) {
      const int i = threadIdx.x;
      const bool ok = i < valid;
      sM[i] = ok ? stats[base + i0 + i] : INFINITY;
      sL[i] = ok ? stats[n_stats + base + i0 + i] : 0.f;
      sD[i] = ok ? stats[2 * n_stats + base + i0 + i] : 0.f;
    }
    __syncthreads();
    // s^T and dp^T: the block's keys (rows) x the chunk's 64 queries (columns).
    float st[8][4], dpt[8][4];
    fa_zero(st);
    fa_zero(dpt);
    fa_mm<4>(st, sKt, LDK, sQt, FA_LD, DH);
    fa_mm<4>(dpt, sVt, LDK, sDOt, FA_LD, DH);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * tx + j;
        const float p = expf(st[i][j] * scale - sM[q]) * sL[q];
        sP[q * LDK + 8 * ty + i] = p;
        sDS[q * LDK + 8 * ty + i] = p * (dpt[i][j] - sD[q]) * scale;
      }
    __syncthreads();
    fa_mm<NJ>(dv, sP, LDK, sDO, DH, FA_ROWS);
    fa_mm<NJ>(dk, sDS, LDK, sQ, DH, FA_ROWS);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + 8 * ty + i;
    if (r >= nk) continue;
    const size_t off = ((size_t)b * nk + r) * lddkv + h * DH + NJ * tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dK[off + j] = dk[i][j];
      dV[off + j] = dv[i][j];
    }
  }
}

// dh ** -0.5 in double, rounded once to fp32, as the Python side does; and
// times log2 e, rounded once.
inline float attn_scale(int dh) { return (float)(1.0 / sqrt((double)dh)); }
inline float attn_c(int dh) { return (float)(sa::LOG2E / sqrt((double)dh)); }

template <int DH>
cudaError_t attention_fwd_dh(const bf16* Q, int ldq, const bf16* Kp, const bf16* Vp, int ldkv,
                             bf16* O, int ldo, int batch, int heads, int nq, int nk,
                             cudaStream_t s) {
  const size_t smem = attn_fwd_smem<DH>(nk);
  DTC_TRY(smem_attr<attn_fwd_kernel<DH>>(smem));
  dim3 grid((nq + AT_ROWS - 1) / AT_ROWS, heads, batch);
  attn_fwd_kernel<DH><<<grid, AT_THREADS, smem, s>>>(Q, ldq, Kp, Vp, ldkv, O, ldo, nq, nk,
                                                    attn_c(DH));
  return cudaGetLastError();
}

// bf16 attention forward, head widths 32, 64, 96 and 128: the head's K and
// V in shared memory where they fit, else the key-tiled K2 forward.
inline cudaError_t attention_fwd(const bf16* Q, int ldq, const bf16* Kp, const bf16* Vp,
                                 int ldkv, bf16* O, int ldo, int batch, int heads, int nq,
                                 int nk, int dh, cudaStream_t s) {
  const size_t need = dh == 32 ? attn_fwd_smem<32>(nk) : dh == 64 ? attn_fwd_smem<64>(nk)
                      : dh == 96 ? attn_fwd_smem<96>(nk) : attn_fwd_smem<128>(nk);
  if (need > SMEM_LIMIT)
    return short_attention_fwd(Q, ldq, Kp, ldkv, Vp, ldkv, O, ldo, nullptr, batch, heads, nq,
                               nk, dh, s);
  switch (dh) {
    case 32: return attention_fwd_dh<32>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 64: return attention_fwd_dh<64>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 96: return attention_fwd_dh<96>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 128: return attention_fwd_dh<128>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

// The fp32 workspace of attention_bwd: three statistics per (sample,
// head, query).
inline size_t attention_bwd_stats(int batch, int heads, int nq) {
  return 3 * (size_t)batch * heads * nq;
}

template <int DH>
cudaError_t attention_bwd_dh(const bf16* Q, int ldq, const bf16* Kp, const bf16* Vp, int ldkv,
                             const bf16* dO, int lddo, bf16* dQ, int lddq, bf16* dK, bf16* dV,
                             int lddkv, float* stats, int batch, int heads, int nq, int nk,
                             cudaStream_t s) {
  const size_t rows_smem = attn_rows_smem<DH>(nk), keys_smem = attn_keys_smem<DH>(nq);
  const size_t n_stats = (size_t)batch * heads * nq;
  DTC_TRY(smem_attr<attn_bwd_rows_kernel<DH>>(rows_smem));
  DTC_TRY(smem_attr<attn_bwd_keys_kernel<DH>>(keys_smem));
  attn_bwd_rows_kernel<DH><<<dim3((nq + AT_ROWS - 1) / AT_ROWS, heads, batch), AT_THREADS,
                             rows_smem, s>>>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, stats,
                                             n_stats, heads, nq, nk, attn_c(DH),
                                             attn_scale(DH));
  DTC_TRY(cudaGetLastError());
  attn_bwd_keys_kernel<DH><<<dim3((nk + AT_ROWS - 1) / AT_ROWS, heads, batch), AT_THREADS,
                             keys_smem, s>>>(Q, ldq, Kp, Vp, ldkv, dO, lddo, stats, n_stats,
                                             dK, dV, lddkv, heads, nq, nk, attn_c(DH),
                                             attn_scale(DH));
  return cudaGetLastError();
}

// bf16 attention backward (dQ, dK, dV), head widths 32 and 64; `stats`
// holds attention_bwd_stats(batch, heads, nq) floats.
inline cudaError_t attention_bwd(const bf16* Q, int ldq, const bf16* Kp, const bf16* Vp,
                                 int ldkv, const bf16* dO, int lddo, bf16* dQ, int lddq,
                                 bf16* dK, bf16* dV, int lddkv, float* stats, int batch,
                                 int heads, int nq, int nk, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return attention_bwd_dh<32>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, dK, dV,
                                         lddkv, stats, batch, heads, nq, nk, s);
    case 64: return attention_bwd_dh<64>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, dK, dV,
                                         lddkv, stats, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH, int RR>
cudaError_t fa_fwd_dh(const float* Q, int ldq, const float* Kp, const float* Vp, int ldkv,
                      float* O, int ldo, int batch, int heads, int nq, int nk, cudaStream_t s) {
  const size_t smem = fa_fwd_smem<DH, RR>(nk);
  DTC_TRY((smem_attr<fa_fwd_kernel<DH, RR>>(smem)));
  fa_fwd_kernel<DH, RR><<<dim3((nq + RR - 1) / RR, heads, batch), 2 * RR, smem, s>>>(
      Q, ldq, Kp, Vp, ldkv, O, ldo, nq, nk, attn_scale(DH));
  return cudaGetLastError();
}

template <int DH>
cudaError_t fa_fwd_any(const float* Q, int ldq, const float* Kp, const float* Vp, int ldkv,
                       float* O, int ldo, int batch, int heads, int nq, int nk, cudaStream_t s) {
  if (fa_fwd_smem<DH, 2 * FA_ROWS>(nk) <= SMEM_LIMIT)
    return fa_fwd_dh<DH, 2 * FA_ROWS>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
  if (fa_fwd_smem<DH, FA_ROWS>(nk) <= SMEM_LIMIT)
    return fa_fwd_dh<DH, FA_ROWS>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
  return attention<float>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, DH, s);
}

// fp32 attention forward, head widths 32, 64, 96 and 128: the head's K and
// V in shared memory where they fit (128 query rows a block, else 64), else
// common.cuh's fp32 kernel.
inline cudaError_t attention_fwd(const float* Q, int ldq, const float* Kp, const float* Vp,
                                 int ldkv, float* O, int ldo, int batch, int heads, int nq,
                                 int nk, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return fa_fwd_any<32>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 64: return fa_fwd_any<64>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 96: return fa_fwd_any<96>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    case 128: return fa_fwd_any<128>(Q, ldq, Kp, Vp, ldkv, O, ldo, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH, int RR>
cudaError_t fa_bwd_dh(const float* Q, int ldq, const float* Kp, const float* Vp, int ldkv,
                      const float* dO, int lddo, float* dQ, int lddq, float* dK, float* dV,
                      int lddkv, float* stats, int batch, int heads, int nq, int nk,
                      cudaStream_t s) {
  if constexpr (RR > FA_ROWS) {  // the 128-row pass where it fits, else 64 rows
    if (fa_rows_smem<DH, RR>(nk) > SMEM_LIMIT)
      return fa_bwd_dh<DH, FA_ROWS>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, dK, dV, lddkv,
                                    stats, batch, heads, nq, nk, s);
  }
  constexpr int KR = 2 * FA_ROWS;  // keys a block: fits at every width (204 KB at 64)
  const size_t rows_smem = fa_rows_smem<DH, RR>(nk), keys_smem = fa_keys_smem<DH, KR>();
  const size_t n_stats = (size_t)batch * heads * nq;
  DTC_TRY((smem_attr<fa_bwd_rows_kernel<DH, RR>>(rows_smem)));
  DTC_TRY((smem_attr<fa_bwd_keys_kernel<DH, KR>>(keys_smem)));
  fa_bwd_rows_kernel<DH, RR><<<dim3((nq + RR - 1) / RR, heads, batch), 2 * RR, rows_smem, s>>>(
      Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, stats, n_stats, heads, nq, nk, attn_scale(DH));
  DTC_TRY(cudaGetLastError());
  fa_bwd_keys_kernel<DH, KR><<<dim3((nk + KR - 1) / KR, heads, batch), 2 * KR, keys_smem,
                               s>>>(Q, ldq, Kp, Vp, ldkv, dO, lddo, stats, n_stats, dK, dV,
                                    lddkv, heads, nq, nk, attn_scale(DH));
  return cudaGetLastError();
}

// fp32 attention backward, head widths 32 and 64; every shape the
// backward's gate admits fits (the 64-row pass at most 197 KB, at 166 keys
// of width 64).
inline cudaError_t attention_bwd(const float* Q, int ldq, const float* Kp, const float* Vp,
                                 int ldkv, const float* dO, int lddo, float* dQ, int lddq,
                                 float* dK, float* dV, int lddkv, float* stats, int batch,
                                 int heads, int nq, int nk, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return fa_bwd_dh<32, 128>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, dK, dV,
                                       lddkv, stats, batch, heads, nq, nk, s);
    case 64: return fa_bwd_dh<64, 128>(Q, ldq, Kp, Vp, ldkv, dO, lddo, dQ, lddq, dK, dV,
                                       lddkv, stats, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dtc
}  // namespace mm
