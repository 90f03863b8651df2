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
// of q, k, v and o (25 MB, 8 us at 3.35 TB/s): tensor-core bound. Its
// exponentials (two per score, 403 M) take ~0.11 ms of the SMs' MUFU
// units on their own, so they, and not only the products, set the pace.
//
// The TPU kernel holds whole (Nq, Nk) fp32 rows of a head in VMEM and
// rounds the NORMALISED probability p = exp(s - m) / l to bf16 before
// P . V (:93-104, :115-119). One head's rows at 2049 keys are 16.8 MB and
// a block here has 227 KB, so this kernel streams key tiles past a block's
// query rows in two passes, keeping those roundings:
//   pass 1: s = q . k^T (fp32), the running row max m and the row sum l of
//           exp(s - m), rescaled as the max grows; lse = m + log(l);
//   pass 2: s again, p = exp(s - m) * (1 / l) in fp32, rounded to bf16,
//           o += p . v in fp32; o rounded to bf16 once at the end.
// Pass 2 recomputes q . k^T, so the kernel does 1.5x the minimal products;
// a one-pass online softmax would round exp(s - m_running) instead and
// move every rounding decision of p. Exponentials are 2^x of
// x = s * (scale * log2 e) - m, one FMA each; 1 / l is taken once per row.
//
// Design (Hopper, wgmma): one block of two warpgroups (8 warps) per
// (128-query tile, head, sample), each warpgroup 64 query rows, each warp
// 16 of them, whose q fragments are loaded once into registers by
// ldmatrix. Both products are wgmma.mma_async m64nNk16 with A from
// registers: S = q . k^T reads the key tile as the K-major B operand, and
// O += P . v takes P straight from the softmax's registers and v as B with
// the transpose bit. Key tiles of 64 rows (pass 1: 128 keys of k; pass 2:
// k and v) stream through a 3-stage cp.async ring in dynamic shared
// memory, in layouts the wgmma descriptor reads (at head width 64, rows
// of 128 bytes with the 128-byte swizzle, copied a row per eight lanes:
// coalesced reads, no bank conflicts); the copies of the next two steps
// are in flight while the tensor cores work on this one, and one barrier
// per step guards the ring. Pass 1 holds no o and needs no v, so its steps
// take 128 keys (a stage's k and v slots together): half the barriers and
// waits. A warpgroup whose rows all lie past nq (the ragged last tile:
// 2049 = 16 * 128 + 1) only helps with the copies. q, k and v are read in
// place from the strided (B, N, 3, H, dh) qkv buffer (row strides ldq,
// ldk, ldv), o is written to (B, N, H*dh): no transposes are
// materialised, the reason for the TPU kernel's BNHD layout. Keys past nk
// are masked to -inf in both passes; query rows past nq read as zero and
// are not written. Each product is waited for as soon as it is issued;
// overlapping a tile's softmax with the next tile's products is later work.

#include <tuple>

#include "short_attention.cuh"

namespace {

using namespace mm;

constexpr int STAGES = 3;

// What a launch computes: both passes (the kernel), or, to time its parts,
// one pass alone or both with the exponentials left out (the copies run in
// every mode; the results of the partial modes are meaningless).
enum { PASS1 = 1, PASS2 = 2, BOTH = 3, NO_EXP = 4 };

template <int DH> __host__ __device__ constexpr int q_elems() { return sa::ROWS * sa::ld<DH>(); }
template <int DH> __host__ __device__ constexpr int kv_elems() { return sa::TILE * DH; }

// wgmma.mma_async m64nNk16 bf16 -> fp32 with A from registers (the
// mma.sync A-fragment layout of each warp's 16 rows) and B from a shared
// memory descriptor; the accumulators are the mma.sync C fragments of the
// warp's 16 rows, n-tile after n-tile (d[4 j + e] = C fragment e of n-tile
// j). TNSP = 1 reads B transposed (its rows are k).
template <int N> struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TNSP));
  }
};

template <>
struct Wgmma<64> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TNSP));
  }
};

template <>
struct Wgmma<96> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TNSP));
  }
};

template <>
struct Wgmma<128> {
  template <int TNSP>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TNSP));
  }
};

// Scores (C fragments) of keys j0 + column at or past nk to -inf.
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N][4], int j0, int nk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + nt * 8 + 2 * t + (e & 1) >= nk) s[nt][e] = -INFINITY;
}

// The descriptor of a shared-memory tile at p for wgmma: lbo and sbo in
// bytes, `swizzle` the 128-byte swizzle (else none).
__device__ __forceinline__ uint64_t tile_desc(const bf16* p, uint32_t lbo, uint32_t sbo,
                                              bool swizzle) {
  return (uint64_t)((sa::smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}

// Key and value tiles in shared memory, in layouts the wgmma descriptor
// reads. At head width 64 (the model's) a row is 128 bytes and the tile
// takes the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)):
// eight lanes copy one row, reading 128 contiguous bytes and writing
// distinct banks. Other widths keep rows of 8 x 16-byte core matrices
// without a swizzle (chunk c of row r at element ((r / 8) * (DH / 8) + c)
// * 64 + (r % 8) * 8), eight lanes filling one core matrix.
template <int DH>
struct Tiles {
  static constexpr bool SWIZZLE = DH == 64;

  // `rows` rows of DH bf16 from global (row r at src + r * ld_src); rows
  // at or past `valid` are zero-filled; commits nothing.
  static __device__ __forceinline__ void copy(bf16* dst, const bf16* src, int ld_src, int rows,
                                              int valid) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < rows * CH; idx += sa::THREADS) {
      int r, c, at;
      if constexpr (SWIZZLE) {
        r = idx / CH, c = idx % CH, at = r * DH + ((c ^ (r & 7)) << 3);
      } else {
        const int rr = idx & 7;
        c = (idx >> 3) % CH, r = (idx / (8 * CH)) * 8 + rr, at = ((r >> 3) * CH + c) * 64 + rr * 8;
      }
      const bool ok = r < valid;
      cp_async_16(dst + at, src + (size_t)(ok ? r : 0) * ld_src + c * 8, ok);
    }
  }

  // k-step kk (16 columns of dh) of the key tile as S = q . k^T's k-major B.
  static __device__ __forceinline__ uint64_t k_desc(const bf16* tile, int kk) {
    if constexpr (SWIZZLE) return tile_desc(tile + kk * 16, 16, 1024, true);
    return tile_desc(tile + kk * 128, 128, DH * 16, false);
  }

  // k-step kk (16 keys) of the value tile as O += P . v's transposed B
  // (swizzled: sbo steps 8 keys; lbo, the step between 64-column groups of
  // dh, is unused at one group).
  static __device__ __forceinline__ uint64_t v_desc(const bf16* tile, int kk) {
    if constexpr (SWIZZLE) return tile_desc(tile + kk * 16 * DH, 16, 1024, true);
    return tile_desc(tile + kk * 16 * DH, DH * 16, 128, false);
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// s (16 x N per warp; 64 x N per warpgroup) = q . k^T over N keys of the
// core-matrix tile sK.
template <int DH, int N>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], const uint32_t (&qa)[DH / 16][4],
                                       const bf16* sK) {
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&s[0][0]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    Wgmma<N>::template run<0>(d, qa[kk], Tiles<DH>::k_desc(sK, kk), kk > 0);
  wg_commit_wait();
}

// o (16 x DH per warp) += p (A fragments, 16 x 64) . v, v a core-matrix tile
// of 64 keys.
template <int DH>
__device__ __forceinline__ void probs_times_v(float (&o)[DH / 8][4],
                                              const uint32_t (&pa)[sa::TILE / 16][4],
                                              const bf16* sV) {
  float(&d)[DH / 2] = *reinterpret_cast<float(*)[DH / 2]>(&o[0][0]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < sa::TILE / 16; ++kk)
    Wgmma<DH>::template run<1>(d, pa[kk], Tiles<DH>::v_desc(sV, kk), 1);
  wg_commit_wait();
}

template <int DH> constexpr size_t smem_bytes() {
  return (size_t)(q_elems<DH>() + 2 * STAGES * kv_elems<DH>()) * sizeof(bf16);
}

template <int MODE>
__device__ __forceinline__ float ex2(float x) {
  if constexpr ((MODE & NO_EXP) != 0) return x;
  return sa::exp2_ftz(x);
}

// c = scale * log2(e): exp(s * scale - m') = exp2(s * c - m) with m = m' * log2(e).
template <int DH, int MODE = BOTH>
__global__ void __launch_bounds__(sa::THREADS, DH <= 64 ? 2 : 1)
short_attention_fwd_kernel(const bf16* __restrict__ Q, int ldq, const bf16* __restrict__ Kp,
                           int ldk, const bf16* __restrict__ Vp, int ldv,
                           bf16* __restrict__ O, int ldo, float* __restrict__ lse,
                           int heads, int nq, int nk, float c) {
  constexpr int NT = sa::TILE / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + q_elems<DH>();  // stage st: k at sKV + 2*st*kv, v after it
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * sa::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the block's tile
  const bool active = (warp >> 2) * 64 < nq - q0;  // its warpgroup has a row
  constexpr int T1 = 2 * sa::TILE;  // keys per pass-1 step
  const int tiles1 = (nk + T1 - 1) / T1, steps = tiles1 + (nk + sa::TILE - 1) / sa::TILE;
  const bf16* kbase = Kp + (size_t)b * nk * ldk + h * DH;
  const bf16* vbase = Vp + (size_t)b * nk * ldv + h * DH;

  // Step i < tiles1 is pass 1 over keys T1 * i.., step tiles1 + j pass 2
  // over key tile j; each step's copies are one cp.async group.
  auto issue = [&](int i) {
    if (i < steps) {
      const int j0 = i < tiles1 ? i * T1 : (i - tiles1) * sa::TILE;
      bf16* sK = sKV + (size_t)(i % STAGES) * 2 * kv_elems<DH>();
      if (i < tiles1) {
        Tiles<DH>::copy(sK, kbase + (size_t)j0 * ldk, ldk, T1, nk - j0);
      } else {
        Tiles<DH>::copy(sK, kbase + (size_t)j0 * ldk, ldk, sa::TILE, nk - j0);
        Tiles<DH>::copy(sK + kv_elems<DH>(), vbase + (size_t)j0 * ldv, ldv, sa::TILE, nk - j0);
      }
    }
    cp_async_commit();
  };

  sa::copy_rows<DH>(sQ, Q + ((size_t)b * nq + q0) * ldq + h * DH, ldq, sa::ROWS, nq - q0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // q rides in the first group

  // The top of every step: wait for its copies, then reuse the stage that
  // the step before last read.
  auto begin_step = [&](int i) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies, made through the generic proxy, become visible
    // to wgmma's reads (the async proxy) once every thread has fenced
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step i's tile has landed; step i-1's stage is free
    issue(i + STAGES - 1);
  };
  auto stage_k = [&](int i) { return sKV + (size_t)(i % STAGES) * 2 * kv_elems<DH>(); };

  uint32_t qa[DH / 16][4];
  // Rows g (u = 0) and g + 8 (u = 1): running max m (log2 units) and this
  // lane's share of the row sum l; after pass 1, l holds 1 / (row sum).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr ((MODE & PASS1) == 0) m[0] = m[1] = 0.f, l[0] = l[1] = 1.f;
  for (int i = 0; i < tiles1; ++i) {  // pass 1
    begin_step(i);
    if (!active) continue;
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) sa::frag_a<DH>(qa[kk], sQ, r0, kk);
    }
    if constexpr ((MODE & PASS1) != 0) {
      const int j0 = i * T1;
      float s[T1 / 8][4];
      scores<DH, T1>(s, qa, stage_k(i));
      if (j0 + T1 > nk) mask_keys(s, j0, nk);
      // The running max and sum move one 64-key half at a time, as over
      // 64-key tiles: the same sums in the same order.
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float tm = -INFINITY;
#pragma unroll
          for (int nt = half * NT; nt < (half + 1) * NT; ++nt)
            tm = fmaxf(tm, fmaxf(s[nt][2 * u], s[nt][2 * u + 1]));
          const float mn = fmaxf(m[u], sa::quad_max(tm) * c);
          float ts = 0.f;
#pragma unroll
          for (int nt = half * NT; nt < (half + 1) * NT; ++nt)
            ts += ex2<MODE>(fmaf(s[nt][2 * u], c, -mn)) +
                  ex2<MODE>(fmaf(s[nt][2 * u + 1], c, -mn));
          l[u] = l[u] * ex2<MODE>(m[u] - mn) + ts;
          m[u] = mn;
        }
    }
  }
  if (active && (MODE & PASS1) != 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] = sa::quad_sum(l[u]);
      const int r = q0 + r0 + g + 8 * u;
      if (lse != nullptr && t == 0 && r < nq)
        lse[(size_t)(b * heads + h) * nq + r] = (m[u] + log2f(l[u])) * sa::LN2;
      l[u] = 1.f / l[u];
    }
  }

  float o[DH / 8][4];
  sa::zero(o);
  for (int i = tiles1; i < steps; ++i) {  // pass 2
    begin_step(i);
    if (!active) continue;
    if constexpr ((MODE & PASS2) != 0) {
      const int j0 = (i - tiles1) * sa::TILE;
      const bf16* sK = stage_k(i);
      float s[NT][4];
      scores<DH, sa::TILE>(s, qa, sK);
      if (j0 + sa::TILE > nk) mask_keys(s, j0, nk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = ex2<MODE>(fmaf(s[nt][e], c, -m[e >> 1])) * l[e >> 1];
      uint32_t pa[sa::TILE / 16][4];
      sa::to_a(pa, s);
      probs_times_v<DH>(o, pa, sK + kv_elems<DH>());
    }
  }
  sa::store_rows<DH>(O + h * DH, ldo, (size_t)b * nq + q0, r0, nq - q0, o);
}

template <int DH, int MODE = BOTH>
cudaError_t launch(const bf16* Q, int ldq, const bf16* Kp, int ldk, const bf16* Vp, int ldv,
                   bf16* O, int ldo, float* lse, int batch, int heads, int nq, int nk,
                   cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(short_attention_fwd_kernel<DH, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + sa::ROWS - 1) / sa::ROWS, heads, batch);
  // dh ** -0.5 * log2(e) in double, rounded once to fp32.
  const float c = (float)(sa::LOG2E / sqrt((double)DH));
  short_attention_fwd_kernel<DH, MODE><<<grid, sa::THREADS, smem, s>>>(
      Q, ldq, Kp, ldk, Vp, ldv, O, ldo, lse, heads, nq, nk, c);
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

// Stage timing of the forward at head width 64 (chip_smoke.py phase 8):
// mode 1 runs pass 1 alone, 2 pass 2 alone, 3 both (the kernel), 7 both
// without the exponentials; every mode makes the same copies. Only mode 3
// gives a meaningful o (and writes no lse here).
extern "C" int mm_short_attention_fwd_stage_bf16(const void* q, int ldq, const void* k, int ldk,
                                                 const void* v, int ldv, void* o, int batch,
                                                 int nq, int nk, int heads, int mode,
                                                 void* stream) {
  using mm::bf16;
  const auto args = std::make_tuple(static_cast<const bf16*>(q), ldq, static_cast<const bf16*>(k),
                                    ldk, static_cast<const bf16*>(v), ldv, static_cast<bf16*>(o),
                                    heads * 64, static_cast<float*>(nullptr), batch, heads, nq,
                                    nk, static_cast<cudaStream_t>(stream));
  cudaError_t e;
  switch (mode) {
    case PASS1: e = std::apply(launch<64, PASS1>, args); break;
    case PASS2: e = std::apply(launch<64, PASS2>, args); break;
    case BOTH: e = std::apply(launch<64, BOTH>, args); break;
    case BOTH | NO_EXP: e = std::apply(launch<64, BOTH | NO_EXP>, args); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
