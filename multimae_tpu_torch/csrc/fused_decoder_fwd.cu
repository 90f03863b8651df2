// fused_decoder_fwd (K1 forward): the SpatialOutputAdapter decoder body.
//
// Replaces: multimae_tpu/ops/fused_decoder_pallas.py `fused_decoder_core`
// forward (`_fused_fwd` -> `_fwd_call`, Pallas program `_fwd_kernel`, math
// `_core_fwd`).
//
// What bounds it on the H100: at the pretraining shape (B=32, 196 queries,
// 99 context tokens, D=256, 8 heads of 32, hidden 1024, depth 2) every
// GEMM has K or N of 256: about 31 GFLOP per call (about 30 us at the
// bf16 tensor-core peak), while its ~25 steps move ~200 MB of (6272,
// 256..1024) activation slabs through device memory (about 60 us at
// 3.35 TB/s): in bf16 the chain is bound by memory traffic and launch
// count rather than by the tensor cores. The fp32 (semseg) variant runs
// its GEMMs on true fp32 FMA (no TF32), which bounds it by the 67 TFLOP/s
// fp32 rate instead (about 0.5 ms).
//
// Design: a fixed chain of launches on the caller's stream (common.cuh):
// LN q, LN c, GEMM q (D -> D), GEMM kv (D -> 2D), cross-attention (196 x 99,
// K/V in shared memory, read in place from the kv output), GEMM proj (no
// residual: the cross-attention output replaces the queries), LN, GEMM
// fc1 + GELU, GEMM fc2 + residual, then `depth` times the fused_block_infer
// chain at dim D. Keeping a sample's tokens on chip across the whole body,
// as the TPU kernel does in VMEM, is later work.

#include "common.cuh"

namespace {

using namespace mm;  // DecoderField: weight pointers in DecoderCoreWeights order

template <typename T>
cudaError_t decoder_fwd(const T* q, const T* c, T* out, const void* const* w,
                        T* qn, T* cn, T* xq, T* kv, T* att, T* qkv, T* hid,
                        int batch, int nq, int nc, int d, int heads, int hidden,
                        int depth, cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  const int mq = batch * nq, mc = batch * nc, dh = d / heads;
  cudaError_t e;
  if ((e = mm::layer_norm<T>(q, F(QN_G), F(QN_B), qn, mq, d, s)) != cudaSuccess) return e;
  if ((e = mm::layer_norm<T>(c, F(CN_G), F(CN_B), cn, mc, d, s)) != cudaSuccess) return e;
  if ((e = mm::gemm<mm::EPI_BIAS>(qn, W(WQ), W(BQ), (const T*)nullptr, xq, mq, d, d, s)) != cudaSuccess) return e;
  if ((e = mm::gemm<mm::EPI_BIAS>(cn, W(WKV), W(BKV), (const T*)nullptr, kv, mc, 2 * d, d, s)) != cudaSuccess) return e;
  if ((e = mm::attention<T>(xq, d, kv, kv + d, 2 * d, att, d, batch, heads, nq, nc,
                            dh, s)) != cudaSuccess) return e;
  if ((e = mm::gemm<mm::EPI_BIAS>(att, W(WXP), W(BXP), (const T*)nullptr, out, mq, d, d, s)) != cudaSuccess) return e;
  if ((e = mm::layer_norm<T>(out, F(ON_G), F(ON_B), qn, mq, d, s)) != cudaSuccess) return e;
  if ((e = mm::gemm<mm::EPI_GELU>(qn, W(W1), W(B1), (const T*)nullptr, hid, mq, hidden, d, s)) != cudaSuccess) return e;
  if ((e = mm::gemm<mm::EPI_RES>(hid, W(W2), W(B2), out, out, mq, d, hidden, s)) != cudaSuccess) return e;

  for (int i = 0; i < depth; ++i) {
    mm::BlockParams<T> p;
    p.n1_g = F(N1_G) + (size_t)i * d;
    p.n1_b = F(N1_B) + (size_t)i * d;
    p.wqkv = W(WQKV) + (size_t)i * 3 * d * d;
    p.bqkv = W(BQKV) + (size_t)i * 3 * d;
    p.wp = W(WP) + (size_t)i * d * d;
    p.bp = W(BP) + (size_t)i * d;
    p.n2_g = F(N2_G) + (size_t)i * d;
    p.n2_b = F(N2_B) + (size_t)i * d;
    p.w1 = W(WF1) + (size_t)i * hidden * d;
    p.b1 = W(BF1) + (size_t)i * hidden;
    p.w2 = W(WF2) + (size_t)i * d * hidden;
    p.b2 = W(BF2) + (size_t)i * d;
    if ((e = mm::block_chain<T>(out, out, p, qn, qkv, att, hid, batch, nq, d,
                                heads, hidden, s)) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

#define MM_DECODER_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* c, void* out,                     \
                      const void* const* w, void* qn, void* cn, void* xq,          \
                      void* kv, void* att, void* qkv, void* hid, int batch,        \
                      int nq, int nc, int d, int heads, int hidden, int depth,     \
                      void* stream) {                                              \
    return static_cast<int>(decoder_fwd<T>(                                        \
        static_cast<const T*>(q), static_cast<const T*>(c), static_cast<T*>(out),  \
        w, static_cast<T*>(qn), static_cast<T*>(cn), static_cast<T*>(xq),          \
        static_cast<T*>(kv), static_cast<T*>(att), static_cast<T*>(qkv),           \
        static_cast<T*>(hid), batch, nq, nc, d, heads, hidden, depth,              \
        static_cast<cudaStream_t>(stream)));                                       \
  }

MM_DECODER_ENTRY(mm_fused_decoder_fwd_bf16, mm::bf16)
MM_DECODER_ENTRY(mm_fused_decoder_fwd_f32, float)
