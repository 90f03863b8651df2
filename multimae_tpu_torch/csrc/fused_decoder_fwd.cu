// fused_decoder_fwd (K1 forward): the SpatialOutputAdapter decoder body.
//
// Replaces: multimae_tpu/ops/fused_decoder_pallas.py `fused_decoder_core`
// forward (`_fused_fwd` -> `_fwd_call`, Pallas program `_fwd_kernel`, math
// `_core_fwd`).
//
// What bounds it on the H100: at the pretraining shape (B=128, 196 queries,
// 99 context tokens, D=256, 8 heads of 32, hidden 1024, depth 2) every
// GEMM has K or N of 256: about 125 GFLOP per call (about 0.13 ms at the
// bf16 tensor-core peak), while its ~25 steps move ~0.8 GB of (25,088,
// 256..1024) activation slabs through device memory (about 0.24 ms at
// 3.35 TB/s): in bf16 the chain is bound by memory traffic and by launch
// count rather than by the tensor cores. The fp32 (semseg) variant runs
// its GEMMs on true fp32 FMA (no TF32), which bounds it by the 67 TFLOP/s
// fp32 rate instead (about 1.9 ms at B=128).
//
// Design: a fixed chain of launches on the caller's stream, on K1's own
// tiles (decoder_tc.cuh): LN q, LN c, GEMM q
// (D -> D), GEMM kv (D -> 2D), cross-attention (196 x 99), GEMM proj (no
// residual: the cross-attention output replaces the queries), LN, GEMM
// fc1 + GELU, GEMM fc2 + residual, then `depth` pre-LN blocks at dim D.
// bf16: the GEMMs on wgmma (128-byte-swizzled tiles through a 3-stage
// cp.async ring, epilogues fused), the attention on mma.sync with the
// head's K and V in shared memory (the key-tiled K2 forward where they do
// not fit). fp32: register-blocked FMA GEMMs (128 x 128 tiles, 8 x 8 a
// thread) and a register-tiled FMA attention (common.cuh's where the
// head's K and V do not fit). Keeping a sample's tokens on
// chip across the whole body, as the TPU kernel does in VMEM, is later
// work.

#include "decoder_tc.cuh"

namespace {

using namespace mm;  // DecoderField: weight pointers in DecoderCoreWeights order

template <typename T>
cudaError_t decoder_fwd(const T* q, const T* c, T* out, const void* const* w,
                        T* qn, T* cn, T* xq, T* kv, T* att, T* qkv, T* hid,
                        int batch, int nq, int nc, int d, int heads, int hidden,
                        int depth, cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  const T* none = nullptr;
  const int mq = batch * nq, mc = batch * nc, dh = d / heads;
  const size_t D = d, H = hidden;
  DTC_TRY(dtc::layer_norm<T>(q, F(QN_G), F(QN_B), qn, mq, d, s));
  DTC_TRY(dtc::layer_norm<T>(c, F(CN_G), F(CN_B), cn, mc, d, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(qn, W(WQ), W(BQ), none, xq, mq, d, d, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(cn, W(WKV), W(BKV), none, kv, mc, 2 * d, d, s));
  DTC_TRY(dtc::attention_fwd(xq, d, kv, kv + d, 2 * d, att, d, batch, heads, nq, nc, dh, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(att, W(WXP), W(BXP), none, out, mq, d, d, s));
  DTC_TRY(dtc::layer_norm<T>(out, F(ON_G), F(ON_B), qn, mq, d, s));
  DTC_TRY(dtc::dense<dtc::GELU>(qn, W(W1), W(B1), none, hid, mq, hidden, d, s));
  DTC_TRY(dtc::dense<dtc::RES>(hid, W(W2), W(B2), out, out, mq, d, hidden, s));

  // depth x (x + proj(attn(qkv(LN1(x)))); x + fc2(gelu(fc1(LN2(x))))), in place
  for (int i = 0; i < depth; ++i) {
    DTC_TRY(dtc::layer_norm<T>(out, F(N1_G) + i * D, F(N1_B) + i * D, qn, mq, d, s));
    DTC_TRY(dtc::dense<dtc::BIAS>(qn, W(WQKV) + i * 3 * D * D, W(BQKV) + i * 3 * D, none, qkv,
                                 mq, 3 * d, d, s));
    DTC_TRY(dtc::attention_fwd(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, att, d, batch, heads,
                              nq, nq, dh, s));
    DTC_TRY(dtc::dense<dtc::RES>(att, W(WP) + i * D * D, W(BP) + i * D, out, out, mq, d, d, s));
    DTC_TRY(dtc::layer_norm<T>(out, F(N2_G) + i * D, F(N2_B) + i * D, qn, mq, d, s));
    DTC_TRY(dtc::dense<dtc::GELU>(qn, W(WF1) + i * H * D, W(BF1) + i * H, none, hid, mq,
                                 hidden, d, s));
    DTC_TRY(dtc::dense<dtc::RES>(hid, W(WF2) + i * D * H, W(BF2) + i * D, out, out, mq, d,
                                hidden, s));
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
