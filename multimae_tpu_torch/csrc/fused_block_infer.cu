// fused_block_infer (K4): one pre-LN ViT encoder block, inference only.
//
// Replaces: multimae_tpu/ops/fused_block_pallas.py `fused_block_infer`
// (Pallas programs `_kernel` / `_kernel_tiled`, math `_block_2d`).
//
// Roundings are the TPU kernel's (`_block_2d`, :164-183): LayerNorm with
// fp32 statistics rounded to bf16; each dense's fp32 sum rounded to bf16
// before its bf16 bias is added; fp32 logits and softmax, p rounded to
// bf16 before P . V; the residuals added in bf16; exact-erf GELU in fp32
// (the TPU kernel's is the tanh-basis fit, within 3e-6).
//
// What bounds it on the H100: at the serving shape (B=32, N=99 tokens,
// D=768, 12 heads, hidden 3072, bf16) a block is 45 GFLOP of GEMMs over
// 3168 rows, so it is bound by tensor-core throughput (about 45 us at
// the bf16 peak) more than by the 14 MB of weights and ~150 MB of
// activation traffic between its steps (about 50 us at 3.35 TB/s).
// Attention is 4% of the FLOPs. At the 512-px eval shape (B=4, N=2049) the
// GEMMs are 116 GFLOP and the attention 26 GFLOP.
//
// Design: a fixed chain of seven launches on the caller's stream: LN1 ->
// GEMM qkv (768 -> 2304) + bias -> attention (q/k/v read in place from the
// fused qkv output) -> GEMM proj + bias + residual -> LN2 -> GEMM fc1 +
// bias + GELU -> GEMM fc2 + bias + residual. The GEMMs and LayerNorms run
// on the tiles of decoder_tc.cuh: wgmma over 128-byte-swizzled tiles
// through a 3-stage cp.async ring, the epilogue (bias, GELU, residual) on
// the rounded tile staged in shared memory and written in 16-byte pieces;
// the torch (out, in) weights read as they lie; one warp per LayerNorm
// row in 16-byte pieces. The GEMMs run over all B*N rows at once (the TPU
// kernel's per-sample grid is a VMEM artefact). The attention is K1's
// bf16 forward (decoder_tc.cuh: mma.sync, a block per 64 query rows of a
// sample-head with its K and V rows in shared memory, two passes so that p
// is rounded where the TPU kernel rounds it) where they fit, else the
// key-tiled K2 forward (2049 tokens). At 99 tokens common.cuh's FMA
// attention took 27% of the block's device time once the GEMMs moved to
// wgmma (H100, 700 W; PERF.md), which is why it moved too. Activations
// between the steps go through device memory; fusing across the GEMMs is
// later work.

#include "decoder_tc.cuh"

namespace {

using namespace mm;  // bf16 and the dtc tiles

// Weight pointers in BlockWeights order (ops/fused_block.py).
enum { B_N1_G, B_N1_B, B_WQKV, B_BQKV, B_WP, B_BP, B_N2_G, B_N2_B, B_W1, B_B1, B_W2, B_B2 };

// out = x + proj(attn(qkv(LN1(x)))); out += fc2(GELU(fc1(LN2(out)))).
cudaError_t block_infer(const bf16* x, bf16* out, const void* const* w, bf16* ln, bf16* qkv,
                        bf16* att, bf16* hid, int batch, int n, int d, int heads, int hidden,
                        cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  const bf16* none = nullptr;
  const int M = batch * n, dh = d / heads;
  DTC_TRY(dtc::layer_norm<bf16>(x, F(B_N1_G), F(B_N1_B), ln, M, d, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(ln, W(B_WQKV), W(B_BQKV), none, qkv, M, 3 * d, d, s));
  DTC_TRY(dtc::attention_fwd(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, att, d, batch, heads, n,
                             n, dh, s));
  DTC_TRY(dtc::dense<dtc::RES>(att, W(B_WP), W(B_BP), x, out, M, d, d, s));
  DTC_TRY(dtc::layer_norm<bf16>(out, F(B_N2_G), F(B_N2_B), ln, M, d, s));
  DTC_TRY(dtc::dense<dtc::GELU>(ln, W(B_W1), W(B_B1), none, hid, M, hidden, d, s));
  return dtc::dense<dtc::RES>(hid, W(B_W2), W(B_B2), out, out, M, d, hidden, s);
}

}  // namespace

extern "C" int mm_fused_block_infer_bf16(const void* x, void* out, const void* const* w,
                                         void* ln, void* qkv, void* att, void* hid,
                                         int batch, int n, int d, int heads, int hidden,
                                         void* stream) {
  return static_cast<int>(block_infer(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), w, static_cast<bf16*>(ln),
      static_cast<bf16*>(qkv), static_cast<bf16*>(att), static_cast<bf16*>(hid), batch, n, d,
      heads, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
