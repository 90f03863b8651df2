// fused_mlp forward (K3a fwd), y = fc2(GELU(fc1(x))), and fused_ln_mlp_res
// forward (K3b fwd), the ConvNeXt block after its depthwise conv,
// y = res + fc2(GELU(fc1(LN(x)))). Both run the same MLP chain.
//
// Replaces: multimae_tpu/ops/fused_mlp_pallas.py `fused_mlp` forward
// (`_fwd`, Pallas program `_fwd_kernel`) and `fused_ln_mlp_res` forward
// (`_lmr_fwd`, Pallas program `_lmr_fwd_kernel`).
//
// Roundings are the TPU kernels' (:93-95, :228-232, `_ln_fwd`, `_dense`,
// `_gelu_fwd`): LayerNorm with fp32 statistics (two-pass here, the
// TPU kernel's fast variance E[x^2] - E[x]^2 there) rounded to bf16; each
// dense's fp32 sum rounded to bf16 before its bf16 bias is added; exact-erf
// GELU in fp32 (the TPU kernel's is the tanh-basis fit, within 3e-6);
// the residual added in bf16.
//
// What bounds it on the H100: at the 512-px ConvNeXt head (M = 4*128*128 =
// 65,536 rows, K = 384, hidden 1536, bf16) the two GEMMs are 4*M*K*H =
// 154.6 GFLOP (156 us at the bf16 peak) against 4*M*K*2 bytes of x, res and
// y plus the weights (~0.2 GB, 60 us at 3.35 TB/s): tensor-core bound.
//
// Design: the TPU kernel keeps each 2048-row tile's (2048, 1536) hidden
// strip in VMEM. Here a chain of three launches on the caller's stream, on
// the wgmma tiles of decoder_tc.cuh: [LN (one warp per row, 8-byte pieces
// at K = 384) ->] fc1 with bias + GELU in its epilogue -> fc2 with bias
// [+ residual] in its epilogue, the (M, 1536) hidden (201 MB) in device
// scratch between them. The GEMMs read the torch (out, in) weights as
// they lie (the NT form: no transposes). Keeping the hidden strip on chip
// (a fused two-GEMM kernel over row tiles) is later work.

#include "decoder_tc.cuh"

namespace {

using namespace mm;  // bf16 and the dtc tiles

// hid = GELU(fc1(x)); y = fc2(hid) (+ res where res is not null).
cudaError_t mlp_chain(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                      const bf16* b2, const bf16* res, bf16* hid, bf16* y, int m, int k,
                      int hidden, cudaStream_t s) {
  const bf16* none = nullptr;
  DTC_TRY(dtc::dense<dtc::GELU>(x, w1, b1, none, hid, m, hidden, k, s));
  if (res == nullptr) return dtc::dense<dtc::BIAS>(hid, w2, b2, none, y, m, k, hidden, s);
  return dtc::dense<dtc::RES>(hid, w2, b2, res, y, m, k, hidden, s);
}

// Pointers in the K3b wrapper's order (ops/fused_mlp.py): LayerNorm gamma
// and beta (K,) fp32; w1 (H, K), b1 (H,), w2 (K, H), b2 (K,) bf16. K3a's
// are the last four.
enum { P_LN_G, P_LN_B, P_W1, P_B1, P_W2, P_B2 };

}  // namespace

// x (M, K) bf16 -> y (M, K) bf16; w = {w1, b1, w2, b2} bf16; hid (M, H)
// bf16 scratch.
extern "C" int mm_fused_mlp_fwd_bf16(const void* x, void* y, const void* const* w, void* hid,
                                     int m, int k, int hidden, void* stream) {
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  return static_cast<int>(mlp_chain(static_cast<const bf16*>(x), W(0), W(1), W(2), W(3),
                                    nullptr, static_cast<bf16*>(hid), static_cast<bf16*>(y),
                                    m, k, hidden, static_cast<cudaStream_t>(stream)));
}

// x, res (M, K) bf16 -> y (M, K) bf16; ln (M, K) and hid (M, H) bf16 scratch.
extern "C" int mm_fused_ln_mlp_res_fwd_bf16(const void* x, const void* res, void* y,
                                            const void* const* w, void* ln, void* hid,
                                            int m, int k, int hidden, void* stream) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto s = static_cast<cudaStream_t>(stream);
  bf16* lnb = static_cast<bf16*>(ln);
  cudaError_t e = dtc::layer_norm<bf16>(static_cast<const bf16*>(x), F(P_LN_G), F(P_LN_B), lnb,
                                        m, k, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mlp_chain(lnb, W(P_W1), W(P_B1), W(P_W2), W(P_B2),
                                    static_cast<const bf16*>(res), static_cast<bf16*>(hid),
                                    static_cast<bf16*>(y), m, k, hidden, s));
}
