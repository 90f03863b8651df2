// fused_ln_mlp_res forward (K3b fwd): the ConvNeXt block after its
// depthwise conv, y = res + fc2(GELU(fc1(LN(x)))).
//
// Replaces: multimae_tpu/ops/fused_mlp_pallas.py `fused_ln_mlp_res`
// forward (`_lmr_fwd`, Pallas program `_lmr_fwd_kernel`).
//
// Roundings are the TPU kernel's (:228-232, `_ln_fwd`, `_dense`,
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
// strip in VMEM. This first version is a chain of three launches on the
// caller's stream from common.cuh, with the (M, 1536) hidden (201 MB) in
// device scratch: LN -> GEMM fc1 + bias + GELU -> GEMM fc2 + bias +
// residual, mma.sync bf16 tiles with fp32 accumulation and the roundings
// in the epilogues. Keeping the hidden strip on chip (a fused two-GEMM
// kernel over row tiles) is later work.

#include "common.cuh"

namespace {

// Pointers in the wrapper's order (ops/fused_mlp.py): LayerNorm gamma and
// beta (K,) fp32; w1 (H, K), b1 (H,), w2 (K, H), b2 (K,) bf16.
enum { LN_G, LN_B, W1, B1, W2, B2 };

}  // namespace

// x, res (M, K) bf16 -> y (M, K) bf16; ln (M, K) and hid (M, H) bf16 scratch.
extern "C" int mm_fused_ln_mlp_res_fwd_bf16(const void* x, const void* res, void* y,
                                            const void* const* w, void* ln, void* hid,
                                            int m, int k, int hidden, void* stream) {
  using T = mm::bf16;
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  auto s = static_cast<cudaStream_t>(stream);
  T* lnb = static_cast<T*>(ln);
  T* hb = static_cast<T*>(hid);
  cudaError_t e;
  if ((e = mm::layer_norm<T>(static_cast<const T*>(x), F(LN_G), F(LN_B), lnb, m, k, s)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = mm::gemm<mm::EPI_GELU>(lnb, W(W1), W(B1), (const T*)nullptr, hb, m, hidden, k, s)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(mm::gemm<mm::EPI_RES>(hb, W(W2), W(B2), static_cast<const T*>(res),
                                                static_cast<T*>(y), m, k, hidden, s));
}
