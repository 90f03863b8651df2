// fused_mlp backward (K3a bwd) and fused_ln_mlp_res backward (K3b bwd):
// gradients of y = fc2(GELU(fc1(x))) (K3a) and of
// y = res + fc2(GELU(fc1(LN(x)))) (K3b) with respect to x, fc1's and fc2's
// weights and biases and, for K3b, the LayerNorm's gamma and beta. K3b's
// residual gradient is dy itself (the caller passes it through, as the TPU
// kernel's VJP returns it, fused_mlp_pallas.py:346).
//
// Replaces: multimae_tpu/ops/fused_mlp_pallas.py `fused_mlp` backward
// (`_bwd`, Pallas program `_bwd_kernel`) and `fused_ln_mlp_res` backward
// (`_lmr_bwd`, Pallas program `_lmr_bwd_kernel`).
//
// What it computes, rounding where `_bwd_kernel` (:98-136) and
// `_lmr_bwd_kernel` (:235-264) round: [LayerNorm and] fc1 recomputed as the
// TPU kernels do (K3b keeps the row statistics), then, with in = x (K3a)
// or n1 = LN(x) (K3b),
//   dW2 = dy^T . h, db2 = colsum(dy)                       fp32
//   dpre = bf16(bf16(dy . W2) * GELU'(pre))                 the GELU backward
//   dW1 = dpre^T . in, db1 = colsum(dpre)                   fp32
//   din = bf16(dpre . W1)                                   K3a: dx = din
//   K3b: dx = bf16(LayerNorm backward of din), dgamma, dbeta fp32
// (torch layout: W1 (H, K), W2 (K, H), and dW in the same layout).
//
// What bounds it on the H100: at the 512-px ConvNeXt head (M = 65,536
// rows, K = 384, hidden 1536) the recomputed fc1 and the four backward
// GEMMs are 10*M*K*H = 386.6 GFLOP (391 us at the bf16 peak): tensor-core
// bound. Its (M, 1536) bf16 slabs (201 MB each: pre, then dpre over it, and
// GELU(pre)) move ~1.0 GB (~0.3 ms at 3.35 TB/s) in this design.
//
// Design, on the tiles of decoder_tc.cuh (as the K1 backward): seven
// launches on the caller's stream, plus one slice sum after each dW pass
// and the LayerNorm's partial-sum pass and slice sum:
//   1. K3b: LayerNorm recomputed with its row statistics (8-byte pieces at
//      K = 384);
//   2. fc1 on wgmma with the GELU2 epilogue: pre and h = GELU(pre) in one
//      pass;
//   3. dW2 and db2: the TN form sums dy^T . h over fixed row slices and the
//      column sums of dy from the tile of dy it already holds;
//   4. dpre: the NN form dy . W2 reads W2 as it lies (no transpose), the
//      DGELU epilogue writes dpre over pre;
//   5. dW1 and db1: the TN form over dpre and in;
//   6. din = dpre . W1, the NN form;
//   7. K3b: the LayerNorm backward, one warp per row, with dgamma and dbeta
//      from 128-row partial sums.
// dW, db, dgamma and dbeta are fp32 partial sums over row slices fixed by
// the shape, added in slice order: bit-equal from run to run, no atomics.
// K3a and K3b share the chain (mlp_bwd). Keeping the hidden strip on chip
// (a fused two-GEMM kernel over row tiles, as the TPU kernel keeps it in
// VMEM) is later work.

#include "decoder_tc.cuh"

namespace {

using namespace mm;  // bf16 and the dtc tiles

// Pointers in the wrapper's order (ops/fused_mlp.py): LayerNorm gamma and
// beta (K,) fp32, w1 (H, K), b1 (H,), w2 (K, H) bf16.
enum { P_LN_G, P_LN_B, P_W1, P_B1, P_W2 };
// Gradients in the wrapper's order, all fp32.
enum { D_LN_G, D_LN_B, D_W1, D_B1, D_W2, D_B2 };

// Offsets (elements) into the bf16 workspace `ws` and the fp32 workspace
// `fws`, each buffer on a 64-element boundary. Without the LayerNorm (K3a)
// n1, mean and rstd take no room.
struct Layout {
  size_t n1, pre, hh, t_total;
  size_t mean, rstd, part, part_b, f_total;
};

size_t take(size_t& n, size_t elems) {
  const size_t o = n;
  n += (elems + 63) & ~(size_t)63;
  return o;
}

size_t larger(size_t a, size_t b) { return a > b ? a : b; }

Layout make_layout(int m, int k, int hidden, bool ln) {
  Layout L{};
  const size_t M = m, K = k, H = hidden, R = ln ? M : 0;
  size_t t = 0, f = 0;
  L.n1 = take(t, R * K);   // LN(x), then dn1 over it
  L.pre = take(t, M * H);  // fc1 pre-activation, then dpre over it
  L.hh = take(t, M * H);   // GELU(pre)
  L.t_total = t;
  L.mean = take(f, R);
  L.rstd = take(f, R);
  // The partial sums of the two TN products (dW2: K x H, dW1: H x K) and,
  // for K3b, of dgamma and dbeta.
  const size_t s2 = dtc::tn_slices(m, k, hidden), s1 = dtc::tn_slices(m, hidden, k);
  size_t part = larger(s2, s1) * K * H;
  if (ln) part = larger(part, 2 * (size_t)dtc::ln_slices(m) * K);
  L.part = take(f, part);
  L.part_b = take(f, larger(s2 * K, s1 * H));
  L.f_total = f;
  return L;
}

// The MLP's backward from its input `in` (M, K) and dy (M, K): recompute
// pre = fc1(in) and h = GELU(pre), then the fp32 dW2, db2, dW1, db1 and
// din = bf16(dpre . W1). din may be `in`'s buffer (read last by step 5).
cudaError_t mlp_bwd(const bf16* in, const bf16* dy, const bf16* w1, const bf16* b1,
                    const bf16* w2, float* dw1, float* db1, float* dw2, float* db2, bf16* din,
                    bf16* ws, float* fws, const Layout& L, int m, int k, int hidden,
                    cudaStream_t s) {
  bf16 *pre = ws + L.pre, *hh = ws + L.hh;
  float *part = fws + L.part, *part_b = fws + L.part_b;
  const bf16* none = nullptr;
  DTC_TRY(dtc::dense<dtc::GELU2>(in, w1, b1, none, hh, m, hidden, k, s, pre));
  DTC_TRY(dtc::weight_grad(dy, (const bf16*)hh, m, k, hidden, part, part_b, dw2, db2, s));
  DTC_TRY(dtc::input_grad<dtc::DGELU>(dy, w2, (const bf16*)pre, pre, m, hidden, k, s));
  DTC_TRY(dtc::weight_grad((const bf16*)pre, in, m, hidden, k, part, part_b, dw1, db1, s));
  return dtc::input_grad<dtc::NONE>((const bf16*)pre, w1, none, din, m, k, hidden, s);
}

cudaError_t ln_mlp_res_bwd(const bf16* x, const bf16* dy, bf16* dx, const void* const* w,
                           void* const* dw, bf16* ws, float* fws, int m, int k, int hidden,
                           cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto DW = [&](int i) { return static_cast<float*>(dw[i]); };
  const Layout L = make_layout(m, k, hidden, true);
  bf16* n1 = ws + L.n1;
  float *mean = fws + L.mean, *rstd = fws + L.rstd, *part = fws + L.part;
  // recompute n1 = LN(x) with its row statistics; the MLP's backward to
  // dn1, written over n1
  DTC_TRY(dtc::layer_norm<bf16>(x, F(P_LN_G), F(P_LN_B), n1, m, k, s, mean, rstd));
  DTC_TRY(mlp_bwd(n1, dy, W(P_W1), W(P_B1), W(P_W2), DW(D_W1), DW(D_B1), DW(D_W2), DW(D_B2),
                  n1, ws, fws, L, m, k, hidden, s));
  // LayerNorm: dx, dgamma, dbeta
  return dtc::ln_backward<bf16>(n1, x, mean, rstd, F(P_LN_G), (const bf16*)nullptr, dx,
                                DW(D_LN_G), DW(D_LN_B), part, m, k, s);
}

}  // namespace

// What a backward needs before its launch: the elements of its bf16 and
// fp32 workspaces at (m, k, hidden), with (ln = 1, K3b) or without (K3a)
// the LayerNorm.
extern "C" int mm_fused_mlp_bwd_workspace(int m, int k, int hidden, int ln,
                                          long long* t_elems, long long* f_elems) {
  const Layout L = make_layout(m, k, hidden, ln != 0);
  *t_elems = (long long)L.t_total;
  *f_elems = (long long)L.f_total;
  return 0;
}

// x, dy (M, K) bf16 -> dx (M, K) bf16 and the four fp32 parameter
// gradients in dw (dW1, db1, dW2, db2); w = {w1, b1, w2} bf16.
extern "C" int mm_fused_mlp_bwd_bf16(const void* x, const void* dy, void* dx,
                                     const void* const* w, void* const* dw, void* ws, void* fws,
                                     int m, int k, int hidden, void* stream) {
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto DW = [&](int i) { return static_cast<float*>(dw[i]); };
  return static_cast<int>(mlp_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), W(0), W(1), W(2), DW(0),
      DW(1), DW(2), DW(3), static_cast<bf16*>(dx), static_cast<bf16*>(ws),
      static_cast<float*>(fws), make_layout(m, k, hidden, false), m, k, hidden,
      static_cast<cudaStream_t>(stream)));
}

// x, dy (M, K) bf16 -> dx (M, K) bf16 and the six fp32 parameter gradients
// (dgamma, dbeta, dW1, db1, dW2, db2).
extern "C" int mm_fused_ln_mlp_res_bwd_bf16(const void* x, const void* dy, void* dx,
                                            const void* const* w, void* const* dw,
                                            void* ws, void* fws, int m, int k, int hidden,
                                            void* stream) {
  return static_cast<int>(ln_mlp_res_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<bf16*>(dx), w, dw,
      static_cast<bf16*>(ws), static_cast<float*>(fws), m, k, hidden,
      static_cast<cudaStream_t>(stream)));
}
