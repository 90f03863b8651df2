// fused_ln_mlp_res backward (K3b bwd): gradients of
// y = res + fc2(GELU(fc1(LN(x)))) with respect to x, the LayerNorm's gamma
// and beta, and fc1's and fc2's weights and biases. The residual's
// gradient is dy itself (the caller passes it through, as the TPU
// kernel's VJP returns it, fused_mlp_pallas.py:346).
//
// Replaces: multimae_tpu/ops/fused_mlp_pallas.py `fused_ln_mlp_res`
// backward (`_lmr_bwd`, Pallas program `_lmr_bwd_kernel`).
//
// What it computes, rounding where `_lmr_bwd_kernel` rounds (:235-264):
// LayerNorm and fc1 recomputed as the TPU kernel does (its row statistics
// kept), then
//   dW2 = dy^T . h, db2 = colsum(dy)                       fp32
//   dpre = bf16(bf16(dy . W2) * GELU'(pre))                 the GELU backward
//   dW1 = dpre^T . n1, db1 = colsum(dpre)                   fp32
//   dn1 = bf16(dpre . W1)
//   dx = bf16(LayerNorm backward of dn1), dgamma, dbeta     fp32
// (torch layout: W1 (H, K), W2 (K, H), and dW in the same layout).
//
// What bounds it on the H100: at the 512-px ConvNeXt head (M = 65,536
// rows, K = 384, hidden 1536) the recomputed fc1 and the four backward
// GEMMs are 10*M*K*H = 386.6 GFLOP (391 us at the bf16 peak): tensor-core
// bound. Its recompute and backward slabs ((M, 1536) bf16 are 201 MB
// each) move ~1.5 GB (~0.45 ms at 3.35 TB/s) in this design.
//
// Design: on the TPU dW is accumulated across the in-order grid. Here the
// pieces of the K1 backward are reused (backward.cuh): the dX GEMMs run
// common.cuh's Y = X . W^T tiles on weights transposed once per call; the
// GELU backward rides in the epilogue of the dh GEMM, written in place
// over the pre-activation; dW, db, dgamma and dbeta are fixed-order slice
// sums over the 65,536 rows (64 slices of 1024 rows), fp32 and bit-equal
// from run to run, no atomics. The recompute's (M, H) pre-activation and
// GELU output live in a workspace the wrapper allocates after asking
// mm_fused_ln_mlp_res_bwd_workspace for its size. Keeping the hidden strip
// on chip, as the TPU kernel does in VMEM, is later work.

#include "backward.cuh"

namespace {

// Pointers in the wrapper's order (ops/fused_mlp.py): LayerNorm gamma and
// beta (K,) fp32, w1 (H, K), b1 (H,), w2 (K, H) bf16.
enum { P_LN_G, P_LN_B, P_W1, P_B1, P_W2 };
// Gradients in the wrapper's order, all fp32.
enum { D_LN_G, D_LN_B, D_W1, D_B1, D_W2, D_B2 };

// Offsets (elements) into the bf16 workspace `ws` and the fp32 workspace
// `fws`, each buffer on a 64-element boundary.
struct Layout {
  size_t n1, pre, hh, dn, w1t, w2t, t_total;
  size_t mean, rstd, part, f_total;
};

size_t take(size_t& n, size_t elems) {
  const size_t o = n;
  n += (elems + 63) & ~(size_t)63;
  return o;
}

Layout make_layout(int m, int k, int hidden) {
  Layout L{};
  const size_t M = m, K = k, H = hidden;
  size_t t = 0, f = 0;
  L.n1 = take(t, M * K);    // LN(x)
  L.pre = take(t, M * H);   // fc1 pre-activation, then dpre in place
  L.hh = take(t, M * H);    // GELU(pre)
  L.dn = take(t, M * K);    // dn1
  L.w1t = take(t, K * H);
  L.w2t = take(t, H * K);
  L.t_total = t;
  L.mean = take(f, M);
  L.rstd = take(f, M);
  L.part = take(f, (size_t)num_slices(m) * K * H);  // the widest reduction: dW
  L.f_total = f;
  return L;
}

cudaError_t ln_mlp_res_bwd(const bf16* x, const bf16* dy, bf16* dx, const void* const* w,
                           void* const* dw, bf16* ws, float* fws, int m, int k, int hidden,
                           cudaStream_t s) {
  using T = bf16;
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  auto DW = [&](int i) { return static_cast<float*>(dw[i]); };
  const Layout L = make_layout(m, k, hidden);
  T *n1 = ws + L.n1, *pre = ws + L.pre, *hh = ws + L.hh, *dn = ws + L.dn;
  T *w1t = ws + L.w1t, *w2t = ws + L.w2t;
  float *mean = fws + L.mean, *rstd = fws + L.rstd, *part = fws + L.part;

  MM_TRY(transpose<T>(W(P_W1), w1t, hidden, k, s));  // (K, H)
  MM_TRY(transpose<T>(W(P_W2), w2t, k, hidden, s));  // (H, K)
  // recompute: n1 = LN(x) with its row statistics, pre = fc1(n1), h = GELU(pre)
  MM_TRY(layer_norm<T>(x, F(P_LN_G), F(P_LN_B), n1, m, k, s, mean, rstd));
  MM_TRY(gemm<EPI_BIAS>(n1, W(P_W1), W(P_B1), (const T*)nullptr, pre, m, hidden, k, s));
  MM_TRY(gelu<T>(pre, hh, (size_t)m * hidden, s));
  // fc2: dW2 = dy^T . h, db2; dpre = bf16(bf16(dy . W2) * GELU'(pre)) over pre
  MM_TRY(weight_grad(dy, hh, m, k, hidden, part, DW(D_W2), s));
  MM_TRY(bias_grad<T>(dy, m, k, part, DW(D_B2), s));
  MM_TRY(gemm<EPI_DGELU>(dy, w2t, (const T*)nullptr, pre, pre, m, hidden, k, s));
  // fc1: dW1 = dpre^T . n1, db1; dn1 = dpre . W1
  MM_TRY(weight_grad(pre, n1, m, hidden, k, part, DW(D_W1), s));
  MM_TRY(bias_grad<T>(pre, m, hidden, part, DW(D_B1), s));
  MM_TRY(gemm<EPI_NONE>(pre, w1t, (const T*)nullptr, (const T*)nullptr, dn, m, k, hidden, s));
  // LayerNorm: dx, dgamma, dbeta
  return ln_backward<T>(dn, x, mean, rstd, F(P_LN_G), (const T*)nullptr, dx, DW(D_LN_G),
                        DW(D_LN_B), part, m, k, s);
}

}  // namespace

// What the backward needs before its launch: the elements of its bf16 and
// fp32 workspaces at (m, k, hidden).
extern "C" int mm_fused_ln_mlp_res_bwd_workspace(int m, int k, int hidden,
                                                 long long* t_elems, long long* f_elems) {
  const Layout L = make_layout(m, k, hidden);
  *t_elems = (long long)L.t_total;
  *f_elems = (long long)L.f_total;
  return 0;
}

// x, dy (M, K) bf16 -> dx (M, K) bf16 and the six fp32 parameter gradients
// (dgamma, dbeta, dW1, db1, dW2, db2).
extern "C" int mm_fused_ln_mlp_res_bwd_bf16(const void* x, const void* dy, void* dx,
                                            const void* const* w, void* const* dw,
                                            void* ws, void* fws, int m, int k, int hidden,
                                            void* stream) {
  return static_cast<int>(ln_mlp_res_bwd(
      static_cast<const mm::bf16*>(x), static_cast<const mm::bf16*>(dy),
      static_cast<mm::bf16*>(dx), w, dw, static_cast<mm::bf16*>(ws),
      static_cast<float*>(fws), m, k, hidden, static_cast<cudaStream_t>(stream)));
}
