// fused_decoder_bwd (K1 backward): gradients of the SpatialOutputAdapter
// decoder body with respect to its queries, its context and its 28
// weight tensors.
//
// Replaces: multimae_tpu/ops/fused_decoder_pallas.py `fused_decoder_core`
// backward (`_fused_bwd` -> `_bwd_call`, Pallas program `_bwd_kernel`,
// math `_core_bwd`, helpers `_ln_bwd`, `_dense_bwd`, `_gelu_bwd`,
// `_attend_bwd_2d`).
//
// What it computes: a recompute backward, as the TPU kernel does. The
// forward chain of fused_decoder_fwd.cu runs again and keeps the
// activations `_core_fwd(save=...)` records (LayerNorm inputs and their
// row statistics, GEMM inputs, GELU pre-activations, attention q/k/v) in a
// workspace the wrapper allocates; then the blocks are walked in reverse,
// then the cross-attention MLP, the cross-attention and both input
// LayerNorms. Roundings follow `_core_bwd`: every dX GEMM is rounded to
// the compute dtype, dW and db are fp32 sums, the LayerNorm backward is
// fp32 and the residual gradient is rounded only after the fp32 sum
// g + dx; attention recomputes fp32 probabilities, takes
// delta = sum dP * P from them and rounds dS to the compute dtype.
//
// What bounds it on the H100: at the pretraining shape (B=128, 196 queries,
// 99 context tokens, D=256, 8 heads of 32, hidden 1024, depth 2) the
// recompute plus the backward are ~3x the forward's ~125 GFLOP (0.38 ms at
// the bf16 tensor-core peak), and the saved activations are ~0.4 G
// elements (0.8 GB in bf16) written once and read once or twice (~0.5 ms
// at 3.35 TB/s): in bf16 memory traffic and the many short launches bound
// it; the fp32 (semseg) variant runs true fp32 FMA (no TF32) and is bound
// by the 67 TFLOP/s fp32 rate (~5.7 ms).
//
// Design, on K1's tiles (decoder_tc.cuh), and what it does about the card:
//  * bf16 GEMMs on wgmma with fused epilogues. The forward recompute's fc1
//    writes the pre-activation and its GELU in one epilogue. dX = G . W
//    (the NN form) reads W as it lies, through a transposed operand tile,
//    so no weight is transposed; the GELU backward rides in the epilogue
//    of the fc2 dX GEMM. fp32 GEMMs: register-blocked FMA, same forms.
//  * dW = G^T . X (the TN form) reduces over M = B*Nq = 25,088 rows into
//    outputs as small as 256 x 256. The TPU accumulated across its
//    sequential grid; here M is cut into fixed slices, each (slice, output
//    tile) block writes fp32 partial sums, and a second pass adds the
//    slices in a fixed order; the same blocks sum G's columns for db in
//    the same pass over G. LayerNorm dgamma/dbeta are summed over 128-row
//    slices. No atomics: the result is bit-identical from run to run.
//  * Attention backward in two launches (decoder_tc.cuh): a row pass (dQ
//    and each query row's max, sum and delta) and a key pass (dK, dV
//    summed over the query rows in order); bf16 on mma.sync, fp32 on
//    register-tiled FMA.
//  * LayerNorm backward: one warp per row, fp32, with the residual add
//    and the final rounding fused; the first one reads the incoming
//    gradient in place (no copy).
// Keeping a sample's rows on chip across the chain, as the TPU kernel does
// in VMEM, is later work.

#include "decoder_tc.cuh"

namespace {

using namespace mm;

// ------------------------------------------------------------------ gate

// The shared memory of the warp-per-row attention backward this file held
// before the tensor-core and register-tiled kernels of decoder_tc.cuh: fp32
// dK and dV accumulators, a 32-row tile's P and dS and its Q and dO rows,
// then K and V rows padded to dh + 2. The wrapper's gate keeps it (see
// mm_fused_decoder_bwd_workspace).
template <typename T>
inline size_t attention_bwd_smem_bytes(int nk, int dh) {
  return 4 * (2 * (size_t)nk * dh + 2 * (size_t)32 * nk + 2 * (size_t)32 * dh) +
         2 * (size_t)nk * (dh + 2) * sizeof(T);
}

// ------------------------------------------------------------ the workspace

// Offsets (in elements) into the compute-dtype workspace `ws` and the
// fp32 workspace `fws`; every buffer starts on a 64-element boundary.
struct Layout {
  // saved forward activations: cross-attention region
  size_t qn, cn, xq, kv, att, xattn, on, xhpre, xh;
  // per block i at blk + i * blk_stride: LN1 input, LN1 output, qkv,
  // attention output, the mid residual, LN2 output, fc1 pre-activation, GELU
  size_t blk, blk_stride, b_in, b_n1, b_qkv, b_a, b_mid, b_n2, b_hpre, b_h;
  // backward temporaries
  size_t g, dh, dn, da, dqkv, dkv, dcn;
  size_t t_total;
  // fp32: LayerNorm row statistics (mean, rstd), the partial sums of dW
  // and of db or dgamma/dbeta, and the attention row statistics
  size_t st_q, st_c, st_on, st_blk, part, part_b, astat, f_total;
};

struct Carver {
  size_t n = 0;
  size_t take(size_t k) {
    const size_t o = n;
    n += (k + 63) & ~(size_t)63;
    return o;
  }
};

Layout make_layout(int batch, int nq, int nc, int d, int heads, int hidden, int depth) {
  Layout L{};
  const size_t mq = (size_t)batch * nq, mc = (size_t)batch * nc;
  const size_t D = d, H = hidden;
  Carver t;
  L.qn = t.take(mq * D);
  L.cn = t.take(mc * D);
  L.xq = t.take(mq * D);
  L.kv = t.take(mc * 2 * D);
  L.att = t.take(mq * D);
  L.xattn = t.take(mq * D);
  L.on = t.take(mq * D);
  L.xhpre = t.take(mq * H);
  L.xh = t.take(mq * H);
  Carver b;
  L.b_in = b.take(mq * D);
  L.b_n1 = b.take(mq * D);
  L.b_qkv = b.take(mq * 3 * D);
  L.b_a = b.take(mq * D);
  L.b_mid = b.take(mq * D);
  L.b_n2 = b.take(mq * D);
  L.b_hpre = b.take(mq * H);
  L.b_h = b.take(mq * H);
  L.blk_stride = b.n;
  L.blk = t.take(L.blk_stride * depth);
  L.g = t.take(mq * D);
  L.dh = t.take(mq * H);
  L.dn = t.take(mq * D);
  L.da = t.take(mq * D);
  L.dqkv = t.take(mq * 3 * D);
  L.dkv = t.take(mc * 2 * D);
  L.dcn = t.take(mc * D);
  L.t_total = t.n;

  Carver f;
  L.st_q = f.take(2 * mq);
  L.st_c = f.take(2 * mc);
  L.st_on = f.take(2 * mq);
  L.st_blk = f.take(4 * mq * depth);  // per block: mean1, rstd1, mean2, rstd2
  // The chain's TN products (rows, Mo, Ni) and the LayerNorm slices.
  const int tn[5][3] = {{(int)mq, d, hidden}, {(int)mq, hidden, d}, {(int)mq, d, d},
                        {(int)mq, 3 * d, d}, {(int)mc, 2 * d, d}};
  const size_t rows = mq > mc ? mq : mc;
  size_t part = (size_t)dtc::ln_slices((int)rows) * 2 * D, part_b = 0;
  for (const auto& x : tn) {
    const size_t S = dtc::tn_slices(x[0], x[1], x[2]);
    part = part > S * x[1] * x[2] ? part : S * x[1] * x[2];
    part_b = part_b > S * x[1] ? part_b : S * x[1];
  }
  L.part = f.take(part);
  L.part_b = f.take(part_b);
  L.astat = f.take(dtc::attention_bwd_stats(batch, heads, nq));
  L.f_total = f.n;
  return L;
}

// ---------------------------------------------------------------- the chain

template <typename T>
cudaError_t decoder_bwd(const T* q, const T* c, const T* gout, T* dq, T* dc,
                        const void* const* w, void* const* dw, T* ws, float* fws,
                        int batch, int nq, int nc, int d, int heads, int hidden,
                        int depth, cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  auto DW = [&](int i) { return static_cast<float*>(dw[i]); };
  const Layout L = make_layout(batch, nq, nc, d, heads, hidden, depth);
  const int mq = batch * nq, mc = batch * nc, dh = d / heads, H = hidden;
  const size_t D = d;
  const T* none = nullptr;
  float *part = fws + L.part, *part_b = fws + L.part_b, *astat = fws + L.astat;
  T *qn = ws + L.qn, *cn = ws + L.cn, *xq = ws + L.xq, *kv = ws + L.kv;
  T *att = ws + L.att, *xattn = ws + L.xattn, *on = ws + L.on;
  T *xhpre = ws + L.xhpre, *xh = ws + L.xh;
  T *g = ws + L.g, *dhid = ws + L.dh, *dn = ws + L.dn, *da = ws + L.da;
  T *dqkv = ws + L.dqkv, *dkv = ws + L.dkv, *dcn = ws + L.dcn;
  auto blk = [&](int i, size_t off) { return ws + L.blk + i * L.blk_stride + off; };
  float *mean_q = fws + L.st_q, *rstd_q = mean_q + mq;
  float *mean_c = fws + L.st_c, *rstd_c = mean_c + mc;
  float *mean_on = fws + L.st_on, *rstd_on = mean_on + mq;
  auto stat = [&](int i, int k) { return fws + L.st_blk + ((size_t)4 * i + k) * mq; };

  // ---- forward recompute (fused_decoder_fwd.cu's chain, keeping activations)
  DTC_TRY(dtc::layer_norm<T>(q, F(QN_G), F(QN_B), qn, mq, d, s, mean_q, rstd_q));
  DTC_TRY(dtc::layer_norm<T>(c, F(CN_G), F(CN_B), cn, mc, d, s, mean_c, rstd_c));
  DTC_TRY(dtc::dense<dtc::BIAS>(qn, W(WQ), W(BQ), none, xq, mq, d, d, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(cn, W(WKV), W(BKV), none, kv, mc, 2 * d, d, s));
  DTC_TRY(dtc::attention_fwd(xq, d, kv, kv + d, 2 * d, att, d, batch, heads, nq, nc, dh, s));
  DTC_TRY(dtc::dense<dtc::BIAS>(att, W(WXP), W(BXP), none, xattn, mq, d, d, s));
  DTC_TRY(dtc::layer_norm<T>(xattn, F(ON_G), F(ON_B), on, mq, d, s, mean_on, rstd_on));
  DTC_TRY(dtc::dense<dtc::GELU2>(on, W(W1), W(B1), none, xh, mq, H, d, s, xhpre));
  if (depth > 0)
    DTC_TRY(dtc::dense<dtc::RES>(xh, W(W2), W(B2), xattn, blk(0, L.b_in), mq, d, H, s));
  for (int i = 0; i < depth; ++i) {
    T *in = blk(i, L.b_in), *n1 = blk(i, L.b_n1), *qkv = blk(i, L.b_qkv);
    T *a = blk(i, L.b_a), *mid = blk(i, L.b_mid), *n2 = blk(i, L.b_n2);
    T *hpre = blk(i, L.b_hpre), *hh = blk(i, L.b_h);
    DTC_TRY(dtc::layer_norm<T>(in, F(N1_G) + i * D, F(N1_B) + i * D, n1, mq, d, s,
                         stat(i, 0), stat(i, 1)));
    DTC_TRY(dtc::dense<dtc::BIAS>(n1, W(WQKV) + i * 3 * D * D, W(BQKV) + i * 3 * D, none, qkv,
                                 mq, 3 * d, d, s));
    DTC_TRY(dtc::attention_fwd(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, a, d, batch, heads, nq,
                              nq, dh, s));
    DTC_TRY(dtc::dense<dtc::RES>(a, W(WP) + i * D * D, W(BP) + i * D, in, mid, mq, d, d, s));
    DTC_TRY(dtc::layer_norm<T>(mid, F(N2_G) + i * D, F(N2_B) + i * D, n2, mq, d, s,
                         stat(i, 2), stat(i, 3)));
    DTC_TRY(dtc::dense<dtc::GELU2>(n2, W(WF1) + i * H * D, W(BF1) + (size_t)i * H, none, hh, mq,
                                  H, d, s, hpre));
    if (i + 1 < depth)
      DTC_TRY(dtc::dense<dtc::RES>(hh, W(WF2) + i * D * H, W(BF2) + i * D, mid,
                                  blk(i + 1, L.b_in), mq, d, H, s));
  }

  // ---- backward (fused_decoder_pallas._core_bwd). The gradient of the
  // output is read in place until the first residual writes g.
  const T* gc = gout;
  for (int i = depth - 1; i >= 0; --i) {
    T *in = blk(i, L.b_in), *n1 = blk(i, L.b_n1), *qkv = blk(i, L.b_qkv);
    T *a = blk(i, L.b_a), *mid = blk(i, L.b_mid), *n2 = blk(i, L.b_n2);
    T *hpre = blk(i, L.b_hpre), *hh = blk(i, L.b_h);
    // x_out = mid + fc2(gelu(fc1(LN2(mid))))
    DTC_TRY(dtc::input_grad<dtc::DGELU>(gc, W(WF2) + i * D * H, hpre, dhid, mq, H, d, s));
    DTC_TRY(dtc::weight_grad(gc, hh, mq, d, H, part, part_b, DW(WF2) + i * D * H,
                            DW(BF2) + i * D, s));
    DTC_TRY(dtc::input_grad<dtc::NONE>(dhid, W(WF1) + i * H * D, none, dn, mq, d, H, s));
    DTC_TRY(dtc::weight_grad(dhid, n2, mq, H, d, part, part_b, DW(WF1) + i * H * D,
                            DW(BF1) + (size_t)i * H, s));
    DTC_TRY(dtc::ln_backward<T>(dn, mid, stat(i, 2), stat(i, 3), F(N2_G) + i * D, gc, g,
                          DW(N2_G) + i * D, DW(N2_B) + i * D, part, mq, d, s));
    gc = g;
    // mid = in + proj(attn(qkv(LN1(in))))
    DTC_TRY(dtc::input_grad<dtc::NONE>(g, W(WP) + i * D * D, none, da, mq, d, d, s));
    DTC_TRY(dtc::weight_grad(g, a, mq, d, d, part, part_b, DW(WP) + i * D * D, DW(BP) + i * D,
                            s));
    DTC_TRY(dtc::attention_bwd(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, da, d, dqkv, 3 * d,
                              dqkv + d, dqkv + 2 * d, 3 * d, astat, batch, heads, nq, nq, dh, s));
    DTC_TRY(dtc::input_grad<dtc::NONE>(dqkv, W(WQKV) + i * 3 * D * D, none, dn, mq, d, 3 * d,
                                      s));
    DTC_TRY(dtc::weight_grad(dqkv, n1, mq, 3 * d, d, part, part_b, DW(WQKV) + i * 3 * D * D,
                            DW(BQKV) + i * 3 * D, s));
    DTC_TRY(dtc::ln_backward<T>(dn, in, stat(i, 0), stat(i, 1), F(N1_G) + i * D, g, g,
                          DW(N1_G) + i * D, DW(N1_B) + i * D, part, mq, d, s));
  }

  // cross-attention MLP: x = x_attn + fc2(gelu(fc1(out_norm(x_attn))))
  DTC_TRY(dtc::input_grad<dtc::DGELU>(gc, W(W2), xhpre, dhid, mq, H, d, s));
  DTC_TRY(dtc::weight_grad(gc, xh, mq, d, H, part, part_b, DW(W2), DW(B2), s));
  DTC_TRY(dtc::input_grad<dtc::NONE>(dhid, W(W1), none, dn, mq, d, H, s));
  DTC_TRY(dtc::weight_grad(dhid, on, mq, H, d, part, part_b, DW(W1), DW(B1), s));
  DTC_TRY(dtc::ln_backward<T>(dn, xattn, mean_on, rstd_on, F(ON_G), gc, g, DW(ON_G), DW(ON_B),
                        part, mq, d, s));

  // x_attn = proj(cross-attention(q(LN q), kv(LN c)))
  DTC_TRY(dtc::input_grad<dtc::NONE>(g, W(WXP), none, da, mq, d, d, s));
  DTC_TRY(dtc::weight_grad(g, att, mq, d, d, part, part_b, DW(WXP), DW(BXP), s));
  T* dqa = dqkv;  // (mq, d): dqkv is free here
  DTC_TRY(dtc::attention_bwd(xq, d, kv, kv + d, 2 * d, da, d, dqa, d, dkv, dkv + d, 2 * d,
                            astat, batch, heads, nq, nc, dh, s));
  DTC_TRY(dtc::input_grad<dtc::NONE>(dqa, W(WQ), none, dn, mq, d, d, s));
  DTC_TRY(dtc::weight_grad(dqa, qn, mq, d, d, part, part_b, DW(WQ), DW(BQ), s));
  DTC_TRY(dtc::input_grad<dtc::NONE>(dkv, W(WKV), none, dcn, mc, d, 2 * d, s));
  DTC_TRY(dtc::weight_grad(dkv, cn, mc, 2 * d, d, part, part_b, DW(WKV), DW(BKV), s));
  DTC_TRY(dtc::ln_backward<T>(dn, q, mean_q, rstd_q, F(QN_G), none, dq, DW(QN_G), DW(QN_B), part,
                        mq, d, s));
  return dtc::ln_backward<T>(dcn, c, mean_c, rstd_c, F(CN_G), none, dc, DW(CN_G), DW(CN_B), part,
                        mc, d, s);
}

}  // namespace

// What the backward needs before its launch: the elements of the
// compute-dtype and fp32 workspaces, and the shared-memory figure the
// caller holds against the card's limit (f32 != 0: fp32, else bf16): the
// fp32 attention kernel's over the longer of the two key sets, and the
// same formula at bf16 sizes for bf16, the gate the backward has always
// had (the bf16 tensor-core kernels need less at every shape it admits:
// 72 KB at 346 keys of width 32, 92 KB at 209 of width 64).
extern "C" int mm_fused_decoder_bwd_workspace(int batch, int nq, int nc, int d, int heads,
                                              int hidden, int depth, int f32,
                                              long long* t_elems, long long* f_elems,
                                              long long* attn_smem) {
  const Layout L = make_layout(batch, nq, nc, d, heads, hidden, depth);
  *t_elems = (long long)L.t_total;
  *f_elems = (long long)L.f_total;
  const int nk = nq > nc ? nq : nc, dh = d / heads;
  *attn_smem = (long long)(f32 ? attention_bwd_smem_bytes<float>(nk, dh)
                               : attention_bwd_smem_bytes<mm::bf16>(nk, dh));
  return 0;
}

#define MM_DECODER_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* q, const void* c, const void* g, void* dq, void* dc, \
                      const void* const* w, void* const* dw, void* ws, void* fws,     \
                      int batch, int nq, int nc, int d, int heads, int hidden,        \
                      int depth, void* stream) {                                      \
    return static_cast<int>(decoder_bwd<T>(                                           \
        static_cast<const T*>(q), static_cast<const T*>(c), static_cast<const T*>(g), \
        static_cast<T*>(dq), static_cast<T*>(dc), w, dw, static_cast<T*>(ws),         \
        static_cast<float*>(fws), batch, nq, nc, d, heads, hidden, depth,             \
        static_cast<cudaStream_t>(stream)));                                          \
  }

MM_DECODER_BWD_ENTRY(mm_fused_decoder_bwd_bf16, mm::bf16)
MM_DECODER_BWD_ENTRY(mm_fused_decoder_bwd_f32, float)
