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
// g + dx; attention recomputes fp32 probabilities and rounds dS to the
// compute dtype.
//
// What bounds it on the H100: at the pretraining shape (B=128, 196 queries,
// 99 context tokens, D=256, 8 heads of 32, hidden 1024, depth 2) the
// recompute plus the backward are ~3x the forward's ~125 GFLOP, and the
// saved activations are ~0.4 G elements (0.8 GB in bf16) written once
// and read once or twice: ~3 ms of HBM traffic at 3.35 TB/s against
// ~0.4 ms of bf16 tensor-core work at peak, so in bf16 the simple design
// below is bound by memory traffic and by its mma.sync tiles' low share of
// peak; the fp32 (semseg) variant runs true fp32 FMA (no TF32) and is
// bound by the 67 TFLOP/s fp32 rate.
//
// Design, and what it does about the card:
//  * dX = G . W (the NN form) reuses common.cuh's Y = X . W^T GEMM on
//    weights transposed once per call into the workspace (weights are
//    small: ~3 MB in bf16 per decoder). The GELU backward rides in the
//    epilogue of the fc2 dX GEMM.
//  * dW = G^T . X (the TN form) reduces over M = B*Nq = 25,088 rows into
//    outputs as small as 256 x 256. The TPU accumulated across its
//    sequential grid; here M is cut into fixed slices of SLICE rows, each
//    (slice, 64x64 output tile) is one block writing fp32 partial sums,
//    and a second pass adds the slices in a fixed order. db and the
//    LayerNorm dgamma/dbeta column sums are split the same way. No
//    atomics: the result is bit-identical from run to run.
//  * Attention backward: one block per (sample, head) holds that head's
//    K and V rows and fp32 dK/dV accumulators in shared memory; a warp
//    takes one query row at a time, recomputes its probabilities, writes
//    dQ, and leaves P and dS of a 32-row tile in shared memory, from
//    which every thread adds its own (key, column) elements of dK and dV
//    in row order: no cross-block sums, a fixed summation order.
//  * LayerNorm backward: one warp per row, fp32, with the residual add
//    and the final rounding fused.
// A faster design (wgmma/TMA tiles, keeping a sample's rows on chip
// across the chain as the TPU kernel does in VMEM) is later work.

#include "backward.cuh"

namespace {

using namespace mm;

// ------------------------------------------------------- attention backward

constexpr int AB_WARPS = 8;
constexpr int AB_QT = 32;  // query rows per tile

// Shared memory: fp32 dK and dV accumulators (nk x dh each), the tile's
// rounded P and dS (AB_QT x nk each), its Q and dO rows in fp32
// (AB_QT x dh each), then K and V rows in the compute dtype padded to dh+2.
template <typename T>
inline size_t attention_bwd_smem_bytes(int nk, int dh) {
  return 4 * (2 * (size_t)nk * dh + 2 * (size_t)AB_QT * nk + 2 * (size_t)AB_QT * dh) +
         2 * (size_t)nk * (dh + 2) * sizeof(T);
}

// One block per (head, sample). Q rows at Q + (b*nq + i)*ldq + h*DH, K/V
// rows at Kp/Vp + (b*nk + j)*ldkv + h*DH, dO like Q with ldo; dQ written
// like Q with lddq, dK/dV like K/V with lddkv (fused_decoder_pallas.
// _attend_bwd_2d):
//   P = softmax(Q K^T * scale) in fp32, dV = T(P)^T dO,
//   dP = dO V^T, dS = T(P * (dP - rowsum(dP * P)) * scale),
//   dQ = dS K, dK = dS^T Q, each product summed in fp32 and rounded to T.
template <typename T, int DH>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_kernel(const T* __restrict__ Q, int ldq, const T* __restrict__ Kp,
                     const T* __restrict__ Vp, int ldkv, const T* __restrict__ dO,
                     int ldo, T* __restrict__ dQ, int lddq, T* __restrict__ dK,
                     T* __restrict__ dV, int lddkv, int nq, int nk, float scale) {
  constexpr int KST = DH + 2;
  constexpr int DPL = DH / 32;  // dQ columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sDK = reinterpret_cast<float*>(smem_raw);
  float* sDV = sDK + nk * DH;
  float* sP = sDV + nk * DH;
  float* sDS = sP + AB_QT * nk;
  float* sQ = sDS + AB_QT * nk;
  float* sDO = sQ + AB_QT * DH;
  T* sK = reinterpret_cast<T*>(sDO + AB_QT * DH);
  T* sV = sK + (size_t)nk * KST;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < nk * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const size_t off = (size_t)(b * nk + j) * ldkv + h * DH + d;
    sK[j * KST + d] = Kp[off];
    sV[j * KST + d] = Vp[off];
    sDK[idx] = 0.f;
    sDV[idx] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += AB_QT) {
    const int rows = min(AB_QT, nq - q0);
    for (int idx = threadIdx.x; idx < AB_QT * DH; idx += blockDim.x) {
      const int r = idx / DH, d = idx % DH;
      const bool ok = r < rows;
      const size_t row = (size_t)(b * nq + q0 + r);
      sQ[idx] = ok ? to_f(Q[row * ldq + h * DH + d]) : 0.f;
      sDO[idx] = ok ? to_f(dO[row * ldo + h * DH + d]) : 0.f;
    }
    __syncthreads();  // also orders the K/V loads before the first tile

    for (int r = warp; r < rows; r += AB_WARPS) {
      const float* qr = sQ + r * DH;
      const float* dor = sDO + r * DH;
      float* p = sP + r * nk;
      float* ds = sDS + r * nk;
      // Lanes own keys: logits and dP, then the fp32 softmax.
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) {
        const T* kr = sK + j * KST;
        const T* vr = sV + j * KST;
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 2) {
          const float2 k2 = load_pair(kr + d), v2 = load_pair(vr + d);
          sc = fmaf(qr[d], k2.x, sc);
          sc = fmaf(qr[d + 1], k2.y, sc);
          dp = fmaf(dor[d], v2.x, dp);
          dp = fmaf(dor[d + 1], v2.y, dp);
        }
        sc *= scale;
        p[j] = sc;
        ds[j] = dp;
        mx = fmaxf(mx, sc);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(p[j] - mx);
        p[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float delta = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float pj = p[j] / sum;
        p[j] = pj;
        delta += ds[j] * pj;
      }
      delta = warp_sum(delta);
      for (int j = lane; j < nk; j += 32) {
        const float pj = p[j];
        ds[j] = rnd<T>(pj * (ds[j] - delta) * scale);
        p[j] = rnd<T>(pj);
      }
      __syncwarp();
      // dQ row: lanes own columns.
      float acc[DPL];
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[u] = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float dsj = ds[j];
        const T* kr = sK + j * KST + lane;
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[u] = fmaf(dsj, to_f(kr[32 * u]), acc[u]);
      }
      T* out = dQ + (size_t)(b * nq + q0 + r) * lddq + h * DH + lane;
#pragma unroll
      for (int u = 0; u < DPL; ++u) out[32 * u] = from_f<T>(acc[u]);
    }
    __syncthreads();

    // dK += dS^T Q, dV += P^T dO over the tile's rows, in row order.
    for (int idx = threadIdx.x; idx < nk * DH; idx += blockDim.x) {
      const int j = idx / DH, d = idx % DH;
      float ak = sDK[idx], av = sDV[idx];
      for (int r = 0; r < rows; ++r) {
        ak = fmaf(sDS[r * nk + j], sQ[r * DH + d], ak);
        av = fmaf(sP[r * nk + j], sDO[r * DH + d], av);
      }
      sDK[idx] = ak;
      sDV[idx] = av;
    }
    __syncthreads();  // before the next tile overwrites P, dS, Q and dO
  }

  for (int idx = threadIdx.x; idx < nk * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const size_t off = (size_t)(b * nk + j) * lddkv + h * DH + d;
    dK[off] = from_f<T>(sDK[idx]);
    dV[off] = from_f<T>(sDV[idx]);
  }
}

template <typename T, int DH>
cudaError_t attention_bwd_dh(const T* Q, int ldq, const T* Kp, const T* Vp, int ldkv,
                             const T* dO, int ldo, T* dQ, int lddq, T* dK, T* dV,
                             int lddkv, int batch, int heads, int nq, int nk,
                             cudaStream_t s) {
  const size_t smem = attention_bwd_smem_bytes<T>(nk, DH);
  MM_TRY(cudaFuncSetAttribute(attention_bwd_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const float scale = (float)(1.0 / sqrt((double)DH));
  attention_bwd_kernel<T, DH><<<dim3(heads, batch), AB_WARPS * 32, smem, s>>>(
      Q, ldq, Kp, Vp, ldkv, dO, ldo, dQ, lddq, dK, dV, lddkv, nq, nk, scale);
  return cudaGetLastError();
}

// Head widths 32 and 64 (checked by the Python wrapper, with the shared
// memory the keys need).
template <typename T>
cudaError_t attention_bwd(const T* Q, int ldq, const T* Kp, const T* Vp, int ldkv,
                          const T* dO, int ldo, T* dQ, int lddq, T* dK, T* dV,
                          int lddkv, int batch, int heads, int nq, int nk, int dh,
                          cudaStream_t s) {
  switch (dh) {
    case 32: return attention_bwd_dh<T, 32>(Q, ldq, Kp, Vp, ldkv, dO, ldo, dQ, lddq, dK,
                                            dV, lddkv, batch, heads, nq, nk, s);
    case 64: return attention_bwd_dh<T, 64>(Q, ldq, Kp, Vp, ldkv, dO, ldo, dQ, lddq, dK,
                                            dV, lddkv, batch, heads, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
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
  // transposed weights, in DecoderField order of the matrices
  size_t wt[NUM_DECODER_FIELDS];
  size_t t_total;
  // fp32: LayerNorm row statistics (mean, rstd) and the partial sums
  size_t st_q, st_c, st_on, st_blk, part, f_total;
};

struct Carver {
  size_t n = 0;
  size_t take(size_t k) {
    const size_t o = n;
    n += (k + 63) & ~(size_t)63;
    return o;
  }
};

Layout make_layout(int batch, int nq, int nc, int d, int hidden, int depth) {
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
  const size_t dep = depth;
  const size_t sizes[NUM_DECODER_FIELDS] = {
      0, 0, 0, 0, 0, 0, D * D, 0, 2 * D * D, 0, D * D, 0, H * D, 0, D * H, 0,
      0, 0, dep * 3 * D * D, 0, dep * D * D, 0, 0, 0, dep * H * D, 0, dep * D * H, 0};
  for (int i = 0; i < NUM_DECODER_FIELDS; ++i) L.wt[i] = sizes[i] ? t.take(sizes[i]) : 0;
  L.t_total = t.n;

  Carver f;
  L.st_q = f.take(2 * mq);
  L.st_c = f.take(2 * mc);
  L.st_on = f.take(2 * mq);
  L.st_blk = f.take(4 * mq * dep);  // per block: mean1, rstd1, mean2, rstd2
  const size_t rows = mq > mc ? mq : mc;
  const size_t S = (rows + SLICE - 1) / SLICE;
  size_t widest = 3 * D * D > H * D ? 3 * D * D : H * D;
  L.part = f.take(S * widest);
  L.f_total = f.n;
  return L;
}

// ---------------------------------------------------------------- the chain

// dX (M, in) = G (M, out) . W, W (out, in), given Wt = W^T (in, out).
template <int EPI, typename T>
cudaError_t input_grad(const T* G, const T* Wt, const T* R, T* Y, int M, int n_in,
                       int n_out, cudaStream_t s) {
  return gemm<EPI>(G, Wt, (const T*)nullptr, R, Y, M, n_in, n_out, s);
}

template <typename T>
cudaError_t decoder_bwd(const T* q, const T* c, const T* gout, T* dq, T* dc,
                        const void* const* w, void* const* dw, T* ws, float* fws,
                        int batch, int nq, int nc, int d, int heads, int hidden,
                        int depth, cudaStream_t s) {
  auto F = [&](int i) { return static_cast<const float*>(w[i]); };
  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  auto DW = [&](int i) { return static_cast<float*>(dw[i]); };
  const Layout L = make_layout(batch, nq, nc, d, hidden, depth);
  const int mq = batch * nq, mc = batch * nc, dh = d / heads, H = hidden;
  const size_t D = d;
  float* part = fws + L.part;
  T *qn = ws + L.qn, *cn = ws + L.cn, *xq = ws + L.xq, *kv = ws + L.kv;
  T *att = ws + L.att, *xattn = ws + L.xattn, *on = ws + L.on;
  T *xhpre = ws + L.xhpre, *xh = ws + L.xh;
  T *g = ws + L.g, *dhid = ws + L.dh, *dn = ws + L.dn, *da = ws + L.da;
  T *dqkv = ws + L.dqkv, *dkv = ws + L.dkv, *dcn = ws + L.dcn;
  auto WT = [&](int i) { return ws + L.wt[i]; };
  auto blk = [&](int i, size_t off) { return ws + L.blk + i * L.blk_stride + off; };
  float *mean_q = fws + L.st_q, *rstd_q = mean_q + mq;
  float *mean_c = fws + L.st_c, *rstd_c = mean_c + mc;
  float *mean_on = fws + L.st_on, *rstd_on = mean_on + mq;
  auto stat = [&](int i, int k) { return fws + L.st_blk + ((size_t)4 * i + k) * mq; };

  // Transposed weight matrices for the dX GEMMs.
  MM_TRY(transpose<T>(W(WQ), WT(WQ), d, d, s));
  MM_TRY(transpose<T>(W(WKV), WT(WKV), 2 * d, d, s));
  MM_TRY(transpose<T>(W(WXP), WT(WXP), d, d, s));
  MM_TRY(transpose<T>(W(W1), WT(W1), H, d, s));
  MM_TRY(transpose<T>(W(W2), WT(W2), d, H, s));
  for (int i = 0; i < depth; ++i) {
    MM_TRY(transpose<T>(W(WQKV) + i * 3 * D * D, WT(WQKV) + i * 3 * D * D, 3 * d, d, s));
    MM_TRY(transpose<T>(W(WP) + i * D * D, WT(WP) + i * D * D, d, d, s));
    MM_TRY(transpose<T>(W(WF1) + i * H * D, WT(WF1) + i * H * D, H, d, s));
    MM_TRY(transpose<T>(W(WF2) + i * D * H, WT(WF2) + i * D * H, d, H, s));
  }

  // ---- forward recompute (fused_decoder_fwd.cu's chain, keeping activations)
  MM_TRY(layer_norm<T>(q, F(QN_G), F(QN_B), qn, mq, d, s, mean_q, rstd_q));
  MM_TRY(layer_norm<T>(c, F(CN_G), F(CN_B), cn, mc, d, s, mean_c, rstd_c));
  MM_TRY(gemm<EPI_BIAS>(qn, W(WQ), W(BQ), (const T*)nullptr, xq, mq, d, d, s));
  MM_TRY(gemm<EPI_BIAS>(cn, W(WKV), W(BKV), (const T*)nullptr, kv, mc, 2 * d, d, s));
  MM_TRY(attention<T>(xq, d, kv, kv + d, 2 * d, att, d, batch, heads, nq, nc, dh, s));
  MM_TRY(gemm<EPI_BIAS>(att, W(WXP), W(BXP), (const T*)nullptr, xattn, mq, d, d, s));
  MM_TRY(layer_norm<T>(xattn, F(ON_G), F(ON_B), on, mq, d, s, mean_on, rstd_on));
  MM_TRY(gemm<EPI_BIAS>(on, W(W1), W(B1), (const T*)nullptr, xhpre, mq, H, d, s));
  MM_TRY(gelu<T>(xhpre, xh, (size_t)mq * H, s));
  if (depth > 0)
    MM_TRY(gemm<EPI_RES>(xh, W(W2), W(B2), xattn, blk(0, L.b_in), mq, d, H, s));
  for (int i = 0; i < depth; ++i) {
    T *in = blk(i, L.b_in), *n1 = blk(i, L.b_n1), *qkv = blk(i, L.b_qkv);
    T *a = blk(i, L.b_a), *mid = blk(i, L.b_mid), *n2 = blk(i, L.b_n2);
    T *hpre = blk(i, L.b_hpre), *hh = blk(i, L.b_h);
    MM_TRY(layer_norm<T>(in, F(N1_G) + i * D, F(N1_B) + i * D, n1, mq, d, s,
                         stat(i, 0), stat(i, 1)));
    MM_TRY(gemm<EPI_BIAS>(n1, W(WQKV) + i * 3 * D * D, W(BQKV) + i * 3 * D,
                          (const T*)nullptr, qkv, mq, 3 * d, d, s));
    MM_TRY(attention<T>(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, a, d, batch, heads,
                        nq, nq, dh, s));
    MM_TRY(gemm<EPI_RES>(a, W(WP) + i * D * D, W(BP) + i * D, in, mid, mq, d, d, s));
    MM_TRY(layer_norm<T>(mid, F(N2_G) + i * D, F(N2_B) + i * D, n2, mq, d, s,
                         stat(i, 2), stat(i, 3)));
    MM_TRY(gemm<EPI_BIAS>(n2, W(WF1) + i * H * D, W(BF1) + (size_t)i * H,
                          (const T*)nullptr, hpre, mq, H, d, s));
    MM_TRY(gelu<T>(hpre, hh, (size_t)mq * H, s));
    if (i + 1 < depth)
      MM_TRY(gemm<EPI_RES>(hh, W(WF2) + i * D * H, W(BF2) + i * D, mid,
                           blk(i + 1, L.b_in), mq, d, H, s));
  }

  // ---- backward (fused_decoder_pallas._core_bwd)
  MM_TRY(cudaMemcpyAsync(g, gout, (size_t)mq * d * sizeof(T), cudaMemcpyDeviceToDevice, s));
  for (int i = depth - 1; i >= 0; --i) {
    T *in = blk(i, L.b_in), *n1 = blk(i, L.b_n1), *qkv = blk(i, L.b_qkv);
    T *a = blk(i, L.b_a), *mid = blk(i, L.b_mid), *n2 = blk(i, L.b_n2);
    T *hpre = blk(i, L.b_hpre), *hh = blk(i, L.b_h);
    // x_out = mid + fc2(gelu(fc1(LN2(mid))))
    MM_TRY(input_grad<EPI_DGELU>(g, WT(WF2) + i * D * H, hpre, dhid, mq, H, d, s));
    MM_TRY(weight_grad(g, hh, mq, d, H, part, DW(WF2) + i * D * H, s));
    MM_TRY(bias_grad<T>(g, mq, d, part, DW(BF2) + i * D, s));
    MM_TRY(input_grad<EPI_NONE>(dhid, WT(WF1) + i * H * D, (const T*)nullptr, dn, mq, d, H, s));
    MM_TRY(weight_grad(dhid, n2, mq, H, d, part, DW(WF1) + i * H * D, s));
    MM_TRY(bias_grad<T>(dhid, mq, H, part, DW(BF1) + (size_t)i * H, s));
    MM_TRY(ln_backward<T>(dn, mid, stat(i, 2), stat(i, 3), F(N2_G) + i * D, g, g,
                          DW(N2_G) + i * D, DW(N2_B) + i * D, part, mq, d, s));
    // mid = in + proj(attn(qkv(LN1(in))))
    MM_TRY(input_grad<EPI_NONE>(g, WT(WP) + i * D * D, (const T*)nullptr, da, mq, d, d, s));
    MM_TRY(weight_grad(g, a, mq, d, d, part, DW(WP) + i * D * D, s));
    MM_TRY(bias_grad<T>(g, mq, d, part, DW(BP) + i * D, s));
    MM_TRY(attention_bwd<T>(qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, da, d, dqkv, 3 * d,
                            dqkv + d, dqkv + 2 * d, 3 * d, batch, heads, nq, nq, dh, s));
    MM_TRY(input_grad<EPI_NONE>(dqkv, WT(WQKV) + i * 3 * D * D, (const T*)nullptr, dn, mq,
                                d, 3 * d, s));
    MM_TRY(weight_grad(dqkv, n1, mq, 3 * d, d, part, DW(WQKV) + i * 3 * D * D, s));
    MM_TRY(bias_grad<T>(dqkv, mq, 3 * d, part, DW(BQKV) + i * 3 * D, s));
    MM_TRY(ln_backward<T>(dn, in, stat(i, 0), stat(i, 1), F(N1_G) + i * D, g, g,
                          DW(N1_G) + i * D, DW(N1_B) + i * D, part, mq, d, s));
  }

  // cross-attention MLP: x = x_attn + fc2(gelu(fc1(out_norm(x_attn))))
  MM_TRY(input_grad<EPI_DGELU>(g, WT(W2), xhpre, dhid, mq, H, d, s));
  MM_TRY(weight_grad(g, xh, mq, d, H, part, DW(W2), s));
  MM_TRY(bias_grad<T>(g, mq, d, part, DW(B2), s));
  MM_TRY(input_grad<EPI_NONE>(dhid, WT(W1), (const T*)nullptr, dn, mq, d, H, s));
  MM_TRY(weight_grad(dhid, on, mq, H, d, part, DW(W1), s));
  MM_TRY(bias_grad<T>(dhid, mq, H, part, DW(B1), s));
  MM_TRY(ln_backward<T>(dn, xattn, mean_on, rstd_on, F(ON_G), g, g, DW(ON_G), DW(ON_B),
                        part, mq, d, s));

  // x_attn = proj(cross-attention(q(LN q), kv(LN c)))
  MM_TRY(input_grad<EPI_NONE>(g, WT(WXP), (const T*)nullptr, da, mq, d, d, s));
  MM_TRY(weight_grad(g, att, mq, d, d, part, DW(WXP), s));
  MM_TRY(bias_grad<T>(g, mq, d, part, DW(BXP), s));
  T* dqa = dqkv;  // (mq, d): dqkv is free here
  MM_TRY(attention_bwd<T>(xq, d, kv, kv + d, 2 * d, da, d, dqa, d, dkv, dkv + d, 2 * d,
                          batch, heads, nq, nc, dh, s));
  MM_TRY(input_grad<EPI_NONE>(dqa, WT(WQ), (const T*)nullptr, dn, mq, d, d, s));
  MM_TRY(weight_grad(dqa, qn, mq, d, d, part, DW(WQ), s));
  MM_TRY(bias_grad<T>(dqa, mq, d, part, DW(BQ), s));
  MM_TRY(input_grad<EPI_NONE>(dkv, WT(WKV), (const T*)nullptr, dcn, mc, d, 2 * d, s));
  MM_TRY(weight_grad(dkv, cn, mc, 2 * d, d, part, DW(WKV), s));
  MM_TRY(bias_grad<T>(dkv, mc, 2 * d, part, DW(BKV), s));
  MM_TRY(ln_backward<T>(dn, q, mean_q, rstd_q, F(QN_G), (const T*)nullptr, dq, DW(QN_G),
                        DW(QN_B), part, mq, d, s));
  return ln_backward<T>(dcn, c, mean_c, rstd_c, F(CN_G), (const T*)nullptr, dc, DW(CN_G),
                        DW(CN_B), part, mc, d, s);
}

}  // namespace

// What the backward needs before its launch: the elements of the
// compute-dtype and fp32 workspaces, and the dynamic shared memory of its
// attention kernel over the longer of the two key sets (f32 != 0: fp32,
// else bf16), which the caller holds against the card's limit.
extern "C" int mm_fused_decoder_bwd_workspace(int batch, int nq, int nc, int d, int heads,
                                              int hidden, int depth, int f32,
                                              long long* t_elems, long long* f_elems,
                                              long long* attn_smem) {
  const Layout L = make_layout(batch, nq, nc, d, hidden, depth);
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
