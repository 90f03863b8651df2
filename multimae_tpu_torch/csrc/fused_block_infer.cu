// fused_block_infer (K4): one pre-LN ViT encoder block, inference only.
//
// Replaces: multimae_tpu/ops/fused_block_pallas.py `fused_block_infer`
// (Pallas programs `_kernel` / `_kernel_tiled`, math `_block_2d`).
//
// What bounds it on the H100: at the serving shape (B=32, N=99 tokens,
// D=768, 12 heads, hidden 3072, bf16) a block is 45 GFLOP of GEMMs over
// 3168 rows, so it is bound by tensor-core throughput (about 45 us at
// the bf16 peak) more than by the 14 MB of weights and ~150 MB of
// activation traffic between its steps (about 50 us at 3.35 TB/s).
// Attention is 4% of the FLOPs.
//
// Design: a fixed chain of seven launches on the caller's stream
// (common.cuh): LN1 -> GEMM qkv (768 -> 2304) -> attention (K/V of one
// sample-head resident in shared memory, q/k/v read in place from the
// fused qkv output) -> GEMM proj + residual -> LN2 -> GEMM fc1 + GELU ->
// GEMM fc2 + residual. The GEMMs run over all B*N rows at once (the TPU
// kernel's per-sample grid is a VMEM artefact) on mma.sync bf16 tensor
// core tiles with fp32 accumulation. Activations between the steps go
// through device memory (L2-resident at this size); fusing across the
// GEMMs and wgmma/TMA tiles are later work.

#include "common.cuh"

namespace {

// Weight pointers in BlockWeights order (ops/fused_block.py).
enum { N1_G, N1_B, WQKV, BQKV, WP, BP, N2_G, N2_B, W1, B1, W2, B2 };

}  // namespace

extern "C" int mm_fused_block_infer_bf16(const void* x, void* out,
                                         const void* const* w, void* ln,
                                         void* qkv, void* att, void* hid,
                                         int batch, int n, int d, int heads,
                                         int hidden, void* stream) {
  using T = mm::bf16;
  mm::BlockParams<T> p;
  p.n1_g = static_cast<const float*>(w[N1_G]);
  p.n1_b = static_cast<const float*>(w[N1_B]);
  p.wqkv = static_cast<const T*>(w[WQKV]);
  p.bqkv = static_cast<const T*>(w[BQKV]);
  p.wp = static_cast<const T*>(w[WP]);
  p.bp = static_cast<const T*>(w[BP]);
  p.n2_g = static_cast<const float*>(w[N2_G]);
  p.n2_b = static_cast<const float*>(w[N2_B]);
  p.w1 = static_cast<const T*>(w[W1]);
  p.b1 = static_cast<const T*>(w[B1]);
  p.w2 = static_cast<const T*>(w[W2]);
  p.b2 = static_cast<const T*>(w[B2]);
  cudaError_t e = mm::block_chain<T>(
      static_cast<const T*>(x), static_cast<T*>(out), p, static_cast<T*>(ln),
      static_cast<T*>(qkv), static_cast<T*>(att), static_cast<T*>(hid), batch, n,
      d, heads, hidden, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
