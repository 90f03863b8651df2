// Backward building blocks shared by the K1 backward (fused_decoder_bwd.cu)
// and the K3b backward (fused_mlp_bwd.cu), for Hopper (sm_90a):
//
//   transpose     a weight matrix, once per call, for the dX = G . W GEMMs
//   gelu          y = GELU(x) elementwise, keeping the pre-activation
//   bias_grad     db = column sums of G, fp32
//   ln_backward   LayerNorm backward (dx, fp32 dgamma and dbeta)
//   weight_grad   dW = G^T . X (the TN GEMM), fp32
//
// Every column reduction over the rows (db, dgamma, dbeta, dW) is cut into
// fixed slices of SLICE rows: one block per slice (and output tile) writes
// fp32 partial sums, and sum_slices adds the slices in a fixed order. No
// atomics, so the results are bit-identical from run to run. The partial
// sums need num_slices(rows) * (outputs) fp32 elements of workspace.
//
// The kernels and launchers live in an anonymous namespace: each
// translation unit that includes this header gets its own copy, so the
// shared library links without duplicate symbols.
#pragma once

#include "common.cuh"

namespace {

using namespace mm;

#define MM_TRY(expr)                             \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

constexpr int SLICE = 1024;  // rows per partial sum of a column reduction

inline int num_slices(int rows) { return (rows + SLICE - 1) / SLICE; }

// ------------------------------------------------------------ small kernels

// out (cols, rows) = in (rows, cols)^T, through a padded 32x32 tile.
template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols) {
  __shared__ T tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && c < cols) out[(size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

template <typename T>
cudaError_t transpose(const T* in, T* out, int rows, int cols, cudaStream_t s) {
  dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  transpose_kernel<T><<<grid, dim3(32, 8), 0, s>>>(in, out, rows, cols);
  return cudaGetLastError();
}

// y = GELU(x) elementwise, x already rounded to T: the forward epilogue's
// last step, kept apart so the pre-activation is saved too.
template <typename T>
__global__ void gelu_kernel(const T* __restrict__ x, T* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = from_f<T>(gelu_f(to_f(x[i])));
}

template <typename T>
cudaError_t gelu(const T* x, T* y, size_t n, cudaStream_t s) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  gelu_kernel<T><<<blocks, 256, 0, s>>>(x, y, n);
  return cudaGetLastError();
}

// out[e] = sum over s = 0..S-1 of part[s * n + e], in that order.
__global__ void sum_slices_kernel(const float* __restrict__ part, int S, size_t n,
                                  float* __restrict__ out) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < S; ++z) acc += part[(size_t)z * n + e];
    out[e] = acc;
  }
}

cudaError_t sum_slices(const float* part, int S, size_t n, float* out, cudaStream_t s) {
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  sum_slices_kernel<<<blocks, 256, 0, s>>>(part, S, n, out);
  return cudaGetLastError();
}

// part[z * n + col] = sum of G[r, col] over the rows r of slice z.
template <typename T>
__global__ void __launch_bounds__(256)
colsum_partial_kernel(const T* __restrict__ G, int rows, int n, float* __restrict__ part) {
  const int col = blockIdx.x * 256 + threadIdx.x, z = blockIdx.y;
  if (col >= n) return;
  const int r1 = min(rows, (z + 1) * SLICE);
  float acc = 0.f;
  for (int r = z * SLICE; r < r1; ++r) acc += to_f(G[(size_t)r * n + col]);
  part[(size_t)z * n + col] = acc;
}

// db (n,) = column sums of G (rows, n), fp32.
template <typename T>
cudaError_t bias_grad(const T* G, int rows, int n, float* part, float* db, cudaStream_t s) {
  const int S = num_slices(rows);
  colsum_partial_kernel<T><<<dim3((n + 255) / 256, S), 256, 0, s>>>(G, rows, n, part);
  MM_TRY(cudaGetLastError());
  return sum_slices(part, S, n, db, s);
}

// LayerNorm backward, one warp per row (fused_decoder_pallas._ln_bwd):
//   xhat = (x - mean) * rstd, dxhat = dy * gamma,
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// out = T(res + dx) where res is given (it may alias out), else T(dx).
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gamma, const T* res, T* out, int rows, int d) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  const float mu = mean[row], inv = rstd[row];
  float xh[LN_MAX_PER_LANE], dxh[LN_MAX_PER_LANE];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < d) {
      xh[i] = (to_f(x[base + c]) - mu) * inv;
      dxh[i] = to_f(dy[base + c]) * gamma[c];
    } else {
      xh[i] = 0.f;
      dxh[i] = 0.f;
    }
    s1 += dxh[i];
    s2 += dxh[i] * xh[i];
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < d) {
      float v = inv * (dxh[i] - m1 - xh[i] * m2);
      if (res != nullptr) v = to_f(res[base + c]) + v;
      out[base + c] = from_f<T>(v);
    }
  }
}

// Partial sums over the rows of slice z: part_g[z*d + c] = sum dy*xhat,
// part_b[z*d + c] = sum dy.
template <typename T>
__global__ void __launch_bounds__(256)
ln_grad_partial_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       int rows, int d, float* __restrict__ part_g,
                       float* __restrict__ part_b) {
  const int col = blockIdx.x * 256 + threadIdx.x, z = blockIdx.y;
  if (col >= d) return;
  const int r1 = min(rows, (z + 1) * SLICE);
  float ag = 0.f, ab = 0.f;
  for (int r = z * SLICE; r < r1; ++r) {
    const size_t off = (size_t)r * d + col;
    const float g = to_f(dy[off]);
    ag += g * ((to_f(x[off]) - mean[r]) * rstd[r]);
    ab += g;
  }
  part_g[(size_t)z * d + col] = ag;
  part_b[(size_t)z * d + col] = ab;
}

// LayerNorm backward of rows (rows, d): out (see ln_bwd_kernel), and the
// fp32 parameter gradients dgamma, dbeta (d,).
template <typename T>
cudaError_t ln_backward(const T* dy, const T* x, const float* mean, const float* rstd,
                        const float* gamma, const T* res, T* out, float* dgamma,
                        float* dbeta, float* part, int rows, int d, cudaStream_t s) {
  ln_bwd_kernel<T><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
      dy, x, mean, rstd, gamma, res, out, rows, d);
  MM_TRY(cudaGetLastError());
  const int S = num_slices(rows);
  float* part_b = part + (size_t)S * d;
  ln_grad_partial_kernel<T><<<dim3((d + 255) / 256, S), 256, 0, s>>>(
      dy, x, mean, rstd, rows, d, part, part_b);
  MM_TRY(cudaGetLastError());
  MM_TRY(sum_slices(part, S, d, dgamma, s));
  return sum_slices(part_b, S, d, dbeta, s);
}

// ---------------------------------------------------- dW = G^T . X (TN GEMM)
//
// part[z][o][i] = sum over the rows r of slice z of A[r, o] * B[r, i], with
// A (R, Mo) and B (R, Ni) row-major. Grid (Ni/64, Mo/64, slices).

constexpr int TN_TILE = 64, TN_K = 32, TN_LD = TN_TILE + 8;

// bf16: 4 warps of 32x32, m16n8k16 tensor-core products. The tiles sit in
// shared memory row-major in r (the reduction index), so a fragment's two
// consecutive-k values are two 16-bit loads packed by hand: lane (g, t)
// reads rows kk+2t, kk+2t+1 at column g, words 36 apart, 16 distinct
// banks per warp (two lanes share each word).
__global__ void __launch_bounds__(128)
tn_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               float* __restrict__ part, int R, int Mo, int Ni) {
  __shared__ __align__(16) bf16 sA[2][TN_K][TN_LD];
  __shared__ __align__(16) bf16 sB[2][TN_K][TN_LD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.y * TN_TILE, i0 = blockIdx.x * TN_TILE;
  const int r_begin = blockIdx.z * SLICE, r_end = min(R, r_begin + SLICE);

  // One stage: TN_K rows x 64 columns of A and of B, 8 chunks of 8 bf16
  // per row; chunks past the last row or column are zero-filled.
  auto load_stage = [&](int st, int r0) {
#pragma unroll
    for (int idx = tid; idx < TN_K * 8; idx += 128) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      const bool okr = r0 + r < r_end;
      const bool oka = okr && o0 + c < Mo, okb = okr && i0 + c < Ni;
      cp_async_16(&sA[st][r][c], A + (oka ? (size_t)(r0 + r) * Mo + o0 + c : 0), oka);
      cp_async_16(&sB[st][r][c], B + (okb ? (size_t)(r0 + r) * Ni + i0 + c : 0), okb);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int steps = (r_end - r_begin + TN_K - 1) / TN_K;
  if (steps > 0) load_stage(0, r_begin);
  for (int kt = 0; kt < steps; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < steps) {
      load_stage(st ^ 1, r_begin + (kt + 1) * TN_K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TN_K; kk += 16) {
      const int k0 = kk + 2 * t;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wm * 32 + mi * 16 + g;
        a[mi][0] = pack2(sA[st][k0][m], sA[st][k0 + 1][m]);
        a[mi][1] = pack2(sA[st][k0][m + 8], sA[st][k0 + 1][m + 8]);
        a[mi][2] = pack2(sA[st][k0 + 8][m], sA[st][k0 + 9][m]);
        a[mi][3] = pack2(sA[st][k0 + 8][m + 8], sA[st][k0 + 9][m + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        b[ni][0] = pack2(sB[st][k0][n], sB[st][k0 + 1][n]);
        b[ni][1] = pack2(sB[st][k0 + 8][n], sB[st][k0 + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the stage is refilled by the next iteration's loads
  }

  float* P = part + (size_t)blockIdx.z * Mo * Ni;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wm * 32 + mi * 16 + g + h * 8;
        const int i = i0 + wn * 32 + ni * 8 + t * 2;
        if (o < Mo) {
          if (i < Ni) P[(size_t)o * Ni + i] = acc[mi][ni][h * 2];
          if (i + 1 < Ni) P[(size_t)o * Ni + i + 1] = acc[mi][ni][h * 2 + 1];
        }
      }
}

// fp32: 256 threads, 4x4 outputs each (rows ty + 16i, columns tx + 16j),
// 16 reduction rows per step, true fp32 FMA.
constexpr int TF_K = 16;

__global__ void __launch_bounds__(256)
tn_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ part, int R, int Mo, int Ni) {
  __shared__ float sA[TF_K][TN_TILE + 4];
  __shared__ float sB[TF_K][TN_TILE + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int o0 = blockIdx.y * TN_TILE, i0 = blockIdx.x * TN_TILE;
  const int r_begin = blockIdx.z * SLICE, r_end = min(R, r_begin + SLICE);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += TF_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      const int r = idx >> 6, c = idx & 63;
      const bool okr = r0 + r < r_end;
      sA[r][c] = okr && o0 + c < Mo ? A[(size_t)(r0 + r) * Mo + o0 + c] : 0.f;
      sB[r][c] = okr && i0 + c < Ni ? B[(size_t)(r0 + r) * Ni + i0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TF_K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* P = part + (size_t)blockIdx.z * Mo * Ni;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty + 16 * i, n = i0 + tx + 16 * j;
      if (o < Mo && n < Ni) P[(size_t)o * Ni + n] = acc[i][j];
    }
}

// dW (Mo, Ni) fp32 = G^T . X over R rows, G (R, Mo), X (R, Ni).
cudaError_t weight_grad(const bf16* G, const bf16* X, int R, int Mo, int Ni,
                        float* part, float* dW, cudaStream_t s) {
  const int S = num_slices(R);
  dim3 grid((Ni + TN_TILE - 1) / TN_TILE, (Mo + TN_TILE - 1) / TN_TILE, S);
  tn_bf16_kernel<<<grid, 128, 0, s>>>(G, X, part, R, Mo, Ni);
  MM_TRY(cudaGetLastError());
  return sum_slices(part, S, (size_t)Mo * Ni, dW, s);
}

cudaError_t weight_grad(const float* G, const float* X, int R, int Mo, int Ni,
                        float* part, float* dW, cudaStream_t s) {
  const int S = num_slices(R);
  dim3 grid((Ni + TN_TILE - 1) / TN_TILE, (Mo + TN_TILE - 1) / TN_TILE, S);
  tn_f32_kernel<<<grid, 256, 0, s>>>(G, X, part, R, Mo, Ni);
  MM_TRY(cudaGetLastError());
  return sum_slices(part, S, (size_t)Mo * Ni, dW, s);
}

}  // namespace
