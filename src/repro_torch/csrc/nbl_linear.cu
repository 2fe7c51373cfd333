// K2: the NBL replacement block y = x @ W + b (+ x), for Hopper.
//
// Replaces the Pallas kernel repro/kernels/nbl_linear.py::nbl_linear (its
// pallas_call), the layer the paper inserts in place of an attention
// sub-block. x (M, K), W (K, N), b (N,), y (M, N); the residual needs a
// square W (K == N). The product accumulates in float32; bias and residual
// are added in float32 in the epilogue and fused into the single output
// write, so x is read once for the product and once for the residual tile.
// Ragged M, N and K are handled with masks (zero-filled tiles), not padding.
//
// What bounds it on an H100: at decode (M = n_slots, e.g. 8) the kernel
// reads the whole d x d W once for a handful of rows (33.5 MB in bf16 at
// d = 4096), so it is bound by device-memory bytes; at a 512-token chunk
// step (M = n_slots * 512) it does ~2*M*K*N flops on 2*K*N bytes of W,
// far above the bf16 ridge, so it is bound by tensor-core operations. This
// first version: bf16 runs on the tensor cores through WMMA 16x16x16
// fragments (float32 accumulators) on 64x64 block tiles, with no
// multi-stage pipeline yet (wgmma/TMA come later); float32 runs on CUDA
// cores with a 64x64 register-tiled loop. Each block reads its x and W
// tiles once per K step into shared memory and writes each output once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;     // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;     // float elements

template <bool RES>
__global__ void __launch_bounds__(128)
nbl_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ y, int M, int N, int K, int vec) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(128) float sC[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wy = warp / 2, wx = warp % 2;      // 2 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {                                  // K % 8 == 0 and N % 8 == 0
      for (int v = tid; v < BM * BK / 8; v += 128) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m0 + r < M && k0 + c < K)
          val = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(sA + r * LDA + c) = val;
      }
      for (int v = tid; v < BK * BN / 8; v += 128) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + r < K && n0 + c < N)
          val = *reinterpret_cast<const uint4*>(w + size_t(k0 + r) * N + n0 + c);
        *reinterpret_cast<uint4*>(sB + r * LDB + c) = val;
      }
    } else {
      for (int e = tid; e < BM * BK; e += 128) {
        const int r = e / BK, c = e % BK;
        sA[r * LDA + c] = (m0 + r < M && k0 + c < K)
                              ? x[size_t(m0 + r) * K + k0 + c] : zero;
      }
      for (int e = tid; e < BK * BN; e += 128) {
        const int r = e / BN, c = e % BN;
        sB[r * LDB + c] = (k0 + r < K && n0 + c < N)
                              ? w[size_t(k0 + r) * N + n0 + c] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wy * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + kk * LDB + wx * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wy * 32 + i * 16) * LDC + wx * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = sC[r * LDC + c] + __bfloat162float(bias[n]);
      if (RES) v += __bfloat162float(x[size_t(m) * K + n]);
      y[size_t(m) * N + n] = __float2bfloat16(v);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int FBK = 16;

template <bool RES>
__global__ void __launch_bounds__(256)
nbl_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y, int M,
               int N, int K) {
  __shared__ float sA[FBK][BM + 4];     // x tile, transposed
  __shared__ float sB[FBK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < BM * FBK; e += 256) {
      const int r = e / FBK, c = e % FBK;
      sA[c][r] = (m0 + r < M && k0 + c < K) ? x[size_t(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int e = tid; e < FBK * BN; e += 256) {
      const int r = e / BN, c = e % BN;
      sB[r][c] = (k0 + r < K && n0 + c < N) ? w[size_t(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        float v = acc[i][j] + bias[n];
        if (RES) v += x[size_t(m) * K + n];
        y[size_t(m) * N + n] = v;
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. residual != 0 requires K == N.
// Returns the launch's cudaError_t (0 = success).
extern "C" int nbl_linear_launch(const void* x, const void* w, const void* b,
                                 void* y, int M, int N, int K, int residual,
                                 int dtype, void* stream) {
  if (residual && K != N) return int(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 1) {
    const int vec = (K % 8 == 0) && (N % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto bb = static_cast<const __nv_bfloat16*>(b);
    auto yb = static_cast<__nv_bfloat16*>(y);
    if (residual)
      nbl_bf16_kernel<true><<<grid, 128, 0, s>>>(xb, wb, bb, yb, M, N, K, vec);
    else
      nbl_bf16_kernel<false><<<grid, 128, 0, s>>>(xb, wb, bb, yb, M, N, K, vec);
  } else if (dtype == 0) {
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto bf = static_cast<const float*>(b);
    auto yf = static_cast<float*>(y);
    if (residual)
      nbl_f32_kernel<true><<<grid, 256, 0, s>>>(xf, wf, bf, yf, M, N, K);
    else
      nbl_f32_kernel<false><<<grid, 256, 0, s>>>(xf, wf, bf, yf, M, N, K);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
