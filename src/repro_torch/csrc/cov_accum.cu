// K4: covariance accumulation acc (Dy, Dx) += y^T x, in place, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/cov_accum.py::cov_accum (its
// pallas_call), the calibration hot spot: NBL streams the raw moments
// sum x^T x, sum y^T x, sum y+^T x and sum y+^T y+ of every tapped layer
// over the calibration tokens (core/moments.py::update_moments, four calls
// per layer per batch). x (T, Dx), y (T, Dy), both row-major and of one
// dtype (float32 or bfloat16, converted to float32 as they are staged);
// acc (Dy, Dx) float32 is read once and written once per output tile, as
// the TPU kernel adds its HBM accumulator at the last token block.
// y == x gives the Gram update. Ragged T, Dx and Dy are masked in the
// kernel (zero-filled tiles), not padded.
//
// Determinism: every output tile is owned by one block, whose threads sum
// the T loop in a fixed order (no atomics, no split over T), so the same
// inputs give a bit-identical acc on every run -- the guarantee the
// moments' elastic restart relies on.
//
// What bounds it on an H100: at the calibration shape (T = 4096 tokens,
// Dx = Dy = 4096) one call is 2*T*Dx*Dy = 137 GFLOP of float32 work on
// 256 MB of traffic, so it is bound by operations: the float32 CUDA-core
// rate (67 TFLOP/s), ~2 ms. This first version is a classic register-tiled
// SGEMM on the CUDA cores: 128 x 128 output tiles, 256 threads with an
// 8 x 8 register tile each (float4 shared-memory reads), 8 tokens per
// stage, the next stage prefetched into registers while the current one
// is multiplied (two shared-memory buffers, one barrier per stage).
// Both operands are token-major, so a staged tile is already k-major for
// the outer product and needs no transpose.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // acc rows per block (y features)
constexpr int BN = 128;   // acc columns per block (x features)
constexpr int BT = 8;     // tokens per stage
constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive features [c, c + 4) of token t as float32, zero past
// the ragged edges. VEC: D % 4 == 0 and an aligned base (one 16-byte
// load for float32, one 8-byte load for bfloat16).
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int D, int Tn,
                                      int t, int c, float v[4]) {
  if (VEC) {
    if (t < Tn && c < D) {
      const T* src = p + size_t(t) * D + c;
      if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
      }
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (t < Tn && c + e < D) ? to_f32(p[size_t(t) * D + c + e]) : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
cov_accum_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 float* __restrict__ acc, int Tn, int Dx, int Dy) {
  __shared__ __align__(16) float sY[2][BT][BM];
  __shared__ __align__(16) float sX[2][BT][BN];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  // staging: each thread moves 4 features of one token per operand
  const int lt = tid / 32, lc = (tid % 32) * 4;
  // compute: 16 x 16 threads, rows {ty*4 .. +3, 64 + ty*4 .. +3}, same
  // for columns with tx, so a warp's float4 reads hit distinct banks
  const int ty = tid / 16, tx = tid % 16;

  float r[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) r[a][b] = 0.f;

  float vy[4], vx[4];
  load4<T, VEC>(y, Dy, Tn, lt, i0 + lc, vy);
  load4<T, VEC>(x, Dx, Tn, lt, j0 + lc, vx);
  *reinterpret_cast<float4*>(&sY[0][lt][lc]) = make_float4(vy[0], vy[1], vy[2], vy[3]);
  *reinterpret_cast<float4*>(&sX[0][lt][lc]) = make_float4(vx[0], vx[1], vx[2], vx[3]);
  __syncthreads();

  const int nst = (Tn + BT - 1) / BT;
  for (int s = 0; s < nst; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < nst;
    if (more) {                       // prefetch the next stage to registers
      const int t = (s + 1) * BT + lt;
      load4<T, VEC>(y, Dy, Tn, t, i0 + lc, vy);
      load4<T, VEC>(x, Dx, Tn, t, j0 + lc, vx);
    }
#pragma unroll
    for (int k = 0; k < BT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sY[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sY[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sX[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sX[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) r[a][b] = fmaf(av[a], bv[b], r[a][b]);
    }
    if (more) {
      *reinterpret_cast<float4*>(&sY[cur ^ 1][lt][lc]) =
          make_float4(vy[0], vy[1], vy[2], vy[3]);
      *reinterpret_cast<float4*>(&sX[cur ^ 1][lt][lc]) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();
  }

  // epilogue: acc += r, each element read and written once
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= Dy) continue;
    float* row = acc + size_t(i) * Dx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      if (VEC && j + 3 < Dx) {
        float4 o = *reinterpret_cast<float4*>(row + j);
        o.x += r[a][h * 4 + 0]; o.y += r[a][h * 4 + 1];
        o.z += r[a][h * 4 + 2]; o.w += r[a][h * 4 + 3];
        *reinterpret_cast<float4*>(row + j) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < Dx) row[j + e] += r[a][h * 4 + e];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* acc, int Tn, int Dx, int Dy,
           cudaStream_t s) {
  const size_t align = sizeof(T) == 4 ? 16 : 8;
  const bool vec = Dx % 4 == 0 && Dy % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  dim3 grid((Dx + BN - 1) / BN, (Dy + BM - 1) / BM);
  auto xt = static_cast<const T*>(x);
  auto yt = static_cast<const T*>(y);
  auto at = static_cast<float*>(acc);
  if (vec)
    cov_accum_kernel<T, true><<<grid, NTHREADS, 0, s>>>(xt, yt, at, Tn, Dx, Dy);
  else
    cov_accum_kernel<T, false><<<grid, NTHREADS, 0, s>>>(xt, yt, at, Tn, Dx, Dy);
  return int(cudaGetLastError());
}

}  // namespace

// acc (Dy, Dx) float32 += y^T x with x (T, Dx), y (T, Dy) row-major of one
// dtype: 0 = float32, 1 = bfloat16. Pass y == x for the Gram update.
// Returns the launch's cudaError_t (0 = success).
extern "C" int cov_accum_launch(const void* x, const void* y, void* acc,
                                int T, int Dx, int Dy, int dtype,
                                void* stream) {
  if (T <= 0 || Dx <= 0 || Dy <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, acc, T, Dx, Dy, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, acc, T, Dx, Dy, s);
  return int(cudaErrorInvalidValue);
}
