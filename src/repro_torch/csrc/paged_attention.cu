// K1: paged attention over the fused step's mixed (B, W) rows, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py::paged_attention
// (its pallas_call), which the JAX package reaches through paged_mixed as
// B*W virtual single-query rows. This kernel takes the mixed rows directly:
// q (B, KV, rep, W, hd) with per-slot row_pos / row_len, so one staged K/V
// chunk serves all W*rep query rows of a tile. W = 1 is decode.
//
// Semantics (the plain version is kernels/paged_attention.py::paged_mixed_ref):
//   query w of slot b sits at absolute position qpos = row_pos[b] + w and is
//   valid iff w < row_len[b]; key t of that slot is attended iff
//   t <= qpos, tbl[b, t / page_size] >= 0, and (window == 0 or
//   qpos - t < window). Scores are scale * q.k, then softcap * tanh(s/softcap)
//   when softcap > 0. Softmax and accumulation in float32. A query row with
//   no attended key (an invalid row, or one whose pages are all unallocated)
//   is written as zeros.
//
// What bounds it on an H100: a decode step (W = 1) reads every attended
// K/V byte once for 4..32 query rows, so it is bound by device-memory
// bytes. A 256..512-token chunk row does about W*rep*hd*4 flops per K/V
// element, which is above the bf16 ridge, so it is bound by operations.
// This first version computes on CUDA cores in float32 (no wgmma/TMA yet).
// The design keeps the bytes minimal: one thread block per (query tile, kv
// head, slot) reads only the pages of its own slot, only up to the tile's
// last valid position (and only from the window's start), stages each K/V
// chunk in shared memory once for all rows of the tile, and exits at once
// for a tile with no valid row. Online softmax keeps scores out of device
// memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile geometry for a head dim: RW query rows per warp, KTMAX keys per
// staged chunk. RW * DPL accumulators and RW * KPL scores live in registers.
template <int HD> struct Geo {
  static constexpr int RW = HD >= 256 ? 8 : 16;
  static constexpr int QT = NWARPS * RW;              // query rows per block
  static constexpr int KTMAX = HD >= 256 ? 32 : 64;   // keys per chunk (max)
  static constexpr int KPL = KTMAX / 32;              // keys per lane
  static constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // head dims per lane
  static constexpr int KSTR = KTMAX + 1;              // padded row of sKt
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(QT) * HD + size_t(HD) * KSTR + size_t(KTMAX) * HD +
                       size_t(QT) * KTMAX);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_mixed_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ tbl,
                   const int* __restrict__ row_pos, const int* __restrict__ row_len,
                   T* __restrict__ out, int KV, int rep, int W, int page_size,
                   int n_lpages, float scale, int window, float softcap) {
  using G = Geo<HD>;
  extern __shared__ float smem[];
  float* sQ = smem;                          // [QT][HD]
  float* sKt = sQ + G::QT * HD;              // [HD][KSTR]  (K transposed)
  float* sV = sKt + HD * G::KSTR;            // [KTMAX][HD]
  float* sP = sV + G::KTMAX * HD;            // [QT][KTMAX]

  const int b = blockIdx.z, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows_total = W * rep;
  const int i0 = blockIdx.x * G::QT;
  const int i_end = min(i0 + G::QT, rows_total);
  const int len = row_len[b];
  const int p0 = row_pos[b];
  // q / out offset of query row i = w * rep + r: ((b*KV + g)*rep + r)*W + w
  const size_t head_base = (size_t(b) * KV + g) * rep;

  if (i0 / rep >= len) {                     // no valid row in this tile
    for (int idx = tid; idx < (i_end - i0) * HD; idx += NTHREADS) {
      const int i = i0 + idx / HD, d = idx % HD;
      out[((head_base + i % rep) * W + i / rep) * HD + d] = from_f<T>(0.f);
    }
    return;
  }
  const int w_lo = i0 / rep;
  const int w_hi = min(len - 1, (i_end - 1) / rep);
  const int qpos_hi = p0 + w_hi;
  const int t_lo = window > 0 ? max(0, p0 + w_lo - window + 1) : 0;

  for (int idx = tid; idx < G::QT * HD; idx += NTHREADS) {
    const int row = idx / HD, d = idx % HD, i = i0 + row;
    float v = 0.f;
    if (i < rows_total) v = to_f(q[((head_base + i % rep) * W + i / rep) * HD + d]);
    sQ[idx] = v;
  }

  int qpos[G::RW];
  bool rvalid[G::RW];
  float m[G::RW], l[G::RW], acc[G::RW][G::DPL];
#pragma unroll
  for (int k = 0; k < G::RW; ++k) {
    const int i = i0 + warp * G::RW + k;
    rvalid[k] = i < rows_total && i / rep < len;
    qpos[k] = p0 + i / rep;
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int e = 0; e < G::DPL; ++e) acc[k][e] = 0.f;
  }

  const int kt = min(page_size, G::KTMAX);   // keys per chunk; divides page_size
  float* sPw = sP + warp * G::RW * G::KTMAX;
  for (int t0 = (t_lo / kt) * kt; t0 <= qpos_hi; t0 += kt) {
    const int lp = t0 / page_size;
    if (lp >= n_lpages) break;
    const int pid = tbl[size_t(b) * n_lpages + lp];
    if (pid < 0) continue;                   // unallocated: every key masked
    const int off = t0 - lp * page_size;
    __syncthreads();                         // previous chunk fully consumed
    const size_t kbase = ((size_t(pid) * KV + g) * page_size + off) * HD;
    for (int idx = tid; idx < kt * HD; idx += NTHREADS) {
      const int j = idx / HD, d = idx % HD;
      sKt[d * G::KSTR + j] = to_f(kp[kbase + idx]);
      sV[idx] = to_f(vp[kbase + idx]);
    }
    __syncthreads();

    float s[G::RW][G::KPL];
#pragma unroll
    for (int k = 0; k < G::RW; ++k)
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) s[k][c] = 0.f;
    const float* sQw = sQ + warp * G::RW * HD;
    for (int d = 0; d < HD; ++d) {
      float kv[G::KPL];
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) kv[c] = sKt[d * G::KSTR + lane + 32 * c];
#pragma unroll
      for (int k = 0; k < G::RW; ++k) {
        const float qv = sQw[k * HD + d];
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) s[k][c] = fmaf(qv, kv[c], s[k][c]);
      }
    }

#pragma unroll
    for (int k = 0; k < G::RW; ++k) {
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) {
        const int j = lane + 32 * c, t = t0 + j;
        float v = s[k][c] * scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        const bool ok = rvalid[k] && j < kt && t <= qpos[k] &&
                        (window <= 0 || qpos[k] - t < window);
        v = ok ? v : -INFINITY;
        s[k][c] = v;
        rmax = fmaxf(rmax, v);
      }
      rmax = warp_max(rmax);
      const float m_new = fmaxf(m[k], rmax);
      float psum = 0.f;
      if (m_new == -INFINITY) {              // nothing attended yet
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) sPw[k * G::KTMAX + lane + 32 * c] = 0.f;
      } else {
        const float corr = expf(m[k] - m_new);
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) {
          const float p = expf(s[k][c] - m_new);
          psum += p;
          sPw[k * G::KTMAX + lane + 32 * c] = p;
        }
        psum = warp_sum(psum);
        l[k] = l[k] * corr + psum;
#pragma unroll
        for (int e = 0; e < G::DPL; ++e) acc[k][e] *= corr;
        m[k] = m_new;
      }
    }
    __syncwarp();
    for (int j = 0; j < kt; ++j) {
      float vv[G::DPL];
#pragma unroll
      for (int e = 0; e < G::DPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < HD ? sV[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < G::RW; ++k) {
        const float p = sPw[k * G::KTMAX + j];
#pragma unroll
        for (int e = 0; e < G::DPL; ++e) acc[k][e] = fmaf(p, vv[e], acc[k][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int k = 0; k < G::RW; ++k) {
    const int i = i0 + warp * G::RW + k;
    if (i >= rows_total) continue;
    const float inv = l[k] > 0.f ? 1.f / l[k] : 0.f;
    T* o = out + ((head_base + i % rep) * W + i / rep) * HD;
#pragma unroll
    for (int e = 0; e < G::DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) o[d] = from_f<T>(acc[k][e] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tbl,
           const int* row_pos, const int* row_len, void* out, int B, int KV,
           int rep, int W, int page_size, int n_lpages, float scale, int window,
           float softcap, cudaStream_t stream) {
  using G = Geo<HD>;
  auto kern = paged_mixed_kernel<T, HD>;
  static bool smem_set = false;              // opt in above 48 KB once
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  dim3 grid((W * rep + G::QT - 1) / G::QT, KV, B);
  paged_mixed_kernel<T, HD><<<grid, NTHREADS, G::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tbl, row_pos, row_len, static_cast<T*>(out),
      KV, rep, W, page_size, n_lpages, scale, window, softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const int* tbl, const int* row_pos, const int* row_len, void* out,
                int B, int KV, int rep, int W, int page_size, int n_lpages,
                float scale, int window, float softcap, cudaStream_t stream) {
#define K1_CASE(HD)                                                             \
  case HD:                                                                    \
    return launch<T, HD>(q, kp, vp, tbl, row_pos, row_len, out, B, KV, rep, W, \
                         page_size, n_lpages, scale, window, softcap, stream);
  switch (hd) {
    K1_CASE(16)
    K1_CASE(64)
    K1_CASE(128)
    K1_CASE(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef K1_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window; softcap
// <= 0 means no softcap. Returns the launch's cudaError_t (0 = success).
extern "C" int paged_mixed_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const int* page_tbl,
                                  const int* row_pos, const int* row_len,
                                  void* out, int B, int KV, int rep, int W,
                                  int hd, int page_size, int n_lpages,
                                  float scale, int window, float softcap,
                                  int dtype, void* stream) {
  if (page_size < 8 || (page_size & (page_size - 1))) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, page_tbl, row_pos, row_len,
                              out, B, KV, rep, W, page_size, n_lpages, scale,
                              window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, page_tbl, row_pos,
                                      row_len, out, B, KV, rep, W, page_size,
                                      n_lpages, scale, window, softcap, s);
  return int(cudaErrorInvalidValue);
}
