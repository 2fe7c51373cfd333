// K3: flash attention forward over explicit positions, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call), and with it the padding wrapper kernels/ops.py::attention:
// ragged S and T are masked here instead of padded to 128-multiples, and the
// head dim is not padded to 128 lanes. Unlike the Pallas kernel it takes the
// query and key POSITIONS, the semantics of the JAX model's full-sequence
// path (models/attention.py::_chunked_attention / _chunk_mask), so one kernel
// serves a whole-prompt prefill, a bucketed prefill (padded keys carry -1)
// and the partial prefill's [prefix ++ suffix] keys.
//
// Semantics (the plain version is kernels/flash_attention.py::flash_attention_ref):
//   q (B, H, S, hd), k / v (B, KV, T, hd), H = KV * rep, qpos (S,), kpos (T,)
//   int32. Key t is attended by query s iff kpos[t] >= 0, (causal == 0 or
//   kpos[t] <= qpos[s]) and (window == 0 or qpos[s] - kpos[t] < window).
//   Scores are scale * q.k, then softcap * tanh(s / softcap) when softcap > 0.
//   Scores, softmax statistics and the output accumulator are float32 (the
//   Pallas kernel's rule). A query with no attended key is written as zeros.
//
// What bounds it on an H100: a causal prefill of S tokens does
// 4 * hd * H * S(S+1)/2 flops on (2 * H + 2 * KV) * S * hd elements, about
// S/2 flops a byte in bf16 at GQA 32/8: above the ridge (~295) from S ~ 600
// on, so a Llama admission at S = 2048 is bound by tensor-core operations
// and one at S = 512 by device-memory bytes. The design: one block per
// (query tile, kv head, batch row), so a K/V tile is staged in shared memory
// once for all rep query heads of its kv head (the query tile's rows are
// (position, head) pairs); a loop over key tiles inside the block replaces
// the TPU's sequential k grid and its VMEM scratch; a key tile no row of the
// block can attend (past the causal edge, before the window, all padding)
// is skipped before its K/V are read. bf16 runs QK^T and PV on the tensor
// cores with mma.sync m16n8k16 (float32 accumulators; fragments by
// ldmatrix), softmax statistics and the output accumulator in registers
// (the FlashAttention-2 layout), and streams K/V tiles through a two-stage
// cp.async ring; the probability tile is rounded to bf16 for PV. float32
// (the tiny configs) runs on CUDA cores. No wgmma/TMA yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

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

__device__ __forceinline__ bool key_ok(int qp, int kp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Least and greatest query position of the block's valid rows (positions
// s0 .. s0+nq-1): a key tile is live iff some key of it is attended by some
// position in [qmin, qmax].
__device__ __forceinline__ void query_range(const int* __restrict__ qpos, int s0,
                                            int nq, int* qmin, int* qmax) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    const int p = qpos[s0 + i];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  *qmin = lo;
  *qmax = hi;
}

__device__ __forceinline__ bool tile_key_live(int kp, int qmin, int qmax,
                                              int causal, int window) {
  return kp >= 0 && (!causal || kp <= qmax) && (window <= 0 || qmin - kp < window);
}

// ---------------------------------------------------------------- bf16 ----
// Tensor cores: 4 warps x 16 rows = 64 (position, head) rows a block; each
// warp owns 16 rows and all BK keys of a tile. Fragment layouts of
// mma.sync.m16n8k16 (g = lane / 4, t = lane % 4): A regs {row g, cols 2t..},
// {row g+8, cols 2t..}, {row g, cols 2t+8..}, {row g+8, cols 2t+8..}; B regs
// {k rows 2t.., col g}, {k rows 2t+8.., col g}; C {row g, cols 2t, 2t+1},
// {row g+8, cols 2t, 2t+1}. Q, K and V stay row-major in shared memory;
// ldmatrix builds the fragments (.trans for V, whose k index is the key).
// K/V tiles arrive by cp.async into a two-stage ring: the next live tile
// is in flight while the current one is computed.

template <int HD> struct GeoB {
  static constexpr int R = NWARPS * 16;               // rows a block
  static constexpr int BK = HD >= 256 ? 32 : 64;      // keys a tile
  static constexpr int LD = HD + 8;                   // bf16 elements a row
  static constexpr size_t SMEM =
      2 * size_t(LD) * (R + 4 * BK) + 4 * 2 * size_t(BK);
};

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each, (row l / 4, cols 2(l % 4), +1) -- of the
// transposed matrix with .trans.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, bool pred) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// First key tile at or after t0 that some row of the block attends (T when
// none); thread tid < BK returns that tile's kpos[tid] in *kp. Block-wide:
// every thread must call it.
template <int BK>
__device__ __forceinline__ int next_live_tile(const int* __restrict__ kpos,
                                              int t0, int T, int qmin, int qmax,
                                              int causal, int window, int* kp) {
  const int tid = threadIdx.x;
  for (; t0 < T; t0 += BK) {
    *kp = (tid < BK && t0 + tid < T) ? kpos[t0 + tid] : -1;
    if (__syncthreads_or(tid < BK &&
                         tile_key_live(*kp, qmin, qmax, causal, window)))
      return t0;
  }
  return T;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ qpos, const int* __restrict__ kpos,
                  __nv_bfloat16* __restrict__ out, int H, int KV, int S, int T,
                  float scale, int causal, int window, float softcap) {
  using G = GeoB<HD>;
  constexpr int BK = G::BK, LD = G::LD;
  constexpr int NT = BK / 8;                          // score n-tiles
  constexpr int NO = HD / 8;                          // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // [R][LD]
  __nv_bfloat16* sK = sQ + G::R * LD;                 // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * BK * LD;               // [2][BK][LD]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * BK * LD);          // [2][BK]

  const int rep = H / KV;
  const int bq = G::R / rep;                          // positions a block
  const int b = blockIdx.z, g = blockIdx.y;
  const int s0 = blockIdx.x * bq;
  const int nq = min(bq, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const size_t kv_base = (size_t(b) * KV + g) * T * HD;

  // stage the query tile: row r = (position s0 + r / rep, head g*rep + r % rep)
  for (int idx = tid; idx < G::R * (HD / 8); idx += NTHREADS) {
    const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const int sl = r / rep, hr = r % rep;
    const bool in = sl < nq;
    cp_async16(sQ + r * LD + d,
               in ? q + ((size_t(b) * H + g * rep + hr) * S + s0 + sl) * HD + d
                  : q, in);
  }
  int qmin, qmax;
  query_range(qpos, s0, nq, &qmin, &qmax);

  // this thread's two rows: rA = warp*16 + gr, rB = rA + 8
  int rq[2];
  bool rv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sl = (warp * 16 + gr + 8 * h) / rep;
    rv[h] = sl < nq;
    rq[h] = rv[h] ? qpos[s0 + sl] : 0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // issue the cp.async copies of key tile t0 into ring stage st
  auto issue = [&](int t0, int st, int kp) {
    for (int idx = tid; idx < BK * (HD / 8); idx += NTHREADS) {
      const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
      const bool in = t0 + j < T;
      const size_t off = kv_base + size_t(t0 + j) * HD + d;
      cp_async16(sK + (st * BK + j) * LD + d, in ? k + off : k, in);
      cp_async16(sV + (st * BK + j) * LD + d, in ? v + off : v, in);
    }
    if (tid < BK) sKpos[st * BK + tid] = kp;
  };

  // ldmatrix row addresses of this lane (see ldsm_x4)
  const int mat = lane / 8, mrow = lane % 8;
  const __nv_bfloat16* qa = sQ + (warp * 16 + (mat & 1) * 8 + mrow) * LD + (mat >> 1) * 8;
  const int ka_row = (mat >> 1) * 8 + mrow, ka_col = (mat & 1) * 8;   // K: B of QK^T
  const int va_row = (mat & 1) * 8 + mrow, va_col = (mat >> 1) * 8;   // V: B of PV

  int kp;
  int t_cur = next_live_tile<BK>(kpos, 0, T, qmin, qmax, causal, window, &kp);
  if (t_cur < T) issue(t_cur, 0, kp);
  cp_async_commit();                          // the Q tile (+ first K/V tile)
  int st = 0;
  while (t_cur < T) {
    const int t_next = next_live_tile<BK>(kpos, t_cur + BK, T, qmin, qmax,
                                          causal, window, &kp);
    if (t_next < T) issue(t_next, st ^ 1, kp);
    cp_async_commit();
    cp_async_wait_prev();                     // this thread's copies of t_cur
    __syncthreads();                          // ... and everyone else's
    const __nv_bfloat16* sKs = sK + st * BK * LD;
    const __nv_bfloat16* sVs = sV + st * BK * LD;
    const int* kps = sKpos + st * BK;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4];                       // n-tiles n and n + 1
        ldsm_x4(bk, sKs + (n * 8 + ka_row) * LD + kk + ka_col);
        mma_bf16(sc[n], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma_bf16(sc[n + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }

    // mask, softcap, online softmax over this thread's two rows
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, j = n * 8 + 2 * tq + (e & 1);
        float x = sc[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = rv[h] && key_ok(rq[h], kps[j], causal, window) ? x : -INFINITY;
        sc[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // m_new == -inf: nothing attended yet; p = 0 below, state unchanged
      corr[h] = m_new == -INFINITY ? 1.f : expf(m[h] - m_new);
      m[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = m[h] == -INFINITY ? 0.f : expf(sc[n][e] - m[h]);
        sc[n][e] = p;
        ps[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];   // quad-partial
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the score accumulators become the A fragments in registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];                       // n-tiles n and n + 1
        ldsm_x4_t(bv, sVs + (kk * 16 + va_row) * LD + n * 8 + va_col);
        mma_bf16(o[n], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[n + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    __syncthreads();                          // stage st free for reuse
    st ^= 1;
    t_cur = t_next;
  }
  cp_async_wait_all();                        // none left in flight at exit

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rv[h]) continue;
    const int r = warp * 16 + gr + 8 * h;
    const int sl = r / rep, hr = r % rep;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    __nv_bfloat16* orow = out + ((size_t(b) * H + g * rep + hr) * S + s0 + sl) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
}

// ----------------------------------------------------------------- f32 ----
// CUDA cores, the layout of K1 (csrc/paged_attention.cu): RW rows a warp,
// keys spread over the lanes for QK^T, head dims over the lanes for PV.

template <int HD> struct GeoF {
  static constexpr int RW = HD >= 256 ? 8 : 16;
  static constexpr int QT = NWARPS * RW;              // rows a block
  static constexpr int KT = HD >= 256 ? 32 : 64;      // keys a tile
  static constexpr int KPL = KT / 32;                 // keys per lane
  static constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // head dims per lane
  static constexpr int KSTR = KT + 1;                 // padded row of sKt
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(QT) * HD + size_t(HD) * KSTR + size_t(KT) * HD +
                       size_t(QT) * KT) + sizeof(int) * KT;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ out, int H,
                 int KV, int S, int T, float scale, int causal, int window,
                 float softcap) {
  using G = GeoF<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [QT][HD]
  float* sKt = sQ + G::QT * HD;                // [HD][KSTR]  (K transposed)
  float* sV = sKt + HD * G::KSTR;              // [KT][HD]
  float* sP = sV + G::KT * HD;                 // [QT][KT]
  int* sKpos = reinterpret_cast<int*>(sP + G::QT * G::KT);

  const int rep = H / KV;
  const int bq = G::QT / rep;
  const int b = blockIdx.z, g = blockIdx.y;
  const int s0 = blockIdx.x * bq;
  const int nq = min(bq, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t kv_base = (size_t(b) * KV + g) * T * HD;

  for (int idx = tid; idx < G::QT * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD, sl = r / rep, hr = r % rep;
    sQ[idx] = sl < nq ? q[((size_t(b) * H + g * rep + hr) * S + s0 + sl) * HD + d]
                      : 0.f;
  }
  int qmin, qmax;
  query_range(qpos, s0, nq, &qmin, &qmax);

  int rq[G::RW];
  bool rv[G::RW];
  float m[G::RW], l[G::RW], acc[G::RW][G::DPL];
#pragma unroll
  for (int i = 0; i < G::RW; ++i) {
    const int sl = (warp * G::RW + i) / rep;
    rv[i] = sl < nq;
    rq[i] = rv[i] ? qpos[s0 + sl] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < G::DPL; ++e) acc[i][e] = 0.f;
  }

  float* sPw = sP + warp * G::RW * G::KT;
  const float* sQw = sQ + warp * G::RW * HD;
  for (int t0 = 0; t0 < T; t0 += G::KT) {
    __syncthreads();                        // previous tile fully consumed
    bool live = false;
    if (tid < G::KT) {
      const int kp = t0 + tid < T ? kpos[t0 + tid] : -1;
      sKpos[tid] = kp;
      live = tile_key_live(kp, qmin, qmax, causal, window);
    }
    if (!__syncthreads_or(live)) continue;
    for (int idx = tid; idx < G::KT * HD; idx += NTHREADS) {
      const int j = idx / HD, d = idx % HD;
      const bool in = t0 + j < T;
      sKt[d * G::KSTR + j] = in ? k[kv_base + size_t(t0 + j) * HD + d] : 0.f;
      sV[idx] = in ? v[kv_base + size_t(t0 + j) * HD + d] : 0.f;
    }
    __syncthreads();

    float s[G::RW][G::KPL];
#pragma unroll
    for (int i = 0; i < G::RW; ++i)
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) s[i][c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kv[G::KPL];
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) kv[c] = sKt[d * G::KSTR + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < G::RW; ++i) {
        const float qv = sQw[i * HD + d];
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) s[i][c] = fmaf(qv, kv[c], s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < G::RW; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < G::KPL; ++c) {
        const int j = lane + 32 * c;
        float x = s[i][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = rv[i] && key_ok(rq[i], sKpos[j], causal, window) ? x : -INFINITY;
        s[i][c] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = warp_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      if (m_new == -INFINITY) {               // nothing attended yet
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) sPw[i * G::KT + lane + 32 * c] = 0.f;
      } else {
        const float corr = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < G::KPL; ++c) {
          const float p = expf(s[i][c] - m_new);
          psum += p;
          sPw[i * G::KT + lane + 32 * c] = p;
        }
        l[i] = l[i] * corr + warp_sum(psum);
#pragma unroll
        for (int e = 0; e < G::DPL; ++e) acc[i][e] *= corr;
        m[i] = m_new;
      }
    }
    __syncwarp();
    for (int j = 0; j < G::KT; ++j) {
      float vv[G::DPL];
#pragma unroll
      for (int e = 0; e < G::DPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < HD ? sV[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < G::RW; ++i) {
        const float p = sPw[i * G::KT + j];
#pragma unroll
        for (int e = 0; e < G::DPL; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < G::RW; ++i) {
    if (!rv[i]) continue;
    const int r = warp * G::RW + i, sl = r / rep, hr = r % rep;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = out + ((size_t(b) * H + g * rep + hr) * S + s0 + sl) * HD;
#pragma unroll
    for (int e = 0; e < G::DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) orow[d] = acc[i][e] * inv;
    }
  }
}

// ---------------------------------------------------------------- launch ----

template <typename Kern>
int set_smem(Kern kern, size_t bytes, bool* done) {
  if (*done) return 0;                      // opt in above 48 KB once
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  *done = true;
  return 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int B, int H, int KV, int S, int T,
           float scale, int causal, int window, float softcap, int dtype,
           cudaStream_t stream) {
  const int rep = H / KV;
  if (dtype == 1) {
    using G = GeoB<HD>;
    static bool smem_set = false;
    if (int err = set_smem(flash_bf16_kernel<HD>, G::SMEM, &smem_set)) return err;
    const int bq = G::R / rep;
    dim3 grid((S + bq - 1) / bq, KV, B);
    flash_bf16_kernel<HD><<<grid, NTHREADS, G::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qpos, kpos,
        static_cast<__nv_bfloat16*>(out), H, KV, S, T, scale, causal, window,
        softcap);
  } else {
    using G = GeoF<HD>;
    static bool smem_set = false;
    if (int err = set_smem(flash_f32_kernel<HD>, G::SMEM, &smem_set)) return err;
    const int bq = G::QT / rep;
    dim3 grid((S + bq - 1) / bq, KV, B);
    flash_f32_kernel<HD><<<grid, NTHREADS, G::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qpos, kpos, static_cast<float*>(out), H,
        KV, S, T, scale, causal, window, softcap);
  }
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1. window <= 0 means no
// window; softcap <= 0 means no softcap. rep = H / KV must divide H and be
// at most the rows of a block (32 for float32 at hd = 256, else 64); q, k,
// v, out contiguous and, for bfloat16, 16-byte aligned. Returns the launch's
// cudaError_t (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* qpos, const int* kpos, void* out,
                                      int B, int H, int KV, int S, int T, int hd,
                                      float scale, int causal, int window,
                                      float softcap, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T <= 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int rep = H / KV;
  if (rep > (dtype == 0 && hd >= 256 ? 32 : 64)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_CASE(HD)                                                           \
  case HD:                                                                  \
    return launch<HD>(q, k, v, qpos, kpos, out, B, H, KV, S, T, scale, causal, \
                      window, softcap, dtype, s);
  switch (hd) {
    K3_CASE(16)
    K3_CASE(32)
    K3_CASE(64)
    K3_CASE(128)
    K3_CASE(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef K3_CASE
}
