// Mamba2 SSD chunked scan on Hopper (sm_90a): the prefill scan of the SSD
// block, y and the final state from x, dt, a, b and c.
//
// Replaces the Pallas TPU kernel ssd_scan of src/repro/kernels/ssd_scan.py
// (body _ssd_kernel).
//
// Bound: at the serving shape, x (8,512,48,64) bf16, dt (8,512,48) f32,
// b and c (8,512,1,128) bf16, chunk 256, one call moves 65.8 MB (0.020 ms at
// 3.35 TB/s) and needs 16.1 GFLOP of products counted over the lower
// triangle of each chunk.  On the bf16 tensor cores that is 0.016 ms, so
// the bytes bound the function; this first kernel does every product in
// f32 on the CUDA cores (0.24 ms at 67 TFLOP/s), with operands read from
// shared memory, so it is bound by operations and far from both.  Tensor
// cores (wgmma over TMA-staged tiles) are later work.
//
// Design: one block of 256 threads per (batch, head), walking the chunks in
// order; the Pallas grid's sequential chunk axis becomes that loop.  The
// state h (P x N, f32) lives in shared memory for the whole sequence, the
// Pallas scratch h_ref, and goes to device memory once, as h_final.  Per
// chunk of Q steps:
//   1. dt of the chunk to shared memory; one thread takes the prefix sums
//      cs = cumsum(dt * a), the running sum in double, each prefix rounded
//      to f32, as the wrapper's plain version does (the products dt * a
//      are f32, rounded, as there);
//   2. for each tile of 64 rows i: C of those rows staged (f32), then for
//      each tile of 64 columns j <= the rows' last: B and x of the columns
//      staged, scores S = (C . B^T) * exp(cs_i - cs_j) * dt_j with exp taken
//      only where i >= j (above the diagonal cs_i - cs_j > 0 and exp could
//      overflow; a 0/1 mask would make inf * 0 = NaN), S staged, y += S . x;
//      then y += exp(cs_i) * (C . h^T) with h from before this chunk, and y
//      rounded to x's dtype and stored;
//   3. after every row tile has read h (a barrier), the update
//      h = exp(cs_last) * h + sum_q x_q * exp(cs_last - cs_q) * dt_q (x) B_q,
//      its sum in registers over tiles of 64 steps.
// Every product tile is 64 x 64 (or 64 x P), one 4 x 4 micro-tile a thread:
// rows ty + 16 r, columns tx + 16 c, so that the shared-memory reads of a
// warp hit distinct banks or broadcast.  Head hi reads b and c of group
// hi / (H / G): they are never repeated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTile = 64;  // rows and columns of a product tile
constexpr int kMaxStateCols = 8;  // N / 16 for N up to 128
constexpr int kLdS = kTile + 16;  // score-tile row stride: rows ty, ty + 1 of a warp fall 16 banks apart
constexpr int kMaxSmem = 232448;  // what a block may opt into on Hopper

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// rows [r0, r0 + rows) of a (rows x cols) slice of global memory, one row
// every `stride` elements, into shared memory as f32 with row stride ld;
// rows past `rows` up to kTile are zero.  `scale`, when given, multiplies
// row r by scale[r].
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t stride, int rows,
                                      int cols, const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kTile * cols; e += kThreads) {
    const int r = e / cols;
    const int k = e - r * cols;
    float v = 0.f;
    if (r < rows) {
      v = to_f32(src[r * stride + k]);
      if (scale != nullptr) v = __fmul_rn(v, scale[r]);
    }
    dst[r * ld + k] = v;
  }
}

// One block per (batch, head).  NP = P / 16 columns of y per thread.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ h_final,
                    int seq, int heads, int groups, int n, int chunk) {
  constexpr int P = NP * 16;
  constexpr int kLdX = P + 1;
  const int ldn = n + 1;  // odd row stride for the (rows x N) tiles: columns tx + 16 c hit distinct banks
  const int nq = n / 16;
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x - bi * heads;
  const int gi = hi / (heads / groups);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* hs = smem;  // P x ldn, the state
  float* cs = hs + P * ldn;  // chunk prefix sums
  float* dts = cs + chunk;  // chunk dt
  float* cs_tile = dts + chunk;  // kTile x ldn: C of the row tile
  float* bs_tile = cs_tile + kTile * ldn;  // kTile x ldn: B of the column tile
  float* xs_tile = bs_tile + kTile * ldn;  // kTile x kLdX: x of the column tile
  float* s_tile = xs_tile + kTile * kLdX;  // kTile x kLdS: scores

  for (int e = threadIdx.x; e < P * ldn; e += kThreads) hs[e] = 0.f;
  const float a_h = a[hi];
  const int64_t x_stride = static_cast<int64_t>(heads) * P;  // between steps
  const int64_t bc_stride = static_cast<int64_t>(groups) * n;
  const T* x_bh = x + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  T* y_bh = y + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  const float* dt_bh = dt + static_cast<int64_t>(bi) * seq * heads + hi;
  const T* b_bg = bm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;
  const T* c_bg = cm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    // 1. dt and the prefix sums of dt * a
    for (int i = threadIdx.x; i < chunk; i += kThreads)
      dts[i] = dt_bh[static_cast<int64_t>(c0 + i) * heads];
    __syncthreads();
    if (threadIdx.x == 0) {
      double run = 0.0;
      for (int i = 0; i < chunk; ++i) {
        run += static_cast<double>(__fmul_rn(dts[i], a_h));
        cs[i] = static_cast<float>(run);
      }
    }
    __syncthreads();
    const float cs_last = cs[chunk - 1];

    // 2. y, row tile by row tile
    for (int i0 = 0; i0 < chunk; i0 += kTile) {
      const int rows = min(kTile, chunk - i0);
      stage(cs_tile, ldn, c_bg + (c0 + i0) * bc_stride, bc_stride, rows, n);
      float acc[4][NP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NP; ++c) acc[r][c] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int cols = min(kTile, chunk - j0);
        stage(bs_tile, ldn, b_bg + (c0 + j0) * bc_stride, bc_stride, cols, n);
        stage(xs_tile, kLdX, x_bh + (c0 + j0) * x_stride, x_stride, cols, P);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cr[4], bc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = cs_tile[(ty + 16 * r) * ldn + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = bs_tile[(tx + 16 * c) * ldn + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cr[r], bc[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float v = 0.f;
            if (i >= j && i < chunk) v = __fmul_rn(__fmul_rn(s[r][c], expf(cs[i] - cs[j])), dts[j]);
            s_tile[(ty + 16 * r) * kLdS + tx + 16 * c] = v;
          }
        }
        __syncthreads();
        for (int j = 0; j < cols; ++j) {
          float sr[4], xv[NP];
#pragma unroll
          for (int r = 0; r < 4; ++r) sr[r] = s_tile[(ty + 16 * r) * kLdS + j];
#pragma unroll
          for (int c = 0; c < NP; ++c) xv[c] = xs_tile[j * kLdX + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NP; ++c) acc[r][c] = fmaf(sr[r], xv[c], acc[r][c]);
        }
        __syncthreads();  // the column tiles are restaged next
      }

      // the carried state's part, from h before this chunk's update
      float pre[4][NP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NP; ++c) pre[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cr[4], hv[NP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs_tile[(ty + 16 * r) * ldn + k];
#pragma unroll
        for (int c = 0; c < NP; ++c) hv[c] = hs[(tx + 16 * c) * ldn + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NP; ++c) pre[r][c] = fmaf(cr[r], hv[c], pre[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < rows) {
          const float decay = expf(cs[i0 + i]);
          T* yrow = y_bh + (c0 + i0 + i) * x_stride;
#pragma unroll
          for (int c = 0; c < NP; ++c) store(yrow + tx + 16 * c, acc[r][c] + __fmul_rn(decay, pre[r][c]));
        }
      }
      __syncthreads();  // C of the next row tile is staged over this one's
    }

    // 3. the state update: h = exp(cs_last) * h + (x * w)^T . B over the chunk
    float upd[NP][kMaxStateCols];
#pragma unroll
    for (int r = 0; r < NP; ++r)
#pragma unroll
      for (int c = 0; c < kMaxStateCols; ++c) upd[r][c] = 0.f;
    for (int q0 = 0; q0 < chunk; q0 += kTile) {
      const int steps = min(kTile, chunk - q0);
      // w_q = exp(cs_last - cs_q) * dt_q, into the s_tile's first row
      for (int q = threadIdx.x; q < steps; q += kThreads)
        s_tile[q] = __fmul_rn(expf(cs_last - cs[q0 + q]), dts[q0 + q]);
      __syncthreads();
      stage(bs_tile, ldn, b_bg + (c0 + q0) * bc_stride, bc_stride, steps, n);
      stage(xs_tile, kLdX, x_bh + (c0 + q0) * x_stride, x_stride, steps, P, s_tile);
      __syncthreads();
      for (int q = 0; q < steps; ++q) {
        float xv[NP], bv[kMaxStateCols];
#pragma unroll
        for (int r = 0; r < NP; ++r) xv[r] = xs_tile[q * kLdX + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < kMaxStateCols; ++c) bv[c] = c < nq ? bs_tile[q * ldn + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < NP; ++r)
#pragma unroll
          for (int c = 0; c < kMaxStateCols; ++c) upd[r][c] = fmaf(xv[r], bv[c], upd[r][c]);
      }
      __syncthreads();
    }
    const float keep = expf(cs_last);
#pragma unroll
    for (int r = 0; r < NP; ++r)
#pragma unroll
      for (int c = 0; c < kMaxStateCols; ++c)
        if (c < nq) {
          float* hp = hs + (ty + 16 * r) * ldn + tx + 16 * c;
          *hp = __fmul_rn(*hp, keep) + upd[r][c];
        }
    __syncthreads();
  }

  float* hf = h_final + (static_cast<int64_t>(bi) * heads + hi) * P * n;
  for (int e = threadIdx.x; e < P * n; e += kThreads) {
    const int p = e / n;
    hf[e] = hs[p * ldn + (e - p * n)];
  }
}

size_t smem_bytes(int p, int n, int chunk) {
  const size_t ldn = n + 1;
  return sizeof(float) * (p * ldn + 2 * static_cast<size_t>(chunk) + 2 * kTile * ldn +
                          kTile * (p + 1) + kTile * kLdS);
}

template <typename T, int NP>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
                   void* y, void* h_final, int bsz, int seq, int heads, int groups, int n,
                   int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP * 16, n, chunk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, NP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bsz * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(h_final), seq, heads, groups, n, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, const void* dt, const void* a, const void* b, const void* c,
                     void* y, void* h_final, int bsz, int seq, int heads, int p, int groups, int n,
                     int chunk, cudaStream_t s) {
  switch (p) {
    case 16: return launch<T, 1>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 32: return launch<T, 2>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 48: return launch<T, 3>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 64: return launch<T, 4>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, b, c and y alike; dt, a and h_final
// are f32).  x and y (B, L, H, P), dt (B, L, H), a (H,), b and c (B, L, G, N),
// h_final (B, H, P, N), all contiguous.  P is 16, 32, 48 or 64; N a multiple
// of 16 up to 128; H % G == 0; L % chunk == 0.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, void* y, void* h_final, int dtype, int bsz, int seq,
                          int heads, int p, int groups, int n, int chunk, void* stream) {
  if (groups <= 0 || heads % groups || chunk <= 0 || seq % chunk || n % 16 ||
      n / 16 > kMaxStateCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<__nv_bfloat16>(x, dt, a, b, c, y, h_final, bsz, seq, heads, p, groups, n, chunk, s);
  if (dtype == 1)
    return launch_p<float>(x, dt, a, b, c, y, h_final, bsz, seq, heads, p, groups, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
