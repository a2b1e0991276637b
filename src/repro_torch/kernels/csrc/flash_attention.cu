// Attention forward on Hopper (sm_90a): causal or non-causal, GQA, q
// right-aligned to kv, online softmax over key tiles with f32 m, l and acc.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (body _flash_kernel).
//
// Bound: bytes at the serving shapes.  One call reads q, k and v once and
// writes o once; at q (8,16,512,128), k and v (8,8,512,128) in bf16 that is
// 50 MB, 0.015 ms at 3.35 TB/s, against ~8.6 GFLOP of causal work, 0.009 ms
// on the bf16 tensor cores.  This first kernel does its products on the
// f32 CUDA cores, out of shared memory, so it is far from that bound; the
// tensor-core version (wgmma over TMA-staged tiles) is later work.
//
// Design: one block per (b, head, 8 query rows), one warp per query row.
// The block stages keys in chunks of 64 rows, widened to f32, in shared
// memory that every row of the block reuses.  A key tile is the wrapper's
// block_k, as in the Pallas grid, and the softmax keeps its semantics:
//   pass 1: each lane takes whole keys and writes s = (q . k) * sm_scale,
//           NEG_INF (-2**30, finite) where k > q's position, to the row's
//           score buffer; the warp takes the tile's max;
//   then:   m_new = max(m, tile max), corr = exp(m - m_new),
//           p = exp(s - m_new), l = l * corr + sum(p), and p is rounded
//           to v's dtype (bf16 here) before it meets v, as in the body;
//   pass 2: each lane owns hd/32 consecutive output dims and accumulates
//           pv = sum_k p_k v_k in f32; acc = acc * corr + pv.
// The output is acc / max(l, 1e-20), rounded to q's dtype.  The tile loop
// stops at the last tile the block's last row admits; keys past a row's
// position have p == 0 exactly, so a row can skip them in pass 2 and a
// tile that is all masked for a row leaves its m, l and acc unchanged, just
// as the Pallas body's skipped blocks do.  Blocks run the heaviest query
// tiles (the last ones, under the causal mask) first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // query rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // keys staged in shared memory at a time
constexpr int kPad = 4;  // floats after each staged row: float4 reads by lane = key hit distinct banks
constexpr float kNegInf = -1073741824.0f;  // -2**30, the body's NEG_INF

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// p as v's dtype would hold it: the body's p.astype(v.dtype)
__device__ __forceinline__ float in_dtype(float p, const float*) { return p; }
__device__ __forceinline__ float in_dtype(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) { *o = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy n rows of hd contiguous elements into shared memory as f32, one
// row every `stride` floats.  hd is a multiple of 4 and src 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, int hd, int stride) {
  const int quads = hd / 4;
  for (int i = threadIdx.x; i < n * quads; i += kThreads) {
    const int r = i / quads;
    const int c = (i - r * quads) * 4;
    *reinterpret_cast<float4*>(dst + r * stride + c) = load4(src + static_cast<int64_t>(r) * hd + c);
  }
}

template <typename T, int NPL>  // NPL = output dims per lane = hd / 32
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // (b, h, sq, hd)
    const T* __restrict__ k,  // (b, hkv, skv, hd)
    const T* __restrict__ v,  // (b, hkv, skv, hd)
    T* __restrict__ o,        // (b, h, sq, hd)
    int h, int hkv, int sq, int skv, int block_k, int chunk, float sm_scale, int causal) {
  constexpr int HD = NPL * 32;
  constexpr int KV_STRIDE = HD + kPad;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (kWarps, HD)
  float* sp = qs + kWarps * HD;                 // (kWarps, block_k): s, then p
  float* kv = sp + kWarps * block_k;            // (chunk, KV_STRIDE): K, then V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWarps;
  const int q_rows = min(kWarps, sq - q0);
  const int row = q0 + warp;
  const bool live = warp < q_rows;
  const int q_offset = skv - sq;
  const int pos = row + q_offset;  // the row's position among the keys
  const int last_pos = q0 + q_rows - 1 + q_offset;

  const int64_t q_base = (static_cast<int64_t>(b) * h + head) * sq * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + kvh) * skv * HD;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  stage(qs, q + q_base + static_cast<int64_t>(q0) * HD, q_rows, HD, HD);
  const float* my_q = qs + warp * HD;
  float* my_s = sp + warp * block_k;

  const int n_tiles_all = skv / block_k;
  const int n_tiles = causal ? min(n_tiles_all, last_pos / block_k + 1) : n_tiles_all;

  float m = kNegInf, l = 0.f;
  float acc[NPL], pv[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k_tile = t * block_k;
    __syncwarp();
    // pass 1: scores of the tile
    float local_max = kNegInf;
    for (int c = 0; c < block_k; c += chunk) {
      const bool needed = !causal || k_tile + c <= last_pos;  // uniform over the block
      if (needed) {
        __syncthreads();  // the previous chunk's readers are done (q staged, the first time)
        stage(kv, kb + static_cast<int64_t>(k_tile + c) * HD, chunk, HD, KV_STRIDE);
        __syncthreads();
      }
      if (!live) continue;
      for (int j = lane; j < chunk; j += 32) {
        const int key = k_tile + c + j;
        float s = kNegInf;
        if (!causal || key <= pos) {
          const float* kr = kv + j * KV_STRIDE;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(my_q + d);
            const float4 x = *reinterpret_cast<const float4*>(kr + d);
            dot = fmaf(a.x, x.x, dot);
            dot = fmaf(a.y, x.y, dot);
            dot = fmaf(a.z, x.z, dot);
            dot = fmaf(a.w, x.w, dot);
          }
          s = dot * sm_scale;
        }
        my_s[c + j] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    // the tile's softmax step
    float corr = 1.f;
    if (live) {
      __syncwarp();
      const float m_new = fmaxf(m, warp_max(local_max));
      corr = expf(m - m_new);
      float local_sum = 0.f;
      for (int j = lane; j < block_k; j += 32) {
        const float p = expf(my_s[j] - m_new);
        local_sum += p;
        my_s[j] = in_dtype(p, v);
      }
      l = l * corr + warp_sum(local_sum);
      m = m_new;
      __syncwarp();
    }
    // pass 2: p . v
#pragma unroll
    for (int i = 0; i < NPL; ++i) pv[i] = 0.f;
    for (int c = 0; c < block_k; c += chunk) {
      if (causal && k_tile + c > last_pos) break;  // uniform over the block
      __syncthreads();
      stage(kv, vb + static_cast<int64_t>(k_tile + c) * HD, chunk, HD, KV_STRIDE);
      __syncthreads();
      if (!live) continue;
      const int n = causal ? min(chunk, pos - (k_tile + c) + 1) : chunk;
      for (int j = 0; j < n; ++j) {
        const float p = my_s[c + j];
        const float* vr = kv + j * KV_STRIDE + lane * NPL;
#pragma unroll
        for (int i = 0; i < NPL; ++i) pv[i] = fmaf(p, vr[i], pv[i]);
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = acc[i] * corr + pv[i];
    }
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-20f);
  T* orow = o + q_base + static_cast<int64_t>(row) * HD + lane * NPL;
#pragma unroll
  for (int i = 0; i < NPL; ++i) store(orow + i, acc[i] / denom);
}

template <typename T, int NPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h, int hkv,
                   int sq, int skv, int block_k, float sm_scale, int causal, cudaStream_t stream) {
  const int hd = NPL * 32;
  const int chunk = block_k % kChunk == 0 ? kChunk : block_k;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kWarps) * hd + static_cast<size_t>(kWarps) * block_k +
                       static_cast<size_t>(chunk) * (hd + kPad));
  auto kernel = flash_attention_kernel<T, NPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kWarps - 1) / kWarps, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, hkv, sq, skv, block_k, chunk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int b, int h, int hkv,
                      int sq, int skv, int hd, int block_k, float sm_scale, int causal,
                      cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 1>(q, k, v, o, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 64: return launch<T, 2>(q, k, v, o, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 128: return launch<T, 4>(q, k, v, o, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 256: return launch<T, 8>(q, k, v, o, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and o alike).  hd is one of
// 32, 64, 128, 256; h % hkv == 0; sq <= skv when causal; skv % block_k == 0.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o, int dtype, int b,
                         int h, int hkv, int sq, int skv, int hd, int block_k, float sm_scale,
                         int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<__nv_bfloat16>(q, k, v, o, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
  if (dtype == 1)
    return launch_hd<float>(q, k, v, o, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
