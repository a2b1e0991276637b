// Decode tail of the image path on Hopper (sm_90a): crop -> horizontal flip
// -> dequant -> per-channel normalize -> NCHW, in one pass over the frame.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dequant_normalize.py:
//   dequant_normalize_augment (body _dequant_augment_kernel), and
//   dequant_normalize (body _dequant_kernel), which is this kernel with no
//   crop and no flip (params == nullptr).
//
// Bound: bytes.  Per output element the kernel reads one input value and
// writes one bf16 (or f32) value after three float operations, far below
// the card's ~295 operations per byte, so its floor is
// (N*oh*ow*C input bytes + N*C*oh*ow*sizeof(out)) / 3.35 TB/s.  Reaching it
// takes wide memory operations and enough bytes in flight on every SM.
//
// Design: a block owns up to kMaxRows output rows of one sample.
//   1. Stage.  A row's crop span, bytes left*C .. (left+ow)*C of its source
//      row, is contiguous.  Rounded out to 16-byte words, every word of every
//      span of the block goes to shared memory by one 16-byte cp.async, all
//      issued before the block waits once.  A word that would reach before
//      x's first byte or past its last is copied byte by byte instead, only
//      the span's own bytes, so nothing outside the tensor is read.
//   2. Write.  A thread takes VEC neighbouring output pixels of one row (8
//      for bf16, 4 for f32, one 16-byte store either way), reads their C
//      interleaved values out of shared memory (reversed under the flip) and
//      writes each plane's VEC values with one 16-byte store, so a warp
//      writes 512 contiguous bytes of each plane.  Rows whose width is not a
//      multiple of VEC are written element by element.
//   mean_c and 1/std_c are computed once per block into shared memory.  The
//   crop is clamped here, as lax.dynamic_slice clamps it; the flip is any
//   nonzero value.  The grid is one-dimensional, (N * ceil(oh / rows)).
//
// The TPU kernel moved one (H, W) plane per grid step through VMEM.  One
// thread per output pixel with 1-byte loads, the direct translation, keeps
// about 6 KB of loads in flight an SM and reaches 30% of the memory rate.
//
// Arithmetic follows the Pallas body bit for bit: x * scale (1/255 for
// uint8, 1 for f32) then (y - mean_c) * (1 / std_c), all in f32 with
// round-to-nearest intrinsics so nvcc cannot contract them into an FMA
// that rounds once instead of twice.  bf16 output rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;                // output rows a block owns
constexpr int kRowBudget = 48 * 1024;       // shared bytes the rows are cut to fit
constexpr int kMaxShared = 227 * 1024;      // one wide row may take up to this

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename Out> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };
template <> struct Vec<float> { static constexpr int kN = 4; };

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads) dn_rows(
    const In* __restrict__ x,            // (n, h, w, c)
    const float* __restrict__ mean,      // (c,)
    const float* __restrict__ stdev,     // (c,)
    const int32_t* __restrict__ params,  // (n, 3): flip, top, left, unclamped; nullptr = none
    Out* __restrict__ out,               // (n, c, oh, ow)
    int h, int w, int c, int oh, int ow, int rows, int tiles, int stride, int stats,
    int64_t x_bytes, float scale) {
  constexpr int V = Vec<Out>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_mean = reinterpret_cast<float*>(smem);
  float* s_inv = s_mean + c;
  unsigned char* staged = smem + stats;  // row r's words at staged + r * stride

  const int n = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - n * tiles) * rows;
  const int nrows = min(rows, oh - y0);
  int flip = 0, top = 0, left = 0;
  if (params != nullptr) {
    flip = params[3 * n] != 0;
    top = min(max(params[3 * n + 1], 0), h - oh);
    left = min(max(params[3 * n + 2], 0), w - ow);
  }
  const uintptr_t lo = reinterpret_cast<uintptr_t>(x), hi = lo + x_bytes;
  const int span = ow * c * static_cast<int>(sizeof(In));
  const uintptr_t first0 =
      lo + ((static_cast<int64_t>(n) * h + top + y0) * w + left) * c * static_cast<int64_t>(sizeof(In));
  const int64_t pitch = static_cast<int64_t>(w) * c * sizeof(In);

  // 1. every word of every span, all in flight before the one wait
  const int words = stride / 16;
  for (int i = threadIdx.x; i < nrows * words; i += kThreads) {
    const int r = i / words, k = i - r * words;
    const uintptr_t first = first0 + r * pitch, end = first + span;
    const uintptr_t a = (first & ~uintptr_t(15)) + 16 * k;
    if (a >= end) continue;
    unsigned char* dst = staged + r * stride + 16 * k;
    if (a >= lo && a + 16 <= hi) {
      cp_async16(smem_addr(dst), reinterpret_cast<const void*>(a));
    } else {
      const uintptr_t from = a > first ? a : first, to = a + 16 < end ? a + 16 : end;
      for (uintptr_t b = from; b < to; ++b) dst[b - a] = *reinterpret_cast<const unsigned char*>(b);
    }
  }
  cp_async_commit();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    s_mean[ch] = mean[ch];
    s_inv[ch] = __fdiv_rn(1.0f, stdev[ch]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. VEC pixels of a row a thread, one 16-byte store per plane
  const int groups = (ow + V - 1) / V;
  const bool whole = ow % V == 0;
  const int64_t plane = static_cast<int64_t>(oh) * ow;
  for (int i = threadIdx.x; i < nrows * groups; i += kThreads) {
    const int r = i / groups, x0 = (i - r * groups) * V;
    const In* row = reinterpret_cast<const In*>(staged + r * stride + ((first0 + r * pitch) & 15));
    Out* dst = out + static_cast<int64_t>(n) * c * plane + static_cast<int64_t>(y0 + r) * ow + x0;
    for (int ch = 0; ch < c; ++ch, dst += plane) {
      const float m = s_mean[ch], inv = s_inv[ch];
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ox = min(x0 + j, ow - 1);  // past the row's end: computed, never stored
        const int sx = flip ? ow - 1 - ox : ox;  // the mirror is taken inside the window
        v[j] = __fmul_rn(__fsub_rn(__fmul_rn(to_f32(row[sx * c + ch]), scale), m), inv);
      }
      if (whole) {
        store16(dst, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (x0 + j < ow) store(dst + j, v[j]);
      }
    }
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const float* mean, const float* stdev, const int32_t* params,
                   void* out, int n, int h, int w, int c, int oh, int ow, float scale,
                   cudaStream_t stream) {
  const int span = ow * c * static_cast<int>(sizeof(In));
  const int stride = (span + 30) / 16 * 16;  // the most words a span rounded out to 16 bytes touches
  const int stats = (2 * c * 4 + 15) / 16 * 16;
  const int rows = max(1, min(min(kMaxRows, oh), (kRowBudget - stats) / stride));
  const int64_t shared = stats + static_cast<int64_t>(rows) * stride;
  const int tiles = (oh + rows - 1) / rows;
  const int64_t blocks = static_cast<int64_t>(n) * tiles;
  if (shared > kMaxShared || blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto kernel = dn_rows<In, Out>;
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const int64_t x_bytes = static_cast<int64_t>(n) * h * w * c * sizeof(In);
  kernel<<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(
      static_cast<const In*>(x), mean, stdev, params, static_cast<Out*>(out), h, w, c, oh, ow, rows,
      tiles, stride, stats, x_bytes, scale);
  return cudaGetLastError();
}

}  // namespace

// in_kind: 0 = uint8, 1 = float32.  out_kind: 0 = bfloat16, 1 = float32.
// params: (n, 3) int32 rows of (flip, top, left) as drawn, on the card; the
// kernel clamps them.  With params_host (pinned) they are first copied there
// on the same stream, and with done that event is recorded after the
// launch, so the caller knows when both buffers are free again.  The launch
// runs on `device`, whatever the calling thread's current device is.
// Returns the first failing call's cudaError_t (0 = launched).
extern "C" int dn_launch(const void* x, int in_kind, const float* mean, const float* stdev,
                         int32_t* params, const int32_t* params_host, void* out, int out_kind,
                         int n, int h, int w, int c, int oh, int ow, float scale, int device,
                         void* stream, void* done) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params_host != nullptr)
    err = cudaMemcpyAsync(params, params_host, sizeof(int32_t) * 3 * n, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    if (in_kind == 0 && out_kind == 0)
      err = launch<uint8_t, __nv_bfloat16>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
    else if (in_kind == 0 && out_kind == 1)
      err = launch<uint8_t, float>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
    else if (in_kind == 1 && out_kind == 0)
      err = launch<float, __nv_bfloat16>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
    else if (in_kind == 1 && out_kind == 1)
      err = launch<float, float>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
    else
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess && done != nullptr) err = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return static_cast<int>(err);
}

// An event on `device` for dn_launch's `done` (nullptr if it cannot be made).
extern "C" void* dn_event_create(int device) {
  int prev = device;
  if (cudaGetDevice(&prev) != cudaSuccess || (prev != device && cudaSetDevice(device) != cudaSuccess))
    return nullptr;
  cudaEvent_t event = nullptr;
  if (cudaEventCreateWithFlags(&event, cudaEventDisableTiming) != cudaSuccess) event = nullptr;
  if (prev != device) cudaSetDevice(prev);
  return event;
}

// Waits until the work before the event's last record has run (at once if
// it was never recorded).
extern "C" int dn_event_sync(void* event) {
  return static_cast<int>(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
