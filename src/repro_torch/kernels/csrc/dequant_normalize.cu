// Decode tail of the image path on Hopper (sm_90a): crop -> horizontal flip
// -> dequant -> per-channel normalize -> NCHW, in one pass over the frame.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dequant_normalize.py:
//   dequant_normalize_augment (body _dequant_augment_kernel), and
//   dequant_normalize (body _dequant_kernel), which is this kernel with no
//   crop and no flip (params == nullptr).
//
// Bound: bytes.  Per output element the kernel reads one input value and
// writes one bf16 (or f32) value after four float operations, far below
// the card's ~295 operations per byte, so its floor is
// (N*oh*ow*C input bytes + N*C*oh*ow*sizeof(out)) / 3.35 TB/s.
//
// Design: one thread per output pixel (n, y, x), n on blockIdx.z.  A thread
// reads the C interleaved values of its source pixel and writes one value
// into each of the C output planes, so each warp's stores are contiguous
// along x in every plane.  The TPU kernel ran one (H, W) plane per grid
// step out of VMEM; here there is no staging, because every input byte is
// read exactly once and L1/L2 absorb the 3-byte stride between neighbours.
//
// Arithmetic follows the Pallas body bit for bit: x * scale (1/255 for
// uint8, 1 for f32) then (y - mean_c) * (1 / std_c), all in f32 with
// round-to-nearest intrinsics so nvcc cannot contract them into an FMA
// that rounds once instead of twice.  bf16 output rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename In, typename Out>
__global__ void dequant_normalize_augment_kernel(
    const In* __restrict__ x,            // (n, h, w, c)
    const float* __restrict__ mean,      // (c,)
    const float* __restrict__ stdev,     // (c,)
    const int32_t* __restrict__ params,  // (n, 3): flip, top, left; nullptr = none
    Out* __restrict__ out,               // (n, c, oh, ow)
    int h, int w, int c, int oh, int ow, float scale) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (ox >= ow || oy >= oh) return;
  int flip = 0, top = 0, left = 0;
  if (params != nullptr) {
    flip = params[3 * n];
    top = params[3 * n + 1];
    left = params[3 * n + 2];
  }
  // the mirror is taken inside the cropped window
  const int sx = left + (flip != 0 ? ow - 1 - ox : ox);
  const In* src = x + ((static_cast<int64_t>(n) * h + top + oy) * w + sx) * c;
  const int64_t plane = static_cast<int64_t>(oh) * ow;
  Out* dst = out + static_cast<int64_t>(n) * c * plane + static_cast<int64_t>(oy) * ow + ox;
  for (int ch = 0; ch < c; ++ch) {
    const float y = __fmul_rn(to_f32(src[ch]), scale);
    const float inv_std = __fdiv_rn(1.0f, stdev[ch]);
    store(dst + ch * plane, __fmul_rn(__fsub_rn(y, mean[ch]), inv_std));
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const float* mean, const float* stdev, const int32_t* params,
                   void* out, int n, int h, int w, int c, int oh, int ow, float scale,
                   cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y, n);
  dequant_normalize_augment_kernel<In, Out><<<grid, block, 0, stream>>>(
      static_cast<const In*>(x), mean, stdev, params, static_cast<Out*>(out), h, w, c, oh, ow,
      scale);
  return cudaGetLastError();
}

}  // namespace

// in_kind: 0 = uint8, 1 = float32.  out_kind: 0 = bfloat16, 1 = float32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int dn_launch(const void* x, int in_kind, const float* mean, const float* stdev,
                         const int32_t* params, void* out, int out_kind, int n, int h, int w,
                         int c, int oh, int ow, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 0 && out_kind == 0)
    return launch<uint8_t, __nv_bfloat16>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
  if (in_kind == 0 && out_kind == 1)
    return launch<uint8_t, float>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
  if (in_kind == 1 && out_kind == 0)
    return launch<float, __nv_bfloat16>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
  if (in_kind == 1 && out_kind == 1)
    return launch<float, float>(x, mean, stdev, params, out, n, h, w, c, oh, ow, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
