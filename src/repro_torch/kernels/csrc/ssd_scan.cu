// Mamba2 SSD chunked scan on Hopper (sm_90a): the prefill scan of the SSD
// block, y and the final state from x, dt, a, b and c.
//
// Replaces the Pallas TPU kernel ssd_scan of src/repro/kernels/ssd_scan.py
// (body _ssd_kernel).  Per chunk of Q steps, in f32, with the state h (P x N)
// carried from chunk to chunk:
//   cs = cumsum(dt * a);  L = where(i >= j, exp(cs_i - cs_j), 0)
//   y  = ((C . B^T) * L * dt_j) . x + exp(cs_i) * (C . h^T)   (h before the update)
//   h <- exp(cs_last) * h + (x * exp(cs_last - cs) * dt)^T . B
// y rounded to x's dtype once per chunk; h_final f32.
//
// Bound: at the serving shape, x (8,512,48,64) bf16, dt (8,512,48) f32,
// b and c (8,512,1,128) bf16, chunk 256, one call moves 65.8 MB (0.020 ms at
// 3.35 TB/s) and needs 16.1 GFLOP of products counted over the lower
// triangle of each chunk: 0.016 ms on the bf16 tensor cores, 0.24 ms on the
// f32 CUDA cores.  So the bytes bound it, once the products run on the
// tensor cores.
//
// Two kernels, routed by dtype (x, b and c alike):
//
// ssd_tc_bf16 (bf16): the products on the tensor cores.
//   - One block of 16 warps per (batch, head), walking the chunks in order
//     (the Pallas grid's sequential chunk axis); head hi reads b and c of
//     group hi / (H / G) in place.  A chunk of up to 256 steps lies in
//     shared memory whole, x, B and C as bf16 (never widened), with the
//     state h in f32 (the Pallas scratch h_ref), which reaches device
//     memory once, as h_final: 215 KB at P 64, N 128, chunk 256, one block
//     (16 warps) an SM where the f32 kernel's 138 KB held 8 warps.  Warp w
//     owns rows 16w .. 16w + 15; rows past the chunk are zero-filled and
//     never stored, so any chunk up to 256 runs (a 20-step prompt scans
//     with chunk 4).
//   - Loads are 16-byte cp.async.  B and x of a chunk are in flight while
//     the chunk's prefix sums are taken; each warp loads the next chunk's C
//     rows, which only it reads, as soon as its own products are done, so
//     they arrive during the state update.  Inside a chunk the products
//     need no block barrier: a warp runs on as far as its rows reach.
//   - All four products are mma.sync.m16n8k16, bf16 operands from ldmatrix
//     and f32 accumulators.  C . B^T is exact (bf16 operands).  Its
//     accumulator is scaled in registers by exp(cs_i - cs_j) * dt_j (exp as
//     ex2.approx, 2 ulp), the exp taken only where i >= j: above the
//     diagonal cs_i - cs_j > 0 may overflow, and inf * 0 is NaN.  16-column
//     groups wholly above a warp's rows are neither multiplied nor fed to
//     S . x.  The f32 operands meet the tensor cores as sums of bf16 pieces:
//     S (the A operand of S . x, straight from the accumulator, which has
//     the A layout) as hi + lo; h (the B operand of C . h^T, split as it is
//     read from shared memory) as hi + lo; x * w of the state update (f32,
//     x bf16 times w = exp(cs_last - cs) * dt) as hi + mid + lo, so that
//     h_final holds the f32 bar with room (two pieces leave up to 2^-16 of
//     each term, a fifth of the bar on tests/test_torch_ssd_scan.py's CPU
//     rehearsal at the serving shape).
//   - The prefix sums cs are a warp-parallel scan in double (each lane a run
//     of steps, then a shuffle scan of the lanes' sums), each prefix rounded
//     to f32; the terms dt * a are f32 products, rounded, as in the
//     wrapper's plain version.
//   - The state update runs on warps 0-7, whose rows have the fewest
//     scores: each holds 16 x 16 blocks of h (all four blocks of one 16-row
//     slice of h at P 64, N 128) in registers over the chunk.  h is rewritten
//     after a barrier that every warp reaches once its C . h^T is done.

// ssd_cuda_f32 (f32): the first design, every product on the f32 CUDA
//   cores from shared memory (the tensor cores' TF32 cannot hold the f32
//   bar).  One block of 256 threads per (batch, head), walking the chunks
//   in order, h in shared memory.  Per chunk:
//   1. dt of the chunk to shared memory; one thread takes the prefix sums
//      cs = cumsum(dt * a), the running sum in double, each prefix rounded
//      to f32 (the products dt * a are f32, rounded);
//   2. for each tile of 64 rows i: C of those rows staged, then for each
//      tile of 64 columns j <= the rows' last: B and x of the columns
//      staged, scores S = (C . B^T) * exp(cs_i - cs_j) * dt_j with exp taken
//      only where i >= j, S staged, y += S . x; then y += exp(cs_i) * (C .
//      h^T) with h from before this chunk, and y stored;
//   3. after every row tile has read h (a barrier), the update
//      h = exp(cs_last) * h + sum_q x_q * exp(cs_last - cs_q) * dt_q (x) B_q,
//      its sum in registers over tiles of 64 steps.
//   Every product tile is 64 x 64 (or 64 x P), one 4 x 4 micro-tile a
//   thread: rows ty + 16 r, columns tx + 16 c, so that the shared-memory
//   reads of a warp hit distinct banks or broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxStateCols = 8;  // N / 16 for N up to 128
constexpr int kMaxSmem = 232448;  // what a block may opt into on Hopper

// ---------------------------------------------------------------------------
// ssd_tc_bf16: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 16;  // 16 rows of the chunk each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = kWarps * 16;  // the chunk lies in shared memory whole
constexpr int kHalf = 64;  // score columns in registers at a time
constexpr int kPad = 8;  // bf16 after each staged row (16 bytes)
constexpr int kHPad = 8;  // f32 after each row of h
constexpr int kMaxK = kMaxStateCols;
constexpr int kUpdWarps = 8;  // warps 0-7, whose rows have the fewest scores, update the state
constexpr int kMaxUnits = 4;  // 16 x 16 blocks of h a warp updates: (64 / 16) * (128 / 16) / kUpdWarps
constexpr int kXwPieces = 3;  // bf16 pieces of x * w in the state update

// (a, b) as hi + lo, each a pair of bf16 packed for a fragment.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

// exp(x) as 2**(x log2(e)) on the SFU (ex2.approx, 2 ulp; a subnormal
// result flushes to 0).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// rows [r0, r1) of a (rows x cols) bf16 slice of global memory, row r at
// src + r * stride, into shared memory with row stride ld; rows from
// `valid` on are zero-filled and not read.  Threads tid, tid + step, ...
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           int64_t stride, int r0, int r1, int valid, int cols,
                                           int tid, int step) {
  const int row_chunks = cols / 8;
  for (int e = tid; e < (r1 - r0) * row_chunks; e += step) {
    const int r = r0 + e / row_chunks;
    const int col = (e % row_chunks) * 8;
    const bool in = r < valid;
    cp_async16_zfill(smem_addr(dst + r * ld + col), in ? src + r * stride + col : src, in ? 16 : 0);
  }
}

// One block of 16 warps per (batch, head).  NP = P / 16.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_tc_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm, __nv_bfloat16* __restrict__ y,
                float* __restrict__ h_final, int seq, int heads, int groups, int n, int chunk) {
  constexpr int P = NP * 16;
  constexpr int LDX = P + kPad;
  const int nk = n / 16;
  const int ldb = n + kPad;
  const int ldh = n + kHPad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x - bi * heads;
  const int gi = hi / (heads / groups);
  const int rows16 = (chunk + 15) & ~15;  // staged rows of a chunk

  extern __shared__ uint4 smem_u4[];
  float* hs = reinterpret_cast<float*>(smem_u4);  // P x ldh, the state
  const int chunk4 = (chunk + 3) & ~3;
  float* cs = hs + P * ldh;  // prefix sums of dt * a
  float* dts = cs + chunk4;  // dt
  float* ws = dts + chunk4;  // exp(cs_last - cs) * dt
  float* ecs = ws + chunk4;  // exp(cs)
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(ecs + chunk4);  // rows16 x ldb
  __nv_bfloat16* b_s = c_s + rows16 * ldb;  // rows16 x ldb
  __nv_bfloat16* x_s = b_s + rows16 * ldb;  // rows16 x LDX

  const float a_h = a[hi];
  const int64_t x_stride = static_cast<int64_t>(heads) * P;  // between steps
  const int64_t bc_stride = static_cast<int64_t>(groups) * n;
  const __nv_bfloat16* x_bh = x + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  __nv_bfloat16* y_bh = y + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  const float* dt_bh = dt + static_cast<int64_t>(bi) * seq * heads + hi;
  const __nv_bfloat16* b_bg = bm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;
  const __nv_bfloat16* c_bg = cm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;

  // This warp's rows of the chunk and, for warps 0-7, its blocks of the
  // state update: u = warp * units + k covers rows 16 (u / nk) .. of h and
  // columns 16 (u % nk) ..
  const int first = warp * 16;
  const bool live = first < chunk;
  const int r0 = first + g, r1 = r0 + 8;  // this thread's rows
  const int units = (NP * nk + kUpdWarps - 1) / kUpdWarps;

  for (int e = threadIdx.x; e < P * ldh; e += kThreads) hs[e] = 0.f;
  stage_rows(c_s, ldb, c_bg, bc_stride, 0, rows16, chunk, n, threadIdx.x, kThreads);

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    // 1. B and x of the chunk in flight (C is: the first chunk's above, the
    //    others' from each warp at the end of its rows' products)
    const int64_t step0 = static_cast<int64_t>(c0);
    stage_rows(b_s, ldb, b_bg + step0 * bc_stride, bc_stride, 0, rows16, chunk, n, threadIdx.x, kThreads);
    stage_rows(x_s, LDX, x_bh + step0 * x_stride, x_stride, 0, rows16, chunk, P, threadIdx.x, kThreads);
    cp_async_commit();
    //    meanwhile dt and the prefix sums of dt * a: warp 0, each lane a run
    //    of steps summed in double, then a scan of the lanes' sums
    for (int q = threadIdx.x; q < chunk; q += kThreads) dts[q] = dt_bh[(step0 + q) * heads];
    __syncthreads();
    if (warp == 0) {
      const int per = (chunk + 31) / 32;
      const int q0 = min(chunk, lane * per);
      const int q1 = min(chunk, q0 + per);
      double own = 0.0;
      for (int q = q0; q < q1; ++q) own += static_cast<double>(__fmul_rn(dts[q], a_h));
      double run = own;
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += up;
      }
      run -= own;  // the sum of the lanes before this one
      for (int q = q0; q < q1; ++q) {
        run += static_cast<double>(__fmul_rn(dts[q], a_h));
        cs[q] = static_cast<float>(run);
      }
    }
    __syncthreads();
    const float cs_last = cs[chunk - 1];
    for (int q = threadIdx.x; q < chunk; q += kThreads) {
      ws[q] = __fmul_rn(expf(cs_last - cs[q]), dts[q]);
      ecs[q] = expf(cs[q]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // 2. y of the warp's rows: exp(cs_i) * (C . h^T), h as hi + lo, then
    //    S . x over the columns up to the warp's last row
    if (live) {
      const float cs_r0 = r0 < chunk ? cs[r0] : 0.f;
      const float cs_r1 = r1 < chunk ? cs[r1] : 0.f;
      const uint32_t c_row = smem_addr(c_s + (first + lane % 16) * ldb + (lane / 16) * 8);  // C's A fragments
      float yacc[2 * NP][4];
#pragma unroll
      for (int nb = 0; nb < 2 * NP; ++nb) yacc[nb][0] = yacc[nb][1] = yacc[nb][2] = yacc[nb][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t cf[4];
        ldmatrix_x4(cf, c_row + kk * 32);
#pragma unroll
        for (int nb = 0; nb < 2 * NP; ++nb) {
          const float* hrow = hs + (nb * 8 + g) * ldh + kk * 16 + 2 * t4;
          const float2 v0 = *reinterpret_cast<const float2*>(hrow);
          const float2 v1 = *reinterpret_cast<const float2*>(hrow + 8);
          uint32_t b0h, b0l, b1h, b1l;
          split2(v0.x, v0.y, b0h, b0l);
          split2(v1.x, v1.y, b1h, b1l);
          mma(yacc[nb], cf, b0h, b1h);
          mma(yacc[nb], cf, b0l, b1l);
        }
      }
      const float e0 = r0 < chunk ? ecs[r0] : 0.f;
      const float e1 = r1 < chunk ? ecs[r1] : 0.f;
#pragma unroll
      for (int nb = 0; nb < 2 * NP; ++nb) {
        yacc[nb][0] = __fmul_rn(yacc[nb][0], e0);
        yacc[nb][1] = __fmul_rn(yacc[nb][1], e0);
        yacc[nb][2] = __fmul_rn(yacc[nb][2], e1);
        yacc[nb][3] = __fmul_rn(yacc[nb][3], e1);
      }

      for (int cb = 0; cb <= first; cb += kHalf) {  // the columns cb .. cb + 63
        // 16-column groups that reach the warp's last row
        const int groups16 = min(kHalf / 16, (first - cb) / 16 + 1);
        float s[kHalf / 8][4];
#pragma unroll
        for (int nb = 0; nb < kHalf / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        // S = C . B^T
#pragma unroll 1
        for (int kk = 0; kk < nk; ++kk) {
          uint32_t cf[4];
          ldmatrix_x4(cf, c_row + kk * 32);
#pragma unroll
          for (int np = 0; np < kHalf / 16; ++np) {
            if (np >= groups16) break;
            uint32_t bf[4];
            const int col = cb + np * 16 + lane % 8 + (lane / 16) * 8;
            ldmatrix_x4(bf, smem_addr(b_s + col * ldb + kk * 16 + ((lane / 8) % 2) * 8));
            mma(s[2 * np], cf, bf[0], bf[1]);
            mma(s[2 * np + 1], cf, bf[2], bf[3]);
          }
        }
        // S * exp(cs_i - cs_j) * dt_j where i >= j, else 0 (exp is not
        // taken above the diagonal, where it may overflow)
#pragma unroll
        for (int nb = 0; nb < kHalf / 8; ++nb) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int col = cb + nb * 8 + 2 * t4 + h2;
            const float cs_j = cs[col];
            const float dt_j = dts[col];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int row = rr ? r1 : r0;
              float& v = s[nb][2 * rr + h2];
              v = row >= col && row < chunk ? v * exp_approx((rr ? cs_r1 : cs_r0) - cs_j) * dt_j : 0.f;
            }
          }
        }
        // y += S . x, S as hi + lo against the same x fragments
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          if (kk >= groups16) break;
          uint32_t ah[4], al[4];
          split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
          split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
          split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
          split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int dp = 0; dp < NP; ++dp) {
            uint32_t bf[4];
            const int step = cb + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
            ldmatrix_x4_trans(bf, smem_addr(x_s + step * LDX + dp * 16 + (lane / 16) * 8));
            mma(yacc[2 * dp], ah, bf[0], bf[1]);
            mma(yacc[2 * dp + 1], ah, bf[2], bf[3]);
            mma(yacc[2 * dp], al, bf[0], bf[1]);
            mma(yacc[2 * dp + 1], al, bf[2], bf[3]);
          }
        }
      }

      // y rounded to bf16 once; rows past the chunk are not stored
#pragma unroll
      for (int nb = 0; nb < 2 * NP; ++nb) {
        const int col = nb * 8 + 2 * t4;
        if (r0 < chunk)
          *reinterpret_cast<__nv_bfloat162*>(y_bh + (c0 + r0) * x_stride + col) =
              __floats2bfloat162_rn(yacc[nb][0], yacc[nb][1]);
        if (r1 < chunk)
          *reinterpret_cast<__nv_bfloat162*>(y_bh + (c0 + r1) * x_stride + col) =
              __floats2bfloat162_rn(yacc[nb][2], yacc[nb][3]);
      }
      // only this warp reads its rows of C: the next chunk's go in now
      __syncwarp();
      if (c0 + chunk < seq)
        stage_rows(c_s, ldb, c_bg + (step0 + chunk) * bc_stride, bc_stride, first, min(first + 16, rows16),
                   chunk, n, lane, 32);
    }

    // 3. the state update, upd = (x * w)^T . B over the chunk, x * w as
    //    kXwPieces bf16 pieces; then, once every warp has read h,
    //    h = exp(cs_last) * h + upd
    float acc[kMaxUnits][2][4];
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k)
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) acc[k][hb][0] = acc[k][hb][1] = acc[k][hb][2] = acc[k][hb][3] = 0.f;
    if (warp < kUpdWarps) {
#pragma unroll 1
      for (int q0 = 0; q0 < chunk; q0 += 16) {
        const int qa = q0 + 2 * t4;
        const float w0 = qa < chunk ? ws[qa] : 0.f;
        const float w1 = qa + 1 < chunk ? ws[qa + 1] : 0.f;
        const float w8 = qa + 8 < chunk ? ws[qa + 8] : 0.f;
        const float w9 = qa + 9 < chunk ? ws[qa + 9] : 0.f;
        uint32_t ap[kXwPieces][4];  // pieces of (x * w)^T for m-tile mt_a
        int mt_a = -1;
#pragma unroll
        for (int k = 0; k < kMaxUnits; ++k) {
          const int u = warp * units + k;
          if (k >= units || u >= NP * nk) break;
          const int mt = u / nk;  // rows 16 mt .. of h
          const int grp = u - mt * nk;  // columns 16 grp .. of h
          if (mt != mt_a) {
            mt_a = mt;
            uint32_t xa[4];  // x^T: rows p of the m-tile, k = steps
            const int step = q0 + lane % 8 + (lane / 16) * 8;
            ldmatrix_x4_trans(xa, smem_addr(x_s + step * LDX + mt * 16 + ((lane / 8) % 2) * 8));
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 xv = unpack_bf16(xa[r]);
              float v0 = __fmul_rn(xv.x, r < 2 ? w0 : w8);
              float v1 = __fmul_rn(xv.y, r < 2 ? w1 : w9);
#pragma unroll
              for (int pc = 0; pc < kXwPieces; ++pc) {
                ap[pc][r] = pack_bf16(v0, v1);
                const float2 got = unpack_bf16(ap[pc][r]);
                v0 -= got.x;
                v1 -= got.y;
              }
            }
          }
          uint32_t bf[4];
          const int brow = q0 + lane % 8 + ((lane / 8) % 2) * 8;
          ldmatrix_x4_trans(bf, smem_addr(b_s + brow * ldb + grp * 16 + (lane / 16) * 8));
#pragma unroll
          for (int pc = 0; pc < kXwPieces; ++pc) {
            mma(acc[k][0], ap[pc], bf[0], bf[1]);
            mma(acc[k][1], ap[pc], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp has read h
    if (warp < kUpdWarps) {
      const float keep = expf(cs_last);
#pragma unroll
      for (int k = 0; k < kMaxUnits; ++k) {
        const int u = warp * units + k;
        if (k >= units || u >= NP * nk) break;
        const int mt = u / nk;
        const int grp = u - mt * nk;
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int col = grp * 16 + hb * 8 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* hp = reinterpret_cast<float2*>(hs + (mt * 16 + g + 8 * half) * ldh + col);
            float2 v = *hp;
            v.x = __fadd_rn(__fmul_rn(v.x, keep), acc[k][hb][2 * half]);
            v.y = __fadd_rn(__fmul_rn(v.y, keep), acc[k][hb][2 * half + 1]);
            *hp = v;
          }
        }
      }
    }
    __syncthreads();  // h, B, x and the chunk's sums are rewritten next
  }

  float* hf = h_final + (static_cast<int64_t>(bi) * heads + hi) * P * n;
  for (int e = threadIdx.x; e < P * n; e += kThreads) {
    const int p = e / n;
    hf[e] = hs[p * ldh + (e - p * n)];
  }
}

size_t smem_bytes(int p, int n, int chunk) {
  const size_t chunk4 = (static_cast<size_t>(chunk) + 3) & ~static_cast<size_t>(3);
  const size_t rows16 = (static_cast<size_t>(chunk) + 15) & ~static_cast<size_t>(15);
  return sizeof(float) * (static_cast<size_t>(p) * (n + kHPad) + 4 * chunk4) +
         sizeof(__nv_bfloat16) * rows16 * (2 * (n + kPad) + p + kPad);
}

template <int NP>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
                   void* y, void* h_final, int bsz, int seq, int heads, int groups, int n,
                   int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP * 16, n, chunk);
  if (chunk > kMaxChunk || smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_tc_bf16<NP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bsz * heads, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_final), seq, heads, groups, n, chunk);
  return cudaGetLastError();
}

cudaError_t launch_p(const void* x, const void* dt, const void* a, const void* b, const void* c,
                     void* y, void* h_final, int bsz, int seq, int heads, int p, int groups, int n,
                     int chunk, cudaStream_t s) {
  switch (p) {
    case 16: return launch<1>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 32: return launch<2>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 48: return launch<3>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 64: return launch<4>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// ssd_cuda_f32: f32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTile = 64;  // rows and columns of a product tile
constexpr int kLdS = kTile + 16;  // score-tile row stride: rows ty, ty + 1 of a warp fall 16 banks apart

// rows [r0, r0 + rows) of a (rows x cols) slice of global memory, one row
// every `stride` elements, into shared memory with row stride ld;
// rows past `rows` up to kTile are zero.  `scale`, when given, multiplies
// row r by scale[r].
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int64_t stride, int rows,
                                      int cols, const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kTile * cols; e += kThreads) {
    const int r = e / cols;
    const int k = e - r * cols;
    float v = 0.f;
    if (r < rows) {
      v = src[r * stride + k];
      if (scale != nullptr) v = __fmul_rn(v, scale[r]);
    }
    dst[r * ld + k] = v;
  }
}

// One block per (batch, head).  NP = P / 16 columns of y per thread.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_cuda_f32(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y, float* __restrict__ h_final,
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
  const float* x_bh = x + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  float* y_bh = y + static_cast<int64_t>(bi) * seq * x_stride + static_cast<int64_t>(hi) * P;
  const float* dt_bh = dt + static_cast<int64_t>(bi) * seq * heads + hi;
  const float* b_bg = bm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;
  const float* c_bg = cm + static_cast<int64_t>(bi) * seq * bc_stride + static_cast<int64_t>(gi) * n;

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
          float* yrow = y_bh + (c0 + i0 + i) * x_stride;
#pragma unroll
          for (int c = 0; c < NP; ++c) yrow[tx + 16 * c] = acc[r][c] + __fmul_rn(decay, pre[r][c]);
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

template <int NP>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
                   void* y, void* h_final, int bsz, int seq, int heads, int groups, int n,
                   int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP * 16, n, chunk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_cuda_f32<NP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bsz * heads, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(h_final), seq, heads, groups, n, chunk);
  return cudaGetLastError();
}

cudaError_t launch_p(const void* x, const void* dt, const void* a, const void* b, const void* c,
                     void* y, void* h_final, int bsz, int seq, int heads, int p, int groups, int n,
                     int chunk, cudaStream_t s) {
  switch (p) {
    case 16: return launch<1>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 32: return launch<2>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 48: return launch<3>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 64: return launch<4>(x, dt, a, b, c, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

}  // namespace

// dtype 0 = bfloat16: ssd_tc_bf16; 1 = float32: ssd_cuda_f32 (x, b, c and y
// alike; dt, a and h_final are f32).  x and y (B, L, H, P), dt (B, L, H),
// a (H,), b and c (B, L, G, N), h_final (B, H, P, N), all contiguous, x, b
// and c 16-byte aligned.  P is 16, 32, 48 or 64; N a multiple of 16 up to
// 128; H % G == 0; L % chunk == 0; chunk up to 256 in bf16, any in f32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, void* y, void* h_final, int dtype, int bsz, int seq,
                          int heads, int p, int groups, int n, int chunk, void* stream) {
  if (groups <= 0 || heads % groups || chunk <= 0 || seq % chunk || n <= 0 || n % 16 ||
      n / 16 > kMaxStateCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tc::launch_p(x, dt, a, b, c, y, h_final, bsz, seq, heads, p, groups, n, chunk, s);
  if (dtype == 1) return f32::launch_p(x, dt, a, b, c, y, h_final, bsz, seq, heads, p, groups, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
