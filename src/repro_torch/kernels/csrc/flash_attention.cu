// Attention forward on Hopper (sm_90a): causal or non-causal, GQA, q
// right-aligned to kv, online softmax over key tiles with f32 m, l and acc.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (body _flash_kernel, called at :88).
//
// Bound.  One call reads q, k and v once and writes o once, and does 4 hd
// operations for each (query, key) pair the mask keeps.  At the serving
// shapes it is bytes: q (8,16,512,128) and k, v (8,8,512,128) in bf16 are
// 50.3 MB, 0.0150 ms at 3.35 TB/s, against 8.61 GFLOP of causal work,
// 0.0087 ms on the bf16 tensor cores.  At 32k keys it is operations: q
// (4,16,32768,128) over k, v (4,8,32768,128) is 17.6 TFLOP, 17.79 ms at
// 989 TFLOP/s.  So the products run on the tensor cores at Hopper's own
// rate (wgmma), the exponentials on the SFU stay off their path, and each
// K and V tile is read from device memory once per 128 query rows.
//
// Two kernels, routed by dtype:
//
// fa_wgmma_bf16 (bf16 q, k, v): a producer warp feeding wgmma by TMA.
//   - A block of 3 warpgroups owns 128 query rows of one (batch, head): two
//     consumer warpgroups of 64 rows each, and a producer warpgroup of which
//     one thread issues every copy (setmaxnreg gives its registers to the
//     consumers: 40 against 232 a thread).  The kv head is head / (H / Hkv),
//     read in place.  Blocks run the heaviest causal query tiles first.
//   - Q (128 rows), then each softmax step's K and V tiles, arrive by TMA
//     (rank-3 tensor maps (b*h or b*hkv, s, hd), so a box past sq fills with
//     zeros inside its own head) in a ring of shared-memory slots, one tile
//     a slot, with a full and an empty mbarrier each.  The producer loads
//     K, then V, of each step in the order the consumers use them; under
//     the index mask it loads no step above the block's diagonal.  The
//     position route loads every step.
//   - Tiles are stored as TMA swizzles them, 128 bytes a row (a panel of 64
//     columns; hd 128 is two panels, hd 192 three); hd 32's 64-byte rows
//     take the 64-byte swizzle.  See wgmma_bf16.cuh for the descriptors.
//   - S = Q.K^T is wgmma.m64nNk16 with both operands in shared memory, N
//     the stage's keys, f32 accumulators.  The softmax runs in the
//     consumer's registers.  O += P.V is wgmma.m64n<hd>k16 with P as the A
//     operand from registers, the S accumulator rounded to bf16 (exactly
//     the body's p.astype(v.dtype)), and V read as an MN-major B operand
//     straight from its tile: nothing is transposed by hand.
//   - What bounds it at length is keeping the tensor cores busy while the
//     SFU takes the exponentials (64 a thread a step).  So a warpgroup
//     issues step j's S and step j-1's P.V together and runs step j's
//     softmax while they are in flight (acc takes step j's rescaling just
//     before step j's P.V), and the two warpgroups take turns to issue
//     (named barriers), so that one's softmax overlaps the other's
//     products.  Between the first issue and the last wait nothing
//     branches on a lane: ptxas serializes wgmmas around a divergent path,
//     so the steady loop is straight-line and the first and last steps are
//     peeled.
//   - The softmax step is the wrapper's block_k, with the body's arithmetic
//     in f32: s = (q.k) * sm_scale, NEG_INF (-2**30, finite) above the
//     diagonal, m_new = max(m, max s) over all the step's keys, corr =
//     exp(m - m_new), p = exp(s - m_new), l = l * corr + sum(p), acc = acc
//     * corr + p_bf16 . v; exp(x) is ex2.approx(x * log2(e)) on the SFU (2
//     ulp), x * log2(e) - m * log2(e) taken as one fma.  A warpgroup
//     multiplies the steps up to its own diagonal and only empties the
//     slots of the block's later ones (their p is 0).  Output acc / max(l,
//     1e-20) in bf16, staged in the warpgroup's own rows of Q's tile in the
//     same swizzle and stored by TMA, which drops rows past sq.
//   - Shared memory, against the 232,448 bytes a block can use (1 KB of
//     alignment and the barriers besides; fa_wgmma_plan below exports it,
//     flash_attention.wgmma_plan reads it):
//       hd 32:  Q 8 KB,  stages of block_k keys, 4 slots of 4 / 8 KB;
//       hd 64:  Q 16 KB, stages of block_k keys, 4 slots of 8 / 16 KB;
//       hd 128: Q 32 KB, stages of block_k keys, 4 slots of 16 / 32 KB
//               (two K+V stages: 160 KB at block_k 128);
//       hd 192: Q 48 KB, stages of 64 keys, 6 slots of 24 KB (three K+V
//               stages, 192 KB; 128-key stages would take 240 KB), so a
//               block_k 128 softmax step spans two stages.
//     Registers: acc (hd / 2), the step's scores (block_k / 2) and the
//     previous step's p in bf16 (block_k / 4) a thread: 192 at hd 192,
//     within the 232, no spills.
//   - On the host, a launch takes its four tensor maps from a cache keyed
//     by address and shape (encoding them is a driver call), and sets the
//     shared-memory limit once an instance and device.
//
// Position mask (both kernels): with q_pos (b, sq) and kv_pos (b, skv), int32,
//   a key is kept iff q_pos >= kv_pos -- the reference's mask for rows that
//   pack documents restarting at 0, repeat or reverse positions -- instead
//   of by index.  It is a template flag (BY_POS), so the index route's code
//   is what it was.  Both kernels stage and score every key and mask each
//   score by its key's position (fa_wgmma_bf16 reads them from device
//   memory, L1, after the product; no block skips a step).  A row that sees no key at all (a
//   padded query row) then averages over every key, as the plain version
//   does; callers drop such rows.
//
// fa_cuda_f32 (f32 q, k, v): the first design, on the f32 CUDA cores (the
//   tensor cores' TF32 cannot hold the 2e-5 f32 bar).  One block per (b,
//   head, 8 query rows), one warp per row; keys staged 64 rows at a time
//   in shared memory; per block_k tile, pass 1 writes the row's scores and
//   takes their max, then the softmax step, then pass 2 accumulates p.v
//   with each lane owning hd/32 output dims.

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, the body's NEG_INF

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2**x on the SFU (ex2.approx, 2 ulp; a subnormal result flushes to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// fa_wgmma_bf16: bf16 on the tensor cores, wgmma over TMA-staged tiles
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kWgRows = 64;                        // query rows of a consumer warpgroup
constexpr int kConsumers = 2;                      // consumer warpgroups a block
constexpr int kRows = kConsumers * kWgRows;        // query rows a block
constexpr int kThreads = (kConsumers + 1) * 128;   // and the producer warpgroup
constexpr int kConsumerWarps = kConsumers * 4;     // arrivals that empty a slot
constexpr int kSmemMax = 232448;                   // what a block can use on an H100
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536

// The plan by head dim and block_k (fa_wgmma_plan exports it).
__host__ __device__ constexpr int stage_keys(int hd, int block_k) { return hd > 128 ? 64 : block_k; }
__host__ __device__ constexpr int ring_slots(int hd) { return hd > 128 ? 6 : 4; }
__host__ __device__ constexpr int panel_cols(int hd) { return hd < 64 ? hd : 64; }  // a 128-byte row (64 at hd 32)
__host__ __device__ constexpr int smem_bytes(int hd, int block_k) {
  return 1024 + kRows * hd * 2 + ring_slots(hd) * stage_keys(hd, block_k) * hd * 2 + 8 * (1 + 2 * ring_slots(hd));
}

template <int HD, int BK, bool BY_POS>  // BK = block_k, the softmax step; BY_POS: mask by q_pos >= kv_pos
__global__ void __launch_bounds__(kThreads, 1) fa_wgmma_bf16(
    const __grid_constant__ CUtensorMap q_map,  // q as (b*h, sq, hd), box (panel, kRows)
    const __grid_constant__ CUtensorMap k_map,  // k as (b*hkv, skv, hd), box (panel, stage keys)
    const __grid_constant__ CUtensorMap v_map,  // v alike
    const __grid_constant__ CUtensorMap o_map,  // o as q, box (panel, kWgRows)
    const int* __restrict__ qp,                 // (b, sq) when BY_POS
    const int* __restrict__ kp,                 // (b, skv) when BY_POS
    int h, int hkv, int sq, int skv, float sm_scale, int causal) {
  constexpr int SK = stage_keys(HD, BK);  // keys a stage
  constexpr int NST = BK / SK;            // stages a softmax step
  constexpr int SLOTS = ring_slots(HD);
  constexpr int PC = panel_cols(HD);
  constexpr int PANELS = HD / PC;
  constexpr int ROWB = PC * 2;            // bytes of a swizzled row
  constexpr uint32_t ATOM = 8 * ROWB;     // 8 rows: the descriptors' stride byte offset
  constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : 2;
  constexpr int Q_PANEL = kRows * ROWB;
  constexpr int T_PANEL = SK * ROWB;
  constexpr int TILE = SK * HD * 2;
  constexpr int QBYTES = kRows * HD * 2;
  constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2**(x log2(e))
  static_assert(smem_bytes(HD, BK) <= kSmemMax, "the shared-memory plan does not fit");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // swizzled tiles sit on 1024-byte boundaries
  uint8_t* const q_g = smem_raw + (q_s - raw);
  const uint32_t ring_s = q_s + QBYTES;
  const uint32_t q_bar = ring_s + SLOTS * TILE;
  const uint32_t full0 = q_bar + 8;            // full[slot]: the tile landed
  const uint32_t empty0 = full0 + 8 * SLOTS;   // empty[slot]: every consumer warp is done with it

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int q_offset = skv - sq;  // row i sits at key position i + q_offset
  // Key steps of BK keys (NST stages each) loaded for the block: up to its
  // diagonal under the index mask, else all (skv is a multiple of BK).
  const int n_steps_all = skv / BK;
  const int n_steps =
      causal && !BY_POS ? min(n_steps_all, (min(q0 + kRows, sq) - 1 + q_offset) / BK + 1) : n_steps_all;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // so the compiler knows it is warp-uniform
  if (wg == kConsumers) {  // the producer: one thread issues every copy, in the consumers' order
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      mbar_expect_tx(q_bar, QBYTES);
      for (int p = 0; p < PANELS; ++p) tma_load_3d(q_s + p * Q_PANEL, &q_map, q_bar, p * PC, q0, b * h + head);
      const int kv_head = b * hkv + kvh;
      int slot = 0;
      uint32_t phase = 1;  // a fresh slot counts as emptied
      for (int step = 0; step < n_steps; ++step) {
        for (int kind = 0; kind < 2; ++kind) {  // the step's K tiles, then its V tiles
          for (int j = 0; j < NST; ++j) {
            mbar_wait(empty0 + 8 * slot, phase);
            mbar_expect_tx(full0 + 8 * slot, TILE);
            for (int p = 0; p < PANELS; ++p)
              tma_load_3d(ring_s + slot * TILE + p * T_PANEL, kind ? &v_map : &k_map, full0 + 8 * slot, p * PC,
                          (step * NST + j) * SK, kv_head);
            if (++slot == SLOTS) slot = 0, phase ^= 1;
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // A consumer warpgroup: rows r0 .. r0 + 63; this thread's rows are g and
  // g + 8 of its warp's 16.
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + wg * kWgRows;
  const int wg_rows = min(kWgRows, sq - r0);  // <= 0: wholly past sq, nothing to compute
  const int wg_last = r0 + wg_rows - 1 + q_offset;
  const int warp_first = r0 + warp * 16 + q_offset;
  int pos0 = warp_first + g;
  int pos1 = pos0 + 8;
  const int* kpos_b = nullptr;
  if constexpr (BY_POS) {
    const int* qpos_b = qp + static_cast<int64_t>(b) * sq;
    kpos_b = kp + static_cast<int64_t>(b) * skv;
    const int row = r0 + warp * 16 + g;
    pos0 = row < sq ? __ldg(qpos_b + row) : INT32_MIN;  // rows past sq see nothing
    pos1 = row + 8 < sq ? __ldg(qpos_b + row + 8) : INT32_MIN;
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums; the quad adds them up at the end
  float corr[2];                // a softmax step's rescaling of acc, applied before its P.V
  float s[NST][SK / 2];         // a step's scores, then its p in f32
  uint32_t pa[NST][SK / 16][4]; // a step's p in bf16: P.V's A operand
  int k_slot[NST], v_slot[NST];
  // The steps this warpgroup multiplies: up to its own diagonal (0 past sq).
  const int wg_steps = wg_rows <= 0 ? 0 : causal && !BY_POS ? min(n_steps, wg_last / BK + 1) : n_steps;

  const uint32_t q_wg = q_s + wg * kWgRows * ROWB;
  // The tiles of a step, as the producer sends them (its K tiles, then its
  // V tiles): wait until they have landed, note their slots; empty them.
  auto wait_k = [&](int step) {
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      const int index = step * 2 * NST + j;
      k_slot[j] = index % SLOTS;
      mbar_wait(full0 + 8 * k_slot[j], (index / SLOTS) & 1);
    }
  };
  auto wait_v = [&](int step) {
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      const int index = step * 2 * NST + NST + j;
      v_slot[j] = index % SLOTS;
      mbar_wait(full0 + 8 * v_slot[j], (index / SLOTS) & 1);
    }
  };
  auto release = [&](const int (&slots)[NST]) {  // every warp's lane 0
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NST; ++j) mbar_arrive(empty0 + 8 * slots[j]);
    }
  };
  // S = Q.K^T of a step's stages, in flight after the call
  auto issue_s = [&]() {
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      const uint32_t k_tile = ring_s + k_slot[j] * TILE;
      fence_regs(s[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk * 16 / PC) * Q_PANEL + (kk * 16 % PC) * 2;  // panel, then 32 bytes a k16 step
        const uint32_t kcol = (kk * 16 / PC) * T_PANEL + (kk * 16 % PC) * 2;
        wgmma_ss<SK>(s[j], smem_desc(q_wg + col, 16, ATOM, LAYOUT), smem_desc(k_tile + kcol, 16, ATOM, LAYOUT),
                     kk > 0);
      }
    }
    wgmma_commit();
  };
  // acc = acc * corr + p_bf16 . v, in flight after the call
  auto issue_pv = [&]() {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      const uint32_t v_tile = ring_s + v_slot[j] * TILE;
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) fence_regs(pa[j][kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)  // 16 keys a step, V's rows: MN-major, panels T_PANEL apart
        wgmma_rs<HD>(acc, pa[j][kk], smem_desc(v_tile + kk * 16 * ROWB, T_PANEL, ATOM, LAYOUT), 1);
    }
    wgmma_commit();
  };
  // The step's softmax on its scores (rows g and g + 8): m, l and corr,
  // and p in f32 in s.  Maxima and sums in 4 partials a row, for latency.
  auto softmax = [&](int step) {
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r][0] = mx[r][1] = mx[r][2] = mx[r][3] = m_row[r];
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      const int k0 = (step * NST + j) * SK;
      if constexpr (BY_POS) {
#pragma unroll
        for (int n = 0; n < SK / 8; ++n) {
          const int2 kpos = __ldg(reinterpret_cast<const int2*>(kpos_b + k0 + n * 8 + 2 * t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][4 * n + e] * sm_scale;
            if ((e % 2 ? kpos.y : kpos.x) > (e < 2 ? pos0 : pos1)) x = kNegInf;
            s[j][4 * n + e] = x;
          }
        }
      } else {
        const bool diagonal = causal && k0 + SK - 1 > warp_first;
#pragma unroll
        for (int n = 0; n < SK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][4 * n + e] * sm_scale;
            if (diagonal && k0 + n * 8 + 2 * t + (e % 2) > (e < 2 ? pos0 : pos1)) x = kNegInf;
            s[j][4 * n + e] = x;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < SK / 8; ++n) {
        mx[0][n % 4] = fmaxf(mx[0][n % 4], fmaxf(s[j][4 * n], s[j][4 * n + 1]));
        mx[1][n % 4] = fmaxf(mx[1][n % 4], fmaxf(s[j][4 * n + 2], s[j][4 * n + 3]));
      }
    }
    float m_log2[2], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
      corr[r] = exp2_approx((m_row[r] - m_new) * kLog2e);
      m_row[r] = m_new;
      m_log2[r] = m_new * kLog2e;
      sum[r][0] = sum[r][1] = sum[r][2] = sum[r][3] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int i = 0; i < SK / 2; ++i) {
        const int r = (i / 2) % 2;  // elements 4n, 4n+1: row g; 4n+2, 4n+3: row g + 8
        const float p = exp2_approx(fmaf(s[j][i], kLog2e, -m_log2[r]));
        sum[r][(i / 4) % 4] += p;
        s[j][i] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  };
  auto pack_p = [&]() {  // keys 16kk .. 16kk+15 of each stage as P.V's A operand, p rounded to bf16
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[j][kk][e] = pack_bf16x2(s[j][8 * kk + 2 * e], s[j][8 * kk + 2 * e + 1]);
      }
    }
  };

  // The two consumer warpgroups take turns to issue their products (named
  // barriers 3 + wg: "warpgroup wg may issue"), so that one's softmax runs
  // while the other's products do.  Each takes n_steps + 1 turns; warpgroup
  // 1 lets warpgroup 0 go first, and warpgroup 0 takes the last pass.
  const int other = 1 - wg;
  auto take_turn = [&]() { named_barrier(3 + wg, 2 * 128); };
  auto pass_turn = [&]() { named_barrier_arrive(3 + other, 2 * 128); };
  if (wg == 1) pass_turn();

  mbar_wait(q_bar, 0);
  if (wg_steps > 0) {  // step 0's scores and softmax
    wait_k(0);
    take_turn();
    issue_s();
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NST; ++j) fence_regs(s[j]);
    release(k_slot);
    softmax(0);
    pack_p();
  } else {
    take_turn();
    pass_turn();
  }
  // Step it's S = Q.K^T and step it - 1's P.V in flight together, step it's
  // softmax while they run; no branch between the first issue and the last
  // wait (ptxas serializes wgmmas around a divergent path).
  for (int it = 1; it < wg_steps; ++it) {
    wait_k(it);
    wait_v(it - 1);
    take_turn();
    issue_s();
    issue_pv();
    pass_turn();
    wgmma_wait<1>();  // this step's scores
#pragma unroll
    for (int j = 0; j < NST; ++j) fence_regs(s[j]);
    softmax(it);
    wgmma_wait<0>();  // the previous step's P.V
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) fence_regs(pa[j][kk]);
    }
    release(k_slot);
    release(v_slot);
    pack_p();
  }
  if (wg_steps > 0) {  // the last step's P.V
    wait_v(wg_steps - 1);
    take_turn();
    issue_pv();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_slot);
  }
  for (int step = wg_steps; step < n_steps; ++step) {  // steps past this warpgroup's diagonal: empty their slots
    wait_k(step);
    release(k_slot);
    wait_v(step);
    release(v_slot);
    take_turn();
    pass_turn();
  }
  if (wg == 0) take_turn();
  if (wg_rows <= 0) return;

  // acc / max(l, 1e-20) in bf16, staged in the warpgroup's own rows of Q's
  // tile (its products are done) in Q's swizzle, then stored by TMA.
  float l_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_sum[r] = l_row[r];
    l_sum[r] += __shfl_xor_sync(0xffffffffu, l_sum[r], 1);
    l_sum[r] += __shfl_xor_sync(0xffffffffu, l_sum[r], 2);
    l_sum[r] = fmaxf(l_sum[r], 1e-20f);
  }
  uint8_t* const out_g = q_g + wg * kWgRows * ROWB;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {  // the n8 block of columns 8i .. 8i+7
    const int col = i * 8 % PC;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      const int swz = ROWB == 128 ? r % 8 : (r / 2) % 4;
      const int at = (i * 8 / PC) * Q_PANEL + r * ROWB + (((col / 8) ^ swz) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(out_g + at) =
          pack_bf16x2(acc[4 * i + 2 * half] / l_sum[half], acc[4 * i + 2 * half + 1] / l_sum[half]);
    }
  }
  fence_async_shared();
  named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int p = 0; p < PANELS; ++p) tma_store_3d(&o_map, q_wg + p * Q_PANEL, p * PC, r0, b * h + head);
    tma_store_wait();
  }
}

// The map of `heads` contiguous (rows, hd) bf16 matrices, a box of
// `box_rows` rows by one panel of columns, swizzled as the kernel reads it.
cudaError_t encode(CUtensorMap* map, const void* base, int heads, int rows, int hd, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t pc = panel_cols(hd);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2, static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {pc, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          pc * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps already encoded, by (address, heads, rows, hd, box rows): a map is
// a function of those alone, so a cached one is exact however the memory
// under it was reused.  A serving prefill launches with the same few
// addresses batch after batch; this keeps the encoding off its host time.
struct MapKey {
  const void* base;
  int heads, rows, hd, box_rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && heads == o.heads && rows == o.rows && hd == o.hd && box_rows == o.box_rows;
  }
};
constexpr int kMapBits = 8;
constexpr int kMapCache = 1 << kMapBits;  // direct-mapped entries

cudaError_t cached_map(CUtensorMap* map, const void* base, int heads, int rows, int hd, int box_rows) {
  static std::mutex mu;
  static MapKey keys[kMapCache] = {};
  static CUtensorMap maps[kMapCache];
  const MapKey key{base, heads, rows, hd, box_rows};
  uint64_t x = reinterpret_cast<uintptr_t>(base) ^ (static_cast<uint64_t>(heads) << 40) ^
               (static_cast<uint64_t>(rows) << 20) ^ (static_cast<uint64_t>(hd) << 8) ^ box_rows;
  const int i = static_cast<int>((x * 0x9E3779B97F4A7C15ull) >> (64 - kMapBits));
  {
    std::lock_guard<std::mutex> lock(mu);
    if (keys[i] == key && base != nullptr) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode(map, base, heads, rows, hd, box_rows);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    keys[i] = key;
    maps[i] = *map;
  }
  return err;
}

template <int HD, int BK, bool BY_POS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                   int h, int hkv, int sq, int skv, float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  cudaError_t err = cached_map(&qm, q, b * h, sq, HD, kRows);
  if (err == cudaSuccess) err = cached_map(&km, k, b * hkv, skv, HD, stage_keys(HD, BK));
  if (err == cudaSuccess) err = cached_map(&vm, v, b * hkv, skv, HD, stage_keys(HD, BK));
  if (err == cudaSuccess) err = cached_map(&om, o, b * h, sq, HD, kWgRows);
  if (err != cudaSuccess) return err;
  constexpr int smem = smem_bytes(HD, BK);
  auto kernel = fa_wgmma_bf16<HD, BK, BY_POS>;
  // The shared-memory limit is set once an instance and device (bit d of
  // `set`), not on every launch.
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, om, qp, kp, h, hkv, sq, skv, sm_scale, causal);
  return cudaGetLastError();
}

template <int HD, bool BY_POS>
cudaError_t launch_bk(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                      int h, int hkv, int sq, int skv, int block_k, float sm_scale, int causal, cudaStream_t s) {
  switch (block_k) {
    case 64: return launch<HD, 64, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, sm_scale, causal, s);
    case 128: return launch<HD, 128, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool BY_POS>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                      int h, int hkv, int sq, int skv, int hd, int block_k, float sm_scale, int causal,
                      cudaStream_t s) {
  switch (hd) {
    case 32: return launch_bk<32, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 64: return launch_bk<64, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 128: return launch_bk<128, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 192: return launch_bk<192, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg


// ---------------------------------------------------------------------------
// fa_cuda_f32: f32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 8;  // query rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // keys staged in shared memory at a time
constexpr int kPad = 4;  // floats after each staged row: float4 reads by lane = key hit distinct banks

// Copy n rows of hd contiguous floats into shared memory, one row every
// `stride` floats.  hd is a multiple of 4 and src 16-byte aligned.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int hd, int stride) {
  const int quads = hd / 4;
  for (int i = threadIdx.x; i < n * quads; i += kThreads) {
    const int r = i / quads;
    const int c = (i - r * quads) * 4;
    *reinterpret_cast<float4*>(dst + r * stride + c) =
        *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r) * hd + c);
  }
}

template <int NPL, bool BY_POS>  // NPL = output dims per lane = hd / 32; BY_POS: mask by q_pos >= kv_pos
__global__ void __launch_bounds__(kThreads) fa_cuda_f32(
    const float* __restrict__ q,  // (b, h, sq, hd)
    const float* __restrict__ k,  // (b, hkv, skv, hd)
    const float* __restrict__ v,  // (b, hkv, skv, hd)
    float* __restrict__ o,        // (b, h, sq, hd)
    const int* __restrict__ qp,   // (b, sq) when BY_POS
    const int* __restrict__ kp,   // (b, skv) when BY_POS
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
  // the row's position among the keys, or its own position (BY_POS)
  const int pos = BY_POS ? (live ? __ldg(qp + static_cast<int64_t>(b) * sq + row) : INT32_MIN) : row + q_offset;
  const int* kpos_b = BY_POS ? kp + static_cast<int64_t>(b) * skv : nullptr;
  const int last_pos = q0 + q_rows - 1 + q_offset;

  const int64_t q_base = (static_cast<int64_t>(b) * h + head) * sq * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + kvh) * skv * HD;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  stage(qs, q + q_base + static_cast<int64_t>(q0) * HD, q_rows, HD, HD);
  const float* my_q = qs + warp * HD;
  float* my_s = sp + warp * block_k;

  const int n_tiles_all = skv / block_k;
  const int n_tiles = causal && !BY_POS ? min(n_tiles_all, last_pos / block_k + 1) : n_tiles_all;

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
      const bool needed = BY_POS || !causal || k_tile + c <= last_pos;  // uniform over the block
      if (needed) {
        __syncthreads();  // the previous chunk's readers are done (q staged, the first time)
        stage(kv, kb + static_cast<int64_t>(k_tile + c) * HD, chunk, HD, KV_STRIDE);
        __syncthreads();
      }
      if (!live) continue;
      for (int j = lane; j < chunk; j += 32) {
        const int key = k_tile + c + j;
        float s = kNegInf;
        if (BY_POS ? __ldg(kpos_b + key) <= pos : !causal || key <= pos) {
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
    // the tile's softmax step (p stays f32: v's dtype)
    float corr = 1.f;
    if (live) {
      __syncwarp();
      const float m_new = fmaxf(m, warp_max(local_max));
      corr = expf(m - m_new);
      float local_sum = 0.f;
      for (int j = lane; j < block_k; j += 32) {
        const float p = expf(my_s[j] - m_new);
        local_sum += p;
        my_s[j] = p;
      }
      l = l * corr + warp_sum(local_sum);
      m = m_new;
      __syncwarp();
    }
    // pass 2: p . v
#pragma unroll
    for (int i = 0; i < NPL; ++i) pv[i] = 0.f;
    for (int c = 0; c < block_k; c += chunk) {
      if (!BY_POS && causal && k_tile + c > last_pos) break;  // uniform over the block
      __syncthreads();
      stage(kv, vb + static_cast<int64_t>(k_tile + c) * HD, chunk, HD, KV_STRIDE);
      __syncthreads();
      if (!live) continue;
      const int n = causal && !BY_POS ? min(chunk, pos - (k_tile + c) + 1) : chunk;
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
  float* orow = o + q_base + static_cast<int64_t>(row) * HD + lane * NPL;
#pragma unroll
  for (int i = 0; i < NPL; ++i) orow[i] = acc[i] / denom;
}

template <int NPL, bool BY_POS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                   int h, int hkv, int sq, int skv, int block_k, float sm_scale, int causal, cudaStream_t stream) {
  const int hd = NPL * 32;
  const int chunk = block_k % kChunk == 0 ? kChunk : block_k;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kWarps) * hd + static_cast<size_t>(kWarps) * block_k +
                       static_cast<size_t>(chunk) * (hd + kPad));
  auto kernel = fa_cuda_f32<NPL, BY_POS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kWarps - 1) / kWarps, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o), qp, kp, h, hkv,
                                           sq, skv, block_k, chunk, sm_scale, causal);
  return cudaGetLastError();
}

template <bool BY_POS>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                      int h, int hkv, int sq, int skv, int hd, int block_k, float sm_scale, int causal,
                      cudaStream_t s) {
  switch (hd) {
    case 32: return launch<1, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 64: return launch<2, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 128: return launch<4, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 192: return launch<6, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    case 256: return launch<8, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, block_k, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

}  // namespace

// dtype 0 = bfloat16: fa_wgmma_bf16, hd 32, 64, 128 or 192, block_k 64 or 128.
// dtype 1 = float32: fa_cuda_f32, hd 32, 64, 128, 192 or 256, any block_k.
// q, k, v and o alike; h % hkv == 0; sq <= skv when causal; skv % block_k
// == 0.  q_pos (b, sq) and kv_pos (b, skv), int32, 8-byte aligned, both or
// neither (null): given, the causal mask is q_pos >= kv_pos.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o, const void* q_pos,
                         const void* kv_pos, int dtype, int b, int h, int hkv, int sq, int skv, int hd, int block_k,
                         float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  if ((qp == nullptr) != (kp == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (qp != nullptr) {
    if (dtype == 0) return wg::launch_hd<true>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, 1, s);
    if (dtype == 1) return f32::launch_hd<true>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, 1, s);
  } else {
    if (dtype == 0)
      return wg::launch_hd<false>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
    if (dtype == 1)
      return f32::launch_hd<false>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// fa_wgmma_bf16's plan at (hd, block_k), as the kernel takes it: out[0..6]
// = query rows a block, rows a consumer warpgroup, keys a K or V stage,
// ring slots, the block's shared memory in bytes (Q's tile, the ring, 1 KB
// of alignment and the mbarriers), the most a block can use, and threads a
// block.  Returns 0, or cudaErrorInvalidValue for a (hd, block_k) the
// kernel does not take.
extern "C" int fa_wgmma_plan(int hd, int block_k, int* out) {
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 192) || (block_k != 64 && block_k != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int plan[7] = {wg::kRows, wg::kWgRows, wg::stage_keys(hd, block_k), wg::ring_slots(hd),
                       wg::smem_bytes(hd, block_k), wg::kSmemMax, wg::kThreads};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
