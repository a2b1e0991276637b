// Mamba2 SSD chunked scan on Hopper (sm_90a): the prefill scan of the SSD
// block, y and the final state from x, dt, a, b and c.
//
// Replaces the Pallas TPU kernel ssd_scan of src/repro/kernels/ssd_scan.py
// (body _ssd_kernel).  Per chunk of Q steps, in f32, with the state h (P x N)
// carried from chunk to chunk:
//   cs = cumsum(dt * a);  L = where(i >= j, exp(cs_i - cs_j), 0)
//   y  = ((C . B^T) * L * dt_j) . x + exp(cs_i) * (C . h^T)   (h before the update)
//   h <- exp(cs_last) * h + (x * exp(cs_last - cs) * dt)^T . B
// y rounded to x's dtype once per chunk; h_final f32.  h starts from h0 (B, H,
// P, N) f32 where the caller gives one (a scan that continues another, as a
// prefill in token windows does), else from zero.
//
// Bound.  At the serving shape, x (8,512,48,64) bf16, dt (8,512,48) f32, b
// and c (8,512,1,128) bf16, chunk 256, one call moves 65.8 MB (0.020 ms at
// 3.35 TB/s) and needs 16.1 GFLOP of products counted over the lower
// triangle of each chunk (0.016 ms on the bf16 tensor cores): bytes.  At
// long_500k, x (1,524288,48,64), the inputs and y are 6.81 GB (2.03 ms)
// against 2.07 TFLOP (2.09 ms): operations.  The split below reads x and B
// once more in its first pass (about 3.3 GB), 10.1 GB in all (3.0 ms); and
// the bf16 pieces that stand in for f32 operands (S and h as hi + lo, x * w
// as hi + mid + lo) take about 1.8x the products of that count on the tensor
// cores (4.13 TFLOP at long_500k, 4.2 ms at 989 TFLOP/s).
//
// Two kernels, routed by dtype (x, b and c alike):
//
// ssd_wgmma_bf16 (bf16): wgmma over tiles that TMA stages, the chunks of a
//   sequence split over blocks.
//   - Segments.  Where (batch x heads) blocks do not fill the card, the
//     wrapper (ssd_scan.segment_plan) splits each sequence's chunks into S
//     segments of consecutive chunks (segment s: chunks [s C / S, (s+1) C /
//     S)).  The recurrence h_k = exp(cs_last,k) h_(k-1) + u_k is linear, so
//     a segment can be scanned from a zero state and its effect added after:
//     pass A (the instance <NPAN,false>, only when S > 1), a block per
//     (batch, segment s < S - 1, head), runs the state update alone from h
//     = 0 (x, dt and B; no C) and writes its local state h_loc (P x N f32)
//     and its log-decay D = sum of its chunks' cs_last (in double) to
//     scratch that the wrapper allocates.  Pass B (<NPAN,true>), a block per
//     (batch, segment, head), takes the carry in its prologue:
//       h_in(0) = 0;  h_in(s) = exp(D(s-1)) h_in(s-1) + h_loc(s-1)
//     folded over its s predecessors (s x 32 KB read at P 64, N 128; a
//     third pass would cost a launch and a round trip of h_in for the same
//     few loads), then walks its chunks as one block walked all of them
//     before: y of every chunk, and the last segment writes h_final.  With
//     an initial state the fold starts from it, h_in(0) = h0, so segment 0
//     starts from h0 and every later one takes it on with its decay; pass A
//     is unchanged (its local states start from zero).
//     Blocks run head-fastest, so the heads of one segment, which read the
//     same rows of b and c, are on the card together.  Both passes go from
//     one host call on the caller's stream, with nothing between them.
//   - A block is two consumer warpgroups and two producer warps (320
//     threads): one producer thread issues every TMA copy, and the other
//     warp takes each chunk's prefix sums ahead of the consumers.  Those are
//     the scan of the first bf16 kernel, in double: each lane a run of
//     steps, then a shuffle scan of the lanes' sums, each prefix rounded to
//     f32; the terms dt * a are f32 products.  The warp also takes w =
//     exp(cs_last - cs) dt, exp(cs) and exp(cs_last) (expf), into a ring of
//     two chunks' sums.  dt is read with ordinary loads: one head's steps
//     are 4 H bytes apart, not a box TMA can take.  ptxas gives a thread of
//     this block 168 registers (the same as with a whole producer
//     warpgroup and setmaxnreg, which bought nothing here), and that bounds
//     the design: a second accumulator in flight spills.
//   - Tiles.  A chunk is ceil(Q / 64) tiles of 64 rows (wgmma's M).  x, B
//     and C arrive by TMA as (64 rows, 64 columns) boxes of rank-3 maps,
//     x as (P, H, B*L) and b, c as (N, G, B*L), into 128-byte swizzled
//     panels (1 KB-aligned, 8 KB each): x one panel, B and C one (N <= 64)
//     or two (N <= 128).  Every P and N takes the 128-byte swizzle: the box
//     is always 64 columns and TMA fills the columns past P or N with zeros,
//     so P 16, 32 and 48 run as 64 and N as 64 or 128, and the zeros add
//     nothing to any product.  A box also reads past a ragged chunk's last
//     row into the next chunk (TMA fills only past the tensor's edge): such
//     rows have w = 0 (nothing of them reaches the state) and sit above
//     every real row's diagonal (no score reaches y), and their y is not
//     stored.  A stage is one tile's x, B and C; the ring holds
//       pass B: 4 stages of 40 KB (N 128) or 8 of 24 KB (N 64), beside h as
//               bf16 hi + lo (32 or 16 KB): 201 or 217 KB;
//       pass A: 8 stages of x and B (24 or 16 KB);
//     so a chunk of 256 lies in the ring whole (two do not fit), and the
//     next chunk's first tiles load while the last row tile of this one is
//     multiplied.  Each stage has a full and an empty mbarrier.
//   - Products, all wgmma with bf16 operands and f32 accumulators:
//       C . h^T  m64n64k16, both operands K-major in shared memory (h as hi
//                + lo);
//       C . B^T  m64n64k16, both K-major, a 64 x 64 block of scores at a
//                time; scaled in registers by exp(cs_i - cs_j) dt_j
//                (ex2.approx, 2 ulp) where i >= j, else 0 (a select: above
//                the diagonal the exp may overflow, and inf * 0 is NaN);
//                blocks above the diagonal are not multiplied;
//       S . x    m64n64k16, S from registers as hi + lo (the accumulator
//                has the A layout), x MN-major straight from its tile;
//       (x w)^T . B  A from registers: x read transposed by ldmatrix, times
//                w, as hi + mid + lo (kXwPieces), so that h_final holds the
//                f32 bar; B MN-major from the same tile that C . B^T reads
//                K-major.  The update sums from zero each chunk and is added
//                to h in f32: h = exp(cs_last) h + upd.
//   - Pass B's warpgroups.  The row tiles of a chunk go to the two
//     consumers so that each multiplies as many score blocks (row tile r
//     has r + 1): at Q 256, rows 0 and 3 to one, 1 and 2 to the other (5
//     blocks each).  The state update is split by columns of h: one
//     64-column panel each (m64n64; N <= 64: the second consumer alone).  A
//     consumer first updates its panel of h in registers (h stays in f32 in
//     registers for the whole walk), then for each of its row tiles takes C
//     . h^T from the bf16 h in shared memory, scaled by exp(cs_i), and adds
//     S . x over the score blocks up to its diagonal; y is rounded to bf16
//     and stored from registers, rows past the chunk and columns past P not
//     at all.  At a chunk's end both consumers meet (a named barrier), write
//     their panels of the new h as hi + lo, and meet again (not after the
//     last chunk).  Segment 0's first chunk multiplies no C . h^T where no h0
//     is given: h is 0.
//   - Pass A's warpgroups split each chunk's tiles instead, each
//     multiplying all of N (m64n128, or m64n64 at N <= 64) over its own
//     steps and keeping its own part of the state (the recurrence is
//     linear): half the pieces each, and the parts summed once, at the
//     segment's end, through the then idle ring.
//   - A consumer releases a stage once it has done with it; the producer
//     refills it with the next chunk's tile at once.  Each product group is
//     issued, committed and waited on before any branch (ptxas serializes
//     wgmmas across a divergent path); the two consumers' products and
//     scaling overlap.  Tried and measured slower or no faster (PERF.md):
//     a block's next scores in flight while the last block is scaled, the
//     two consumers taking turns to issue, persistent blocks, pass B
//     launched as pass A's programmatic dependent.

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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxStateCols = 8;  // N / 16 for N up to 128
constexpr int kMaxSmem = 232448;  // what a block may opt into on Hopper

// ---------------------------------------------------------------------------
// ssd_wgmma_bf16: bf16 on the tensor cores, wgmma over TMA-staged tiles
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kRows = 64;                          // rows of a tile: wgmma's M and the TMA box's
constexpr int kPanel = kRows * 64 * 2;             // 64 rows of 64 bf16 columns, 128-byte swizzled
constexpr uint32_t kAtom = 8 * 128;                // 8 swizzled rows: the descriptors' stride byte offset
constexpr int kMaxChunk = 256;
constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * 128 + 64;  // and two producer warps
constexpr int kMaxSlots = 8;
constexpr int kXwPieces = 3;  // bf16 pieces of x * w in the state update

// One chunk's sums from the scan warp; a ring of two.  Rows past the chunk
// (up to its last tile's end) hold cs = cs_last, dt = 0 and w = 0.
struct ChunkSums {
  float cs[kMaxChunk];   // prefix sums of dt * a
  float dt[kMaxChunk];
  float w[kMaxChunk];    // exp(cs_last - cs) * dt
  float ecs[kMaxChunk];  // exp(cs)
  float keep;            // exp(cs_last)
  float pad[3];
};

// The plan by state panels (N <= 64: 1, else 2) and pass (FULL: pass B).
__host__ __device__ constexpr int tile_bytes(int npan, bool full) { return kPanel * (1 + npan * (full ? 2 : 1)); }
__host__ __device__ constexpr int h_bytes(int npan, bool full) { return full ? 2 * npan * kPanel : 0; }
__host__ __device__ constexpr int fixed_bytes() {
  return 1024 + 2 * static_cast<int>(sizeof(ChunkSums)) + 8 * (2 * kMaxSlots + 4);
}
__host__ __device__ constexpr int ring_slots(int npan, bool full) {
  return (kMaxSmem - fixed_bytes() - h_bytes(npan, full)) / tile_bytes(npan, full) < kMaxSlots
             ? (kMaxSmem - fixed_bytes() - h_bytes(npan, full)) / tile_bytes(npan, full)
             : kMaxSlots;
}
__host__ __device__ constexpr int smem_bytes(int npan, bool full) {
  return fixed_bytes() + h_bytes(npan, full) + ring_slots(npan, full) * tile_bytes(npan, full);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// exp(x) as 2**(x log2(e)) on the SFU (ex2.approx, 2 ulp; a subnormal
// result flushes to 0).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// K-major operand (rows of 64-column panels, the reduction along the row):
// the k16 step kk of a tile whose panels lie kPanel apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, kAtom, 1);
}
// MN-major operand (the reduction along the rows): rows 16 kk .. of a panel.
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk) {
  return smem_desc(panel + kk * 16 * 128, kPanel, kAtom, 1);
}

template <int NPAN, bool FULL>  // NPAN: 64-column panels of the state (N <= 64 * NPAN); FULL: pass B, else pass A
__global__ void __launch_bounds__(kThreads, 1) ssd_wgmma_bf16(
    const __grid_constant__ CUtensorMap x_map,  // x as (P, H, B*L), box (64, 1, 64)
    const __grid_constant__ CUtensorMap b_map,  // b as (N, G, B*L), box (64, 1, 64)
    const __grid_constant__ CUtensorMap c_map,  // c alike (pass B)
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ h0,  // (B, H, P, N) f32, or null: the state segment 0 starts from (pass B)
    __nv_bfloat16* __restrict__ y,
    float* __restrict__ h_final, float* __restrict__ h_loc, double* __restrict__ d_loc, int seq, int heads,
    int groups, int p, int n, int chunk, int segments) {
  constexpr int SLOTS = ring_slots(NPAN, FULL);
  constexpr int TILE = tile_bytes(NPAN, FULL);
  // consumer warps that release each stage (pass A: its one warpgroup's) and each chunk's sums
  constexpr int STAGE_ARRIVALS = (FULL ? kConsumers : 1) * 4;
  constexpr int SUMS_ARRIVALS = kConsumers * 4;
  static_assert(smem_bytes(NPAN, FULL) <= kMaxSmem && SLOTS >= kMaxChunk / kRows, "the plan does not fit");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzled panels sit on 1024-byte boundaries
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const uint32_t h_s = ring + SLOTS * TILE;  // pass B: h as bf16, NPAN hi panels, then NPAN lo panels
  uint8_t* const h_g = ring_g + SLOTS * TILE;
  ChunkSums* const sums = reinterpret_cast<ChunkSums*>(h_g + h_bytes(NPAN, FULL));
  const uint32_t bars = h_s + h_bytes(NPAN, FULL) + 2 * sizeof(ChunkSums);
  auto full_bar = [&](int slot) { return bars + 8 * slot; };
  auto empty_bar = [&](int slot) { return bars + 8 * (kMaxSlots + slot); };
  auto sums_full = [&](int i) { return bars + 8 * (2 * kMaxSlots + i); };
  auto sums_empty = [&](int i) { return bars + 8 * (2 * kMaxSlots + 2 + i); };

  const int tiles = (chunk + kRows - 1) / kRows;
  const int passes = FULL ? segments : segments - 1;  // this pass's blocks per (batch, head)
  const int hi = blockIdx.x % heads;
  const int s = (blockIdx.x / heads) % passes;
  const int bi = blockIdx.x / heads / passes;
  const int gi = hi / (heads / groups);
  const int chunks = seq / chunk;
  const int k0 = static_cast<int>(static_cast<int64_t>(s) * chunks / segments);
  const int k1 = static_cast<int>(static_cast<int64_t>(s + 1) * chunks / segments);
  const int64_t bh = static_cast<int64_t>(bi) * heads + hi;

  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full_bar(i), 1);
      mbar_init(empty_bar(i), STAGE_ARRIVALS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(sums_full(i), 32);
      mbar_init(sums_empty(i), SUMS_ARRIVALS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform, as the compiler can see
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // the producer warps
    const int pw = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
    if (pw == 0) {  // one thread issues every copy, in the order the consumers use the tiles
      if (lane == 0) {
        prefetch_map(&x_map);
        prefetch_map(&b_map);
        if (FULL) prefetch_map(&c_map);
        int stage = 0;
        for (int k = k0; k < k1; ++k) {
          for (int t = 0; t < tiles; ++t, ++stage) {
            const int slot = stage % SLOTS;
            mbar_wait(empty_bar(slot), ((stage / SLOTS) & 1) ^ 1);  // a fresh slot counts as emptied
            mbar_expect_tx(full_bar(slot), TILE);
            const uint32_t dst = ring + slot * TILE;
            const int row = static_cast<int>(static_cast<int64_t>(bi) * seq + static_cast<int64_t>(k) * chunk) +
                            t * kRows;
            tma_load_3d(dst, &x_map, full_bar(slot), 0, hi, row);
            for (int m = 0; m < NPAN; ++m) {
              tma_load_3d(dst + (1 + m) * kPanel, &b_map, full_bar(slot), m * 64, gi, row);
              if (FULL) tma_load_3d(dst + (1 + NPAN + m) * kPanel, &c_map, full_bar(slot), m * 64, gi, row);
            }
          }
        }
      }
    } else if (pw == 1) {  // each chunk's sums, a chunk or two ahead of the consumers
      const float a_h = a[hi];
      const float* dt_bh = dt + static_cast<int64_t>(bi) * seq * heads + hi;
      const int padded = tiles * kRows;
      const int per = (chunk + 31) / 32;
      const int qa = min(chunk, lane * per);
      const int qb = min(chunk, qa + per);
      double total = 0.0;
      for (int k = k0, i = 0; k < k1; ++k, ++i) {
        ChunkSums& cs = sums[i & 1];
        mbar_wait(sums_empty(i & 1), ((i >> 1) & 1) ^ 1);
        const float* dt_k = dt_bh + static_cast<int64_t>(k) * chunk * heads;
        float v[kMaxChunk / 32];
#pragma unroll
        for (int u = 0; u < kMaxChunk / 32; ++u) {  // all in flight at once
          const int q = lane + 32 * u;
          v[u] = q < chunk ? __ldg(dt_k + static_cast<int64_t>(q) * heads) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kMaxChunk / 32; ++u)
          if (lane + 32 * u < padded) cs.dt[lane + 32 * u] = v[u];
        __syncwarp();
        double own = 0.0;
        for (int q = qa; q < qb; ++q) own += static_cast<double>(__fmul_rn(cs.dt[q], a_h));
        double run = own;
        for (int o = 1; o < 32; o <<= 1) {
          const double up = __shfl_up_sync(0xffffffffu, run, o);
          if (lane >= o) run += up;
        }
        run -= own;  // the sum of the lanes before this one
        for (int q = qa; q < qb; ++q) {
          run += static_cast<double>(__fmul_rn(cs.dt[q], a_h));
          cs.cs[q] = static_cast<float>(run);
        }
        __syncwarp();
        const float last = cs.cs[chunk - 1];
        for (int q = lane; q < padded; q += 32) {
          const bool in = q < chunk;
          const float c = in ? cs.cs[q] : last;
          cs.cs[q] = c;
          cs.w[q] = in ? __fmul_rn(expf(last - c), cs.dt[q]) : 0.f;
          if (FULL) cs.ecs[q] = expf(c);
        }
        if (lane == 0) cs.keep = expf(last);
        total += static_cast<double>(last);
        __syncwarp();
        mbar_arrive(sums_full(i & 1));
      }
      if (!FULL && lane == 0) d_loc[bh * (segments - 1) + s] = total;
    }
    return;
  }
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
  const int g = lane / 4;
  const int t4 = lane % 4;
  // Pass B: the state panel this warpgroup updates (columns 64 panel ..), if any.
  const bool has_panel = NPAN == 2 || wg == 1;
  const int panel = NPAN == 2 ? wg : 0;
  // Pass B: this warpgroup's row tiles, dealt from the last so that both
  // multiply as many score blocks (row tile r has r + 1): bit r of `mine`.
  int mine = 0;
  if (FULL) {
    int load[2] = {0, 0};
    for (int r = tiles - 1; r >= 0; --r) {
      const int to = load[0] <= load[1] ? 0 : 1;
      load[to] += r + 1;
      if (to == wg) mine |= 1 << r;
    }
  }
  const int nr = __popc(mine);
  const int ra = mine ? __ffs(mine) - 1 : -1;   // the first
  const int rb = mine ? 31 - __clz(mine) : -1;  // and the last

  // h, this thread's part of the warpgroup's 64 x 64 panel in the
  // accumulator layout: element 4 jb + e is row 16 warp + g + 8 (e / 2),
  // column 64 panel + 8 jb + 2 t4 + e % 2.
  float h[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) h[e] = 0.f;
  auto at_row = [&](int e) { return 16 * warp + g + 8 * ((e % 4) / 2); };
  auto at_col = [&](int e) { return 64 * panel + 8 * (e / 4) + 2 * t4 + e % 2; };

  // h into shared memory as bf16 hi + lo, in the swizzle that TMA would give.
  auto store_h = [&]() {
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half;
        const float v0 = h[4 * jb + 2 * half], v1 = h[4 * jb + 2 * half + 1];
        const uint32_t hi2 = pack_bf16x2(v0, v1);
        const float2 back = unpack_bf16x2(hi2);
        const uint32_t lo2 = pack_bf16x2(v0 - back.x, v1 - back.y);
        const int at = panel * kPanel + r * 128 + ((jb ^ (r % 8)) * 16) + 4 * t4;
        *reinterpret_cast<uint32_t*>(h_g + at) = hi2;
        *reinterpret_cast<uint32_t*>(h_g + NPAN * kPanel + at) = lo2;
      }
    }
    fence_async_shared();
  };
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(stage % SLOTS));
  };
  auto wait_full = [&](int stage) { mbar_wait(full_bar(stage % SLOTS), (stage / SLOTS) & 1); };
  auto tile_at = [&](int stage) { return ring + (stage % SLOTS) * TILE; };

  if (FULL && (s > 0 || h0 != nullptr)) {
    // the carry: h_in(0) = h0; h_in(s) = exp(D(s-1)) h_in(s-1) + h_loc(s-1),
    // folded over the segments before this one (without h0, segment 0
    // starts from h = 0, which its first chunk does not multiply)
    if (has_panel) {
      if (h0 != nullptr) {
        const float* hz = h0 + bh * p * n;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = at_row(i), c = at_col(i);
          h[i] = r < p && c < n ? hz[r * n + c] : 0.f;
        }
      }
      for (int j = 0; j < s; ++j) {
        const int64_t at = bh * (segments - 1) + j;
        const float e = static_cast<float>(exp(d_loc[at]));
        const float* hl = h_loc + at * p * n;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = at_row(i), c = at_col(i);
          const float v = r < p && c < n ? hl[r * n + c] : 0.f;
          h[i] = __fadd_rn(__fmul_rn(h[i], e), v);
        }
      }
      store_h();
    }
    named_barrier(1, kConsumers * 128);
  }

  // (x * w)^T for the rows p of this warp and the steps 16 kk .. of tile t:
  // x read transposed from its tile, times w, as kXwPieces bf16 pieces
  auto xw_pieces = [&](uint32_t (&ap)[kXwPieces][4], const ChunkSums& cs, uint32_t x_tile, int t, int kk) {
    const int q = kk * 16 + lane % 8 + (lane / 16) * 8;  // x's row (a step of the tile)
    const int chk = 2 * warp + (lane / 8) % 2;           // x's 16-byte column chunk (8 values of p)
    uint32_t xa[4];
    ldmatrix_x4_trans(xa, x_tile + q * 128 + ((chk ^ (q % 8)) * 16));
    const int qw = t * kRows + kk * 16 + 2 * t4;
    const float w0 = cs.w[qw], w1 = cs.w[qw + 1], w8 = cs.w[qw + 8], w9 = cs.w[qw + 9];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 xv = unpack_bf16x2(xa[r]);
      float v0 = __fmul_rn(xv.x, r < 2 ? w0 : w8);
      float v1 = __fmul_rn(xv.y, r < 2 ? w1 : w9);
#pragma unroll
      for (int pc = 0; pc < kXwPieces; ++pc) {
        ap[pc][r] = pack_bf16x2(v0, v1);
        const float2 got = unpack_bf16x2(ap[pc][r]);
        v0 -= got.x;
        v1 -= got.y;
      }
    }
  };
  if constexpr (!FULL) {
    // Pass A: a chunk's tiles split between the warpgroups, each multiplying
    // all of N (64 NPAN columns) over its own steps and keeping its own part
    // of the state; the recurrence is linear, so the segment's local state
    // is the sum of the two parts, taken once at the end.
    constexpr int NC = 64 * NPAN;
    float hp[NC / 2], up[NC / 2];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) hp[e] = 0.f;
    const int split = (tiles + 1) / 2;
    const int t_lo = wg == 0 ? 0 : split, t_hi = wg == 0 ? split : tiles;
    auto issue_up = [&](uint32_t (&ap)[kXwPieces][4], uint32_t b_tile, int kk, bool first) {
      fence_regs(up);
#pragma unroll
      for (int pc = 0; pc < kXwPieces; ++pc) fence_regs(ap[pc]);
      wgmma_fence();
#pragma unroll
      for (int pc = 0; pc < kXwPieces; ++pc) wgmma_rs<NC>(up, ap[pc], desc_mn(b_tile, kk), !first || pc > 0);
      wgmma_commit();
    };
    for (int k = k0, i = 0; k < k1; ++k, ++i) {
      const ChunkSums& cs = sums[i & 1];
      mbar_wait(sums_full(i & 1), (i >> 1) & 1);
      for (int t = t_lo; t < t_hi; ++t) {
        const int stage = i * tiles + t;
        wait_full(stage);
        const uint32_t x_tile = tile_at(stage);
        const uint32_t b_tile = x_tile + kPanel;
        uint32_t pa[kXwPieces][4], pb[kXwPieces][4];
        xw_pieces(pa, cs, x_tile, t, 0);
        issue_up(pa, b_tile, 0, t == t_lo);
        xw_pieces(pb, cs, x_tile, t, 1);
        issue_up(pb, b_tile, 1, false);
        wgmma_wait<1>();
#pragma unroll
        for (int pc = 0; pc < kXwPieces; ++pc) fence_regs(pa[pc]);
        xw_pieces(pa, cs, x_tile, t, 2);
        issue_up(pa, b_tile, 2, false);
        wgmma_wait<1>();
#pragma unroll
        for (int pc = 0; pc < kXwPieces; ++pc) fence_regs(pb[pc]);
        xw_pieces(pb, cs, x_tile, t, 3);
        issue_up(pb, b_tile, 3, false);
        wgmma_wait<0>();
        fence_regs(up);
#pragma unroll
        for (int pc = 0; pc < kXwPieces; ++pc) {
          fence_regs(pa[pc]);
          fence_regs(pb[pc]);
        }
        release(stage);
      }
      const float keep = cs.keep;
      if (t_hi > t_lo) {
#pragma unroll
        for (int e = 0; e < NC / 2; ++e) hp[e] = __fadd_rn(__fmul_rn(hp[e], keep), up[e]);
      } else {
#pragma unroll
        for (int e = 0; e < NC / 2; ++e) hp[e] = __fmul_rn(hp[e], keep);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sums_empty(i & 1));
    }
    // the parts summed through shared memory (the ring is idle now), then stored
    named_barrier(1, kConsumers * 128);
    float* part = reinterpret_cast<float*>(ring_g);
    const int tid = threadIdx.x % 128;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) part[e * 128 + tid] = hp[e];
    }
    named_barrier(1, kConsumers * 128);
    if (wg == 1) return;
    float* out = h_loc + (bh * (segments - 1) + s) * p * n;
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) {
      const int r = 16 * warp + g + 8 * ((e % 4) / 2), c = 8 * (e / 4) + 2 * t4 + e % 2;
      if (r < p && c < n) out[r * n + c] = __fadd_rn(hp[e], part[e * 128 + tid]);
    }
  } else {
    float upd[32];
    for (int k = k0, i = 0; k < k1; ++k, ++i) {
      const ChunkSums& cs = sums[i & 1];
      mbar_wait(sums_full(i & 1), (i >> 1) & 1);
      const int stage0 = i * tiles;

      // 1. upd = (x * w)^T . B over the chunk for this warpgroup's panel, x * w
      //    as kXwPieces bf16 pieces; then h = exp(cs_last) h + upd (registers
      //    only: shared memory keeps the h this chunk's C . h^T reads)
      if (has_panel) {
        for (int t = 0; t < tiles; ++t) {
          const int stage = stage0 + t;
          wait_full(stage);
          const uint32_t x_tile = tile_at(stage);
          uint32_t ap[4][kXwPieces][4];  // (x * w)^T: rows p of this warp, k = the tile's steps 16 kk ..
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) xw_pieces(ap[kk], cs, x_tile, t, kk);
          const uint32_t b_panel = x_tile + (1 + panel) * kPanel;
          fence_regs(upd);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int pc = 0; pc < kXwPieces; ++pc) fence_regs(ap[kk][pc]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int pc = 0; pc < kXwPieces; ++pc)
              wgmma_rs<64>(upd, ap[kk][pc], desc_mn(b_panel, kk), t > 0 || kk > 0 || pc > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(upd);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int pc = 0; pc < kXwPieces; ++pc) fence_regs(ap[kk][pc]);
          if (t > rb) release(stage);  // no row tile of this warpgroup reads it
        }
        const float keep = cs.keep;
#pragma unroll
        for (int e = 0; e < 32; ++e) h[e] = __fadd_rn(__fmul_rn(h[e], keep), upd[e]);
      } else {
        for (int t = rb + 1; t < tiles; ++t) release(stage0 + t);
      }

      // 2. this warpgroup's row tiles: y = exp(cs_i) (C . h^T) + S . x over
      //    the score blocks up to the diagonal
      for (int j = 0; j < nr; ++j) {
        const int r = j == 0 ? ra : rb;
        const bool last_tile = j == nr - 1;
        const int i0 = r * kRows + 16 * warp + g, i1 = i0 + 8;  // this thread's rows of the chunk
        const float cs0 = cs.cs[i0], cs1 = cs.cs[i1];
        wait_full(stage0 + r);
        const uint32_t c_tile = tile_at(stage0 + r) + (1 + NPAN) * kPanel;
        float yacc[32];
        if (s == 0 && k == k0 && h0 == nullptr) {  // h is 0: so is C . h^T
#pragma unroll
          for (int e = 0; e < 32; ++e) yacc[e] = 0.f;
        } else {
          fence_regs(yacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NPAN; ++kk) wgmma_ss<64>(yacc, desc_k(c_tile, kk), desc_k(h_s, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4 * NPAN; ++kk)
            wgmma_ss<64>(yacc, desc_k(c_tile, kk), desc_k(h_s + NPAN * kPanel, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(yacc);
          const float e0 = cs.ecs[i0], e1 = cs.ecs[i1];
#pragma unroll
          for (int e = 0; e < 32; ++e) yacc[e] = __fmul_rn(yacc[e], (e % 4) < 2 ? e0 : e1);
        }

        for (int c = 0; c <= r; ++c) {
          const int stage = stage0 + c;
          wait_full(stage);
          const uint32_t b_tile = tile_at(stage) + kPanel;
          float sacc[32];
          fence_regs(sacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NPAN; ++kk) wgmma_ss<64>(sacc, desc_k(c_tile, kk), desc_k(b_tile, kk), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          // S * exp(cs_i - cs_j) * dt_j where i >= j, else 0
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int col = c * kRows + 8 * jb + 2 * t4 + h2;
              const float cs_j = cs.cs[col], dt_j = cs.dt[col];
              float& v0 = sacc[4 * jb + h2];
              float& v1 = sacc[4 * jb + 2 + h2];
              v0 = i0 >= col ? __fmul_rn(__fmul_rn(v0, exp_approx(cs0 - cs_j)), dt_j) : 0.f;
              v1 = i1 >= col ? __fmul_rn(__fmul_rn(v1, exp_approx(cs1 - cs_j)), dt_j) : 0.f;
            }
          }
          // y += S . x, S as hi + lo against the same x tile
          uint32_t sh[4][4], sl[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v0 = sacc[8 * kk + 2 * e], v1 = sacc[8 * kk + 2 * e + 1];
              sh[kk][e] = pack_bf16x2(v0, v1);
              const float2 back = unpack_bf16x2(sh[kk][e]);
              sl[kk][e] = pack_bf16x2(v0 - back.x, v1 - back.y);
            }
          }
          const uint32_t x_tile = tile_at(stage);
          fence_regs(yacc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(sh[kk]);
            fence_regs(sl[kk]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<64>(yacc, sh[kk], desc_mn(x_tile, kk), 1);
            wgmma_rs<64>(yacc, sl[kk], desc_mn(x_tile, kk), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(yacc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(sh[kk]);
            fence_regs(sl[kk]);
          }
          if (last_tile) release(stage);
        }

        // y rounded to bf16 once; rows past the chunk and columns past P not stored
        const int64_t row_at = static_cast<int64_t>(bi) * seq + static_cast<int64_t>(k) * chunk;
        __nv_bfloat16* y0 = y + ((row_at + i0) * heads + hi) * p;
        __nv_bfloat16* y1 = y + ((row_at + i1) * heads + hi) * p;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int col = 8 * jb + 2 * t4;
          if (col < p) {
            if (i0 < chunk) *reinterpret_cast<uint32_t*>(y0 + col) = pack_bf16x2(yacc[4 * jb], yacc[4 * jb + 1]);
            if (i1 < chunk) *reinterpret_cast<uint32_t*>(y1 + col) = pack_bf16x2(yacc[4 * jb + 2], yacc[4 * jb + 3]);
          }
        }
      }
      // 3. once both warpgroups' C . h^T have read the old h, the new one
      //    (not after the last chunk)
      if (k + 1 < k1) {
        named_barrier(1, kConsumers * 128);
        if (has_panel) store_h();
        named_barrier(1, kConsumers * 128);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sums_empty(i & 1));
    }

    // the last segment's h_final
    if (has_panel && s == segments - 1) {
      float* out = h_final + bh * p * n;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = at_row(e), c = at_col(e);
        if (r < p && c < n) out[r * n + c] = h[e];
      }
    }
  }
}

// The map of a (rows, parts, cols) bf16 tensor, cols contiguous, read in
// boxes of 64 rows of one part by 64 columns, 128-byte swizzled; columns
// past `cols` and rows past `rows` arrive as zeros.
cudaError_t encode(CUtensorMap* map, const void* base, int cols, int parts, int64_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(parts),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2, static_cast<cuuint64_t>(parts) * cols * 2};
  const cuuint32_t box[3] = {64, 1, kRows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shared-memory limit of an instance, set once a device (bit d).
template <int NPAN, bool FULL>
cudaError_t prepare() {
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(ssd_wgmma_bf16<NPAN, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(NPAN, FULL));
    if (err != cudaSuccess) return err;
    set.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int NPAN>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c, const void* h0,
                   void* y, void* h_final, void* h_loc, void* d_loc, int bsz, int seq, int heads, int p, int groups,
                   int n, int chunk, int segments, cudaStream_t stream) {
  CUtensorMap xm, bm, cm;
  const int64_t rows = static_cast<int64_t>(bsz) * seq;
  cudaError_t err = encode(&xm, x, p, heads, rows);
  if (err == cudaSuccess) err = encode(&bm, b, n, groups, rows);
  if (err == cudaSuccess) err = encode(&cm, c, n, groups, rows);
  if (err == cudaSuccess) err = prepare<NPAN, true>();
  if (err == cudaSuccess && segments > 1) err = prepare<NPAN, false>();
  if (err != cudaSuccess) return err;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* hz = static_cast<const float*>(h0);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  float* hf = static_cast<float*>(h_final);
  float* hl = static_cast<float*>(h_loc);
  double* dl = static_cast<double*>(d_loc);
  if (segments > 1) {
    ssd_wgmma_bf16<NPAN, false><<<bsz * heads * (segments - 1), kThreads, smem_bytes(NPAN, false), stream>>>(
        xm, bm, cm, dtf, af, hz, yb, hf, hl, dl, seq, heads, groups, p, n, chunk, segments);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_wgmma_bf16<NPAN, true><<<bsz * heads * segments, kThreads, smem_bytes(NPAN, true), stream>>>(
      xm, bm, cm, dtf, af, hz, yb, hf, hl, dl, seq, heads, groups, p, n, chunk, segments);
  return cudaGetLastError();
}

}  // namespace wg

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
                 const float* __restrict__ cm, const float* __restrict__ h0,  // h0: null = a zero start
                 float* __restrict__ y, float* __restrict__ h_final,
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

  const float* h0_bh = h0 == nullptr ? nullptr : h0 + (static_cast<int64_t>(bi) * heads + hi) * P * n;
  for (int e = threadIdx.x; e < P * ldn; e += kThreads) {
    const int r = e / ldn, k = e - r * ldn;
    hs[e] = h0_bh != nullptr && k < n ? h0_bh[r * n + k] : 0.f;
  }
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
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c, const void* h0,
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
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<const float*>(h0),
      static_cast<float*>(y),
      static_cast<float*>(h_final), seq, heads, groups, n, chunk);
  return cudaGetLastError();
}

cudaError_t launch_p(const void* x, const void* dt, const void* a, const void* b, const void* c, const void* h0,
                     void* y, void* h_final, int bsz, int seq, int heads, int p, int groups, int n,
                     int chunk, cudaStream_t s) {
  switch (p) {
    case 16: return launch<1>(x, dt, a, b, c, h0, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 32: return launch<2>(x, dt, a, b, c, h0, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 48: return launch<3>(x, dt, a, b, c, h0, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    case 64: return launch<4>(x, dt, a, b, c, h0, y, h_final, bsz, seq, heads, groups, n, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

}  // namespace

// dtype 0 = bfloat16: ssd_wgmma_bf16, the chunks of each (batch, head) in
// `segments` segments (pass A over the first segments - 1 when there are
// more than one, then pass B); h_loc (B, H, segments - 1, P, N) f32 and
// d_loc (B, H, segments - 1) f64 are its scratch (null when segments is 1);
// chunk up to 256, segments up to the number of chunks.  dtype 1 =
// float32: ssd_cuda_f32, any chunk, segments 1.  x and y (B, L, H, P), dt
// (B, L, H), a (H,), b and c (B, L, G, N), h_final (B, H, P, N), all
// contiguous, x, b and c 16-byte aligned; h0 (B, H, P, N) f32 contiguous,
// the state the scan starts from, or null for zero.  P is 16, 32, 48 or 64;
// N a multiple of 16 up to 128; H % G == 0; L % chunk == 0.  Returns the
// first launch error (0 = launched).
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* b, const void* c, const void* h0,
                          void* y, void* h_final, void* h_loc, void* d_loc, int dtype, int bsz, int seq, int heads,
                          int p, int groups, int n, int chunk, int segments, void* stream) {
  if (groups <= 0 || heads % groups || chunk <= 0 || seq % chunk || n <= 0 || n % 16 ||
      n / 16 > kMaxStateCols || segments < 1 || segments > seq / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (chunk > wg::kMaxChunk || p % 16 || p > 64 || (segments > 1 && (h_loc == nullptr || d_loc == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return n > 64 ? wg::launch<2>(x, dt, a, b, c, h0, y, h_final, h_loc, d_loc, bsz, seq, heads, p, groups, n,
                                  chunk, segments, s)
                  : wg::launch<1>(x, dt, a, b, c, h0, y, h_final, h_loc, d_loc, bsz, seq, heads, p, groups, n,
                                  chunk, segments, s);
  }
  if (dtype == 1 && segments == 1)
    return f32::launch_p(x, dt, a, b, c, h0, y, h_final, bsz, seq, heads, p, groups, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
