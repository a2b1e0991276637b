// Attention forward on Hopper (sm_90a): causal or non-causal, GQA, q
// right-aligned to kv, online softmax over key tiles with f32 m, l and acc.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (body _flash_kernel).
//
// Bound: bytes at the serving shapes.  One call reads q, k and v once and
// writes o once; at q (8,16,512,128), k and v (8,8,512,128) in bf16 that is
// 50.3 MB, 0.0150 ms at 3.35 TB/s, against 8.61 GFLOP of causal work,
// 0.0087 ms on the bf16 tensor cores and 0.13 ms on the f32 CUDA cores.
// So the products must run on the tensor cores, and the kernel must read
// each K and V tile from device memory once per 64 query rows while the
// previous tile is multiplied.
//
// Two kernels, routed by dtype:
//
// fa_tc_bf16 (bf16 q, k, v): FlashAttention-2's shape on mma.sync.
//   - A block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//     warp; the kv head is head / (H / Hkv), read in place (GQA without
//     repeating K or V).  Blocks run the heaviest causal query tiles first.
//   - S = Q.K^T and O += P.V are mma.sync.m16n8k16 with bf16 operands and
//     f32 accumulators.  Fragments come from shared memory by ldmatrix
//     (.trans for V); the Q fragments stay in registers for the whole key
//     loop.  The P fragment of P.V is the S accumulator rounded to bf16 in
//     registers: exactly the body's p.astype(v.dtype).
//   - K and V tiles of 64 keys go through a ring of 4 shared-memory slots
//     filled by cp.async in the order they are used (the K sub-tiles of a
//     softmax step, then its V sub-tiles), three tiles ahead of the one
//     being multiplied.  Rows are padded by 16 bytes, so the 8 rows an
//     ldmatrix phase reads fall in 8 distinct 16-byte bank groups.  At hd
//     128: 17 KB of Q and 68 KB of ring, two blocks an SM.
//   - hd 192 (DeepSeek's MLA: q and k 128 + 64 rope dims, v zero-padded
//     from 128 by the caller) holds 24 n8 output blocks, 96 f32 registers
//     of acc a thread beside up to 64 of scores.  There the Q fragments are
//     read from shared memory for each k16 step instead of kept in 48 more
//     registers, and the ring is 3 slots, two tiles ahead: 25 KB of Q and
//     75 KB of ring, so two blocks still share an SM (4 slots would be
//     125 KB, one block an SM).
//   - The softmax step is the wrapper's block_k (64 or 128 keys, one or two
//     64-key sub-tiles whose scores are all in registers before the step's
//     max is taken), with the body's arithmetic in f32: s = (q.k) * sm_scale,
//     NEG_INF (-2**30, finite) above the diagonal, m_new = max(m, max s),
//     corr = exp(m - m_new), p = exp(s - m_new), l = l * corr + sum(p),
//     acc = acc * corr + p_bf16 . v; exp(x) is ex2.approx(x * log2(e)) on
//     the SFU (2 ulp).  Sub-tiles wholly above a warp's
//     diagonal are neither multiplied nor exponentiated (their p is 0), and
//     those above the block's are not loaded.  Output acc / max(l, 1e-20),
//     staged through shared memory for 16-byte stores.  Rows past sq are
//     zero in Q and never stored, so sq need not be a multiple of 64.
//
// Position mask (both kernels): with q_pos (b, sq) and kv_pos (b, skv), int32,
//   a key is kept iff q_pos >= kv_pos -- the reference's mask for rows that
//   pack documents restarting at 0, repeat or reverse positions -- instead
//   of by index.  It is a template flag (BY_POS), so the index route's code
//   is what it was.  Every K/V tile is loaded; fa_tc_bf16 multiplies a 64-key
//   sub-tile for a warp only where the sub-tile's smallest key position is
//   at most the warp's largest query position (a warp reads two positions
//   a lane and takes the minimum), and masks each score by the key's
//   position, read from device memory (L1) beside the product.  fa_cuda_f32
//   stages and scores every key.  A row that sees no key at all (a padded
//   query row) is then the average over the sub-tiles its warp multiplied,
//   not over every key as in the plain version: callers drop such rows.
//
// fa_cuda_f32 (f32 q, k, v): the first design, on the f32 CUDA cores (the
//   tensor cores' TF32 cannot hold the 2e-5 f32 bar).  One block per (b,
//   head, 8 query rows), one warp per row; keys staged 64 rows at a time
//   in shared memory; per block_k tile, pass 1 writes the row's scores and
//   takes their max, then the softmax step, then pass 2 accumulates p.v
//   with each lane owning hd/32 output dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// fa_tc_bf16: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 64;  // query rows per block
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;  // keys per staged K or V tile
constexpr int kPad = 8;    // bf16 after each staged row (16 bytes)

// The K/V ring's slots, and whether the Q fragments stay in registers (else
// each k16 step reads them from shared memory), by head dim.
__host__ __device__ constexpr int ring_slots(int hd) { return hd > 128 ? 3 : 4; }
__host__ __device__ constexpr bool q_in_registers(int hd) { return hd <= 128; }

// 2**x on the SFU (ex2.approx, 2 ulp; a subnormal result flushes to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The S tile of keys 16kk..16kk+15 (n8 blocks 2kk and 2kk+1) is, rounded
// to bf16, the A fragment of P.V for those keys (mma_bf16.cuh's layouts).
template <int HD, int NSUB, bool BY_POS>  // NSUB = block_k / 64; BY_POS: mask by q_pos >= kv_pos
__global__ void __launch_bounds__(kThreads, 2) fa_tc_bf16(
    const __nv_bfloat16* __restrict__ q,  // (b, h, sq, hd)
    const __nv_bfloat16* __restrict__ k,  // (b, hkv, skv, hd)
    const __nv_bfloat16* __restrict__ v,  // (b, hkv, skv, hd)
    __nv_bfloat16* __restrict__ o,        // (b, h, sq, hd)
    const int* __restrict__ qp,           // (b, sq) when BY_POS
    const int* __restrict__ kp,           // (b, skv) when BY_POS
    int h, int hkv, int sq, int skv, float sm_scale, int causal) {
  constexpr int STRIDE = HD + kPad;  // bf16 per staged row
  constexpr int TILE = kKeys * STRIDE;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;  // k16 steps of q.k
  constexpr int SBLK = kKeys / 8;  // n8 blocks of a sub-tile's scores
  constexpr int DBLK = HD / 8;     // n8 blocks of the output
  constexpr int kSlots = ring_slots(HD);
  constexpr bool kQRegs = q_in_registers(HD);
  constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2**(x log2(e))
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // (64, STRIDE); the output's staging at the end
  __nv_bfloat16* ring = qs + kRows * STRIDE;                        // kSlots x (64, STRIDE)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int q_rows = min(kRows, sq - q0);
  const int q_offset = skv - sq;  // row i sits at key position i + q_offset
  const int block_last = q0 + q_rows - 1 + q_offset;
  const int n_sub_all = skv / kKeys;
  const int n_sub = causal && !BY_POS ? min(n_sub_all, block_last / kKeys + 1) : n_sub_all;
  const int n_steps = (n_sub + NSUB - 1) / NSUB;
  const int n_tiles = n_steps * 2 * NSUB;  // per step: its K sub-tiles, then its V sub-tiles

  const __nv_bfloat16* qb = q + ((static_cast<int64_t>(b) * h + head) * sq + q0) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + kvh) * skv * HD;
  const __nv_bfloat16* kb = k + kv_base;
  const __nv_bfloat16* vb = v + kv_base;

  // Tile i of the sequence into slot i % kSlots; one commit group per call,
  // empty past the end and for sub-tiles above the block's diagonal.
  auto load_tile = [&](int i) {
    if (i < n_tiles) {
      const int r = i % (2 * NSUB);
      const int sub = (i / (2 * NSUB)) * NSUB + r % NSUB;
      if (sub < n_sub) {
        const __nv_bfloat16* src = (r < NSUB ? kb : vb) + static_cast<int64_t>(sub) * kKeys * HD;
        __nv_bfloat16* dst = ring + (i % kSlots) * TILE;
        for (int c = threadIdx.x; c < kKeys * CHUNKS; c += kThreads) {
          const int row = c / CHUNKS;
          const int col = (c % CHUNKS) * 8;
          cp_async16(smem_addr(dst + row * STRIDE + col), src + static_cast<int64_t>(row) * HD + col);
        }
      }
    }
    cp_async_commit();
  };

  for (int c = threadIdx.x; c < kRows * CHUNKS; c += kThreads) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    __nv_bfloat16* dst = qs + row * STRIDE + col;
    if (row < q_rows)
      cp_async16(smem_addr(dst), qb + static_cast<int64_t>(row) * HD + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = 0; i < kSlots - 1; ++i) load_tile(i);  // Q rides in tile 0's group

  // This thread's rows: g and g + 8 of the warp's 16.
  const int warp_row = q0 + warp * 16;
  const int warp_first = warp_row + q_offset;
  const int warp_last = warp_first + 15;
  int pos0 = warp_first + g;
  int pos1 = pos0 + 8;
  int warp_qmax = warp_last;
  const int* kpos_b = nullptr;
  if constexpr (BY_POS) {
    const int* qpos_b = qp + static_cast<int64_t>(b) * sq;
    kpos_b = kp + static_cast<int64_t>(b) * skv;
    pos0 = warp_row + g < sq ? __ldg(qpos_b + warp_row + g) : INT32_MIN;  // rows past sq see nothing
    pos1 = warp_row + g + 8 < sq ? __ldg(qpos_b + warp_row + g + 8) : INT32_MIN;
    warp_qmax = __reduce_max_sync(0xffffffffu, max(pos0, pos1));
  }

  uint32_t qf[kQRegs ? KSTEPS : 1][4];
  float acc[DBLK][4];
#pragma unroll
  for (int d = 0; d < DBLK; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums; the quad adds them up at the end
  float s[NSUB][SBLK][4];
  bool live[NSUB];

  // Wait for tile i, let every warp be done with tile i - 1, and reuse its
  // slot for tile i + kSlots - 1.
  auto next_tile = [&](int i) -> const __nv_bfloat16* {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    load_tile(i + kSlots - 1);
    return ring + (i % kSlots) * TILE;
  };

  for (int step = 0; step < n_steps; ++step) {
    const int tile0 = step * 2 * NSUB;
    // scores of the step's sub-tiles
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const __nv_bfloat16* ks = next_tile(tile0 + j);
      const __nv_bfloat16* q_frag = qs + (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;
      if constexpr (kQRegs) {
        if (tile0 + j == 0) {
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], smem_addr(q_frag + kk * 16));
        }
      }
      const int sub = step * NSUB + j;
      const int k0 = sub * kKeys;
      if constexpr (BY_POS) {
        int kmin = INT32_MAX;
        if (sub < n_sub) kmin = min(__ldg(kpos_b + k0 + lane), __ldg(kpos_b + k0 + lane + 32));
        live[j] = sub < n_sub && __reduce_min_sync(0xffffffffu, kmin) <= warp_qmax;
      } else {
        live[j] = sub < n_sub && (!causal || k0 <= warp_last);
      }
      if (!live[j]) continue;
#pragma unroll
      for (int nb = 0; nb < SBLK; ++nb) s[j][nb][0] = s[j][nb][1] = s[j][nb][2] = s[j][nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
          qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
        } else {
          ldmatrix_x4(qa, smem_addr(q_frag + kk * 16));
        }
#pragma unroll
        for (int np = 0; np < SBLK / 2; ++np) {  // keys 16np .. 16np+15
          uint32_t bf[4];
          const int key = np * 16 + lane % 8 + (lane / 16) * 8;
          const int col = kk * 16 + ((lane / 8) % 2) * 8;
          ldmatrix_x4(bf, smem_addr(ks + key * STRIDE + col));
          mma(s[j][2 * np], qa, bf[0], bf[1]);
          mma(s[j][2 * np + 1], qa, bf[2], bf[3]);
        }
      }
      if constexpr (BY_POS) {
#pragma unroll
        for (int nb = 0; nb < SBLK; ++nb) {
          const int2 kpos = __ldg(reinterpret_cast<const int2*>(kpos_b + k0 + nb * 8 + 2 * t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][nb][e] * sm_scale;
            if ((e % 2 ? kpos.y : kpos.x) > (e < 2 ? pos0 : pos1)) x = kNegInf;
            s[j][nb][e] = x;
          }
        }
      } else {
        const bool diagonal = causal && k0 + kKeys - 1 > warp_first;
#pragma unroll
        for (int nb = 0; nb < SBLK; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][nb][e] * sm_scale;
            if (diagonal && k0 + nb * 8 + 2 * t + (e % 2) > (e < 2 ? pos0 : pos1)) x = kNegInf;
            s[j][nb][e] = x;
          }
        }
      }
    }

    // the step's softmax, rows g and g + 8
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      if (!live[j]) continue;  // all NEG_INF: the max is m's or another sub-tile's
#pragma unroll
      for (int nb = 0; nb < SBLK; ++nb) {
        m_new[0] = fmaxf(m_new[0], fmaxf(s[j][nb][0], s[j][nb][1]));
        m_new[1] = fmaxf(m_new[1], fmaxf(s[j][nb][2], s[j][nb][3]));
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      corr[r] = exp2_approx((m_row[r] - m_new[r]) * kLog2e);
      m_row[r] = m_new[r];
      l_row[r] *= corr[r];
    }
#pragma unroll
    for (int d = 0; d < DBLK; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      if (!live[j]) continue;
#pragma unroll
      for (int nb = 0; nb < SBLK; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx((s[j][nb][e] - m_new[e / 2]) * kLog2e);
          l_row[e / 2] += p;
          s[j][nb][e] = p;
        }
      }
    }

    // acc += p . v, p rounded to bf16
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const __nv_bfloat16* vs = next_tile(tile0 + NSUB + j);
      if (!live[j]) continue;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[j][2 * kk][0], s[j][2 * kk][1]),
            pack_bf16(s[j][2 * kk][2], s[j][2 * kk][3]),
            pack_bf16(s[j][2 * kk + 1][0], s[j][2 * kk + 1][1]),
            pack_bf16(s[j][2 * kk + 1][2], s[j][2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < DBLK / 2; ++dp) {  // output dims 16dp .. 16dp+15
          uint32_t bf[4];
          const int key = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
          const int col = dp * 16 + (lane / 16) * 8;
          ldmatrix_x4_trans(bf, smem_addr(vs + key * STRIDE + col));
          mma(acc[2 * dp], pa, bf[0], bf[1]);
          mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }

  // acc / max(l, 1e-20), staged in the warp's own 16 rows of qs (no other
  // warp reads them), then 16-byte stores.
  float l_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_sum[r] = l_row[r];
    l_sum[r] += __shfl_xor_sync(0xffffffffu, l_sum[r], 1);
    l_sum[r] += __shfl_xor_sync(0xffffffffu, l_sum[r], 2);
    l_sum[r] = fmaxf(l_sum[r], 1e-20f);
  }
  __nv_bfloat16* os = qs + warp * 16 * STRIDE;
  __syncwarp();  // every lane's ldmatrix of these rows is done
#pragma unroll
  for (int d = 0; d < DBLK; ++d) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * STRIDE + d * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[d][0] / l_sum[0], acc[d][1] / l_sum[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * STRIDE + d * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[d][2] / l_sum[1], acc[d][3] / l_sum[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + ((static_cast<int64_t>(b) * h + head) * sq + warp_row) * HD;
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    if (warp * 16 + row < q_rows)
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(row) * HD + col) =
          *reinterpret_cast<const uint4*>(os + row * STRIDE + col);
  }
}

template <int HD, int NSUB, bool BY_POS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                   int h, int hkv, int sq, int skv, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (kRows + ring_slots(HD) * kKeys) * (HD + kPad);
  auto kernel = fa_tc_bf16<HD, NSUB, BY_POS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), qp, kp, h, hkv, sq, skv, sm_scale,
      causal);
  return cudaGetLastError();
}

template <int HD, bool BY_POS>
cudaError_t launch_bk(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int b,
                      int h, int hkv, int sq, int skv, int block_k, float sm_scale, int causal, cudaStream_t s) {
  switch (block_k) {
    case 64: return launch<HD, 1, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, sm_scale, causal, s);
    case 128: return launch<HD, 2, BY_POS>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, sm_scale, causal, s);
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

}  // namespace tc

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

// dtype 0 = bfloat16: fa_tc_bf16, hd 32, 64, 128 or 192, block_k 64 or 128.
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
    if (dtype == 0) return tc::launch_hd<true>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, 1, s);
    if (dtype == 1) return f32::launch_hd<true>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, 1, s);
  } else {
    if (dtype == 0)
      return tc::launch_hd<false>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
    if (dtype == 1)
      return f32::launch_hd<false>(q, k, v, o, qp, kp, b, h, hkv, sq, skv, hd, block_k, sm_scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
