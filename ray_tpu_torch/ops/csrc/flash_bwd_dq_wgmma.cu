// Flash-attention backward dQ for bf16 at head_dim 128 on Hopper (sm_90a):
// TMA loads into a ring of shared-memory stages, wgmma products, dS kept in
// registers. rt_flash_bwd_dq (flash_attention_bwd.cu) routes bf16 D128 here.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_dq_kernel (launched by
// _flash_backward), and the delta = rowsum(dO * O) that _flash_backward
// computes before it, for the shapes the model gives it. Same function as
// flash_attention_bwd.cu's dQ kernel: with S = scale * Q K^T (causal mask
// aligned to the END of the keys), P = exp(S - LSE), dP = dO V^T and
// dS = P * (dP - delta) * scale,
//   dQ = sum over kv tiles of dS K,
// with dS rounded to bf16 before its product, every sum in f32 and dQ
// stored in bf16. It also writes delta (f32) for the dK/dV kernel, which
// runs after it on the stream. A row that sees no key (causal, seq_q >
// seq_k) gets dQ = 0: its masked scores do not depend on q.
//
// What bounds it on the H100: at the train shape (B12 H32 S1024, causal)
// moving Q, K, V, O, dO and dQ once takes 0.18 ms at 3.35 TB/s and the
// three products (Q K^T, dO V^T, dS K), 2 * 128 operations each per visible
// (query, key) pair, 0.16 ms at 989 TFLOP/s. The design keeps the tensor
// cores fed from shared memory while K and V stream in:
//   * one block per (batch * head, 128-row q tile): two consumer warpgroups
//     of 64 rows (wgmma's M), 256 threads, 129 KB of shared memory, one
//     block per SM; Q and dO loaded once by TMA (two 64-column boxes each,
//     128-byte swizzle);
//   * K and V in 64-key tiles through a 2-stage ring, with "full" mbarriers
//     (TMA bytes landed) and "empty" ones (the eight warps are done)
//     separately for K and for V: V is done with after dP of its tile, K
//     only after dS K, so V's next load starts a product earlier. One
//     thread of warpgroup 1 issues every load;
//   * delta in the prologue: each warp sums dO * O for its 16 rows, dO from
//     shared memory and O from global in 16-byte pieces (loaded before the
//     wait for dO), two lanes a row; it is written to global and kept in
//     registers. LSE by plain loads, two rows a thread, zero past seq_q;
//   * per tile, S = Q K^T and dP = dO V^T as wgmma m64n64k16, both operands
//     from shared memory (K-major); dS in the accumulator's register layout,
//     packed to bf16 pairs, is the register A operand of dQ += dS K (wgmma
//     m64n128k16, K read again through an MN-major descriptor). dQ (64 f32
//     a thread) stays in registers for the whole loop (174 registers a
//     thread, no spill). A warpgroup's products and its dS run in turn, and
//     the other warpgroup's fill the gaps: issuing S, dP of tile n + 1
//     before dS K of tile n measured no faster on the H100 and takes far
//     more registers;
//   * exp2 on pre-scaled scores; masks only on tiles that cross the causal
//     diagonal or a ragged edge; a warpgroup skips the tiles its causal mask
//     hides whole (it still waits for each stage's loads before releasing
//     it, so no warp laps the loading thread);
//   * consecutive blocks are the q tiles of one head, last (heaviest,
//     causal) first, so they share that head's K and V in L2 (measured
//     faster than batch * head fastest); a 1-D grid, so batch * heads may
//     exceed 65535;
//   * dQ staged through shared memory (the warpgroup's rows of Q) and
//     stored 16 bytes a thread.
//
// Any seq_q and seq_k work: TMA zero-fills rows past either length; rows
// past seq_q are neither used nor stored, keys past seq_k are masked.

#include <climits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kDim = 128;
constexpr int kRows = 128;  // q rows a block owns, 64 per consumer warpgroup
constexpr int kKeys = 64;   // keys per K, V tile
constexpr int kStages = 2;
constexpr int kBlockThreads = 256;
constexpr uint32_t kQBytes = kRows * kDim * 2;   // 32 KB: two 64-column boxes
constexpr uint32_t kQHalf = kRows * 128;         // one box of Q or dO
constexpr uint32_t kKVBytes = kKeys * kDim * 2;  // 16 KB a tile
constexpr uint32_t kKVHalf = kKeys * 128;        // one box of K or V
constexpr uint32_t kOffDO = kQBytes;
constexpr uint32_t kOffK = 2 * kQBytes;                   // K stages
constexpr uint32_t kOffV = kOffK + kStages * kKVBytes;    // V stages
// Barriers: qdo_full, then per stage s K full (kOffBar + 8 + 8s), K empty,
// V full and V empty, kStages of each.
constexpr uint32_t kOffBar = kOffV + kStages * kKVBytes;
constexpr size_t kSmemBytes = kOffBar + (1 + 4 * kStages) * 8 + 1024;  // + alignment slack

struct Maps {
  CUtensorMap q, k, v, dout;
};

// The producer loads kv tile `tile` of K (or of V) into stage `stage`: two
// 64-column boxes counted on the stage's full barrier.
__device__ __forceinline__ void load_kv(const CUtensorMap* map, uint32_t dst, uint32_t full,
                                        int tile, int bh) {
  mbar_arrive_expect_tx(full, kKVBytes);
  tma_load_3d(dst, map, full, 0, tile * kKeys, bh);
  tma_load_3d(dst + kKVHalf, map, full, 64, tile * kKeys, bh);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const Maps maps, const __nv_bfloat16* __restrict__ o,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int seq_q, int seq_k, int causal,
                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t qdo_full = base + kOffBar;
  auto k_full = [&](int s) { return base + kOffBar + 8 + 8 * s; };
  auto k_empty = [&](int s) { return base + kOffBar + 8 + 8 * (kStages + s); };
  auto v_full = [&](int s) { return base + kOffBar + 8 + 8 * (2 * kStages + s); };
  auto v_empty = [&](int s) { return base + kOffBar + 8 + 8 * (3 * kStages + s); };

  // Consecutive blocks are the q tiles of one head, heaviest (causal) first.
  const int q_tiles = (seq_q + kRows - 1) / kRows;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const int q0w = q0 + 64 * wg;  // this warpgroup's first row
  const float scale_log2 = scale * kLog2e;
  const size_t row_base = (size_t)bh * seq_q;
  // The thread that issues the loads: the first of warpgroup 1.
  const bool producer = tid == 128;

  // The kv tiles this block needs: all of them, or (causal) those up to the
  // one holding the last key that the block's last row may see; none when
  // every row of the block sees no key.
  int n_tiles = (seq_k + kKeys - 1) / kKeys;
  if (causal) {
    const int last_key = causal_offset + min(q0 + kRows, seq_q) - 1;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kKeys + 1);
  }
  // This warpgroup's share: the tiles past its last visible key, the last
  // ones, add nothing (none at all when its rows are past seq_q or see no key).
  int n_mine = n_tiles;
  if (q0w >= seq_q) {
    n_mine = 0;
  } else if (causal) {
    const int last_key = causal_offset + min(q0w + 64, seq_q) - 1;
    n_mine = last_key < 0 ? 0 : min(n_tiles, last_key / kKeys + 1);
  }

  if (tid == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per warp
      mbar_init(v_empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (producer) {
    mbar_arrive_expect_tx(qdo_full, 2 * kQBytes);
    tma_load_3d(base, &maps.q, qdo_full, 0, q0, bh);
    tma_load_3d(base + kQHalf, &maps.q, qdo_full, 64, q0, bh);
    tma_load_3d(base + kOffDO, &maps.dout, qdo_full, 0, q0, bh);
    tma_load_3d(base + kOffDO + kQHalf, &maps.dout, qdo_full, 64, q0, bh);
    for (int s = 0; s < kStages && s < n_tiles; ++s) {
      load_kv(&maps.k, base + kOffK + s * kKVBytes, k_full(s), s, bh);
      load_kv(&maps.v, base + kOffV + s * kKVBytes, v_full(s), s, bh);
    }
  }
  __syncwarp();

  // The two rows this thread's accumulator elements belong to.
  const int rows[2] = {q0w + warp * 16 + g, q0w + warp * 16 + g + 8};
  float lse_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_log2[r] = rows[r] < seq_q ? lse[row_base + rows[r]] * kLog2e : 0.f;
  }

  // delta = rowsum(dO * O) for the warp's 16 rows: lanes 2i and 2i + 1 take
  // row i, the even and the odd 16-byte pieces of it. O is read while the
  // TMA brings dO.
  float row_delta[2];
  {
    const int drow = warp * 16 + (lane >> 1);  // row of the warpgroup
    const int half = lane & 1;
    const bool in = q0w + drow < seq_q;
    int4 ov[8];
    if (in) {
      const int4* orow = reinterpret_cast<const int4*>(o + (row_base + q0w + drow) * kDim);
#pragma unroll
      for (int i = 0; i < 8; ++i) ov[i] = __ldg(orow + 2 * i + half);
    }
    mbar_wait(qdo_full, 0);
    float part = 0.f;
    if (in) {
      const int trow = 64 * wg + drow;  // row of the dO tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 2 * i + half;
        const uint32_t off =
            kOffDO + (c >> 3) * kQHalf + trow * 128 + (((c & 7) ^ (trow & 7)) << 4);
        const int4 dv = *reinterpret_cast<const int4*>(smem + off);
        const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&dv);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 x = __bfloat1622float2(a[h]);
          const float2 y = __bfloat1622float2(b[h]);
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (in && half == 0) delta[row_base + q0w + drow] = part;
    row_delta[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    row_delta[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
  }

  // This warpgroup's 64 rows of Q and dO as A operands.
  const uint64_t desc_q = make_desc(base + 64 * wg * 128, 0, 1024);
  const uint64_t desc_do = make_desc(base + kOffDO + 64 * wg * 128, 0, 1024);

  // S = Q K^T and dP = dO V^T of tile n: one commit group.
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int n) {
    const int stage = n % kStages;
    const uint64_t desc_k = make_desc(base + kOffK + stage * kKVBytes, 0, 1024);
    const uint64_t desc_v = make_desc(base + kOffV + stage * kKVBytes, 0, 1024);
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) {
      const uint32_t off_q = (kk >> 2) * kQHalf + (kk & 3) * 32;
      const uint32_t off_kv = (kk >> 2) * kKVHalf + (kk & 3) * 32;
      wgmma_ss_n64(s, desc_add(desc_q, off_q), desc_add(desc_k, off_kv), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) {
      const uint32_t off_q = (kk >> 2) * kQHalf + (kk & 3) * 32;
      const uint32_t off_kv = (kk >> 2) * kKVHalf + (kk & 3) * 32;
      wgmma_ss_n64(dp, desc_add(desc_do, off_q), desc_add(desc_v, off_kv), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K of tile n: four k-steps over the tile's keys, one commit group.
  auto issue_dq = [&](float (&acc)[64], const uint32_t (&da)[4][4], int n) {
    const uint64_t desc_k = make_desc(base + kOffK + (n % kStages) * kKVBytes, kKVHalf, 1024);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs_n128(acc, da[kk], desc_add(desc_k, kk * 2048));
    }
    wgmma_commit();
  };
  // dS of tile n from S and dP (element 4j + e at row rows[e / 2], key
  // k0 + 8j + 2t + e % 2), packed to the bf16 A operand of dS K: k-step kk
  // takes keys 16kk..16kk+15, its four registers rows g and g + 8 of the
  // first 8 keys, then of the next 8.
  auto make_ds = [&](uint32_t (&da)[4][4], const float (&s)[32], float (&dp)[32], int n) {
    const int k0 = n * kKeys;
    const bool need_mask = k0 + kKeys > seq_k || q0w + 64 > seq_q ||
                           (causal && q0w + causal_offset < k0 + kKeys - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = fast_exp2(fmaf(s[i], scale_log2, -lse_log2[r]));
      float ds = p * (dp[i] - row_delta[r]) * scale;
      if (need_mask) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key >= seq_k || rows[r] >= seq_q || (causal && rows[r] + causal_offset < key)) {
          ds = 0.f;
        }
      }
      dp[i] = ds;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * kk + 4 * (h >> 1) + 2 * (h & 1);
        da[kk][h] = pack_bf16(dp[i], dp[i + 1]);
      }
    }
  };
  // Tile n's V (or K) stage is free once all eight warps are done with it;
  // the producer then loads tile n + kStages into it.
  auto release_v = [&](int n) {
    const int stage = n % kStages;
    if (lane == 0) mbar_arrive(v_empty(stage));
    if (producer && n + kStages < n_tiles) {
      mbar_wait(v_empty(stage), (n / kStages) & 1);
      load_kv(&maps.v, base + kOffV + stage * kKVBytes, v_full(stage), n + kStages, bh);
    }
    __syncwarp();
  };
  auto release_k = [&](int n) {
    const int stage = n % kStages;
    if (lane == 0) mbar_arrive(k_empty(stage));
    if (producer && n + kStages < n_tiles) {
      mbar_wait(k_empty(stage), (n / kStages) & 1);
      load_kv(&maps.k, base + kOffK + stage * kKVBytes, k_full(stage), n + kStages, bh);
    }
    __syncwarp();
  };
  auto wait_full = [&](int n) {
    mbar_wait(k_full(n % kStages), (n / kStages) & 1);
    mbar_wait(v_full(n % kStages), (n / kStages) & 1);
  };

  float acc[64], s[32], dp[32];
  uint32_t da[4][4];  // dS as bf16 pairs
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int n = 0; n < n_mine; ++n) {
    wait_full(n);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_sdp(s, dp, n);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    release_v(n);
    make_ds(da, s, dp, n);
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
    issue_dq(acc, da, n);
    wgmma_wait<0>();
    fence_regs(acc);
    release_k(n);
  }
  // The tiles this warpgroup skips: it waits for each stage's loads before
  // releasing it, so that no warp arrives on an empty barrier a phase early.
  for (int n = n_mine; n < n_tiles; ++n) {
    wait_full(n);
    release_v(n);
    release_k(n);
  }

  // Stage dQ (bf16) in this warpgroup's rows of Q, in the same swizzled
  // layout, and store it 16 bytes a thread.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + warp * 16 + g + 8 * r;  // row of the Q tile
      const uint32_t off = (j >> 3) * kQHalf + row * 128 + (((j & 7) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + off) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
  named_barrier(1 + wg, 128);
  const int wtid = tid & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = wtid + 128 * i;
    const int row = idx >> 4, c = idx & 15;  // 16-byte chunk c of the row
    if (q0w + row >= seq_q) continue;
    const int tile_row = 64 * wg + row;
    const uint32_t off = (c >> 3) * kQHalf + tile_row * 128 + (((c & 7) ^ (tile_row & 7)) << 4);
    *reinterpret_cast<int4*>(dq + (row_base + q0w + row) * kDim + 8 * c) =
        *reinterpret_cast<const int4*>(smem + off);
  }
}

}  // namespace

namespace flash {

cudaError_t flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq, int bh,
                               int seq_q, int seq_k, int causal, float scale,
                               cudaStream_t stream) {
  Maps maps;
  cudaError_t err = encode_rows_map(&maps.q, q, bh, seq_q, kRows);
  if (err == cudaSuccess) err = encode_rows_map(&maps.dout, dout, bh, seq_q, kRows);
  if (err == cudaSuccess) err = encode_rows_map(&maps.k, k, bh, seq_k, kKeys);
  if (err == cudaSuccess) err = encode_rows_map(&maps.v, v, bh, seq_k, kKeys);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((seq_q + kRows - 1) / kRows) * bh;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<<<(unsigned)blocks, kBlockThreads, kSmemBytes, stream>>>(
      maps, static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq), seq_q, seq_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace flash
