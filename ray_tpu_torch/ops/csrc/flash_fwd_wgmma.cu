// Flash-attention forward for bf16 at head_dim 128 on Hopper (sm_90a):
// TMA loads into a ring of shared-memory stages, wgmma products, P kept in
// registers. rt_flash_fwd (flash_attention_fwd.cu) routes bf16 D128 here.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_fwd_kernel (launched by
// _flash_forward), for the shapes the model gives it. Same function as
// flash_attention_fwd.cu: O = softmax(scale * Q K^T) V with the causal mask
// aligned to the END of the keys (causal_offset = seq_k - seq_q), masked
// scores -1e30 and keys past seq_k -inf, P rounded to bf16 before P V, f32
// running max, sum and accumulator, O = acc / max(l, 1e-30), and the
// natural-log LSE = m + log(l) in f32 that the backward reads.
//
// What bounds it on the H100: at the train shape (B12 H32 S1024, causal)
// moving Q, K, V and O once takes 0.12 ms at 3.35 TB/s and the two products
// 0.10 ms at 989 TFLOP/s, so the kernel has to keep the tensor cores fed
// while K and V stream in and the softmax runs. The design:
//   * one block per (batch * head, 128-row q tile): two consumer
//     warpgroups of 64 q rows (wgmma's M), 256 threads, 160 KB of shared
//     memory, one block per SM;
//   * Q loaded once by TMA; K and V in 128-key tiles through a 2-stage
//     ring, each tile two 64-column TMA boxes with 128-byte swizzle. Each
//     stage has "full" mbarriers (TMA bytes landed) and "empty" ones (the
//     eight warps are done), separately for K and for V: K is done with
//     after S of its tile, V only after P V. One thread of warpgroup 1
//     issues every load, so no thread copies through registers;
//   * S = Q K^T as eight wgmma m64n128k16 per warpgroup, both operands from
//     shared memory (K-major); P converted to bf16 in registers is the
//     register A operand of O += P V (wgmma m64n128k16, V MN-major);
//   * inside a warpgroup, S of tile n and P V of tile n - 1 are issued
//     together and tile n's softmax runs while P V does; between the two
//     warpgroups, named barriers make them take turns issuing products
//     (ping-pong), so one's softmax runs under the other's products;
//   * scores scaled by scale * log2(e) inside the exponent's FFMA, ex2 for
//     the exponent; the masks are evaluated only on tiles that cross the
//     causal diagonal or the ragged seq_k edge, and a warpgroup skips a
//     tile its causal mask hides whole;
//   * consecutive blocks are the q tiles of one head, last (heaviest,
//     causal) first, so they share that head's K and V in L2 and the light
//     tiles fill the card's tail;
//   * O staged through shared memory and stored 16 bytes a thread.
//
// Any seq_q and seq_k work: TMA zero-fills rows past either length, rows
// past seq_q are not stored, keys past seq_k score -inf. A row that sees no
// key (causal, seq_q > seq_k) scores -1e30 everywhere, which gives it equal
// weights over every key, as attention_reference does; its LSE is -1e30.

#include <climits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;
using flash::kMasked;

constexpr int kDim = 128;
constexpr int kRows = 128;  // q rows a block owns, 64 per consumer warpgroup
constexpr int kKeys = 128;  // keys per K, V tile
constexpr int kBlockThreads = 256;
constexpr uint32_t kQBytes = kRows * kDim * 2;     // 32 KB: two 64-column boxes
constexpr uint32_t kKVBytes = kKeys * kDim * 2;    // 32 KB a tile
constexpr uint32_t kQHalf = kRows * 128;           // one box of Q
constexpr uint32_t kKVHalf = kKeys * 128;          // one box of K or V
constexpr uint32_t kOffK = kQBytes;                // K stages 0, 1
constexpr uint32_t kOffV = kOffK + 2 * kKVBytes;   // V stages 0, 1
// Barriers: q_full, then per stage s the K tile's full (kOffBar + 8 + 8s)
// and empty (+ 24 + 8s) barriers, then the V tile's (+ 40 + 8s, + 56 + 8s).
constexpr uint32_t kOffBar = kOffV + 2 * kKVBytes;
constexpr size_t kSmemBytes = kOffBar + 9 * 8 + 1024;  // + slack to align the base to 1024

// The producer loads kv tile `tile` of K (or of V: kOffset = kOffV, kBar =
// 40) into stage `stage`: two 64-column boxes on the stage's full barrier.
template <uint32_t kOffset, uint32_t kBar>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t base, int stage,
                                          int tile, int bh) {
  const uint32_t full = base + kOffBar + kBar + 8 * stage;
  const uint32_t dst = base + kOffset + stage * kKVBytes;
  mbar_arrive_expect_tx(full, kKVBytes);
  tma_load_3d(dst, map, full, 0, tile * kKeys, bh);
  tma_load_3d(dst + kKVHalf, map, full, 64, tile * kKeys, bh);
}

// S = Q K^T of kv tile n: eight k-steps over head_dim, one commit group.
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t desc_q, uint32_t base, int n) {
  const uint64_t desc_k = make_desc(base + kOffK + (n & 1) * kKVBytes, 0, 1024);
#pragma unroll
  for (int kk = 0; kk < kDim / 16; ++kk) {
    const uint32_t off_q = (kk >> 2) * kQHalf + (kk & 3) * 32;
    const uint32_t off_k = (kk >> 2) * kKVHalf + (kk & 3) * 32;
    wgmma_ss_n128(s, desc_add(desc_q, off_q), desc_add(desc_k, off_k), kk > 0);
  }
  wgmma_commit();
}

// O += P V of kv tile n: eight k-steps over the tile's keys, one commit group.
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pa)[8][4],
                                         uint32_t base, int n) {
  const uint64_t desc_v = make_desc(base + kOffV + (n & 1) * kKVBytes, kKVHalf, 1024);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_rs_n128(acc, pa[kk], desc_add(desc_v, kk * 2048));
  }
  wgmma_commit();
}

// The online softmax of one tile of scores s (keys k0..k0+127) in place:
// scores to log2 units, masked only where the tile crosses the causal
// diagonal or the ragged edge of the keys; the running max m and this
// thread's share of the sum l updated; s left holding P in f32; corr the
// factor the accumulator is to be rescaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&rows)[2], int k0,
                                             int seq_k, int causal, int causal_offset, int q0w,
                                             int t, float scale_log2) {
  const bool need_mask = k0 + kKeys > seq_k || (causal && k0 + kKeys - 1 > q0w + causal_offset);
  float m_cur[2] = {-INFINITY, -INFINITY};
  if (!need_mask) {
    // No mask: the max of the raw scores, and one FFMA a score for the
    // scale and the max.
#pragma unroll
    for (int i = 0; i < 64; ++i) m_cur[(i >> 1) & 1] = fmaxf(m_cur[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m[r], m_cur[r] * scale_log2);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -m[r]));
      l[r] += s[i];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      if (key >= seq_k) {
        x = -INFINITY;
      } else if (causal && rows[e >> 1] + causal_offset < key) {
        x = kMasked;
      }
      s[4 * j + e] = x;
      m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
    const float m_new = fmaxf(m[r], m_cur[r]);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - m[r]);
    l[r] += s[i];
  }
}

// P (f32, accumulator layout) to the bf16 A operand of P V: k-step kk takes
// the tile's keys 16kk..16kk+15, its four registers rows g and g + 8 of the
// first 8 keys, then of the next 8.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = 8 * kk + 4 * (h >> 1) + 2 * (h & 1);
      pa[kk][h] = pack_bf16(s[i], s[i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int seq_q, int seq_k, int causal,
                       float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + kOffBar;
  auto k_full = [&](int s) { return base + kOffBar + 8 + 8 * s; };
  auto k_empty = [&](int s) { return base + kOffBar + 24 + 8 * s; };
  auto v_full = [&](int s) { return base + kOffBar + 40 + 8 * s; };
  auto v_empty = [&](int s) { return base + kOffBar + 56 + 8 * s; };

  // Consecutive blocks are the q tiles of one head, heaviest (causal) first,
  // so they share that head's K and V in L2. A 1-D grid: batch * heads may
  // exceed gridDim.y's 65535.
  const int q_tiles = (seq_q + kRows - 1) / kRows;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const int q0w = q0 + 64 * wg;  // this warpgroup's first row
  // The thread that issues the loads: in warpgroup 1, which takes its turn
  // second, so its waits for both warpgroups to be done with a stage are
  // short.
  const bool producer = tid == 128;

  // The kv tiles this block needs: all of them, or (causal) those up to the
  // one holding the last key that the block's last row may see. A block
  // holding a row that sees no key visits every tile.
  int n_tiles = (seq_k + kKeys - 1) / kKeys;
  if (causal && causal_offset + q0 >= 0) {
    const int last_key = causal_offset + min(q0 + kRows, seq_q) - 1;
    n_tiles = min(n_tiles, last_key / kKeys + 1);
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per warp
      mbar_init(v_empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (producer) {
    mbar_arrive_expect_tx(q_full, kQBytes);
    tma_load_3d(base, &tm_q, q_full, 0, q0, bh);
    tma_load_3d(base + kQHalf, &tm_q, q_full, 64, q0, bh);
    for (int s = 0; s < 2 && s < n_tiles; ++s) {
      load_tile<kOffK, 8>(&tm_k, base, s, s, bh);
      load_tile<kOffV, 40>(&tm_v, base, s, s, bh);
    }
  }

  // This warpgroup's 64 Q rows as the A operand: rows 64 * wg of each box.
  const uint64_t desc_q = make_desc(base + 64 * wg * 128, 0, 1024);
  const int rows[2] = {q0w + warp * 16 + g, q0w + warp * 16 + g + 8};
  // Causal: the tiles past this warpgroup's last visible key add nothing
  // and are skipped; they are the last ones. (A warpgroup holding a row
  // that sees no key weighs every key and skips none.)
  int n_mine = n_tiles;
  if (causal && q0w + causal_offset >= 0) {
    n_mine = min(n_tiles, (q0w + 63 + causal_offset) / kKeys + 1);
  }

  float m[2] = {kMasked, kMasked};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float acc[64], s[64], corr[2];
  uint32_t pa[8][4];  // P in bf16: the A operand of the eight k-steps of P V
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;

  // Tile n's K (or V) stage is free once both warpgroups are done with it;
  // the producer then loads tile n + 2's K (or V) into it. K is done with after
  // S of its tile, V only after P V, an iteration later.
  auto release_k = [&](int n) {
    if (lane == 0) mbar_arrive(k_empty(n & 1));
    if (producer && n + 2 < n_tiles) {
      mbar_wait(k_empty(n & 1), (n >> 1) & 1);
      load_tile<kOffK, 8>(&tm_k, base, n & 1, n + 2, bh);
    }
    __syncwarp();
  };
  auto release_v = [&](int n) {
    if (lane == 0) mbar_arrive(v_empty(n & 1));
    if (producer && n + 2 < n_tiles) {
      mbar_wait(v_empty(n & 1), (n >> 1) & 1);
      load_tile<kOffV, 40>(&tm_v, base, n & 1, n + 2, bh);
    }
    __syncwarp();
  };

  // Ping-pong: the warpgroups take turns issuing their products (named
  // barriers 3 and 4), so one computes its softmax while the other's
  // products run. Both take n_tiles + 1 turns (a skipped tile's turn issues
  // nothing); warpgroup 0 goes first.
  int turns_left = n_tiles + 1;
  auto turn_begin = [&]() { named_barrier(3 + wg, 256); };
  auto turn_end = [&]() {
    if (--turns_left > 0 || wg == 0) named_arrive(3 + (wg ^ 1), 256);
  };
  if (wg == 1) named_arrive(3, 256);

  // Each iteration issues S = Q K^T of tile n and O += P V of tile n - 1
  // together, then computes tile n's softmax while P V still runs on the
  // tensor cores; O is rescaled once P V is done.
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  fence_regs(s);
  turn_begin();
  wgmma_fence();
  issue_s(s, desc_q, base, 0);
  turn_end();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m, l, corr, rows, 0, seq_k, causal, causal_offset, q0w, t, scale_log2);
  release_k(0);
  pack_p(pa, s);
  for (int n = 1; n < n_mine; ++n) {
    mbar_wait(k_full(n & 1), (n >> 1) & 1);
    mbar_wait(v_full((n - 1) & 1), ((n - 1) >> 1) & 1);
    fence_regs(s);
    fence_regs(acc);
    fence_regs(pa);
    turn_begin();
    wgmma_fence();
    issue_s(s, desc_q, base, n);
    issue_pv(acc, pa, base, n - 1);
    turn_end();
    wgmma_wait<1>();  // S of tile n is in; P V of tile n - 1 still runs
    fence_regs(s);
    softmax_tile(s, m, l, corr, rows, n * kKeys, seq_k, causal, causal_offset, q0w, t,
                 scale_log2);
    release_k(n);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release_v(n - 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p(pa, s);
  }
  mbar_wait(v_full((n_mine - 1) & 1), ((n_mine - 1) >> 1) & 1);
  fence_regs(acc);
  fence_regs(pa);
  turn_begin();
  wgmma_fence();
  issue_pv(acc, pa, base, n_mine - 1);
  turn_end();
  wgmma_wait<0>();
  fence_regs(acc);
  release_v(n_mine - 1);
  for (int n = n_mine; n < n_tiles; ++n) {
    turn_begin();
    turn_end();
    release_k(n);
    release_v(n);
  }

  // Normalise, write the LSE, and stage O (bf16) in this warpgroup's Q rows,
  // in the same swizzled layout, for 16-byte stores.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / denom;
    if (t == 0 && rows[r] < seq_q) {
      // m == kMasked: the row sees no key; the reference's -1e30 + log(n)
      // rounds to -1e30.
      lse[(size_t)bh * seq_q + rows[r]] = m[r] == kMasked ? kMasked : m[r] * kLn2 + logf(denom);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + warp * 16 + g + 8 * r;  // row of the Q tile
      const uint32_t off = (j >> 3) * kQHalf + row * 128 + (((j & 7) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + off) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
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
    *reinterpret_cast<int4*>(o + ((size_t)bh * seq_q + q0w + row) * kDim + 8 * c) =
        *reinterpret_cast<const int4*>(smem + off);
  }
}

}  // namespace

namespace flash {

cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int seq_q, int seq_k, int causal, float scale,
                            cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_rows_map(&tm_q, q, bh, seq_q, kRows);
  if (err == cudaSuccess) err = encode_rows_map(&tm_k, k, bh, seq_k, kKeys);
  if (err == cudaSuccess) err = encode_rows_map(&tm_v, v, bh, seq_k, kKeys);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((seq_q + kRows - 1) / kRows) * bh;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<<<(unsigned)blocks, kBlockThreads, kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), seq_q, seq_k,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace flash
