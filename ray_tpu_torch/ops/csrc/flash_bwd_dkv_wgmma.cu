// Flash-attention backward dK/dV for bf16 at head_dim 128 on Hopper
// (sm_90a): TMA loads into a ring of shared-memory stages, wgmma products,
// P^T and dS^T kept in registers. rt_flash_bwd_dkv (flash_attention_bwd.cu)
// routes bf16 D128 here.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_dkv_kernel (launched by
// _flash_backward), for the shapes the model gives it. Same function as
// flash_attention_bwd.cu's dK/dV kernel: with S = scale * Q K^T (causal mask
// aligned to the END of the keys), P = exp(S - LSE), dP = dO V^T and
// dS = P * (dP - delta) * scale, where delta = rowsum(dO * O) comes from the
// dQ kernel that runs first on the stream,
//   dV = sum over q tiles of P^T dO,  dK = sum over q tiles of dS^T Q,
// with P and dS rounded to bf16 before their products, every sum in f32
// and dK, dV stored in bf16. A row that sees no key (causal, seq_q > seq_k)
// adds dO / seq_k to every dV row and nothing to dK.
//
// What bounds it on the H100: the four products (K Q^T, V dO^T, P^T dO,
// dS^T Q), 2 * 128 operations each per visible (query, key) pair: 0.21 ms
// at the train shape (B12 H32 S1024, causal) at 989 TFLOP/s, against
// 0.06 ms to move its bytes once. The design feeds the tensor cores from
// shared memory with wgmma and keeps the loads off the threads:
//   * one block per (batch * head, 128-key tile): two consumer warpgroups of
//     64 keys (wgmma's M), 256 threads, 129 KB of shared memory, one block
//     per SM; K and V of the block's keys loaded once by TMA;
//   * Q and dO in 64-row tiles through a 2-stage ring: TMA boxes of 64
//     columns with 128-byte swizzle, plus LSE and delta for the tile's rows
//     by 4-byte cp.async (zero past seq_q), all issued by one warp and
//     counted on the stage's "full" mbarrier; the eight warps arrive on the
//     stage's "empty" mbarrier when done, and the loading warp then refills
//     it with tile m + 2;
//   * S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 with the keys as
//     rows, all operands from shared memory (K-major), so P^T and dS^T come
//     out in the register layout of the next products' A operand:
//     dV += P^T dO and dK += dS^T Q are wgmma m64n128k16 with A from
//     registers and dO, Q from shared memory (MN-major). dK and dV (2 x 64
//     f32 a thread) stay in registers for the whole loop;
//   * exp2 on pre-scaled scores; masks only on tiles that cross the causal
//     diagonal or a ragged edge, and a warpgroup skips a q tile its causal
//     mask hides whole;
//   * the block starts at the first q tile the causal mask needs, and the
//     heaviest blocks (the first keys) are launched first;
//   * dK, dV staged through shared memory and stored 16 bytes a thread.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kDim = 128;
constexpr int kKeys = 128;  // keys a block owns, 64 per consumer warpgroup
constexpr int kRows = 64;   // q rows per Q, dO tile
constexpr int kBlockThreads = 256;
constexpr uint32_t kKVBytes = kKeys * kDim * 2;  // 32 KB: two 64-column boxes
constexpr uint32_t kKVHalf = kKeys * 128;
constexpr uint32_t kQBytes = kRows * kDim * 2;   // 16 KB a tile
constexpr uint32_t kQHalf = kRows * 128;
constexpr uint32_t kOffV = kKVBytes;
constexpr uint32_t kOffQ = 2 * kKVBytes;          // Q stages 0, 1
constexpr uint32_t kOffDO = kOffQ + 2 * kQBytes;  // dO stages 0, 1
constexpr uint32_t kOffRows = kOffDO + 2 * kQBytes;  // per stage: LSE[64], delta[64]
constexpr uint32_t kOffBar = kOffRows + 2 * 2 * kRows * 4;  // kv_full, full[2], empty[2]
constexpr size_t kSmemBytes = kOffBar + 5 * 8 + 1024;

struct Maps {
  CUtensorMap q, k, v, dout;
};

// The loading warp fills stage `stage` with q tile `tile`: lane 0 the TMA
// boxes of Q and dO, every lane two rows of LSE and delta.
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const float* lse, const float* delta, uint32_t base,
                                            int stage, int tile, int bh, int seq_q, int lane) {
  const uint32_t full = base + kOffBar + 8 + 8 * stage;
  const int q0 = tile * kRows;
  if (lane == 0) {
    const uint32_t sq = base + kOffQ + stage * kQBytes;
    const uint32_t sdo = base + kOffDO + stage * kQBytes;
    mbar_arrive_expect_tx(full, 2 * kQBytes);
    tma_load_3d(sq, tm_q, full, 0, q0, bh);
    tma_load_3d(sq + kQHalf, tm_q, full, 64, q0, bh);
    tma_load_3d(sdo, tm_do, full, 0, q0, bh);
    tma_load_3d(sdo + kQHalf, tm_do, full, 64, q0, bh);
  }
  const uint32_t rows = base + kOffRows + stage * 2 * kRows * 4;
  const size_t row_base = (size_t)bh * seq_q;
#pragma unroll
  for (int i = lane; i < kRows; i += 32) {
    const bool in = q0 + i < seq_q;
    const size_t at = in ? row_base + q0 + i : 0;
    cp_async_4(rows + 4 * i, lse + at, in);
    cp_async_4(rows + 4 * (kRows + i), delta + at, in);
  }
  cp_async_arrive(full);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const Maps maps, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int seq_q, int seq_k, int causal,
                           float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + kOffBar;
  auto full = [&](int s) { return base + kOffBar + 8 + 8 * s; };
  auto empty = [&](int s) { return base + kOffBar + 24 + 8 * s; };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;  // y = 0, the heaviest causal tile, first
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
  const float scale_log2 = scale * kLog2e;
  // The warp that issues the loads: the first of warpgroup 1, whose own
  // products then do not wait behind a refill.
  const bool producer = wg == 1 && warp == 0;

  // The q tiles this block needs: (causal) from the one holding the first
  // row that may see the block's first key. With seq_q > seq_k the first
  // rows see no key and weigh every key, so every tile is visited.
  const int end = (seq_q + kRows - 1) / kRows;
  int first = 0;
  if (causal && causal_offset >= 0) first = max(0, k0 - causal_offset) / kRows;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA issuer, and the loading warp's cp.asyncs
      mbar_init(empty(s), 8);      // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (producer) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
      tma_load_3d(base, &maps.k, kv_full, 0, k0, bh);
      tma_load_3d(base + kKVHalf, &maps.k, kv_full, 64, k0, bh);
      tma_load_3d(base + kOffV, &maps.v, kv_full, 0, k0, bh);
      tma_load_3d(base + kOffV + kKVHalf, &maps.v, kv_full, 64, k0, bh);
    }
    for (int s = 0; s < 2 && first + s < end; ++s) {
      load_q_tile(&maps.q, &maps.dout, lse, delta, base, s, first + s, bh, seq_q, lane);
    }
  }
  __syncwarp();

  // This warpgroup's 64 keys of K and V as A operands.
  const uint64_t desc_k = make_desc(base + 64 * wg * 128, 0, 1024);
  const uint64_t desc_v = make_desc(base + kOffV + 64 * wg * 128, 0, 1024);
  // The two keys this thread's accumulator rows belong to.
  const int keys[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};

  float acc_dk[64], acc_dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int m = first; m < end; ++m) {
    const int i = m - first;
    const int stage = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int q0 = m * kRows;
    // Causal: a q tile whose rows all see keys, none of them this
    // warpgroup's, adds nothing.
    const bool skip = causal && q0 + causal_offset >= 0 && q0 + kRows - 1 + causal_offset < kw0;
    // Every warp waits for the tile's loads, a skipping one too: none may
    // arrive on empty(stage) for tile m + 2 before the loading warp has
    // refilled the stage with it, or that warp's parity wait would see the
    // wrong phase.
    mbar_wait(full(stage), parity);
    if (!skip) {
      const uint32_t sq = base + kOffQ + stage * kQBytes;
      const uint32_t sdo = base + kOffDO + stage * kQBytes;
      const uint64_t desc_q = make_desc(sq, 0, 1024);
      const uint64_t desc_do = make_desc(sdo, 0, 1024);
      float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 rows
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDim / 16; ++kk) {
        const uint32_t off_kv = (kk >> 2) * kKVHalf + (kk & 3) * 32;
        const uint32_t off_q = (kk >> 2) * kQHalf + (kk & 3) * 32;
        wgmma_ss_n64(st, desc_add(desc_k, off_kv), desc_add(desc_q, off_q), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kDim / 16; ++kk) {
        const uint32_t off_kv = (kk >> 2) * kKVHalf + (kk & 3) * 32;
        const uint32_t off_q = (kk >> 2) * kQHalf + (kk & 3) * 32;
        wgmma_ss_n64(dpt, desc_add(desc_v, off_kv), desc_add(desc_do, off_q), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, element 4j + e at key keys[e / 2], row q0 + 8j + 2t + e % 2.
      const float* s_lse = reinterpret_cast<const float*>(
          smem + kOffRows + stage * 2 * kRows * 4);
      const float* s_delta = s_lse + kRows;
      const bool need_mask = q0 + kRows > seq_q || kw0 + 64 > seq_k ||
                             (causal && q0 + causal_offset < kw0 + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(s_lse + col);
        const float2 dl2 = *reinterpret_cast<const float2*>(s_delta + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float row_lse = ((e & 1) ? lse2.y : lse2.x) * kLog2e;
          const float row_delta = (e & 1) ? dl2.y : dl2.x;
          const float p = fast_exp2(st[4 * j + e] * scale_log2 - row_lse);
          float pv = p, ds = p * (dpt[4 * j + e] - row_delta) * scale;
          if (need_mask) {
            const int key = keys[e >> 1];
            const int row = q0 + col + (e & 1);
            if (key >= seq_k || row >= seq_q) {
              pv = ds = 0.f;
            } else if (causal && row + causal_offset < 0) {
              pv = 1.f / seq_k;  // a row that sees no key
              ds = 0.f;
            } else if (causal && row + causal_offset < key) {
              pv = ds = 0.f;
            }
          }
          st[4 * j + e] = pv;
          dpt[4 * j + e] = ds;
        }
      }
      uint32_t pa[4][4], da[4][4];  // the A operands of the four k-steps (16 rows each)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int idx = 8 * kk + 4 * (h >> 1) + 2 * (h & 1);
          pa[kk][h] = pack_bf16(st[idx], st[idx + 1]);
          da[kk][h] = pack_bf16(dpt[idx], dpt[idx + 1]);
        }
      }
      const uint64_t desc_do_mn = make_desc(sdo, kQHalf, 1024);
      const uint64_t desc_q_mn = make_desc(sq, kQHalf, 1024);
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_rs_n128(acc_dv, pa[kk], desc_add(desc_do_mn, kk * 2048));
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_rs_n128(acc_dk, da[kk], desc_add(desc_q_mn, kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    if (lane == 0) mbar_arrive(empty(stage));
    if (producer && m + 2 < end) {
      mbar_wait(empty(stage), parity);
      load_q_tile(&maps.q, &maps.dout, lse, delta, base, stage, m + 2, bh, seq_q, lane);
    }
    __syncwarp();
  }

  // Stage dK and dV (bf16) in this warpgroup's rows of K and V, in the same
  // swizzled layout, and store them 16 bytes a thread.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + warp * 16 + g + 8 * r;  // row of the K, V tile
      const uint32_t off = (j >> 3) * kKVHalf + row * 128 + (((j & 7) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + off) =
          pack_bf16(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(smem + kOffV + off) =
          pack_bf16(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
  named_barrier(1 + wg, 128);
  const int wtid = tid & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = wtid + 128 * i;
    const int row = idx >> 4, c = idx & 15;
    if (kw0 + row >= seq_k) continue;
    const int tile_row = 64 * wg + row;
    const uint32_t off = (c >> 3) * kKVHalf + tile_row * 128 + (((c & 7) ^ (tile_row & 7)) << 4);
    const size_t at = ((size_t)bh * seq_k + kw0 + row) * kDim + 8 * c;
    *reinterpret_cast<int4*>(dk + at) = *reinterpret_cast<const int4*>(smem + off);
    *reinterpret_cast<int4*>(dv + at) = *reinterpret_cast<const int4*>(smem + kOffV + off);
  }
}

}  // namespace

namespace flash {

cudaError_t flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int seq_q, int seq_k, int causal, float scale,
                                cudaStream_t stream) {
  Maps maps;
  cudaError_t err = encode_rows_map(&maps.q, q, bh, seq_q, kRows);
  if (err == cudaSuccess) err = encode_rows_map(&maps.dout, dout, bh, seq_q, kRows);
  if (err == cudaSuccess) err = encode_rows_map(&maps.k, k, bh, seq_k, kKeys);
  if (err == cudaSuccess) err = encode_rows_map(&maps.v, v, bh, seq_k, kKeys);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_k + kKeys - 1) / kKeys);
  flash_bwd_dkv_wgmma_kernel<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      maps, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq_q, seq_k, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace flash
