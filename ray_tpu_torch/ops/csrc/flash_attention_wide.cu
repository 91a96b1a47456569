// Flash attention for head_dims above 256 on Hopper (sm_90a): forward,
// dQ and dK/dV, each for any head_dim that is a multiple of 128.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_fwd_kernel,
// _flash_dq_kernel and _flash_dkv_kernel at the head_dims that the other
// kernels of this directory are not built for (the Pallas kernels take any
// head_dim). The functions are those of flash_attention_fwd.cu and
// flash_attention_bwd.cu, with the same numerics: scores scale * Q K^T in
// f32, masked scores -1e30 with the causal mask aligned to the END of the
// keys, P and dS cast to the input type before their products, every sum in
// f32, O = acc / max(l, 1e-30), LSE = m + log(l), delta = rowsum(dO * O).
// The Python wrapper zero-pads a head_dim above 256 up to the next multiple
// of 128, which is exact (zero columns add nothing to any score).
//
// What bounds it on the H100: at head_dim 512 the products dominate, as at
// 128 (2 * head_dim operations per visible (query, key) pair and product,
// three in dQ, four in dK/dV). What the design does about it: nothing yet
// beyond keeping every intermediate on chip. This is a first version that
// is right for any width. A block of four warps owns a 64-row tile and
// computes one 128-column slice of the output (of O, dQ, or dK and dV),
// named by blockIdx.z. A full-width Q or K tile at head_dim 512 in f32 is
// 128 KB, so the scores S = Q K^T (and dP = dO V^T) are summed over the
// head_dim in 128-column chunks staged through shared memory, and every
// slice's blocks compute the scores anew. Plain loads, no TMA, no wgmma:
// the tensor cores through mma.sync m16n8k16 for bf16 and f16, f32 FMAs
// for f32, in the register layout of flash_common.cuh.
//
// Any seq_q and seq_k work, as in the other kernels: rows past seq_q and
// keys past seq_k are neither used nor stored, and a row that sees no key
// (causal with seq_q > seq_k) gets equal weights 1 / seq_k over every key,
// the derivative of the plain attention_reference in the backward.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kChunk = 128;  // head_dim columns staged at a time; a block's output columns

template <typename T>
constexpr int kLD = kChunk + Pad<T>::value;  // row stride of a staged chunk
template <typename T>
constexpr int kLDP = kBlockN + Pad<T>::value;  // row stride of a warp's P or dS tile

// Copies rows [row0, row0 + kRows) and columns [col0, col0 + kChunk) of a
// [seq, head_dim] matrix into shared memory (row stride kLD) in 16-byte
// pieces, writing zeros past `seq`.
template <typename T, int kRows>
__device__ __forceinline__ void load_chunk(T* smem, const T* gmem, int row0, int seq,
                                           int head_dim, int col0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kChunk / kVec;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const int4*>(gmem + (size_t)(row0 + r) * head_dim + col0 + c);
    }
    *reinterpret_cast<int4*>(smem + r * kLD<T> + c) = val;
  }
}

// s += A B^T over one staged chunk, for A's 16 rows and B's 64 rows.
template <typename T, typename = std::enable_if_t<kHalfWidth<T>>>
__device__ __forceinline__ void qk_accumulate(float (&s)[8][4], const T* sA, const T* sB,
                                              int lane) {
  constexpr int LD = kLD<T>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(sA + g * LD + kk + 2 * t);
    a[1] = ld32(sA + (g + 8) * LD + kk + 2 * t);
    a[2] = ld32(sA + g * LD + kk + 2 * t + 8);
    a[3] = ld32(sA + (g + 8) * LD + kk + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      b[0] = ld32(sB + (8 * j + g) * LD + kk + 2 * t);
      b[1] = ld32(sB + (8 * j + g) * LD + kk + 2 * t + 8);
      mma16<T>(s[j], a, b);
    }
  }
}

__device__ __forceinline__ void qk_accumulate(float (&s)[8][4], const float* sA,
                                              const float* sB, int lane) {
  constexpr int LD = kLD<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* arow = sA + (g + 8 * (e >> 1)) * LD;
      const float* brow = sB + (8 * j + 2 * t + (e & 1)) * LD;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) acc = fmaf(arow[k], brow[k], acc);
      s[j][e] += acc;
    }
  }
}

__device__ __forceinline__ void zero(float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
}

// Stores this warp's accumulator rows (16 of them from row0) into columns
// [col0, col0 + kChunk) of a [seq, head_dim] output, skipping rows past seq.
template <typename T>
__device__ __forceinline__ void store_slice(T* out, float (&acc)[kChunk / 8][4], int row0,
                                            int seq, int head_dim, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
    T* orow = out + (size_t)row * head_dim + col0;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(acc[j][2 * r]);
      orow[8 * j + 2 * t + 1] = from_f32<T>(acc[j][2 * r + 1]);
    }
  }
}

template <typename T>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * ((kBlockM + 2 * kBlockN) * kLD<T> + kWarps * 16 * kLDP<T>);
}

template <typename T>
constexpr size_t bwd_smem_bytes() {
  return sizeof(T) * (4 * kBlockM * kLD<T> + kWarps * 16 * kLDP<T>) + 2 * kBlockM * sizeof(float);
}

// One block per (batch * head, 64-row q tile, 128-column slice of O).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k,
                      int head_dim, int causal, float scale) {
  constexpr int LDP = kLDP<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [kBlockM][kLD]: a chunk of Q
  T* sK = sQ + kBlockM * kLD<T>;            // [kBlockN][kLD]: a chunk of K
  T* sV = sK + kBlockN * kLD<T>;            // [kBlockN][kLD]: the block's slice of V
  T* sP = sV + kBlockN * kLD<T>;            // [warps][16][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.z * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const T* qb = q + (size_t)bh * seq_q * head_dim;
  const T* kb = k + (size_t)bh * seq_k * head_dim;
  const T* vb = v + (size_t)bh * seq_k * head_dim;

  // The kv tiles the block needs, as in flash_attention_fwd.cu.
  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal && causal_offset + q0 >= 0) {
    const int last_key = causal_offset + min(q0 + kBlockM, seq_q) - 1;
    n_tiles = min(n_tiles, last_key / kBlockN + 1);
  }

  const T* sQw = sQ + warp * 16 * kLD<T>;
  T* sPw = sP + warp * 16 * LDP;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[kChunk / 8][4];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBlockN;
    float s[8][4];
    zero(s);
    for (int c = 0; c < head_dim; c += kChunk) {
      __syncthreads();  // every warp is done with the previous chunks (and V)
      load_chunk<T, kBlockM>(sQ, qb, q0, seq_q, head_dim, c);
      load_chunk<T, kBlockN>(sK, kb, k0, seq_k, head_dim, c);
      if (c == 0) load_chunk<T, kBlockN>(sV, vb, k0, seq_k, head_dim, col0);
      __syncthreads();
      qk_accumulate(s, sQw, sK, lane);
    }

    float m_cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (key >= seq_k) {
          x = -INFINITY;
        } else if (causal && rows[e >> 1] + causal_offset < key) {
          x = kMasked;
        }
        s[j][e] = x;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
    float m_new[2], corr[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      m_new[r] = fmaxf(m[r], m_cur[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[j][e] - m_new[r]);
        rowsum[r] += p;
        sPw[(g + 8 * r) * LDP + 8 * j + 2 * t + (e & 1)] = from_f32<T>(p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
      l[r] = corr[r] * l[r] + rowsum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    __syncwarp();  // the warp's P tile is written
    pv_tile<kChunk>(acc, sPw, sV, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * seq_q + row) * head_dim + col0;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(acc[j][2 * r] / denom);
      orow[8 * j + 2 * t + 1] = from_f32<T>(acc[j][2 * r + 1] / denom);
    }
    if (t == 0 && col0 == 0) lse[(size_t)bh * seq_q + row] = m[r] + logf(denom);
  }
}

// Sum over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// One block per (batch * head, 64-row q tile, 128-column slice of dQ).
// The first slice's blocks write delta for the dK/dV kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq, int seq_q, int seq_k,
                         int head_dim, int causal, float scale) {
  constexpr int LDP = kLDP<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kBlockM * kLD<T>;
  T* sK = sdO + kBlockM * kLD<T>;  // a chunk of K, then the block's slice of K
  T* sV = sK + kBlockN * kLD<T>;
  T* sdS = sV + kBlockN * kLD<T>;  // [warps][16][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.z * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const size_t row_base = (size_t)bh * seq_q;
  const T* qb = q + row_base * head_dim;
  const T* dob = dout + row_base * head_dim;
  const T* kb = k + (size_t)bh * seq_k * head_dim;
  const T* vb = v + (size_t)bh * seq_k * head_dim;

  const T* sQw = sQ + warp * 16 * kLD<T>;
  const T* sdOw = sdO + warp * 16 * kLD<T>;
  T* sdSw = sdS + warp * 16 * LDP;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // delta = rowsum(dO * O) in f32 over the whole head_dim, lanes across it.
  float row_delta[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float sum = 0.f;
    if (row < seq_q) {
      const T* orow = o + (row_base + row) * head_dim;
      const T* dorow = dob + (size_t)row * head_dim;
      for (int c = lane; c < head_dim; c += 32) sum += to_f32(dorow[c]) * to_f32(orow[c]);
    }
    sum = warp_sum(sum);
    if (r == g) row_delta[0] = sum;
    if (r == g + 8) row_delta[1] = sum;
    if (lane == 0 && row < seq_q && col0 == 0) delta[row_base + row] = sum;
  }
  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_lse[r] = rows[r] < seq_q ? lse[row_base + rows[r]] : 0.f;

  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal) {
    const int last_key = causal_offset + min(q0 + kBlockM, seq_q) - 1;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockN + 1);
  }

  float acc[kChunk / 8][4];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBlockN;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int c = 0; c < head_dim; c += kChunk) {
      __syncthreads();  // every warp is done with the previous chunks (and the K slice)
      load_chunk<T, kBlockM>(sQ, qb, q0, seq_q, head_dim, c);
      load_chunk<T, kBlockM>(sdO, dob, q0, seq_q, head_dim, c);
      load_chunk<T, kBlockN>(sK, kb, k0, seq_k, head_dim, c);
      load_chunk<T, kBlockN>(sV, vb, k0, seq_k, head_dim, c);
      __syncthreads();
      qk_accumulate(s, sQw, sK, lane);
      qk_accumulate(dp, sdOw, sV, lane);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool visible = key < seq_k && rows[r] < seq_q &&
                             !(causal && rows[r] + causal_offset < key);
        float ds = 0.f;
        if (visible) {
          const float p = expf(s[j][e] * scale - row_lse[r]);
          ds = p * (dp[j][e] - row_delta[r]) * scale;
        }
        sdSw[(g + 8 * r) * LDP + 8 * j + 2 * t + (e & 1)] = from_f32<T>(ds);
      }
    }
    __syncthreads();  // every warp is done with the last K chunk
    load_chunk<T, kBlockN>(sK, kb, k0, seq_k, head_dim, col0);
    __syncthreads();  // the K slice (and every warp's dS tile) is written
    pv_tile<kChunk>(acc, sdSw, sK, lane);
  }
  store_slice<T>(dq + row_base * head_dim, acc, q0 + warp * 16, seq_q, head_dim, col0, lane);
}

// One block per (batch * head, 64-key kv tile, 128-column slice of dK and
// dV). Each warp computes S^T = K Q^T and dP^T = V dO^T for its 16 keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq_q, int seq_k,
                          int head_dim, int causal, float scale) {
  constexpr int LDP = kLDP<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBlockM * kLD<T>;
  T* sQ = sV + kBlockM * kLD<T>;    // a chunk of Q, then the block's slice of Q
  T* sdO = sQ + kBlockN * kLD<T>;   // a chunk of dO, then the block's slice of dO
  T* sP = sdO + kBlockN * kLD<T>;   // [warps][16][LDP]: P^T, then dS^T
  float* sLse = reinterpret_cast<float*>(sP + kWarps * 16 * LDP);
  float* sDelta = sLse + kBlockN;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.z * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const size_t row_base = (size_t)bh * seq_q;
  const size_t key_base = (size_t)bh * seq_k;
  const T* qb = q + row_base * head_dim;
  const T* dob = dout + row_base * head_dim;
  const T* kb = k + key_base * head_dim;
  const T* vb = v + key_base * head_dim;

  const T* sKw = sK + warp * 16 * kLD<T>;
  const T* sVw = sV + warp * 16 * kLD<T>;
  T* sPw = sP + warp * 16 * LDP;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  const int n_tiles = (seq_q + kBlockN - 1) / kBlockN;
  int first = 0;
  if (causal && causal_offset >= 0) first = max(0, k0 - causal_offset) / kBlockN;

  float acc_dk[kChunk / 8][4], acc_dv[kChunk / 8][4];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int m = first; m < n_tiles; ++m) {
    const int q0 = m * kBlockN;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int c = 0; c < head_dim; c += kChunk) {
      __syncthreads();  // every warp is done with the previous chunks (and slices)
      load_chunk<T, kBlockM>(sK, kb, k0, seq_k, head_dim, c);
      load_chunk<T, kBlockM>(sV, vb, k0, seq_k, head_dim, c);
      load_chunk<T, kBlockN>(sQ, qb, q0, seq_q, head_dim, c);
      load_chunk<T, kBlockN>(sdO, dob, q0, seq_q, head_dim, c);
      if (c == 0) {
        for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
          const bool in = q0 + i < seq_q;
          sLse[i] = in ? lse[row_base + q0 + i] : 0.f;
          sDelta[i] = in ? delta[row_base + q0 + i] : 0.f;
        }
      }
      __syncthreads();
      qk_accumulate(s, sKw, sQ, lane);
      qk_accumulate(dp, sVw, sdO, lane);
    }
    // P^T into s, dS^T into dp, both for this warp's 16 keys.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e >> 1];
        const int i = 8 * j + 2 * t + (e & 1);
        const int row = q0 + i;
        float p = 0.f, ds = 0.f;
        if (key < seq_k && row < seq_q) {
          if (causal && row + causal_offset < 0) {
            p = 1.f / seq_k;  // a row that sees no key
          } else if (!causal || row + causal_offset >= key) {
            p = expf(s[j][e] * scale - sLse[i]);
            ds = p * (dp[j][e] - sDelta[i]) * scale;
          }
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
    __syncthreads();  // every warp is done with the last Q and dO chunks
    load_chunk<T, kBlockN>(sQ, qb, q0, seq_q, head_dim, col0);
    load_chunk<T, kBlockN>(sdO, dob, q0, seq_q, head_dim, col0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sPw[(g + 8 * (e >> 1)) * LDP + 8 * j + 2 * t + (e & 1)] = from_f32<T>(s[j][e]);
      }
    }
    __syncthreads();  // the slices and every warp's P^T tile are written
    pv_tile<kChunk>(acc_dv, sPw, sdO, lane);
    __syncwarp();  // every lane is done reading P^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sPw[(g + 8 * (e >> 1)) * LDP + 8 * j + 2 * t + (e & 1)] = from_f32<T>(dp[j][e]);
      }
    }
    __syncwarp();  // the warp's dS^T tile is written
    pv_tile<kChunk>(acc_dk, sPw, sQ, lane);
  }
  store_slice<T>(dk + key_base * head_dim, acc_dk, k0 + warp * 16, seq_k, head_dim, col0, lane);
  store_slice<T>(dv + key_base * head_dim, acc_dv, k0 + warp * 16, seq_k, head_dim, col0, lane);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

dim3 grid_of(int bh, int rows, int head_dim) {
  return dim3(bh, (rows + kBlockM - 1) / kBlockM, head_dim / kChunk);
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int seq_q, int seq_k, int head_dim, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T>();
  cudaError_t err = set_smem((const void*)flash_fwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wide_kernel<T><<<grid_of(bh, seq_q, head_dim), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq_q, seq_k, head_dim, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int bh, int seq_q, int seq_k,
                   int head_dim, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = set_smem((const void*)flash_bwd_dq_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<T><<<grid_of(bh, seq_q, head_dim), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), seq_q, seq_k, head_dim, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int seq_q,
                    int seq_k, int head_dim, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = set_smem((const void*)flash_bwd_dkv_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<T><<<grid_of(bh, seq_k, head_dim), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq_q, seq_k,
      head_dim, causal, scale);
  return cudaGetLastError();
}

bool takes(int head_dim) { return head_dim > 256 && head_dim % kChunk == 0; }

}  // namespace

namespace flash {

cudaError_t flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                           int bh, int seq_q, int seq_k, int head_dim, int dtype, int causal,
                           float scale, cudaStream_t stream) {
  if (!takes(head_dim)) return cudaErrorInvalidValue;
  switch (dtype) {
    case kDtypeF32:
      return fwd<float>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, stream);
    case kDtypeBf16:
      return fwd<__nv_bfloat16>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale,
                                stream);
    case kDtypeF16:
      return fwd<__half>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq, int bh,
                              int seq_q, int seq_k, int head_dim, int dtype, int causal,
                              float scale, cudaStream_t stream) {
  if (!takes(head_dim)) return cudaErrorInvalidValue;
  switch (dtype) {
    case kDtypeF32:
      return bwd_dq<float>(q, k, v, o, dout, lse, delta, dq, bh, seq_q, seq_k, head_dim, causal,
                           scale, stream);
    case kDtypeBf16:
      return bwd_dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, bh, seq_q, seq_k, head_dim,
                                   causal, scale, stream);
    case kDtypeF16:
      return bwd_dq<__half>(q, k, v, o, dout, lse, delta, dq, bh, seq_q, seq_k, head_dim,
                            causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv, int bh,
                               int seq_q, int seq_k, int head_dim, int dtype, int causal,
                               float scale, cudaStream_t stream) {
  if (!takes(head_dim)) return cudaErrorInvalidValue;
  switch (dtype) {
    case kDtypeF32:
      return bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, head_dim,
                            causal, scale, stream);
    case kDtypeBf16:
      return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k,
                                    head_dim, causal, scale, stream);
    case kDtypeF16:
      return bwd_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, head_dim,
                             causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
