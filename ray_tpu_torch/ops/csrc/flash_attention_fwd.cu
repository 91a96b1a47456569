// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_fwd_kernel (launched by
// _flash_forward). Same function: blocked online-softmax attention over
// q, k, v laid out [batch * heads, seq, head_dim], emitting O in the input
// type and the f32 log-sum-exp LSE [batch * heads, seq_q]. The numerics
// follow the Pallas kernel: scores are scale * (Q K^T) in f32, masked
// scores are -1e30 with the causal mask aligned to the END of the keys
// (causal_offset = seq_k - seq_q), P is cast to V's type before P V, the
// running max, sum and accumulator are f32, O = acc / max(l, 1e-30) and
// LSE = m + log(l).
//
// What bounds it on the H100: at the serving shape (bf16, 32 heads,
// seq 512, head_dim 128) the bytes of Q, K, V and O over 3.35 TB/s and the
// causal FLOPs over 989 TFLOP/s are about equal (tens of microseconds), so
// a simple kernel is limited by how fast it feeds the tensor cores.
// The design keeps every intermediate on chip: one block per
// (batch * head, 64-row q tile), four warps of 16 q rows each; the Q tile
// stays in shared memory while a loop walks the K and V tiles (64 keys at
// a time), which stands in for the Pallas grid's sequential kv axis and
// stops at the last tile the causal mask needs. S and P never reach
// device memory. bf16 and f16 products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulation); f32 inputs use f32 FMAs in the same
// register layout (flash_common.cuh), so every type shares the softmax
// code. Plain loads (no TMA, no wgmma, no pipelining) keep it simple: it
// serves f32 and f16 at head_dim 16, 32, 64, 128 and 256 and bf16 at 16,
// 32, 64 and 256 (the JAX test shapes: tiny()'s head_dim is 16; Gemma's
// decoders use 256), and rt_flash_fwd routes bf16 at head_dim 128, every
// shape the model gives the kernel, to the TMA/wgmma kernel of
// flash_fwd_wgmma.cu. The Python wrapper pads any other head_dim up to 256
// with zero columns to the next of these sizes.
//
// At head_dim 256 (flash_common.cuh, Tile) a block computes one half of
// O's columns, named by blockIdx.z, so a warp's accumulator stays at 64
// f32 registers a thread: Q and K stay full-width for the scores, V is
// loaded for the block's columns only, and the first half's blocks write
// the LSE. f32 blocks there have two warps (32 q rows).
//
// Any seq_q and seq_k work: rows past seq_q are neither computed into O
// nor stored, and keys past seq_k score -inf, so they weigh nothing.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
constexpr size_t smem_bytes() {
  using Tl = Tile<T, D>;
  return sizeof(T) * ((Tl::kRows + kBlockN) * (D + Pad<T>::value) +
                      kBlockN * (Tl::kCols + Pad<T>::value) +
                      Tl::kWarps * 16 * (kBlockN + Pad<T>::value));
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k, int causal,
                 float scale) {
  constexpr int kRows = Tile<T, D>::kRows;
  constexpr int kCols = Tile<T, D>::kCols;
  constexpr int kThr = Tile<T, D>::kThreads;
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDV = kCols + Pad<T>::value;
  constexpr int LDP = kBlockN + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kRows * LD;
  T* sV = sK + kBlockN * LD;  // [kBlockN][LDV]: the block's columns of V
  T* sP = sV + kBlockN * LDV;  // [warps][16][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  // The output columns this block computes start here.
  const int col0 = kCols < D ? blockIdx.z * kCols : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const T* qb = q + (size_t)bh * seq_q * D;
  const T* kb = k + (size_t)bh * seq_k * D;
  const T* vb = v + (size_t)bh * seq_k * D;

  // The kv tiles this block needs: all of them, or (causal) those up to the
  // one holding the last key that the block's last row may see. Tiles past
  // it are masked whole and would add nothing. A row that sees no key at
  // all (causal with seq_q > seq_k) scores -1e30 everywhere, which the
  // reference turns into equal weights over every key, so a block holding
  // such a row visits every tile.
  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal && causal_offset + q0 >= 0) {
    const int last_key = causal_offset + min(q0 + kRows, seq_q) - 1;
    n_tiles = min(n_tiles, last_key / kBlockN + 1);
  }

  load_tile<T, D, kRows, D, kThr>(sQ, qb, q0, seq_q);
  const T* sQw = sQ + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;
  // The two q rows this thread's accumulator elements belong to.
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBlockN;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<T, D, kBlockN, D, kThr>(sK, kb, k0, seq_k);
    load_tile<T, D, kBlockN, kCols, kThr>(sV, vb, k0, seq_k, col0);
    __syncthreads();

    float s[8][4];
    qk_tile<D>(s, sQw, sK, lane);

    float m_cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (key >= seq_k) {
          x = -INFINITY;  // past the ragged edge: weighs nothing
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
      // The four threads of a row group hold the row's 64 scores.
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
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    __syncwarp();  // the warp's P tile is written
    pv_tile<kCols>(acc, sPw, sV, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * seq_q + row) * D + col0;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(acc[j][2 * r] / denom);
      orow[8 * j + 2 * t + 1] = from_f32<T>(acc[j][2 * r + 1] / denom);
    }
    if (t == 0 && col0 == 0) lse[(size_t)bh * seq_q + row] = m[r] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int seq_q, int seq_k, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using Tl = Tile<T, D>;
  const dim3 grid(bh, (seq_q + Tl::kRows - 1) / Tl::kRows, D / Tl::kCols);
  flash_fwd_kernel<T, D><<<grid, Tl::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq_q, seq_k, causal, scale);
  return cudaGetLastError();
}

// bf16 at head_dim 128 takes the TMA/wgmma kernel; the rest this file's
// (bf16 at 256 too). Writes the route taken to *route.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int seq_q, int seq_k, int head_dim, int causal, float scale, int* route,
                     cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  *route = kRouteMmaSync;
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    case 128:
      if constexpr (kBf16) {
        *route = kRouteWgmma;
        return flash_fwd_wgmma(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
      } else {
        return launch<T, 128>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
      }
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous [bh, seq, head_dim] of one type (dtype a
// dtype_codes.cuh code), 16-byte aligned; head_dim 16, 32, 64, 128 or 256,
// or a multiple of 128 above 256 (flash_attention_wide.cu); lse: f32
// [bh, seq_q]. Launches on `stream`, writes the route it took to *route
// (kRouteMmaSync or kRouteWgmma) and returns the launch's cudaError_t.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int seq_q, int seq_k, int head_dim, int dtype, int causal,
                            float scale, int* route, void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim > 256) {
    *route = kRouteMmaSync;
    return flash_fwd_wide(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, dtype, causal, scale, s);
  }
  switch (dtype) {
    case kDtypeF32:
      return dispatch<float>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, route,
                             s);
    case kDtypeBf16:
      return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale,
                                     route, s);
    case kDtypeF16:
      return dispatch<__half>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, route,
                              s);
    default: return cudaErrorInvalidValue;
  }
}
