// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, dQ and dK/dV.
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_dq_kernel and
// _flash_dkv_kernel (launched by _flash_backward). Same function: from
// q, k, v, dO laid out [batch * heads, seq, head_dim] and the forward's
// f32 LSE, both kernels recompute the scores S = scale * Q K^T in f32 (the
// causal mask aligned to the END of the keys, causal_offset = seq_k -
// seq_q), P = exp(S - LSE), dP = dO V^T and dS = P * (dP - delta) * scale
// tile by tile, where delta = rowsum(dO * O) in f32. Then
//   dQ = sum over kv tiles of dS K,
//   dV = sum over q tiles of P^T dO,  dK = sum over q tiles of dS^T Q,
// with P and dS cast to the input type before their products and every
// sum in f32, as in the Pallas kernels; outputs are cast to the inputs'
// type. The dQ kernel also computes delta (rowsum(dO * O) for its rows)
// and writes it for the dK/dV kernel, which runs after it on the stream.
//
// What bounds it on the H100: at the training shape (bf16, 32 heads,
// seq 1024, head_dim 128, causal) the products dominate. dQ does three
// of them (QK^T, dO V^T, dS K) and dK/dV four (K Q^T, V dO^T, P^T dO,
// dS^T Q), 2 * head_dim operations each per visible (query, key) pair:
// about 0.16 and 0.21 ms of tensor-core time at 989 TFLOP/s, against
// about 0.05 ms to move their bytes once at 3.35 TB/s.
// The design keeps every intermediate on chip. The Pallas grids carry
// their sums across a sequential axis; here one block owns a tile and a
// loop inside it walks the other axis, so no block writes what another
// reads and no atomics are needed:
//   * dQ: one block per (batch * head, 64-row q tile), four warps of 16
//     rows; Q and dO stay in shared memory while the loop walks the K and
//     V tiles up to the last one the causal mask needs.
//   * dK/dV: one block per (batch * head, 64-key kv tile), four warps of
//     16 keys; K and V stay in shared memory while the loop walks the Q
//     and dO tiles from the first one the causal mask needs. Each warp
//     computes S^T = K Q^T and dP^T = V dO^T directly (its keys are the
//     rows), so P^T and dS^T come out in the layout that the products
//     P^T dO and dS^T Q take as their left operand, and no transpose of
//     a register tile is needed.
// The products run on the tensor cores for bf16 and f16 (mma.sync
// m16n8k16) and as f32 FMAs for f32 (flash_common.cuh). Plain loads (no
// TMA, no wgmma, no pipelining) keep them simple. rt_flash_bwd_dq and
// rt_flash_bwd_dkv route bf16 at head_dim 128, the model's shapes, to the
// TMA/wgmma kernels of flash_bwd_dq_wgmma.cu and flash_bwd_dkv_wgmma.cu;
// this file's kernels serve f32 and f16 at head_dim 16, 32, 64, 128 and
// 256 and bf16 at 16, 32, 64 and 256. The Python wrapper pads any other
// head_dim up to 256 with zero columns to the next of these sizes.
//
// At head_dim 256 (flash_common.cuh, Tile) a block computes one half of
// the columns of dQ, or of dK and dV, named by blockIdx.z: the scores and
// dP still take the full-width Q, K, V and dO tiles, and the products that
// accumulate read the block's column half of K (dQ), dO (dV) or Q (dK).
// Both halves' dQ blocks compute delta; the first half's write it. f32
// blocks there have two warps (32 rows of the tile a block owns).
//
// Any seq_q and seq_k work: rows past seq_q and keys past seq_k are
// neither used nor stored. A row that sees no key (causal with seq_q >
// seq_k) gets, as the forward gives it, equal weights 1 / seq_k over every
// key: it adds dO / seq_k to each dV row, and its dQ and its share of dK
// are zero, because its masked scores do not depend on q or k. That is the
// derivative of the plain attention_reference; the Pallas kernels, which
// skip masked tiles, differ from it there.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

static_assert(kBlockM == kBlockN, "pv_tile sums over a 64-wide tile of either axis");

// Both kernels keep two tiles of the rows a block owns and two of the
// 64-wide tiles it walks, all full-width, and a warp's P or dS tile.
template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  using Tl = Tile<T, D>;
  return sizeof(T) * ((2 * Tl::kRows + 2 * kBlockN) * (D + Pad<T>::value) +
                      Tl::kWarps * 16 * (kBlockN + Pad<T>::value));
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<T, D>() + 2 * kBlockM * sizeof(float);
}

// Sum over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int seq_q, int seq_k, int causal, float scale) {
  constexpr int kRows = Tile<T, D>::kRows;
  constexpr int kCols = Tile<T, D>::kCols;
  constexpr int kThr = Tile<T, D>::kThreads;
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDP = kBlockN + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kRows * LD;
  T* sK = sdO + kRows * LD;
  T* sV = sK + kBlockN * LD;
  T* sdS = sV + kBlockN * LD;  // [warps][16][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  // The dQ columns this block computes start here.
  const int col0 = kCols < D ? blockIdx.z * kCols : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const size_t row_base = (size_t)bh * seq_q;
  const T* kb = k + (size_t)bh * seq_k * D;
  const T* vb = v + (size_t)bh * seq_k * D;

  load_tile<T, D, kRows, D, kThr>(sQ, q + row_base * D, q0, seq_q);
  load_tile<T, D, kRows, D, kThr>(sdO, dout + row_base * D, q0, seq_q);
  __syncthreads();

  const T* sQw = sQ + warp * 16 * LD;
  const T* sdOw = sdO + warp * 16 * LD;
  T* sdSw = sdS + warp * 16 * LDP;
  // The two q rows this thread's accumulator elements belong to.
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // delta = rowsum(dO * O) in f32 for the warp's 16 rows, lanes across D.
  float row_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f;
    if (row < seq_q) {
      const T* orow = o + (row_base + row) * D;
      for (int c = lane; c < D; c += 32) acc += to_f32(sdOw[r * LD + c]) * to_f32(orow[c]);
    }
    acc = warp_sum(acc);
    if (r == g) row_delta[0] = acc;
    if (r == g + 8) row_delta[1] = acc;
    if (lane == 0 && row < seq_q && col0 == 0) delta[row_base + row] = acc;
  }
  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_lse[r] = rows[r] < seq_q ? lse[row_base + rows[r]] : 0.f;

  // The kv tiles this block needs: all of them, or (causal) those up to the
  // one holding the last key that the block's last row may see; none when
  // every row of the block sees no key.
  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal) {
    const int last_key = causal_offset + min(q0 + kRows, seq_q) - 1;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockN + 1);
  }

  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBlockN;
    __syncthreads();  // every warp is done with the previous K, V and dS tiles
    load_tile<T, D, kBlockN, D, kThr>(sK, kb, k0, seq_k);
    load_tile<T, D, kBlockN, D, kThr>(sV, vb, k0, seq_k);
    __syncthreads();

    float s[8][4], dp[8][4];
    qk_tile<D>(s, sQw, sK, lane);
    qk_tile<D>(dp, sdOw, sV, lane);
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
    __syncwarp();  // the warp's dS tile is written
    pv_tile<kCols, LD>(acc, sdSw, sK + col0, lane);
  }
  store_rows<T, kCols, D>(dq + row_base * D + col0, acc, q0 + warp * 16, seq_q, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq_q, int seq_k, int causal, float scale) {
  constexpr int kRows = Tile<T, D>::kRows;  // keys a block owns
  constexpr int kCols = Tile<T, D>::kCols;
  constexpr int kThr = Tile<T, D>::kThreads;
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDP = kBlockN + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sdO = sQ + kBlockM * LD;
  T* sP = sdO + kBlockM * LD;  // [warps][16][LDP]: P^T, then dS^T
  float* sLse = reinterpret_cast<float*>(sP + Tile<T, D>::kWarps * 16 * LDP);
  float* sDelta = sLse + kBlockM;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  // The dK and dV columns this block computes start here.
  const int col0 = kCols < D ? blockIdx.z * kCols : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int causal_offset = seq_k - seq_q;
  const size_t row_base = (size_t)bh * seq_q;
  const size_t key_base = (size_t)bh * seq_k;

  load_tile<T, D, kRows, D, kThr>(sK, k + key_base * D, k0, seq_k);
  load_tile<T, D, kRows, D, kThr>(sV, v + key_base * D, k0, seq_k);
  const T* sKw = sK + warp * 16 * LD;
  const T* sVw = sV + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;
  // The two keys this thread's accumulator elements belong to.
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // The q tiles this block needs: (causal) from the one holding the first
  // row that may see the block's first key. With seq_q > seq_k the first
  // rows see no key and weigh every key, so every tile is visited.
  const int n_tiles = (seq_q + kBlockM - 1) / kBlockM;
  int first = 0;
  if (causal && causal_offset >= 0) first = max(0, k0 - causal_offset) / kBlockM;

  float acc_dk[kCols / 8][4], acc_dv[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int m = first; m < n_tiles; ++m) {
    const int q0 = m * kBlockM;
    __syncthreads();  // every warp is done with the previous Q, dO tiles
    load_tile<T, D, kBlockM, D, kThr>(sQ, q + row_base * D, q0, seq_q);
    load_tile<T, D, kBlockM, D, kThr>(sdO, dout + row_base * D, q0, seq_q);
    for (int i = threadIdx.x; i < kBlockM; i += kThr) {
      const bool in = q0 + i < seq_q;
      sLse[i] = in ? lse[row_base + q0 + i] : 0.f;
      sDelta[i] = in ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T: this warp's 16 keys against the tile's 64 rows; then P^T.
    float s[8][4];
    qk_tile<D>(s, sKw, sQ, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e >> 1];
        const int i = 8 * j + 2 * t + (e & 1);
        const int row = q0 + i;
        float p = 0.f;
        if (key < seq_k && row < seq_q) {
          if (causal && row + causal_offset < 0) {
            p = 1.f / seq_k;  // a row that sees no key
          } else if (!causal || row + causal_offset >= key) {
            p = expf(s[j][e] * scale - sLse[i]);
          }
        }
        s[j][e] = p;
        sPw[(g + 8 * (e >> 1)) * LDP + i] = from_f32<T>(p);
      }
    }
    __syncwarp();  // the warp's P^T tile is written
    pv_tile<kCols, LD>(acc_dv, sPw, sdO + col0, lane);

    // dP^T, then dS^T in place of P^T.
    float dp[8][4];
    qk_tile<D>(dp, sVw, sdO, lane);
    __syncwarp();  // every lane is done reading P^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e >> 1];
        const int i = 8 * j + 2 * t + (e & 1);
        const int row = q0 + i;
        const bool visible = key < seq_k && row < seq_q &&
                             !(causal && row + causal_offset < key);
        const float ds = visible ? s[j][e] * (dp[j][e] - sDelta[i]) * scale : 0.f;
        sPw[(g + 8 * (e >> 1)) * LDP + i] = from_f32<T>(ds);
      }
    }
    __syncwarp();  // the warp's dS^T tile is written
    pv_tile<kCols, LD>(acc_dk, sPw, sQ + col0, lane);
  }
  store_rows<T, kCols, D>(dk + key_base * D + col0, acc_dk, k0 + warp * 16, seq_k, lane);
  store_rows<T, kCols, D>(dv + key_base * D + col0, acc_dv, k0 + warp * 16, seq_k, lane);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int bh, seq_q, seq_k, causal;
  float scale;
  cudaStream_t stream;
  int* route;  // where the route taken is written
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using Tl = Tile<T, D>;
  const dim3 grid(a.bh, (a.seq_q + Tl::kRows - 1) / Tl::kRows, D / Tl::kCols);
  flash_bwd_dq_kernel<T, D><<<grid, Tl::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta), static_cast<T*>(a.dq),
      a.seq_q, a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using Tl = Tile<T, D>;
  const dim3 grid(a.bh, (a.seq_k + Tl::kRows - 1) / Tl::kRows, D / Tl::kCols);
  flash_bwd_dkv_kernel<T, D><<<grid, Tl::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.seq_q, a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

// bf16 at head_dim 128 takes the TMA/wgmma kernels; the rest this file's
// (bf16 at 256 too).
template <bool kDq, typename T, int D>
cudaError_t launch_one(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D == 128) {
    *a.route = kRouteWgmma;
    if constexpr (kDq) {
      return flash_bwd_dq_wgmma(a.q, a.k, a.v, a.o, a.dout, a.lse, a.delta, a.dq, a.bh, a.seq_q,
                                a.seq_k, a.causal, a.scale, a.stream);
    } else {
      return flash_bwd_dkv_wgmma(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.bh,
                                 a.seq_q, a.seq_k, a.causal, a.scale, a.stream);
    }
  } else {
    *a.route = kRouteMmaSync;
    if constexpr (kDq) {
      return launch_dq<T, D>(a);
    } else {
      return launch_dkv<T, D>(a);
    }
  }
}

template <bool kDq, typename T>
cudaError_t dispatch_dim(const Args& a, int head_dim) {
  switch (head_dim) {
    case 16: return launch_one<kDq, T, 16>(a);
    case 32: return launch_one<kDq, T, 32>(a);
    case 64: return launch_one<kDq, T, 64>(a);
    case 128: return launch_one<kDq, T, 128>(a);
    case 256: return launch_one<kDq, T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.bh <= 0 || a.seq_q <= 0 || a.seq_k <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kDtypeF32: return dispatch_dim<kDq, float>(a, head_dim);
    case kDtypeBf16: return dispatch_dim<kDq, __nv_bfloat16>(a, head_dim);
    case kDtypeF16: return dispatch_dim<kDq, __half>(a, head_dim);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: contiguous [bh, seq_q, head_dim]; k, v: [bh, seq_k,
// head_dim]; all of one type (dtype a dtype_codes.cuh code), 16-byte
// aligned; head_dim 16, 32, 64, 128 or 256, or a multiple of 128 above 256
// (flash_attention_wide.cu). lse (in) and delta (out): f32 [bh, seq_q]. Writes dQ, delta =
// rowsum(dout * o) and the route it took to *route (kRouteMmaSync or
// kRouteWgmma). Launches on `stream` and returns the launch's cudaError_t.
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq, int bh,
                               int seq_q, int seq_k, int head_dim, int dtype, int causal,
                               float scale, int* route, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               bh, seq_q, seq_k, causal, scale, static_cast<cudaStream_t>(stream), route};
  if (head_dim > 256 && bh > 0 && seq_q > 0 && seq_k > 0) {
    *route = kRouteMmaSync;
    return flash_bwd_dq_wide(q, k, v, o, dout, lse, delta, dq, bh, seq_q, seq_k, head_dim, dtype,
                             causal, scale, a.stream);
  }
  return dispatch<true>(a, head_dim, dtype);
}

// The same layouts; delta as rt_flash_bwd_dq wrote it. Writes dK and dV
// ([bh, seq_k, head_dim]) and the route it took to *route (kRouteMmaSync
// or kRouteWgmma). Launch it after rt_flash_bwd_dq on the same stream.
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int seq_q, int seq_k, int head_dim, int dtype, int causal,
                                float scale, int* route, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
               bh, seq_q, seq_k, causal, scale, static_cast<cudaStream_t>(stream), route};
  if (head_dim > 256 && bh > 0 && seq_q > 0 && seq_k > 0) {
    *route = kRouteMmaSync;
    return flash_bwd_dkv_wide(q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, head_dim,
                              dtype, causal, scale, a.stream);
  }
  return dispatch<false>(a, head_dim, dtype);
}
