// Tiles and warp-level products shared by the mma.sync flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu), and what the
// TMA/wgmma kernels share with them: the masked score and the entry points
// the C functions route bf16 at head_dim 128 to.
//
// Each warp owns 16 rows of the tile it computes and walks a 64-wide tile
// of the other axis. A block has four warps and computes every output
// column up to head_dim 128; at head_dim 256 (Tile below) it computes half
// of them. bf16 and f16 products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulation); f32 inputs use f32 FMAs in the same register
// layout, so the kernels' softmax and masking code is written once for
// every type.
//
// Accumulator layout shared by every type (that of mma.sync m16n8k16):
// with g = lane / 4 and t = lane % 4, element e of n-tile j holds
// row g + 8 * (e / 2), column 8 * j + 2 * t + e % 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtype_codes.cuh"

namespace flash {

constexpr int kBlockM = 64;  // rows of the tile a block owns, 16 per warp
constexpr int kBlockN = 64;  // width of the tiles a block walks
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;

// The tile shape at head_dim D. Up to D = 128 a block has kWarps warps
// (kBlockM rows) and computes all D output columns. At D = 256 a warp's f32
// O accumulator alone would take 128 registers a thread, and dK/dV holds
// two of them, so a block computes 128 of the output columns (kCols; the
// grid's z index names which) and recomputes the scores, which need all D
// columns, for each half. The scores keep full-width tiles of Q and K (and
// of dO and V in the backward) in shared memory; in f32 four warps' tiles
// would pass the 227 KB a block may use, so f32 blocks have two warps.
template <typename T, int D>
struct Tile {
  static constexpr int kCols = D > 128 ? 128 : D;
  static constexpr int kWarps = (D > 128 && sizeof(T) == 4) ? 2 : flash::kWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kWarps * 16;  // rows of the tile a block owns
};

// The 16-bit types, whose products run on the tensor cores.
template <typename T>
constexpr bool kHalfWidth = std::is_same<T, __nv_bfloat16>::value ||
                            std::is_same<T, __half>::value;

// Row padding of the shared-memory tiles: 16 bytes, which keeps every row
// 16-byte aligned and shifts consecutive rows by four banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct Pad<__half> { static constexpr int value = 8; };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Two neighbouring 16-bit elements as one register.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same tile with f16 operands.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The m16n8k16 product for the operands' type.
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(d, a, b);
  } else {
    mma_bf16(d, a, b);
  }
}

// Copies rows [row0, row0 + kRows) and columns [col0, col0 + kCols) of a
// [seq, D] matrix into shared memory (row stride kCols + pad) in 16-byte
// pieces, writing zeros past `seq`; kLoadThreads threads take part.
template <typename T, int D, int kRows, int kCols = D, int kLoadThreads = kThreads>
__device__ __forceinline__ void load_tile(T* smem, const T* gmem, int row0, int seq,
                                          int col0 = 0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kCols / kVec;
  constexpr int LD = kCols + Pad<T>::value;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kLoadThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const int4*>(gmem + (size_t)(row0 + r) * D + col0 + c);
    }
    *reinterpret_cast<int4*>(smem + r * LD + c) = val;
  }
}

// s = A B^T for A's 16 rows and B's 64 rows, both [*, D] in shared memory
// (row stride D + pad): Q K^T in the forward, also dO V^T, K Q^T and
// V dO^T in the backward. D is a multiple of 16 (one k step at D = 16).
template <int D, typename T, typename = std::enable_if_t<kHalfWidth<T>>>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const T* sQ, const T* sK, int lane) {
  static_assert(D % 16 == 0, "the k steps of m16n8k16");
  constexpr int LD = D + Pad<T>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(sQ + g * LD + kk + 2 * t);
    a[1] = ld32(sQ + (g + 8) * LD + kk + 2 * t);
    a[2] = ld32(sQ + g * LD + kk + 2 * t + 8);
    a[3] = ld32(sQ + (g + 8) * LD + kk + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      b[0] = ld32(sK + (8 * j + g) * LD + kk + 2 * t);
      b[1] = ld32(sK + (8 * j + g) * LD + kk + 2 * t + 8);
      mma16<T>(s[j], a, b);
    }
  }
}

template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const float* sQ, const float* sK,
                                        int lane) {
  constexpr int LD = D + Pad<float>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* qrow = sQ + (g + 8 * (e >> 1)) * LD;
      const float* krow = sK + (8 * j + 2 * t + (e & 1)) * LD;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(qrow[k], krow[k], acc);
      s[j][e] = acc;
    }
  }
}

// o += P V for P's 16 rows; P is [16, 64] with row stride LDP, V is
// [64, D] with row stride kLD (D + pad unless given): P V in the forward,
// also dS K, P^T dO and dS^T Q in the backward. At head_dim 256 the
// backward passes a column half of a full-width tile as V, with the full
// tile's row stride.
template <int D, int kLD = 0, typename T, typename = std::enable_if_t<kHalfWidth<T>>>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const T* sP, const T* sV,
                                        int lane) {
  constexpr int LD = kLD ? kLD : D + Pad<T>::value;
  constexpr int LDP = kBlockN + Pad<T>::value;
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* v = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(sP + g * LDP + kk + 2 * t);
    a[1] = ld32(sP + (g + 8) * LDP + kk + 2 * t);
    a[2] = ld32(sP + g * LDP + kk + 2 * t + 8);
    a[3] = ld32(sP + (g + 8) * LDP + kk + 2 * t + 8);
    const int r0 = kk + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + g;
      uint32_t b[2];
      // B fragment: rows r0, r0 + 1 (and r0 + 8, r0 + 9) of column col,
      // the lower row in the low half.
      b[0] = uint32_t(v[r0 * LD + col]) | (uint32_t(v[(r0 + 1) * LD + col]) << 16);
      b[1] = uint32_t(v[(r0 + 8) * LD + col]) | (uint32_t(v[(r0 + 9) * LD + col]) << 16);
      mma16<T>(o[j], a, b);
    }
  }
}

template <int D, int kLD = 0>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float* sP, const float* sV,
                                        int lane) {
  constexpr int LD = kLD ? kLD : D + Pad<float>::value;
  constexpr int LDP = kBlockN + Pad<float>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* prow = sP + (g + 8 * (e >> 1)) * LDP;
      const float* vcol = sV + 8 * j + 2 * t + (e & 1);
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < kBlockN; ++k) acc = fmaf(prow[k], vcol[k * LD], acc);
      o[j][e] += acc;
    }
  }
}

// The TMA/wgmma route, taken for bf16 at head_dim 128 by rt_flash_fwd,
// rt_flash_bwd_dq and rt_flash_bwd_dkv (flash_fwd_wgmma.cu,
// flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu); the kernels of this header
// serve f32 and f16 at head_dim 16, 32, 64, 128 and 256 and bf16 at 16,
// 32, 64 and 256. Arguments as those entry points
// take them. The entry points report the route they launched in `*route`,
// and the Python wrappers count launches by what they report.
constexpr int kRouteMmaSync = 0;
constexpr int kRouteWgmma = 1;
cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int seq_q, int seq_k, int causal, float scale,
                            cudaStream_t stream);
cudaError_t flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq, int bh,
                               int seq_q, int seq_k, int causal, float scale,
                               cudaStream_t stream);
cudaError_t flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int seq_q, int seq_k, int causal, float scale,
                                cudaStream_t stream);

// Stores this warp's accumulator rows (16 of them from row0) of a
// [seq, D] output with row stride kStride (D unless given: a column block
// of a wider output), skipping rows past `seq`.
template <typename T, int D, int kStride = D>
__device__ __forceinline__ void store_rows(T* out, float (&acc)[D / 8][4], int row0,
                                           int seq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
    T* orow = out + (size_t)row * kStride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(acc[j][2 * r]);
      orow[8 * j + 2 * t + 1] = from_f32<T>(acc[j][2 * r + 1]);
    }
  }
}

}  // namespace flash
