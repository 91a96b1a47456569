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
// device memory. bf16 products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulation); f32 inputs use f32 FMAs in the same
// register layout, so both types share the softmax code. Plain loads
// (no TMA, no wgmma, no pipelining) keep this first version simple.
//
// Any seq_q and seq_k work: rows past seq_q are neither computed into O
// nor stored, and keys past seq_k score -inf, so they weigh nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;

// Row padding of the shared-memory tiles: 16 bytes, which keeps every row
// 16-byte aligned and shifts consecutive rows by four banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

// Copies rows [row0, row0 + kRows) of a [seq, D] matrix into shared memory
// (row stride D + pad) in 16-byte pieces, writing zeros past `seq`.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* smem, const T* gmem, int row0, int seq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int LD = D + Pad<T>::value;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const int4*>(gmem + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<int4*>(smem + r * LD + c) = val;
  }
}

// Accumulator layout shared by both types (that of mma.sync m16n8k16):
// with g = lane / 4 and t = lane % 4, element e of n-tile j holds
// row g + 8 * (e / 2), column 8 * j + 2 * t + e % 2.

// s = Q K^T for this warp's 16 rows and the tile's 64 keys.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const __nv_bfloat16* sQ,
                                        const __nv_bfloat16* sK, int lane) {
  constexpr int LD = D + Pad<__nv_bfloat16>::value;
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
      mma_bf16(s[j], a, b);
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

// o += P V for this warp's 16 rows; P is [16, 64] with row stride LDP.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const __nv_bfloat16* sP,
                                        const __nv_bfloat16* sV, int lane) {
  constexpr int LD = D + Pad<__nv_bfloat16>::value;
  constexpr int LDP = kBlockN + Pad<__nv_bfloat16>::value;
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
      // B fragment: keys r0, r0 + 1 (and r0 + 8, r0 + 9) of column col,
      // the lower key in the low half.
      b[0] = uint32_t(v[r0 * LD + col]) | (uint32_t(v[(r0 + 1) * LD + col]) << 16);
      b[1] = uint32_t(v[(r0 + 8) * LD + col]) | (uint32_t(v[(r0 + 9) * LD + col]) << 16);
      mma_bf16(o[j], a, b);
    }
  }
}

template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float* sP, const float* sV,
                                        int lane) {
  constexpr int LD = D + Pad<float>::value;
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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((kBlockM + 2 * kBlockN) * (D + Pad<T>::value) +
                      kWarps * 16 * (kBlockN + Pad<T>::value));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k, int causal,
                 float scale) {
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDP = kBlockN + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockM * LD;
  T* sV = sK + kBlockN * LD;
  T* sP = sV + kBlockN * LD;  // [kWarps][16][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
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
    const int last_key = causal_offset + min(q0 + kBlockM, seq_q) - 1;
    n_tiles = min(n_tiles, last_key / kBlockN + 1);
  }

  load_tile<T, D, kBlockM>(sQ, qb, q0, seq_q);
  const T* sQw = sQ + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;
  // The two q rows this thread's accumulator elements belong to.
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBlockN;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<T, D, kBlockN>(sK, kb, k0, seq_k);
    load_tile<T, D, kBlockN>(sV, vb, k0, seq_k);
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
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    __syncwarp();  // the warp's P tile is written
    pv_tile<D>(acc, sPw, sV, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * seq_q + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(acc[j][2 * r] / denom);
      orow[8 * j + 2 * t + 1] = from_f32<T>(acc[j][2 * r + 1] / denom);
    }
    if (t == 0) lse[(size_t)bh * seq_q + row] = m[r] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int seq_q, int seq_k, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq_q, seq_k, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int seq_q, int seq_k, int head_dim, int causal, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, seq_q, seq_k, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous [bh, seq, head_dim] of one type (bf16 when is_bf16,
// else f32), 16-byte aligned; lse: f32 [bh, seq_q]. Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int seq_q, int seq_k, int head_dim, int is_bf16, int causal,
                            float scale, void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, s);
  }
  return dispatch<float>(q, k, v, o, lse, bh, seq_q, seq_k, head_dim, causal, scale, s);
}
