// RMSNorm forward and backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: ray_tpu/ops/rmsnorm.py, _rmsnorm_kernel (launched by rmsnorm).
// The JAX model calls the XLA-fused rmsnorm_reference and differentiates it
// through jax.checkpoint; XLA fuses each direction into one pass, which is
// what the two kernels here are in the port. Same functions, f32 math:
//   forward  y = x * r * w, r = rsqrt(mean(x^2) + eps), cast to x's type;
//   backward n = x * r, g = dy * w, dx = r * (g - n * mean(g * n)) in x's
//            type, dw = sum over rows of dy * n in f32, cast to w's type.
//
// What bounds it on the H100, in both directions: bytes. Each kernel does a
// few operations per element and moves 2 (bf16, f16) or 4 (f32) bytes per
// element and tensor, far below the card's ~295 operations per byte, so the
// best either can do is read each input once and write each output once at
// 3.35 TB/s.
//
// The design, for both directions:
//  - A persistent grid: as many blocks as fit on the card at once (the
//    occupancy API times the SM count), each walking rows with the grid's
//    stride, so a block's setup is paid once and w is read once a block.
//  - A row belongs to a team of G warps: one warp a row while a lane holds
//    at most four 16-byte pieces of it (dim <= 1024 in bf16), else 2, 4 or
//    8 warps (the model's dim 4096 in bf16: 4 warps). A lane owns the same
//    pieces of every row, so it holds its part of w in registers for the
//    block's whole life, and the row stays in registers between the
//    reduction and the write: x (and dy) are read from HBM once. Four
//    pieces a lane keep the registers low enough for two blocks an SM; one
//    warp a row at dim 4096 (16 pieces a lane) spills on the H100.
//  - The row's sums are warp shuffles; for G > 1 the G warp sums meet in
//    shared memory behind the team's named barrier (two buffers, so one
//    barrier a row), summed in a fixed order. No __syncthreads. The mean
//    multiplies by 1 / dim, taken on the host: a division in the kernel
//    calls a slow path around which ptxas spills registers.
//  - The next row's loads are issued before the current row's reduction
//    (two register buffers), so two rows are in flight per team.
//  - Backward: sum(x^2) and sum(dy * w * x) in the same reduction, since
//    mean(g * n) = r * sum(g * x) / dim. dw is deterministic: each team
//    keeps per-column f32 sums of dy * n in registers over its rows and
//    writes them to a partial row [teams, dim]; a second kernel sums the
//    partial rows in a fixed order. No float atomics, so dw is the same
//    on every run.
//  - Rows wider than 8 warps' registers (dim > 8192 in bf16, 4096 in f32)
//    take a looped route: one block a row, x read twice (the second time
//    from L2), dw's partial row kept in global memory by the thread that
//    owns each column.
//  - Types: x (and dy, y, dx) f32, bf16 or f16, and w (and dw) of its own
//    type among those three. The routes above (the vector routes) take x
//    and w of one type, a dim that is a multiple of a 16-byte piece (4 in
//    f32, 8 in bf16 and f16) and 16-byte aligned pointers: every shape the
//    model gives the kernels. Anything else (a dim such as 50, or bf16 x
//    with f32 w) takes the scalar route: one warp a row on a persistent
//    grid, one element a lane at a time, x read twice (the second time
//    from L1 or L2), and dw's per-warp partial row kept in global memory
//    by the lane that owns each column, then summed in a fixed order as
//    above. It moves the same bytes less efficiently; no model dim takes
//    it.
// Any row count works.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype_codes.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block, in 8 / G teams
constexpr int kSumWarps = 32;  // warps a block of the dw sum
constexpr int kMaxDevices = 64;
constexpr int kWarps = kThreads / 32;  // rows a block of the scalar route

// 16 bytes of T (4 f32, or 8 bf16 or f16) <-> f32.
template <typename T>
constexpr int kElems = 16 / static_cast<int>(sizeof(T));

template <typename T> struct Pieces;
template <> struct Pieces<float> {
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Pieces<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};
template <> struct Pieces<__half> {
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __half22float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    uint4 v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// One element of the scalar route <-> f32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Sums N values over a team of G warps; every thread of the team gets the
// same sums. `scratch` holds 2 * G * N floats for the team; `slot`
// alternates between its two halves from one row to the next, so a warp
// that runs ahead writes the other half while its team still reads this
// one. Team t uses named barrier 1 + t (0 is __syncthreads').
template <int G, int N>
__device__ __forceinline__ void team_sum(float (&v)[N], float* scratch, int team, int slot) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
  }
  if constexpr (G > 1) {
    float* s = scratch + slot * G * N;
    const int warp = (threadIdx.x >> 5) % G;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) s[warp * N + n] = v[n];
    }
    team_barrier(1 + team, 32 * G);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) t += s[g * N + n];
      v[n] = t;
    }
  }
}

// Loads the V pieces of a row this thread owns (piece t + j * 32 * G);
// pieces past the row's end read as zeros.
template <int G, int V>
__device__ __forceinline__ void load_row(uint4 (&buf)[V], const uint4* __restrict__ row, int t,
                                         int nvec) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = t + j * 32 * G;
    buf[j] = i < nvec ? row[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------- forward
// One row: its sum of squares, then y = x * r * w written from registers.
template <typename T, int G, int V>
__device__ __forceinline__ void fwd_row(const uint4 (&xb)[V], const uint4 (&wv)[V],
                                        uint4* __restrict__ yr, int t, int nvec,
                                        float inv_dim, float eps, float* scratch, int team,
                                        int slot) {
  constexpr int E = kElems<T>;
  float ss[1] = {0.f};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float f[E];
    Pieces<T>::unpack(xb[j], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss[0] = fmaf(f[e], f[e], ss[0]);
  }
  team_sum<G, 1>(ss, scratch, team, slot);
  const float r = rsqrtf(ss[0] * inv_dim + eps);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = t + j * 32 * G;
    if (i < nvec) {
      float f[E], g[E];
      Pieces<T>::unpack(xb[j], f);
      Pieces<T>::unpack(wv[j], g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (f[e] * r) * g[e];
      yr[i] = Pieces<T>::pack(f);
    }
  }
}

// A block's rows, for the forward kernels below.
template <typename T, int G, int V>
__device__ __forceinline__ void fwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                                         T* __restrict__ y, int rows, int dim, float inv_dim,
                                         float eps) {
  constexpr int kTeams = kThreads / (32 * G);
  __shared__ float scratch[kTeams * 2 * G];
  const int team = threadIdx.x / (32 * G), t = threadIdx.x % (32 * G);
  float* my_scratch = scratch + team * 2 * G;
  const int nvec = dim / kElems<T>;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 wv[V], a[V], b[V];
  load_row<G, V>(wv, reinterpret_cast<const uint4*>(w), t, nvec);
  const int stride = gridDim.x * kTeams;
  int row = blockIdx.x * kTeams + team;
  if (row < rows) load_row<G, V>(a, xv + (size_t)row * nvec, t, nvec);
  for (; row < rows; row += 2 * stride) {
    const int r1 = row + stride, r2 = row + 2 * stride;
    if (r1 < rows) load_row<G, V>(b, xv + (size_t)r1 * nvec, t, nvec);
    fwd_row<T, G, V>(a, wv, yv + (size_t)row * nvec, t, nvec, inv_dim, eps, my_scratch, team,
                     0);
    if (r2 < rows) load_row<G, V>(a, xv + (size_t)r2 * nvec, t, nvec);
    if (r1 < rows)
      fwd_row<T, G, V>(b, wv, yv + (size_t)r1 * nvec, t, nvec, inv_dim, eps, my_scratch, team,
                       1);
  }
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
                   int dim, float inv_dim, float eps) {
  fwd_rows<T, G, V>(x, w, y, rows, dim, inv_dim, eps);
}

// f16 states two blocks an SM: under the bound above alone, ptxas holds
// the one-warp, two-piece instantiation to 64 registers and spills.
template <int G, int V>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_fwd_f16_kernel(const __half* __restrict__ x, const __half* __restrict__ w,
                       __half* __restrict__ y, int rows, int dim, float inv_dim, float eps) {
  fwd_rows<__half, G, V>(x, w, y, rows, dim, inv_dim, eps);
}

// Rows too wide for registers: one block a row, x read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_looped_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                          int rows, int dim, float inv_dim, float eps) {
  constexpr int E = kElems<T>;
  __shared__ float scratch[2 * (kThreads / 32)];
  const int nvec = dim / E;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  int slot = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, slot ^= 1) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * nvec;
    uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)row * nvec;
    float ss[1] = {0.f};
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float f[E];
      Pieces<T>::unpack(xr[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) ss[0] = fmaf(f[e], f[e], ss[0]);
    }
    team_sum<kThreads / 32, 1>(ss, scratch, 0, slot);
    const float r = rsqrtf(ss[0] * inv_dim + eps);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float f[E], g[E];
      Pieces<T>::unpack(xr[i], f);
      Pieces<T>::unpack(wv[i], g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (f[e] * r) * g[e];
      yr[i] = Pieces<T>::pack(f);
    }
  }
}

// ---------------------------------------------------------------- backward
// One row: sums, dx, and dy * n added to the thread's per-column sums.
template <typename T, int G, int V>
__device__ __forceinline__ void bwd_row(const uint4 (&xb)[V], const uint4 (&gb)[V],
                                        const uint4 (&wv)[V], float (&acc)[V][kElems<T>],
                                        uint4* __restrict__ dxr, int t, int nvec,
                                        float inv_dim, float eps, float* scratch, int team,
                                        int slot) {
  constexpr int E = kElems<T>;
  float s[2] = {0.f, 0.f};  // sum(x^2), sum(dy * w * x)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float f[E], d[E], g[E];
    Pieces<T>::unpack(xb[j], f);
    Pieces<T>::unpack(gb[j], d);
    Pieces<T>::unpack(wv[j], g);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s[0] = fmaf(f[e], f[e], s[0]);
      s[1] = fmaf(d[e] * g[e], f[e], s[1]);
    }
  }
  team_sum<G, 2>(s, scratch, team, slot);
  const float r = rsqrtf(s[0] * inv_dim + eps);
  const float m = r * s[1] * inv_dim;  // mean(g * n)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = t + j * 32 * G;
    if (i < nvec) {
      float f[E], d[E], g[E];
      Pieces<T>::unpack(xb[j], f);
      Pieces<T>::unpack(gb[j], d);
      Pieces<T>::unpack(wv[j], g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float n = f[e] * r;
        acc[j][e] = fmaf(d[e], n, acc[j][e]);
        f[e] = r * (d[e] * g[e] - n * m);
      }
      dxr[i] = Pieces<T>::pack(f);
    }
  }
}

// Writes E f32 column sums starting at `p` (16-byte aligned).
template <int E>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[E]) {
#pragma unroll
  for (int k = 0; k < E; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int dim,
                   float inv_dim, float eps) {
  constexpr int E = kElems<T>;
  constexpr int kTeams = kThreads / (32 * G);
  __shared__ float scratch[kTeams * 2 * G * 2];
  const int team = threadIdx.x / (32 * G), t = threadIdx.x % (32 * G);
  float* my_scratch = scratch + team * 2 * G * 2;
  const int nvec = dim / E;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  uint4 wv[V], xa[V], ga[V], xb[V], gb[V];
  float acc[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  load_row<G, V>(wv, reinterpret_cast<const uint4*>(w), t, nvec);
  const int stride = gridDim.x * kTeams;
  const int first = blockIdx.x * kTeams + team;
  int row = first;
  if (row < rows) {
    load_row<G, V>(xa, xv + (size_t)row * nvec, t, nvec);
    load_row<G, V>(ga, gv + (size_t)row * nvec, t, nvec);
  }
  for (; row < rows; row += 2 * stride) {
    const int r1 = row + stride, r2 = row + 2 * stride;
    if (r1 < rows) {
      load_row<G, V>(xb, xv + (size_t)r1 * nvec, t, nvec);
      load_row<G, V>(gb, gv + (size_t)r1 * nvec, t, nvec);
    }
    bwd_row<T, G, V>(xa, ga, wv, acc, dxv + (size_t)row * nvec, t, nvec, inv_dim, eps,
                     my_scratch, team, 0);
    if (r2 < rows) {
      load_row<G, V>(xa, xv + (size_t)r2 * nvec, t, nvec);
      load_row<G, V>(ga, gv + (size_t)r2 * nvec, t, nvec);
    }
    if (r1 < rows)
      bwd_row<T, G, V>(xb, gb, wv, acc, dxv + (size_t)r1 * nvec, t, nvec, inv_dim, eps,
                       my_scratch, team, 1);
  }
  // This team's partial row (zeros for a team that had no row).
  float* pr = partial + (size_t)first * dim;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = t + j * 32 * G;
    if (i < nvec) store_f32<E>(pr + i * E, acc[j]);
  }
}

// Rows too wide for registers: one block a row, x, dy and w read twice;
// the block's partial row of dw lives in global memory, each column owned
// by one thread, so no two threads touch the same sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_looped_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int dim, float inv_dim,
                          float eps) {
  constexpr int E = kElems<T>;
  __shared__ float scratch[2 * (kThreads / 32) * 2];
  const int nvec = dim / E;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  float* pr = partial + (size_t)blockIdx.x * dim;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const float zero[E] = {};
    store_f32<E>(pr + i * E, zero);
  }
  int slot = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, slot ^= 1) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * nvec;
    const uint4* gr = reinterpret_cast<const uint4*>(dy) + (size_t)row * nvec;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + (size_t)row * nvec;
    float s[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float f[E], d[E], g[E];
      Pieces<T>::unpack(xr[i], f);
      Pieces<T>::unpack(gr[i], d);
      Pieces<T>::unpack(wv[i], g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s[0] = fmaf(f[e], f[e], s[0]);
        s[1] = fmaf(d[e] * g[e], f[e], s[1]);
      }
    }
    team_sum<kThreads / 32, 2>(s, scratch, 0, slot);
    const float r = rsqrtf(s[0] * inv_dim + eps);
    const float m = r * s[1] * inv_dim;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float f[E], d[E], g[E], acc[E];
      Pieces<T>::unpack(xr[i], f);
      Pieces<T>::unpack(gr[i], d);
      Pieces<T>::unpack(wv[i], g);
#pragma unroll
      for (int k = 0; k < E; k += 4) {
        const float4 p = *reinterpret_cast<const float4*>(pr + i * E + k);
        acc[k] = p.x;
        acc[k + 1] = p.y;
        acc[k + 2] = p.z;
        acc[k + 3] = p.w;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float n = f[e] * r;
        acc[e] = fmaf(d[e], n, acc[e]);
        f[e] = r * (d[e] * g[e] - n * m);
      }
      store_f32<E>(pr + i * E, acc);
      dxr[i] = Pieces<T>::pack(f);
    }
  }
}

// dw[c] = sum over p of partial[p][c], p in increasing order within each of
// the kSumWarps warps (warp k takes p = k, k + kSumWarps, ...), then the
// warps in order: the same order on every run. A block takes 128 columns,
// a lane 4.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
rmsnorm_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw, int parts, int dim) {
  constexpr int kWarps = kSumWarps;
  __shared__ float4 sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c4 = blockIdx.x * 32 + lane, n4 = dim / 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c4 < n4) {
#pragma unroll 4
    for (int p = warp; p < parts; p += kWarps) {
      const float4 v = reinterpret_cast<const float4*>(partial + (size_t)p * dim)[c4];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c4 < n4) {
    float4 s = sums[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      s.x += sums[k][lane].x;
      s.y += sums[k][lane].y;
      s.z += sums[k][lane].z;
      s.w += sums[k][lane].w;
    }
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(dw)[c4] = s;
    } else if constexpr (std::is_same<T, __half>::value) {
      __half2 h[2] = {__floats2half2_rn(s.x, s.y), __floats2half2_rn(s.z, s.w)};
      reinterpret_cast<uint2*>(dw)[c4] = *reinterpret_cast<const uint2*>(h);
    } else {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(s.x, s.y), __floats2bfloat162_rn(s.z, s.w)};
      reinterpret_cast<uint2*>(dw)[c4] = *reinterpret_cast<const uint2*>(h);
    }
  }
}

// ---------------------------------------------------------------- scalar route
// Sum over the 32 lanes of a warp, in every lane (team_sum's shuffles).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Forward, one warp a row: the sum of squares, then y = x * r * w.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                          int rows, int dim, float inv_dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows; row += stride) {
    const T* xr = x + (size_t)row * dim;
    T* yr = y + (size_t)row * dim;
    float ss = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
    const float r = rsqrtf(warp_sum(ss) * inv_dim + eps);
    for (int c = lane; c < dim; c += 32) {
      yr[c] = from_f32<T>((to_f32(xr[c]) * r) * to_f32(w[c]));
    }
  }
}

// Backward, one warp a row. The warp's partial row of dw (zeros for a warp
// that had no row) is in global memory; column c belongs to lane c % 32,
// the only thread that reads or writes it.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int dim, float inv_dim,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float* pr = partial + (size_t)first * dim;
  for (int c = lane; c < dim; c += 32) pr[c] = 0.f;
  const int stride = gridDim.x * kWarps;
  for (int row = first; row < rows; row += stride) {
    const T* xr = x + (size_t)row * dim;
    const T* gr = dy + (size_t)row * dim;
    T* dxr = dx + (size_t)row * dim;
    float s0 = 0.f, s1 = 0.f;  // sum(x^2), sum(dy * w * x)
    for (int c = lane; c < dim; c += 32) {
      const float f = to_f32(xr[c]);
      s0 = fmaf(f, f, s0);
      s1 = fmaf(to_f32(gr[c]) * to_f32(w[c]), f, s1);
    }
    const float r = rsqrtf(warp_sum(s0) * inv_dim + eps);
    const float m = r * warp_sum(s1) * inv_dim;  // mean(g * n)
    for (int c = lane; c < dim; c += 32) {
      const float d = to_f32(gr[c]);
      const float n = to_f32(xr[c]) * r;
      pr[c] = fmaf(d, n, pr[c]);
      dxr[c] = from_f32<T>(r * (d * to_f32(w[c]) - n * m));
    }
  }
}

// dw[c] = sum over p of partial[p][c] in rmsnorm_dw_kernel's fixed order,
// one column a lane: a block takes 32 columns.
template <typename W>
__global__ void __launch_bounds__(kSumWarps * 32)
rmsnorm_dw_scalar_kernel(const float* __restrict__ partial, W* __restrict__ dw, int parts,
                         int dim) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < dim) {
    for (int p = warp; p < parts; p += kSumWarps) acc += partial[(size_t)p * dim + c];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < dim) {
    float total = sums[0][lane];
#pragma unroll
    for (int k = 1; k < kSumWarps; ++k) total += sums[k][lane];
    dw[c] = from_f32<W>(total);
  }
}

// ---------------------------------------------------------------- launch
// Blocks of kernel K resident on the current device at once (the
// persistent grid's size), from the occupancy API; cached per device.
template <auto K>
cudaError_t resident_blocks(int* out) {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// The persistent grid of K for `rows` rows at `teams` rows a block at once.
template <auto K>
cudaError_t grid_for(int rows, int teams, int* grid) {
  int resident = 0;
  const cudaError_t e = resident_blocks<K>(&resident);
  const int want = (rows + teams - 1) / teams;
  *grid = resident < want ? resident : want;
  return e;
}

// The team shape for rows of `dim`, in both directions: one warp a row
// while a lane holds at most four 16-byte pieces of it, else 2, 4 or 8
// warps (so a lane never holds more than four); L::looped() for rows wider
// than 8 warps' worth.
template <typename T, typename L>
cudaError_t by_width(int dim, const L& launch) {
  const int n = (dim / kElems<T> + 31) / 32;  // pieces a lane with one warp a row
  if (n <= 1) return launch.template resident<1, 1>();
  if (n <= 2) return launch.template resident<1, 2>();
  if (n <= 4) return launch.template resident<1, 4>();
  if (n <= 8) return launch.template resident<2, 4>();
  if (n <= 16) return launch.template resident<4, 4>();
  if (n <= 32) return launch.template resident<8, 4>();
  return launch.looped();
}

template <typename T, typename W>
struct FwdLaunch {
  const void *x, *w;
  void* y;
  int rows, dim;
  float eps;
  cudaStream_t stream;

  template <auto K, int kTeams>
  cudaError_t go() const {
    int grid = 0;
    const cudaError_t e = grid_for<K>(rows, kTeams, &grid);
    if (e != cudaSuccess) return e;
    K<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                     static_cast<T*>(y), rows, dim, 1.f / (float)dim, eps);
    return cudaGetLastError();
  }
  template <int G, int V>
  cudaError_t resident() const {
    if constexpr (std::is_same<T, __half>::value) {
      return this->template go<&rmsnorm_fwd_f16_kernel<G, V>, kThreads / (32 * G)>();
    } else {
      return this->template go<&rmsnorm_fwd_kernel<T, G, V>, kThreads / (32 * G)>();
    }
  }
  cudaError_t looped() const { return this->template go<&rmsnorm_fwd_looped_kernel<T>, 1>(); }
  cudaError_t scalar() const {
    return this->template go<&rmsnorm_fwd_scalar_kernel<T, W>, kWarps>();
  }
};

// With partial null, go() writes the partial rows the launch needs into
// *parts; otherwise it launches K and then Dw, the dw sum over those rows,
// on blocks of kCols columns.
template <typename T, typename W>
struct BwdLaunch {
  const void *x, *w, *dy;
  void *dx, *dw;
  float* partial;
  int* parts;
  int rows, dim;
  float eps;
  cudaStream_t stream;

  template <auto K, int kTeams, auto Dw, int kCols>
  cudaError_t go() const {
    int grid = 0;
    cudaError_t e = grid_for<K>(rows, kTeams, &grid);
    if (e != cudaSuccess) return e;
    const int needed = grid * kTeams;
    if (partial == nullptr) {
      *parts = needed;
      return cudaSuccess;
    }
    if (needed > *parts) return cudaErrorInvalidValue;
    K<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                     static_cast<const T*>(dy), static_cast<T*>(dx), partial,
                                     rows, dim, 1.f / (float)dim, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    Dw<<<(dim + kCols - 1) / kCols, kSumWarps * 32, 0, stream>>>(partial, static_cast<W*>(dw),
                                                                 needed, dim);
    return cudaGetLastError();
  }
  template <int G, int V>
  cudaError_t resident() const {
    return this->template go<&rmsnorm_bwd_kernel<T, G, V>, kThreads / (32 * G),
                             &rmsnorm_dw_kernel<T>, 128>();
  }
  cudaError_t looped() const {
    return this->template go<&rmsnorm_bwd_looped_kernel<T>, 1, &rmsnorm_dw_kernel<T>, 128>();
  }
  cudaError_t scalar() const {
    return this->template go<&rmsnorm_bwd_scalar_kernel<T, W>, kWarps,
                             &rmsnorm_dw_scalar_kernel<W>, 32>();
  }
};

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// The vector routes (by_width) for x and w of one type, a dim of whole
// 16-byte pieces and aligned pointers; else the scalar route.
template <typename T, typename W, typename L>
cudaError_t by_route(int dim, bool aligned, const L& launch) {
  if constexpr (std::is_same<T, W>::value) {
    if (aligned && dim % kElems<T> == 0) return by_width<T>(dim, launch);
  }
  return launch.scalar();
}

template <typename T> struct Tag { using type = T; };

// f(Tag<T>{}) for the element type of a dtype code.
template <typename F>
cudaError_t with_type(int code, const F& f) {
  switch (code) {
    case kDtypeF32: return f(Tag<float>{});
    case kDtypeBf16: return f(Tag<__nv_bfloat16>{});
    case kDtypeF16: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: contiguous [rows, dim] of type x_dtype; w: [dim] of type w_dtype
// (dtype_codes.cuh codes). Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int rt_rmsnorm(const void* x, const void* w, void* y, int rows, int dim, int x_dtype,
                          int w_dtype, float eps, void* stream) {
  if (rows <= 0 || dim <= 0) return cudaErrorInvalidValue;
  const bool aligned = !misaligned(x) && !misaligned(w) && !misaligned(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(w_dtype, [&](auto wt) {
      using T = typename decltype(xt)::type;
      using W = typename decltype(wt)::type;
      return by_route<T, W>(dim, aligned, FwdLaunch<T, W>{x, w, y, rows, dim, eps, s});
    });
  });
}

// x, dy, dx: contiguous [rows, dim] of type x_dtype; w, dw: [dim] of type
// w_dtype. partial: f32 scratch of *parts rows of dim, 16-byte aligned.
// Called with partial null, it launches nothing and writes into *parts the
// rows of scratch that a call with these rows, dim, types and pointers
// needs on the current device; called with the scratch, it launches the
// backward and the dw sum on `stream` and returns the launches'
// cudaError_t.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                              void* partial, int* parts, int rows, int dim, int x_dtype,
                              int w_dtype, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || parts == nullptr || misaligned(partial)) {
    return cudaErrorInvalidValue;
  }
  const bool aligned = !misaligned(x) && !misaligned(w) && !misaligned(dy) && !misaligned(dx) &&
                       !misaligned(dw);
  float* scratch = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(w_dtype, [&](auto wt) {
      using T = typename decltype(xt)::type;
      using W = typename decltype(wt)::type;
      return by_route<T, W>(
          dim, aligned, BwdLaunch<T, W>{x, w, dy, dx, dw, scratch, parts, rows, dim, eps, s});
    });
  });
}

// The message of a cudaError_t returned by the entry points above.
extern "C" const char* rt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
