// RMSNorm for Hopper (sm_90a), with a plain C interface.
//
// Replaces: ray_tpu/ops/rmsnorm.py, _rmsnorm_kernel (launched by rmsnorm).
// The JAX model calls the XLA-fused rmsnorm_reference instead; XLA fuses it
// into one pass, which is what this kernel is in the port. Same function:
// y = x * rsqrt(mean(x^2) + eps) * w with f32 math, cast to x's type.
//
// What bounds it on the H100: bytes. It does about 4 operations per
// element and moves 2 (bf16) or 4 (f32) bytes in and out, far below the
// card's ~295 operations per byte, so the best it can do is read x once and
// write y once at 3.35 TB/s. The design: one block per row, the sum of
// squares taken in f32 from 16-byte loads (8 elements per thread per step),
// a warp-shuffle then shared-memory block reduction, and the scaled write
// with 16-byte stores. The second read of x comes from L1/L2 (a row of the
// model is 8 KB). Any row count works; dim must be a multiple of 8 and
// every pointer 16-byte aligned (the wrapper checks the one and ensures the
// other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

// 8 consecutive elements <-> f32, in 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  int4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<int4*>(p) = raw;
}

// Sum over the block (blockDim.x a multiple of 32); every thread gets it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int dim,
               float eps) {
  const T* xr = x + (size_t)blockIdx.x * dim;
  T* yr = y + (size_t)blockIdx.x * dim;
  float ss = 0.f;
  for (int i = threadIdx.x * 8; i < dim; i += blockDim.x * 8) {
    float f[8];
    load8(xr + i, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
  }
  const float r = rsqrtf(block_sum(ss) / (float)dim + eps);
  for (int i = threadIdx.x * 8; i < dim; i += blockDim.x * 8) {
    float f[8], wv[8];
    load8(xr + i, f);
    load8(w + i, wv);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] * r) * wv[e];
    store8(yr + i, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int dim, float eps,
                   cudaStream_t stream) {
  int threads = (dim / 8 + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(w), static_cast<T*>(y),
                                                  dim, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous [rows, dim]; w: [dim]; all bf16 when is_bf16, else f32;
// dim a multiple of 8 and every pointer 16-byte aligned. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int rt_rmsnorm(const void* x, const void* w, void* y, int rows, int dim, int is_bf16,
                          float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim % 8 != 0 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, y, rows, dim, eps, s)
                 : launch<float>(x, w, y, rows, dim, eps, s);
}

// The message of a cudaError_t returned by the entry points above.
extern "C" const char* rt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
