// Shared helpers for the delta kernels: dtype codes, 8-wide loads and
// stores, and the split-K reduction pass.  Eight elements is one packed sign
// byte's worth of a row, so every kernel here moves weights in groups of
// eight (32 bytes of fp32, 16 bytes of bf16 or fp16, 8 bytes of int8) — one
// or two vector accesses per thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/build.py
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I8 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Eight consecutive elements starting at p, widened to fp32.  p is 16-byte
// aligned for fp32, bf16 and fp16, 8-byte aligned for int8.
__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float o[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// int8 base payload: one 8-byte load.  The widening is exact.
__device__ __forceinline__ void load8(const int8_t* p, float o[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)(int8_t)((u.x >> (8 * i)) & 0xffu);
    o[4 + i] = (float)(int8_t)((u.y >> (8 * i)) & 0xffu);
  }
}

// Dequantize eight int8 base values in place against their row's scale:
// one fp32 product each, the plain version's q * s.  __fmul_rn keeps the
// compiler from contracting the product with the delta add that follows
// into one fma, which would round once where the plain version rounds
// twice.
__device__ __forceinline__ void dequant8(float w[8], float s) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = __fmul_rn(w[j], s);
}

__device__ __forceinline__ void store8(float* p, const float o[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float o[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(__half* p, const float o[8]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

namespace {

// Second pass of a split-K GEMM: y[i] = sum over splits of partial[z][i],
// summed in split order (deterministic, no atomics).
__global__ void __launch_bounds__(256) splitk_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ y, int64_t mn,
    int splits) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += step) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    y[i] = s;
  }
}

inline cudaError_t launch_splitk_reduce(const float* partial, float* y,
                                        int64_t mn, int splits,
                                        cudaStream_t stream) {
  int64_t blocks = (mn + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(partial, y, mn,
                                                             splits);
  return cudaGetLastError();
}

}  // namespace
