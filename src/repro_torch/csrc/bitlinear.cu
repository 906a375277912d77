// Static-mode fused delta GEMM
//   y = x @ (v (.) unpack(B) + W_b)^T,   fp32 accumulation,
// with one per-axis vector v: per output row (N, 1), per input column (1, K)
// or one scalar (1, 1).
//
// Replaces: src/repro/kernels/bitlinear.py, bitlinear_p — its `_kernel` body
// (fp32/bf16 W_b) and its `_kernel_q8` body (int8 W_b with one fp16 scale
// per output row).  Its caller is core/bitdelta.DeltaLinear in apply mode
// "onfly".
//
// Bound on an H100: as bitlinear_axes.cu — bytes at decode-sized M (W_b plus
// 1/8 B of signs per element), operations at M = 64 and above.
//
// Design: the delta GEMM of delta_gemm.cuh (streaming for M <= 16, tiled
// above) with the strided scale policy: the mode is a pair of strides into
// v, as unpack_apply.cu reads it, so one kernel covers the three modes.  v
// arrives as fp32 (the wrapper widens an fp16 vector, exactly).
#include "delta_gemm.cuh"

// x (M, K) fp32|bf16; packed (N, K/8) u8; v fp32 read as v[n*vs_n + k*vs_k];
// wb (N, K) fp32|bf16|int8; ws (N,) fp16 with an int8 wb, else nullptr;
// y (M, N) fp32.  With splits > 1, workspace holds (splits, M, N) fp32
// partials.  splits and k_per_split follow kernels/bitlinear.gemm_plan: a
// multiple of 512 for M <= 16 (the x slice and column scales fit 48 KB of
// shared memory), of 32 above; a launch off the plan fails with
// cudaErrorInvalidValue.  All contiguous; x 16-byte
// aligned, wb 16-byte aligned (8-byte for int8); K a multiple of 8.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_bitlinear(const void* x, int x_dtype, const void* packed,
                               const void* v, int64_t vs_n, int64_t vs_k,
                               const void* wb, int wb_dtype, const void* ws,
                               void* y, void* workspace, int M, int N, int K,
                               int splits, int k_per_split, void* stream) {
  GemmArgs a{x, packed, wb, ws, static_cast<float*>(y),
             static_cast<float*>(workspace), M, N, K, splits, k_per_split,
             static_cast<cudaStream_t>(stream)};
  return run_gemm(a, StridedScale{static_cast<const float*>(v), vs_n, vs_k},
                  x_dtype, wb_dtype);
}
