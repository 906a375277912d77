// Fused on-the-fly delta GEMM
//   y = x @ ((v_row[n] + v_col[k]) (.) unpack(B) + W_b)^T,   fp32 accumulation.
//
// Replaces: src/repro/kernels/bitlinear.py, bitlinear_axes_p — its
// `_kernel_axes` body (fp32/bf16 W_b) and its `_kernel_axes_q8` body (int8
// W_b with one fp16 scale per output row, dequantized in the tile pass).  The
// overlay zeroes the axis vector it does not use, so one kernel covers row-,
// col- and scalar-scaled deltas.
//
// Bound on an H100 at the serving path's shapes:
//   * decode, M = batch = 4: bytes.  The kernel must stream W_b (4 B/element
//     of fp32, 1 B of int8) plus the sign plane (1/8 B/element) once, against
//     2*M = 8 flops per element — about 2 (fp32) or 7 (int8) flops per byte.
//   * prefill, M = batch * prompt = 64: operations.  128 fp32 flops per weight
//     element on the CUDA cores (67 TFLOP/s) outweigh 4.1 B at 3.35 TB/s.
//
// Design: the delta GEMM of delta_gemm.cuh (a streaming kernel for M <= 16,
// a double-buffered tiled one above) with the dual-axis scale policy.
#include "delta_gemm.cuh"

// x (M, K) fp32|bf16; packed (N, K/8) u8; vr (N,), vc (K,) fp16|fp32;
// wb (N, K) fp32|bf16|int8; ws (N,) fp16 with an int8 wb, else nullptr;
// y (M, N) fp32.  With splits > 1, workspace holds (splits, M, N) fp32
// partials.  splits and k_per_split follow kernels/bitlinear.gemm_plan: a
// multiple of 512 for M <= 16 (the x slice and column scales fit 48 KB of
// shared memory), of 32 above; a launch off the plan fails with
// cudaErrorInvalidValue.  All contiguous; x 16-byte
// aligned, wb 16-byte aligned (8-byte for int8); K a multiple of 8.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes(const void* x, int x_dtype, const void* packed,
                                    const void* vr, const void* vc, int v_dtype,
                                    const void* wb, int wb_dtype, const void* ws,
                                    void* y, void* workspace, int M, int N,
                                    int K, int splits, int k_per_split,
                                    void* stream) {
  GemmArgs a{x, packed, wb, ws, static_cast<float*>(y),
             static_cast<float*>(workspace), M, N, K, splits, k_per_split,
             static_cast<cudaStream_t>(stream)};
  if (v_dtype == DT_F16)
    return run_gemm(a, AxesScale<__half>{static_cast<const __half*>(vr),
                                         static_cast<const __half*>(vc)},
                    x_dtype, wb_dtype);
  if (v_dtype == DT_F32)
    return run_gemm(a, AxesScale<float>{static_cast<const float*>(vr),
                                        static_cast<const float*>(vc)},
                    x_dtype, wb_dtype);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
