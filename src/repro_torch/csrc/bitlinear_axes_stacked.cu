// Expert-stacked fused on-the-fly delta GEMM
//   y[e] = x[e] @ ((v_row[e, n] + v_col[e, k]) (.) unpack(B[e]) + W_b[e])^T,
// fp32 accumulation, for every expert e of an MoE layer's stack, in one
// launch.
//
// Replaces: src/repro/kernels/bitlinear.py, bitlinear_axes_p as the JAX MoE
// layer runs it under jax.vmap over the experts (src/repro/models/moe.py,
// `_expert_mm`): Pallas batches the vmapped call into one pallas_call with
// a leading grid axis, over both bodies (`_kernel_axes` with fp32/bf16 W_b,
// `_kernel_axes_q8` with int8 W_b and one fp16 scale per output row).
//
// Bound on an H100: as bitlinear_axes.cu, per expert.  At decode the rows an
// expert receives are few (capacity 1 at batch 4 for deepseek-moe-16b), so
// the stack's bytes bound it: every expert's W_b (4 B or 1 B per weight) and
// 1/8 B of signs per weight, read once.  At a prefill's capacity (120 rows)
// the fp32 operations do, 2*M flops per weight on the CUDA cores.
//
// Design: delta_gemm.cuh's two kernels with an expert axis on the grid
// (`ExpertStack`): the streaming kernel for M <= 16 rows per expert, the
// tiled one above.  The plan (kernels/bitlinear.stacked_plan)
// counts E times the tiles of one product when it fills the card's last
// wave, so a stack splits K less than one product would.
#include "delta_gemm.cuh"

// x (E, M, K) fp32|bf16; packed (E, N, K/8) u8; vr (E, N), vc (E, K)
// fp16|fp32; wb (E, N, K) fp32|bf16|int8; ws (E, N) fp16 with an int8 wb,
// else nullptr; y (E, M, N) fp32.  With splits > 1, workspace holds
// (splits, E, M, N) fp32 partials.  splits and k_per_split follow
// kernels/bitlinear.stacked_plan; a launch off the plan fails
// with cudaErrorInvalidValue.  All contiguous; x 16-byte aligned, wb
// 16-byte aligned (8-byte for int8); K a multiple of 8.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes_stacked(
    const void* x, int x_dtype, const void* packed, const void* vr,
    const void* vc, int v_dtype, const void* wb, int wb_dtype,
    const void* ws, void* y, void* workspace, int E, int M, int N, int K,
    int splits, int k_per_split, void* stream) {
  GemmArgs a{x, packed, wb, ws, static_cast<float*>(y),
             static_cast<float*>(workspace), M, N, K, splits, k_per_split,
             static_cast<cudaStream_t>(stream)};
  const ExpertStack st{E, splits, (int64_t)M * K, (int64_t)N * (K / 8),
                       (int64_t)N, (int64_t)K, (int64_t)N * K, (int64_t)N};
  if (v_dtype == DT_F16)
    return run_gemm(a, AxesScale<__half>{static_cast<const __half*>(vr),
                                         static_cast<const __half*>(vc)},
                    x_dtype, wb_dtype, st);
  if (v_dtype == DT_F32)
    return run_gemm(a, AxesScale<float>{static_cast<const float*>(vr),
                                        static_cast<const float*>(vc)},
                    x_dtype, wb_dtype, st);
  return (int)cudaErrorInvalidValue;
}
