// Fused on-the-fly delta GEMM
//   y = x @ ((v_row[n] + v_col[k]) (.) unpack(B) + W_b)^T,   fp32 accumulation.
//
// Replaces: src/repro/kernels/bitlinear.py, bitlinear_axes_p (its
// `_kernel_axes` body).  The overlay zeroes the axis vector it does not use,
// so one kernel covers row-, col- and scalar-scaled deltas.
//
// Bound on an H100 at the serving path's shapes (W_b fp32):
//   * decode, M = batch = 4: bytes.  The kernel must stream W_b (4 B/element)
//     plus the sign plane (1/8 B/element) once, against 2*M = 8 flops per
//     element — about 2 flops per byte.
//   * prefill, M = batch * prompt = 64: operations.  128 fp32 flops per weight
//     element on the CUDA cores (67 TFLOP/s) outweigh 4.1 B at 3.35 TB/s.
//
// Design (simple and correct first; wgmma/TMA come later):
//   * A block owns a BM x 64 output tile and walks K in steps of 32.  Per step
//     it stages the x tile (widened to fp32) and builds the W_hat tile in
//     shared memory: each of the 256 threads takes one packed sign byte (one
//     row, eight columns), reads the eight W_b values as vector loads and
//     writes W_b +- (v_row + v_col) — the same fp32 values the plain version
//     forms, so only the summation order differs from it.  The dense W_hat
//     never reaches device memory.
//   * Each thread accumulates TM x 4 outputs in fp32 registers.  BM = 16 for
//     decode-sized M (less wasted work on the ragged M edge, which is masked),
//     BM = 64 otherwise.
//   * Decode-sized calls have too few output tiles to fill 132 SMs, so K is
//     split across blockIdx.z; each split writes its partial tile to a
//     workspace and a second small kernel sums the splits in a fixed order
//     (deterministic, no atomics).
//   * Shared tiles are padded to an odd row stride (65 / BM+1) so the
//     transposed stores and the compute reads are free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TN = 4;
constexpr int NTHREADS = 256;

template <int BM, int TM, typename TX, typename TV, typename TW>
__global__ void __launch_bounds__(NTHREADS) bitlinear_axes_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed,
    const TV* __restrict__ vr, const TV* __restrict__ vc,
    const TW* __restrict__ wb, float* __restrict__ y, int M, int N, int K,
    int k_per_split) {
  constexpr int TY = BM / TM;
  static_assert(TY * (BN / TN) == NTHREADS, "thread layout must cover the tile");
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // output columns tx + 16*j
  const int ty = tid / (BN / TN);   // output rows ty + TY*i
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  // W_hat tile role: one packed byte = row wn, columns wk..wk+7 of the step
  const int wn = tid >> 2;
  const int wk = (tid & 3) * 8;
  const int gn = n0 + wn;
  const bool n_ok = gn < N;
  const float vrow = n_ok ? to_f32(vr[gn]) : 0.f;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    // x tile: BM rows x BK columns in chunks of eight, zero outside M / K
    for (int e = tid; e < BM * (BK / 8); e += NTHREADS) {
      const int xm = e / (BK / 8);
      const int xk = (e % (BK / 8)) * 8;
      const int gm = m0 + xm;
      const int gk = kt + xk;
      float v8[8];
      if (gm < M && gk < k_end) {
        load8(x + (int64_t)gm * K + gk, v8);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v8[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[xk + j][xm] = v8[j];
    }
    // W_hat tile: (v_row[n] + v_col[k]) * sign + W_b, zero outside N / K
    {
      const int gk = kt + wk;
      float w8[8];
      if (n_ok && gk < k_end) {
        load8(wb + (int64_t)gn * K + gk, w8);
        const uint32_t bits = packed[(int64_t)gn * (K / 8) + gk / 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s = vrow + to_f32(vc[gk + j]);
          w8[j] = ((bits >> j) & 1u) ? w8[j] + s : w8[j] - s;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w8[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[wk + j][wn] = w8[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = y + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx + (BN / TN) * j;
      if (gc < N) out[(int64_t)gm * N + gc] = acc[i][j];
    }
  }
}

struct Args {
  const void* x;
  const void* packed;
  const void* vr;
  const void* vc;
  const void* wb;
  float* y;
  float* workspace;
  int M, N, K, splits, k_per_split;
  cudaStream_t stream;
};

template <int BM, int TM, typename TX, typename TV, typename TW>
void launch_tiles(const Args& a) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  bitlinear_axes_kernel<BM, TM, TX, TV, TW><<<grid, NTHREADS, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const TV*>(a.vr), static_cast<const TV*>(a.vc),
      static_cast<const TW*>(a.wb), dst, a.M, a.N, a.K, a.k_per_split);
}

template <typename TX, typename TV, typename TW>
void launch_m(const Args& a) {
  if (a.M <= 16)
    launch_tiles<16, 1, TX, TV, TW>(a);
  else
    launch_tiles<64, 4, TX, TV, TW>(a);
}

template <typename TX, typename TV>
bool launch_w(const Args& a, int wb_dtype) {
  if (wb_dtype == DT_F32) launch_m<TX, TV, float>(a);
  else if (wb_dtype == DT_BF16) launch_m<TX, TV, __nv_bfloat16>(a);
  else return false;
  return true;
}

template <typename TX>
bool launch_v(const Args& a, int v_dtype, int wb_dtype) {
  if (v_dtype == DT_F16) return launch_w<TX, __half>(a, wb_dtype);
  if (v_dtype == DT_F32) return launch_w<TX, float>(a, wb_dtype);
  return false;
}

}  // namespace

// x (M, K) fp32|bf16; packed (N, K/8) u8; vr (N,), vc (K,) fp16|fp32;
// wb (N, K) fp32|bf16; y (M, N) fp32.  With splits > 1, workspace holds
// (splits, M, N) fp32 partials and k_per_split is a multiple of 32.  All
// contiguous; x and wb 16-byte aligned; K a multiple of 8.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes(const void* x, int x_dtype, const void* packed,
                                    const void* vr, const void* vc, int v_dtype,
                                    const void* wb, int wb_dtype, void* y,
                                    void* workspace, int M, int N, int K,
                                    int splits, int k_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  Args a{x, packed, vr, vc, wb, static_cast<float*>(y),
         static_cast<float*>(workspace), M, N, K, splits, k_per_split,
         static_cast<cudaStream_t>(stream)};
  bool ok;
  if (x_dtype == DT_F32) ok = launch_v<float>(a, v_dtype, wb_dtype);
  else if (x_dtype == DT_BF16) ok = launch_v<__nv_bfloat16>(a, v_dtype, wb_dtype);
  else ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_splitk_reduce(a.workspace, a.y, (int64_t)M * N, splits,
                                   a.stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
