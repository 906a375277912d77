// The tiled delta GEMM shared by bitlinear_axes.cu and bitlinear.cu:
//   y = x @ (scale(n, k) (.) unpack(B) + W_b)^T,   fp32 accumulation,
// with W_b fp32, bf16 or int8 (dequantized against one fp16 scale per output
// row, `ws`).  The two entry points differ only in how the delta scale of
// element (n, k) is read, which a small policy class supplies:
//   * AxesScale    v_row[n] + v_col[k]     (bitlinear_axes_p, the overlay's
//                                            dual-axis form)
//   * StridedScale v[n*sn + k*sk]           (bitlinear_p, one static-mode
//                                            vector: row (1, 0), col (0, 1)
//                                            or scalar (0, 0) strides)
//
// Design (simple and correct first; wgmma/TMA come later):
//   * A block owns a BM x 64 output tile and walks K in steps of 32.  Per step
//     it stages the x tile (widened to fp32) and builds the W_hat tile in
//     shared memory: each of the 256 threads takes one packed sign byte (one
//     row, eight columns), reads the eight W_b values as vector loads (an
//     int8 base: one 8-byte load, dequantized in registers against the row's
//     scale, read once per thread) and writes W_b +- scale — the same fp32
//     values the plain version forms, so only the summation order differs
//     from it.  The dense W_hat never reaches device memory.
//   * Each thread accumulates TM x 4 outputs in fp32 registers.  BM = 16 for
//     decode-sized M (less wasted work on the ragged M edge, which is masked),
//     BM = 64 otherwise.
//   * Decode-sized calls have too few output tiles to fill 132 SMs, so K is
//     split across blockIdx.z; each split writes its partial tile to a
//     workspace and a second small kernel sums the splits in a fixed order
//     (deterministic, no atomics).
//   * Shared tiles are padded to an odd row stride (65 / BM+1) so the
//     transposed stores and the compute reads are free of bank conflicts.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TN = 4;
constexpr int NTHREADS = 256;

// v_row[n] + v_col[k]: the row part is read once per thread.
template <typename TV>
struct AxesScale {
  const TV* vr;
  const TV* vc;
  __device__ __forceinline__ float row(int64_t n) const { return to_f32(vr[n]); }
  __device__ __forceinline__ float at(float r, int64_t, int64_t k) const {
    return r + to_f32(vc[k]);
  }
};

// v[n*sn + k*sk]: one static-mode vector, the mode a pair of strides.
template <typename TV>
struct StridedScale {
  const TV* v;
  int64_t sn, sk;
  __device__ __forceinline__ float row(int64_t) const { return 0.f; }
  __device__ __forceinline__ float at(float, int64_t n, int64_t k) const {
    return to_f32(v[n * sn + k * sk]);
  }
};

template <int BM, int TM, typename TX, typename TW, typename Scale>
__global__ void __launch_bounds__(NTHREADS) delta_gemm_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed, Scale sc,
    const TW* __restrict__ wb, const __half* __restrict__ ws,
    float* __restrict__ y, int M, int N, int K, int k_per_split) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int TY = BM / TM;
  static_assert(TY * (BN / TN) == NTHREADS, "thread layout must cover the tile");
  __shared__ float xs[BK][BM + 1];
  __shared__ float wt[BK][BN + 1];

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
  const float vrow = n_ok ? sc.row(gn) : 0.f;
  float wscale = 1.f;
  if constexpr (Q8) wscale = n_ok ? __half2float(ws[gn]) : 0.f;

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
    // W_hat tile: scale(n, k) * sign + W_b, zero outside N / K
    {
      const int gk = kt + wk;
      float w8[8];
      if (n_ok && gk < k_end) {
        load8(wb + (int64_t)gn * K + gk, w8);
        if constexpr (Q8) dequant8(w8, wscale);
        const uint32_t bits = packed[(int64_t)gn * (K / 8) + gk / 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s = sc.at(vrow, gn, gk + j);
          w8[j] = ((bits >> j) & 1u) ? w8[j] + s : w8[j] - s;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w8[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) wt[wk + j][wn] = w8[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wt[k][tx + (BN / TN) * j];
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

struct GemmArgs {
  const void* x;
  const void* packed;
  const void* wb;
  const void* ws;      // int8 base: (N,) fp16 row scales; else nullptr
  float* y;
  float* workspace;
  int M, N, K, splits, k_per_split;
  cudaStream_t stream;
};

template <int BM, int TM, typename TX, typename TW, typename Scale>
void launch_tiles(const GemmArgs& a, const Scale& sc) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  delta_gemm_kernel<BM, TM, TX, TW, Scale><<<grid, NTHREADS, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed), sc,
      static_cast<const TW*>(a.wb), static_cast<const __half*>(a.ws), dst,
      a.M, a.N, a.K, a.k_per_split);
}

template <typename TX, typename TW, typename Scale>
void launch_m(const GemmArgs& a, const Scale& sc) {
  if (a.M <= 16)
    launch_tiles<16, 1, TX, TW>(a, sc);
  else
    launch_tiles<64, 4, TX, TW>(a, sc);
}

template <typename TX, typename Scale>
bool launch_w(const GemmArgs& a, const Scale& sc, int wb_dtype) {
  if (wb_dtype == DT_F32) launch_m<TX, float>(a, sc);
  else if (wb_dtype == DT_BF16) launch_m<TX, __nv_bfloat16>(a, sc);
  else if (wb_dtype == DT_I8) launch_m<TX, int8_t>(a, sc);
  else return false;
  return true;
}

// Instantiate over x and W_b types, launch, then the split-K pass.
// Returns a cudaError_t as int.
template <typename Scale>
int run_gemm(const GemmArgs& a, const Scale& sc, int x_dtype, int wb_dtype) {
  if (a.M == 0 || a.N == 0) return 0;
  if ((wb_dtype == DT_I8) != (a.ws != nullptr)) return (int)cudaErrorInvalidValue;
  bool ok;
  if (x_dtype == DT_F32) ok = launch_w<float>(a, sc, wb_dtype);
  else if (x_dtype == DT_BF16) ok = launch_w<__nv_bfloat16>(a, sc, wb_dtype);
  else ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return (int)launch_splitk_reduce(a.workspace, a.y, (int64_t)a.M * a.N,
                                   a.splits, a.stream);
}

}  // namespace
