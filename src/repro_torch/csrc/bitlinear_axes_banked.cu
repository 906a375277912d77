// Mixed-variant fused delta GEMM over an overlay bank
//   y[m] = x[m] @ ((vr[s,n] + vc[s,k]) (.) unpack(B[s]) + W_b)^T,  s = vidx[m],
// fp32 accumulation.  Slot 0 of the bank is the base: its vectors are zero,
// so rows naming it compute x[m] @ W_b^T, and the kernel reads W_b for them
// without touching slot 0's sign plane or vectors.
//
// Replaces: src/repro/kernels/bitlinear.py, bitlinear_axes_banked_p — its
// `_kernel_axes_banked` body (fp32/bf16 W_b) and its `_kernel_axes_banked_q8`
// body (int8 W_b with one fp16 scale per output row, shared by every slot).
//
// Bound on an H100 at the serving path's shapes:
//   * decode, M = 4 lanes: bytes.  The function must stream W_b once (4 B per
//     weight of fp32, 1 B of int8) plus the sign plane (1/8 B per weight) and
//     vectors of each distinct non-zero slot the rows name, against
//     2*M = 8 flops per weight.
//   * prefill, M = 4 lanes x 16 tokens = 64: operations (128 fp32 flops per
//     weight on the CUDA cores against about 4.3 B).
//
// Design (a tile build in shared memory; the streaming scheme of
// delta_gemm.cuh is not applied here yet):
//   * A block owns a BM x 64 output tile and walks K in steps of 32 (launch
//     plan: kernels/bitlinear.banked_plan); decode-sized calls split K across
//     blockIdx.z and a second pass sums the splits in a fixed order
//     (deterministic, no atomics).
//   * The TPU kernel pulls the whole bank block into VMEM on every grid step
//     and forms a Ŵ per ROW (bm x bn x bk).  Here a block first loads its
//     rows' slot indices and lists the distinct slots among them.  Per K step
//     each thread loads its eight W_b values once, into registers (an int8
//     base is dequantized there, once, against the row's scale — the
//     counterpart of the TPU kernel's one dequant per tile), and writes
//     one shared-memory Ŵ tile per distinct slot: W_b +- (vr[s,n] + vc[s,k])
//     from that slot's sign byte and vectors (the same fp32 values, one
//     rounding, that the plain version forms), or W_b itself for slot 0.  The
//     tile builds scale with the distinct slots, not with the rows, and W_b
//     is read once whatever the mix.
//   * Up to DMAX = 4 tiles are staged at once (34 KB of shared memory); a
//     block whose rows name more slots makes several passes over the same x
//     tile.  Each row accumulates only against its own slot's tile.
//   * A thread owns TM contiguous rows (row ty*TM + i), so in prefill its
//     rows are tokens of one lane, name one slot and read one tile.
//   * A slot index outside [0, V) traps before any bank read: the launch
//     fails with a CUDA error, as a device-side assert does in PyTorch.
//     Nothing is clamped.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TN = 4;
constexpr int NTHREADS = 256;
constexpr int DMAX = 4;                  // Ŵ tiles staged at once
constexpr int WSTRIDE = BN + 1;          // padded tile row (bank-conflict free)
constexpr int TILE = BK * WSTRIDE + 16;  // tiles 16 banks apart

template <int BM, int TM, typename TX, typename TV, typename TW>
__global__ void __launch_bounds__(NTHREADS) bitlinear_axes_banked_kernel(
    const TX* __restrict__ x, const int* __restrict__ vidx,
    const uint8_t* __restrict__ packed, const TV* __restrict__ vr,
    const TV* __restrict__ vc, const TW* __restrict__ wb,
    const __half* __restrict__ wsc, float* __restrict__ y, int M, int N, int K,
    int V, int k_per_split) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int TY = BM / TM;
  static_assert(TY * (BN / TN) == NTHREADS, "thread layout must cover the tile");
  __shared__ float xs[BK][BM + 1];
  __shared__ float wt[DMAX * TILE];
  __shared__ int row_slot[BM];   // bank slot of each row; -1 past M
  __shared__ int row_d[BM];      // the slot's index in dslots; -1 past M
  __shared__ int dslots[BM];     // distinct slots, in order of first use
  __shared__ int n_distinct;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // output columns tx + 16*j
  const int ty = tid / (BN / TN);   // output rows ty*TM + i
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  if (tid < BM) {
    const int gm = m0 + tid;
    int s = -1;
    if (gm < M) {
      s = vidx[gm];
      if (s < 0 || s >= V) __trap();   // never read outside the bank
    }
    row_slot[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    int nd = 0;
    for (int r = 0; r < BM; ++r) {
      const int s = row_slot[r];
      int d = -1;
      if (s >= 0) {
        for (int j = 0; j < nd; ++j)
          if (dslots[j] == s) { d = j; break; }
        if (d < 0) { dslots[nd] = s; d = nd++; }
      }
      row_d[r] = d;
    }
    n_distinct = nd;
  }
  __syncthreads();
  const int nd = n_distinct;
  int rd[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rd[i] = row_d[ty * TM + i];

  // Ŵ tile role: one packed byte = row wn, columns wk..wk+7 of the step
  const int wn = tid >> 2;
  const int wk = (tid & 3) * 8;
  const int gn = n0 + wn;
  const bool n_ok = gn < N;
  float wscale = 1.f;
  if constexpr (Q8) wscale = n_ok ? __half2float(wsc[gn]) : 0.f;

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
    // this thread's eight W_b values of the step, read once for every slot
    const int gk = kt + wk;
    const bool w_ok = n_ok && gk < k_end;
    float w8[8];
    if (w_ok) {
      load8(wb + (int64_t)gn * K + gk, w8);
      if constexpr (Q8) dequant8(w8, wscale);   // once, for every slot
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w8[j] = 0.f;
    }
    for (int c0 = 0; c0 < nd; c0 += DMAX) {
      const int nc = min(DMAX, nd - c0);
      // one Ŵ tile per distinct slot of this pass
      for (int t = 0; t < nc; ++t) {
        const int s = dslots[c0 + t];
        float o[8];
        if (w_ok && s != 0) {
          const uint32_t bits =
              packed[((int64_t)s * N + gn) * (K / 8) + gk / 8];
          float c8[8];
          load8(vc + (int64_t)s * K + gk, c8);
          const float vrow = to_f32(vr[(int64_t)s * N + gn]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float sc = vrow + c8[j];
            o[j] = ((bits >> j) & 1u) ? w8[j] + sc : w8[j] - sc;
          }
        } else {   // slot 0 (the base), or outside N / K (zeros)
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = w8[j];
        }
        float* tile = wt + t * TILE;
#pragma unroll
        for (int j = 0; j < 8; ++j) tile[(wk + j) * WSTRIDE + wn] = o[j];
      }
      __syncthreads();
      // each row against its own slot's tile, if the slot is in this pass
      int tt[TM];
      bool uniform = true;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int d = rd[i] - c0;
        tt[i] = (rd[i] >= 0 && d >= 0 && d < nc) ? d : -1;
        uniform = uniform && tt[i] == tt[0];
      }
      if (uniform) {
        if (tt[0] >= 0) {
          const float* tile = wt + tt[0] * TILE;
#pragma unroll
          for (int k = 0; k < BK; ++k) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j)
              b[j] = tile[k * WSTRIDE + tx + (BN / TN) * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (tt[i] < 0) continue;
            const float a = xs[k][ty * TM + i];
            const float* row = wt + tt[i] * TILE + k * WSTRIDE + tx;
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a, row[(BN / TN) * j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  float* out = y + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
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
  const int* vidx;
  const void* packed;
  const void* vr;
  const void* vc;
  const void* wb;
  const void* ws;      // int8 base: (N,) fp16 row scales; else nullptr
  float* y;
  float* workspace;
  int M, N, K, V, splits, k_per_split;
  cudaStream_t stream;
};

template <int BM, int TM, typename TX, typename TV, typename TW>
void launch_tiles(const Args& a) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  bitlinear_axes_banked_kernel<BM, TM, TX, TV, TW>
      <<<grid, NTHREADS, 0, a.stream>>>(
          static_cast<const TX*>(a.x), a.vidx,
          static_cast<const uint8_t*>(a.packed), static_cast<const TV*>(a.vr),
          static_cast<const TV*>(a.vc), static_cast<const TW*>(a.wb),
          static_cast<const __half*>(a.ws), dst, a.M, a.N, a.K, a.V,
          a.k_per_split);
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
  else if (wb_dtype == DT_I8) launch_m<TX, TV, int8_t>(a);
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

// x (M, K) fp32|bf16; vidx (M,) int32 in [0, V); packed (V, N, K/8) u8;
// vr (V, N), vc (V, K) fp16|fp32 with slot 0 all zero; wb (N, K)
// fp32|bf16|int8; ws (N,) fp16 with an int8 wb, else nullptr; y (M, N) fp32.
// With splits > 1, workspace holds (splits, M, N) fp32 partials and
// k_per_split is a multiple of 32.  All contiguous; x and vc 16-byte
// aligned, wb 16-byte aligned (8-byte for int8); K a multiple of 8.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes_banked(
    const void* x, int x_dtype, const void* vidx, const void* packed,
    const void* vr, const void* vc, int v_dtype, const void* wb, int wb_dtype,
    const void* ws, void* y, void* workspace, int M, int N, int K, int V,
    int splits, int k_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  if ((wb_dtype == DT_I8) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const int*>(vidx), packed, vr, vc, wb, ws,
         static_cast<float*>(y), static_cast<float*>(workspace), M, N, K, V,
         splits, k_per_split, static_cast<cudaStream_t>(stream)};
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
