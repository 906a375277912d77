// Dense reconstruction  W_hat = v (.) unpack(B) + W_b  for a stack of L
// matrices.
//
// Replaces: src/repro/kernels/unpack_apply.py, unpack_apply_p (its `_kernel`
// body), which the loader vmaps over the stacked layer dim.  Here the stacked
// dim is part of the grid, so one launch covers the whole (L, d_out, d_in)
// stack.
//
// Bound on an H100: bytes.  Per element it reads 4 B of fp32 W_b and 1/8 B of
// sign mask and writes 4 B of fp32 output (8.125 B/element), with one add per
// element — about 0.1 operations per byte, far below the card's balance point.
//
// Design: each thread owns one packed sign byte, i.e. eight consecutive
// columns of one row.  It reads those eight W_b values as 16-byte vector
// loads, the byte itself, and the scale (one value per row, eight per-column
// values, or one per matrix — the mode is only a set of strides), and writes
// eight outputs as 16-byte stores.  Neighbouring threads take neighbouring
// bytes, so a warp streams 1 KiB of contiguous fp32 weights.  No shared
// memory; a grid-stride loop covers any size.
//
// Arithmetic is the plain version's: v * (+-1) is exact, so the result is
// W_b +- v with a single fp32 rounding, bit-identical to the reference.
#include "common.cuh"

template <typename TW, typename TO>
__global__ void __launch_bounds__(256) unpack_apply_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ v,
    int64_t vs_l, int64_t vs_r, int64_t vs_c, const TW* __restrict__ wb,
    TO* __restrict__ out, int64_t d_out, int64_t nb, int64_t total) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t cb = i % nb;   // packed byte within the row
    const int64_t lr = i / nb;   // l * d_out + row
    const int64_t r = lr % d_out;
    const int64_t l = lr / d_out;
    const uint32_t bits = packed[i];
    float w[8];
    load8(wb + i * 8, w);        // element (l, r, 8*cb) of a contiguous stack
    const float* vp = v + l * vs_l + r * vs_r + cb * 8 * vs_c;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = vp[j * vs_c];
      o[j] = ((bits >> j) & 1u) ? w[j] + s : w[j] - s;
    }
    store8(out + i * 8, o);
  }
}

template <typename TW, typename TO>
static void launch(const void* packed, const void* v, int64_t vs_l, int64_t vs_r,
                   int64_t vs_c, const void* wb, void* out, int64_t d_out,
                   int64_t nb, int64_t total, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  unpack_apply_kernel<TW, TO><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(v), vs_l,
      vs_r, vs_c, static_cast<const TW*>(wb), static_cast<TO*>(out), d_out, nb,
      total);
}

// packed (L, d_out, d_in/8) u8; v fp32 addressed as v[l*vs_l + r*vs_r + c*vs_c];
// wb (L, d_out, d_in) fp32|bf16; out (L, d_out, d_in) fp32|bf16.  All
// contiguous; wb and out 16-byte aligned.  Returns cudaGetLastError().
extern "C" int repro_unpack_apply(const void* packed, const void* v, int64_t vs_l,
                                  int64_t vs_r, int64_t vs_c, const void* wb,
                                  int wb_dtype, void* out, int out_dtype,
                                  int64_t L, int64_t d_out, int64_t d_in,
                                  void* stream) {
  const int64_t nb = d_in / 8;
  const int64_t total = L * d_out * nb;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wb_dtype == DT_F32 && out_dtype == DT_F32)
    launch<float, float>(packed, v, vs_l, vs_r, vs_c, wb, out, d_out, nb, total, s);
  else if (wb_dtype == DT_F32 && out_dtype == DT_BF16)
    launch<float, __nv_bfloat16>(packed, v, vs_l, vs_r, vs_c, wb, out, d_out, nb, total, s);
  else if (wb_dtype == DT_BF16 && out_dtype == DT_F32)
    launch<__nv_bfloat16, float>(packed, v, vs_l, vs_r, vs_c, wb, out, d_out, nb, total, s);
  else if (wb_dtype == DT_BF16 && out_dtype == DT_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(packed, v, vs_l, vs_r, vs_c, wb, out, d_out, nb, total, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
