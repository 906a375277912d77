// Dense reconstruction  W_hat = v (.) unpack(B) + W_b  for a stack of L
// matrices, over a full-precision or an int8 base.
//
// Replaces: src/repro/kernels/unpack_apply.py, unpack_apply_p — its `_kernel`
// body (fp32/bf16 W_b) and its `_kernel_q8` body (int8 W_b with one fp16
// scale per output row, dequantized before the delta add), which the loader
// vmaps over the stacked layer dim.  Here the stacked dim is part of the
// grid, so one launch covers the whole (L, d_out, d_in) stack.
//
// Bound on an H100: bytes.  Per element it reads 4 B of fp32 W_b (1 B of
// int8 W_b) and 1/8 B of sign mask and writes 4 B of fp32 output
// (8.125 B/element; 5.125 B over an int8 base), with one add (and one
// product under int8) per element — far below the card's balance point.
//
// Design: each thread owns one packed sign byte, i.e. eight consecutive
// columns of one row.  It reads those eight W_b values as vector loads
// (16 B of bf16, 2 x 16 B of fp32, 8 B of int8), the byte itself, the row's
// int8 scale where there is one, and the delta scale (one value per row,
// eight per-column values, or one per matrix — the mode is only a set of
// strides), and writes eight outputs as 16-byte stores.  Neighbouring
// threads take neighbouring bytes, so a warp streams contiguous weights.  No
// shared memory; a grid-stride loop covers any size.
//
// Arithmetic is the plain version's: q * s is one fp32 product (kept apart
// from the add, see dequant8), v * (+-1) is exact, so the result is
// W_b +- v with one fp32 rounding per step, bit-identical to the reference.
#include <type_traits>

#include "common.cuh"

template <typename TW, typename TO>
__global__ void __launch_bounds__(256) unpack_apply_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ v,
    int64_t vs_l, int64_t vs_r, int64_t vs_c, const TW* __restrict__ wb,
    const __half* __restrict__ ws, TO* __restrict__ out, int64_t d_out,
    int64_t nb, int64_t total) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
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
    if constexpr (Q8) dequant8(w, __half2float(ws[lr]));   // scale (l, r)
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

namespace {

struct Args {
  const void* packed;
  const void* v;
  int64_t vs_l, vs_r, vs_c;
  const void* wb;
  const void* ws;
  void* out;
  int64_t d_out, nb, total;
  cudaStream_t stream;
};

template <typename TW, typename TO>
void launch(const Args& a) {
  const int threads = 256;
  int64_t blocks = (a.total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  unpack_apply_kernel<TW, TO><<<(unsigned)blocks, threads, 0, a.stream>>>(
      static_cast<const uint8_t*>(a.packed), static_cast<const float*>(a.v),
      a.vs_l, a.vs_r, a.vs_c, static_cast<const TW*>(a.wb),
      static_cast<const __half*>(a.ws), static_cast<TO*>(a.out), a.d_out,
      a.nb, a.total);
}

template <typename TW>
bool launch_out(const Args& a, int out_dtype) {
  if (out_dtype == DT_F32) launch<TW, float>(a);
  else if (out_dtype == DT_BF16) launch<TW, __nv_bfloat16>(a);
  else if (out_dtype == DT_F16) launch<TW, __half>(a);
  else return false;
  return true;
}

}  // namespace

// packed (L, d_out, d_in/8) u8; v fp32 addressed as v[l*vs_l + r*vs_r + c*vs_c];
// wb (L, d_out, d_in) fp32|bf16|int8; ws (L, d_out) fp16 with an int8 wb,
// else nullptr; out (L, d_out, d_in) fp32|bf16|fp16.  All contiguous; wb
// 16-byte aligned (8-byte for int8), out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int repro_unpack_apply(const void* packed, const void* v, int64_t vs_l,
                                  int64_t vs_r, int64_t vs_c, const void* wb,
                                  int wb_dtype, const void* ws, void* out,
                                  int out_dtype, int64_t L, int64_t d_out,
                                  int64_t d_in, void* stream) {
  const int64_t nb = d_in / 8;
  const int64_t total = L * d_out * nb;
  if (total == 0) return 0;
  if ((wb_dtype == DT_I8) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  Args a{packed, v, vs_l, vs_r, vs_c, wb, ws, out, d_out, nb, total,
         static_cast<cudaStream_t>(stream)};
  bool ok;
  if (wb_dtype == DT_F32) ok = launch_out<float>(a, out_dtype);
  else if (wb_dtype == DT_BF16) ok = launch_out<__nv_bfloat16>(a, out_dtype);
  else if (wb_dtype == DT_I8) ok = launch_out<int8_t>(a, out_dtype);
  else ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
