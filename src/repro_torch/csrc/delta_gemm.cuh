// The delta GEMM shared by bitlinear_axes.cu and bitlinear.cu (and its
// helpers by bitlinear_axes_banked.cu and bitlinear_axes_stacked.cu):
//   y = x @ (scale(n, k) (.) unpack(B) + W_b)^T,   fp32 accumulation,
// with W_b fp32, bf16 or int8 (dequantized against one fp16 scale per output
// row, `ws`).  The two entry points differ only in how the delta scale of
// element (n, k) is read, which a small policy class supplies as a row part
// plus a column part:
//   * AxesScale    v_row[n] + v_col[k]     (bitlinear_axes_p, the overlay's
//                                            dual-axis form)
//   * StridedScale v[n*sn + k*sk]           (bitlinear_p, one static-mode
//                                            vector: row (1, 0), col (0, 1)
//                                            or scalar (0, 0) strides)
// Either way every Ŵ element is W_b +- scale, formed in fp32 with the plain
// version's roundings (an int8 base: one product q*s first), so only the
// order of the sums differs from it.
//
// Replaces, through those entry points: src/repro/kernels/bitlinear.py,
// bitlinear_axes_p (`_kernel_axes`, `_kernel_axes_q8`) and bitlinear_p
// (`_kernel`, `_kernel_q8`).
//
// Bound on an H100: at decode-sized M the bytes (W_b once, 4 B, 2 B or 1 B
// per weight, plus 1/8 B of signs; 2*M flops per weight); at M = 64 the
// operations (128 fp32 flops per weight; Ŵ is fp32, so the products run on
// the CUDA cores at 67 TFLOP/s, never on TF32 or bf16 tensor cores).
//
// Design, two kernels chosen by M (plan in kernels/bitlinear.py):
//   * stream_gemm_kernel, M <= 16 (decode).  Nothing is built in shared
//     memory: each warp owns four output rows and streams their W_b along K
//     with coalesced vector loads (lane l reads the l-th 16 bytes, or 8 for
//     int8, of each 512-byte or 256-byte warp access), two steps per lane
//     in flight at a time (256 B of fp32 or bf16, 128 B of int8), so a block
//     of eight warps keeps 32-64 KB of loads in flight all along.  Each lane
//     applies its sign bits and the scale in registers, keeps MT (4, 8 or
//     16) fp32 dot products per row, and the warp sums them with shuffles at
//     the end.  The block first
//     stages its K-slice of x (in the caller's dtype) and of the column
//     scale (fp32) in shared memory; rows of x past M are zeros, so M = 1..16
//     stream the same bytes with no padded weight rows.  K is split across
//     blockIdx.y only so far as rows alone cannot fill the card: the plan
//     picks the fewest splits that fill the last wave of blocks.
//   * tile_gemm_kernel, M > 16 (prefill).  A block of 128 threads owns a
//     64 x 128 output tile and walks K in steps of 32.  cp.async copies the
//     next step's raw x and W_b tiles into a second shared buffer (row pitch
//     an odd number of 16-byte units: conflict-free) while this step builds
//     fp32 x and Ŵ tiles, k-major, from the current one and multiplies them.
//     The block's column scales are staged once; the next step's sign bytes
//     wait in registers.  Each thread owns an 8 x 8 microtile, read with
//     float4 loads (two of x, two of Ŵ per k: 64 FMAs per four loads).
//   * Split-K partials go to a workspace and a second small kernel sums them
//     in a fixed order (common.cuh: deterministic, no atomics).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// stream kernel (kernels/bitlinear.py STREAM_ROWS, STREAM_SPAN, STREAM_SMEM)
constexpr int kRowsPerWarp = 4;
constexpr int kStreamRows = (kThreads / 32) * kRowsPerWarp;   // 32
constexpr int kStreamSmem = 48 * 1024;
// tile kernel (kernels/bitlinear.py TILE_M, TILE_N, TILE_K)
constexpr int kTileThreads = 128;
constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kTK = 32;
constexpr int kTileMaxK = 4096;   // a split's K: its column scales fit 16 KB

// v_row[n] + v_col[k].
template <typename TV>
struct AxesScale {
  const TV* vr;
  const TV* vc;
  __device__ __forceinline__ float row(int64_t n) const { return to_f32(vr[n]); }
  __device__ __forceinline__ float col(int64_t k) const { return to_f32(vc[k]); }
};

// v[n*sn + k*sk] with (sn, sk) in {(1, 0), (0, 1), (0, 0)}: the row part
// carries the row and scalar modes, the column part the col mode; the other
// part is 0, and x + 0 = x exactly.
struct StridedScale {
  const float* v;
  int64_t sn, sk;
  __device__ __forceinline__ float row(int64_t n) const {
    return sk == 0 ? v[n * sn] : 0.f;
  }
  __device__ __forceinline__ float col(int64_t k) const {
    return sk != 0 ? v[k * sk] : 0.f;
  }
};

// W_b + s where the sign bit is set, W_b - s where not.
__device__ __forceinline__ float apply_sign(float w, float s, uint32_t bit) {
  return bit ? w + s : w - s;
}

// ---------------------------------------------------------------------------
// stream kernel (M <= 16)
// ---------------------------------------------------------------------------

// How a lane reads W_b: NL vector loads per row per step of SPAN elements,
// VEC elements each; load j of lane l starts at element j*32*VEC + l*VEC, so
// a warp's load j covers 32*VEC contiguous elements.  Two steps are in
// flight at a time (the registers of one are loaded while the other's are
// used): per lane 256 B of fp32 or bf16, 128 B of int8.
template <typename TW> struct Stream;
template <> struct Stream<float> {           // 2 x 16 B: 512 B per access
  static constexpr int VEC = 4, NL = 2, SPAN = 256;
  using Raw = uint4;
};
template <> struct Stream<__nv_bfloat16> {   // 2 x 16 B: 512 B per access
  static constexpr int VEC = 8, NL = 2, SPAN = 512;
  using Raw = uint4;
};
template <> struct Stream<int8_t> {          // 2 x 8 B: 256 B per access
  static constexpr int VEC = 8, NL = 2, SPAN = 512;   // 8-byte aligned rows
  using Raw = uint2;
};

// W_b is read once: bypass L1.  (volatile: the loads stay where they are
// issued, a step ahead of their use.)
__device__ __forceinline__ void ld_stream(const void* p, uint4& r) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
}
__device__ __forceinline__ void ld_stream(const void* p, uint2& r) {
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y) : "l"(p));
}
__device__ __forceinline__ void zero(uint4& r) { r = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(uint2& r) { r = make_uint2(0, 0); }

// Elements 4g..4g+3 of a loaded vector, widened to fp32.
__device__ __forceinline__ void get4(const uint4& r, int g, float o[4], float) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
  o[0] = __uint_as_float(u[0]);
  o[1] = __uint_as_float(u[1]);
  o[2] = __uint_as_float(u[2]);
  o[3] = __uint_as_float(u[3]);
}
__device__ __forceinline__ void get4(const uint4& r, int g, float o[4],
                                     __nv_bfloat16) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t w = g ? u[2 + i] : u[i];
    o[2 * i] = __uint_as_float(w << 16);
    o[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
  }
}
__device__ __forceinline__ void get4(const uint2& r, int g, float o[4], int8_t) {
  const uint32_t w = g ? r.y : r.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (float)(int8_t)((w >> (8 * i)) & 0xffu);
}

// Four staged x values of one row, widened to fp32.
__device__ __forceinline__ void x4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void x4(const __nv_bfloat16* p, float o[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <int MT, typename TX, typename TW, typename Scale>
__global__ void __launch_bounds__(kThreads) stream_gemm_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed, Scale sc,
    const TW* __restrict__ wb, const __half* __restrict__ ws,
    float* __restrict__ y, int M, int N, int K, int k_per_split) {
  using S = Stream<TW>;
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  const int64_t out_mat = blockIdx.y;   // the (M, N) matrix of y it writes
  constexpr int R = kRowsPerWarp;
  constexpr int XV = 16 / sizeof(TX);   // x elements per 16-byte chunk
  extern __shared__ float4 smem4[];
  float* vcs = reinterpret_cast<float*>(smem4);         // column scale slice
  TX* xs = reinterpret_cast<TX*>(vcs + k_per_split);    // MT x k_per_split

  const int k_begin = blockIdx.y * k_per_split;
  const int k_len = min(K - k_begin, k_per_split);
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kStreamRows + (threadIdx.x >> 5) * R;
  bool ok[R];
  float vrow[R], wscale[R];
  const TW* wrow[R];
  const uint8_t* prow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r;
    ok[r] = n < N;
    const int64_t nc = ok[r] ? n : 0;
    vrow[r] = ok[r] ? sc.row(n) : 0.f;
    wscale[r] = Q8 && ok[r] ? __half2float(ws[nc]) : 1.f;
    wrow[r] = wb + nc * K + k_begin;
    prow[r] = packed + nc * (K / 8);
  }
  // two steps' W_b vectors and sign bytes per row, in registers.  A sign
  // byte is kept as loaded (nothing consumes it until its step is used, so
  // the load does not stall the warp); for fp32 (VEC 4) a lane's four bits
  // sit at bit 4 * (lane & 1) of it.
  typename S::Raw raw[2][R][S::NL];
  uint32_t bits[2][R][S::NL];
  const int bit0 = S::VEC == 4 ? 4 * (lane & 1) : 0;
  auto load_step = [&](int buf, int kl0) {
#pragma unroll
    for (int j = 0; j < S::NL; ++j) {
      const int e = kl0 + j * 32 * S::VEC + lane * S::VEC;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (ok[r] && e < k_len) {
          ld_stream(wrow[r] + e, raw[buf][r][j]);
          bits[buf][r][j] = prow[r][(k_begin + e) >> 3];
        } else {
          zero(raw[buf][r][j]);
          bits[buf][r][j] = 0;
        }
      }
    }
  };

  for (int i = threadIdx.x; i < k_per_split; i += kThreads)
    vcs[i] = i < k_len ? sc.col(k_begin + i) : 0.f;
  const int chunks = k_per_split / XV;
  for (int i = threadIdx.x; i < MT * chunks; i += kThreads) {
    const int m = i / chunks;
    const int c = (i - m * chunks) * XV;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M && c < k_len)
      v = *reinterpret_cast<const uint4*>(x + (int64_t)m * K + k_begin + c);
    *reinterpret_cast<uint4*>(xs + m * k_per_split + c) = v;
  }
  load_step(0, 0);
  __syncthreads();

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  // Elements past the slice are zeros of x: their Ŵ (+-s) adds nothing.
  auto compute_step = [&](int buf, int kl0) {
#pragma unroll
    for (int j = 0; j < S::NL; ++j) {
#pragma unroll
      for (int g = 0; g < S::VEC / 4; ++g) {
        const int e = kl0 + j * 32 * S::VEC + lane * S::VEC + 4 * g;
        const float4 c4 = *reinterpret_cast<const float4*>(vcs + e);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        float xv[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) x4(xs + m * k_per_split + e, xv[m]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float w[4];
          get4(raw[buf][r][j], g, w, TW());
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (Q8) w[i] = __fmul_rn(w[i], wscale[r]);
            w[i] = apply_sign(w[i], vrow[r] + cv[i],
                              (bits[buf][r][j] >> (bit0 + 4 * g + i)) & 1u);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[r][m] = fmaf(xv[m][i], w[i], acc[r][m]);
        }
      }
    }
  };
  for (int kl0 = 0; kl0 < k_len; kl0 += 2 * S::SPAN) {
    load_step(1, kl0 + S::SPAN);
    compute_step(0, kl0);
    if (kl0 + S::SPAN >= k_len) break;
    load_step(0, kl0 + 2 * S::SPAN);
    compute_step(1, kl0 + S::SPAN);
  }

  float* out = y + out_mat * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == (r * MT + m) % 32 && m < M && ok[r])
        out[(int64_t)m * N + n0 + r] = v;
    }
}

// ---------------------------------------------------------------------------
// tile kernel (M > 16)
// ---------------------------------------------------------------------------

// Raw tiles: row pitch (bytes) an odd multiple of 16, so the build pass's
// 16-byte reads, one row per lane, are free of bank conflicts.
template <typename T>
struct RawTile {
  static constexpr int kRowBytes = kTK * sizeof(T);   // 128, 64 or 32
  static constexpr int kPitch = kRowBytes + 16;       // 144, 80 or 48
  static constexpr int kChunk = sizeof(T) == 1 ? 8 : 16;   // cp.async size
  static constexpr int kChunksPerRow = kRowBytes / kChunk;
};

template <typename TX, typename TW>
struct TileSmem {
  static constexpr int kW = kTN * RawTile<TW>::kPitch;   // one raw W_b stage
  static constexpr int kX = kTM * RawTile<TX>::kPitch;   // one raw x stage
  static constexpr int kFixed =
      2 * (kW + kX) + (kTK * kTN + kTK * kTM) * (int)sizeof(float);
  // plus the block's column scales, k_per_split floats
  static int bytes(int k_per_split) { return kFixed + 4 * k_per_split; }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok,
                                         int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;   // 0: the chunk is zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename TX, typename TW, typename Scale>
__global__ void __launch_bounds__(kTileThreads) tile_gemm_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed, Scale sc,
    const TW* __restrict__ wb, const __half* __restrict__ ws,
    float* __restrict__ y, int M, int N, int K, int k_per_split) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  const int split = blockIdx.z;
  const int64_t out_mat = blockIdx.z;   // the (M, N) matrix of y it writes
  using RW = RawTile<TW>;
  using RX = RawTile<TX>;
  using L = TileSmem<TX, TW>;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  char* rw = base;                      // 2 raw W_b stages
  char* rx = base + 2 * L::kW;          // 2 raw x stages
  float* wt = reinterpret_cast<float*>(rx + 2 * L::kX);   // Ŵ [kTK][kTN]
  float* xt = wt + kTK * kTN;                             // x [kTK][kTM]
  float* cs = xt + kTK * kTM;                             // column scales

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = (k_end - k_begin + kTK - 1) / kTK;

  // cp.async of step s into stage s & 1
  auto issue = [&](int s) {
    const int k0 = k_begin + s * kTK;
    char* dw = rw + (s & 1) * L::kW;
    for (int c = tid; c < kTN * RW::kChunksPerRow; c += kTileThreads) {
      const int r = c / RW::kChunksPerRow;
      const int e = (c % RW::kChunksPerRow) * (RW::kChunk / (int)sizeof(TW));
      const bool ok = n0 + r < N && k0 + e < k_end;
      const TW* src = ok ? wb + (int64_t)(n0 + r) * K + k0 + e : wb;
      cp_async(dw + r * RW::kPitch + e * sizeof(TW), src, ok, RW::kChunk);
    }
    char* dx = rx + (s & 1) * L::kX;
    for (int c = tid; c < kTM * RX::kChunksPerRow; c += kTileThreads) {
      const int r = c / RX::kChunksPerRow;
      const int e = (c % RX::kChunksPerRow) * (RX::kChunk / (int)sizeof(TX));
      const bool ok = m0 + r < M && k0 + e < k_end;
      const TX* src = ok ? x + (int64_t)(m0 + r) * K + k0 + e : x;
      cp_async(dx + r * RX::kPitch + e * sizeof(TX), src, ok, RX::kChunk);
    }
    cp_async_commit();
  };

  // Ŵ build role: row tid of the tile, the step's 32 elements
  const int gn = n0 + tid;
  const bool n_ok = gn < N;
  const float vrow = n_ok ? sc.row(gn) : 0.f;
  const float wscale = Q8 && n_ok ? __half2float(ws[gn]) : 1.f;
  const uint8_t* prow = packed + (int64_t)(n_ok ? gn : 0) * (K / 8);
  // the next step's four sign bytes, kept as loaded until their step
  uint32_t bytes_next[4];
  auto fetch = [&](int s) {
    const int k0 = k_begin + s * kTK;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bytes_next[b] = n_ok && k0 + 8 * b < k_end ? prow[(k0 >> 3) + b] : 0u;
  };
  // x transpose role: row xm of the tile, elements 16*xq .. 16*xq + 15
  const int xm = tid % kTM;
  const int xq = tid / kTM;

  // compute role: rows ty*8 + i, columns tx*4 + c and 64 + tx*4 + c
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  issue(0);
  fetch(0);
  for (int i = tid; i < steps * kTK; i += kTileThreads)
    cs[i] = k_begin + i < k_end ? sc.col(k_begin + i) : 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();   // stage s & 1 landed; the last step's tiles are free
    if (s + 1 < steps) issue(s + 1);
    const uint32_t bits = bytes_next[0] | bytes_next[1] << 8 |
                          bytes_next[2] << 16 | bytes_next[3] << 24;
    if (s + 1 < steps) fetch(s + 1);
    {
      const TW* src =
          reinterpret_cast<const TW*>(rw + (s & 1) * L::kW + tid * RW::kPitch);
      const float* col = cs + s * kTK;
#pragma unroll
      for (int h = 0; h < kTK / 8; ++h) {
        float w[8];
        load8(src + 8 * h, w);
        const float4 c0 = *reinterpret_cast<const float4*>(col + 8 * h);
        const float4 c1 = *reinterpret_cast<const float4*>(col + 8 * h + 4);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (Q8) w[j] = __fmul_rn(w[j], wscale);
          w[j] = apply_sign(w[j], vrow + cv[j], (bits >> (8 * h + j)) & 1u);
          wt[(8 * h + j) * kTN + tid] = w[j];
        }
      }
      const TX* xsrc = reinterpret_cast<const TX*>(
          rx + (s & 1) * L::kX + xm * RX::kPitch) + 16 * xq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float xv[8];
        load8(xsrc + 8 * h, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) xt[(16 * xq + 8 * h + j) * kTM + xm] = xv[j];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(wt + k * kTN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wt + k * kTN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = y + out_mat * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < N) out[(int64_t)gm * N + gc] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

template <int MT, typename TX, typename TW, typename Scale>
cudaError_t launch_stream(const GemmArgs& a, const Scale& sc) {
  const size_t smem = (size_t)a.k_per_split * (sizeof(float) + MT * sizeof(TX));
  if (a.k_per_split % Stream<TW>::SPAN || smem > (size_t)kStreamSmem)
    return cudaErrorInvalidValue;
  const dim3 grid((a.N + kStreamRows - 1) / kStreamRows, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  stream_gemm_kernel<MT, TX, TW, Scale>
      <<<grid, kThreads, smem, a.stream>>>(
          static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed),
          sc, static_cast<const TW*>(a.wb), static_cast<const __half*>(a.ws),
          dst, a.M, a.N, a.K, a.k_per_split);
  return cudaGetLastError();
}

template <typename TX, typename TW, typename Scale>
cudaError_t launch_tiles(const GemmArgs& a, const Scale& sc) {
  if (a.k_per_split % kTK || a.k_per_split > kTileMaxK)
    return cudaErrorInvalidValue;
  auto kern = tile_gemm_kernel<TX, TW, Scale>;
  const int bytes = TileSmem<TX, TW>::bytes(a.k_per_split);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kTN - 1) / kTN, (a.M + kTM - 1) / kTM, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  kern<<<grid, kTileThreads, bytes, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed), sc,
      static_cast<const TW*>(a.wb), static_cast<const __half*>(a.ws), dst,
      a.M, a.N, a.K, a.k_per_split);
  return cudaGetLastError();
}

template <typename TX, typename TW, typename Scale>
cudaError_t launch_m(const GemmArgs& a, const Scale& sc) {
  if (a.M <= 4) return launch_stream<4, TX, TW>(a, sc);
  if (a.M <= 8) return launch_stream<8, TX, TW>(a, sc);
  if (a.M <= 16) return launch_stream<16, TX, TW>(a, sc);
  return launch_tiles<TX, TW>(a, sc);
}

template <typename TX, typename Scale>
cudaError_t launch_w(const GemmArgs& a, const Scale& sc, int wb_dtype) {
  if (wb_dtype == DT_F32) return launch_m<TX, float>(a, sc);
  if (wb_dtype == DT_BF16) return launch_m<TX, __nv_bfloat16>(a, sc);
  if (wb_dtype == DT_I8) return launch_m<TX, int8_t>(a, sc);
  return cudaErrorInvalidValue;
}

// Instantiate over x and W_b types, launch, then the split-K pass.  Returns
// a cudaError_t as int.
template <typename Scale>
int run_gemm(const GemmArgs& a, const Scale& sc, int x_dtype, int wb_dtype) {
  if (a.M == 0 || a.N == 0) return 0;
  if ((wb_dtype == DT_I8) != (a.ws != nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (x_dtype == DT_F32) err = launch_w<float>(a, sc, wb_dtype);
  else if (x_dtype == DT_BF16) err = launch_w<__nv_bfloat16>(a, sc, wb_dtype);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return (int)launch_splitk_reduce(a.workspace, a.y, (int64_t)a.M * a.N,
                                   a.splits, a.stream);
}

}  // namespace
