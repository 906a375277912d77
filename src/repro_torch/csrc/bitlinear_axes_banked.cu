// Mixed-variant fused delta GEMM over an overlay bank
//   y[m] = x[m] @ ((vr[s,n] + vc[s,k]) (.) unpack(B[s]) + W_b)^T,  s = vidx[m],
// fp32 accumulation.  Slot 0 of the bank is the base: its vectors are zero,
// so rows naming it compute x[m] @ W_b^T, and the kernels read W_b for them
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
// Design: the two kernels of delta_gemm.cuh, with a slot per row.  Each block
// first reads the slot indices of its rows (an index outside [0, V) traps
// before any bank read: the launch fails with a CUDA error, as a device-side
// assert does in PyTorch; nothing is clamped) and lists the distinct slots
// among them.
//   * banked_stream_kernel, M <= 16 (decode).  As stream_gemm_kernel: warps
//     own four output rows and stream their W_b once along K with 16-byte
//     loads (8 for int8) two steps in flight.  A block serves four rows of
//     x: the rows sorted by slot (base first), the block's four taken from
//     that order, neighbouring blocks (the same W_b rows) serving the other
//     groups, so M = 5..16 reads W_b from device memory about once and
//     from L2 once per group.  Beside each W_b vector a lane loads the sign
//     byte of each distinct non-base slot of its group; the slots' column
//     scales and the rows of x are staged in shared memory as fp32, the row
//     scales sit in registers.  Ŵ is formed in registers once per distinct
//     slot, not once per row (an int8 base dequantized once for all of
//     them), the sign applied as the sign bit of the scale, and each row
//     accumulates against the Ŵ of its own slot or W_b itself.  Sorted, a
//     group's row-to-slot map is one of 16 sequences, and each has a body
//     with the map fixed at compile time, so no row selects its Ŵ at run
//     time: [0,1,2,1] forms two Ŵ per weight and four products, an all-base
//     group streams W_b alone.  Up to kBankPass = 3 slots a pass (all a
//     4-slot bank can name); four take a second pass over the K-slice with
//     the other rows' x zeroed (they add exact zeros).
//   * banked_tile_kernel, M > 16 (prefill).  As tile_gemm_kernel: 64 x 128
//     output tiles, K in steps of 32, cp.async double-buffered raw x and W_b
//     tiles, 8 x 8 microtiles on contiguous rows ty*8 + i.  Per step the
//     block builds one fp32 Ŵ tile for each distinct slot of its 64 rows
//     (the base counts: its tile is W_b), up to kBankTiles = 3 at a time
//     (more take further passes); three tiles and 512-column splits keep
//     two blocks on an SM.  A thread whose eight rows name one slot (a
//     serving lane's tokens do when a lane holds a multiple of eight) reads
//     that tile with float4 loads as the single-variant kernel does; rows
//     that span slots take one product per tile they name, the other rows'
//     x zero.
//   * The launch plan (kernels/bitlinear.gemm_plan, banked) depends on M, N,
//     K and the dtypes only, never on V or vidx, so the host never reads
//     vidx; split-K partials go to a workspace and a second pass sums them
//     in a fixed order (deterministic, no atomics).
#include "delta_gemm.cuh"

namespace {

// kernels/bitlinear.py BANK_PASS, BANK_STREAM_SMEM, BANK_TILES,
// BANK_TILE_MAX_K
constexpr int kBankPass = 3;                 // non-base slots per stream pass
constexpr int kBankStreamSmem = 192 * 1024;  // column scales + x (fp32)
constexpr int kBankTiles = 3;                // Ŵ tiles per tiled pass
constexpr int kBankTileMaxK = 512;           // a split's column scales

__device__ __forceinline__ float vget(const void* p, int64_t i, int v16) {
  return v16 ? __half2float(static_cast<const __half*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// The bank operands.
struct Bank {
  const int* vidx;         // (M,) slot per row
  const uint8_t* packed;   // (V, N, K/8)
  const void* vr;          // (V, N) fp16|fp32
  const void* vc;          // (V, K) fp16|fp32
  int v16;                 // the vectors are fp16
  int V;
};

// ---------------------------------------------------------------------------
// stream kernel (M <= 16)
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;   // rows of x per block
constexpr int kMaxGroups = 4;   // M <= 16

// Which Ŵ each row of a pass takes: its slot among the pass's ND (0..ND-1)
// or -1 for W_b.  The block sorts its rows by slot, so the map is one of
// the non-decreasing sequences below (the last: four slots, the fourth in
// a second pass) and each gets a body of its own with the map fixed at
// compile time: no per-element select.
template <int L0, int L1, int L2, int L3>
struct Fixed {
  __device__ __forceinline__ int at(int m) const {
    return m == 0 ? L0 : m == 1 ? L1 : m == 2 ? L2 : L3;
  }
};
__host__ __device__ constexpr int pattern_key(int a, int b, int c, int d) {
  return (a + 1) + 5 * (b + 1) + 25 * (c + 1) + 125 * (d + 1);
}
// (slots, row map) of every pass over four sorted rows
#define REPRO_PATTERNS(X)                                                   \
  X(0, -1, -1, -1, -1)                                                      \
  X(1, -1, -1, -1, 0) X(1, -1, -1, 0, 0) X(1, -1, 0, 0, 0) X(1, 0, 0, 0, 0) \
  X(2, -1, -1, 0, 1) X(2, -1, 0, 0, 1) X(2, -1, 0, 1, 1)                    \
  X(2, 0, 0, 0, 1) X(2, 0, 0, 1, 1) X(2, 0, 1, 1, 1)                        \
  X(3, -1, 0, 1, 2) X(3, 0, 0, 1, 2) X(3, 0, 1, 1, 2) X(3, 0, 1, 2, 2)     \
  X(3, 0, 1, 2, -1)

// Elements 4g..4g+3 of a loaded W_b vector, widened to fp32.  int8 goes
// through the fp32 adder, not the converter (a quarter of its rate on the
// card): byte b + 128 becomes the low mantissa bits of 2^23, and the
// subtraction 2^23 + 128 gives b exactly.
template <typename Raw, typename TW>
__device__ __forceinline__ void unpack4(const Raw& r, int g, float o[4], TW) {
  get4(r, g, o, TW());
}
__device__ __forceinline__ void unpack4(const uint2& r, int g, float o[4],
                                        int8_t) {
  const uint32_t u = (g ? r.y : r.x) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, i | 0x7650)) -
           8388736.f;
}

// W_b + s where the sign bit is set, W_b - s where not, as W_b + (+-s): the
// inverted bit nb at bit `pos` becomes the sign of s (w - s and w + (-s)
// are the same IEEE result).
__device__ __forceinline__ float add_signed(float w, float s, uint32_t nb,
                                            int pos) {
  return w + __int_as_float(__float_as_int(s) ^
                            ((nb << (31 - pos)) & 0x80000000u));
}

// dst[i] = the slot's column scale k_begin + i, widened to fp32, for i < len
// and 0 for len <= i < cap; each thread keeps eight loads in flight.
template <typename TV>
__device__ __forceinline__ void stage_cols(float* dst, const TV* v, int len,
                                           int cap, int nthreads) {
  for (int i0 = threadIdx.x; i0 < cap; i0 += 8 * nthreads) {
    float f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads;
      f[u] = i < len ? to_f32(v[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads;
      if (i < cap) dst[i] = f[u];
    }
  }
}
__device__ __forceinline__ void stage_cols(float* dst, const Bank& bk,
                                           int64_t from, int len, int cap,
                                           int nthreads) {
  if (bk.v16)
    stage_cols(dst, static_cast<const __half*>(bk.vc) + from, len, cap,
               nthreads);
  else
    stage_cols(dst, static_cast<const float*>(bk.vc) + from, len, cap,
               nthreads);
}

// One pass over the block's K-slice with ND distinct non-base slots
// (slots[0..ND)): stages their column scales and the x rows of the pass
// (fp32, rows in sorted order), then streams W_b.
template <int ND, typename TW, typename Sel>
__device__ __forceinline__ void stream_pass(
    const void* __restrict__ x, int x16, const Bank& bk, const int* slots,
    const int* keep, const int* row_of, Sel sel, float* vcs, float* xs,
    const bool (&ok)[kRowsPerWarp], const float (&wscale)[kRowsPerWarp],
    const TW* const (&wrow)[kRowsPerWarp], int n0, int M, int N, int K,
    int k_begin, int k_len, int k_per_split,
    float (&acc)[kRowsPerWarp][kGroup]) {
  constexpr int MT = kGroup;
  using S = Stream<TW>;
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int R = kRowsPerWarp;
  constexpr int NS = ND > 0 ? ND : 1;      // array extents
  const int lane = threadIdx.x & 31;
  const int bit0 = S::VEC == 4 ? 4 * (lane & 1) : 0;
  const int64_t kb = K / 8;

  float vrow[NS][R];
  const uint8_t* pslot[NS];
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const int64_t s = slots[t];
    pslot[t] = bk.packed + s * N * kb + (k_begin >> 3);
#pragma unroll
    for (int r = 0; r < R; ++r)
      vrow[t][r] = ok[r] ? vget(bk.vr, s * N + n0 + r, bk.v16) : 0.f;
  }
  typename S::Raw raw[2][R][S::NL];
  uint32_t bits[2][NS][R][S::NL];
  auto load_step = [&](int buf, int kl0) {
#pragma unroll
    for (int j = 0; j < S::NL; ++j) {
      const int e = kl0 + j * 32 * S::VEC + lane * S::VEC;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = ok[r] && e < k_len;
        if (in) ld_stream(wrow[r] + e, raw[buf][r][j]);
        else zero(raw[buf][r][j]);
#pragma unroll
        for (int t = 0; t < ND; ++t)
          bits[buf][t][r][j] =
              in ? pslot[t][(int64_t)(n0 + r) * kb + (e >> 3)] : 0u;
      }
    }
  };

  load_step(0, 0);
#pragma unroll
  for (int t = 0; t < ND; ++t)
    stage_cols(vcs + t * k_per_split, bk, (int64_t)slots[t] * K + k_begin,
               k_len, k_per_split, kThreads);
  // x rows in sorted order, widened to fp32; four chunks of eight a thread
  // in flight at a time
  const int chunks = k_per_split / 8;
  auto stage_x = [&](const auto* xp) {
    for (int i0 = threadIdx.x; i0 < MT * chunks; i0 += 4 * kThreads) {
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        const int m = i / chunks;
        const int c = (i - m * chunks) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) v[u][q] = 0.f;
        if (i < MT * chunks && row_of[m] < M && keep[m] && c < k_len)
          load8(xp + (int64_t)row_of[m] * K + k_begin + c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= MT * chunks) break;
        const int m = i / chunks;
        const int c = (i - m * chunks) * 8;
        store8(xs + m * k_per_split + c, v[u]);
      }
    }
  };
  if (x16) stage_x(static_cast<const __nv_bfloat16*>(x));
  else stage_x(static_cast<const float*>(x));
  __syncthreads();

  // Elements past the slice are zeros of x: their Ŵ adds nothing.
  auto compute_step = [&](int buf, int kl0) {
#pragma unroll
    for (int j = 0; j < S::NL; ++j) {
      uint32_t nb[NS][R];   // inverted sign bits, this lane's first at bit 0
#pragma unroll
      for (int t = 0; t < ND; ++t)
#pragma unroll
        for (int r = 0; r < R; ++r) nb[t][r] = ~(bits[buf][t][r][j] >> bit0);
#pragma unroll
      for (int g = 0; g < S::VEC / 4; ++g) {
        const int e = kl0 + j * 32 * S::VEC + lane * S::VEC + 4 * g;
        float cv[NS][4];
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(vcs + t * k_per_split + e);
          cv[t][0] = c4.x; cv[t][1] = c4.y; cv[t][2] = c4.z; cv[t][3] = c4.w;
        }
        float xv[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) x4(xs + m * k_per_split + e, xv[m]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float w[4];
          unpack4(raw[buf][r][j], g, w, TW());
          float wh[NS][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (Q8) w[i] = __fmul_rn(w[i], wscale[r]);
#pragma unroll
            for (int t = 0; t < ND; ++t)
              wh[t][i] = add_signed(w[i], vrow[t][r] + cv[t][i], nb[t][r],
                                    4 * g + i);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float wm = w[i];
#pragma unroll
              for (int t = 0; t < ND; ++t) wm = sel.at(m) == t ? wh[t][i] : wm;
              acc[r][m] = fmaf(xv[m][i], wm, acc[r][m]);
            }
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
}

template <typename TW>
__global__ void __launch_bounds__(kThreads) banked_stream_kernel(
    const void* __restrict__ x, int x16, Bank bk, const TW* __restrict__ wb,
    const __half* __restrict__ ws, float* __restrict__ y, int M, int N,
    int K, int k_per_split) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int R = kRowsPerWarp;
  constexpr int MT = kGroup;
  constexpr int DT = kBankPass;
  extern __shared__ float4 smem4[];
  float* vcs = reinterpret_cast<float*>(smem4);   // DT x k_per_split
  float* xs = vcs + DT * k_per_split;             // MT x k_per_split
  __shared__ int slot_of[kGroup * kMaxGroups];    // each row's slot
  __shared__ int row_d[MT];    // sorted rows' index in dslots; -1: W_b
  __shared__ int row_of[MT];   // the row of x at each sorted position
  __shared__ int dslots[MT];   // distinct non-base slots, in order of use
  __shared__ int keep[MT];     // sorted row's x is staged in this pass
  __shared__ int n_distinct;

  const int groups = (M + kGroup - 1) / kGroup;
  const int group = blockIdx.x % groups;   // neighbours share W_b rows
  if (threadIdx.x < kGroup * groups) {
    int s = 0;   // rows past M: zeros of x, on W_b
    if (threadIdx.x < M) {
      s = bk.vidx[threadIdx.x];
      if (s < 0 || s >= bk.V) __trap();   // never read outside the bank
    }
    slot_of[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // rows in order of slot (stable), W_b's first; this block takes the
    // group-th four of them
    int order[kGroup * kMaxGroups];
    for (int i = 0; i < kGroup * groups; ++i) {
      int at = i;
      for (; at > 0 && slot_of[order[at - 1]] > slot_of[i]; --at)
        order[at] = order[at - 1];
      order[at] = i;
    }
    int nd = 0;
    for (int m = 0; m < MT; ++m) {
      const int row = order[group * kGroup + m];
      const int s = slot_of[row];
      int d = -1;
      if (s != 0) {
        for (int j = 0; j < nd; ++j)
          if (dslots[j] == s) d = j;
        if (d < 0) { dslots[nd] = s; d = nd++; }
      }
      row_of[m] = row;
      row_d[m] = d;
    }
    n_distinct = nd;
  }
  __syncthreads();
  const int nd = n_distinct;
  int dm[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) dm[m] = row_d[m];

  const int k_begin = blockIdx.y * k_per_split;
  const int k_len = min(K - k_begin, k_per_split);
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x / groups * kStreamRows + (threadIdx.x >> 5) * R;
  bool ok[R];
  float wscale[R];
  const TW* wrow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r;
    ok[r] = n < N;
    const int64_t nc = ok[r] ? n : 0;
    wscale[r] = Q8 && ok[r] ? __half2float(ws[nc]) : 1.f;
    wrow[r] = wb + nc * K + k_begin;
  }
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int c0 = 0; c0 == 0 || c0 < nd; c0 += DT) {
    const int np = min(DT, nd - c0);
    if (c0 > 0) __syncthreads();   // the last pass is done with xs, vcs
    int lm[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      lm[m] = dm[m] >= c0 && dm[m] < c0 + np ? dm[m] - c0 : -1;
    if (threadIdx.x < MT) {
      const int d = row_d[threadIdx.x];
      keep[threadIdx.x] = d < 0 ? c0 == 0 : d >= c0 && d < c0 + np;
    }
    __syncthreads();
    const int* slots = dslots + c0;
    switch (pattern_key(lm[0], lm[1], lm[2], lm[3])) {
#define REPRO_CASE(ND, A, B, C, D)                                         \
  case pattern_key(A, B, C, D):                                            \
    stream_pass<ND, TW>(x, x16, bk, slots, keep, row_of,                   \
                        Fixed<A, B, C, D>{}, vcs, xs, ok, wscale, wrow, n0, \
                        M, N, K, k_begin, k_len, k_per_split, acc);         \
    break;
      REPRO_PATTERNS(REPRO_CASE)
#undef REPRO_CASE
      default: __trap();   // rows are sorted: no other map occurs
    }
  }

  float* out = y + (int64_t)blockIdx.y * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == (r * MT + m) % 32 && ok[r] && row_of[m] < M)
        out[(int64_t)row_of[m] * N + n0 + r] = v;
    }
}

// ---------------------------------------------------------------------------
// tile kernel (M > 16)
// ---------------------------------------------------------------------------

template <typename TX, typename TW>
struct BankTileSmem {
  static constexpr int kW = TileSmem<TX, TW>::kW;   // one raw W_b stage
  static constexpr int kX = TileSmem<TX, TW>::kX;   // one raw x stage
  static constexpr int kFixed =
      2 * (kW + kX) + (kBankTiles * kTK * kTN + kTK * kTM) * (int)sizeof(float);
  // plus kBankTiles slots' column scales, k_per_split floats each
  static int bytes(int k_per_split) {
    return kFixed + 4 * kBankTiles * k_per_split;
  }
};

template <typename TX, typename TW>
__global__ void __launch_bounds__(kTileThreads) banked_tile_kernel(
    const TX* __restrict__ x, Bank bk, const TW* __restrict__ wb,
    const __half* __restrict__ ws, float* __restrict__ y, int M, int N,
    int K, int k_per_split) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int T = kBankTiles;
  using RW = RawTile<TW>;
  using RX = RawTile<TX>;
  using L = BankTileSmem<TX, TW>;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  char* rw = base;                      // 2 raw W_b stages
  char* rx = base + 2 * L::kW;          // 2 raw x stages
  float* wt = reinterpret_cast<float*>(rx + 2 * L::kX);   // T x Ŵ [kTK][kTN]
  float* xt = wt + T * kTK * kTN;                         // x [kTK][kTM]
  float* cs = xt + kTK * kTM;                             // T x column scales
  __shared__ int row_s[kTM];    // row's slot; -1 past M
  __shared__ int row_d[kTM];    // row's index in dslots; -1 past M
  __shared__ int dslots[kTM];   // distinct slots (the base included)
  __shared__ uint32_t firsts[kTM / 32];   // rows where a slot first occurs

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = (k_end - k_begin + kTK - 1) / kTK;

  // each row's slot, then its slot's index in order of first occurrence
  int s_row = -1;
  if (tid < kTM && m0 + tid < M) {
    s_row = bk.vidx[m0 + tid];
    if (s_row < 0 || s_row >= bk.V) __trap();   // never read outside the bank
  }
  if (tid < kTM) row_s[tid] = s_row;
  __syncthreads();
  int f = tid;   // the first row with this row's slot
  if (tid < kTM && s_row >= 0)
    for (int r = 0; r < tid; ++r)
      if (row_s[r] == s_row) { f = r; break; }
  const uint32_t ball = __ballot_sync(0xffffffffu,
                                      tid < kTM && s_row >= 0 && f == tid);
  if (tid < kTM && (tid & 31) == 0) firsts[tid >> 5] = ball;
  __syncthreads();
  int nd = 0, d = -1;
#pragma unroll
  for (int w = 0; w < kTM / 32; ++w) {
    if (s_row >= 0 && f >> 5 == w)
      d = nd + __popc(firsts[w] & ((1u << (f & 31)) - 1u));
    nd += __popc(firsts[w]);
  }
  if (tid < kTM) {
    row_d[tid] = d;
    if (s_row >= 0 && f == tid) dslots[d] = s_row;
  }
  __syncthreads();

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

  // Ŵ build role: row tid of each tile, the step's 32 elements
  const int gn = n0 + tid;
  const bool n_ok = gn < N;
  const float wscale = Q8 && n_ok ? __half2float(ws[gn]) : 1.f;
  // x transpose role: row xm of the tile, elements 16*xq .. 16*xq + 15
  const int xm = tid % kTM;
  const int xq = tid / kTM;
  // compute role: rows ty*8 + i, columns tx*4 + c and 64 + tx*4 + c
  const int tx = tid % 16;
  const int ty = tid / 16;
  int rd[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rd[i] = row_d[ty * 8 + i];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < nd; c0 += T) {
    const int np = min(T, nd - c0);
    if (c0 > 0) __syncthreads();   // the last pass is done with the tiles
    int st[T];            // the pass's slots; 0 (the base) past np
    float vrow[T];
    const uint8_t* prow[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      st[t] = t < np ? dslots[c0 + t] : 0;
      vrow[t] = st[t] && n_ok ? vget(bk.vr, (int64_t)st[t] * N + gn, bk.v16)
                              : 0.f;
      prow[t] = bk.packed + ((int64_t)st[t] * N + (n_ok ? gn : 0)) * (K / 8);
    }
    // the next step's four sign bytes per slot, kept as loaded
    uint32_t bytes_next[T][4];
    auto fetch = [&](int s) {
      const int k0 = k_begin + s * kTK;
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          bytes_next[t][b] = st[t] && n_ok && k0 + 8 * b < k_end
                                 ? prow[t][(k0 >> 3) + b] : 0u;
    };
    // each row's tile in this pass (-1: its slot is in another pass), and
    // the tiles the thread's rows read
    int tix[8];
    bool uniform = true;
    uint32_t tmask = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tix[i] = rd[i] >= c0 && rd[i] < c0 + np ? rd[i] - c0 : -1;
      uniform = uniform && tix[i] == tix[0];
      if (tix[i] >= 0) tmask |= 1u << tix[i];
    }

    issue(0);
    fetch(0);
    for (int t = 0; t < np; ++t)   // the base's scales are zero
      stage_cols(cs + t * k_per_split, bk, (int64_t)st[t] * K + k_begin,
                 st[t] ? k_end - k_begin : 0, steps * kTK, kTileThreads);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait_all();
      __syncthreads();   // stage s & 1 landed; the last step's tiles are free
      if (s + 1 < steps) issue(s + 1);
      uint32_t nbits[T];   // inverted sign bits of the step
#pragma unroll
      for (int t = 0; t < T; ++t)
        nbits[t] = ~(bytes_next[t][0] | bytes_next[t][1] << 8 |
                     bytes_next[t][2] << 16 | bytes_next[t][3] << 24);
      if (s + 1 < steps) fetch(s + 1);
      {
        const TW* src = reinterpret_cast<const TW*>(
            rw + (s & 1) * L::kW + tid * RW::kPitch);
#pragma unroll
        for (int h = 0; h < kTK / 8; ++h) {
          float w[8];
          load8(src + 8 * h, w);
          if constexpr (Q8) dequant8(w, wscale);   // once, for every slot
#pragma unroll
          for (int t = 0; t < T; ++t) {
            if (t >= np) break;
            float* tile = wt + t * kTK * kTN;
            if (st[t] == 0) {   // the base: W_b itself
#pragma unroll
              for (int j = 0; j < 8; ++j) tile[(8 * h + j) * kTN + tid] = w[j];
              continue;
            }
            const float* col = cs + t * k_per_split + s * kTK + 8 * h;
            const float4 c0v = *reinterpret_cast<const float4*>(col);
            const float4 c1v = *reinterpret_cast<const float4*>(col + 4);
            const float cv[8] = {c0v.x, c0v.y, c0v.z, c0v.w,
                                 c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
              tile[(8 * h + j) * kTN + tid] =
                  add_signed(w[j], vrow[t] + cv[j], nbits[t], 8 * h + j);
          }
        }
        const TX* xsrc = reinterpret_cast<const TX*>(
            rx + (s & 1) * L::kX + xm * RX::kPitch) + 16 * xq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float xv[8];
          load8(xsrc + 8 * h, xv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xt[(16 * xq + 8 * h + j) * kTM + xm] = xv[j];
        }
      }
      __syncthreads();
      if (uniform) {
        if (tix[0] >= 0) {
          const float* tile = wt + tix[0] * kTK * kTN;
#pragma unroll 4
          for (int k = 0; k < kTK; ++k) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8);
            const float4 a1 =
                *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8 + 4);
            const float4 b0 =
                *reinterpret_cast<const float4*>(tile + k * kTN + tx * 4);
            const float4 b1 =
                *reinterpret_cast<const float4*>(tile + k * kTN + 64 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      } else {   // the rows span slots: a product per tile, other rows' x 0
#pragma unroll 1
        for (int t = 0; t < T; ++t) {
          if (!(tmask >> t & 1u)) continue;
          const float* tile = wt + t * kTK * kTN;
#pragma unroll 4
          for (int k = 0; k < kTK; ++k) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8);
            const float4 a1 =
                *reinterpret_cast<const float4*>(xt + k * kTM + ty * 8 + 4);
            const float4 b0 =
                *reinterpret_cast<const float4*>(tile + k * kTN + tx * 4);
            const float4 b1 =
                *reinterpret_cast<const float4*>(tile + k * kTN + 64 + tx * 4);
            const float ax[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = tix[i] == t ? ax[i] : 0.f;   // adds exact 0
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(a, bv[j], acc[i][j]);
            }
          }
        }
      }
    }
  }

  float* out = y + (int64_t)blockIdx.z * M * N;
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

struct BankArgs {
  const void* x;
  int x16;             // x is bf16
  Bank bank;
  const void* wb;
  const void* ws;      // int8 base: (N,) fp16 row scales; else nullptr
  float* y;
  float* workspace;
  int M, N, K, splits, k_per_split;
  cudaStream_t stream;
};

template <typename TW>
cudaError_t launch_bank_stream(const BankArgs& a) {
  const size_t smem = (size_t)a.k_per_split * (kBankPass + kGroup) * 4;
  if (a.k_per_split % Stream<TW>::SPAN || smem > (size_t)kBankStreamSmem)
    return cudaErrorInvalidValue;
  auto kern = banked_stream_kernel<TW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBankStreamSmem);
  if (attr != cudaSuccess) return attr;
  const int groups = (a.M + kGroup - 1) / kGroup;
  const dim3 grid((a.N + kStreamRows - 1) / kStreamRows * groups, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  kern<<<grid, kThreads, smem, a.stream>>>(
      a.x, a.x16, a.bank, static_cast<const TW*>(a.wb),
      static_cast<const __half*>(a.ws), dst, a.M, a.N, a.K, a.k_per_split);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_bank_tiles(const BankArgs& a) {
  if (a.k_per_split % kTK || a.k_per_split > kBankTileMaxK)
    return cudaErrorInvalidValue;
  using L = BankTileSmem<TX, TW>;
  auto kern = banked_tile_kernel<TX, TW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(kBankTileMaxK));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + kTN - 1) / kTN, (a.M + kTM - 1) / kTM, a.splits);
  float* dst = a.splits > 1 ? a.workspace : a.y;
  kern<<<grid, kTileThreads, L::bytes(a.k_per_split), a.stream>>>(
      static_cast<const TX*>(a.x), a.bank, static_cast<const TW*>(a.wb),
      static_cast<const __half*>(a.ws), dst, a.M, a.N, a.K, a.k_per_split);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_bank_m(const BankArgs& a) {
  if (a.M <= kGroup * kMaxGroups) return launch_bank_stream<TW>(a);
  return launch_bank_tiles<TX, TW>(a);
}

template <typename TX>
cudaError_t launch_bank_w(const BankArgs& a, int wb_dtype) {
  if (wb_dtype == DT_F32) return launch_bank_m<TX, float>(a);
  if (wb_dtype == DT_BF16) return launch_bank_m<TX, __nv_bfloat16>(a);
  if (wb_dtype == DT_I8) return launch_bank_m<TX, int8_t>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) fp32|bf16; vidx (M,) int32 in [0, V); packed (V, N, K/8) u8;
// vr (V, N), vc (V, K) fp16|fp32 with slot 0 all zero; wb (N, K)
// fp32|bf16|int8; ws (N,) fp16 with an int8 wb, else nullptr; y (M, N) fp32.
// With splits > 1, workspace holds (splits, M, N) fp32 partials.  splits
// and k_per_split follow kernels/bitlinear.gemm_plan(banked=True): a
// multiple of the stream step for M <= 16 (the slots' column scales and the
// x slice, as fp32, fit 192 KB of shared memory), of 32 and at most 2048 above; a
// launch off the plan fails with cudaErrorInvalidValue.  All contiguous; x
// 16-byte aligned, wb 16-byte aligned (8-byte for int8); K a multiple of 8.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes_banked(
    const void* x, int x_dtype, const void* vidx, const void* packed,
    const void* vr, const void* vc, int v_dtype, const void* wb, int wb_dtype,
    const void* ws, void* y, void* workspace, int M, int N, int K, int V,
    int splits, int k_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  if ((wb_dtype == DT_I8) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  if (v_dtype != DT_F16 && v_dtype != DT_F32) return (int)cudaErrorInvalidValue;
  BankArgs a{x, x_dtype == DT_BF16,
             Bank{static_cast<const int*>(vidx),
                  static_cast<const uint8_t*>(packed), vr, vc,
                  v_dtype == DT_F16, V},
             wb, ws, static_cast<float*>(y), static_cast<float*>(workspace),
             M, N, K, splits, k_per_split, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (x_dtype == DT_F32) err = launch_bank_w<float>(a, wb_dtype);
  else if (x_dtype == DT_BF16) err = launch_bank_w<__nv_bfloat16>(a, wb_dtype);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_splitk_reduce(a.workspace, a.y, (int64_t)M * N, splits,
                                   a.stream);
}
