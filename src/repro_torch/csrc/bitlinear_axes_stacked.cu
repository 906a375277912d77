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
// Bound on an H100.  At decode an expert receives one row (capacity 1 at
// batch 4 for deepseek-moe-16b), so bytes bound it: W_b (4 B or 1 B a
// weight) and 1/8 B of signs, read once, of the experts that some token
// routes to; the others need no byte.  At a prefill's capacity (120 rows)
// the fp32 operations do: 2*M flops a weight on the CUDA cores (Ŵ is fp32,
// so never TF32 or bf16 tensor cores).
//
// Design.
//   * Skip.  An expert no token routes to has all-zero rows of x (the MoE
//     layer zeroes its capacity fillers).  A block whose slice of x (its
//     rows x its K split) is all zeros writes zeros (its split's partials
//     with split-K) and loads no W_b, sign or scale: exact for finite Ŵ,
//     since a sum of +-0 products started from 0.f is +0.f; -0 counts as
//     zero, NaN does not.  The streaming body votes on the x slice it has
//     staged (__syncthreads_or) before its first weight load; the tiled
//     body reads a per-(expert, M tile, split) flag that a pre-pass over x
//     (live_kernel, which reads x once) sets, so no tile block reads its x
//     slice twice.
//   * stacked_stream_kernel, M <= 16 (decode): delta_gemm.cuh's streaming
//     design (a warp streams its W_b rows along K with coalesced 16-byte
//     loads, 8-byte for int8, two steps in flight, and forms Ŵ in
//     registers) with row tiers of 1, 2, 4, 8 and 16 rows of x, so a
//     decode row does one FMA a weight, not four.  Two W_b rows a warp (one
//     at 16 rows) keep it within 80 registers at 1-2 rows of x (three
//     blocks an SM; int8 64 and four) and 128 above (two).  A block stages its x slice and
//     column scales once, votes once and then streams four tiles of eight
//     warps' rows (64 rows, 32 at 16), so staging and a dead block's cost
//     are paid once per 64 rows while the SM's other blocks stream.  An
//     int8 weight widens by one byte permute and one subtraction (exact;
//     I2F runs at a quarter of the FP32 rate).
//   * stacked_tile_kernel, M > 16 (prefill): a 128 x 128 output tile above
//     64 rows of x, so a prefill's 120 rows build each Ŵ element once a
//     launch (64 x 256 at 17-64 rows, which pads less); 256 threads, an
//     8 x 8 microtile (float4 reads, conflict-free), K steps of 16.
//     Each thread cp.async-copies the 8 W_b and 8 x elements it will build
//     itself, so no barrier stands between copy and build: two raw stages,
//     the copies of step s + 2 in flight during the products of step s
//     (three copies a thread a step against 1024 FMAs, so TMA would save
//     nothing that shows).  Ŵ and x are built as fp32, k-major, into two
//     buffers: one barrier a step separates a step's build from its
//     products while other warps multiply.  64-90 KB of shared memory and
//     128 registers, so two blocks share an SM.
//   * Split-K partials go to a (splits, E, M, N) workspace and common.cuh's
//     second pass sums them in a fixed order.
#include "delta_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// streaming body (M <= 16)
// ---------------------------------------------------------------------------

// kernels/bitlinear.STACK_STREAM_SMEM: a block's x slice and column scales
constexpr int kStackSmem = 96 * 1024;

// By x-row tier: W_b rows a warp streams, and the resident blocks an SM
// the launch bounds ask for (kernels/bitlinear.STACK_BLOCKS_PER_SM; over
// an int8 base at one or two rows of x, STACK_Q8_BLOCKS_PER_SM).  A block
// streams kTiles tiles of eight warps' rows (kernels/bitlinear.STACK_ROWS
// counts those tiles).  Each choice was measured against its neighbours on
// an H100 with tools/stacked_gemm_bench.py (PERF.md).
template <int MT, typename TW = float> struct StackTier {
  static constexpr int R = MT <= 8 ? 2 : 1;
  static constexpr int kBlocks =
      MT > 2 ? 2 : std::is_same<TW, int8_t>::value ? 4 : 3;
  static constexpr int kTiles = 4;
};

// The magnitude bits of a 16-byte chunk of x: zero iff every element is +-0.
template <typename TX>
__device__ __forceinline__ uint32_t nonzero(const uint4& v) {
  constexpr uint32_t mask = sizeof(TX) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  return (v.x | v.y | v.z | v.w) & mask;
}

// Elements 4g..4g+3 of eight int8 weights, widened to fp32 exactly: each
// byte, offset by 128, becomes the low byte of 2^23's mantissa (one byte
// permute) and one subtraction of 2^23 + 128 leaves the integer.
__device__ __forceinline__ void get4q(const uint2& r, int g, float o[4]) {
  const uint32_t t = (g ? r.y : r.x) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7540u | i)) -
           8388736.f;
}
__device__ __forceinline__ void get4w(const uint4& r, int g, float o[4],
                                      float) { get4(r, g, o, float()); }
__device__ __forceinline__ void get4w(const uint4& r, int g, float o[4],
                                      __nv_bfloat16) {
  get4(r, g, o, __nv_bfloat16());
}
__device__ __forceinline__ void get4w(const uint2& r, int g, float o[4],
                                      int8_t) { get4q(r, g, o); }

// Grid (row blocks, splits, experts): a block streams kTiles tiles of
// 8 * R rows.  Split s of expert e writes matrix s * E + e of y (or of the
// split-K workspace).
template <int MT, typename TX, typename TW, typename TV>
__global__ void __launch_bounds__(kThreads, StackTier<MT, TW>::kBlocks)
stacked_stream_kernel(const TX* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const TV* __restrict__ vr, const TV* __restrict__ vc,
                      const TW* __restrict__ wb, const __half* __restrict__ ws,
                      float* __restrict__ y, int E, int M, int N, int K,
                      int k_per_split) {
  using S = Stream<TW>;
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  constexpr int R = StackTier<MT>::R;
  constexpr int kRows = (kThreads / 32) * R;
  constexpr int kTiles = StackTier<MT>::kTiles;
  constexpr int XV = 16 / sizeof(TX);   // x elements per 16-byte chunk
  const int e = blockIdx.z;
  x += (int64_t)e * M * K;
  packed += (int64_t)e * N * (K / 8);
  wb += (int64_t)e * N * K;
  if constexpr (Q8) ws += (int64_t)e * N;
  const AxesScale<TV> sc{vr + (int64_t)e * N, vc + (int64_t)e * K};
  float* out = y + ((int64_t)blockIdx.y * E + e) * M * N;

  extern __shared__ float4 smem4[];
  float* vcs = reinterpret_cast<float*>(smem4);         // column scale slice
  TX* xs = reinterpret_cast<TX*>(vcs + k_per_split);    // MT x k_per_split

  const int k_begin = blockIdx.y * k_per_split;
  const int k_len = min(K - k_begin, k_per_split);
  const int chunks = k_per_split / XV;
  uint32_t live = 0;
  for (int i = threadIdx.x; i < MT * chunks; i += kThreads) {
    const int m = i / chunks;
    const int c = (i - m * chunks) * XV;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M && c < k_len) {   // k_len is a multiple of 8: whole chunks
      v = *reinterpret_cast<const uint4*>(x + (int64_t)m * K + k_begin + c);
      live |= nonzero<TX>(v);
    }
    *reinterpret_cast<uint4*>(xs + m * k_per_split + c) = v;
  }
  // The vote is the barrier that publishes the staged slice.  A block with
  // no routed row writes its zeros before any weight load.
  const int row0 = blockIdx.x * kTiles * kRows;
  if (!__syncthreads_or(live)) {
    for (int i = threadIdx.x; i < kTiles * kRows * M; i += kThreads) {
      const int n = row0 + i % (kTiles * kRows);
      if (n < N) out[(int64_t)(i / (kTiles * kRows)) * N + n] = 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < k_per_split; i += kThreads)
    vcs[i] = i < k_len ? sc.col(k_begin + i) : 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int bit0 = S::VEC == 4 ? 4 * (lane & 1) : 0;
  for (int t = 0; t < kTiles && row0 + t * kRows < N; ++t) {
    const int n0 = row0 + t * kRows + (threadIdx.x >> 5) * R;
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
    // two steps' W_b vectors and sign bytes per row, in registers (as in
    // delta_gemm.cuh's stream_gemm_kernel)
    typename S::Raw raw[2][R][S::NL];
    uint32_t bits[2][R][S::NL];
    auto load_step = [&](int buf, int kl0) {
#pragma unroll
      for (int j = 0; j < S::NL; ++j) {
        const int el = kl0 + j * 32 * S::VEC + lane * S::VEC;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (ok[r] && el < k_len) {
            ld_stream(wrow[r] + el, raw[buf][r][j]);
            bits[buf][r][j] = prow[r][(k_begin + el) >> 3];
          } else {
            zero(raw[buf][r][j]);
            bits[buf][r][j] = 0;
          }
        }
      }
    };
    load_step(0, 0);

    float acc[R][MT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

    // Elements past the slice are zeros of x: their Ŵ adds nothing.
    auto compute_step = [&](int buf, int kl0) {
#pragma unroll
      for (int j = 0; j < S::NL; ++j) {
#pragma unroll
        for (int g = 0; g < S::VEC / 4; ++g) {
          const int el = kl0 + j * 32 * S::VEC + lane * S::VEC + 4 * g;
          const float4 c4 = *reinterpret_cast<const float4*>(vcs + el);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          float xv[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) x4(xs + m * k_per_split + el, xv[m]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float w[4];
            get4w(raw[buf][r][j], g, w, TW());
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
}

// ---------------------------------------------------------------------------
// tiled body (M > 16)
// ---------------------------------------------------------------------------

// kernels/bitlinear.stack_tile_m, TILE_MAX_K.  K steps of 16 keep a block
// within 64-90 KB of shared memory (two an SM; steps of 32 ran 15% slower
// at one an SM).  A split is a multiple of 32.
constexpr int kSTK = 16;
constexpr int kSTThreads = 256;
constexpr int kSTBlocks = 2;

// A tile of TM rows of x by 16384 / TM rows of W_b, 64 outputs a thread
// (an 8 x 8 microtile) either way.  TM is 128 above 64 rows of x, so a
// prefill's capacity of 120 builds each Ŵ element once; 64 at 17-64 rows,
// where a 128-row tile multiplies mostly padding (17 rows: 1.17 ms a stack
// against 0.80 at 64 rows on an H100).
template <int TM>
struct StackTile {
  static constexpr int kN = 16384 / TM;                  // 128 or 256
  static constexpr int kWPer = kN * kSTK / kSTThreads;   // W_b elements a thread
  static constexpr int kXPer = TM * kSTK / kSTThreads;   // x elements a thread
  static constexpr int kTX = kSTThreads / (TM / 8);      // threads along N
};

// A raw tile row of kSTK elements: its pitch an odd number of 16-byte
// units, so the build pass's 16-byte reads, one row a lane, are free of
// bank conflicts.
template <typename T>
struct StackRaw {
  static constexpr int kRowBytes = kSTK * sizeof(T);
  static constexpr int kUnits = kRowBytes / 16 + 1;
  static constexpr int kPitch = 16 * (kUnits % 2 ? kUnits : kUnits + 1);
  static constexpr int kChunk = sizeof(T) == 1 ? 8 : 16;   // cp.async size
};

template <typename TX, typename TW, int TM>
struct StackTileSmem {
  static constexpr int kN = StackTile<TM>::kN;
  static constexpr int kW = kN * StackRaw<TW>::kPitch;    // one raw W_b stage
  static constexpr int kX = TM * StackRaw<TX>::kPitch;    // one raw x stage
  static constexpr int kBuilt = kSTK * (kN + TM);         // Ŵ + x, fp32 floats
  static constexpr int kFixed = 2 * (kW + kX) + 2 * kBuilt * (int)sizeof(float);
  // plus the split's column scales, k_per_split floats
  static int bytes(int k_per_split) { return kFixed + 4 * k_per_split; }
};

// live[(e * M tiles + M tile) * splits + split] = 1 where that block's x
// slice holds a non-zero; the caller zeroes live first.  Grid (items,
// TM / 8): block y scans rows 8y .. 8y + 7 of its M tile.
template <typename TX, int TM>
__global__ void __launch_bounds__(256) live_kernel(
    const TX* __restrict__ x, int* __restrict__ live, int M, int K,
    int k_per_split, int splits) {
  constexpr int XV = 16 / sizeof(TX);
  const int item = blockIdx.x;
  const int split = item % splits;
  const int mtiles = (M + TM - 1) / TM;
  const int mt = (item / splits) % mtiles;
  const int e = item / splits / mtiles;
  const int k0 = split * k_per_split;
  const int per_row = (min(K, k0 + k_per_split) - k0) / XV;
  uint32_t any = 0;
  for (int r = 8 * blockIdx.y; r < 8 * blockIdx.y + 8; ++r) {
    const int m = mt * TM + r;
    if (m >= M) break;
    const uint4* p =
        reinterpret_cast<const uint4*>(x + ((int64_t)e * M + m) * K + k0);
    for (int i = threadIdx.x; i < per_row; i += 256) any |= nonzero<TX>(p[i]);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) live[item] = 1;
}

// Grid (N tiles, M tiles, E * splits): expert z / splits, split z % splits.
template <typename TX, typename TW, typename TV, int TM>
__global__ void __launch_bounds__(kSTThreads, kSTBlocks) stacked_tile_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed,
    const TV* __restrict__ vr, const TV* __restrict__ vc,
    const TW* __restrict__ wb, const __half* __restrict__ ws,
    const int* __restrict__ live, float* __restrict__ y, int E, int M, int N,
    int K, int k_per_split, int splits) {
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  using T = StackTile<TM>;
  constexpr int kN = T::kN;
  using RW = StackRaw<TW>;
  using RX = StackRaw<TX>;
  using L = StackTileSmem<TX, TW, TM>;
  const int e = blockIdx.z / splits;
  const int split = blockIdx.z - e * splits;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kN;
  const int m0 = blockIdx.y * TM;
  float* out = y + ((int64_t)split * E + e) * M * N;
  if (!live[((int64_t)e * gridDim.y + blockIdx.y) * splits + split]) {
    for (int i = tid; i < TM * kN; i += kSTThreads) {
      const int gm = m0 + i / kN;
      const int gn = n0 + i % kN;
      if (gm < M && gn < N) out[(int64_t)gm * N + gn] = 0.f;
    }
    return;
  }
  x += (int64_t)e * M * K;
  packed += (int64_t)e * N * (K / 8);
  wb += (int64_t)e * N * K;
  if constexpr (Q8) ws += (int64_t)e * N;
  const AxesScale<TV> sc{vr + (int64_t)e * N, vc + (int64_t)e * K};

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  char* rw = base;                       // 2 raw W_b stages
  char* rx = base + 2 * L::kW;           // 2 raw x stages
  float* built = reinterpret_cast<float*>(rx + 2 * L::kX);  // 2 x (Ŵ, x)
  float* cs = built + 2 * L::kBuilt;     // the split's column scales

  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = (k_end - k_begin + kSTK - 1) / kSTK;

  // copy and build roles: row `row` of the W_b tile, its elements
  // kWPer * h .. kWPer * (h + 1) - 1 of each K step; row `xrow` of the x
  // tile, its elements kXPer * xh .. kXPer * (xh + 1) - 1
  const int row = tid % kN;
  const int h = tid / kN;
  const int xrow = tid % TM;
  const int xh = tid / TM;
  const int gn = n0 + row;
  const bool n_ok = gn < N;
  const bool m_ok = m0 + xrow < M;
  const TW* wsrc = wb + (int64_t)(n_ok ? gn : 0) * K;
  const TX* xsrc = x + (int64_t)(m_ok ? m0 + xrow : 0) * K;
  const uint8_t* prow = packed + (int64_t)(n_ok ? gn : 0) * (K / 8);
  const float vrow = n_ok ? sc.row(gn) : 0.f;
  const float wscale = Q8 && n_ok ? __half2float(ws[gn]) : 1.f;

  auto issue = [&](int s) {   // this thread's chunks of step s, stage s & 1
    const int k0 = k_begin + s * kSTK + T::kWPer * h;
    constexpr int WE = RW::kChunk / (int)sizeof(TW);   // elements a chunk
    char* dw = rw + (s & 1) * L::kW + row * RW::kPitch +
               T::kWPer * h * sizeof(TW);
#pragma unroll
    for (int c = 0; c < T::kWPer / WE; ++c) {
      const bool ok = n_ok && k0 + c * WE < k_end;
      cp_async(dw + c * RW::kChunk, ok ? wsrc + k0 + c * WE : wb, ok,
               RW::kChunk);
    }
    const int kx = k_begin + s * kSTK + T::kXPer * xh;
    constexpr int XB = T::kXPer * (int)sizeof(TX) < 16
                           ? T::kXPer * (int)sizeof(TX) : 16;   // 8 or 16
    constexpr int XE = XB / (int)sizeof(TX);
    char* dx = rx + (s & 1) * L::kX + xrow * RX::kPitch +
               T::kXPer * xh * sizeof(TX);
#pragma unroll
    for (int c = 0; c < T::kXPer / XE; ++c) {
      const bool ok = m_ok && kx + c * XE < k_end;
      cp_async(dx + c * XB, ok ? xsrc + kx + c * XE : x, ok, XB);
    }
    cp_async_commit();
  };
  auto fetch = [&](int s) {   // the step's sign bytes, as loaded
    const int k0 = k_begin + s * kSTK + T::kWPer * h;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < T::kWPer / 8; ++b)
      if (n_ok && k0 + 8 * b < k_end) bits |= (uint32_t)prow[(k0 >> 3) + b]
                                                << (8 * b);
    return bits;
  };
  // Ŵ and x of step s, fp32, k-major, into built buffer s & 1
  auto build = [&](int s, uint32_t bits) {
    float* wt = built + (s & 1) * L::kBuilt;   // [kSTK][kN]
    float* xt = wt + kSTK * kN;               // [kSTK][TM]
    const TW* src = reinterpret_cast<const TW*>(
        rw + (s & 1) * L::kW + row * RW::kPitch) + T::kWPer * h;
    const float* col = cs + s * kSTK + T::kWPer * h;
#pragma unroll
    for (int hh = 0; hh < T::kWPer / 8; ++hh) {
      float w[8];
      load8(src + 8 * hh, w);
      const float4 c0 = *reinterpret_cast<const float4*>(col + 8 * hh);
      const float4 c1 = *reinterpret_cast<const float4*>(col + 8 * hh + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (Q8) w[j] = __fmul_rn(w[j], wscale);
        w[j] = apply_sign(w[j], vrow + cv[j], (bits >> (8 * hh + j)) & 1u);
        wt[(T::kWPer * h + 8 * hh + j) * kN + row] = w[j];
      }
    }
    const TX* xr = reinterpret_cast<const TX*>(
        rx + (s & 1) * L::kX + xrow * RX::kPitch) + T::kXPer * xh;
#pragma unroll
    for (int q = 0; q < T::kXPer / 4; ++q) {
      float xv[4];
      x4(xr + 4 * q, xv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xt[(T::kXPer * xh + 4 * q + j) * TM + xrow] = xv[j];
    }
  };

  // compute role: rows ra0 + i and ra1 + i, columns cb0 + j and cb1 + j
  // (i, j < 4) of the tile
  const int ra0 = (tid / T::kTX) * 8, ra1 = ra0 + 4;
  const int cb0 = (tid % T::kTX) * 4, cb1 = cb0 + kN / 2;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  issue(0);
  uint32_t bits_next = fetch(0);
  for (int i = tid; i < steps * kSTK; i += kSTThreads)
    cs[i] = k_begin + i < k_end ? sc.col(k_begin + i) : 0.f;
  cp_async_wait_all();
  __syncthreads();   // the column scales
  build(0, bits_next);
  if (steps > 1) {
    issue(1);
    bits_next = fetch(1);
  }
  __syncthreads();   // step 0's tiles
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      cp_async_wait_all();   // this thread's chunks of step s + 1
      build(s + 1, bits_next);
      if (s + 2 < steps) {
        issue(s + 2);
        bits_next = fetch(s + 2);
      }
    }
    const float* wt = built + (s & 1) * L::kBuilt;
    const float* xt = wt + kSTK * kN;
#pragma unroll
    for (int k = 0; k < kSTK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + k * TM + ra0);
      const float4 a1 = *reinterpret_cast<const float4*>(xt + k * TM + ra1);
      const float4 b0 = *reinterpret_cast<const float4*>(wt + k * kN + cb0);
      const float4 b1 = *reinterpret_cast<const float4*>(wt + k * kN + cb1);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();   // step s + 1's tiles built; buffer s & 1 free
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ra0 + i : ra1 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = n0 + (j < 4 ? cb0 + j : cb1 + j - 4);
      if (gc < N) out[(int64_t)gm * N + gc] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct StackArgs {
  const void *x, *packed, *vr, *vc, *wb, *ws;
  float *y, *workspace;
  int* live;
  int E, M, N, K, splits, k_per_split;
  cudaStream_t stream;
};

template <int MT, typename TX, typename TW, typename TV>
cudaError_t launch_stack_stream(const StackArgs& a) {
  using S = Stream<TW>;
  const size_t smem = (size_t)a.k_per_split * (sizeof(float) + MT * sizeof(TX));
  if (a.k_per_split % S::SPAN || smem > (size_t)kStackSmem)
    return cudaErrorInvalidValue;
  auto kern = stacked_stream_kernel<MT, TX, TW, TV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int rows = (kThreads / 32) * StackTier<MT>::R *
                       StackTier<MT>::kTiles;
  const dim3 grid((a.N + rows - 1) / rows, a.splits, a.E);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const TV*>(a.vr), static_cast<const TV*>(a.vc),
      static_cast<const TW*>(a.wb), static_cast<const __half*>(a.ws),
      a.splits > 1 ? a.workspace : a.y, a.E, a.M, a.N, a.K, a.k_per_split);
  return cudaGetLastError();
}

template <typename TX, typename TW, typename TV, int TM>
cudaError_t launch_stack_tiles(const StackArgs& a) {
  if (a.k_per_split % kSTK || a.k_per_split > kTileMaxK || a.live == nullptr)
    return cudaErrorInvalidValue;
  constexpr int kN = StackTile<TM>::kN;
  const int mtiles = (a.M + TM - 1) / TM;
  const int items = a.E * mtiles * a.splits;
  cudaError_t err =
      cudaMemsetAsync(a.live, 0, sizeof(int) * (size_t)items, a.stream);
  if (err != cudaSuccess) return err;
  live_kernel<TX, TM><<<dim3(items, TM / 8), 256, 0, a.stream>>>(
      static_cast<const TX*>(a.x), a.live, a.M, a.K, a.k_per_split, a.splits);
  auto kern = stacked_tile_kernel<TX, TW, TV, TM>;
  const int bytes = StackTileSmem<TX, TW, TM>::bytes(a.k_per_split);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kN - 1) / kN, mtiles, a.E * a.splits);
  kern<<<grid, kSTThreads, bytes, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const TV*>(a.vr), static_cast<const TV*>(a.vc),
      static_cast<const TW*>(a.wb), static_cast<const __half*>(a.ws), a.live,
      a.splits > 1 ? a.workspace : a.y, a.E, a.M, a.N, a.K, a.k_per_split,
      a.splits);
  return cudaGetLastError();
}

// kernels/bitlinear.stack_tier: the x rows a streaming block computes
template <typename TX, typename TW, typename TV>
cudaError_t launch_stack_m(const StackArgs& a) {
  if (a.M <= 1) return launch_stack_stream<1, TX, TW, TV>(a);
  if (a.M <= 2) return launch_stack_stream<2, TX, TW, TV>(a);
  if (a.M <= 4) return launch_stack_stream<4, TX, TW, TV>(a);
  if (a.M <= 8) return launch_stack_stream<8, TX, TW, TV>(a);
  if (a.M <= 16) return launch_stack_stream<16, TX, TW, TV>(a);
  if (a.M <= 64) return launch_stack_tiles<TX, TW, TV, 64>(a);
  return launch_stack_tiles<TX, TW, TV, 128>(a);
}

template <typename TX, typename TV>
cudaError_t launch_stack_w(const StackArgs& a, int wb_dtype) {
  if (wb_dtype == DT_F32) return launch_stack_m<TX, float, TV>(a);
  if (wb_dtype == DT_BF16) return launch_stack_m<TX, __nv_bfloat16, TV>(a);
  if (wb_dtype == DT_I8) return launch_stack_m<TX, int8_t, TV>(a);
  return cudaErrorInvalidValue;
}

template <typename TV>
cudaError_t launch_stack_x(const StackArgs& a, int x_dtype, int wb_dtype) {
  if (x_dtype == DT_F32) return launch_stack_w<float, TV>(a, wb_dtype);
  if (x_dtype == DT_BF16) return launch_stack_w<__nv_bfloat16, TV>(a, wb_dtype);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (E, M, K) fp32|bf16; packed (E, N, K/8) u8; vr (E, N), vc (E, K)
// fp16|fp32; wb (E, N, K) fp32|bf16|int8; ws (E, N) fp16 with an int8 wb,
// else nullptr; y (E, M, N) fp32.  With splits > 1, workspace holds
// (splits, E, M, N) fp32 partials.  For M > 16, live holds E * ceil(M /
// TM) * splits ints of scratch (the pre-pass's flags; TM 64 up to 64 rows
// of x, else 128); else it may be nullptr.  splits and k_per_split follow kernels/bitlinear.stacked_plan;
// a launch off the plan fails with cudaErrorInvalidValue.  All
// contiguous; x 16-byte aligned, wb 16-byte aligned (8-byte for int8); K a
// multiple of 8.  Returns cudaGetLastError() after the launches.
extern "C" int repro_bitlinear_axes_stacked(
    const void* x, int x_dtype, const void* packed, const void* vr,
    const void* vc, int v_dtype, const void* wb, int wb_dtype,
    const void* ws, void* y, void* workspace, void* live, int E, int M, int N,
    int K, int splits, int k_per_split, void* stream) {
  if (M == 0 || N == 0 || E == 0) return 0;
  if ((wb_dtype == DT_I8) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  const StackArgs a{x, packed, vr, vc, wb, ws, static_cast<float*>(y),
                    static_cast<float*>(workspace), static_cast<int*>(live),
                    E, M, N, K, splits, k_per_split,
                    static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (v_dtype == DT_F16) err = launch_stack_x<__half>(a, x_dtype, wb_dtype);
  else if (v_dtype == DT_F32) err = launch_stack_x<float>(a, x_dtype, wb_dtype);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_splitk_reduce(static_cast<float*>(workspace),
                                   static_cast<float*>(y),
                                   (int64_t)E * M * N, splits, a.stream);
}
