// Forward flash attention with grouped KV heads
//   o = softmax((q . k^T) * hd^-1/2 + mask) v,   fp32 scores, softmax and sums.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_attention_fwd_p — its
// `_kernel` body.  Layout as there: q (BH, S, hd), k and v (BH / group, T, hd),
// query head b reading KV head b / group; o (BH, S, hd) in q's dtype.
//
// Semantics kept from the TPU kernel, by both kernels below:
//   * the causal mask is by absolute position, q_offset + i >= kv_offset + j,
//     and a masked score is the finite -1e30, not -inf: a row that sees no
//     key at all (q_offset + i < kv_offset) gets weight exp(0) = 1 on every
//     key, so its output is the mean of v over all T, as in the TPU kernel;
//     a key past T gets -inf (weight 0);
//   * online softmax with fp32 m, l and accumulator; o = acc / max(l, 1e-30);
//   * under the causal mask the key tiles wholly above the diagonal are
//     skipped (they add exactly 0 to every row that sees a key), except in a
//     query tile whose first row sees no key, which keeps every tile;
//   * ragged S and T; hd 64, 128 and 256.
//
// Bound on an H100: operations at the prefill shapes of the main path.  Two
// products of 2 * S * T * hd flops each (half of it under the causal mask)
// against q, k, v and o read or written once: at S = T = 4096, hd = 128 that
// is about 2000 flops per byte, far above the card's balance point; bf16
// operands bound it by the tensor cores (989 TFLOP/s), fp32 ones by the CUDA
// cores (67 TFLOP/s).
//
// Two kernels, chosen by dtype:
//
// fp32 (flash_fwd_kernel): fp32 FMAs on the CUDA cores, which are its bound.
// One block of 256 threads per (query tile of BQ rows, head).  The Q tile
// (pre-scaled: the score is (q * hd^-1/2) . k, as the TPU kernel forms it),
// one K tile and one V tile of BK = 64 keys live in shared memory as fp32,
// plus the BQ x BK probability tile.  Threads form a 16 x 16 grid: thread
// (ty, tx) owns score rows ty + 16 i and columns tx + 16 j, so a row's 64
// scores sit in 16 lanes of one warp and its max and sum reduce with shuffles.
// The row pitch of the Q and K tiles is hd + 4 floats, which keeps the
// 16-byte reads of the score loop free of bank conflicts.  A query row past S
// is computed and not stored.
//
// bf16 (flash_fwd_wgmma_kernel): the tensor cores through wgmma, fed by TMA.
// A block is two consumer warpgroups of 64 query rows each (BQ = 128).  One
// thread loads the Q tile once and K/V tiles of BK keys (128; 64 at hd 256)
// into a two-stage ring (TMA, 128-byte swizzle, one mbarrier per stage; the
// next tile loads while this one computes; a row or key past S or T arrives
// as zeros).  S = Q K^T runs as wgmma over bf16 Q and K in shared memory
// with fp32 accumulation, K in its natural (T, hd) layout, then S is scaled
// by hd^-1/2 * log2(e) in fp32 (exp2 below; the TPU kernel scales q before
// the product, which differs by fp32 rounding only).  The online softmax
// runs on the accumulator registers (a row's scores lie in the four lanes of
// a quad).  P stays fp32 in the statistics; for O += P V it is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), taken as wgmma's register
// operand against V read through the transpose bit: two products that keep
// P to about 16 bits where one bf16 rounding would add 2^-8 of each weight.
// Shared memory: 160 KB at hd 128, 192 KB at hd 256; 256 registers per
// thread at most, so no producer warp (one thread of the block issues the
// loads after the block has released a stage).
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// rows x HD elements of src (row pitch HD) starting at row r0 -> dst (row
// pitch `pitch` floats), times `mul`; rows at or past `limit` are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* __restrict__ src, int r0,
                                          int rows, int limit, float mul) {
  constexpr int kVec = HD / 8;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx - r * kVec) * 8;
    float v[8];
    if (r0 + r < limit) {
      load8(src + (int64_t)(r0 + r) * HD + c, v);
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] *= mul;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = 0.f;
    }
    store4(dst + r * pitch + c, v[0], v[1], v[2], v[3]);
    store4(dst + r * pitch + c + 4, v[4], v[5], v[6], v[7]);
  }
}

template <int HD, int BQ>
struct Smem {
  static constexpr int kQP = HD + 4;   // Q and K tile pitch (floats)
  static constexpr int kVP = HD;       // V tile pitch
  static constexpr int kPP = kBK + 16; // probability tile pitch
  static constexpr int kFloats = BQ * kQP + kBK * kQP + kBK * kVP + BQ * kPP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int T_len, int group, int causal, int q_offset,
    int kv_offset, float scale) {
  using L = Smem<HD, BQ>;
  constexpr int RI = BQ / 16;   // score rows per thread
  constexpr int CJ = kBK / 16;  // score columns per thread
  constexpr int DU = HD / 64;   // float4 groups of output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * L::kQP;
  float* Vs = Ks + kBK * L::kQP;
  float* Ps = Vs + kBK * L::kVP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  // heaviest query tiles (the causal tail) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qh = q + (int64_t)bh * S * HD;
  const float* kh = k + (int64_t)(bh / group) * T_len * HD;
  const float* vh = v + (int64_t)(bh / group) * T_len * HD;

  load_tile<HD>(Qs, L::kQP, qh, q0, BQ, S, scale);

  int n_kt = (T_len + kBK - 1) / kBK;
  if (causal && q_offset + q0 >= kv_offset) {
    // every row of the tile sees key 0: stop after the last visible key
    const int last_row = min(q0 + BQ, S) - 1;
    const int j_max = q_offset + last_row - kv_offset;
    n_kt = min(n_kt, j_max / kBK + 1);
  }

  float m[RI], l[RI], acc[RI][DU][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile<HD>(Ks, L::kQP, kh, k0, kBK, T_len, 1.f);
    load_tile<HD>(Vs, L::kVP, vh, k0, kBK, T_len, 1.f);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::kQP + d);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::kQP + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= T_len)
          s[i][j] = -INFINITY;   // no key: weight 0, not part of the max
        else if (causal && q_pos < kv_offset + col)
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * L::kPP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < DU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][u][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::kPP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (c + cc) * L::kVP + tx * 4 + 64 * u);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float p = cc == 0 ? p4[i].x
                          : cc == 1 ? p4[i].y
                          : cc == 2 ? p4[i].z : p4[i].w;
            acc[i][u][0] = fmaf(p, vv.x, acc[i][u][0]);
            acc[i][u][1] = fmaf(p, vv.y, acc[i][u][1]);
            acc[i][u][2] = fmaf(p, vv.z, acc[i][u][2]);
            acc[i][u][3] = fmaf(p, vv.w, acc[i][u][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + ((int64_t)bh * S + row) * HD;
#pragma unroll
    for (int u = 0; u < DU; ++u)
      store4(orow + tx * 4 + 64 * u, acc[i][u][0] * inv, acc[i][u][1] * inv,
             acc[i][u][2] * inv, acc[i][u][3] * inv);
  }
}

template <int HD, int BQ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int BH, int S, int T_len, int group, int causal,
                       int q_offset, int kv_offset, float scale,
                       cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD, BQ>;
  const size_t bytes = Smem<HD, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, group,
      causal, q_offset, kv_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;   // query rows per block: two warpgroups of 64
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgCfg {
  static constexpr int BK = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int kChunks = HD / 64;           // 128-byte column chunks
  static constexpr int kQBytes = kWgBQ * HD * 2;
  static constexpr int kTile = BK * HD * 2;         // one K or V tile
  // Q, two K and two V stages, 1024-byte alignment, three mbarriers
  static constexpr int kAlloc = kQBytes + 4 * kTile + 1024 + 64;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int S, int T_len, int group, int causal, int q_offset, int kv_offset,
    float scale_log2) {
  using C = WgCfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::kQBytes;        // stage s at ks + s * kTile
  uint8_t* vs = ks + 2 * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * C::kTile);
  const uint32_t qbar = smem_u32(bars);
  const uint32_t full0 = smem_u32(bars + 1);   // stage s: full0 + 8 * s

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int qd = lane % 4;
  const int bh = blockIdx.x;
  const int kvh = bh / group;
  // heaviest query tiles (the causal tail) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  // this thread's two rows: g and g + 8 of its warp's 16
  const int row0 = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;

  int n_kt = (T_len + BK - 1) / BK;
  if (causal && q_offset + q0 >= kv_offset) {
    // every row of the tile sees key 0: stop after the last visible key
    const int last_row = min(q0 + kWgBQ, S) - 1;
    n_kt = min(n_kt, (q_offset + last_row - kv_offset) / BK + 1);
  }

  const void* kp = &kmap;
  const void* vp = &vmap;
  auto load_kv = [&](int j) {   // key tile j into stage j & 1
    const int s = j & 1;
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_3d(ks + s * C::kTile + c * BK * 128, kp, bar, 64 * c,
                  j * BK, kvh);
      tma_load_3d(vs + s * C::kTile + c * BK * 128, vp, bar, 64 * c,
                  j * BK, kvh);
    }
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_3d(qs + c * kWgBQ * 128, &qmap, qbar, 64 * c, q0, bh);
    load_kv(0);
    if (n_kt > 1) load_kv(1);
  }

  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};   // this thread's columns; the quad sums at the end
  const uint32_t qaddr = smem_u32(qs) + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j & 1;
    const int k0 = j * BK;
    mbar_wait(full0 + 8 * s, (j >> 1) & 1);
    const uint32_t kaddr = smem_u32(ks + s * C::kTile);
    const uint32_t vaddr = smem_u32(vs + s * C::kTile);

    // S = Q K^T: K-major Q and K, 16 of hd per product
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da =
          sw128_desc(qaddr + (kk / 4) * kWgBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          sw128_desc(kaddr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
      WgmmaSS<BK>::mma(sacc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // mask, scale to log2 units, online softmax over the quad's columns
    const bool need_mask =
        k0 + BK > T_len ||
        (causal && kv_offset + k0 + BK - 1 > q_offset + q0);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q_pos = q_offset + row0 + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * jj + 2 * r + c;
          float t = sacc[i] * scale_log2;
          if (need_mask) {
            const int col = k0 + 8 * jj + 2 * qd + c;
            if (col >= T_len)
              t = -INFINITY;   // no key: weight 0, not part of the max
            else if (causal && q_pos < kv_offset + col)
              t = kNegInf;
          }
          sacc[i] = t;
          mx = fmaxf(mx, t);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * jj + 2 * r + c;
          const float p = exp2f(sacc[i] - m_new);
          sacc[i] = p;
          sum += p;
        }
      l_r[r] = l_r[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) oacc[4 * jj + i] *= alpha[i / 2];

    // P = P_hi + P_lo, both bf16, as wgmma's register operand: the
    // accumulator's columns 16kk..16kk+15 are the A fragment of key step kk
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p0 = sacc[8 * kk + 2 * e];
        const float p1 = sacc[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        phi[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[kk][e] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += P_hi V + P_lo V: V MN-major (transpose bit), 16 keys per product
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<HD>::mma(oacc, phi[kk],
                       sw128_desc(vaddr + kk * 2048, BK * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<HD>::mma(oacc, plo[kk],
                       sw128_desc(vaddr + kk * 2048, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);

    __syncthreads();   // both warpgroups are done with stage s
    if (tid == 0 && j + 2 < n_kt) load_kv(j + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((int64_t)bh * S + row) * HD;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * qd) =
          __floats2bfloat162_rn(oacc[4 * jj + 2 * r] * inv,
                                oacc[4 * jj + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled from libcuda, which the process has loaded
// (PyTorch has), so the library links against nothing but the CUDA runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// (heads, rows, hd) bf16 as a 3-D map of boxes 64 wide (128 bytes, the
// swizzle span) and box_rows tall; out-of-range rows load as zeros.
bool bf16_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int T_len, int group, int causal,
                        int q_offset, int kv_offset, float scale,
                        cudaStream_t stream) {
  using C = WgCfg<HD>;
  if (!encode_tiled()) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!bf16_map(&qm, q, HD, S, BH, kWgBQ) ||
      !bf16_map(&km, k, HD, T_len, BH / group, C::BK) ||
      !bf16_map(&vm, v, HD, T_len, BH / group, C::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + kWgBQ - 1) / kWgBQ);
  kern<<<grid, kThreads, C::kAlloc, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, T_len, group, causal,
      q_offset, kv_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q (BH, S, hd), k and v (BH / group, T, hd), o (BH, S, hd): one dtype, fp32
// or bf16; contiguous and 16-byte aligned; hd 64, 128 or 256; BH a multiple
// of group; at most 65535 query tiles (64 rows in fp32, 32 at hd 256; 128 in
// bf16).  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int BH, int S, int T_len, int hd,
                                         int group, int causal, int q_offset,
                                         int kv_offset, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (hd == 64)
      err = launch_f32<64, 64>(q, k, v, o, BH, S, T_len, group, causal,
                               q_offset, kv_offset, scale, st);
    else if (hd == 128)
      err = launch_f32<128, 64>(q, k, v, o, BH, S, T_len, group, causal,
                                q_offset, kv_offset, scale, st);
    else if (hd == 256)
      err = launch_f32<256, 32>(q, k, v, o, BH, S, T_len, group, causal,
                                q_offset, kv_offset, scale, st);
  } else if (dtype == DT_BF16) {
    if (hd == 64)
      err = launch_bf16<64>(q, k, v, o, BH, S, T_len, group, causal,
                            q_offset, kv_offset, scale, st);
    else if (hd == 128)
      err = launch_bf16<128>(q, k, v, o, BH, S, T_len, group, causal,
                             q_offset, kv_offset, scale, st);
    else if (hd == 256)
      err = launch_bf16<256>(q, k, v, o, BH, S, T_len, group, causal,
                             q_offset, kv_offset, scale, st);
  }
  return (int)err;
}
