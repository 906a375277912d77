// Forward flash attention with grouped KV heads
//   o = softmax((q * hd^-1/2) k^T + mask) v,   fp32 scores, softmax and sums.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_attention_fwd_p — its
// `_kernel` body.  Layout as there: q (BH, S, hd), k and v (BH / group, T, hd),
// query head b reading KV head b / group; o (BH, S, hd) in q's dtype.
//
// Semantics kept from the TPU kernel:
//   * the score is (q in fp32 times the scale, not rounded back) . k in fp32;
//   * the causal mask is by absolute position, q_offset + i >= kv_offset + j,
//     and a masked score is the finite -1e30, not -inf: a row that sees no
//     key at all (q_offset + i < kv_offset) gets weight exp(0) = 1 on every
//     key, so its output is the mean of v over all T, as in the TPU kernel;
//   * online softmax with fp32 m, l and accumulator; o = acc / max(l, 1e-30).
//
// Bound on an H100: operations at the prefill shapes of the main path.  Two
// products of 2 * S * T * hd flops each (half of it under the causal mask)
// against q, k, v and o read or written once: at S = T = 4096, hd = 128 that
// is about 2000 flops per byte, far above the card's balance point.
//
// Design (simple and right; tensor cores, TMA and wgmma come later): one block
// of 256 threads per (query tile of BQ rows, head).  The Q tile (pre-scaled),
// one K tile and one V tile of BK = 64 keys live in shared memory as fp32,
// plus the BQ x BK probability tile.  Threads form a 16 x 16 grid: thread
// (ty, tx) owns score rows ty + 16 i and columns tx + 16 j, so a row's 64
// scores sit in 16 lanes of one warp and its max and sum reduce with shuffles.
// The row pitch of the Q and K tiles is hd + 4 floats, which keeps the
// 16-byte reads of the score loop free of bank conflicts.  Under the causal
// mask the key tiles wholly above the diagonal are skipped: they add exactly
// 0 to every row that sees a key.  A query tile whose first row sees no key
// keeps every tile, so those rows still come out as the mean of v.  Ragged S
// and T are bounds-checked: a key past T gets weight 0, a query row past S is
// computed and not stored.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows x HD elements of src (row pitch HD) starting at row r0 -> dst (row
// pitch `pitch` floats), times `mul`; rows at or past `limit` are zeros.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src, int r0,
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

template <int HD, int BQ, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int T_len, int group, int causal, int q_offset,
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
  const T* qh = q + (int64_t)bh * S * HD;
  const T* kh = k + (int64_t)(bh / group) * T_len * HD;
  const T* vh = v + (int64_t)(bh / group) * T_len * HD;

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
    T* orow = o + ((int64_t)bh * S + row) * HD;
#pragma unroll
    for (int u = 0; u < DU; ++u)
      store4(orow + tx * 4 + 64 * u, acc[i][u][0] * inv, acc[i][u][1] * inv,
             acc[i][u][2] * inv, acc[i][u][3] * inv);
  }
}

template <int HD, int BQ, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int T_len, int group, int causal,
                   int q_offset, int kv_offset, float scale,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD, BQ, T>;
  const size_t bytes = Smem<HD, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, group, causal,
      q_offset, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int T_len, int hd, int group,
                        int causal, int q_offset, int kv_offset, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, 64, T>(q, k, v, o, BH, S, T_len, group, causal,
                               q_offset, kv_offset, scale, stream);
    case 128:
      return launch<128, 64, T>(q, k, v, o, BH, S, T_len, group, causal,
                                q_offset, kv_offset, scale, stream);
    case 256:
      return launch<256, 32, T>(q, k, v, o, BH, S, T_len, group, causal,
                                q_offset, kv_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, S, hd), k and v (BH / group, T, hd), o (BH, S, hd): one dtype, fp32
// or bf16; contiguous and 16-byte aligned; hd 64, 128 or 256; BH a multiple
// of group; S / BQ tiles at most 65535.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int BH, int S, int T_len, int hd,
                                         int group, int causal, int q_offset,
                                         int kv_offset, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_hd<float>(q, k, v, o, BH, S, T_len, hd, group,
                                   causal, q_offset, kv_offset, scale, st);
  if (dtype == DT_BF16)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, S, T_len, hd,
                                           group, causal, q_offset, kv_offset,
                                           scale, st);
  return (int)cudaErrorInvalidValue;
}
