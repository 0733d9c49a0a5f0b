// Multi-head cross-attention for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/attention.py:_mha_pallas
// (kernel _attn_kernel, pallas_call at :319), the general attention of
// ops/attention.py:mha that carries LoftUp's coordinate cross-attention:
//     out[b, i, h, :] = sum_j softmax_j(q[b,i,h] . k[b,j,h] * scale) v[b,j,h]
// over q [B, Nq, H, dh] and k, v [B, Nk, H, dh] (any Nq, Nk; dh <= 128), with
// f32 scores, softmax and accumulation and the output in q's dtype. For bf16
// inputs the probabilities are rounded to bf16 before PV, as the reference
// path (_mha_jnp) rounds them.
//
// Bound on this card: 4*B*H*Nq*Nk*dh operations (QK^T and PV) at the 67
// TFLOP/s f32 rate: the products are true f32 FMAs (no TF32), and bf16 inputs
// are widened to f32 and take the same path. The bytes (q, k, v read once,
// out written once) are small beside them: LoftUp's slab at B=2 is 9.5e10
// operations against 0.2 GB.
//
// Design: LoftUp has ~28k queries per slab against 1k keys, the reverse of
// the ViT's self-attention that kernel A splits over keys, so a block of 256
// threads owns 128 query rows for the whole key range and stages K and V in
// chunks of 32 keys (widened to f32) in shared memory; q stays in shared
// memory for the block's life. Both products are register-tiled like a
// CUDA-core GEMM, so that shared-memory loads, not FMAs, stop being the
// limit: a thread computes the scores of 4 query rows x 4 keys (8 16-byte
// loads per 64 FMAs) and accumulates the output of the same 4 rows x 16
// dims (5 loads per 64 FMAs). The 8 threads that share 4 rows sit in one
// warp, so the row max and sum of the online softmax are warp shuffles, and
// the probabilities go through a per-warp slice of shared memory with no
// block barrier. Row, key and dim assignments are strided so that every
// 16-byte shared load of a warp is conflict-free (padded rows of dh + 4).
// f32 keeps a flash-style online softmax in one pass over the keys; bf16
// takes two passes (max and sum, then the normalised probabilities rounded
// to bf16 times V), since a probability can only be rounded once its
// normaliser is known. dh is padded to a multiple of 8 for the scores (104
// for LoftUp's 101) and to a multiple of 32 for the output (128). Keys >= Nk
// score -inf. Registers are capped at 128 so that two blocks share an SM
// (ptxas spills a few dozen bytes at dh 101): occupancy, not the spill, sets
// the speed here. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;            // blocks per SM the registers allow
constexpr int kGroups = kThreads / 8;    // row groups of 8 lanes
constexpr int kRows = 4 * kGroups;       // query rows per block
constexpr int kKeys = 32;  // keys per shared-memory chunk: 8 key lanes x 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// DHP: dh padded to a multiple of 8 (scores); DVP: to a multiple of 32
// (output dims, 4 per lane and step of 32)
template <int DHP>
struct Dims {
  static constexpr int QS = DHP + 4;               // q and k row stride
  static constexpr int DVP = (DHP + 31) / 32 * 32;  // v row stride
  static constexpr int NJ = DVP / 32;               // float4 output groups
  static constexpr int kSmemFloats =
      kRows * QS + kKeys * QS + kKeys * DVP + kKeys * kRows;
};

// Stage keys [c0, c0 + kKeys) of one (batch, head): k as [kKeys][QS] and v
// as [kKeys][DVP], widened to f32, zero beyond nk and dh.
template <typename T, int DHP>
__device__ __forceinline__ void load_chunk(const T* __restrict__ kg,
                                           const T* __restrict__ vg,
                                           float* k_s, float* v_s, int c0,
                                           int nk, int dh, long rs) {
  using D = Dims<DHP>;
  for (int i = threadIdx.x; i < kKeys * D::DVP; i += kThreads) {
    const int r = i / D::DVP, d = i % D::DVP, key = c0 + r;
    const bool ok = key < nk && d < dh;
    const long off = key * rs + d;
    if (d < DHP) k_s[r * D::QS + d] = ok ? to_f32(kg[off]) : 0.f;
    v_s[i] = ok ? to_f32(vg[off]) : 0.f;
  }
}

// Scores of rows (ty + kGroups*rr) against chunk keys (tx + 8*kk), scaled;
// keys >= nk score -inf.
template <int DHP>
__device__ __forceinline__ void scores(const float* q_s, const float* k_s,
                                       int ty, int tx, int c0, int nk,
                                       float scale, float (&s)[4][4]) {
  using D = Dims<DHP>;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) s[rr][kk] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DHP; d += 4) {
    float4 k[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      k[kk] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * kk) * D::QS + d);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 q = *reinterpret_cast<const float4*>(
          q_s + (ty + kGroups * rr) * D::QS + d);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        s[rr][kk] = fmaf(q.x, k[kk].x, s[rr][kk]);
        s[rr][kk] = fmaf(q.y, k[kk].y, s[rr][kk]);
        s[rr][kk] = fmaf(q.z, k[kk].z, s[rr][kk]);
        s[rr][kk] = fmaf(q.w, k[kk].w, s[rr][kk]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bool valid = c0 + tx + 8 * kk < nk;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      s[rr][kk] = valid ? s[rr][kk] * scale : -INFINITY;
  }
}

// Sum or max over the 8 lanes (tx) that share a row group.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// o[rows (ty + kGroups*rr)][dims (tx*4 + 32*j + e)] += P . V over the chunk;
// the probabilities are read from p_s, [key][ty*4 + rr]
template <int DHP>
__device__ __forceinline__ void accumulate(const float* p_s, const float* v_s,
                                           int ty, int tx,
                                           float (&o)[4][Dims<DHP>::NJ * 4]) {
  using D = Dims<DHP>;
#pragma unroll 4
  for (int key = 0; key < kKeys; ++key) {
    const float4 p = *reinterpret_cast<const float4*>(p_s + key * kRows + ty * 4);
    const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int j = 0; j < D::NJ; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(v_s + key * D::DVP + tx * 4 + 32 * j);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        o[rr][4 * j] = fmaf(pr[rr], v.x, o[rr][4 * j]);
        o[rr][4 * j + 1] = fmaf(pr[rr], v.y, o[rr][4 * j + 1]);
        o[rr][4 * j + 2] = fmaf(pr[rr], v.z, o[rr][4 * j + 2]);
        o[rr][4 * j + 3] = fmaf(pr[rr], v.w, o[rr][4 * j + 3]);
      }
    }
  }
}

// Write the thread's probabilities p[rr][kk] (keys tx + 8*kk) to p_s.
__device__ __forceinline__ void put_probs(float* p_s, int ty, int tx,
                                          const float (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    *reinterpret_cast<float4*>(p_s + (tx + 8 * kk) * kRows + ty * 4) =
        make_float4(p[0][kk], p[1][kk], p[2][kk], p[3][kk]);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int nq, int nk,
           int heads, int dh, float scale) {
  using D = Dims<DHP>;
  constexpr bool kTwoPass = sizeof(T) < sizeof(float);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* k_s = q_s + kRows * D::QS;              // [kKeys][QS]
  float* v_s = k_s + kKeys * D::QS;              // [kKeys][DVP]
  float* p_s = v_s + kKeys * D::DVP;             // [kKeys][kRows]

  const int tx = threadIdx.x & 7;   // key and dim lane of the row group
  const int ty = threadIdx.x >> 3;  // row group: rows ty + kGroups*rr
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long rs = (long)heads * dh;  // row stride of q, k, v and out
  const T* qg = q + (long)b * nq * rs + (long)h * dh;
  const T* kg = k + (long)b * nk * rs + (long)h * dh;
  const T* vg = v + (long)b * nk * rs + (long)h * dh;

  for (int i = threadIdx.x; i < kRows * DHP; i += kThreads) {
    const int r = i / DHP, d = i % DHP, row = q0 + r;
    q_s[r * D::QS + d] =
        (row < nq && d < dh) ? to_f32(qg[row * rs + d]) : 0.f;
  }

  float o[4][D::NJ * 4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int e = 0; e < D::NJ * 4; ++e) o[rr][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) m[rr] = -INFINITY, l[rr] = 0.f;
  float s[4][4];

  // pass 1: online softmax; f32 also accumulates PV here
  for (int c0 = 0; c0 < nk; c0 += kKeys) {
    __syncthreads();  // q staged / the previous chunk's reads are done
    load_chunk<T, DHP>(kg, vg, k_s, v_s, c0, nk, dh, rs);
    __syncthreads();
    scores<DHP>(q_s, k_s, ty, tx, c0, nk, scale, s);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float t = fmaxf(fmaxf(s[rr][0], s[rr][1]), fmaxf(s[rr][2], s[rr][3]));
      // the chunk holds a valid key, so m_new is finite; on the first chunk
      // m = -inf and corr = 0
      const float m_new = fmaxf(m[rr], row_max(t));
      const float corr = expf(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        s[rr][kk] = expf(s[rr][kk] - m_new);  // 0 for masked keys
        sum += s[rr][kk];
      }
      l[rr] = l[rr] * corr + row_sum(sum);
      m[rr] = m_new;
      if constexpr (!kTwoPass) {
#pragma unroll
        for (int e = 0; e < D::NJ * 4; ++e) o[rr][e] *= corr;
      }
    }
    if constexpr (!kTwoPass) {
      put_probs(p_s, ty, tx, s);
      __syncwarp();  // the row group's probabilities are all written
      accumulate<DHP>(p_s, v_s, ty, tx, o);
    }
  }
  float inv_l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) inv_l[rr] = 1.f / l[rr];

  // pass 2 (bf16): PV with the probabilities rounded to bf16
  if constexpr (kTwoPass) {
    for (int c0 = 0; c0 < nk; c0 += kKeys) {
      __syncthreads();
      load_chunk<T, DHP>(kg, vg, k_s, v_s, c0, nk, dh, rs);
      __syncthreads();
      scores<DHP>(q_s, k_s, ty, tx, c0, nk, scale, s);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          s[rr][kk] = round_bf16(expf(s[rr][kk] - m[rr]) * inv_l[rr]);
      put_probs(p_s, ty, tx, s);
      __syncwarp();
      accumulate<DHP>(p_s, v_s, ty, tx, o);
    }
  }

  T* og = out + (long)b * nq * rs + (long)h * dh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + ty + kGroups * rr;
    const float norm = kTwoPass ? 1.f : inv_l[rr];
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < D::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 32 * j + e;
        if (d < dh) store(og + (long)row * rs + d, o[rr][4 * j + e] * norm);
      }
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int nq, int nk, int heads, int dh, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = Dims<DHP>::kSmemFloats * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mha_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((nq + kRows - 1) / kRows, heads, batch);
  mha_kernel<T, DHP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nk, heads, dh,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int nq, int nk, int heads, int dh,
                     float scale, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, out, batch, nq, nk, heads, dh, scale, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, out, batch, nq, nk, heads, dh, scale, stream);
  if (dh <= 104)
    return launch<T, 104>(q, k, v, out, batch, nq, nk, heads, dh, scale, stream);
  return launch<T, 128>(q, k, v, out, batch, nq, nk, heads, dh, scale, stream);
}

}  // namespace

extern "C" {

// q, out [batch, nq, heads, dh] and k, v [batch, nk, heads, dh], contiguous,
// of one dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int iseg_mha(const void* q, const void* k, const void* v, void* out,
             int batch, int nq, int nk, int heads, int dh, float scale,
             int dtype, void* stream) {
  if (batch < 1 || nq < 1 || nk < 1 || heads < 1 || dh < 1 || dh > 128 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, batch, nq, nk, heads, dh, scale,
                                s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, batch, nq, nk, heads,
                                        dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
