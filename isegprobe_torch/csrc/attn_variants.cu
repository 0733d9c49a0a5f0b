// The attention variants of the sweep for Hopper (sm_90a): kernel F (nodiv)
// and kernel G (merged), f32 and bf16, with an optional bf16 exp.
//
// Replaces the Pallas TPU kernel of scripts/bench_attn_variants.py:run_variant
// (pallas_call at :101) with its two bodies _kernel_nodiv (:51) and
// _kernel_merged (:71). Both compute, over a packed qkv [B, N, 3C] with dh =
// 64 and an even head count (q, k, v at column offsets 0, C, 2C; head h at
// 64h), for each head and query row i:
//     s_j  = (q_i . k_j) * scale                        f32; keys j >= N out
//     e_j  = round_exp(exp(round_exp(s_j - m)))         m = max_j s_j
//     o_i  = (sum_j round_io(e_j) v_j) / sum_j e_j      f32 accumulation
// and write round_io(o_i) at [B, N, C]: the output is normalised once, after
// PV, not the probability panel (kernel A's reference rounds normalised
// probabilities instead). round_exp is the identity for an f32 exp and a
// bf16 rounding for a bf16 exp; round_io rounds to the input dtype. The two
// bodies compute one function: merged only summed in another order, through
// a block-diagonal 128-deep product that filled the TPU's matrix unit.
//
// Bound on this card, the largest of: 4*B*H*N^2*dh product operations (bf16
// tensor cores, 989 TFLOP/s; f32 CUDA-core FMAs, 67 TFLOP/s), B*H*N^2 exps
// on the special-function units, and the bytes (qkv read once, out written
// once). In bf16 at [16, 1025, 1152] the exps bound as much as the products.
//
// Design.
// * Kernel F: one block per (query tile, head, batch); kernel G: one block
//   per (query tile, head pair, batch), which stages the pair's contiguous
//   128 columns of K and V once (256-byte rows in bf16) and computes both
//   heads from them. That shared load is what the merged variant tests; its
//   block-diagonal product would waste half of the tensor cores' products,
//   so G does not copy it. F and G are one kernel template with one or two
//   heads per block.
// * The softmax is online (flash form): each key tile rescales the running
//   sum and output accumulator by exp(m_old - m_new) as the row max moves,
//   and the accumulator is divided once at the end. So e is taken against
//   the running max, where the reference takes it against the row's final
//   max: the bf16 roundings of e (and, with a bf16 exp, of s - m) fall at
//   other points than the plain version's, within one bf16 rounding.
// * bf16: QK^T and PV run on tensor cores with
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on fragments loaded
//   by ldmatrix (V transposed by ldmatrix .trans), f32 accumulators. A warp
//   owns 16 query rows of one head for the whole key range; q stays in
//   registers, and key tiles of 64 stream through shared memory (rows padded
//   by 16 bytes, so ldmatrix is conflict-free). The score accumulators become
//   PV's A fragments in registers, with e rounded to bf16 as the reference
//   rounds it. The f32 exp is __expf (ex2.approx.ftz.f32 of x*log2 e; a
//   few ulp of f32, far below the bf16 rounding of e that follows).
//   Registers are capped at 128 a thread: uncapped, ptxas gave G's 64-row
//   f32-exp instantiation 162, one block an SM, and it ran 1.6x slower than
//   the same kernel with a bf16 exp.
// * bf16 exp: s - m is rounded to bf16, multiplied by log2 e in f32, rounded
//   to bf16 again and raised by Hopper's packed ex2.approx.ftz.bf16x2, two
//   exps per instruction, whose bf16 result is e. The plain version computes
//   exp in f32 from the bf16 argument and rounds once; the extra rounding of
//   x*log2 e here moves e by up to 2^-9 |x| ln 2 relative (0.5% at x = -2.8).
// * f32: CUDA-core FMAs, no TF32 (parity with the HIGHEST-precision
//   reference), register-tiled as kernel D (csrc/mha.cu): 8 lanes share 4
//   query rows; a lane computes 4 rows x 4 keys of scores and accumulates 4
//   rows x 8 output dims; row max and sum are shuffles among the 8 lanes; e
//   goes through a per-warp slice of shared memory with no block barrier.
//   Key chunks of 32.
// * Query rows >= N are read as zeros and never written; keys >= N score
//   -inf (and their K, V rows are zero). N = 1025 is ragged.
// Simple and right first: no cp.async/TMA pipeline, no wgmma, no warp
// specialisation (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16 --

constexpr int kKeyTile = 64;  // keys per shared-memory tile (bf16 path)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// e of two scores of one row against the running max m, packed as PV's bf16
// operand; adds the f32 values of e (as rounded by expdt) to sum
template <bool kExpBf16>
__device__ __forceinline__ uint32_t exp_pair(float s0, float s1, float m,
                                             float& sum) {
  if constexpr (kExpBf16) {
    const float2 x = unpack_bf16(pack_bf16(s0 - m, s1 - m));
    const uint32_t e = ex2_bf16x2(pack_bf16(x.x * kLog2e, x.y * kLog2e));
    const float2 ef = unpack_bf16(e);
    sum += ef.x + ef.y;
    return e;
  } else {
    const float e0 = __expf(s0 - m), e1 = __expf(s1 - m);
    sum += e0 + e1;
    return pack_bf16(e0, e1);
  }
}

template <int HP, int WH>
struct Bf16Dims {
  static constexpr int kThreads = HP * WH * 32;
  // blocks per SM that keep a thread at 128 registers or fewer
  static constexpr int kMinBlocks = 65536 / (128 * kThreads);
  static constexpr int kRows = 16 * WH;    // query rows per head
  static constexpr int QP = kDh + 8;       // q row stride (bf16)
  static constexpr int KP = HP * kDh + 8;  // k and v row stride (bf16)
  static constexpr int kSmemBytes =
      (HP * kRows * QP + 2 * kKeyTile * KP) * 2;
};

// HP heads per block (1: kernel F, 2: kernel G), WH warps per head
template <int HP, int WH, bool kExpBf16>
__global__ void __launch_bounds__(Bf16Dims<HP, WH>::kThreads,
                                  Bf16Dims<HP, WH>::kMinBlocks)
attn_variant_bf16(const __nv_bfloat16* __restrict__ qkv,
                  __nv_bfloat16* __restrict__ out, int n, int heads,
                  float scale) {
  using D = Bf16Dims<HP, WH>;
  constexpr int kChunks = kDh / 8;  // 16-byte chunks of one head's row
  extern __shared__ uint4 smem_bf[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_bf);
  __nv_bfloat16* k_s = q_s + HP * D::kRows * D::QP;  // [kKeyTile][KP]
  __nv_bfloat16* v_s = k_s + kKeyTile * D::KP;       // [kKeyTile][KP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hh = warp / WH;  // head of the block this warp computes
  const int wr = warp % WH;  // its 16-row slice of the query tile
  const int q0 = blockIdx.x * D::kRows;
  const int head0 = blockIdx.y * HP;
  const int b = blockIdx.z;
  const int c = heads * kDh;
  const long rs = 3L * c;  // row stride of the packed tensor
  const __nv_bfloat16* qg = qkv + (long)b * n * rs + (long)head0 * kDh;
  const __nv_bfloat16* kg = qg + c;
  const __nv_bfloat16* vg = qg + 2 * c;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // q tile: [HP * kRows][QP], head-major
  for (int i = threadIdx.x; i < HP * D::kRows * kChunks; i += D::kThreads) {
    const int r = i / kChunks, ch = i % kChunks, row = q0 + r % D::kRows;
    const uint4 val =
        row < n ? *reinterpret_cast<const uint4*>(
                      qg + row * rs + (r / D::kRows) * kDh + ch * 8)
                : zero;
    *reinterpret_cast<uint4*>(q_s + r * D::QP + ch * 8) = val;
  }
  __syncthreads();
  uint32_t qa[kDh / 16][4];  // A fragments of the warp's 16 rows
  {
    const __nv_bfloat16* base =
        q_s + (hh * D::kRows + 16 * wr + (lane & 15)) * D::QP + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks) ldsm_x4(base + 16 * ks, qa[ks]);
  }

  // rows lane/4 (accumulator halves 0, 1) and lane/4 + 8 (halves 2, 3)
  float o[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int kcol = hh * kDh;

  for (int k0 = 0; k0 < n; k0 += kKeyTile) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < kKeyTile * HP * kChunks; i += D::kThreads) {
      const int r = i / (HP * kChunks), ch = i % (HP * kChunks), key = k0 + r;
      uint4 kv = zero, vv = zero;
      if (key < n) {
        kv = *reinterpret_cast<const uint4*>(kg + key * rs + ch * 8);
        vv = *reinterpret_cast<const uint4*>(vg + key * rs + ch * 8);
      }
      *reinterpret_cast<uint4*>(k_s + r * D::KP + ch * 8) = kv;
      *reinterpret_cast<uint4*>(v_s + r * D::KP + ch * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks)
#pragma unroll
      for (int np = 0; np < kKeyTile / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(k_s + (16 * np + (lane & 7) + (lane >> 4) * 8) * D::KP + kcol +
                    16 * ks + ((lane >> 3) & 1) * 8,
                kb);
        mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        s[j][e] = key < n ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the tile holds a valid key, so m_new is finite; on the first tile
      // m_r = -inf and corr = 0
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      o[j][0] *= corr[0], o[j][1] *= corr[0];
      o[j][2] *= corr[1], o[j][3] *= corr[1];
    }
    uint32_t p[kKeyTile / 8][2];  // e as bf16 pairs: rows lane/4, lane/4 + 8
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      p[j][0] = exp_pair<kExpBf16>(s[j][0], s[j][1], m_r[0], l_r[0]);
      p[j][1] = exp_pair<kExpBf16>(s[j][2], s[j][3], m_r[1], l_r[1]);
    }

    // O += E V: the score tiles 2t, 2t+1 are the A fragment of keys 16t..
#pragma unroll
    for (int t = 0; t < kKeyTile / 16; ++t) {
      const uint32_t pa[4] = {p[2 * t][0], p[2 * t][1], p[2 * t + 1][0],
                              p[2 * t + 1][1]};
#pragma unroll
      for (int np = 0; np < kDh / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(v_s + (16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                D::KP +
                          kcol + 16 * np + (lane >> 4) * 8,
                      vb);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  const int row0 = q0 + 16 * wr + (lane >> 2);
  __nv_bfloat16* og = out + (long)b * n * c + (long)(head0 + hh) * kDh;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)row0 * c + col) =
          __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    if (row0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)(row0 + 8) * c + col) =
          __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
}

// ------------------------------------------------------------------- f32 --

constexpr int kKeys32 = 32;  // keys per shared-memory chunk (f32 path)

template <int HP, int GH>
struct F32Dims {
  static constexpr int kGroups = HP * GH;  // row groups of 8 lanes
  static constexpr int kThreads = 8 * kGroups;
  static constexpr int kRows = 4 * GH;          // query rows per head
  static constexpr int QS = kDh + 4;            // q row stride (floats)
  static constexpr int KS = HP * kDh + 4;       // k row stride
  static constexpr int VS = HP * kDh;           // v row stride
  static constexpr int PS = 4 * kGroups + 4;    // e row stride (per key)
  static constexpr int kSmemBytes =
      (HP * kRows * QS + kKeys32 * (KS + VS + PS)) * 4;
};

// Max or sum over the 8 lanes of a row group.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// HP heads per block (1: kernel F, 2: kernel G), GH row groups per head
template <int HP, int GH>
__global__ void __launch_bounds__(8 * HP * GH)
attn_variant_f32(const float* __restrict__ qkv, float* __restrict__ out,
                 int n, int heads, float scale) {
  using D = F32Dims<HP, GH>;
  extern __shared__ float4 smem_f[];
  float* q_s = reinterpret_cast<float*>(smem_f);  // [HP * kRows][QS]
  float* k_s = q_s + HP * D::kRows * D::QS;       // [kKeys32][KS]
  float* v_s = k_s + kKeys32 * D::KS;             // [kKeys32][VS]
  float* p_s = v_s + kKeys32 * D::VS;             // [kKeys32][PS]

  const int tx = threadIdx.x & 7;   // key and dim lane of the row group
  const int ty = threadIdx.x >> 3;  // row group
  const int hh = ty / GH;           // head of the block
  const int gy = ty % GH;           // rows gy + GH*rr of that head
  const int q0 = blockIdx.x * D::kRows;
  const int head0 = blockIdx.y * HP;
  const int b = blockIdx.z;
  const int c = heads * kDh;
  const long rs = 3L * c;
  const float* qg = qkv + (long)b * n * rs + (long)head0 * kDh;
  const float* kg = qg + c;
  const float* vg = qg + 2 * c;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kChunks = kDh / 4;

  for (int i = threadIdx.x; i < HP * D::kRows * kChunks; i += D::kThreads) {
    const int r = i / kChunks, ch = i % kChunks, row = q0 + r % D::kRows;
    *reinterpret_cast<float4*>(q_s + r * D::QS + ch * 4) =
        row < n ? *reinterpret_cast<const float4*>(
                      qg + row * rs + (r / D::kRows) * kDh + ch * 4)
                : zero;
  }
  const float* q_me = q_s + (hh * D::kRows + gy) * D::QS;

  float o[4][8];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[rr][e] = 0.f;
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) m[rr] = -INFINITY, l[rr] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKeys32) {
    __syncthreads();  // q staged / the previous chunk's reads are done
    for (int i = threadIdx.x; i < kKeys32 * HP * kChunks; i += D::kThreads) {
      const int r = i / (HP * kChunks), ch = i % (HP * kChunks), key = k0 + r;
      float4 kv = zero, vv = zero;
      if (key < n) {
        kv = *reinterpret_cast<const float4*>(kg + key * rs + ch * 4);
        vv = *reinterpret_cast<const float4*>(vg + key * rs + ch * 4);
      }
      *reinterpret_cast<float4*>(k_s + r * D::KS + ch * 4) = kv;
      *reinterpret_cast<float4*>(v_s + r * D::VS + ch * 4) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) s[rr][kk] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kDh; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(
            k_s + (tx + 8 * kk) * D::KS + hh * kDh + d);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 qf =
            *reinterpret_cast<const float4*>(q_me + GH * rr * D::QS + d);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          s[rr][kk] = fmaf(qf.x, kf[kk].x, s[rr][kk]);
          s[rr][kk] = fmaf(qf.y, kf[kk].y, s[rr][kk]);
          s[rr][kk] = fmaf(qf.z, kf[kk].z, s[rr][kk]);
          s[rr][kk] = fmaf(qf.w, kf[kk].w, s[rr][kk]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bool valid = k0 + tx + 8 * kk < n;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        s[rr][kk] = valid ? s[rr][kk] * scale : -INFINITY;
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float t =
          fmaxf(fmaxf(s[rr][0], s[rr][1]), fmaxf(s[rr][2], s[rr][3]));
      const float m_new = fmaxf(m[rr], group_max(t));  // finite, see bf16
      const float corr = expf(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        s[rr][kk] = expf(s[rr][kk] - m_new);  // 0 for masked keys
        sum += s[rr][kk];
      }
      l[rr] = l[rr] * corr + group_sum(sum);
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[rr][e] *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      *reinterpret_cast<float4*>(p_s + (tx + 8 * kk) * D::PS + ty * 4) =
          make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
    __syncwarp();  // the row group's e are all written (one warp)
#pragma unroll 4
    for (int key = 0; key < kKeys32; ++key) {
      const float4 p =
          *reinterpret_cast<const float4*>(p_s + key * D::PS + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            v_s + key * D::VS + hh * kDh + tx * 4 + 32 * j);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          o[rr][4 * j] = fmaf(pr[rr], v.x, o[rr][4 * j]);
          o[rr][4 * j + 1] = fmaf(pr[rr], v.y, o[rr][4 * j + 1]);
          o[rr][4 * j + 2] = fmaf(pr[rr], v.z, o[rr][4 * j + 2]);
          o[rr][4 * j + 3] = fmaf(pr[rr], v.w, o[rr][4 * j + 3]);
        }
      }
    }
    __syncwarp();  // e is read before the next chunk overwrites it
  }

  float* og = out + (long)b * n * c + (long)(head0 + hh) * kDh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + gy + GH * rr;
    if (row >= n) continue;
    const float inv = 1.f / l[rr];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(og + (long)row * c + tx * 4 + 32 * j) =
          make_float4(o[rr][4 * j] * inv, o[rr][4 * j + 1] * inv,
                      o[rr][4 * j + 2] * inv, o[rr][4 * j + 3] * inv);
  }
}

// --------------------------------------------------------------- launch --

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int HP, int WH, bool kExpBf16>
cudaError_t launch_bf16(const void* qkv, void* out, int batch, int n,
                        int heads, float scale, cudaStream_t stream) {
  using D = Bf16Dims<HP, WH>;
  static bool attr_set = false;
  cudaError_t e = set_smem(attn_variant_bf16<HP, WH, kExpBf16>,
                           D::kSmemBytes, attr_set);
  if (e != cudaSuccess) return e;
  dim3 grid((n + D::kRows - 1) / D::kRows, heads / HP, batch);
  attn_variant_bf16<HP, WH, kExpBf16><<<grid, D::kThreads, D::kSmemBytes,
                                        stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), n, heads, scale);
  return cudaGetLastError();
}

template <int HP, int GH>
cudaError_t launch_f32(const void* qkv, void* out, int batch, int n,
                       int heads, float scale, cudaStream_t stream) {
  using D = F32Dims<HP, GH>;
  static bool attr_set = false;
  cudaError_t e = set_smem(attn_variant_f32<HP, GH>, D::kSmemBytes, attr_set);
  if (e != cudaSuccess) return e;
  dim3 grid((n + D::kRows - 1) / D::kRows, heads / HP, batch);
  attn_variant_f32<HP, GH><<<grid, D::kThreads, D::kSmemBytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, heads,
      scale);
  return cudaGetLastError();
}

template <int HP, int WH>
cudaError_t launch_bf16_exp(const void* qkv, void* out, int batch, int n,
                            int heads, float scale, int exp_bf16,
                            cudaStream_t stream) {
  if (exp_bf16)
    return launch_bf16<HP, WH, true>(qkv, out, batch, n, heads, scale, stream);
  return launch_bf16<HP, WH, false>(qkv, out, batch, n, heads, scale, stream);
}

}  // namespace

extern "C" {

// qkv [batch, n, 3*heads*64] and out [batch, n, heads*64], contiguous, of one
// dtype (0 = float32, 1 = bfloat16); heads even. merged = 0 runs kernel F
// (q_tile 64 or 128), 1 kernel G (q_tile 32 or 64 rows of each head of a
// pair). exp_bf16 = 1 takes the exp in bf16 (bf16 only). Returns
// cudaGetLastError().
int iseg_attn_variant(const void* qkv, void* out, int batch, int n, int heads,
                      float scale, int dtype, int exp_bf16, int merged,
                      int q_tile, void* stream) {
  if (batch < 1 || n < 1 || heads < 2 || heads % 2 || batch > 65535 ||
      heads > 65535 || (dtype == 0 && exp_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!merged && q_tile == 64)
      return (int)launch_bf16_exp<1, 4>(qkv, out, batch, n, heads, scale,
                                        exp_bf16, s);
    if (!merged && q_tile == 128)
      return (int)launch_bf16_exp<1, 8>(qkv, out, batch, n, heads, scale,
                                        exp_bf16, s);
    if (merged && q_tile == 32)
      return (int)launch_bf16_exp<2, 2>(qkv, out, batch, n, heads, scale,
                                        exp_bf16, s);
    if (merged && q_tile == 64)
      return (int)launch_bf16_exp<2, 4>(qkv, out, batch, n, heads, scale,
                                        exp_bf16, s);
  } else if (dtype == 0) {
    if (!merged && q_tile == 64)
      return (int)launch_f32<1, 16>(qkv, out, batch, n, heads, scale, s);
    if (!merged && q_tile == 128)
      return (int)launch_f32<1, 32>(qkv, out, batch, n, heads, scale, s);
    if (merged && q_tile == 32)
      return (int)launch_f32<2, 8>(qkv, out, batch, n, heads, scale, s);
    if (merged && q_tile == 64)
      return (int)launch_f32<2, 16>(qkv, out, batch, n, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
