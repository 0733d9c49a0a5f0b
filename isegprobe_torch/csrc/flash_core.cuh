// The flash-attention core shared by kernel A (csrc/attention.cu, packed-qkv
// self-attention), kernel D (csrc/mha.cu, cross-attention) and the sweep's
// variants F and G (csrc/attn_variants.cu), for Hopper (sm_90a).
//
// All compute, for each (batch b, head h, query row i),
//     out[b, i, h, :] = sum_j softmax_j(q[b,i,h] . k[b,j,h] * scale) v[b,j,h]
// over nq queries and nk keys of dh <= 128 values each, with f32 scores,
// softmax and accumulation and the output in the input dtype. q, k, v and
// out are strided operands: element (b, h, r, d) of an operand lies at
// p + b*batch + h*head + r*row + d, so one core reads A's packed [B, N, 3C]
// tensor and D's [B, N, H, dh] tensors (or D's head-major K/V relayout)
// without a copy. The .cu files hold the __global__ entries (one name per
// kernel, so a profile tells A, D, F and G apart) and the dispatch.
//
// Two template options serve the sweep. HP, the heads of a block: 1, or 2
// (kernel G) for a pair of heads whose columns lie side by side (head
// stride == dh == DHP): the pair's 2*DHP columns of q, K and V are staged
// once and each warpgroup (bf16) or group of lanes (f32) computes one head
// from its half, exactly as a one-head block computes it. kExpBf16 (bf16
// only): e is taken by Hopper's packed bf16 ex2 (below).
//
// Bound on this card: 4*B*H*nq*nk*dh operations (QK^T and PV) at the bf16
// tensor-core rate (989 TFLOP/s) or the f32 CUDA-core rate (67 TFLOP/s),
// B*H*nq*nk exps at the special-function rate (3.9e12/s), and the bytes
// (each operand read once, out written once). At the paths' shapes the
// products bound both dtypes; in bf16 the exps come within a few percent.
//
// bf16 (flash_bf16): warpgroup tensor cores (wgmma).
// * A block owns a query tile of 64 or 128 rows of one head (picked by the
//   wrapper): one or two warpgroups of four warps, 64 rows each.
// * q is staged once in shared memory and K and V stream through a ring of
//   kStages (3 or 4) shared-memory stages of 64 keys, filled by cp.async.cg
//   16-byte copies (commit_group / wait_group): tile t+kStages-2 is in
//   flight while tile t is multiplied, behind one block barrier a tile.
//   dh is zero-padded to DHP (a multiple of 16); keys past nk and dims past
//   dh are zero-filled by the copy (src-size 0).
// * QK^T: DHP/16 wgmma.m64n64k16 per warpgroup, q and K both read from
//   shared memory by descriptor (K-major). PV: 4 wgmma.m64nDHPk16, e from
//   registers (the score accumulators' layout is the A fragment's) and V
//   by descriptor (MN-major, transposed by the instruction). Each product
//   is retired (wgmma.wait_group 0) in its own tile, PV at the tile's end.
//   The descriptors are written out in PTX (smem_desc).
// * Why PV is not left in flight across the next tile's barrier and QK^T
//   (times in PERF.md): with o zeroed before the loop, ptxas then
//   serialized every wgmma of the loop (C7515, "non wgmma instructions
//   defining accumulator registers"); leaving o to the first PV cleared
//   that, but e's fragments, live beside the scores, spilled at the
//   128-register cap and the kernels were slower than serialized.
// * Layout: q, K and V tiles are stored in the 32-byte swizzle (blocks of
//   16 columns, rows of 32 bytes, 16-byte chunk c of row r at chunk c ^
//   ((r / 4) % 2)), which wgmma reads without bank conflicts at every DHP,
//   LoftUp's 112 included. On the H100 (chip_smoke.py): D at [2, 28672, 4,
//   101] took 0.526 ms with unswizzled 8x16-byte core matrices; A at
//   [16, 1025, 1152] 0.124 ms with the 128-byte swizzle, which only 64- and
//   128-wide rows can take (PERF.md gives this layout's times).
// * wgmma replaced a checked intermediate of the same ring with mma.sync.
//   m16n8k16 products on ldmatrix fragments: 0.152 ms at [16, 1025, 1152]
//   and 0.513 ms at D's [2, 28672, 4, 101] (PERF.md).
// * Online softmax (flash form): the running max and sum are f32; e =
//   exp(s - m_running) is rounded to bf16 as PV's operand, the sum takes
//   the f32 e, and the output is divided once, after PV. The plain version
//   rounds the normalised probabilities to bf16 instead
//   (ops/attention.py:_mha_qkv_plain, _mha_plain): the two differ by at
//   most one bf16 rounding of each term, inside the bf16 tolerance
//   1e-2 + 1e-2|x|. This is also kernel F's function
//   (scripts/bench_attn_variants.py:_kernel_nodiv), e against the running
//   max where the reference takes the row's final max.
// * kExpBf16: scores are held in log2 units (s * scale * log2 e), so the
//   argument x2 = s2 - m2 is rounded to bf16 once and raised by
//   ex2.approx.ftz.bf16x2, two exps an instruction, whose bf16 result is
//   PV's operand as it stands; the row sum adds those bf16 values in f32.
//   _kernel_nodiv rounds its argument once too, but in natural units and
//   against the final max, then takes exp in f32 and rounds e. Each
//   rounding moves the argument by up to 2^-9 |x| (x in natural units), so
//   the two e differ by up to about 2^-8 |x| exp(-|x|) <= 2^-8 / e (1.4e-3)
//   of the row's largest e, besides the rounding of e that both make:
//   within the bf16 tolerance.
// * Load paths: with kKvAsync (resp. kQoAsync) K and V (resp. q and out) go
//   through 16-byte copies and stores, which need the base, head offset and
//   row stride all multiples of 16 bytes and dh a multiple of 8; otherwise
//   the same core stages tiles with element loads (synchronous, into the
//   same ring and layout) and writes out element by element.
// * Query rows >= nq are read as zeros and never written; keys >= nk score
//   -inf. Registers are capped at 128 a thread, so that two 128-row blocks
//   share an SM; ptxas then spills in some of the wider instantiations
//   (chip_smoke.py prints its report).
//
// f32 (flash_f32): CUDA-core FMAs, no TF32 (parity with the HIGHEST-
// precision reference), register-tiled like a CUDA-core GEMM: a block of
// 8*GROUPS threads owns 4*GROUPS query rows (64 or 128); the 8 lanes of a
// row group share 4 rows, and a lane computes 4 rows x 4 keys of scores (8
// 16-byte shared loads per 64 FMAs) and accumulates 4 rows x DVP/8 output
// dims. Row max and sum are shuffles among the 8 lanes, e goes through a
// per-warp slice of shared memory with no block barrier, and the softmax is
// online in one pass over key chunks of 32, padded by 4 floats a key so
// that the lanes' e stores do not collide. Scores use dh padded to a
// multiple of 8 (DHP), the output a multiple of 32 (DVP). A thread issues
// all its loads of a K or V chunk before its first shared store, so their
// latencies overlap (one element load at a time left the FMAs waiting on
// memory). Load paths: with kKvVec (resp. kQoVec) K and V (resp. q and
// out) move as 16-byte vectors (dh % 4 == 0, or rows zero-padded past dh,
// 16-byte aligned rows); otherwise element by element, any stride and dh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// element (b, h, r, d) at p + b*batch + h*head + r*row + d
template <typename T>
struct Operand {
  T* p;
  long batch, head, row;
};

template <typename T>
struct Args {
  Operand<const T> q, k, v;  // k and v: nk rows
  Operand<T> out;            // nq rows, as q
  int nq, nk, dh;
  float scale;
};

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16 --

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d (m64n64 f32 accumulators) = or += a (m64k16, shared memory by
// descriptor, K-major) * b (k16n64, shared memory by descriptor, K-major)
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64nN f32 accumulators of this thread) += a (m64k16 bf16 fragment of
// this warp's 16 rows, in registers) * b (k16nN bf16 in shared memory, by
// descriptor); scale_d = 0 overwrites d. kTransB = 1 reads b MN-major.
template <int N, int kTransB>
struct Wgmma;

template <int kTransB>
struct Wgmma<16, kTransB> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<32, kTransB> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<64, kTransB> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<112, kTransB> {
  __device__ __forceinline__ static void run(float (&d)[56],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<128, kTransB> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(kTransB));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor for the 32-byte swizzle: rows of 32
// bytes (16 bf16) in atoms of 8 rows, 16-byte chunk c of row r at chunk
// c ^ ((r / 4) % 2) from a 256-byte aligned atom. `sbo`: bytes between
// 8-row groups (K-major) or 8-row K groups (MN-major); `lbo` (MN-major
// only): bytes between blocks of 16 columns.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 3ull << 62;
}

// 16 bytes global -> shared; only the first src_bytes (0 or 16) are read,
// the rest is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// 2^x of two bf16 values at once, each result rounded to bf16
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// WARPS warps for HP heads: each head's query tile is WARPS / (4 HP)
// warpgroups of 64 rows
template <int DHP, int WARPS, int HP = 1>
struct Bf16Tile {
  static_assert(HP == 1 || HP == 2, "one head or a pair per block");
  static_assert(WARPS % (4 * HP) == 0, "whole warpgroups per head");
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kRows = 16 * WARPS / HP;  // query rows per head
  static constexpr int kWidth = HP * DHP;        // columns staged
  static constexpr int kKeys = 64;               // keys per ring stage
  // ring stages; tile t+kStages-2 is loaded while tile t is multiplied (one
  // tile deeper, into tile t-1's stage, measured no faster on the H100)
  static constexpr int kStages = kWidth <= 64 ? 4 : 3;
  static constexpr int kTile = kKeys * kWidth;  // elements of a K or V tile
  // + 256: the base is aligned up to the swizzle atom
  static constexpr int kSmemBytes =
      (kRows * kWidth + kStages * 2 * kTile) * 2 + 256;
  // blocks per SM that keep a thread at 128 registers or fewer
  static constexpr int kMinBlocks = 65536 / (128 * kThreads);
};

// Stage ROWS rows of DHP values (rows >= valid and dims >= dh as zeros)
// from src (row stride `stride` elements) into dst in wgmma's 32-byte
// swizzled layout: blocks of 16 columns outermost, ROWS rows of 32 bytes
// each, 16-byte chunk c of row r at chunk c ^ ((r / 4) % 2). q and K are
// read from it K-major, V MN-major. Copies: lanes 2j and 2j + 1 take the
// two chunks of a row, so each 8-lane phase of a 16-byte shared store
// fills 128 contiguous bytes (no bank conflict). Element loads: lanes walk
// along a row, so that neighbouring lanes read neighbouring elements.
template <int DHP, int ROWS, int NT, bool kAsync>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long stride, int valid, int dh) {
  constexpr int C = DHP / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int h = i % 2;  // i % C is even or odd with i (C is even)
    const int r = kAsync ? (i / 2) % ROWS : i / C;
    const int blk = kAsync ? i / (2 * ROWS) : (i % C) / 2;
    const int c = 16 * blk + 8 * h;  // first column of the chunk
    bf16* d = dst + (blk * ROWS + r) * 16 + (h ^ ((r >> 2) & 1)) * 8;
    if constexpr (kAsync) {
      const bool ok = r < valid && c < dh;
      cp_async16(d, ok ? src + r * stride + c : src, ok ? 16 : 0);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src) +
                                r * stride;
      uint32_t w4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = c + 2 * j;
        const uint32_t lo = r < valid && x < dh ? s[x] : 0u;
        const uint32_t hi = r < valid && x + 1 < dh ? s[x + 1] : 0u;
        w4[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  }
}

template <int DHP, int WARPS, bool kKvAsync, bool kQoAsync, int HP = 1,
          bool kExpBf16 = false>
__device__ __forceinline__ void flash_bf16(const Args<bf16>& a) {
  using C = Bf16Tile<DHP, WARPS, HP>;
  constexpr int KT = C::kKeys, S = C::kStages, NT = C::kThreads;
  constexpr int W = C::kWidth, BLK = DHP / 16;  // 16-column blocks a head
  extern __shared__ uint4 smem_bf16[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_bf16);  // kRows x W
  q_s += ((256 - (smem_addr(q_s) & 255)) & 255) / 2;  // swizzle atom
  bf16* ring = q_s + C::kRows * W;  // S x (k, v), KT x W each

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warpgroup's head of the block and 64-row slice of its query tile
  // (constants for one head, which saves registers)
  const int hh = HP == 1 ? 0 : warp / 4 / (WARPS / 4 / HP);
  const int wr = HP == 1 ? warp / 4 : warp / 4 % (WARPS / 4 / HP);
  const int q0 = blockIdx.x * C::kRows;
  const int h0 = blockIdx.y * HP;  // the block's first head
  const int b = blockIdx.z;
  const bf16* qg = a.q.p + b * a.q.batch + h0 * a.q.head + q0 * a.q.row;
  const bf16* kg = a.k.p + b * a.k.batch + h0 * a.k.head;
  const bf16* vg = a.v.p + b * a.v.batch + h0 * a.v.head;
  const int width = HP == 1 ? a.dh : W;  // valid columns staged
  const int ntiles = (a.nk + KT - 1) / KT;
  const float sl2 = a.scale * kLog2e;  // scores in log2 units

  auto load_kv = [&](int t) {
    const int k0 = t * KT, valid = min(KT, a.nk - k0);
    bf16* ks = ring + (t % S) * 2 * C::kTile;
    stage_tile<W, KT, NT, kKvAsync>(ks, kg + k0 * a.k.row, a.k.row, valid,
                                    width);
    stage_tile<W, KT, NT, kKvAsync>(ks + C::kTile, vg + k0 * a.v.row,
                                    a.v.row, valid, width);
  };

  // prologue: q joins the first group, then tiles 0 .. S-3
  stage_tile<W, C::kRows, NT, kQoAsync>(q_s, qg, a.q.row,
                                        min(C::kRows, a.nq - q0), width);
#pragma unroll
  for (int t = 0; t < S - 2; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  // this warpgroup's 64 query rows: QK^T's A operand, by descriptor. Head
  // hh's columns are the stages' 16-column blocks BLK*hh .. BLK*hh + BLK-1
  const bf16* q_wg = q_s + (hh * BLK * C::kRows + wr * 64) * 16;
  // accumulators: for 8-column block j, [4j], [4j+1] hold row lane/4 and
  // [4j+2], [4j+3] row lane/4 + 8 of the warp's 16, columns 8j + 2(lane%4)
  // and the next
  float o[DHP / 2];
#pragma unroll
  for (int j = 0; j < DHP / 2; ++j) o[j] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums

  // PV's A fragments: e of tile t as bf16 pairs, read by the PV of tile t
  // while it is in flight
  uint32_t pa[KT / 16][4];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<S - 3>();  // this thread's copies of tile t have landed
    // make them (and element stores) visible to wgmma's reads, then wait
    // for everyone's; every warpgroup has also finished the PV of tile t-2,
    // so that tile's stage is free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + S - 2 < ntiles) load_kv(t + S - 2);
    cp_async_commit();
    // this warpgroup's head in the stage: its K and V column blocks
    const bf16* k_s = ring + (t % S) * 2 * C::kTile + hh * BLK * KT * 16;
    const bf16* v_s = k_s + C::kTile;
    const int k0 = t * KT;

    // S = Q K^T: DHP/16 steps of m64n64k16, both operands K-major
    float s[KT / 2];
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BLK; ++ks)  // a k-step is a 16-column block
      wgmma_ss64(s, smem_desc(q_wg + ks * C::kRows * 16, 16, 256),
                 smem_desc(k_s + ks * KT * 16, 16, 256), ks);
    wgmma_commit();
    wgmma_wait();
    pin(s);
    pin(o);
    pin(pa);

    const bool ragged = k0 + KT > a.nk;  // the last tile only
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        float& x = s[4 * j + e];
        x = ragged && key >= a.nk ? -INFINITY : x * sl2;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a valid key, so m_new is finite; on the first tile
      // m_r = -inf and corr = 0
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = ex2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      o[4 * j] *= corr[0], o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1], o[4 * j + 3] *= corr[1];
    }
    // e as bf16 pairs, already laid out as PV's A fragments: keys 16kt ..
    // 16kt + 15 are score blocks 2kt and 2kt + 1
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      uint32_t e01, e23;
      if constexpr (kExpBf16) {  // the argument rounded once, packed ex2
        e01 = ex2_bf16x2(pack_bf16(s[4 * j] - m_r[0], s[4 * j + 1] - m_r[0]));
        e23 = ex2_bf16x2(
            pack_bf16(s[4 * j + 2] - m_r[1], s[4 * j + 3] - m_r[1]));
        const float2 f01 = unpack_bf16(e01), f23 = unpack_bf16(e23);
        l_r[0] += f01.x + f01.y;
        l_r[1] += f23.x + f23.y;
      } else {
        const float e0 = ex2(s[4 * j] - m_r[0]);
        const float e1 = ex2(s[4 * j + 1] - m_r[0]);
        const float e2 = ex2(s[4 * j + 2] - m_r[1]);
        const float e3 = ex2(s[4 * j + 3] - m_r[1]);
        l_r[0] += e0 + e1;
        l_r[1] += e2 + e3;
        e01 = pack_bf16(e0, e1);
        e23 = pack_bf16(e2, e3);
      }
      pa[j / 2][2 * (j % 2)] = e01;
      pa[j / 2][2 * (j % 2) + 1] = e23;
    }

    // O += E V: KT/16 steps of m64nDHPk16, E from registers, V MN-major,
    // retired before the next tile
    pin(o);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT / 16; ++kt)  // 16 keys are 16 rows of 32 B
      Wgmma<DHP, 1>::run(o, pa[kt], smem_desc(v_s + kt * 256, KT * 32, 256),
                         1);
    wgmma_commit();
    wgmma_wait();
    pin(o);
    pin(pa);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  const int row0 = q0 + 64 * wr + 16 * (warp % 4) + (lane >> 2);
  bf16* og = a.out.p + b * a.out.batch + (h0 + hh) * a.out.head;
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (col >= a.dh) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.nq) continue;
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      bf16* dst = og + row * a.out.row + col;
      if constexpr (kQoAsync) {  // dh % 8 == 0: both columns are in
        *reinterpret_cast<__nv_bfloat162*>(dst) = v2;
      } else {
        dst[0] = v2.x;
        if (col + 1 < a.dh) dst[1] = v2.y;
      }
    }
  }
}

// ------------------------------------------------------------------- f32 --

// GROUPS row groups of 8 lanes for HP heads, GROUPS / HP a head
template <int DHP, int GROUPS, int HP = 1>
struct F32Tile {
  static_assert(HP == 1 || (HP == 2 && DHP % 32 == 0 && GROUPS % 2 == 0),
                "a pair of heads stages whole 32-float V rows");
  static constexpr int kThreads = 8 * GROUPS;
  static constexpr int kRows = 4 * GROUPS / HP;  // query rows per head
  static constexpr int kKeys = 32;  // keys per chunk: 8 key lanes x 4
  static constexpr int QS = DHP + 4;                // q row stride
  static constexpr int KS = HP * DHP + 4;           // k row stride
  static constexpr int DVP = (DHP + 31) / 32 * 32;  // a head's v columns
  static constexpr int VS = HP * DVP;               // v row stride
  static constexpr int NJ = DVP / 32;               // float4 output groups
  static constexpr int PS = 4 * GROUPS + 4;         // e row stride (per key)
  static constexpr int kSmemBytes =
      (HP * kRows * QS + kKeys * KS + kKeys * VS + kKeys * PS) * 4;
  static constexpr int kMinBlocks = 65536 / (128 * kThreads);
};

// Stage ROWS rows of W floats (rows >= valid and dims >= dh as zeros) from
// src (row stride `stride`) into dst (row stride LD): every load of the
// thread is issued before the first store, so their latencies overlap.
// kVec: 16-byte loads (dh % 4 == 0 or rows zero-padded past dh, 16-byte
// aligned rows); otherwise element loads.
template <int W, int LD, int ROWS, int NT, bool kVec>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long stride, int valid, int dh) {
  constexpr int kChunks = W / 4, kTotal = ROWS * kChunks;
  constexpr int kIters = (kTotal + NT - 1) / NT;
  float4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((kTotal % NT == 0 || i < kTotal) && r < valid) {
      const float* row = src + r * stride;
      if constexpr (kVec) {
        if (c < dh) x = *reinterpret_cast<const float4*>(row + c);
      } else {
        if (c < dh) x.x = row[c];
        if (c + 1 < dh) x.y = row[c + 1];
        if (c + 2 < dh) x.z = row[c + 2];
        if (c + 3 < dh) x.w = row[c + 3];
      }
    }
    buf[it] = x;
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * NT;
    if (kTotal % NT == 0 || i < kTotal)
      *reinterpret_cast<float4*>(dst + (i / kChunks) * LD +
                                 (i % kChunks) * 4) = buf[it];
  }
}

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

template <int DHP, int GROUPS, bool kKvVec, bool kQoVec, int HP = 1>
__device__ __forceinline__ void flash_f32(const Args<float>& a) {
  using C = F32Tile<DHP, GROUPS, HP>;
  constexpr int G = GROUPS / HP, KC = C::kKeys, QS = C::QS, KS = C::KS;
  constexpr int DVP = C::DVP, VS = C::VS, PS = C::PS, NT = C::kThreads;
  extern __shared__ float4 smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32);  // [HP][kRows][QS]
  float* k_s = q_s + HP * C::kRows * QS;            // [KC][KS]
  float* v_s = k_s + KC * KS;                       // [KC][VS]
  float* p_s = v_s + KC * VS;                       // [KC][PS]

  const int tx = threadIdx.x & 7;   // key and dim lane of the row group
  const int ty = threadIdx.x >> 3;  // row group
  const int hh = ty / G;            // of head hh of the block
  const int gy = ty % G;            // its rows gy + G*rr
  const int q0 = blockIdx.x * C::kRows;
  const int h0 = blockIdx.y * HP;  // the block's first head
  const int b = blockIdx.z;
  const float* qg = a.q.p + b * a.q.batch + h0 * a.q.head + q0 * a.q.row;
  const float* kg = a.k.p + b * a.k.batch + h0 * a.k.head;
  const float* vg = a.v.p + b * a.v.batch + h0 * a.v.head;
  const int width = HP == 1 ? a.dh : HP * DHP;  // valid K/V columns staged

  {  // q, once: a plain loop (its loads need not be batched)
    constexpr int kChunks = DHP / 4;
    const int valid = min(C::kRows, a.nq - q0);
    for (int i = threadIdx.x; i < HP * C::kRows * kChunks; i += NT) {
      const int r = i / kChunks % C::kRows, c = (i % kChunks) * 4;
      const int qh = i / (kChunks * C::kRows);  // head of the block
      const float* row = qg + qh * a.q.head + r * a.q.row;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) {
        if constexpr (kQoVec) {
          if (c < a.dh) x = *reinterpret_cast<const float4*>(row + c);
        } else {
          if (c < a.dh) x.x = row[c];
          if (c + 1 < a.dh) x.y = row[c + 1];
          if (c + 2 < a.dh) x.z = row[c + 2];
          if (c + 3 < a.dh) x.w = row[c + 3];
        }
      }
      *reinterpret_cast<float4*>(q_s + (qh * C::kRows + r) * QS + c) = x;
    }
  }

  // this row group's head: its q rows and its K and V columns
  const float* q_me = q_s + (hh * C::kRows + gy) * QS;
  const float* k_me = k_s + hh * DHP;
  const float* v_me = v_s + hh * DVP;

  float o[4][C::NJ * 4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int e = 0; e < C::NJ * 4; ++e) o[rr][e] = 0.f;
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) m[rr] = -INFINITY, l[rr] = 0.f;

  for (int c0 = 0; c0 < a.nk; c0 += KC) {
    __syncthreads();  // q staged / the previous chunk's reads are done
    const int valid = min(KC, a.nk - c0);
    stage_f32<HP * DHP, KS, KC, NT, kKvVec>(k_s, kg + c0 * a.k.row,
                                            a.k.row, valid, width);
    stage_f32<VS, VS, KC, NT, kKvVec>(v_s, vg + c0 * a.v.row, a.v.row,
                                      valid, width);
    __syncthreads();

    // scores of rows (gy + G*rr) against chunk keys (tx + 8*kk)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) s[rr][kk] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DHP; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(k_me + (tx + 8 * kk) * KS +
                                                  d);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 qf =
            *reinterpret_cast<const float4*>(q_me + G * rr * QS + d);
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
      const bool ok = tx + 8 * kk < valid;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        s[rr][kk] = ok ? s[rr][kk] * a.scale : -INFINITY;
    }

    // online softmax: the chunk holds a valid key, so m_new is finite; on
    // the first chunk m = -inf and corr = 0
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float t =
          fmaxf(fmaxf(s[rr][0], s[rr][1]), fmaxf(s[rr][2], s[rr][3]));
      const float m_new = fmaxf(m[rr], group_max(t));
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
      for (int e = 0; e < C::NJ * 4; ++e) o[rr][e] *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      *reinterpret_cast<float4*>(p_s + (tx + 8 * kk) * PS + ty * 4) =
          make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
    __syncwarp();  // the row group's e are all written (one warp)
#pragma unroll 4
    for (int key = 0; key < KC; ++key) {
      const float4 pv =
          *reinterpret_cast<const float4*>(p_s + key * PS + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(v_me + key * VS + tx * 4 + 32 * j);
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

  float* og = a.out.p + b * a.out.batch + (h0 + hh) * a.out.head;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + gy + G * rr;
    if (row >= a.nq) continue;
    const float inv = 1.f / l[rr];
    float* dst = og + row * a.out.row;
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int d = tx * 4 + 32 * j;
      const float4 x = make_float4(o[rr][4 * j] * inv, o[rr][4 * j + 1] * inv,
                                   o[rr][4 * j + 2] * inv,
                                   o[rr][4 * j + 3] * inv);
      if constexpr (kQoVec) {  // dh % 4 == 0: all four or none
        if (d < a.dh) *reinterpret_cast<float4*>(dst + d) = x;
      } else {
        if (d < a.dh) dst[d] = x.x;
        if (d + 1 < a.dh) dst[d + 1] = x.y;
        if (d + 2 < a.dh) dst[d + 2] = x.z;
        if (d + 3 < a.dh) dst[d + 3] = x.w;
      }
    }
  }
}

// ---------------------------------------------------------------- launch --

// One launch of `kernel` over (query tiles, heads, batch); sets the dynamic
// shared-memory limit first unless `attr_set` (the caller keeps one flag
// per kernel instantiation).
template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, bool& attr_set, int smem_bytes,
                   int threads, int rows, int heads, int batch,
                   const Args<T>& a, cudaStream_t stream) {
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.nq + rows - 1) / rows, heads, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The head widths the kernels are built for: dh zero-padded to a multiple
// of 16 (bf16, the tensor cores' depth) or of 8 (f32 scores).
__host__ __device__ constexpr int bf16_dhp(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 112 ? 112
                                                                   : 128;
}
__host__ __device__ constexpr int f32_dhp(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 104 ? 104 : 128;
}

// Launch instantiation K::launch<DHP, 64- or 128-row tile, aligned> of a
// kernel family K (each .cu names its own __global__ kernels, so that a
// profile tells A from D) for a.dh, q_tile and the load path.
template <class K, typename T>
cudaError_t dispatch(const Args<T>& a, int heads, int batch, int q_tile,
                     bool aligned, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int dhp = kBf16 ? bf16_dhp(a.dh) : f32_dhp(a.dh);
  auto go = [&](auto dhp_c) -> cudaError_t {
    constexpr int D = decltype(dhp_c)::value;
    if (q_tile == 128)
      return aligned ? K::template launch<D, 128, true>(a, heads, batch, s)
                     : K::template launch<D, 128, false>(a, heads, batch, s);
    return aligned ? K::template launch<D, 64, true>(a, heads, batch, s)
                   : K::template launch<D, 64, false>(a, heads, batch, s);
  };
  using std::integral_constant;
  switch (dhp) {
    case 16: if constexpr (kBf16) return go(integral_constant<int, 16>{});
             break;
    case 32: return go(integral_constant<int, 32>{});
    case 64: return go(integral_constant<int, 64>{});
    case 104: if constexpr (!kBf16) return go(integral_constant<int, 104>{});
              break;
    case 112: if constexpr (kBf16) return go(integral_constant<int, 112>{});
              break;
    case 128: return go(integral_constant<int, 128>{});
  }
  return cudaErrorInvalidValue;
}

// A packed qkv [batch, n, 3*heads*dh] (q, k, v at column offsets 0, C, 2C
// with C = heads*dh; head h at h*dh inside each) and out [batch, n, C], as
// the core's strided operands (kernels A, F and G)
template <typename T>
Args<T> packed_args(const void* qkv, void* out, int n, int heads, int dh,
                    float scale) {
  const long c = (long)heads * dh, rs = 3 * c;
  const T* base = static_cast<const T*>(qkv);
  Args<T> a;
  a.q = {base, n * rs, dh, rs};
  a.k = {base + c, n * rs, dh, rs};
  a.v = {base + 2 * c, n * rs, dh, rs};
  a.out = {static_cast<T*>(out), n * c, dh, c};
  a.nq = a.nk = n;
  a.dh = dh;
  a.scale = scale;
  return a;
}

// whether a pointer and element offsets allow 16-byte copies
__host__ __forceinline__ bool aligned16(const void* p, long elem_bytes,
                                        long a, long b, long c) {
  const long m = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && a % m == 0 &&
         b % m == 0 && c % m == 0;
}

}  // namespace flash
