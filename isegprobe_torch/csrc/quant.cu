// Dynamic W8A8 int8 for Hopper (sm_90a): a row quantizer (kernel H) and an
// s8 tensor-core GEMM with a fused dequantizing epilogue (kernel I).
//
// Replaces no Pallas kernel. The JAX package computes int8_dynamic_matmul
// (isegprobe_tpu/ops/quant.py:44-64) as XLA ops: per-row absmax scales of
// the activations and of the weight's output channels (:54-57), then an
// int8 x int8 -> int32 dot_general and the f32 rescale (:59-64). H is the
// first part on the card and I the second, with XLA's rounding:
//     s = max(max|x_row| / 127, 1e-8)      true f32 division
//     q = rint(x / s)                       true division, half to even
//     y = (f32(acc) * sx_m) * sw_n (+ b_n)  left to right, no FMA
// written in the output dtype. Every operation is an explicitly rounded
// intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn), which nvcc never contracts
// into an FMA, so both kernels equal their plain PyTorch versions bit for
// bit (the integer sum is exact in any order).
//
// H, iseg_quantize_rows: [R, K] f32 or bf16 -> q int8 [R, K], s f32 [R].
// Bound on this card: bytes, each input read once (2 or 4 B an element),
// q written once (1 B), one scale a row; a handful of operations a byte.
// Design: one warp a row, eight rows a block; each lane loads its share of
// the row with 16-byte loads into registers (K <= 3072: 96 values a lane),
// the warp reduces the absmax with shuffles, and the row is quantized and
// written from the registers, so x is read from device memory once. The
// serving path runs H on activations only: a fixed weight's rows are
// quantized once and kept (ops/quant.py).
//
// I, iseg_int8_gemm: a [M, K] s8 (rows of x) times b [N, K] s8 (rows of the
// weight, the output channels) -> int32 on the tensor cores, then the
// epilogue above in f32, written as f32 or bf16. bias_after_cast adds the
// bias after the cast, in the output dtype (MaskCLIP's packed in_proj,
// isegprobe_tpu/models/featurizers/maskclip.py:63-72).
// Bound on this card: bytes at the flagship's shapes, and the output
// dominates them. At qkv, [16400, 384] x [1152, 384] -> bf16, the products
// take 7.3 us at 1,979 TOP/s and the bytes 13.3 us at 3.35 TB/s, of which
// the output is 37.8 of the 44.5 MB (a 6.3, b 0.4). So the design keeps
// the output streaming out and hides the rest behind it:
// * Persistent schedule: one block an SM (grid min(tiles, SMs)) takes a
//   run of consecutive 128 x 128 output tiles, N fastest, so its next tile
//   reuses the a rows it just read (from L2, not again from HBM), and its
//   loads for the next tile overlap the current tile's epilogue and store.
// * Loads: TMA (cp.async.bulk.tensor.2d) of 128-row x 128-byte K-blocks of
//   a and b into a ring of 4 stages, issued by one producer warp
//   and completed on mbarriers (full: the stage's bytes landed; empty: every
//   consumer warp's products on it retired). The tensor maps zero-fill
//   the ragged M, N and K edges (K % 32 == 0, so K = 32 or 96 read one
//   partial block). They are encoded on the host at every launch by
//   cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ parameters.
// * Products: wgmma.mma_async m64n128k32 .s32.s8.s8, both operands K-major
//   in shared memory by descriptor (the only layout s8 wgmma takes), in
//   TMA's 128-byte swizzle, which wgmma reads without bank conflicts. Two
//   consumer warpgroups take 64 rows each of a tile; a K-block's products
//   stay in flight while the next block's are issued (wait_group 1). A
//   tile's first product overwrites the accumulators (scale-d 0): zeroing
//   them with other instructions would make ptxas serialize every wgmma
//   (C7515).
// * Tile: 128 x 128 divides every N of the three towers (384, 768, 1152,
//   1536, 2304, 3072), holds 64 s32 accumulators a thread, and with 4
//   stages (128 KB) and the output staging (32 KB bf16, 64 KB f32) fits one
//   block in the SM's 227 KB. 128 x 192 tiles (96 accumulators, 6 tiles
//   across 1152) were slower on the H100 at all but two of the products
//   timed, and faster at none, in a tuning run.
// * Epilogue: a tile's sx, sw and bias are read into registers before its
//   products and staged once in shared memory (one copy a warpgroup: its
//   reads end before the barrier that closes the epilogue, and the next
//   tile's writes come after it). Each thread reads the scales it needs
//   into registers, then
//   dequantizes its accumulators with the intrinsics above into a shared
//   output tile in the 128-byte swizzle (bank-conflict free for bf16
//   pairs); the bias mode is a template argument, so the unrolled loop has
//   no branch (per-element branches, and scale reads ordered after the
//   stores, made the epilogue cost more than the products in a tuning
//   run). One thread a warpgroup writes the tile with TMA stores of 64
//   rows x 128 bytes (bulk_group), which write whole 128-byte row segments,
//   clip at the M and N edges, and drain while the warpgroup multiplies the
//   next tile; the staging tile is reused once the previous store has read
//   it (cp.async.bulk.wait_group.read). The epilogue does not overlap the
//   block's own products, and is what keeps I from its bound.
// The version this replaced (mma.sync.m16n8k32 on ldmatrix fragments, two
// cp.async stages, one tile a block, 4-byte stores straight from the
// fragments) reached 23% of the bound at qkv; PERF.md gives both versions'
// times (scripts/bench_int8.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- kernel H

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) QPack {
  int8_t v[VEC];
};

template <typename T, int VEC, int MAXV>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int rows, int k) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long)row * k;
  int8_t* qr = q + (long)row * k;

  float v[MAXV];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < MAXV / VEC; ++c) {
    const int i = (c * 32 + lane) * VEC;
    if (i < k) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[c * VEC + e] = to_f32(p.v[e]);
        amax = fmaxf(amax, fabsf(v[c * VEC + e]));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (lane == 0) s[row] = scale;

#pragma unroll
  for (int c = 0; c < MAXV / VEC; ++c) {
    const int i = (c * 32 + lane) * VEC;
    if (i < k) {
      QPack<VEC> p;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        p.v[e] = (int8_t)__float2int_rn(__fdiv_rn(v[c * VEC + e], scale));
      *reinterpret_cast<QPack<VEC>*>(qr + i) = p;
    }
  }
}

template <typename T, int VEC>
void launch_rows_vec(const void* x, void* q, void* s, int rows, int k,
                     cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (k <= 32 * 32)
    quantize_rows_kernel<T, VEC, 32><<<grid, block, 0, stream>>>(
        xp, qp, sp, rows, k);
  else
    quantize_rows_kernel<T, VEC, 96><<<grid, block, 0, stream>>>(
        xp, qp, sp, rows, k);
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, void* s, int rows, int k,
                        cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = k % vec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % vec == 0;
  if (aligned)
    launch_rows_vec<T, vec>(x, q, s, rows, k, stream);
  else
    launch_rows_vec<T, 1>(x, q, s, rows, k, stream);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- kernel I

constexpr int BM = 128, BN = 128;  // output tile (wgmma_s8 is n128)
constexpr int BK = 128;            // K-block: 128 int8 = one swizzled row
constexpr int kConsumers = 2;      // warpgroups, 64 rows of a tile each
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kScaleFloats = 64 + 2 * BN;  // sx, sw, bias of a warpgroup

// The dynamic shared memory, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
template <typename T>
struct Layout {
  static constexpr int kStages = 4;  // ring stages
  static constexpr int kABytes = BM * BK, kBBytes = BN * BK;
  static constexpr int kSubCols = 128 / sizeof(T);  // a TMA store's columns
  static constexpr int kSubs = BN / kSubCols;
  static constexpr int kSubBytes = 64 * 128;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kABytes;
  static constexpr int kOut = kB + kStages * kBBytes;  // a tile per WG
  static constexpr int kScales = kOut + kConsumers * kSubs * kSubBytes;
  static constexpr int kBars = kScales + kConsumers * kScaleFloats * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "one block an SM");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait for the phase of the given parity to complete. A wait that outlasts
// 2^26 tries (seconds; a stage waits microseconds) traps, so a lost arrival
// fails the launch at the next synchronize instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// a box of the map at (c0 = column, c1 = row) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused in this layout.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | 1ull << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// d (m64n128 s32 accumulators of this thread) = or += a (m64k32 s8) * b
// (n128k32 s8), both K-major in shared memory by descriptor; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two values cast to T (round to nearest even) and stored side by side;
// bf16 pairs are cast by one packed conversion
template <typename T>
__device__ __forceinline__ void store2(uint8_t* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(uint8_t* p, float a,
                                                      float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// How the bias enters: none, added in f32 before the cast, or (MaskCLIP's
// packed in_proj) added after it in T, as `y.astype(T) + bias.astype(T)`
enum BiasMode { kNoBias, kBiasBefore, kBiasAfter };

// One output value before its cast to T: (f32(acc) * sx) * sw, then the
// bias as kMode says (after the cast: both rounded to T first, and their
// f32 sum rounds once, in the cast).
template <typename T, int kMode>
__device__ __forceinline__ float epilogue(int acc, float sx, float sw,
                                          float b) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (kMode == kNoBias) return y;
  if (kMode == kBiasBefore) return __fadd_rn(y, b);
  return __fadd_rn(to_f32(from_f32<T>(y)), to_f32(from_f32<T>(b)));
}

// A warpgroup's 64 x BN accumulators dequantized into its shared output
// tile: boxes of 64 rows x 128 bytes, 16-byte chunk c of row r at chunk
// c ^ (r % 8) (TMA's 128-byte swizzle; bank-conflict free for bf16
// pairs). sc holds the tile's sx [64], sw [BN] and bias [BN]. The bias mode
// is a template argument so that the unrolled loop has no branch.
template <typename T, int kMode>
__device__ __forceinline__ void dequantize(const int (&acc)[BN / 2],
                                           const float* sc, uint8_t* out_s,
                                           int wrow, int t4) {
  constexpr int kSubCols = Layout<T>::kSubCols;
  // every scale this thread needs, read before its first store (a store
  // through out_s could alias sc, and would order the reads after it)
  const float sxr[2] = {sc[wrow], sc[wrow + 8]};
  float2 swc[BN / 8], bc[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    swc[j] = *reinterpret_cast<const float2*>(sc + 64 + 8 * j + 2 * t4);
    bc[j] = kMode == kNoBias ? make_float2(0.f, 0.f)
                             : *reinterpret_cast<const float2*>(
                                   sc + 64 + BN + 8 * j + 2 * t4);
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const int cb = col % kSubCols * static_cast<int>(sizeof(T));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + 8 * h;
      store2<T>(out_s + col / kSubCols * Layout<T>::kSubBytes + row * 128 +
                    ((cb >> 4 ^ (row & 7)) << 4) + (cb & 15),
                epilogue<T, kMode>(acc[4 * j + 2 * h], sxr[h], swc[j].x,
                                   bc[j].x),
                epilogue<T, kMode>(acc[4 * j + 2 * h + 1], sxr[h], swc[j].y,
                                   bc[j].y));
    }
  }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const B* __restrict__ bias, int m, int n, int k,
                 int has_bias, int bias_after) {
  using L = Layout<T>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::kBars, empty = full + S * 8;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = ((m + BM - 1) / BM) * tiles_n;
  // this block's run of consecutive tiles
  const int first = static_cast<int>((long)blockIdx.x * tiles / gridDim.x);
  const int last =
      static_cast<int>((long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int kblocks = (k + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if ((threadIdx.x & 31) == 0) {
      int it = 0;
      for (int t = first; t < last; ++t) {
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, L::kABytes + L::kBBytes);
          tma_load(base + L::kA + s * L::kABytes, &map_a, kb * BK, m0,
                   full + 8 * s);
          tma_load(base + L::kB + s * L::kBBytes, &map_b, kb * BK, n0,
                   full + 8 * s);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (tid >> 5) * 16 + g;  // this thread's first row of 64
  uint8_t* out_s = smem + L::kOut + wg * L::kSubs * L::kSubBytes;
  float* sc = reinterpret_cast<float*>(smem + L::kScales) +
              wg * kScaleFloats;
  static_assert(BN == 128, "a column of sw and bias a consumer thread");
  int acc[BN / 2];
  int it = 0;
  for (int t = first; t < last; ++t) {
    const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
    const int row0 = m0 + 64 * wg;
    // the tile's scales and bias, read while the products run
    const float sx_v = tid < 64 && row0 + tid < m ? sx[row0 + tid] : 0.f;
    const bool col_in = n0 + tid < n;
    const float sw_v = col_in ? sw[n0 + tid] : 0.f;
    const float b_v = col_in && has_bias ? to_f32(bias[n0 + tid]) : 0.f;

    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a = base + L::kA + s * L::kABytes + wg * 64 * BK;
      const uint32_t b = base + L::kB + s * L::kBBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk),
                 kb > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous K-block's products retired: its stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    if (tid < 64) sc[tid] = sx_v;
    sc[64 + tid] = sw_v;
    sc[64 + BN + tid] = b_v;
    // the previous tile's store has read the staging tile
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_bar(1 + wg);
    if (!has_bias)
      dequantize<T, kNoBias>(acc, sc, out_s, wrow, t4);
    else if (!bias_after)
      dequantize<T, kBiasBefore>(acc, sc, out_s, wrow, t4);
    else
      dequantize<T, kBiasAfter>(acc, sc, out_s, wrow, t4);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar(1 + wg);
    if (tid == 0 && row0 < m) {
#pragma unroll
      for (int sub = 0; sub < L::kSubs; ++sub)
        if (n0 + sub * L::kSubCols < n)
          tma_store(&map_out, n0 + sub * L::kSubCols, row0,
                    smem_addr(out_s + sub * L::kSubBytes));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled looked up through cudaGetDriverEntryPoint, so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of `rows` rows of `cols` elements (row pitch `pitch` bytes) in
// boxes of box_rows x 128 bytes, 128-byte swizzle; out-of-range elements
// read as zeros and are not written.
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                      const void* p, long cols, long rows, long pitch,
                      int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(p), dims, strides, box, steps,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the map of an s8 operand [rows, k]: K-blocks of 128 bytes x box_rows
cudaError_t operand_map(CUtensorMap* map, const void* p, int rows, int k,
                        int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, k, rows, k, BK,
                   box_rows);
}

template <typename T, typename B>
cudaError_t launch_gemm(const void* a, const void* b, const void* sx,
                        const void* sw, const void* bias, void* out, int m,
                        int n, int k, int has_bias, int bias_after,
                        cudaStream_t stream) {
  using L = Layout<T>;
  CUtensorMap map_a, map_b, map_out;
  cudaError_t e = operand_map(&map_a, a, m, k, BM);
  if (e != cudaSuccess) return e;
  if ((e = operand_map(&map_b, b, n, k, BN)) != cudaSuccess) return e;
  e = encode_2d(&map_out,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                out, n, m, (long)n * sizeof(T), L::kSubCols, 64);
  if (e != cudaSuccess) return e;

  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(int8_gemm_kernel<T, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAlloc);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  int8_gemm_kernel<T, B><<<tiles < sms ? tiles : sms, kThreads, L::kAlloc,
                           stream>>>(
      map_a, map_b, map_out, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const B*>(bias), m, n, k,
      has_bias, bias_after);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, k] contiguous of x_dtype (0 = float32, 1 = bfloat16), 1 <= k <=
// 3072; q [rows, k] int8 and s [rows] float32. Returns cudaGetLastError().
int iseg_quantize_rows(const void* x, void* q, void* s, int rows, int k,
                       int x_dtype, void* stream) {
  if (rows < 1 || k < 1 || k > 32 * 96) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return (int)launch_rows<float>(x, q, s, rows, k, st);
  if (x_dtype == 1)
    return (int)launch_rows<__nv_bfloat16>(x, q, s, rows, k, st);
  return (int)cudaErrorInvalidValue;
}

// a [m, k] and b [n, k] int8, contiguous, 16-byte aligned; sx [m] and sw [n]
// float32; bias [n] of bias_dtype (read only when has_bias); out [m, n] of
// out_dtype (0 = float32, 1 = bfloat16), 16-byte aligned. k % 32 == 0,
// n % 8 == 0. Returns cudaGetLastError().
int iseg_int8_gemm(const void* a, const void* b, const void* sx,
                   const void* sw, const void* bias, void* out, int m, int n,
                   int k, int out_dtype, int bias_dtype, int has_bias,
                   int bias_after, void* stream) {
  if (m < 1 || n < 8 || k < 32 || k % 32 || n % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0 && bias_dtype == 0)
    return (int)launch_gemm<float, float>(a, b, sx, sw, bias, out, m, n, k,
                                          has_bias, bias_after, st);
  if (out_dtype == 0 && bias_dtype == 1)
    return (int)launch_gemm<float, __nv_bfloat16>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  if (out_dtype == 1 && bias_dtype == 0)
    return (int)launch_gemm<__nv_bfloat16, float>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  if (out_dtype == 1 && bias_dtype == 1)
    return (int)launch_gemm<__nv_bfloat16, __nv_bfloat16>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
