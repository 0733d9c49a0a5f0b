// Kernel D: multi-head cross-attention for Hopper (sm_90a), f32 and bf16,
// on the shared flash core (flash_core.cuh).
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/attention.py:_mha_pallas
// (kernel _attn_kernel, pallas_call at :319), the general attention of
// ops/attention.py:mha that carries LoftUp's coordinate cross-attention:
//     out[b, i, h, :] = sum_j softmax_j(q[b,i,h] . k[b,j,h] * scale) v[b,j,h]
// over q [B, Nq, H, dh] and k, v with Nk rows (any Nq, Nk; dh <= 128), with
// f32 scores, softmax and accumulation and the output in q's dtype.
//
// Bound on this card: 4*B*H*Nq*Nk*dh operations at the bf16 tensor-core or
// f32 CUDA-core rate, and B*H*Nq*Nk exps. LoftUp's slab at B=2 (q
// [2, 28672, 4, 101], k/v [2, 1024, 4, 101]) is 9.49e10 operations: 0.0960
// ms in bf16 (exps 0.0602, bytes 0.029) and 1.416 ms in f32.
//
// Design. LoftUp has ~28k queries per slab against 1k keys, so a block owns
// a query tile (64 or 128 rows, picked by the wrapper) for the whole key
// range and streams K and V; q is read exactly once.
// * dh = 101 puts a row at 202 bytes (404 in f32) and a head at h*202: no
//   16-byte (or 4-byte) load of q, k or v is aligned. So the wrapper relays
//   K and V once per call into a zero-padded head-major scratch
//   [2, B, H, Nk, 112] in bf16 ([..., 104] in f32: rows rounded up to
//   whole 32-byte sectors), which every query tile re-reads through 16-byte
//   loads: the cp.async ring in bf16, vector loads in f32. At the LoftUp
//   loop's batch of 8 the bf16 scratch is 14.7 MB against 185 MB of q. q
//   is staged with element loads and out written
//   with element stores unless dh % 8 (f32: 4) == 0 and the pointers are
//   16-byte aligned, when they take 16-byte copies too.
// * bf16: the flash core's tensor-core path at DHP = 112 (7 k-steps of 16:
//   11% wasted products, against 27% at 128). K/V re-reads: each 128-row
//   tile reads its head's 1024 x 112 x 2 x 2 B = 459 KB from L2, 0.82 GB
//   for the 1792 tiles at B=2: about 0.1 ms at L2 rates, the same order as
//   the product bound (0.096 ms), so L2 reads and products share the limit
//   at this shape.
// * f32: the flash core's register-tiled CUDA-core path (this kernel's
//   tiling since it was ported), one pass.

#include "flash_core.cuh"

namespace {

using flash::Args;
using flash::bf16;

template <int DHP, int WARPS, bool kQoAsync>
__global__ void __launch_bounds__(flash::Bf16Tile<DHP, WARPS>::kThreads,
                                  flash::Bf16Tile<DHP, WARPS>::kMinBlocks)
mha_kernel_bf16(const Args<bf16> a) {
  flash::flash_bf16<DHP, WARPS, true, kQoAsync>(a);
}

template <int DHP, int GROUPS, bool kQoVec>
__global__ void __launch_bounds__(flash::F32Tile<DHP, GROUPS>::kThreads,
                                  flash::F32Tile<DHP, GROUPS>::kMinBlocks)
mha_kernel_f32(const Args<float> a) {
  flash::flash_f32<DHP, GROUPS, true, kQoVec>(a);
}

// kernel D's instantiations: K and V always from the aligned scratch, q and
// out on the aligned path or not
struct KernelD {
  template <int DHP, int ROWS, bool kAligned>
  static cudaError_t launch(const Args<bf16>& a, int heads, int batch,
                            cudaStream_t s) {
    using C = flash::Bf16Tile<DHP, ROWS / 16>;
    static bool attr_set = false;
    return flash::launch(mha_kernel_bf16<DHP, ROWS / 16, kAligned>, attr_set,
                         C::kSmemBytes, C::kThreads, C::kRows, heads, batch,
                         a, s);
  }
  template <int DHP, int ROWS, bool kAligned>
  static cudaError_t launch(const Args<float>& a, int heads, int batch,
                            cudaStream_t s) {
    using C = flash::F32Tile<DHP, ROWS / 4>;
    static bool attr_set = false;
    return flash::launch(mha_kernel_f32<DHP, ROWS / 4, kAligned>, attr_set,
                         C::kSmemBytes, C::kThreads, C::kRows, heads, batch,
                         a, s);
  }
};

template <typename T>
Args<T> mha_args(const void* q, const void* k, const void* v, void* out,
                 int nq, int nk, int heads, int dh, long kv_batch,
                 long kv_head, long kv_row, float scale) {
  const long rs = (long)heads * dh;  // row stride of q and out
  Args<T> a;
  a.q = {static_cast<const T*>(q), nq * rs, dh, rs};
  a.k = {static_cast<const T*>(k), kv_batch, kv_head, kv_row};
  a.v = {static_cast<const T*>(v), kv_batch, kv_head, kv_row};
  a.out = {static_cast<T*>(out), nq * rs, dh, rs};
  a.nq = nq, a.nk = nk, a.dh = dh, a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// q, out [batch, nq, heads, dh], contiguous; k and v with nk rows, element
// (b, h, r, d) at k + b*kv_batch + h*kv_head + r*kv_row + d (v alike): the
// wrapper's head-major scratch: 16-byte aligned rows, zero past dh, of at
// least dh rounded up to a 16-byte chunk (8 bf16, 4 floats), which is all
// the kernel reads. All of one dtype: 0 = float32, 1 = bfloat16.
// aligned
// = 1 also takes q and out through 16-byte copies (dh a multiple of 8 in
// bf16, 4 in f32; pointers 16-byte aligned). q_tile: query rows per block,
// 64 or 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for what
// the kernel does not take.
int iseg_mha(const void* q, const void* k, const void* v, void* out,
             int batch, int nq, int nk, int heads, int dh, long kv_batch,
             long kv_head, long kv_row, float scale, int dtype, int q_tile,
             int aligned, void* stream) {
  if (batch < 1 || nq < 1 || nk < 1 || heads < 1 || dh < 1 || dh > 128 ||
      batch > 65535 || heads > 65535 || (q_tile != 64 && q_tile != 128) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rs = (long)heads * dh;  // row stride of q and out
  const long elem = dtype == 1 ? 2 : 4, vec = 16 / elem;
  if (kv_row < (dh + vec - 1) / vec * vec ||
      !flash::aligned16(k, elem, kv_batch, kv_head, kv_row) ||
      !flash::aligned16(v, elem, kv_batch, kv_head, kv_row) ||
      (aligned && !(flash::aligned16(q, elem, dh, rs, 0) &&
                    flash::aligned16(out, elem, dh, rs, 0))))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)flash::dispatch<KernelD>(
        mha_args<bf16>(q, k, v, out, nq, nk, heads, dh, kv_batch, kv_head,
                       kv_row, scale),
        heads, batch, q_tile, aligned, s);
  return (int)flash::dispatch<KernelD>(
      mha_args<float>(q, k, v, out, nq, nk, heads, dh, kv_batch, kv_head,
                      kv_row, scale),
      heads, batch, q_tile, aligned, s);
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
