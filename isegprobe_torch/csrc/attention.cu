// Kernel A: packed-qkv multi-head self-attention for Hopper (sm_90a), f32
// and bf16, on the shared flash core (flash_core.cuh).
//
// Replaces the Pallas TPU kernels isegprobe_tpu/ops/attention.py:
// _mha_qkv_pallas_pairs (two dh=64 heads per grid step, pallas_call at :172)
// and _mha_qkv_pallas (any dh via a transpose, :97). Both compute
//     out[b, i, h*dh:(h+1)*dh] = softmax_j(q_i . k_j * scale) v_j
// over a packed qkv [B, N, 3C] (q, k, v at column offsets 0, C, 2C; head h at
// h*dh inside each) and write [B, N, C]; they differ only in TPU lane layout.
// Here q, k and v are strided operands of the packed tensor (row stride 3C,
// head offset h*dh) for any dh <= 128, and the output is written in place:
// no relayout, no padding copy.
//
// Bound on this card: 4*B*H*N^2*dh operations at the bf16 tensor-core rate
// or the f32 CUDA-core rate, and B*H*N^2 exps; at [16, 1025, 1152] bf16 the
// products (0.0261 ms) and the exps (0.0259 ms) bound it together. The
// flash core's note says what the design does about them: bf16 on wgmma
// tensor cores over a cp.async K/V ring, f32 on register-tiled FMAs.
//
// Instantiations: bf16 at DHP in {16, 32, 64, 112, 128}, f32 at DHP in {32,
// 64, 104, 128}, each x query tiles of 64 and 128 rows x the 16-byte path
// (16-byte aligned pointers and dh % 8 == 0 in bf16, % 4 in f32) or the
// element-load path (any dh, e.g. 13).

#include "flash_core.cuh"

namespace {

using flash::Args;
using flash::bf16;

template <int DHP, int WARPS, bool kAsync>
__global__ void __launch_bounds__(flash::Bf16Tile<DHP, WARPS>::kThreads,
                                  flash::Bf16Tile<DHP, WARPS>::kMinBlocks)
attn_qkv_bf16(const Args<bf16> a) {
  flash::flash_bf16<DHP, WARPS, kAsync, kAsync>(a);
}

template <int DHP, int GROUPS, bool kVec>
__global__ void __launch_bounds__(flash::F32Tile<DHP, GROUPS>::kThreads,
                                  flash::F32Tile<DHP, GROUPS>::kMinBlocks)
attn_qkv_f32(const Args<float> a) {
  flash::flash_f32<DHP, GROUPS, kVec, kVec>(a);
}

// kernel A's instantiations: q, k, v and out all on the aligned path or not
struct KernelA {
  template <int DHP, int ROWS, bool kAligned>
  static cudaError_t launch(const Args<bf16>& a, int heads, int batch,
                            cudaStream_t s) {
    using C = flash::Bf16Tile<DHP, ROWS / 16>;
    static bool attr_set = false;
    return flash::launch(attn_qkv_bf16<DHP, ROWS / 16, kAligned>, attr_set,
                         C::kSmemBytes, C::kThreads, C::kRows, heads, batch,
                         a, s);
  }
  template <int DHP, int ROWS, bool kAligned>
  static cudaError_t launch(const Args<float>& a, int heads, int batch,
                            cudaStream_t s) {
    using C = flash::F32Tile<DHP, ROWS / 4>;
    static bool attr_set = false;
    return flash::launch(attn_qkv_f32<DHP, ROWS / 4, kAligned>, attr_set,
                         C::kSmemBytes, C::kThreads, C::kRows, heads, batch,
                         a, s);
  }
};

}  // namespace

extern "C" {

// qkv [batch, n, 3*heads*dh] and out [batch, n, heads*dh], both contiguous,
// of one dtype: 0 = float32, 1 = bfloat16. q_tile: query rows per block, 64
// or 128. aligned = 1 takes the 16-byte path (cp.async in bf16, vector
// loads in f32; needs dh a multiple of 16 bytes' worth of elements, 8 in
// bf16 and 4 in f32, and both pointers 16-byte aligned), 0 element loads.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what the kernel
// does not take.
int iseg_attention_qkv(const void* qkv, void* out, int batch, int n,
                       int heads, int dh, float scale, int dtype, int q_tile,
                       int aligned, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || dh < 1 || dh > 128 ||
      batch > 65535 || heads > 65535 || (q_tile != 64 && q_tile != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long elem = dtype == 1 ? 2 : 4;
  if (aligned && !(flash::aligned16(qkv, elem, dh, 3L * heads * dh, 0) &&
                   flash::aligned16(out, elem, dh, (long)heads * dh, 0)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)flash::dispatch<KernelA>(
        flash::packed_args<bf16>(qkv, out, n, heads, dh, scale), heads, batch,
        q_tile, aligned, s);
  if (dtype == 0)
    return (int)flash::dispatch<KernelA>(
        flash::packed_args<float>(qkv, out, n, heads, dh, scale), heads, batch,
        q_tile, aligned, s);
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
