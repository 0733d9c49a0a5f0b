// The attention variants of the sweep for Hopper (sm_90a): kernel F (nodiv)
// and kernel G (merged), f32 and bf16, with an optional bf16 exp, on the
// shared flash core (flash_core.cuh).
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
// Design. That function is the flash core's own (online softmax, e rounded
// to bf16 as PV's operand, one division after PV), so both kernels are the
// core's instantiations on kernel A's strided operands of the packed qkv,
// under names of their own so that a profile tells them from A:
// * kernel F: one head per block, the core as kernel A runs it at the same
//   query tile on the 16-byte path; with an f32 exp its output equals A's
//   bit for bit. The bf16 exp is the core's kExpBf16.
// * kernel G: one block per (query tile, head pair, batch), which stages the
//   pair's 128 contiguous columns of q, K and V once (the core's HP = 2) and
//   computes each head from its half in its own warpgroups (bf16) or lane
//   groups (f32), exactly as F does: G's output equals F's bit for bit at
//   the same tile and exp. That shared staging is what the merged variant
//   tests; its block-diagonal product would waste half of the tensor cores'
//   products, so G does not copy it.
// * Query tiles of 64 or 128 rows per head (a wgmma warpgroup takes 64). G's
//   bf16 blocks are 2 or 4 warpgroups with 128 staged columns: at 64 rows
//   the 3-stage ring and q take 112 KB, two blocks an SM (4 stages, 144 KB,
//   would allow one); at 128 rows 128 KB, one block of 512 threads.
// Instantiations: bf16 {F, G} x {64, 128} x {f32, bf16 exp} and f32 {F, G} x
// {64, 128}, all on the 16-byte path (the wrapper passes 16-byte aligned
// tensors only).

#include "flash_core.cuh"

namespace {

using flash::Args;
using flash::bf16;

constexpr int kDh = 64;

template <int WARPS, bool kExpBf16>
__global__ void __launch_bounds__(flash::Bf16Tile<kDh, WARPS>::kThreads,
                                  flash::Bf16Tile<kDh, WARPS>::kMinBlocks)
attn_nodiv_bf16(const Args<bf16> a) {
  flash::flash_bf16<kDh, WARPS, true, true, 1, kExpBf16>(a);
}

template <int WARPS, bool kExpBf16>
__global__ void __launch_bounds__(flash::Bf16Tile<kDh, WARPS, 2>::kThreads,
                                  flash::Bf16Tile<kDh, WARPS, 2>::kMinBlocks)
attn_merged_bf16(const Args<bf16> a) {
  flash::flash_bf16<kDh, WARPS, true, true, 2, kExpBf16>(a);
}

template <int GROUPS>
__global__ void __launch_bounds__(flash::F32Tile<kDh, GROUPS>::kThreads,
                                  flash::F32Tile<kDh, GROUPS>::kMinBlocks)
attn_nodiv_f32(const Args<float> a) {
  flash::flash_f32<kDh, GROUPS, true, true>(a);
}

template <int GROUPS>
__global__ void __launch_bounds__(flash::F32Tile<kDh, GROUPS, 2>::kThreads,
                                  flash::F32Tile<kDh, GROUPS, 2>::kMinBlocks)
attn_merged_f32(const Args<float> a) {
  flash::flash_f32<kDh, GROUPS, true, true, 2>(a);
}

// HP heads per block (1: F, 2: G), ROWS query rows per head
template <int HP, int ROWS, bool kExpBf16>
cudaError_t launch_bf16(const Args<bf16>& a, int heads, int batch,
                        cudaStream_t s) {
  constexpr int WARPS = HP * ROWS / 16;
  using C = flash::Bf16Tile<kDh, WARPS, HP>;
  static bool attr_set = false;
  auto kernel = [] {
    if constexpr (HP == 1) return attn_nodiv_bf16<WARPS, kExpBf16>;
    else return attn_merged_bf16<WARPS, kExpBf16>;
  }();
  return flash::launch(kernel, attr_set, C::kSmemBytes, C::kThreads, C::kRows,
                       heads / HP, batch, a, s);
}

template <int HP, int ROWS>
cudaError_t launch_f32(const Args<float>& a, int heads, int batch,
                       cudaStream_t s) {
  constexpr int GROUPS = HP * ROWS / 4;
  using C = flash::F32Tile<kDh, GROUPS, HP>;
  static bool attr_set = false;
  auto kernel = [] {
    if constexpr (HP == 1) return attn_nodiv_f32<GROUPS>;
    else return attn_merged_f32<GROUPS>;
  }();
  return flash::launch(kernel, attr_set, C::kSmemBytes, C::kThreads, C::kRows,
                       heads / HP, batch, a, s);
}

template <int HP>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads,
                   float scale, int dtype, int exp_bf16, int q_tile,
                   cudaStream_t s) {
  if (dtype == 0) {
    const Args<float> a =
        flash::packed_args<float>(qkv, out, n, heads, kDh, scale);
    return q_tile == 64 ? launch_f32<HP, 64>(a, heads, batch, s)
                        : launch_f32<HP, 128>(a, heads, batch, s);
  }
  const Args<bf16> a = flash::packed_args<bf16>(qkv, out, n, heads, kDh, scale);
  if (q_tile == 64)
    return exp_bf16 ? launch_bf16<HP, 64, true>(a, heads, batch, s)
                    : launch_bf16<HP, 64, false>(a, heads, batch, s);
  return exp_bf16 ? launch_bf16<HP, 128, true>(a, heads, batch, s)
                  : launch_bf16<HP, 128, false>(a, heads, batch, s);
}

}  // namespace

extern "C" {

// qkv [batch, n, 3*heads*64] and out [batch, n, heads*64], contiguous and
// 16-byte aligned, of one dtype (0 = float32, 1 = bfloat16); heads even.
// merged = 0 runs kernel F, 1 kernel G; q_tile (64 or 128) is the query
// rows per block of each head. exp_bf16 = 1 takes the exp in bf16 (bf16
// only). Returns cudaGetLastError(), or cudaErrorInvalidValue for what the
// kernels do not take.
int iseg_attn_variant(const void* qkv, void* out, int batch, int n, int heads,
                      float scale, int dtype, int exp_bf16, int merged,
                      int q_tile, void* stream) {
  const long elem = dtype == 1 ? 2 : 4;
  if (batch < 1 || n < 1 || heads < 2 || heads % 2 || batch > 65535 ||
      heads > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && exp_bf16) || (q_tile != 64 && q_tile != 128) ||
      !flash::aligned16(qkv, elem, kDh, 3L * heads * kDh, 0) ||
      !flash::aligned16(out, elem, kDh, (long)heads * kDh, 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(merged ? launch<2>(qkv, out, batch, n, heads, scale, dtype,
                                  exp_bf16, q_tile, s)
                      : launch<1>(qkv, out, batch, n, heads, scale, dtype,
                                  exp_bf16, q_tile, s));
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
