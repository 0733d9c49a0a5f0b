// Kernel C: the row pass of the exact squared Euclidean distance transform,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/edt.py:_row_envelope_pallas
// (kernel _edt_row_kernel, pallas_call at :168). For every row of g
// ([rows, W] float32 vertical distances from the column pass):
//     out[j] = min(1e12, min over j' of g[j']^2 + (j - j')^2)
// Every finite value is an integer below 2^24, which float32 holds exactly,
// and min is exact in any order, so the result is bitwise equal to the plain
// version (isegprobe_torch/ops/edt.py:_row_envelope_plain), clamp included:
// for W <= 4096, d = j - j' and d*d are exact, so fmaf(d, d, g2) rounds
// d*d + g2 once, as the plain version's (j - j')^2 + g2 does.
//
// Algorithm: brute force over the sources of the row. Bounds at the device
// loop's shape (B lanes x 2 error maps x (hp+2) rows of wp+2; at B = 8 and
// 480x640 scenes rows = 8224, W = 642):
//     operations: 2 * rows * W^2 (an add and a min per candidate), 6.8e9
//                 at that shape, 0.10 ms at the 67 TFLOP/s float32 rate;
//     bytes:      8 * rows * W (read g and write out once), 42 MB, 0.013 ms.
// The kernel is held to the operation bound. A linear-time lower envelope
// (Felzenszwalb-Huttenlocher) would do O(W) work a row but runs one
// sequential chain a row; it is later work.
//
// Design: one block of 128 threads per row. The block stages the row's g^2
// in shared memory (W <= 4096 floats, 16 KB; the wrapper raises beyond, where
// (j - j')^2 would no longer be exact in float32).
// Each thread owns K output columns j = base + threadIdx.x + 128 k, keeps
// their running minima in registers, and walks all W sources, each a
// broadcast read from shared memory reused for K columns; (j - j')^2 is
// computed in registers (the TPU kernel reads it from a table in memory,
// and its sources-on-sublanes layout is a TPU matter not carried over).
// K = ceil(W / 128) up to 8; wider rows take several passes of 1024
// columns, each walking all sources again.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;
constexpr int kMaxWidth = 4096;  // (j - j')^2 exact in float32
constexpr float kBig2 = 1.0e12f;  // float32(1e12) = 999999995904

template <int K>
__global__ void __launch_bounds__(kThreads)
row_envelope_kernel(const float* __restrict__ g, float* __restrict__ out,
                    int w) {
  extern __shared__ float g2[];
  const float* grow = g + (long)blockIdx.x * w;
  float* orow = out + (long)blockIdx.x * w;
  for (int i = threadIdx.x; i < w; i += kThreads) {
    const float v = grow[i];
    g2[i] = v * v;
  }
  __syncthreads();

  for (int base = 0; base < w; base += K * kThreads) {
    float jf[K], m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      jf[k] = (float)(base + threadIdx.x + k * kThreads);
      m[k] = kBig2;
    }
    float sf = 0.f;
    for (int s = 0; s < w; ++s, sf += 1.f) {
      const float v = g2[s];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float d = jf[k] - sf;
        m[k] = fminf(m[k], fmaf(d, d, v));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = base + threadIdx.x + k * kThreads;
      if (j < w) orow[j] = m[k];
    }
  }
}

template <int K>
cudaError_t launch(const float* g, float* out, int rows, int w,
                   cudaStream_t stream) {
  row_envelope_kernel<K><<<rows, kThreads, w * sizeof(float), stream>>>(
      g, out, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g and out [rows, w] contiguous float32. Returns cudaGetLastError().
int iseg_edt_row_envelope(const void* g, void* out, int rows, int w,
                          void* stream) {
  if (rows < 1 || w < 1 || w > kMaxWidth) return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int k = (w + kThreads - 1) / kThreads;
  if (k > kMaxK) k = kMaxK;
  switch (k) {
    case 1: return (int)launch<1>(gp, op, rows, w, s);
    case 2: return (int)launch<2>(gp, op, rows, w, s);
    case 3: return (int)launch<3>(gp, op, rows, w, s);
    case 4: return (int)launch<4>(gp, op, rows, w, s);
    case 5: return (int)launch<5>(gp, op, rows, w, s);
    case 6: return (int)launch<6>(gp, op, rows, w, s);
    case 7: return (int)launch<7>(gp, op, rows, w, s);
    default: return (int)launch<8>(gp, op, rows, w, s);
  }
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
