// Fused 7x7 joint bilateral filter (FeatUp's JBU stage) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/jbu_kernel.py:
// jbu_filter_pallas (kernel _jbu_kernel, pallas_call at :188). For every
// output pixel x of hr [B, H, W, C] with range keys proj [B, H, W, K]:
//     s_p  = temp * <key(x), key(x + p)>        for the 49 taps p of a 7x7 window
//     m    = max_p s_p
//     e_p  = exp(s_p - m) * spatial_p
//     out  = sum_p e_p * hr(x + p) / max(sum_p e_p, 1e-7)
// with reflect padding at the frame edge, temp = clip(exp(range_temp), 1e-4,
// 1e4) and spatial_p the Gaussian of sigma on linspace(-1, 1, 7)^2; the
// wrapper computes (temp, spatial[49]) on the device and passes them as
// coef[50]. Inputs and output are f32 (the wrapper casts); any B, H, W >= 4,
// C and K.
//
// Bound on this card: bytes. Each pixel does 49*K products for the range
// kernel and 49*C for the weighted sum (~4e4 operations at K=32, C=384),
// while hr is read and out written once (8*C bytes a pixel): at 512^2, C=384,
// B=2 that is 1.6 GB, 0.48 ms at 3.35 TB/s, against 0.31 ms of f32
// operations at 67 TFLOP/s.
//
// Design: one block of 256 threads per (16x16 output tile, batch), one thread
// per output pixel. Reflect padding is index arithmetic: a tile stages its
// 22x22 halo from the unpadded tensors into shared memory, 32 channels at a
// time, each pixel a row of 36 floats (16-byte reads by neighbouring pixels
// then fall on distinct banks). Pass 1 sweeps the key channels and
// accumulates the 49 dot products in registers; the softmax max, the
// exponentials, the spatial weights and the normaliser follow in registers,
// so the 49 weights of a pixel are computed once and never leave its thread.
// Pass 2 sweeps hr in chunks of 32 channels through the same shared buffer,
// each thread accumulating its pixel's 32 outputs in registers (four FMAs
// per 16-byte shared load) and writing them once. Occupancy sets the speed:
// registers are capped so that three blocks share an SM (80 a thread; ptxas
// spills ~130 bytes of the weights to L1), which hides the staging and
// barrier latency far better than one block of 154 registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRadius = 3;
constexpr int kDiam = 2 * kRadius + 1;
constexpr int kTaps = kDiam * kDiam;    // 49
constexpr int kTile = 16;               // output tile side
constexpr int kHalo = kTile + 2 * kRadius;  // 22
constexpr int kHaloPix = kHalo * kHalo;     // 484
constexpr int kCh = 32;                 // channels per shared-memory chunk
constexpr int kStride = kCh + 4;        // floats per staged pixel
constexpr int kThreads = kTile * kTile;  // 256
constexpr int kSmemBytes = (kHaloPix * kStride + 64) * (int)sizeof(float);

// reflect (no edge repeat) into [0, n); indices past one reflection only
// occur for pixels outside the frame, whose outputs are not written: clamp
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// Stage channels [c0, c0 + kCh) of the tile's halo of x [H, W, ch] (one
// batch item) into buf [kHaloPix][kStride], zero beyond ch.
__device__ __forceinline__ void stage(const float* __restrict__ x, float* buf,
                                      int y0, int x0, int h, int w, int ch,
                                      int c0) {
  for (int i = threadIdx.x; i < kHaloPix * kCh; i += kThreads) {
    const int pix = i / kCh, c = i % kCh;
    const int yy = reflect(y0 - kRadius + pix / kHalo, h);
    const int xx = reflect(x0 - kRadius + pix % kHalo, w);
    buf[pix * kStride + c] =
        c0 + c < ch ? x[((long)yy * w + xx) * ch + c0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
jbu_kernel(const float* __restrict__ hr, const float* __restrict__ proj,
           const float* __restrict__ coef, float* __restrict__ out, int h,
           int w, int c, int k) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [kHaloPix][kStride]
  float* coef_s = buf + kHaloPix * kStride;      // temp, spatial[49]

  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const float* hr_b = hr + (long)b * h * w * c;
  const float* proj_b = proj + (long)b * h * w * k;
  if (threadIdx.x < 1 + kTaps) coef_s[threadIdx.x] = coef[threadIdx.x];

  // pass 1: the 49 key dot products, swept over the key channels
  float s[kTaps];
#pragma unroll
  for (int p = 0; p < kTaps; ++p) s[p] = 0.f;
  const int centre = (ty + kRadius) * kHalo + tx + kRadius;
  for (int c0 = 0; c0 < k; c0 += kCh) {
    __syncthreads();
    stage(proj_b, buf, y0, x0, h, w, k, c0);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kCh; d += 4) {
      const float4 kc = *reinterpret_cast<const float4*>(buf + centre * kStride + d);
#pragma unroll
      for (int p = 0; p < kTaps; ++p) {
        const int pix = (ty + p / kDiam) * kHalo + tx + p % kDiam;
        const float4 kn = *reinterpret_cast<const float4*>(buf + pix * kStride + d);
        s[p] = fmaf(kc.x, kn.x, s[p]);
        s[p] = fmaf(kc.y, kn.y, s[p]);
        s[p] = fmaf(kc.z, kn.z, s[p]);
        s[p] = fmaf(kc.w, kn.w, s[p]);
      }
    }
  }

  // the weights: max, exponentials times the spatial Gaussian, normaliser
  const float temp = coef_s[0];
  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < kTaps; ++p) {
    s[p] *= temp;
    m = fmaxf(m, s[p]);
  }
  float den = 0.f;
#pragma unroll
  for (int p = 0; p < kTaps; ++p) {
    s[p] = expf(s[p] - m) * coef_s[1 + p];
    den += s[p];
  }
  const float inv_den = 1.f / fmaxf(den, 1e-7f);

  // pass 2: the weighted sum of hr, 32 channels at a time
  const int y = y0 + ty, x = x0 + tx;
  float* out_px = out + (((long)b * h + y) * w + x) * c;
  for (int c0 = 0; c0 < c; c0 += kCh) {
    __syncthreads();
    stage(hr_b, buf, y0, x0, h, w, c, c0);
    __syncthreads();
    float acc[kCh];
#pragma unroll
    for (int e = 0; e < kCh; ++e) acc[e] = 0.f;
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      const float* src =
          buf + ((ty + p / kDiam) * kHalo + tx + p % kDiam) * kStride;
#pragma unroll
      for (int e = 0; e < kCh; e += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(src + e);
        acc[e] = fmaf(s[p], hv.x, acc[e]);
        acc[e + 1] = fmaf(s[p], hv.y, acc[e + 1]);
        acc[e + 2] = fmaf(s[p], hv.z, acc[e + 2]);
        acc[e + 3] = fmaf(s[p], hv.w, acc[e + 3]);
      }
    }
    if (y < h && x < w) {
      if (c0 + kCh <= c && c % 4 == 0) {
#pragma unroll
        for (int e = 0; e < kCh; e += 4)
          *reinterpret_cast<float4*>(out_px + c0 + e) =
              make_float4(acc[e] * inv_den, acc[e + 1] * inv_den,
                          acc[e + 2] * inv_den, acc[e + 3] * inv_den);
      } else {
#pragma unroll
        for (int e = 0; e < kCh; ++e)
          if (c0 + e < c) out_px[c0 + e] = acc[e] * inv_den;
      }
    }
  }
}

}  // namespace

extern "C" {

// hr, out [batch, h, w, c] and proj [batch, h, w, k], float32, contiguous;
// coef [50] float32 on the device: (temp, spatial[49]). Returns
// cudaGetLastError().
int iseg_jbu(const void* hr, const void* proj, const void* coef, void* out,
             int batch, int h, int w, int c, int k, void* stream) {
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 || c < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        jbu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  jbu_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hr), static_cast<const float*>(proj),
      static_cast<const float*>(coef), static_cast<float*>(out), h, w, c, k);
  return (int)cudaGetLastError();
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
