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
// B=8 that is 6.7 GB, 2.0 ms at 3.35 TB/s, against 1.3 ms of f32 FMAs.
// The FMAs are only that cheap if shared memory feeds them: an SM loads 128
// bytes a clock from shared memory and issues 128 FMAs a clock, so the
// weighted sum must load at most one byte of hr a product.
//
// Design: one block of 128 threads per (8x16 output tile, batch), two
// blocks an SM (113 KB of shared memory each), so that one block's barrier
// and staging overlap the other's sums. Reflect padding is index
// arithmetic: the block maps each of its 14x22 halo pixels to its source
// pixel once, and stages the halo 32 channels at a time with cp.async, into
// a ring of two buffers (each pixel a row of 36 floats, so that 16-byte
// reads of eight neighbouring pixels fall on distinct banks): chunk t+1
// lands while chunk t is summed, one barrier a chunk. Chunks run over the
// key channels, then over hr's. A 16-byte copy needs C (or K) % 4 == 0 and
// a 16-byte aligned base; otherwise the same kernel copies 4 bytes at a
// time.
// Pass 1 (range weights): a thread owns one pixel and accumulates its 49 key
// dot products in registers in channel order (4 FMAs a 16-byte load, ~8% of
// the products), then writes the pixel's 49 normalised weights
// e_p / max(sum e, 1e-7) to shared memory as [tap][y][x], and nothing of
// them stays in registers. Pass 2 (weighted sum): a thread owns a strip of
// 8 pixels along a row times one float4 of channels, 32 accumulators. For
// each tap row it holds the strip's 7x8 weights (14 broadcast 16-byte loads)
// and walks the strip's halo row once (14 16-byte loads of hr, each feeding
// up to 7 outputs): 224 FMAs for 224 bytes of hr. The 8 lanes that share a
// strip read and write one pixel's 128 contiguous bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kDiam = 2 * kRadius + 1;
constexpr int kTaps = kDiam * kDiam;         // 49
constexpr int kTileH = 8;                    // output tile rows
constexpr int kTileW = 16;                   // output tile columns
constexpr int kTilePix = kTileH * kTileW;
constexpr int kHaloH = kTileH + 2 * kRadius;
constexpr int kHaloW = kTileW + 2 * kRadius;  // 22
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kCh = 32;                      // channels per staged chunk
constexpr int kVec = kCh / 4;                // float4 groups per chunk: 8
constexpr int kStride = kCh + 4;             // floats per staged pixel
constexpr int kStrip = 8;                    // pass 2: pixels a thread owns
constexpr int kThreads = kTilePix;           // one a pixel in pass 1
constexpr int kStages = 2;                   // ring buffers of staged chunks
constexpr int kBlocksPerSm = 2;              // as shared memory allows
constexpr int kStageFloats = kHaloPix * kStride;
constexpr int kWeightFloats = kTaps * kTilePix;
constexpr int kCoefFloats = 64;              // temp, spatial[49], padding
constexpr int kSmemBytes =
    (kStages * kStageFloats + kWeightFloats + kCoefFloats) *
        (int)sizeof(float) +
    kHaloPix * (int)sizeof(int);
static_assert(kStages == 2, "chunk t lives in buffer t & 1, one in flight");
static_assert(kThreads == kVec * kTileH * (kTileW / kStrip),
              "pass 2 maps one thread to a channel group of one strip");

// flags of the launch: which copies and stores may be 16 bytes wide
constexpr int kVecHr = 1, kVecProj = 2, kVecOut = 4;

// reflect (no edge repeat) into [0, n); indices past one reflection only
// occur for pixels outside the frame, whose outputs are not written: clamp
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 or 4 bytes; only the first src_bytes are
// read, the rest is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying channels [c0, c0 + kCh) of the tile's halo of x [H*W, ch]
// (one batch item; src_pix maps each halo pixel to its source pixel) into
// buf [kHaloPix][kStride]; channels at or beyond ch are zero-filled.
__device__ __forceinline__ void stage(const float* __restrict__ x, float* buf,
                                      const int* src_pix, int ch, int c0,
                                      bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kHaloPix * kVec; i += kThreads) {
      const int pix = i / kVec, e = (i % kVec) * 4;
      const bool ok = c0 + e < ch;
      cp_async16(buf + pix * kStride + e,
                 ok ? x + (long)src_pix[pix] * ch + c0 + e : x, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kHaloPix * kCh; i += kThreads) {
      const int pix = i / kCh, e = i % kCh;
      const bool ok = c0 + e < ch;
      cp_async4(buf + pix * kStride + e,
                ok ? x + (long)src_pix[pix] * ch + c0 + e : x, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// component i (a constant once unrolled) of v
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
jbu_kernel(const float* __restrict__ hr, const float* __restrict__ proj,
           const float* __restrict__ coef, float* __restrict__ out, int h,
           int w, int c, int k, int flags) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kHaloPix][kStride]
  float* wts = ring + kStages * kStageFloats;     // [kTaps][kTileH][kTileW]
  float* coef_s = wts + kWeightFloats;            // temp, spatial[49]
  int* src_pix = reinterpret_cast<int*>(coef_s + kCoefFloats);

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const long plane = (long)h * w;
  const float* hr_b = hr + blockIdx.z * plane * c;
  const float* proj_b = proj + blockIdx.z * plane * k;
  if (tid < 1 + kTaps) coef_s[tid] = coef[tid];
  for (int i = tid; i < kHaloPix; i += kThreads)
    src_pix[i] = reflect(y0 - kRadius + i / kHaloW, h) * w +
                 reflect(x0 - kRadius + i % kHaloW, w);
  __syncthreads();

  // chunk t < nk holds key channels [t kCh, ...), chunk nk + u hr channels
  // [u kCh, ...); chunk t lives in ring buffer t % 2
  const int nk = (k + kCh - 1) / kCh, nt = nk + (c + kCh - 1) / kCh;
  auto issue = [&](int t) {
    float* buf = ring + (t & 1) * kStageFloats;
    if (t < nk)
      stage(proj_b, buf, src_pix, k, t * kCh, flags & kVecProj);
    else
      stage(hr_b, buf, src_pix, c, (t - nk) * kCh, flags & kVecHr);
  };
  issue(0);

  // pass 1: the 49 key dot products of this thread's pixel
  const int ty = tid / kTileW, tx = tid % kTileW;
  float s[kTaps];
#pragma unroll
  for (int p = 0; p < kTaps; ++p) s[p] = 0.f;
  int t = 0;
  for (; t < nk; ++t) {
    cp_async_wait_all();  // chunk t has landed (this thread's copies)
    __syncthreads();      // ... everyone's; chunk t-1's buffer is free
    issue(t + 1);         // nt > nk: the next chunk always exists
    const float* buf = ring + (t & 1) * kStageFloats;
    const float* centre =
        buf + ((ty + kRadius) * kHaloW + tx + kRadius) * kStride;
#pragma unroll 1
    for (int d = 0; d < kCh; d += 4) {
      const float4 kc = *reinterpret_cast<const float4*>(centre + d);
#pragma unroll
      for (int p = 0; p < kTaps; ++p) {
        const float4 kn = *reinterpret_cast<const float4*>(
            buf + ((ty + p / kDiam) * kHaloW + tx + p % kDiam) * kStride + d);
        s[p] = fmaf(kc.x, kn.x, s[p]);
        s[p] = fmaf(kc.y, kn.y, s[p]);
        s[p] = fmaf(kc.z, kn.z, s[p]);
        s[p] = fmaf(kc.w, kn.w, s[p]);
      }
    }
  }

  // the weights: max, exponentials times the spatial Gaussian, normaliser;
  // written to shared memory, read by pass 2 after the next barrier
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
#pragma unroll
  for (int p = 0; p < kTaps; ++p) wts[p * kTilePix + tid] = s[p] * inv_den;

  // pass 2: the weighted sum of hr, a strip of kStrip pixels x one float4
  // of channels per thread, one chunk of kCh channels at a time
  const int g = tid % kVec, strip = tid / kVec;
  const int sy = strip / (kTileW / kStrip);
  const int sx = strip % (kTileW / kStrip) * kStrip;
  const int y = y0 + sy;
  for (; t < nt; ++t) {
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < nt) issue(t + 1);
    const float* buf = ring + (t & 1) * kStageFloats;
    float4 acc[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int dy = 0; dy < kDiam; ++dy) {
      // the strip's weights of this tap row: [dx][pixels 0-3, 4-7]
      float4 wv[kDiam][kStrip / 4];
      const float* wrow = wts + dy * kDiam * kTilePix + sy * kTileW + sx;
#pragma unroll
      for (int dx = 0; dx < kDiam; ++dx)
#pragma unroll
        for (int q = 0; q < kStrip / 4; ++q)
          wv[dx][q] = *reinterpret_cast<const float4*>(
              wrow + dx * kTilePix + 4 * q);
      // the strip's halo row: halo pixel i feeds output j = i - dx
      const float* src = buf + ((sy + dy) * kHaloW + sx) * kStride + 4 * g;
#pragma unroll
      for (int i = 0; i < kStrip + kDiam - 1; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(src + i * kStride);
#pragma unroll
        for (int dx = 0; dx < kDiam; ++dx) {
          const int j = i - dx;
          if (j < 0 || j >= kStrip) continue;
          const float wj = part(wv[dx][j / 4], j % 4);
          acc[j].x = fmaf(wj, v.x, acc[j].x);
          acc[j].y = fmaf(wj, v.y, acc[j].y);
          acc[j].z = fmaf(wj, v.z, acc[j].z);
          acc[j].w = fmaf(wj, v.w, acc[j].w);
        }
      }
    }
    const int cc = (t - nk) * kCh + 4 * g;
    if (y < h && cc < c) {
      float* o = out + ((blockIdx.z * (long)h + y) * w + x0 + sx) * c + cc;
#pragma unroll
      for (int j = 0; j < kStrip; ++j, o += c) {
        if (x0 + sx + j >= w) break;
        if (flags & kVecOut) {
          *reinterpret_cast<float4*>(o) = acc[j];
        } else {
          o[0] = acc[j].x;
          if (cc + 1 < c) o[1] = acc[j].y;
          if (cc + 2 < c) o[2] = acc[j].z;
          if (cc + 3 < c) o[3] = acc[j].w;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// once a process: all of the SM's shared memory for the kernel, none for L1
cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      jbu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        jbu_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// hr, out [batch, h, w, c] and proj [batch, h, w, k], float32, contiguous;
// coef [50] float32 on the device: (temp, spatial[49]). A 16-byte copy or
// store is taken where the channel count is a multiple of 4 and the base is
// 16-byte aligned, else 4-byte ones. Returns cudaGetLastError().
int iseg_jbu(const void* hr, const void* proj, const void* coef, void* out,
             int batch, int h, int w, int c, int k, void* stream) {
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 || c < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  const int flags = (c % 4 == 0 && aligned16(hr) ? kVecHr : 0) |
                    (k % 4 == 0 && aligned16(proj) ? kVecProj : 0) |
                    (c % 4 == 0 && aligned16(out) ? kVecOut : 0);
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  jbu_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hr), static_cast<const float*>(proj),
      static_cast<const float*>(coef), static_cast<float*>(out), h, w, c, k,
      flags);
  return (int)cudaGetLastError();
}

// The kernel's tiling as compiled and its resources as loaded on the
// current device, into out[10]: tile rows, tile columns, channels a chunk,
// ring buffers, pixels a strip, threads a block, shared bytes a block,
// resident blocks an SM (the occupancy calculator's), registers a thread
// and local bytes a thread (stack and spills). Returns a CUDA error code.
int iseg_jbu_config(int* out) {
  cudaError_t e = set_attributes();
  int blocks = 0;
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jbu_kernel,
                                                      kThreads, kSmemBytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, jbu_kernel);
  if (e != cudaSuccess) return (int)e;
  const int v[10] = {kTileH,  kTileW,     kCh,    kStages,      kStrip,
                     kThreads, kSmemBytes, blocks, attr.numRegs,
                     (int)attr.localSizeBytes};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
