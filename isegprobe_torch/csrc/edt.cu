// Kernel C: the row pass of the exact squared Euclidean distance transform,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/edt.py:_row_envelope_pallas
// (kernel _edt_row_kernel, pallas_call at :168). For every row of g
// ([rows, W] float32 vertical distances from the column pass):
//     out[j] = min(1e12, min over j' of fl(g[j']^2) + (j - j')^2)
// with one float32 rounding of each sum, as the plain version
// (isegprobe_torch/ops/edt.py:_row_envelope_plain) computes it.
//
// Exactness. The inputs the column pass produces are non-negative integers
// and the sentinel 1e6, so G = fl(g^2) is an integer (float32 values of 2^24
// and above are integers) below 2^40. The kernel finds the exact integer
// minimum M = min over j' of G[j'] + (j - j')^2 and rounds it once (round
// to nearest even, as float32 addition rounds). Rounding is monotone, so
// fl(M) = min over j' of fl(G[j'] + (j - j')^2), the plain version's value,
// bit for bit, even where G + d^2 passes 2^24. A source with
// G >= float32(1e12) cannot beat the clamp and is left out. A row whose
// finite G all lie below 2^30 - 2^24 (any column pass of height up to
// 32,000) runs in int32 with int64 products; any other row in int64 (see
// Arith below).
//
// Algorithm: a lower envelope of parabolas (Felzenszwalb-Huttenlocher),
// linear in W. With F[x] = G[x] + x^2 the value at column j of source x is
// F[x] - 2jx + j^2, a line in j whose slope falls as x grows. Every test
// is an exact integer cross-multiplication (products below 2^53):
//   - sources u < v < q: v leaves the envelope when
//       (F[q] - F[v]) (v - u) <= (F[v] - F[u]) (q - v);
//   - at column j the envelope moves from vertex v to the next vertex w
//     when F[w] - F[v] < 2j (w - v).
//
// Bounds at the device loop's shape (B lanes x 2 error maps x (hp+2) rows of
// wp+2; at B = 8 and 480x640 scenes rows = 8224, W = 642):
//     bytes:      8 * rows * W (read g and write out once), 42.2 MB,
//                 0.0126 ms at 3.35 TB/s;
//     operations: ~20 integer operations a source, 1e8, far below.
// The kernel is held to the byte bound. What holds it back is issue: the
// envelope's steps are chains of dependent integer operations and
// shared-memory loads, and a warp runs as long as its busiest lane.
//
// Design: one warp per row, up to eight rows (warps) a block in 64 KB of
// shared memory (four blocks, 32 warps, an SM at W = 642), one row a block
// at wider W. Warps never wait on each other: each stages, solves and
// stores its own row.
//   1. Stage: the warp reads its row with coalesced 4-byte loads (a row of
//      642 floats is not 16-byte aligned past row 0), each lane's 24 loads
//      issued in one batch, and writes G into shared memory, a negative
//      flag for a left-out source. A warp vote picks the row's arithmetic.
//   2. Segment envelopes: lane l builds, sequentially, the exact envelope
//      of the sources in its segment [l S, (l + 1) S), S = ceil(W / 32), in
//      place in shared memory (F or G of each vertex, and its column as
//      int16), and starts M of each of its columns at that column's own G.
//   3. Merge: M of each column lives in shared memory. Lane l folds its own
//      envelope and those of segments l - 1 and l + 1 into its columns, each
//      with a pointer that only moves forward over the ascending columns.
//      The farther segments in reach of its columns (those whose least G
//      plus squared distance to the lane's nearest column is below the
//      lane's largest M) form a list of (lane, segment) folds for the whole
//      warp, dealt out to all 32 lanes in turn and applied with atomicMin:
//      the lanes of a wide region of large M (a missed object on the first
//      click) share its work with the lanes of background. A column skips a
//      fold when the segment's least G plus its squared distance to the
//      segment's nearest vertex reaches its M. On the clicker's maps most
//      columns settle within their own segment and its neighbours; at worst
//      a column takes all 32 segments (32 W evaluations a row, against the
//      brute force's W^2).
//   4. Store: fl(M), clamped, with coalesced 4-byte stores.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxRows = 8;  // rows (warps) a block
constexpr int kMaxWidth = 4096;  // the columns fit int16
constexpr int kStage = 24;  // loads in flight a lane while staging a row
constexpr int kSmemBudget = 64 * 1024;  // shared bytes a block of several rows
constexpr int kBlocksPerSm = 4;  // 32 warps an SM at W = 642: 64 registers
constexpr long long kBig2 = 999999995904LL;  // float32(1e12)
constexpr float kBig2f = 1.0e12f;
// below this G every F = G + x^2 and every value F - 2jx + j^2 fits int32
constexpr float kNarrowG = 1056964608.0f;  // 2^30 - 2^24

// One segment's envelope as the other lanes read it: the least G of its
// sources, its vertex count and its first and last vertex columns.
struct Seg {
  long long g;
  int n;
  short first, last;
};

// Shared bytes of one row: a 4-byte slot a column for the sources (then the
// segment envelopes, in place) and one for M, the vertex columns (int16,
// padded to 8 bytes), and a Seg for each lane.
__host__ __device__ constexpr int row_bytes(int w) {
  return 8 * w + ((2 * w + 7) & ~7) + (int)sizeof(Seg) * kLanes;
}

int rows_per_block(int w) {
  const int r = kSmemBudget / row_bytes(w);
  return r < 1 ? 1 : (r > kMaxRows ? kMaxRows : r);
}

__host__ __device__ constexpr int segment_width(int w) {
  return (w + kLanes - 1) / kLanes;
}

// The two arithmetics of a row. The slots hold each source's G (float32)
// until its lane builds the envelope. Narrow (every finite G below
// kNarrowG, as for any column pass of height up to 32,000): F and M are
// int32, an envelope's slots hold its vertices' F, and INT_MAX stands for
// the clamp. Wide: F is int64, computed from a vertex's G, which its slot
// keeps, and its column; M is float32, each candidate rounded once.
// Rounding is monotone, so the least rounded candidate is the rounded least
// one, and a fold skipped because fl(lower bound) >= M could not have
// lowered M. M >= 0 in both, so atomicMin on its bits orders it right.
template <bool kWide>
struct Arith;

template <>
struct Arith<false> {
  using V = int;
  using M = int;
  static constexpr M kNone = INT_MAX;
  static __device__ V source(const unsigned* a, int x) {
    const float gg = __uint_as_float(a[x]);
    return gg < 0.f ? -1 : (int)gg + x * x;
  }
  static __device__ unsigned slot(V f, int) { return (unsigned)f; }
  static __device__ V vertex(const unsigned* a, const short*, int p) {
    return (int)a[p];
  }
  static __device__ M round(long long v) { return (M)v; }
  static __device__ float out(M m) {
    return m == kNone ? kBig2f : __int2float_rn(m);
  }
  static __device__ M load(const unsigned* m, int j) { return (int)m[j]; }
  static __device__ void store(unsigned* m, int j, M v) { m[j] = (unsigned)v; }
  static __device__ void store_min(unsigned* m, int j, M v) {
    atomicMin(&m[j], (unsigned)v);  // M >= 0: unsigned order is int order
  }
};

template <>
struct Arith<true> {
  using V = long long;
  using M = float;
  static constexpr M kNone = kBig2f;
  static __device__ V source(const unsigned* a, int x) {
    const float gg = __uint_as_float(a[x]);
    return gg < 0.f ? -1LL : (long long)gg + x * x;
  }
  static __device__ unsigned slot(V f, int x) {  // the vertex's G
    return __float_as_uint((float)(f - x * x));
  }
  static __device__ V vertex(const unsigned* a, const short* ex, int p) {
    const int x = ex[p];
    return (long long)__uint_as_float(a[p]) + x * x;
  }
  static __device__ M round(long long v) { return __ll2float_rn(v); }
  static __device__ float out(M m) { return m; }
  static __device__ M load(const unsigned* m, int j) {
    return __uint_as_float(m[j]);
  }
  static __device__ void store(unsigned* m, int j, M v) {
    m[j] = __float_as_uint(v);
  }
  static __device__ void store_min(unsigned* m, int j, M v) {
    atomicMin(&m[j], __float_as_uint(v));  // M >= 0: bits order as values
  }
};

// Build the envelope of the lane's sources [lo, hi) in place from slot lo,
// publish it as seg, and start M of each of the lane's columns at its own
// source's value G (the clamp for a left-out source).
template <bool kWide>
__device__ __forceinline__ void build_segment(unsigned* a, unsigned* m,
                                              short* env_x, Seg* seg, int lo,
                                              int hi) {
  using A = Arith<kWide>;
  using V = typename A::V;
  int n = 0;
  long long gmin = kBig2;
  V fu = 0, fv = 0;
  int u = 0, v = 0;  // the stack's two top vertices
  for (int x = lo; x < hi; ++x) {
    const V fx = A::source(a, x);
    if (fx < 0) {
      A::store(m, x, A::kNone);
      continue;
    }
    const long long gx = fx - x * x;
    A::store(m, x, A::round(gx));
    gmin = min(gmin, gx);
    while (n >= 2 && (long long)(fx - fv) * (v - u) <=
                         (long long)(fv - fu) * (x - v)) {
      --n;
      v = u;
      fv = fu;
      if (n >= 2) {
        u = env_x[lo + n - 2];
        fu = A::vertex(a, env_x, lo + n - 2);
      }
    }
    a[lo + n] = A::slot(fx, x);  // slot lo + n <= x: source x is already read
    env_x[lo + n] = (short)x;
    ++n;
    u = v;
    fu = fv;
    v = x;
    fv = fx;
  }
  Seg s;
  s.g = gmin;
  s.n = n;
  s.first = n > 0 ? env_x[lo] : 0;
  s.last = n > 0 ? env_x[lo + n - 1] : 0;
  *seg = s;
}

// Fold the envelope of one segment (vertices from slot k0) into M of the
// columns [lo, hi). side < 0: the segment lies left of those columns,
// side > 0: right of them, 0: it is their own segment. Other segments fold
// in with atomicMin, since several lanes may fold into the same columns at
// once. A column skips the segment when
// the least G of its sources plus the squared distance to its nearest
// vertex reaches the column's M: no source of the segment can beat it.
// Returns the largest M of the columns.
template <bool kWide>
__device__ __forceinline__ typename Arith<kWide>::M merge_segment(
    const unsigned* a, const short* env_x, unsigned* m, int k0,
    const Seg& sg, int lo, int hi, int side) {
  using A = Arith<kWide>;
  using V = typename A::V;
  using M = typename A::M;
  const int last = k0 + sg.n - 1;
  const int near = side < 0 ? sg.last : sg.first;
  int p = k0;
  V fv = A::vertex(a, env_x, p);
  int v = env_x[p];
  M top = 0;
  for (int j = lo; j < hi; ++j) {
    const int gap = side < 0 ? j - near : (side > 0 ? near - j : 0);
    M mj = A::load(m, j);
    if (A::round(sg.g + gap * gap) < mj) {
      while (p < last) {
        const V fw = A::vertex(a, env_x, p + 1);
        const int x = env_x[p + 1];
        if (fw - fv >= (V)(2 * j * (x - v))) break;
        ++p;
        fv = fw;
        v = x;
      }
      const M c = A::round(fv + (V)(j * j - 2 * j * v));
      if (c < mj) {
        mj = c;
        if (side == 0)
          A::store(m, j, c);
        else
          A::store_min(m, j, c);
      }
    }
    top = top < mj ? mj : top;
  }
  return top;
}

// Steps 2 and 3 for one row, by its warp.
template <bool kWide>
__device__ __forceinline__ void solve_row(unsigned* a, unsigned* m,
                                          short* env_x, Seg* segs, int w,
                                          int lane) {
  using A = Arith<kWide>;
  using M = typename A::M;
  const int s = segment_width(w);
  const int lo = lane * s;
  const int hi = min(w, lo + s);
  build_segment<kWide>(a, m, env_x, &segs[lane], lo, hi);
  __syncwarp();
  // the lane folds its own segment and its two neighbours into its columns
  // itself, which settles most columns on short range
  M max_m = A::kNone;
  if (lo < hi) {
    const Seg own = segs[lane];
    if (own.n > 0)
      max_m = merge_segment<kWide>(a, env_x, m, lo, own, lo, hi, 0);
    for (int side = -1; side <= 1; side += 2) {
      const int k = lane + side;
      if (k < 0 || k >= kLanes) continue;
      const Seg sg = segs[k];
      const int gap = side < 0 ? lo - sg.last : sg.first - (hi - 1);
      if (sg.n > 0 && A::round(sg.g + gap * gap) < max_m)
        max_m = merge_segment<kWide>(a, env_x, m, k * s, sg, lo, hi, side);
    }
  }
  __syncwarp();  // before other lanes fold into the lane's columns

  // the farther segments in reach of the lane's columns, as a bit mask:
  // those whose least G plus squared distance to the lane's nearest column
  // is below the lane's largest M
  unsigned mask = 0;
  if (lo < hi)
    for (int k = 0; k < kLanes; ++k) {
      const Seg sg = segs[k];
      if (abs(k - lane) <= 1 || sg.n == 0) continue;
      const int gap = k < lane ? lo - sg.last : sg.first - (hi - 1);
      if (A::round(sg.g + gap * gap) < max_m) mask |= 1u << k;
    }
  // the warp's (lane, segment) folds, dealt out to all 32 lanes in turn, so
  // that the lanes of a wide region of large M share its work with the rest
  const int count = __popc(mask);
  int incl = count;
  for (int o = 1; o < kLanes; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - count;
  const int total = __shfl_sync(0xffffffffu, incl, kLanes - 1);
  for (int t0 = 0; t0 < total; t0 += kLanes) {
    const int t = t0 + lane;
    int owner = 0;  // the last lane whose folds start at or before t
    for (int b = kLanes / 2; b > 0; b >>= 1) {
      const int e = __shfl_sync(0xffffffffu, excl, owner + b);
      if (e <= t) owner += b;
    }
    unsigned om = __shfl_sync(0xffffffffu, mask, owner);
    const int first = __shfl_sync(0xffffffffu, excl, owner);
    if (t < total) {
      for (int i = first; i < t; ++i) om &= om - 1;
      const int k = __ffs(om) - 1;
      const int olo = owner * s;
      merge_segment<kWide>(a, env_x, m, k * s, segs[k], olo,
                           min(w, olo + s), k < owner ? -1 : 1);
    }
  }
}

__global__ void __launch_bounds__(kLanes * kMaxRows, kBlocksPerSm)
row_envelope_kernel(const float* __restrict__ g, float* __restrict__ out,
                    int rows, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const long long row = (long long)blockIdx.x * (blockDim.x / kLanes) + warp;
  if (row >= rows) return;  // the whole warp leaves together
  unsigned char* base = smem + warp * row_bytes(w);
  Seg* segs = reinterpret_cast<Seg*>(base);
  unsigned* a = reinterpret_cast<unsigned*>(segs + kLanes);
  unsigned* m = a + w;
  short* env_x = reinterpret_cast<short*>(m + w);
  const float* grow = g + row * w;
  float* orow = out + row * w;

  // 1. stage G = fl(g^2), all of a lane's loads in flight at once up to
  // W = 768; a source whose G reaches the clamp is flagged -1
  bool wide = false;
  for (int x0 = lane; x0 < w; x0 += kStage * kLanes) {
    float gv[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int x = x0 + k * kLanes;
      gv[k] = x < w ? grow[x] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int x = x0 + k * kLanes;
      if (x < w) {
        const float gg = gv[k] * gv[k];
        const bool in = gg < kBig2f;
        wide = wide || (in && gg >= kNarrowG);
        a[x] = __float_as_uint(in ? gg : -1.f);
      }
    }
  }
  wide = __any_sync(0xffffffffu, wide);
  __syncwarp();

  // 2-3. segment envelopes, then the exact minimum of each lane's columns
  if (wide)
    solve_row<true>(a, m, env_x, segs, w, lane);
  else
    solve_row<false>(a, m, env_x, segs, w, lane);
  __syncwarp();

  // 4. one rounding of the exact minimum, clamped
  if (wide)
    for (int x = lane; x < w; x += kLanes)
      orow[x] = Arith<true>::out(Arith<true>::load(m, x));
  else
    for (int x = lane; x < w; x += kLanes)
      orow[x] = Arith<false>::out(Arith<false>::load(m, x));
}

cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  // a block of several rows takes at most kSmemBudget, one row less
  static_assert(row_bytes(kMaxWidth) <= kSmemBudget, "one row fits");
  cudaError_t e = cudaFuncSetAttribute(
      row_envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBudget);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(row_envelope_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// g and out [rows, w] contiguous float32, g as the column pass gives it
// (non-negative integers and the sentinel 1e6). Returns cudaGetLastError().
int iseg_edt_row_envelope(const void* g, void* out, int rows, int w,
                          void* stream) {
  if (rows < 1 || w < 1 || w > kMaxWidth) return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  const int r = rows_per_block(w);
  const unsigned blocks = (unsigned)((rows + r - 1) / r);
  row_envelope_kernel<<<blocks, r * kLanes, r * row_bytes(w),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(out), rows, w);
  return (int)cudaGetLastError();
}

// The kernel's layout at row width w as compiled, and its resources as
// loaded on the current device, into out[7]: rows a block, threads a block,
// segment width, shared bytes a block, resident blocks an SM (the occupancy
// calculator's), registers a thread and local bytes a thread (stack and
// spills). Returns a CUDA error code.
int iseg_edt_config(int w, int* out) {
  if (w < 1 || w > kMaxWidth) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes();
  const int r = rows_per_block(w);
  int blocks = 0;
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, row_envelope_kernel, r * kLanes, r * row_bytes(w));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, row_envelope_kernel);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {r, r * kLanes, segment_width(w), r * row_bytes(w),
                    blocks, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
