// Host image work for the data layer: a sequential (baseline and extended
// Huffman) JPEG decoder, the PNG row unfilter, and the bilinear affine warp
// of uint8 images.
//
// The JPEG decoder gives the pixels that libjpeg-turbo gives with its
// default decompression settings, the settings OpenCV's imread uses:
//   * the accurate integer inverse DCT (JDCT_ISLOW, jidctint.c), with its
//     post-IDCT range-limit table;
//   * "fancy" (triangle-filter) chroma upsampling for h2v1, h1v2 and h2v2
//     (jdsample.c), box replication where a component is at most two
//     samples wide or the ratio is another integer;
//   * the table-driven YCbCr -> RGB conversion (jdcolor.c).
// libjpeg-turbo's SIMD paths are bit-exact with that C code. Progressive,
// arithmetic-coded, lossless, 12-bit and four-component files are refused
// with their own error codes. The EXIF orientation tag (APP1, IFD0, tag
// 0x0112) is reported, not applied.
//
// The warp is cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) as this
// OpenCV build computes it in float32: source coordinates
// fma(M0, x, f32(M1*y) + M2) over the columns its 16-wide vector loop
// covers and fma(x, M0, f32(M1*y)) + M2 over the scalar tail, lerps
// fma(a, p1 - p0, p0), round half to even. std::fmaf is exact, and
// without -mfma or -ffast-math g++ contracts no other product.
//
// Built with g++ -O2 -shared -fPIC at first use (utils/host_lib.py) and
// called through ctypes, which releases the GIL for the call.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kCorrupt = 1,
  kProgressive = 2,
  kArithmetic = 3,
  kUnsupported = 4,
  kTruncated = 5,
  kBadFilter = 6,
};

// natural order of the zig-zag positions, with libjpeg's 16 extra entries
// that keep a corrupt run length inside the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valoff[17];
  // 9-bit look-ahead: (length << 8) | value, 0 where the code is longer
  uint16_t look[512];

  void derive() {
    int code = 0, k = 0;
    int huffcode[257];
    uint8_t huffsize[257];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[k++] = (uint8_t)l;
    huffsize[k] = 0;
    int si = huffsize[0];
    int p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoff[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); ++c)
          look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
    }
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;  // downsampled width and height in samples
  int bw = 0, bh = 0;  // blocks allocated a row and a column
  int pred = 0;
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
};

struct Decoder {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint16_t qt[4][64];
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Comp comp[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool frame = false;
  // entropy bit reader
  uint64_t buf = 0;
  int nbits = 0;
  bool marker_hit = false;

  int u8() { return pos < n ? d[pos++] : -1; }
  int u16() {
    if (pos + 2 > n) return -1;
    int v = (d[pos] << 8) | d[pos + 1];
    pos += 2;
    return v;
  }

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!marker_hit && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            marker_hit = true;  // leave the marker for the parser
            pos = q - 1;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = (int)(buf >> (64 - k));
    buf <<= k;
    nbits -= k;
    return v;
  }
  int decode(const Huff& t) {
    if (nbits < 16) fill();
    int e = t.look[buf >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    int l = 1;
    int code = bits(1);
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      if (++l > 16) return 0;  // corrupt: libjpeg returns 0 too
    }
    return t.vals[(t.valoff[l] + code) & 0xFF];
  }
  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }

  void block(Comp& c, int16_t* blk) {
    int s = decode(dc[c.td]);
    if (s) s = extend(bits(s), s);
    c.pred += s;
    blk[0] = (int16_t)c.pred;
    const Huff& t = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // at a restart marker: drop the buffered bits, skip the RSTn marker,
  // reset the DC predictions
  void restart_interval() {
    buf = 0;
    nbits = 0;
    marker_hit = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        break;
      }
      if (d[pos] == 0xFF && d[pos + 1] != 0xFF && d[pos + 1] != 0x00)
        break;  // another marker: leave it (libjpeg resyncs the same way)
      ++pos;
    }
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
  }

  int scan() {
    int len = u16();
    if (len < 3) return kCorrupt;
    size_t end = pos + len - 2;
    if (end > n) return kTruncated;
    int ns = u8();
    if (ns < 1 || ns > 4) return kCorrupt;
    int idx[4];
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), tables = u8();
      idx[i] = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) idx[i] = j;
      if (idx[i] < 0 || tables < 0) return kCorrupt;
      comp[idx[i]].td = tables >> 4;
      comp[idx[i]].ta = tables & 15;
      if (comp[idx[i]].td > 3 || comp[idx[i]].ta > 3) return kCorrupt;
      if (!dc[comp[idx[i]].td].present || !ac[comp[idx[i]].ta].present)
        return kCorrupt;
    }
    pos = end;  // Ss, Se, Ah/Al: fixed for sequential scans
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
    buf = 0;
    nbits = 0;
    marker_hit = false;
    int todo = restart;
    if (ns == 1) {
      Comp& c = comp[idx[0]];
      int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      for (int y = 0; y < by; ++y)
        for (int x = 0; x < bx; ++x) {
          if (restart) {
            if (todo == 0) {
              restart_interval();
              todo = restart;
            }
            --todo;
          }
          block(c, &c.coef[((size_t)y * c.bw + x) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart) {
            if (todo == 0) {
              restart_interval();
              todo = restart;
            }
            --todo;
          }
          for (int i = 0; i < ns; ++i) {
            Comp& c = comp[idx[i]];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                size_t bx = (size_t)mx * c.h + h, by = (size_t)my * c.v + v;
                block(c, &c.coef[(by * c.bw + bx) * 64]);
              }
          }
        }
    }
    // continue after the entropy-coded segment, at the next marker (a
    // marker the bit reader stopped at is already under `pos`)
    if (!marker_hit) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
                               d[pos + 1] != 0xFF &&
                               !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
        ++pos;
    }
    marker_hit = false;
    return kOk;
  }

  void exif(size_t start, size_t len) {
    if (len < 14 || std::memcmp(d + start, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = d + start + 6;
    size_t tn = len - 6;
    bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
    auto g16 = [&](size_t o) -> int {
      if (o + 2 > tn) return -1;
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto g32 = [&](size_t o) -> long {
      if (o + 4 > tn) return -1;
      return le ? (long)t[o] | ((long)t[o + 1] << 8) | ((long)t[o + 2] << 16) |
                      ((long)t[o + 3] << 24)
                : ((long)t[o] << 24) | ((long)t[o + 1] << 16) |
                      ((long)t[o + 2] << 8) | (long)t[o + 3];
    };
    long ifd = g32(4);
    if (ifd < 0) return;
    int count = g16((size_t)ifd);
    for (int i = 0; i < count; ++i) {
      size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
      if (g16(e) == 0x0112) {
        int v = g16(e + 8);
        if (v >= 1 && v <= 8) orientation = v;
        return;
      }
    }
  }

  int header(bool decode_scans) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kCorrupt;
    pos = 2;
    for (;;) {
      int b = u8();
      if (b < 0) return frame ? kTruncated : kCorrupt;
      if (b != 0xFF) continue;  // garbage between markers: skipped
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m < 0) return kTruncated;
      if (m == 0xD9) return frame ? kOk : kCorrupt;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0xD8 || m == 0x01) continue;
      if (m == 0xDA) {  // SOS
        if (!frame) return kCorrupt;
        if (!decode_scans) return kOk;
        int rc = scan();
        if (rc) return rc;
        continue;
      }
      int len = u16();
      if (len < 2) return kTruncated;
      size_t start = pos, end = pos + len - 2;
      if (end > n) return kTruncated;
      if (m == 0xC0 || m == 0xC1) {
        int rc = sof();
        if (rc) return rc;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        return kProgressive;
      } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD ||
                 m == 0xCF) {
        return kArithmetic;
      } else if (m == 0xC3 || m == 0xC5 || m == 0xC7 || m == 0xCB) {
        return kUnsupported;
      } else if (m == 0xC4) {
        while (pos < end) {
          int tc = u8();
          Huff& t = (tc >> 4) ? ac[tc & 3] : dc[tc & 3];
          int total = 0;
          for (int l = 1; l <= 16; ++l) {
            t.bits[l] = (uint8_t)u8();
            total += t.bits[l];
          }
          if (total > 256 || pos + total > end) return kCorrupt;
          for (int i = 0; i < total; ++i) t.vals[i] = (uint8_t)u8();
          t.derive();
          t.present = true;
        }
      } else if (m == 0xDB) {
        while (pos < end) {
          int pq = u8();
          int tq = pq & 3;
          for (int i = 0; i < 64; ++i)
            qt[tq][kNatural[i]] = (uint16_t)((pq >> 4) ? u16() : u8());
        }
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(d + start, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {
        if (orientation == 1) exif(start, len - 2);
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d + start, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[start + 11];
        }
      } else if (m == 0xCC) {
        return kArithmetic;  // DAC
      }
      pos = end;
    }
  }

  int sof() {
    if (u8() != 8) return kUnsupported;  // 12-bit samples
    height = u16();
    width = u16();
    ncomp = u8();
    if (height <= 0 || width <= 0) return kCorrupt;
    // a bound on what the coefficient buffers may hold (2^28 pixels)
    if ((long)height * width > (1L << 28)) return kUnsupported;
    if (ncomp != 1 && ncomp != 3) return kUnsupported;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8() & 3;
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4)
        return kCorrupt;
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) return kUnsupported;
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
    return kOk;
  }
};

// jidctint.c: jpeg_idct_islow
const int kConstBits = 13, kPass1Bits = 2;
const long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
           FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
           FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
           FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
           FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
           FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// jdmaster.c's post-IDCT range limit, indexed by (x & 1023)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    auto deq = [&](int k) -> long {
      return (long)ip[8 * k] * (long)(int16_t)q[c + 8 * k];
    };
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dcval = (int)(deq(0) * (1 << kPass1Bits));
      for (int k = 0; k < 8; ++k) ws[c + 8 * k] = dcval;
      continue;
    }
    long z2 = deq(2), z3 = deq(6);
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = deq(0);
    z3 = deq(4);
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = deq(7);
    tmp1 = deq(5);
    tmp2 = deq(3);
    tmp3 = deq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[c + 0] = (int)descale(tmp10 + tmp3, sh);
    ws[c + 56] = (int)descale(tmp10 - tmp3, sh);
    ws[c + 8] = (int)descale(tmp11 + tmp2, sh);
    ws[c + 48] = (int)descale(tmp11 - tmp2, sh);
    ws[c + 16] = (int)descale(tmp12 + tmp1, sh);
    ws[c + 40] = (int)descale(tmp12 - tmp1, sh);
    ws[c + 24] = (int)descale(tmp13 + tmp0, sh);
    ws[c + 32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + stride * r;
    long z2 = w[2], z3 = w[6];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    long tmp0 = ((long)w[0] + w[4]) * (1L << kConstBits);
    long tmp1 = ((long)w[0] - w[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// one component's samples brought to the full grid (W x H), jdsample.c
void upsample(const Comp& c, const uint8_t* s, size_t ss, int hmax, int vmax,
              int W, int H, uint8_t* o) {
  int he = hmax / c.h, ve = vmax / c.v;
  int dw = c.dw, dh = c.dh;
  auto at = [&](int y, int x) -> int {
    return s[(size_t)y * ss + x];
  };
  auto put = [&](int y, int x, int v) {
    if (y < H && x < W) o[(size_t)y * W + x] = (uint8_t)v;
  };
  if (he == 1 && ve == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(o + (size_t)y * W, s + y * ss, W);
  } else if (he == 2 && ve == 1 && dw > 2) {
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < dw; ++x) {
        int v3 = at(y, x) * 3;
        int l = at(y, x > 0 ? x - 1 : 0), r = at(y, x + 1 < dw ? x + 1 : x);
        put(y, 2 * x, (v3 + l + 1) >> 2);
        put(y, 2 * x + 1, (v3 + r + 2) >> 2);
      }
  } else if (he == 1 && ve == 2) {
    for (int y = 0; y < dh; ++y) {
      int ya = y > 0 ? y - 1 : 0, yb = y + 1 < dh ? y + 1 : y;
      for (int x = 0; x < dw; ++x) {
        int v3 = at(y, x) * 3;
        put(2 * y, x, (v3 + at(ya, x) + 1) >> 2);
        put(2 * y + 1, x, (v3 + at(yb, x) + 2) >> 2);
      }
    }
  } else if (he == 2 && ve == 2 && dw > 2) {
    std::vector<int> above(dw), below(dw);
    for (int y = 0; y < dh; ++y) {
      int ya = y > 0 ? y - 1 : 0, yb = y + 1 < dh ? y + 1 : y;
      for (int x = 0; x < dw; ++x) {
        above[x] = at(y, x) * 3 + at(ya, x);
        below[x] = at(y, x) * 3 + at(yb, x);
      }
      for (int v = 0; v < 2; ++v) {
        const std::vector<int>& cs = v ? below : above;
        for (int x = 0; x < dw; ++x) {
          int l = cs[x > 0 ? x - 1 : 0], r = cs[x + 1 < dw ? x + 1 : x];
          put(2 * y + v, 2 * x, (cs[x] * 3 + l + 8) >> 4);
          put(2 * y + v, 2 * x + 1, (cs[x] * 3 + r + 7) >> 4);
        }
      }
    }
  } else {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) o[(size_t)y * W + x] = at(y / ve, x / he);
  }
}

// jdcolor.c's ycc_rgb tables
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const long one_half = 1L << 15;
    auto fix = [](double x) { return (long)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

const char* iseg_host_error(int code) {
  switch (code) {
    case kOk: return "ok";
    case kCorrupt: return "not a JPEG file or a corrupt one";
    case kProgressive: return "progressive JPEG is not supported";
    case kArithmetic: return "arithmetic-coded JPEG is not supported";
    case kUnsupported:
      return "unsupported JPEG (lossless, 12-bit, 2 or 4 components, "
             "non-integral sampling, or over 2^28 pixels)";
    case kTruncated: return "truncated JPEG";
    case kBadFilter: return "PNG row filter type out of range";
  }
  return "unknown error";
}

// The frame's size and component count, and the EXIF orientation (1-8, 1
// when absent), read up to the first scan.
int iseg_jpeg_info(const uint8_t* data, size_t n, int* height, int* width,
                   int* components, int* orientation) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  int rc = dec.header(false);
  if (rc) return rc;
  *height = dec.height;
  *width = dec.width;
  *components = dec.ncomp;
  *orientation = dec.orientation;
  return kOk;
}

// Decode to interleaved RGB [height, width, 3], before the EXIF
// orientation; the caller's buffer has iseg_jpeg_info's size.
int iseg_jpeg_decode_rgb(const uint8_t* data, size_t n, uint8_t* out) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  int rc = dec.header(true);
  if (rc) return rc;
  const int W = dec.width, H = dec.height;
  std::vector<std::vector<uint8_t>> full(dec.ncomp);
  for (int i = 0; i < dec.ncomp; ++i) {
    Comp& c = dec.comp[i];
    size_t ss = (size_t)c.bw * 8;
    std::vector<uint8_t> plane(ss * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], dec.qt[c.tq],
                   &plane[(size_t)by * 8 * ss + bx * 8], ss);
    full[i].resize((size_t)W * H);
    upsample(c, plane.data(), ss, dec.hmax, dec.vmax, W, H, full[i].data());
  }
  size_t np = (size_t)W * H;
  if (dec.ncomp == 1) {
    for (size_t p = 0; p < np; ++p)
      out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
    return kOk;
  }
  bool rgb;
  if (dec.jfif) rgb = false;
  else if (dec.adobe) rgb = dec.adobe_transform == 0;
  else rgb = dec.comp[0].id == 82 && dec.comp[1].id == 71 &&
             dec.comp[2].id == 66;
  const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
  if (rgb) {
    for (size_t p = 0; p < np; ++p) {
      out[3 * p] = y[p];
      out[3 * p + 1] = cb[p];
      out[3 * p + 2] = cr[p];
    }
    return kOk;
  }
  for (size_t p = 0; p < np; ++p) {
    int yy = y[p];
    out[3 * p] = clamp255(yy + kYcc.cr_r[cr[p]]);
    out[3 * p + 1] =
        clamp255(yy + (int)((kYcc.cb_g[cb[p]] + kYcc.cr_g[cr[p]]) >> 16));
    out[3 * p + 2] = clamp255(yy + kYcc.cb_b[cb[p]]);
  }
  return kOk;
}

// PNG: undo the five row filters. `in` holds `rows` rows of a filter byte
// and `rowbytes` bytes; `out` gets rows * rowbytes bytes; `bpp` is the
// filter's byte distance (bytes a pixel, at least 1).
int iseg_png_unfilter(const uint8_t* in, uint8_t* out, int rows, int rowbytes,
                      int bpp) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* f = in + (size_t)r * (rowbytes + 1);
    int type = f[0];
    const uint8_t* s = f + 1;
    uint8_t* o = out + (size_t)r * rowbytes;
    const uint8_t* u = r ? o - rowbytes : nullptr;
    for (int i = 0; i < rowbytes; ++i) {
      int a = i >= bpp ? o[i - bpp] : 0;
      int b = u ? u[i] : 0;
      int c = (u && i >= bpp) ? u[i - bpp] : 0;
      int x;
      switch (type) {
        case 0: x = 0; break;
        case 1: x = a; break;
        case 2: x = b; break;
        case 3: x = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          x = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return kBadFilter;
      }
      o[i] = (uint8_t)(s[i] + x);
    }
  }
  return kOk;
}

// Bilinear affine warp of a uint8 image [sh, sw, ch] into [dh, dw, ch]:
// `m` is the destination-to-source matrix in float32 (row major, 2 x 3);
// taps outside the source read 0.
int iseg_warp_affine_linear(const uint8_t* src, int sh, int sw, int ch,
                            uint8_t* dst, int dh, int dw, const float* m) {
  const int kVector = 16;
  const int vec = dw - dw % kVector;
  auto tap = [&](int y, int x, int c) -> float {
    if (y < 0 || y >= sh || x < 0 || x >= sw) return 0.0f;
    return (float)src[((size_t)y * sw + x) * ch + c];
  };
  for (int y = 0; y < dh; ++y) {
    const float fy = (float)y;
    const float xb = fy * m[1], yb = fy * m[4];
    const float xc = xb + m[2], yc = yb + m[5];
    for (int x = 0; x < dw; ++x) {
      const float fx = (float)x;
      float sx, sy;
      if (x < vec) {
        sx = std::fmaf(m[0], fx, xc);
        sy = std::fmaf(m[3], fx, yc);
      } else {
        sx = std::fmaf(fx, m[0], xb) + m[2];
        sy = std::fmaf(fx, m[3], yb) + m[5];
      }
      const float x0 = std::floor(sx), y0 = std::floor(sy);
      const float a = sx - x0, b = sy - y0;
      // clamped so that the conversion is defined; every tap out there
      // reads the border
      const int ix = (int)(x0 >= -2.0f ? (x0 <= (float)sw ? x0 : (float)sw)
                                       : -2.0f);
      const int iy = (int)(y0 >= -2.0f ? (y0 <= (float)sh ? y0 : (float)sh)
                                       : -2.0f);
      uint8_t* o = dst + ((size_t)y * dw + x) * ch;
      for (int c = 0; c < ch; ++c) {
        const float p00 = tap(iy, ix, c), p01 = tap(iy, ix + 1, c);
        const float p10 = tap(iy + 1, ix, c), p11 = tap(iy + 1, ix + 1, c);
        const float v0 = std::fmaf(a, p01 - p00, p00);
        const float v1 = std::fmaf(a, p11 - p10, p10);
        const float r = std::fmaf(b, v1 - v0, v0);
        const long q = std::lrint(r);
        o[c] = (uint8_t)(q < 0 ? 0 : q > 255 ? 255 : q);
      }
    }
  }
  return kOk;
}

}  // extern "C"
