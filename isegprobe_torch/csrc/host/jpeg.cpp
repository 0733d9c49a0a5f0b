// Host image work for the data layer: a sequential (baseline and extended
// Huffman) JPEG decoder, a baseline JPEG encoder (below, with its own
// notes), the PNG row unfilter, and the bilinear affine warp of uint8
// images.
//
// The JPEG decoder gives the pixels that libjpeg-turbo gives with its
// default decompression settings, the settings OpenCV's imread uses. A
// progressive file (SOF2: DC and AC first and refinement scans, EOB runs,
// interleaved and not) is decoded into the whole-image coefficient buffer
// and then takes the sequential path. libjpeg-turbo reads a multi-scan file
// to its end before the first output pass, and smooths blocks
// (jdcoefct.c:smoothing_ok) only when a component's coefficients 1-9 are
// then still not fully refined: such a file is refused with its own error
// code, never decoded without the smoothing. Every file:
//   * the accurate integer inverse DCT (JDCT_ISLOW, jidctint.c), with its
//     post-IDCT range-limit table;
//   * "fancy" (triangle-filter) chroma upsampling for h2v1, h1v2 and h2v2
//     (jdsample.c), box replication where a component is at most two
//     samples wide or the ratio is another integer;
//   * the table-driven YCbCr -> RGB conversion (jdcolor.c).
// libjpeg-turbo's SIMD paths are bit-exact with that C code. Arithmetic-
// coded, lossless, 12-bit and four-component files are refused with their
// own error codes. The EXIF orientation tag (APP1, IFD0, tag
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
  kSmoothing = 2,
  kArithmetic = 3,
  kUnsupported = 4,
  kTruncated = 5,
  kBadFilter = 6,
  kSmallBuffer = 7,
  kBadArgument = 8,
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
  // progressive: the Al of the last scan of each zig-zag coefficient, -1
  // before its first scan (libjpeg's coef_bits)
  int coef_bits[64];
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
  bool progressive = false;
  int eobrun = 0;
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

  // jdphuff.c: the four kinds of progressive scan, for one block
  void dc_first(Comp& c, int16_t* blk, int al) {
    int s = decode(dc[c.td]);
    if (s) s = extend(bits(s), s);
    c.pred += s;
    blk[0] = (int16_t)(c.pred * (1 << al));
  }
  void dc_refine(int16_t* blk, int al) {
    if (bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }
  void ac_first(Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& t = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(r);
        --eobrun;
        break;
      }
    }
  }
  // a coefficient already nonzero takes its correction bit
  void refine_bit(int16_t* coef, int p1) {
    if (bits(1) && (*coef & p1) == 0)
      *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
  }
  void ac_refine(Comp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    const Huff& t = ac[c.ta];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits(1) ? p1 : m1;  // s != 1 is corrupt; libjpeg goes on too
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* coef = &blk[kNatural[k]];
          if (*coef != 0) {
            refine_bit(coef, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef != 0) refine_bit(coef, p1);
      }
      --eobrun;
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
    eobrun = 0;
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
    }
    int ss = u8(), se = u8(), a = u8();
    if (a < 0) return kTruncated;
    int ah = a >> 4, al = a & 15;
    // the scan's kind: 0 sequential, 1 DC first, 2 DC refine, 3 AC first,
    // 4 AC refine
    int kind = 0;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return kCorrupt;
      if (al > 13 || (ah && al != ah - 1)) return kCorrupt;
      kind = ss == 0 ? (ah ? 2 : 1) : (ah ? 4 : 3);
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) comp[idx[i]].coef_bits[k] = al;
    }
    for (int i = 0; i < ns; ++i) {
      const Comp& c = comp[idx[i]];
      if ((kind == 0 || kind == 1) && !dc[c.td].present) return kCorrupt;
      if ((kind == 0 || kind >= 3) && !ac[c.ta].present) return kCorrupt;
    }
    pos = end;
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
    buf = 0;
    nbits = 0;
    marker_hit = false;
    eobrun = 0;
    auto one = [&](Comp& c, int16_t* blk) {
      switch (kind) {
        case 0: block(c, blk); break;
        case 1: dc_first(c, blk, al); break;
        case 2: dc_refine(blk, al); break;
        case 3: ac_first(c, blk, ss, se, al); break;
        default: ac_refine(c, blk, ss, se, al); break;
      }
    };
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
          one(c, &c.coef[((size_t)y * c.bw + x) * 64]);
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
                one(c, &c.coef[(by * c.bw + bx) * 64]);
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
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) return kCorrupt;
        progressive = m == 0xC2;
        int rc = sof();
        if (rc) return rc;
      } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD ||
                 m == 0xCE || m == 0xCF) {
        return kArithmetic;
      } else if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7) {
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
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
    return kOk;
  }

  // jdcoefct.c:smoothing_ok once every scan is in: every component has DC
  // data and nonzero quantizers 0-9, and some component's coefficients 1-9
  // are not fully refined
  bool smooths() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Comp& c = comp[i];
      for (int j = 0; j < 10; ++j)
        if (qt[c.tq][kPos[j]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
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

// ---------------------------------------------------------------------------
// Baseline JPEG encoder: the file libjpeg-turbo writes with OpenCV's
// imwrite settings (no optimized tables, no restarts, not progressive):
// the Annex K tables scaled by jpeg_quality_scaling (forced to 8 bits),
// the table-driven RGB -> YCbCr conversion (jccolor.c), 2x2 chroma
// subsampling with the alternating 1, 2 bias (jcsample.c h2v2), edges
// replicated as the preprocessing controller replicates them (the last
// column; the last row of each component after downsampling), dummy blocks
// with the neighbouring DC past the component's blocks (jccoefct.c), the
// accurate integer forward DCT (jfdctint.c), quantization by 16-bit
// reciprocal (jcdctmgr.c, the SIMD build's), and the standard Huffman
// tables. libjpeg-turbo's SIMD paths are bit-exact with that C code.

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  const uint8_t* bits;  // bits[1..16]
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  void derive(const uint8_t* b, const uint8_t* v) {
    bits = b;
    vals = v;
    nvals = 0;
    for (int l = 1; l <= 16; ++l) nvals += b[l];
    std::memset(size, 0, sizeof size);
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < b[l]; ++i, ++k) {
        code[v[k]] = (uint16_t)c++;
        size[v[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t byte = (uint8_t)(acc >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {
    if (nbits) put(0x7F, 7);  // pad with 1-bits to the byte boundary
    nbits = 0;
    acc = 0;
  }
};

// libjpeg's jpeg_fdct_islow on level-shifted samples, in place; outputs
// are scaled up by 8
void fdct_islow(int* d) {
  const int kConst = 13, kPass1 = 2;
  auto descale = [](long x, int n) { return (int)((x + (1L << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int stride = pass ? 8 : 1;   // element step within a line
    const int advance = pass ? 1 : 8;  // step between lines
    const int shift_even = pass ? kPass1 : 0;
    const int shift_odd = pass ? kConst + kPass1 : kConst - kPass1;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int* p = d + ctr * advance;
      long t0 = p[0] + p[7 * stride], t7 = p[0] - p[7 * stride];
      long t1 = p[stride] + p[6 * stride], t6 = p[stride] - p[6 * stride];
      long t2 = p[2 * stride] + p[5 * stride],
           t5 = p[2 * stride] - p[5 * stride];
      long t3 = p[3 * stride] + p[4 * stride],
           t4 = p[3 * stride] - p[4 * stride];
      long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (pass == 0) {
        p[0] = (int)((t10 + t11) * (1 << kPass1));
        p[4 * stride] = (int)((t10 - t11) * (1 << kPass1));
      } else {
        p[0] = descale(t10 + t11, shift_even);
        p[4 * stride] = descale(t10 - t11, shift_even);
      }
      long z1 = (t12 + t13) * 4433;
      p[2 * stride] = descale(z1 + t13 * 6270, shift_odd);
      p[6 * stride] = descale(z1 + t12 * -15137, shift_odd);
      z1 = t4 + t7;
      long z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      long z5 = (z3 + z4) * 9633;
      t4 *= 2446;
      t5 *= 16819;
      t6 *= 25172;
      t7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      p[7 * stride] = descale(t4 + z1 + z3, shift_odd);
      p[5 * stride] = descale(t5 + z2 + z4, shift_odd);
      p[3 * stride] = descale(t6 + z2 + z3, shift_odd);
      p[stride] = descale(t7 + z1 + z4, shift_odd);
    }
  }
}

// jcdctmgr.c's compute_reciprocal with 16-bit DCTELEM
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // floor(log2)
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

int quantize(int v, const Divisor& q) {
  const uint32_t a = (uint32_t)(v < 0 ? -v : v);
  const uint32_t prod = (a + q.corr) * q.recip;
  const int t = (int)(prod >> q.shift);
  return v < 0 ? -t : t;
}

struct EncComp {
  int id, h, v, tq;
  int bw, bh;  // the component's blocks (width_in_blocks, height_in_blocks)
  int pw, ph;  // the plane's size (bw * 8 rounded up to the MCU, ...)
  std::vector<uint8_t> plane;
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void emit_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
              const uint8_t* vals, int nvals) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + nvals);
  o.push_back((uint8_t)cls_id);
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < nvals; ++i) o.push_back(vals[i]);
}

// The encoder behind iseg_jpeg_encode: `px` is [h, w, channels] (RGB or
// gray), `quality` 1-100.
void jpeg_encode(const uint8_t* px, int h, int w, int channels, int quality,
                 std::vector<uint8_t>& out) {
  // jpeg_quality_scaling and jpeg_add_quant_table(force_baseline)
  int q = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  const int scale = q < 50 ? 5000 / q : 200 - q * 2;
  uint16_t qt[2][64];
  Divisor dv[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((long)(t ? kStdChromQ : kStdLumQ)[i] * scale + 50L) / 100L;
      v = v <= 0 ? 1 : v > 255 ? 255 : v;
      qt[t][i] = (uint16_t)v;
      dv[t][i] = reciprocal((uint16_t)(v << 3));
    }
  HuffEnc dc[2], ac[2];
  dc[0].derive(kDcLumBits, kDcVals);
  dc[1].derive(kDcChromBits, kDcVals);
  ac[0].derive(kAcLumBits, kAcLumVals);
  ac[1].derive(kAcChromBits, kAcChromVals);

  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, vmax = color ? 2 : 1;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  const int ncomp = color ? 3 : 1;
  std::vector<EncComp> comps(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    EncComp& c = comps[ci];
    c.id = ci + 1;
    c.h = ci == 0 ? hmax : 1;
    c.v = ci == 0 ? vmax : 1;
    c.tq = ci == 0 ? 0 : 1;
    c.bw = (w * c.h + 8 * hmax - 1) / (8 * hmax);
    c.bh = (h * c.v + 8 * vmax - 1) / (8 * vmax);
    c.pw = mcux * 8 * c.h;
    c.ph = mcuy * 8 * c.v;
    c.plane.assign((size_t)c.pw * c.ph, 0);
  }

  // colour conversion at full resolution, edges replicated
  const int fw = color ? mcux * 16 : comps[0].pw;  // full-res plane width
  const int fh = color ? (h + 1) / 2 * 2 : h;      // full rows kept
  std::vector<std::vector<uint8_t>> full(ncomp,
                                         std::vector<uint8_t>((size_t)fw * fh));
  // jccolor.c's rgb_ycc_tab (Y, Cb and Cr by table lookups and a 16-bit
  // shift; the B->Cb and R->Cr columns are one)
  static const std::vector<int32_t> tab = [] {
    std::vector<int32_t> t(8 * 256);
    const int32_t half = 1 << 15, off = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      t[i] = fix(0.29900) * i;
      t[i + 256] = fix(0.58700) * i;
      t[i + 512] = fix(0.11400) * i + half;
      t[i + 768] = -fix(0.16874) * i;
      t[i + 1024] = -fix(0.33126) * i;
      t[i + 1280] = fix(0.50000) * i + off + half - 1;
      t[i + 1536] = -fix(0.41869) * i;
      t[i + 1792] = -fix(0.08131) * i;
    }
    return t;
  }();
  for (int y = 0; y < fh; ++y) {
    const uint8_t* row = px + (size_t)(y < h ? y : h - 1) * w * channels;
    for (int x = 0; x < fw; ++x) {
      const uint8_t* p = row + (size_t)(x < w ? x : w - 1) * channels;
      const size_t o = (size_t)y * fw + x;
      if (!color) {
        full[0][o] = p[0];
        continue;
      }
      const int r = p[0], g = p[1], b = p[2];
      full[0][o] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
      full[1][o] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
      full[2][o] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
    }
  }
  // downsampling; the last row of each component replicated to the MCU
  for (int ci = 0; ci < ncomp; ++ci) {
    EncComp& c = comps[ci];
    const bool sub = color && ci > 0;
    const int rows = sub ? fh / 2 : fh;
    for (int y = 0; y < c.ph; ++y) {
      uint8_t* o = &c.plane[(size_t)y * c.pw];
      const int sy = y < rows ? y : rows - 1;
      if (!sub) {
        std::memcpy(o, &full[ci][(size_t)sy * fw], c.pw);
        continue;
      }
      const uint8_t* r0 = &full[ci][(size_t)(2 * sy) * fw];
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (int x = 0; x < c.pw; ++x) {
        o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
                          bias) >> 2);
        bias ^= 3;
      }
    }
  }

  // headers
  out.clear();
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',  'F',
                              'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                              0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), soi_app0, soi_app0 + sizeof soi_app0);
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) out.push_back((uint8_t)qt[t][kNatural[k]]);
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * ncomp);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back((uint8_t)ncomp);
  for (auto& c : comps) {
    out.push_back((uint8_t)c.id);
    out.push_back((uint8_t)((c.h << 4) | c.v));
    out.push_back((uint8_t)c.tq);
  }
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    emit_dht(out, t, dc[t].bits, dc[t].vals, dc[t].nvals);
    emit_dht(out, 0x10 | t, ac[t].bits, ac[t].vals, ac[t].nvals);
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * ncomp);
  out.push_back((uint8_t)ncomp);
  for (auto& c : comps) {
    out.push_back((uint8_t)c.id);
    out.push_back((uint8_t)((c.tq << 4) | c.tq));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // scan
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int blk[64], coef[4][64];
  auto encode_block = [&](const int* c, int ci, int t) {
    int temp = c[0] - last_dc[ci], temp2 = temp;
    last_dc[ci] = c[0];
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nbits = 0;
    while (temp) {
      ++nbits;
      temp >>= 1;
    }
    bw.put(dc[t].code[nbits], dc[t].size[nbits]);
    if (nbits) bw.put((uint32_t)temp2, nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = c[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        run -= 16;
      }
      int a = v, a2 = v;
      if (a < 0) {
        a = -a;
        --a2;
      }
      nbits = 1;
      while ((a >>= 1)) ++nbits;
      const int sym = (run << 4) + nbits;
      bw.put(ac[t].code[sym], ac[t].size[sym]);
      bw.put((uint32_t)a2, nbits);
      run = 0;
    }
    if (run > 0) bw.put(ac[t].code[0], ac[t].size[0]);
  };
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int ci = 0; ci < ncomp; ++ci) {
        EncComp& c = comps[ci];
        int n = 0;
        for (int by = 0; by < c.v; ++by) {
          for (int bx = 0; bx < c.h; ++bx, ++n) {
            const int gy = my * c.v + by, gx = mx * c.h + bx;
            int* out_blk = coef[n];
            if (gy >= c.bh) {  // a row of dummy blocks at the bottom
              std::memset(out_blk, 0, sizeof coef[0]);
              out_blk[0] = coef[by * c.h - 1][0];
              continue;
            }
            if (gx >= c.bw) {  // a dummy block at the right edge
              std::memset(out_blk, 0, sizeof coef[0]);
              out_blk[0] = coef[n - 1][0];
              continue;
            }
            for (int r = 0; r < 8; ++r) {
              const uint8_t* s = &c.plane[(size_t)(gy * 8 + r) * c.pw + gx * 8];
              for (int k = 0; k < 8; ++k) blk[r * 8 + k] = (int)s[k] - 128;
            }
            fdct_islow(blk);
            for (int k = 0; k < 64; ++k)
              out_blk[k] = quantize(blk[k], dv[c.tq][k]);
          }
        }
        for (int k = 0; k < n; ++k) encode_block(coef[k], ci, c.tq);
      }
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

}  // namespace

extern "C" {

const char* iseg_host_error(int code) {
  switch (code) {
    case kOk: return "ok";
    case kCorrupt: return "not a JPEG file or a corrupt one";
    case kSmoothing:
      return "progressive JPEG whose scans leave coefficients 1-9 of a "
             "component unrefined (libjpeg-turbo block-smooths it) is not "
             "supported";
    case kArithmetic: return "arithmetic-coded JPEG is not supported";
    case kUnsupported:
      return "unsupported JPEG (lossless, 12-bit, 2 or 4 components, "
             "non-integral sampling, or over 2^28 pixels)";
    case kTruncated: return "truncated JPEG";
    case kBadFilter: return "PNG row filter type out of range";
    case kSmallBuffer: return "output buffer too small";
    case kBadArgument: return "JPEG encoder takes 1 or 3 channels and a "
                              "size of 1 to 65535 pixels a side";
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
  if (dec.smooths()) return kSmoothing;
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

// Encode [h, w, channels] uint8 pixels (RGB, or gray with channels = 1) as
// the baseline JPEG that OpenCV's imwrite writes at `quality`; the file's
// size goes to *n. If it exceeds `cap`, nothing is written to `out` and
// kSmallBuffer is returned with the size needed in *n.
int iseg_jpeg_encode(const uint8_t* px, int h, int w, int channels,
                     int quality, uint8_t* out, size_t cap, size_t* n) {
  if ((channels != 1 && channels != 3) || h < 1 || w < 1 || h > 65535 ||
      w > 65535)
    return kBadArgument;
  std::vector<uint8_t> buf;
  jpeg_encode(px, h, w, channels, quality, buf);
  *n = buf.size();
  if (buf.size() > cap) return kSmallBuffer;
  std::memcpy(out, buf.data(), buf.size());
  return kOk;
}

}  // extern "C"
