// Baseline, extended sequential and progressive Huffman JPEG decoder,
// host C++, bound with ctypes by vatl4pose_tpu_torch/data/image_io.py.
//
// The output is bit-identical to libjpeg-turbo's defaults as
// cv2.imread(path, IMREAD_COLOR) uses them, converted to RGB:
//   * the ISLOW integer IDCT (jidctint.c: 13-bit constants, 2 pass-1 bits,
//     the post-IDCT range-limit table indexed with RANGE_MASK);
//   * fancy upsampling (jdsample.c): the triangle filters of h2v1, h2v2
//     (when the component is more than two samples wide, else
//     replication) and h1v2, other integer ratios by replication; the
//     sample rows above the first and below the last repeat them
//     (jdmainct.c's context pointers);
//   * the fixed-point YCbCr->RGB tables of jdcolor.c (16 scale bits);
//   * a grayscale image replicated into three channels.
// EXIF orientation is read here (jpeg_info) and applied by the caller.
//
// 8-bit SOF0/SOF1/SOF2 frames of 1 or 3 components, any integer sampling
// ratio, one interleaved scan or several (non-interleaved, Huffman tables
// redefined between them), restart intervals; APPn and COM segments are
// skipped.  A progressive (SOF2) file's scans are read as jdphuff.c reads
// them: DC first and refinement scans (interleaved or not), AC first and
// refinement scans of one component with spectral selection, successive
// approximation and end-of-band runs; once every scan is read the
// coefficients are the file's, and the IDCT, upsampling and colour paths
// are the sequential ones (libjpeg's block smoothing changes nothing on a
// complete file, whose last scans leave no coefficient bits unknown).
// Each component's delivered bits are tracked as jdphuff.c's coef_bits:
// a scan whose Ah does not follow the previous scan of its coefficients,
// an AC scan before the DC one, and a file whose scans leave any
// coefficient unknown or partly read are refused.
// Arithmetic, lossless and hierarchical frames, 12-bit samples,
// CMYK/YCCK, RGB (Adobe transform 0 or 'R','G','B' component ids) and DNL
// are refused with an error naming the marker.  Corrupt or truncated
// entropy-coded data is refused too (libjpeg would warn and fill with
// zeros).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread jpeg_decode.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &msg) { throw Error(msg); }

std::string hex_marker(int m) {
  char buf[16];
  std::snprintf(buf, sizeof buf, "0xFF%02X", m);
  return buf;
}

// jpeg_natural_order plus 16 guard entries (jutils.c): a run past the
// block's end writes coefficient 63, as libjpeg does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];

  // jdhuff.c jpeg_make_d_derived_tbl: canonical codes from the counts
  void build(const uint8_t *counts, const uint8_t *symbols, int nsym,
             bool dc) {
    std::memcpy(vals, symbols, nsym);
    std::memset(look_len, 0, sizeof look_len);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      valoff[len] = k - code;
      int n = counts[len - 1];
      for (int i = 0; i < n; i++, k++, code++) {
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); j++) {
            look_len[(code << shift) | j] = uint8_t(len);
            look_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = n ? code - 1 : -1;
      // no code may be all ones
      if (n && code >= (1 << len)) fail("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    if (dc)
      for (int i = 0; i < nsym; i++)
        if (symbols[i] > 15) fail("bad DC Huffman table (symbol above 15)");
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;        // blocks in the padded, interleaved layout
  int width = 0, height = 0; // downsampled_width / _height
  bool latched = false;      // quant table copied at its first scan
  int16_t quant[64];         // natural order, ISLOW_MULT_TYPE (short)
  // progressive: the lowest bit of each coefficient (zigzag order) that
  // the scans so far delivered, -1 before its first scan (jdphuff.c's
  // coef_bits)
  int8_t coef_bits[64];
  std::vector<int16_t> coef; // bh * bw blocks of 64, natural order
};

struct Frame {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  int mcusx = 0, mcusy = 0;
  Component comp[3];
};

// The entropy-coded segment's bits, MSB first, with FF 00 unstuffed; at a
// marker no byte is consumed and zero bits stand in (libjpeg's
// fill_bit_buffer), which count as an overrun if decoding uses them.
struct BitReader {
  const uint8_t *data;
  size_t size, pos;
  uint64_t acc = 0;
  int nbits = 0, fake = 0;
  bool at_marker = false, overrun = false;

  BitReader(const uint8_t *d, size_t n, size_t p) : data(d), size(n), pos(p) {}

  void fill() {
    while (nbits <= 56) {
      int c = 0;
      if (!at_marker && pos < size) {
        c = data[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) q++;
          if (q < size && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;   // pos stays on the marker's first FF
            c = 0;
          }
        } else {
          pos++;
        }
      } else {
        at_marker = true;
      }
      if (at_marker) fake += 8;
      acc = (acc << 8) | uint64_t(c);
      nbits += 8;
    }
  }

  inline void consume(int n) {
    nbits -= n;
    if (nbits < fake) overrun = true;
  }

  inline int peek(int n) {
    if (nbits < n) fill();
    return int((acc >> (nbits - n)) & ((uint64_t(1) << n) - 1));
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    consume(n);
    return v;
  }

  inline int decode(const Huffman &t) {
    if (nbits < 16) fill();
    int look = int((acc >> (nbits - kLookBits)) & ((1 << kLookBits) - 1));
    int len = t.look_len[look];
    if (len) {
      consume(len);
      return t.look_val[look];
    }
    for (len = kLookBits + 1; len <= 16; len++) {
      int code = int((acc >> (nbits - len)) & ((1 << len) - 1));
      if (code <= t.maxcode[len]) {
        consume(len);
        return t.vals[t.valoff[len] + code];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }

  // drop what is left of the current byte and of the bit buffer: the
  // reader then stands on the next marker (restart or end of scan)
  void reset() {
    acc = 0;
    nbits = fake = 0;
    at_marker = false;
  }
};

// jdhuff.c HUFF_EXTEND: the s-bit value v as a signed magnitude
inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return int32_t((x + (int64_t(1) << (n - 1))) >> n);
}

// jdmaster.c prepare_range_limit_table: the post-IDCT part, indexed by
// (x & 1023) where x is the sample before the +128 level shift
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; v++) {
      if (v < 128) t[v] = uint8_t(v + 128);
      else if (v < 512) t[v] = 255;
      else if (v < 896) t[v] = 0;
      else t[v] = uint8_t(v - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *p = in + c;
    const int16_t *qp = q + c;
    int *w = ws + c;
    if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
      int dc = (int(p[0]) * int(qp[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(p[16]) * qp[16], z3 = int64_t(p[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(p[0]) * qp[0];
    z3 = int64_t(p[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(p[56]) * qp[56];
    tmp1 = int64_t(p[40]) * qp[40];
    tmp2 = int64_t(p[24]) * qp[24];
    tmp3 = int64_t(p[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int32_t half = int32_t(1) << (kScale - 1);
    auto fix = [&](double x) { return int32_t(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Segment {
  int marker;
  size_t start, length;   // payload (after the 2 length bytes)
};

class Decoder {
 public:
  Decoder(const uint8_t *data, size_t size) : d_(data), n_(size) {}

  // headers up to the first SOS: size, components, EXIF orientation
  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!frame_seen_) fail("SOS before the frame header (SOF)");
        sos_pos_ = pos_;
        return;
      }
      if (m == 0xD9) fail("EOI before any scan");
      handle_segment(m);
    }
  }

  int width() const { return f_.width; }
  int height() const { return f_.height; }
  int components() const { return f_.ncomp; }
  int orientation() const { return orientation_; }

  void decode(uint8_t *rgb) {
    pos_ = sos_pos_;
    int m = 0xDA;
    for (;;) {
      if (m == 0xDA) {
        scan();
        scans_++;
      } else if (m == 0xD9) {
        break;
      } else {
        handle_segment(m);
      }
      if (pos_ >= n_) break;   // no EOI: what was decoded stands
      m = next_marker();
    }
    for (int c = 0; c < f_.ncomp; c++) {
      const Component &k = f_.comp[c];
      if (!k.latched)
        fail("component " + std::to_string(k.id) + " is in no scan");
      // an incomplete scan script: libjpeg-turbo would smooth the blocks
      // whose low coefficients are unknown, so its pixels are not these
      for (int z = 0; progressive_ && z < 64; z++)
        if (k.coef_bits[z] != 0)
          fail("incomplete progressive JPEG: component " +
               std::to_string(k.id) + " coefficient " + std::to_string(z) +
               (k.coef_bits[z] < 0
                    ? std::string(" is in no scan")
                    : " lacks its low " + std::to_string(k.coef_bits[z]) +
                          " bits"));
    }
    output(rgb);
  }

 private:
  const uint8_t *d_;
  size_t n_, pos_ = 0, sos_pos_ = 0;
  Frame f_;
  bool frame_seen_ = false, jfif_ = false, adobe_ = false;
  bool progressive_ = false;
  bool app1_seen_ = false;
  int adobe_transform_ = -1, orientation_ = 1;
  int restart_interval_ = 0, scans_ = 0;
  int16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];

  int u16(size_t p) const {
    if (p + 2 > n_) fail("truncated JPEG header");
    return (d_[p] << 8) | d_[p + 1];
  }

  // skips fill bytes (and, as libjpeg's next_marker does, stray data)
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      if (pos_ >= n_) fail("truncated JPEG file (no marker where one is due)");
      int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  Segment segment(int marker) {
    int len = u16(pos_);
    if (len < 2 || pos_ + len > n_)
      fail("truncated segment " + hex_marker(marker));
    Segment s{marker, pos_ + 2, size_t(len - 2)};
    pos_ += len;
    return s;
  }

  void handle_segment(int m) {
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        progressive_ = m == 0xC2;
        sof(segment(m));
        return;
      case 0xC3:
        fail("lossless JPEG (SOF3, marker 0xFFC3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("hierarchical JPEG (marker " + hex_marker(m) +
             ") is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xCC:
        fail("arithmetic-coded JPEG (marker " + hex_marker(m) +
             ") is not supported");
      case 0xC4:
        dht(segment(m));
        return;
      case 0xDB:
        dqt(segment(m));
        return;
      case 0xDD: {
        Segment s = segment(m);
        if (s.length != 2) fail("bad DRI segment");
        restart_interval_ = u16(s.start);
        return;
      }
      case 0xDC:
        fail("DNL marker (0xFFDC) is not supported");
      case 0xFE:
        segment(m);
        return;
      case 0xD8:
        fail("a second SOI marker");
      default:
        break;
    }
    if (m >= 0xE0 && m <= 0xEF) {
      app(segment(m));
      return;
    }
    if (m >= 0xD0 && m <= 0xD7)
      fail("restart marker " + hex_marker(m) + " outside a scan");
    fail("unsupported JPEG marker " + hex_marker(m));
  }

  void app(const Segment &s) {
    const uint8_t *p = d_ + s.start;
    if (s.marker == 0xE0 && s.length >= 14 && !std::memcmp(p, "JFIF\0", 5))
      jfif_ = true;
    if (s.marker == 0xEE && s.length >= 12 && !std::memcmp(p, "Adobe", 5)) {
      adobe_ = true;
      adobe_transform_ = p[11];
    }
    if (s.marker == 0xE1 && !app1_seen_) {
      // OpenCV reads the first APP1 segment, 6 bytes ("Exif\0\0") past
      // its start, as a TIFF header and IFD0
      app1_seen_ = true;
      if (s.length > 6) exif(p + 6, s.length - 6);
    }
  }

  void exif(const uint8_t *t, size_t n) {
    if (n < 8 || t[0] != t[1] || (t[0] != 'I' && t[0] != 'M')) return;
    bool le = t[0] == 'I';
    auto g16 = [&](size_t o) -> int {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto g32 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                      (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24)
                : (uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                      (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]);
    };
    if (g16(2) != 0x2A) return;
    size_t off = g32(4);
    if (off + 2 > n) return;
    int count = g16(off);
    off += 2;
    for (int i = 0; i < count && off + 12 <= n; i++, off += 12)
      if (g16(off) == 0x0112) {
        orientation_ = g16(off + 8);
        return;
      }
  }

  void sof(const Segment &s) {
    if (frame_seen_) fail("a second frame header (SOF)");
    const uint8_t *p = d_ + s.start;
    if (s.length < 6) fail("bad SOF segment");
    if (p[0] != 8)
      fail(std::to_string(p[0]) + "-bit JPEG samples (SOF marker " +
           hex_marker(s.marker) + ") are not supported, only 8-bit");
    f_.height = u16(s.start + 1);
    f_.width = u16(s.start + 3);
    f_.ncomp = p[5];
    if (f_.height == 0)
      fail("a JPEG whose height comes in a DNL segment is not supported");
    if (f_.width == 0) fail("a JPEG of width 0");
    if (f_.ncomp == 4)
      fail("a 4-component (CMYK/YCCK) JPEG (SOF marker " +
           hex_marker(s.marker) + ") is not supported");
    if (f_.ncomp != 1 && f_.ncomp != 3)
      fail(std::to_string(f_.ncomp) + "-component JPEG is not supported");
    if (s.length != size_t(6 + 3 * f_.ncomp)) fail("bad SOF segment length");
    for (int c = 0; c < f_.ncomp; c++) {
      Component &k = f_.comp[c];
      k.id = p[6 + 3 * c];
      k.h = p[7 + 3 * c] >> 4;
      k.v = p[7 + 3 * c] & 15;
      k.tq = p[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail("bad sampling factors or quantisation table in SOF");
      f_.max_h = std::max(f_.max_h, k.h);
      f_.max_v = std::max(f_.max_v, k.v);
    }
    f_.mcusx = (f_.width + 8 * f_.max_h - 1) / (8 * f_.max_h);
    f_.mcusy = (f_.height + 8 * f_.max_v - 1) / (8 * f_.max_v);
    for (int c = 0; c < f_.ncomp; c++) {
      Component &k = f_.comp[c];
      if (f_.max_h % k.h || f_.max_v % k.v)
        fail("fractional sampling ratios are not supported");
      k.bw = f_.mcusx * k.h;
      k.bh = f_.mcusy * k.v;
      k.width = int((int64_t(f_.width) * k.h + f_.max_h - 1) / f_.max_h);
      k.height = int((int64_t(f_.height) * k.v + f_.max_v - 1) / f_.max_v);
    }
    frame_seen_ = true;
  }

  void dqt(const Segment &s) {
    size_t p = s.start, end = s.start + s.length;
    while (p < end) {
      int pq = d_[p] >> 4, tq = d_[p] & 15;
      p++;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      if (p + (pq ? 128 : 64) > end) fail("truncated DQT segment");
      for (int k = 0; k < 64; k++) {
        int v = pq ? (d_[p + 2 * k] << 8) | d_[p + 2 * k + 1] : d_[p + k];
        qt_[tq][kNatural[k]] = int16_t(v);
      }
      p += pq ? 128 : 64;
      qt_defined_[tq] = true;
    }
  }

  void dht(const Segment &s) {
    size_t p = s.start, end = s.start + s.length;
    while (p < end) {
      if (p + 17 > end) fail("truncated DHT segment");
      int tc = d_[p] >> 4, th = d_[p] & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      const uint8_t *counts = d_ + p + 1;
      int nsym = 0;
      for (int i = 0; i < 16; i++) nsym += counts[i];
      if (nsym > 256 || p + 17 + nsym > end) fail("bad DHT segment");
      (tc ? ac_ : dc_)[th].build(counts, d_ + p + 17, nsym, tc == 0);
      p += 17 + nsym;
    }
  }

  void check_color_space() {
    if (f_.ncomp != 3) return;
    if (jfif_) return;
    if (adobe_) {
      if (adobe_transform_ == 1) return;
      fail("an Adobe APP14 transform " + std::to_string(adobe_transform_) +
           " (RGB or YCCK) is not supported");
    }
    if (f_.comp[0].id == 82 && f_.comp[1].id == 71 && f_.comp[2].id == 66)
      fail("an RGB JPEG (component ids 'R','G','B') is not supported");
  }

  void scan() {
    if (scans_ == 0) check_color_space();
    Segment s = segment(0xDA);
    const uint8_t *p = d_ + s.start;
    int ns = p[0];
    if (ns < 1 || ns > 4 || s.length != size_t(4 + 2 * ns))
      fail("bad SOS segment");
    const int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
    const int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail("a scan with spectral selection or successive approximation "
             "in a sequential JPEG");
    } else if ((ss == 0) != (se == 0) || se < ss || se > 63 || al > 13 ||
               (ss > 0 && ns != 1) || (ah != 0 && al != ah - 1)) {
      fail("bad progressive scan parameters (Ss " + std::to_string(ss) +
           ", Se " + std::to_string(se) + ", Ah " + std::to_string(ah) +
           ", Al " + std::to_string(al) + ")");
    }
    // which tables the scan codes with: DC first scans the DC table,
    // AC scans the AC table, DC refinement none (jdphuff.c)
    const bool dc_first = ss == 0 && (!progressive_ || ah == 0);
    const bool need_ac = !progressive_ || ss > 0;
    Component *sc[4];
    for (int i = 0; i < ns; i++) {
      int id = p[1 + 2 * i], t = p[2 + 2 * i];
      Component *k = nullptr;
      for (int c = 0; c < f_.ncomp; c++)
        if (f_.comp[c].id == id) k = &f_.comp[c];
      if (!k) fail("SOS names a component the frame does not have");
      k->dc_tbl = t >> 4;
      k->ac_tbl = t & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3 ||
          (dc_first && !dc_[k->dc_tbl].defined) ||
          (need_ac && !ac_[k->ac_tbl].defined))
        fail("SOS uses a Huffman table that is not defined");
      if (!k->latched) {   // jdinput.c latch_quant_tables
        if (!qt_defined_[k->tq]) fail("a quantisation table is missing");
        std::memcpy(k->quant, qt_[k->tq], sizeof k->quant);
        k->coef.assign(size_t(k->bw) * k->bh * 64, 0);
        std::memset(k->coef_bits, -1, sizeof k->coef_bits);
        k->latched = true;
      }
      if (progressive_) {   // jdphuff.c start_pass_phuff_decoder
        if (ss > 0 && k->coef_bits[0] < 0)
          fail("bad progression: an AC scan of component " +
               std::to_string(id) + " before its first DC scan");
        for (int z = ss; z <= se; z++) {
          int expected = k->coef_bits[z] < 0 ? 0 : k->coef_bits[z];
          if (ah != expected)
            fail("bad progression: component " + std::to_string(id) +
                 " coefficient " + std::to_string(z) + " scanned with Ah " +
                 std::to_string(ah) + " where " + std::to_string(expected) +
                 " is due");
          k->coef_bits[z] = int8_t(al);
        }
      }
      sc[i] = k;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail("too many blocks in an MCU");
    }

    BitReader br(d_, n_, pos_);
    int pred[4] = {0, 0, 0, 0};
    long eobrun = 0;
    int restarts_to_go = restart_interval_, next_rst = 0;
    auto restart = [&]() {
      br.reset();
      size_t q = br.pos;
      while (q < n_ && d_[q] == 0xFF) q++;
      if (q >= n_ || d_[q] != 0xD0 + next_rst)
        fail("corrupt JPEG data: restart marker RST" +
             std::to_string(next_rst) + " missing");
      br.pos = q + 1;
      next_rst = (next_rst + 1) & 7;
      restarts_to_go = restart_interval_;
      for (int &v : pred) v = 0;
      eobrun = 0;
    };
    // jdhuff.c decode_mcu (sequential)
    auto sequential = [&](Component *k, int i, int16_t *b) {
      int s = br.decode(dc_[k->dc_tbl]);
      int diff = s ? extend(br.bits(s), s) : 0;
      pred[i] += diff;
      b[0] = int16_t(pred[i]);
      const Huffman &ac = ac_[k->ac_tbl];
      for (int z = 1; z < 64; z++) {
        int rs = br.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          z += r;
          b[kNatural[z]] = int16_t(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          z += 15;
        }
      }
    };
    // jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine
    auto dc_scan = [&](Component *k, int i, int16_t *b) {
      if (ah == 0) {
        int s = br.decode(dc_[k->dc_tbl]);
        int diff = s ? extend(br.bits(s), s) : 0;
        pred[i] += diff;
        b[0] = int16_t(int32_t(uint32_t(pred[i]) << al));
      } else if (br.bits(1)) {
        b[0] = int16_t(b[0] | (1 << al));
      }
    };
    auto ac_first = [&](Component *k, int16_t *b) {
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      const Huffman &ac = ac_[k->ac_tbl];
      for (int z = ss; z <= se; z++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          z += r;
          b[kNatural[z]] =
              int16_t(int32_t(uint32_t(extend(br.bits(s), s)) << al));
        } else if (r == 15) {
          z += 15;
        } else {
          eobrun = (1L << r) - 1;
          if (r) eobrun += br.bits(r);
          break;
        }
      }
    };
    auto ac_refine = [&](Component *k, int16_t *b) {
      const int p1 = 1 << al, m1 = -(1 << al);
      auto correct = [&](int16_t *c) {
        if (br.bits(1) && (*c & p1) == 0)
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
      };
      int z = ss;
      if (eobrun == 0) {
        const Huffman &ac = ac_[k->ac_tbl];
        for (; z <= se; z++) {
          int rs = br.decode(ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {   // libjpeg warns when s != 1 and reads one bit
            s = br.bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1L << r;
            if (r) eobrun += br.bits(r);
            break;
          }
          do {
            int16_t *c = b + kNatural[z];
            if (*c != 0) {
              correct(c);
            } else if (--r < 0) {
              break;
            }
            z++;
          } while (z <= se);
          if (s) b[kNatural[z]] = int16_t(s);
        }
      }
      if (eobrun > 0) {
        for (; z <= se; z++) {
          int16_t *c = b + kNatural[z];
          if (*c != 0) correct(c);
        }
        eobrun--;
      }
    };
    auto block = [&](Component *k, int i, int by, int bx) {
      int16_t *b = k->coef.data() + (size_t(by) * k->bw + bx) * 64;
      if (!progressive_) sequential(k, i, b);
      else if (ss == 0) dc_scan(k, i, b);
      else if (ah == 0) ac_first(k, b);
      else ac_refine(k, b);
    };
    auto mcu_start = [&](long index) {
      if (restart_interval_ && index > 0) {
        if (restarts_to_go == 0) restart();
      }
      if (restart_interval_) restarts_to_go--;
    };

    long index = 0;
    if (ns == 1) {
      Component *k = sc[0];
      int bx_n = (k->width + 7) / 8, by_n = (k->height + 7) / 8;
      for (int by = 0; by < by_n; by++)
        for (int bx = 0; bx < bx_n; bx++, index++) {
          mcu_start(index);
          block(k, 0, by, bx);
        }
    } else {
      for (int my = 0; my < f_.mcusy; my++)
        for (int mx = 0; mx < f_.mcusx; mx++, index++) {
          mcu_start(index);
          for (int i = 0; i < ns; i++) {
            Component *k = sc[i];
            for (int v = 0; v < k->v; v++)
              for (int h = 0; h < k->h; h++)
                block(k, i, my * k->v + v, mx * k->h + h);
          }
        }
    }
    if (br.overrun)
      fail("corrupt or truncated JPEG data: the scan ends before its last "
           "MCU");
    br.reset();
    pos_ = br.pos;
  }

  // the component's samples, (bh * 8) rows of (bw * 8)
  std::vector<uint8_t> plane(const Component &k) const {
    int stride = k.bw * 8;
    std::vector<uint8_t> out(size_t(stride) * k.bh * 8);
    for (int by = 0; by < k.bh; by++)
      for (int bx = 0; bx < k.bw; bx++)
        idct_islow(k.coef.data() + (size_t(by) * k.bw + bx) * 64, k.quant,
                   out.data() + size_t(by) * 8 * stride + bx * 8, stride);
    return out;
  }

  // the component at full size (width x height), jdsample.c's methods
  std::vector<uint8_t> upsample(const Component &k) const {
    std::vector<uint8_t> src = plane(k);
    const int sstride = k.bw * 8, W = f_.width, H = f_.height;
    const int hr = f_.max_h / k.h, vr = f_.max_v / k.v;
    const int cw = k.width, ch = k.height;
    std::vector<uint8_t> out(size_t(W) * H);
    auto row = [&](int r) {
      return src.data() + size_t(std::min(std::max(r, 0), ch - 1)) * sstride;
    };
    // one upsampled row (2 * cw wide) into buf, by the h2 triangle filter
    // of columns' values `col(i)` (h2v1: ints already x1, bias (1, 2);
    // h2v2: column sums x4 scale, bias (8, 7))
    std::vector<uint8_t> wide(size_t(std::max(hr, 1)) * cw + 16);
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; y++)
        std::memcpy(out.data() + size_t(y) * W, row(y), W);
    } else if (hr == 2 && vr == 1 && cw > 2) {
      for (int y = 0; y < H; y++) {
        const uint8_t *in = row(y);
        uint8_t *o = wide.data();
        int v = in[0];
        o[0] = uint8_t(v);
        o[1] = uint8_t((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; x++) {
          v = in[x] * 3;
          o[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        v = in[cw - 1];
        o[2 * cw - 2] = uint8_t((v * 3 + in[cw - 2] + 1) >> 2);
        o[2 * cw - 1] = uint8_t(v);
        std::memcpy(out.data() + size_t(y) * W, o, W);
      }
    } else if (hr == 1 && vr == 2) {
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        const uint8_t *in0 = row(r);
        const uint8_t *in1 = row((y & 1) ? r + 1 : r - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t *o = out.data() + size_t(y) * W;
        for (int x = 0; x < W; x++)
          o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (hr == 2 && vr == 2 && cw > 2) {
      std::vector<int> sum(cw);
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        const uint8_t *in0 = row(r);
        const uint8_t *in1 = row((y & 1) ? r + 1 : r - 1);
        for (int x = 0; x < cw; x++) sum[x] = in0[x] * 3 + in1[x];
        uint8_t *o = wide.data();
        int t = sum[0];
        o[0] = uint8_t((t * 4 + 8) >> 4);
        o[1] = uint8_t((t * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < cw - 1; x++) {
          t = sum[x];
          o[2 * x] = uint8_t((t * 3 + sum[x - 1] + 8) >> 4);
          o[2 * x + 1] = uint8_t((t * 3 + sum[x + 1] + 7) >> 4);
        }
        t = sum[cw - 1];
        o[2 * cw - 2] = uint8_t((t * 3 + sum[cw - 2] + 8) >> 4);
        o[2 * cw - 1] = uint8_t((t * 4 + 7) >> 4);
        std::memcpy(out.data() + size_t(y) * W, o, W);
      }
    } else {
      // h2v1 / h2v2 at widths of 1-2 samples, and every other integer
      // ratio: replication (h2v1_upsample, h2v2_upsample, int_upsample)
      for (int y = 0; y < H; y++) {
        const uint8_t *in = src.data() + size_t(y / vr) * sstride;
        uint8_t *o = out.data() + size_t(y) * W;
        for (int x = 0; x < W; x++) o[x] = in[x / hr];
      }
    }
    return out;
  }

  void output(uint8_t *rgb) const {
    const size_t npix = size_t(f_.width) * f_.height;
    if (f_.ncomp == 1) {
      std::vector<uint8_t> g = upsample(f_.comp[0]);
      for (size_t i = 0; i < npix; i++)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> y = upsample(f_.comp[0]);
    std::vector<uint8_t> cb = upsample(f_.comp[1]);
    std::vector<uint8_t> cr = upsample(f_.comp[2]);
    for (size_t i = 0; i < npix; i++) {
      int Y = y[i], b = cb[i], r = cr[i];
      rgb[3 * i] = clamp255(Y + kYcc.cr_r[r]);
      rgb[3 * i + 1] =
          clamp255(Y + int((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
      rgb[3 * i + 2] = clamp255(Y + kYcc.cb_b[b]);
    }
  }
};

void copy_error(const char *msg, char *err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// Header only: width, height, components and EXIF orientation (1 when
// there is none).  Returns 0, or -1 with a message in err.
int jpeg_info(const uint8_t *data, size_t size, int *width, int *height,
              int *components, int *orientation, char *err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.read_header();
    *width = dec.width();
    *height = dec.height();
    *components = dec.components();
    *orientation = dec.orientation();
    return 0;
  } catch (const std::exception &e) {
    copy_error(e.what(), err, errlen);
    return -1;
  }
}

// Decodes n files on up to num_threads threads: file i (datas[i],
// sizes[i]) into outs[i], an (H, W, 3) uint8 RGB buffer of the size
// jpeg_info gave, before any EXIF orientation.  status[i] is 0 or -1, with
// file i's message at errs + i * errlen.  Returns the number of failures.
int jpeg_decode_batch(const uint8_t *const *datas, const size_t *sizes,
                      uint8_t *const *outs, int n, int num_threads,
                      int *status, char *errs, int errlen) {
  std::atomic<int> next{0}, failures{0};
  auto work = [&]() {
    for (int i = next++; i < n; i = next++) {
      try {
        Decoder dec(datas[i], sizes[i]);
        dec.read_header();
        dec.decode(outs[i]);
        status[i] = 0;
      } catch (const std::exception &e) {
        status[i] = -1;
        copy_error(e.what(), errs + size_t(i) * errlen, errlen);
        failures++;
      }
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  for (int i = 1; i < t; i++) pool.emplace_back(work);
  work();
  for (auto &th : pool) th.join();
  return failures.load();
}

}  // extern "C"
