// Baseline JPEG encoder, host C++, bound with ctypes by
// vatl4pose_tpu_torch/data/image_io.py (`encode_jpeg`).
//
// The output is byte for byte what cv2.imencode(".jpg") / cv2.imwrite write
// with OpenCV's bundled libjpeg-turbo at its defaults (jpeg_set_defaults,
// jpeg_set_quality(q, force_baseline=TRUE), no optimized tables, no
// restart interval):
//   * SOI, JFIF APP0 1.01 (density 0, 1:1), one DQT a table used, SOF0,
//     one DHT a Huffman table used (the Annex K tables, in the order
//     jcmarker.c's write_scan_header emits them), one interleaved SOS, the
//     entropy-coded data, EOI;
//   * the Annex K quantisation tables scaled as jcparam.c scales them;
//   * the fixed-point RGB->YCbCr of jccolor.c (16 scale bits, Cb/Cr with
//     the 0.5-epsilon rounding fudge);
//   * jcprepct.c's edges: the last column and row replicated out to the
//     downsampler's width and to the row group, the downsampled planes'
//     last row out to the iMCU height;
//   * jcsample.c's downsamplers: h1v1 a copy, h2v1 with bias 0,1,0,1...,
//     h2v2 with bias 1,2,1,2...;
//   * jccoefct.c's dummy blocks: all AC 0, DC that of the block before it
//     in the MCU (right edge) or of the MCU's last block of the row above
//     (bottom edge);
//   * the ISLOW forward DCT (jfdctint.c) and jcdctmgr.c's reciprocal
//     quantiser (compute_reciprocal), which rounds |x| / q half up;
//   * jchuff.c's Huffman coding: 0xFF stuffed with 0x00, the last byte
//     padded with 1 bits.
// An (H, W, 3) RGB image is written as YCbCr with the luma sampled 1x1
// (4:4:4), 2x1 (4:2:2) or 2x2 (4:2:0) and the chroma 1x1; an (H, W) gray
// image as one component.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread jpeg_encode.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural
// order)
const int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jpeg_natural_order: the zigzag position k holds coefficient kZigzag[k]
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jstdhuff.c: the Annex K tables (counts of codes of 1..16 bits, symbols)
const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jchuff.c jpeg_make_c_derived_tbl: the code and its length by symbol
struct HuffCodes {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t *bits, const uint8_t *vals) {
    std::memset(size, 0, sizeof size);
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, k++) {
        code[vals[k]] = c++;
        size[vals[k]] = uint8_t(len);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal, as the 16-bit DCTELEM builds use it:
// (|x| + corr) * recip >> shift is |x| / divisor rounded half up
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);   // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {uint32_t(fq), c, r};
}

// jfdctint.c jpeg_fdct_islow: the 8x8 samples (already less 128) in
// place, the result scaled up by 8
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

void fdct_islow(int32_t *d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int i = 0; i < 8; i++) {
      int32_t *p = d + i * next;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, n);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, n);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, n);
      p[5 * step] = descale(tmp5 + z2 + z4, n);
      p[3 * step] = descale(tmp6 + z2 + z3, n);
      p[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

// jccolor.c rgb_ycc_start / rgb_ycc_convert
struct YccTables {
  int32_t t[8][256];
  YccTables() {
    const int kScale = 16;
    const int32_t half = int32_t(1) << (kScale - 1);
    const int32_t cbcr_offset = int32_t(128) << kScale;
    auto fix = [&](double x) { return int32_t(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; i++) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + half;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + cbcr_offset + half - 1;  // B->Cb, R->Cr
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};
const YccTables kYcc;

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// the entropy-coded bytes and the markers around them
struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) { out.push_back(uint8_t(b)); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 255);
  }
  void bits(uint32_t code, int size) {
    acc = (acc << size) | (code & ((uint32_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      int b = int((acc >> (nbits - 8)) & 255);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {   // jchuff.c flush_bits: pad with 1 bits
    if (nbits) bits(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

struct Component {
  int id, h, v, tq, tbl;     // tbl: the Huffman tables (0 luma, 1 chroma)
  int wib, hib;              // width_in_blocks, height_in_blocks
  int pw, ph;                // the downsampled plane, padded
  std::vector<uint8_t> plane;
  Divisor div[64];
};

// one sample plane (W x H) -> the component's downsampled plane: columns
// replicated out to wib * 8 * hexp, rows to the row group (max_v), then
// downsampled, then its last row replicated to the iMCU height
void downsample(const uint8_t *full, int W, int H, int max_v, Component &c,
                int hexp, int vexp) {
  const int fw = c.wib * 8 * hexp;
  const int fh = (H + max_v - 1) / max_v * max_v;
  auto at = [&](int y, int x) {
    return int(full[size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)]);
  };
  const int rows = fh / vexp;
  c.plane.assign(size_t(c.pw) * c.ph, 0);
  for (int y = 0; y < rows; y++) {
    uint8_t *o = c.plane.data() + size_t(y) * c.pw;
    if (hexp == 1 && vexp == 1) {
      for (int x = 0; x < fw; x++) o[x] = uint8_t(at(y, x));
    } else if (hexp == 2 && vexp == 1) {
      int bias = 0;
      for (int x = 0; x < fw / 2; x++) {
        o[x] = uint8_t((at(y, 2 * x) + at(y, 2 * x + 1) + bias) >> 1);
        bias ^= 1;
      }
    } else {   // h2v2
      int bias = 1;
      for (int x = 0; x < fw / 2; x++) {
        o[x] = uint8_t((at(2 * y, 2 * x) + at(2 * y, 2 * x + 1) +
                        at(2 * y + 1, 2 * x) + at(2 * y + 1, 2 * x + 1) +
                        bias) >> 2);
        bias ^= 3;
      }
    }
  }
  for (int y = rows; y < c.ph; y++)
    std::memcpy(c.plane.data() + size_t(y) * c.pw,
                c.plane.data() + size_t(rows - 1) * c.pw, c.pw);
}

// the block at (by, bx) of the component: ISLOW DCT, quantised, natural
// order
void block_coefs(const Component &c, int by, int bx, int32_t *q) {
  int32_t d[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t *row = c.plane.data() + size_t(by * 8 + y) * c.pw + bx * 8;
    for (int x = 0; x < 8; x++) d[8 * y + x] = int32_t(row[x]) - 128;
  }
  fdct_islow(d);
  for (int i = 0; i < 64; i++) {
    const Divisor &v = c.div[i];
    uint32_t a = uint32_t(d[i] < 0 ? -d[i] : d[i]);
    int32_t m = int32_t((uint64_t(a + v.corr) * v.recip) >> v.shift);
    q[i] = d[i] < 0 ? -m : m;
  }
}

inline int nbits_of(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    n++;
    a >>= 1;
  }
  return n;
}

void encode_block(Writer &w, const int32_t *q, int &pred,
                  const HuffCodes &dc, const HuffCodes &ac) {
  int diff = q[0] - pred;
  pred = q[0];
  int n = nbits_of(diff);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = q[kZigzag[k]];
    if (!v) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = nbits_of(v);
    int rs = (run << 4) + n;
    w.bits(ac.code[rs], ac.size[rs]);
    w.bits(uint32_t(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) w.bits(ac.code[0], ac.size[0]);
}

std::vector<uint8_t> encode(const uint8_t *px, int W, int H, int channels,
                            int quality, int hy, int vy) {
  if (W < 1 || H < 1 || W > 65535 || H > 65535)
    throw Error("image sides must be 1-65535 for a JPEG");
  if (quality < 1 || quality > 100) throw Error("quality must be 1-100");
  if (channels != 1 && channels != 3) throw Error("1 or 3 channels");
  // jcparam.c jpeg_quality_scaling, jpeg_add_quant_table (force_baseline)
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long(kStdQuant[t][i]) * scale + 50L) / 100L;
      qt[t][i] = int(std::min(255L, std::max(1L, v)));
    }
  const int nc = channels;
  std::vector<Component> comp(nc);
  if (nc == 1) {
    comp[0] = Component{1, 1, 1, 0, 0, 0, 0, 0, 0, {}, {}};
  } else {
    comp[0] = Component{1, hy, vy, 0, 0, 0, 0, 0, 0, {}, {}};
    comp[1] = Component{2, 1, 1, 1, 1, 0, 0, 0, 0, {}, {}};
    comp[2] = Component{3, 1, 1, 1, 1, 0, 0, 0, 0, {}, {}};
  }
  int max_h = 1, max_v = 1;
  for (auto &c : comp) {
    max_h = std::max(max_h, c.h);
    max_v = std::max(max_v, c.v);
  }
  const int mcus_x = (W + 8 * max_h - 1) / (8 * max_h);
  const int mcus_y = (H + 8 * max_v - 1) / (8 * max_v);
  for (auto &c : comp) {
    c.wib = int((long(W) * c.h + 8L * max_h - 1) / (8L * max_h));
    c.hib = int((long(H) * c.v + 8L * max_v - 1) / (8L * max_v));
    c.pw = c.wib * 8;
    c.ph = mcus_y * c.v * 8;
    for (int i = 0; i < 64; i++) c.div[i] = reciprocal(uint32_t(qt[c.tq][i]) << 3);
  }

  // colour conversion to full-size planes, then each component's plane
  const size_t npix = size_t(W) * H;
  if (nc == 1) {
    downsample(px, W, H, max_v, comp[0], 1, 1);
  } else {
    std::vector<uint8_t> ycc[3];
    for (auto &p : ycc) p.resize(npix);
    for (size_t i = 0; i < npix; i++) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      ycc[0][i] = uint8_t((kYcc.t[0][r] + kYcc.t[1][g] + kYcc.t[2][b]) >> 16);
      ycc[1][i] = uint8_t((kYcc.t[3][r] + kYcc.t[4][g] + kYcc.t[5][b]) >> 16);
      ycc[2][i] = uint8_t((kYcc.t[5][r] + kYcc.t[6][g] + kYcc.t[7][b]) >> 16);
    }
    for (int k = 0; k < 3; k++)
      downsample(ycc[k].data(), W, H, max_v, comp[k], max_h / comp[k].h,
                 max_v / comp[k].v);
  }

  HuffCodes dc[2], ac[2];
  for (int t = 0; t < 2; t++) {
    dc[t].build(kDcBits[t], kDcVals);
    ac[t].build(kAcBits[t], kAcVals[t]);
  }

  Writer w;
  w.out.reserve(npix / 2 + 1024);
  w.u16(0xFFD8);
  // JFIF APP0: version 1.01, density unit 0, density 1:1, no thumbnail
  const uint8_t jfif[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1,
                          0,    0,    1, 0,  1,   0,   0};
  w.out.insert(w.out.end(), jfif, jfif + sizeof jfif);
  const int ntables = nc == 1 ? 1 : 2;
  for (int t = 0; t < ntables; t++) {
    w.u16(0xFFDB);
    w.u16(67);
    w.byte(t);
    for (int k = 0; k < 64; k++) w.byte(qt[t][kZigzag[k]]);
  }
  w.u16(0xFFC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(nc);
  for (auto &c : comp) {
    w.byte(c.id);
    w.byte((c.h << 4) | c.v);
    w.byte(c.tq);
  }
  for (int t = 0; t < ntables; t++) {
    for (int cls = 0; cls < 2; cls++) {
      const uint8_t *bits = cls ? kAcBits[t] : kDcBits[t];
      const uint8_t *vals = cls ? kAcVals[t] : kDcVals;
      int n = 0;
      for (int i = 0; i < 16; i++) n += bits[i];
      w.u16(0xFFC4);
      w.u16(2 + 17 + n);
      w.byte((cls << 4) | t);
      for (int i = 0; i < 16; i++) w.byte(bits[i]);
      for (int i = 0; i < n; i++) w.byte(vals[i]);
    }
  }
  w.u16(0xFFDA);
  w.u16(6 + 2 * nc);
  w.byte(nc);
  for (auto &c : comp) {
    w.byte(c.id);
    w.byte((c.tbl << 4) | c.tbl);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int pred[3] = {0, 0, 0};
  int32_t q[64];
  if (nc == 1) {   // one component: non-interleaved, no dummy blocks
    const Component &c = comp[0];
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) {
        block_coefs(c, by, bx, q);
        encode_block(w, q, pred[0], dc[0], ac[0]);
      }
  } else {
    std::vector<int32_t> mcu(size_t(max_h) * max_v * 64);
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++)
        for (int k = 0; k < nc; k++) {
          const Component &c = comp[k];
          for (int yi = 0; yi < c.v; yi++)
            for (int xi = 0; xi < c.h; xi++) {
              int by = my * c.v + yi, bx = mx * c.h + xi;
              int32_t *b = mcu.data() + size_t(yi * c.h + xi) * 64;
              if (by < c.hib && bx < c.wib) {
                block_coefs(c, by, bx, b);
              } else {
                // jccoefct.c's dummy blocks
                int dcv = by < c.hib ? b[-64] : mcu[size_t(yi * c.h - 1) * 64];
                std::memset(b, 0, 64 * sizeof(int32_t));
                b[0] = dcv;
              }
              encode_block(w, b, pred[k], dc[c.tbl], ac[c.tbl]);
            }
        }
  }
  w.flush();
  w.u16(0xFFD9);
  return w.out;
}

void copy_error(const char *msg, char *err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// Encodes an (height, width, channels) uint8 image, RGB (3) or gray (1),
// at quality 1-100, the luma sampled h_y x v_y (1x1, 2x1 or 2x2), into out
// (cap bytes).  Returns the file's size, the size it needs if that is more
// than cap (nothing then written), or -1 with a message in err.
long jpeg_encode(const uint8_t *px, int width, int height, int channels,
                 int quality, int h_y, int v_y, uint8_t *out, size_t cap,
                 char *err, int errlen) {
  try {
    if (!((h_y == 1 && v_y == 1) || (h_y == 2 && v_y == 1) ||
          (h_y == 2 && v_y == 2)))
      throw Error("luma sampling must be 1x1, 2x1 or 2x2");
    std::vector<uint8_t> bytes =
        encode(px, width, height, channels, quality, h_y, v_y);
    if (bytes.size() <= cap) std::memcpy(out, bytes.data(), bytes.size());
    return long(bytes.size());
  } catch (const std::exception &e) {
    copy_error(e.what(), err, errlen);
    return -1;
  }
}

}  // extern "C"
