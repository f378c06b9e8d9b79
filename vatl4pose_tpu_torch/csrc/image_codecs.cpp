// The byte-level codecs of BMP and TIFF that are too slow as per-code
// Python loops, host C++, bound with ctypes by
// vatl4pose_tpu_torch/data/bmp.py and data/tiff.py:
//   * BMP RLE8 and RLE4 (encoded runs, absolute runs padded to 16 bits,
//     end of line, end of bitmap, delta) to one palette index a pixel;
//     pixels the stream skips keep index 0;
//   * TIFF LZW (the code width growing one code early, as the TIFF 6.0
//     specification and libtiff write it; the old LSB-first variant is
//     refused);
//   * TIFF/Macintosh PackBits.
// Each returns 0, or -1 with a message in err.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread image_codecs.cpp

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &msg) { throw Error(msg); }

void copy_error(const char *msg, char *err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

// rows are stored bottom-up: out row 0 is the file's first row
void rle(const uint8_t *src, size_t n, int width, int height, bool rle4,
         uint8_t *out) {
  std::memset(out, 0, size_t(width) * height);
  size_t p = 0;
  long x = 0, y = 0;
  auto put = [&](int v) {
    if (x >= width) fail("an RLE run past the end of row " + std::to_string(y));
    out[size_t(y) * width + x++] = uint8_t(v);
  };
  while (y < height) {
    if (p + 2 > n) fail("RLE data ends without an end-of-bitmap escape");
    int count = src[p], value = src[p + 1];
    p += 2;
    if (count) {                       // encoded run
      for (int i = 0; i < count; i++)
        put(rle4 ? (i & 1 ? value & 15 : value >> 4) : value);
    } else if (value == 0) {           // end of line
      x = 0;
      y++;
    } else if (value == 1) {           // end of bitmap
      return;
    } else if (value == 2) {           // delta
      if (p + 2 > n) fail("truncated RLE delta escape");
      x += src[p];
      y += src[p + 1];
      p += 2;
      if (x > width) fail("an RLE delta past the end of a row");
    } else {                           // absolute run of `value` pixels
      size_t bytes = rle4 ? (size_t(value) + 1) / 2 : size_t(value);
      if (p + bytes > n) fail("truncated RLE absolute run");
      for (int i = 0; i < value; i++)
        put(rle4 ? (i & 1 ? src[p + i / 2] & 15 : src[p + i / 2] >> 4)
                 : src[p + i]);
      p += bytes + (bytes & 1);
    }
  }
}

void lzw(const uint8_t *src, size_t n, uint8_t *out, size_t cap) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    fail("old-style (LSB-first) LZW is not supported");
  const int kClear = 256, kEoi = 257, kTable = 4096;
  std::vector<int32_t> prefix(kTable, -1);
  std::vector<uint8_t> suffix(kTable), first(kTable);
  std::vector<uint16_t> length(kTable, 1);
  for (int i = 0; i < 256; i++) suffix[i] = first[i] = uint8_t(i);
  size_t o = 0, bitpos = 0;
  const size_t nbits = n * 8;
  int width = 9, next = 258, old = -1;
  auto emit = [&](int code) {
    size_t len = length[code];
    if (o + len > cap) fail("LZW data longer than the strip");
    size_t at = o + len;
    for (int c = code; c >= 0; c = prefix[c]) out[--at] = suffix[c];
    o += len;
  };
  while (bitpos + width <= nbits) {          // no EOI: what was read stands
    int code = 0;
    for (int i = 0; i < width; i++, bitpos++)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old == -1) {
      if (code > 255) fail("corrupt LZW data: a first code above 255");
      emit(code);
      old = code;
      continue;
    }
    if (code > next || (code == next && next >= kTable))
      fail("corrupt LZW data: code " + std::to_string(code) +
           " past the table");
    if (next < kTable) {
      prefix[next] = old;
      suffix[next] = code < next ? first[code] : first[old];
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
      next++;
    }
    emit(code);
    old = code;
    // the width grows one code early (libtiff's LZWDecode)
    if (next >= (1 << width) - 1 && width < 12) width++;
  }
  if (o != cap)
    fail("LZW data of " + std::to_string(o) + " bytes, not " +
         std::to_string(cap));
}

void packbits(const uint8_t *src, size_t n, uint8_t *out, size_t cap) {
  size_t p = 0, o = 0;
  while (p < n && o < cap) {
    int c = int(int8_t(src[p++]));
    if (c >= 0) {
      size_t len = size_t(c) + 1;
      if (p + len > n || o + len > cap) fail("corrupt PackBits literal run");
      std::memcpy(out + o, src + p, len);
      p += len;
      o += len;
    } else if (c != -128) {
      size_t len = size_t(1 - c);
      if (p >= n || o + len > cap) fail("corrupt PackBits repeat run");
      std::memset(out + o, src[p++], len);
      o += len;
    }
  }
  if (o != cap)
    fail("PackBits data of " + std::to_string(o) + " bytes, not " +
         std::to_string(cap));
}

}  // namespace

extern "C" {

// BMP RLE8 (rle4 = 0) or RLE4 (rle4 = 1) to width x height indices, rows
// in the file's (bottom-up) order.
int bmp_rle_decode(const uint8_t *src, size_t n, int width, int height,
                   int rle4, uint8_t *out, char *err, int errlen) {
  try {
    rle(src, n, width, height, rle4 != 0, out);
    return 0;
  } catch (const std::exception &e) {
    copy_error(e.what(), err, errlen);
    return -1;
  }
}

// One TIFF strip or tile: LZW (method 5) or PackBits (method 32773) to
// exactly cap bytes.
int tiff_decompress(int method, const uint8_t *src, size_t n, uint8_t *out,
                    size_t cap, char *err, int errlen) {
  try {
    if (method == 5) lzw(src, n, out, cap);
    else if (method == 32773) packbits(src, n, out, cap);
    else fail("compression " + std::to_string(method));
    return 0;
  } catch (const std::exception &e) {
    copy_error(e.what(), err, errlen);
    return -1;
  }
}

}  // extern "C"
