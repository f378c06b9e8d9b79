// Affine person crop for Hopper (sm_90a): the training augmentation crop and,
// with rot=0 matrices, the scoring crop.
//
// Replaces: vatl4pose_tpu/kernels/rot_warp.py, the Pallas TPU kernels
// `_shear_kernel` (:115, called through `_shear_pass`, :162) and
// `_make_shear_kernel_v2` (:397, called through `_shear_pass_v2`, :459),
// with their callers `warp_rotated_traced` and `warp_rotated_traced2`.  The
// copy variant below stands in for the timing harness
// exp/profile_shear_variants.py `_run` (:197), whose `copy` variant split
// the shear kernel's cost into bytes and inner work.
//
// What it computes, from frames (F, H, W, 3) uint8 or float32 in [0, 255],
// frame_idx (N,) int64 and dst->src affines inv_mats (N, 2, 3) f32 with any
// rotation, scale or flip: per output pixel (x, y) of an (oh, ow) crop,
// s = M (x, y, 1), the 4 bilinear taps at floor(s) and +1, each read as 0
// outside the frame (cv2.warpAffine INTER_LINEAR + BORDER_CONSTANT 0), then
// * scale minus the RGB mean.  Output (N, oh, ow, 3) f32 or bf16.  A frame
// index outside [0, F) reads as all border.
//
// Exactness: every operation is rounded on its own (__fmul_rn, __fadd_rn;
// no FMA contraction), in the order of the plain version
// (ops/warp.warp_affine_bilinear_batch), whose tensor ops each round once.
// The source coordinate, the taps and the weights are then bit-identical to
// the plain version's; at an image edge of 255 per pixel, one ulp of the
// coordinate would move the output by about 0.015 of 255.  The /255 is a
// multiply by `scale`, the f32 reciprocal that PyTorch's CUDA division by a
// scalar multiplies by, so on the card the f32 output equals the plain
// version's.  The bf16 output is that f32 value rounded once to nearest
// even (__float2bfloat16_rn), the plain version's `.to(torch.bfloat16)`.
//
// Why one pass: on the TPU a gather runs at scalar rate, so the JAX package
// built the rotation from a separable pre-warp and three shear passes, each
// a per-row fractional shift (an approximation: three interpolations
// instead of one).  On Hopper a gather is a cached load, so this kernel
// computes the exact single-pass bilinear warp directly.
//
// What bounds it on the card: bytes in principle.  It writes every output
// value once (4 or 2 bytes) and reads the source pixels the crops tap, each
// at least once, against about 20 flops per value, far below the ridge.
// In practice the taps' instructions: with the stores below, the crop's
// geometry and stores alone run at the byte bound, and the 4 taps a pixel
// (8-byte loads, byte extraction, masks) and their blend set the pace.
//
// Design.  The output is one flat array of N*oh*ow pixels, so each thread
// computes VEC consecutive pixels (4 in f32, 8 in bf16: 48 bytes either
// way), and a warp computes 32*VEC consecutive pixels, 1536 contiguous
// bytes.  A 1-D grid-stride loop over the spans has no limit on N.
//  - Stores.  The simple form's were 4-byte scalars at a 12-byte stride, a
//    third of each sector per store instruction; here each thread stages
//    its 48 bytes in shared memory and the warp writes its span with three
//    16-byte stores a lane, every store instruction 512 contiguous bytes
//    (full sectors).  Only a span that runs past the end of the output (the
//    grid's last one) takes a masked scalar epilogue.
//  - Taps.  A run of VEC pixels that stays in one sample (always, where VEC
//    divides oh*ow) takes one matrix and straight-line code: each tap's
//    loads come from an address that is always readable and its value is
//    masked, not branched on, so all of a thread's loads can be in flight
//    at once.  A run that crosses a sample or the output's end steps pixel
//    by pixel.  Staging each tile's source box in shared memory was tried
//    and measured slower (see PERF.md): its load round trip and block
//    barriers per tile cost more than the global taps it saved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 3;            // 16-byte chunks a thread writes
constexpr int MAX_BLOCKS = 4096;     // grid-stride beyond

template <typename Out>
struct OutVec;
template <>
struct OutVec<float> {
  static constexpr int VEC = 4;      // 4 pixels * 3 * 4 bytes = 48
};
template <>
struct OutVec<__nv_bfloat16> {
  static constexpr int VEC = 8;      // 8 pixels * 3 * 2 bytes = 48
};

// a byte as f32 without a conversion instruction (I2F runs at a quarter of
// the FP32 rate): 0x4B0000bb is 2^23 + b exactly, less 2^23 is b
__device__ __forceinline__ float byte_f(uint32_t word, uint32_t k) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u,
                                               0x7440u | k)),
                   8388608.f);
}

// The 6 values of one source row at pixels x0 and x0 + 1 (channels 0-2 of
// each), 0 where a pixel is outside the frame (!ok0, !ok1).  `px` points at
// pixel x0 of the row.  Branch-free, so that a thread's pixels can all have
// their loads in flight at once: uint8 takes the 6 bytes from two aligned
// 8-byte loads, each from its own address where it holds a byte that is
// needed (an aligned block that holds a byte of the buffer is readable),
// else from `safe`, the aligned block of the buffer's first byte.
__device__ __forceinline__ void fetch_row(const uint8_t* px, uintptr_t safe,
                                          bool ok0, bool ok1, float* v) {
  const uintptr_t a = (uintptr_t)px;
  const uintptr_t a8 = a & ~(uintptr_t)7;
  const uint32_t o = (uint32_t)(a - a8);                 // 0..7
  // bytes o..o+2 are pixel x0's, o+3..o+5 pixel x0 + 1's
  const bool need01 = ok0 || (ok1 && o <= 4);
  const bool need23 = (ok0 && o >= 6) || (ok1 && o >= 3);
  const uint2 w01 = __ldg(reinterpret_cast<const uint2*>(need01 ? a8 : safe));
  const uint2 w23 =
      __ldg(reinterpret_cast<const uint2*>(need23 ? a8 + 8 : safe));
  const uint32_t w0 = o < 4 ? w01.x : w01.y;
  const uint32_t w1 = o < 4 ? w01.y : w23.x;
  const uint32_t w2 = o < 4 ? w23.x : w23.y;
  const uint32_t b0 = __funnelshift_r(w0, w1, (o & 3) * 8);     // o..o+3
  const uint32_t b1 = __funnelshift_r(w1, w2, (o & 3) * 8);     // o+4..
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = ok0 ? byte_f(b0, c) : 0.f;
  v[3] = ok1 ? byte_f(b0, 3) : 0.f;
  v[4] = ok1 ? byte_f(b1, 0) : 0.f;
  v[5] = ok1 ? byte_f(b1, 1) : 0.f;
}

// float32 frames: 6 loads, from the buffer's first pixel where masked
__device__ __forceinline__ void fetch_row(const float* px, uintptr_t safe,
                                          bool ok0, bool ok1, float* v) {
  const float* p0 = ok0 ? px : reinterpret_cast<const float*>(safe);
  const float* p1 = ok1 ? px + 3 : reinterpret_cast<const float*>(safe);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = ok0 ? __ldg(p0 + c) : 0.f;
    v[3 + c] = ok1 ? __ldg(p1 + c) : 0.f;
  }
}

__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// 12 words (48 bytes) of one thread's results r[3 * VEC], in memory order
__device__ __forceinline__ uint32_t word(const float* r, int i, float*) {
  return __float_as_uint(r[i]);
}
__device__ __forceinline__ uint32_t word(const float* r, int i,
                                         __nv_bfloat16*) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i]))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i + 1]))
            << 16);
}

struct Geometry {
  const float* inv_mats;
  const int64_t* frame_idx;
  int F, H, W, oh, ow;
  float scale, mean0, mean1, mean2;
};

// one output pixel's 3 normalized values; COPY reads the floor tap alone.
// Straight-line code: taps outside the frame are masked, not branched on.
// gx is the pixel's column; ax, ay are m[1] * row and m[4] * row.
template <typename Src, bool COPY>
__device__ __forceinline__ void crop_pixel(const Geometry& g, const float* m,
                                           const Src* __restrict__ img,
                                           uintptr_t safe, bool frame_ok,
                                           float gx, float ax, float ay,
                                           float* r) {
  const int H = g.H;
  const int W = g.W;
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), ax), m[2]);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), ay), m[5]);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f);
  const float fy = __fsub_rn(sy, y0f);
  // clamped before the cast so that a far-off coordinate cannot overflow
  // int; both taps of a clamped coordinate stay outside the frame
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const bool okx0 = frame_ok && x0 >= 0 && x0 < W;
  const bool okx1 = frame_ok && x0 + 1 >= 0 && x0 + 1 < W;
  const bool oky0 = y0 >= 0 && y0 < H;
  const bool oky1 = y0 + 1 >= 0 && y0 + 1 < H;
  const Src* p0 = img + ((int64_t)y0 * W + x0) * 3;
  const float mean[3] = {g.mean0, g.mean1, g.mean2};
  // rows: v[0..2] the tap at x0, v[3..5] the tap at x0 + 1
  float t0[6], t1[6];
  fetch_row(p0, safe, oky0 && okx0, oky0 && okx1, t0);
  if (COPY) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r[c] = __fsub_rn(__fmul_rn(t0[c], g.scale), mean[c]);
    return;
  }
  fetch_row(p0 + (int64_t)W * 3, safe, oky1 && okx0, oky1 && okx1, t1);
  const float gfx = __fsub_rn(1.f, fx);
  const float gfy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gfx, gfy);
  const float w01 = __fmul_rn(fx, gfy);
  const float w10 = __fmul_rn(gfx, fy);
  const float w11 = __fmul_rn(fx, fy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float acc = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(t0[c], w00), __fmul_rn(t0[3 + c], w01)),
                  __fmul_rn(t1[c], w10)),
        __fmul_rn(t1[3 + c], w11));
    r[c] = __fsub_rn(__fmul_rn(acc, g.scale), mean[c]);
  }
}

template <typename Src, typename Out, bool COPY>
__global__ void __launch_bounds__(THREADS)
    rot_warp_kernel(const Src* __restrict__ frames, Out* __restrict__ out,
                    const Geometry g, const int64_t total) {
  constexpr int VEC = OutVec<Out>::VEC;
  constexpr int64_t SPAN = 32 * VEC;             // pixels a warp writes
  __shared__ uint4 stage[WARPS][32 * CHUNKS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t ohw = (int64_t)g.oh * g.ow;
  const int64_t spans = (total + SPAN - 1) / SPAN;
  const int64_t frame_px = (int64_t)g.H * g.W;
  const uintptr_t safe = (uintptr_t)frames & ~(uintptr_t)15;

  for (int64_t s = (int64_t)blockIdx.x * WARPS + warp; s < spans;
       s += (int64_t)gridDim.x * WARPS) {
    const int64_t q0 = s * SPAN + (int64_t)lane * VEC;
    float r[3 * VEC];
    // the run's first pixel; then step along rows (and samples)
    int64_t n = q0 / ohw;
    const int rem = (int)(q0 - n * ohw);
    int oy = rem / g.ow;
    int ox = rem - oy * g.ow;
    if (q0 + VEC <= total && rem + VEC <= ohw) {
      // the run lies in one sample (always, where VEC divides oh * ow): one
      // matrix, and every pixel's loads can be in flight together
      float m[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) m[j] = g.inv_mats[6 * n + j];
      const int64_t fi = g.frame_idx[n];
      const bool frame_ok = fi >= 0 && fi < g.F;
      const Src* img = frames + (frame_ok ? fi : 0) * frame_px * 3;
      // column and row as floats, stepped exactly (integers below 2^24)
      float gx = (float)ox;
      float gy = (float)oy;
      float ax = __fmul_rn(m[1], gy);
      float ay = __fmul_rn(m[4], gy);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        crop_pixel<Src, COPY>(g, m, img, safe, frame_ok, gx, ax, ay,
                              r + 3 * i);
        if (i + 1 < VEC) {
          const bool wrap = ++ox == g.ow;
          ox = wrap ? 0 : ox;
          gx = wrap ? 0.f : __fadd_rn(gx, 1.f);
          if (wrap) {
            gy = __fadd_rn(gy, 1.f);
            ax = __fmul_rn(m[1], gy);
            ay = __fmul_rn(m[4], gy);
          }
        }
      }
    } else {
      // a run that crosses a sample or the output's end
      int64_t cur = -1;
      float m[6];
      const Src* img = frames;
      bool frame_ok = false;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (q0 + i < total) {
          if (n != cur) {
            cur = n;
#pragma unroll
            for (int j = 0; j < 6; ++j) m[j] = g.inv_mats[6 * n + j];
            const int64_t fi = g.frame_idx[n];
            frame_ok = fi >= 0 && fi < g.F;
            img = frames + (frame_ok ? fi : 0) * frame_px * 3;
          }
          const float gy = (float)oy;
          crop_pixel<Src, COPY>(g, m, img, safe, frame_ok, (float)ox,
                                __fmul_rn(m[1], gy), __fmul_rn(m[4], gy),
                                r + 3 * i);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) r[3 * i + c] = 0.f;
        }
        if (++ox == g.ow) {
          ox = 0;
          if (++oy == g.oh) {
            oy = 0;
            ++n;
          }
        }
      }
    }

    if ((s + 1) * SPAN <= total) {
      // stage the warp's 1536 bytes, then 3 coalesced 16-byte stores a lane
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j)
        stage[warp][lane * CHUNKS + j] =
            make_uint4(word(r, 4 * j, (Out*)nullptr),
                       word(r, 4 * j + 1, (Out*)nullptr),
                       word(r, 4 * j + 2, (Out*)nullptr),
                       word(r, 4 * j + 3, (Out*)nullptr));
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + s * SPAN * 3);
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j)
        dst[j * 32 + lane] = stage[warp][j * 32 + lane];
      __syncwarp();
    } else {
      // the output's ragged end: masked scalar stores
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (q0 + i < total)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            put(out + (q0 + i) * 3 + c, r[3 * i + c]);
    }
  }
}

template <typename Src, typename Out, bool COPY>
int launch(const void* frames, const void* frame_idx, const void* inv_mats,
           void* out, int F, int H, int W, int N, int oh, int ow, float scale,
           float mean0, float mean1, float mean2, void* stream) {
  const int64_t total = (int64_t)N * oh * ow;
  if (total == 0) return 0;
  constexpr int64_t SPAN = 32 * OutVec<Out>::VEC;
  const int64_t spans = (total + SPAN - 1) / SPAN;
  const int64_t want = (spans + WARPS - 1) / WARPS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const Geometry g{(const float*)inv_mats, (const int64_t*)frame_idx, F, H,
                   W, oh, ow, scale, mean0, mean1, mean2};
  rot_warp_kernel<Src, Out, COPY><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const Src*)frames, (Out*)out, g, total);
  return (int)cudaGetLastError();
}

}  // namespace

#define ROT_WARP_ENTRY(name, Src, Out, COPY)                                  \
  extern "C" int name(const void* frames, const void* frame_idx,              \
                      const void* inv_mats, void* out, int F, int H, int W,   \
                      int N, int oh, int ow, float scale, float mean0,        \
                      float mean1, float mean2, void* stream) {               \
    return launch<Src, Out, COPY>(frames, frame_idx, inv_mats, out, F, H, W,  \
                                  N, oh, ow, scale, mean0, mean1, mean2,      \
                                  stream);                                    \
  }

ROT_WARP_ENTRY(rot_warp_u8_f32, uint8_t, float, false)
ROT_WARP_ENTRY(rot_warp_u8_bf16, uint8_t, __nv_bfloat16, false)
ROT_WARP_ENTRY(rot_warp_f32_f32, float, float, false)
ROT_WARP_ENTRY(rot_warp_f32_bf16, float, __nv_bfloat16, false)
ROT_WARP_ENTRY(rot_warp_copy_u8_f32, uint8_t, float, true)
ROT_WARP_ENTRY(rot_warp_copy_u8_bf16, uint8_t, __nv_bfloat16, true)
ROT_WARP_ENTRY(rot_warp_copy_f32_f32, float, float, true)
ROT_WARP_ENTRY(rot_warp_copy_f32_bf16, float, __nv_bfloat16, true)
