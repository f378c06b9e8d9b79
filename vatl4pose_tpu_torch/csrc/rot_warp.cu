// Rotated affine crop for Hopper (sm_90a): the training augmentation crop.
//
// Replaces: vatl4pose_tpu/kernels/rot_warp.py, the Pallas TPU kernels
// `_shear_kernel` (:115, called through `_shear_pass`, :162) and
// `_make_shear_kernel_v2` (:397, called through `_shear_pass_v2`, :459),
// with their callers `warp_rotated_traced` and `warp_rotated_traced2`.  The
// copy variant below stands in for the timing harness
// exp/profile_shear_variants.py `_run` (:197), whose `copy` variant split
// the shear kernel's cost into bytes and inner work.
//
// What it computes, from uint8 frames (F, H, W, 3), frame_idx (N,) int64
// and dst->src affines inv_mats (N, 2, 3) f32 with any rotation, scale or
// flip: per output pixel (x, y) of an (oh, ow) crop, s = M (x, y, 1), the
// 4 bilinear taps at floor(s) and +1, each read as 0 outside the frame
// (cv2.warpAffine INTER_LINEAR + BORDER_CONSTANT 0), then /255 minus the
// RGB mean.  Output (N, oh, ow, 3) f32.  A frame index outside [0, F)
// reads as all border.
//
// Exactness: every operation is rounded on its own (__fmul_rn, __fadd_rn;
// no FMA contraction), in the order of the plain version
// (ops/warp.warp_affine_bilinear_batch), whose tensor ops each round once.
// The source coordinate, the taps and the weights are then bit-identical to
// the plain version's; at an image edge of 255 per pixel, one ulp of the
// coordinate would move the output by about 0.015 of 255.
//
// Why one pass: on the TPU a gather runs at scalar rate, so the JAX package
// built the rotation from a separable pre-warp and three shear passes, each
// a per-row fractional shift (an approximation: three interpolations
// instead of one).  On Hopper a gather is a cached load, so this kernel
// computes the exact single-pass bilinear warp directly.
//
// What bounds it on the card: bytes.  It writes 4 bytes per output value
// and reads at least one source byte per value, N*oh*ow*3*5 bytes in all
// (88.5 MB at N=120, 256x192: 0.026 ms at 3.35 TB/s), against about 20
// flops per value, far below the ridge.
//
// Design (the simple form): one thread per output pixel and its 3
// channels, a 2-D grid over (pixels, samples); each thread reads its
// sample's matrix and frame index (the same address across the block, so
// a broadcast from L1).  Neighbouring threads write neighbouring 12-byte
// pixels, so the stores coalesce.  Shared-memory staging of the source
// footprint and vectorized stores are left for a later change.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// COPY: one tap (the floor tap) and no interpolation, with the same grid
// and the same bytes written: the time of moving the bytes alone
template <bool COPY>
__global__ void __launch_bounds__(THREADS)
    rot_warp_kernel(const uint8_t* __restrict__ frames,
                    const int64_t* __restrict__ frame_idx,
                    const float* __restrict__ inv_mats,
                    float* __restrict__ out, int F, int H, int W, int oh,
                    int ow, float mean0, float mean1, float mean2) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= oh * ow) return;
  const int oy = p / ow;
  const int ox = p - oy * ow;
  const float* m = inv_mats + 6 * (int64_t)n;
  const float gx = (float)ox;
  const float gy = (float)oy;
  const float sx =
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)), m[2]);
  const float sy =
      __fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), __fmul_rn(m[4], gy)), m[5]);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f);
  const float fy = __fsub_rn(sy, y0f);
  // clamped before the cast so that a far-off coordinate cannot overflow
  // int; both taps of a clamped coordinate stay outside the frame
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);

  const int64_t fi = frame_idx[n];
  const bool frame_ok = fi >= 0 && fi < F;
  const uint8_t* img = frames + (frame_ok ? fi : 0) * (int64_t)H * W * 3;
  const bool okx0 = frame_ok && x0 >= 0 && x0 < W;
  const bool okx1 = frame_ok && x0 + 1 >= 0 && x0 + 1 < W;
  const bool oky0 = y0 >= 0 && y0 < H;
  const bool oky1 = y0 + 1 >= 0 && y0 + 1 < H;
  const int64_t r0 = (int64_t)y0 * W;
  const int64_t r1 = r0 + W;
  const float mean[3] = {mean0, mean1, mean2};
  float* o = out + ((int64_t)n * oh * ow + p) * 3;

  if (COPY) {
    const bool ok = okx0 && oky0;
    const uint8_t* t = img + (r0 + x0) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = ok ? (float)t[c] : 0.f;
      o[c] = __fsub_rn(__fdiv_rn(v, 255.f), mean[c]);
    }
    return;
  }

  const bool ok00 = okx0 && oky0;
  const bool ok01 = okx1 && oky0;
  const bool ok10 = okx0 && oky1;
  const bool ok11 = okx1 && oky1;
  const uint8_t* t00 = img + (r0 + x0) * 3;
  const uint8_t* t01 = t00 + 3;
  const uint8_t* t10 = img + (r1 + x0) * 3;
  const uint8_t* t11 = t10 + 3;
  const float gfx = __fsub_rn(1.f, fx);
  const float gfy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gfx, gfy);
  const float w01 = __fmul_rn(fx, gfy);
  const float w10 = __fmul_rn(gfx, fy);
  const float w11 = __fmul_rn(fx, fy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = ok00 ? (float)t00[c] : 0.f;
    const float v01 = ok01 ? (float)t01[c] : 0.f;
    const float v10 = ok10 ? (float)t10[c] : 0.f;
    const float v11 = ok11 ? (float)t11[c] : 0.f;
    const float acc = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(v00, w00), __fmul_rn(v01, w01)),
                  __fmul_rn(v10, w10)),
        __fmul_rn(v11, w11));
    o[c] = __fsub_rn(__fdiv_rn(acc, 255.f), mean[c]);
  }
}

template <bool COPY>
int launch(const void* frames, const void* frame_idx, const void* inv_mats,
           void* out, int F, int H, int W, int N, int oh, int ow, float mean0,
           float mean1, float mean2, void* stream) {
  if (N == 0 || oh * ow == 0) return 0;
  const dim3 grid((oh * ow + THREADS - 1) / THREADS, N);
  rot_warp_kernel<COPY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const int64_t*)frame_idx,
      (const float*)inv_mats, (float*)out, F, H, W, oh, ow, mean0, mean1,
      mean2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rot_warp_f32(const void* frames, const void* frame_idx,
                            const void* inv_mats, void* out, int F, int H,
                            int W, int N, int oh, int ow, float mean0,
                            float mean1, float mean2, void* stream) {
  return launch<false>(frames, frame_idx, inv_mats, out, F, H, W, N, oh, ow,
                       mean0, mean1, mean2, stream);
}

extern "C" int rot_warp_copy_f32(const void* frames, const void* frame_idx,
                                 const void* inv_mats, void* out, int F,
                                 int H, int W, int N, int oh, int ow,
                                 float mean0, float mean1, float mean2,
                                 void* stream) {
  return launch<true>(frames, frame_idx, inv_mats, out, F, H, W, N, oh, ow,
                      mean0, mean1, mean2, stream);
}
