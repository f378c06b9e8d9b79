// Deformable im2col for Hopper (sm_90a): K4.
//
// Replaces no TPU kernel: the JAX package's deformable convolution
// (vatl4pose_tpu/kernels/deform_conv.py) is plain JAX.  It takes the place
// of the deformable_im2col of the reference's CUDA extension
// (dcn/src/deform_conv_cuda.cpp), which FastPose's DCN stages called before
// their GEMM; the port's eager route (kernels/deform_conv.bilinear_taps:
// four gathers, each followed by a mask, a weight product and a sum) writes
// the same columns some thirty times over.
//
// What it computes: the columns of deform_conv2d,
//   cols[n, (c*K + ky)*K + kx, ho*Wo + wo] =
//     sum over the four corners of x[n, c, y0+dy, x0+dx] * inb * w
//     (times the DCNv2 mask), the position
//     (ho*stride - pad + ky + dy_off, wo*stride - pad + kx + dx_off)
// with the offsets of channel c's deform group, in the eager route's own
// f32 arithmetic and order: floor, fy = y - y0, the weights
// (1-fy)*(1-fx), (1-fy)*fx, fy*(1-fx), fy*fx, each corner (v * inb) * w
// with the value read at the clamped corner, summed onto 0 corner by
// corner, then * mask.  Every product and sum is an __fmul_rn/__fadd_rn,
// so that nothing contracts into an FMA: the columns are the eager route's
// bit for bit.
// Input x (N, C, H, W), offsets (N, 2*G*K*K, Ho, Wo), mask (N, G*K*K, Ho,
// Wo) or none: any strides (the channels-last stream is read as it lies).
// Output: cols (N, C*K*K, Ho*Wo), contiguous, as the GEMM consumes it.
//
// What bounds it on the card: the columns written once (K*K values per
// input value sampled), the input and the offsets read once: device-memory
// bandwidth; about 15 flops a column value on the CUDA cores.
//
// Design.  A CTA takes one sample, a tile of TP = 32 consecutive output
// positions and CB channels of one deform group (CB the largest power of
// two <= 32 that divides C/G).  First its threads compute, for each of the
// K*K x TP (tap, position) pairs, the four clamped corner offsets, their
// in-bounds bits, the four weights and the mask into shared memory.  Then
// each warp takes pairs in turn, its lanes across channels, so that a
// corner's CB channels are one coalesced read of the channels-last stream,
// and writes the value into a shared tile [channel][tap, position] padded
// by one float against bank conflicts.  Last, each warp writes rows
// (channel, tap) of TP positions: coalesced 128-byte stores of the columns.
// The CTAs of one (sample, tile) are adjacent in the grid, so they share
// the offsets in L2.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int TP = 32;          // output positions a CTA
constexpr int THREADS = 256;
constexpr int MAX_K = 5;
constexpr size_t MAX_SMEM_BYTES = 232448;

struct Pair {                   // one (tap, position) of a CTA
  int idx[4];                   // clamped corner offsets within a channel
  float w[4];                   // bilinear weights
  float m;                      // DCNv2 mask (1 where none)
  int inb;                      // bit i: corner i inside the image
};

__global__ void __launch_bounds__(THREADS)
deform_im2col_kernel(const float* __restrict__ x, long long xsn, int xsc,
                     int xsh, int xsw, const float* __restrict__ off,
                     long long osn, int osc, int osh, int osw,
                     const float* __restrict__ mask, long long msn, int msc,
                     int msh, int msw, float* __restrict__ cols, int C,
                     int H, int W, int Ho, int Wo, int K, int stride,
                     int pad, int Cg, int CB, int tiles, int chunks) {
  extern __shared__ float smem[];
  const int KK = K * K;
  const int npairs = KK * TP;
  Pair* pairs = reinterpret_cast<Pair*>(smem);
  float* tile = smem + npairs * (sizeof(Pair) / sizeof(float));
  const int tstride = npairs + 1;

  // blockIdx.x = (n * tiles + t) * chunks + chunk
  const int chunk = blockIdx.x % chunks;
  const int t = (blockIdx.x / chunks) % tiles;
  const long long n = blockIdx.x / chunks / tiles;
  const int HW = Ho * Wo;
  const int p0 = t * TP;
  const int c0 = chunk * CB;
  const int g = c0 / Cg;

  for (int q = threadIdx.x; q < npairs; q += THREADS) {
    const int k = q / TP;
    const int pos = p0 + q % TP;
    if (pos >= HW) continue;
    const int ho = pos / Wo, wo = pos % Wo;
    const int by = ho * stride - pad + k / K;
    const int bx = wo * stride - pad + k % K;
    const float* o = off + n * osn + (long long)(g * 2 * KK + 2 * k) * osc
        + (long long)ho * osh + (long long)wo * osw;
    const float ys = __fadd_rn((float)by, o[0]);
    const float xs = __fadd_rn((float)bx, o[osc]);
    const float y0 = floorf(ys), x0 = floorf(xs);
    const float fy = __fsub_rn(ys, y0), fx = __fsub_rn(xs, x0);
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    Pair pr;
    pr.w[0] = __fmul_rn(gy, gx);
    pr.w[1] = __fmul_rn(gy, fx);
    pr.w[2] = __fmul_rn(fy, gx);
    pr.w[3] = __fmul_rn(fy, fx);
    pr.inb = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // integral floats: exact sums and tests, whatever the offset's size
      const float yy = y0 + (float)(i >> 1), xx = x0 + (float)(i & 1);
      if (yy >= 0.0f && yy < (float)H && xx >= 0.0f && xx < (float)W)
        pr.inb |= 1 << i;
      const int yc = (int)fminf(fmaxf(yy, 0.0f), (float)(H - 1));
      const int xc = (int)fminf(fmaxf(xx, 0.0f), (float)(W - 1));
      pr.idx[i] = yc * xsh + xc * xsw;
    }
    pr.m = mask == nullptr ? 1.0f
        : mask[n * msn + (long long)(g * KK + k) * msc
               + (long long)ho * msh + (long long)wo * msw];
    pairs[q] = pr;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = 32 / CB;      // pairs a warp takes at once
  const int c = lane % CB;
  const float* xc = x + n * xsn + (long long)(c0 + c) * xsc;
  for (int q = warp * per + lane / CB; q < npairs;
       q += (THREADS / 32) * per) {
    if (p0 + q % TP >= HW) continue;
    const Pair& pr = pairs[q];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = xc[pr.idx[i]];
      const float tap = __fmul_rn(__fmul_rn(v, (pr.inb >> i) & 1 ? 1.0f
                                                                 : 0.0f),
                                  pr.w[i]);
      acc = __fadd_rn(acc, tap);
    }
    if (mask != nullptr) acc = __fmul_rn(acc, pr.m);
    tile[c * tstride + q] = acc;
  }
  __syncthreads();

  const int pos = p0 + lane;
  if (pos >= HW) return;
  float* out = cols + ((n * C + c0) * KK) * (long long)HW + pos;
  for (int r = warp; r < CB * KK; r += THREADS / 32) {
    const int cc = r / KK, k = r % KK;
    out[(long long)r * HW] = tile[cc * tstride + k * TP + lane];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or an error code for a
// shape the kernel does not take.  mask may be null (DCNv1).
extern "C" int deform_im2col_f32(
    const void* x, int xsn, int xsc, int xsh, int xsw, const void* off,
    int osn, int osc, int osh, int osw, const void* mask, int msn, int msc,
    int msh, int msw, void* cols, int N, int C, int H, int W, int Ho, int Wo,
    int K, int stride, int pad, int G, void* stream) {
  if (N == 0 || Ho == 0 || Wo == 0 || C == 0) return 0;
  if (K < 1 || K > MAX_K || G < 1 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const int Cg = C / G;
  int CB = 32;
  while (Cg % CB != 0) CB /= 2;
  const int KK = K * K;
  const size_t smem = (size_t)KK * TP * sizeof(Pair)
      + (size_t)CB * (KK * TP + 1) * sizeof(float);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int tiles = (Ho * Wo + TP - 1) / TP;
  const int chunks = C / CB;
  const long long blocks = (long long)N * tiles * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deform_im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  deform_im2col_kernel<<<(unsigned)blocks, THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const float*)x, xsn, xsc, xsh, xsw, (const float*)off, osn, osc, osh,
      osw, (const float*)mask, msn, msc, msh, msw, (float*)cols, C, H, W, Ho,
      Wo, K, stride, pad, Cg, CB, tiles, chunks);
  return (int)cudaGetLastError();
}
