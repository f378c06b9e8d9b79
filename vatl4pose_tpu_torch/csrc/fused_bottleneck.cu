// Folded-BN ResNet bottleneck chain for Hopper (sm_90a).
//
// Replaces: vatl4pose_tpu/kernels/fused_bottleneck.py, `_kernel` called
// through `fused_bottleneck_chain` (the Pallas TPU kernel).
//
// What it computes: nb chained stride-1, non-downsampling bottlenecks over
// an NHWC stream x (N, H, W, C) with eval BatchNorm folded to per-channel
// scale/bias (s, b).  Per block, with P = C / 4 planes:
//   y1  = relu(conv1x1(x, w1) * s1 + b1)                  -> stream dtype
//   y2  = relu(conv3x3(y1, w2, pad 1) * s2 + b2)          -> stream dtype
//   out = relu(conv1x1(y2, w3) * s3 + b3 + x)             -> stream dtype
// Products are accumulated in f32 and every epilogue runs in f32 before the
// cast back to the stream dtype (float or bf16), as in the TPU kernel.
//
// What bounds it on the card: at the shapes of SimplePose-R50 the work is
// 2*N*H*W*(2*C*P + 9*P*P) FLOPs per block against one read and one write of
// the stream, i.e. 40-400 FLOPs per byte: compute-bound in both dtypes.
// The tensor cores are the card's ceiling (989 TFLOP/s bf16), and in f32
// with TF32 off the 67 TFLOP/s of the CUDA cores.
//
// What this design does about it: each of the three products is one tiled
// shared-memory GEMM on the CUDA cores (64x64 output tile, k-step 16, 4x4
// outputs per thread, f32 accumulators in registers) with the folded BN,
// the residual add and the ReLU fused into its epilogue, so no separate
// elementwise pass touches device memory.  The 3x3 conv is an implicit
// GEMM over the 9 taps: the A tile is gathered from y1 on the fly and the
// zero padding is a masked load, not a padded copy.  The intermediates y1
// and y2 go through device memory; block 0 writes `out`, and every later
// block updates `out` in place (each thread reads its residual element
// before it overwrites it).  Tensor-core (wgmma) tiles, TMA and keeping the
// residual stream on chip are the next steps.
//
// Weight layouts: w1 (nb, C, P), w2 (nb, 3, 3, P, P), w3 (nb, P, C) in the
// stream dtype, row-major; s1/b1/s2/b2 (nb, P) and s3/b3 (nb, C) in f32.
// Each C entry launches 3*nb kernels on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows (pixels) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps float4 rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// out[m, co] = relu(sum_k A[m, k] * wt[k, co] * scale[co] + bias[co]
//                   (+ res[m, co]))
// A is the implicit im2col of `in` (M = N*H*W pixel rows of Cin channels)
// for a KS x KS window, stride 1, zero padding KS/2, with
// k = (dy * KS + dx) * Cin + ci, which is wt's row-major row order.
// `res` may alias `out`: each element is read and written by one thread.
template <typename T, int KS, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
    conv_bn_relu_kernel(const T* __restrict__ in, const T* __restrict__ wt,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, const T* res, T* out,
                        int M, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = KS * KS * Cin;

  // A loader: one pixel row, four consecutive k
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int am = m0 + a_row;
  const bool a_valid = am < M;
  int ah = 0, aw = 0;
  if (KS > 1 && a_valid) {
    const int hw = am % (H * W);
    ah = hw / W;
    aw = hw - ah * W;
  }
  // B loader: one k row, four consecutive output channels
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;
  // compute: rows ty*4 .. ty*4+3, channels tx*4 .. tx*4+3
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_k + j;
      float v = 0.f;
      if (a_valid && k < K) {
        if (KS == 1) {
          v = to_f32(in[(int64_t)am * Cin + k]);
        } else {
          const int tap = k / Cin;
          const int ci = k - tap * Cin;
          const int dy = tap / KS - KS / 2;
          const int dx = tap % KS - KS / 2;
          const int hh = ah + dy;
          const int ww = aw + dx;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f32(in[((int64_t)am + (int64_t)dy * W + dx) * Cin + ci]);
        }
      }
      As[a_k + j][a_row] = v;
    }
    {
      const int k = k0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_n + j;
        Bs[b_k][b_n + j] =
            (k < K && n < Cout) ? to_f32(wt[(int64_t)k * Cout + n]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      const int64_t o = (int64_t)m * Cout + n;
      float v = acc[i][j] * scale[n] + bias[n];
      if (RESIDUAL) v = v + to_f32(res[o]);
      out[o] = from_f32<T>(fmaxf(v, 0.f));
    }
  }
}

template <typename T>
cudaError_t run_chain(const T* x, T* out, T* y1, T* y2, const T* w1,
                      const float* s1, const float* b1, const T* w2,
                      const float* s2, const float* b2, const T* w3,
                      const float* s3, const float* b3, int N, int H, int W,
                      int C, int P, int nb, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 block(THREADS);
  const dim3 grid_p((M + BM - 1) / BM, (P + BN - 1) / BN);
  const dim3 grid_c((M + BM - 1) / BM, (C + BN - 1) / BN);
  const T* cur = x;
  for (int i = 0; i < nb; ++i) {
    conv_bn_relu_kernel<T, 1, false><<<grid_p, block, 0, stream>>>(
        cur, w1 + (int64_t)i * C * P, s1 + (int64_t)i * P,
        b1 + (int64_t)i * P, nullptr, y1, M, H, W, C, P);
    conv_bn_relu_kernel<T, 3, false><<<grid_p, block, 0, stream>>>(
        y1, w2 + (int64_t)i * 9 * P * P, s2 + (int64_t)i * P,
        b2 + (int64_t)i * P, nullptr, y2, M, H, W, P, P);
    conv_bn_relu_kernel<T, 1, true><<<grid_c, block, 0, stream>>>(
        y2, w3 + (int64_t)i * P * C, s3 + (int64_t)i * C,
        b3 + (int64_t)i * C, cur, out, M, H, W, P, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur = out;
  }
  return cudaGetLastError();
}

}  // namespace

#define CHAIN_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* x, void* out, void* y1, void* y2,           \
                      const void* w1, const void* s1, const void* b1,         \
                      const void* w2, const void* s2, const void* b2,         \
                      const void* w3, const void* s3, const void* b3, int N,  \
                      int H, int W, int C, int P, int nb, void* stream) {     \
    return (int)run_chain<T>(                                                 \
        (const T*)x, (T*)out, (T*)y1, (T*)y2, (const T*)w1,                   \
        (const float*)s1, (const float*)b1, (const T*)w2, (const float*)s2,   \
        (const float*)b2, (const T*)w3, (const float*)s3, (const float*)b3,   \
        N, H, W, C, P, nb, (cudaStream_t)stream);                             \
  }

CHAIN_ENTRY(fused_bottleneck_chain_f32, float)
CHAIN_ENTRY(fused_bottleneck_chain_bf16, __nv_bfloat16)
