// Heatmap post-process for Hopper (sm_90a).
//
// Replaces: vatl4pose_tpu/kernels/pallas_postprocess.py, `_kernel` called
// through `fused_postprocess` (the Pallas TPU kernel).
//
// What it computes, from f32 heatmaps (N, K, H, W):
//   per joint map: the argmax in row-major order where the first maximum
//   wins (the minimum flat index among the maxima), the max value, and the
//   4 neighbours (left, right, up, down) at the peak clamped to
//   [1, W-2] x [1, H-2], for the +-0.25 subpixel shift;
//   per sample: gc = sum / max(count, 1) over the kept 3x3 local peaks of
//   all K maps, where a pixel is a peak if it equals the 3x3 max around it
//   with a constant-0 border (not -inf), and is kept if it is >= 0.5 * the
//   map's global max (a negative max included).
// Output: joint (N, 7, K) f32 rows px, py, maxval, left, right, up, down;
// part (N*K, 2) f32 per-map kept-peak sum and count; gc (N,) f32.  The
// caller applies the maxval <= 0 masking and the subpixel shift.
//
// What bounds it on the card: one read of the heatmaps (4*N*K*H*W bytes)
// against a few operations per pixel, so device-memory bandwidth.
//
// What this design does about it: one block per (sample, joint) map reads
// the map from device memory once, coalesced, into shared memory while it
// reduces the (value, index) argmax; the peak test then reads the 3x3
// neighbourhoods from shared memory.  Blocks run in no order, unlike the
// TPU grid, so the cross-joint sum of a sample is a second, tiny pass over
// the per-map partials in fixed joint order: the result does not depend on
// scheduling.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// (v, i) beats (bv, bi) if larger, or equal with a lower flat index
__device__ __forceinline__ void arg_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(THREADS)
    heatmap_stats_kernel(const float* __restrict__ hms,
                         float* __restrict__ joint, float* __restrict__ part,
                         int K, int H, int W) {
  extern __shared__ float tile[];  // one H x W map
  __shared__ float warp_v[WARPS];
  __shared__ int warp_i[WARPS];
  __shared__ float warp_s[WARPS];
  __shared__ int warp_c[WARPS];
  __shared__ float gmax_s;
  __shared__ int gidx_s;

  const int map = blockIdx.x;
  const int HW = H * W;
  const float* src = hms + (int64_t)map * HW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // pass 1: load the map once, reduce (max, first index)
  float bv = -INFINITY;
  int bi = HW;
  for (int i = threadIdx.x; i < HW; i += THREADS) {
    const float v = src[i];
    tile[i] = v;
    arg_better(v, i, bv, bi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, bv, off);
    const int oi = __shfl_down_sync(FULL, bi, off);
    arg_better(ov, oi, bv, bi);
  }
  if (lane == 0) {
    warp_v[warp] = bv;
    warp_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = warp_v[0];
    int i = warp_i[0];
    for (int w = 1; w < WARPS; ++w) arg_better(warp_v[w], warp_i[w], v, i);
    gmax_s = v;
    gidx_s = i;
  }
  __syncthreads();
  const float gmax = gmax_s;
  const float thresh = gmax * 0.5f;

  // pass 2: kept 3x3 local peaks, from shared memory
  float s = 0.f;
  int c = 0;
  for (int i = threadIdx.x; i < HW; i += THREADS) {
    const int y = i / W;
    const int x = i - y * W;
    const float v = tile[i];
    float mf = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = y + dy;
        const int xx = x + dx;
        const bool inb = yy >= 0 && yy < H && xx >= 0 && xx < W;
        mf = fmaxf(mf, inb ? tile[yy * W + xx] : 0.f);
      }
    if (v == mf && v >= thresh) {
      s += v;
      c += 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(FULL, s, off);
    c += __shfl_down_sync(FULL, c, off);
  }
  if (lane == 0) {
    warp_s[warp] = s;
    warp_c[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f;
    int tc = 0;
    for (int w = 0; w < WARPS; ++w) {
      ts += warp_s[w];
      tc += warp_c[w];
    }
    const int n = map / K;
    const int k = map - n * K;
    const int idx = gidx_s;
    const int px = idx % W;
    const int py = idx / W;
    const int pxc = min(max(px, 1), W - 2);
    const int pyc = min(max(py, 1), H - 2);
    float* out = joint + (int64_t)n * 7 * K + k;
    out[0 * K] = (float)px;
    out[1 * K] = (float)py;
    out[2 * K] = gmax;
    out[3 * K] = tile[pyc * W + pxc - 1];
    out[4 * K] = tile[pyc * W + pxc + 1];
    out[5 * K] = tile[(pyc - 1) * W + pxc];
    out[6 * K] = tile[(pyc + 1) * W + pxc];
    part[2 * (int64_t)map] = ts;
    part[2 * (int64_t)map + 1] = (float)tc;
  }
}

// second pass: per-sample gc over the K per-map partials, in joint order
__global__ void sample_gc_kernel(const float* __restrict__ part,
                                 float* __restrict__ gc, int N, int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  float c = 0.f;
  for (int k = 0; k < K; ++k) {
    s += part[2 * ((int64_t)n * K + k)];
    c += part[2 * ((int64_t)n * K + k) + 1];
  }
  gc[n] = s / fmaxf(c, 1.f);
}

}  // namespace

extern "C" int heatmap_postprocess_f32(const void* hms, void* joint,
                                       void* part, void* gc, int N, int K,
                                       int H, int W, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)H * W * sizeof(float);
  heatmap_stats_kernel<<<N * K, THREADS, smem, st>>>(
      (const float*)hms, (float*)joint, (float*)part, K, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sample_gc_kernel<<<(N + 127) / 128, 128, 0, st>>>((const float*)part,
                                                    (float*)gc, N, K);
  return (int)cudaGetLastError();
}
