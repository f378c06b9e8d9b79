// Heatmap post-process for Hopper (sm_90a).
//
// Replaces: vatl4pose_tpu/kernels/pallas_postprocess.py, `_kernel` called
// through `fused_postprocess` (the Pallas TPU kernel).
//
// What it computes, from f32 heatmaps (N, K, H, W), in one launch:
//   per joint map: the argmax in row-major order where the first maximum
//   wins (the minimum flat index among the maxima) and the max value; then
//   the decode of ops/heatmap.get_max_pred + subpixel_refine: the coords
//   zeroed where the max is <= 0, rounded, and where 1 < p < size-1 on
//   both axes shifted by 0.25 * sign(right - left), 0.25 * sign(down - up)
//   of the neighbours at the peak clamped to [1, W-2] x [1, H-2];
//   per sample: gc = sum / max(count, 1) over the kept 3x3 local peaks of
//   all K maps, where a pixel is a peak if it equals the 3x3 max around it
//   with a constant-0 border (not -inf), and is kept if it is >= 0.5 * the
//   map's global max (a negative max included).
// Output: coords (N, K, 2) f32 in heatmap space, maxvals (N, K), gc (N,).
//
// What bounds it on the card: one read of the heatmaps (4*N*K*H*W bytes)
// against a few operations per pixel, so device-memory bandwidth.
//
// Design.  One CTA per sample, as the TPU grid (N,): its warps loop over
// the sample's K maps, one map per warp at a time, each in its own
// shared-memory buffer.  A warp copies its map into the buffer with
// asynchronous 16-byte copies, all in flight at once (scalar loads only for
// the few floats before the first 16-byte boundary and after the last),
// and reduces the (value, first index) argmax with shuffles: no block
// barrier per map.  The 3x3 test is separable: each lane walks a band of
// rows down its unit of columns keeping the 3-wide row maxima of the row
// above, its own and the row below.  Where the map's rows are 16-byte
// aligned a unit is 4 columns, one float4 and its 2 neighbours a row;
// elsewhere one column, 3 shared loads a pixel; no divide either way.
// Lane 0 then writes the map's decoded coords and max, and its kept-peak
// sum and count into shared memory; after the one barrier thread 0 sums
// them in joint order, so gc does not depend on scheduling.  The host
// picks the warps per CTA so that two CTAs fit on an SM's shared memory
// and the K maps split into equal rounds.  The buffers bound the warps an
// SM holds (18 at 64x48), so each warp's map copy and walk run back to
// back.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 16;
// two CTAs in an SM's 228 KB, each with the 1 KB the SM reserves for it
constexpr size_t TWO_CTA_BYTES = (233472 / 2) - 1024;
constexpr size_t MAX_SMEM_BYTES = 232448;

// (v, i) beats (bv, bi) if larger, or equal with a lower flat index
__device__ __forceinline__ void arg_better(float v, int i, float& bv,
                                           int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// one 16-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float sign_quarter(float d) {
  return d > 0.f ? 0.25f : (d < 0.f ? -0.25f : 0.f);
}

// the 3-wide max of row y at column x, 0 past the left and right edges;
// `center` receives the pixel itself
__device__ __forceinline__ float row_max3(const float* b, int y, int x, int W,
                                          float& center) {
  const float* p = b + y * W + x;
  center = p[0];
  const float l = x > 0 ? p[-1] : 0.f;
  const float r = x < W - 1 ? p[1] : 0.f;
  return fmaxf(fmaxf(l, center), r);
}

// the 3-wide maxima of row y at columns x..x+3 (x a multiple of 4, the
// row 16-byte aligned), 0 past the left and right edges; `center` receives
// the 4 pixels
__device__ __forceinline__ float4 row_max3x4(const float* b, int y, int x,
                                             int W, float4& center) {
  const float* p = b + y * W + x;
  const float4 q = *reinterpret_cast<const float4*>(p);
  center = q;
  const float l = x > 0 ? p[-1] : 0.f;
  const float r = x + 4 < W ? p[4] : 0.f;
  return make_float4(fmaxf(fmaxf(l, q.x), q.y), fmaxf(fmaxf(q.x, q.y), q.z),
                     fmaxf(fmaxf(q.y, q.z), q.w), fmaxf(fmaxf(q.z, q.w), r));
}

// a pixel is a kept peak if it equals the 3x3 max around it and is at
// least half the map's max
__device__ __forceinline__ void keep_peak(float v, float mf, float thresh,
                                          float& s, int& c) {
  if (v == mf && v >= thresh) {
    s += v;
    c += 1;
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    heatmap_postprocess_kernel(const float* __restrict__ hms,
                               float2* __restrict__ coords,
                               float* __restrict__ maxvals,
                               float* __restrict__ gc, int K, int H, int W,
                               int bands1, int bands4, int buf_floats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int head_floats = (2 * K + 3) & ~3;
  float* part_sum = smem;                                    // K
  int* part_cnt = reinterpret_cast<int*>(smem + K);          // K
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* buf = smem + head_floats + warp * buf_floats;
  const int n = blockIdx.x;
  const int HW = H * W;

  for (int k = warp; k < K; k += nwarps) {
    const float* src = hms + ((int64_t)n * K + k) * HW;
    // floats before src's first 16-byte boundary; b + head is 16-aligned
    int head = (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2);
    head = min(head, HW);
    float* b = buf + ((4 - head) & 3);
    // the map into the buffer: its 16-byte part as asynchronous copies, all
    // in flight at once, the few floats before and after it by plain loads
    const int n4 = (HW - head) >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* b4 = reinterpret_cast<float4*>(b + head);
    for (int i = lane; i < n4; i += 32) copy16(b4 + i, src4 + i);
    asm volatile("cp.async.commit_group;\n" ::);
    const int tail = head + 4 * n4 + lane;
    if (lane < head) b[lane] = src[lane];
    if (tail < HW) b[tail] = src[tail];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    // the argmax: each lane meets its values in increasing flat order
    float bv = -INFINITY;
    int bi = HW;
    if (lane < head) arg_better(b[lane], lane, bv, bi);
    for (int i = lane; i < n4; i += 32) {
      const float4 v = b4[i];
      const int f = head + 4 * i;
      arg_better(v.x, f, bv, bi);
      arg_better(v.y, f + 1, bv, bi);
      arg_better(v.z, f + 2, bv, bi);
      arg_better(v.w, f + 3, bv, bi);
    }
    if (tail < HW) arg_better(b[tail], tail, bv, bi);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      arg_better(ov, oi, bv, bi);
    }
    __syncwarp();
    const float gmax = bv;
    const float thresh = gmax * 0.5f;

    // kept 3x3 local peaks: lane u walks band u / units down its unit of
    // columns u % units, keeping the 3-wide row maxima of the row above,
    // its own and the row below.  A unit is 4 columns read as one float4
    // where the map's rows are 16-byte aligned, else one column.
    float s = 0.f;
    int c = 0;
    if (W % 4 == 0 && head == 0) {
      const int units = W / 4;
      const int bands = bands4;
      const int rows = (H + bands - 1) / bands;
      for (int u = lane; u < bands * units; u += 32) {
        const int band = u / units;
        const int x = 4 * (u - band * units);
        const int y0 = band * rows;
        const int y1 = min(H, y0 + rows);
        if (y0 >= y1) continue;              // the last bands may be empty
        float4 v, vn, unused;
        float4 hp = y0 > 0 ? row_max3x4(b, y0 - 1, x, W, unused)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 hc = row_max3x4(b, y0, x, W, v);
        for (int y = y0; y < y1; ++y) {
          const float4 hn = y + 1 < H ? row_max3x4(b, y + 1, x, W, vn)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          keep_peak(v.x, fmaxf(fmaxf(hp.x, hc.x), hn.x), thresh, s, c);
          keep_peak(v.y, fmaxf(fmaxf(hp.y, hc.y), hn.y), thresh, s, c);
          keep_peak(v.z, fmaxf(fmaxf(hp.z, hc.z), hn.z), thresh, s, c);
          keep_peak(v.w, fmaxf(fmaxf(hp.w, hc.w), hn.w), thresh, s, c);
          hp = hc;
          hc = hn;
          v = vn;
        }
      }
    } else {
      const int rows = (H + bands1 - 1) / bands1;
      for (int u = lane; u < bands1 * W; u += 32) {
        const int band = u / W;
        const int x = u - band * W;
        const int y0 = band * rows;
        const int y1 = min(H, y0 + rows);
        if (y0 >= y1) continue;
        float v, vn, unused;
        float hp = y0 > 0 ? row_max3(b, y0 - 1, x, W, unused) : 0.f;
        float hc = row_max3(b, y0, x, W, v);
        for (int y = y0; y < y1; ++y) {
          const float hn = y + 1 < H ? row_max3(b, y + 1, x, W, vn) : 0.f;
          keep_peak(v, fmaxf(fmaxf(hp, hc), hn), thresh, s, c);
          hp = hc;
          hc = hn;
          v = vn;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL, s, off);
      c += __shfl_xor_sync(FULL, c, off);
    }

    if (lane == 0) {
      const int idx = bi;
      const int py = idx / W;
      const int px = idx - py * W;
      const int pxc = min(max(px, 1), W - 2);
      const int pyc = min(max(py, 1), H - 2);
      const float* pk = b + pyc * W + pxc;
      const float shx = sign_quarter(pk[1] - pk[-1]);
      const float shy = sign_quarter(pk[W] - pk[-W]);
      // coords zeroed where the max is <= 0, then the window test on the
      // rounded coords (integers already: rint changes nothing)
      const float mx = gmax > 0.f ? (float)px : 0.f;
      const float my = gmax > 0.f ? (float)py : 0.f;
      const int pxi = (int)rintf(mx);
      const int pyi = (int)rintf(my);
      const bool ok = pxi > 1 && pxi < W - 1 && pyi > 1 && pyi < H - 1;
      const int64_t o = (int64_t)n * K + k;
      coords[o] = ok ? make_float2(mx + shx, my + shy) : make_float2(mx, my);
      maxvals[o] = gmax;
      part_sum[k] = s;
      part_cnt[k] = c;
    }
    __syncwarp();   // the buffer is refilled with the warp's next map
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f;
    int tc = 0;
    for (int k = 0; k < K; ++k) {
      ts += part_sum[k];
      tc += part_cnt[k];
    }
    gc[n] = ts / (float)max(tc, 1);
  }
}

// The split of a map's rows into bands that balances a warp's 32 lanes
// over (band, unit) tasks, each band walking 2 rows more than it tests.
int pick_bands(int H, int units) {
  int bands = 1;
  long best = -1;
  for (int r = 1; r <= 16 && r <= H; ++r) {
    const long cost = (long)((units * r + 31) / 32) * ((H + r - 1) / r + 2);
    if (best < 0 || cost < best) {
      best = cost;
      bands = r;
    }
  }
  return bands;
}

}  // namespace

extern "C" int heatmap_postprocess_f32(const void* hms, void* coords,
                                       void* maxvals, void* gc, int N, int K,
                                       int H, int W, void* stream) {
  if (N == 0 || K == 0) return 0;
  if (H < 3 || W < 3) return (int)cudaErrorInvalidValue;
  // a map's buffer: HW floats, up to 3 before them for the 16-byte
  // alignment and one past them (the last column's right neighbour read)
  const size_t buf_floats = ((size_t)H * W + 4 + 3) & ~(size_t)3;
  const size_t head_bytes = (((size_t)2 * K + 3) & ~(size_t)3) * 4;
  const size_t buf_bytes = buf_floats * 4;
  if (head_bytes + buf_bytes > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  size_t fit = head_bytes + buf_bytes <= TWO_CTA_BYTES
                   ? (TWO_CTA_BYTES - head_bytes) / buf_bytes
                   : 1;
  int wmax = (int)(fit < (size_t)MAX_WARPS ? fit : MAX_WARPS);
  if (wmax > K) wmax = K;
  const int rounds = (K + wmax - 1) / wmax;
  const int warps = (K + rounds - 1) / rounds;
  const size_t smem = head_bytes + warps * buf_bytes;
  // column bands for 1- and 4-column units
  const int bands1 = pick_bands(H, W);
  const int bands4 = W % 4 == 0 ? pick_bands(H, W / 4) : 1;
  cudaError_t err = cudaFuncSetAttribute(
      heatmap_postprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  heatmap_postprocess_kernel<<<N, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)hms, (float2*)coords, (float*)maxvals, (float*)gc, K, H,
      W, bands1, bands4, (int)buf_floats);
  return (int)cudaGetLastError();
}
