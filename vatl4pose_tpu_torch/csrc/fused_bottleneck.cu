// Folded-BN ResNet bottleneck chain for Hopper (sm_90a), on the tensor cores.
//
// Replaces: vatl4pose_tpu/kernels/fused_bottleneck.py, `_kernel` called
// through `fused_bottleneck_chain` (the Pallas TPU kernel).
//
// What it computes: nb chained stride-1, non-downsampling bottlenecks over
// an NHWC stream x (N, H, W, C) with eval BatchNorm folded to per-channel
// scale/bias (s, b).  Per block, with P planes:
//   y1  = relu(conv1x1(x, w1) * s1 + b1)                  -> stream dtype
//   y2  = relu(conv3x3(y1, w2, pad 1) * s2 + b2)          -> stream dtype
//   out = relu(conv1x1(y2, w3) * s3 + b3 + x)             -> stream dtype
// Products are accumulated in f32 and every epilogue runs in f32 before the
// cast back to the stream dtype (float or bf16), as in the TPU kernel.
//
// What bounds it on the card: 2*N*H*W*(2*C*P + 9*P*P) FLOPs per block.  In
// bf16 the tensor cores' 989 TFLOP/s; in f32 parity mode three TF32
// products per product (below) at 495 TFLOP/s.  This design writes y1 and
// y2 to device memory and reads the stream twice per block, 4 stream sizes
// of traffic per block, so at R50's first stage it is bound by bytes.
//
// What this design does about it: each of the three products of a block is
// one implicit-GEMM launch on the tensor cores.  A CTA owns 128 pixel rows x
// BN output channels (BN = 64 when the product has at most 64 output
// channels, else 128) and runs 384 threads: two consumer warpgroups, 64
// rows each, issue wgmma (m64nBNk16 bf16, or m64nBNk8 tf32) on 128-byte
// swizzled tiles in shared memory; one producer warpgroup keeps an
// S-stage ring of tiles in flight, handed over by full/empty mbarriers.
// One K step is one 128-byte swizzle row: 64 bf16 or 32 f32 channels.
//   - 1x1 products: A (stream rows, K = input channels) and B (the K-major
//     weights) come by TMA; its zero fill out of bounds covers the ragged
//     M, K and N edges.
//   - 3x3 product: an implicit GEMM over K = 9*P, tap-major.  The producer
//     warpgroup gathers each (tap, channel block) A tile with 16-byte
//     cp.async copies into the same swizzle; a tap outside the image (the
//     row above or below, or the left/right neighbour that lies in another
//     pixel row), a row past M and channels past P are zero-fill copies
//     (src-size 0).  B comes by TMA from a 4-D map, whose bounds zero the
//     channels past P.
//   - f32: 3xTF32.  The weights come split, once a call, by
//     k_major_split_kernel (below): hi = tf32_rna(w) and lo =
//     tf32_rna(w - hi), K-major, and the producer loads B_hi and B_lo by
//     TMA beside A.  Each consumer warpgroup splits its own half of every A
//     tile that lands the same way (hi in place, lo in a second buffer), and
//     sums a_lo*b_hi + a_hi*b_lo, then a_hi*b_hi, for each k-step (8
//     channels) into a fresh accumulator, which an f32 FADD (round to
//     nearest) then adds to the running sum ("promotion").  The
//     tensor core rounds each wgmma's sum toward zero (negating the
//     products negates the result bit for bit).  Summed into one
//     accumulator over all of K (up to 4608), that cut every product to
//     the running sum's last bit, and on trained weights K1 sat 5x further
//     from an f64 forward than cuDNN's f32.  Promoted a k-step, each part
//     still comes out 0 to 1 ulp short, half an ulp on average, and on sums
//     that cancel to a few percent those biases added up to 6x cuDNN's
//     distance.  So each part's last mantissa bit is set before the FADD:
//     that adds one ulp to half of the parts and evens the bias out (0.6x
//     cuDNN's distance there, ROADMAP C1).  The promotion is the
//     consumers' bookkeeping, and the tensor cores do not wait for it: the
//     tile's columns go in chunks of 64 (m64n64k8, two a k-step at
//     BN = 128), two 32-float parts take alternate chunks, and a chunk's
//     wgmmas are issued before the chunk before it is waited for and
//     promoted, so each promotion runs under the next chunk's products; a
//     stage is released as soon as its last chunk has landed.  Each
//     element's FADDs keep their order, so the sums are those of a wait
//     after every k-step, bit for bit.  The two warpgroups share no
//     barrier in the loop, and their index is read warp-uniform, so that
//     the wgmma descriptors live in uniform registers.
//     It was chosen from 13 summation schemes (bf16x6 and XLA's
//     "highest" among them) by their distance from an f64 chain
//     (ROADMAP.md C1).
//   - Epilogue: acc*s + b in f32 is staged in shared memory (the ring's
//     memory, free by then), then each thread takes 16 bytes of a row: adds
//     the residual, ReLU, rounds (__float2bfloat16_rn for bf16) and stores
//     16 bytes.  Block 0 writes `out`; every later block updates `out` in
//     place: each residual element is read, then written, by one thread.
// Keeping the stream on chip across blocks, as the TPU kernel did in VMEM,
// is the next step.
//
// K5 (shuffle_conv3x3_kernel): FastPose's DUC, relu(conv3x3(x, w) * s + b)
// with eval BN folded, stored through PixelShuffle(2), x (N, H, W, Cin) ->
// out (N, 2H, 2W, Cout / 4), f32.  It replaces no TPU kernel: the JAX
// package leaves DUC to XLA.  Bound: 2*N*H*W*9*Cin*Cout FLOPs in three
// TF32 products at 495 TFLOP/s (5.6 ms a DUC at a chunk of 512 of FastPose
// at 256x192); its bytes (x read, out written once) are 0.2 ms.  Design:
// K1's f32 3x3 product as it is (the same CTA, gather producer, TMA for
// B_hi and B_lo, promotion a k-step, each part's last bit set), at BN =
// 128, with Cout apart from Cin, and two changes:
//   - the shuffle is folded into B's row order: shuffle_split_kernel lays
//     out column q * Cout/4 + c with channel 4c + q (and s, b with it), so
//     a tile's 128 columns are one sub-pixel (i, j) = (q / 2, q % 2) of
//     contiguous channels, and the epilogue stores 16-byte runs at
//     out[n, 2h + i, 2w + j, c];
//   - TAP_SUMS: each tap's promoted parts are summed apart and added to
//     acc at the tap's end.  One running f32 sum over 9 * Cin / 8
//     promotions sat 2.9x further from an f64 forward than cuDNN's FFT
//     route at Cin 256 (7.3e-7 against 2.5e-7 of the max, N = 512); two
//     short sums read 2.1e-7.  Its 64 more floats a thread spill (about a
//     sixth more time than one sum); ptxas ignored setmaxnreg here.
//
// Weight layouts (K-major): w1t (nb, P, C), w2t (nb, P, 9, P) with
// k = tap*P + ci, w3t (nb, C, P) in the stream dtype, laid out by the
// wrapper in bf16 and, with their lo halves, by k_major_split_f32 in f32;
// s1/b1/s2/b2 (nb, P) and s3/b3 (nb, C) in f32.  C and P are multiples of 8
// (16-byte TMA strides).  Each chain entry builds its TMA descriptors on
// the host (cuTensorMapEncodeTiled, fetched through the runtime, so no
// -lcuda), launches 3*nb kernels on the caller's stream and returns a
// cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int BM = 128;          // pixel rows per CTA
constexpr int ROW_BYTES = 128;   // one swizzle row = one K step
constexpr int K_STEPS = 4;       // wgmmas per K step: 32 bytes of K each
constexpr int CONSUMERS = 256;   // two warpgroups of wgmma
constexpr int THREADS = 384;     // + one producer warpgroup

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int STAGES = 4;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Cfg<float> {
  static constexpr int STAGES = 3;   // each stage also holds the lo tiles
  static constexpr bool SPLIT = true;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T, int BN>
struct Tile {
  static constexpr int KB = ROW_BYTES / sizeof(T);   // channels per K step
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  // a stage: A, B (and in f32 their lo halves, A_lo then B_lo)
  static constexpr int STAGE = (A_BYTES + B_BYTES) * (Cfg<T>::SPLIT ? 2 : 1);
  static constexpr int B_LOADS = Cfg<T>::SPLIT ? 2 : 1;
  // f32: a stage's B_lo tile
  __device__ static uint8_t* b_lo(uint8_t* stage) {
    return stage + 2 * A_BYTES + B_BYTES;
  }
  static constexpr int STAGES = Cfg<T>::STAGES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LD = BN + 8;   // floats per staged epilogue row
  static_assert(BM * LD * 4 <= RING, "the epilogue is staged in the ring");
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;
  // cp.async groups the 3x3 producer keeps in flight before it signals
  static constexpr int LAG = STAGES - 2;
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed; a wait of more
// than about 10 s (a pipeline fault) traps, so that the launch fails
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16-byte copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma reads)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the async
// wgmma issue and wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma operand descriptor of a K-major tile whose rows are 128 bytes,
// 128-byte swizzled, 8-row groups 1024 bytes apart; the tile starts on a
// 1024-byte boundary.  Adding 2 moves it 32 bytes (one K step) along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC32(d) ACC16(d, 0), ACC16(d, 16)
#define ACC64(d) ACC32(d), ACC16(d, 32), ACC16(d, 48)
// the same registers written only
#define OUT4(d, i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define OUT16(d, i) OUT4(d, i), OUT4(d, i + 4), OUT4(d, i + 8), OUT4(d, i + 12)
#define OUT32(d) OUT16(d, 0), OUT16(d, 16)

// d (64 x BN f32 per warpgroup) += A (64 x K-step) * B (BN x K-step)^T,
// both operands K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// f32 (3xTF32) issues m64n64k8 alone: a 64-column chunk of the tile, so
// that a thread holds acc and two 32-float parts (at BN = 128, three
// 64-float arrays left ptxas spilling acc even at 232 registers a thread)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db));
}

// d = A * B^T into a fresh accumulator (scale-d 0).  d is an output only,
// so the compiler keeps no earlier value of it alive across the issue, and
// ptxas sees no instruction read a wgmma's accumulator while it runs
__device__ __forceinline__ void wgmma_tf32_n64_fresh(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : OUT32(d)
      : "l"(da), "l"(db));
}

template <typename T, int BN>
struct Mma;
template <>
struct Mma<__nv_bfloat16, 64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d = 1) {
    wgmma_bf16_n64(d, a, b, scale_d);
  }
};
template <>
struct Mma<__nv_bfloat16, 128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d = 1) {
    wgmma_bf16_n128(d, a, b, scale_d);
  }
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// a promoted part with its last mantissa bit set: the tensor core's sum
// rounded toward zero is short by half an ulp on average, and setting the
// bit adds one ulp to half of the parts
__device__ __forceinline__ float debias(float p) {
  return __int_as_float(__float_as_int(p) | 1);
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - hi);
}

// 3xTF32: tile -> hi in place, lo into `lo`, 16 bytes a thread at a time
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo,
                                           int bytes, int idx, int nthreads) {
  float4* h4 = reinterpret_cast<float4*>(tile);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int i = idx; i < bytes / 16; i += nthreads) {
    const float4 v = h4[i];
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    h4[i] = h;
    l4[i] = l;
  }
}

// One f32 chunk: a k-step's products for 64 columns of the tile into `p`
// (a fresh accumulator), hi * hi last, so that the tensor core aligns that
// sum to the products and not to a running sum; then, while they run, the
// chunk before, `q`, its bias evened out, is added to its columns of acc,
// acc[OFF, OFF + 32).  da, db, dal, dbl: the chunk's A, B_hi, A_lo and
// B_lo descriptors.
template <int BN, int OFF>
__device__ __forceinline__ void chunk(float (&p)[32], float (&q)[32],
                                      float (&acc)[BN / 2], uint64_t da,
                                      uint64_t db, uint64_t dal,
                                      uint64_t dbl) {
  wgmma_fence();
  wgmma_tf32_n64_fresh(p, dal, db);
  wgmma_tf32_n64(p, da, dbl);
  wgmma_tf32_n64(p, da, db);
  wgmma_commit();
  wgmma_wait<1>();   // q's chunk has landed; p's runs on
  fence_operands(q);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    q[i] = debias(q[i]);   // in place: q is written over next anyway
    acc[OFF + i] = __fadd_rn(acc[OFF + i], q[i]);
  }
  fence_operands(acc);
}

// `first` where FIRST, else `second`: a reference chosen at compile time
template <bool FIRST, typename A>
__device__ __forceinline__ A& pick(A& first, A& second) {
  if constexpr (FIRST)
    return first;
  else
    return second;
}

// acc += tap, tap = 0: a tap's sum of promoted parts added to the total
template <int BN>
__device__ __forceinline__ void add_tap(float (&acc)[BN / 2],
                                        float (&tap)[BN / 2]) {
  fence_operands(tap);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = __fadd_rn(acc[i], tap[i]);
    tap[i] = 0.f;
  }
  fence_operands(acc);
}

// out[0:4] = relu(y + res), 16 bytes of f32
template <bool RESIDUAL>
__device__ __forceinline__ void store_out(const float* y, const float* res,
                                          float* out) {
  float4 v = *reinterpret_cast<const float4*>(y);
  if (RESIDUAL) {
    const float4 r = *reinterpret_cast<const float4*>(res);
    v.x = __fadd_rn(v.x, r.x);
    v.y = __fadd_rn(v.y, r.y);
    v.z = __fadd_rn(v.z, r.z);
    v.w = __fadd_rn(v.w, r.w);
  }
  *reinterpret_cast<float4*>(out) = make_float4(
      fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// out[0:8] = bf16(relu(y + res)), 16 bytes of bf16
template <bool RESIDUAL>
__device__ __forceinline__ void store_out(const float* y,
                                          const __nv_bfloat16* res,
                                          __nv_bfloat16* out) {
  float v[8];
  const float4 y0 = *reinterpret_cast<const float4*>(y);
  const float4 y1 = *reinterpret_cast<const float4*>(y + 4);
  v[0] = y0.x, v[1] = y0.y, v[2] = y0.z, v[3] = y0.w;
  v[4] = y1.x, v[5] = y1.y, v[6] = y1.z, v[7] = y1.w;
  if (RESIDUAL) {
    const uint4 raw = *reinterpret_cast<const uint4*>(res);
    const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], __bfloat162float(r[i]));
  }
  uint4 packed;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16_rn(fmaxf(v[i], 0.f));
  *reinterpret_cast<uint4*>(out) = packed;
}

// ------------------------------------------------------------- kernel ----

// out[m, n] = relu(sum_k A[m, k] * B[n, k] * scale[n] + bias[n]
//                  (+ res[m, n])) for m < M, n < Cout.
// CONV3 = false: A is the (M, Cin) matrix of a_map, K = Cin.
// CONV3 = true: A is the implicit im2col of `in` (M pixel rows of Cin
// channels, images of H x W) for a 3x3 window with zero padding 1,
// k = tap * Cin + ci; b_map is 4-D (Cin, 9, Cout, nb).
// B is block `blk` of b_map, K-major; in f32 b_map holds its hi halves and
// b_lo_map its lo halves (bf16 reads no b_lo_map).  `res` may alias `out`.
// SHUFFLE: column n = q * Cout / 4 + c of pixel (img, h, w) is stored at
// out[img, 2h + q / 2, 2w + q % 2, c] of an (N, 2H, 2W, Cout / 4) stream
// (PixelShuffle(2) of a column order that shuffle_split_kernel makes).
// TAP_SUMS (f32): the promoted parts of each tap (kblocks stages) are
// summed apart and each tap's sum is added to acc at its end, two short
// f32 sums in place of one over all 9 * Cin / 8 k-steps (its 64 floats
// are more than a thread of 384 has: ptxas spills about 56 of them).
// The body of conv_gemm_kernel (K1) and shuffle_conv3x3_kernel (K5).
template <typename T, int BN, bool CONV3, bool RESIDUAL, bool SHUFFLE,
          bool TAP_SUMS>
__device__ __forceinline__ void conv_gemm(
    const CUtensorMap& a_map, const CUtensorMap& b_map,
    const CUtensorMap& b_lo_map, const T* __restrict__ in,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const T* res, T* out, int M, int H, int W, int Cin, int Cout, int blk) {
  using TL = Tile<T, BN>;
  constexpr int S = TL::STAGES;
  constexpr int KB = TL::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::RING);
  uint64_t* empty = full + S;

  const int n_tiles = (Cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;   // the N tiles of one M
  const int m0 = (blockIdx.x / n_tiles) * BM;   // tile run side by side
  const int kblocks = (Cin + KB - 1) / KB;      // K steps per tap
  const int nk = CONV3 ? 9 * kblocks : kblocks;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // full: the TMA arrival (+ one per gathering thread for the 3x3)
      mbar_init(&full[s], CONV3 ? 1 + 128 : 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------- producer ----
    const int p = tid - CONSUMERS;
    if (!CONV3) {
      if (p != 0) return;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        if (kb >= S) mbar_wait(&empty[s], (kb / S - 1) & 1);
        uint8_t* a_dst = smem + s * TL::STAGE;
        mbar_expect_tx(&full[s], TL::A_BYTES + TL::B_LOADS * TL::B_BYTES);
        tma_load_2d(a_dst, &a_map, &full[s], kb * KB, m0);
        tma_load_3d(a_dst + TL::A_BYTES, &b_map, &full[s], kb * KB, n0, blk);
        if constexpr (Cfg<T>::SPLIT)
          tma_load_3d(TL::b_lo(a_dst), &b_lo_map, &full[s], kb * KB, n0,
                      blk);
      }
      return;
    }
    // 3x3: thread p copies 16-byte chunk p % 8 of rows p / 8 + 16 i
    constexpr int VEC = 16 / sizeof(T);
    const int chunk = p & 7;
    int pos[8];   // (h << 16) | w of each row, -1 past M
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (p >> 3) + 16 * i;
      if (m < M) {
        const int hw = m % (H * W);
        const int h = hw / W;
        pos[i] = (h << 16) | (hw - h * W);
      } else {
        pos[i] = -1;
      }
    }
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      if (Cfg<T>::SPLIT && kb > 0) {
        // f32: step kb - 1 is handed over as soon as it lands, before this
        // thread waits for step kb's slot: the consumers, which split each
        // A tile before its products, wait less
        cp_async_wait<0>();
        fence_async_shared();
        mbar_arrive(&full[(kb - 1) % S]);
      }
      if (kb >= S) mbar_wait(&empty[s], (kb / S - 1) & 1);
      uint8_t* a_dst = smem + s * TL::STAGE;
      const int tap = kb / kblocks;
      const int c0 = (kb - tap * kblocks) * KB;
      if (p == 0) {
        mbar_expect_tx(&full[s], TL::B_LOADS * TL::B_BYTES);
        tma_load_4d(a_dst + TL::A_BYTES, &b_map, &full[s], c0, tap, n0, blk);
        if constexpr (Cfg<T>::SPLIT)
          tma_load_4d(TL::b_lo(a_dst), &b_lo_map, &full[s], c0, tap, n0,
                      blk);
      }
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int c = c0 + chunk * VEC;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (p >> 3) + 16 * i;
        const int h = pos[i] >> 16, w = pos[i] & 0xFFFF;
        const bool ok = pos[i] >= 0 && c < Cin &&
                        (unsigned)(h + dy) < (unsigned)H &&
                        (unsigned)(w + dx) < (unsigned)W;
        const T* src =
            ok ? in + ((int64_t)(m0 + r) + dy * W + dx) * Cin + c : in;
        cp_async_16(a_dst + r * ROW_BYTES + ((chunk ^ (r & 7)) << 4), src,
                    ok ? 16 : 0);
      }
      cp_async_commit();
      if (!Cfg<T>::SPLIT && kb >= TL::LAG) {
        // the copies of step kb - LAG have landed: hand them over
        cp_async_wait<TL::LAG>();
        fence_async_shared();
        mbar_arrive(&full[(kb - TL::LAG) % S]);
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    constexpr int LAG = Cfg<T>::SPLIT ? 1 : TL::LAG;   // steps not handed over
    for (int kb = nk > LAG ? nk - LAG : 0; kb < nk; ++kb)
      mbar_arrive(&full[kb % S]);
    return;
  }

  // ------------------------------------------------------ consumers ----
  // warpgroup: rows 64 g .. 64 g + 63; read from lane 0, so that the
  // compiler knows it is the same across the warp and keeps the wgmma
  // descriptors, which depend on it, in uniform registers
  const int g = __shfl_sync(0xffffffff, tid >> 7, 0);
  const int t = tid & 127;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if constexpr (Cfg<T>::SPLIT) {
    // The tile's columns go in chunks of 64 (m64n64k8: at BN = 128 two a
    // k-step, which keeps a thread at acc plus two 32-float parts), and
    // chunks land in part0 and part1 by turns; a stage has an even number
    // of chunks.  Each chunk promotes the one before it, so that the loop
    // has no branch (one there made ptxas spill acc): the first promotes a
    // chunk -1 that leaves acc at +0, where a sum starts: those columns of
    // acc hold the smallest subnormal and part1 -0, whose debias is minus
    // that subnormal, and x + (-x) rounds to +0.
    constexpr int NH = BN / 64;            // chunks a k-step
    constexpr int LAST = (BN - 64) / 2;    // acc of a k-step's last chunk
    // a turn's second chunk at BN = 128: B's columns 64-127, 64 rows on, in
    // the descriptor's 16-byte units
    constexpr uint64_t H1 = NH == 2 ? 64 * ROW_BYTES / 16 : 0;
    float part0[32], part1[32];
    // where the parts are promoted: acc, or with TAP_SUMS the tap's sum
    float tap[BN / 2];
    float(&sum)[BN / 2] = pick<TAP_SUMS>(tap, acc);
    if constexpr (TAP_SUMS) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) tap[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sum[LAST + i] = __int_as_float(1);
      part1[i] = -0.f;
    }
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      mbar_wait(&full[s], (kb / S) & 1);
      uint8_t* a_tile = smem + s * TL::STAGE + g * (TL::A_BYTES / 2);
      uint8_t* b_tile = smem + s * TL::STAGE + TL::A_BYTES;
      uint8_t* a_lo = b_tile + TL::B_BYTES + g * (TL::A_BYTES / 2);
      if (CONV3) fence_async_shared();
      split_tile(a_tile, a_lo, TL::A_BYTES / 2, t, 128);
      fence_async_shared();
      named_sync(2 + g, 128);   // this warpgroup's half of A is split
      const uint64_t da = smem_desc(a_tile), db = smem_desc(b_tile);
      const uint64_t dal = smem_desc(a_lo);
      const uint64_t dbl = smem_desc(TL::b_lo(smem + s * TL::STAGE));
      // two chunks a turn, not unrolled, so that the parts keep their
      // registers from turn to turn (unrolled, ptxas gives every chunk new
      // ones, more than a thread has)
#pragma unroll 1
      for (int c = 0; c < K_STEPS * NH / 2; ++c) {
        const int k0 = 2 * (2 * c / NH), k1 = 2 * ((2 * c + 1) / NH);
        chunk<BN, LAST>(part0, part1, sum, da + k0, db + k0, dal + k0,
                        dbl + k0);
        // the previous stage's last chunk has landed: release it
        if (c == 0 && kb > 0) {
          mbar_arrive(&empty[(kb - 1) % S]);
          // and a tap ended with that stage: its sum is complete
          if constexpr (TAP_SUMS) {
            if (kb % kblocks == 0) add_tap<BN>(acc, tap);
          }
        }
        chunk<BN, 0>(part1, part0, sum, da + k1, db + k1 + H1, dal + k1,
                     dbl + k1 + H1);
      }
    }
    wgmma_wait<0>();
    fence_operands(part1);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sum[LAST + i] = __fadd_rn(sum[LAST + i], debias(part1[i]));
    if constexpr (TAP_SUMS) add_tap<BN>(acc, tap);
    mbar_arrive(&empty[(nk - 1) % S]);
  } else {
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      mbar_wait(&full[s], (kb / S) & 1);
      uint8_t* a_tile = smem + s * TL::STAGE + g * (TL::A_BYTES / 2);
      uint8_t* b_tile = smem + s * TL::STAGE + TL::A_BYTES;
      if (CONV3) fence_async_shared();
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K_STEPS; ++kk)
        Mma<T, BN>::run(acc, smem_desc(a_tile) + 2 * kk,
                        smem_desc(b_tile) + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(&empty[s]);
    }
  }

  // both warpgroups are done with the ring: it becomes the staging tile
  named_sync(1, CONSUMERS);
  float* stg = reinterpret_cast<float*>(smem);
  constexpr int LD = TL::LD;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = g * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
    const int n = n0 + c;
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (n < Cout) {   // Cout is even: n + 1 < Cout too
      s0 = scale[n], s1 = scale[n + 1], b0 = bias[n], b1 = bias[n + 1];
    }
    *reinterpret_cast<float2*>(&stg[r0 * LD + c]) =
        make_float2(__fadd_rn(__fmul_rn(acc[4 * j], s0), b0),
                    __fadd_rn(__fmul_rn(acc[4 * j + 1], s1), b1));
    *reinterpret_cast<float2*>(&stg[(r0 + 8) * LD + c]) =
        make_float2(__fadd_rn(__fmul_rn(acc[4 * j + 2], s0), b0),
                    __fadd_rn(__fmul_rn(acc[4 * j + 3], s1), b1));
  }
  named_sync(2 + g, 128);
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = BN / VEC;   // 16-byte output chunks per row
  for (int i = t; i < 64 * CPR; i += 128) {
    const int r = g * 64 + i / CPR;
    const int c = (i % CPR) * VEC;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= Cout) continue;
    int64_t o;
    if constexpr (SHUFFLE) {
      const int C4 = Cout / 4, q = n / C4;
      const int img = m / (H * W), hw = m - img * (H * W);
      const int h = hw / W, w = hw - h * W;
      o = (((int64_t)img * 2 * H + 2 * h + (q >> 1)) * 2 * W + 2 * w +
           (q & 1)) * C4 + (n - q * C4);
    } else {
      o = (int64_t)m * Cout + n;
    }
    store_out<RESIDUAL>(&stg[r * LD + c], res + o, out + o);
  }
}

template <typename T, int BN, bool CONV3, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, 1)
    conv_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap b_lo_map,
                     const T* __restrict__ in, const float* __restrict__ scale,
                     const float* __restrict__ bias, const T* res, T* out,
                     int M, int H, int W, int Cin, int Cout, int blk) {
  conv_gemm<T, BN, CONV3, RESIDUAL, false, false>(
      a_map, b_map, b_lo_map, in, scale, bias, res, out, M, H, W, Cin, Cout,
      blk);
}

// K5: relu(conv3x3(x, w) * s + b) of an (N, H, W, Cin) f32 stream, stored
// through PixelShuffle(2); B (Cout, 9, Cin) and s, b in the column order
// of shuffle_split_kernel
__global__ void __launch_bounds__(THREADS, 1)
    shuffle_conv3x3_kernel(const __grid_constant__ CUtensorMap b_map,
                           const __grid_constant__ CUtensorMap b_lo_map,
                           const float* __restrict__ in,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, float* out, int M,
                           int H, int W, int Cin, int Cout) {
  conv_gemm<float, 128, true, false, true, true>(
      b_map, b_map, b_lo_map, in, scale, bias, nullptr, out, M, H, W, Cin,
      Cout, 0);
}

// One batched transpose of the f32 weights: `batch` matrices of rows x
// cols, each contiguous in src; matrix q lands transposed, split into hi
// and lo, at (q / taps) * taps * rows * cols + (q % taps) * rows, its rows
// taps * rows apart (taps = 9 lays the 3x3 weights out tap-major:
// k = tap * P + ci).
struct Transpose {
  const float* src;
  float* hi;
  float* lo;
  int batch, rows, cols, taps;
  __host__ __device__ int tiles() const {
    return batch * ((rows + 31) / 32) * ((cols + 31) / 32);
  }
};

// The f32 B operands of a chain, K-major and split as the consumers split
// A, in one launch: 32 x 32 tiles of the three weights, read along their
// rows and written along the K-major rows through shared memory.
__global__ void __launch_bounds__(256)
    k_major_split_kernel(Transpose t1, Transpose t2, Transpose t3) {
  __shared__ float tile[32][33];
  int b = blockIdx.x;
  Transpose t = t1;
  if (b >= t1.tiles()) {
    b -= t1.tiles();
    t = t2;
    if (b >= t2.tiles()) {
      b -= t2.tiles();
      t = t3;
    }
  }
  const int rt = (t.rows + 31) / 32, ct = (t.cols + 31) / 32;
  const int q = b / (rt * ct);
  const int r0 = (b / ct) % rt * 32, c0 = b % ct * 32;
  const float* src = t.src + (int64_t)q * t.rows * t.cols;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < t.rows && c < t.cols)
      tile[i][threadIdx.x] = src[(int64_t)r * t.cols + c];
  }
  __syncthreads();
  const int64_t base = (int64_t)(q / t.taps) * t.taps * t.rows * t.cols +
                       (int64_t)(q % t.taps) * t.rows;
  const int64_t ld = (int64_t)t.taps * t.rows;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;   // out row c, column r
    if (r < t.rows && c < t.cols) {
      float hi, lo;
      split(tile[threadIdx.x][i], hi, lo);
      t.hi[base + c * ld + r] = hi;
      t.lo[base + c * ld + r] = lo;
    }
  }
}

// K5's B operand and epilogue constants in one launch, a block an output
// column n: w (Cout, Cin, 3, 3) as torch keeps it -> (Cout, 9, Cin),
// k = tap * Cin + ci, split into hi and lo, and s, b, where column
// n = q * C4 + c (C4 = Cout / 4) takes channel 4c + q, PixelShuffle(2)'s
// sub-pixel q = 2i + j of channel c: a tile's columns are one sub-pixel
// of contiguous channels, so the epilogue stores 16-byte runs.  The
// channel's 9 * Cin weights are read into shared memory along torch's
// rows and written along K.
__global__ void __launch_bounds__(256)
    shuffle_split_kernel(const float* __restrict__ w,
                         const float* __restrict__ s,
                         const float* __restrict__ b, float* hi, float* lo,
                         float* sp, float* bp, int Cin, int Cout) {
  extern __shared__ float row[];
  const int n = blockIdx.x, C4 = Cout / 4;
  const int oc = 4 * (n % C4) + n / C4;
  const int K = 9 * Cin;
  const float* src = w + (int64_t)oc * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) row[i] = src[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int tap = k / Cin, ci = k - tap * Cin;
    float h, l;
    split(row[ci * 9 + tap], h, l);
    hi[(int64_t)n * K + k] = h;
    lo[(int64_t)n * K + k] = l;
  }
  if (threadIdx.x == 0) sp[n] = s[oc], bp[n] = b[oc];
}

// --------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tiled, 128-byte swizzled map; zero fill out of bounds
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, Cfg<T>::TMA_TYPE, rank, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int bn_for(int cout) { return cout <= 64 ? 64 : 128; }

template <typename T, int BN, bool CONV3, bool RESIDUAL>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b,
                   const CUtensorMap& b_lo, const T* in, const float* s,
                   const float* bias, const T* res, T* out, int M, int H,
                   int W, int Cin, int Cout, int blk, cudaStream_t stream) {
  auto kernel = conv_gemm_kernel<T, BN, CONV3, RESIDUAL>;
  constexpr int smem = Tile<T, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  kernel<<<(unsigned)tiles, THREADS, smem, stream>>>(
      a, b, b_lo, in, s, bias, res, out, M, H, W, Cin, Cout, blk);
  return cudaGetLastError();
}

template <typename T, bool CONV3, bool RESIDUAL>
cudaError_t conv(const CUtensorMap& a, const CUtensorMap& b,
                 const CUtensorMap& b_lo, const T* in, const float* s,
                 const float* bias, const T* res, T* out, int M, int H, int W,
                 int Cin, int Cout, int blk, cudaStream_t stream) {
  return bn_for(Cout) == 64
             ? launch<T, 64, CONV3, RESIDUAL>(a, b, b_lo, in, s, bias, res,
                                              out, M, H, W, Cin, Cout, blk,
                                              stream)
             : launch<T, 128, CONV3, RESIDUAL>(a, b, b_lo, in, s, bias, res,
                                               out, M, H, W, Cin, Cout, blk,
                                               stream);
}

// w1lo, w2lo, w3lo: the lo halves of the f32 weights (nullptr in bf16)
template <typename T>
cudaError_t run_chain(const T* x, T* out, T* y1, T* y2, const T* w1t,
                      const T* w1lo, const float* s1, const float* b1,
                      const T* w2t, const T* w2lo, const float* s2,
                      const float* b2, const T* w3t, const T* w3lo,
                      const float* s3, const float* b3, int N, int H, int W,
                      int C, int P, int nb, cudaStream_t stream) {
  const int M = N * H * W;
  const cuuint64_t e = sizeof(T);
  const cuuint32_t kb = ROW_BYTES / sizeof(T);
  const cuuint32_t bnp = bn_for(P), bnc = bn_for(C);
  CUtensorMap xa, oa, y2a, w1m, w2m, w3m, w1l, w2l, w3l;
  bool ok = true;
  {  // A of the 1x1 products: (M, K) row-major
    const cuuint64_t dc[2] = {(cuuint64_t)C, (cuuint64_t)M};
    const cuuint64_t sc[1] = {C * e};
    const cuuint64_t dp[2] = {(cuuint64_t)P, (cuuint64_t)M};
    const cuuint64_t sp[1] = {P * e};
    const cuuint32_t box[2] = {kb, BM};
    ok = ok && encode<T>(&xa, x, 2, dc, sc, box) &&
         encode<T>(&oa, out, 2, dc, sc, box) &&
         encode<T>(&y2a, y2, 2, dp, sp, box);
  }
  {  // B: w1t (nb, P, C), w3t (nb, C, P), w2t (nb, P, 9, P)
    const cuuint64_t d1[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)nb};
    const cuuint64_t s1b[2] = {C * e, (cuuint64_t)P * C * e};
    const cuuint32_t box1[3] = {kb, bnp, 1};
    const cuuint64_t d3[3] = {(cuuint64_t)P, (cuuint64_t)C, (cuuint64_t)nb};
    const cuuint64_t s3b[2] = {P * e, (cuuint64_t)C * P * e};
    const cuuint32_t box3[3] = {kb, bnc, 1};
    const cuuint64_t d2[4] = {(cuuint64_t)P, 9, (cuuint64_t)P,
                              (cuuint64_t)nb};
    const cuuint64_t s2b[3] = {P * e, 9 * P * e, (cuuint64_t)9 * P * P * e};
    const cuuint32_t box2[4] = {kb, 1, bnp, 1};
    ok = ok && encode<T>(&w1m, w1t, 3, d1, s1b, box1) &&
         encode<T>(&w3m, w3t, 3, d3, s3b, box3) &&
         encode<T>(&w2m, w2t, 4, d2, s2b, box2);
    if constexpr (Cfg<T>::SPLIT) {
      ok = ok && encode<T>(&w1l, w1lo, 3, d1, s1b, box1) &&
           encode<T>(&w3l, w3lo, 3, d3, s3b, box3) &&
           encode<T>(&w2l, w2lo, 4, d2, s2b, box2);
    } else {
      w1l = w1m, w2l = w2m, w3l = w3m;
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  const T* cur = x;
  for (int i = 0; i < nb; ++i) {
    cudaError_t err = conv<T, false, false>(
        i == 0 ? xa : oa, w1m, w1l, nullptr, s1 + (int64_t)i * P,
        b1 + (int64_t)i * P, nullptr, y1, M, H, W, C, P, i, stream);
    if (err != cudaSuccess) return err;
    err = conv<T, true, false>(w2m, w2m, w2l, y1, s2 + (int64_t)i * P,
                               b2 + (int64_t)i * P, nullptr, y2, M, H, W, P,
                               P, i, stream);
    if (err != cudaSuccess) return err;
    err = conv<T, false, true>(y2a, w3m, w3l, nullptr, s3 + (int64_t)i * C,
                               b3 + (int64_t)i * C, cur, out, M, H, W, P, C,
                               i, stream);
    if (err != cudaSuccess) return err;
    cur = out;
  }
  return cudaSuccess;
}

}  // namespace

// w1, w2, w3 as the wrapper takes them: (nb, C, P), (nb, 3, 3, P, P),
// (nb, P, C); out: w1t, w2t, w3t and their lo halves, as run_chain reads them
extern "C" int k_major_split_f32(const void* w1, const void* w2,
                                 const void* w3, void* w1hi, void* w1lo,
                                 void* w2hi, void* w2lo, void* w3hi,
                                 void* w3lo, int C, int P, int nb,
                                 void* stream) {
  const Transpose t1{(const float*)w1, (float*)w1hi, (float*)w1lo, nb, C, P,
                     1};
  const Transpose t2{(const float*)w2, (float*)w2hi, (float*)w2lo, 9 * nb, P,
                     P, 9};
  const Transpose t3{(const float*)w3, (float*)w3hi, (float*)w3lo, nb, P, C,
                     1};
  k_major_split_kernel<<<t1.tiles() + t2.tiles() + t3.tiles(), dim3(32, 8), 0,
                         (cudaStream_t)stream>>>(t1, t2, t3);
  return (int)cudaGetLastError();
}

extern "C" int fused_bottleneck_chain_f32(
    const void* x, void* out, void* y1, void* y2, const void* w1t,
    const void* w1lo, const void* s1, const void* b1, const void* w2t,
    const void* w2lo, const void* s2, const void* b2, const void* w3t,
    const void* w3lo, const void* s3, const void* b3, int N, int H, int W,
    int C, int P, int nb, void* stream) {
  return (int)run_chain<float>(
      (const float*)x, (float*)out, (float*)y1, (float*)y2,
      (const float*)w1t, (const float*)w1lo, (const float*)s1,
      (const float*)b1, (const float*)w2t, (const float*)w2lo,
      (const float*)s2, (const float*)b2, (const float*)w3t,
      (const float*)w3lo, (const float*)s3, (const float*)b3, N, H, W, C, P,
      nb, (cudaStream_t)stream);
}

extern "C" int fused_bottleneck_chain_bf16(
    const void* x, void* out, void* y1, void* y2, const void* w1t,
    const void* s1, const void* b1, const void* w2t, const void* s2,
    const void* b2, const void* w3t, const void* s3, const void* b3, int N,
    int H, int W, int C, int P, int nb, void* stream) {
  using T = __nv_bfloat16;
  return (int)run_chain<T>(
      (const T*)x, (T*)out, (T*)y1, (T*)y2, (const T*)w1t, nullptr,
      (const float*)s1, (const float*)b1, (const T*)w2t, nullptr,
      (const float*)s2, (const float*)b2, (const T*)w3t, nullptr,
      (const float*)s3, (const float*)b3, N, H, W, C, P, nb,
      (cudaStream_t)stream);
}

// K5's operands as the wrapper takes them: w (Cout, Cin, 3, 3), s and b
// (Cout); out: w_hi, w_lo (Cout, 9, Cin) and s, b in the kernel's column
// order
extern "C" int shuffle_split_f32(const void* w, const void* s, const void* b,
                                 void* whi, void* wlo, void* sp, void* bp,
                                 int Cin, int Cout, void* stream) {
  const int smem = 9 * Cin * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(shuffle_split_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  shuffle_split_kernel<<<Cout, 256, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)s, (const float*)b, (float*)whi,
      (float*)wlo, (float*)sp, (float*)bp, Cin, Cout);
  return (int)cudaGetLastError();
}

// K5: x (N, H, W, Cin) -> out (N, 2H, 2W, Cout / 4), both f32 NHWC; whi,
// wlo, sp, bp as shuffle_split_f32 makes them
extern "C" int shuffle_conv3x3_f32(const void* x, const void* whi,
                                   const void* wlo, const void* sp,
                                   const void* bp, void* out, int N, int H,
                                   int W, int Cin, int Cout, void* stream) {
  const cuuint64_t e = sizeof(float);
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout, 1};
  const cuuint64_t strides[3] = {Cin * e, 9 * Cin * e,
                                 (cuuint64_t)9 * Cin * Cout * e};
  const cuuint32_t box[4] = {ROW_BYTES / sizeof(float), 1, 128, 1};
  CUtensorMap hi, lo;
  if (!encode<float>(&hi, whi, 4, dims, strides, box) ||
      !encode<float>(&lo, wlo, 4, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Tile<float, 128>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(shuffle_conv3x3_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int M = N * H * W;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((Cout + 127) / 128);
  shuffle_conv3x3_kernel<<<(unsigned)tiles, THREADS, smem,
                           (cudaStream_t)stream>>>(
      hi, lo, (const float*)x, (const float*)sp, (const float*)bp,
      (float*)out, M, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
