// Fused two-conv first block of vgg_large from the space-to-depth planes:
//   y0[b,y,x,c]  = round_T(prelu0(b0[c] + conv3x3(x, w0)[b,y,x,c]))
//                  for (y, x) inside the H x W image, 0 outside
//   out[b,i,j,o] = round_T(max over the 2x2 pool window (ry, rx) of
//                  prelu1(b1[o] + conv3x3(y0, w1)[b, 2i+ry, 2j+rx, o]))
//
// Replaces: frcnn_tpu/ops/pallas_block0_2conv.py::fused_block0_2conv (kernel
// body `_kernel`, pallas_block0_2conv.py:136), all of its modes. Like the
// Pallas kernel, both convolutions accumulate in float32 with float32
// biases, and y0 is held in the compute dtype T between them (its ZG
// scratch); neither full-resolution [B, H, W, 64] activation reaches device
// memory.
//
// int8 conv1 mode (the Pallas kernel's w1_scales/act_scale, the int8
// serving chain): y0 is quantized from the float32 conv0 + bias + PReLU
// value (no rounding to T first) as clip(rint(y * inv_y), -127, 127) with
// inv_y = float32(1/s_y) (pallas_block0_2conv.py:199-205); conv1 runs on
// int8 tensor cores (mma.sync m16n8k32, int32 sums, exact) with int8 w1
// [9, 64, 64]; the sums are dequantized as fmaf(float(z), ws[o], b1[o]) with
// ws[o] = s_w[o] * s_y (:414-418): one fused multiply-add, rounded once
// (__fmaf_rn), the form XLA gives the Pallas kernel's `z * wscale + b1` on
// the CPU in interpret mode; then PReLU and the 2x2 max.
// int8 output mode (out_scale, :311-312, :427-431), with either conv1: the
// pooled float32 value m is stored as clip(rint(m * inv_out), -127, 127).
// rintf rounds half to even, as jnp.round does; the clip comes before the
// conversion to int8.
//
// Inputs are the planes ops/block0_kernel.py documents:
//   lum4   [B, 4, Hc, Wc]  lum4[b, 2qy+qx, I, J]          = P[2I+qy, 2J+qx, 0]
//   chroma [B, Hc, 8, Wc]  chroma[b, I, 2(2qy+qx)+c-1, J] = P[2I+qy, 2J+qx, c]
// with P = pad(image, 1), Hc = H/2+1, Wc = W/2+1, H and W even. Weights:
//   w0 [27, 64] in T (tap (ky*3+kx)*3+c, the HWIO conv0 kernel flattened),
//   w1 [9, 64, 64] in T (tap dy*3+dx, output channel, input channel),
//   b0, b1 [64] and slopes [2] (prelu0, prelu1) in float32.
//   int8 conv1 mode: w1 [9, 64, 64] int8, ws [64] and inv_y [1] float32.
//   int8 output: inv_out [1] float32.
// Output: NHWC [B, Hc-1, Wc-1, 64] in T (or int8), the channels_last layout
// block 1's convolution reads.
//
// Bound on the H100: operations. conv1 is 2*64*64*9 = 73.7 kFLOP per fine
// pixel (283 GFLOP per batch of 8 at 480x1000; 0.29 ms at the 989 TFLOP/s
// bf16 tensor-core rate), conv0 2*27*64 = 3.5 kFLOP per pixel; the planes
// and the output move ~146 MB in bf16 (0.044 ms at 3.35 TB/s). In float32
// the same work takes ~4.4 ms at 67 TFLOP/s on CUDA cores. The int8 conv1
// halves the tensor-core time (1,979 TOP/s int8).
//
// Design. The output is cut into tiles of PH x PW pooled outputs for all 64
// channels. One persistent block per SM walks the tiles (t, t + grid, ...),
// so what every tile shares is loaded once per block, not once per tile:
// w1 (all 9 taps by cp.async, swizzled as its rows are read), w0, b0, b1
// and the dequant column. Per tile:
//  1. its P patch (two fine rows and columns of halo on each side) arrives
//     in a staging buffer in the planes' own layout: 12 x (PH + 3) plane
//     rows (4 lum phases, 8 chroma rows) of PW + 3 plane columns, copied by
//     16-byte cp.async. A row of an odd-width plane starts on any element,
//     so each row keeps its offset within its first chunk; what lies
//     outside the planes, or in a plane row outside them, is zero-filled.
//     The copy for tile t + grid is issued as soon as tile t has read the
//     buffer, so it lands while tile t runs conv0 and conv1. The block then
//     rearranges the buffer into the fine patch P[3][PR][PC] in T;
//     positions outside the padded image hold zeros or other plane values
//     and feed only y0 positions that are masked;
//  2. conv0 for the (2PH+2) x (2PW+2) fine pixels of the tile and its
//     one-pixel halo. bf16 planes: on tensor cores, an implicit GEMM with
//     M = 660 pixels (42 m16 tiles over 16 warps), N = 64 and K = 27 taps
//     padded with zero weights to 32, on mma.sync.m16n8k16 with float32
//     accumulators; A fragments are gathered from P with per-lane tap
//     offsets, B comes from w0 stored transposed with a padded row (no bank
//     conflicts). Products of bf16 values are exact, so only the float32 sum
//     order differs from a CUDA-core loop. float32 planes: on CUDA cores in
//     float32 (no TF32), a thread per (pixel, 16 channels). Every position
//     outside the image (fine row -1 or H, column -1 or W) is stored as 0,
//     conv1's zero padding: the planes' pad ring would otherwise give
//     prelu0(b0 + ...) there. Letterboxed pixels inside the bucket are not
//     masked, as in the Pallas kernel. y0 is rounded to T (or quantized)
//     into shared memory;
//  3. conv1 as an implicit GEMM (M = fine pixels, N = 64, K = 9 taps x 64)
//     on wgmma: warpgroup pr (4 warps) owns pooled row pr, i.e. fine rows
//     2pr and 2pr + 1 as two 64-pixel M tiles x 64 channels. A comes from
//     the warps' registers, loaded with ldmatrix (warp w holds rows
//     16w..16w+15 of both tiles); B, w1, is read by the tensor cores from
//     shared memory through a matrix descriptor. Both sit K-major in rows
//     of 16-byte chunks XOR-swizzled by the row's address bits, which is
//     the hardware's swizzle: bf16 rows of 128 bytes, chunk c of row p at
//     c ^ (p & 7) (128-byte mode); int8 rows of 64 bytes, at
//     c ^ ((p >> 1) & 3) (64-byte mode), so ldmatrix reads are free of bank
//     conflicts too. bf16: m64n64k16, float32 accumulators; int8:
//     m64n64k32, int32 accumulators (exact). A step is one tap and k slice;
//     the next step's A fragments load while this step's products run
//     (wgmma.wait_group 1). float32 runs on CUDA cores (no TF32): a thread
//     owns a pooled pixel and four output channels, w1 goes through shared
//     memory a tap at a time;
//  4. epilogue: bias, PReLU, the 2x2 max (the vertical pair in registers,
//     the horizontal one by a warp shuffle), one rounding (or the int8
//     quantization), 16-byte NHWC stores (staged through shared memory on
//     the tensor-core paths); the accumulator layout of wgmma is that of
//     mma.sync, one m16 tile per warp.
// Any F (the Pallas kernel takes any): the host pads the weights once per
// weight set (ops/block0_2conv_kernel.py::block0_2conv_weights) to Fp, a
// multiple of 64: zero conv0 columns, zero conv1 rows and columns, a zero
// dequant column; the biases keep F and read as 0 past it. A padded y0
// channel is prelu0(0 + 0) = 0 and meets zero w1 rows, so the F real
// channels are exact, and only they are stored: NHWC [B, Ho, Wo, F].
//  * F <= 64 (Fp = 64): the design above as it is (vgg_large's F = 64 runs
//    this code and this tile);
//  * F > 64 (the kMulti instances): a work item is (tile, 64-channel group
//    go of conv1's outputs). For each 64-channel group gi of y0, in order,
//    the block computes conv0's group gi of the tile into the y0 buffer,
//    loads the 9 x 64 x 64 slice (go, gi) of w1 into the w1 buffer, and
//    adds conv1's products over gi to the accumulators, which stay in
//    registers until the epilogue. Shared memory is the F = 64 plan: w1 is
//    no longer resident, conv0 runs Fp / 64 times per tile and group go,
//    so conv0's work grows by Fp / 64 (accepted: a right kernel first).
// Shared memory of the bf16 instance, in bytes: w1 73,728; y0 84,480 (10 x
// 66 pixels x 64 x 2); staging 8,064 (84 rows x 48 x 2) and its 84 row
// offsets 336; P 4,896 (3 x 12 x 68 x 2); w0 5,120 (64 x 40 x 2); b0, b1
// and the dequant column 768; the staged output 16,384: 193,776 of the
// 232,448 a block may hold (int8 conv1 with int8 output: 106,480). The
// accumulators' registers allow one block of 16 warps per SM either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace frcnn;

constexpr int kF = 64;          // channels of both convolutions
constexpr int kY0StrideF32 = 68;  // floats per pixel of the f32 y0 tile
constexpr int kW0Stride = 40;   // bf16 per row of the transposed w0 (K 32)

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Split of the kernel's time by phase, built only with
// -DFRCNN_PHASE_STAMPS (frcnn_tpu_torch/tools/phase_split.py): thread 0 of
// each block adds the clock64() cycles of each phase of the tile loop to
// its row of g_stamps (8: the block's total), which
// frcnn_block0_2conv_stamps reads and clears. STAMP_SYNC waits for the
// whole block first. Without the flag the macros are empty.
#ifdef FRCNN_PHASE_STAMPS
constexpr int kStampPhases = 8, kStampBlocks = 1024;
__device__ long long g_stamps[kStampBlocks][kStampPhases];
#define STAMP_START                              \
  long long stamp_acc[kStampPhases] = {};        \
  long long stamp_t = clock64();                 \
  const long long stamp_t0 = stamp_t
#define STAMP(i)                                 \
  do {                                           \
    const long long n_ = clock64();              \
    stamp_acc[i] += n_ - stamp_t;                \
    stamp_t = n_;                                \
  } while (0)
#define STAMP_SYNC(i) \
  do {                \
    __syncthreads();  \
    STAMP(i);         \
  } while (0)
#define STAMP_END                                                   \
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {              \
    stamp_acc[kStampPhases - 1] = clock64() - stamp_t0;             \
    for (int i = 0; i < kStampPhases; ++i)                          \
      g_stamps[blockIdx.x][i] = stamp_acc[i];                       \
  }
#else
#define STAMP_START
#define STAMP(i)
#define STAMP_SYNC(i)
#define STAMP_END
#endif

// One mode of the kernel: planes and w0 in T; conv1 in int8 (kQ) or T;
// output in O (T, or int8).
template <typename T, bool kQ, typename O>
struct Mode {
  // y0 and w1 in shared memory: int8, bf16, or float32 (CUDA-core conv1)
  using Y = typename std::conditional<
      kQ, int8_t, T>::type;
  static constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kTC = kQ || kBF16;   // conv1 on tensor cores
  static constexpr bool kTC0 = kBF16;        // conv0 on tensor cores
  // tensor cores: 4 pooled rows x 32 pooled columns (8 x 64 fine pixels),
  // 16 warps; float32 CUDA cores: 2 x 16, 8 warps
  static constexpr int PH = kTC ? 4 : 2, PW = kTC ? 32 : 16;
  static constexpr int kThreads = kTC ? 512 : 256;
};

// Shared-memory plan of one block, in bytes; every region 16-byte aligned.
template <typename T, bool kQ, typename O>
struct Smem {
  using M = Mode<T, kQ, O>;
  using Y = typename M::Y;
  static constexpr int RT = 2 * M::PH + 2, CT = 2 * M::PW + 2;  // y0 tile
  static constexpr int PR = RT + 2, PC = CT + 2;                // P patch
  // staging: NR plane rows (4 lum phases, then 8 chroma rows, per plane
  // row I) of NCH 16-byte chunks, E elements each, covering NJ columns
  // from any offset within the first chunk
  static constexpr int NI = M::PH + 3, NJ = M::PW + 3, NR = 12 * NI;
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int NCH = (NJ + 2 * (E - 1)) / E, SW = NCH * E;
  static constexpr int w1_bytes = M::kTC ? 9 * kF * kF * (int)sizeof(Y)
                                         : kF * kY0StrideF32 * 4;
  static constexpr int y0_bytes = M::kTC ? RT * CT * kF * (int)sizeof(Y)
                                         : RT * CT * kY0StrideF32 * 4;
  static constexpr int stage_bytes = align16(NR * SW * (int)sizeof(T));
  static constexpr int shift_bytes = align16(NR * 4);
  static constexpr int p_bytes = align16(3 * PR * PC * (int)sizeof(T));
  static constexpr int w0_bytes = M::kTC0 ? kF * kW0Stride * 2 : 27 * kF * 4;
  static constexpr int out_bytes =
      M::kTC ? M::PH * M::PW * kF * (int)sizeof(O) : 0;
  static constexpr int w1_off = 0;
  static constexpr int y0_off = w1_off + w1_bytes;
  static constexpr int stage_off = y0_off + y0_bytes;
  static constexpr int shift_off = stage_off + stage_bytes;
  static constexpr int p_off = shift_off + shift_bytes;
  static constexpr int w0_off = p_off + p_bytes;
  static constexpr int b0_off = w0_off + w0_bytes;
  static constexpr int b1_off = b0_off + kF * 4;
  static constexpr int ws_off = b1_off + kF * 4;
  static constexpr int out_off = ws_off + kF * 4;
  static constexpr int total = out_off + out_bytes;
  static_assert(y0_bytes % 16 == 0 && w1_bytes % 16 == 0 &&
                    w0_bytes % 16 == 0,
                "alignment");
};

// the plans the source note states
static_assert(Smem<__nv_bfloat16, false, __nv_bfloat16>::total == 193776,
              "bf16 plan");
static_assert(Smem<__nv_bfloat16, true, int8_t>::total == 106480,
              "int8 plan");

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&two);
}

// two adjacent output channels into the staged tile
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float lo, float hi,
                                       float) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(lo, hi);
}
__device__ __forceinline__ void store2(float* dst, float lo, float hi,
                                       float) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(int8_t* dst, float lo, float hi,
                                       float inv) {
  *reinterpret_cast<uint16_t*>(dst) =
      static_cast<uint16_t>(quant8(lo, inv) | (quant8(hi, inv) << 8));
}

// four adjacent output channels to device memory (float32 CUDA-core path)
__device__ __forceinline__ void store4(float* dst, const float (&m)[4],
                                       float) {
  *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
}
__device__ __forceinline__ void store4(int8_t* dst, const float (&m)[4],
                                       float inv) {
  *reinterpret_cast<uint32_t*>(dst) =
      quant8(m[0], inv) | (quant8(m[1], inv) << 8) |
      (quant8(m[2], inv) << 16) | (quant8(m[3], inv) << 24);
}

// one output channel to device memory (F not a multiple of the vector)
__device__ __forceinline__ void store1(float* dst, float v, float) {
  *dst = v;
}
__device__ __forceinline__ void store1(int8_t* dst, float v, float inv) {
  *dst = static_cast<int8_t>(quant8(v, inv));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D = A (16x16, row) * B (16x8, col) + D; bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float prelu(float y, float a) {
  return y >= 0.0f ? y : a * y;
}

// 16-byte chunk c of row p of an int8 tile (rows of 4 chunks)
__device__ __forceinline__ int s8_chunk(int p, int c) {
  return c ^ ((p >> 1) & 3);
}

// 16 channels (group g) of one y0 pixel into the tile (CUDA-core conv0).
__device__ __forceinline__ void store_y0(float* y0s, int pix, int g,
                                         const float (&v)[16], float) {
  float4* d = reinterpret_cast<float4*>(y0s + pix * kY0StrideF32 + g * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// int8 conv1: y0 quantized from the float32 value at inv_y
__device__ __forceinline__ void store_y0(int8_t* y0s, int pix, int g,
                                         const float (&v)[16], float inv_y) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = quant8(v[4 * q], inv_y) | (quant8(v[4 * q + 1], inv_y) << 8) |
           (quant8(v[4 * q + 2], inv_y) << 16) |
           (quant8(v[4 * q + 3], inv_y) << 24);
  *reinterpret_cast<uint4*>(y0s + pix * kF + s8_chunk(pix, g) * 16) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// The horizontal half of the 2x2 max and the staged store of the tensor-core
// paths: v[n][e] holds the vertical max of accumulator (n, e).
template <typename O>
__device__ __forceinline__ void pool_store(float (&v)[8][4], int pr, int cs,
                                           float inv_out, O* out_s) {
  constexpr int PW = 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[n][e] = fmaxf(v[n][e], __shfl_xor_sync(0xffffffffu, v[n][e], 4));
  if ((g & 1) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pc = (cs + g + 8 * h) >> 1;
      O* dst = out_s + (pr * PW + pc) * kF + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(dst + 8 * n, v[n][2 * h], v[n][2 * h + 1], inv_out);
    }
  }
}

// D (64 x 64, int32) += A (64 x 32 int8, registers) * B (descriptor)
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// conv1's accumulators: int32 sums of int8 products, or float32
template <bool kQ>
using Acc1 = typename std::conditional<kQ, int, float>::type;

// conv1 on wgmma, added to acc: warpgroup pr owns pooled row pr, i.e. fine
// rows 2pr and 2pr + 1 as two 64-pixel M tiles; warp w of the group loads
// the A rows 16w..16w+15 of both (fine columns cs = 16w) with ldmatrix, the
// group's wgmma reads w1 from shared memory. Steps are (tap, k slice); the
// next step's A fragments load while this step's products run.
template <bool kQ, typename Y>
__device__ __forceinline__ void conv1_wgmma(Acc1<kQ> (&acc)[2][32],
                                            const Y* y0s, const Y* w1s) {
  constexpr int CT = 2 * 32 + 2;
  constexpr int kSlices = kQ ? 2 : 4;          // k slices per tap
  constexpr int kSteps = 9 * kSlices;
  constexpr int kRowBytes = kF * (int)sizeof(Y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / 4, cs = (warp % 4) * 16;
  const int am = lane & 15, ak = lane >> 4;
  const uint32_t y0_base = smem_addr(y0s), w1_base = smem_addr(w1s);

  auto load_a = [&](uint32_t (&dst)[2][4], int step) {
    const int tap = step / kSlices, kc = step % kSlices;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pix = (2 * pr + t + dy) * CT + cs + am + dx;
      const uint32_t off =
          kQ ? pix * kF + s8_chunk(pix, 2 * kc + ak) * 16
             : (pix * kF + ((2 * kc + ak) ^ (pix & 7)) * 8) * 2;
      ldmatrix_x4(dst[t], y0_base + off);
    }
  };
  auto mma_step = [&](uint32_t (&cur)[2][4], uint32_t (&nxt)[2][4],
                      int step) {
    const int tap = step / kSlices, kc = step % kSlices;
    const uint64_t desc = kmajor_desc<kRowBytes>(
        w1_base + tap * kF * kRowBytes + kc * 32);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if constexpr (kQ)
        wgmma_s8(acc[t], cur[t], desc);
      else
        wgmma_bf16(acc[t], cur[t], desc);
    }
    wgmma_commit();
    if (step + 1 < kSteps) {
      wgmma_wait<1>();   // the step that read nxt is done
      load_a(nxt, step + 1);
    }
  };
  uint32_t a0[2][4], a1f[2][4];
  load_a(a0, 0);
#pragma unroll 1
  for (int step = 0; step < kSteps; step += 2) {
    mma_step(a0, a1f, step);
    mma_step(a1f, a0, step + 1);
  }
  wgmma_wait<0>();
}

// (dequant +) bias, PReLU and the pool of conv1's accumulators into the
// staged output tile. The accumulator layout is mma.sync's, so the
// epilogue is pool_store's.
template <bool kQ, typename O>
__device__ __forceinline__ void conv1_epilogue(const Acc1<kQ> (&acc)[2][32],
                                               const float* wss,
                                               const float* b1s, float a1,
                                               float inv_out, O* out_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / 4, cs = (warp % 4) * 16;
  // accumulator (t, 4n + e): fine row 2pr+t, fine column cs + g + 8*(e >> 1),
  // channel 8n + 2*tig + (e & 1), with g = lane >> 2, tig = lane & 3
  const int tig = lane & 3;
  float v[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 8 * n + 2 * tig + (e & 1);
      const float bias = b1s[o];
      if constexpr (kQ) {
        const float sc = wss[o];
        v[n][e] = fmaxf(
            prelu(__fmaf_rn(static_cast<float>(acc[0][4 * n + e]), sc, bias),
                  a1),
            prelu(__fmaf_rn(static_cast<float>(acc[1][4 * n + e]), sc, bias),
                  a1));
      } else {
        v[n][e] = fmaxf(prelu(acc[0][4 * n + e] + bias, a1),
                        prelu(acc[1][4 * n + e] + bias, a1));
      }
    }
  pool_store(v, pr, cs, inv_out, out_s);
}

template <bool kQ>
__device__ __forceinline__ void zero_acc(Acc1<kQ> (&acc)[2][32]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[t][k] = 0;
}

// conv1 on CUDA cores (float32, no TF32), added to acc: a thread owns a
// pooled pixel and four output channels of the tile, per item; w1 goes
// through shared memory a tap at a time, from w1g, the (output group,
// input group) slice's first element of the [9, Fp, Fp] weights.
template <typename O>
using AccF32 = float[Mode<float, false, O>::PH * Mode<float, false, O>::PW *
                     (kF / 4) / Mode<float, false, O>::kThreads][4][4];

template <typename O>
__device__ __forceinline__ void conv1_f32(AccF32<O>& acc, const float* y0s,
                                          float* w1s,
                                          const float* __restrict__ w1g,
                                          int Fp) {
  using M = Mode<float, false, O>;
  constexpr int CT = Smem<float, false, O>::CT, NT = M::kThreads;
  constexpr int kItems = M::PH * M::PW * (kF / 4) / NT;
  static_assert(kItems * NT == M::PH * M::PW * (kF / 4), "items");
  const int q = threadIdx.x & 15;  // output channels 4q .. 4q+3
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    __syncthreads();  // the previous tap's reads of w1s are done
    for (int k = threadIdx.x; k < kF * kF; k += NT) {
      const int o = k / kF, c = k % kF;  // w1[tap][o][c] -> w1s[c][o]
      w1s[c * kY0StrideF32 + o] = w1g[((size_t)tap * Fp + o) * Fp + c];
    }
    __syncthreads();
    int base[kItems][4];
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      const int pp = (threadIdx.x + s * NT) >> 4;
      const int fy = 2 * (pp / M::PW), fx = 2 * (pp % M::PW);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        base[s][f] =
            ((fy + (f >> 1) + dy) * CT + fx + (f & 1) + dx) * kY0StrideF32;
    }
#pragma unroll 4
    for (int c = 0; c < kF; ++c) {
      const float4 w =
          *reinterpret_cast<const float4*>(w1s + c * kY0StrideF32 + 4 * q);
#pragma unroll
      for (int s = 0; s < kItems; ++s)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float v = y0s[base[s][f] + c];
          acc[s][f][0] += v * w.x;
          acc[s][f][1] += v * w.y;
          acc[s][f][2] += v * w.z;
          acc[s][f][3] += v * w.w;
        }
    }
  }
}

// bias, PReLU and the pool of conv1_f32's accumulators, to out: channels
// go * 64 + 4q .., those below F
template <typename O>
__device__ __forceinline__ void pool_store_f32(const AccF32<O>& acc,
                                               const float* b1s, float a1,
                                               float inv_out,
                                               O* __restrict__ out, int b,
                                               int pi0, int pj0, int Ho,
                                               int Wo, int go, int F) {
  using M = Mode<float, false, O>;
  constexpr int NT = M::kThreads;
  constexpr int kItems = M::PH * M::PW * (kF / 4) / NT;
  const int q = threadIdx.x & 15;
  const int c0 = go * kF + 4 * q;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int pp = (threadIdx.x + s * NT) >> 4;
    const int i = pi0 + pp / M::PW, j = pj0 + pp % M::PW;
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float bias = b1s[4 * q + k];
      m[k] = prelu(acc[s][0][k] + bias, a1);
#pragma unroll
      for (int f = 1; f < 4; ++f)
        m[k] = fmaxf(m[k], prelu(acc[s][f][k] + bias, a1));
    }
    if (i < Ho && j < Wo && c0 < F) {
      O* dst = out + (((size_t)b * Ho + i) * Wo + j) * F + c0;
      if (F % 4 == 0) {
        store4(dst, m, inv_out);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + k < F) store1(dst + k, m[k], inv_out);
      }
    }
  }
}

template <typename O>
__device__ __forceinline__ void zero_acc_f32(AccF32<O>& acc) {
#pragma unroll
  for (int s = 0; s < (int)(sizeof(acc) / sizeof(acc[0])); ++s)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s][f][k] = 0.0f;
}


// Two adjacent y0 channels (8n + 2 tig, + 1) of pixel p into the tile:
// bf16 in the 16-byte chunk n ^ (p & 7), or quantized to int8 at inv_y.
__device__ __forceinline__ void store_y0_pair(__nv_bfloat16* y0s, int p,
                                              int n, int tig, float v0,
                                              float v1, float) {
  *reinterpret_cast<uint32_t*>(y0s + p * kF + ((n ^ (p & 7)) << 3) +
                               2 * tig) = pack_bf16x2(v0, v1);
}

__device__ __forceinline__ void store_y0_pair(int8_t* y0s, int p, int n,
                                              int tig, float v0, float v1,
                                              float inv_y) {
  *reinterpret_cast<uint16_t*>(y0s + p * kF + s8_chunk(p, n >> 1) * 16 +
                               8 * (n & 1) + 2 * tig) =
      static_cast<uint16_t>(quant8(v0, inv_y) | (quant8(v1, inv_y) << 8));
}

// Issue the cp.async copies of the staging buffer of the tile whose first
// pooled output is (pi0, pj0) of image b, and note each row's offset.
template <typename T, bool kQ, typename O>
__device__ __forceinline__ void stage_tile(const T* lum4, const T* chroma,
                                           T* stage, int* shift, int b,
                                           int pi0, int pj0, int batch,
                                           int Hc, int Wc) {
  using SM = Smem<T, kQ, O>;
  constexpr int NI = SM::NI, E = SM::E, NCH = SM::NCH;
  // element offsets fit in 32 bits (the launcher checks)
  const int n_lum = batch * 4 * Hc * Wc;   // elements; chroma: twice that
  for (int k = threadIdx.x; k < SM::NR * NCH; k += blockDim.x) {
    const int row = k / NCH, q = k % NCH;
    const bool lum = row < 4 * NI;
    const int cr = row - 4 * NI;   // chroma: plane row cr / 8, channel cr % 8
    const int I = pi0 - 1 + (lum ? row % NI : cr / 8);
    const int e0 = (lum ? (b * 4 + row / NI) * Hc + I
                        : (b * Hc + I) * 8 + cr % 8) * Wc + pj0 - 1;
    const int es = e0 & -E;   // the 16-byte chunk holding e0
    if (q == 0) shift[row] = e0 - es;
    const int e = es + q * E, n = lum ? n_lum : 2 * n_lum;
    const int bytes = I >= 0 && I < Hc && e >= 0 && e < n
                          ? (n - e < E ? n - e : E) * (int)sizeof(T)
                          : 0;
    cp_async16z(stage + row * SM::SW + q * E,
                (lum ? lum4 : chroma) + (bytes ? e : 0), bytes);
  }
}

// The staging buffer into the fine patch P[3][PR][PC]: P row yl + 1 of the
// patch is plane row yl >> 1 of phase yl & 1 (the patch starts on an odd
// row and column of P), and likewise for columns.
template <typename T, bool kQ, typename O>
__device__ __forceinline__ void unstage(const T* stage, const int* shift,
                                        T* ps) {
  using SM = Smem<T, kQ, O>;
  constexpr int PR = SM::PR, PC = SM::PC, NI = SM::NI;
  for (int k = threadIdx.x; k < 3 * PR * PC; k += blockDim.x) {
    const int c = k / (PR * PC), rem = k % (PR * PC);
    const int yl = rem / PC + 1, xl = rem % PC + 1;
    const int ph = 2 * (yl & 1) + (xl & 1), il = yl >> 1;
    const int row = c == 0 ? ph * NI + il : 4 * NI + il * 8 + 2 * ph + c - 1;
    ps[k] = stage[row * SM::SW + (xl >> 1) + shift[row]];
  }
}

// conv0 + bias + PReLU of the tile and its halo on tensor cores (bf16
// planes): M = pixels in m16 tiles, N = 64 (8 n8 tiles), K = 27 taps
// padded to 32 (two k16 steps; w0t holds zero weights at taps 27-31).
template <typename Y>
__device__ __forceinline__ void conv0_tc(const __nv_bfloat16* ps,
                                         const __nv_bfloat16* w0t,
                                         const float* b0s, float a0,
                                         float qy, Y* y0s, int pi0, int pj0,
                                         int H, int W) {
  constexpr int RT = 2 * 4 + 2, CT = 2 * 32 + 2, PR = RT + 2, PC = CT + 2;
  constexpr int kPix = RT * CT, kTiles = (kPix + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  constexpr int kWarps = 16;
  const uint16_t* pu = reinterpret_cast<const uint16_t*>(ps);
  // the lane's taps k = 16s + 2 tig + (j & 1) + 8 ((j >> 1) & 1), j = 4s..
  // (the A fragment's columns), as offsets into P; a padded tap reads any
  // finite value of P, which meets a zero weight
  int koff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 16 * (j >> 2) + 2 * tig + (j & 1) + 8 * ((j >> 1) & 1);
    const int tap = k / 3, c = k % 3;
    koff[j] = k < 27 ? (c * PR + tap / 3) * PC + tap % 3 : 0;
  }
  // the lane's biases (channels 8n + 2 tig, + 1)
  float bias[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    bias[n][0] = b0s[8 * n + 2 * tig];
    bias[n][1] = b0s[8 * n + 2 * tig + 1];
  }
#pragma unroll
  for (int it = 0; it < (kTiles + kWarps - 1) / kWarps; ++it) {
    const int mt = warp + it * kWarps;
    if (mt >= kTiles) break;
    int q[2];   // rows g and g + 8 of the m tile: their pixels' P offsets
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      q[h] = p < kPix ? (p / CT) * PC + p % CT : 0;
    }
    uint32_t a[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: row g + 8 (r & 1), taps k, k + 1 of pair r >> 1
        const int h = r & 1, j = 4 * s + 2 * (r >> 1);
        a[s][r] = static_cast<uint32_t>(pu[q[h] + koff[j]]) |
                  (static_cast<uint32_t>(pu[q[h] + koff[j + 1]]) << 16);
      }
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      // B fragments: the lane's channel 8n + g, taps 2 tig (+ 8) of k16
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(
          w0t + (8 * n + g) * kW0Stride + 2 * tig);
#pragma unroll
      for (int s = 0; s < 2; ++s) mma_bf16(acc[n], a[s], wr[8 * s], wr[8 * s + 4]);
    }
    // accumulator (n, e): pixel row g + 8 (e >> 1), channel 8n + 2 tig +
    // (e & 1); 0 outside the image
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      if (p >= kPix) continue;
      const int y = 2 * pi0 - 1 + p / CT, x = 2 * pj0 - 1 + p % CT;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float v0 = in ? prelu(acc[n][2 * h] + bias[n][0], a0) : 0.0f;
        const float v1 = in ? prelu(acc[n][2 * h + 1] + bias[n][1], a0) : 0.0f;
        store_y0_pair(y0s, p, n, tig, v0, v1, qy);
      }
    }
  }
}

// conv0 + bias + PReLU on CUDA cores in float32 (float32 planes): item =
// (pixel, group of 16 channels); positions outside the image store 0
template <typename Y, int PH, int PW>
__device__ __forceinline__ void conv0_f32(const float* ps, const float* w0s,
                                          const float* b0s, float a0,
                                          float qy, Y* y0s, int pi0, int pj0,
                                          int H, int W) {
  constexpr int RT = 2 * PH + 2, CT = 2 * PW + 2, PR = RT + 2, PC = CT + 2;
  for (int item = threadIdx.x; item < RT * CT * 4; item += blockDim.x) {
    const int pix = item % (RT * CT), g = item / (RT * CT);
    const int r = pix / CT, col = pix % CT;
    const int y = 2 * pi0 - 1 + r, x = 2 * pj0 - 1 + col;
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float p = ps[(c * PR + r + ky) * PC + col + kx];
            const float4* wr = reinterpret_cast<const float4*>(
                w0s + ((ky * 3 + kx) * 3 + c) * kF + 16 * g);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 wv = wr[q];
              acc[4 * q + 0] += p * wv.x;
              acc[4 * q + 1] += p * wv.y;
              acc[4 * q + 2] += p * wv.z;
              acc[4 * q + 3] += p * wv.w;
            }
          }
#pragma unroll
      for (int k = 0; k < 16; ++k)
        acc[k] = prelu(acc[k] + b0s[16 * g + k], a0);
    }
    store_y0(y0s, pix, g, acc, qy);
  }
}

// conv0's weights and biases of y0 group gi into shared memory: w0 is
// [27, Fp], a padded channel's bias 0
template <typename T, bool kQ, typename O>
__device__ __forceinline__ void load_conv0(const T* __restrict__ w0,
                                           const float* __restrict__ b0,
                                           unsigned char* smem, int gi,
                                           int Fp, int F) {
  using M = Mode<T, kQ, O>;
  using SM = Smem<T, kQ, O>;
  constexpr int NT = M::kThreads;
  const int tid = threadIdx.x, o0 = gi * kF;
  if constexpr (M::kTC0) {
    // w0 transposed, [o][tap] with taps 27-31 zero: B fragments of conv0
    __nv_bfloat16* w0t = reinterpret_cast<__nv_bfloat16*>(smem + SM::w0_off);
    for (int k = tid; k < kF * 32; k += NT) {
      const int o = k / 32, tap = k % 32;
      w0t[o * kW0Stride + tap] =
          tap < 27 ? w0[tap * Fp + o0 + o] : __float2bfloat16(0.0f);
    }
  } else {
    float* w0s = reinterpret_cast<float*>(smem + SM::w0_off);
    for (int k = tid; k < 27 * kF; k += NT)
      w0s[k] = to_f32(w0[(k / kF) * Fp + o0 + k % kF]);
  }
  float* b0s = reinterpret_cast<float*>(smem + SM::b0_off);
  for (int k = tid; k < kF; k += NT) b0s[k] = o0 + k < F ? b0[o0 + k] : 0.0f;
}

// conv1's biases (and dequant column, [Fp]) of output group go
template <typename T, bool kQ, typename O>
__device__ __forceinline__ void load_conv1_bias(const float* __restrict__ b1,
                                                const float* __restrict__ ws,
                                                unsigned char* smem, int go,
                                                int F) {
  using SM = Smem<T, kQ, O>;
  float* b1s = reinterpret_cast<float*>(smem + SM::b1_off);
  float* wss = reinterpret_cast<float*>(smem + SM::ws_off);
  const int o0 = go * kF;
  for (int k = threadIdx.x; k < kF; k += Mode<T, kQ, O>::kThreads) {
    b1s[k] = o0 + k < F ? b1[o0 + k] : 0.0f;
    if constexpr (kQ) wss[k] = ws[o0 + k];
  }
}

// Start the cp.async copies of w1's slice (output group go, input group
// gi) of [9, Fp, Fp] into shared memory, swizzled as its tile rows are read
// (tensor-core conv1)
template <typename Y>
__device__ __forceinline__ void load_w1(const void* w1, Y* w1s, int go,
                                        int gi, int Fp, int nt) {
  constexpr int kChunks = kF * (int)sizeof(Y) / 16;   // per (tap, o) row
  constexpr bool kS8 = std::is_same<Y, int8_t>::value;
  const unsigned char* src = static_cast<const unsigned char*>(w1);
  for (int k = threadIdx.x; k < 9 * kF * kChunks; k += nt) {
    const int row = k / kChunks, c = k % kChunks;
    const int tap = row / kF, o = row % kF;
    const int dst = kS8 ? s8_chunk(row, c) : (c ^ (row & 7));
    cp_async16(reinterpret_cast<unsigned char*>(w1s) +
                   (row * kChunks + dst) * 16,
               src + (((size_t)tap * Fp + go * kF + o) * Fp + gi * kF) *
                         sizeof(Y) +
                   c * 16);
  }
}

// The channels [64 go, 64 go + 64) of the staged output tile below F, to
// NHWC out (tensor-core paths): 16-byte stores where F is a multiple of a
// chunk's channels, else element by element
template <typename T, bool kQ, typename O>
__device__ __forceinline__ void store_tile(O* __restrict__ out,
                                           const O* out_s, int b, int pi0,
                                           int pj0, int Ho, int Wo, int go,
                                           int F) {
  using M = Mode<T, kQ, O>;
  constexpr int kCE = 16 / (int)sizeof(O);   // channels of a chunk
  constexpr int kChunks = kF / kCE;          // per pooled pixel
  for (int k = threadIdx.x; k < M::PH * M::PW * kChunks; k += M::kThreads) {
    const int pp = k / kChunks, c = k % kChunks;
    const int i = pi0 + pp / M::PW, j = pj0 + pp % M::PW;
    const int c0 = go * kF + c * kCE;
    if (i < Ho && j < Wo && c0 < F) {
      O* dst = out + (((size_t)b * Ho + i) * Wo + j) * F + c0;
      const uint4 v = reinterpret_cast<const uint4*>(out_s + pp * kF)[c];
      if (F % kCE == 0 && c0 + kCE <= F) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const O* e = reinterpret_cast<const O*>(&v);
#pragma unroll
        for (int q = 0; q < kCE; ++q)
          if (c0 + q < F) dst[q] = e[q];
      }
    }
  }
}

// kMulti: F > 64 (Fp / 64 groups), a work item per (tile, output group)
template <typename T, bool kQ, typename O, bool kMulti>
__global__ void __launch_bounds__(Mode<T, kQ, O>::kThreads, 1)
    block0_2conv_kernel(const T* __restrict__ lum4,
                        const T* __restrict__ chroma,
                        const T* __restrict__ w0, const float* __restrict__ b0,
                        const void* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ slopes,
                        const float* __restrict__ ws,
                        const float* __restrict__ inv_y,
                        const float* __restrict__ inv_out,
                        O* __restrict__ out, int batch, int Hc, int Wc,
                        int F) {
  using M = Mode<T, kQ, O>;
  using SM = Smem<T, kQ, O>;
  using Y = typename M::Y;
  constexpr int NT = M::kThreads;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  Y* w1s = reinterpret_cast<Y*>(smem + SM::w1_off);
  Y* y0s = reinterpret_cast<Y*>(smem + SM::y0_off);
  T* stage = reinterpret_cast<T*>(smem + SM::stage_off);
  int* shift = reinterpret_cast<int*>(smem + SM::shift_off);
  T* ps = reinterpret_cast<T*>(smem + SM::p_off);
  float* b0s = reinterpret_cast<float*>(smem + SM::b0_off);
  float* b1s = reinterpret_cast<float*>(smem + SM::b1_off);
  float* wss = reinterpret_cast<float*>(smem + SM::ws_off);

  const int Ho = Hc - 1, Wo = Wc - 1, H = 2 * Ho, W = 2 * Wo;
  const int groups = kMulti ? (F + kF - 1) / kF : 1, Fp = groups * kF;
  const int tiles_x = (Wo + M::PW - 1) / M::PW;
  const int tiles_img = tiles_x * ((Ho + M::PH - 1) / M::PH);
  const int n_items = batch * tiles_img * groups;   // (tile, group go)
  const int tid = threadIdx.x;
  int item = blockIdx.x;
  if (item >= n_items) return;
  STAMP_START;

  // all of w1, once per block (F <= 64)
  if constexpr (M::kTC && !kMulti) load_w1<Y>(w1, w1s, 0, 0, kF, NT);
  {
    const int tile = item / groups;
    stage_tile<T, kQ, O>(lum4, chroma, stage, shift, tile / tiles_img,
                         (tile % tiles_img) / tiles_x * M::PH,
                         tile % tiles_x * M::PW, batch, Hc, Wc);
  }
  cp_async_commit();
  if constexpr (!kMulti) {
    load_conv0<T, kQ, O>(w0, b0, smem, 0, kF, F);
    load_conv1_bias<T, kQ, O>(b1, ws, smem, 0, F);
  }
  const float a0 = slopes[0], a1 = slopes[1];
  const float qy = kQ ? inv_y[0] : 0.0f;
  const float qo = inv_out != nullptr ? inv_out[0] : 0.0f;

  // conv0 of y0 group gi (with its weights staged) into y0s
  auto conv0 = [&](int pi0, int pj0) {
    if constexpr (M::kTC0)
      conv0_tc(ps, reinterpret_cast<const __nv_bfloat16*>(smem + SM::w0_off),
               b0s, a0, qy, y0s, pi0, pj0, H, W);
    else
      conv0_f32<Y, M::PH, M::PW>(
          ps, reinterpret_cast<const float*>(smem + SM::w0_off), b0s, a0, qy,
          y0s, pi0, pj0, H, W);
  };

  STAMP_SYNC(0);   // the prologue
  for (; item < n_items; item += gridDim.x) {
    const int tile = item / groups, go = item % groups;
    const int b = tile / tiles_img;
    const int pi0 = (tile % tiles_img) / tiles_x * M::PH;
    const int pj0 = tile % tiles_x * M::PW;
    // this tile's patch (first: also w1 and the weights) has landed, and
    // the previous item's conv1 is done with y0
    cp_async_wait_all();
    // w1 is read by wgmma through the async proxy
    fence_proxy_async();
    __syncthreads();
    STAMP(1);   // the patch wait
    unstage<T, kQ, O>(stage, shift, ps);
    __syncthreads();
    STAMP(2);   // the unstaging
    const int next = item + gridDim.x;
    if (next < n_items) {   // lands while this item runs
      const int nt = next / groups;
      stage_tile<T, kQ, O>(lum4, chroma, stage, shift, nt / tiles_img,
                           (nt % tiles_img) / tiles_x * M::PH,
                           nt % tiles_x * M::PW, batch, Hc, Wc);
      cp_async_commit();
    }
    STAMP(3);   // issuing the next patch's copies
    if constexpr (!kMulti) {
      conv0(pi0, pj0);
      __syncthreads();
      STAMP(4);   // conv0
      if constexpr (M::kTC) {
        O* out_s = reinterpret_cast<O*>(smem + SM::out_off);
        Acc1<kQ> acc[2][32];
        zero_acc<kQ>(acc);
        conv1_wgmma<kQ>(acc, y0s, w1s);
        conv1_epilogue<kQ>(acc, wss, b1s, a1, qo, out_s);
        __syncthreads();
        STAMP(5);   // conv1 and the pool
        store_tile<T, kQ, O>(out, out_s, b, pi0, pj0, Ho, Wo, 0, F);
        STAMP_SYNC(6);   // the store
      } else {
        AccF32<O> acc;
        zero_acc_f32<O>(acc);
        conv1_f32<O>(acc, y0s, w1s, static_cast<const float*>(w1), kF);
        pool_store_f32<O>(acc, b1s, a1, qo, out, b, pi0, pj0, Ho, Wo, 0, F);
        STAMP_SYNC(5);   // conv1, the pool and the store
      }
    } else {
      load_conv1_bias<T, kQ, O>(b1, ws, smem, go, F);
      if constexpr (M::kTC) {
        Acc1<kQ> acc[2][32];
        zero_acc<kQ>(acc);
        for (int gi = 0; gi < groups; ++gi) {
          load_w1<Y>(w1, w1s, go, gi, Fp, NT);
          cp_async_commit();
          load_conv0<T, kQ, O>(w0, b0, smem, gi, Fp, F);
          __syncthreads();
          conv0(pi0, pj0);
          cp_async_wait_all();   // the slice of w1 (and the next patch)
          fence_proxy_async();
          __syncthreads();
          conv1_wgmma<kQ>(acc, y0s, w1s);
          __syncthreads();   // conv1 is done with y0s and w1s
        }
        O* out_s = reinterpret_cast<O*>(smem + SM::out_off);
        conv1_epilogue<kQ>(acc, wss, b1s, a1, qo, out_s);
        __syncthreads();
        store_tile<T, kQ, O>(out, out_s, b, pi0, pj0, Ho, Wo, go, F);
        __syncthreads();
      } else {
        AccF32<O> acc;
        zero_acc_f32<O>(acc);
        for (int gi = 0; gi < groups; ++gi) {
          load_conv0<T, kQ, O>(w0, b0, smem, gi, Fp, F);
          __syncthreads();
          conv0(pi0, pj0);
          __syncthreads();
          conv1_f32<O>(acc, reinterpret_cast<const float*>(y0s),
                       reinterpret_cast<float*>(w1s),
                       static_cast<const float*>(w1) +
                           (size_t)go * kF * Fp + gi * kF,
                       Fp);
          __syncthreads();   // conv1 is done with y0s and w1s
        }
        pool_store_f32<O>(acc, b1s, a1, qo, out, b, pi0, pj0, Ho, Wo, go,
                          F);
      }
    }
  }
  STAMP_END;
}

template <typename T, bool kQ, typename O, bool kMulti>
int launch_as(const void* lum4, const void* chroma, const void* w0,
              const void* b0, const void* w1, const void* b1,
              const void* slopes, const void* ws, const void* inv_y,
              const void* inv_out, void* out, int batch, int Hc, int Wc,
              int F, void* stream) {
  using M = Mode<T, kQ, O>;
  const int Ho = Hc - 1, Wo = Wc - 1;
  const int smem = Smem<T, kQ, O>::total;
  constexpr auto kernel = block0_2conv_kernel<T, kQ, O, kMulti>;
  // persistent: as many blocks as the current card holds at once, at most
  // one per work item
  int resident = 0;
  cudaError_t e = resident_blocks<block0_2conv_kernel<T, kQ, O, kMulti>>(
      M::kThreads, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)batch * ((Ho + M::PH - 1) / M::PH) *
                          ((Wo + M::PW - 1) / M::PW) *
                          (kMulti ? (F + kF - 1) / kF : 1);
  if (items > 0x7fffffffLL || (long long)batch * 8 * Hc * Wc > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < resident ? items : resident);
  kernel<<<grid, M::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(lum4), static_cast<const T*>(chroma),
      static_cast<const T*>(w0), static_cast<const float*>(b0), w1,
      static_cast<const float*>(b1), static_cast<const float*>(slopes),
      static_cast<const float*>(ws), static_cast<const float*>(inv_y),
      static_cast<const float*>(inv_out), static_cast<O*>(out), batch, Hc,
      Wc, F);
  return (int)cudaGetLastError();
}

// F real channels; the weights padded to Fp = 64 ceil(F / 64) (w0 [27,
// Fp], w1 [9, Fp, Fp], ws [Fp]), the biases [F]
template <typename T, bool kQ, typename O>
int launch(const void* lum4, const void* chroma, const void* w0,
           const void* b0, const void* w1, const void* b1, const void* slopes,
           const void* ws, const void* inv_y, const void* inv_out, void* out,
           int batch, int Hc, int Wc, int F, void* stream) {
  const int Ho = Hc - 1, Wo = Wc - 1;
  if (F < 1) return (int)cudaErrorInvalidValue;
  if (kQ && (ws == nullptr || inv_y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (std::is_same<O, int8_t>::value && inv_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  return F <= kF
             ? launch_as<T, kQ, O, false>(lum4, chroma, w0, b0, w1, b1,
                                          slopes, ws, inv_y, inv_out, out,
                                          batch, Hc, Wc, F, stream)
             : launch_as<T, kQ, O, true>(lum4, chroma, w0, b0, w1, b1,
                                         slopes, ws, inv_y, inv_out, out,
                                         batch, Hc, Wc, F, stream);
}

}  // namespace

// Every launcher takes the same arguments; the pointers a mode does not
// read (ws and inv_y without int8 conv1, inv_out with a float output) may
// be null.
#define FRCNN_BLOCK0_2CONV(NAME, T, Q, O)                                    \
  extern "C" int NAME(const void* lum4, const void* chroma, const void* w0,  \
                      const void* b0, const void* w1, const void* b1,        \
                      const void* slopes, const void* ws, const void* inv_y, \
                      const void* inv_out, void* out, int batch, int Hc,     \
                      int Wc, int F, void* stream) {                         \
    return launch<T, Q, O>(lum4, chroma, w0, b0, w1, b1, slopes, ws, inv_y,  \
                           inv_out, out, batch, Hc, Wc, F, stream);          \
  }

// float conv1 (w1 in T), output in T or int8
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_f32, float, false, float)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_bf16, __nv_bfloat16, false,
                   __nv_bfloat16)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_f32_s8, float, false, int8_t)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_bf16_s8, __nv_bfloat16, false, int8_t)
// int8 conv1 (w1 int8), output in T or int8
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_q_f32, float, true, float)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_q_bf16, __nv_bfloat16, true,
                   __nv_bfloat16)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_q_f32_s8, float, true, int8_t)
FRCNN_BLOCK0_2CONV(frcnn_block0_2conv_q_bf16_s8, __nv_bfloat16, true, int8_t)

#ifdef FRCNN_PHASE_STAMPS
// Copies the phase stamps of the last launch ([1024 blocks][8] cycles, 0
// for a block that did not run) to host memory and clears them.
extern "C" int frcnn_block0_2conv_stamps(long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  void* dev = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, g_stamps);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(g_stamps));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#endif
