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
// bf16 tensor-core rate), conv0 a twentieth of that; the planes and the
// output move ~146 MB in bf16 (0.044 ms at 3.35 TB/s). In float32 the same
// work takes ~4.4 ms at 67 TFLOP/s on CUDA cores. The int8 conv1 halves the
// tensor-core time (1,979 TOP/s int8); conv0 on CUDA cores then sets the
// bound with bf16 or float32 planes alike.
//
// Design (simple first; wgmma, TMA and a pipeline are later work). A block
// owns a tile of PH x PW pooled outputs for all 64 channels:
//  1. the block copies the P patch of its tile (two fine rows and columns
//     of halo on each side) into shared memory as float32, and, in bf16,
//     starts cp.async copies of all of w1 (72 KB) into shared memory;
//  2. conv0 on CUDA cores in float32 for the (2PH+2) x (2PW+2) fine pixels
//     of the tile and its one-pixel halo; every position outside the image
//     (fine row -1 or H, column -1 or W) is stored as 0, which is conv1's
//     zero padding: the planes' pad ring would otherwise give
//     prelu0(b0 + ...) there. Letterboxed pixels inside the bucket are not
//     masked, as in the Pallas kernel. y0 is rounded to T into shared
//     memory;
//  3. conv1 as an implicit GEMM (M = fine pixels, N = 64, K = 9 taps x 64):
//     bf16 on tensor cores with mma.sync.m16n8k16 (float32 accumulators),
//     A and B fragments loaded with ldmatrix from XOR-swizzled shared
//     memory (16-byte chunk c of pixel/row p stored at chunk c ^ (p & 7),
//     so eight consecutive rows hit eight different bank groups). Each warp
//     owns two fine rows (one pooled row) x 16 fine columns x 64 channels.
//     int8 takes the same tile and warps with mma.sync.m16n8k32 (int32
//     accumulators): a row of 64 int8 is 4 chunks, stored at chunk
//     c ^ ((p >> 1) & 3), so eight consecutive rows again cover the eight
//     bank groups; ldmatrix moves the int8 fragments as b16 pairs, whose
//     lane layout is the m16n8k32 one. 79 KB of y0 and w1 against 190 KB
//     in bf16; one block per SM all the same (the accumulators' registers).
//     float32 runs on CUDA cores (no TF32): a thread owns a pooled pixel
//     and four output channels, w1 goes through shared memory a tap at a
//     time;
//  4. epilogue: bias, PReLU, the 2x2 max (the vertical pair in registers,
//     the horizontal one by a warp shuffle), one rounding (or the int8
//     quantization), 16-byte NHWC stores (staged through shared memory on
//     the tensor-core paths).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kF = 64;          // channels of both convolutions
constexpr int kY0StrideF32 = 68;  // floats per pixel of the f32 y0 tile

// One mode of the kernel: planes and w0 in T; conv1 in int8 (kQ) or T;
// output in O (T, or int8).
template <typename T, bool kQ, typename O>
struct Mode {
  // y0 and w1 in shared memory: int8, bf16, or float32 (CUDA-core conv1)
  using Y = typename std::conditional<
      kQ, int8_t, T>::type;
  static constexpr bool kTC = kQ || std::is_same<T, __nv_bfloat16>::value;
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
  static constexpr int w1_bytes = M::kTC ? 9 * kF * kF * (int)sizeof(Y)
                                         : kF * kY0StrideF32 * 4;
  static constexpr int y0_bytes = M::kTC ? RT * CT * kF * (int)sizeof(Y)
                                         : RT * CT * kY0StrideF32 * 4;
  static constexpr int p_bytes = 3 * PR * PC * 4;
  static constexpr int w0_bytes = 27 * kF * 4;
  static constexpr int out_bytes =
      M::kTC ? M::PH * M::PW * kF * (int)sizeof(O) : 0;
  static constexpr int w1_off = 0;
  static constexpr int y0_off = w1_off + w1_bytes;
  static constexpr int p_off = y0_off + y0_bytes;
  static constexpr int w0_off = p_off + p_bytes;
  static constexpr int b0_off = w0_off + w0_bytes;
  static constexpr int b1_off = b0_off + kF * 4;
  static constexpr int ws_off = b1_off + kF * 4;
  static constexpr int out_off = ws_off + kF * 4;
  static constexpr int total = out_off + out_bytes;
  static_assert(p_bytes % 16 == 0 && y0_bytes % 16 == 0 &&
                    w1_bytes % 16 == 0,
                "alignment");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&two);
}

// clip(round(v * inv), -127, 127) as the int8's byte, round half to even
__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
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

// D = A (16x32, row) * B (32x8, col) + D; int8 inputs, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float prelu(float y, float a) {
  return y >= 0.0f ? y : a * y;
}

// 16-byte chunk c of row p of an int8 tile (rows of 4 chunks)
__device__ __forceinline__ int s8_chunk(int p, int c) {
  return c ^ ((p >> 1) & 3);
}

// 16 channels (group g) of one y0 pixel into the tile.
__device__ __forceinline__ void store_y0(__nv_bfloat16* y0s, int pix, int g,
                                         const float (&v)[16], float) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int chunk = (2 * g + h) ^ (pix & 7);
    uint4 q;
    q.x = pack_bf16x2(v[8 * h + 0], v[8 * h + 1]);
    q.y = pack_bf16x2(v[8 * h + 2], v[8 * h + 3]);
    q.z = pack_bf16x2(v[8 * h + 4], v[8 * h + 5]);
    q.w = pack_bf16x2(v[8 * h + 6], v[8 * h + 7]);
    *reinterpret_cast<uint4*>(y0s + pix * kF + chunk * 8) = q;
  }
}

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

// conv1 + PReLU + pool on tensor cores (bf16); out_s stages the tile.
template <typename O>
__device__ __forceinline__ void conv1_pool_bf16(
    const __nv_bfloat16* y0s, const __nv_bfloat16* w1s, const float* b1s,
    float a1, float inv_out, O* out_s) {
  constexpr int CT = 2 * 32 + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / 4;             // pooled row of the warp
  const int cs = (warp % 4) * 16;      // its first fine column
  // ldmatrix row addresses: A rows are pixels (lane & 15), k half lane >> 4;
  // B rows are output channels, matrices (n 0-7 | 8-15) x (k lo | k hi)
  const int am = lane & 15, ak = lane >> 4;
  const int bn = ((lane >> 4) << 3) + (lane & 7), bk = (lane >> 3) & 1;
  const uint32_t y0_base = smem_addr(y0s), w1_base = smem_addr(w1s);

  float acc[2][8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    int pix[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) pix[t] = (2 * pr + t + dy) * CT + cs + am + dx;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int chunk = (2 * kc + ak) ^ (pix[t] & 7);
        ldmatrix_x4(a[t], y0_base + (pix[t] * kF + chunk * 8) * 2);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = np * 16 + bn;
        const int chunk = (2 * kc + bk) ^ (n & 7);
        uint32_t b[4];
        ldmatrix_x4(b, w1_base + ((tap * kF + n) * kF + chunk * 8) * 2);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][2 * np], a[t], b[0], b[1]);
          mma_bf16(acc[t][2 * np + 1], a[t], b[2], b[3]);
        }
      }
    }
  }

  // accumulator (t, n, e): fine row 2pr+t, fine column cs + g + 8*(e >> 1),
  // channel 8n + 2*tig + (e & 1), with g = lane >> 2, tig = lane & 3
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bias = b1s[8 * n + 2 * tig + (e & 1)];
      acc[0][n][e] = fmaxf(prelu(acc[0][n][e] + bias, a1),
                           prelu(acc[1][n][e] + bias, a1));
    }
  pool_store(acc[0], pr, cs, inv_out, out_s);
}

// conv1 + dequant + PReLU + pool on int8 tensor cores; out_s stages the
// tile. Same warp layout and accumulator mapping as conv1_pool_bf16.
template <typename O>
__device__ __forceinline__ void conv1_pool_s8(
    const int8_t* y0s, const int8_t* w1s, const float* wss, const float* b1s,
    float a1, float inv_out, O* out_s) {
  constexpr int CT = 2 * 32 + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / 4, cs = (warp % 4) * 16;
  const int am = lane & 15, ak = lane >> 4;
  const int bn = ((lane >> 4) << 3) + (lane & 7), bk = (lane >> 3) & 1;
  const uint32_t y0_base = smem_addr(y0s), w1_base = smem_addr(w1s);

  int acc[2][8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    int pix[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) pix[t] = (2 * pr + t + dy) * CT + cs + am + dx;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {   // 32 of the tap's 64 inputs a step
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[t], y0_base + pix[t] * kF +
                              s8_chunk(pix[t], 2 * kc + ak) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int row = tap * kF + np * 16 + bn;
        uint32_t b[4];
        ldmatrix_x4(b, w1_base + row * kF + s8_chunk(row, 2 * kc + bk) * 16);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_s8(acc[t][2 * np], a[t], b[0], b[1]);
          mma_s8(acc[t][2 * np + 1], a[t], b[2], b[3]);
        }
      }
    }
  }

  const int tig = lane & 3;
  float v[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 8 * n + 2 * tig + (e & 1);
      const float s = wss[o], bias = b1s[o];
      v[n][e] = fmaxf(
          prelu(__fmaf_rn(static_cast<float>(acc[0][n][e]), s, bias), a1),
          prelu(__fmaf_rn(static_cast<float>(acc[1][n][e]), s, bias), a1));
    }
  pool_store(v, pr, cs, inv_out, out_s);
}

// conv1 + PReLU + pool on CUDA cores (float32, no TF32); writes out.
template <typename O>
__device__ __forceinline__ void conv1_pool_f32(
    const float* y0s, float* w1s, const float* __restrict__ w1,
    const float* b1s, float a1, float inv_out, O* __restrict__ out, int b,
    int pi0, int pj0, int Ho, int Wo) {
  using M = Mode<float, false, O>;
  constexpr int CT = Smem<float, false, O>::CT, NT = M::kThreads;
  constexpr int kItems = M::PH * M::PW * (kF / 4) / NT;
  static_assert(kItems * NT == M::PH * M::PW * (kF / 4), "items");
  const int q = threadIdx.x & 15;  // output channels 4q .. 4q+3
  float acc[kItems][4][4];
#pragma unroll
  for (int s = 0; s < kItems; ++s)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s][f][k] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    __syncthreads();  // the previous tap's reads of w1s are done
    for (int k = threadIdx.x; k < kF * kF; k += NT) {
      const int o = k / kF, c = k % kF;  // w1[tap][o][c] -> w1s[c][o]
      w1s[c * kY0StrideF32 + o] = w1[(tap * kF + o) * kF + c];
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
    if (i < Ho && j < Wo)
      store4(out + (((size_t)b * Ho + i) * Wo + j) * kF + 4 * q, m, inv_out);
  }
}

template <typename T, bool kQ, typename O>
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
                        O* __restrict__ out, int Hc, int Wc) {
  using M = Mode<T, kQ, O>;
  using SM = Smem<T, kQ, O>;
  using Y = typename M::Y;
  constexpr int NT = M::kThreads, RT = SM::RT, CT = SM::CT, PR = SM::PR,
                PC = SM::PC;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  Y* w1s = reinterpret_cast<Y*>(smem + SM::w1_off);
  Y* y0s = reinterpret_cast<Y*>(smem + SM::y0_off);
  float* ps = reinterpret_cast<float*>(smem + SM::p_off);
  float* w0s = reinterpret_cast<float*>(smem + SM::w0_off);
  float* b0s = reinterpret_cast<float*>(smem + SM::b0_off);
  float* b1s = reinterpret_cast<float*>(smem + SM::b1_off);
  float* wss = reinterpret_cast<float*>(smem + SM::ws_off);

  const int Ho = Hc - 1, Wo = Wc - 1, H = 2 * Ho, W = 2 * Wo;
  const int pj0 = blockIdx.x * M::PW, pi0 = blockIdx.y * M::PH;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  if constexpr (M::kTC) {
    // all of w1 into shared memory, swizzled as its tile rows are read;
    // lands while conv0 runs
    constexpr int kChunks = kF * (int)sizeof(Y) / 16;   // per (tap, o) row
    const unsigned char* src = static_cast<const unsigned char*>(w1);
    for (int k = tid; k < 9 * kF * kChunks; k += NT) {
      const int row = k / kChunks, c = k % kChunks;
      const int dst = kQ ? s8_chunk(row, c) : (c ^ (row & 7));
      cp_async16(reinterpret_cast<unsigned char*>(w1s) +
                     (row * kChunks + dst) * 16,
                 src + (size_t)k * 16);
    }
  }
  // P patch: rows 2*pi0-1 .. 2*pi0+2PH+2, columns 2*pj0-1 .. 2*pj0+2PW+2;
  // positions outside the planes only feed masked y0 and are read as 0
  for (int k = tid; k < 3 * PR * PC; k += NT) {
    const int c = k / (PR * PC), rem = k % (PR * PC);
    const int yp = 2 * pi0 - 1 + rem / PC, xp = 2 * pj0 - 1 + rem % PC;
    float v = 0.0f;
    if (yp >= 0 && yp < 2 * Hc && xp >= 0 && xp < 2 * Wc) {
      const size_t I = yp >> 1, J = xp >> 1;
      const int ph = 2 * (yp & 1) + (xp & 1);
      v = c == 0 ? to_f32(lum4[(((size_t)b * 4 + ph) * Hc + I) * Wc + J])
                 : to_f32(chroma[(((size_t)b * Hc + I) * 8 + 2 * ph + c - 1) *
                                     Wc + J]);
    }
    ps[k] = v;
  }
  for (int k = tid; k < 27 * kF; k += NT) w0s[k] = to_f32(w0[k]);
  for (int k = tid; k < kF; k += NT) {
    b0s[k] = b0[k];
    b1s[k] = b1[k];
    if constexpr (kQ) wss[k] = ws[k];
  }
  __syncthreads();

  // conv0 over the tile and its halo: item = (pixel, group of 16 channels);
  // positions outside the image store 0 (int8 0 in the int8 mode)
  const float a0 = slopes[0];
  const float qy = kQ ? inv_y[0] : 0.0f;
  for (int item = tid; item < RT * CT * 4; item += NT) {
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
  if constexpr (M::kTC) cp_async_wait_all();
  __syncthreads();

  const float a1 = slopes[1];
  const float qo = inv_out != nullptr ? inv_out[0] : 0.0f;
  if constexpr (M::kTC) {
    O* out_s = reinterpret_cast<O*>(smem + SM::out_off);
    if constexpr (kQ)
      conv1_pool_s8(y0s, w1s, wss, b1s, a1, qo, out_s);
    else
      conv1_pool_bf16(y0s, w1s, b1s, a1, qo, out_s);
    __syncthreads();
    constexpr int kChunks = kF * (int)sizeof(O) / 16;   // per pooled pixel
    for (int k = tid; k < M::PH * M::PW * kChunks; k += NT) {
      const int pp = k / kChunks, c = k % kChunks;
      const int i = pi0 + pp / M::PW, j = pj0 + pp % M::PW;
      if (i < Ho && j < Wo)
        reinterpret_cast<uint4*>(out + (((size_t)b * Ho + i) * Wo + j) * kF)[c] =
            reinterpret_cast<const uint4*>(out_s + pp * kF)[c];
    }
  } else {
    conv1_pool_f32(y0s, w1s, static_cast<const float*>(w1), b1s, a1, qo, out,
                   b, pi0, pj0, Ho, Wo);
  }
}

template <typename T, bool kQ, typename O>
int launch(const void* lum4, const void* chroma, const void* w0,
           const void* b0, const void* w1, const void* b1, const void* slopes,
           const void* ws, const void* inv_y, const void* inv_out, void* out,
           int batch, int Hc, int Wc, int F, void* stream) {
  using M = Mode<T, kQ, O>;
  const int Ho = Hc - 1, Wo = Wc - 1;
  if (F != kF) return (int)cudaErrorInvalidValue;
  if (kQ && (ws == nullptr || inv_y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (std::is_same<O, int8_t>::value && inv_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  const int smem = Smem<T, kQ, O>::total;
  cudaError_t e = cudaFuncSetAttribute(
      block0_2conv_kernel<T, kQ, O>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Wo + M::PW - 1) / M::PW, (Ho + M::PH - 1) / M::PH, batch);
  block0_2conv_kernel<T, kQ, O>
      <<<grid, M::kThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(lum4), static_cast<const T*>(chroma),
          static_cast<const T*>(w0), static_cast<const float*>(b0), w1,
          static_cast<const float*>(b1), static_cast<const float*>(slopes),
          static_cast<const float*>(ws), static_cast<const float*>(inv_y),
          static_cast<const float*>(inv_out), static_cast<O*>(out), Hc, Wc);
  return (int)cudaGetLastError();
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
