// Fused first conv block of vgg_small from the space-to-depth planes:
//   out[b,i,j,o] = max over the 2x2 pool window (ry, rx) of
//                  prelu(bias[o] + conv3x3(x, w)[b, 2i+ry, 2j+rx, o])
//
// Replaces: frcnn_tpu/ops/pallas_block0.py::fused_block0 (kernel body
// `_kernel`, pallas_block0.py:58), its float output mode and its int8
// output mode (`out_scale`, :99-102). Inputs are the normalized planes the
// serving path feeds (ops/normalization.py):
//   lum4   [B, 4, Hc, Wc]  lum4[b, 2qy+qx, I, J]          = P[2I+qy, 2J+qx, 0]
//   chroma [B, Hc, 8, Wc]  chroma[b, I, 2(2qy+qx)+c-1, J] = P[2I+qy, 2J+qx, c]
// with P = pad(image, 1), Hc = H/2+1, Wc = W/2+1. The weights are the
// HWIO conv kernel flattened to [27, F] (tap t = (ky*3+kx)*3+c), in the
// input dtype; bias [F] and the single PReLU slope [1] are float32.
// Output: NHWC [B, Hc-1, Wc-1, F] in the input dtype (bf16 or f32), the
// channels_last layout block 1's convolution reads directly. In the int8
// output mode the pooled float32 value m is stored as
// clip(rint(m * inv_out), -127, 127) (hopper.cuh's quant8: the product
// rounded once by __fmul_rn, rounding half to even as jnp.round, the clip
// before the conversion or by its saturation, the same bits), with inv_out
// the float32 reciprocal of the next conv's input scale: NHWC int8, half
// the bf16 bytes.
//
// Bound on the H100: bytes. Per output pixel the kernel reads its share of
// the planes (12 values of one cell) and writes F values: at B=8, 450x800,
// F=64 in bf16, 17.4 MB of planes and 92.2 MB of output, 0.033 ms at
// 3.35 TB/s (int8 output: 46 MB, 0.019 ms). The products are 4 phases x 48
// patch values x F per pixel, 17.7 GFLOP per batch: 0.018 ms on bf16
// tensor cores, but 0.26 ms as float32 FMAs on CUDA cores (67 TFLOP/s),
// which is where the work had to leave the CUDA cores.
//
// Design, bf16 planes (float and int8 output; one templated body). The
// Pallas kernel's product [4F, 64] x [64, W] becomes, per output pixel, one
// row of an implicit GEMM on wgmma:
//  * A row = the pixel's 4x4x3 patch, 48 values, exactly three k16 steps.
//    K is ordered k = 2m + cx with m = 12 cy + r12: cell (cy, cx) of the
//    2x2 cells the patch covers, r12 the plane row of the cell (lum phases
//    0-3, then the 8 chroma rows). So a k pair (2m, 2m+1) is two
//    horizontally adjacent elements of one staged plane row, and each A
//    register of the mma.sync fragment layout is two 16-bit loads from the
//    staged planes, with no rearranging pass (a staged row may start on
//    any element, so the pair need not be 32-bit aligned).
//  * B = [48, 4F]: N is ordered (16-channel group q, half h, phase p,
//    channel c8), so wgmma m64n64k16 over one group's 64 columns leaves the
//    four phases of a channel in the same thread's accumulators (n8 tiles
//    4h + p). B is built from w27 in the block's prologue, K-major in rows
//    of 128 bytes (K padded to 64, only 48 read) with the hardware's
//    128-byte swizzle, the layout the descriptor reads:
//      B[n][k] = w27[((ky*3+kx)*3+c)][o] where, for n = (q, h, p, c8):
//        o = 16q + 8h + c8, (ry, rx) = (p >> 1, p & 1);
//      for k = 2m + cx, m = 12 cy + r12: (ph, c) = (r12, 0) for r12 < 4,
//        else ((r12 - 4) >> 1, (r12 - 4) % 2 + 1); (qy, qx) = ph >> 1, ph & 1;
//        ky = 2cy + qy - ry, kx = 2cx + qx - rx; B is 0 unless both lie in
//        [0, 3).
//    This is the Pallas kernel's `block0_weights` re-tiling (its 48 live
//    basis rows) in this kernel's K order.
//  * bias, PReLU and the 4-phase max run in registers; with a slope in
//    [0, 1] PReLU is monotone and max(y, a y), so the max is taken first
//    (bitwise the same result: rounding and PReLU are monotone); then one
//    rounding (or the int8 quantization) into the warp's staged pixels,
//    16-byte chunks XOR-swizzled by pixel; the warp writes each group's
//    16 channels of its 16 consecutive pixels out at once, 16-byte NHWC
//    stores that fill whole 32-byte sectors (bf16).
//  * A tile is 4 output rows x 32 columns (128 pixels, two warpgroups of 64
//    pixels). Its planes, 5 cell rows x 12 plane rows x 33 cells, arrive by
//    16-byte cp.async (each row keeps its offset within its first chunk,
//    chunks beyond the planes are zero-filled) into one of two buffers:
//    the next tile's copies land while this tile computes. A warpgroup
//    starts group q + 1's products before group q's epilogue (two
//    accumulator sets), and two blocks share an SM. Blocks are persistent,
//    as many as the card holds at once, and walk the tiles;
//    pixels past the ragged edge are computed from zero-filled or
//    neighbouring plane values and never stored.
//  * Any F: the host pads w27 with zero columns to a multiple of 64
//    (ops/block0_kernel.py::block0_weights, once per weight set); a block
//    computes one 64-channel slice of it (the grid's y), the bias of a
//    padded channel is 0, and only the F real channels are stored, so the
//    output is [B, Hc-1, Wc-1, F] with no copy. F = 64 is one slice: the
//    code and grid of vgg_small's block 0.
// float32 planes keep the CUDA-core design (TF32 would keep ~3 digits):
// one thread per output pixel, its 48 patch values in registers, float32
// FMAs against weights broadcast from shared memory, 16 channels at a time
// (w27 padded to a multiple of 16; F a multiple of 16 stores 16-byte
// vectors, any other F element by element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace frcnn;

__device__ __forceinline__ float prelu(float y, float a) {
  return y >= 0.0f ? y : a * y;
}

// -- float32 planes: CUDA cores ----------------------------------------------

constexpr int kPix = 128;   // output pixels per block (one row segment)
constexpr int kGroup = 16;  // output channels per inner pass

__device__ __forceinline__ void store_group(float* dst, const float* v,
                                            float /*inv*/) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < kGroup / 4; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void store_group(int8_t* dst, const float* v,
                                            float inv) {
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    packed[q] = quant8(v[4 * q], inv) | (quant8(v[4 * q + 1], inv) << 8) |
                (quant8(v[4 * q + 2], inv) << 16) |
                (quant8(v[4 * q + 3], inv) << 24);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// the first n < kGroup channels of a group, one at a time
__device__ __forceinline__ void store_some(float* dst, const float* v,
                                           float, int n) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    if (k < n) dst[k] = v[k];
}

__device__ __forceinline__ void store_some(int8_t* dst, const float* v,
                                           float inv, int n) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    if (k < n) dst[k] = static_cast<int8_t>(quant8(v[k], inv));
}

template <typename O>
__device__ __forceinline__ void block0_cuda_cores(
    const float* __restrict__ lum4, const float* __restrict__ chroma,
    const float* __restrict__ w27, const float* __restrict__ bias,
    const float* __restrict__ slope, const float* __restrict__ inv_out,
    O* __restrict__ out, int Hc, int Wc, int F) {
  extern __shared__ float4 smem4[];
  const int Fp = (F + kGroup - 1) / kGroup * kGroup;   // w27's columns
  float* ws = reinterpret_cast<float*>(smem4);  // [27][Fp]
  float* sb = ws + 27 * Fp;                     // [Fp], 0 past F
  for (int k = threadIdx.x; k < 27 * Fp; k += blockDim.x) ws[k] = w27[k];
  for (int k = threadIdx.x; k < Fp; k += blockDim.x)
    sb[k] = k < F ? bias[k] : 0.0f;
  __syncthreads();

  const int Ho = Hc - 1, Wo = Wc - 1;
  const int j = blockIdx.x * kPix + threadIdx.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= Wo) return;
  const float a = slope[0];
  const float inv = inv_out != nullptr ? inv_out[0] : 0.0f;

  // patch[yy][xx][c] = P[2i+yy, 2j+xx, c], yy = 2cy+qy, xx = 2cx+qx
  float patch[4][4][3];
#pragma unroll
  for (int cy = 0; cy < 2; ++cy)
#pragma unroll
    for (int cx = 0; cx < 2; ++cx)
#pragma unroll
      for (int qy = 0; qy < 2; ++qy)
#pragma unroll
        for (int qx = 0; qx < 2; ++qx) {
          const int ph = 2 * qy + qx;
          const size_t I = i + cy, J = j + cx;
          patch[2 * cy + qy][2 * cx + qx][0] =
              lum4[(((size_t)b * 4 + ph) * Hc + I) * Wc + J];
#pragma unroll
          for (int c = 1; c < 3; ++c)
            patch[2 * cy + qy][2 * cx + qx][c] =
                chroma[(((size_t)b * Hc + I) * 8 + 2 * ph + c - 1) * Wc + J];
        }

  O* dst = out + (((size_t)b * Ho + i) * Wo + j) * F;
#pragma unroll 1
  for (int og = 0; og < Fp; og += kGroup) {
    float m[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) m[k] = -INFINITY;
#pragma unroll
    for (int ry = 0; ry < 2; ++ry)
#pragma unroll
      for (int rx = 0; rx < 2; ++rx) {
        float acc[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) acc[k] = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float p = patch[ry + ky][rx + kx][c];
              const float4* wr = reinterpret_cast<const float4*>(
                  ws + ((ky * 3 + kx) * 3 + c) * Fp + og);
#pragma unroll
              for (int q = 0; q < kGroup / 4; ++q) {
                const float4 wv = wr[q];
                acc[4 * q + 0] += p * wv.x;
                acc[4 * q + 1] += p * wv.y;
                acc[4 * q + 2] += p * wv.z;
                acc[4 * q + 3] += p * wv.w;
              }
            }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          m[k] = fmaxf(m[k], prelu(acc[k] + sb[og + k], a));
      }
    if (F % kGroup == 0)
      store_group(dst + og, m, inv);
    else
      store_some(dst + og, m, inv, F - og);
  }
}

// -- bf16 planes: tensor cores -----------------------------------------------

constexpr int kF = 64;             // output channels of a block's slice
constexpr int kTH = 4, kTW = 32;   // output rows x columns of a tile
constexpr int kTC = 256;           // threads: two warpgroups of 64 pixels
constexpr int kRows = (kTH + 1) * 12;  // staged plane rows: cell rows x 12
constexpr int kCells = kTW + 1;        // staged cells per plane row
constexpr int kE = 8;                  // bf16 per 16-byte chunk
constexpr int kChunks = (kCells + 2 * (kE - 1)) / kE;  // per staged row
// staged row stride, elements: 24 words, so the four rows a warp's A
// loads touch at once start 8 banks apart
constexpr int kSW = 48;
static_assert(kSW >= kChunks * kE, "staged row");

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of one block, in bytes: B first (1024-byte aligned, as the
// 128-byte swizzle reads its address bits)
template <typename O>
struct Smem {
  static constexpr int b_off = 0, b_bytes = 4 * kF * 128;
  static constexpr int stage_off = b_off + b_bytes;   // two buffers
  static constexpr int stage_bytes = kRows * kSW * 2;
  static constexpr int shift_off = stage_off + 2 * stage_bytes;
  static constexpr int shift_bytes = align16(kRows * 4);
  static constexpr int bias_off = shift_off + 2 * shift_bytes;
  static constexpr int out_off = bias_off + kF * 4;
  static constexpr int total = out_off + kTH * kTW * kF * (int)sizeof(O);
};
static_assert(Smem<__nv_bfloat16>::total == 61408, "bf16 plan");
static_assert(Smem<int8_t>::total == 53216, "int8 plan");

// Row n of B (the note above) into shared memory from w27s (w27 staged):
// its 48 values as 6 16-byte chunks, chunk ch at ch ^ (n & 7), the
// 128-byte swizzle; 0 where a tap misses the pooling phase
__device__ __forceinline__ void build_b_row(__nv_bfloat16* bsm,
                                            const uint16_t* w27s, int n) {
  const int q = n >> 6, nt = (n >> 3) & 7, c8 = n & 7;
  const int o = 16 * q + 8 * (nt >> 2) + c8;
  const int ry = (nt & 3) >> 1, rx = nt & 1;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * ch + e, m = k >> 1, cx = k & 1;
      const int cy = m / 12, r12 = m % 12;
      const int ph = r12 < 4 ? r12 : (r12 - 4) >> 1;
      const int c = r12 < 4 ? 0 : (r12 - 4) % 2 + 1;
      const int ky = 2 * cy + (ph >> 1) - ry, kx = 2 * cx + (ph & 1) - rx;
      const uint32_t v = ky >= 0 && ky < 3 && kx >= 0 && kx < 3
                             ? w27s[((ky * 3 + kx) * 3 + c) * kF + o]
                             : 0u;
      w[e >> 1] = (e & 1) ? w[e >> 1] | (v << 16) : v;
    }
    *reinterpret_cast<uint4*>(bsm + n * 64 + ((ch ^ (n & 7)) << 3)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Start the cp.async copies of the tile whose first output is (i0, j0) of
// image b: staged row ic * 12 + r12 is plane row r12 of cell row i0 + ic,
// from cell j0 on, at an offset within its first chunk (shift).
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* lum4,
                                           const __nv_bfloat16* chroma,
                                           __nv_bfloat16* stage, int* shift,
                                           int b, int i0, int j0, int batch,
                                           int Hc, int Wc) {
  const int n_lum = batch * 4 * Hc * Wc;   // elements; chroma: twice that
#pragma unroll
  for (int u = 0; u < (kRows * kChunks + kTC - 1) / kTC; ++u) {
    const int k = threadIdx.x + kTC * u;
    if (k >= kRows * kChunks) break;
    const int row = k / kChunks, ch = k % kChunks;
    const int ic = row / 12, r12 = row % 12, I = i0 + ic;
    const bool lum = r12 < 4;
    const int e0 = (lum ? (b * 4 + r12) * Hc + I
                        : (b * Hc + I) * 8 + r12 - 4) * Wc + j0;
    const int es = e0 & -kE;   // the 16-byte chunk holding e0
    if (ch == 0) shift[row] = e0 - es;
    const int e = es + ch * kE, n = lum ? n_lum : 2 * n_lum;
    const int bytes =
        I < Hc && e < n ? (n - e < kE ? n - e : kE) * 2 : 0;
    cp_async16z(stage + row * kSW + ch * kE,
                (lum ? lum4 : chroma) + (bytes ? e : 0), bytes);
  }
}

// The A fragments of this thread's pixels p0 + g and p0 + g + 8 (one
// output row orow, columns c and c + 8) from the staged planes: register
// (s, r) holds k = 16s + 2 tig + 8 (r >> 1) of pixel row g + 8 (r & 1),
// i.e. staged row orow * 12 + m, m = 8s + tig + 4 (r >> 1), elements c and
// c + 1 (cells (cy, 0) and (cy, 1))
__device__ __forceinline__ void load_a(uint32_t (&af)[3][4],
                                       const __nv_bfloat16* stage,
                                       const int* shift, int orow, int c) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(stage);
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 6; ++j) {   // m = tig + 4j
    const int row = orow * 12 + tig + 4 * j;
    const uint16_t* e = s + row * kSW + shift[row] + c;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      af[j >> 1][2 * (j & 1) + r] = static_cast<uint32_t>(e[8 * r]) |
                                    (static_cast<uint32_t>(e[8 * r + 1]) << 16);
  }
}

// the pooled values of one 16-channel group into the staged output tile:
// v[h][e] is channel 16q + 8h + 2 tig + (e & 1) of pixel row g + 8 (e >> 1)
__device__ __forceinline__ void stage_out(__nv_bfloat16* out_s, int p0,
                                          int q, const float (&v)[2][4],
                                          float) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g + 8 * r;
      __nv_bfloat162 two =
          __floats2bfloat162_rn(v[h][2 * r], v[h][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out_s + p * kF + (((2 * q + h) ^ (p & 7)) << 3) + 2 * tig) = two;
    }
}

__device__ __forceinline__ void stage_out(int8_t* out_s, int p0, int q,
                                          const float (&v)[2][4], float inv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g + 8 * r;
      *reinterpret_cast<uint16_t*>(out_s + p * kF +
                                   ((q ^ ((p >> 1) & 3)) << 4) + 8 * h +
                                   2 * tig) =
          static_cast<uint16_t>(quant8(v[h][2 * r], inv) |
                                (quant8(v[h][2 * r + 1], inv) << 8));
    }
}

// 16-byte chunk c of staged output pixel p
template <typename O>
__device__ __forceinline__ int out_chunk(int p, int c) {
  return std::is_same<O, int8_t>::value ? c ^ ((p >> 1) & 3) : c ^ (p & 7);
}

// Bias, PReLU and the max over the 4 phases of group q's accumulators
// (n8 tile 4h + p holds phase p of channels 16q + 8h + ..), then the
// staged store. kUnit: a slope in [0, 1], where PReLU is monotone (the
// max goes first: rounding is monotone too, so the result is the same to
// the bit) and equals max(y, a y).
template <bool kUnit, typename O>
__device__ __forceinline__ void epilogue_as(const float (&acc)[32], int q,
                                            const float* bs, float a,
                                            float inv, O* out_s, int p0) {
  const int tig = threadIdx.x & 3;
  float v[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* t = acc + 16 * h + e;   // t[4p]: phase p
      const float bias = bs[16 * q + 8 * h + 2 * tig + (e & 1)];
      if constexpr (kUnit) {
        const float y = fmaxf(fmaxf(t[0], t[4]), fmaxf(t[8], t[12])) + bias;
        v[h][e] = fmaxf(y, a * y);
      } else {
        v[h][e] = fmaxf(fmaxf(prelu(t[0] + bias, a), prelu(t[4] + bias, a)),
                        fmaxf(prelu(t[8] + bias, a), prelu(t[12] + bias, a)));
      }
    }
  stage_out(out_s, p0, q, v, inv);
}

template <typename O>
__device__ __forceinline__ void epilogue(const float (&acc)[32], int q,
                                         const float* bs, float a, float inv,
                                         O* out_s, int p0) {
  if (a >= 0.0f && a <= 1.0f)
    epilogue_as<true>(acc, q, bs, a, inv, out_s, p0);
  else
    epilogue_as<false>(acc, q, bs, a, inv, out_s, p0);
}

// Group q's channels of a warp's 16 staged pixels (p0 .. p0 + 15, one
// output row of the tile) to NHWC: one 32-byte sector (bf16) or 16 bytes
// (int8) of each pixel, 16 bytes a lane; of the slice's channels c0 =
// 64 slice + .., those below F, as 16-byte stores where F is a multiple
// of a chunk's channels, else element by element
template <typename O>
__device__ __forceinline__ void store_group(O* __restrict__ out,
                                            const O* out_s, int p0, int q,
                                            int b, int i, int j0, int Ho,
                                            int Wo, int slice, int F) {
  constexpr int kGC = (int)sizeof(O);   // 16-byte chunks of a group
  constexpr int kCE = 16 / (int)sizeof(O);   // channels of a chunk
  const int lane = threadIdx.x & 31;
  const int p = p0 + lane / kGC, ch = q * kGC + lane % kGC;
  const int j = j0 + p % kTW;
  const int c0 = slice * kF + ch * kCE;
  if (lane < 16 * kGC && i < Ho && j < Wo && c0 < F) {
    O* dst = out + (((size_t)b * Ho + i) * Wo + j) * F + c0;
    const uint4 v =
        reinterpret_cast<const uint4*>(out_s + p * kF)[out_chunk<O>(p, ch)];
    if (F % kCE == 0 && c0 + kCE <= F) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const O* e = reinterpret_cast<const O*>(&v);
#pragma unroll
      for (int k = 0; k < kCE; ++k)
        if (c0 + k < F) dst[k] = e[k];
    }
  }
}

// Start group q's three k16 products (64 pixels x its 64 B columns) into d
// (the first one ignores d's old values)
__device__ __forceinline__ void mma_group(float (&d)[32],
                                          const uint32_t (&af)[3][4],
                                          uint32_t b_base, int q) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 3; ++s)
    wgmma_bf16(d, af[s], kmajor_desc<128>(b_base + q * 64 * 128 + s * 32),
               s > 0);
  wgmma_commit();
}

template <typename O>
__device__ __forceinline__ void block0_tensor_cores(
    const __nv_bfloat16* __restrict__ lum4,
    const __nv_bfloat16* __restrict__ chroma,
    const __nv_bfloat16* __restrict__ w27, const float* __restrict__ bias,
    const float* __restrict__ slope, const float* __restrict__ inv_out,
    O* __restrict__ out, int batch, int Hc, int Wc, int F) {
  using SM = Smem<O>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* bsm = reinterpret_cast<__nv_bfloat16*>(smem + SM::b_off);
  float* bs = reinterpret_cast<float*>(smem + SM::bias_off);
  O* out_s = reinterpret_cast<O*>(smem + SM::out_off);
  auto stage = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + SM::stage_off +
                                            buf * SM::stage_bytes);
  };
  auto shift = [&](int buf) {
    return reinterpret_cast<int*>(smem + SM::shift_off +
                                  buf * SM::shift_bytes);
  };

  const int Ho = Hc - 1, Wo = Wc - 1;
  const int tiles_x = (Wo + kTW - 1) / kTW;
  const int tiles_img = tiles_x * ((Ho + kTH - 1) / kTH);
  const int n_tiles = batch * tiles_img;
  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  stage_tile(lum4, chroma, stage(0), shift(0), tile / tiles_img,
             (tile % tiles_img) / tiles_x * kTH, tile % tiles_x * kTW, batch,
             Hc, Wc);
  cp_async_commit();
  // B from the slice's columns of w27 (padded to Fp), staged in the output
  // tile's space (one round of global loads); a padded channel's bias is 0
  const int slice = blockIdx.y, Fp = gridDim.y * kF;
  __nv_bfloat16* w27s = reinterpret_cast<__nv_bfloat16*>(out_s);
  static_assert(27 * kF * 2 <= kTH * kTW * kF, "w27 fits the output tile");
  for (int k = tid; k < 27 * kF; k += kTC)
    w27s[k] = w27[(k / kF) * Fp + slice * kF + k % kF];
  for (int k = tid; k < kF; k += kTC)
    bs[k] = slice * kF + k < F ? bias[slice * kF + k] : 0.0f;
  __syncthreads();
  static_assert(kTC == 4 * kF, "a thread per row of B");
  build_b_row(bsm, reinterpret_cast<const uint16_t*>(w27s), tid);
  fence_proxy_async();
  const float a = slope[0];
  const float inv = inv_out != nullptr ? inv_out[0] : 0.0f;

  // this thread's pixels: rows g and g + 8 of its warp's 16 (p0 = 16 warp),
  // in output row p0 / kTW of the tile, columns c and c + 8
  const int warp = tid >> 5, g = (tid & 31) >> 2;
  const int p0 = 16 * warp, orow = p0 / kTW, c = p0 % kTW + g;
  const uint32_t b_base = smem_addr(bsm);
  float acc0[32], acc1[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc0[k] = acc1[k] = 0.0f;

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / tiles_img;
    const int i0 = (tile % tiles_img) / tiles_x * kTH;
    const int j0 = tile % tiles_x * kTW;
    const int cur = it & 1;
    cp_async_wait_all();
    // this tile's planes have landed; every warp is done with the last
    // tile's planes and its own staged pixels
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < n_tiles) {   // lands while this tile computes
      stage_tile(lum4, chroma, stage(cur ^ 1), shift(cur ^ 1),
                 next / tiles_img, (next % tiles_img) / tiles_x * kTH,
                 next % tiles_x * kTW, batch, Hc, Wc);
      cp_async_commit();
    }
    uint32_t af[3][4];
    load_a(af, stage(cur), shift(cur), orow, c);

    // group q + 1's products run while group q's epilogue does; each
    // group's channels go out as soon as they are staged
    const int i = i0 + orow;
    auto finish = [&](const float(&acc)[32], int q) {
      epilogue(acc, q, bs, a, inv, out_s, p0);
      __syncwarp();
      store_group(out, out_s, p0, q, b, i, j0, Ho, Wo, slice, F);
    };
    mma_group(acc0, af, b_base, 0);
    mma_group(acc1, af, b_base, 1);
    wgmma_wait<1>();
    finish(acc0, 0);
    mma_group(acc0, af, b_base, 2);
    wgmma_wait<1>();
    finish(acc1, 1);
    mma_group(acc1, af, b_base, 3);
    wgmma_wait<1>();
    finish(acc0, 2);
    wgmma_wait<0>();
    finish(acc1, 3);
  }
}

// T: the planes' and weights' type; O: the output's (T, or int8 with
// inv_out, which is unused otherwise)
template <typename T>
constexpr bool kCudaCores = std::is_same<T, float>::value;

// bf16: two blocks of 256 threads per SM (at most 128 registers a thread)
template <typename T, typename O>
__global__ void __launch_bounds__(kCudaCores<T> ? kPix : kTC,
                                  kCudaCores<T> ? 1 : 2)
    block0_kernel(const T* __restrict__ lum4, const T* __restrict__ chroma,
                  const T* __restrict__ w27, const float* __restrict__ bias,
                  const float* __restrict__ slope,
                  const float* __restrict__ inv_out, O* __restrict__ out,
                  int batch, int Hc, int Wc, int F) {
  if constexpr (kCudaCores<T>)
    block0_cuda_cores<O>(lum4, chroma, w27, bias, slope, inv_out, out, Hc,
                         Wc, F);
  else
    block0_tensor_cores<O>(lum4, chroma, w27, bias, slope, inv_out, out,
                           batch, Hc, Wc, F);
}

template <typename T, typename O>
int launch(const void* lum4, const void* chroma, const void* w27,
           const void* bias, const void* slope, const void* inv_out,
           void* out, int batch, int Hc, int Wc, int F, void* stream) {
  const int Ho = Hc - 1, Wo = Wc - 1;
  if (std::is_same<O, int8_t>::value && inv_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (F < 1) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  constexpr auto kernel = block0_kernel<T, O>;
  if constexpr (kCudaCores<T>) {
    // w27 [27, F padded to a multiple of 16], bias [F]
    const size_t smem =
        (size_t)28 * ((F + kGroup - 1) / kGroup * kGroup) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Wo + kPix - 1) / kPix, Ho, batch);
    kernel<<<grid, kPix, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(lum4), static_cast<const T*>(chroma),
        static_cast<const T*>(w27), static_cast<const float*>(bias),
        static_cast<const float*>(slope), static_cast<const float*>(inv_out),
        static_cast<O*>(out), batch, Hc, Wc, F);
  } else {
    // w27 [27, F padded to a multiple of 64], bias [F]: a 64-channel
    // slice per block (grid y)
    const int slices = (F + kF - 1) / kF;
    // element offsets of the planes fit in 32 bits
    if ((long long)batch * 8 * Hc * Wc > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const int smem = Smem<O>::total;
    int resident = 0;
    cudaError_t e =
        resident_blocks<block0_kernel<T, O>>(kTC, smem, &resident);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)batch * ((Ho + kTH - 1) / kTH) *
                            ((Wo + kTW - 1) / kTW);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // the card's resident blocks shared among the slices
    const int per_slice = resident / slices > 0 ? resident / slices : 1;
    const dim3 grid((unsigned)(tiles < per_slice ? tiles : per_slice),
                    slices);
    kernel<<<grid, kTC, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(lum4), static_cast<const T*>(chroma),
        static_cast<const T*>(w27), static_cast<const float*>(bias),
        static_cast<const float*>(slope), static_cast<const float*>(inv_out),
        static_cast<O*>(out), batch, Hc, Wc, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_block0_f32(const void* lum4, const void* chroma,
                                const void* w27, const void* bias,
                                const void* slope, void* out, int batch,
                                int Hc, int Wc, int F, void* stream) {
  return launch<float, float>(lum4, chroma, w27, bias, slope, nullptr, out,
                              batch, Hc, Wc, F, stream);
}

extern "C" int frcnn_block0_bf16(const void* lum4, const void* chroma,
                                 const void* w27, const void* bias,
                                 const void* slope, void* out, int batch,
                                 int Hc, int Wc, int F, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(lum4, chroma, w27, bias, slope,
                                              nullptr, out, batch, Hc, Wc, F,
                                              stream);
}

// int8 output (out_scale): inv_out [1] float32 = 1/s
extern "C" int frcnn_block0_f32_s8(const void* lum4, const void* chroma,
                                   const void* w27, const void* bias,
                                   const void* slope, const void* inv_out,
                                   void* out, int batch, int Hc, int Wc,
                                   int F, void* stream) {
  return launch<float, int8_t>(lum4, chroma, w27, bias, slope, inv_out, out,
                               batch, Hc, Wc, F, stream);
}

extern "C" int frcnn_block0_bf16_s8(const void* lum4, const void* chroma,
                                    const void* w27, const void* bias,
                                    const void* slope, const void* inv_out,
                                    void* out, int batch, int Hc, int Wc,
                                    int F, void* stream) {
  return launch<__nv_bfloat16, int8_t>(lum4, chroma, w27, bias, slope,
                                       inv_out, out, batch, Hc, Wc, F,
                                       stream);
}
