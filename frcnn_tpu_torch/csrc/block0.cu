// Fused first conv block of vgg_small from the space-to-depth planes:
//   out[b,i,j,o] = max over the 2x2 pool window of
//                  prelu(bias[o] + conv3x3(x, w)[b, 2i+ry, 2j+rx, o])
//
// Replaces: frcnn_tpu/ops/pallas_block0.py::fused_block0 (kernel body
// `_kernel`, pallas_block0.py:58), float output mode. Inputs are the
// normalized planes the serving path feeds (ops/normalization.py):
//   lum4   [B, 4, Hc, Wc]  lum4[b, 2qy+qx, I, J]          = P[2I+qy, 2J+qx, 0]
//   chroma [B, Hc, 8, Wc]  chroma[b, I, 2(2qy+qx)+c-1, J] = P[2I+qy, 2J+qx, c]
// with P = pad(image, 1), Hc = H/2+1, Wc = W/2+1. The weights are the
// HWIO conv kernel flattened to [27, F] (tap t = (ky*3+kx)*3+c), in the
// input dtype; bias [F] and the single PReLU slope [1] are float32.
// Output: NHWC [B, Hc-1, Wc-1, F] in the input dtype (bf16 or f32), which
// is the channels_last layout block 1's convolution reads directly.
//
// int8 output mode (the Pallas kernel's `out_scale`, pallas_block0.py:99-102,
// the int8 serving chain): the pooled float32 value m is quantized in
// registers as clip(rint(m * inv_out), -127, 127), with inv_out the float32
// reciprocal 1/s of the next conv's input scale: the product is rounded
// once (__fmul_rn, nothing to contract), rintf rounds half to even as
// jnp.round does, and the clip comes before the conversion. The output is
// then NHWC int8, a quarter of the bf16 bytes.
//
// Bound on the H100: operations. Per output pixel 4 phases x 27 taps x F
// multiply-adds (F=64: 13.8 kFLOP) against 48 input values read and F
// values written, about 1.24 GFLOP per 450x800 image. On CUDA cores
// (67 TFLOP/s f32) that is ~18 us per image; the planes (2.9 MB per image
// in bf16) and the output (11.5 MB) would take ~4.3 us at 3.35 TB/s.
// Tensor cores (989 TFLOP/s bf16) would move the bound to the bytes; that
// is later work.
//
// Design: one thread per output pixel; a block covers 128 pixels of one
// output row. Each thread loads its 4x4x3 input patch once into registers
// (48 loads, neighbouring threads on neighbouring addresses), then for
// each group of 16 output channels runs the four phases' 27-tap dot
// products in float32 against weights held in shared memory (every
// thread of a warp reads the same weights: a broadcast, 4 values per
// load), applies bias and PReLU, takes the max of the four phases and
// writes 16 contiguous channels. The pre-pool [B, H, W, F] tensor never
// exists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPix = 128;  // output pixels per block (one row segment)
constexpr int kGroup = 16;  // output channels per inner pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_group(float* dst, const float* v,
                                            float /*inv*/) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < kGroup / 4; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* dst,
                                            const float* v, float /*inv*/) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < kGroup / 8; ++k) {
    uint32_t packed[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 two =
          __floats2bfloat162_rn(v[8 * k + 2 * q], v[8 * k + 2 * q + 1]);
      packed[q] = *reinterpret_cast<uint32_t*>(&two);
    }
    d[k] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// clip(round(m * inv), -127, 127), round half to even
__device__ __forceinline__ uint32_t quant8(float m, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(m, inv)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
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

// T: the planes' and weights' type; O: the output's (T, or int8 with
// inv_out, which is unused otherwise)
template <typename T, typename O>
__global__ void __launch_bounds__(kPix)
block0_kernel(const T* __restrict__ lum4, const T* __restrict__ chroma,
              const T* __restrict__ w27, const float* __restrict__ bias,
              const float* __restrict__ slope,
              const float* __restrict__ inv_out, O* __restrict__ out, int Hc,
              int Wc, int F) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [27][F]
  float* sb = ws + 27 * F;                      // [F]
  for (int k = threadIdx.x; k < 27 * F; k += blockDim.x) ws[k] = to_f32(w27[k]);
  for (int k = threadIdx.x; k < F; k += blockDim.x) sb[k] = bias[k];
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
              to_f32(lum4[(((size_t)b * 4 + ph) * Hc + I) * Wc + J]);
#pragma unroll
          for (int c = 1; c < 3; ++c)
            patch[2 * cy + qy][2 * cx + qx][c] = to_f32(
                chroma[(((size_t)b * Hc + I) * 8 + 2 * ph + c - 1) * Wc + J]);
        }

  O* dst = out + (((size_t)b * Ho + i) * Wo + j) * F;
#pragma unroll 1
  for (int og = 0; og < F; og += kGroup) {
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
                  ws + ((ky * 3 + kx) * 3 + c) * F + og);
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
        for (int k = 0; k < kGroup; ++k) {
          const float y = acc[k] + sb[og + k];
          const float act = y >= 0.0f ? y : a * y;
          m[k] = fmaxf(m[k], act);
        }
      }
    store_group(dst + og, m, inv);
  }
}

template <typename T, typename O>
int launch(const void* lum4, const void* chroma, const void* w27,
           const void* bias, const void* slope, const void* inv_out,
           void* out, int batch, int Hc, int Wc, int F, void* stream) {
  const int Ho = Hc - 1, Wo = Wc - 1;
  if (batch <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  if (F % kGroup != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)28 * F * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block0_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Wo + kPix - 1) / kPix, Ho, batch);
  block0_kernel<T, O><<<grid, kPix, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(lum4), static_cast<const T*>(chroma),
      static_cast<const T*>(w27), static_cast<const float*>(bias),
      static_cast<const float*>(slope), static_cast<const float*>(inv_out),
      static_cast<O*>(out), Hc, Wc, F);
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
