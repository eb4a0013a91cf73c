// Backward of the 2x2/2 ceil-mode max pool with first-max routing.
//
// Replaces: frcnn_tpu/ops/pallas_pool_bwd.py::_pool_bwd_pallas (kernel body
// `_bwd_kernel`, pallas_pool_bwd.py:54), reached through
// ceil_max_pool_2x2_firstmax. Same function: each pooled cotangent g goes to
// the FIRST maximum of its 2x2 window in row-major order ((h0,w0), (h0,w1),
// (h1,w0), (h1,w1)), as SelectAndScatter and torch's max_pool2d backward
// route it; the other cells get zero. Cells past H or W (ceil mode) take
// part as -inf and are not written. Comparisons in float32 (bf16 widening
// is exact), so the output is pure routing, bitwise equal to the library
// backward. Unlike the TPU kernel (even W only), any H and W.
//
// Bound on the H100: bytes. No arithmetic beyond four compares per window:
// x is read once, g once, dx written once (at the train step's first pool,
// x [8,450,800,64] bf16: 368 MB + 92 MB + 368 MB).
//
// Design: tensors are NHWC, channels contiguous. One thread per (pooled
// cell, group of VEC channels): VEC = 16 bytes of channels when C allows,
// so every read and write of a window cell is one 16-byte access and a
// warp touches contiguous memory. Windows do not overlap, so no atomics and
// no shared memory; a grid-stride loop covers any size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void pool_bwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int B, int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int Hc = (H + 1) / 2, Wc = (W + 1) / 2, Cv = C / VEC;
  const size_t n = (size_t)B * Hc * Wc * Cv;
  const size_t row = (size_t)W * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int cv = (int)(i % Cv);
    size_t t = i / Cv;
    const int wc = (int)(t % Wc);
    t /= Wc;
    const int hc = (int)(t % Hc);
    const int b = (int)(t / Hc);
    const int h0 = 2 * hc, w0 = 2 * wc;
    const bool h1 = h0 + 1 < H, w1 = w0 + 1 < W;
    const size_t base = (((size_t)b * H + h0) * W + w0) * C + (size_t)cv * VEC;
    const P gv = *reinterpret_cast<const P*>(g + i * VEC);
    P a[4];
    a[0] = *reinterpret_cast<const P*>(x + base);
    if (w1) a[1] = *reinterpret_cast<const P*>(x + base + C);
    if (h1) a[2] = *reinterpret_cast<const P*>(x + base + row);
    if (h1 && w1) a[3] = *reinterpret_cast<const P*>(x + base + row + C);
    P out[4];
    const T zero = zero_of<T>();
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v0 = to_f32(a[0].v[k]);
      const float v1 = w1 ? to_f32(a[1].v[k]) : -INFINITY;
      const float v2 = h1 ? to_f32(a[2].v[k]) : -INFINITY;
      const float v3 = (h1 && w1) ? to_f32(a[3].v[k]) : -INFINITY;
      const float m = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
      const int first = v0 == m ? 0 : (v1 == m ? 1 : (v2 == m ? 2 : 3));
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j].v[k] = first == j ? gv.v[k] : zero;
    }
    *reinterpret_cast<P*>(dx + base) = out[0];
    if (w1) *reinterpret_cast<P*>(dx + base + C) = out[1];
    if (h1) *reinterpret_cast<P*>(dx + base + row) = out[2];
    if (h1 && w1) *reinterpret_cast<P*>(dx + base + row + C) = out[3];
  }
}

template <typename T, int VEC>
int launch_vec(const void* x, const void* g, void* dx, int B, int H, int W,
               int C, void* stream) {
  const size_t n =
      (size_t)B * ((H + 1) / 2) * ((W + 1) / 2) * (C / VEC);
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  pool_bwd_kernel<T, VEC><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      B, H, W, C);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* g, void* dx, int B, int H, int W, int C,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaSuccess;
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC == 0 && aligned16(x) && aligned16(g) && aligned16(dx))
    return launch_vec<T, VEC>(x, g, dx, B, H, W, C, stream);
  return launch_vec<T, 1>(x, g, dx, B, H, W, C, stream);
}

}  // namespace

extern "C" int frcnn_pool_bwd_f32(const void* x, const void* g, void* dx,
                                  int B, int H, int W, int C, void* stream) {
  return launch<float>(x, g, dx, B, H, W, C, stream);
}

extern "C" int frcnn_pool_bwd_bf16(const void* x, const void* g, void* dx,
                                   int B, int H, int W, int C, void* stream) {
  return launch<__nv_bfloat16>(x, g, dx, B, H, W, C, stream);
}
