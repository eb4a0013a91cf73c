// Adaptive max pooling of D feature rects per image (forward only).
//
// Replaces: frcnn_tpu/ops/pallas_roi_pool.py::_forward (kernel body
// `_kernel`, pallas_roi_pool.py:36), reached through
// pallas_adaptive_max_pool_valid. Same function: Torch adaptive bins
// [floor(b*h/k), ceil((b+1)*h/k)) per axis (bins overlap when the rect is
// smaller than the grid), comparisons in float32, output in the feature
// map's dtype, rows with valid == 0 written as zeros.
//
// Bound on the H100: bytes. Each pooled value is one compare, so the
// operation count is tiny; the work is reading the rect windows. The
// least traffic is the feature map once plus the output once
// (fm [8,29,50,384] bf16 = 8.9 MB, out [8,128,6,6,384] bf16 = 28 MB at
// the serving shapes); overlapping bins and overlapping rects re-read the
// same rows, which the 50 MB L2 absorbs (one image's map is 1.1 MB).
//
// Design: one block per (roi, image); threads run over channels, so each
// row of a window is one coalesced read of C contiguous values. Each
// thread walks the 6x6 bins with integer bin edges and keeps its max in a
// register, then writes [kh, kw] outputs for its channels. Bin edges are
// clamped to the map so a malformed rect can never read out of bounds.
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
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__global__ void roi_pool_kernel(const T* __restrict__ fm,
                                const int32_t* __restrict__ rects,
                                const uint8_t* __restrict__ valid,
                                T* __restrict__ out, int n_rois, int H, int W,
                                int C, int kh, int kw) {
  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * n_rois + d;
  T* o = out + roi * kh * kw * C;
  if (!valid[roi]) {
    for (int i = threadIdx.x; i < kh * kw * C; i += blockDim.x)
      o[i] = from_f32<T>(0.0f);
    return;
  }
  const int32_t* r = rects + roi * 4;
  const int x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
  const int w = x1 - x0, h = y1 - y0;
  const T* f = fm + (size_t)b * H * W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int rb = 0; rb < kh; ++rb) {
      const int ylo = clampi(y0 + (rb * h) / kh, 0, H);
      const int yhi = clampi(y0 + ((rb + 1) * h + kh - 1) / kh, 0, H);
      for (int cb = 0; cb < kw; ++cb) {
        const int xlo = clampi(x0 + (cb * w) / kw, 0, W);
        const int xhi = clampi(x0 + ((cb + 1) * w + kw - 1) / kw, 0, W);
        float m = -INFINITY;
        for (int y = ylo; y < yhi; ++y) {
          const T* row = f + ((size_t)y * W) * C + c;
          for (int x = xlo; x < xhi; ++x) m = fmaxf(m, to_f32(row[(size_t)x * C]));
        }
        o[(rb * kw + cb) * C + c] = from_f32<T>(m);
      }
    }
  }
}

template <typename T>
int launch(const void* fm, const void* rects, const void* valid, void* out,
           int batch, int n_rois, int H, int W, int C, int kh, int kw,
           void* stream) {
  if (batch <= 0 || n_rois <= 0) return (int)cudaSuccess;
  const int threads = C >= 384 ? 384 : ((C + 31) / 32) * 32;
  dim3 grid(n_rois, batch);
  roi_pool_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), n_rois, H, W,
      C, kh, kw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_roi_pool_f32(const void* fm, const void* rects,
                                  const void* valid, void* out, int batch,
                                  int n_rois, int H, int W, int C, int kh,
                                  int kw, void* stream) {
  return launch<float>(fm, rects, valid, out, batch, n_rois, H, W, C, kh, kw,
                       stream);
}

extern "C" int frcnn_roi_pool_bf16(const void* fm, const void* rects,
                                   const void* valid, void* out, int batch,
                                   int n_rois, int H, int W, int C, int kh,
                                   int kw, void* stream) {
  return launch<__nv_bfloat16>(fm, rects, valid, out, batch, n_rois, H, W, C,
                               kh, kw, stream);
}
