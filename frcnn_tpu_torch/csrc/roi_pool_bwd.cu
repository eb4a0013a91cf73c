// Gradient of the adaptive max ROI pool with respect to the feature map.
//
// Replaces: frcnn_tpu/ops/pallas_roi_pool.py::_backward (kernel body
// `_bwd_kernel`, pallas_roi_pool.py:194), the custom VJP of
// pallas_adaptive_max_pool_valid. Same function: the VJP of the columns-then-
// rows formulation (frcnn_tpu/ops/roi_pool.py::adaptive_max_pool). Per valid
// roi and column bin cb, colmax[y] is the max over the bin's columns of row
// y; the row stage splits g[rb, cb] evenly among the rows of row bin rb
// whose colmax ties for the bin's max, summing into dcol[y, cb] over the
// (overlapping) row bins in rb order; the column stage splits dcol[y, cb]
// evenly among the bin's columns x with fm[y, x] == colmax[y] and adds it to
// dfm[y, x]. Bin edges [floor(b*h/k), ceil((b+1)*h/k)), comparisons and
// sums in float32, one cast to the map's dtype at the end; invalid rois
// are skipped (the caller's losses give them a zero cotangent).
//
// Bound on the H100: bytes. A few compares and one division per touched
// cell: the least traffic is fm read once, the valid rois' g read once and
// dfm written once (fm [8,29,50,384] bf16 8.9 MB, g of 96 valid of 224 rois
// per image 10.6 MB, dfm 8.9 MB at the train step).
//
// Design: deterministic, no atomics. One thread owns one (image, row y,
// channel) and walks the rois in order, recomputing from fm (L1/L2
// resident: one image's map is 1.1 MB) the column maxima of the row bins
// that contain y. It accumulates its row of dfm in shared memory in the
// order of the Pallas kernel (rois, then column bins; dcol over row bins),
// so the float32 result is that kernel's to the bit, and writes the row
// once. Threads of a block run over channels, so every fm, g and dfm access
// of a warp is contiguous.
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

// max over columns [xlo, xhi) of row `row` (channel-strided by C)
template <typename T>
__device__ __forceinline__ float row_max(const T* row, int xlo, int xhi,
                                         int C) {
  float m = -INFINITY;
  for (int x = xlo; x < xhi; ++x) m = fmaxf(m, to_f32(row[(size_t)x * C]));
  return m;
}

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ fm,
                                    const int32_t* __restrict__ rects,
                                    const uint8_t* __restrict__ valid,
                                    const T* __restrict__ g,
                                    T* __restrict__ dfm, int n_rois, int H,
                                    int W, int C, int kh, int kw) {
  extern __shared__ float acc[];  // [W][blockDim.x]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int x = 0; x < W; ++x) acc[x * nt + tid] = 0.0f;
  if (c >= C) return;
  const T* f = fm + (size_t)b * H * W * C + c;
  const T* frow = f + (size_t)y * W * C;
  for (int d = 0; d < n_rois; ++d) {
    const size_t roi = (size_t)b * n_rois + d;
    if (!valid[roi]) continue;
    const int32_t* r = rects + roi * 4;
    const int x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
    const int w = x1 - x0, h = y1 - y0;
    if (y < y0 || y >= y1) continue;  // no row bin holds y
    const T* gr = g + roi * kh * kw * C + c;
    for (int cb = 0; cb < kw; ++cb) {
      const int xlo = clampi(x0 + (cb * w) / kw, 0, W);
      const int xhi = clampi(x0 + ((cb + 1) * w + kw - 1) / kw, 0, W);
      const float cm = row_max(frow, xlo, xhi, C);
      // row stage: dcol[y, cb] over the row bins that hold y, in rb order
      float dcol = 0.0f;
      for (int rb = 0; rb < kh; ++rb) {
        const int ylo = clampi(y0 + (rb * h) / kh, 0, H);
        const int yhi = clampi(y0 + ((rb + 1) * h + kh - 1) / kh, 0, H);
        if (y < ylo || y >= yhi) continue;
        float m = -INFINITY;
        int cnt = 0;
        for (int yy = ylo; yy < yhi; ++yy) {
          const float v = row_max(f + (size_t)yy * W * C, xlo, xhi, C);
          if (v > m) {
            m = v;
            cnt = 1;
          } else if (v == m) {
            ++cnt;
          }
        }
        if (cm == m)
          dcol += to_f32(gr[(size_t)(rb * kw + cb) * C]) / (float)cnt;
      }
      if (dcol == 0.0f) continue;  // adds exact zeros only
      // column stage: split dcol among the tied columns of the bin
      int cnt = 0;
      for (int x = xlo; x < xhi; ++x) cnt += to_f32(frow[(size_t)x * C]) == cm;
      const float share = dcol / (float)cnt;
      for (int x = xlo; x < xhi; ++x)
        if (to_f32(frow[(size_t)x * C]) == cm) acc[x * nt + tid] += share;
    }
  }
  T* out = dfm + ((size_t)b * H + y) * W * C + c;
  for (int x = 0; x < W; ++x) out[(size_t)x * C] = from_f32<T>(acc[x * nt + tid]);
}

template <typename T>
int launch(const void* fm, const void* rects, const void* valid,
           const void* g, void* dfm, int batch, int n_rois, int H, int W,
           int C, int kh, int kw, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaSuccess;
  // a block of channels; its dfm row accumulators take W*threads floats
  int threads = C >= 128 ? 128 : ((C + 31) / 32) * 32;
  while (threads > 32 && (size_t)W * threads * sizeof(float) > 48 * 1024)
    threads /= 2;
  const size_t smem = (size_t)W * threads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roi_pool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((C + threads - 1) / threads, H, batch);
  roi_pool_bwd_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(g),
      static_cast<T*>(dfm), n_rois, H, W, C, kh, kw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_roi_pool_bwd_f32(const void* fm, const void* rects,
                                      const void* valid, const void* g,
                                      void* dfm, int batch, int n_rois, int H,
                                      int W, int C, int kh, int kw,
                                      void* stream) {
  return launch<float>(fm, rects, valid, g, dfm, batch, n_rois, H, W, C, kh,
                       kw, stream);
}

extern "C" int frcnn_roi_pool_bwd_bf16(const void* fm, const void* rects,
                                       const void* valid, const void* g,
                                       void* dfm, int batch, int n_rois,
                                       int H, int W, int C, int kh, int kw,
                                       void* stream) {
  return launch<__nv_bfloat16>(fm, rects, valid, g, dfm, batch, n_rois, H, W,
                               C, kh, kw, stream);
}
