// Adaptive max pooling of D feature rects per image (forward only).
//
// Replaces: frcnn_tpu/ops/pallas_roi_pool.py::_forward (kernel body
// `_kernel`, pallas_roi_pool.py:36), reached through
// pallas_adaptive_max_pool_valid. Same function: Torch adaptive bins
// [floor(b*h/k), ceil((b+1)*h/k)) per axis (bins overlap when the rect is
// smaller than the grid), comparisons in float32, output in the feature
// map's dtype, rows with valid == 0 written as zeros. A bf16 max is taken
// as bf16 (__hmax2): widening to float32 is exact and monotone, so the
// float32 comparison picks the same value.
//
// Bound on the H100: bytes. Each pooled value is a handful of compares;
// the least traffic is the feature map once plus the output once (fm
// [8,29,50,384] bf16 = 8.9 MB, out [8,128,6,6,384] bf16 = 28.3 MB at the
// vgg_small serving shapes: 0.011 ms at 3.35 TB/s). The rects' windows are
// re-read from the 50 MB L2, which holds a batch's map.
//
// Design: the Pallas kernel's separable order, in registers. One block per
// (roi, image); a thread owns one row bin and one 16-byte vector of
// channels (8 bf16 or 4 float32; neighbouring threads on neighbouring
// vectors, so a row of a window is one coalesced read of C values). It
// walks the rect's columns once: each column's max over the bin's rows is
// folded into the column bins that hold that column (found by two integer
// divisions; 6 or 8 running maxima, in registers), so a cell is
// read once per row bin that holds it, not once per bin. At most 64
// registers a thread keep several blocks on an SM, the parallelism the
// L2 reads' latency needs. The bins' maxima then go out as 16-byte
// stores. Invalid slots read nothing and write zeros. Bin edges are clamped
// to the map, so a malformed rect never reads out of bounds. These vector
// instances take C a multiple of the vector, kw at most 8, and a 16-byte
// aligned map: every shape of the published configurations.
//
// Every other shape (any kh, kw and C, as the Pallas kernel's full-C block
// takes) goes to roi_pool_any_kernel, which the host picks by shape
// (`route`, ops/roi_pool_kernel.py::forward_plan) so that the vector
// instances' code is what the serving and training paths run: one thread
// per (row bin, chunk of up to 8 column bins, channel), the same walk over
// the chunk's columns with scalar loads (neighbouring threads on
// neighbouring channels) and at most 8 running maxima in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 16 bytes of channels as 4 words W: -inf, max, and W from and to bits
struct VecF32 {
  using W = float;
  static __device__ __forceinline__ W ninf() { return -INFINITY; }
  static __device__ __forceinline__ W max(W a, W b) { return fmaxf(a, b); }
  static __device__ __forceinline__ W of(uint32_t u) {
    return __uint_as_float(u);
  }
  static __device__ __forceinline__ uint32_t bits(W v) {
    return __float_as_uint(v);
  }
};
struct VecBF16 {
  using W = __nv_bfloat162;
  static __device__ __forceinline__ W ninf() {
    return __bfloat162bfloat162(__ushort_as_bfloat16(0xff80));
  }
  static __device__ __forceinline__ W max(W a, W b) { return __hmax2(a, b); }
  static __device__ __forceinline__ W of(uint32_t u) {
    return *reinterpret_cast<const W*>(&u);
  }
  static __device__ __forceinline__ uint32_t bits(W v) {
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr int kThreads = 512;   // at most, per block; two blocks an SM

// kBins: the column bins a thread holds, 6 (the path's grid) or 8; the
// smaller instance needs fewer registers
template <typename V, int kBins>
__global__ void __launch_bounds__(kThreads, 2)
    roi_pool_kernel(const uint4* __restrict__ fm,
                    const int32_t* __restrict__ rects,
                    const uint8_t* __restrict__ valid,
                    uint4* __restrict__ out, int n_rois, int H, int W,
                    int nvec, int kh, int kw) {
  using Wd = typename V::W;
  const size_t roi = blockIdx.x;   // image * n_rois + slot
  const int b = static_cast<int>(roi / n_rois);
  uint4* o = out + roi * kh * kw * nvec;
  if (!valid[roi]) {
    for (int k = threadIdx.x; k < kh * kw * nvec; k += blockDim.x)
      o[k] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int32_t* r = rects + roi * 4;
  const int x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
  const int w = x1 - x0, h = y1 - y0;
  const int xs = clampi(x0, 0, W), xe = clampi(x1, 0, W);
  const uint4* f = fm + (size_t)b * H * W * nvec;
  for (int item = threadIdx.x; item < kh * nvec; item += blockDim.x) {
    const int rb = item / nvec, v = item % nvec;
    const int ylo = clampi(y0 + (rb * h) / kh, 0, H);
    const int yhi = clampi(y0 + ((rb + 1) * h + kh - 1) / kh, 0, H);
    Wd m[kBins][4];
#pragma unroll
    for (int cb = 0; cb < kBins; ++cb)
#pragma unroll
      for (int k = 0; k < 4; ++k) m[cb][k] = V::ninf();
    for (int x = xs; x < xe; ++x) {
      Wd cm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cm[k] = V::ninf();
      const uint4* col = f + (size_t)x * nvec + v;
#pragma unroll 4
      for (int y = ylo; y < yhi; ++y) {
        const uint4 q = col[(size_t)y * W * nvec];
        cm[0] = V::max(cm[0], V::of(q.x));
        cm[1] = V::max(cm[1], V::of(q.y));
        cm[2] = V::max(cm[2], V::of(q.z));
        cm[3] = V::max(cm[3], V::of(q.w));
      }
      // the column bins holding x: floor(cb w / kw) <= u < ceil((cb + 1) w
      // / kw) for u = x - x0, i.e. cb from floor(u kw / w) to
      // ceil((u + 1) kw / w) - 1
      const int u = x - x0;
      const int cb0 = u * kw / w, cb1 = ((u + 1) * kw + w - 1) / w - 1;
#pragma unroll
      for (int cb = 0; cb < kBins; ++cb)
        if (cb0 <= cb && cb <= cb1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) m[cb][k] = V::max(m[cb][k], cm[k]);
        }
    }
    uint4* dst = o + (size_t)rb * kw * nvec + v;
#pragma unroll
    for (int cb = 0; cb < kBins; ++cb)
      if (cb < kw)
        dst[cb * nvec] = make_uint4(V::bits(m[cb][0]), V::bits(m[cb][1]),
                                    V::bits(m[cb][2]), V::bits(m[cb][3]));
  }
}

// one scalar channel: its type T and the max of two
struct OneF32 {
  using T = float;
  static __device__ __forceinline__ T ninf() { return -INFINITY; }
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T max(T a, T b) { return fmaxf(a, b); }
};
struct OneBF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T ninf() {
    return __ushort_as_bfloat16(0xff80);
  }
  static __device__ __forceinline__ T zero() {
    return __ushort_as_bfloat16(0);
  }
  static __device__ __forceinline__ T max(T a, T b) { return __hmax(a, b); }
};

constexpr int kChunkBins = 8;   // column bins a thread of the any kernel holds

// Any kh, kw and C: a thread per (row bin, chunk of column bins, channel).
template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
    roi_pool_any_kernel(const typename S::T* __restrict__ fm,
                        const int32_t* __restrict__ rects,
                        const uint8_t* __restrict__ valid,
                        typename S::T* __restrict__ out, int n_rois, int H,
                        int W, int C, int kh, int kw) {
  using T = typename S::T;
  const size_t roi = blockIdx.x;   // image * n_rois + slot
  const int b = static_cast<int>(roi / n_rois);
  T* o = out + roi * kh * kw * C;
  if (!valid[roi]) {
    for (int k = threadIdx.x; k < kh * kw * C; k += blockDim.x)
      o[k] = S::zero();
    return;
  }
  const int32_t* r = rects + roi * 4;
  const int x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
  const int w = x1 - x0, h = y1 - y0;
  const int chunks = (kw + kChunkBins - 1) / kChunkBins;
  const T* f = fm + (size_t)b * H * W * C;
  for (int item = threadIdx.x; item < kh * chunks * C; item += blockDim.x) {
    const int c = item % C, rest = item / C;
    const int ch = rest % chunks, rb = rest / chunks;
    const int cbase = ch * kChunkBins;
    const int nb = kw - cbase < kChunkBins ? kw - cbase : kChunkBins;
    const int ylo = clampi(y0 + (rb * h) / kh, 0, H);
    const int yhi = clampi(y0 + ((rb + 1) * h + kh - 1) / kh, 0, H);
    // the chunk's columns: from its first bin's first to its last bin's
    // last (the bins are monotone)
    const int xs = clampi(x0 + (cbase * w) / kw, 0, W);
    const int xe = clampi(x0 + ((cbase + nb) * w + kw - 1) / kw, 0, W);
    T m[kChunkBins];
#pragma unroll
    for (int k = 0; k < kChunkBins; ++k) m[k] = S::ninf();
    for (int x = xs; x < xe; ++x) {
      T cm = S::ninf();
      const T* col = f + (size_t)x * C + c;
#pragma unroll 4
      for (int y = ylo; y < yhi; ++y)
        cm = S::max(cm, col[(size_t)y * W * C]);
      // the column bins holding x, as in roi_pool_kernel
      const int u = x - x0;
      const int cb0 = u * kw / w, cb1 = ((u + 1) * kw + w - 1) / w - 1;
#pragma unroll
      for (int k = 0; k < kChunkBins; ++k)
        if (k < nb && cb0 <= cbase + k && cbase + k <= cb1)
          m[k] = S::max(m[k], cm);
    }
    T* dst = o + ((size_t)rb * kw + cbase) * C + c;
#pragma unroll
    for (int k = 0; k < kChunkBins; ++k)
      if (k < nb) dst[(size_t)k * C] = m[k];
  }
}

// route 0: the vector instances (C a multiple of the 16-byte vector, kw at
// most 8, a 16-byte aligned map); route 1: roi_pool_any_kernel
template <typename V, typename S>
int launch(const void* fm, const void* rects, const void* valid, void* out,
           int batch, int n_rois, int H, int W, int C, int kh, int kw,
           int route, int elem_bytes, void* stream) {
  if (batch <= 0 || n_rois <= 0) return (int)cudaSuccess;
  if (C < 1 || kh < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const int items = kh * ((kw + kChunkBins - 1) / kChunkBins) * C;
    int threads = ((items + 31) / 32) * 32;
    if (threads > kThreads) threads = kThreads;
    roi_pool_any_kernel<S><<<batch * n_rois, threads, 0, s>>>(
        static_cast<const typename S::T*>(fm),
        static_cast<const int32_t*>(rects),
        static_cast<const uint8_t*>(valid),
        static_cast<typename S::T*>(out), n_rois, H, W, C, kh, kw);
    return (int)cudaGetLastError();
  }
  const int per_vec = 16 / elem_bytes;
  if (route != 0 || C % per_vec != 0 || kw > 8)
    return (int)cudaErrorInvalidValue;
  const int nvec = C / per_vec;
  int threads = ((kh * nvec + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  auto* kernel = kw <= 6 ? roi_pool_kernel<V, 6> : roi_pool_kernel<V, 8>;
  kernel<<<batch * n_rois, threads, 0, s>>>(
      static_cast<const uint4*>(fm), static_cast<const int32_t*>(rects),
      static_cast<const uint8_t*>(valid), static_cast<uint4*>(out), n_rois,
      H, W, nvec, kh, kw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_roi_pool_f32(const void* fm, const void* rects,
                                  const void* valid, void* out, int batch,
                                  int n_rois, int H, int W, int C, int kh,
                                  int kw, int route, void* stream) {
  return launch<VecF32, OneF32>(fm, rects, valid, out, batch, n_rois, H, W,
                                C, kh, kw, route, 4, stream);
}

extern "C" int frcnn_roi_pool_bf16(const void* fm, const void* rects,
                                   const void* valid, void* out, int batch,
                                   int n_rois, int H, int W, int C, int kh,
                                   int kw, int route, void* stream) {
  return launch<VecBF16, OneBF16>(fm, rects, valid, out, batch, n_rois, H,
                                  W, C, kh, kw, route, 2, stream);
}
