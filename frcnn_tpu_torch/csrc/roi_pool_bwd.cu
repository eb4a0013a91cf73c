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
// dfm written once (fm [8,29,50,384] bf16 8.9 MB, g of the valid rois, dfm
// 8.9 MB: ~0.012 ms at the smoke's check shapes, ~0.019 ms at a train
// step's). Traffic is not what sets the time: a cell's sum runs over every
// roi that holds it, in slot order, so each thread walks a dependent chain
// of (roi, column bin) steps - loads, compares, an exact division - and
// the chains are long where rois pile up.
//
// Design: two passes on the caller's stream, deterministic, no atomics.
//  1. ties (grid: row bin x roi slot x image; invalid slots exit). A thread
//     owns one column bin and 16 bytes of channels of a valid roi's row
//     bin: it takes each of the bin's rows' column max once and writes the
//     mask of rows whose column max ties for the bin's max (bit r = row
//     ylo + r; 32 bits per channel, so bins of up to 32 rows). The row
//     stage's count is then the mask's popcount and its test
//     a bit, so no thread recomputes another row's maxima (the PR 5 kernel
//     recomputed every row of every row bin holding its row).
//  2. scatter (grid: strips of x x rows y x images). A block stages in
//     shared memory, in slot order, the valid rois that hold its row y and
//     their bin edges (an order-preserving ballot compaction). A thread owns
//     S = 2 adjacent cells (y, x) and V = 4 channels, and walks that list:
//     for each roi and column bin that holds one of its cells it takes row
//     y's max and tie count over the bin's columns, builds dcol from the
//     masks and g of the row bins that hold y (rb in order), and adds
//     dcol / count to each of its cells equal to that max. It writes each
//     cell once, zeros included: dfm needs no memset. A division by a count
//     is Markstein's correction of the product by the rounded reciprocal (a
//     table per block), which rounds as the division does.
// The sums run in the order of the Pallas kernel (rois, then column bins;
// dcol over row bins), so the float32 result is that kernel's to the bit.
// These instances take C a multiple of 16, kh and kw at most 8, W under
// 32768 and row bins of at most 32 rows: every shape of the published
// configurations.
//
// Every other shape goes to the any-shape pair below, which the host picks
// by shape (`route`, ops/roi_pool_kernel.py::backward_plan), so that the
// instances above are what training runs. The same two passes and sums in
// the same order, with what limited the shapes taken out:
//  * row-tie masks of `words` = ceil(rows / 32) 32-bit words per (roi, row
//    bin, column bin, channel), word-major over the channels: bin rows of
//    any count (pass 1 takes the bin's max first, then writes each word);
//  * column-bin edges as two int32s and row-bin offsets as one int32 each,
//    staged in shared memory per roi, sized by kh and kw, in rounds of at
//    most `round` rois (as many as the shared memory takes): any W, kh, kw
//    and any number of rois;
//  * one thread per (cell, channel) with scalar loads: any C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 8;       // kh, kw at most this

// channels per thread: pass 1 moves 16 bytes per access; a pass-2 thread
// owns V channels of S cells along x
template <typename T>
struct Vec {
  static constexpr int V1 = 16 / (int)sizeof(T);
  static constexpr int V = 4, S = 2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// bin b of k over [start, start + ext), clamped to [0, size)
__device__ __forceinline__ int bin_lo(int start, int ext, int b, int k,
                                      int size) {
  return clampi(start + (b * ext) / k, 0, size);
}
__device__ __forceinline__ int bin_hi(int start, int ext, int b, int k,
                                      int size) {
  return clampi(start + ((b + 1) * ext + k - 1) / k, 0, size);
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x;
  f[1] = q.y;
  f[2] = q.z;
  f[3] = q.w;
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[N]) {
  uint32_t w[N / 2];
  if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x;
    w[1] = q.y;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[4]) {
  uint32_t w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// V = 4 or 8 masks as one or two 16-byte accesses
template <int V>
__device__ __forceinline__ void store_masks(uint32_t* dst,
                                            const uint32_t (&m)[V]) {
  static_assert(V % 4 == 0, "masks move 16 bytes at a time");
#pragma unroll
  for (int k = 0; k < V / 4; ++k)
    reinterpret_cast<uint4*>(dst)[k] =
        make_uint4(m[4 * k], m[4 * k + 1], m[4 * k + 2], m[4 * k + 3]);
}

__device__ __forceinline__ void load_masks(const uint32_t* src,
                                           uint32_t (&m)[4]) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  m[0] = q.x;
  m[1] = q.y;
  m[2] = q.z;
  m[3] = q.w;
}

// x / n rounded to nearest even, as a division rounds it, for a count
// n >= 1 and x far from under- and overflow: Markstein's correction of
// x * y by the exact remainder, with y = 1/n rounded (from the table rcp
// for n <= 32), rounds the same as x / n
__device__ __forceinline__ float div_count(float x, int n, const float* rcp) {
  const float fn = static_cast<float>(n);
  const float y = n <= 32 ? rcp[n] : __frcp_rn(fn);
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-fn, q, x), y, q);
}

// Pass 1: the tie masks of one row bin (blockIdx.x) of one roi slot; a
// thread per (column bin, 16 bytes of channels).
template <typename T>
__global__ void roi_pool_bwd_ties_kernel(const T* __restrict__ fm,
                                         const int32_t* __restrict__ rects,
                                         const uint8_t* __restrict__ valid,
                                         uint32_t* __restrict__ ties,
                                         int n_rois,
                                         int H, int W, int C, int kh,
                                         int kw) {
  constexpr int V = Vec<T>::V1;
  const int rb = blockIdx.x, d = blockIdx.y, b = blockIdx.z;
  const size_t roi = (size_t)b * n_rois + d;
  if (!valid[roi]) return;
  const int32_t* r = rects + roi * 4;
  const int x0 = r[0], y0 = r[1], w = r[2] - r[0], h = r[3] - r[1];
  const int ylo = bin_lo(y0, h, rb, kh, H), yhi = bin_hi(y0, h, rb, kh, H);
  const int ng = C / V;
  const T* f = fm + (size_t)b * H * W * C;
  for (int item = threadIdx.x; item < kw * ng; item += blockDim.x) {
    const int cb = item / ng, c = (item % ng) * V;
    const int xlo = bin_lo(x0, w, cb, kw, W), xhi = bin_hi(x0, w, cb, kw, W);
    float m[V];
    uint32_t mask[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = -INFINITY;
      mask[k] = 0;
    }
    for (int yy = ylo; yy < yhi; ++yy) {
      const T* row = f + (size_t)yy * W * C + c;
      float cm[V];
#pragma unroll
      for (int k = 0; k < V; ++k) cm[k] = -INFINITY;
      for (int x = xlo; x < xhi; ++x) {
        float v[V];
        load_vec(row + (size_t)x * C, v);
#pragma unroll
        for (int k = 0; k < V; ++k) cm[k] = fmaxf(cm[k], v[k]);
      }
      const uint32_t bit = 1u << (yy - ylo);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (cm[k] > m[k]) {
          m[k] = cm[k];
          mask[k] = bit;
        } else if (cm[k] == m[k]) {
          mask[k] |= bit;
        }
      }
    }
    store_masks<V>(ties + ((roi * kh + rb) * kw + cb) * C + c, mask);
  }
}

// What a block of pass 2 keeps of a valid roi holding its row y.
struct RoiRow {
  int x01;                  // x0 | x1 << 16
  int slot;                 // d
  unsigned long long rb;    // byte rb: 1 + y - ylo(rb) if bin rb holds y
  int cols[kMaxBins];       // xlo | xhi << 16 of column bin cb
};

// Pass 2: every cell of dfm, from the valid rois that hold its row.
template <typename T>
__global__ void __launch_bounds__(256, 1)
    roi_pool_bwd_kernel(const T* __restrict__ fm,
                        const int32_t* __restrict__ rects,
                        const uint8_t* __restrict__ valid,
                        const T* __restrict__ g,
                        const uint32_t* __restrict__ ties,
                        T* __restrict__ dfm, int n_rois, int H, int W, int C,
                        int kh, int kw, int strips_per_block) {
  constexpr int V = Vec<T>::V, S = Vec<T>::S;
  extern __shared__ RoiRow s_roi[];  // [n_rois]
  __shared__ int s_warp[32];
  __shared__ float s_rcp[33];   // 1/n rounded, n = 1..32
  const int y = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k <= 32; k += nt)
    s_rcp[k] = k ? __frcp_rn(static_cast<float>(k)) : 0.0f;

  // the valid rois holding row y, in slot order, with their bin edges
  int n = 0;
  for (int d0 = 0; d0 < n_rois; d0 += nt) {
    const int d = d0 + tid;
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    bool keep = false;
    if (d < n_rois && valid[(size_t)b * n_rois + d]) {
      const int32_t* p = rects + ((size_t)b * n_rois + d) * 4;
      x0 = p[0];
      y0 = p[1];
      x1 = p[2];
      y1 = p[3];
      keep = y >= y0 && y < y1;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int at = n, total = 0;
    for (int k = 0; k < nt / 32; ++k) {
      at += k < warp ? s_warp[k] : 0;
      total += s_warp[k];
    }
    if (keep) {
      RoiRow& e = s_roi[at + __popc(ball & ((1u << lane) - 1u))];
      e.x01 = x0 | (x1 << 16);
      e.slot = d;
      unsigned long long rbs = 0;
      for (int rb = 0; rb < kh; ++rb) {
        const int lo = bin_lo(y0, y1 - y0, rb, kh, H);
        if (y >= lo && y < bin_hi(y0, y1 - y0, rb, kh, H))
          rbs |= (unsigned long long)(1 + y - lo) << (8 * rb);
      }
      e.rb = rbs;
      for (int cb = 0; cb < kw; ++cb)
        e.cols[cb] = bin_lo(x0, x1 - x0, cb, kw, W) |
                     (bin_hi(x0, x1 - x0, cb, kw, W) << 16);
    }
    n += total;
    __syncthreads();
  }

  const int ng = C / V;
  for (int item = tid; item < strips_per_block * ng; item += nt) {
    const int xs = (blockIdx.x * strips_per_block + item / ng) * S;
    if (xs >= W) continue;
    const int c = (item % ng) * V;
    const T* frow = fm + ((size_t)b * H + y) * W * C + c;
    float fx[S][V], acc[S][V];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        fx[s][k] = 0.0f;
        acc[s][k] = 0.0f;
      }
      if (xs + s < W) load_vec(frow + (size_t)(xs + s) * C, fx[s]);
    }
    for (int i = 0; i < n; ++i) {
      const int x01 = s_roi[i].x01;
      if ((x01 >> 16) <= xs || (x01 & 0xffff) >= xs + S) continue;
      const unsigned long long rbs = s_roi[i].rb;
      const size_t roi = (size_t)b * n_rois + s_roi[i].slot;
      for (int cb = 0; cb < kw; ++cb) {
        const int edges = s_roi[i].cols[cb];
        const int xlo = edges & 0xffff, xhi = edges >> 16;
        if (xhi <= xs || xlo >= xs + S) continue;
        // row y's max over the bin's columns and its tie count
        float cm[V];
        int cnt[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          cm[k] = -INFINITY;
          cnt[k] = 0;
        }
        for (int x = xlo; x < xhi; ++x) {
          float v[V];
          load_vec(frow + (size_t)x * C, v);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (v[k] > cm[k]) {
              cm[k] = v[k];
              cnt[k] = 1;
            } else if (v[k] == cm[k]) {
              ++cnt[k];
            }
          }
        }
        bool hit[S][V], any = false;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool in = xs + s >= xlo && xs + s < xhi;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            hit[s][k] = in && fx[s][k] == cm[k];
            any |= hit[s][k];
          }
        }
        if (!any) continue;  // would add exact zeros only
        // row stage: dcol[y, cb] over the row bins that hold y, in rb order
        float dcol[V];
#pragma unroll
        for (int k = 0; k < V; ++k) dcol[k] = 0.0f;
        for (int rb = 0; rb < kh; ++rb) {
          const int sh = (int)((rbs >> (8 * rb)) & 0xff) - 1;
          if (sh < 0) continue;
          const size_t e = ((roi * kh + rb) * kw + cb) * C + c;
          uint32_t mk[V];
          float gv[V];
          load_masks(ties + e, mk);
          load_vec(g + e, gv);
#pragma unroll
          for (int k = 0; k < V; ++k)
            if ((mk[k] >> sh) & 1u) dcol[k] += div_count(gv[k], __popc(mk[k]), s_rcp);
        }
        // column stage: split dcol among the tied columns of the bin
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float share = div_count(dcol[k], cnt[k], s_rcp);
#pragma unroll
          for (int s = 0; s < S; ++s)
            if (hit[s][k]) acc[s][k] += share;
        }
      }
    }
    T* out = dfm + ((size_t)b * H + y) * W * C + c;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (xs + s < W) store_vec(out + (size_t)(xs + s) * C, acc[s]);
  }
}

// -- any shape ---------------------------------------------------------------

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// row y's max over columns [xlo, xhi) of channel c, and its tie count
template <typename T>
__device__ __forceinline__ float row_max(const T* frow, int xlo, int xhi,
                                         int C, int* count) {
  float m = -INFINITY;
  int n = 0;
  for (int x = xlo; x < xhi; ++x) {
    const float v = load1(frow + (size_t)x * C);
    if (v > m) {
      m = v;
      n = 1;
    } else if (v == m) {
      ++n;
    }
  }
  *count = n;
  return m;
}

// Pass 1, any shape: the tie masks of one row bin (blockIdx.x) of one roi
// slot; a thread per (column bin, channel). ties [.., kh, kw, words, C].
template <typename T>
__global__ void roi_pool_bwd_ties_any_kernel(
    const T* __restrict__ fm, const int32_t* __restrict__ rects,
    const uint8_t* __restrict__ valid, uint32_t* __restrict__ ties,
    int n_rois, int H, int W, int C, int kh, int kw, int words) {
  const int rb = blockIdx.x, d = blockIdx.y, b = blockIdx.z;
  const size_t roi = (size_t)b * n_rois + d;
  if (!valid[roi]) return;
  const int32_t* r = rects + roi * 4;
  const int x0 = r[0], y0 = r[1], w = r[2] - r[0], h = r[3] - r[1];
  const int ylo = bin_lo(y0, h, rb, kh, H);
  int yhi = bin_hi(y0, h, rb, kh, H);
  if (yhi - ylo > 32 * words) yhi = ylo + 32 * words;  // malformed rects
  const T* f = fm + (size_t)b * H * W * C;
  for (int item = threadIdx.x; item < kw * C; item += blockDim.x) {
    const int cb = item / C, c = item % C;
    const int xlo = bin_lo(x0, w, cb, kw, W), xhi = bin_hi(x0, w, cb, kw, W);
    const T* col = f + c;
    int n;
    float m = -INFINITY;
    for (int yy = ylo; yy < yhi; ++yy)
      m = fmaxf(m, row_max(col + (size_t)yy * W * C, xlo, xhi, C, &n));
    uint32_t* dst = ties + (((roi * kh + rb) * kw + cb) * words) * C + c;
    for (int wd = 0; wd < words; ++wd) {
      uint32_t mask = 0;
      for (int k = 0; k < 32; ++k) {
        const int yy = ylo + 32 * wd + k;
        if (yy < yhi &&
            row_max(col + (size_t)yy * W * C, xlo, xhi, C, &n) == m)
          mask |= 1u << k;
      }
      dst[(size_t)wd * C] = mask;
    }
  }
}

// What a block of the any-shape pass 2 keeps of a valid roi holding its
// row y, as int32s: x0, x1, the slot, then per row bin rb the offset
// y - ylo(rb) (-1 where rb does not hold y), then per column bin its xlo
// and xhi.
__host__ __device__ constexpr int roi_ints(int kh, int kw) {
  return 3 + kh + 2 * kw;
}

// Pass 2, any shape: a thread per (cell x, channel c) of row y; the valid
// rois holding row y, in slot order, staged `round` candidates at a time.
template <typename T>
__global__ void __launch_bounds__(256)
    roi_pool_bwd_any_kernel(const T* __restrict__ fm,
                            const int32_t* __restrict__ rects,
                            const uint8_t* __restrict__ valid,
                            const T* __restrict__ g,
                            const uint32_t* __restrict__ ties,
                            T* __restrict__ dfm, int n_rois, int H, int W,
                            int C, int kh, int kw, int words, int round) {
  extern __shared__ int s_any[];   // [round][roi_ints(kh, kw)]
  __shared__ int s_warp[32];
  __shared__ float s_rcp[33];
  const int y = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = roi_ints(kh, kw);
  for (int k = tid; k <= 32; k += nt)
    s_rcp[k] = k ? __frcp_rn(static_cast<float>(k)) : 0.0f;
  const size_t item = (size_t)blockIdx.x * nt + tid;
  const bool live = item < (size_t)W * C;
  const int x = live ? (int)(item / C) : 0, c = live ? (int)(item % C) : 0;
  const T* frow = fm + ((size_t)b * H + y) * W * C + c;
  const float fx = live ? load1(frow + (size_t)x * C) : 0.0f;
  float acc = 0.0f;
  for (int d0 = 0; d0 < n_rois; d0 += round) {
    // stage this round's valid rois holding row y, in slot order
    __syncthreads();   // the last round's entries are read
    const int d = d0 + tid;
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    bool keep = false;
    if (tid < round && d < n_rois && valid[(size_t)b * n_rois + d]) {
      const int32_t* p = rects + ((size_t)b * n_rois + d) * 4;
      x0 = p[0];
      y0 = p[1];
      x1 = p[2];
      y1 = p[3];
      keep = y >= y0 && y < y1;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int at = 0, n = 0;
    for (int k = 0; k < nt / 32; ++k) {
      at += k < warp ? s_warp[k] : 0;
      n += s_warp[k];
    }
    if (keep) {
      int* e = s_any + (at + __popc(ball & ((1u << lane) - 1u))) * R;
      e[0] = x0;
      e[1] = x1;
      e[2] = d;
      for (int rb = 0; rb < kh; ++rb) {
        const int lo = bin_lo(y0, y1 - y0, rb, kh, H);
        e[3 + rb] =
            y >= lo && y < bin_hi(y0, y1 - y0, rb, kh, H) ? y - lo : -1;
      }
      for (int cb = 0; cb < kw; ++cb) {
        e[3 + kh + 2 * cb] = bin_lo(x0, x1 - x0, cb, kw, W);
        e[4 + kh + 2 * cb] = bin_hi(x0, x1 - x0, cb, kw, W);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const int* e = s_any + i * R;
      if (x < e[0] || x >= e[1]) continue;
      const size_t roi = (size_t)b * n_rois + e[2];
      for (int cb = 0; cb < kw; ++cb) {
        const int xlo = e[3 + kh + 2 * cb], xhi = e[4 + kh + 2 * cb];
        if (x < xlo || x >= xhi) continue;
        int cnt;
        const float cm = row_max(frow, xlo, xhi, C, &cnt);
        if (fx != cm) continue;  // would add an exact zero only
        // row stage: dcol[y, cb] over the row bins that hold y, in rb order
        float dcol = 0.0f;
        for (int rb = 0; rb < kh; ++rb) {
          const int sh = e[3 + rb];
          if (sh < 0 || sh >= 32 * words) continue;
          const size_t bin = (roi * kh + rb) * kw + cb;
          const uint32_t* mk = ties + bin * words * C + c;
          if (!((mk[(size_t)(sh >> 5) * C] >> (sh & 31)) & 1u)) continue;
          int ties_n = 0;
          for (int wd = 0; wd < words; ++wd)
            ties_n += __popc(mk[(size_t)wd * C]);
          dcol += div_count(load1(g + bin * C + c), ties_n, s_rcp);
        }
        // column stage: x's share of dcol among the tied columns
        acc += div_count(dcol, cnt, s_rcp);
      }
    }
  }
  if (live) store1(dfm + ((size_t)b * H + y) * W * C + (size_t)x * C + c, acc);
}

// route 0: the instances above (ties [batch, n_rois, kh, kw, C] of 32-bit
// masks; kh, kw at most 8; C a multiple of 16, every pointer 16-byte
// aligned, W < 32768, bins of at most 32 rows). route 1: the any-shape
// pair (ties [batch, n_rois, kh, kw, words, C]).
template <typename T>
int launch_any(const void* fm, const void* rects, const void* valid,
               const void* g, void* ties, void* dfm, int batch, int n_rois,
               int H, int W, int C, int kh, int kw, int words,
               cudaStream_t s) {
  constexpr int kT = 256;
  const int max_rows = H < (H + kh - 1) / kh + 1 ? H : (H + kh - 1) / kh + 1;
  if (words < 1 || 32 * words < max_rows) return (int)cudaErrorInvalidValue;
  if (n_rois > 0) {
    dim3 grid1(kh, n_rois, batch);
    const int items = kw * C;
    roi_pool_bwd_ties_any_kernel<T>
        <<<grid1, items < kT ? (items + 31) / 32 * 32 : kT, 0, s>>>(
            static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
            static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(ties),
            n_rois, H, W, C, kh, kw, words);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // rois staged per round: a multiple of 32, at most a thread each, as
  // many as the opt-in shared memory takes
  const size_t per_roi = (size_t)roi_ints(kh, kw) * sizeof(int);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t limit = (size_t)optin - 1024;   // the static arrays
  int round = (int)(limit / per_roi) / 32 * 32;
  if (round > kT) round = kT;
  if (round < 32) return (int)cudaErrorInvalidValue;
  const int n_round = n_rois < round ? (n_rois + 31) / 32 * 32 : round;
  const size_t smem = (size_t)(n_round > 0 ? n_round : 32) * per_roi;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(roi_pool_bwd_any_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long cells = (long long)W * C;
  dim3 grid2((unsigned)((cells + kT - 1) / kT), H, batch);
  roi_pool_bwd_any_kernel<T><<<grid2, kT, smem, s>>>(
      static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(g),
      static_cast<const uint32_t*>(ties), static_cast<T*>(dfm), n_rois, H, W,
      C, kh, kw, words, n_round > 0 ? n_round : 32);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* fm, const void* rects, const void* valid,
           const void* g, void* ties, void* dfm, int batch, int n_rois,
           int H, int W, int C, int kh, int kw, int route, int words,
           void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaSuccess;
  if (kh <= 0 || kw <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return launch_any<T>(fm, rects, valid, g, ties, dfm, batch, n_rois, H,
                         W, C, kh, kw, words, s);
  const int max_rows = H < (H + kh - 1) / kh + 1 ? H : (H + kh - 1) / kh + 1;
  if (route != 0 || C % 16 != 0 || kh > kMaxBins || kw > kMaxBins ||
      W >= 32768 || max_rows > 32)
    return (int)cudaErrorInvalidValue;
  constexpr int V = Vec<T>::V, S = Vec<T>::S;
  const int ng = C / V;
  auto threads_for = [](int items) {
    const int t = ((items + 31) / 32) * 32;
    return t > 1024 ? 1024 : t;
  };
  if (n_rois > 0) {
    dim3 grid1(kh, n_rois, batch);
    roi_pool_bwd_ties_kernel<T>
        <<<grid1, threads_for(kw * (C / Vec<T>::V1)), 0, s>>>(
        static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
        static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(ties),
        n_rois, H, W, C, kh, kw);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int spb = ng >= 256 ? 1 : 256 / ng;   // strips per block
  const int strips = (W + S - 1) / S;
  const size_t smem = (size_t)n_rois * sizeof(RoiRow);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(roi_pool_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid2((strips + spb - 1) / spb, H, batch);
  const int threads2 = threads_for(spb * ng < 256 ? spb * ng : 256);
  roi_pool_bwd_kernel<T><<<grid2, threads2, smem, s>>>(
      static_cast<const T*>(fm), static_cast<const int32_t*>(rects),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(g),
      static_cast<const uint32_t*>(ties), static_cast<T*>(dfm), n_rois, H,
      W, C, kh, kw, spb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_roi_pool_bwd_f32(const void* fm, const void* rects,
                                      const void* valid, const void* g,
                                      void* ties, void* dfm, int batch,
                                      int n_rois, int H, int W, int C, int kh,
                                      int kw, int route, int words,
                                      void* stream) {
  return launch<float>(fm, rects, valid, g, ties, dfm, batch, n_rois, H, W,
                       C, kh, kw, route, words, stream);
}

extern "C" int frcnn_roi_pool_bwd_bf16(const void* fm, const void* rects,
                                       const void* valid, const void* g,
                                       void* ties, void* dfm, int batch,
                                       int n_rois, int H, int W, int C,
                                       int kh, int kw, int route, int words,
                                       void* stream) {
  return launch<__nv_bfloat16>(fm, rects, valid, g, ties, dfm, batch, n_rois,
                               H, W, C, kh, kw, route, words, stream);
}
