// Exact greedy NMS over boxes already sorted by descending score.
//
// Replaces: frcnn_tpu/ops/pallas_nms.py::pallas_nms_keep_mask (kernel body
// `_kernel`, pallas_nms.py:33). Same function: +1-pixel IoU, a box is
// suppressed unless IoU <= threshold (so NaN suppresses), at most
// `max_out` picks per image, a [B, N] keep mask over the sorted order.
//
// Bound on the H100: neither bytes nor operations. The work is a chain of
// up to `max_out` dependent picks per image; each pick needs one IoU row
// (N divisions) and a block-wide barrier before the next pick can start.
// At N=512 the inputs are 10 KB per image, the ~N*max_out IoUs are tens of
// kFLOP, so the time is latency: barriers times picks.
//
// Design: one block per image. Boxes, areas and alive flags live in
// shared memory (N=512: 10.5 KB). A single bounded loop walks the sorted
// order once; a dead box costs one shared-memory read and no barrier
// (nothing changes), a kept box costs one parallel IoU row and one
// barrier. The loop has at most N trips, no spin-wait and no cross-block
// sync. The IoU is computed in the TPU kernel's operation order with
// round-to-nearest intrinsics, so no FMA contraction can move a tie at the
// threshold: the result equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float area_plus_one(float x0, float y0, float x1,
                                               float y1) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x1, x0), 1.0f),
                   __fadd_rn(__fsub_rn(y1, y0), 1.0f));
}

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int n,
                                float iou_threshold, int max_out) {
  extern __shared__ float smem[];
  float* sx0 = smem;
  float* sy0 = sx0 + n;
  float* sx1 = sy0 + n;
  float* sy1 = sx1 + n;
  float* sarea = sy1 + n;
  uint8_t* alive = reinterpret_cast<uint8_t*>(sarea + n);

  const int b = blockIdx.x;
  const float* bx = boxes + (size_t)b * n * 4;
  const uint8_t* bv = valid + (size_t)b * n;
  uint8_t* bk = keep + (size_t)b * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float x0 = bx[4 * j + 0], y0 = bx[4 * j + 1];
    const float x1 = bx[4 * j + 2], y1 = bx[4 * j + 3];
    sx0[j] = x0;
    sy0[j] = y0;
    sx1[j] = x1;
    sy1[j] = y1;
    sarea[j] = area_plus_one(x0, y0, x1, y1);
    alive[j] = bv[j] != 0;
    bk[j] = 0;
  }
  __syncthreads();

  int count = 0;
  for (int i = 0; i < n && count < max_out; ++i) {
    if (!alive[i]) continue;  // uniform: nothing was written since the barrier
    ++count;
    if (threadIdx.x == 0) bk[i] = 1;
    if (count >= max_out) break;
    const float px0 = sx0[i], py0 = sy0[i], px1 = sx1[i], py1 = sy1[i];
    const float parea = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (!alive[j]) continue;
      const float iw = max_nan(
          __fadd_rn(__fsub_rn(min_nan(sx1[j], px1), max_nan(sx0[j], px0)),
                    1.0f),
          0.0f);
      const float ih = max_nan(
          __fadd_rn(__fsub_rn(min_nan(sy1[j], py1), max_nan(sy0[j], py0)),
                    1.0f),
          0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(sarea[j], parea), inter));
      if (!(iou <= iou_threshold)) alive[j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int frcnn_nms_keep(const void* boxes, const void* valid, void* keep,
                              int batch, int n, float iou_threshold,
                              int max_out, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaSuccess;
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  const size_t smem = (size_t)n * (5 * sizeof(float) + 1);
  nms_keep_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, iou_threshold, max_out);
  return (int)cudaGetLastError();
}

extern "C" const char* frcnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
