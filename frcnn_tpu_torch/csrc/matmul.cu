// Dense matrix product O[M, N] = A[M, K] . B[K, N], both row-major, on
// tensor cores, in two modes:
//   s8 x s8 -> s32     (mma.sync m16n8k32, int32 sums)
//   bf16 x bf16 -> f32 (mma.sync m16n8k16, float32 sums)
//
// Replaces: scripts/probe_int8_dot.py::_mm_kernel (kernel body of
// pallas_mm, probe_int8_dot.py:40; pallas_call at :51), both of its modes
// (acc_dtype int32 and float32). The Pallas kernel is one lax.dot_general
// over a whole-array block; here a grid of 128 x 128 output tiles covers
// any M, N and K. The int32 sums wrap modulo 2^32 past 2^31 - 1 (mma.sync
// without .satfinite), as XLA's int32 dot does; they are exact otherwise,
// so the s8 mode is bitwise any correct product. The bf16 products are
// exact in float32 and summed in float32 in the tensor core's order.
//
// Bound on the H100: bytes at the probe's shapes. 1024^3: A + B + O is
// 6.29 MB (s8) or 8.39 MB (bf16), 1.88 / 2.50 us at 3.35 TB/s, against
// 1.09 / 2.17 us of operations at 1,979 TOP/s int8 and 989 TFLOP/s bf16
// (a launch costs more than either). The int8 chain's largest GEMM
// (M = 720000, K = 1152, N = 128): 1.198 GB, 0.357 ms of bytes against
// 0.107 ms of operations.
//
// Design (simple and right; a wgmma/TMA version is later speed work):
// - one block of 256 threads (8 warps, 2 x 4) per 128 x 128 output tile;
//   each warp holds a 64 x 32 tile of accumulators in registers (4 m16 x 4
//   n8 mma tiles). Blocks walk M fastest, so the blocks that share a B
//   column tile run together and B stays in L2.
// - K steps of 64 bytes per A row (64 s8 or 32 bf16), staged through
//   shared memory with cp.async, double buffered: the next step's copies
//   are in flight while the tensor cores work on this one. Rows padded by
//   16 bytes, so fragment loads are free of bank conflicts.
// - The edges: cp_async16z zero-fills rows past M, columns past N and the
//   K tail, so partial tiles need no other code. cp.async moves 16-byte
//   aligned chunks; where K or N is not a multiple of 16 bytes (or a
//   pointer is not 16-byte aligned) the same kernel stages with plain
//   element loads instead (kVec = false), zero-filled the same way.
// - B is N-contiguous. The bf16 B fragment comes from ldmatrix.trans
//   (16-bit elements). The 8-bit mma.sync B fragment must be K-contiguous
//   and ldmatrix cannot transpose bytes, so the s8 B tile is transposed in
//   the kernel: after its copy lands, each thread reads 4 x 4-byte words
//   from 4 consecutive k rows, transposes the 4 x 4 bytes with byte
//   permutes (prmt) in registers and stores 4 words of the [n][k] tile.
//   The wrapper passes B as it is: no copy outside the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using frcnn::cp_async16z;
using frcnn::cp_async_commit;
using frcnn::smem_addr;

constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kRowBytes = 64;            // bytes of A per row and K step
constexpr int kAStride = kRowBytes + 16; // staged A rows (and s8 B^T rows)
constexpr int kRawStride = 128 + 16;     // staged s8 B rows: 128 n bytes
constexpr int kBbStride = 256 + 16;      // staged bf16 B rows: 128 n values
constexpr int kATile = kBM * kAStride;           // 10240 bytes
constexpr int kRawTile = 64 * kRawStride;        // 9216 bytes (64 k rows)
constexpr int kBtTile = kBN * kAStride;          // 10240 bytes
constexpr int kBbTile = 32 * kBbStride;          // 8704 bytes (32 k rows)

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_none() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the element's bits (the plain loads copy bits, whatever the type)
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 1, uint8_t,
                                       uint16_t>::type;
// two accumulators, stored as one 8-byte access
template <typename Acc>
using Acc2 = typename std::conditional<std::is_same<Acc, float>::value,
                                       float2, int2>::type;

// One 16-byte chunk of a row into shared memory: `valid` of its elements
// (0 to 16 / sizeof(T)) from `src`, the rest zero. kVec: one cp.async
// (valid is then 0 or the whole chunk, and src 16-byte aligned); else
// plain loads.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const T* src,
                                            int valid, const T* base) {
  constexpr int kE = 16 / sizeof(T);
  if constexpr (kVec) {
    cp_async16z(dst, valid > 0 ? src : base, valid > 0 ? 16 : 0);
  } else {
    const Bits<T>* s = reinterpret_cast<const Bits<T>*>(src);
    Bits<T>* d = reinterpret_cast<Bits<T>*>(dst);
#pragma unroll
    for (int e = 0; e < kE; ++e) d[e] = e < valid ? s[e] : Bits<T>(0);
  }
}

__device__ __forceinline__ int clamp_valid(long long left, int e) {
  return left <= 0 ? 0 : (left >= e ? e : (int)left);
}

// A rows m0..m0+127, K elements k0..k0+kRowBytes/sizeof(T)-1: 4 chunks a
// row, 2 chunks a thread
template <typename T, bool kVec>
__device__ __forceinline__ void stage_a(uint8_t* as, const T* A, int M, int K,
                                        int m0, int k0) {
  constexpr int kE = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int row = q >> 2, c = q & 3;
    const int m = m0 + row, k = k0 + c * kE;
    const int valid = m < M ? clamp_valid((long long)K - k, kE) : 0;
    stage_chunk<T, kVec>(as + row * kAStride + c * 16,
                         A + (size_t)m * K + k, valid, A);
  }
}

// B rows k0..k0+kRows-1 (64 s8 or 32 bf16 k rows), columns n0..n0+127:
// 128 x sizeof(T) bytes a row, 2 chunks a thread
template <typename T, bool kVec>
__device__ __forceinline__ void stage_b(uint8_t* bs, const T* B, int K, int N,
                                        int k0, int n0) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kChunks = kBN / kE;                  // per row: 8 or 16
  constexpr int kStride = sizeof(T) == 1 ? kRawStride : kBbStride;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int row = q / kChunks, c = q % kChunks;
    const int k = k0 + row, n = n0 + c * kE;
    const int valid = k < K ? clamp_valid((long long)N - n, kE) : 0;
    stage_chunk<T, kVec>(bs + row * kStride + c * 16,
                         B + (size_t)k * N + n, valid, B);
  }
}

// s8: the staged [64 k][128 n] tile into the [128 n][64 k] tile the mma B
// fragment reads. 512 blocks of 4 x 4 bytes, 2 a thread; the lane mapping
// keeps the loads 2-way and the stores 4-way in bank conflicts.
__device__ __forceinline__ void transpose_b(uint8_t* bt, const uint8_t* raw) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int kq = (lane & 3) | ((w & 3) << 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int nq = (lane >> 2) | ((w >> 2) << 3) | (j << 4);
    const uint8_t* src = raw + 4 * kq * kRawStride + 4 * nq;
    const uint32_t w0 = lds32(src), w1 = lds32(src + kRawStride),
                   w2 = lds32(src + 2 * kRawStride),
                   w3 = lds32(src + 3 * kRawStride);
    // byte c of word r is B[4kq + r][4nq + c]
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);   // w0.0 w1.0 w0.1 w1.1
    const uint32_t t1 = __byte_perm(w0, w1, 0x7362);   // w0.2 w1.2 w0.3 w1.3
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    uint8_t* dst = bt + 4 * nq * kAStride + 4 * kq;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kAStride) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kAStride) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kAStride) =
        __byte_perm(t1, t3, 0x7632);
  }
}

template <typename Acc>
__device__ __forceinline__ void store2(Acc* o, int M, int N, int row, int col,
                                       Acc v0, Acc v1, bool pairs) {
  if (row >= M || col >= N) return;
  Acc* p = o + (size_t)row * N + col;
  if (pairs && col + 1 < N) {
    Acc2<Acc> v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<Acc2<Acc>*>(p) = v;
  } else {
    p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    mm_kernel(const T* __restrict__ A, const T* __restrict__ B,
              void* __restrict__ out, int M, int K, int N) {
  constexpr bool kS8 = sizeof(T) == 1;
  using Acc = typename std::conditional<kS8, int32_t, float>::type;
  constexpr int kBK = kRowBytes / sizeof(T);         // 64 s8, 32 bf16
  constexpr int kBTile = kS8 ? kRawTile : kBbTile;
  __shared__ __align__(16) uint8_t as[2][kATile];
  __shared__ __align__(16) uint8_t bs[2][kBTile];
  __shared__ __align__(16) uint8_t bt[kS8 ? kBtTile : 16];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) {
    stage_a<T, kVec>(as[0], A, M, K, m0, 0);
    stage_b<T, kVec>(bs[0], B, K, N, 0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      stage_a<T, kVec>(as[s ^ 1], A, M, K, m0, (kt + 1) * kBK);
      stage_b<T, kVec>(bs[s ^ 1], B, K, N, (kt + 1) * kBK, n0);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_none();
    }
    __syncthreads();
    const uint8_t* a_s = as[s];
    if constexpr (kS8) {
      transpose_b(bt, bs[s]);
      __syncthreads();
    }
    // two mma K steps of 32 bytes of A: k32 (s8) or k16 (bf16)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = ks * 32;
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = a_s + (wm + mi * 16 + g) * kAStride + kb + tig * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kAStride);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kAStride + 16);
      }
      uint32_t bf[4][2];
      if constexpr (kS8) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint8_t* p = bt + (wn + ni * 8 + g) * kAStride + kb + tig * 4;
          bf[ni][0] = lds32(p);
          bf[ni][1] = lds32(p + 16);
        }
      } else {
        // lanes 0-15 address k rows kb/2 + 0..15 at column n, lanes 16-31
        // the same rows at n + 8: two n8 tiles a load
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int row = ks * 16 + (lane & 15);
          const int col = wn + np * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_addr(bs[s] + row * kBbStride + col * 2));
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (kS8)
            mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
          else
            mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
    }
    __syncthreads();
  }

  // accumulator e of an m16n8 tile: row g + 8 (e >> 1), column 2 tig + (e & 1)
  Acc* o = static_cast<Acc*>(out);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + g;
      const int col = n0 + wn + ni * 8 + 2 * tig;
      store2<Acc>(o, M, N, row, col, acc[mi][ni][0], acc[mi][ni][1], pairs);
      store2<Acc>(o, M, N, row + 8, col, acc[mi][ni][2], acc[mi][ni][3],
                  pairs);
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* a, const void* b, void* o, int M, int K, int N,
           void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  constexpr int kE = 16 / sizeof(T);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % kE == 0 && N % kE == 0 && aligned16(a) && aligned16(b))
    mm_kernel<T, true><<<grid, kThreads, 0, s>>>(A, B, o, M, K, N);
  else
    mm_kernel<T, false><<<grid, kThreads, 0, s>>>(A, B, o, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// O [M, N] int32 = A [M, K] int8 . B [K, N] int8, all row-major
extern "C" int frcnn_mm_s8s32(const void* a, const void* b, void* o, int M,
                              int K, int N, void* stream) {
  return launch<int8_t>(a, b, o, M, K, N, stream);
}

// O [M, N] float32 = A [M, K] bf16 . B [K, N] bf16, all row-major
extern "C" int frcnn_mm_bf16f32(const void* a, const void* b, void* o, int M,
                                int K, int N, void* stream) {
  return launch<__nv_bfloat16>(a, b, o, M, K, N, stream);
}
