// Dense matrix product O[M, N] = A[M, K] . B[K, N] on tensor cores, in two
// modes:
//   s8 x s8 -> s32     (int32 sums)
//   bf16 x bf16 -> f32 (float32 sums)
//
// Replaces: scripts/probe_int8_dot.py::_mm_kernel (kernel body of
// pallas_mm, probe_int8_dot.py:40; pallas_call at :51), both of its modes
// (acc_dtype int32 and float32). The Pallas kernel is one lax.dot_general
// over a whole-array block; here output tiles cover any M, N and K. The
// int32 sums wrap modulo 2^32 past 2^31 - 1 (no .satfinite), as XLA's int32
// dot does; they are exact otherwise, so the s8 mode is bitwise any correct
// product. The bf16 products are exact in float32 and summed in float32 in
// the tensor core's order.
//
// Bound on the H100: bytes at the probe's shapes. 1024^3: A + B + O is
// 6.29 MB (s8) or 8.39 MB (bf16), 1.88 / 2.50 us at 3.35 TB/s, against
// 1.09 / 2.17 us of operations at 1,979 TOP/s int8 and 989 TFLOP/s bf16.
// The int8 chain's largest GEMM (M = 720000, K = 1152, N = 128): 1.198 GB,
// 0.357 ms of bytes against 0.107 ms of operations; the s32 output is 368
// MB of it, so the stores have to overlap the loads.
//
// Two routes, chosen by shape in ops/matmul_kernel.py::route:
//
// 1. TMA route, mm_tma_kernel (every operand TMA can read: A's rows of
//    K * size bytes and B's rows on the 16-byte grain, 16-byte aligned
//    bases). Persistent and warp-specialized:
//    - one block of 384 threads per SM (resident_blocks) walks 128 x BN
//      output tiles, M fastest, so the blocks that share a B column tile
//      run together and B stays in L2. BN = 64 where 128-wide tiles would
//      leave half the SMs idle (1024^3: 64 tiles of 128 x 128; 128 of
//      128 x 64 fill the card); else 256, 192 or 128, the widest that pads
//      N no further than 128 does while every SM still gets a tile: a
//      wider tile moves fewer bytes from L2 per operation;
//    - warpgroup 0 gives up registers (setmaxnreg) and one of its threads
//      is the producer: it issues TMA loads of A's [128 rows][128 bytes]
//      box and B's BN x 128 bytes of the same K step into a ring of 6
//      stages (4 at BN = 256, 5 at 192; 128-byte swizzle), each with a
//      full and an empty mbarrier; the full barrier is armed with the
//      stage's bytes, which TMA counts whole even where a box is partly or
//      wholly out of bounds (zero-filled: ragged M, N and K need no
//      load-side code);
//    - warpgroups 1 and 2 take the registers and each runs wgmma on 64 of
//      the tile's 128 rows (m64nBNk32 s8, m64nBNk16 bf16; A and B from
//      shared memory), 4 per stage; after wgmma.wait_group 1 a warp
//      releases the previous stage (empty barrier, 8 warp arrivals);
//    - the epilogue stores each warp's accumulators from registers as
//      32-byte row segments (rows past M and columns past N masked) while
//      the producer already fills the ring with the next tile's steps.
//    Phase bits run on one step counter across the tiles of a block.
//    wgmma takes 8-bit operands only K-major. The probe's B is N-major
//    ([K, N] row-major), so transpose_s8_kernel first writes B^T [N, K]
//    into a scratch the wrapper allocates (its launch and time are part of
//    the kernel's); a B that is already K-contiguous (the int8 chain's
//    torch._int_mm(cols, wmat.t())) is read as it is. 16-bit B is read
//    N-major: wgmma transposes it from an MN-major descriptor.
// 2. mma.sync route, mm_kernel (the first version; any M, N, K, alignment;
//    B N-contiguous): one block of 256 threads (8 warps, 2 x 4) per 128 x
//    128 output tile, each warp a 64 x 32 tile of accumulators (4 m16 x 4
//    n8 mma tiles, m16n8k32 s8 and m16n8k16 bf16); K steps of 64 bytes per
//    A row staged with cp.async, double buffered, rows padded by 16 bytes
//    (fragment loads free of bank conflicts); cp_async16z zero-fills rows
//    past M, columns past N and the K tail; where K or N is off the
//    16-byte grain (or a pointer is not 16-byte aligned) the same kernel
//    stages with plain element loads (kVec = false). The bf16 B fragment
//    comes from ldmatrix.trans; the 8-bit one must be K-contiguous and
//    ldmatrix cannot transpose bytes, so after its copy lands the s8 B tile
//    is transposed in shared memory by byte permutes (prmt).
#include <cuda.h>   // CUtensorMap and cuTensorMapEncodeTiled's types only
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


// -- TMA route --------------------------------------------------------------

constexpr int kTmaBM = 128;
constexpr int kStepBytes = 128;                    // of K per stage and row
constexpr int kABytes = kTmaBM * kStepBytes;       // 16 KB of A per stage
constexpr int kTmaThreads = 384;                   // producer + 2 consumers
constexpr int kConsumerWarps = 8;

// a stage: A's box, then B's kBN rows (s8) or k rows of kBN values (bf16)
template <int kBN>
__host__ __device__ constexpr int stage_bytes() {
  return kABytes + kBN * kStepBytes;
}
// stages of the ring: 6, or as many as 225 KB hold (4 at kBN = 256, 5 at
// 192)
template <int kBN>
__host__ __device__ constexpr int stages() {
  return 225 * 1024 / stage_bytes<kBN>() < 6
             ? 225 * 1024 / stage_bytes<kBN>()
             : 6;
}
// the ring, 1024 bytes to align it, the barriers
template <int kBN>
__host__ __device__ constexpr int tma_smem() {
  return stages<kBN>() * stage_bytes<kBN>() + 1024 + 2 * stages<kBN>() * 8;
}

using frcnn::fence_mbar_init;
using frcnn::kmajor_desc;
using frcnn::mbar_arrive;
using frcnn::mbar_expect_tx;
using frcnn::mbar_init;
using frcnn::mbar_wait;
using frcnn::mnmajor_desc128;
using frcnn::resident_blocks;
using frcnn::tma_load_2d;

template <typename T, int kBN>
__global__ void __launch_bounds__(kTmaThreads, 1)
    mm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  void* __restrict__ out, int M, int K, int N) {
  constexpr bool kS8 = sizeof(T) == 1;
  using Acc = typename std::conditional<kS8, int32_t, float>::type;
  constexpr int kBK = kStepBytes / sizeof(T);      // 128 s8, 64 bf16
  constexpr int kStageBytes = stage_bytes<kBN>();
  constexpr int kStages = stages<kBN>();
  extern __shared__ uint8_t smem_raw[];
  // the ring on a 1024-byte boundary (the 128-byte swizzle's atom), then
  // the barriers
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = (M + kTmaBM - 1) / kTmaBM;
  const int tiles = tiles_m * ((N + kBN - 1) / kBN);
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread issues every load
    frcnn::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      frcnn::prefetch_tensor_map(&map_a);
      frcnn::prefetch_tensor_map(&map_b);
      int it = 0;   // steps issued by this block, across its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kTmaBM;
        const int n0 = (tile / tiles_m) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          // the first round finds every stage free (parity 1 of a fresh
          // barrier counts as completed)
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
          if constexpr (kS8) {
            // B^T [N, K]: kBN n rows of 128 k bytes
            tma_load_2d(st + kABytes, &map_b, &full[s], kt * kBK, n0);
          } else {
            // B [K, N]: 64 k rows of 64 n values, kBN / 64 times
#pragma unroll
            for (int h = 0; h < kBN / 64; ++h)
              tma_load_2d(st + kABytes + h * 64 * kStepBytes, &map_b,
                          &full[s], n0 + 64 * h, kt * kBK);
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 (wg - 1) .. of each tile
    frcnn::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const uint32_t ring_s = smem_addr(ring);
    const uint32_t a_off = (wg - 1) * 64 * kStepBytes;
    Acc* o = static_cast<Acc*>(out);
    const bool pairs = (N & 1) == 0;
    Acc acc[kBN / 2];
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[e] = Acc(0);
    int it = 0;   // steps consumed, the producer's count
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kTmaBM;
      const int n0 = (tile / tiles_m) * kBN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a_s = ring_s + s * kStageBytes + a_off;
        const uint32_t b_s = ring_s + s * kStageBytes + kABytes;
        frcnn::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int scale_d = (kt > 0 || j > 0) ? 1 : 0;
          // k32 (s8) or k16 (bf16) slice j: 32 bytes along A's rows
          const uint64_t da = kmajor_desc<128>(a_s + 32 * j);
          if constexpr (kS8)
            frcnn::wgmma_s8_ss(acc, da, kmajor_desc<128>(b_s + 32 * j),
                               scale_d);
          else
            // 16 k rows of 128 bytes; k rows 8..15 1 KB on, each next 64
            // columns 8 KB on
            frcnn::wgmma_bf16_ss_tb(
                acc, da, mnmajor_desc128(b_s + 16 * 128 * j, 8192, 1024),
                scale_d);
        }
        frcnn::wgmma_commit();
        frcnn::wgmma_wait<1>();    // the previous step's products are done
        if (kt > 0 && lane == 0)
          mbar_arrive(&empty[(it - 1) % kStages]);
      }
      frcnn::wgmma_wait<0>();
      if (nk > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      const int row = m0 + (wg - 1) * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tig;
        store2<Acc>(o, M, N, row, col, acc[4 * j], acc[4 * j + 1], pairs);
        store2<Acc>(o, M, N, row + 8, col, acc[4 * j + 2], acc[4 * j + 3],
                    pairs);
      }
    }
  }
}

// Bt [N, K] = B [K, N]^T, int8, through 32 x 32 byte tiles of shared memory
__global__ void __launch_bounds__(256)
    transpose_s8_kernel(const uint8_t* __restrict__ b,
                        uint8_t* __restrict__ bt, int K, int N) {
  __shared__ uint8_t t[32][33];
  const long long tiles_n = (N + 31) / 32;
  const int n0 = (int)(blockIdx.x % tiles_n) * 32;
  const int k0 = (int)(blockIdx.x / tiles_n) * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const int k = k0 + ty + i, n = n0 + tx;
    if (k < K && n < N) t[ty + i][tx] = b[(size_t)k * N + n];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const int n = n0 + ty + i, k = k0 + tx;
    if (n < N && k < K) bt[(size_t)n * K + k] = t[tx][ty + i];
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime: the library
// links against the runtime alone
EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || p == nullptr)
    return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// A row-major [rows, cols] tensor of `row_bytes` a row, read in boxes of
// [box_rows][box_cols] elements under the 128-byte swizzle
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, long long rows, long long cols,
                       long long row_bytes, int box_rows, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides,
                      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of mm_tma_kernel<T, kBN>: B's tensor map (its box spans kBN
// columns of the output), the persistent grid, the kernel
template <typename T, int kBN>
cudaError_t launch_tiles(const CUtensorMap& map_a, const void* b_tma,
                         void* o, int M, int K, int N, cudaStream_t s) {
  constexpr bool kS8 = sizeof(T) == 1;
  constexpr int kBK = kStepBytes / sizeof(T);
  const CUtensorMapDataType type = kS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_b;
  cudaError_t e =
      kS8 ? tensor_map(&map_b, type, b_tma, N, K, K, kBN, kBK)  // B^T [N, K]
          : tensor_map(&map_b, type, b_tma, K, N, (long long)N * 2, kBK,
                       64);                                     // B [K, N]
  int blocks = 0;
  if (e == cudaSuccess)
    e = resident_blocks<mm_tma_kernel<T, kBN>>(kTmaThreads, tma_smem<kBN>(),
                                              &blocks);
  if (e != cudaSuccess) return e;
  const long long tiles =
      (long long)((M + kTmaBM - 1) / kTmaBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  mm_tma_kernel<T, kBN><<<grid, kTmaThreads, tma_smem<kBN>(), s>>>(
      map_a, map_b, o, M, K, N);
  return cudaGetLastError();
}

// b_kmajor: B is the K-contiguous view of a row-major [N, K] (s8 only);
// else B is row-major [K, N], and s8's is first transposed into bt [N, K].
// Tiles of 128 x BN: 64 where 128 x 128 tiles would leave half the SMs
// without one (twice as many 128 x 64 tiles then still run in one round);
// else the widest of 256, 192 and 128 that pads N no further than 128 does
// and still gives every SM a tile (each K step then moves fewer bytes from
// L2 for its operations).
template <typename T>
int launch_tma(const void* a, const void* b, void* bt, void* o, int M, int K,
               int N, int b_kmajor, void* stream) {
  constexpr bool kS8 = sizeof(T) == 1;
  constexpr int kBK = kStepBytes / sizeof(T);
  const long long a_row = (long long)K * sizeof(T);
  if (M <= 0 || N <= 0 || K <= 0 || (b_kmajor && !kS8))
    return (int)cudaErrorInvalidValue;
  if (a_row % 16 != 0 || !aligned16(a)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* b_tma = b;
  if (kS8 && !b_kmajor) {
    const long long blocks = ((N + 31) / 32) * (long long)((K + 31) / 32);
    if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    transpose_s8_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), K, N);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    b_tma = bt;
  }
  if (!aligned16(b_tma) || (!kS8 && ((long long)N * 2) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const CUtensorMapDataType type = kS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a;
  cudaError_t e = tensor_map(&map_a, type, a, M, K, a_row, kTmaBM, kBK);
  int sms = 0;
  if (e == cudaSuccess)
    e = resident_blocks<mm_tma_kernel<T, 128>>(kTmaThreads, tma_smem<128>(),
                                               &sms);
  if (e != cudaSuccess) return (int)e;
  const long long tiles_m = (M + kTmaBM - 1) / kTmaBM;
  auto fits = [&](long long bn) {   // no more padding of N, a tile per SM
    const long long nt = (N + bn - 1) / bn;
    return nt * bn <= (N + 127) / 128 * 128 && tiles_m * nt >= sms;
  };
  if (2 * tiles_m * ((N + 127) / 128) <= sms)
    e = launch_tiles<T, 64>(map_a, b_tma, o, M, K, N, s);
  else if (fits(256))
    e = launch_tiles<T, 256>(map_a, b_tma, o, M, K, N, s);
  else if (fits(192))
    e = launch_tiles<T, 192>(map_a, b_tma, o, M, K, N, s);
  else
    e = launch_tiles<T, 128>(map_a, b_tma, o, M, K, N, s);
  return (int)e;
}

}  // namespace

// The mma.sync route: O [M, N] int32 = A [M, K] int8 . B [K, N] int8,
// all row-major
extern "C" int frcnn_mm_s8s32(const void* a, const void* b, void* o, int M,
                              int K, int N, void* stream) {
  return launch<int8_t>(a, b, o, M, K, N, stream);
}

// The mma.sync route: O [M, N] float32 = A [M, K] bf16 . B [K, N] bf16,
// all row-major
extern "C" int frcnn_mm_bf16f32(const void* a, const void* b, void* o, int M,
                                int K, int N, void* stream) {
  return launch<__nv_bfloat16>(a, b, o, M, K, N, stream);
}

// The TMA route: O [M, N] int32 = A [M, K] int8 . B, with B row-major
// [K, N] (b_kmajor = 0: transposed into bt, [N, K] of scratch) or the
// K-contiguous view of a row-major [N, K] (b_kmajor = 1: bt unused)
extern "C" int frcnn_mm_tma_s8s32(const void* a, const void* b, void* bt,
                                  void* o, int M, int K, int N, int b_kmajor,
                                  void* stream) {
  return launch_tma<int8_t>(a, b, bt, o, M, K, N, b_kmajor, stream);
}

// The TMA route: O [M, N] float32 = A [M, K] bf16 . B [K, N] bf16, all
// row-major (bt and b_kmajor unused: pass null and 0)
extern "C" int frcnn_mm_tma_bf16f32(const void* a, const void* b, void* bt,
                                    void* o, int M, int K, int N,
                                    int b_kmajor, void* stream) {
  return launch_tma<__nv_bfloat16>(a, b, bt, o, M, K, N, b_kmajor, stream);
}
