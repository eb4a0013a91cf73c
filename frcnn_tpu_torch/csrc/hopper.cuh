// Hopper building blocks shared by the tensor-core kernels (block0.cu,
// block0_2conv.cu, matmul.cu): cp.async copies into shared memory, the
// int8 output quantization, wgmma with A in registers or in shared memory
// and B behind a shared-memory descriptor, mbarriers and TMA tile loads,
// register hand-over between warpgroups, and the persistent grid's size
// per device. Header only; every function is inline.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace frcnn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 16 bytes, of which the first src_bytes (0 to 16) are read, the rest
// zeroed
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// clip(rint(v * inv), -127, 127) as the int8's byte: the product rounded
// once (__fmul_rn, nothing to contract), the lower clip, then one
// conversion that rounds half to even (as jnp.round) and saturates at 127,
// which is the upper clip
__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=r"(q)
      : "f"(fmaxf(__fmul_rn(v, inv), -127.0f)));
  return static_cast<uint32_t>(q) & 0xffu;
}

// generic-proxy writes to shared memory become visible to wgmma's reads
// (the async proxy); each writing thread fences before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma (one warpgroup of 4 warps issues a 64-row product): A from the
// warps' registers, B from shared memory through a matrix descriptor.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand whose rows of `row_bytes` (128: swizzle
// mode 1, 64: mode 2) hold their 16-byte chunks XOR-swizzled by the row's
// address bits (chunk c of row p at c ^ (p & 7) for 128-byte rows), 8-row
// groups 8 * row_bytes apart. The rows start on a 1024-byte boundary.
template <int kRowBytes>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) |
         (kMode << 62);
}

// D (64 x 64, float32) = A (64 x 16 bf16, registers) * B (descriptor) + D,
// or without the + D under scale_d = 0.
// The accumulator layout is mma.sync's, one m16 tile per warp: d[4n + e]
// is row g + 8 (e >> 1), column 8n + 2 tig + (e & 1) of the warp's tile,
// with g = lane >> 2, tig = lane & 3; A's registers are mma.sync's A
// fragment of the warp's 16 rows.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Descriptor of an MN-major 16-bit operand under the 128-byte swizzle, as
// TMA's SWIZZLE_128B writes a box of 64 MN values (128 bytes) by k rows:
// 8 k rows 128 bytes apart, the next 8 rows `sbo` bytes on, the next 64 MN
// values `lbo` bytes on (CUTLASS's canonical ((8,n),(8,k)):((1,LBO),(8,SBO))
// in 16-byte units). Rows start on a 1024-byte boundary.
__device__ __forceinline__ uint64_t mnmajor_desc128(uint32_t addr,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The accumulators of an m64nN wgmma (N = 64, 128, 192, 256: N / 2 a
// thread) as asm operands: d[4j + e] is row g + 8 (e >> 1), column
// 8j + 2 tig + (e & 1) of the warp's 16 rows (the layout of mma.sync's
// accumulators, n8 tile after n8 tile).
#define FRCNN_D8(C, i)                                                      \
  C(d[i + 0]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),          \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define FRCNN_D32(C, i)                                                     \
  FRCNN_D8(C, i), FRCNN_D8(C, i + 8), FRCNN_D8(C, i + 16),                  \
      FRCNN_D8(C, i + 24)
#define FRCNN_D_32(C) FRCNN_D32(C, 0)
#define FRCNN_D_64(C) FRCNN_D32(C, 0), FRCNN_D32(C, 32)
#define FRCNN_D_96(C) FRCNN_D_64(C), FRCNN_D32(C, 64)
#define FRCNN_D_128(C) FRCNN_D_96(C), FRCNN_D32(C, 96)
#define FRCNN_LIST_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define FRCNN_LIST_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define FRCNN_LIST_96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, " \
  "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, " \
  "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define FRCNN_LIST_128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, " \
  "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, " \
  "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, " \
  "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, " \
  "%121, %122, %123, %124, %125, %126, %127}"

// D (64 x N, int32) = A (64 x 32 int8) * B (32 x N int8) + D, both K-major
// in shared memory behind descriptors; without the + D under scale_d = 0.
// The int32 sums wrap modulo 2^32 (no .satfinite).
//
// D (64 x N, float32) = A (64 x 16 bf16, K-major) * B (16 x N bf16,
// MN-major: the transpose bit) + D, both in shared memory; without the + D
// under scale_d = 0.
#define FRCNN_WGMMA_SS(R, N, P, Q, S)                                       \
  __device__ __forceinline__ void wgmma_s8_ss(int (&d)[R], uint64_t desc_a, \
                                              uint64_t desc_b,              \
                                              int scale_d) {                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" N "k32.s32.s8.s8 "     \
                 FRCNN_LIST_##R ", %" P ", %" Q ", p;\n}\n"                 \
                 : FRCNN_D_##R("+r")                                        \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                 \
  }                                                                         \
  __device__ __forceinline__ void wgmma_bf16_ss_tb(                         \
      float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 " \
                 FRCNN_LIST_##R ", %" P ", %" Q ", p, 1, 1, 0, 1;\n}\n"     \
                 : FRCNN_D_##R("+f")                                        \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                 \
  }
FRCNN_WGMMA_SS(32, "64", "32", "33", "34")
FRCNN_WGMMA_SS(64, "128", "64", "65", "66")
FRCNN_WGMMA_SS(96, "192", "96", "97", "98")
FRCNN_WGMMA_SS(128, "256", "128", "129", "130")

#undef FRCNN_WGMMA_SS
#undef FRCNN_D8
#undef FRCNN_D32
#undef FRCNN_D_32
#undef FRCNN_D_64
#undef FRCNN_D_96
#undef FRCNN_D_128
#undef FRCNN_LIST_32
#undef FRCNN_LIST_64
#undef FRCNN_LIST_96
#undef FRCNN_LIST_128

// mbarriers in shared memory (one phase bit each) and TMA tile loads that
// complete on them.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialization becomes visible to the other threads and to
// the async proxy (TMA's completions)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that has
// not ended after ~2^34 cycles (seconds) traps: a launch fails with an
// error instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// A 2-D box of a tensor map (a __grid_constant__ CUtensorMap parameter)
// at element coordinates (c0 innermost, c1) into shared memory; its bytes
// complete on `bar`. Parts of the box outside the tensor are zero-filled
// and counted all the same.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Registers per thread of the calling warpgroup (all 128 threads call it):
// a producer gives up registers, the consumers take them. The kernel must
// be compiled with a register ceiling (__launch_bounds__).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Blocks of kKernel (at `threads` threads and `smem` bytes of dynamic
// shared memory) that the current device holds at once: the grid of a
// persistent kernel. The shared-memory attribute and the SM count belong
// to a device, so both are taken at the first launch on each device and
// kept per device (and per kernel: the cache is kKernel's own).
template <auto kKernel>
cudaError_t resident_blocks(int threads, int smem, int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> resident_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int resident = resident_of[dev].load(std::memory_order_acquire);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                        threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    resident_of[dev].store(resident, std::memory_order_release);
  }
  *blocks = resident;
  return cudaSuccess;
}

}  // namespace frcnn
