// Hopper building blocks shared by the tensor-core kernels (block0.cu,
// block0_2conv.cu): cp.async copies into shared memory, the int8 output
// quantization, wgmma with A in registers and B behind a shared-memory
// descriptor, and the persistent grid's size per device. Header only;
// every function is inline.
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
