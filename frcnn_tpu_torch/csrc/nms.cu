// Exact greedy NMS over boxes already sorted by descending score, as
// blocked greedy NMS on 64-box bitsets.
//
// Replaces: frcnn_tpu/ops/pallas_nms.py::pallas_nms_keep_mask (kernel body
// `_kernel`, pallas_nms.py:33, pallas_call at :91) and the compaction that
// pallas_nms runs after it in XLA (pallas_nms.py:110-123). Same function:
// +1-pixel IoU, a box is suppressed unless IoU <= threshold (so a NaN
// coordinate suppresses), at most `max_out` picks per image. The TPU
// kernel reads a pick's coordinates as a one-hot sum over the image's row,
// where 0 * inf and 0 * NaN are NaN: a non-finite coordinate of any other
// box, valid or not, makes that coordinate of the pick NaN. This kernel
// records, per coordinate, the first and last box holding a non-finite
// value and reads a pick's coordinates the same way. Outputs: the
// [B, N] keep mask over the sorted order and the [B, max_out] int32 slots,
// the sorted positions of the picks in pick order, padded with -1 (what
// compact_mask(keep, max_out) returns).
//
// Bound on the H100: neither bytes nor operations. At the serving path's
// N=512 an image's inputs are 9 KB and the IoUs greedy NMS needs (each pick
// against each later box still alive) are at most ~10^5 per image, a few
// MFLOP; the time is the latency of the pick chain. Pick k+1 depends on
// every suppression by picks 1..k, so a design that walks the sorted order
// box by box pays a dependent shared-memory read per box and, per pick, an
// IoU row and a block-wide barrier; and one block per image leaves 124 of
// the 132 SMs idle at batch 8 while the IoU rows are bound by instruction
// throughput on the other 8. At Faster R-CNN's published proposal NMS,
// 6000 boxes into 300 picks, an image's inputs are 102 KB and its IoUs at
// most 300 x 6000 = 1.8 x 10^6: still the pick chain, now over more
// chunks, with each block's (d) pass over ~750 boxes per chunk.
//
// Design: blocked greedy NMS on 64-box bitsets, one thread-block cluster of
// 8 blocks (8 SMs) per image. Block r owns the alive words w with
// w % 8 == r, and every block keeps a copy of the alive bitset (one bit
// per box) in shared memory. Each block stages boxes (16 B) and +1-pixel
// areas (4 B) in shared memory: the whole image where it has at most
// kWholeMax boxes (within the 48 KB default), else only the boxes of its
// own words, about N/8, which is all that pass (d) reads. Where that share
// passes 48 KB the launcher opts in to the card's 227 KB once per device,
// which holds shares of up to frcnn_nms_max_boxes() (87552 boxes, the
// largest staged image). Past that (the `direct` flag the host sets,
// ops/nms_kernel.py::plan) no box is staged: pass (d) reads its share
// straight from device memory and computes the +1-pixel areas as staging
// does, and shared memory holds the alive bitset (one bit per box, up to
// ~1.8 million boxes) and the chunk. Passes (b) and R
// read only the chunk's 64 members, which one warp copies into a small
// buffer as it lists them: from the staged image, or from device memory
// where the block holds only its share. The non-finite records span the
// image in every block: staging reads every box for them and the alive
// bits, and stores only what the block keeps. The greedy walk takes
// chunks of the next 64 alive boxes, so a chunk never holds a box that an
// earlier chunk's picks suppressed, and a chunk of fewer than 64 is the
// last. Each chunk after the first costs one cluster barrier (the first
// runs while the blocks wait on each other's staging, which only the first
// remote write needs):
//   (d)   every block clears each alive box of its own words after the
//         last chunk that a pick of that chunk suppresses, in every block's
//         copy (one distributed shared memory atomic per warp and block);
//         tpb threads per box, each taking every tpb-th pick, as few boxes
//         as remain;
//   cluster barrier: the alive bits are final up to the next chunk and
//         the same in every block (a block that runs ahead clears only
//         bits after that chunk's 64th box);
//   chunk one warp lists the first 64 alive boxes (a scan of popcounts over
//         32 words at a time, a trip per nonzero word) and copies their
//         boxes and areas;
//   (b)   every block computes the chunk's intra-chunk suppression columns
//         (col[a] bit b set when member b < a suppresses member a), a warp
//         per two columns, one ballot per 32 members;
//   R     one warp resolves the chunk in registers, in rounds of four
//         ballots: an undecided member that no undecided or kept member
//         suppresses is kept, one that a kept member suppresses is not. A
//         round decides at least the lowest undecided member, and most
//         chunks take a few rounds where a walk takes one step per pick.
//         The picks past max_out are dropped from the top; block 0 writes
//         the keep bytes and the slots (rank = picks before the chunk +
//         popcount below the member).
// The serving path's N=512 takes 2-4 chunks, against a block barrier per
// pick; the proposal NMS of 6000 boxes into 300 picks at least 5. A zero intersection over a nonzero, non-NaN union is decided
// without the division (the same bit: +-0 <= thr), and most pairs of
// boxes do not overlap, so a warp whose pairs all miss skips the IEEE
// division's instruction sequence. The walk is instantiated twice:
// where every coordinate of the image is finite, min and max are
// fminf/fmaxf and a pick is its staged box; otherwise the NaN-propagating
// forms and the TPU kernel's reading of a pick.
// Every IoU is computed in the TPU kernel's operation order, the later box
// first, with round-to-nearest intrinsics (an IEEE division, no FMA
// contraction): a tie at the threshold depends on the exact rounding, and
// the keep mask equals the plain PyTorch version bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 512;
constexpr int kCluster = 8;  // blocks per image, on 8 SMs
constexpr int kWholeMax = 2048;  // boxes staged whole in every block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float area_plus_one(float4 q) {
  return __fmul_rn(__fadd_rn(__fsub_rn(q.z, q.x), 1.0f),
                   __fadd_rn(__fsub_rn(q.w, q.y), 1.0f));
}

// True unless IoU(q, p) <= thr: kept box p suppresses the later box q.
// (x0, y0, x1, y1) are (x, y, z, w); q's operands come first. kFinite:
// every coordinate of the image is finite, so no operand of a min or max
// is NaN and fminf/fmaxf give the same values (a zero's sign is lost in
// the + 1 that follows each).
template <bool kFinite>
__device__ __forceinline__ bool suppresses(float4 q, float qarea, float4 p,
                                           float parea, float thr) {
  auto mn = [](float a, float b) { return kFinite ? fminf(a, b) : min_nan(a, b); };
  auto mx = [](float a, float b) { return kFinite ? fmaxf(a, b) : max_nan(a, b); };
  const float iw = mx(__fadd_rn(__fsub_rn(mn(q.z, p.z), mx(q.x, p.x)), 1.0f),
                      0.0f);
  const float ih = mx(__fadd_rn(__fsub_rn(mn(q.w, p.w), mx(q.y, p.y)), 1.0f),
                      0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fsub_rn(__fadd_rn(qarea, parea), inter);
  // +-0 over a nonzero, non-NaN den is +-0: decided without dividing, as
  // most pairs do not overlap
  if (inter == 0.0f && den == den && den != 0.0f) return !(0.0f <= thr);
  return !(__fdiv_rn(inter, den) <= thr);
}

// inclusive prefix sum over the warp's lanes
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// word w of a bitset with its bits below position pos cleared
__device__ __forceinline__ uint32_t from_pos(uint32_t x, int w, int pos) {
  const int lo = pos - 32 * w;
  return lo <= 0 ? x : lo >= 32 ? 0u : x & (~0u << lo);
}

// An image as every block of its cluster holds it in shared memory.
struct Image {
  const float4* box;      // the staged boxes (x0, y0, x1, y1): the whole
  const float* area;      // image, or the block's share; +1-pixel areas
  const float* gbox;      // the image's boxes in device memory [n, 4]
  uint32_t* alive;        // [n_words] one bit per box
  const int* bad;         // first [0..3] and last [4..7] non-finite box
  uint64_t* cols;         // [kChunk] col[a] bit b: member b suppresses a
  int* cidx;              // [kChunk] the chunk's members, sorted positions
  float4* cbox;           // [kChunk] their boxes and areas
  float* carea;
  int* chunk;             // [2] its size, and the position after it
  uint64_t* chunk_kept;   // its picks, bits over cidx
  int npad, n_words, max_out, rank;
  bool whole;             // every block stages the whole image
  bool direct;            // no block stages boxes: (d) reads gbox
  float thr;
  uint8_t* keep;          // this image's outputs (written by block 0)
  int32_t* slots;

  // where box j of one of this block's words is staged
  __device__ __forceinline__ int staged(int j) const {
    return whole ? j : ((j >> 5) / kCluster) * 32 + (j & 31);
  }

  // box j from device memory, as staging read it
  __device__ __forceinline__ float4 load(int j) const {
    return make_float4(gbox[4 * j], gbox[4 * j + 1], gbox[4 * j + 2],
                       gbox[4 * j + 3]);
  }

  // member a of the chunk as a pick: its coordinates as the TPU kernel
  // reads them, where one of the image's coordinates is not finite
  template <bool kFinite>
  __device__ __forceinline__ void pick(int a, float4& p, float& pa) const {
    p = cbox[a];
    pa = carea[a];
    if (!kFinite) {
      const int i = cidx[a];
      float c[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (bad[k] <= bad[4 + k] && (bad[k] != i || bad[4 + k] != i))
          c[k] = __int_as_float(0x7fc00000);
      p = make_float4(c[0], c[1], c[2], c[3]);
      pa = area_plus_one(p);
    }
  }
};

// The greedy walk over the staged image, chunk by chunk (see the header).
template <bool kFinite>
__device__ __forceinline__ void walk(const Image& im,
                                     cg::cluster_group cluster) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const volatile uint32_t* va = im.alive;
  bool staged = false;
  int count = 0;
  int pos = 0;             // every box before pos is decided
  uint64_t kept = 0;       // picks of the last chunk, bits over cidx
  while (true) {
    // (d) this block's words (w % kCluster == rank) from pos on against
    // the last chunk's picks; tpb threads per box, each taking every
    // tpb-th pick; a warp's clears go to every block's copy of its word
    if (kept != 0) {
      if (!staged) {
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
        staged = true;
      }
      const int wp = pos >> 5;
      const int w0 =
          wp + ((im.rank - wp) % kCluster + kCluster) % kCluster;
      const int owned =
          w0 < im.n_words ? (im.n_words - 1 - w0) / kCluster + 1 : 0;
      const int picks = __popcll(kept);
      int tpb = 1;
      while (tpb < 32 && tpb < picks && 2 * tpb * 32 * owned <= kThreads)
        tpb *= 2;
      const int sub = threadIdx.x & (tpb - 1);
      // a warp's boxes lie in one word
      for (int g = threadIdx.x / tpb; g < 32 * owned; g += kThreads / tpb) {
        const int j = (w0 + (g >> 5) * kCluster) * 32 + (g & 31);
        const bool was = j >= pos && ((va[j >> 5] >> (j & 31)) & 1u);
        bool s = false;
        if (was) {
          float4 q;
          float qa;
          if (im.direct) {
            q = im.load(j);
            qa = area_plus_one(q);
          } else {
            q = im.box[im.staged(j)];
            qa = im.area[im.staged(j)];
          }
          uint64_t m = kept;
          for (int r = 0; r < sub; ++r) m &= m - 1;
          while (m != 0 && !s) {
            float4 p;
            float pa;
            im.pick<kFinite>(__ffsll((long long)m) - 1, p, pa);
            for (int r = 0; r < tpb; ++r) m &= m - 1;
            s = suppresses<kFinite>(q, qa, p, pa, im.thr);
          }
        }
        for (int o = 1; o < tpb; o <<= 1)
          s |= __shfl_xor_sync(0xffffffffu, s, o);
        const uint32_t clear = __reduce_or_sync(
            0xffffffffu, was && s ? 1u << (j & 31) : 0u);
        if (clear != 0 && lane < kCluster)
          atomicAnd(cluster.map_shared_rank(im.alive + (j >> 5), lane),
                    ~clear);
      }
      cluster.sync();  // every block's alive bits are final up to the chunk
    }

    // the chunk: the first 64 alive boxes from pos on, the same in every
    // block (a block that runs ahead clears only bits after them); one
    // warp, 32 words at a time, a trip per nonzero word, lane l taking
    // bit l; then each lane copies members l and l + 32
    if (warp == 0) {
      int found = 0;  // alive boxes counted from pos on
      for (int w0 = pos >> 5; w0 < im.n_words && found < kChunk; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t x = w < im.n_words ? from_pos(va[w], w, pos) : 0u;
        const int c = __popc(x);
        const int incl = warp_scan(c);
        const int e = found + incl - c;  // members before this word
        for (uint32_t nz = __ballot_sync(0xffffffffu, x != 0 && e < kChunk);
             nz != 0; nz &= nz - 1) {
          const int l = __ffs(nz) - 1;
          const uint32_t xl = __shfl_sync(0xffffffffu, x, l);
          const int r = __shfl_sync(0xffffffffu, e, l) +
                        __popc(xl & ((1u << lane) - 1));
          if (((xl >> lane) & 1) && r < kChunk)
            im.cidx[r] = 32 * (w0 + l) + lane;
        }
        found += __shfl_sync(0xffffffffu, incl, 31);
      }
      const int size = min(found, kChunk);
      __syncwarp();
      // both loads in flight before either store
      const bool h0 = lane < size, h1 = lane + 32 < size;
      const int j0 = h0 ? im.cidx[lane] : 0, j1 = h1 ? im.cidx[lane + 32] : 0;
      float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0;
      if (h0) q0 = im.whole ? im.box[j0] : im.load(j0);
      if (h1) q1 = im.whole ? im.box[j1] : im.load(j1);
      if (h0) {
        im.cbox[lane] = q0;
        im.carea[lane] = im.whole ? im.area[j0] : area_plus_one(q0);
      }
      if (h1) {
        im.cbox[lane + 32] = q1;
        im.carea[lane + 32] = im.whole ? im.area[j1] : area_plus_one(q1);
      }
      if (lane == 0) {
        im.chunk[0] = size;
        if (size > 0) im.chunk[1] = im.cidx[size - 1] + 1;
      }
    }
    __syncthreads();
    const int size = im.chunk[0];
    if (size == 0) break;

    // (b) the chunk's columns, in every block: columns a and a + kWarps to
    // warp a % kWarps, four IoUs in flight per lane; lane l holds members
    // l and l + 32 as picks
    {
      float4 p0, p1;
      float pa0, pa1;
      if (lane < size) im.pick<kFinite>(lane, p0, pa0);
      if (lane + 32 < size) im.pick<kFinite>(lane + 32, p1, pa1);
      for (int a = warp; a < size; a += 2 * kWarps) {
        const int a2 = a + kWarps;
        const int b2 = a2 < size ? a2 : a;
        const float4 q = im.cbox[a], q2 = im.cbox[b2];
        const float qa = im.carea[a], qa2 = im.carea[b2];
        const bool s0 =
            lane < a && suppresses<kFinite>(q, qa, p0, pa0, im.thr);
        const bool s1 =
            lane + 32 < a && suppresses<kFinite>(q, qa, p1, pa1, im.thr);
        const bool t0 = a2 < size && lane < a2 &&
                        suppresses<kFinite>(q2, qa2, p0, pa0, im.thr);
        const bool t1 = a2 < size && lane + 32 < a2 &&
                        suppresses<kFinite>(q2, qa2, p1, pa1, im.thr);
        const uint64_t col_a =
            __ballot_sync(0xffffffffu, s0) |
            ((uint64_t)__ballot_sync(0xffffffffu, s1) << 32);
        const uint64_t col_a2 =
            __ballot_sync(0xffffffffu, t0) |
            ((uint64_t)__ballot_sync(0xffffffffu, t1) << 32);
        if (lane == 0) {
          im.cols[a] = col_a;
          if (a2 < size) im.cols[a2] = col_a2;
        }
      }
    }
    __syncthreads();

    // R greedy over the chunk in warp 0, in rounds of four ballots: an
    // undecided member that no undecided or kept member suppresses is
    // kept; one that a kept member suppresses is not. A round decides at
    // least the lowest undecided member.
    if (warp == 0) {
      uint64_t und = size == kChunk ? ~0ull : (1ull << size) - 1;
      const uint64_t c0 = im.cols[lane], c1 = im.cols[lane + 32];
      uint64_t k_all = 0;
      while (und != 0) {
        const uint64_t live = und | k_all;
        const bool u0 = (und >> lane) & 1, u1 = (und >> (lane + 32)) & 1;
        const uint64_t k =
            __ballot_sync(0xffffffffu, u0 && !(c0 & live)) |
            ((uint64_t)__ballot_sync(0xffffffffu, u1 && !(c1 & live)) << 32);
        const uint64_t d =
            __ballot_sync(0xffffffffu, u0 && (c0 & k_all)) |
            ((uint64_t)__ballot_sync(0xffffffffu, u1 && (c1 & k_all)) << 32);
        k_all |= k;
        und &= ~(k | d);
      }
      // at most max_out picks: the lowest ones of the chunk
      for (int extra = count + __popcll(k_all) - im.max_out; extra > 0;
           --extra)
        k_all &= ~(1ull << (63 - __clzll((long long)k_all)));
      if (im.rank == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = h * 32 + lane;
          if ((k_all >> a) & 1) {
            im.keep[im.cidx[a]] = 1;
            im.slots[count + __popcll(k_all & ((1ull << a) - 1))] =
                im.cidx[a];
          }
        }
      }
      if (lane == 0) *im.chunk_kept = k_all;
    }
    __syncthreads();
    kept = *im.chunk_kept;
    count += __popcll(kept);
    pos = im.chunk[1];
    // a chunk of fewer than 64 holds every box still alive
    if (count >= im.max_out || size < kChunk || pos >= im.npad) break;
  }
  if (!staged) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // nothing writes into another block after the last chunk's barrier
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nms_keep_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int32_t* __restrict__ slots,
                    int n, int staged, float thr, int max_out, bool direct) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float4 cbox[kChunk];
  __shared__ float carea[kChunk];
  __shared__ uint64_t cols[kChunk];
  __shared__ int cidx[kChunk];
  __shared__ int chunk[2];
  __shared__ uint64_t chunk_kept;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int npad = (n + 31) / 32 * 32;
  const int n_words = npad / 32;
  const bool whole = staged >= npad;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + staged);
  uint32_t* alive = reinterpret_cast<uint32_t*>(sarea + staged);
  int* bad = reinterpret_cast<int*>(alive + n_words);

  const int b = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const float* bx = boxes + (size_t)b * n * 4;
  const uint8_t* bv = valid + (size_t)b * n;
  uint8_t* bk = keep + (size_t)b * n;
  int32_t* bs = slots + (size_t)b * max_out;

  // every block reads the whole image (the non-finite records and the
  // alive bits) and stores the boxes it keeps: all of them, or its share
  if (threadIdx.x < 8) bad[threadIdx.x] = threadIdx.x < 4 ? n : -1;
  __syncthreads();
  // a warp's 32 boxes are all below npad or all above (npad % 32 == 0)
  for (int j = threadIdx.x; j < npad; j += kThreads) {
    bool v = false;
    if (j < n) {
      const float c[4] = {bx[4 * j], bx[4 * j + 1], bx[4 * j + 2],
                          bx[4 * j + 3]};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!isfinite(c[k])) {
          atomicMin(bad + k, j);
          atomicMax(bad + 4 + k, j);
        }
      }
      if (!direct && (whole || (j >> 5) % kCluster == rank)) {
        const float4 q = make_float4(c[0], c[1], c[2], c[3]);
        const int s = whole ? j : ((j >> 5) / kCluster) * 32 + (j & 31);
        sbox[s] = q;
        sarea[s] = area_plus_one(q);
      }
      v = bv[j] != 0;
      if (rank == 0) bk[j] = 0;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, v);
    if (lane == 0) alive[j >> 5] = word;
  }
  if (rank == 0)
    for (int s = threadIdx.x; s < max_out; s += kThreads) bs[s] = -1;
  __syncthreads();
  // no block writes into another before it is staged: the wait comes just
  // before the first remote write, so the first chunk runs meanwhile
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");

  const Image im{sbox,  sarea,       bx,   alive,   bad,     cols,
                 cidx,  cbox,        carea, chunk,  &chunk_kept,
                 npad,  n_words,     max_out, rank, whole,   direct,
                 thr,   bk,          bs};
  const bool finite = bad[0] > bad[4] && bad[1] > bad[5] &&
                      bad[2] > bad[6] && bad[3] > bad[7];
  if (finite)
    walk<true>(im, cluster);
  else
    walk<false>(im, cluster);
}

// boxes staged per block (none when direct), and the dynamic shared
// memory that takes
void staging(int n, bool direct, int* staged, size_t* smem) {
  const int npad = (n + 31) / 32 * 32;
  const int n_words = npad / 32;
  *staged = direct              ? 0
            : npad <= kWholeMax ? npad
                                : (n_words + kCluster - 1) / kCluster * 32;
  *smem = (size_t)*staged * (sizeof(float4) + sizeof(float)) +
          (size_t)n_words * sizeof(uint32_t) + 8 * sizeof(int);
}

// the dynamic shared memory a block may take on the current device (after
// the one opt-in per device), or 0 on an error
size_t dynamic_limit() {
  static size_t limit[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (limit[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, nms_keep_kernel) != cudaSuccess)
      return 0;
    const int dyn = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(nms_keep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn) != cudaSuccess)
      return 0;
    limit[dev] = (size_t)dyn;
  }
  return limit[dev];
}

}  // namespace

// The largest N a launch stages on the current device (0 on an error);
// past it the host sets `direct`.
extern "C" int frcnn_nms_max_boxes() {
  const size_t limit = dynamic_limit();
  int n = 0;
  for (int step = 1 << 20; step >= 32; step >>= 1) {
    int staged;
    size_t smem;
    staging(n + step, false, &staged, &smem);
    if (smem <= limit) n += step;
  }
  return n;
}

extern "C" int frcnn_nms_keep(const void* boxes, const void* valid, void* keep,
                              void* slots, int batch, int n,
                              float iou_threshold, int max_out, int direct,
                              void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  // box offsets 4 j fit in 32 bits
  if (n < 0 || (long long)n * 4 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int staged;
  size_t smem;
  staging(n, direct != 0, &staged, &smem);
  if (smem > 48 * 1024) {
    const size_t limit = dynamic_limit();
    if (limit == 0) return (int)cudaGetLastError();
    if (smem > limit) return (int)cudaErrorInvalidValue;
  }
  nms_keep_kernel<<<batch * kCluster, kThreads, smem,
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(slots), n, staged,
      iou_threshold, max_out, direct != 0);
  return (int)cudaGetLastError();
}

extern "C" const char* frcnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
