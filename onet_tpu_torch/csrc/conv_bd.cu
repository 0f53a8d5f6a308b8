// Native-layout (channel-stacked) SAME 3x3 convolution, 128 -> 128 lanes,
// with the optional BatchNorm-statistics epilogue, for sm_90a.
//
// Replaces the Pallas kernels of onet_tpu/ops/pallas_conv_bd.py:
//   _bd_fwd_kernel  (:96, via conv3x3_bd_raw)     y = conv(x, w)
//   _bd_fwd2_kernel (:119, via conv3x3_bd2in_raw) y = conv(xa, wa) +
//                                                     conv(xb, wb)
// x [n, h, w, 128] and w [3, 3, 128, 128] (HWIO, any dense weight: the
// block-diagonal zeros of bd2 are multiplied like any other value) are bf16;
// the accumulator is f32; y is stored as bf16 or f32. With stats, per-sample
// lane sums s1, s2 [n][128] of the f32 accumulator before the cast.
//
// What bounds it on the H100. At the probe's sites (n = 8, 512x512) one input
// is 2 * 8 * 512^2 * 128 * 128 * 9 = 6.2e11 flops, 0.625 ms of tensor-core
// time at 989 TFLOP/s, against 1.07 GB of input and output, 0.32 ms at
// 3.35 TB/s: operations bound it (the two-input form: 1.25 ms). So the tensor
// cores must never wait: on loads, on barriers, or on the epilogue.
//
// Design (one kernel, conv_bd, for both forms):
//  * work: output tiles of 2 rows x 128 pixels x all 128 co, numbered in
//    strip order g = ((b * strips + strip) * rowpairs + rowpair); persistent
//    CTAs, one per SM, in clusters of 2; every CTA takes the same number of
//    tiles, a contiguous range of g, so a tile's window rows are still in L2
//    from the tile above it. The last CTAs' ranges run past the end: those
//    tiles are computed on stale planes and dropped (the card's time is the
//    longest range either way), so both CTAs of a cluster stream the same
//    taps;
//  * window planes: the K loop runs plane by plane, a plane being 64 ci of
//    one input (one input is 2 planes, two inputs 4): the 4 rows x 130
//    pixels (halo included) x 64 ci of the tile's window, 66,560 B, one
//    128-byte row a pixel. One TMA load (a 4-D tensor map over x, built on
//    the host) fetches a plane; its out-of-bounds zero fill is the SAME
//    padding and the ragged edges, and its 128-byte swizzle is the tensor
//    cores' own. Two plane buffers: the next plane, or the next tile's
//    first, loads while the current one multiplies;
//  * tap ring: the nine 128x128 taps are 295 KB an input, more than a
//    block's 227 KB, so they stream in chunks of one tap x 64 ci x 128 co
//    (16 KB) in the K loop's order through a 5-stage ring. The wrapper lays
//    the taps out once per call as [plane][tap][co][64 ci] with the 16-byte
//    chunks of each co row already swizzled (ops/conv_bd.py::taps_bd), so a
//    plain bulk copy lands them as the tensor cores read them. Each tile
//    needs 295 KB of taps an input from L2, 2.4 GB a one-input call at
//    N=8 512^2: each CTA of a cluster copies half of every chunk and
//    multicasts it to both, which halves those L2 reads (it paid in the
//    two-input form, where tap and plane reads from L2 neared 4 TB/s).
//    Each cluster takes a plane's taps from its own first tap on (cluster
//    index mod 9): started together, the 66 clusters would otherwise ask
//    the same L2 lines for the same chunk at once (5% in the two-input
//    form);
//  * products: wgmma m64n128k16, D[pixel][co], A = the window plane (pixels
//    K-major: a tap's pixel shift dc is a descriptor dc * 128 bytes on, its
//    row shift dr one (dr * 130 * 128) bytes on, no copy; the tensor cores
//    swizzle by the absolute shared address), B = the tap chunk (co
//    K-major). Two consumer warpgroups each own one output row of the tile:
//    2 x m64n128 a k16 step, 128 f32 accumulators a thread. One issue path
//    for both groups (the row is in the descriptor), so ptxas does not
//    serialize the wgmma. m64n128 with both operands in shared memory reads
//    96 B a clock of tensor-core time, 75% of shared memory's 128 B;
//  * registers: the consumers hold 128 accumulators and 64 statistics a
//    thread. ptxas sizes a kernel's registers for its block rounded to whole
//    warpgroups (a 288-thread block got 168 and spilled 2.2 KB; a larger
//    per-kernel cap does not launch), so a producer warpgroup gives its
//    registers to the consumers (setmaxnreg 40 / 232);
//  * synchronization: mbarriers only. Thread 0 of producer warp 8 issues
//    the tap copies, thread 0 of warp 9 the plane loads, against "full"
//    barriers (transaction bytes); each consumer warp arrives on "empty"
//    barriers once the wgmma that read a chunk or a plane have completed
//    (wgmma.wait_group 1 keeps one group of 8 in flight while the next is
//    issued): a tap slot is refilled once both CTAs' 8 warps released it.
//    The arrivals on the other CTA's barrier use the default (CTA-scope)
//    release: with .release.cluster the kernel ran twice as long. No
//    __syncthreads in the main loop;
//  * epilogue: bf16 y goes from the registers into the buffer of the tile's
//    last plane (both groups are done reading it), one [128 pixels][64 co]
//    swizzled half row at a time, and leaves by TMA stores while the next
//    tile's products run; the buffer is released once the stores have read
//    it. f32 y (no main path's) is stored straight from the registers. The
//    statistics are summed in registers across the tiles of one sample (32
//    co x 2 a thread); when the range moves to another sample, and at its
//    end, the CTA meets them in shared memory and writes one [256] partial
//    (s1 lanes, then s2 lanes) for that sample; stats_reduce_ranges sums
//    each sample's partials in CTA order: the same inputs give the same
//    bits, run to run (no atomics).
// Shared memory: 2 planes 133,120 B + ring 81,920 B + 8,192 B for the
// statistics + barriers, 223,360 B (+1 KB to align to the swizzle atom).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;                 // lanes, in and out
constexpr int TP = 128;                // output pixels per tile row
constexpr int TR = 2;                  // output rows per tile
constexpr int PW = TP + 2;             // plane pixels incl. halo
constexpr int PR = TR + 2;             // plane rows incl. halo
constexpr int PIX = 128;               // bytes of one pixel of a plane (64 ci)
constexpr int PLANE = PR * PW * PIX;   // 66,560
constexpr int CHUNK = L * PIX;         // one tap x 64 ci x 128 co: 16,384
constexpr int RING = 5;                // tap chunks in flight
constexpr int NSTAT = 2 * L;           // s1 lanes, s2 lanes
constexpr int CONSUMERS = 256;         // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int CLUSTER = 2;             // CTAs that share each tap chunk
constexpr int OFF_RING = 2 * PLANE;
constexpr int OFF_RED = OFF_RING + RING * CHUNK;
constexpr int OFF_BAR = OFF_RED + (CONSUMERS / 32) * NSTAT * 4;
constexpr int SMEM = OFF_BAR + 128 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "227 KB of shared memory a block");
static_assert(PLANE % 1024 == 0 && CHUNK % 1024 == 0, "swizzle atoms");

struct Args {
  const __nv_bfloat16* taps;  // [2 nin][9][128 co][64 ci], chunks swizzled
  void* y;                    // NHWC [n, h, w, 128]
  float* part;                // stats partials (stats only)
  int n, h, w, nin, out_bf16, stats;
};

// Partials a CTA writes: one for each sample its range of tiles meets. A
// range of `count` tiles meets at most ceil((count - 1) / per_b) + 1
// samples of per_b tiles each.
__host__ __device__ __forceinline__ int range_slots(int count, int per_b) {
  return (count - 1 + per_b - 1) / per_b + 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One plane: box {64 ci, 130 pixels, 4 rows, 1 sample} of the 4-D map at
// (ci0, pixel, row, sample); out-of-bounds elements land as zeros.
__device__ __forceinline__ void tma_plane(uint32_t dst, const CUtensorMap* map,
                                          int ci0, int c, int r, int b,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ci0), "r"(c), "r"(r), "r"(b),
      "r"(bar)
      : "memory");
}

// Copy `bytes` from global memory to shared address `dst` of every CTA of
// the cluster, each signalling its own barrier at `bar`.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"((uint16_t)((1 << CLUSTER) - 1))
      : "memory");
}

// Arrive on the barrier at `bar` of CTA r of the cluster (lane r of a warp
// arrives at CTA r).
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, int r) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(r)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// One half row of y: box {64 co, 128 pixels, 1 row, 1 sample} of the 4-D
// map of y at (co0, pixel, row, sample) from `src`; the hardware clips what
// lies outside y.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int co0, int c, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(co0), "r"(c), "r"(r), "r"(b), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle starting at
// shared address `addr`: rows of 64 bf16 128 bytes apart, 8 rows a
// 1024-byte swizzle atom (stride 1024); the leading offset is unused.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

#define ACC8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A B, m64n128k16, bf16 in, f32 accumulate, A (64 pixels x 16 ci)
// and B (16 ci x 128 co) both K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b));
}

#undef ACC8

// Tile g: sample b, first output row r0, first pixel c0.
struct Tile {
  int b, r0, c0;
};

__device__ __forceinline__ Tile tile_of(int g, int rowpairs, int strips) {
  const int bs = g / rowpairs;
  Tile t;
  t.r0 = 2 * (g - bs * rowpairs);
  t.b = bs / strips;
  t.c0 = (bs - t.b * strips) * TP;
  return t;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
conv_bd(const __grid_constant__ CUtensorMap map0,
        const __grid_constant__ CUtensorMap map1,
        const __grid_constant__ CUtensorMap map_y, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t planes = base, ring = base + OFF_RING;
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  // barriers: full planes 0-1, empty planes 2-3, full taps 4.., empty taps
  const uint32_t bars = base + OFF_BAR;
  const uint32_t full_plane = bars, empty_plane = bars + 16;
  const uint32_t full_tap = bars + 32, empty_tap = bars + 32 + 8 * RING;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_plane + 8 * i, 1);
      mbar_init(empty_plane + 8 * i, CONSUMERS / 32);
    }
    for (int i = 0; i < RING; ++i) {
      mbar_init(full_tap + 8 * i, 1);
      mbar_init(empty_tap + 8 * i, CLUSTER * CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers exist before either uses them

  const int h = a.h, w = a.w, nplanes = 2 * a.nin;
  const int strips = (w + TP - 1) / TP, rowpairs = (h + 1) / 2;
  const int per_b = strips * rowpairs, total = a.n * per_b;
  // every CTA walks `count` tiles, so the two of a cluster stream the same
  // taps; tiles past `total` (the last CTAs' tail) are computed and dropped
  const int count = (total + gridDim.x - 1) / gridDim.x;
  const int bid = blockIdx.x;
  const int g_begin = bid * count;
  // each cluster starts a plane's taps at its own one, so the clusters do
  // not all ask L2 for the same chunk at once
  const int rot = (bid / CLUSTER) % 9;

  if (tid >= CONSUMERS) {
    // producers: thread 0 of warp 8 streams the taps, thread 0 of warp 9
    // the planes, each in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int kplanes = count * nplanes;
    if (tid == CONSUMERS) {
      // this CTA's half of each chunk (64 of the 128 co) goes to both CTAs
      // of the cluster, once both have released the slot
      const uint32_t half = cluster_rank() * (CHUNK / CLUSTER);
      const unsigned char* taps =
          reinterpret_cast<const unsigned char*>(a.taps) + half;
      int c = 0;
      for (int k = 0; k < kplanes; ++k) {
        const int p = k % nplanes;
        for (int t = 0; t < 9; ++t, ++c) {
          const int slot = c % RING;
          mbar_wait(empty_tap + 8 * slot, ((c / RING) & 1) ^ 1);
          mbar_expect_tx(full_tap + 8 * slot, CHUNK);
          bulk_multicast(ring + slot * CHUNK + half,
                         taps + (size_t)(p * 9 + (t + rot) % 9) * CHUNK,
                         CHUNK / CLUSTER, full_tap + 8 * slot);
        }
      }
      // the last releases of both CTAs, so no arrival reaches this CTA
      // after it has ended
      for (int i = 0; i < RING; ++i, ++c)
        mbar_wait(empty_tap + 8 * (c % RING), ((c / RING) & 1) ^ 1);
    } else if (tid == CONSUMERS + 32) {
      // plane k goes to buffer k % 2 as soon as plane k - 2 is released
      for (int k = 0; k < kplanes; ++k) {
        const int p = k % nplanes;
        const Tile t = tile_of(g_begin + k / nplanes, rowpairs, strips);
        const int pb = k & 1;
        mbar_wait(empty_plane + 8 * pb, ((k >> 1) & 1) ^ 1);
        if (g_begin + k / nplanes >= total) {  // a dropped tile: no load
          mbar_arrive(full_plane + 8 * pb);
          continue;
        }
        mbar_expect_tx(full_plane + 8 * pb, PLANE);
        tma_plane(planes + pb * PLANE, p < 2 ? &map0 : &map1, 64 * (p & 1),
                  t.c0 - 1, t.r0 - 1, t.b, full_plane + 8 * pb);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes output row r0 + wg of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;  // issues the group's y stores
  const int nslot = range_slots(count, per_b);
  const int b_first = g_begin / per_b;
  int b_cur = g_begin < total ? b_first : -1;  // sample being summed
  // by i = 2 j + e1: co 8 j + 2 (lane % 4) + e1
  float s1[32], s2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s1[i] = s2[i] = 0.f;
  float acc[2][64];
  int c = 0, kp = 0;  // chunks and planes consumed so far
  // the plane buffer that holds the last tile's bf16 y until its stores
  // have read it (-1: none)
  int staged = -1;

  for (int i = 0;; ++i) {
    const int g = g_begin + i;
    const bool done = i == count, real = g < total;
    if (a.stats && b_cur >= 0 && (done || !real || g / per_b != b_cur)) {
      // this CTA's partial of sample b_cur: the 8 lanes that share a co set
      // meet by shuffles, the 8 warps in shared memory
#pragma unroll
      for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int d = 4; d < 32; d <<= 1) {
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], d);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], d);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int co = 8 * (i >> 1) + 2 * lane + (i & 1);
          red[warp * NSTAT + co] = s1[i];
          red[warp * NSTAT + L + co] = s2[i];
        }
      }
      bar_sync(1, CONSUMERS);
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < CONSUMERS / 32; ++k) v += red[k * NSTAT + tid];
      a.part[((size_t)bid * nslot + (b_cur - b_first)) * NSTAT + tid] = v;
#pragma unroll
      for (int i = 0; i < 32; ++i) s1[i] = s2[i] = 0.f;
      b_cur = done || !real ? -1 : g / per_b;
      bar_sync(1, CONSUMERS);  // red is rewritten by the next flush
    }
    if (done) break;
    const Tile tl = tile_of(g, rowpairs, strips);

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[m][k] = 0.f;
    for (int p = 0; p < nplanes; ++p, ++kp) {
      const int pb = kp & 1;
      mbar_wait(full_plane + 8 * pb, (kp >> 1) & 1);
      const uint32_t arow = planes + pb * PLANE + wg * PW * PIX;
#pragma unroll
      for (int t = 0; t < 9; ++t, ++c) {
        const int slot = c % RING;
        mbar_wait(full_tap + 8 * slot, (c / RING) & 1);
        const int tt = (t + rot) % 9, dr = tt / 3, dc = tt - 3 * dr;
        const uint64_t da = desc(arow + (dr * PW + dc) * PIX);
        const uint64_t db = desc(ring + slot * CHUNK);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wgmma_n128(acc[m], da + ((m * 64 * PIX + ks * 32) >> 4),
                       db + ((ks * 32) >> 4));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous chunk's group is done: free its slot (and plane)
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (p | t) {
          if (lane < CLUSTER)
            mbar_arrive_cta(empty_tap + 8 * ((c - 1) % RING), lane);
          if (lane == 0 && t == 0)
            mbar_arrive(empty_plane + 8 * ((kp - 1) & 1));
        } else if (staged >= 0) {
          // the last tile's y has left its plane buffer: release it
          if (leader) {
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            mbar_arrive(empty_plane + 8 * staged, 4);
          }
          staged = -1;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 64; ++k) asm volatile("" : "+f"(acc[m][k])::"memory");
    if (lane < CLUSTER) mbar_arrive_cta(empty_tap + 8 * ((c - 1) % RING), lane);

    // epilogue: acc[m][4 j + e] holds pixel 64 m + 16 (warp % 4) +
    // lane / 4 + 8 (e >> 1), co 8 j + 2 (lane % 4) + (e & 1)
    const int r = tl.r0 + wg;
    const bool row_ok = real && r < h;
    const int pb = (kp - 1) & 1;  // the tile's last plane
    if (a.out_bf16) {
      // y goes through the last plane's buffer: group wg's row as two
      // [128 pixels][64 co] halves of 16 KB in the 128-byte swizzle, then
      // out by two TMA stores while the next tile's products run
      bar_sync(1, CONSUMERS);  // both groups are done reading the plane
      const uint32_t stage = planes + pb * PLANE + wg * 2 * TP * PIX;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int px = 64 * m + 16 * (warp & 3) + (lane >> 2) + 8 * e2;
          const bool ok = row_ok && tl.c0 + px < w;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float v0 = acc[m][4 * j + 2 * e2];
            const float v1 = acc[m][4 * j + 2 * e2 + 1];
            const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            const uint32_t dst = stage + (j >> 3) * TP * PIX + px * PIX +
                                 (((j & 7) ^ (px & 7)) << 4) + 4 * (lane & 3);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                         "r"(*reinterpret_cast<const uint32_t*>(&o))
                         : "memory");
            if (a.stats && ok) {
              s1[2 * j] += v0;
              s2[2 * j] += v0 * v0;
              s1[2 * j + 1] += v1;
              s2[2 * j + 1] += v1 * v1;
            }
          }
        }
      }
      // the stores read through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(2 + wg, 128);
      if (leader && row_ok) {
        tma_store(&map_y, stage, 0, tl.c0, r, tl.b);
        tma_store(&map_y, stage + TP * PIX, 64, tl.c0, r, tl.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      staged = pb;
    } else {
      if (lane == 0) mbar_arrive(empty_plane + 8 * pb);
      const size_t row_off = ((size_t)tl.b * h + (row_ok ? r : 0)) * w;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int px =
              tl.c0 + 64 * m + 16 * (warp & 3) + (lane >> 2) + 8 * e2;
          if (!row_ok || px >= w) continue;
          float* yp = static_cast<float*>(a.y) + (row_off + px) * L +
                      2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float v0 = acc[m][4 * j + 2 * e2];
            const float v1 = acc[m][4 * j + 2 * e2 + 1];
            *reinterpret_cast<float2*>(yp + 8 * j) = make_float2(v0, v1);
            if (a.stats) {
              s1[2 * j] += v0;
              s2[2 * j] += v0 * v0;
              s1[2 * j + 1] += v1;
              s2[2 * j + 1] += v1 * v1;
            }
          }
        }
      }
    }
  }
  // y must be written before the CTA ends
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Per-sample sums of conv_bd's partials: sample b's are those of the CTAs
// whose tile ranges (`count` tiles each) meet it, summed in CTA order
// (deterministic). grid n, NSTAT threads, one value each.
__global__ void __launch_bounds__(NSTAT)
stats_reduce_ranges(const float* __restrict__ part, float* s1, float* s2,
                    int per_b, int count) {
  const int b = blockIdx.x, v = threadIdx.x;
  const int nslot = range_slots(count, per_b);
  float acc = 0.f;
  const int last = (b * per_b + per_b - 1) / count;
  for (int c = b * per_b / count; c <= last; ++c)
    acc += part[((size_t)c * nslot + b - c * count / per_b) * NSTAT + v];
  (v < L ? s1 : s2)[(size_t)b * L + v % L] = acc;
}

// cuTensorMapEncodeTiled, reached through the runtime so nothing links
// libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

// The 4-D map of x or y [n, h, w, 128] bf16 whose box is {box0 lanes,
// box1 pixels, box2 rows, 1 sample}: a plane of x, or a half row of y.
int make_map(CUtensorMap* map, const void* x, int n, int h, int w, int box0,
             int box1, int box2) {
  const cuuint64_t dims[4] = {(cuuint64_t)L, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)L * 2, (cuuint64_t)w * L * 2,
                                 (cuuint64_t)h * w * L * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1,
                             (cuuint32_t)box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Set up conv_bd on the current device: its shared-memory attribute, the
// tensor-map encoder, and the launch geometry at this shape. Returns the
// grid (CTAs) a launch uses and writes to *nparts the number of [256] f32
// stats partials it needs: the wrapper allocates them and calls this once
// per (device, shape, nin). Negative: -(CUDA error).
extern "C" int onet_conv3x3_bd_setup(int n, int h, int w, int nin,
                                     int* nparts) {
  if (nin < 1 || nin > 2) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_bd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return -(int)err;
  if (!encode_tiled) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if ((err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                       cudaEnableDefault, &found)) !=
        cudaSuccess)
      return -(int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return -(int)cudaErrorSymbolNotFound;
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  int dev = 0, sms = 0, clusters = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -(int)err;
  // as many clusters as the card holds at once (one CTA an SM)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / CLUSTER * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)conv_bd,
                                            &cfg)) != cudaSuccess)
    return -(int)err;
  if (clusters < 1) return -(int)cudaErrorInvalidConfiguration;
  // tiles numbered with 32-bit ints
  const long tiles = (long)n * ((w + TP - 1) / TP) * ((h + 1) / 2);
  if (tiles > INT32_MAX) return -(int)cudaErrorInvalidValue;
  if (tiles == 0) return *nparts = 0;
  const long need = (tiles + CLUSTER - 1) / CLUSTER;
  const int grid = CLUSTER * (int)(need < clusters ? need : clusters);
  const int per_b = ((w + TP - 1) / TP) * ((h + 1) / 2);
  *nparts = grid * range_slots((int)((tiles + grid - 1) / grid), per_b);
  return grid;
}

// Launch on `stream` with the grid `nblk` from onet_conv3x3_bd_setup;
// returns the CUDA error code (0 on success). x pointers must be 16-byte
// aligned and the tensors contiguous; the wrapper checks. `taps` is
// ops/conv_bd.py::taps_bd of the nin weights. With stats, `part` holds
// that call's nparts * 256 floats of scratch and s1, s2 receive [n][128]
// each.
extern "C" int onet_conv3x3_bd(const void* xa, const void* xb,
                               const void* taps, void* y, float* part,
                               float* s1, float* s2, int n, int h, int w,
                               int nin, int out_bf16, int stats, int nblk,
                               void* stream) {
  if (nin < 1 || nin > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nblk == 0) {  // no pixels: the sums are zero
    if (stats && n > 0) {
      if ((err = cudaMemsetAsync(s1, 0, n * L * 4, st)) != cudaSuccess)
        return (int)err;
      return (int)cudaMemsetAsync(s2, 0, n * L * 4, st);
    }
    return (int)cudaSuccess;
  }
  if (!encode_tiled) return (int)cudaErrorInitializationError;
  // y's map is used only for bf16 y; f32 y is stored from the registers
  CUtensorMap m0, m1, my;
  int bad = make_map(&m0, xa, n, h, w, 64, PW, PR);
  if (!bad) bad = make_map(&m1, nin > 1 ? xb : xa, n, h, w, 64, PW, PR);
  if (!bad) bad = make_map(&my, out_bf16 ? y : xa, n, h, w, 64, TP, 1);
  if (bad) return bad;
  Args a;
  a.taps = static_cast<const __nv_bfloat16*>(taps);
  a.y = y;
  a.part = part;
  a.n = n;
  a.h = h;
  a.w = w;
  a.nin = nin;
  a.out_bf16 = out_bf16;
  a.stats = stats;
  conv_bd<<<nblk, THREADS, SMEM, st>>>(m0, m1, my, a);
  if ((err = cudaGetLastError()) != cudaSuccess || !stats) return (int)err;
  const int per_b = ((w + TP - 1) / TP) * ((h + 1) / 2);
  stats_reduce_ranges<<<n, NSTAT, 0, st>>>(part, s1, s2, per_b,
                                           (n * per_b + nblk - 1) / nblk);
  return (int)cudaGetLastError();
}
