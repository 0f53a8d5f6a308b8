// Pair-packed SAME 3x3 convolution with its two epilogues, for sm_90a.
//
// Replaces the Pallas kernels of onet_tpu/ops/pallas_conv.py:
//   _fwd_kernel  (:212, via conv3x3_wp_raw)   y = conv(x, w)
//   _fwd2_kernel (:259, via conv3x3_wp2_raw)  y = conv(xa, wa) + conv(xb, wb)
// each with the optional bias+ReLU store epilogue (serving) and the optional
// BatchNorm-statistics epilogue (training): per-sample lane sums s1, s2
// [n][128] of the f32 value after bias/ReLU and before the cast, lane
// (w%2)*64 + c, taken from the accumulator so no pass re-reads y.
//
// Layout. The packed tensor [N, H, W/2, 128] (lane = (w%2)*64 + c) is, byte
// for byte, the per-branch NHWC tensor [N, H, W, 64]. The TPU kernel needed
// the packing to fill 128-lane tiles, and paid for it with 6 [m,128]x[128,128]
// products per kernel row of which 25% multiply structural zeros. Here the
// kernel reads the unpacked view and runs the 9 real 64x64 taps: every
// multiply is useful. The wrapper passes the taps [3][3][64][64] (HWIO),
// sliced from Wc, whose blocks hold all nine.
//
// What bounds it on the H100. At the training shape (N=16 packed samples,
// 512x512, bf16, stats) one conv is 0.31 TFLOP against 1.07 GB of input and
// output: 0.313 ms of tensor-core time at 989 TFLOP/s and 0.321 ms of HBM
// time at 3.35 TB/s; with two inputs 0.625 ms of operations against 0.481 ms
// of bytes; at the serving shape (N=64) four times that. Both limits sit
// close together, so every x byte is read once from HBM and loads, products
// and the epilogue overlap. The bf16 kernels share:
//   * work: the image rows of every 64-pixel column strip, strip after
//     strip, numbered g = (b * strips + strip) * H + r; persistent CTAs,
//     one per SM, each take an equal contiguous range of g (no wave tail)
//     and walk it as segments, a segment being the part of the range that
//     lies in one strip. A right-edge strip narrower than 64 pixels and the
//     image's top and bottom rows are masked by zero-filled loads (SAME
//     padding) and masked stores, so any H and any W = 2 Wp work;
//   * loads: cp.async (16 bytes, zero-fill through the source-size operand
//     outside the image) into a ring in shared memory of x rows of 66
//     pixels (the +-1 halo), 8,448 bytes each. Each x row is fetched once
//     from HBM and serves the three dr taps of three output rows. One
//     commit group per output row, XR - 3 of them in flight while a row
//     multiplies. The 128-byte pixel rows are XOR-swizzled as the tensor
//     cores' 128-byte swizzle has it (16-byte chunk ^ bits 7..9 of the
//     shared address), so the pixel shift dc of a tap is a descriptor that
//     starts dc * 128 bytes on, with no copy (the tensor cores swizzle by
//     the absolute address, as conv_wp_dw.cu found);
//   * products: wgmma m64n64k16, D[co][pixel] for one output row of the
//     strip: M = the 64 co, N = the 64 pixels, K = 9 taps x 64 ci an input,
//     f32 accumulators (32 a thread). B, the shifted x rows, is read
//     K-major from the ring. Two warpgroups split K in halves: with one
//     input each takes 18 of the 36 k16 steps, with two each takes one
//     input. co as M leaves N to the pixels, where the strip can grow, and
//     lets A (the taps) come from registers;
//   * statistics: a thread sums its f32 values and their squares by channel
//     and pixel parity in registers over the rows of its range; when the
//     range moves to another sample, and at its end, the CTA meets them in
//     shared memory and writes one [256] partial (s1 lanes, then s2 lanes)
//     for that sample. A partial never spans two samples. The reduce kernel
//     sums each sample's partials in CTA order: the same inputs give the
//     same bits, run to run (no atomics).
// One input (conv_wp_bf16_1in, 384 threads: 6 of the 7 launches of a train
// step, 2 of the 3 of a served batch): warp-specialized. Warpgroups 0 and 1
// hold their 18 steps' taps in registers for the kernel's life (72 a
// thread: A from registers halves the shared-memory reads of an n64
// product, 2 KB a step instead of 4), load the ring (XR = 12 rows) and
// multiply; after each row they write their f32 partials to a double
// buffer in shared memory and go on to the next row, while warpgroup 2
// sums the two partials and runs the epilogue (bias, ReLU, statistics, the
// cast, 16-byte coalesced stores: the strip's pixels of an output row are
// contiguous in y). Named barriers pair them. Shared memory: 101,376 B of
// ring + 65,536 B of partials + 4,096 B for the statistics = 171,008 B;
// ptxas: 168 registers (the cap of 384 threads), no spills.
// Two inputs (conv_wp_bf16_2in, 256 threads): both inputs' taps, 147,456 B,
// stay in shared memory as A (in registers they would take 144 a thread),
// which leaves room for 4 ring rows of each input (67,584 B) and one 16 KB
// buffer, so the two warpgroups swap halves of their partials through it
// (each ends with 32 of the 64 pixels summed) and run the epilogue
// themselves, through the same buffer as a staging area. 231,424 B of the
// 232,448 a block may have; ptxas: 244 registers, no spills.
// Not mma.sync through ldmatrix: with 16 pixels a warp, every warp re-reads
// a tap's 64 co each k16 step, and shared-memory reads bound it at 2.5x
// this kernel's time (PERF.md, PR 6).
//
// f32 inputs take a CUDA-core path (one thread per output pixel, 64 f32
// accumulators, weights read through the read-only cache, 8-row x 32-pixel
// tiles staged by synchronous loads, per-tile partials): it exists for the
// float32 policy's exactness, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;             // channels per branch at the packed levels
constexpr int NSTAT = 4 * C;      // s1 lanes, s2 lanes

struct Args {
  const void* x[2];     // inputs, NHWC [n, h, w, 64]
  const void* taps[2];  // [3][3][64][64] HWIO, inputs' dtype
  const float* bias;    // [128] packed lanes (parity * 64 + c); read if relu
  void* y;              // NHWC [n, h, w, 64]
  float* part;          // stats partials (stats only)
  int n, h, w;          // unpacked geometry: w = 2 * Wp
  int nin, relu, out_bf16, stats;
};

__device__ __forceinline__ float epilogue(float v, float b, int relu) {
  return relu ? fmaxf(v + b, 0.f) : v;
}

__device__ __forceinline__ void store8(void* y, size_t off, const float* v,
                                       int out_bf16) {
  if (out_bf16) {
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(y) + off) =
        *reinterpret_cast<const uint4*>(o);
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(y) + off);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ---------------------------------------------------------------------------
// bf16: cp.async row ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int SW = 64;                  // strip width, pixels
constexpr int PIX = C * 2;              // bytes of one bf16 pixel, tap row
constexpr int XROW = (SW + 2) * PIX;    // bytes of one staged x row: 8,448
constexpr int TAP = C * PIX;            // bytes of one tap [co][ci]: 8,192
constexpr int B_THREADS = 256;          // two warpgroups
constexpr int ACC = 32;                 // f32 accumulators a thread
constexpr int HALF = ACC / 2;           // of them handed to the other group
constexpr int XCH = 2 * HALF * 128 * 4;  // exchange and staging bytes

// Two inputs (conv_wp_bf16_2in): both inputs' taps, 147,456 bytes, stay in
// shared memory as the A operand (in registers they would take 144 a
// thread), and the ring takes 4 rows of each input.
constexpr int XR2 = 4;                    // x rows of each input
constexpr int DEPTH2 = XR2 - 3;           // commit groups in flight
constexpr int TAPS2 = 2 * 9 * TAP;
constexpr int SMEM2 = TAPS2 + 2 * XR2 * XROW + XCH;
static_assert(SMEM2 <= 232448, "227 KB of shared memory a block");

// Partials a CTA writes: one for each sample its range of strip rows meets.
// A range of at most `len` rows meets at most ceil((len - 1) / per_b) + 1
// samples of per_b rows each.
__host__ __device__ __forceinline__ int range_slots(int total, int nblk,
                                                    int per_b) {
  const int len = total / nblk + (total % nblk > 0);
  return (len - 1 + per_b - 1) / per_b + 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared address of 16-byte chunk v of the 128-byte row at shared address
// `row` (128-byte aligned): the chunk index XOR bits 7..9 of the address,
// the 128-byte swizzle of the tensor cores' shared-memory operands.
__device__ __forceinline__ uint32_t swz(uint32_t row, int v) {
  return row + ((v ^ ((row >> 7) & 7)) << 4);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle starting at
// shared address `addr`: rows of 64 bf16 (one pixel) 128 bytes apart, 8 rows
// a 1024-byte swizzle atom (stride 1024); the leading offset is unused.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

#define ACC8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[32] += A B, m64n64k16, bf16 in, f32 accumulate: A (64 co x 16 ci) from
// registers, B (16 ci x 64 pixels) K-major in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[ACC],
                                          const uint32_t (&a)[4], uint64_t b) {
  // scale-d is a predicate operand: set true, D += A B
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The same with A (64 co x 16 ci) K-major in shared memory.
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[ACC], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b));
}

#undef ACC8

__device__ __forceinline__ void st_shared16(uint32_t addr, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Issue the copies of image row r (zero outside 0..h-1) of the strip at
// pixel c0, with the halo (pixels c0-1 .. c0+SW), into the ring row `dst`.
// Called by threads 0 .. B_THREADS-1 (both warpgroups of 2in, the product
// warpgroups of 1in).
__device__ __forceinline__ void load_row(uint32_t dst,
                                         const __nv_bfloat16* __restrict__ src,
                                         int b, int r, int c0, int h, int w) {
  const bool row_ok = r >= 0 && r < h;
  const __nv_bfloat16* row = src + ((size_t)b * h + (row_ok ? r : 0)) * w * C;
  for (int i = threadIdx.x; i < (SW + 2) * 8; i += B_THREADS) {
    const int q = i >> 3, v = i & 7;
    const int c = c0 - 1 + q;
    const bool ok = row_ok && c >= 0 && c < w;
    cp_async16(swz(dst + q * PIX, v), ok ? row + (size_t)c * C + v * 8 : src,
               ok);
  }
}

// k16 step s of the 36 of an output row of one input: tap s / 4 =
// 3 dr + dc, ci 16 (s % 4) .. 16 (s % 4) + 15.
struct Step {
  int dr, dc, ks;
};

__device__ __forceinline__ Step step_of(int s) {
  Step t;
  t.dr = s / 12;
  t.dc = (s >> 2) - 3 * t.dr;
  t.ks = s & 3;
  return t;
}

// Both inputs' taps, HWIO [tap][ci][co] in global memory, into shared
// memory at `dst` as [in][tap][co][ci] (K-major) in the swizzle. A thread
// gathers 8 ci of one co (lanes on neighbouring co: coalesced) into one
// 16-byte store.
__device__ void load_taps(uint32_t dst, const Args& a) {
  for (int i = threadIdx.x; i < 2 * 9 * C * 8; i += B_THREADS) {
    const int co = i % C, v = (i / C) % 8, it = i / (C * 8);
    const unsigned short* src =
        static_cast<const unsigned short*>(it < 9 ? a.taps[0] : a.taps[1]) +
        ((size_t)(it % 9) * C + v * 8) * C + co;
    uint32_t k[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      k[e] = (uint32_t)__ldg(src + 2 * e * C) |
             (uint32_t)__ldg(src + (2 * e + 1) * C) << 16;
    st_shared16(swz(dst + it * TAP + co * PIX, v), k[0], k[1], k[2], k[3]);
  }
}

// Issue warpgroup WG's wgmma of output row offset j (ring offsets j .. j+2)
// of one input into acc and commit them: D[co][pixel] += taps x shifted x
// rows over its 18 k16 steps, its taps (A) in registers. Taps, shifts and
// k offsets are constants; a descriptor is linear in the address, so each
// is a ring row's plus a constant.
template <int WG, int XR>
__device__ __forceinline__ void issue_row_1in(float (&acc)[ACC],
                                              const uint32_t (&wa)[18][4],
                                              uint32_t xring, int j) {
  uint64_t rows[3];
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
    rows[dr] = desc(xring + (j + dr) % XR * XROW);
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    const Step st = step_of(WG * 18 + i);
    wgmma_n64(acc, wa[i],
              rows[st.dr] + ((st.dc * PIX + st.ks * 32) >> 4));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The same for input wg of two, both operands in shared memory: the taps
// at `taps`, the 4-row ring of input wg at xring + wg * 4 rows. One code
// path for both groups (a branch around wgmma makes ptxas serialize them).
__device__ __forceinline__ void issue_row_2in(float (&acc)[ACC],
                                              uint32_t xring, uint32_t taps,
                                              int j, int wg) {
  uint64_t rows[3];
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
    rows[dr] = desc(xring + (wg * XR2 + (j + dr) % XR2) * XROW);
  const uint64_t tp = desc(taps + wg * 9 * TAP);
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 36; ++i) {
    const Step st = step_of(i);
    wgmma_n64_ss(acc, tp + (((3 * st.dr + st.dc) * TAP + st.ks * 32) >> 4),
                 rows[st.dr] + ((st.dc * PIX + st.ks * 32) >> 4));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(B_THREADS, 1)
conv_wp_bf16_2in(const Args a) {
  constexpr int XR = XR2, DEPTH = DEPTH2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t taps = smem_addr(smem);
  const uint32_t xring = taps + TAPS2;
  float* xch = reinterpret_cast<float*>(smem + TAPS2 + 2 * XR * XROW);
  unsigned char* stage = reinterpret_cast<unsigned char*>(xch);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int wi = t >> 5, lane = tid & 31;
  const __nv_bfloat16* xg[2] = {static_cast<const __nv_bfloat16*>(a.x[0]),
                                static_cast<const __nv_bfloat16*>(a.x[1])};

  const int cr = 16 * wi + (lane >> 2);
  load_taps(taps, a);  // visible to the tensor cores after the first
                       // row's fence and barrier

  // after the exchange a thread holds pixels px0 + 8 jj + (e & 1) of the
  // strip, jj < 4, and co cr + 8 (e >> 1); the parity of a pixel is e & 1
  // (the strip starts at an even pixel)
  const int px0 = 32 * wg + 2 * (lane & 3);
  float bias[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    bias[e] = a.relu ? __ldg(a.bias + (e & 1) * C + cr + 8 * (e >> 1)) : 0.f;

  // strip rows numbered in 32 bits (the host checks the count fits)
  const int h = a.h, w = a.w;
  const int strips = (w + SW - 1) / SW, per_b = strips * h;
  const int total = a.n * per_b;
  const int q = total / gridDim.x, rem = total % gridDim.x;
  const int bid = blockIdx.x;
  int g = bid * q + min(bid, rem);
  const int g_end = g + q + (bid < rem);
  const int nslot = range_slots(total, gridDim.x, per_b);
  const int b_first = g / per_b;
  int b_cur = b_first;
  float s1[4], s2[4];  // by e: co cr + 8 (e >> 1), parity e & 1
#pragma unroll
  for (int e = 0; e < 4; ++e) s1[e] = s2[e] = 0.f;

  const int osz = a.out_bf16 ? 2 : 4;
  const int lg = a.out_bf16 ? 3 : 4, cpp = 1 << lg;  // 16-byte chunks a pixel

  // Output row r of image b, strip c0, from acc (its wgmma waited for):
  // acc[4 jb + e] holds co cr + 8 (e >> 1), pixel 8 jb + 2 (lane % 4) +
  // (e & 1). Group wg keeps pixels 32 wg .. 32 wg + 31, acc[16 wg ..], and
  // hands the other 16 over; then bias, ReLU, stats, the cast, and the row
  // through the staging buffer to y.
  auto finish = [&](const float (&acc)[ACC], int b, int r, int c0) {
    float v[HALF];
#pragma unroll
    for (int k = 0; k < HALF; ++k)
      xch[(wg * HALF + k) * 128 + t] = wg ? acc[k] : acc[HALF + k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < HALF; ++k)
      v[k] = (wg ? acc[HALF + k] : acc[k]) +
             xch[((1 - wg) * HALF + k) * 128 + t];
    __syncthreads();  // xch is free: the staging buffer
    // v[4 jj + e]: pixel px0 + 8 jj + (e & 1), co cr + 8 (e >> 1); stage
    // the row [64 pixels][64 co], 16-byte chunks swizzled by pixel
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const int e = k & 3, m = px0 + 8 * (k >> 2) + (e & 1);
      if (a.relu) v[k] = fmaxf(v[k] + bias[e], 0.f);
      if (a.stats && c0 + m < w) {
        s1[e] += v[k];
        s2[e] += v[k] * v[k];
      }
      const int off = (cr + 8 * (e >> 1)) * osz;
      unsigned char* p =
          stage + m * cpp * 16 + (((off >> 4) ^ (m & 7)) << 4) + (off & 15);
      if (a.out_bf16)
        *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v[k]);
      else
        *reinterpret_cast<float*>(p) = v[k];
    }
    __syncthreads();
    // the strip's pixels of an output row are contiguous in y
    unsigned char* yrow = static_cast<unsigned char*>(a.y) +
                          (((size_t)b * h + r) * w + c0) * C * osz;
    for (int i = tid; i < SW * cpp; i += B_THREADS) {
      const int m = i >> lg, c = i & (cpp - 1);
      if (c0 + m < w)
        *reinterpret_cast<uint4*>(yrow + (size_t)i * 16) =
            *reinterpret_cast<const uint4*>(stage + m * cpp * 16 +
                                            ((c ^ (m & 7)) << 4));
    }
  };

  float acc[ACC];
  for (;;) {
    const bool done = g >= g_end;
    if (a.stats && (done || g / per_b != b_cur)) {
      // this CTA's partial of sample b_cur: the 4 lanes of a channel row
      // meet by shuffles, the warpgroups in shared memory
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], 1);
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], 2);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], 1);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], 2);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lanev = (e & 1) * C + cr + 8 * (e >> 1);
          xch[wg * NSTAT + lanev] = s1[e];
          xch[wg * NSTAT + 2 * C + lanev] = s2[e];
        }
      }
      __syncthreads();
      a.part[((size_t)bid * nslot + (b_cur - b_first)) * NSTAT + tid] =
          xch[tid] + xch[NSTAT + tid];
#pragma unroll
      for (int e = 0; e < 4; ++e) s1[e] = s2[e] = 0.f;
      b_cur = g / per_b;
      __syncthreads();  // xch is the next row's exchange
    }
    if (done) break;
    // one segment: rows ra .. rb-1 of strip s of image b
    const int bs = g / h;
    const int ra = g - bs * h;
    const int rb = min(g_end - bs * h, h);
    const int b = bs / strips, c0 = (bs - b * strips) * SW;
    const int len = rb - ra;
    // ring offset o holds image row ra - 1 + o of every input
    auto load = [&](int o) {
#pragma unroll
      for (int in = 0; in < 2; ++in)
        load_row(xring + (in * XR + o % XR) * XROW, xg[in], b, ra - 1 + o, c0,
                 h, w);
    };
    // prologue: group k holds offset k + 2, group 0 also offsets 0 and 1
    load(0);
    load(1);
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if (k < len) load(k + 2);
      cp_commit();
    }

    for (int j = 0; j < len; ++j) {
      cp_wait<DEPTH - 1>();  // group j has landed, for this thread;
      // make it visible to the tensor cores (the async proxy) ...
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // ... for all threads; row j-1's wgmma are done
      if (j + DEPTH < len) load(j + DEPTH + 2);
      cp_commit();
      issue_row_2in(acc, xring, taps, j, wg);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < ACC; ++k) asm volatile("" : "+f"(acc[k])::"memory");
      finish(acc, b, ra + j, c0);
    }
    __syncthreads();  // the next segment's prologue refills the ring
    g += len;
  }
}

// One input, warp-specialized (the design is in the note at the top):
// warpgroups 0 and 1 load and multiply, warpgroup 2 runs the epilogue.
// Named barriers pair them up; bar 0 (__syncthreads) is not used.
constexpr int WS_THREADS = 384;
constexpr int WS_XR = 12;                    // x rows in the ring
constexpr int WS_DEPTH = WS_XR - 3;          // commit groups in flight
constexpr int PART_F = SW * C;               // floats of one partial
constexpr int WS_SMEM = WS_XR * XROW + 4 * PART_F * 4 + 4 * NSTAT * 4;
static_assert(WS_SMEM <= 232448, "227 KB of shared memory a block");
enum { BAR_MMA = 1, BAR_READY = 2, BAR_FREE = 4, BAR_EPI = 6 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Float offset of (pixel m, channel co) in a [64][64] f32 partial: 16-byte
// chunks XOR the pixel's low 3 bits, so the product warps' scattered
// writes and the epilogue's 16-byte reads meet few bank conflicts.
__device__ __forceinline__ int part_off(int m, int co) {
  return m * C + ((((co >> 2) ^ (m & 7))) << 2) + (co & 3);
}

__global__ void __launch_bounds__(WS_THREADS, 1)
conv_wp_bf16_1in(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t xring = smem_addr(smem);
  float* pbuf = reinterpret_cast<float*>(smem + WS_XR * XROW);
  float* red = pbuf + 4 * PART_F;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int wi = (tid >> 5) & 3;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x[0]);

  const int h = a.h, w = a.w;
  const int strips = (w + SW - 1) / SW, per_b = strips * h;
  const int total = a.n * per_b;
  const int q = total / gridDim.x, rem = total % gridDim.x;
  const int bid = blockIdx.x;
  const int g_begin = bid * q + min(bid, rem);
  const int g_end = g_begin + q + (bid < rem);

  if (wg < 2) {
    // products: the taps of this group's 18 k16 steps in registers, as in
    // conv_wp_bf16<1>
    const int cr = 16 * wi + (lane >> 2);
    uint32_t wa[18][4];
#pragma unroll
    for (int i = 0; i < 18; ++i) {
      const Step st = step_of(wg * 18 + i);
      const unsigned short* p =
          static_cast<const unsigned short*>(a.taps[0]) +
          ((size_t)(3 * st.dr + st.dc) * C + 16 * st.ks + 2 * (lane & 3)) *
              C + cr;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned short* qq = p + (r >> 1) * 8 * C + (r & 1) * 8;
        wa[i][r] = (uint32_t)__ldg(qq) | (uint32_t)__ldg(qq + C) << 16;
      }
    }
    float acc[ACC];
    int n = 0;  // rows of this CTA so far
    for (int g = g_begin; g < g_end;) {
      const int bs = g / h;
      const int ra = g - bs * h;
      const int len = min(g_end - bs * h, h) - ra;
      const int b = bs / strips, c0 = (bs - b * strips) * SW;
      auto load = [&](int o) {
        load_row(xring + (o % WS_XR) * XROW, x, b, ra - 1 + o, c0, h, w);
      };
      bar_sync(BAR_MMA, 256);  // the last segment's wgmma are done
      load(0);
      load(1);
#pragma unroll
      for (int k = 0; k < WS_DEPTH; ++k) {
        if (k < len) load(k + 2);
        cp_commit();
      }
      for (int j = 0; j < len; ++j, ++n) {
        cp_wait<WS_DEPTH - 1>();  // group j has landed, for this thread;
        // make it visible to the tensor cores (the async proxy) ...
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_sync(BAR_MMA, 256);  // ... for both groups; row j-1's are done
        if (j + WS_DEPTH < len) load(j + WS_DEPTH + 2);
        cp_commit();
        if (wg)
          issue_row_1in<1, WS_XR>(acc, wa, xring, j);
        else
          issue_row_1in<0, WS_XR>(acc, wa, xring, j);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < ACC; ++k)
          asm volatile("" : "+f"(acc[k])::"memory");
        // acc[4 jb + e]: co cr + 8 (e >> 1), pixel 8 jb + 2 (lane % 4) +
        // (e & 1), into buffer n % 2 once the epilogue has read row n - 2
        if (n >= 2) bar_sync(BAR_FREE + (n & 1), WS_THREADS);
        float* p = pbuf + ((n & 1) * 2 + wg) * PART_F;
#pragma unroll
        for (int k = 0; k < ACC; ++k)
          p[part_off(8 * (k >> 2) + 2 * (lane & 3) + (k & 1),
                     cr + 8 * ((k >> 1) & 1))] = acc[k];
        bar_arrive(BAR_READY + (n & 1), WS_THREADS);
      }
      g += len;
    }
    // match the epilogue's last releases
    for (int k = n > 2 ? n - 2 : 0; k < n; ++k)
      bar_sync(BAR_FREE + (k & 1), WS_THREADS);
    return;
  }

  // epilogue: thread e takes channels 8 cg .. 8 cg + 7 of pixels e / 8 +
  // 16 i, all of parity par
  const int e = tid - 256, cg = e & 7, par = (e >> 3) & 1;
  const int ew = e >> 5;  // warp of the group
  float bias[8], s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bias[i] = a.relu ? __ldg(a.bias + par * C + 8 * cg + i) : 0.f;
    s1[i] = s2[i] = 0.f;
  }
  const int nslot = range_slots(total, gridDim.x, per_b);
  const int b_first = g_begin / per_b;
  int b_cur = b_first, n = 0;
  const int osz = a.out_bf16 ? 2 : 4;
  for (int g = g_begin;;) {
    const bool done = g >= g_end;
    if (a.stats && (done || g / per_b != b_cur)) {
      // this CTA's partial of sample b_cur: the two threads of a class in a
      // warp meet by a shuffle, the four warps in shared memory
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 16);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 16);
      }
      if (lane < 16) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          red[ew * NSTAT + par * C + 8 * cg + i] = s1[i];
          red[ew * NSTAT + 2 * C + par * C + 8 * cg + i] = s2[i];
        }
      }
      bar_sync(BAR_EPI, 128);
      float* out = a.part + ((size_t)bid * nslot + (b_cur - b_first)) * NSTAT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = e + 128 * half;
        out[v] = red[v] + red[NSTAT + v] + red[2 * NSTAT + v] +
                 red[3 * NSTAT + v];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
      b_cur = g / per_b;
      bar_sync(BAR_EPI, 128);  // red is rewritten by the next flush
    }
    if (done) break;
    const int bs = g / h;
    const int ra = g - bs * h;
    const int len = min(g_end - bs * h, h) - ra;
    const int b = bs / strips, c0 = (bs - b * strips) * SW;
    for (int j = 0; j < len; ++j, ++n) {
      bar_sync(BAR_READY + (n & 1), WS_THREADS);
      const float* p0 = pbuf + (n & 1) * 2 * PART_F;
      const float* p1 = p0 + PART_F;
      unsigned char* yrow = static_cast<unsigned char*>(a.y) +
                            (((size_t)b * h + ra + j) * w + c0) * C * osz;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (e >> 3) + 16 * i;
        const int o0 = part_off(m, 8 * cg), o1 = part_off(m, 8 * cg + 4);
        const float4 u0 = *reinterpret_cast<const float4*>(p0 + o0);
        const float4 u1 = *reinterpret_cast<const float4*>(p0 + o1);
        const float4 w0 = *reinterpret_cast<const float4*>(p1 + o0);
        const float4 w1 = *reinterpret_cast<const float4*>(p1 + o1);
        float v[8] = {u0.x + w0.x, u0.y + w0.y, u0.z + w0.z, u0.w + w0.w,
                      u1.x + w1.x, u1.y + w1.y, u1.z + w1.z, u1.w + w1.w};
        const bool inside = c0 + m < w;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (a.relu) v[k] = fmaxf(v[k] + bias[k], 0.f);
          if (a.stats && inside) {
            s1[k] += v[k];
            s2[k] += v[k] * v[k];
          }
        }
        if (inside) store8(yrow, (size_t)m * C + 8 * cg, v, a.out_bf16);
      }
      bar_arrive(BAR_FREE + (n & 1), WS_THREADS);
    }
    g += len;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, exact float32 products
// ---------------------------------------------------------------------------

constexpr int TH = 8;             // output rows per tile
constexpr int TW = 32;            // output pixels per tile row
constexpr int THREADS = 32 * TH;
constexpr int SROWS = TH + 2;     // window rows incl. halo
constexpr int SCOLS = TW + 2;     // window pixels per row incl. halo
constexpr int XS_F = 68;          // f32 window pixel stride (elements)
constexpr int X_BYTES_F = SROWS * SCOLS * XS_F * 4;    // f32 window
constexpr int RED_BYTES = TH * NSTAT * 4;              // per-row partials

struct Tile {
  int b, r0, c0;
};

__device__ __forceinline__ Tile tile_of(long t, const Args& a) {
  const int tw = (a.w + TW - 1) / TW;
  const int th = (a.h + TH - 1) / TH;
  Tile s;
  s.c0 = (int)(t % tw) * TW;
  s.r0 = (int)((t / tw) % th) * TH;
  s.b = (int)(t / ((long)tw * th));
  return s;
}

// Stage the (TH+2) x (TW+2) window of image b around the tile, zero outside.
template <typename T, int XS>
__device__ void load_window(T* xs, const T* __restrict__ x, const Tile& t,
                            int h, int w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = C / VEC;
  for (int i = threadIdx.x; i < SROWS * SCOLS * CHUNKS; i += THREADS) {
    const int v = i % CHUNKS;
    const int p = i / CHUNKS;
    const int sc = p % SCOLS, sr = p / SCOLS;
    const int gr = t.r0 - 1 + sr, gc = t.c0 - 1 + sc;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      val = __ldg(reinterpret_cast<const uint4*>(
          x + ((((size_t)t.b * h + gr) * w + gc) * C + v * VEC)));
    *reinterpret_cast<uint4*>(xs + (sr * SCOLS + sc) * XS + v * VEC) = val;
  }
}

// The 8 warps' [256] partials in `red` -> one tile partial, summed in warp
// order. Call with every thread of the CTA after the warps wrote `red`.
__device__ __forceinline__ void tile_stats(const float* red, float* part,
                                           long tile) {
  __syncthreads();
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < TH; ++k) v += red[k * NSTAT + threadIdx.x];
  part[tile * NSTAT + threadIdx.x] = v;
}

__global__ void __launch_bounds__(THREADS)
conv_wp_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + X_BYTES_F);
  const int row = threadIdx.x / TW, px = threadIdx.x % TW;

  const long tiles = (long)a.n * ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, a);
    float acc[C];
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = 0.f;

    for (int in = 0; in < a.nin; ++in) {
      load_window<float, XS_F>(xs, static_cast<const float*>(a.x[in]), t,
                               a.h, a.w);
      __syncthreads();
      const float* wi = static_cast<const float*>(a.taps[in]);
      for (int dr = 0; dr < 3; ++dr) {
        for (int dc = 0; dc < 3; ++dc) {
          const float* xp = xs + ((row + dr) * SCOLS + px + dc) * XS_F;
          const float* wt = wi + (dr * 3 + dc) * C * C;
          for (int c4 = 0; c4 < C / 4; ++c4) {
            const float4 xv = *reinterpret_cast<const float4*>(xp + c4 * 4);
            const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4* wr =
                  reinterpret_cast<const float4*>(wt + (c4 * 4 + q) * C);
#pragma unroll
              for (int o4 = 0; o4 < C / 4; ++o4) {
                const float4 wv = __ldg(wr + o4);
                acc[o4 * 4 + 0] = fmaf(xq[q], wv.x, acc[o4 * 4 + 0]);
                acc[o4 * 4 + 1] = fmaf(xq[q], wv.y, acc[o4 * 4 + 1]);
                acc[o4 * 4 + 2] = fmaf(xq[q], wv.z, acc[o4 * 4 + 2]);
                acc[o4 * 4 + 3] = fmaf(xq[q], wv.w, acc[o4 * 4 + 3]);
              }
            }
          }
        }
      }
      __syncthreads();   // window is reloaded by the next input or tile
    }

    const int r = t.r0 + row, col = t.c0 + px;
    const bool inside = r < a.h && col < a.w;
    const float* bp = a.bias + (col & 1) * C;
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = epilogue(acc[o], bp[o], a.relu);
    if (inside) {
      const size_t base = (((size_t)t.b * a.h + r) * a.w + col) * C;
#pragma unroll
      for (int o = 0; o < C; o += 8) store8(a.y, base + o, acc + o, a.out_bf16);
    }
    if (a.stats) {
      // lanes of one parity (px & 1; c0 is even) meet by butterfly; lanes
      // 0 and 1 then hold the row's parity-0 and parity-1 sums
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int o = 0; o < C; ++o) {
        float v1 = inside ? acc[o] : 0.f;
        float v2 = v1 * v1;
#pragma unroll
        for (int d = 2; d < 32; d <<= 1) {
          v1 += __shfl_xor_sync(0xffffffffu, v1, d);
          v2 += __shfl_xor_sync(0xffffffffu, v2, d);
        }
        if (lane < 2) {
          red[row * NSTAT + lane * C + o] = v1;
          red[row * NSTAT + 2 * C + lane * C + o] = v2;
        }
      }
      tile_stats(red, a.part, tile);
      __syncthreads();   // red is rewritten by the next tile
    }
  }
}

// Per-sample sums of the tile partials, in tile order (deterministic).
// grid (n, NSTAT / 32), 256 threads: 8 phases of 32 values each.
__global__ void __launch_bounds__(THREADS)
stats_reduce(const float* __restrict__ part, float* s1, float* s2, int tps) {
  __shared__ float ph_sum[8][32];
  const int lane = threadIdx.x % 32, ph = threadIdx.x / 32;
  const int v = blockIdx.y * 32 + lane;
  const float* p = part + (size_t)blockIdx.x * tps * NSTAT + v;
  float acc = 0.f;
  for (int t = ph; t < tps; t += 8) acc += p[(size_t)t * NSTAT];
  ph_sum[ph][lane] = acc;
  __syncthreads();
  if (ph == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += ph_sum[k][lane];
    float* out = v < 2 * C ? s1 : s2;
    out[(size_t)blockIdx.x * 2 * C + (v % (2 * C))] = s;
  }
}

// Per-sample sums of conv_wp_bf16's partials: sample b's are those of the
// CTAs whose row ranges meet it, summed in CTA order (deterministic).
// grid n, NSTAT threads, one value each.
__global__ void __launch_bounds__(NSTAT)
stats_reduce_ranges(const float* __restrict__ part, float* s1, float* s2,
                    int per_b, int total, int nblk) {
  const int b = blockIdx.x, v = threadIdx.x;
  const int q = total / nblk, rem = total % nblk;
  const int nslot = range_slots(total, nblk, per_b);
  auto cta_of = [&](int g) {
    return g < rem * (q + 1) ? g / (q + 1) : rem + (g - rem * (q + 1)) / q;
  };
  float acc = 0.f;
  const int last = cta_of(b * per_b + per_b - 1);
  for (int c = cta_of(b * per_b); c <= last; ++c) {
    const int start = c * q + min(c, rem);
    acc += part[((size_t)c * nslot + b - start / per_b) * NSTAT + v];
  }
  (v < 2 * C ? s1 : s2)[(size_t)b * 2 * C + v % (2 * C)] = acc;
}

}  // namespace

// Set up the kernel of (nin, dtype) on the current device: its shared-memory
// attribute, and the launch geometry at this shape. Returns the grid (CTAs)
// a launch uses and writes to *nparts the number of [256] f32 stats
// partials it needs: the wrapper allocates them and calls this once per
// (device, shape, nin, dtype). Negative: -(CUDA error).
extern "C" int onet_conv3x3_wp_setup(int n, int h, int w, int nin,
                                     int in_bf16, int* nparts) {
  if (nin < 1 || nin > 2) return -(int)cudaErrorInvalidValue;
  const void* kern;
  int smem, threads;
  if (in_bf16) {
    kern = nin == 1 ? (const void*)conv_wp_bf16_1in
                    : (const void*)conv_wp_bf16_2in;
    smem = nin == 1 ? WS_SMEM : SMEM2;
    threads = nin == 1 ? WS_THREADS : B_THREADS;
  } else {
    kern = (const void*)conv_wp_f32;
    smem = X_BYTES_F + RED_BYTES;
    threads = THREADS;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  // bf16: CTAs over the strip rows, one partial per sample a range meets;
  // f32: CTAs over the 8x32 tiles, one partial per tile
  const long strips = (w + SW - 1) / SW;
  const long work = in_bf16 ? n * strips * h
                            : (long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  // the bf16 kernel numbers the strip rows with 32-bit ints
  if (in_bf16 && work > INT32_MAX) return -(int)cudaErrorInvalidValue;
  const long max_grid = (long)sms * per_sm;
  const int grid = (int)(max_grid < work ? max_grid : work);
  *nparts = grid == 0 ? 0
          : in_bf16 ? grid * range_slots((int)work, grid, (int)(strips * h))
                    : (int)work;
  return grid;
}

// Launch on `stream` with the grid `nblk` from onet_conv3x3_wp_setup; returns
// the CUDA error code (0 on success). Pointers must be 16-byte aligned and
// the tensors contiguous; the wrapper checks. bias is read only with relu.
// With stats, `part` holds that call's nparts * 256 floats of scratch and
// s1, s2 receive [n][128] each. No host query: the set-up call made the
// kernel launchable.
extern "C" int onet_conv3x3_wp(const void* xa, const void* xb,
                               const void* wa, const void* wb,
                               const float* bias, void* y, float* part,
                               float* s1, float* s2, int n, int h, int w,
                               int nin, int in_bf16, int out_bf16, int relu,
                               int stats, int nblk, void* stream) {
  if (nin < 1 || nin > 2) return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = xa;
  a.x[1] = xb;
  a.taps[0] = wa;
  a.taps[1] = wb;
  a.bias = bias;
  a.y = y;
  a.part = part;
  a.n = n;
  a.h = h;
  a.w = w;
  a.nin = nin;
  a.relu = relu;
  a.out_bf16 = out_bf16;
  a.stats = stats;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nblk == 0) {  // no pixels: the sums are zero
    if (stats && n > 0) {
      if ((err = cudaMemsetAsync(s1, 0, n * 2 * C * 4, st)) != cudaSuccess)
        return (int)err;
      return (int)cudaMemsetAsync(s2, 0, n * 2 * C * 4, st);
    }
    return (int)cudaSuccess;
  }
  if (!in_bf16)
    conv_wp_f32<<<nblk, THREADS, X_BYTES_F + RED_BYTES, st>>>(a);
  else if (nin == 1)
    conv_wp_bf16_1in<<<nblk, WS_THREADS, WS_SMEM, st>>>(a);
  else
    conv_wp_bf16_2in<<<nblk, B_THREADS, SMEM2, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || !stats) return (int)err;
  const int strips = (w + SW - 1) / SW;
  if (in_bf16)
    stats_reduce_ranges<<<n, NSTAT, 0, st>>>(part, s1, s2, strips * h,
                                             n * strips * h, nblk);
  else
    stats_reduce<<<dim3((unsigned)n, NSTAT / 32), THREADS, 0, st>>>(
        part, s1, s2, ((h + TH - 1) / TH) * ((w + TW - 1) / TW));
  return (int)cudaGetLastError();
}
