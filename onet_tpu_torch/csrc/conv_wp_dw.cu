// Weight gradient of the pair-packed SAME 3x3 convolution, for sm_90a.
//
// Replaces the Pallas kernel _dw_kernel (via conv3x3_wp_dw) of
// onet_tpu/ops/pallas_conv.py:
//   dw[dr][dc][ci][co] = sum_{n,r,c} x[n, r+dr-1, c+dc-1, ci] * dy[n, r, c, co]
// with zeros outside the image, summed over the batch (the twin branches
// ride the batch, so weight sharing is automatic), f32 out.
//
// Layout. As in conv_wp.cu, the packed [N, H, W/2, 128] tensors are read as
// the NHWC [N, H, W, 64] tensors they are byte for byte. The TPU kernel
// formed the [128,128] quadrant products Gc = xc^T dy and Ge = ae^T dy, of
// which a quarter multiplies structural zeros, and assembled the taps from
// the quadrants afterwards. Here each of the 9 taps is one 64x64 product
// with K = the pixels: every multiply is useful.
//
// What bounds it on the H100. At the training shape (N=16 packed samples,
// 512x512) one call is 0.31 TFLOP against 1.07 GB of bf16 x and dy: 0.313
// ms of tensor-core time at 989 TFLOP/s and 0.321 ms of HBM time at
// 3.35 TB/s. The two bounds are nearly equal, so loads and products have to
// overlap. The bf16 design (dw_bf16):
//   * work: the image rows of every 64-pixel column strip, strip after
//     strip, numbered g = (b * strips + strip) * H + r; persistent CTAs,
//     one per SM, each take an equal contiguous range of g (no wave tail)
//     and walk it as segments, a segment being the part of the range that
//     lies in one strip. A right-edge strip narrower than 64 pixels and the
//     image's top and bottom rows are masked by zero-filled loads, so any H
//     and any W (a multiple of 4) work;
//   * loads: cp.async (16 bytes, zero-fill through the source-size operand
//     outside the image) into a ring in shared memory: STAGES = 4 dy rows of
//     64 pixels and STAGES + 2 = 6 x rows of 66 pixels (the +-1 halo). Each
//     x row is fetched once and serves the three dr taps of three output
//     rows. One commit group per output row; row j + 3 is in flight while
//     row j multiplies (cp.async.wait_group 2, one barrier per row). The
//     128-byte pixel rows are XOR-swizzled as the tensor cores' 128-byte
//     swizzle has it (16-byte chunk ^ bits 7..9 of the shared address);
//   * products: wgmma.mma_async m64n192k16 bf16 -> f32, both operands read
//     from shared memory through descriptors, MN-major (both transpose bits
//     set). Three warpgroups, one per dr. A = dy^T: M = the 64 co, K = 16
//     pixels. B = the shifted x views of the three dc taps side by side:
//     N = (dc, ci), the descriptor's leading byte offset (between 64-wide
//     blocks of N) one pixel row, 128 bytes, so block dc starts dc pixels
//     on. Since the swizzle follows the address bits, a view that starts
//     1, 2 or 3 rows past a 1024-byte boundary reads the right bytes with
//     no base offset. Four wgmma a row per warpgroup, one commit group,
//     waited for before the next row's barrier (the ring's next copies
//     overwrite the slots of the row before);
//   * registers: the m64n192 f32 tile, 96 a thread, is the accumulator;
//     nothing else of the product sits in registers. nvcc -Xptxas -v
//     (printed by chip_smoke.py): 168 registers, the cap for 384 threads
//     at one CTA per SM, and no spills;
//   * totals: the tensor cores add into the accumulator without rounding to
//     nearest (a bias of up to an ulp of the accumulator per step, 1.2e-5
//     of max|dw| over a CTA's ~2000 steps unflushed), so every FLUSH_ROWS =
//     16 rows (64 k16 steps, 1024 pixels) each thread adds its accumulators
//     into its own slots of the CTA's 9x64x64 f32 totals in shared memory
//     (147 KB; the ring takes the other 83 KB of the block's 227 KB) and
//     restarts them from zero;
//   * at the end each CTA stores its totals as its partial to a
//     [grid][9][64][64] buffer, and a second kernel, dw_reduce, sums the
//     partials in CTA order. Deterministic, where atomicAdd into dw would
//     not be; the partials are 19 MB at 132 CTAs, 2% of the call's bytes.
// The product is wgmma; an earlier version of this design fed mma.sync
// through ldmatrix and took 1.35x as long on the H100 (PERF.md).
//
// f32 inputs take a CUDA-core path (the float32 policy): 4-row x 32-pixel
// tiles staged by synchronous loads, one warp per tap; thread (tap, ci-group
// of 8, co-group of 16) keeps 128 f32 accumulators and does exact f32 FMAs;
// the same partials and reduce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;             // channels per branch at the packed levels
constexpr int TAPS = 9;
constexpr int PART = TAPS * C * C;  // floats of one CTA's partial

struct Args {
  const void* x;     // NHWC [n, h, w, 64]
  const void* dy;    // NHWC [n, h, w, 64]
  float* part;       // [gridDim.x][9][64][64]
  int n, h, w;
};

// ---------------------------------------------------------------------------
// bf16: cp.async ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int SW = 64;               // strip width, pixels
constexpr int STAGES = 4;            // dy rows in the ring
constexpr int XR = STAGES + 2;       // x rows in the ring
constexpr int PIX = C * 2;           // bytes of one bf16 pixel
constexpr int XROW = (SW + 2) * PIX;  // bytes of one staged x row
constexpr int DROW = SW * PIX;
constexpr int B_THREADS = 3 * 128;   // warpgroup dr = 0, 1, 2
constexpr int ACC = 3 * C / 2;       // f32 accumulators a thread: 96
constexpr int FLUSH_ROWS = 16;       // rows (4 k16 steps each) per chain
constexpr int TOT_BYTES = ACC * B_THREADS * 4;
constexpr int SMEM_B = TOT_BYTES + XR * XROW + STAGES * DROW;
static_assert(ACC * B_THREADS == PART, "the warps hold the whole output");
static_assert(SMEM_B <= 232448, "227 KB of shared memory a block");

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

// Shared address of 16-byte chunk v of the pixel row at shared address
// `row` (128-byte aligned): the chunk index XOR bits 7..9 of the address,
// the 128-byte swizzle of the tensor cores' shared-memory operands.
__device__ __forceinline__ uint32_t swz(uint32_t row, int v) {
  return row + ((v ^ ((row >> 7) & 7)) << 4);
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle starting
// at shared address `addr`: 64 elements (one pixel row) along M or N, then
// the next 64 at `lbo` bytes; 8 pixel rows along K, then the next 8 at 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

#define ACC8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[96] += A^T-view x B-view, m64n192k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_n192(float (&d)[ACC], uint64_t a,
                                           uint64_t b) {
  // scale-d is a predicate operand: set true, D += A B
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88)
      : "l"(a), "l"(b));
}

#undef ACC8

// Issue the copies of image row r (zero outside 0..h-1) of strip c0 into a
// ring row: x with the halo (pixels c0-1 .. c0+SW), or dy (c0 .. c0+SW-1).
template <bool HALO>
__device__ __forceinline__ void load_row(uint32_t dst,
                                         const __nv_bfloat16* __restrict__ src,
                                         int b, int r, int c0, int h, int w) {
  constexpr int NPIX = HALO ? SW + 2 : SW;
  const int lo = HALO ? c0 - 1 : c0;
  const bool row_ok = r >= 0 && r < h;
  const __nv_bfloat16* row = src + ((size_t)b * h + (row_ok ? r : 0)) * w * C;
  for (int i = threadIdx.x; i < NPIX * 8; i += B_THREADS) {
    const int q = i >> 3, v = i & 7;
    const int c = lo + q;
    const bool ok = row_ok && c >= 0 && c < w;
    cp_async16(swz(dst + q * PIX, v), ok ? row + (size_t)c * C + v * 8 : src,
               ok);
  }
}

__global__ void __launch_bounds__(B_THREADS, 1)
dw_bf16(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // totals: slot k of thread t at k * B_THREADS + t (each thread its own)
  float* tot = reinterpret_cast<float*>(smem);
  const uint32_t xring = smem_addr(smem + TOT_BYTES);
  const uint32_t dring = xring + XR * XROW;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy);
  const int dr = threadIdx.x >> 7;

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int k = 0; k < ACC; ++k) tot[k * B_THREADS + threadIdx.x] = 0.f;

  // The empty asm every 16 accumulators keeps the compiler from loading
  // many totals ahead of their adds: with all 96 accumulators live, that
  // batching spilled registers.
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      tot[i * B_THREADS + threadIdx.x] += acc[i];
      acc[i] = 0.f;
      if (i % 16 == 15) asm volatile("" ::: "memory");
    }
  };

  // strip rows numbered in 32 bits (the host checks the count fits): the
  // divisions stay inline, where 64-bit ones are called routines
  const int h = a.h, w = a.w;
  const int strips = (w + SW - 1) / SW;
  const int total = a.n * strips * h;
  const int q = total / gridDim.x, rem = total % gridDim.x;
  const int bid = blockIdx.x;
  int g = bid * q + min(bid, rem);
  const int g_end = g + q + (bid < rem);
  int chain = 0;  // rows in the accumulators since the last flush
  while (g < g_end) {
    // one segment: rows ra .. rb-1 of strip s of image b
    const int bs = g / h;
    const int ra = g - bs * h;
    const int rb = min(g_end - bs * h, h);
    const int b = bs / strips, c0 = (bs % strips) * SW;
    const int len = rb - ra;
    // ring row of x offset o (image row ra - 1 + o), of dy step j (row ra+j)
    auto xrow = [&](int o) { return xring + (o % XR) * XROW; };
    auto drow = [&](int j) { return dring + (j % STAGES) * DROW; };

    // prologue: groups 0 .. STAGES-2; group j holds dy row ra+j and x row
    // ra+j+1, group 0 also x rows ra-1 and ra
    load_row<true>(xrow(0), x, b, ra - 1, c0, h, w);
    load_row<true>(xrow(1), x, b, ra, c0, h, w);
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < len) {
        load_row<true>(xrow(j + 2), x, b, ra + j + 1, c0, h, w);
        load_row<false>(drow(j), dy, b, ra + j, c0, h, w);
      }
      cp_commit();
    }

    for (int j = 0; j < len; ++j) {
      cp_wait<STAGES - 2>();  // group j has landed, for this thread;
      // make it visible to the tensor cores (the async proxy) ...
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // ... for all threads; row j-1's wgmma are done
      const int jn = j + STAGES - 1;
      if (jn < len) {
        load_row<true>(xrow(jn + 2), x, b, ra + jn + 1, c0, h, w);
        load_row<false>(drow(jn), dy, b, ra + jn, c0, h, w);
      }
      cp_commit();

      // output row ra+j reads x row ra+j+dr-1 = offset j+dr
      const uint32_t xa = xrow(j + dr), da = drow(j);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < SW / 16; ++ks)
        wgmma_n192(acc, desc(da + ks * 16 * PIX, DROW),
                   desc(xa + ks * 16 * PIX, PIX));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (++chain == FLUSH_ROWS) {
        flush();
        chain = 0;
      }
    }
    __syncthreads();  // the next segment's prologue refills the ring
    g += len;
  }
  cp_wait<0>();
  flush();

  // the partial: accumulator 4j + e of thread (warp wi of the warpgroup,
  // lane) holds co = 16 wi + lane/4 + 8 (e >> 1) and column n = 8j +
  // 2 (lane % 4) + (e & 1) of the 192, that is dc = n / 64, ci = n % 64
  const int wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float* p = a.part + (size_t)blockIdx.x * PART;
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = wi * 16 + (lane >> 2) + 8 * (e >> 1);
      const int n = 8 * j + 2 * (lane & 3) + (e & 1);
      p[((dr * 3 + n / C) * C + n % C) * C + co] =
          tot[(j * 4 + e) * B_THREADS + threadIdx.x];
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, exact float32 products
// ---------------------------------------------------------------------------

constexpr int TH = 4;             // tile rows
constexpr int TW = 32;            // tile pixels per row
constexpr int THREADS = 32 * TAPS;  // one warp per tap
constexpr int SROWS = TH + 2;
constexpr int SCOLS = TW + 2;
constexpr int XS_F = 68;          // f32 window pixel and dy pixel strides
constexpr int DS_F = 68;
constexpr int X_BYTES_F = SROWS * SCOLS * XS_F * 4;
constexpr int D_BYTES_F = TH * TW * DS_F * 4;

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

// Stage rows [r0+lo, r0+lo+rows) x pixels [c0+lo, c0+lo+cols) of image b,
// zero outside; lo = -1 with the halo (x), 0 without (dy).
template <typename T, int STRIDE>
__device__ void load_block(T* dst, const T* __restrict__ src, const Tile& t,
                           int lo, int rows, int cols, int h, int w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = C / VEC;
  for (int i = threadIdx.x; i < rows * cols * CHUNKS; i += THREADS) {
    const int v = i % CHUNKS;
    const int p = i / CHUNKS;
    const int sc = p % cols, sr = p / cols;
    const int gr = t.r0 + lo + sr, gc = t.c0 + lo + sc;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + ((((size_t)t.b * h + gr) * w + gc) * C + v * VEC)));
    *reinterpret_cast<uint4*>(dst + (sr * cols + sc) * STRIDE + v * VEC) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
dw_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ds = reinterpret_cast<float*>(smem + X_BYTES_F);
  const int tap = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dr = tap / 3, dc = tap % 3;
  const int ci0 = (lane / 4) * 8, co0 = (lane % 4) * 16;

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  const long tiles = (long)a.n * ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, a);
    load_block<float, XS_F>(xs, static_cast<const float*>(a.x), t, -1, SROWS,
                            SCOLS, a.h, a.w);
    load_block<float, DS_F>(ds, static_cast<const float*>(a.dy), t, 0, TH, TW,
                            a.h, a.w);
    __syncthreads();
    for (int rr = 0; rr < TH; ++rr) {
      for (int cc = 0; cc < TW; ++cc) {
        const float* xp = xs + ((rr + dr) * SCOLS + cc + dc) * XS_F + ci0;
        const float* dp = ds + (rr * TW + cc) * DS_F + co0;
        float xv[8], dv[16];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xp + 4 * q);
          xv[4 * q] = v.x; xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(dp + 4 * q);
          dv[4 * q] = v.x; dv[4 * q + 1] = v.y;
          dv[4 * q + 2] = v.z; dv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(xv[i], dv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* p = a.part + (size_t)blockIdx.x * PART + (size_t)tap * C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(p + (ci0 + i) * C + co0 + j) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
}

// dw[i] = sum over the CTAs' partials, in CTA order (deterministic).
__global__ void dw_reduce(const float* __restrict__ part, float* dw,
                          int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PART) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * PART + i];
  dw[i] = s;
}

}  // namespace

// Set up the kernel of the dtype on the current device and return the
// number of CTA partials a launch at this shape uses: the wrapper allocates
// `part` as that many [9][64][64] f32 blocks, and calls this once per
// (device, shape, dtype). Negative: -(CUDA error).
extern "C" int onet_conv3x3_wp_dw_blocks(int n, int h, int w, int in_bf16) {
  void (*kern)(const Args) = in_bf16 ? dw_bf16 : dw_f32;
  const int smem = in_bf16 ? SMEM_B : X_BYTES_F + D_BYTES_F;
  const int threads = in_bf16 ? B_THREADS : THREADS;
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
  // bf16: one CTA per SM over the strip rows; f32: over the tiles
  const long work = in_bf16
      ? (long)n * ((w + SW - 1) / SW) * h
      : (long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  // the bf16 kernel numbers the strip rows with 32-bit ints
  if (in_bf16 && work > INT32_MAX) return -(int)cudaErrorInvalidValue;
  const long g = (long)sms * per_sm;
  return (int)(g < work ? g : work);
}

// Launch on `stream`; returns the CUDA error code (0 on success). x and dy
// are contiguous NHWC [n, h, w, 64] (bf16 or f32, 16-byte aligned), part
// holds `nblk` partials from onet_conv3x3_wp_dw_blocks (any nblk >= 0 is
// right: the kernels share the work out by gridDim), dw [9*64*64] f32. No
// host query: the set-up call made the kernel launchable.
extern "C" int onet_conv3x3_wp_dw(const void* x, const void* dy, float* part,
                                  float* dw, int n, int h, int w, int in_bf16,
                                  int nblk, void* stream) {
  Args a;
  a.x = x;
  a.dy = dy;
  a.part = part;
  a.n = n;
  a.h = h;
  a.w = w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nblk > 0) {
    if (in_bf16)
      dw_bf16<<<nblk, B_THREADS, SMEM_B, st>>>(a);
    else
      dw_f32<<<nblk, THREADS, X_BYTES_F + D_BYTES_F, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dw_reduce<<<(PART + 255) / 256, 256, 0, st>>>(part, dw, nblk);
  return (int)cudaGetLastError();
}
