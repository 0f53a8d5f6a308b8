// Native-layout (channel-stacked) SAME 3x3 convolution, 128 -> 128 lanes,
// with the optional BatchNorm-statistics epilogue, for sm_90a.
//
// Replaces the Pallas kernels of onet_tpu/ops/pallas_conv_bd.py:
//   _bd_fwd_kernel  (via conv3x3_bd_raw)    y = conv(x, w)
//   _bd_fwd2_kernel (via conv3x3_bd2in_raw) y = conv(xa, wa) + conv(xb, wb)
// x [n, h, w, 128] and w [3, 3, 128, 128] (HWIO, any dense weight: the
// block-diagonal zeros of bd2 are multiplied like any other value) are bf16;
// the accumulator is f32; y is stored as bf16 or f32. With stats, per-sample
// lane sums s1, s2 [n][128] of the f32 accumulator before the cast.
//
// What bounds it on the H100. At the probe's sites (n = 8, 512x512) one input
// is 2 * 8 * 512^2 * 128 * 128 * 9 = 6.2e11 flops, 0.625 ms of tensor-core
// time at 989 TFLOP/s, against 1.07 GB of input and output, 0.32 ms at
// 3.35 TB/s: operations bound it (the two-input form: 1.25 ms).
//
// Design, from csrc/conv_wp.cu:
//  * persistent CTAs (one per SM, 16 warps) walk tiles of 8 output rows x
//    32 pixels x all 128 output lanes; the (8+2) x (32+2) x 128 input window,
//    halo and SAME zeros included, is staged in shared memory once per
//    (tile, input), so each input pixel is read from HBM ~1.3 times;
//  * nine 128x128 bf16 taps are 295 KB, more than a block's 227 KB, and the
//    two-input form needs twice that. So the taps stream through shared
//    memory one tap (32 KB) at a time, double-buffered with cp.async: tap
//    t+1 is in flight while the warps multiply with tap t. A tile reads
//    295 KB of taps per input from L2 (the weights stay L2-resident), for
//    75 MFLOP of products;
//  * warp w owns output row w % 8 and output lanes 64 * (w / 8) .. + 63:
//    2 x 4 WMMA bf16 16x16x16 fragments accumulate in f32 over the 9 taps x
//    8 k-steps of each input;
//  * the epilogue goes fragment by fragment through a 1 KB per-warp slice
//    of the (then idle) window buffer: 16-byte stores of y, and for the
//    statistics each lane sums one lane column over half the fragment's
//    pixels; the two halves meet by a shuffle, the 8 row warps in shared
//    memory, and each tile writes a [256] partial (s1 lanes, s2 lanes).
//    stats_reduce sums a sample's tile partials in tile order: the result
//    does not depend on which CTA ran which tile (no atomics).
// Window loads are synchronous 16-byte loads; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int L = 128;            // lanes of the stacked layout, in and out
constexpr int HALF = 64;          // output lanes per warp
constexpr int TH = 8;             // output rows per tile
constexpr int TW = 32;            // output pixels per tile row
constexpr int WARPS = 2 * TH;     // row warp % TH, output half warp / TH
constexpr int THREADS = 32 * WARPS;
constexpr int SROWS = TH + 2;     // window rows incl. halo
constexpr int SCOLS = TW + 2;     // window pixels per row incl. halo
constexpr int XS = 144;           // window pixel stride (elements): 288 B,
                                  // keeps each tap column 32-byte aligned
constexpr int WS = 136;           // tap row stride (elements)
constexpr int X_BYTES = SROWS * SCOLS * XS * 2;   // 97,920
constexpr int TAP_ELEMS = L * WS;
constexpr int TAP_BYTES = TAP_ELEMS * 2;          // 34,816
constexpr int NSTAT = 2 * L;                      // s1 lanes, s2 lanes
constexpr int RED_BYTES = TH * NSTAT * 4;         // 8,192
constexpr int SMEM = X_BYTES + 2 * TAP_BYTES + RED_BYTES;   // 175,744

struct Args {
  const __nv_bfloat16* x[2];   // inputs, NHWC [n, h, w, 128]
  const __nv_bfloat16* wt[2];  // [3][3][128][128] HWIO
  void* y;                     // NHWC [n, h, w, 128]
  float* part;                 // [tiles][256] stats partials (stats only)
  int n, h, w, nin, out_bf16, stats;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying tap t ([128 ci][128 co]) of w into buf, rows padded to WS.
__device__ __forceinline__ void issue_tap(__nv_bfloat16* buf,
                                          const __nv_bfloat16* w, int t) {
  const __nv_bfloat16* src = w + (size_t)t * L * L;
  for (int i = threadIdx.x; i < L * (L / 8); i += THREADS) {
    const int row = i / (L / 8), v = i % (L / 8);
    cp_async16(buf + row * WS + v * 8, src + row * L + v * 8);
  }
  cp_async_commit();
}

// Stage the (TH+2) x (TW+2) window of image b around the tile, zero outside.
__device__ void load_window(__nv_bfloat16* xs, const __nv_bfloat16* x,
                            const Tile& t, int h, int w) {
  constexpr int CHUNKS = L / 8;
  for (int i = threadIdx.x; i < SROWS * SCOLS * CHUNKS; i += THREADS) {
    const int v = i % CHUNKS;
    const int p = i / CHUNKS;
    const int sc = p % SCOLS, sr = p / SCOLS;
    const int gr = t.r0 - 1 + sr, gc = t.c0 - 1 + sc;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      val = __ldg(reinterpret_cast<const uint4*>(
          x + ((((size_t)t.b * h + gr) * w + gc) * L + v * 8)));
    *reinterpret_cast<uint4*>(xs + (sr * SCOLS + sc) * XS + v * 8) = val;
  }
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS, 1)
conv_bd(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* taps = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* red = reinterpret_cast<float*>(smem + X_BYTES + 2 * TAP_BYTES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp % TH, half = warp / TH;

  const long tiles = (long)a.n * ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, a);
    FragC acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) wmma::fill_fragment(acc[m][nn], 0.f);

    for (int in = 0; in < a.nin; ++in) {
      __syncthreads();   // the window and tap buffer 0 are free again
      issue_tap(taps, a.wt[in], 0);
      load_window(xs, a.x[in], t, a.h, a.w);
      for (int tap = 0; tap < 9; ++tap) {
        cp_async_wait_all();
        __syncthreads();   // tap `tap` landed; tap - 1's buffer is free
        if (tap + 1 < 9) issue_tap(taps + ((tap + 1) & 1) * TAP_ELEMS,
                                   a.wt[in], tap + 1);
        const int dr = tap / 3, dc = tap % 3;
        // output (row, pixel p) reads window (row + dr, p + dc)
        const __nv_bfloat16* xr = xs + ((row + dr) * SCOLS + dc) * XS;
        const __nv_bfloat16* wt = taps + (tap & 1) * TAP_ELEMS + half * HALF;
#pragma unroll 2
        for (int k = 0; k < L; k += 16) {
          FragA fa[2];
          FragB fb[4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wmma::load_matrix_sync(fa[m], xr + m * 16 * XS + k, XS);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            wmma::load_matrix_sync(fb[nn], wt + k * WS + nn * 16, WS);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nn = 0; nn < 4; ++nn)
              wmma::mma_sync(acc[m][nn], fa[m], fb[nn], acc[m][nn]);
        }
      }
    }
    __syncthreads();     // the window is free: it becomes epilogue scratch

    float* scratch = reinterpret_cast<float*>(xs) + warp * 256;
    const int r = t.r0 + row;
    const int i = lane >> 1, j0 = (lane & 1) * 8;
    // stats: lane (sc, sp) sums lane column sc over fragment rows 2q + sp
    const int sc = lane & 15, sp = lane >> 4;
    float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        wmma::store_matrix_sync(scratch, acc[m][nn], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = t.c0 + m * 16 + i;
        if (r < a.h && col < a.w)
          store8(a.y,
                 (((size_t)t.b * a.h + r) * a.w + col) * L + half * HALF +
                     nn * 16 + j0,
                 scratch + i * 16 + j0, a.out_bf16);
        if (a.stats) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int ii = 2 * q + sp;
            if (r < a.h && t.c0 + m * 16 + ii < a.w) {
              const float v = scratch[ii * 16 + sc];
              s1[nn] += v;
              s2[nn] += v * v;
            }
          }
        }
        __syncwarp();
      }
    }
    if (a.stats) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        s1[nn] += __shfl_xor_sync(0xffffffffu, s1[nn], 16);
        s2[nn] += __shfl_xor_sync(0xffffffffu, s2[nn], 16);
        if (sp == 0) {
          red[row * NSTAT + half * HALF + nn * 16 + sc] = s1[nn];
          red[row * NSTAT + L + half * HALF + nn * 16 + sc] = s2[nn];
        }
      }
      __syncthreads();
      if (threadIdx.x < NSTAT) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < TH; ++k) v += red[k * NSTAT + threadIdx.x];
        a.part[tile * NSTAT + threadIdx.x] = v;
      }
    }
    // the next tile's first __syncthreads guards the scratch and `red`
  }
}

// Per-sample sums of the tile partials, in tile order (deterministic).
// grid (n, NSTAT / 32), 256 threads: 8 phases of 32 values each.
__global__ void __launch_bounds__(256)
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
    float* out = v < L ? s1 : s2;
    out[(size_t)blockIdx.x * L + (v % L)] = s;
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success). Pointers
// must be 16-byte aligned and the tensors contiguous; the wrapper checks.
// With stats, `part` holds n * ceil(h/8) * ceil(w/32) * 256 floats of
// scratch and s1, s2 receive [n][128] each.
extern "C" int onet_conv3x3_bd(const void* xa, const void* xb, const void* wa,
                               const void* wb, void* y, float* part, float* s1,
                               float* s2, int n, int h, int w, int nin,
                               int out_bf16, int stats, void* stream) {
  if (nin < 1 || nin > 2) return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = static_cast<const __nv_bfloat16*>(xa);
  a.x[1] = static_cast<const __nv_bfloat16*>(xb);
  a.wt[0] = static_cast<const __nv_bfloat16*>(wa);
  a.wt[1] = static_cast<const __nv_bfloat16*>(wb);
  a.y = y;
  a.part = part;
  a.n = n;
  a.h = h;
  a.w = w;
  a.nin = nin;
  a.out_bf16 = out_bf16;
  a.stats = stats;

  cudaError_t err = cudaFuncSetAttribute(
      conv_bd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int tps = ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const long tiles = (long)n * tps;
  if (tiles == 0) return (int)cudaSuccess;
  const long grid = tiles < sms ? tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv_bd<<<(unsigned)grid, THREADS, SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || !stats) return (int)err;
  stats_reduce<<<dim3((unsigned)n, NSTAT / 32), 256, 0, st>>>(part, s1, s2,
                                                             tps);
  return (int)cudaGetLastError();
}
