// Pair-packed SAME 3x3 convolution with the serving epilogue, for sm_90a.
//
// Replaces the Pallas kernels of onet_tpu/ops/pallas_conv.py:
//   _fwd_kernel  (via conv3x3_wp_raw)   y = conv(x, w)
//   _fwd2_kernel (via conv3x3_wp2_raw)  y = conv(xa, wa) + conv(xb, wb)
// each with the optional bias+ReLU store epilogue. The BatchNorm-stats
// epilogue is not here: the Python wrapper refuses stats=True on the card.
//
// Layout. The packed tensor [N, H, W/2, 128] (lane = (w%2)*64 + c) is, byte
// for byte, the per-branch NHWC tensor [N, H, W, 64]. The TPU kernel needed
// the packing to fill 128-lane tiles, and paid for it with 6 [m,128]x[128,128]
// products per kernel row of which 25% multiply structural zeros. Here the
// kernel reads the unpacked view and runs the 9 real 64x64 taps: every
// multiply is useful. The wrapper passes the taps [3][3][64][64] (HWIO),
// sliced from Wc, whose blocks hold all nine.
//
// What bounds it on the H100. At the serving shape (N=64, 512x512, bf16) one
// conv is 1.24 TFLOP against 4.3 GB of input and output: about 1.25 ms of
// tensor-core time at 989 TFLOP/s and 1.28 ms of HBM time at 3.35 TB/s, so
// both limits sit close together. The design keeps every byte read once from
// HBM and the weights read once per CTA:
//   * persistent CTAs (a grid the size of the card) walk the output tiles,
//     so the 74 KB (one input) or 147 KB (two inputs) of bf16 taps are loaded
//     into shared memory once per CTA, not once per tile;
//   * a tile is 8 output rows x 32 pixels x 64 channels; its (8+2) x (32+2)
//     input window, halo included, is staged in shared memory, zero-filled
//     outside the image (SAME padding), and each input pixel is re-read from
//     shared memory by the 9 taps, not from HBM;
//   * each of the 8 warps owns one output row: 2x4 WMMA bf16 16x16x16
//     fragments accumulate in f32 registers over 9 taps x 4 k-steps;
//   * the epilogue goes fragment by fragment through a 1 KB per-warp slice
//     of the (then idle) window buffer, adds the f32 bias, applies ReLU,
//     casts, and stores 16-byte vectors.
// Shared-memory rows are padded (80 and 72 elements) so the WMMA loads hit
// few bank conflicts while keeping their 32-byte alignment. Loads are plain
// synchronous 16-byte loads, not cp.async or TMA, and there is one CTA per SM:
// load and compute do not overlap. That, and wgmma, are later work.
//
// f32 inputs take a CUDA-core path (one thread per output pixel, 64 f32
// accumulators, weights read through the read-only cache): it exists for the
// float32 policy's exactness, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;             // channels per branch at the packed levels
constexpr int TH = 8;             // output rows per tile, one warp each
constexpr int TW = 32;            // output pixels per tile row
constexpr int THREADS = 32 * TH;
constexpr int SROWS = TH + 2;     // window rows incl. halo
constexpr int SCOLS = TW + 2;     // window pixels per row incl. halo
constexpr int XS_B = 80;          // bf16 window pixel stride (elements)
constexpr int WS_B = 72;          // bf16 weight row stride (elements)
constexpr int XS_F = 68;          // f32 window pixel stride (elements)
constexpr int W_BYTES_B = 9 * C * WS_B * 2;            // one input's taps
constexpr int X_BYTES_B = SROWS * SCOLS * XS_B * 2;    // bf16 window
constexpr int X_BYTES_F = SROWS * SCOLS * XS_F * 4;    // f32 window

struct Args {
  const void* x[2];     // inputs, NHWC [n, h, w, 64]
  const void* taps[2];  // [3][3][64][64] HWIO, inputs' dtype
  const float* bias;    // [128] packed lanes (parity * 64 + c)
  void* y;              // NHWC [n, h, w, 64]
  int n, h, w;          // unpacked geometry: w = 2 * Wp
  int nin, relu, out_bf16;
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
// bf16: WMMA on the tensor cores
// ---------------------------------------------------------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS)
conv_wp_bf16(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + a.nin * W_BYTES_B);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // taps of every input, once per CTA: [in][tap][ci][co], rows padded to WS_B
  for (int in = 0; in < a.nin; ++in) {
    const __nv_bfloat16* wg = static_cast<const __nv_bfloat16*>(a.taps[in]);
    __nv_bfloat16* wd = ws + in * 9 * C * WS_B;
    for (int i = threadIdx.x; i < 9 * C * (C / 8); i += THREADS) {
      const int v = i % (C / 8), row = i / (C / 8);
      *reinterpret_cast<uint4*>(wd + row * WS_B + v * 8) =
          __ldg(reinterpret_cast<const uint4*>(wg + row * C + v * 8));
    }
  }

  const long tiles = (long)a.n * ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, a);
    FragC acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) wmma::fill_fragment(acc[m][nn], 0.f);

    for (int in = 0; in < a.nin; ++in) {
      load_window<__nv_bfloat16, XS_B>(
          xs, static_cast<const __nv_bfloat16*>(a.x[in]), t, a.h, a.w);
      __syncthreads();
      const __nv_bfloat16* wi = ws + in * 9 * C * WS_B;
      for (int dr = 0; dr < 3; ++dr) {
        for (int dc = 0; dc < 3; ++dc) {
          // output (row warp, pixel p) reads window (warp + dr, p + dc)
          const __nv_bfloat16* xr = xs + ((warp + dr) * SCOLS + dc) * XS_B;
          const __nv_bfloat16* wt = wi + (dr * 3 + dc) * C * WS_B;
#pragma unroll
          for (int k = 0; k < C; k += 16) {
            FragA fa[2];
            FragB fb[4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              wmma::load_matrix_sync(fa[m], xr + m * 16 * XS_B + k, XS_B);
#pragma unroll
            for (int nn = 0; nn < 4; ++nn)
              wmma::load_matrix_sync(fb[nn], wt + k * WS_B + nn * 16, WS_B);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int nn = 0; nn < 4; ++nn)
                wmma::mma_sync(acc[m][nn], fa[m], fb[nn], acc[m][nn]);
          }
        }
      }
      __syncthreads();   // window free: next input, or the epilogue scratch
    }

    float* scratch = reinterpret_cast<float*>(xs) + warp * 256;
    const int r = t.r0 + warp;
    const int i = lane >> 1, j0 = (lane & 1) * 8;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        wmma::store_matrix_sync(scratch, acc[m][nn], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = t.c0 + m * 16 + i;
        const int co = nn * 16 + j0;
        if (r < a.h && col < a.w) {
          const float* bp = a.bias + (col & 1) * C + co;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = epilogue(scratch[i * 16 + j0 + j], bp[j], a.relu);
          store8(a.y, (((size_t)t.b * a.h + r) * a.w + col) * C + co, v,
                 a.out_bf16);
        }
        __syncwarp();
      }
    }
    __syncthreads();     // scratch (the window) is reloaded by the next tile
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, exact float32 products
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
conv_wp_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
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
    if (r < a.h && col < a.w) {
      const size_t base = (((size_t)t.b * a.h + r) * a.w + col) * C;
      const float* bp = a.bias + (col & 1) * C;
#pragma unroll
      for (int o = 0; o < C; o += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = epilogue(acc[o + j], bp[o + j], a.relu);
        store8(a.y, base + o, v, a.out_bf16);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success). Pointers
// must be 16-byte aligned and the tensors contiguous; the wrapper checks.
extern "C" int onet_conv3x3_wp(const void* xa, const void* xb,
                               const void* wa, const void* wb,
                               const float* bias, void* y, int n, int h,
                               int w, int nin, int in_bf16, int out_bf16,
                               int relu, void* stream) {
  if (nin < 1 || nin > 2) return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = xa;
  a.x[1] = xb;
  a.taps[0] = wa;
  a.taps[1] = wb;
  a.bias = bias;
  a.y = y;
  a.n = n;
  a.h = h;
  a.w = w;
  a.nin = nin;
  a.relu = relu;
  a.out_bf16 = out_bf16;

  void (*kern)(const Args) = in_bf16 ? conv_wp_bf16 : conv_wp_f32;
  const int smem = in_bf16 ? nin * W_BYTES_B + X_BYTES_B : X_BYTES_F;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long tiles = (long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  if (tiles == 0) return (int)cudaSuccess;
  long grid = (long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  kern<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
