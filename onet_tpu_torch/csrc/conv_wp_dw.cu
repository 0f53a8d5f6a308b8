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
// 512x512) one call is 0.31 TFLOP against 1.07 GB of bf16 x and dy: about
// 0.31 ms of tensor-core time at 989 TFLOP/s and 0.32 ms of HBM time at
// 3.35 TB/s. The design reads every byte once from HBM:
//   * persistent CTAs (a grid the size of the card) walk 4-row x 32-pixel
//     tiles; each stages the (4+2) x (32+2) x 64 x window, halo included and
//     zero outside the image, and the 4 x 32 x 64 dy tile in shared memory;
//   * 9 warps, one per tap: warp (dr, dc) multiplies the window shifted by
//     (dr, dc), read as a col-major 16x16 WMMA A fragment (channels x
//     pixels), by the dy tile (pixels x channels) into its 64x64 tap, held
//     as 4x4 f32 accumulator fragments in registers (4 A and 4 B fragment
//     loads per 16 products);
//   * after each tile the warp adds its fragments into the CTA's running
//     9x64x64 f32 totals in shared memory (147 KB, kept in fragment order,
//     so no layout is assumed) and starts the next tile from zero. The
//     tensor cores add into the accumulator without rounding to nearest, a
//     bias of up to an ulp of the accumulator per product step: carried
//     across a CTA's ~2000 steps at the training shape it grows to ~5e-5
//     of the sum, while 8 steps per tile and a rounded f32 add per tile keep
//     it near 1e-6;
//   * at the end each CTA stores its totals as its partial to a
//     [grid][9][64][64] buffer, and a second kernel, dw_reduce, sums the
//     partials in CTA order. Deterministic, where atomicAdd into dw would
//     not be; the partials are 19 MB at 132 CTAs, 2% of the call's bytes.
// Loads are synchronous 16-byte loads and there is one CTA per SM: load and
// compute do not overlap. cp.async/TMA, wgmma and overlap are later work.
//
// f32 inputs take a CUDA-core path (the float32 policy): the same tiles and
// partials; thread (tap, ci-group of 8, co-group of 16) keeps 128 f32
// accumulators and does exact f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;             // channels per branch at the packed levels
constexpr int TH = 4;             // tile rows
constexpr int TW = 32;            // tile pixels per row
constexpr int TAPS = 9;
constexpr int THREADS = 32 * TAPS;  // one warp per tap
constexpr int SROWS = TH + 2;
constexpr int SCOLS = TW + 2;
constexpr int XS_B = 80;          // bf16 window pixel stride (elements)
constexpr int DS_B = 72;          // bf16 dy pixel stride (elements)
constexpr int XS_F = 68;          // f32 strides
constexpr int DS_F = 68;
constexpr int X_BYTES_B = SROWS * SCOLS * XS_B * 2;
constexpr int D_BYTES_B = TH * TW * DS_B * 2;
constexpr int X_BYTES_F = SROWS * SCOLS * XS_F * 4;
constexpr int D_BYTES_F = TH * TW * DS_F * 4;
constexpr int PART = TAPS * C * C;  // floats of one CTA's partial
constexpr int T_BYTES_B = PART * 4;  // bf16 path: the CTA's totals

struct Args {
  const void* x;     // NHWC [n, h, w, 64]
  const void* dy;    // NHWC [n, h, w, 64]
  float* part;       // [gridDim.x][9][64][64]
  int n, h, w;
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

// ---------------------------------------------------------------------------
// bf16: WMMA on the tensor cores
// ---------------------------------------------------------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS)
dw_bf16(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES_B);
  // totals in fragment order: element e of fragment f of thread t at
  // (f * 8 + e) * THREADS + t (conflict-free; each thread owns its own)
  float* tot = reinterpret_cast<float*>(smem + X_BYTES_B + D_BYTES_B);
  const int tap = threadIdx.x / 32;
  const int dr = tap / 3, dc = tap % 3;

  FragC acc[4][4];
  static_assert(FragC::num_elements == 8, "16x16 f32 fragment: 8 per lane");
  for (int k = 0; k < 16 * 8; ++k) tot[k * THREADS + threadIdx.x] = 0.f;

  const long tiles = (long)a.n * ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, a);
    load_block<__nv_bfloat16, XS_B>(
        xs, static_cast<const __nv_bfloat16*>(a.x), t, -1, SROWS, SCOLS,
        a.h, a.w);
    load_block<__nv_bfloat16, DS_B>(
        ds, static_cast<const __nv_bfloat16*>(a.dy), t, 0, TH, TW, a.h, a.w);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    // K runs over the tile's pixels, 16 at a time: (row rr, half hh)
    for (int rr = 0; rr < TH; ++rr) {
#pragma unroll
      for (int hh = 0; hh < TW / 16; ++hh) {
        // output pixel (rr, hh*16 + k) reads window (rr + dr, hh*16 + k + dc)
        const __nv_bfloat16* xr =
            xs + ((rr + dr) * SCOLS + hh * 16 + dc) * XS_B;
        const __nv_bfloat16* dp = ds + (rr * TW + hh * 16) * DS_B;
        FragA fa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(fa[i], xr + i * 16, XS_B);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, dp + j * 16, DS_B);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 16; ++f)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tot[(f * 8 + e) * THREADS + threadIdx.x] += acc[f / 4][f % 4].x[e];
    __syncthreads();     // the window and dy tile are reloaded next tile
  }

  float* p = a.part + (size_t)blockIdx.x * PART + (size_t)tap * C * C;
#pragma unroll
  for (int f = 0; f < 16; ++f) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[f / 4][f % 4].x[e] = tot[(f * 8 + e) * THREADS + threadIdx.x];
    wmma::store_matrix_sync(p + (f / 4) * 16 * C + (f % 4) * 16,
                            acc[f / 4][f % 4], C, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, exact float32 products
// ---------------------------------------------------------------------------

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

cudaError_t grid_of(int n, int h, int w, int in_bf16, int* grid, int* smem) {
  void (*kern)(const Args) = in_bf16 ? dw_bf16 : dw_f32;
  *smem = in_bf16 ? X_BYTES_B + D_BYTES_B + T_BYTES_B : X_BYTES_F + D_BYTES_F;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, *smem)) != cudaSuccess)
    return err;
  const long tiles = (long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  long g = (long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(g < tiles ? g : tiles);
  return cudaSuccess;
}

}  // namespace

// The number of CTA partials the launch needs: the wrapper allocates
// `part` as that many [9][64][64] f32 blocks. Negative: -(CUDA error).
extern "C" int onet_conv3x3_wp_dw_blocks(int n, int h, int w, int in_bf16) {
  int grid = 0, smem = 0;
  cudaError_t err = grid_of(n, h, w, in_bf16, &grid, &smem);
  return err == cudaSuccess ? grid : -(int)err;
}

// Launch on `stream`; returns the CUDA error code (0 on success). x and dy
// are contiguous NHWC [n, h, w, 64] (bf16 or f32, 16-byte aligned), part
// holds `nblk` partials from onet_conv3x3_wp_dw_blocks, dw [9*64*64] f32.
extern "C" int onet_conv3x3_wp_dw(const void* x, const void* dy, float* part,
                                  float* dw, int n, int h, int w, int in_bf16,
                                  int nblk, void* stream) {
  int grid = 0, smem = 0;
  cudaError_t err = grid_of(n, h, w, in_bf16, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  if (grid != nblk) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dy = dy;
  a.part = part;
  a.n = n;
  a.h = h;
  a.w = w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (in_bf16)
      dw_bf16<<<grid, THREADS, smem, st>>>(a);
    else
      dw_f32<<<grid, THREADS, smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  dw_reduce<<<(PART + 255) / 256, 256, 0, st>>>(part, dw, grid);
  return (int)cudaGetLastError();
}
