// int8 convolutions of the int8 serving graph and int8 training, for sm_90a:
// int8 codes in, int32 accumulator, a fused dequantize / requantize epilogue.
//
// These replace no Pallas kernel. They replace the XLA int8 ops of the JAX
// package, which PyTorch has no counterpart of on the card (F.conv2d refuses
// int8):
//   conv3x3_i8   lax.conv_general_dilated(int8, int8 -> int32), 3x3 SAME
//                (onet_tpu/models/quant.py:257-263, qtrain.py:69-72,116-121)
//   convT2x2_i8  lax.conv_transpose(int8, int8 -> int32), 2x2 stride 2
//                (quant.py:307-315)
// Both are one GEMM, D[pixel][col] = sum_k A[pixel][k] B[col][k]:
//   3x3:  pixel = (n, y, x), col = co, k = (tap, ci) with tap = 3 dy + dx,
//         A gathered from x[n, y + dy - 1, x + dx - 1, ci] (zero outside:
//         the SAME padding), B[co][k] = w[dy, dx, ci, co];
//   convT: pixel = (n, i, j) of the input, col = (di, dj, co), k = ci,
//         A = x[n, i, j, ci], B[(di, dj, co)][ci] = w[di, dj, ci, co] of the
//         unflipped kernel; the epilogue scatters col into the output pixel
//         (2i + di, 2j + dj).
// The wrapper (ops/conv_i8.py) lays B out once per call, K contiguous and
// padded with zero codes to a multiple of 64; the kernel zero-fills A past
// K, so a padded K adds zero products: exact.
//
// Epilogue (out mode), per column channel o, in the plain version's order
// and rounding, without FMA contraction:
//   I32  acc
//   F32  v = acc * scale[o] (+ bias[o])        __fmul_rn, __fadd_rn
//   U8   clamp(rint(v / snext[o]), 0, 127)     __fdiv_rn, round half even
//   S8   clamp(rint(v / snext[o]), -127, 127)
// so the codes are bit-equal to the plain version's (ops/conv_i8.py, which
// computes the accumulator exactly in float64).
//
// What bounds it on the H100. At the int8 serving graph's 512x512 sites
// (batch 8) a conv does 2 * 8 * 512^2 * 9 ci co operations: up4.conv1
// (ci 256, co 128) 1.24 T operations, 0.625 ms at 1979 dense int8 TOP/s,
// against 0.8 GB in and out, 0.24 ms at 3.35 TB/s; the deep sites are
// operations-bound by far. This first kernel is the simple form: mma.sync
// m16n8k32 s8 (the tensor cores through the pre-Hopper path), a 128 x 128
// output tile per
// 256-thread block (8 warps of 64 x 32), K in steps of 64 bytes through a
// 3-stage cp.async ring; A's 16-byte chunks (4-byte where ci is not a
// multiple of 16) gathered from NHWC with the zero fill of cp.async's
// src-size; fragments by ldmatrix from rows padded to 80 bytes (no bank
// conflicts); the epilogue stages the tile in shared memory and stores
// 16-byte runs of a pixel's channels (a scattered store of each
// accumulator was slower, most for the transposed conv's scatter).
// Registers are held to 128, two blocks an SM (at 165-175 registers one
// block an SM left the sites of one K step, inc.conv1's K = 18, waiting
// on their loads). wgmma s8 and TMA are the later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;          // pixels of a block tile
constexpr int BN = 128;          // columns of a block tile
constexpr int BK = 64;           // bytes of K a stage
constexpr int LDS = BK + 16;     // shared row stride: 80 bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int TILE_BYTES = BM * (BN * 4 + 16);  // the f32 / int32 out tile
constexpr int SMEM = STAGES * STAGE_BYTES > TILE_BYTES
                         ? STAGES * STAGE_BYTES : TILE_BYTES;  // 67,584

enum { OUT_I32 = 0, OUT_F32 = 1, OUT_U8 = 2, OUT_S8 = 3 };

struct Args {
  const int8_t* x;      // [n, h, w, ci]
  const int8_t* b;      // [ncols, kpad]
  const float* scale;   // [co]
  const float* bias;    // [co] or null
  const float* snext;   // [co] (U8, S8)
  void* y;              // [n, h, w, co] (3x3) or [n, 2h, 2w, co] (convT)
  int n, h, w, ci, co;
  int m;                // pixels: n h w
  int ncols;            // co (3x3) or 4 co (convT)
  int k;                // 9 ci (3x3) or ci (convT)
  int kpad;             // k rounded up to BK
  int out;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (VEC == 16)
    cp_async16(dst, src, bytes);
  else
    cp_async4(dst, src, bytes);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A rows a thread loads, fixed over the K loop: chunk i of the tile is
// row i / CPR, byte (i % CPR) VEC, i = tid + j THREADS.
template <int VEC>
struct RowsA {
  static constexpr int CPR = BK / VEC;
  static constexpr int PER = BM * CPR / THREADS;
  int ok[PER];          // pixel inside the GEMM
  int nb[PER], py[PER], px[PER];
};

template <int VEC, bool CONVT>
__device__ __forceinline__ void load_stage(const Args& a, int8_t* st,
                                           const RowsA<VEC>& rows, int m0,
                                           int n0, int k0, int tid) {
  using R = RowsA<VEC>;
  int8_t* sa = st;
  int8_t* sb = st + BM * LDS;
#pragma unroll
  for (int j = 0; j < R::PER; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / R::CPR;
    const int kk = k0 + (i % R::CPR) * VEC;
    const int8_t* src = a.x;
    int bytes = 0;
    if (rows.ok[j] && kk < a.k) {
      if constexpr (CONVT) {
        src = a.x + static_cast<size_t>(m0 + r) * a.ci + kk;
        bytes = VEC;
      } else {
        const int tap = kk / a.ci;
        const int ch = kk - tap * a.ci;
        const int yy = rows.py[j] + tap / 3 - 1;
        const int xx = rows.px[j] + tap % 3 - 1;
        if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
          src = a.x + ((static_cast<size_t>(rows.nb[j]) * a.h + yy) * a.w +
                       xx) * a.ci + ch;
          bytes = VEC;
        }
      }
    }
    cp_async<VEC>(sa + r * LDS + (i % R::CPR) * VEC, src, bytes);
  }
  // B: 128 rows of 64 bytes, 16-byte chunks, two a thread
#pragma unroll
  for (int j = 0; j < (BN * BK / 16) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / (BK / 16);
    const int c = (i % (BK / 16)) * 16;
    const int row = n0 + r;
    const bool ok = row < a.ncols;
    const int8_t* src = ok ? a.b + static_cast<size_t>(row) * a.kpad + k0 + c
                           : a.b;
    cp_async16(sb + r * LDS + c, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The epilogue of one accumulator in the out mode's type: the int32, the
// f32's bits, or the int8 code in the low byte.
__device__ __forceinline__ unsigned finish(const Args& a, int o, int acc) {
  if (a.out == OUT_I32) return static_cast<unsigned>(acc);
  float v = __fmul_rn(__int2float_rn(acc), a.scale[o]);
  if (a.bias) v = __fadd_rn(v, a.bias[o]);
  if (a.out == OUT_F32) return __float_as_uint(v);
  const float lo = a.out == OUT_U8 ? 0.f : -127.f;
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, a.snext[o])), lo), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// Element index in y of GEMM row m (a pixel) and column col.
template <bool CONVT>
__device__ __forceinline__ size_t dest(const Args& a, int m, int col) {
  if constexpr (!CONVT) {
    return static_cast<size_t>(m) * a.co + col;
  } else {
    const int jj = m % a.w;
    const int t = m / a.w;
    const int ii = t % a.h;
    const int nb = t / a.h;
    const int d = col / a.co;
    const int o = col - d * a.co;
    return ((static_cast<size_t>(nb) * 2 * a.h + 2 * ii + (d >> 1)) * 2 *
                a.w + 2 * jj + (d & 1)) * a.co + o;
  }
}

template <int VEC, bool CONVT>
__global__ void __launch_bounds__(THREADS, 2)
    conv_i8(const Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;       // warp rows in the tile
  const int wn = (warp & 3) * 32;        // warp columns in the tile
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  RowsA<VEC> rows;
#pragma unroll
  for (int j = 0; j < RowsA<VEC>::PER; ++j) {
    const int m = m0 + (tid + j * THREADS) / RowsA<VEC>::CPR;
    rows.ok[j] = m < a.m;
    const int px = m % a.w;
    const int t = m / a.w;
    rows.px[j] = px;
    rows.py[j] = t % a.h;
    rows.nb[j] = t / a.h;
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int nk = a.kpad / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<VEC, CONVT>(a, smem + s * STAGE_BYTES, rows, m0, n0, s * BK,
                             tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int kb = 0; kb < nk; ++kb) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    // refill the stage read STAGES - 1 steps ago (every warp is past it)
    const int next = kb + STAGES - 1;
    if (next < nk)
      load_stage<VEC, CONVT>(a, smem + (next % STAGES) * STAGE_BYTES, rows,
                             m0, n0, next * BK, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* sa = smem + (kb % STAGES) * STAGE_BYTES;
    const int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[4][4];
      unsigned bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], sa + (wm + mt * 16 + (lane & 15)) * LDS + ks +
                                (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], sb + (wn + np * 16 + (lane & 7) +
                                  ((lane >> 4) << 3)) * LDS + ks +
                                ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                 bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: the tile's outputs into shared memory (c0, c1 at row g, cols
  // 2t, 2t + 1; c2, c3 at row g + 8), then out in 16-byte row chunks: a
  // tile row is one pixel's run of channels (3x3), or of one (di, dj)
  // block's channels (convT), contiguous in y
  __syncthreads();
  const int es = a.out >= OUT_U8 ? 1 : 4;
  const int ts = BN * es + 16;                 // tile row stride, bytes
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = wm + mt * 16 + g + (v >> 1) * 8;
        const int c = wn + nt * 8 + t4 * 2 + (v & 1);
        const int col = n0 + c;
        if (col >= a.ncols) continue;
        const unsigned u = finish(a, CONVT ? col % a.co : col, acc[mt][nt][v]);
        if (es == 1)
          smem[r * ts + c] = static_cast<int8_t>(u);
        else
          *reinterpret_cast<unsigned*>(smem + r * ts + c * 4) = u;
      }
  __syncthreads();
  const int per = 16 / es;                     // columns a chunk
  const int cpr = BN / per;                    // chunks a row
  const int nc = min(BN, a.ncols - n0);
  const bool vec = (a.co * es) % 16 == 0;
  int8_t* y = static_cast<int8_t*>(a.y);
  for (int i = tid; i < BM * cpr; i += THREADS) {
    const int r = i / cpr;
    const int c = (i % cpr) * per;
    const int m = m0 + r;
    if (m >= a.m || c >= nc) continue;
    const int8_t* src = smem + r * ts + c * es;
    if (vec && c + per <= nc) {
      *reinterpret_cast<int4*>(y + dest<CONVT>(a, m, n0 + c) * es) =
          *reinterpret_cast<const int4*>(src);
    } else {
      for (int k = 0; k < per && c + k < nc; ++k) {
        int8_t* dst = y + dest<CONVT>(a, m, n0 + c + k) * es;
        for (int bt = 0; bt < es; ++bt) dst[bt] = src[k * es + bt];
      }
    }
  }
}

template <int VEC, bool CONVT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_i8<VEC, CONVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  dim3 grid((a.m + BM - 1) / BM, (a.ncols + BN - 1) / BN);
  conv_i8<VEC, CONVT><<<grid, THREADS, SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [n, h, w, ci] int8 NHWC; b [ncols, kpad] int8 (ops/conv_i8.py lays it
// out); y as the out mode says. convt: 0 for the 3x3 SAME conv, 1 for the
// 2x2 stride-2 transposed conv. vec: 16 (ci a multiple of 16) or 4 (ci a
// multiple of 4). Returns the CUDA error of the launch (0: launched).
extern "C" int onet_conv_i8(const void* x, const void* b, const void* scale,
                            const void* bias, const void* snext, void* y,
                            int n, int h, int w, int ci, int co, int kpad,
                            int convt, int vec, int out, void* stream) {
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.b = static_cast<const int8_t*>(b);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.snext = static_cast<const float*>(snext);
  a.y = y;
  a.n = n;
  a.h = h;
  a.w = w;
  a.ci = ci;
  a.co = co;
  a.m = n * h * w;
  a.ncols = convt ? 4 * co : co;
  a.k = convt ? ci : 9 * ci;
  a.kpad = kpad;
  a.out = out;
  if (a.m <= 0 || a.kpad % BK || a.kpad < a.k || (vec != 16 && vec != 4) ||
      ci % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (convt)
    err = vec == 16 ? launch<16, true>(a, st) : launch<4, true>(a, st);
  else
    err = vec == 16 ? launch<16, false>(a, st) : launch<4, false>(a, st);
  return static_cast<int>(err);
}
