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
//         A = x[n, y + dy - 1, x + dx - 1, ci] (zero outside: the SAME
//         padding), B[co][k] = w[dy, dx, ci, co];
//   convT: pixel = (n, i, j) of the input, col = (di, dj, co), k = ci,
//         A = x[n, i, j, ci], B[(di, dj, co)][ci] = w[di, dj, ci, co] of the
//         unflipped kernel; the epilogue writes col to the output pixel
//         (2i + di, 2j + dj).
// The wrapper (ops/conv_i8.py) pads ci with zero codes to cip (32, or a
// multiple of 64) and lays B out once per call, [cols][kpad] with kpad =
// 9 cip or cip, K contiguous; zero codes add zero products: exact.
//
// Epilogue (out mode), per column channel o, in the plain version's order
// and rounding, without FMA contraction:
//   I32   acc
//   F32   v = acc * scale[o] (+ bias[o])        __fmul_rn, __fadd_rn
//   U8    clamp(rint(v / snext[o]), 0, 127)     __fdiv_rn, round half even
//   S8    clamp(rint(v / snext[o]), -127, 127)
//   U8X2  U8 at snext and U8 at snext2, two tensors from one accumulator
//         (the sites whose output feeds a skip and the next conv)
// so the codes are bit-equal to the plain version's (ops/conv_i8.py, which
// computes the accumulator exactly in float64).
//
// What bounds it on the H100. A 3x3 site at 512^2 (batch 8) does
// 2 * 8 * 512^2 * 9 ci co operations: up4.conv1 (ci 256, co 128) 1.24 T,
// 0.625 ms at 1979 dense int8 TOP/s against 0.27 GB in and out, 0.08 ms at
// 3.35 TB/s. The ci >= 128 sites are operations-bound; inc.conv1 (ci 2),
// the f32 outputs and the transposed convs (K = ci, one tap) bytes-bound.
// Two costs stand between the kernel and those bounds: the tensor cores'
// feed (each 128 x 128 tile reads its A once a tap and its B once, from
// L2 into shared memory, and wgmma reads both from there) and the
// epilogue, which divides every output by its scale correctly rounded
// (the multi-function unit's rate) and writes it.
//
// Design (one main loop, conv_i8<CK, CONVT>):
//  * tile: 128 pixels x 128 columns, the pixels one image's block of bh
//    rows x bw columns (bw = 128, 64, 32 ... as W allows, bw bh = 128);
//    column tiles fastest, so the CTAs that share a block of x run
//    together and read it from L2;
//  * operands by TMA: a 4-D tensor map over x [n, h, w, cip] with box
//    {CK ci, bw, bh, 1}; tap (dy, dx) of ci block c is the box at
//    (c, x0 + dx - 1, y0 + dy - 1, n): the hardware's zero fill of what
//    lies outside x is the SAME padding and the ragged edge, no predicate
//    in the kernel. The transposed conv is the same loop with one
//    unshifted tap. B by a 2-D map over [cols, kpad], box {CK, 128};
//  * K steps of CK bytes of ci (128 where cip allows, else 64 or 32), each
//    a stage of a 96 KB ring (3, 6 or 12 stages), landed in the CK-byte
//    swizzle that the tensor cores' descriptors read (no bank conflicts);
//  * products: wgmma.mma_async m64n128k32 .s32.s8.s8, both operands
//    K-major in shared memory; two warpgroups, 64 pixels each, 64 int32
//    accumulators a thread; each warp releases a stage on its "empty"
//    mbarrier once the wgmma that read it have completed (wait_group 1
//    keeps one in flight);
//  * persistent, two CTAs an SM (105 KB of shared memory and 128 registers
//    a thread each), so one CTA's epilogue overlaps the other's products.
//    Thread 0 is the producer: it fills the ring against "full" mbarriers
//    (transaction bytes) and refills each slot as the 8 warps release it,
//    running on into the next tile while this one's epilogue runs. (A
//    producer warp of its own would put five warps on some quarter of the
//    SM, capping a thread at 96 registers; ptxas spilled there.) Against
//    one CTA a tile, whose start and epilogue nothing overlapped, the
//    persistent loop took 45% off the transposed convs;
//  * epilogue: in the slot of the tile's last stage (released after it,
//    the others already loading), per-column scale, bias, snext and y
//    offsets staged once a tile; the outputs (one or two code tensors, or
//    int32 / f32 in passes) staged in 16-byte chunks XOR-swizzled by row,
//    then stored as whole runs: a 3x3 tile row is one pixel's channels,
//    consecutive rows consecutive pixels; a transposed-conv tile row is,
//    for each di, a run of 2 co columns (dj, o) of y[n, 2i + di,
//    2j .. 2j + 1, :]. rint, the clamp and the conversion to int are one
//    exact add of 1.5 2^23;
//  * what it reaches: the ops-bound sites a quarter to a half of their
//    bound (the 64-accumulator tile: wgmma's operand reads and the TMA's
//    writes come near shared memory's 128 B a clock an SM), the transposed
//    convs under torch._int_mm's bare GEMM (runs/i8_probe.py). Tiles of
//    128 x 256 with 128 accumulators a thread need one CTA an SM, whose
//    epilogue then wants a second tile in flight (ping-pong warpgroups).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // pixels of a tile
constexpr int BN = 128;                  // columns of a tile
constexpr int THREADS = 256;             // two consumer warpgroups
constexpr int RING = 96 * 1024;          // the stage ring, bytes
constexpr int OFF_BAR = RING;            // 2 x at most 12 stages x 8 bytes
constexpr int OFF_ROWS = RING + 256;     // 128 row offsets in y
constexpr int OFF_COLS = OFF_ROWS + BM * 8;  // 5 x 128 column constants
constexpr int SMEM = OFF_COLS + 5 * BN * 4 + 1024;  // + alignment slack
constexpr uint64_t NO_ROW = ~0ull;       // a tile row outside y
static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs an SM");

enum { OUT_I32 = 0, OUT_F32 = 1, OUT_U8 = 2, OUT_S8 = 3, OUT_U8X2 = 4 };

struct Args {
  const float* scale;    // [co]
  const float* bias;     // [co] or null
  const float* snext;    // [co] (U8, S8, U8X2)
  const float* snext2;   // [co] (U8X2)
  void* y;               // [n, h, w, co] (3x3) or [n, 2h, 2w, co] (convT)
  void* y2;              // U8X2's second codes, as y
  int h, w, cip, co;
  int ncols;             // co (3x3) or 4 co (convT)
  int bw;                // a tile's pixel columns; bh = BM / bw rows
  int tx, ty;            // tiles across a row of x, down an image
  int ntn;               // column tiles
  int tiles;             // n tx ty ntn
  int out;
};

// Tile t: column tile t % ntn of pixel tile t / ntn (image nb, first row
// y0, first column x0), first column n0.
struct Tile {
  int nb, y0, x0, n0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int mt = t / a.ntn;
  Tile tl;
  tl.n0 = (t - mt * a.ntn) * BN;
  tl.x0 = (mt % a.tx) * a.bw;
  tl.y0 = ((mt / a.tx) % a.ty) * (BM / a.bw);
  tl.nb = mt / a.tx / a.ty;
  return tl;
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait of 2^34 clocks (seconds) is a deadlock: trap, so the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// Box {CK, bw, bh, 1} of the 4-D map of x at (c, x, y, n); what lies
// outside x lands as zeros.
__device__ __forceinline__ void tma_x(uint32_t dst, const CUtensorMap* map,
                                      int c, int x, int y, int n,
                                      uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(n),
      "r"(bar)
      : "memory");
}

// Box {CK, BN} of the 2-D map of B at (k, col).
__device__ __forceinline__ void tma_b(uint32_t dst, const CUtensorMap* map,
                                      int k, int col, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(col), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma descriptor of a K-major operand in the CK-byte swizzle starting at
// shared address `addr`: rows of CK bytes, 8 rows a swizzle atom (stride
// 8 CK); the leading offset is unused. Layout 1: 128-byte swizzle, 2:
// 64-byte, 3: 32-byte.
template <int CK>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t layout = CK == 128 ? 1 : CK == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((8 * CK) >> 4) << 32 | layout << 62;
}

#define ACC8(i)                                                             \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] += A B, m64n128k32, s8 in, s32 accumulate, A (64 pixels x 32 k) and
// B (32 k x 128 columns) both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b));
}

#undef ACC8

// The int8 code of v at scale s, clamped to [lo, 127], in the low byte:
// clamp(rint(v / s), lo, 127) with the division correctly rounded. q is
// held to [-256, 256] (a NaN goes to -256: the clamp gives lo, as the
// clamp of rint(NaN) does), then 1.5 2^23 + q rounds q half to even into
// the low bits of the sum: rint and the conversion to int in one add.
__device__ __forceinline__ uint32_t code(float v, float s, int lo) {
  const float q = fminf(fmaxf(__fdiv_rn(v, s), -256.f), 256.f);
  const int c = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000;
  return static_cast<uint32_t>(max(min(c, 127), lo)) & 0xffu;
}

// The epilogue of one tile: acc (as wgmma leaves it) through the out
// mode into `stg` (a ring slot, 256 CK bytes), then out to y in 16-byte
// chunks. A pass stages `pc` columns of one output tensor, 2 CK bytes a
// row, the 16-byte chunks of row r XOR-swizzled by r (no bank conflicts);
// consecutive threads store consecutive chunks of a row: a 3x3 row's
// columns are contiguous in y, and so is each run of 2 co columns (dj, o)
// of a transposed-conv row (cofs). nc: the tile's columns inside y.
template <int CK>
__device__ __forceinline__ void epilogue(
    const Args& a, const int (&acc)[64], unsigned char* stg,
    const uint64_t* rows, const float* cs, const float* cb, const float* cn,
    const float* cn2, const int* cofs, int nc) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool wide = a.out == OUT_I32 || a.out == OUT_F32;
  const int es = wide ? 4 : 1;
  const int pc = min(BN, 2 * CK / es);   // columns a pass
  const int rs = pc * es;                // bytes of a staged row
  const int nch = rs >> 4;               // its 16-byte chunks: 4 to 16
  const int per = 16 / es;               // columns a chunk
  const int lo = a.out == OUT_S8 ? -127 : 0;
  const bool vec = (a.co * es) % 16 == 0;
  // acc[4 j + e]: row r0 + 8 (e >> 1), column 8 j + 2 (lane % 4) + (e & 1)
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int blocks = BN / pc;
  for (int ps = 0; ps < (a.out == OUT_U8X2 ? 2 : 1) * blocks; ++ps) {
    const bool second = ps >= blocks;
    const int cl = (ps - (second ? blocks : 0)) * pc;
    const float* sn = second ? cn2 : cn;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j < cl || 8 * j >= cl + pc) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = r0 + 8 * e2;
        const int c = 8 * j + 2 * (lane & 3);
        uint32_t u[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = acc[4 * j + 2 * e2 + e];
          if (a.out == OUT_I32) {
            u[e] = static_cast<uint32_t>(v);
            continue;
          }
          // acc * scale (+ bias), rounded after each operation
          float f = __fmul_rn(__int2float_rn(v), cs[c + e]);
          if (a.bias) f = __fadd_rn(f, cb[c + e]);
          u[e] = a.out == OUT_F32 ? __float_as_uint(f)
                                  : code(f, sn[c + e], lo);
        }
        const int ob = (c - cl) * es;
        unsigned char* dst =
            stg + r * rs + (((ob >> 4) ^ (r & (nch - 1))) << 4) + (ob & 15);
        if (wide)
          *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
        else
          *reinterpret_cast<uint16_t*>(dst) =
              static_cast<uint16_t>(u[0] | u[1] << 8);
      }
    }
    bar_sync(1, THREADS);
    unsigned char* y = static_cast<unsigned char*>(second ? a.y2 : a.y);
    for (int i = tid; i < BM * nch; i += THREADS) {
      const int r = i / nch, k = i - r * nch;
      const int c = cl + k * per;
      const uint64_t off = rows[r];
      if (off == NO_ROW || c >= nc) continue;
      const unsigned char* src = stg + r * rs + ((k ^ (r & (nch - 1))) << 4);
      if (vec && c + per <= nc) {
        *reinterpret_cast<int4*>(y + (off + cofs[c]) * es) =
            *reinterpret_cast<const int4*>(src);
      } else {
        for (int q = 0; q < per && c + q < nc; ++q)
          for (int bt = 0; bt < es; ++bt)
            y[(off + cofs[c + q]) * es + bt] = src[q * es + bt];
      }
    }
    bar_sync(1, THREADS);  // read before it is restaged or released
  }
}

template <int CK, bool CONVT>
__global__ void __launch_bounds__(THREADS, 2)
    conv_i8(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_b, const Args a) {
  constexpr int STAGE_A = BM * CK, STAGE = (BM + BN) * CK;
  constexpr int STAGES = RING / STAGE;
  static_assert(STAGES >= 3 && STAGES <= 12, "ring");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  uint64_t* rows = reinterpret_cast<uint64_t*>(smem + OFF_ROWS);
  // per column of the tile: scale, bias, snext, snext2, offset in a row
  float* cs = reinterpret_cast<float*>(smem + OFF_COLS);
  float* cb = cs + BN;
  float* cn = cb + BN;
  float* cn2 = cn + BN;
  int* cofs = reinterpret_cast<int*>(cn2 + BN);
  const int tid = threadIdx.x;
  const int cblocks = a.cip / CK;
  const int nk = (CONVT ? 1 : 9) * cblocks;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: CTA b takes tiles b, b + grid, ...; stage g of its K
  // steps (all tiles in a row) goes to slot g % STAGES. Thread 0 is the
  // producer: it fills the ring, then refills a slot each time the 8 warps
  // have released one (the next tile's first stages load while this one's
  // epilogue runs). pt, pk, pg: the tile, K step and stage it loads next.
  int pt = blockIdx.x, pk = 0;
  uint32_t pg = 0;
  auto produce = [&]() {
    if (pt >= a.tiles) return;
    const int s = pg % STAGES;
    mbar_wait(empty + 8 * s, ((pg / STAGES) & 1) ^ 1);
    const Tile tl = tile_of(a, pt);
    const int tap = pk / cblocks, c0 = (pk - tap * cblocks) * CK;
    const int dy = CONVT ? 0 : tap / 3 - 1, dx = CONVT ? 0 : tap % 3 - 1;
    const uint32_t st = base + s * STAGE;
    mbar_expect_tx(full + 8 * s, STAGE);
    tma_x(st, &map_x, c0, tl.x0 + dx, tl.y0 + dy, tl.nb, full + 8 * s);
    tma_b(st + STAGE_A, &map_b, tap * a.cip + c0, tl.n0, full + 8 * s);
    ++pg;
    if (++pk == nk) {
      pk = 0;
      pt += gridDim.x;
    }
  };
  if (tid == 0)
    for (int i = 0; i < STAGES; ++i) produce();

  // warpgroup wg multiplies pixels 64 wg .. 64 wg + 63
  const int wg = tid >> 7, lane = tid & 31;
  uint32_t g = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kb = 0; kb < nk; ++kb, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      const uint32_t st = base + s * STAGE;
      const uint64_t da = desc<CK>(st + wg * 64 * CK);
      const uint64_t db = desc<CK>(st + STAGE_A);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < CK / 32; ++ks)  // 32 bytes on: 2 16-byte units
        wgmma_s8(acc, da + 2 * ks, db + 2 * ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's group is done: release its slot
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kb > 0) {
        if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
        if (tid == 0) produce();
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    // epilogue, staged in the tile's last slot, released at its end (the
    // producer fills the others with the next tile's first stages); first
    // the tile's row offsets in y and column constants
    bar_sync(1, THREADS);  // both groups are done reading the slot
    const Tile tl = tile_of(a, t);
    if (tid < BM) {
      const int yy = tl.y0 + tid / a.bw, xx = tl.x0 + tid % a.bw;
      uint64_t off = NO_ROW;
      if (yy < a.h && xx < a.w)
        off = CONVT ? (((uint64_t)tl.nb * 2 * a.h + 2 * yy) * 2 * a.w +
                       2 * xx) * a.co
                    : (((uint64_t)tl.nb * a.h + yy) * a.w + xx) * a.co;
      rows[tid] = off;
    } else {
      const int c = tid - BM, col = min(tl.n0 + c, a.ncols - 1);
      const int o = CONVT ? col % a.co : col;
      cs[c] = a.scale ? __ldg(a.scale + o) : 0.f;
      cb[c] = a.bias ? __ldg(a.bias + o) : 0.f;
      cn[c] = a.snext ? __ldg(a.snext + o) : 1.f;
      cn2[c] = a.snext2 ? __ldg(a.snext2 + o) : 1.f;
      // (di, dj, o) of the transposed conv: y[n, 2i + di, 2j + dj, o]
      cofs[c] = CONVT ? col / (2 * a.co) * 2 * a.w * a.co + col % (2 * a.co)
                      : col;
    }
    bar_sync(1, THREADS);
    epilogue<CK>(a, acc, smem + ((g - 1) % STAGES) * STAGE, rows, cs, cb,
                 cn, cn2, cofs, min(BN, a.ncols - tl.n0));
    // the slot's generic reads and writes before the producer's next TMA
    // write to it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    if (tid == 0) produce();
  }
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

// A map of int8 elements, `rank` dims innermost first, box `box`, in the
// ck-byte swizzle; elements outside the tensor load as zeros.
int make_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
             const cuuint32_t* box, int ck) {
  cuuint64_t strides[3];
  cuuint64_t s = 1;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = ck == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : ck == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int CK, bool CONVT>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mb,
                   const Args& a, cudaStream_t st) {
  static int sms[32] = {};  // a device's SMs, once its attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(conv_i8<CK, CONVT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  // two persistent CTAs an SM, or one a tile where there are fewer
  const int grid = a.tiles < 2 * sms[dev] ? a.tiles : 2 * sms[dev];
  conv_i8<CK, CONVT><<<grid, THREADS, SMEM, st>>>(mx, mb, a);
  return cudaGetLastError();
}

}  // namespace

// x [n, h, w, cip] int8 NHWC; b [ncols, kpad] int8 (ops/conv_i8.py lays it
// out, kpad = 9 cip or cip); y (and y2) as the out mode says. convt: 0 for
// the 3x3 SAME conv, 1 for the 2x2 stride-2 transposed conv. ck: the K step
// (128, 64 or 32 bytes; cip a multiple of it); bw: a tile's pixel columns (a
// power of two up to 128). Returns the CUDA error of the launch (0:
// launched).
extern "C" int onet_conv_i8(const void* x, const void* b, const void* scale,
                            const void* bias, const void* snext,
                            const void* snext2, void* y, void* y2, int n,
                            int h, int w, int cip, int co, int convt, int ck,
                            int bw, int out, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || co <= 0 || out < 0 || out > OUT_U8X2 ||
      (ck != 32 && ck != 64 && ck != 128) || cip % ck || bw < 1 || bw > BM ||
      BM % bw ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15))
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorSymbolNotFound;
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  Args a;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.snext = static_cast<const float*>(snext);
  a.snext2 = static_cast<const float*>(snext2);
  a.y = y;
  a.y2 = y2;
  a.h = h;
  a.w = w;
  a.cip = cip;
  a.co = co;
  a.ncols = convt ? 4 * co : co;
  a.bw = bw;
  a.tx = (w + bw - 1) / bw;
  a.ty = (h + BM / bw - 1) / (BM / bw);
  a.ntn = (a.ncols + BN - 1) / BN;
  a.out = out;
  const long tiles = (long)n * a.tx * a.ty * a.ntn;
  if (tiles > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const int kpad = (convt ? 1 : 9) * cip;
  CUtensorMap mx, mb;
  const cuuint64_t dx[4] = {(cuuint64_t)cip, (cuuint64_t)w, (cuuint64_t)h,
                            (cuuint64_t)n};
  const cuuint32_t bx[4] = {(cuuint32_t)ck, (cuuint32_t)bw,
                            (cuuint32_t)(BM / bw), 1};
  const cuuint64_t db[2] = {(cuuint64_t)kpad, (cuuint64_t)a.ncols};
  const cuuint32_t bb[2] = {(cuuint32_t)ck, (cuuint32_t)BN};
  int bad = make_map(&mx, x, 4, dx, bx, ck);
  if (!bad) bad = make_map(&mb, b, 2, db, bb, ck);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (convt)
    err = ck == 128  ? launch<128, true>(mx, mb, a, st)
          : ck == 64 ? launch<64, true>(mx, mb, a, st)
                     : launch<32, true>(mx, mb, a, st);
  else
    err = ck == 128  ? launch<128, false>(mx, mb, a, st)
          : ck == 64 ? launch<64, false>(mx, mb, a, st)
                     : launch<32, false>(mx, mb, a, st);
  return (int)err;
}

// CTAs of conv_i8<ck, convt> an SM can hold (the design wants 2), or
// -(CUDA error).
extern "C" int onet_conv_i8_occupancy(int ck, int convt) {
  int blocks = 0;
  const void* fn =
      convt ? (ck == 128  ? (const void*)conv_i8<128, true>
               : ck == 64 ? (const void*)conv_i8<64, true>
                          : (const void*)conv_i8<32, true>)
            : (ck == 128  ? (const void*)conv_i8<128, false>
               : ck == 64 ? (const void*)conv_i8<64, false>
                          : (const void*)conv_i8<32, false>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                        SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}
