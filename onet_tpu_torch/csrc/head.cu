// The JSD head loss, its backward, and the min-max/complement input pass,
// for sm_90a.
//
// Replaces the Pallas kernels of onet_tpu/ops/pallas_head.py:
//   _head_fwd_kernel    (via fused_jsd_loss)        onet_head_fwd
//   _head_bwd_kernel    (fused_jsd_loss's VJP)      onet_head_bwd
//   _minmax_comp_kernel (via minmax_complement,     onet_minmax_complement
//                        paired_input)
// The formulas are in onet_tpu_torch/ops/head.py, whose plain versions
// repeat this arithmetic in f32.
//
// What bounds them on the H100: bytes. At the train batch (8 x 512 x 512
// pixels, C = 64, bf16) the loss reads 1.07 GB (0.32 ms at 3.35 TB/s) and
// does ~20 flops and 4 log1pexp per pixel; its backward reads the same and
// writes as much again (0.64 ms). The min-max pass over the [8,512,512,1]
// f32 frames moves 25 MB: ~8 us, below a launch's own latency.
//
// Design.
//  * Head, both directions: G = 8 threads share one pixel's C channels,
//    each loading 16-byte vectors (one vector each at C = 64, bf16), so a
//    warp reads 4 pixels' contiguous rows; the pixel's four sums meet by a
//    butterfly shuffle, which leaves them in all 8 lanes. Loops advance a
//    warp at a time, so the shuffles never run with lanes missing. Rows
//    that are not a multiple of 16 bytes take a scalar path.
//  * Forward: a grid fixed by the pixel count alone (onet_head_fwd_blocks:
//    at most 1024 blocks of 32 pixel groups, whatever the card) walks the
//    pixels; every group adds its pixel's four-term sum into a double,
//    blocks write one double partial each, and head_fwd_reduce sums the
//    partials in a fixed order and divides by 2N. No atomics: the same
//    inputs give the same bits.
//  * Backward: the same walk, no reduction across pixels; the cotangent
//    scale dloss / (2N) is read from device memory (no host sync); the
//    gradients are written in the inputs' dtype.
//  * Min-max: two passes over a (chunk, frame) grid, so every SM has work
//    (one block per frame would leave 124 of 132 SMs idle): min_max_part
//    writes each 4096-element chunk's min and max; minmax_apply folds its
//    frame's partials, then writes xn = (x - lo) / (hi - lo + 1.1920929e-07)
//    and clip(1 - xn, 0, 1) for its chunk. Built without fast-math, so the
//    f32 division is IEEE and the result equals the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 8;                        // threads per pixel (head)
constexpr int PPB = THREADS / G;            // pixel groups per block
constexpr int PPW = 32 / G;                 // pixel groups per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_MAX_BLOCKS = 1024;        // forward partials, at most
constexpr int MM_CHUNK = THREADS * 16;      // elements per min-max block
constexpr float MM_EPS = 1.1920929e-07f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V elements at p (16 bytes when V * sizeof(T) == 16, else one element)
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* out) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (V * sizeof(T) == 16) {
    __align__(16) T o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f<T>(v[j]);
  }
}

// The reference's piecewise log1pexp (onet_tpu_torch/ops/math.py).
__device__ __forceinline__ float log1pexp(float x) {
  if (x <= -37.f) return expf(x);
  if (x <= 18.f) return log1pf(expf(x));
  if (x < 33.3f) return x + expf(-x);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Sums {
  float ct, cd, vt, vd;
};

// The four channel sums of pixel p, complete in all G lanes of its group.
// Called by whole warps; lanes of a pixel past the end (valid = false)
// contribute zeros.
template <typename T, int V>
__device__ __forceinline__ Sums pixel_sums(const T* lt, const T* ht,
                                           const T* ld, const T* hd,
                                           size_t base, int chunks, int g,
                                           bool valid) {
  Sums s = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    for (int k = g; k < chunks; k += G) {
      float a[V], b[V], e[V], f[V];
      load<T, V>(lt + base + k * V, a);
      load<T, V>(ht + base + k * V, b);
      load<T, V>(ld + base + k * V, e);
      load<T, V>(hd + base + k * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s.ct += a[j];
        s.vt += a[j] * b[j];
        s.cd += e[j];
        s.vd += e[j] * f[j];
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    s.ct += __shfl_xor_sync(FULL, s.ct, o);
    s.cd += __shfl_xor_sync(FULL, s.cd, o);
    s.vt += __shfl_xor_sync(FULL, s.vt, o);
    s.vd += __shfl_xor_sync(FULL, s.vd, o);
  }
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
head_fwd(const T* __restrict__ lt, const T* __restrict__ ht,
         const T* __restrict__ ld, const T* __restrict__ hd, long long npix,
         int c, double* __restrict__ part) {
  __shared__ double warp_sum[THREADS / 32];
  const int g = threadIdx.x % G, warp = threadIdx.x / 32;
  const int grp = (threadIdx.x % 32) / G;
  const int chunks = c / V;
  const long long stride = (long long)gridDim.x * PPB;
  double acc = 0.0;
  for (long long p0 = (long long)blockIdx.x * PPB + warp * PPW; p0 < npix;
       p0 += stride) {
    const long long p = p0 + grp;
    const bool valid = p < npix;
    const Sums s = pixel_sums<T, V>(lt, ht, ld, hd, (size_t)p * c, chunks, g,
                                    valid);
    if (valid && g == 0) {
      const float st = sigmoid(s.vt - s.vd);
      const float sd = 1.f - st;
      const float terms = log1pexp(-s.ct * st) + log1pexp(s.ct * sd) +
                          log1pexp(-s.cd * sd) + log1pexp(s.cd * st);
      acc += (double)terms;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (threadIdx.x % 32 == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) t += warp_sum[k];
    part[blockIdx.x] = t;
  }
}

// One block: the partials summed in a fixed order, / (2N), as f32.
__global__ void __launch_bounds__(THREADS)
head_fwd_reduce(const double* __restrict__ part, int nblk, long long npix,
                float* loss) {
  __shared__ double red[THREADS];
  double t = 0.0;
  for (int i = threadIdx.x; i < nblk; i += THREADS) t += part[i];
  red[threadIdx.x] = t;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = (float)(red[0] / (2.0 * (double)npix));
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
head_bwd(const T* __restrict__ lt, const T* __restrict__ ht,
         const T* __restrict__ ld, const T* __restrict__ hd,
         const float* __restrict__ scale_p, T* __restrict__ dlt,
         T* __restrict__ dht, T* __restrict__ dld, T* __restrict__ dhd,
         long long npix, int c) {
  const int g = threadIdx.x % G, warp = threadIdx.x / 32;
  const int grp = (threadIdx.x % 32) / G;
  const int chunks = c / V;
  const long long stride = (long long)gridDim.x * PPB;
  const float k = *scale_p;
  for (long long p0 = (long long)blockIdx.x * PPB + warp * PPW; p0 < npix;
       p0 += stride) {
    const long long p = p0 + grp;
    const bool valid = p < npix;
    const size_t base = (size_t)p * c;
    const Sums s = pixel_sums<T, V>(lt, ht, ld, hd, base, chunks, g, valid);
    if (!valid) continue;
    const float st = sigmoid(s.vt - s.vd);
    const float sd = 1.f - st;
    const float g1 = -sigmoid(-s.ct * st);
    const float g2 = sigmoid(s.ct * sd);
    const float g3 = -sigmoid(-s.cd * sd);
    const float g4 = sigmoid(s.cd * st);
    const float dct = (g1 * st + g2 * sd) * k;
    const float dcd = (g3 * sd + g4 * st) * k;
    const float dst = (g1 * s.ct + g4 * s.cd) * k;
    const float dsd = (g2 * s.ct + g3 * s.cd) * k;
    const float dvt = (dst - dsd) * st * sd;
    const float dvd = -dvt;
    for (int q = g; q < chunks; q += G) {
      const size_t off = base + q * V;
      float a[V], b[V], e[V], f[V], o[V];
      load<T, V>(lt + off, a);   // second read of the row: from L1/L2
      load<T, V>(ht + off, b);
      load<T, V>(ld + off, e);
      load<T, V>(hd + off, f);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = dct + dvt * b[j];
      store<T, V>(dlt + off, o);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = dvt * a[j];
      store<T, V>(dht + off, o);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = dcd + dvd * f[j];
      store<T, V>(dld + off, o);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = dvd * e[j];
      store<T, V>(dhd + off, o);
    }
  }
}

// Block-wide min and max; the result is valid in every thread.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[THREADS / 32], s_hi[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();                  // s_lo/s_hi free from an earlier call
  if (threadIdx.x % 32 == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int k = 1; k < THREADS / 32; ++k) {
    lo = fminf(lo, s_lo[k]);
    hi = fmaxf(hi, s_hi[k]);
  }
}

// grid (nchunk, frames): min and max of each chunk of each frame
template <typename T>
__global__ void __launch_bounds__(THREADS)
minmax_part(const T* __restrict__ x, long long m, float* __restrict__ pmin,
            float* __restrict__ pmax) {
  const T* xf = x + (size_t)blockIdx.y * m;
  const long long start = (long long)blockIdx.x * MM_CHUNK;
  const long long end = start + MM_CHUNK < m ? start + MM_CHUNK : m;
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float v = to_f(xf[i]);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    pmin[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = lo;
    pmax[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = hi;
  }
}

// grid (nchunk, frames): fold the frame's partials, write the chunk
template <typename T>
__global__ void __launch_bounds__(THREADS)
minmax_apply(const T* __restrict__ x, long long m,
             const float* __restrict__ pmin, const float* __restrict__ pmax,
             T* __restrict__ xn, T* __restrict__ xc) {
  float lo = INFINITY, hi = -INFINITY;
  const size_t row = (size_t)blockIdx.y * gridDim.x;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    lo = fminf(lo, pmin[row + i]);
    hi = fmaxf(hi, pmax[row + i]);
  }
  block_minmax(lo, hi);
  const float denom = hi - lo + MM_EPS;
  const size_t fo = (size_t)blockIdx.y * m;
  const long long start = (long long)blockIdx.x * MM_CHUNK;
  const long long end = start + MM_CHUNK < m ? start + MM_CHUNK : m;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float v = to_f(x[fo + i]);
    const float n = (v - lo) / denom;
    xn[fo + i] = from_f<T>(n);
    xc[fo + i] = from_f<T>(fminf(fmaxf(1.f - n, 0.f), 1.f));
  }
}

template <typename T, int V>
int launch_fwd(const void* lt, const void* ht, const void* ld, const void* hd,
               double* part, float* loss, long long npix, int c, int nblk,
               cudaStream_t st) {
  head_fwd<T, V><<<nblk, THREADS, 0, st>>>(
      static_cast<const T*>(lt), static_cast<const T*>(ht),
      static_cast<const T*>(ld), static_cast<const T*>(hd), npix, c, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_fwd_reduce<<<1, THREADS, 0, st>>>(part, nblk, npix, loss);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* lt, const void* ht, const void* ld, const void* hd,
               const float* scale, void* dlt, void* dht, void* dld, void* dhd,
               long long npix, int c, cudaStream_t st) {
  long long blocks = (npix + PPB - 1) / PPB;
  if (blocks > 4096) blocks = 4096;
  head_bwd<T, V><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(lt), static_cast<const T*>(ht),
      static_cast<const T*>(ld), static_cast<const T*>(hd), scale,
      static_cast<T*>(dlt), static_cast<T*>(dht), static_cast<T*>(dld),
      static_cast<T*>(dhd), npix, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_minmax(const void* x, float* part, void* xn, void* xc, int b,
                  long long m, cudaStream_t st) {
  const long long nchunk = (m + MM_CHUNK - 1) / MM_CHUNK;
  const dim3 grid((unsigned)nchunk, (unsigned)b);
  float* pmin = part;
  float* pmax = part + (size_t)b * nchunk;
  minmax_part<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), m, pmin,
                                           pmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  minmax_apply<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), m, pmin,
                                            pmax, static_cast<T*>(xn),
                                            static_cast<T*>(xc));
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points launch on `stream` and return the CUDA error code (0 on
// success). Tensors are contiguous; with vec, rows are multiples of 16 bytes
// and every pointer is 16-byte aligned (the wrapper checks).

// The forward's block count for npix pixels: its partials, and so the order
// of its sum, depend on the shape only.
extern "C" int onet_head_fwd_blocks(long long npix) {
  const long long b = (npix + PPB - 1) / PPB;
  return (int)(b < 1 ? 1 : (b > FWD_MAX_BLOCKS ? FWD_MAX_BLOCKS : b));
}

// loss (one f32) of the [npix][c] maps; part holds nblk doubles of scratch
// (nblk from onet_head_fwd_blocks).
extern "C" int onet_head_fwd(const void* lt, const void* ht, const void* ld,
                             const void* hd, double* part, float* loss,
                             long long npix, int c, int bf16, int vec,
                             int nblk, void* stream) {
  if (npix <= 0 || c <= 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? launch_fwd<__nv_bfloat16, 8>(lt, ht, ld, hd, part, loss,
                                              npix, c, nblk, st)
               : launch_fwd<__nv_bfloat16, 1>(lt, ht, ld, hd, part, loss,
                                              npix, c, nblk, st);
  return vec ? launch_fwd<float, 4>(lt, ht, ld, hd, part, loss, npix, c,
                                    nblk, st)
             : launch_fwd<float, 1>(lt, ht, ld, hd, part, loss, npix, c, nblk,
                                    st);
}

// The four gradients for the cotangent scale *scale = dloss / (2N).
extern "C" int onet_head_bwd(const void* lt, const void* ht, const void* ld,
                             const void* hd, const float* scale, void* dlt,
                             void* dht, void* dld, void* dhd, long long npix,
                             int c, int bf16, int vec, void* stream) {
  if (npix <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? launch_bwd<__nv_bfloat16, 8>(lt, ht, ld, hd, scale, dlt, dht,
                                              dld, dhd, npix, c, st)
               : launch_bwd<__nv_bfloat16, 1>(lt, ht, ld, hd, scale, dlt, dht,
                                              dld, dhd, npix, c, st);
  return vec ? launch_bwd<float, 4>(lt, ht, ld, hd, scale, dlt, dht, dld, dhd,
                                    npix, c, st)
             : launch_bwd<float, 1>(lt, ht, ld, hd, scale, dlt, dht, dld, dhd,
                                    npix, c, st);
}

// Chunks per frame of m elements: part holds 2 * frames * chunks floats.
extern "C" int onet_minmax_chunks(long long m) {
  return (int)((m + MM_CHUNK - 1) / MM_CHUNK);
}

// x [b][m] -> xn, xc [b][m] (both may lie in one buffer, apart).
extern "C" int onet_minmax_complement(const void* x, float* part, void* xn,
                                      void* xc, int b, long long m, int bf16,
                                      void* stream) {
  if (b <= 0 || m <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_minmax<__nv_bfloat16>(x, part, xn, xc, b, m, st)
              : launch_minmax<float>(x, part, xn, xc, b, m, st);
}
