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
//  * Min-max: one launch, minmax_cluster, over a (K, frame) grid whose
//    clusters are the K CTAs of one frame (K from onet_minmax_setup, set at
//    launch time through cudaLaunchKernelEx; up to 16, above 8 as a
//    non-portable size). CTA r owns a contiguous share of its frame.
//    Resident form (the share fits 200 KB of shared memory): the threads
//    load the share's 16-byte aligned body with 16-byte loads, 8 in flight
//    each, copy it to shared memory and fold min/max as it arrives; the
//    unaligned head and tail come in as scalars (TMA bulk copies loaded
//    the share more slowly, PERF.md). Each CTA then pushes its
//    (lo, hi) into a slot of every peer's shared memory (mapa + st.async,
//    completing 8 bytes on that peer's mbarrier) and waits on its own
//    mbarrier for the K pairs: one notification, no cluster barrier around
//    the exchange and none at exit (a CTA passes its wait only after every
//    push into it has landed); pulling the pairs between two cluster
//    barriers took twice as long. The mbarrier's initialisation is published
//    by a split cluster barrier whose wait comes after the load. xn = (x -
//    lo) / (hi - lo + 1.1920929e-07) and clip(1 - xn, 0, 1) are then
//    written from the on-chip copy with 16-byte stores, so x is read from
//    HBM once (3 x 8 MiB moved at [8,512,512,1] f32). Streaming form (a
//    share too large even at K = 16, e.g. a 1024 x 1500 f32 frame): the
//    same launch folds while it streams its share from global memory,
//    exchanges, then reads the share again (mostly from L2). Each output's
//    16-byte body is aligned on its own address, with scalar edges, so
//    frames of any size and paired_input's second half (an offset of B * m
//    elements) take any alignment. min/max are min.NaN/max.NaN and the
//    clamp keeps a NaN, as jnp.min/jnp.max/jnp.clip and torch's
//    amin/amax/clamp. Built without fast-math, so the f32 division is IEEE
//    and the result equals the plain version's bits. A trace pointer, null
//    on the main path, lets runs/minmax_probe.py read each CTA's SM and the
//    clocks of its load, exchange and write phases.

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
constexpr float MM_EPS = 1.1920929e-07f;
constexpr int MM_THREADS = 512;
constexpr int MM_WARPS = MM_THREADS / 32;
constexpr int MM_KMAX = 16;                 // CTAs a frame, at most
constexpr long long MM_BUDGET = 200 * 1024; // a resident share, at most
constexpr long long MM_MIN_SHARE = 32768;   // bytes a raised K leaves a CTA
constexpr int MM_SPREAD = 116 * 1024;       // more than half an SM's 228 KB
constexpr int MM_BATCH = 8;                 // 16-byte loads in flight a thread
// shared memory: the exchange's mbarrier, the warps' (lo, hi), the K CTAs'
// pairs, then the share (shifted by the share's address mod 16, so its
// aligned body lands on 16-byte boundaries)
constexpr int MM_OFF_PAIRS = 16;
constexpr int MM_OFF_SLOTS = MM_OFF_PAIRS + MM_WARPS * 8;
constexpr int MM_HEADER = 512;
static_assert(MM_OFF_SLOTS + 8 * MM_KMAX <= MM_HEADER, "header");
static_assert(MM_HEADER + MM_BUDGET + 16 <= 232448, "227 KB a block");

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

// ---- min-max: NaN-propagating folds, the cluster exchange

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clip(v, 0, 1), a NaN kept (torch.clamp, jnp.clip)
__device__ __forceinline__ float clip01(float v) {
  return nan_min(nan_max(v, 0.f), 1.f);
}

__device__ __forceinline__ void fold(float v, float& lo, float& hi) {
  lo = nan_min(lo, v);
  hi = nan_max(hi, v);
}

template <typename T>
__device__ __forceinline__ void fold16(const uint4& raw, float& lo,
                                       float& hi) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) fold(to_f(e[j]), lo, hi);
}

__device__ __forceinline__ int mis16(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Elements of T before p reaches a 16-byte boundary, at most n.
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int n) {
  const int h = ((16 - mis16(p)) & 15) / (int)sizeof(T);
  return h < n ? h : n;
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

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// (lo, hi) into the pair at shared address `addr` of CTA `rank` of the
// cluster, completing 8 bytes of the transaction on its barrier at `bar`.
__device__ __forceinline__ void push_pair(uint32_t addr, uint32_t bar,
                                          int rank, float lo, float hi) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[ra], {%3, %4}, [rb];\n}\n" ::"r"(addr),
      "r"(bar), "r"(rank), "f"(lo), "f"(hi)
      : "memory");
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(FULL, lo, o));
    hi = nan_max(hi, __shfl_xor_sync(FULL, hi, o));
  }
}

// min and max of g[0, n) in global memory: 16-byte loads over the aligned
// body, scalars at the edges.
template <typename T>
__device__ __forceinline__ void fold_global(const T* g, int n, float& lo,
                                            float& hi) {
  constexpr int V = 16 / sizeof(T);
  const int head = head_of(g, n);
  const int nv = (n - head) / V, tail0 = head + nv * V;
  const int tid = threadIdx.x;
  if (tid < head) fold(to_f(g[tid]), lo, hi);
  if (tid < n - tail0) fold(to_f(g[tail0 + tid]), lo, hi);
  const uint4* body = reinterpret_cast<const uint4*>(g + head);
#pragma unroll 4
  for (int i = tid; i < nv; i += MM_THREADS) fold16<T>(__ldg(body + i), lo, hi);
}

// xn (WHICH & 1) and xc (WHICH & 2) of src[0, n) (shared or global memory):
// 16-byte stores over the outputs' aligned body, scalars at the edges; with
// WHICH == 3 both outputs lie at the same address mod 16. src is read in
// 16-byte vectors where it lies as the outputs do, else by element.
template <typename T, int WHICH>
__device__ __forceinline__ void write_range(const T* src, T* on, T* oc, int n,
                                            float lo, float denom) {
  constexpr int V = 16 / sizeof(T);
  const int head = head_of(WHICH & 1 ? on : oc, n);
  const int nv = (n - head) / V, tail0 = head + nv * V;
  const int tid = threadIdx.x;
  auto element = [&](int i) {
    const float v = (to_f(src[i]) - lo) / denom;
    if (WHICH & 1) on[i] = from_f<T>(v);
    if (WHICH & 2) oc[i] = from_f<T>(clip01(1.f - v));
  };
  if (tid < head) element(tid);
  if (tid < n - tail0) element(tail0 + tid);
  const bool vec = mis16(src + head) == 0;
  const T* sb = src + head;
  T* obn = on + head;
  T* obc = oc + head;
#pragma unroll 4
  for (int i = tid; i < nv; i += MM_THREADS) {
    const T* p = sb + i * V;
    float a[V], c[V];
    if (vec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] = to_f(p[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = (a[j] - lo) / denom;
      c[j] = clip01(1.f - a[j]);
    }
    if (WHICH & 1) store<T, V>(obn + i * V, a);
    if (WHICH & 2) store<T, V>(obc + i * V, c);
  }
}

template <typename T>
__device__ __forceinline__ void write_share(const T* src, T* on, T* oc, int n,
                                            float lo, float denom) {
  if (mis16(on) == mis16(oc)) {
    write_range<T, 3>(src, on, oc, n, lo, denom);
  } else {  // paired_input's second half, b * m elements on
    write_range<T, 1>(src, on, oc, n, lo, denom);
    write_range<T, 2>(src, on, oc, n, lo, denom);
  }
}

// grid (k, frames), cluster (k, 1, 1): CTA r of frame b owns elements
// [r * share, (r + 1) * share) of it. Dynamic shared memory: resident
// (streaming == 0) MM_HEADER + share * sizeof(T) + 16 bytes, streaming
// MM_HEADER.
template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
minmax_cluster(const T* __restrict__ x, T* __restrict__ xn,
               T* __restrict__ xc, long long m, long long share, int k,
               int streaming, unsigned long long* __restrict__ trace) {
  extern __shared__ __align__(128) unsigned char mm_smem[];
  long long clk[4];
  unsigned long long t0 = 0;
  if (trace) {
    t0 = global_ns();
    clk[0] = clock64();
  }
  const uint32_t xbar = smem_addr(mm_smem);
  if (k > 1) {
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_expect_tx(xbar, 8 * k);  // its one arrival: K pairs to come
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();  // waited on before the first push
  }
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long start = (long long)blockIdx.x * share;
  const int n = start >= m ? 0 : (int)(m - start < share ? m - start : share);
  const size_t fo = (size_t)blockIdx.y * m + start;
  const T* g = x + fo;
  float* pairs = reinterpret_cast<float*>(mm_smem + MM_OFF_PAIRS);
  float lo = INFINITY, hi = -INFINITY;
  // the share on chip: element i at s[i], s placed as g mod 16
  T* s = reinterpret_cast<T*>(mm_smem + MM_HEADER + mis16(g));
  if (!streaming) {
    const int head = head_of(g, n);
    const int nv = (n - head) / V, tail0 = head + nv * V;
    // the edges by element, beside the body
    if (tid < head) {
      const T v = g[tid];
      s[tid] = v;
      fold(to_f(v), lo, hi);
    }
    if (tid < n - tail0) {
      const T v = g[tail0 + tid];
      s[tail0 + tid] = v;
      fold(to_f(v), lo, hi);
    }
    uint4* body = reinterpret_cast<uint4*>(s + head);
    // 16-byte loads, MM_BATCH a thread in flight, copied and folded
    const uint4* gb = reinterpret_cast<const uint4*>(g + head);
    for (int i0 = tid; i0 < nv; i0 += MM_BATCH * MM_THREADS) {
      uint4 v[MM_BATCH];
#pragma unroll
      for (int j = 0; j < MM_BATCH; ++j)
        if (i0 + j * MM_THREADS < nv) v[j] = __ldg(gb + i0 + j * MM_THREADS);
#pragma unroll
      for (int j = 0; j < MM_BATCH; ++j)
        if (i0 + j * MM_THREADS < nv) {
          body[i0 + j * MM_THREADS] = v[j];
          fold16<T>(v[j], lo, hi);
        }
    }
  } else {
    fold_global<T>(g, n, lo, hi);
  }
  if (trace) clk[1] = clock64();
  // the CTA's (lo, hi) in every thread; the __syncthreads also makes the
  // edges' shared stores visible to every thread
  warp_minmax(lo, hi);
  if (lane == 0) {
    pairs[2 * warp] = lo;
    pairs[2 * warp + 1] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MM_WARPS; ++w) {
    lo = nan_min(lo, pairs[2 * w]);
    hi = nan_max(hi, pairs[2 * w + 1]);
  }
  if (k > 1) {
    float* slots = reinterpret_cast<float*>(mm_smem + MM_OFF_SLOTS);
    cluster_wait();  // every peer's barrier is initialised
    if (tid < k)
      push_pair(smem_addr(slots + 2 * cluster_rank()), xbar, tid, lo, hi);
    mbar_wait(xbar, 0);
    for (int r = 0; r < k; ++r) {
      lo = nan_min(lo, slots[2 * r]);
      hi = nan_max(hi, slots[2 * r + 1]);
    }
  }
  if (trace) clk[2] = clock64();
  const float denom = hi - lo + MM_EPS;
  if (!streaming)
    write_share<T>(s, xn + fo, xc + fo, n, lo, denom);
  else
    write_share<T>(g, xn + fo, xc + fo, n, lo, denom);
  if (trace) {
    clk[3] = clock64();
    const unsigned long long t1 = global_ns();
    if (tid == 0) {
      unsigned long long* r =
          trace + 8 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
      r[0] = sm_id();
      r[1] = t0;
      r[2] = t1;
      for (int i = 0; i < 3; ++i) r[3 + i] = clk[i + 1] - clk[i];
    }
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

// A frame's share per CTA at k CTAs: a multiple of 64 elements, so shares
// of aligned frames start aligned.
long long mm_share(long long m, int k) {
  return ((m + k - 1) / k + 63) / 64 * 64;
}

// Dynamic shared memory of a launch: the header, and a resident share.
int mm_smem_bytes(long long m, int k, int es, int streaming) {
  return MM_HEADER + (streaming ? 0 : (int)(mm_share(m, k) * es) + 16);
}

// The launch of minmax_cluster<T> on b frames at k CTAs a frame: its
// cluster dimension set at run time.
template <typename T>
struct MinmaxLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  MinmaxLaunch(int b, int k, int smem, cudaStream_t st) {
    cfg.gridDim = dim3((unsigned)k, (unsigned)b);
    cfg.blockDim = dim3(MM_THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of k CTAs (smem bytes each) the card holds at once;
// negative: -(CUDA error).
template <typename T>
int mm_clusters(int b, int k, int smem) {
  MinmaxLaunch<T> l(b, k, smem, nullptr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, (const void*)minmax_cluster<T>, &l.cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int setup_minmax(int b, long long m, int k_req, int* k_out, int* smem_out,
                 int* streaming_out) {
  const int es = (int)sizeof(T);
  const void* fn = (const void*)minmax_cluster<T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MM_HEADER + (int)MM_BUDGET + 16);
  if (err != cudaSuccess) return -(int)err;
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return -(int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -(int)err;
  auto fits = [&](int k) { return mm_share(m, k) * es <= MM_BUDGET; };
  // with the batch's CTAs within the SM count, a CTA an SM: two on one SM
  // would halve its share of the memory system
  auto smem_of = [&](int k) {
    const int need = mm_smem_bytes(m, k, es, !fits(k));
    return (long long)b * k <= sms && need < MM_SPREAD ? MM_SPREAD : need;
  };
  int k = k_req;
  if (k_req <= 0) {
    // the smallest K whose share stays on chip (else 16, streaming)
    int kmin = 1;
    while (kmin < MM_KMAX && !fits(kmin)) kmin *= 2;
    // raised while the batch's CTAs stay within the SM count and each
    // share keeps MM_MIN_SHARE bytes
    int kmax = kmin;
    while (kmax < MM_KMAX && (long long)b * 2 * kmax <= sms &&
           mm_share(m, 2 * kmax) * es >= MM_MIN_SHARE)
      kmax *= 2;
    // of those, the fewest waves of co-resident clusters, then the
    // largest K: clusters of 16 need 16 free SMs of one GPC, and a
    // cluster that finds none waits for a whole wave
    long long best = -1;
    k = kmin;
    for (int c = kmax; c >= kmin; c /= 2) {
      const int n = mm_clusters<T>(b, c, smem_of(c));
      if (n < 0) return n;
      if (n == 0) continue;
      const long long waves = (b + n - 1) / n;
      if (best < 0 || waves < best) {
        best = waves;
        k = c;
      }
    }
  } else if (k_req > MM_KMAX) {
    return -(int)cudaErrorInvalidValue;
  }
  if (mm_share(m, k) > INT32_MAX) return -(int)cudaErrorInvalidValue;
  const int streaming = !fits(k);
  const int smem = smem_of(k);
  const int n = mm_clusters<T>(b, k, smem);
  if (n < 0) return n;
  if (n == 0) return -(int)cudaErrorInvalidConfiguration;
  *k_out = k;
  *smem_out = smem;
  *streaming_out = streaming;
  return n;
}

template <typename T>
int launch_minmax(const void* x, void* xn, void* xc, int b, long long m,
                  int k, int smem, int streaming,
                  unsigned long long* trace, cudaStream_t st) {
  MinmaxLaunch<T> l(b, k, smem, st);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, minmax_cluster<T>, static_cast<const T*>(x),
      static_cast<T*>(xn), static_cast<T*>(xc), m, mm_share(m, k), k,
      streaming, trace);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
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

// The min-max launch on the current device for b frames of m elements:
// sets the kernel's attributes and writes its CTAs a frame (*k), dynamic
// shared memory (*smem) and form (*streaming: 1 when a share does not fit
// on chip). k_req > 0 forces K (1-16). Returns how many of its clusters
// the card holds at once (cudaOccupancyMaxActiveClusters); negative:
// -(CUDA error). The wrapper calls it once per (device, b, m, dtype).
extern "C" int onet_minmax_setup(int b, long long m, int bf16, int k_req,
                                 int* k, int* smem, int* streaming) {
  if (b <= 0 || b > 65535 || m <= 0) return -(int)cudaErrorInvalidValue;
  return bf16 ? setup_minmax<__nv_bfloat16>(b, m, k_req, k, smem, streaming)
              : setup_minmax<float>(b, m, k_req, k, smem, streaming);
}

// x [b][m] -> xn, xc [b][m] (both may lie in one buffer, apart), one
// launch; k, smem and streaming from onet_minmax_setup at (b, m, bf16).
extern "C" int onet_minmax_complement(const void* x, void* xn, void* xc,
                                      int b, long long m, int bf16, int k,
                                      int smem, int streaming,
                                      unsigned long long* trace,
                                      void* stream) {
  if (b <= 0 || m <= 0) return (int)cudaSuccess;
  if (k < 1 || k > MM_KMAX || b > 65535 || mm_share(m, k) > INT32_MAX ||
      smem < mm_smem_bytes(m, k, bf16 ? 2 : 4, streaming))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_minmax<__nv_bfloat16>(x, xn, xc, b, m, k, smem,
                                             streaming, trace, st)
              : launch_minmax<float>(x, xn, xc, b, m, k, smem, streaming,
                                     trace, st);
}
