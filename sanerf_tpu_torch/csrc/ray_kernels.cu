// Per-level ray geometry for the NeRF renderer, Hopper (sm_90a).
//
// Replaces the TPU kernels sanerf_tpu/ops/ray_kernels.py:275 ray_level0
// (_ray0_kernel :145, _level_body :109, _contract_planes :47), :310
// ray_level (_ray_kernel :167, _resample :73) with their pack_q outputs
// (_pack_rows / _store_packed :131-142), and :247 flatten3_nt
// (_flatten_kernel :230). Plain PyTorch versions of the same functions:
// sanerf_tpu_torch/ops/ray_kernels.py (*_plain).
//
// Bound on an H100: memory. Per ray, level 0 reads 32 B of ray and writes
// bins, ts, dl and three coordinate planes: (T+1 + 2T + 3T) floats; at
// 512^2 rays and T=32 that is 0.21 GB, ~63 us at 3.35 TB/s. A resampling
// level also reads the previous weights and edges (T0 + T0+1 floats).
// Its arithmetic is O(T0 + K) a ray on the many-ray path below, far below
// the byte time, but each ray's sums and walk are serial chains, and their
// latency is what bounds that path on the card (PERF.md).
//
// ray_level0: one warp per ray; lane t writes sample t, so every store of
// bins, ts, dl and the [3, N, T] planes is contiguous across the warp.
//
// ray_level, few rays (N < THREAD_RAYS_FROM: the 32^2 feature render's
// 1,024): one warp a ray, the shortest latency a ray. Lane 0 sums the pdf
// total and the CDF in index order (the JAX kernel's triangular matmul;
// any other order moves the metric deltas by more than 1e-5), and lane j
// sums the inverse CDF of edge j as the full ramp sum below, in index
// order: K T0 ramps a ray, spread over 32 lanes.
//
// ray_level, many rays: a block of RAYS rays, one thread a ray.
//  1. The block stages its rays' rows (w, the previous edges, jitter, rays8)
//     in shared memory with 4 B cp.async copies, coalesced and all in flight
//     at once. Each ray's rows have an odd stride, so the threads' serial
//     passes along their own rows hit 32 different banks.
//  2. Thread q sums ray q's pdf total and its CDF in index order.
//  3. Thread q walks ray q's CDF once for all K edges. The inverse CDF is
//     F^-1(u) = b0 + sum_i db_i clamp((u - c_i) r_i, 0, 1), r_i = 1 /
//     max(c_{i+1} - c_i, 1e-12), summed in index order (the JAX formulation,
//     _resample). A term is exactly 0 iff u <= c_i, and the CDF does not
//     decrease, so the terms past the first such i are all 0. A term whose
//     ramp rounds to exactly 1 is exactly db_i (1 under uniform_prev). The
//     ramps do not decrease in u, and the edges u_j do not decrease in j, so
//     the prefix of exactly-1 ramps only grows: the walk keeps its length m
//     and its index-order sum P, and an edge costs P plus the terms from m
//     to the first 0, each with the same float operations in the same
//     order as the plain version. So the result is bit for bit the O(K T0)
//     sum, in O(K + T0) steps a ray. An edge below the one before it
//     (jitter) restarts the walk at 0. (Measured on the H100: evaluating 4
//     or 8 ramps together, the slopes precomputed by the block, the walk
//     as one flat loop of steps, skipping the division where the ramp
//     must round to 1, and blocks of 64 rays were all as fast or slower.)
//  4. The block writes bins and, from the metric edges in shared memory,
//     ts, dl and the planes as flat ranges: stores contiguous across the
//     block.
// The contraction keeps the 1e-12 clamps and the x-over-y-over-z
// tie-break. Built with -fmad=false so products and sums round like the
// separate PyTorch ops.
//
// pack_q > 0 (the packed-epilogue feed): the kernel also writes ts and dl as
// [N/q, q*T, 1] rows, ray n in slot n % q of row n / q. On a row-major GPU
// tensor those rows are the same bytes as [N, T] (the TPU packs q rays into
// one 128-lane row; Hopper has no lanes to fill), so the two extra outputs
// cost 8 B per sample of writes and nothing else.
//
// flatten3_nt: [3, N, T] -> [3, N*T]. Row-major, the two layouts are the same
// bytes, so the kernel is a copy: a grid-stride loop of 16-byte loads and
// stores (scalar when a pointer is not 16-byte aligned). Bound by bytes:
// 2 x 12 B per sample, ~30 us for the 4.19 M final samples of a 512^2 frame
// at (32, 16) at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAXE = 132;  // edges per ray held in shared memory (T <= 128)
// ray_level: the thread-per-ray kernel from this many rays on
constexpr int THREAD_RAYS_FROM = 16384;
constexpr int RAYS = 32;        // its rays a block, one a thread

__device__ __forceinline__ float spacing_inv(float x) {
  return x < 0.5f ? 2.0f * x : 1.0f / fmaxf(2.0f - 2.0f * x, 1e-12f);
}

__device__ __forceinline__ void contract3(float& x, float& y, float& z) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const float mag = fmaxf(fmaxf(ax, ay), az);
  if (mag < 1.0f) return;
  const float inv = 1.0f / fmaxf(mag, 1e-12f);
  const float dom = (2.0f - inv) * inv;
  const bool is_x = ax == mag;
  const bool is_y = (ay == mag) && !is_x;
  const bool is_z = !(is_x || is_y);
  x = x * (is_x ? dom : inv);
  y = y * (is_y ? dom : inv);
  z = z * (is_z ? dom : inv);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, sn, sf;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        long n) {
  const float* r = rays8 + n * 8;
  return Ray{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
}

// s-space edge -> metric edge
__device__ __forceinline__ float metric_edge(const Ray& r, float b) {
  return spacing_inv(r.sn * (1.0f - b) + r.sf * b);
}

// sample i = n T + t of ray r, between the metric edges r0 and r1, as
// emit_samples writes it. The packed rows [N/q, q T] hold ray n (slot
// n % q of row n / q) at the same offset (n / q) q T + (n % q) T = n T.
// (emit_samples keeps its own copy: calling this from it spilled 16 B of
// registers in ray_level0, ptxas on sm_90a.)
__device__ __forceinline__ void write_sample(
    const Ray& r, float r0, float r1, size_t i, size_t plane, int contract,
    float* __restrict__ ts, float* __restrict__ dl, float* __restrict__ x3,
    int pack_q, float* __restrict__ ts_p, float* __restrict__ dl_p) {
  const float tv = 0.5f * (r1 + r0);
  float x = r.ox + r.dx * tv, y = r.oy + r.dy * tv, z = r.oz + r.dz * tv;
  if (contract) contract3(x, y, z);
  ts[i] = tv;
  dl[i] = r1 - r0;
  x3[i] = x;
  x3[plane + i] = y;
  x3[2 * plane + i] = z;
  if (pack_q) {
    ts_p[i] = tv;
    dl_p[i] = r1 - r0;
  }
}

// lane t writes sample t from the metric edges rb[0..T]
__device__ __forceinline__ void emit_samples(const Ray& r, const float* rb,
                                             long n, int N, int T,
                                             int contract, int lane,
                                             float* __restrict__ ts,
                                             float* __restrict__ dl,
                                             float* __restrict__ x3,
                                             int pack_q,
                                             float* __restrict__ ts_p,
                                             float* __restrict__ dl_p) {
  const size_t plane = (size_t)N * T;
  // packed row offset of ray n: slot n % q of row n / q
  const size_t prow = pack_q ? (size_t)(n / pack_q) * pack_q * T +
                                   (size_t)(n % pack_q) * T
                             : 0;
  for (int t = lane; t < T; t += 32) {
    const float r0 = rb[t], r1 = rb[t + 1];
    const float tv = 0.5f * (r1 + r0);
    float x = r.ox + r.dx * tv, y = r.oy + r.dy * tv, z = r.oz + r.dz * tv;
    if (contract) contract3(x, y, z);
    const size_t i = (size_t)n * T + t;
    ts[i] = tv;
    dl[i] = r1 - r0;
    x3[i] = x;
    x3[plane + i] = y;
    x3[2 * plane + i] = z;
    if (pack_q) {
      ts_p[prow + t] = tv;
      dl_p[prow + t] = r1 - r0;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
ray_level0_kernel(const float* __restrict__ rays8,
                  const float* __restrict__ jitter, int N, int T,
                  int contract, float* __restrict__ bins,
                  float* __restrict__ ts, float* __restrict__ dl,
                  float* __restrict__ x3, int pack_q,
                  float* __restrict__ ts_p, float* __restrict__ dl_p) {
  __shared__ float s_rb[WARPS][MAXE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rb = s_rb[warp];
  for (long n = (long)blockIdx.x * WARPS + warp; n < N;
       n += (long)gridDim.x * WARPS) {
    const Ray r = load_ray(rays8, n);
    for (int j = lane; j <= T; j += 32) {
      float b = (float)j / (float)T;
      if (jitter) b = fminf(fmaxf(b + jitter[n * (T + 1) + j], 0.0f), 1.0f);
      bins[n * (T + 1) + j] = b;
      rb[j] = metric_edge(r, b);
    }
    __syncwarp();
    emit_samples(r, rb, n, N, T, contract, lane, ts, dl, x3, pack_q, ts_p,
                 dl_p);
    __syncwarp();
  }
}

// ray_level, few rays: one warp a ray (see the header)
__global__ void __launch_bounds__(WARPS * 32)
ray_level_warp_kernel(const float* __restrict__ rays8,
                      const float* __restrict__ w_prev,
                      const float* __restrict__ bins_prev,
                      const float* __restrict__ jitter, int N, int T0, int T,
                      int contract, int uniform_prev,
                      float* __restrict__ bins, float* __restrict__ ts,
                      float* __restrict__ dl, float* __restrict__ x3,
                      int pack_q, float* __restrict__ ts_p,
                      float* __restrict__ dl_p) {
  __shared__ float s_pdf[WARPS][MAXE];
  __shared__ float s_cdf[WARPS][MAXE];
  __shared__ float s_rc[WARPS][MAXE];
  __shared__ float s_db[WARPS][MAXE];
  __shared__ float s_rb[WARPS][MAXE];
  __shared__ float s_total[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float *pdf = s_pdf[warp], *cdf = s_cdf[warp], *rc = s_rc[warp],
        *db = s_db[warp], *rb = s_rb[warp];
  const int K = T + 1;
  for (long n = (long)blockIdx.x * WARPS + warp; n < N;
       n += (long)gridDim.x * WARPS) {
    const Ray r = load_ray(rays8, n);
    // pdf = (w + 0.01) / sum; the sums run in index order (the deltas
    // downstream difference nearly equal edges, so the order shows)
    for (int i = lane; i < T0; i += 32) pdf[i] = w_prev[n * T0 + i] + 0.01f;
    __syncwarp();
    if (lane == 0) {
      float total = 0.0f;
      for (int i = 0; i < T0; ++i) total += pdf[i];
      s_total[warp] = total;
    }
    __syncwarp();
    const float total = s_total[warp];
    for (int i = lane; i < T0; i += 32) pdf[i] = pdf[i] / total;
    __syncwarp();
    // cdf by running sum, clipped at 1
    if (lane == 0) {
      float acc = 0.0f;
      cdf[0] = 0.0f;
      for (int i = 0; i < T0; ++i) {
        acc += pdf[i];
        cdf[i + 1] = fminf(acc, 1.0f);
      }
    }
    __syncwarp();
    const float* bp = bins_prev + n * (T0 + 1);
    for (int i = lane; i < T0; i += 32) {
      rc[i] = 1.0f / fmaxf(cdf[i + 1] - cdf[i], 1e-12f);
      db[i] = uniform_prev ? 0.0f : bp[i + 1] - bp[i];
    }
    const float b0 = uniform_prev ? 0.0f : bp[0];
    __syncwarp();
    // inverse CDF at u_j = (j + 0.5) / K (+ jitter)
    for (int j = lane; j < K; j += 32) {
      float u = ((float)j + 0.5f) / (float)K;
      if (jitter) u = u + jitter[n * K + j];
      float acc = 0.0f;
      for (int i = 0; i < T0; ++i) {
        const float fr = fminf(fmaxf((u - cdf[i]) * rc[i], 0.0f), 1.0f);
        acc += uniform_prev ? fr : fr * db[i];
      }
      const float b = uniform_prev ? acc / (float)T0 : b0 + acc;
      bins[n * K + j] = b;
      rb[j] = metric_edge(r, b);
    }
    __syncwarp();
    emit_samples(r, rb, n, N, T, contract, lane, ts, dl, x3, pack_q, ts_p,
                 dl_p);
    __syncwarp();
  }
}

// the row of flat offset f in rows of len floats; exact for f < 2^20:
// (f + 0.5) / len sits at least 0.5 / len from an integer
__device__ __forceinline__ int row_of(int f, float inv_len) {
  return (int)(((float)f + 0.5f) * inv_len);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// nr rows of len floats, contiguous at src, into shared rows of stride S
// from column off: one 4 B cp.async an element, coalesced across the
// block, all in flight at once (the caller waits: cp.async.wait_all)
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int nr, int len, float* dst,
                                           int S, int off) {
  const int n = nr * len;
  const float inv = 1.0f / (float)len;
  for (int f = threadIdx.x; f < n; f += RAYS) {
    const int q = row_of(f, inv);
    cp_async4(dst + q * S + off + (f - q * len), src + f);
  }
}

// One ray, one thread (see the header). c: w at [1, T0], becomes the CDF at
// [0, T0]; bp: the previous edges [0, T0] (unused under uniform_prev); e:
// the jitter of u at [0, K) (if jittered), becomes the new s-space edges.
__device__ __forceinline__ void resample_ray(float* c, const float* bp,
                                             float* e, int T0, int K,
                                             bool uniform_prev,
                                             bool jittered) {
  // pdf = (w + 0.01) / total and the CDF, both sums in index order
  float total = 0.0f;
  for (int i = 1; i <= T0; ++i) total += c[i] + 0.01f;
  float acc = 0.0f;
  c[0] = 0.0f;
  for (int i = 1; i <= T0; ++i) {
    acc += (c[i] + 0.01f) / total;
    c[i] = fminf(acc, 1.0f);
  }
  const float b0 = uniform_prev ? 0.0f : bp[0];
  int m = 0;          // ramps [0, m) are exactly 1 at this edge
  float P = 0.0f;     // their terms summed in index order
  float u_last = 0.0f;
  for (int j = 0; j < K; ++j) {
    float u = ((float)j + 0.5f) / (float)K;
    if (jittered) u = u + e[j];
    if (j > 0 && u < u_last) {
      m = 0;
      P = 0.0f;
    }
    u_last = u;
    // the terms from m to the first exact 0 (u <= c_i: all later ones are
    // 0 too); while they are exactly 1 the prefix grows with them
    float a = P;
    bool prefix = true;
    for (int i = m; i < T0 && u > c[i]; ++i) {
      const float r = 1.0f / fmaxf(c[i + 1] - c[i], 1e-12f);
      const float fr = fminf(fmaxf((u - c[i]) * r, 0.0f), 1.0f);
      a = a + (uniform_prev ? fr : fr * (bp[i + 1] - bp[i]));
      prefix = prefix && fr == 1.0f;
      if (prefix) {
        P = a;
        m = i + 1;
      }
    }
    e[j] = uniform_prev ? a / (float)T0 : b0 + a;
  }
}

// many rays: a block of RAYS rays, one thread a ray (see the header)
__global__ void __launch_bounds__(RAYS)
ray_level_thread_kernel(const float* __restrict__ rays8,
                        const float* __restrict__ w_prev,
                        const float* __restrict__ bins_prev,
                        const float* __restrict__ jitter, int N, int T0,
                        int T, int contract, int uniform_prev,
                        float* __restrict__ bins, float* __restrict__ ts,
                        float* __restrict__ dl, float* __restrict__ x3,
                        int pack_q, float* __restrict__ ts_p,
                        float* __restrict__ dl_p, int SA, int SB, int SC) {
  // per ray: s_a w, the CDF, then metric edges (stride SA); s_c jitter,
  // then new edges (SC); s_b previous edges (SB, absent under uniform_prev)
  extern __shared__ float smem[];
  __shared__ float s_ray[RAYS * 8];
  float* s_a = smem;
  float* s_c = s_a + RAYS * SA;
  float* s_b = s_c + RAYS * SC;
  const int tid = threadIdx.x, K = T + 1;
  const size_t plane = (size_t)N * T;
  const float inv_k = 1.0f / (float)K, inv_t = 1.0f / (float)T;
  for (long n0 = (long)blockIdx.x * RAYS; n0 < N;
       n0 += (long)gridDim.x * RAYS) {
    const int nr = (int)min((long)RAYS, (long)N - n0);
    stage_rows(w_prev + n0 * T0, nr, T0, s_a, SA, 1);
    if (!uniform_prev)
      stage_rows(bins_prev + n0 * (T0 + 1), nr, T0 + 1, s_b, SB, 0);
    if (jitter) stage_rows(jitter + n0 * K, nr, K, s_c, SC, 0);
    stage_rows(rays8 + n0 * 8, nr, 8, s_ray, 8, 0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (tid < nr)
      resample_ray(s_a + tid * SA, s_b + tid * SB, s_c + tid * SC, T0, K,
                   uniform_prev, jitter != nullptr);
    __syncthreads();
    for (int f = tid; f < nr * K; f += RAYS) {
      const int q = row_of(f, inv_k), j = f - q * K;
      const float b = s_c[q * SC + j];
      bins[n0 * K + f] = b;
      const float* rq = s_ray + q * 8;
      s_a[q * SA + j] = metric_edge(
          Ray{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7]}, b);
    }
    __syncthreads();
    for (int f = tid; f < nr * T; f += RAYS) {
      const int q = row_of(f, inv_t), t = f - q * T;
      const float* rq = s_ray + q * 8;
      write_sample(
          Ray{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7]},
          s_a[q * SA + t], s_a[q * SA + t + 1], (size_t)n0 * T + f, plane,
          contract, ts, dl, x3, pack_q, ts_p, dl_p);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256)
flatten3_kernel(const float* __restrict__ x, float* __restrict__ out, long n,
                int vec) {
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long done = 0;
  if (vec) {
    const long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long i = tid; i < n4; i += stride) o4[i] = __ldg(x4 + i);
    done = n4 * 4;
  }
  for (long i = done + tid; i < n; i += stride) out[i] = x[i];
}

bool pack_ok(int N, int pack_q, const float* ts_p, const float* dl_p) {
  if (pack_q < 0) return false;
  if (pack_q == 0) return true;
  return N % pack_q == 0 && ts_p && dl_p;
}

int grid_for(int N) {
  long blocks = ((long)N + WARPS - 1) / WARPS;
  return (int)(blocks < (1L << 20) ? blocks : (1L << 20));
}

}  // namespace

extern "C" int ray_level0_launch(const float* rays8, const float* jitter,
                                 int N, int T, int contract, float* bins,
                                 float* ts, float* dl, float* x3, int pack_q,
                                 float* ts_p, float* dl_p, void* stream) {
  if (T < 1 || T + 1 > MAXE || !pack_ok(N, pack_q, ts_p, dl_p))
    return (int)cudaErrorInvalidValue;
  ray_level0_kernel<<<grid_for(N), WARPS * 32, 0, (cudaStream_t)stream>>>(
      rays8, jitter, N, T, contract, bins, ts, dl, x3, pack_q, ts_p, dl_p);
  return (int)cudaGetLastError();
}

extern "C" int ray_level_launch(const float* rays8, const float* w_prev,
                                const float* bins_prev, const float* jitter,
                                int N, int T0, int T, int contract,
                                int uniform_prev, float* bins, float* ts,
                                float* dl, float* x3, int pack_q, float* ts_p,
                                float* dl_p, void* stream) {
  if (T < 1 || T + 1 > MAXE || T0 < 1 || T0 + 1 > MAXE ||
      !pack_ok(N, pack_q, ts_p, dl_p))
    return (int)cudaErrorInvalidValue;
  if (N < THREAD_RAYS_FROM) {
    ray_level_warp_kernel<<<grid_for(N), WARPS * 32, 0,
                            (cudaStream_t)stream>>>(
        rays8, w_prev, bins_prev, jitter, N, T0, T, contract, uniform_prev,
        bins, ts, dl, x3, pack_q, ts_p, dl_p);
    return (int)cudaGetLastError();
  }
  // odd strides: thread q's row starts in bank (q * S) % 32, all distinct
  const int SA = (T0 + 1 > T + 1 ? T0 + 1 : T + 1) | 1, SC = (T + 1) | 1,
            SB = uniform_prev ? 0 : (T0 + 1) | 1;
  static const int attr = (int)cudaFuncSetAttribute(
      ray_level_thread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RAYS * 3 * (MAXE | 1) * (int)sizeof(float));
  if (attr) return attr;
  const long blocks = ((long)N + RAYS - 1) / RAYS;
  ray_level_thread_kernel<<<(int)(blocks < (1L << 20) ? blocks : (1L << 20)),
                            RAYS, (size_t)RAYS * (SA + SB + SC) *
                                      sizeof(float),
                            (cudaStream_t)stream>>>(
      rays8, w_prev, bins_prev, jitter, N, T0, T, contract, uniform_prev,
      bins, ts, dl, x3, pack_q, ts_p, dl_p, SA, SB, SC);
  return (int)cudaGetLastError();
}

extern "C" int flatten3_launch(const float* x3, long n, float* out,
                               void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int vec = ((uintptr_t)x3 % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long work = vec ? (n + 3) / 4 : n;
  long blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  flatten3_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(x3, out, n,
                                                                vec);
  return (int)cudaGetLastError();
}
