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
// ray_level0, many rays: one tile of R rays a block of L0_THREADS threads,
// as many blocks as tiles.
//  1. The tile's rays8 rows (R x 32 contiguous bytes) and jitter rows
//     (R (T+1) contiguous floats) are staged in shared memory with 16 B
//     cp.async copies, while the block divides the K uniform edges j / T
//     once (the same division for every ray).
//  2. A flat thread index over the tile's R (T+1) edges, 4 consecutive
//     edges a thread, writes each metric edge to shared memory and bins as
//     the flat range [n0 (T+1), (n0 + R) (T+1)).
//  3. A flat index over the tile's R T samples, 4 consecutive samples a
//     thread, writes ts, dl, the three planes and the packed rows as the
//     flat ranges [n0 T, (n0 + R) T), in 16 B stores where aligned.
//  Every output is written with streaming stores (st.global.cs, evict
//  first): at 512^2 rays the outputs are 4-16x the 50 MB L2, and these
//  stores were faster than plain ones. R by T (the host's plan,
//  ops/ray_kernels.py:ray_plan): R T <= 1,024 samples (R = 32 at T = 32,
//  8 at T = 128), one pass of the block's threads (tiles of 2,048-8,192
//  samples were slower), and R is a multiple of 4, at least 4 (so a tile
//  of a level past 256 samples takes several passes), so every tile starts
//  16 B-aligned in bins and the sample outputs.
//  A grid of as many blocks as tiles was faster than a persistent grid
//  that walks the tiles with the next tile's rows loaded in the background
//  (likely because the block scheduler keeps the tiles in flight close
//  together in memory).
// ray_level0, few rays (fewer than 4 samples a resident thread of the tile
// kernel: the 1,024-ray launch of the 32^2 feature render): one warp a ray,
// lane t on sample t, the shortest latency a ray; no tiling of so few rays
// was as fast. (PERF.md section 6 has the times of every design tried.)
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
// Levels of any length: every kernel holds its rays' rows in shared memory,
// a warp kernel's in static arrays up to 131 samples (the served levels)
// and in dynamic shared memory past them, ray_level's thread kernel with
// fewer rays a block where 32 rays' rows do not fit (ray_plan); the only
// limit is a block's 227 KB (T of a few thousand).
//
// flatten3_nt: [3, N, T] -> [3, N*T]. Row-major, the two layouts are the same
// bytes, so the kernel is a copy. Bound by bytes: 2 x 12 B per sample,
// 60 us for the [3, 262144, 32] coordinates of a 512^2 frame's first level
// at 3.35 TB/s. Tiles of FLAT_UNROLL x FLAT_THREADS 16 B units, one a block,
// as many blocks as tiles: each thread issues its FLAT_UNROLL independent
// 16 B streaming loads (ld.global.cs) before its streaming stores
// (st.global.cs). Scalar copies when a pointer is not 16 B-aligned, and for
// the n % 4 floats of the tail. (PERF.md section 6 times it against a
// persistent grid, contiguous chunks a block, 8 loads a thread, plain
// loads or stores, and a TMA copy through shared memory with cp.async.bulk.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the warp-per-ray kernels: warps a block (at most), and the edges a ray's
// rows hold in their static shared memory (levels of T <= 131; longer ones
// take their rows in dynamic shared memory)
constexpr int WARPS = 8;
constexpr int STATIC_EDGES = 132;
// ray_level0's tile kernel: threads a block; its rays a tile R come from
// the host (ops/ray_kernels.py:ray_plan: R T <= 1,024 samples, R % 4 == 0,
// at least 4)
constexpr int L0_THREADS = 256;
// flatten3_nt: threads a block, 16 B loads in flight a thread
constexpr int FLAT_THREADS = 256;
constexpr int FLAT_UNROLL = 4;
// ray_level: the thread-per-ray kernel from this many rays on
constexpr int THREAD_RAYS_FROM = 16384;
constexpr int RAYS = 32;  // its rays a block (at most), one a thread
// shared memory a block may use (dynamic, beside the kernels' static)
constexpr int SMEM_LIMIT = 232448;

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
// registers, ptxas on sm_90a.)
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// len floats from src into shared dst, coalesced across the block: 16 B
// copies when both start 16 B-aligned (vec), 4 B for the rest (the caller
// waits: cp_async_wait_all)
__device__ __forceinline__ void stage_flat(float* dst,
                                           const float* __restrict__ src,
                                           int len, bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = len >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < len; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// v[0, m) to dst[0, m), m <= 4, as streaming stores (st.global.cs: the
// lines are written once, evict them first): one 16 B store when vec and
// m == 4
__device__ __forceinline__ void put4(float* __restrict__ dst,
                                     const float (&v)[4], int m, bool vec) {
  if (vec && m == 4) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < m) __stcs(dst + u, v[u]);
}

// One tile of R rays a block, 4 consecutive edges and samples a thread (see
// the header). Shared memory: the tile's metric edges [R, T+1], its rays8
// rows [R, 8], jittered its jitter rows [R, T+1], and the K uniform edges
// j / T. vec_ray / vec_jit: 16 B copies of the rays8 / jitter rows;
// vec_out: the outputs 16 B-aligned and N T % 4 == 0 (the planes start
// aligned; R % 4 == 0 aligns every tile).
__global__ void __launch_bounds__(L0_THREADS)
ray_level0_tile_kernel(const float* __restrict__ rays8,
                       const float* __restrict__ jitter, int N, int T, int R,
                       int contract, int vec_ray, int vec_jit, int vec_out,
                       float* __restrict__ bins, float* __restrict__ ts,
                       float* __restrict__ dl, float* __restrict__ x3,
                       int pack_q, float* __restrict__ ts_p,
                       float* __restrict__ dl_p) {
  extern __shared__ __align__(16) float smem[];
  const int K = T + 1, EK = R * K;  // R % 4 == 0: the arrays stay aligned
  float* s_rb = smem;
  float* ray = s_rb + EK;
  float* jit = ray + R * 8;
  float* s_bj = jit + (jitter ? EK : 0);
  const long n0 = (long)blockIdx.x * R;
  const int nr = (int)min((long)R, (long)N - n0);
  stage_flat(ray, rays8 + n0 * 8, nr * 8, vec_ray);
  if (jitter) stage_flat(jit, jitter + n0 * K, nr * K, vec_jit);
  // the uniform edges, divided once a block (each is the same division)
  for (int j = threadIdx.x; j < K; j += L0_THREADS)
    s_bj[j] = (float)j / (float)T;
  cp_async_wait_all();
  __syncthreads();
  // edges: 4 consecutive of the tile's nr K a thread
  const int ne = nr * K;
  float* bins_t = bins + n0 * K;
  for (int f = 4 * threadIdx.x; f < ne; f += 4 * L0_THREADS) {
    int q = f / K, j = f - q * K;
    const int m = min(4, ne - f);
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < m) {
        float b = s_bj[j];
        if (jitter) b = fminf(fmaxf(b + jit[f + u], 0.0f), 1.0f);
        v[u] = b;
        s_rb[f + u] = spacing_inv(ray[q * 8 + 6] * (1.0f - b) +
                                  ray[q * 8 + 7] * b);
        if (++j == K) {
          j = 0;
          ++q;
        }
      }
    }
    put4(bins_t + f, v, m, vec_out);
  }
  __syncthreads();
  // samples: 4 consecutive of the tile's nr T a thread
  const int ns = nr * T;
  const size_t s0 = (size_t)n0 * T, plane = (size_t)N * T;
  for (int f = 4 * threadIdx.x; f < ns; f += 4 * L0_THREADS) {
    int q = f / T, t = f - q * T;
    const int m = min(4, ns - f);
    float vt[4], vd[4], vx[4], vy[4], vz[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < m) {
        const float* rq = ray + q * 8;
        const float r0 = s_rb[q * K + t], r1 = s_rb[q * K + t + 1];
        const float tv = 0.5f * (r1 + r0);
        float x = rq[0] + rq[3] * tv, y = rq[1] + rq[4] * tv,
              z = rq[2] + rq[5] * tv;
        if (contract) contract3(x, y, z);
        vt[u] = tv;
        vd[u] = r1 - r0;
        vx[u] = x;
        vy[u] = y;
        vz[u] = z;
        if (++t == T) {
          t = 0;
          ++q;
        }
      }
    }
    const size_t i = s0 + f;
    put4(ts + i, vt, m, vec_out);
    put4(dl + i, vd, m, vec_out);
    put4(x3 + i, vx, m, vec_out);
    put4(x3 + plane + i, vy, m, vec_out);
    put4(x3 + 2 * plane + i, vz, m, vec_out);
    if (pack_q) {  // ray n's packed row offset is n T: the same offsets
      put4(ts_p + i, vt, m, vec_out);
      put4(dl_p + i, vd, m, vec_out);
    }
  }
}

// few rays: one warp a ray, lane t on sample t (see the header). E: the
// edges a warp's row holds in static shared memory (levels of T < E, the
// served ones); E = 0: [WARPS][T + 1] in dynamic shared memory (longer)
template <int E>
__global__ void __launch_bounds__(WARPS * 32)
ray_level0_warp_kernel(const float* __restrict__ rays8,
                       const float* __restrict__ jitter, int N, int T,
                       int contract, float* __restrict__ bins,
                       float* __restrict__ ts, float* __restrict__ dl,
                       float* __restrict__ x3, int pack_q,
                       float* __restrict__ ts_p, float* __restrict__ dl_p) {
  __shared__ float s_rb[E ? WARPS : 1][E ? E : 1];
  extern __shared__ float s_dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rb = E ? s_rb[warp] : s_dyn + warp * (T + 1);
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

// ray_level, few rays: one warp a ray (see the header). E as for
// ray_level0_warp_kernel (T0, T < E, WARPS warps a block); E = 0: the
// warps a block of the host's plan, their rows in dynamic shared memory
template <int E>
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
  // per warp: pdf [T0], cdf [T0 + 1], rc [T0], db [T0], rb [T + 1], total
  constexpr int W = E ? WARPS : 1, S = E ? E : 1;
  __shared__ float s_pdf[W][S];
  __shared__ float s_cdf[W][S];
  __shared__ float s_rc[W][S];
  __shared__ float s_db[W][S];
  __shared__ float s_rb[W][S];
  __shared__ float s_tot[W];
  extern __shared__ float s_warp[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = E ? WARPS : blockDim.x >> 5;
  const int K = T + 1;
  float *pdf, *cdf, *rc, *db, *rb, *s_total;
  if constexpr (E != 0) {
    pdf = s_pdf[warp];
    cdf = s_cdf[warp];
    rc = s_rc[warp];
    db = s_db[warp];
    rb = s_rb[warp];
    s_total = s_tot + warp;
  } else {
    pdf = s_warp + (size_t)warp * (4 * T0 + K + 2);
    cdf = pdf + T0;
    rc = cdf + T0 + 1;
    db = rc + T0;
    rb = db + T0;
    s_total = rb + K;
  }
  for (long n = (long)blockIdx.x * warps + warp; n < N;
       n += (long)gridDim.x * warps) {
    const Ray r = load_ray(rays8, n);
    // pdf = (w + 0.01) / sum; the sums run in index order (the deltas
    // downstream difference nearly equal edges, so the order shows)
    for (int i = lane; i < T0; i += 32) pdf[i] = w_prev[n * T0 + i] + 0.01f;
    __syncwarp();
    if (lane == 0) {
      float total = 0.0f;
      for (int i = 0; i < T0; ++i) total += pdf[i];
      s_total[0] = total;
    }
    __syncwarp();
    const float total = s_total[0];
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

// nr rows of len floats, contiguous at src, into shared rows of stride S
// from column off: one 4 B cp.async an element, coalesced across the
// block, all in flight at once (the caller waits: cp.async.wait_all)
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int nr, int len, float* dst,
                                           int S, int off, int stride) {
  const int n = nr * len;
  const float inv = 1.0f / (float)len;
  for (int f = threadIdx.x; f < n; f += stride) {
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

// many rays: a block of RB rays, one thread a ray (see the header); RB = 0:
// blockDim.x rays, as many as fit beside their rows (the host's plan; long
// levels), RAYS otherwise
template <int RB>
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
  const int tid = threadIdx.x, K = T + 1, rays = RB ? RB : blockDim.x;
  float* s_c = s_a + rays * SA;
  float* s_b = s_c + rays * SC;
  const size_t plane = (size_t)N * T;
  const float inv_k = 1.0f / (float)K, inv_t = 1.0f / (float)T;
  for (long n0 = (long)blockIdx.x * rays; n0 < N;
       n0 += (long)gridDim.x * rays) {
    const int nr = (int)min((long)rays, (long)N - n0);
    stage_rows(w_prev + n0 * T0, nr, T0, s_a, SA, 1, rays);
    if (!uniform_prev)
      stage_rows(bins_prev + n0 * (T0 + 1), nr, T0 + 1, s_b, SB, 0, rays);
    if (jitter) stage_rows(jitter + n0 * K, nr, K, s_c, SC, 0, rays);
    stage_rows(rays8 + n0 * 8, nr, 8, s_ray, 8, 0, rays);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (tid < nr)
      resample_ray(s_a + tid * SA, s_b + tid * SB, s_c + tid * SC, T0, K,
                   uniform_prev, jitter != nullptr);
    __syncthreads();
    for (int f = tid; f < nr * K; f += rays) {
      const int q = row_of(f, inv_k), j = f - q * K;
      const float b = s_c[q * SC + j];
      bins[n0 * K + f] = b;
      const float* rq = s_ray + q * 8;
      s_a[q * SA + j] = metric_edge(
          Ray{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7]}, b);
    }
    __syncthreads();
    for (int f = tid; f < nr * T; f += rays) {
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

// tiles of FLAT_UNROLL x FLAT_THREADS 16 B units, one a block (tile b + k
// grid to block b past 2^31 - 1 blocks); FLAT_UNROLL loads in flight a
// thread (see the header)
__global__ void __launch_bounds__(FLAT_THREADS)
flatten3_kernel(const float* __restrict__ x, float* __restrict__ out, long n,
                int vec) {
  if (!vec) {
    const long stride = (long)gridDim.x * blockDim.x;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride)
      out[i] = __ldcs(x + i);
    return;
  }
  const long n4 = n / 4;
  const long tile = (long)FLAT_UNROLL * FLAT_THREADS;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long base = blockIdx.x * tile + threadIdx.x; base < n4;
       base += gridDim.x * tile) {
    float4 v[FLAT_UNROLL];
#pragma unroll
    for (int u = 0; u < FLAT_UNROLL; ++u) {
      const long i = base + (long)u * FLAT_THREADS;
      if (i < n4) v[u] = __ldcs(x4 + i);
    }
#pragma unroll
    for (int u = 0; u < FLAT_UNROLL; ++u) {
      const long i = base + (long)u * FLAT_THREADS;
      if (i < n4) __stcs(o4 + i, v[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    out[n4 * 4 + threadIdx.x] = __ldcs(x + n4 * 4 + threadIdx.x);
}

// the SMs x the blocks of `threads` threads and `smem` bytes that fit on one
template <typename Kern>
long resident_blocks(Kern kernel, int threads, size_t smem) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (long)(n_sm > 0 ? n_sm : 1) * (per_sm > 0 ? per_sm : 1);
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

// The plans come from the host (ops/ray_kernels.py:ray_plan): R, the rays
// of a ray_level0 tile; for ray_level the warps a block of its warp kernel
// and the rays a block of its thread kernel. Each kernel may take up to
// SMEM_LIMIT bytes of dynamic shared memory; a launch whose plan needs
// more is refused.
template <typename Kern>
int allow_smem(Kern kernel, int static_bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT - static_bytes);
}

extern "C" int ray_level0_launch(const float* rays8, const float* jitter,
                                 int N, int T, int contract, float* bins,
                                 float* ts, float* dl, float* x3, int pack_q,
                                 float* ts_p, float* dl_p, int R,
                                 void* stream) {
  if (T < 1 || N < 0 || R < 4 || R % 4 || !pack_ok(N, pack_q, ts_p, dl_p))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int K = T + 1;
  const size_t smem =
      (size_t)(R * K * (jitter ? 2 : 1) + 8 * R + K) * sizeof(float);
  const size_t warp_smem = (size_t)WARPS * K * sizeof(float);
  if (smem > (size_t)SMEM_LIMIT || warp_smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem(ray_level0_tile_kernel, 0) |
                          allow_smem(ray_level0_warp_kernel<0>, 0);
  if (attr) return attr;
  if ((long)N * T < 4L * L0_THREADS *
                        resident_blocks(ray_level0_tile_kernel, L0_THREADS,
                                        smem)) {
    if (K <= STATIC_EDGES)
      ray_level0_warp_kernel<STATIC_EDGES><<<grid_for(N), WARPS * 32, 0,
                                             (cudaStream_t)stream>>>(
          rays8, jitter, N, T, contract, bins, ts, dl, x3, pack_q, ts_p,
          dl_p);
    else
      ray_level0_warp_kernel<0><<<grid_for(N), WARPS * 32, warp_smem,
                                  (cudaStream_t)stream>>>(
          rays8, jitter, N, T, contract, bins, ts, dl, x3, pack_q, ts_p,
          dl_p);
    return (int)cudaGetLastError();
  }
  const auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec_out = al(bins) && al(ts) && al(dl) && al(x3) &&
                      (!pack_q || (al(ts_p) && al(dl_p))) &&
                      ((long)N * T) % 4 == 0;
  ray_level0_tile_kernel<<<(int)(((long)N + R - 1) / R), L0_THREADS, smem,
                           (cudaStream_t)stream>>>(
      rays8, jitter, N, T, R, contract, al(rays8), jitter && al(jitter),
      vec_out, bins, ts, dl, x3, pack_q, ts_p, dl_p);
  return (int)cudaGetLastError();
}

extern "C" int ray_level_launch(const float* rays8, const float* w_prev,
                                const float* bins_prev, const float* jitter,
                                int N, int T0, int T, int contract,
                                int uniform_prev, float* bins, float* ts,
                                float* dl, float* x3, int pack_q, float* ts_p,
                                float* dl_p, int warps, int rays,
                                void* stream) {
  if (T < 1 || T0 < 1 || warps < 1 || warps > WARPS || rays < 1 ||
      rays > RAYS || !pack_ok(N, pack_q, ts_p, dl_p))
    return (int)cudaErrorInvalidValue;
  static const int attr =
      allow_smem(ray_level_warp_kernel<0>, 0) |
      allow_smem(ray_level_thread_kernel<RAYS>,
                 RAYS * 8 * (int)sizeof(float)) |
      allow_smem(ray_level_thread_kernel<0>, RAYS * 8 * (int)sizeof(float));
  if (attr) return attr;
  const int K = T + 1;
  if (N < THREAD_RAYS_FROM) {
    const size_t smem = (size_t)warps * (4 * T0 + K + 2) * sizeof(float);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    long blocks = ((long)N + warps - 1) / warps;
    blocks = blocks < (1L << 20) ? blocks : (1L << 20);
    const bool fixed = warps == WARPS && T0 + 1 <= STATIC_EDGES &&
                       K <= STATIC_EDGES;
    auto* kernel = fixed ? ray_level_warp_kernel<STATIC_EDGES>
                         : ray_level_warp_kernel<0>;
    kernel<<<(int)blocks, warps * 32, fixed ? 0 : smem,
             (cudaStream_t)stream>>>(
        rays8, w_prev, bins_prev, jitter, N, T0, T, contract, uniform_prev,
        bins, ts, dl, x3, pack_q, ts_p, dl_p);
    return (int)cudaGetLastError();
  }
  // odd strides: thread q's row starts in bank (q * S) % 32, all distinct
  const int SA = (T0 + 1 > T + 1 ? T0 + 1 : T + 1) | 1, SC = (T + 1) | 1,
            SB = uniform_prev ? 0 : (T0 + 1) | 1;
  const size_t smem = (size_t)rays * (SA + SB + SC) * sizeof(float);
  if (smem + RAYS * 8 * sizeof(float) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  long blocks = ((long)N + rays - 1) / rays;
  blocks = blocks < (1L << 20) ? blocks : (1L << 20);
  auto* kernel = rays == RAYS ? ray_level_thread_kernel<RAYS>
                              : ray_level_thread_kernel<0>;
  kernel<<<(int)blocks, rays, smem, (cudaStream_t)stream>>>(
      rays8, w_prev, bins_prev, jitter, N, T0, T, contract, uniform_prev,
      bins, ts, dl, x3, pack_q, ts_p, dl_p, SA, SB, SC);
  return (int)cudaGetLastError();
}

extern "C" int flatten3_launch(const float* x3, long n, float* out,
                               void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int vec = ((uintptr_t)x3 % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long units = vec ? n / 4 : n;
  const long per = vec ? (long)FLAT_UNROLL * FLAT_THREADS : FLAT_THREADS;
  const long tiles = (units + per - 1) / per;
  flatten3_kernel<<<(int)max(1L, min(tiles, (long)INT32_MAX)), FLAT_THREADS,
                    0, (cudaStream_t)stream>>>(x3, out, n, vec);
  return (int)cudaGetLastError();
}
