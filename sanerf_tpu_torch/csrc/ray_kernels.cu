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
// The arithmetic (a K x T0 clamped-ramp sum per ray) stays far below the
// byte time.
//
// Design: one warp per ray. Lanes load the previous level's row (coalesced);
// the pdf total and the CDF are running sums in index order kept in shared
// memory (the TPU kernel's triangular matmul becomes a plain scan), and each
// lane evaluates the inverse CDF of some edges as the sum of clamped ramps
// (F^-1(u) = b0 + sum_i db_i clamp((u - c_i) / dc_i, 0, 1), exactly the JAX
// formulation, degenerate zero-weight rows included). The metric edges go to
// shared memory; lane t then writes sample t, so every store of bins, ts, dl
// and the [3, N, T] planes is contiguous across the warp. The contraction
// keeps the 1e-12 clamps and the x-over-y-over-z tie-break. Built with
// -fmad=false so products and sums round like the separate PyTorch ops.
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

__global__ void __launch_bounds__(WARPS * 32)
ray_level_kernel(const float* __restrict__ rays8,
                 const float* __restrict__ w_prev,
                 const float* __restrict__ bins_prev,
                 const float* __restrict__ jitter, int N, int T0, int T,
                 int contract, int uniform_prev, float* __restrict__ bins,
                 float* __restrict__ ts, float* __restrict__ dl,
                 float* __restrict__ x3, int pack_q,
                 float* __restrict__ ts_p, float* __restrict__ dl_p) {
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
  ray_level_kernel<<<grid_for(N), WARPS * 32, 0, (cudaStream_t)stream>>>(
      rays8, w_prev, bins_prev, jitter, N, T0, T, contract, uniform_prev,
      bins, ts, dl, x3, pack_q, ts_p, dl_p);
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
