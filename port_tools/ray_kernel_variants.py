"""The designs of `flatten3_nt` and `ray_level0` measured against the ones
in csrc/ray_kernels.cu, as text substitutions in that source, for
`port_tools/ray_gather_variants.py` (one process a variant):

    python3 port_tools/ray_gather_variants.py \
        port_tools/ray_kernel_variants.py NAME level0,flatten

flatten3_nt (the source: tiles of 4 x 256 16 B units, one a block, 4
streaming loads in flight a thread, streaming stores):
  fl_persist  a persistent grid (the SMs x the blocks that fit on one),
              tile b + k grid to block b;
  fl_u8       8 loads in flight a thread;
  fl_contig   a persistent grid, each block one contiguous chunk;
  fl_plain    plain loads (ld.global.nc) and stores, no streaming hints;
  fl_ldcs_st  streaming loads, plain stores;
  fl_512      blocks of 512 threads;
  fl_pf256    loads with an L2 prefetch hint of 256 B
              (ld.global.nc.L1::no_allocate.L2::256B); fl_pf128 of 128 B;
  fl_tma      a TMA copy: one-warp blocks whose lane 0 moves 16 KB tiles
              global -> shared -> global with cp.async.bulk through
              FT_STAGES stages (mbarriers for the loads, bulk groups for the
              stores), on a persistent grid, each block one contiguous run
              of tiles;
  fl_tma_gs   the same, tile b + k grid to block b.
ray_level0 (the source: one tile of R rays a block, R T <= 1,024, as many
blocks as tiles, 4 samples a thread, streaming stores, the uniform edges
from a table the block divides once; below 4 samples a resident thread,
one warp a ray):
  l0_st       plain stores, not streaming ones;
  l0_whole    a path of its own where T % 4 == 0: a thread's 4 samples lie
              in one ray, whose row and 5 edges it reads from shared memory
              once, not once a sample;
  l0_div      b = j / T divided for every edge, not read from the table;
  l0_edges    tiles of R (T+1) <= 1,024 edges, not R T <= 1,024 samples;
  l0_s2048    tiles of R T <= 2,048 samples; l0_s4096 of 4,096;
  l0_512      blocks of 512 threads;
  l0_tiles_small  the tile kernel at every N (no warp-a-ray launch);
  l0_persist  a persistent grid (the SMs x the blocks that fit on one),
              each block walking tiles b, b + grid, ... with the next
              tile's rows staged by cp.async while it computes this one
              (two buffers), R also cut by N to spread the tiles evenly;
  l0_bulk     each tile's outputs staged in shared memory and written as
              flat ranges with one cp.async.bulk a range (direct stores
              where a range is not a multiple of 16 B);
  l0_onepass  no edge phase: each thread computes the 5 edges of its 4
              samples itself and writes their bins;
  l0_warp     one warp a ray at every N, as the parent's kernel, on a
              persistent grid that loads a warp's next ray while it
              computes this one, streaming stores; l0_warp_st the same with
              plain stores.
parent        the source of the commit before this design: unpack it first
              with `mkdir -p build/parent && git archive <parent commit>
              sanerf_tpu_torch/csrc | tar -x -C build/parent`.
"""

import os


_BULK_HELPERS = r'''
__device__ __forceinline__ void mbar_init(unsigned long long* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* b,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

'''

_ANCHOR = "__device__ __forceinline__ void put4("

_FLAT_TMA_KERNEL = r'''constexpr int FT_STAGES = 4, FT_TILE = 16384;
constexpr bool FT_INTERLEAVE = false;  // tile b + k grid to block b

// lane 0 of a one-warp block copies its FT_TILE-byte tiles through
// FT_STAGES shared-memory stages
__global__ void __launch_bounds__(32)
flatten3_tma_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long n) {
  extern __shared__ __align__(128) unsigned char fbuf[];
  __shared__ __align__(8) unsigned long long bar[FT_STAGES];
  const long bytes = (n / 4) * 16;
  const long ntiles = (bytes + FT_TILE - 1) / FT_TILE;
  const long per = (ntiles + gridDim.x - 1) / gridDim.x;
  const long t0 = FT_INTERLEAVE ? blockIdx.x : (long)blockIdx.x * per;
  const long step = FT_INTERLEAVE ? gridDim.x : 1;
  const long cnt = FT_INTERLEAVE
                       ? (t0 < ntiles ? (ntiles - 1 - t0) / step + 1 : 0)
                       : max(0L, min(t0 + per, ntiles) - t0);
  if (threadIdx.x == 0 && cnt > 0) {
    for (int s = 0; s < FT_STAGES; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const char* src = reinterpret_cast<const char*>(x);
    char* dst = reinterpret_cast<char*>(out);
    auto size_of = [&](long t) {
      return (unsigned)min((long)FT_TILE, bytes - t * FT_TILE);
    };
    auto load = [&](long i, int s) {
      const long t = t0 + i * step;
      mbar_expect(&bar[s], size_of(t));
      bulk_load(fbuf + s * FT_TILE, src + t * FT_TILE, size_of(t), &bar[s]);
    };
    for (int s = 0; s < FT_STAGES && s < cnt; ++s) load(s, s);
    for (long i = 0; i < cnt; ++i) {
      const int s = (int)(i % FT_STAGES);
      const long t = t0 + i * step;
      mbar_wait(&bar[s], (unsigned)((i / FT_STAGES) & 1));
      bulk_store(dst + t * FT_TILE, fbuf + s * FT_TILE, size_of(t));
      bulk_commit();
      // refill the previous stage once its store has read it
      if (i >= 1 && i - 1 + FT_STAGES < cnt) {
        bulk_wait_read<1>();
        load(i - 1 + FT_STAGES, (int)((i - 1) % FT_STAGES));
      }
    }
    bulk_wait_all();
  }
  const long done = (n / 4) * 4;
  if (blockIdx.x == 0 && threadIdx.x < n - done)
    out[done + threadIdx.x] = x[done + threadIdx.x];
}

'''

_FLAT_LAUNCH_OLD = r'''  const long units = vec ? n / 4 : n;
  const long per = vec ? (long)FLAT_UNROLL * FLAT_THREADS : FLAT_THREADS;
  const long tiles = (units + per - 1) / per;
  flatten3_kernel<<<(int)max(1L, min(tiles, (long)INT32_MAX)), FLAT_THREADS,
                    0, (cudaStream_t)stream>>>(x3, out, n, vec);
  return (int)cudaGetLastError();'''

_FLAT_LAUNCH_TMA = r'''  if (!vec) {
    const long tiles = (n + FLAT_THREADS - 1) / FLAT_THREADS;
    flatten3_kernel<<<(int)max(1L, min(tiles, (long)INT32_MAX)),
                      FLAT_THREADS, 0, (cudaStream_t)stream>>>(x3, out, n, 0);
    return (int)cudaGetLastError();
  }
  const int smem = FT_STAGES * FT_TILE;
  static const int attr = (int)cudaFuncSetAttribute(
      flatten3_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr) return attr;
  const long tiles = ((n / 4) * 16 + FT_TILE - 1) / FT_TILE;
  const long grid = resident_blocks(flatten3_tma_kernel, 32, smem);
  flatten3_tma_kernel<<<(int)max(1L, min(tiles, grid)), 32, smem,
                        (cudaStream_t)stream>>>(x3, out, n);
  return (int)cudaGetLastError();'''

_FLAT_PERSIST = [
    "  flatten3_kernel<<<(int)max(1L, min(tiles, (long)INT32_MAX)), "
    "FLAT_THREADS,",
    "  const long grid = resident_blocks(flatten3_kernel, FLAT_THREADS, 0);\n"
    "  flatten3_kernel<<<(int)max(1L, min(tiles, grid)), FLAT_THREADS,"]
_FLAT_LOOP = ("  for (long base = blockIdx.x * tile + threadIdx.x; base < n4;\n"
              "       base += gridDim.x * tile) {")
_FLAT_LOOP_CONTIG = (
    "  const long chunk = (n4 + gridDim.x - 1) / gridDim.x;\n"
    "  const long b0 = (long)blockIdx.x * chunk, b1 = min(b0 + chunk, n4);\n"
    "  for (long base = b0 + threadIdx.x; base < b1; base += tile) {")

_PUT_SMEM = r"""__device__ __forceinline__ void put_s4(float* dst, const float (&v)[4],
                                       int m) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < m) dst[u] = v[u];
}

"""
_L0_SMEM_ATTR = [
    "      (2 * (L0_SAMPLES + L0_MAX_RAYS) + 8 * L0_MAX_RAYS + MAXE) *\n"
    "          (int)sizeof(float));",
    "      200 * 1024);"]
_PUT_PLAIN = [["    __stcs(reinterpret_cast<float4*>(dst),\n"
               "           make_float4(v[0], v[1], v[2], v[3]));",
               "    *reinterpret_cast<float4*>(dst) =\n"
               "        make_float4(v[0], v[1], v[2], v[3]);"],
              ["    if (u < m) __stcs(dst + u, v[u]);",
               "    if (u < m) dst[u] = v[u];"]]
_SMEM = "      (size_t)(R * K * (jitter ? 2 : 1) + 8 * R + K) * sizeof(float);"
_TILE_LAUNCH = ("  ray_level0_tile_kernel<<<(int)(((long)N + R - 1) / R), "
                "L0_THREADS, smem,")

# ray_level0 with each tile's outputs staged in shared memory (s_out: bins
# [R, K], then ts, dl, x, y, z [R, T] each) and stored with cp.async.bulk
_L0_BULK = [
    [_ANCHOR, _BULK_HELPERS + _PUT_SMEM + _ANCHOR],
    ["  float* s_bj = jit + (jitter ? EK : 0);\n",
     "  float* s_bj = jit + (jitter ? EK : 0);\n"
     "  float* s_out = s_bj + ((K + 3) & ~3);\n"
     "  const int RT = R * T;\n"],
    ["  float* bins_t = bins + n0 * K;\n",
     "  const bool bulk = vec_out && (nr * K) % 4 == 0 && (nr * T) % 4 == 0;\n"
     "  float* bins_t = bulk ? s_out : bins + n0 * K;\n"],
    ["    put4(bins_t + f, v, m, vec_out);",
     "    if (bulk)\n"
     "      put_s4(bins_t + f, v, m);\n"
     "    else\n"
     "      put4(bins_t + f, v, m, vec_out);"],
    ["    const size_t i = s0 + f;\n"
     "    put4(ts + i, vt, m, vec_out);\n",
     "    if (bulk) {\n"
     "      float* o = s_out + EK + f;\n"
     "      put_s4(o, vt, m);\n"
     "      put_s4(o + RT, vd, m);\n"
     "      put_s4(o + 2 * RT, vx, m);\n"
     "      put_s4(o + 3 * RT, vy, m);\n"
     "      put_s4(o + 4 * RT, vz, m);\n"
     "      continue;\n"
     "    }\n"
     "    const size_t i = s0 + f;\n"
     "    put4(ts + i, vt, m, vec_out);\n"],
    ["      put4(dl_p + i, vd, m, vec_out);\n    }\n  }\n}\n",
     "      put4(dl_p + i, vd, m, vec_out);\n    }\n  }\n"
     "  if (bulk) {\n"
     "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n"
     "    if (threadIdx.x == 0) {\n"
     "      const unsigned sb = ns * 4;\n"
     "      const float* o = s_out + EK;\n"
     "      bulk_store(bins + n0 * K, s_out, ne * 4);\n"
     "      bulk_store(ts + s0, o, sb);\n"
     "      bulk_store(dl + s0, o + RT, sb);\n"
     "      bulk_store(x3 + s0, o + 2 * RT, sb);\n"
     "      bulk_store(x3 + plane + s0, o + 3 * RT, sb);\n"
     "      bulk_store(x3 + 2 * plane + s0, o + 4 * RT, sb);\n"
     "      if (pack_q) {\n"
     "        bulk_store(ts_p + s0, o, sb);\n"
     "        bulk_store(dl_p + s0, o + RT, sb);\n"
     "      }\n"
     "      bulk_commit();\n"
     "      bulk_wait_all();\n"
     "    }\n"
     "  }\n}\n"],
    [_SMEM, "      (size_t)(R * K * (jitter ? 3 : 2) + 8 * R + ((K + 3) & ~3) +\n"
            "               5 * R * T) * sizeof(float);"],
    _L0_SMEM_ATTR,
]

# ray_level0 on a persistent grid (the SMs x the blocks that fit on one):
# each block walks tiles b, b + grid, ... and stages the next tile's rows
# with cp.async while it computes this one (two buffers); R also cut by N
# so that the tiles spread evenly over the grid
_PERSIST_KERNEL = r"""__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

""" + r"""// Tiles of R rays, 4 consecutive edges and samples a thread (see the
// header). Shared memory: the tile's metric edges [R, T+1], two rays8
// buffers [R, 8], jittered two jitter buffers [R, T+1], and the K uniform
// edges j / T. vec_ray / vec_jit: 16 B copies of the rays8 / jitter rows;
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
  float* s_ray = s_rb + EK;
  float* s_jit = s_ray + 2 * R * 8;
  float* s_bj = s_jit + (jitter ? 2 * EK : 0);
  const long tiles = ((long)N + R - 1) / R;
  const size_t plane = (size_t)N * T;
  // the uniform edges, divided once a block (each is the same division)
  for (int j = threadIdx.x; j < K; j += L0_THREADS)
    s_bj[j] = (float)j / (float)T;
  const bool whole = false;  // as the tile kernel: no one-ray path
  auto stage = [&](long tile, int buf) {
    const long n0 = tile * R;
    const int nr = (int)min((long)R, (long)N - n0);
    stage_flat(s_ray + buf * R * 8, rays8 + n0 * 8, nr * 8, vec_ray);
    if (jitter)
      stage_flat(s_jit + buf * EK, jitter + n0 * K, nr * K, vec_jit);
  };
  long tile = blockIdx.x;
  if (tile < tiles) stage(tile, 0);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (all but the newest group)
    __syncthreads();
    const long n0 = tile * R;
    const int nr = (int)min((long)R, (long)N - n0);
    const float* ray = s_ray + buf * R * 8;
    const float* jit = s_jit + buf * EK;
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
    const size_t s0 = (size_t)n0 * T;
    for (int f = 4 * threadIdx.x; f < ns; f += 4 * L0_THREADS) {
      int q = f / T, t = f - q * T;
      const int m = min(4, ns - f);
      float vt[4], vd[4], vx[4], vy[4], vz[4];
      if (whole) {  // one ray: its row read once, its edges once each
        const float4 a = *reinterpret_cast<const float4*>(ray + q * 8);
        const float4 c = *reinterpret_cast<const float4*>(ray + q * 8 + 4);
        const float* rb = s_rb + q * K + t;
        float e[5];
#pragma unroll
        for (int u = 0; u < 5; ++u) e[u] = rb[u];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float tv = 0.5f * (e[u + 1] + e[u]);
          float x = a.x + a.w * tv, y = a.y + c.x * tv, z = a.z + c.y * tv;
          if (contract) contract3(x, y, z);
          vt[u] = tv;
          vd[u] = e[u + 1] - e[u];
          vx[u] = x;
          vy[u] = y;
          vz[u] = z;
        }
      } else {
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
    __syncthreads();
  }
  cp_async_wait<0>();
}

"""
_L0_PERSIST = [
    ["// One tile of R rays a block, 4 consecutive edges and samples a thread",
     "// One tile of R rays a block, 4 consecutive edges and samples a thread"],
    ["  const int R = min(L0_MAX_RAYS, L0_SAMPLES / T) & ~3;",
     "  int R = min(L0_MAX_RAYS, L0_SAMPLES / T) & ~3;"],
    [_SMEM, "      (size_t)(R * K * (jitter ? 3 : 1) + 16 * R + K) * sizeof(float);"],
    _L0_SMEM_ATTR,
    [_TILE_LAUNCH,
     "  const long grid = resident_blocks(ray_level0_tile_kernel, L0_THREADS,\n"
     "                                    smem);\n"
     "  const long per_block = (((long)N + R - 1) / R + grid - 1) / grid;\n"
     "  const long even = ((long)N + grid * per_block - 1) / (grid * per_block);\n"
     "  R = (int)max(4L, min((long)R, (even + 3) & ~3L));\n"
     "  ray_level0_tile_kernel<<<(int)min(((long)N + R - 1) / R, grid),\n"
     "                           L0_THREADS, smem,"],
]

_FEW = "  if ((long)N * T < 4L * L0_THREADS *\n"


def _function(src, head):
    """The text of src from `head` to the end of its function."""
    i = src.index(head)
    return src[i:src.index("\n}\n", i) + 3]


_SRC = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "sanerf_tpu_torch", "csrc", "ray_kernels.cu")).read()

# one warp a ray as in the parent, on a persistent grid: a warp walks rays
# n, n + W, ... (W the grid's warps) and loads ray n + W's row while it
# computes ray n; STORE is __stcs or st_plain
_L0_WARP = r'''__device__ __forceinline__ void st_plain(float* p, float v) { *p = v; }

__global__ void __launch_bounds__(WARPS * 32)
ray_level0_pwarp_kernel(const float* __restrict__ rays8,
                       const float* __restrict__ jitter, int N, int T,
                       int contract, float* __restrict__ bins,
                       float* __restrict__ ts, float* __restrict__ dl,
                       float* __restrict__ x3, int pack_q,
                       float* __restrict__ ts_p, float* __restrict__ dl_p) {
  __shared__ float s_rb[WARPS][MAXE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rb = s_rb[warp];
  const long stride = (long)gridDim.x * WARPS;
  const size_t plane = (size_t)N * T;
  const float fT = (float)T;
  long n = (long)blockIdx.x * WARPS + warp;
  float mine = n < N && lane < 8 ? __ldcs(rays8 + n * 8 + lane) : 0.0f;
  for (; n < N; n += stride) {
    const long nx = n + stride;
    const float next =
        nx < N && lane < 8 ? __ldcs(rays8 + nx * 8 + lane) : 0.0f;
    Ray r;
    r.ox = __shfl_sync(0xffffffffu, mine, 0);
    r.oy = __shfl_sync(0xffffffffu, mine, 1);
    r.oz = __shfl_sync(0xffffffffu, mine, 2);
    r.dx = __shfl_sync(0xffffffffu, mine, 3);
    r.dy = __shfl_sync(0xffffffffu, mine, 4);
    r.dz = __shfl_sync(0xffffffffu, mine, 5);
    r.sn = __shfl_sync(0xffffffffu, mine, 6);
    r.sf = __shfl_sync(0xffffffffu, mine, 7);
    for (int j = lane; j <= T; j += 32) {
      float b = (float)j / fT;
      if (jitter) b = fminf(fmaxf(b + jitter[n * (T + 1) + j], 0.0f), 1.0f);
      STORE(bins + n * (T + 1) + j, b);
      rb[j] = metric_edge(r, b);
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      const float r0 = rb[t], r1 = rb[t + 1];
      const float tv = 0.5f * (r1 + r0);
      float x = r.ox + r.dx * tv, y = r.oy + r.dy * tv, z = r.oz + r.dz * tv;
      if (contract) contract3(x, y, z);
      const size_t i = (size_t)n * T + t;
      STORE(ts + i, tv);
      STORE(dl + i, r1 - r0);
      STORE(x3 + i, x);
      STORE(x3 + plane + i, y);
      STORE(x3 + 2 * plane + i, z);
      if (pack_q) {
        STORE(ts_p + i, tv);
        STORE(dl_p + i, r1 - r0);
      }
    }
    __syncwarp();
    mine = next;
  }
}

'''
_L0_WARP_LAUNCH = r'''extern "C" int ray_level0_launch(const float* rays8, const float* jitter,
                                 int N, int T, int contract, float* bins,
                                 float* ts, float* dl, float* x3, int pack_q,
                                 float* ts_p, float* dl_p, void* stream) {
  if (T < 1 || T + 1 > MAXE || N < 0 || !pack_ok(N, pack_q, ts_p, dl_p))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const long want = ((long)N + WARPS - 1) / WARPS;
  const long grid = resident_blocks(ray_level0_pwarp_kernel, WARPS * 32, 0);
  ray_level0_pwarp_kernel<<<(int)max(1L, min(want, grid)), WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
      rays8, jitter, N, T, contract, bins, ts, dl, x3, pack_q, ts_p, dl_p);
  return (int)cudaGetLastError();
}
'''


def _l0_warp(store):
    return {"ray_kernels.cu": [
        [_function(_SRC, 'extern "C" int ray_level0_launch('),
         _L0_WARP_LAUNCH],
        ["// ray_level, few rays: one warp a ray (see the header)",
         _L0_WARP.replace("STORE(", store + "(")
         + "// ray_level, few rays: one warp a ray (see the header)"]]}


# ray_level0 where T % 4 == 0 takes a path of its own: a thread's 4 samples
# lie in one ray, whose row (two 16 B reads) and 5 edges it reads once
_L0_SAMPLES_LOOP = r"""  for (int f = 4 * threadIdx.x; f < ns; f += 4 * L0_THREADS) {
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
"""
_L0_WHOLE_LOOP = r"""  const bool whole = T % 4 == 0;  // a thread's 4 samples lie in one ray
  for (int f = 4 * threadIdx.x; f < ns; f += 4 * L0_THREADS) {
    int q = f / T, t = f - q * T;
    const int m = min(4, ns - f);
    float vt[4], vd[4], vx[4], vy[4], vz[4];
    if (whole) {  // one ray: its row read once, its edges once each
      const float4 a = *reinterpret_cast<const float4*>(ray + q * 8);
      const float4 c = *reinterpret_cast<const float4*>(ray + q * 8 + 4);
      const float* rb = s_rb + q * K + t;
      float e[5];
#pragma unroll
      for (int u = 0; u < 5; ++u) e[u] = rb[u];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float tv = 0.5f * (e[u + 1] + e[u]);
        float x = a.x + a.w * tv, y = a.y + c.x * tv, z = a.z + c.y * tv;
        if (contract) contract3(x, y, z);
        vt[u] = tv;
        vd[u] = e[u + 1] - e[u];
        vx[u] = x;
        vy[u] = y;
        vz[u] = z;
      }
    } else {
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
    }
"""


# ray_level0 in one pass: each thread computes the metric edges of its 4
# samples itself (5 edges for 4 samples of one ray, the last reused as the
# next sample's first) and writes their bins; no edge phase, no edges in
# shared memory, one barrier less
_L0_BODY_HEAD = "  // edges: 4 consecutive of the tile's nr K a thread\n"
_L0_BODY = _SRC[_SRC.index(_L0_BODY_HEAD):
                _SRC.index("\n}\n", _SRC.index(_L0_BODY_HEAD)) + 1]
_L0_ONEPASS_BODY = r"""  // samples and their edges: 4 consecutive samples a thread
  const int ns = nr * T;
  const size_t s0 = (size_t)n0 * T, plane = (size_t)N * T;
  float* bins_t = bins + n0 * K;
  for (int f = 4 * threadIdx.x; f < ns; f += 4 * L0_THREADS) {
    int q = f / T, t = f - q * T;
    const int m = min(4, ns - f);
    float vt[4], vd[4], vx[4], vy[4], vz[4];
    float4 a = *reinterpret_cast<const float4*>(ray + q * 8);
    float4 c = *reinterpret_cast<const float4*>(ray + q * 8 + 4);
    float b0 = s_bj[t];
    if (jitter) b0 = fminf(fmaxf(b0 + jit[q * K + t], 0.0f), 1.0f);
    float r0 = spacing_inv(c.z * (1.0f - b0) + c.w * b0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < m) {
        float b1 = s_bj[t + 1];
        if (jitter) b1 = fminf(fmaxf(b1 + jit[q * K + t + 1], 0.0f), 1.0f);
        const float r1 = spacing_inv(c.z * (1.0f - b1) + c.w * b1);
        __stcs(bins_t + q * K + t, b0);
        if (t == T - 1) __stcs(bins_t + q * K + T, b1);
        const float tv = 0.5f * (r1 + r0);
        float x = a.x + a.w * tv, y = a.y + c.x * tv, z = a.z + c.y * tv;
        if (contract) contract3(x, y, z);
        vt[u] = tv;
        vd[u] = r1 - r0;
        vx[u] = x;
        vy[u] = y;
        vz[u] = z;
        b0 = b1;
        r0 = r1;
        if (++t == T && u + 1 < m) {  // the next sample opens ray q + 1
          t = 0;
          ++q;
          a = *reinterpret_cast<const float4*>(ray + q * 8);
          c = *reinterpret_cast<const float4*>(ray + q * 8 + 4);
          b0 = s_bj[0];
          if (jitter) b0 = fminf(fmaxf(b0 + jit[q * K], 0.0f), 1.0f);
          r0 = spacing_inv(c.z * (1.0f - b0) + c.w * b0);
        }
      }
    }
    const size_t i = s0 + f;
    put4(ts + i, vt, m, vec_out);
    put4(dl + i, vd, m, vec_out);
    put4(x3 + i, vx, m, vec_out);
    put4(x3 + plane + i, vy, m, vec_out);
    put4(x3 + 2 * plane + i, vz, m, vec_out);
    if (pack_q) {
      put4(ts_p + i, vt, m, vec_out);
      put4(dl_p + i, vd, m, vec_out);
    }
  }
"""


def _fl_prefetch(size):
    """flatten3_nt's loads with an L2 prefetch of `size` bytes."""
    return {"ray_kernels.cu": [
        ["// tiles of FLAT_UNROLL x FLAT_THREADS 16 B units",
         "__device__ __forceinline__ float4 ld_pf(const float4* p) {\n"
         "  float4 v;\n"
         "  asm volatile(\"ld.global.nc.L1::no_allocate.L2::" + size +
         ".v4.f32 {%0, %1, %2, %3}, [%4];\\n\"\n"
         "               : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w)\n"
         "               : \"l\"(p));\n"
         "  return v;\n}\n\n"
         "// tiles of FLAT_UNROLL x FLAT_THREADS 16 B units"],
        ["      if (i < n4) v[u] = __ldcs(x4 + i);",
         "      if (i < n4) v[u] = ld_pf(x4 + i);"]]}


VARIANTS = {
    "fl_persist": {"ray_kernels.cu": [_FLAT_PERSIST]},
    "fl_u8": {"ray_kernels.cu": [["constexpr int FLAT_UNROLL = 4;",
                                  "constexpr int FLAT_UNROLL = 8;"]]},
    "fl_contig": {"ray_kernels.cu": [
        _FLAT_PERSIST, [_FLAT_LOOP, _FLAT_LOOP_CONTIG],
        ["      if (i < n4) v[u] = __ldcs(x4 + i);",
         "      if (i < b1) v[u] = __ldcs(x4 + i);"],
        ["      if (i < n4) __stcs(o4 + i, v[u]);",
         "      if (i < b1) __stcs(o4 + i, v[u]);"]]},
    "fl_plain": {"ray_kernels.cu": [
        ["      if (i < n4) v[u] = __ldcs(x4 + i);",
         "      if (i < n4) v[u] = __ldg(x4 + i);"],
        ["      if (i < n4) __stcs(o4 + i, v[u]);",
         "      if (i < n4) o4[i] = v[u];"]]},
    "fl_ldcs_st": {"ray_kernels.cu": [
        ["      if (i < n4) __stcs(o4 + i, v[u]);",
         "      if (i < n4) o4[i] = v[u];"]]},
    "fl_512": {"ray_kernels.cu": [["constexpr int FLAT_THREADS = 256;",
                                   "constexpr int FLAT_THREADS = 512;"]]},
    "fl_pf256": _fl_prefetch("256B"),
    "fl_pf128": _fl_prefetch("128B"),
    "fl_tma": {"ray_kernels.cu": [
        [_ANCHOR, _BULK_HELPERS + _ANCHOR],
        ["bool pack_ok(", _FLAT_TMA_KERNEL + "bool pack_ok("],
        [_FLAT_LAUNCH_OLD, _FLAT_LAUNCH_TMA]]},
    "fl_tma_gs": {"ray_kernels.cu": [
        [_ANCHOR, _BULK_HELPERS + _ANCHOR],
        ["bool pack_ok(", _FLAT_TMA_KERNEL.replace(
            "FT_INTERLEAVE = false", "FT_INTERLEAVE = true") + "bool pack_ok("],
        [_FLAT_LAUNCH_OLD, _FLAT_LAUNCH_TMA]]},
    "l0_st": {"ray_kernels.cu": _PUT_PLAIN},
    "l0_whole": {"ray_kernels.cu": [[_L0_SAMPLES_LOOP, _L0_WHOLE_LOOP]]},
    "l0_div": {"ray_kernels.cu": [["        float b = s_bj[j];",
                                   "        float b = (float)j / (float)T;"]]},
    "l0_edges": {"ray_kernels.cu": [
        ["R = min(L0_MAX_RAYS, L0_SAMPLES / T) & ~3;",
         "R = min(L0_MAX_RAYS, L0_SAMPLES / K) & ~3;"]]},
    "l0_s2048": {"ray_kernels.cu": [["constexpr int L0_SAMPLES = 1024;",
                                     "constexpr int L0_SAMPLES = 2048;"]]},
    "l0_s4096": {"ray_kernels.cu": [["constexpr int L0_SAMPLES = 1024;",
                                     "constexpr int L0_SAMPLES = 4096;"]]},
    "l0_512": {"ray_kernels.cu": [["constexpr int L0_THREADS = 256;",
                                   "constexpr int L0_THREADS = 512;"]]},
    "l0_tiles_small": {"ray_kernels.cu": [
        [_FEW, "  if (false && (long)N * T < 4L * L0_THREADS *\n"]]},
    "l0_persist": {"ray_kernels.cu": [
        [_function(_SRC, "// One tile of R rays a block, 4 consecutive"),
         _PERSIST_KERNEL], *_L0_PERSIST[1:]]},
    "l0_bulk": {"ray_kernels.cu": _L0_BULK},
    "l0_onepass": {"ray_kernels.cu": [[_L0_BODY, _L0_ONEPASS_BODY]]},
    "l0_warp": _l0_warp("__stcs"),
    "l0_warp_st": _l0_warp("st_plain"),
    "parent": {"ray_kernels.cu":
               "build/parent/sanerf_tpu_torch/csrc/ray_kernels.cu"},
}
