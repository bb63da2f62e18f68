// The hash grid's table gradient for Hopper (sm_90a), one launch a grid:
//
//   grad[offset_l + idx_c] += w_c * g[point, l, :]
//
// for every active level l and every corner c of each in-cube point's cell
// (hash_grid_backward). The table's gradient in training: the gradient of
// sanerf_tpu/ops/hashgrid.py:170-239 hash_encode_01 with respect to the
// table, which the JAX package leaves to XLA (the scatter-add of the
// jnp.take at :229). No Pallas kernel has it: like gather.cu's
// gather_rows_backward, which it replaces on the training step, it is a
// kernel of the port without a TPU counterpart. Plain PyTorch version:
// sanerf_tpu_torch/ops/hashgrid.py:hash_grid_backward_plain (the same
// corner taps and index_add_ into a zero gradient).
//
// Bound on an H100: memory, then the L2's atomic units. The inputs are the
// points x01 (4 D B a point) and the output gradient g (4 L C B a point),
// each read once; each touched table row is read and written once (8 C B)
// and the others written. At a hash-grid training step that is 0.066 ms
// (chip_smoke T3), where the route it replaces read 1.16 GB of corner
// indices and gradient rows that the forward had saved or autograd had
// written (26 launches, one a level). What keeps the kernel from that bound
// is the adds: 96.5 M a step, 2^D a point a level, each a read-modify-write
// in L2, which takes ~88 G atomic requests a second (1.1 ms for them one
// by one), hundreds of them on each row of the coarse levels.
//
// Design (PERF.md, section 6, row 15, measures it and the designs before
// it):
//  - One launch a grid, persistent blocks, a thread a point of a tile of
//    THREADS consecutive points (neighbouring samples of a ray). The work
//    is taken in one of two orders, by the size of the grid's gradient:
//    * point-major, at most kLevelMajorBytes: a block walks its tiles and
//      each thread takes its point's levels in turn, reading the point once
//      (4 D B) and its output gradient a level at a time (4 C B, through
//      L1). The proposal grids' 3 MB stay in L2 whole, and the blocks'
//      adds spread over the levels;
//    * level-major, past it (the field's 50 MB): items (level, tile), all
//      blocks on one level at a time, so that the level's rows (4 MB at a
//      hashed level) stay in L2. Point-major, the field took 16 % longer;
//      level-major, the proposal grids 21 % longer (their coarse rows
//      then take every block's adds at once).
//  - The corners are recomputed in registers with native uint32
//    arithmetic: the xor hash with the primes 1, 2654435761, 805459861, or
//    the dense / tiled index with its strides mod 2^32 (the break at
//    stride > size taken on the host in 64 bits), then % size (a mask at
//    power-of-two sizes). The weights round as the plain version's: x res
//    - 0.5 in one fused multiply-add (XLA's contraction), the rest with
//    -fmad=false (ops/_build.py), the dim-order product of 1 - frac /
//    frac, smoothstep's frac frac (3 - 2 frac), and w * g one float32
//    product. Only the order of the sums differs from the plain version.
//  - The card adds into L2 at ~88 G atomic requests a second whatever
//    their width (1, 2 or 4 floats; port_tools/red_probe.cu), fewer when
//    many land on one row at once, so the kernel issues as few requests as
//    it can:
//    * lanes whose points lie in one cell of the level (a run of
//      consecutive samples of a ray: the coarse levels' cells hold many)
//      sum their adds first, a segmented scan over the warp by shuffles,
//      and the run's last lane adds the sums (at levels of at least
//      kRunAddsPerRow adds a row); the summing in the first design,
//      __match_any_sync a corner, cost more;
//    * at C <= 2 the corner pair {x, x + 1} whose rows share one 2C-float
//      piece is one request (kPairAdd): at a hashed level with an even x
//      (the x prime is 1, so the rows are r and r ^ 1), at a dense level
//      with an even row (r and r + 1);
//    * every other add is one vector atomicAdd a piece of the row
//      (Hopper's float4 / float2 / float atomics; the result unused, so
//      red.global.add).
//    Past four channels (the SAM grid's C = 8) the corners' adds are taken
//    in passes of kGroup channels, each with its own run sums: one pass of
//    8 held 64 sums a lane and spilled at 128 registers (3 % slower).
//    Summing the coarse levels in shared memory (the first design) was
//    slower: one block an SM for the shared levels, and shared atomics
//    that serialise on a run's rows.
//  Points outside the unit cube add nothing (the forward gives them
//  zeros). Shapes: D 2 or 3, C 1 to 8, at most MAX_LEVELS levels; the
//  wrapper refuses the rest (ROADMAP.md queue B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
// the work is taken level-major (all blocks on one level at a time) for a
// gradient of more than this many bytes, a third of the 50 MB L2
constexpr long long kLevelMajorBytes = 16ll << 20;
// at a level of at least this many adds a row on average, lanes whose
// points share the level's cell sum their adds first
constexpr long kRunAddsPerRow = 0;
// at C <= 2, a corner pair whose rows share one 2C-float piece as one add
constexpr bool kPairAdd = true;

constexpr unsigned PRIMES[3] = {1u, 2654435761u, 805459861u};

struct Level {
  long long offset;  // first row in the table
  unsigned size;     // rows
  unsigned mask;     // size - 1 at a power-of-two size, else 0
  unsigned mult[3];  // per dim: the hash prime, or the dense stride mod
                     // 2^32 (0 past the dims a tiled level consumes)
  int res;
  int hashed;  // xor of the terms (else their sum)
  int runs;    // lanes in one cell sum their adds first
};

struct Levels {
  Level l[MAX_LEVELS];
};

template <int C> struct Piece {
  static constexpr int W = C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
};

// channels a pass over the corners takes
constexpr int kGroup = 4;

template <int W>
__device__ __forceinline__ void add_global(float* p, const float* v) {
  if constexpr (W == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// G floats at p in pieces of W
template <int W, int G>
__device__ __forceinline__ void add_pieces(float* p, const float* v) {
#pragma unroll
  for (int c = 0; c < G; c += W) add_global<W>(p + c, v + c);
}

template <int W, int G>
__device__ __forceinline__ void load_pieces(const float* p, float* v) {
#pragma unroll
  for (int c = 0; c < G; c += W) {
    if constexpr (W == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + c));
      v[c] = a.x; v[c + 1] = a.y; v[c + 2] = a.z; v[c + 3] = a.w;
    } else if constexpr (W == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p + c));
      v[c] = a.x; v[c + 1] = a.y;
    } else {
      v[c] = __ldg(p + c);
    }
  }
}

// Channels C0 .. C0 + G - 1 of the lane's adds: w * g at each corner's row,
// summed over the lane's run first where `scan` (start: the run's first
// lane), added where `adds`; then the next channels.
template <int D, int C, int C0>
__device__ __forceinline__ void channel_adds(
    float* base, const float* gp, bool ok, const unsigned (&rows)[1 << D],
    const float (&w)[1 << D], bool scan, int start, bool adds, int lane) {
  constexpr int K = 1 << D, W = Piece<C>::W;
  constexpr int G = C - C0 < kGroup ? C - C0 : kGroup;
  float gv[G];
  if (ok) {
    load_pieces<W, G>(gp + C0, gv);
  } else {
#pragma unroll
    for (int c = 0; c < G; ++c) gv[c] = 0.f;
  }
  float v[K][G];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < G; ++c) v[k][c] = __fmul_rn(w[k], gv[c]);
  }
  if (scan) {  // a segmented inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int c = 0; c < G; ++c) {
          const float t = __shfl_up_sync(0xffffffffu, v[k][c], o);
          if (lane - o >= start) v[k][c] = __fadd_rn(v[k][c], t);
        }
      }
    }
  }
  if (adds) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const unsigned r0 = rows[k], r1 = rows[k + 1];
      if constexpr (kPairAdd && C <= 2) {
        // corners k (x at lo) and k + 1 (x at lo + 1) in one 2C-float
        // piece
        if ((r0 >> 1) == (r1 >> 1) && r0 != r1) {
          float u[2 * C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            u[c] = r0 < r1 ? v[k][c] : v[k + 1][c];
            u[C + c] = r0 < r1 ? v[k + 1][c] : v[k][c];
          }
          add_global<2 * C>(base + (long)(r0 & ~1u) * C, u);
          continue;
        }
      }
      add_pieces<W, G>(base + (long)r0 * C + C0, v[k]);
      add_pieces<W, G>(base + (long)r1 * C + C0, v[k + 1]);
    }
  }
  if constexpr (C0 + kGroup < C)
    channel_adds<D, C, C0 + kGroup>(base, gp, ok, rows, w, scan, start, adds,
                                    lane);
}

// The adds of the warp's points at level l: each lane's point p (ok:
// in range and in the cube) adds w * g at its cell's 2^D corners. Every
// lane of the warp calls it (the run sums are warp collectives).
template <int D, int C>
__device__ __forceinline__ void level_adds(float* __restrict__ grad,
                                           const float* __restrict__ g,
                                           const float (&xs)[D], bool ok,
                                           long p, int gstride,
                                           const Level& L, int l, int align,
                                           int smooth) {
  constexpr int K = 1 << D;
  const int lane = threadIdx.x & 31;
  float wf[D][2];
  unsigned term[D][2];
  unsigned long long key = 0;  // the cell
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float pos, pg;
    if (align) {
      pos = __fmul_rn(xs[d], (float)(L.res - 1));
      pg = fminf(floorf(pos), (float)(L.res - 2));
    } else {
      pos = fminf(fmaxf(__fmaf_rn(xs[d], (float)L.res, -0.5f), 0.f),
                  (float)(L.res - 1));
      pg = floorf(pos);
    }
    float f = __fsub_rn(pos, pg);
    if (smooth)
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.f, __fmul_rn(2.f, f)));
    wf[d][0] = __fsub_rn(1.f, f);
    wf[d][1] = f;
    const int lo = (int)pg;
    term[d][0] = (unsigned)lo * L.mult[d];
    term[d][1] = (unsigned)min(lo + 1, L.res - 1) * L.mult[d];
    key |= (unsigned long long)((unsigned)lo & 0x1fffffu) << (21 * d);
  }
  unsigned rows[K];
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float wk = wf[0][k & 1];
    unsigned idx = term[0][k & 1];
#pragma unroll
    for (int d = 1; d < D; ++d) {
      wk = __fmul_rn(wk, wf[d][(k >> d) & 1]);
      idx = L.hashed ? (idx ^ term[d][(k >> d) & 1])
                     : (idx + term[d][(k >> d) & 1]);
    }
    rows[k] = L.mask ? (idx & L.mask) : (idx % L.size);
    w[k] = wk;
  }
  bool adds = ok, scan = false;
  int start = lane;
  if (L.runs) {
    // a lane with nothing to add is a run of its own
    if (!ok) key = ~0ull - (unsigned)lane;
    const unsigned long long before = __shfl_up_sync(0xffffffffu, key, 1);
    const unsigned heads =
        __ballot_sync(0xffffffffu, lane == 0 || key != before);
    if (heads != 0xffffffffu) {  // some run is longer than one lane
      scan = true;
      start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
      // the run's last lane adds its sums
      adds = ok && (lane == 31 || ((heads >> (lane + 1)) & 1u));
    }
  }
  channel_adds<D, C, 0>(grad + L.offset * C, g + p * (long)gstride + l * C,
                        ok, rows, w, scan, start, adds, lane);
}

template <int D>
__device__ __forceinline__ bool load_point(const float* __restrict__ x,
                                           long p, long B, float (&xs)[D]) {
  bool ok = p < B;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xs[d] = ok ? __ldg(x + p * D + d) : 0.f;
    ok = ok && !(xs[d] < 0.f || xs[d] > 1.f);
  }
  return ok;
}

template <int D, int C>
__global__ void __launch_bounds__(THREADS, 2)
hash_backward_kernel(float* __restrict__ grad, const float* __restrict__ x,
                     const float* __restrict__ g, long B, int gstride,
                     int n_levels, const __grid_constant__ Levels lv,
                     int align, int smooth, bool level_major) {
  const long tiles = (B + THREADS - 1) / THREADS;
  float xs[D];
  if (level_major) {
    const long items = tiles * n_levels;
    for (long it = blockIdx.x; it < items; it += gridDim.x) {
      const int l = (int)(it / tiles);
      const long p = (it - l * tiles) * THREADS + threadIdx.x;
      const bool ok = load_point<D>(x, p, B, xs);
      level_adds<D, C>(grad, g, xs, ok, p, gstride, lv.l[l], l, align,
                       smooth);
    }
  } else {
    for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long p = t * THREADS + threadIdx.x;
      const bool ok = load_point<D>(x, p, B, xs);
#pragma unroll 1
      for (int l = 0; l < n_levels; ++l)
        level_adds<D, C>(grad, g, xs, ok, p, gstride, lv.l[l], l, align,
                         smooth);
    }
  }
}

// levels from the spec's arrays: the multipliers, the mask; -> 0, or a
// CUDA error code for a level the kernel does not take
int make_levels(int D, int n, const long long* offsets,
                const unsigned* sizes, const int* res, const int* hashed,
                Level* out) {
  for (int l = 0; l < n; ++l) {
    Level& L = out[l];
    L = Level{};
    L.offset = offsets[l];
    L.size = sizes[l];
    L.res = res[l];
    if (L.size == 0 || L.size % 8 || L.res < 1)
      return (int)cudaErrorInvalidValue;
    L.mask = (L.size & (L.size - 1)) == 0 ? L.size - 1 : 0u;
    L.hashed = hashed[l] != 0;
    if (L.hashed) {
      for (int d = 0; d < D; ++d) L.mult[d] = PRIMES[d];
    } else {
      unsigned long long stride = 1;
      for (int d = 0; d < D; ++d) {
        if (stride > (unsigned long long)L.size) break;
        L.mult[d] = (unsigned)(stride & 0xffffffffull);
        stride *= (unsigned long long)L.res;
      }
    }
  }
  return 0;
}

template <int D, int C>
int launch(float* grad, const float* x, const float* g, long B, int gstride,
           const Levels& lv, int n, int align, int smooth,
           cudaStream_t stream) {
  auto kernel = hash_backward_kernel<D, C>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long tiles = (B + THREADS - 1) / THREADS;
  Levels planned = lv;
  for (int l = 0; l < n; ++l)
    planned.l[l].runs = (B << D) >= kRunAddsPerRow * (long)lv.l[l].size;
  const long long rows = lv.l[n - 1].offset + lv.l[n - 1].size;
  const bool level_major = rows * C * 4 > kLevelMajorBytes;
  const long items = level_major ? tiles * n : tiles;
  long blocks = (long)n_sm * per_sm;
  if (blocks > items) blocks = items;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      grad, x, g, B, gstride, n, planned, align, smooth, level_major);
  return (int)cudaGetLastError();
}

template <int D>
int launch_c(int C, float* grad, const float* x, const float* g, long B,
             int gstride, const Levels& lv, int n, int align, int smooth,
             cudaStream_t s) {
  switch (C) {
    case 1: return launch<D, 1>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 2: return launch<D, 2>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 3: return launch<D, 3>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 4: return launch<D, 4>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 5: return launch<D, 5>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 6: return launch<D, 6>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 7: return launch<D, 7>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    case 8: return launch<D, 8>(grad, x, g, B, gstride, lv, n, align, smooth, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hash_backward_max_levels() { return MAX_LEVELS; }

// grad: [rows, C] float32, 16 B-aligned, added into; x: [B, D] float32
// points (outside the unit cube they add nothing); g: [B, gstride]
// float32, 16 B-aligned, level l's gradient at columns l C .. l C + C - 1;
// the first n levels' metadata in the host arrays. -> the CUDA error code
// of the launch (0: launched).
extern "C" int hash_grid_backward_launch(float* grad, int C, const float* x,
                                         int D, const float* g, long B,
                                         int gstride, int n,
                                         const long long* offsets,
                                         const unsigned* sizes,
                                         const int* res, const int* hashed,
                                         int align, int smooth,
                                         cudaStream_t stream) {
  if (B <= 0 || n == 0) return 0;
  if (n < 0 || n > MAX_LEVELS || D < 2 || D > 3 || C < 1 || C > 8 ||
      gstride < n * C)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)grad | (uintptr_t)g) % 16)
    return (int)cudaErrorMisalignedAddress;
  Levels lv;
  const int bad = make_levels(D, n, offsets, sizes, res, hashed, lv.l);
  if (bad) return bad;
  if (D == 2)
    return launch_c<2>(C, grad, x, g, B, gstride, lv, n, align, smooth,
                       stream);
  return launch_c<3>(C, grad, x, g, B, gstride, lv, n, align, smooth,
                     stream);
}
