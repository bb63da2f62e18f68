// The hash grid's encode and its table gradient for Hopper (sm_90a), one
// launch a grid each. They share the corner code (`Level`, `make_levels`,
// `load_point`, `corners`).
//
// The encode (hash_grid_forward):
//
//   out[point, l, :] = sum over the corners c, in order, of w_c * row_c
//
// for every active level l of each in-cube point (zeros outside the cube
// and past the active levels). It computes the function of
// sanerf_tpu/ops/hashgrid.py:170-239 hash_encode_01, which the JAX package
// leaves to XLA; its row reads (the jnp.take at :229) are the lookups that
// the TPU kernels of tools/probe_gather.py:90-247 compute. Plain PyTorch
// version: sanerf_tpu_torch/ops/hashgrid.py:hash_grid_forward_plain, the
// level route (the index math in PyTorch, one gather_rows a level), bit for
// bit the same.
//
// Bound on an H100: memory. The points are read once (4 D B), the features
// written once (4 L C B, ~80 % of the bytes at the hash-grid frame) and
// each table row the points touch read once: 3.88 GB, 1.157 ms, at a
// 512^2 interactive frame's 7 launches. What keeps the kernel from it is
// the table's row reads, 2^D a point a level at random rows, through L1
// and L2 (the field's bf16 table, 25 MB, stays in L2).
//
// Design (PERF.md, section 6, row 15f, measures it and the variants in
// port_tools/hash_forward_variants.py):
//  - Persistent blocks of FWD_THREADS threads take tiles of as many
//    consecutive points (neighbouring samples of a ray), a thread a point,
//    which takes its levels in turn (point-major). Level-major, with all
//    blocks on one level at a time, was 2-2.5x slower at the frames.
//  - The corners and weights come from `corners`, rounded as the plain
//    version's. The rows are read through the read-only path
//    (ld.global.nc) as vectors; a corner pair {x, x + 1} whose rows share
//    one 2-row piece of at most 16 B is one load (kPairLoad: at a hashed
//    level with an even x, the x prime being 1, at a dense level with an
//    even row). Each product is w * row (a bf16 row widens exactly), the
//    sums in corner order.
//  - A tile's features are one contiguous range of the output. They are
//    built in shared memory a slab of FWD_SLAB floats a point at a time
//    (a row stride that keeps a warp's stores off each other's banks) and
//    stored by consecutive threads as 16-byte streaming stores (the output
//    is read once by the next kernel and should not push the table out of
//    L2). A slab of 16 floats beat 32 (one line a point) by 1.5x at the
//    frames: it leaves shared memory for more resident blocks.
//
// The table gradient (hash_grid_backward):
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
//  zeros).
//
// Shapes of both: D 2 or 3, C 1 to 8, at most MAX_LEVELS levels, float32
// tables (and bf16 ones for the encode); the wrappers refuse the rest
// (ROADMAP.md queue B).

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

// The 2^D corners of the cell of point xs at level L, in the reference's
// corner order (bit d of k picks the cell's upper face in dim d): their
// level-local rows and weights, rounded as the plain version's
// (ops/hashgrid.py:_level_taps). -> the cell's key (its lower corner, 21
// bits a dim). The forward and the backward share it.
template <int D>
__device__ __forceinline__ unsigned long long corners(
    const float (&xs)[D], const Level& L, int align, int smooth,
    unsigned (&rows)[1 << D], float (&w)[1 << D]) {
  constexpr int K = 1 << D;
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
  return key;
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
  unsigned rows[K];
  float w[K];
  unsigned long long key = corners<D>(xs, L, align, smooth, rows, w);
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

// ---------------------------------------------------------------------------
// the forward: the features of every point at every level
// ---------------------------------------------------------------------------

// points a tile, a thread each
constexpr int FWD_THREADS = 128;
// floats of a point's features staged in shared memory at a time (64 B:
// two whole sectors of the output a point)
constexpr int FWD_SLAB = 16;
// a staged row's floats at most (FWD_SLAB and its pad)
constexpr int FWD_ROW = FWD_SLAB + 4;
// at rows of at most 8 B, a corner pair whose rows share one 2-row piece as
// one load
constexpr bool kPairLoad = true;

// N elements of ES bytes at p (a float32 or a bf16 row, aligned to the
// largest power-of-two piece of its bytes up to 16) as floats, through the
// read-only path; bf16 widens exactly
template <int ES, int N>
__device__ __forceinline__ void load_row(const char* p, float (&v)[N]) {
  if constexpr (ES == 4) {
    const float* f = reinterpret_cast<const float*>(p);
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(f + i));
        v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(f + i));
        v[i] = a.x; v[i + 1] = a.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __ldg(f + i);
    }
  } else if constexpr (N % 2 == 0) {
    // two bf16 a 32-bit word, the first in its low half
    constexpr int WORDS = N / 2;
    unsigned u[WORDS];
    if constexpr (WORDS % 4 == 0) {
#pragma unroll
      for (int i = 0; i < WORDS; i += 4) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
        u[i] = a.x; u[i + 1] = a.y; u[i + 2] = a.z; u[i + 3] = a.w;
      }
    } else if constexpr (WORDS % 2 == 0) {
#pragma unroll
      for (int i = 0; i < WORDS; i += 2) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p) + i / 2);
        u[i] = a.x; u[i + 1] = a.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i)
        u[i] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __uint_as_float((unsigned)__ldg(h + i) << 16);
  }
}

// The features of point xs at level L (ok: in the cube; else zeros): the
// sum over its cell's corners, in corner order, of w * row, each product
// one rounding and the sums in that order (ops/hashgrid.py:_corner_sum).
template <int D, int C, int ES>
__device__ __forceinline__ void level_features(const char* __restrict__ table,
                                               const float (&xs)[D], bool ok,
                                               const Level& L, int align,
                                               int smooth, float (&acc)[C]) {
  constexpr int K = 1 << D, RB = C * ES;
  constexpr bool pair =
      kPairLoad && 2 * RB <= 16 && ((2 * RB) & (2 * RB - 1)) == 0;
  if (!ok) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    return;
  }
  unsigned rows[K];
  float w[K];
  corners<D>(xs, L, align, smooth, rows, w);
  const char* base = table + L.offset * RB;
  float v[K][C];
#pragma unroll
  for (int k = 0; k < K; k += 2) {
    const unsigned r0 = rows[k], r1 = rows[k + 1];
    if constexpr (pair) {
      // corners k (x at lo) and k + 1 (x at lo + 1) in one 2-row piece: at
      // a hashed level with an even x (the x prime is 1), at a dense level
      // with an even row
      if ((r0 >> 1) == (r1 >> 1) && r0 != r1) {
        float u[2 * C];
        load_row<ES, 2 * C>(base + (long long)(r0 & ~1u) * RB, u);
        const bool odd = r0 & 1u;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[k][c] = odd ? u[C + c] : u[c];
          v[k + 1][c] = odd ? u[c] : u[C + c];
        }
        continue;
      }
    }
    load_row<ES, C>(base + (long long)r0 * RB, v[k]);
    load_row<ES, C>(base + (long long)r1 * RB, v[k + 1]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = __fmul_rn(w[0], v[0][c]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(w[k], v[k][c]));
  }
}

// G floats read from shared memory at s in pieces of P, stored at o as one
// streaming store (the output is read once, by the next kernel: it should
// not push the table out of L2)
template <int P, int G>
__device__ __forceinline__ void put(float* o, const float* s) {
  float f[G];
#pragma unroll
  for (int c = 0; c < G; c += P) {
    if constexpr (P == 4) {
      const float4 a = *reinterpret_cast<const float4*>(s + c);
      f[c] = a.x; f[c + 1] = a.y; f[c + 2] = a.z; f[c + 3] = a.w;
    } else if constexpr (P == 2) {
      const float2 a = *reinterpret_cast<const float2*>(s + c);
      f[c] = a.x; f[c + 1] = a.y;
    } else {
      f[c] = s[c];
    }
  }
  if constexpr (G == 4) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(f[0], f[1], f[2], f[3]));
  } else if constexpr (G == 2) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(f[0], f[1]));
  } else {
    __stcs(o, f[0]);
  }
}

// C floats from registers to shared memory at p (V-float aligned) in
// pieces of V
template <int V, int C>
__device__ __forceinline__ void put_row(float* p, const float (&a)[C]) {
#pragma unroll
  for (int c = 0; c < C; c += V) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p + c) =
          make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p + c) = make_float2(a[c], a[c + 1]);
    } else {
      p[c] = a[c];
    }
  }
}

// out [B, L C] float32: point p's features at level l in columns l C ..
// l C + C - 1, zeros outside the cube and at levels l >= n. A block takes
// tiles of FWD_THREADS consecutive points, a thread a point (point-major:
// the thread takes its point's levels in turn); the tile's rows are built a
// slab of `lps` levels at a time in shared memory (a row every `rs` floats,
// a stride that keeps a warp's stores off each other's banks) and stored
// as the slab's block of the output, pieces of `gw` floats by consecutive
// threads: one contiguous range when the slab is the whole row.
template <int D, int C, int ES>
__global__ void __launch_bounds__(FWD_THREADS)
hash_forward_kernel(float* __restrict__ out, const char* __restrict__ table,
                    const float* __restrict__ x, long B, int L, int n,
                    const __grid_constant__ Levels lv, int align, int smooth,
                    int lps, int rs, int gw) {
  constexpr int V = Piece<C>::W;
  __shared__ __align__(16) float stage[FWD_THREADS * FWD_ROW];
  const long tiles = (B + FWD_THREADS - 1) / FWD_THREADS;
  const long LC = (long)L * C;
  float xs[D];
  float* row = stage + threadIdx.x * rs;
  for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long p0 = t * FWD_THREADS;
    const int np = (int)min((long)FWD_THREADS, B - p0);
    const bool ok = load_point<D>(x, p0 + threadIdx.x, B, xs);
    for (int l0 = 0; l0 < L; l0 += lps) {
      const int sl = min(lps, L - l0);
#pragma unroll 1
      for (int j = 0; j < sl; ++j) {
        const int l = l0 + j;
        float acc[C];
        level_features<D, C, ES>(table, xs, ok && l < n, lv.l[l < n ? l : 0],
                                 align, smooth, acc);
        put_row<V, C>(row + j * C, acc);
      }
      __syncthreads();
      // the slab's [np, sl C] block of the output
      const int per = sl * C / gw;
      float* o = out + p0 * LC + l0 * C;
      for (int i = threadIdx.x; i < np * per; i += FWD_THREADS) {
        const int q = i / per, col = (i - q * per) * gw;
        if (gw == 4)
          put<(V < 4 ? V : 4), 4>(o + q * LC + col, stage + q * rs + col);
        else if (gw == 2)
          put<(V < 2 ? V : 2), 2>(o + q * LC + col, stage + q * rs + col);
        else
          put<1, 1>(o + q * LC + col, stage + q * rs + col);
      }
      __syncthreads();
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

// the forward's launch: the slab (levels `lps`, row stride `rs`, store
// width `gw`) from the shapes
template <int D, int C, int ES>
int launch_forward(float* out, const char* table, const float* x, long B,
                   int L, const Levels& lv, int n, int align, int smooth,
                   cudaStream_t stream) {
  auto kernel = hash_forward_kernel<D, C, ES>;
  constexpr int V = Piece<C>::W;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FWD_THREADS,
                                                0);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int lps = FWD_SLAB / C < L ? FWD_SLAB / C : L, sw = lps * C;
  int rs = sw;  // rs / V odd: a warp's V-float stores take distinct banks
  while (rs % V || (rs / V) % 2 == 0) ++rs;
  const long LC = (long)L * C;
  const int gw = LC % 4 == 0 && sw % 4 == 0 ? 4
                 : (LC % 2 == 0 && sw % 2 == 0 ? 2 : 1);
  const long tiles = (B + FWD_THREADS - 1) / FWD_THREADS;
  long blocks = (long)n_sm * per_sm;
  if (blocks > tiles) blocks = tiles;
  kernel<<<(unsigned)blocks, FWD_THREADS, 0, stream>>>(
      out, table, x, B, L, n, lv, align, smooth, lps, rs, gw);
  return (int)cudaGetLastError();
}

template <int D, int ES>
int launch_forward_c(int C, float* out, const char* table, const float* x,
                     long B, int L, const Levels& lv, int n, int align,
                     int smooth, cudaStream_t s) {
  switch (C) {
#define HG_FWD(c) \
    case c: return launch_forward<D, c, ES>(out, table, x, B, L, lv, n, \
                                            align, smooth, s);
    HG_FWD(1) HG_FWD(2) HG_FWD(3) HG_FWD(4) HG_FWD(5) HG_FWD(6) HG_FWD(7)
    HG_FWD(8)
#undef HG_FWD
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

// out: [B, L C] float32, 16 B-aligned; table: [rows, C] float32 (es 4) or
// bf16 (es 2), 16 B-aligned; x: [B, D] float32 points (outside the unit
// cube they give zeros); the first n <= L levels' metadata in the host
// arrays, the levels past them zeros. -> the CUDA error code of the launch
// (0: launched).
extern "C" int hash_grid_forward_launch(float* out, const void* table, int es,
                                        int C, const float* x, int D, long B,
                                        int L, int n, const long long* offsets,
                                        const unsigned* sizes, const int* res,
                                        const int* hashed, int align,
                                        int smooth, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > MAX_LEVELS || L < n || D < 2 || D > 3 || C < 1 || C > 8 ||
      (es != 2 && es != 4))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out | (uintptr_t)table) % 16)
    return (int)cudaErrorMisalignedAddress;
  Levels lv;
  const int bad = make_levels(D, n, offsets, sizes, res, hashed, lv.l);
  if (bad) return bad;
  const char* t = static_cast<const char*>(table);
  if (D == 2)
    return es == 4 ? launch_forward_c<2, 4>(C, out, t, x, B, L, lv, n, align,
                                            smooth, stream)
                   : launch_forward_c<2, 2>(C, out, t, x, B, L, lv, n, align,
                                            smooth, stream);
  return es == 4 ? launch_forward_c<3, 4>(C, out, t, x, B, L, lv, n, align,
                                          smooth, stream)
                 : launch_forward_c<3, 2>(C, out, t, x, B, L, lv, n, align,
                                          smooth, stream);
}
