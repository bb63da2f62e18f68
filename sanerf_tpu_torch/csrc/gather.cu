// Row gather out[i] = table[idx[i]] for Hopper (sm_90a): the per-point
// table lookup of the instant-ngp hash encoder; and its gradient, the
// scatter-add grad_table[idx[i]] += grad_out[i] (gather_rows_backward, at
// the end of this file).
//
// Replaces the eight Pallas probes of tools/probe_gather.py, which are all
// formulations of one function: pallas_dynloop :90, pallas_dynloop_vmem
// :109, pallas_take :125, pallas_take_small :142 (C = 128), p_loop :185,
// p2_take :202 (out-of-range rows filled with 0), p_loop8 :226 and p_blk
// :244 (8-row blocks: the same gather on the table viewed as [R/8, 8C]).
// In the JAX package the encoder's gather is the jnp.take of
// sanerf_tpu/ops/hashgrid.py:229. Plain PyTorch version:
// sanerf_tpu_torch/ops/gather.py:gather_rows_plain.
//
// Bound on an H100: memory. Each index is read once (4 B), each output
// row written once (row_bytes), and the table rows are read through L2
// (the encoder's per-level tables are 1-8 MB, the 2^19-row probe tables
// 4-256 MB, against a 50 MB L2). Nothing is computed, so the time is the
// bytes over 3.35 TB/s at best; random row reads of 4-32 B each cost a
// 32 B L2 sector apiece, which is what keeps a gather from that bound.
//
// Two kernels, both a copy of bytes, the same for float32 and bf16. An
// index outside [0, rows) writes zeros (jnp.take's mode="fill",
// fill_value=0). Offsets are 64-bit.
//
// narrow_kernel, rows of 2, 4, 8 or 16 B (C = 1-8): the hash grid's rows.
// A unit is 16 B of output, U = 16 / row_bytes rows. Lane l of a warp takes
// units l, l + 32, ... (KU of them, ROWS_IN_FLIGHT rows), so each of its
// index loads (one U-int vector) and each 16 B store is contiguous across
// the warp. It loads all its indices, then issues every table read, and
// only then stores: ROWS_IN_FLIGHT random reads in flight a thread, where
// one row a thread left one dependent index -> row -> store chain at a
// time. Indices are read with ld.global.cs and outputs written with
// st.global.cs (touched once: evict first), so the table keeps the L2.
// Table rows are read with ld.global.nc, through L1: the hash encoder's
// corner indices come from neighbouring samples and reuse rows there
// (measured on the H100: its 26 gathers of a 512^2 frame took 3.8x as long
// with L1::no_allocate; the probes' uniform indices moved by nothing). The
// index count's remainder past the last whole unit is one row a thread.
// The launch takes this kernel when the index and output pointers allow
// the vectors; otherwise the generic kernel.
//
// generic_kernel, any row: the row is cut into pieces of the widest vector
// (16, 8, 4, 2 or 1 B) that divides the row and both base addresses.
// Thread t copies piece t % ppr of output row t / ppr, so neighbouring
// threads write neighbouring addresses and every store coalesces; the index
// is read with __ldg (threads of one row share it through L1) and the piece
// with __ldg. One thread a piece, a grid-stride loop past 2^24 blocks. At
// C = 128 (32 threads a row) and at 8-row blocks it moves whole sectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long MAX_BLOCKS = 1L << 24;
// narrow kernel: table rows a thread has in flight before it stores
// (measured on the H100: 8 is faster than 16 or 32 on the hash-grid frame)
constexpr int ROWS_IN_FLIGHT = 8;

template <typename V>
__global__ void __launch_bounds__(THREADS)
generic_kernel(const V* __restrict__ table, long rows, int ppr, int shift,
               const int32_t* __restrict__ idx, long total,
               V* __restrict__ out) {
  const long stride = (long)gridDim.x * THREADS;
  for (long t = (long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += stride) {
    long i;
    int p;
    if (shift >= 0) {
      i = t >> shift;
      p = (int)(t & (ppr - 1));
    } else {
      i = t / ppr;
      p = (int)(t - i * ppr);
    }
    const long r = __ldg(idx + i);
    V v{};
    if (r >= 0 && r < rows) v = __ldg(table + r * ppr + p);
    out[t] = v;
  }
}

template <typename V>
int launch_generic(const void* table, long rows, int row_bytes,
                   const int32_t* idx, long m, void* out,
                   cudaStream_t stream) {
  const int ppr = row_bytes / (int)sizeof(V);
  int shift = -1;
  if ((ppr & (ppr - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < ppr) ++shift;
  }
  const long total = m * ppr;
  long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  generic_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(table), rows, ppr, shift, idx, total,
      static_cast<V*>(out));
  return (int)cudaGetLastError();
}

// one table row of RB bytes as a vector
template <int RB> struct RowOf;
template <> struct RowOf<2> { using T = unsigned short; };
template <> struct RowOf<4> { using T = unsigned int; };
template <> struct RowOf<8> { using T = uint2; };
template <> struct RowOf<16> { using T = uint4; };

// the U indices of one unit, read once (evict first)
template <int U>
__device__ __forceinline__ void ld_idx(const int32_t* p, int* r) {
  if constexpr (U == 1) {
    r[0] = __ldcs(p);
  } else if constexpr (U == 2) {
    const int2 a = __ldcs(reinterpret_cast<const int2*>(p));
    r[0] = a.x; r[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < U / 4; ++h) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(p) + h);
      r[4 * h] = a.x; r[4 * h + 1] = a.y;
      r[4 * h + 2] = a.z; r[4 * h + 3] = a.w;
    }
  }
}

template <int RB>
union Unit {
  uint4 v;
  typename RowOf<RB>::T row[16 / RB];
};

template <int RB>
__global__ void __launch_bounds__(THREADS)
narrow_kernel(const typename RowOf<RB>::T* __restrict__ table, long rows,
              const int32_t* __restrict__ idx, long m,
              uint4* __restrict__ out) {
  using V = typename RowOf<RB>::T;
  constexpr int U = 16 / RB;
  constexpr int KU = ROWS_IN_FLIGHT / U > 0 ? ROWS_IN_FLIGHT / U : 1;
  const long units = m / U;
  const int lane = threadIdx.x & 31;
  const long gt = (long)blockIdx.x * THREADS + threadIdx.x;
  const long warps = (long)gridDim.x * (THREADS / 32);
  for (long w = gt >> 5; w * 32 * KU < units; w += warps) {
    const long u0 = w * 32 * KU + lane;
    int r[KU][U];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      if (u0 + 32L * k < units) {
        ld_idx<U>(idx + (u0 + 32L * k) * U, r[k]);
      } else {
#pragma unroll
        for (int j = 0; j < U; ++j) r[k][j] = -1;
      }
    }
    Unit<RB> v[KU];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const long rr = r[k][j];
        v[k].row[j] = (rr >= 0 && rr < rows) ? __ldg(table + rr) : V{};
      }
    }
#pragma unroll
    for (int k = 0; k < KU; ++k)
      if (u0 + 32L * k < units) __stcs(out + u0 + 32L * k, v[k].v);
  }
  // the rows past the last whole unit, one a thread
  const long i = units * U + gt;
  if (i < m) {
    const long rr = __ldcs(idx + i);
    reinterpret_cast<V*>(out)[i] =
        (rr >= 0 && rr < rows) ? __ldg(table + rr) : V{};
  }
}

template <int RB>
int launch_narrow(const void* table, long rows, const int32_t* idx, long m,
                  void* out, cudaStream_t stream) {
  constexpr int U = 16 / RB;
  constexpr int KU = ROWS_IN_FLIGHT / U > 0 ? ROWS_IN_FLIGHT / U : 1;
  const long units = m / U;
  const long warps = (units + 32L * KU - 1) / (32L * KU);
  long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks < 1) blocks = 1;  // the remainder rows
  if (blocks > (1L << 24)) blocks = 1L << 24;
  narrow_kernel<RB><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const typename RowOf<RB>::T*>(table), rows, idx, m,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gather_rows_backward: grad[idx[i]] += gout[i] over float32 rows of C.
//
// The gradient of the gather, which the JAX package leaves to XLA's
// scatter-add (no Pallas kernel has it). Plain PyTorch version:
// sanerf_tpu_torch/ops/gather.py:gather_rows_backward_plain (index_add_ on
// the same views). Each row is cut into pieces of VW floats (4, 2 or 1: the
// widest that divides C and both base addresses); thread t takes piece
// t % ppr of gradient row t / ppr, for table row idx[t / ppr]. Where the
// launch adds many index rows a table row (kWarpSumRatio), the lanes of a
// warp that add into the same piece (__match_any_sync) sum their pieces in
// registers first, in lane order, and the first of them adds the sum; each
// add is one vector atomicAdd (Hopper has float2 / float4 atomicAdd on
// global memory; the result is unused, so it compiles to a reduction,
// red.global.add).
// The gradient rows are read once, with streaming loads; an index outside
// [0, rows) adds nothing, as the forward gives zeros there. The sums of one
// row run in the order the warps' atomics reach L2, which changes from run
// to run: the result differs from index_add_'s by rounding only.
//
// Bound on an H100: memory. Each index is read once (4 B), each gradient
// row once (4 C B), and each distinct table row touched is read and
// written once at L2 (8 C B); the hash encoder's rows of 8 B are a quarter
// of a 32 B sector, which keeps the kernel from that bound.

template <int VW> struct PieceOf;
template <> struct PieceOf<1> { using T = float; };
template <> struct PieceOf<2> { using T = float2; };
template <> struct PieceOf<4> { using T = float4; };

// a launch sums across the warp when it adds at least this many index
// rows a table row on average: the encoder's neighbouring samples share
// the cells of the coarse levels, where hundreds of adds land on each row
// and summing first cuts the atomics to a row 3-4x; at the fine, hashed
// levels (4-32 adds a row) neighbours rarely share a row and the match
// costs up to 50 % (port_tools/scatter_variants.py on an NVIDIA H100 80GB
// HBM3 at 700 W: 64 adds a row lost 16 %, 86 won 18 %)
constexpr long kWarpSumRatio = 80;

template <int VW>
__device__ __forceinline__ void add_piece(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <int VW>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(float* __restrict__ grad, long rows, int ppr, int shift,
                   const int32_t* __restrict__ idx, long total,
                   const float* __restrict__ gout, bool warp_sum) {
  using V = typename PieceOf<VW>::T;
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * THREADS;
  // the whole warp steps together (stride and start are warp-aligned)
  for (long b = (long)blockIdx.x * THREADS + (threadIdx.x & ~31); b < total;
       b += stride) {
    const long t = b + lane;
    long dst = -1;  // the piece this lane adds into; -1: none
    float v[VW] = {};
    if (t < total) {
      long i;
      int p;
      if (shift >= 0) {
        i = t >> shift;
        p = (int)(t & (ppr - 1));
      } else {
        i = t / ppr;
        p = (int)(t - i * ppr);
      }
      const long r = __ldg(idx + i);
      const V x = __ldcs(reinterpret_cast<const V*>(gout) + t);
#pragma unroll
      for (int c = 0; c < VW; ++c) v[c] = reinterpret_cast<const float*>(&x)[c];
      if (r >= 0 && r < rows) dst = r * ppr + p;
    }
    if (warp_sum) {
      // a lane with nothing to add is a group of its own
      const unsigned long long key =
          dst >= 0 ? (unsigned long long)dst : ~0ull - (unsigned)lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      float s[VW] = {};
      for (unsigned m = peers; m; m &= m - 1) {  // in lane order
        const int src = __ffs(m) - 1;
#pragma unroll
        for (int c = 0; c < VW; ++c) s[c] += __shfl_sync(peers, v[c], src);
      }
      if (dst >= 0 && lane == __ffs(peers) - 1)
        add_piece<VW>(grad + dst * VW, s);
    } else if (dst >= 0) {
      add_piece<VW>(grad + dst * VW, v);
    }
  }
}

template <int VW>
int launch_scatter_add(float* grad, long rows, int cols, const int32_t* idx,
                       long m, const float* gout, cudaStream_t stream) {
  const int ppr = cols / VW;
  int shift = -1;
  if ((ppr & (ppr - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < ppr) ++shift;
  }
  const long total = m * ppr;
  long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  scatter_add_kernel<VW><<<(unsigned)blocks, THREADS, 0, stream>>>(
      grad, rows, ppr, shift, idx, total, gout, m >= kWarpSumRatio * rows);
  return (int)cudaGetLastError();
}

}  // namespace

// grad: rows x cols float32, contiguous, added into; idx: m int32; gout:
// m x cols float32, contiguous. Returns the CUDA error code of the launch.
extern "C" int gather_rows_backward_launch(float* grad, long rows, int cols,
                                           const int32_t* idx, long m,
                                           const float* gout,
                                           cudaStream_t stream) {
  if (m <= 0) return 0;
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)grad | (uintptr_t)gout;
  if (cols % 4 == 0 && addr % 16 == 0)
    return launch_scatter_add<4>(grad, rows, cols, idx, m, gout, stream);
  if (cols % 2 == 0 && addr % 8 == 0)
    return launch_scatter_add<2>(grad, rows, cols, idx, m, gout, stream);
  return launch_scatter_add<1>(grad, rows, cols, idx, m, gout, stream);
}

// table: rows x row_bytes bytes, contiguous; idx: m int32; out: m x
// row_bytes bytes. Returns the CUDA error code of the launch (0 = none).
extern "C" int gather_rows_launch(const void* table, long rows, int row_bytes,
                                  const int32_t* idx, long m, void* out,
                                  cudaStream_t stream) {
  if (m <= 0) return 0;
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ta = (uintptr_t)table, ia = (uintptr_t)idx,
                  oa = (uintptr_t)out;
  // the narrow kernel: rows of one vector, the unit's index vector and
  // 16 B output stores aligned
  const bool narrow = row_bytes == 2 || row_bytes == 4 || row_bytes == 8 ||
                      row_bytes == 16;
  const int ib = narrow && row_bytes >= 4 ? 64 / row_bytes : 16;  // U int32
  if (narrow && oa % 16 == 0 && ta % row_bytes == 0 && ia % ib == 0) {
    switch (row_bytes) {
      case 2: return launch_narrow<2>(table, rows, idx, m, out, stream);
      case 4: return launch_narrow<4>(table, rows, idx, m, out, stream);
      case 8: return launch_narrow<8>(table, rows, idx, m, out, stream);
      case 16: return launch_narrow<16>(table, rows, idx, m, out, stream);
      default: break;
    }
  }
  const uintptr_t addr = ta | oa;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch_generic<uint4>(table, rows, row_bytes, idx, m, out, stream);
  if (row_bytes % 8 == 0 && addr % 8 == 0)
    return launch_generic<uint2>(table, rows, row_bytes, idx, m, out, stream);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch_generic<unsigned int>(table, rows, row_bytes, idx, m, out,
                                        stream);
  if (row_bytes % 2 == 0 && addr % 2 == 0)
    return launch_generic<unsigned short>(table, rows, row_bytes, idx, m,
                                          out, stream);
  return launch_generic<unsigned char>(table, rows, row_bytes, idx, m, out,
                                       stream);
}
