// Row gather out[i] = table[idx[i]] for Hopper (sm_90a): the per-point
// table lookup of the instant-ngp hash encoder.
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
// Design: a copy of bytes, the same for float32 and bf16. The row is cut
// into pieces of the widest vector (16, 8, 4, 2 or 1 B) that divides the
// row and both base addresses. Thread t copies piece t % ppr of output row
// t / ppr, so neighbouring threads write neighbouring addresses and every
// store coalesces; the index is read with __ldg (threads of one row share
// it through L1) and the piece with __ldg. An index outside [0, rows)
// writes zeros (jnp.take's mode="fill", fill_value=0). Offsets are 64-bit;
// a grid-stride loop covers any number of pieces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long MAX_BLOCKS = 132L * 32;

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const V* __restrict__ table, long rows, int ppr, int shift,
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
int launch(const void* table, long rows, int row_bytes, const int32_t* idx,
           long m, void* out, cudaStream_t stream) {
  const int ppr = row_bytes / (int)sizeof(V);
  int shift = -1;
  if ((ppr & (ppr - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < ppr) ++shift;
  }
  const long total = m * ppr;
  long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(table), rows, ppr, shift, idx, total,
      static_cast<V*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// table: rows x row_bytes bytes, contiguous; idx: m int32; out: m x
// row_bytes bytes. Returns the CUDA error code of the launch (0 = none).
extern "C" int gather_rows_launch(const void* table, long rows, int row_bytes,
                                  const int32_t* idx, long m, void* out,
                                  cudaStream_t stream) {
  if (m <= 0) return 0;
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)table | (uintptr_t)out;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch<uint4>(table, rows, row_bytes, idx, m, out, stream);
  if (row_bytes % 8 == 0 && addr % 8 == 0)
    return launch<uint2>(table, rows, row_bytes, idx, m, out, stream);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch<unsigned int>(table, rows, row_bytes, idx, m, out, stream);
  if (row_bytes % 2 == 0 && addr % 2 == 0)
    return launch<unsigned short>(table, rows, row_bytes, idx, m, out,
                                  stream);
  return launch<unsigned char>(table, rows, row_bytes, idx, m, out, stream);
}
