// The rate at which an H100's SMs read small tables through L2 (and L1),
// as the grid field kernels' encoders read their CP and VM rows: each
// thread reads 16-byte vectors, four consecutive ones (a 64-byte row) at a
// pseudo-random row of the table, two rows (8 loads) in flight at a time,
// and xors them into one word it writes (so no load is dropped). Built and
// timed by port_tools/grid_variants.py (l2_probe), with a plain C
// interface as the port's kernels have.
#include <cstdint>
#include <cuda_runtime.h>

template <bool L1>
__global__ void __launch_bounds__(256)
    probe_kernel(const uint4* __restrict__ table, uint32_t mask, int iters,
                 uint32_t* __restrict__ out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t h = t * 2654435761u + 12345u;
  uint32_t acc = 0u;
  for (int i = 0; i < iters; i += 8) {
    uint4 v[8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      h = h * 1664525u + 1013904223u;
      const uint4* row = table + (size_t)((h >> 8) & mask) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // .ca: through L1 and L2; .cg: L2 only
        if constexpr (L1)
          v[4 * r + j] = __ldca(row + j);
        else
          v[4 * r + j] = __ldcg(row + j);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
  }
  out[t] = acc;
}

// table: 2^rows_log2 rows of 64 bytes; iters (a multiple of 8) loads a
// thread; out: blocks * threads words. -> a CUDA error code (0: launched)
extern "C" int l2_probe(const void* table, unsigned rows_log2, int iters,
                        int l1, unsigned* out, int blocks, int threads,
                        void* stream) {
  if (rows_log2 > 24 || iters % 8 || threads > 256) return -1;
  const uint32_t mask = (1u << rows_log2) - 1u;
  const uint4* tb = static_cast<const uint4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1)
    probe_kernel<true><<<blocks, threads, 0, s>>>(tb, mask, iters, out);
  else
    probe_kernel<false><<<blocks, threads, 0, s>>>(tb, mask, iters, out);
  return (int)cudaGetLastError();
}
