// The rate at which an H100's SMs add into a float32 table with vector
// atomics whose result is unused (red.global.add), as csrc/hashgrid.cu's
// and csrc/gather.cu's scatter-adds do: each thread adds `iters` pieces of
// 1, 2 or 4 floats (float, float2, float4 atomicAdd) at pseudo-random rows
// of a table of 2^rows_log2 rows of 16 bytes. A small table makes many
// adds land on one row, as at the hash grid's coarse levels. Built and
// timed by port_tools/hash_backward_variants.py (red_probe), with a plain C
// interface as the port's kernels have.
#include <cstdint>
#include <cuda_runtime.h>

template <int W>
__global__ void __launch_bounds__(256)
    red_kernel(float* __restrict__ table, uint32_t mask, int iters) {
  uint32_t h = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 12345u;
  for (int i = 0; i < iters; ++i) {
    h = h * 1664525u + 1013904223u;
    float* row = table + (size_t)((h >> 8) & mask) * 4;
    if constexpr (W == 4)
      atomicAdd(reinterpret_cast<float4*>(row),
                make_float4(1.f, 1.f, 1.f, 1.f));
    else if constexpr (W == 2)
      atomicAdd(reinterpret_cast<float2*>(row), make_float2(1.f, 1.f));
    else
      atomicAdd(row, 1.f);
  }
}

// table: 2^rows_log2 rows of 16 bytes (float32, 16 B-aligned); width 1, 2
// or 4 floats an add; iters adds a thread. -> a CUDA error code (0:
// launched)
extern "C" int red_probe(void* table, unsigned rows_log2, int iters,
                         int width, int blocks, int threads, void* stream) {
  if (rows_log2 > 26 || threads > 256) return -1;
  const uint32_t mask = (1u << rows_log2) - 1u;
  float* t = static_cast<float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4)
    red_kernel<4><<<blocks, threads, 0, s>>>(t, mask, iters);
  else if (width == 2)
    red_kernel<2><<<blocks, threads, 0, s>>>(t, mask, iters);
  else if (width == 1)
    red_kernel<1><<<blocks, threads, 0, s>>>(t, mask, iters);
  else
    return -1;
  return (int)cudaGetLastError();
}
