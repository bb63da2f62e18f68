// A stand-in for the CUDA runtime header that lets g++ build a kernel
// source of sanerf_tpu_torch/csrc for the CPU (tests/test_torch_hash_forward
// .py): device qualifiers dropped, the read-only loads and streaming stores
// plain ones, the rounding intrinsics IEEE float32 operations, and a launch
// (`emu_launch`, put in place of `<<<...>>>` by the test) running the blocks
// one after another, each as one std::thread a thread, __syncthreads a
// barrier among them. Warp shuffles and atomics are not modelled: only
// kernels without them run.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

using std::max;
using std::min;

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorMisalignedAddress = 716,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

struct dim3v { unsigned x, y, z; };
inline thread_local dim3v threadIdx;
inline dim3v blockIdx, gridDim, blockDim;

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

template <class T> T __ldg(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
// not modelled: a kernel that reaches one of these stops the process
template <class T> T __shfl_up_sync(unsigned, T, int) { std::abort(); }
inline unsigned __ballot_sync(unsigned, int) { std::abort(); }
template <class T> T atomicAdd(T*, T) { std::abort(); }

inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 4;
  return 0;
}
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
  *n = 2;
  return 0;
}
inline int cudaGetLastError() { return 0; }

template <class K, class... A>
void emu_launch(K kernel, unsigned blocks, int threads, int, cudaStream_t,
                A... a) {
  std::barrier<> bar(threads);
  emu_barrier = &bar;
  gridDim = {blocks, 1, 1};
  blockDim = {(unsigned)threads, 1, 1};
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx = {b, 0, 0};
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        kernel(a...);
      });
    for (auto& th : ts) th.join();
  }
}
