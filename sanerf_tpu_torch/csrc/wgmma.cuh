// Hopper warpgroup MMA (wgmma, sm_90a) with A from registers, for the
// fused field kernels (csrc/fused_mlp_t.cu), and the mbarriers and bulk
// copies of their weight ring.
//
// Layouts, per warp w of the warpgroup (rows 16w .. 16w + 15), lane = 4g + t:
//   A in registers, the fragment of one k16 step (as mma.sync m16n8k16):
//   a[0] = row g, cols 2t, 2t+1; a[1] = row g+8, same cols; a[2], a[3] =
//   the same rows, cols 8 + 2t, 8 + 2t + 1; two bf16 in each register, the
//   lower column low.
//   Accumulator: d[4j + 0, 1] = row g, cols 8j + 2t + {0, 1}; d[4j + 2, 3] =
//   row g + 8, same cols. Two adjacent n8 tiles (j = 2s, 2s + 1) are thus
//   exactly the A fragment of k step s of the next layer.
//   A or B in shared memory, K-major without swizzle: 8 x 8 core matrices
//   of 128 B (8 rows of M or N, each 8 consecutive K elements), the core
//   matrix of rows 8n.. and columns 8k.. at base + k * LBO + n * SBO.
#pragma once

#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (the weight ring of csrc/fused_mlp_t.cu):
// barriers are addressed by their shared-memory address (smem())
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the inits visible to the other threads' barrier operations and to the
// async proxy (the copies' complete_tx)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the arrival of the threads where `pred` holds, as one predicated
// instruction (no branch the compiler must treat as divergent)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}
// this thread's arrival, and `bytes` more for the phase to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity. A wait
// longer than 2^32 clocks (over 2 s; a ring whose producer and consumers
// disagree on the units) traps: the launch fails with an error instead of
// holding the card. The loop is inside the asm: no branch of the caller's
// that the compiler would treat as divergent (which serializes the
// consumers' wgmma pipeline).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// A monotonic count in shared memory (the V_GRID encoding slots' releases):
// `pred` threads add 1 with release semantics, as one predicated
// instruction; a waiter loads it with acquire semantics until it reaches
// `target` (a count has no phase that a waiter two uses behind could
// mistake for its own, as an mbarrier's parity does), trapping after 2^32
// clocks as mbar_wait does, the loop inside the asm.
__device__ __forceinline__ void count_add_if(uint32_t addr, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p red.release.cta.shared::cta.add.u32 [%0], 1;\n}\n" ::"r"(addr),
      "r"((uint32_t)pred)
      : "memory");
}
__device__ __forceinline__ void count_wait(uint32_t addr, uint32_t target) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 v;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAITC:\n"
      "ld.acquire.cta.shared::cta.u32 v, [%0];\n"
      "setp.ge.u32 p, v, %1;\n"
      "@p bra DONEC;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAITC;\n"
      "DONEC:\n}\n" ::"r"(addr),
      "r"(target)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing as transactions on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The registers a wgmma reads or writes asynchronously are only tied to
// the asm statement that issues it: `keep` after wait_all() keeps the
// compiler from reusing A registers, or reading accumulators, before the
// products are done (and before issue, from sinking their writes past it).
template <int NA>
__device__ __forceinline__ void keep(float (&r)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int NK>
__device__ __forceinline__ void keep(uint32_t (&r)[NK][4]) {
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 128] += A[64 x 16] (registers) * B[128 x 16]^T (shared memory,
// K-major, no swizzle); d holds this thread's accumulators from O on.
template <int O, int NA>
__device__ __forceinline__ void wgmma_n128(float (&d)[NA],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D[64 x 16] += A[64 x 16] (registers) * B[16 x 16]^T (shared memory,
// K-major, no swizzle); d holds this thread's accumulators from O on.
template <int O, int NA>
__device__ __forceinline__ void wgmma_n16(float (&d)[NA],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[128 x 16]^T, both in shared memory (K-major,
// no swizzle).
template <int O, int NA>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[NA], uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16]^T, both in shared memory (K-major,
// no swizzle).
template <int O, int NA>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[NA], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[64 x 16]^T, both in shared memory (K-major,
// no swizzle); d holds this thread's accumulators from O on.
template <int O, int NA>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NA], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// tf32 (the float32 V_WIDE32 chain, 3xTF32): D[64 x N] (+)= A[64 x 8]
// (registers) * B[N x 8]^T (shared memory, K-major, no swizzle: core
// matrices of 8 rows x 4 floats, 128 B). tf32 takes no transpose. A's
// fragment per warp (rows 16w ..), lane = 4g + t, as mma.sync m16n8k8's:
// a[0] = row g, k slot t; a[1] = row g + 8, slot t; a[2], a[3] = the same
// rows, slot t + 4; the tensor core reads each as tf32 (its low 13 bits
// dropped). SCALE_D 0: D = A B (the accumulators' old values ignored).
template <int SCALE_D, int NA>
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[NA],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  static_assert(NA >= 64, "n128 keeps 64 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(SCALE_D));
}

template <int SCALE_D, int NA>
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[NA],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  static_assert(NA >= 32, "n64 keeps 32 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(SCALE_D));
}

template <int SCALE_D, int NA>
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[NA],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  static_assert(NA >= 8, "n16 keeps 8 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(SCALE_D));
}

}  // namespace wg
