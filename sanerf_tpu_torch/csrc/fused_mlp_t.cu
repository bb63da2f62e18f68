// Fused encode + MLP chain of the MLP-family NeRF field, Hopper (sm_90a).
//
// Replaces the TPU kernels sanerf_tpu/ops/fused_mlp_t.py:1077 _run_tmlp
// (reached by run_tmlp :481; body _encode_and_chain :549, _ad_encode :108,
// _grid_blocks :323 with _cp_level :235 per CP level and _vm_block :263 per
// VM level and for the sigma-VM table) and :885 _run_tmlp_composite (reached
// by run_tmlp_composite :978; kernel _tmlp_composite_kernel :707, view
// epilogue :835-874, packed epilogue pack_q > 1 :757-796). Plain PyTorch
// versions of the same functions:
// sanerf_tpu_torch/ops/fused_mlp_t.py (forward_plain, *_plain).
//
// Bound on an H100: the field chain of the serving asset is 50,944 MAC per
// point (127->128, 255->128, 128->16); a 512^2 frame at the (32, 16)
// hierarchy has 4.19 M final points, 0.43 TFLOP, ~0.43 ms on the bf16
// tensor cores at 989 TFLOP/s. The proposal chain (33->32->1) is ~1.1 k
// MAC per point and bound by its 12 B in + 4 B out per point. In float32
// (the trainer's evaluation) the default field is 116,480 MAC a sample:
// 131,072 samples of a 64^2 frame take 0.185 ms as 3xTF32 at 495 TFLOP/s.
//
// Design (bound by the tensor cores for the field, by bytes for the
// proposal nets; what holds each back is in PERF.md):
//   - a warpgroup (4 warps) owns tiles of 64 points, the M of one wgmma;
//     blocks of up to 4 warpgroups (as many as the shared-memory plan
//     admits) are persistent and walk the tiles, each thread loading its
//     point of the next tile while it works on this one;
//   - encode, one point per thread pair (each thread half of the point's
//     features), taps computed once per point and level: the angle-doubling
//     Fourier features (one sinf pair per coordinate, then s' = 2sc,
//     c' = c^2 - s^2, the JAX recurrence), then the factorized-grid
//     features, every table read in 16-byte vectors through L1/L2 (the
//     TPU's one-hot MXU contractions become direct reads): each level of a
//     CP ladder as 2-tap linear interpolation of its [3, R, K] table (the
//     pair splits its K columns in halves); each level of a VM ladder, per
//     mode m, as the bilinear read of the 4 corner rows of plane m
//     [R, R, K] times the 2-tap read of line m [Rl, K] (ops/vmgrid.py),
//     the level's 3K columns in units of a vector that alternate between
//     the pair (halves of K would leave one thread idle at K = 8 in bf16);
//     the sigma-CP and sigma-VM sums are sequential sums per thread plus
//     one shuffle. The
//     encoding goes to shared memory, since the skip layer reads it a
//     second time: for bf16 as the core matrices wgmma reads A from;
//   - the chain, bf16: each layer is a row of wgmma.m64nNk16 (csrc/
//     wgmma.cuh) with B, the layer's W^T packed on the host as 8x8 core
//     matrices (K-major, no swizzle), in shared memory, where each block
//     copies all weights once (or, when they do not fit, one layer at a
//     time per tile). Layer 0 and the skip layer's encoding part read A
//     from shared memory; the accumulators of layer l, after the activation
//     and the rounding to bf16 (fused_mlp_t.py:616), are the register A
//     fragments of layer l+1, so hidden activations never leave registers;
//   - the chain, float32 weights: 3xTF32 on the tensor cores, each
//     product a b as a_lo b_hi + a_hi b_lo + a_hi b_hi (hi the tf32
//     rounding of a value, lo the rest as the tensor core reads it; the
//     products see each operand to 2^-21 and drop the lo lo term), three
//     mma.sync.m16n8k8 tf32 per warp and 16-row slice, the small terms
//     first, into a zeroed fragment that a float32 add puts into the
//     accumulator (the tensor core truncates the sum it writes: summed
//     into the accumulator itself, that error grows with the accumulator,
//     1.6-1.9x cuBLAS float32's own against float64 on the asset's trained
//     weights; with the fresh fragment 0.93-1.05x, PERF.md; 6-16 % more
//     time). The bound of the work is the
//     tensor cores' tf32 rate (3 x 2 x MAC at 495 TFLOP/s, 2.5x below the
//     CUDA cores' 67 TFLOP/s for 2 x MAC); what binds is mma.sync's own
//     rate (wgmma's half; a third product costs ~8 cycles of an SM
//     quarter, PERF.md), then the instructions that feed it: a load, two
//     roundings (two integer instructions each, not cvt's four) and two
//     subtractions for every three products, four adds, no branch
//     between the n-tiles (a layer_f32 of constant n-tile count for the
//     configurations' widths). Each k step of 8 pairs the
//     columns: a lane's A fragment (rows g, g + 8; k slots t, t + 4) holds
//     columns 2t and 2t + 1, which are its accumulators' columns, so the
//     hidden activations stay in registers from layer to layer; A is read
//     as float2 from the row-major encoding (stride 8 mod 16 floats,
//     conflict-free) and B as float2 from W^T's core matrices (32 lanes
//     on 256 contiguous bytes). The weights sit in shared memory when they
//     fit, else stream one layer at a time (cp.async), else (wide
//     encodings beside the buffers) are read through L1/L2. The products
//     are tensor-core instructions and the adds plain adds, which
//     -fmad=false does not touch;
//   - nets wider than 128 (up to MAX_WIDTH = 512; the V_WIDE variant of
//     tmlp_kernel and the composites) keep the hidden activations of a
//     tile in shared memory, since a 64 x 256 accumulator and the next
//     layer's A fragments would not fit in a thread's registers: each
//     layer runs as chunks of at most 128 outputs (one 64-register
//     accumulator), chunk 0 held in registers, activated, the chunks
//     between the first and the last parked in device memory (a slot per
//     warpgroup of the persistent grid, each thread its own words,
//     coalesced), until the last chunk has read the previous activations,
//     then all written back. bf16: A comes from shared memory for every
//     layer (wgmma_ss), B from the weights in shared memory, all of them
//     where they fit, else streamed one chunk (128 rows of W^T) at a time
//     (80 KB for a 256-wide skip layer), else in units of one chunk's rows
//     over 64 columns (16 KB: a 512-wide layer's chunk is 128 KB);
//     float32: the A fragments read from the row-major activations as from
//     the encoding, the weights in shared memory where they fit, else
//     streamed in units of one chunk's rows over 64 columns (32 KB; a 256
//     x 320 float32 skip layer is 320 KB), else read through L2;
//   - optional biases (float32, as the JAX package packs them) are added
//     to the layer's float32 sum before the activation; the dense-sin
//     encode (angle_double = 0) takes one sinf pair per coordinate and
//     frequency at z 2^f instead of the doubling recurrence;
//   - the last layer (plus the sigma-CP sum on column 0) goes to a small
//     per-warpgroup buffer. run_tmlp writes it out as [kout, P] rows, each
//     warp its 16 points; the composite kernel gathers whole rays (a step
//     of lcm(64, T) points where that is at most 448, else of the R rays
//     that leave the fewest padded points in its last tile, the padded
//     points encoded from x = 0 and never read; the JAX kernel pads its
//     block with rays of dl = 0 the same way) and runs the epilogue per
//     ray in one warp:
//     softplus density, alpha with the optional opaque last sample, a warp
//     scan for the exclusive transmittance sum of the finite optical
//     depths, NaN weights -> 0, per-ray sums in index order, then the SH
//     (degree <= 4) + view MLP head on one lane per output and the sigmoid;
//   - the general composite (composite_kernel<..., GEN = true>, chosen by
//     the plan) takes what that epilogue does not: rays longer
//     than a step holds (past 128 samples) run one ray a step in segments
//     of up to 256 points, warp 0 carrying the transmittance and the
//     partial sums from one segment to the next (every sum in index order,
//     as in one pass); up to MAX_GSUM outputs (a lane a column of each
//     16-column group); view heads up to MAX_VIEW wide (a lane its units
//     lane + 32 q); and the parked chunks of the widest nets;
//   - the proposal nets (bf16, two layers no wider than 32, no CP tables,
//     no bias, angle doubling) take small_kernel instead: a warp per
//     16-point tile, mma.sync with the weights held in registers as B
//     fragments.
// The host plans every launch (ops/fused_mlp_t.py:kernel_plan, which the
// CPU tests read): the variant, the warpgroups and the shared-memory carve,
// where the weights and the view head live, the composite's steps; the
// kernels trust the plan's buffers, and the launch functions check it.
// A ladder's first INLINE_LEVELS levels sit in the grid descriptor's slots
// (kernel parameters); levels past them (V_BRANCHES and V_WIDE only) are
// read from an array in device memory. Grid tables of any size are read
// through L2 from device memory.
// With pack_q > 1 the composite reads dl and ts through the packed layout
// of the ray kernels, [N/q, q*T, 1] with ray n in slot n % q of row n / q
// (the TPU fills 128-lane rows with q rays; the per-ray warp epilogue here
// has no lanes to fill, so the option computes the same function from the
// packed operands at the same cost).
// Built with -fmad=false (ops/_build.py) so the encode and the epilogue
// round like the PyTorch versions (contracting them was measured no
// faster); neither chain has a float32 a * b + c for it to keep apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int TILE = 64;  // points per warpgroup tile (the M of wgmma)
// accumulators a thread: a 64 x 128 tile over the warpgroup's 128 threads
constexpr int NA = 64;
// The most warpgroups in one block (one block an SM): bf16 runs 3 (<= 168
// registers a thread), 4 in the composite (<= 128; measured faster there
// despite a few spilled registers, slower in run_tmlp). The float32 chain
// keeps two layers' accumulators in registers: 3 in run_tmlp (168, some
// spilled), 2 in the composite (no spill; faster there, slower in
// run_tmlp; a narrow run_tmlp kernel for nets no wider than 64, half the
// accumulators and 3-5 warpgroups, measured no faster). plan_for takes
// fewer where the buffers of that many do not fit (long rays in the
// composite).
constexpr int F32_WGS = 3, F32_COMPOSITE_WGS = 2;
template <typename T>
constexpr int wgs_of(bool composite) {
  return sizeof(T) == 2 ? (composite ? 4 : 3)
                        : (composite ? F32_COMPOSITE_WGS : F32_WGS);
}
// Each kernel comes in three variants, picked per net by the host's plan
// (ops/fused_mlp_t.py:kernel_plan): V_SERVED, the nets every served
// configuration has (no bias, angle doubling, no layer over 128, ladders
// of at most INLINE_LEVELS levels), whose code holds no test for the
// branches below (a run-time test of either cost the asset's float32
// launches 3-7 %, PERF.md); V_BRANCHES, such nets with biases, the
// dense-sin encode or longer ladders; V_WIDE, nets with a layer over 128
// (each branch at run time).
enum Variant { V_SERVED = 0, V_BRANCHES = 1, V_WIDE = 2 };
// V_WIDE kernels: 2 warpgroups (plan_for takes fewer where the buffers do
// not fit)
constexpr int WIDE_WGS = 2;
template <typename T>
constexpr int wgs_of(bool composite, int v) {
  return v == V_WIDE ? WIDE_WGS : wgs_of<T>(composite);
}
// Layers of a net: the layer table is a kernel parameter (the parameter
// space's budget sets this; ops/fused_mlp_t.py:MAX_LAYERS)
constexpr int MAX_LAYERS = 32;
constexpr int MAX_NT = 16;  // n-tiles of 8 outputs in one accumulator
// the widest layer: four accumulator chunks (ops/fused_mlp_t.py:MAX_WIDTH)
constexpr int MAX_WIDTH = 512;
constexpr int CHUNK = 8 * MAX_NT;  // outputs of one chunk of a wide layer
// bias rows: [n_layers][BIAS_LD] float32 (ops/fused_mlp_t.py:BIAS_LD)
constexpr int BIAS_LD = MAX_WIDTH;
// the general composite (composite_kernel, GEN): per-ray sums of up to
// MAX_GSUM outputs, 16 lanes of a warp each holding a column of every
// 16-column group; a view head of up to MAX_VIEW hidden units, 32 a lane
// group
constexpr int MAX_GSUM = 64;
constexpr int MAX_VIEW = 128;
constexpr int PAD = 8;  // row padding of the float32 encoding: stride 8 mod 16
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr float HALF_PI = 1.57079632679489661923f;

typedef __nv_bfloat16 bf16;

struct Layer {
  int kin_h, kin_e, kout, kout_real, w_off, w_ld;
};

// a CP level: lines [3, R, K] in the weight type, u = x * s + o
struct Grid {
  const void* table;
  int R, K;
  float s, o;
};

// a VM level: planes [3, R, R, K] (plane m: rows along axis (m + 1) % 3,
// columns along (m + 2) % 3) and lines [3, Rl, K] (line m along axis m),
// u = x * s + o on the planes, x * sl + ol on the lines
struct VMGrid {
  const void* planes;
  const void* lines;
  int R, Rl, K;
  float s, o, sl, ol;
};

// The factorized grids of a net, as the host passes them (mirrored by the
// ctypes.Structure ops/fused_mlp_t.py:Grids): the first n_cp CP levels and
// n_vm VM levels of a ladder in fixed slots of the kernel parameters (at
// most INLINE_LEVELS each), the n_cp_more / n_vm_more levels past them as
// arrays in device memory (so a ladder may have any number of levels);
// scp.table / svm.planes null when there is no sigma-CP / sigma-VM table.
constexpr int INLINE_LEVELS = 8;  // ops/fused_mlp_t.py:INLINE_LEVELS
struct Grids {
  int n_cp, n_vm;
  Grid cp[INLINE_LEVELS];
  VMGrid vm[INLINE_LEVELS];
  Grid scp;
  VMGrid svm;
  int n_cp_more, n_vm_more;
  const Grid* cp_more;
  const VMGrid* vm_more;
};

struct Net {
  int n_layers, leaky, enc_freqs, F, ke, hmax, angle_double;
  Layer layer[MAX_LAYERS];
  float enc_scale;
  const void* w;
  int w_elems;
  const float* bias;  // [n_layers][BIAS_LD], or null: no bias
  Grids g;
};

__host__ __device__ inline bool has_sigma(const Net& net) {
  return net.g.scp.table != nullptr || net.g.svm.planes != nullptr;
}

struct View {
  const void* w;
  int elems, H, n_rest, sh_dim, degree;
};

template <typename T>
__device__ __forceinline__ float tof(T v);
template <>
__device__ __forceinline__ float tof<float>(float v) { return v; }
template <>
__device__ __forceinline__ float tof<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 fromf<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float v) { return tof<T>(fromf<T>(v)); }

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ float act(float v, int leaky) {
  return leaky ? (v >= 0.0f ? v : 0.01f * v) : fmaxf(v, 0.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the warpgroup's own barrier (ids 1..4; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ---------------------------------------------------------------------------
// encode: one point per thread pair
// ---------------------------------------------------------------------------

struct Taps {
  int i0[3], i1[3];
  float f[3];
};

__device__ __forceinline__ Taps taps(int R, float s, float o,
                                     const float* x) {
  Taps tp;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(x[a] * s + o, 0.0f), (float)(R - 1));
    const float fl = floorf(u);
    tp.f[a] = u - fl;
    tp.i0[a] = (int)fl;
    tp.i1[a] = min(tp.i0[a] + 1, R - 1);
  }
  return tp;
}

// 16 bytes of a table row (shared or global memory) as floats
template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

// Column c of tile row p in the encoding buffer: row-major [64][lde] for
// float32; for bf16 the K-major core matrices that wgmma reads A from
// (8 x 8 blocks of 128 B, rows 8i.. and columns 8j.. at (8j + i) * 64).
template <typename T>
__device__ __forceinline__ int enc_index(int p, int c, int lde);
template <>
__device__ __forceinline__ int enc_index<float>(int p, int c, int lde) {
  return p * lde + c;
}
template <>
__device__ __forceinline__ int enc_index<bf16>(int p, int c, int) {
  return ((c >> 3) * (TILE / 8) + (p >> 3)) * 64 + (p & 7) * 8 + (c & 7);
}

// CP features k in [k0, k1) of one point from gr's table: each handed to
// put(c0 + k, value) when `write`; returns their sum in order of k.
template <typename T, typename Put>
__device__ float cp_range(const Grid& gr, const Taps& tp, int k0, int k1,
                          bool write, int c0, const Put& put) {
  const T* L = reinterpret_cast<const T*>(gr.table);
  const long plane = (long)gr.R * gr.K;
  constexpr int V = Vec<T>::N;
  float sum = 0.0f;
  const bool vec = gr.K % (2 * V) == 0 &&
                   (reinterpret_cast<uintptr_t>(L) & 15) == 0;
  if (vec) {
#pragma unroll 2
    for (int k = k0; k < k1; k += V) {
      float v[V];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float lo[V], hi[V];
        Vec<T>::load(L + a * plane + (long)tp.i0[a] * gr.K + k, lo);
        Vec<T>::load(L + a * plane + (long)tp.i1[a] * gr.K + k, hi);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float fa = lo[j] * (1.0f - tp.f[a]) + hi[j] * tp.f[a];
          v[j] = a == 0 ? fa : v[j] * fa;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (write) put(c0 + k + j, v[j]);
        sum += v[j];
      }
    }
  } else {
    for (int k = k0; k < k1; ++k) {
      float v = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T* la = L + a * plane;
        const float fa =
            tof<T>(la[(long)tp.i0[a] * gr.K + k]) * (1.0f - tp.f[a]) +
            tof<T>(la[(long)tp.i1[a] * gr.K + k]) * tp.f[a];
        v = a == 0 ? fa : v * fa;
      }
      if (write) put(c0 + k, v);
      sum += v;
    }
  }
  return sum;
}

// The VM features of one level at the point x: per mode m, plane m read
// bilinearly at (u_a, u_b), a = (m + 1) % 3, b = (m + 2) % 3, from its 4
// corner rows, times line m read at u_m from its 2 taps, in the order of
// operations of the plain version (ops/fused_mlp_t.py:_vm_plain). The
// level's 3K columns go in units of W (a 16-byte vector where K and the
// alignment allow, else 1); unit j of the level belongs to the thread of
// the pair with (unit + j) % 2 == half, `unit` counting on across levels.
// Each value goes to put(c0 + m K + k, value) when `write`; returns this
// thread's sum of its values, mode by mode, in order of k.
template <typename T, typename Put>
__device__ float vm_level(const VMGrid& g, const float (&x)[3], int half,
                          int& unit, bool write, int c0, const Put& put) {
  constexpr int V = Vec<T>::N;
  const T* Pl = reinterpret_cast<const T*>(g.planes);
  const T* Ln = reinterpret_cast<const T*>(g.lines);
  const bool vec = g.K % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(Pl) |
                     reinterpret_cast<uintptr_t>(Ln)) & 15) == 0;
  const int W = vec ? V : 1;
  const int per_mode = g.K / W;
  const Taps tp = taps(g.R, g.s, g.o, x);
  const Taps tl = taps(g.Rl, g.sl, g.ol, x);
  const long RK = (long)g.R * g.K;
  float sum = 0.0f;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int a = (m + 1) % 3, b = (m + 2) % 3;
    const T* P = Pl + m * g.R * RK;
    const T* r0 = P + tp.i0[a] * RK;
    const T* r1 = P + tp.i1[a] * RK;
    const T* Lm = Ln + (long)m * g.Rl * g.K;
    const long b0 = (long)tp.i0[b] * g.K, b1 = (long)tp.i1[b] * g.K;
    const long l0 = (long)tl.i0[m] * g.K, l1 = (long)tl.i1[m] * g.K;
    const float fa = tp.f[a], fb = tp.f[b], fl = tl.f[m];
    for (int j = (half + unit + m * per_mode) & 1; j < per_mode; j += 2) {
      const int k = j * W;
      if (vec) {
        float v00[V], v01[V], v10[V], v11[V], q0[V], q1[V];
        Vec<T>::load(r0 + b0 + k, v00);
        Vec<T>::load(r0 + b1 + k, v01);
        Vec<T>::load(r1 + b0 + k, v10);
        Vec<T>::load(r1 + b1 + k, v11);
        Vec<T>::load(Lm + l0 + k, q0);
        Vec<T>::load(Lm + l1 + k, q1);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float pf = (v00[i] * (1.0f - fb) + v01[i] * fb) * (1.0f - fa) +
                           (v10[i] * (1.0f - fb) + v11[i] * fb) * fa;
          const float v = pf * (q0[i] * (1.0f - fl) + q1[i] * fl);
          if (write) put(c0 + m * g.K + k + i, v);
          sum += v;
        }
      } else {
        const float pf =
            (tof<T>(r0[b0 + k]) * (1.0f - fb) + tof<T>(r0[b1 + k]) * fb) *
                (1.0f - fa) +
            (tof<T>(r1[b0 + k]) * (1.0f - fb) + tof<T>(r1[b1 + k]) * fb) * fa;
        const float v = pf * (tof<T>(Lm[l0 + k]) * (1.0f - fl) +
                              tof<T>(Lm[l1 + k]) * fl);
        if (write) put(c0 + m * g.K + k, v);
        sum += v;
      }
    }
  }
  unit += 3 * per_mode;
  return sum;
}

// point p of x3 [3, np] (zeros past np); the kernels load the next
// tile's point while they work on this one
__device__ __forceinline__ void load_point(const float* __restrict__ x3,
                                           long np, long p, float (&x)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = p < np ? x3[a * np + p] : 0.0f;
}

// Encodes the point x, each feature handed to put(column, value): Fourier
// features (the dense-sin encode only with EXTRA), CP levels, VM levels
// (fields.position_features' order; none without GRIDS, for nets that have
// no tables); the thread pair (half 0 / 1) splits the features. Returns the
// sum of the sigma tables' features (both threads of the pair).
template <typename T, bool EXTRA, bool GRIDS = true, typename Put>
__device__ float encode_point(const Net& net, const float (&x)[3], int half,
                              const Put& put) {
  for (int d = half; d < 3; d += 2) {
    const float z = x[d] * net.enc_scale;
    put(d, z);
    if (EXTRA && !net.angle_double) {
      // dense sin: z 2^f is exact, as the JAX kernel's projection by
      // 2^f pi / bound is
      for (int f = 0; f < net.enc_freqs; ++f) {
        const float zf = z * (float)(1 << f);
        put(3 + 6 * f + d, sinf(zf));
        put(6 + 6 * f + d, sinf(zf + HALF_PI));
      }
      continue;
    }
    float s = sinf(z), c = sinf(z + HALF_PI);
    for (int f = 0; f < net.enc_freqs; ++f) {
      if (f) {
        const float s2 = 2.0f * s * c;
        const float c2 = c * c - s * s;
        s = s2;
        c = c2;
      }
      put(3 + 6 * f + d, s);
      put(6 + 6 * f + d, c);
    }
  }
  if constexpr (!GRIDS) return 0.0f;
  // CP halves split at a multiple of the vector width
  constexpr int V = Vec<T>::N;
  const Grids& g = net.g;
  int col = net.F;
  for (int i = 0; i < g.n_cp; ++i) {
    const Grid& gr = g.cp[i];
    const int mid = (gr.K / (2 * V)) * V;
    const int k0 = half ? mid : 0, k1 = half ? gr.K : mid;
    cp_range<T>(gr, taps(gr.R, gr.s, gr.o, x), k0, k1, true, col, put);
    col += gr.K;
  }
  // a ladder's levels past the slots: only in the EXTRA variants (in the
  // served ones their loop would cost registers, and spills, PERF.md)
  if constexpr (EXTRA) {
    for (int i = 0; i < g.n_cp_more; ++i) {
      const Grid gr = g.cp_more[i];
      const int mid = (gr.K / (2 * V)) * V;
      const int k0 = half ? mid : 0, k1 = half ? gr.K : mid;
      cp_range<T>(gr, taps(gr.R, gr.s, gr.o, x), k0, k1, true, col, put);
      col += gr.K;
    }
  }
  int unit = 0;
  for (int i = 0; i < g.n_vm; ++i) {
    vm_level<T>(g.vm[i], x, half, unit, true, col, put);
    col += 3 * g.vm[i].K;
  }
  if constexpr (EXTRA) {
    for (int i = 0; i < g.n_vm_more; ++i) {
      const VMGrid gv = g.vm_more[i];
      vm_level<T>(gv, x, half, unit, true, col, put);
      col += 3 * gv.K;
    }
  }
  float part = 0.0f;
  if (g.scp.table) {
    const Grid& gr = g.scp;
    const int mid = (gr.K / (2 * V)) * V;
    const int k0 = half ? mid : 0, k1 = half ? gr.K : mid;
    part = cp_range<T>(gr, taps(gr.R, gr.s, gr.o, x), k0, k1, false, 0, put);
  }
  if (g.svm.planes) part += vm_level<T>(g.svm, x, half, unit, false, 0, put);
  return part + __shfl_xor_sync(FULL, part, 1);
}

// ---------------------------------------------------------------------------
// the chain of one 64-point tile -> the last layer in accumulators
//   acc[4j + 0, 1] = out[row g][col 8j + 2t + {0, 1}], acc[4j + 2, 3] = row
//   g + 8 (rows of this warp: 16 warp + g; g = lane / 4, t = lane % 4).
// ---------------------------------------------------------------------------

// n16 tiles I.. of one k step (kout not 128): B's rows 16I.. sit 2I core
// matrices (SBO = 128 B each) further on
template <int I>
__device__ __forceinline__ void n16_tiles(float (&acc)[NA],
                                          const uint32_t (&a)[4], uint64_t d,
                                          int n16) {
  if constexpr (8 * I < NA) {
    if (I < n16) {
      wg::wgmma_n16<8 * I>(acc, a, d + (uint64_t)(16 * I));
      n16_tiles<I + 1>(acc, a, d, n16);
    }
  }
}

// one k16 step of the layer: D[64 x kout] += A (registers) * B step
__device__ __forceinline__ void k_step(float (&acc)[NA], const uint32_t (&a)[4],
                                       uint64_t d, int kout) {
  if (kout == 128) {
    wg::wgmma_n128<0>(acc, a, d);
    return;
  }
  n16_tiles<0>(acc, a, d, kout / 16);
}

template <int I>
__device__ __forceinline__ void n16_tiles_ss(float (&acc)[NA], uint64_t da,
                                             uint64_t db, int n16) {
  if constexpr (8 * I < NA) {
    if (I < n16) {
      wg::wgmma_ss_n16<8 * I>(acc, da, db + (uint64_t)(16 * I));
      n16_tiles_ss<I + 1>(acc, da, db, n16);
    }
  }
}

// Issues the products over A (the tile's [64, kA] core matrices in shared
// memory: the encoding, or a wide net's hidden activations) columns [0, kA)
// against W^T columns [kcol0, kcol0 + kA) of nw outputs; Wl holds W^T rows
// as core matrices of a slab ldn rows wide (ldn / 8 core matrices of 128 B
// from one k column to the next).
__device__ __forceinline__ void ss_part(float (&acc)[NA], const bf16* Wl,
                                        int ldn, int nw, int kcol0,
                                        const bf16* A, int kA) {
  const uint32_t lbo = (uint32_t)ldn * 16;
  for (int s = 0; s < kA / 16; ++s) {
    const int kc = kcol0 + 16 * s;  // W^T column of this step
    const uint64_t da = wg::desc(A + s * 2 * TILE * 8, TILE * 16, 128);
    const uint64_t db = wg::desc(Wl + (kc / 8) * ldn * 8, lbo, 128);
    if (nw == 128) {
      wg::wgmma_ss_n128<0>(acc, da, db);
      continue;
    }
    n16_tiles_ss<0>(acc, da, db, nw / 16);
  }
}

// acc += the bias b at the columns of its ncols / 8 n-tiles (column 8 nt +
// 2t (+1) of rows g and g + 8)
__device__ __forceinline__ void add_bias(float (&acc)[NA], const float* b,
                                         int ncols, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NA / 4; ++nt) {
    if (nt < ncols / 8) {
      const float2 v = *reinterpret_cast<const float2*>(b + 8 * nt + 2 * t);
      acc[4 * nt] += v.x;
      acc[4 * nt + 1] += v.y;
      acc[4 * nt + 2] += v.x;
      acc[4 * nt + 3] += v.y;
    }
  }
}

// Copies `bytes` (a multiple of 16) from global to shared memory with the
// whole block and makes them visible to wgmma (the async proxy).
__device__ void block_copy(void* dst, const void* src, int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// bf16 chain. W: every layer's slab in shared memory, or with `stream` a
// one-layer buffer that the block refills per layer from net.w (so every
// warpgroup of the block calls this the same number of times). Biases only
// with EXTRA.
template <bool EXTRA>
__device__ void chain(const Net& net, const bf16* W, bool stream,
                      const bf16* enc, int /*lde*/, float (&acc)[NA],
                      int /*warp*/, int lane) {
  uint32_t hA[NA / 8][4];
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const bf16* Wl = W + L.w_off;
    if (stream) {
      __syncthreads();  // the previous layer's products are done
      block_copy((void*)W,
                 reinterpret_cast<const bf16*>(net.w) + L.w_off,
                 L.kout * L.w_ld * 2);
      Wl = W;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    wg::keep(hA);
    wg::keep(acc);
    wg::fence();
    if (l == 0) {
      ss_part(acc, Wl, L.kout, L.kout, 0, enc, L.kin_h);
    } else {
      const uint32_t lbo = (uint32_t)L.kout * 16;
#pragma unroll
      for (int s = 0; s < NA / 8; ++s)
        if (s < L.kin_h / 16)
          k_step(acc, hA[s], wg::desc(Wl + 2 * s * L.kout * 8, lbo, 128),
                 L.kout);
      if (L.kin_e) ss_part(acc, Wl, L.kout, L.kout, L.kin_h, enc, L.kin_e);
    }
    wg::commit();
    wg::wait_all();
    wg::keep(hA);
    wg::keep(acc);
    if (EXTRA && net.bias) add_bias(acc, net.bias + l * BIAS_LD, L.kout, lane);
    if (l < net.n_layers - 1) {
#pragma unroll
      for (int s = 0; s < NA / 8; ++s) {
        if (s < L.kout / 16) {
          const float* c = acc + 8 * s;
          hA[s][0] = pack_bf16(act(c[0], net.leaky), act(c[1], net.leaky));
          hA[s][1] = pack_bf16(act(c[2], net.leaky), act(c[3], net.leaky));
          hA[s][2] = pack_bf16(act(c[4], net.leaky), act(c[5], net.leaky));
          hA[s][3] = pack_bf16(act(c[6], net.leaky), act(c[7], net.leaky));
        }
      }
    }
  }
}

// float32 chain: 3xTF32 (see the note at the top). A k step of 8 takes the
// lane's A fragment as a[0..3] = (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8,
// 2t + 1) of the step's 8 columns, the k slots t and t + 4 of mma's A; B's
// slots t and t + 4 are then W^T columns 2t and 2t + 1 of the step, which
// the core-matrix layout of the slab (TransposedFieldMLP.packed) keeps
// side by side: block (s, nt) of 8 x 8 at (s * kout / 8 + nt) * 64, row g
// of it at 8 g, so lane 4 g + t reads its float2 at 2 lane of the block
// (32 lanes, 256 contiguous bytes: no bank conflict, no address math but
// the block's constant offset).

// the tf32 rounding of a finite v as cvt.rna.tf32.f32 gives it (to
// nearest, ties away from zero): two integer instructions, where the
// conversion takes four (a test for NaN and infinity, and a select)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo: hi the tf32 rounding of v, lo the rest (v - hi is exact),
// whose low 13 bits the tensor core drops, so that the products see v to
// within 2^-21 |v| (CUTLASS's fast 3xTF32 splits the same way; rounding lo
// too measured 7-9 % slower for no smaller error)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c[0 .. 3], one n-tile's C fragment, += A (16 x 8) * B (8 x 8) in tf32
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A times the k step's nt_n blocks of W^T from wb (one n-tile of 8
// outputs each). The three products of an n-tile go into a zeroed
// fragment, which is then added to acc in float32: the tensor core
// truncates the sum it writes, and summed into acc that truncation is of
// acc's size at every product, here of one k step's. With nt_n the constant
// NT no branch is left between the n-tiles, so that the scheduler
// interleaves their loads, splits and the three dependent products of each.
template <int NT>
__device__ __forceinline__ void k8_step(float (&acc)[NA], const float (&a)[4],
                                        const float* wb, int lane, int nt_n) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  const float* w = wb + 2 * lane;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_n) break;
    const float2 b = *reinterpret_cast<const float2*>(w + nt * 64);
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b.x, bh0, bl0);
    split_tf32(b.y, bh1, bl1);
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * nt + i] += c[i];
  }
}

// k steps over columns [0, kA) of the encoding (or of a wide net's hidden
// activations), e the lane's (row g, column 2t) of it, against the W^T
// blocks from wb on, kst floats from one k step's blocks to the next
template <int NT>
__device__ __forceinline__ void enc_steps(float (&acc)[NA], const float* e,
                                          int lde, const float* wb, int kA,
                                          int lane, int nt_n, int kst) {
  for (int k0 = 0; k0 < kA; k0 += 8, wb += kst) {
    const float2 r0 = *reinterpret_cast<const float2*>(e + k0);
    const float2 r1 = *reinterpret_cast<const float2*>(e + 8 * lde + k0);
    const float a[4] = {r0.x, r1.x, r0.y, r1.y};
    k8_step<NT>(acc, a, wb, lane, nt_n);
  }
}

// Layer l of nt_n = kout / 8 <= NT n-tiles into acc: A from the encoding
// (layer 0), else from hid, the previous layer's activations, then the
// skip layer's encoding part.
template <int NT>
__device__ __forceinline__ void layer_f32(float (&acc)[NA],
                                          const float (&hid)[NA],
                                          const float* e, int lde,
                                          const float* Wl, const Layer& L,
                                          int l, int lane, int nt_n) {
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  if (l == 0) {
    enc_steps<NT>(acc, e, lde, Wl, L.kin_h, lane, nt_n, nt_n * 64);
    return;
  }
#pragma unroll
  for (int s = 0; s < NA / 4; ++s) {
    if (s < L.kin_h / 8) {
      const float a[4] = {hid[4 * s], hid[4 * s + 2], hid[4 * s + 1],
                          hid[4 * s + 3]};
      k8_step<NT>(acc, a, Wl + s * nt_n * 64, lane, nt_n);
    }
  }
  if (L.kin_e)
    enc_steps<NT>(acc, e, lde, Wl + L.kin_h / 8 * nt_n * 64, L.kin_e, lane,
                  nt_n, nt_n * 64);
}

// Copies `bytes` (a multiple of 16) from global to shared memory with the
// whole block, every 16-byte piece in flight at once (cp.async).
__device__ void block_copy_async(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     d + 16 * i),
                 "l"(s + 16 * i)
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// float32 chain of the warp's 16 rows. W: every layer's W^T slab in shared
// or global memory, or with `stream` the block's one-layer buffer (as for
// bf16). Biases only with EXTRA.
template <bool EXTRA>
__device__ void chain(const Net& net, const float* W, bool stream,
                      const float* enc, int lde, float (&acc)[NA], int warp,
                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* e = enc + (16 * warp + g) * lde + 2 * t;
  float hid[NA];  // the previous layer's activations: its accumulators
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const float* Wl = W + L.w_off;
    if (stream) {
      __syncthreads();  // the previous layer's products are done
      block_copy_async((void*)W,
                       reinterpret_cast<const float*>(net.w) + L.w_off,
                       L.kout * L.w_ld * 4);
      Wl = W;
    }
    // kout: a multiple of 16 up to 128. The widths of the configurations
    // (128, 64, 32 and the last layers' 16) take a loop of constant length;
    // the others one loop that leaves the n-tiles past kout / 8.
    switch (L.kout) {
      case 16: layer_f32<2>(acc, hid, e, lde, Wl, L, l, lane, 2); break;
      case 32: layer_f32<4>(acc, hid, e, lde, Wl, L, l, lane, 4); break;
      case 64: layer_f32<8>(acc, hid, e, lde, Wl, L, l, lane, 8); break;
      case 128: layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, 16); break;
      default: layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, L.kout / 8);
    }
    if (EXTRA && net.bias) add_bias(acc, net.bias + l * BIAS_LD, L.kout, lane);
    if (l < net.n_layers - 1) {
#pragma unroll
      for (int i = 0; i < NA; ++i) hid[i] = act(acc[i], net.leaky);
    }
  }
}

// The last layer's accumulators (+ the sigma-CP sum on column 0) into
// outb rows [16 warp, 16 warp + 16) of [rows][ldo]; ncols = kout.
__device__ __forceinline__ void store_last(const float (&acc)[NA], int ncols,
                                           const float* sig, float* outb,
                                           int ldo, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* r0 = outb + (16 * warp + g) * ldo;
  float* r1 = r0 + 8 * ldo;
  const float s0 = (sig && t == 0) ? sig[16 * warp + g] : 0.0f;
  const float s1 = (sig && t == 0) ? sig[16 * warp + g + 8] : 0.0f;
#pragma unroll
  for (int nt = 0; nt < NA / 4; ++nt) {
    if (nt < ncols / 8) {
      const int col = nt * 8 + 2 * t;
      r0[col] = acc[4 * nt + 0] + (nt == 0 ? s0 : 0.0f);
      r0[col + 1] = acc[4 * nt + 1];
      r1[col] = acc[4 * nt + 2] + (nt == 0 ? s1 : 0.0f);
      r1[col + 1] = acc[4 * nt + 3];
    }
  }
}

// where a block's chains read the weights from: global memory (through
// L2; float32 only), all of them staged in shared memory, or one layer
// (one chunk of a V_WIDE layer, or one unit of a chunk) at a time
enum WeightMode { W_GLOBAL = 0, W_ALL = 1, W_STREAM = 2 };

// ---------------------------------------------------------------------------
// the launch plan: made on the host by ops/fused_mlp_t.py:kernel_plan (its
// ctypes mirror KernelPlan; plan_size() checks the two agree) and passed to
// the kernels as it is
// ---------------------------------------------------------------------------

struct Plan {
  int lde, ldo, M, R;  // M: points per warpgroup step, R of them rays'
  int ldh;             // hb row stride (V_WIDE)
  int wgs, w_mode, w_bytes, v_bytes;
  int enc_b, h_b, out_b, sig_b, wts_b, ts_b, vin_b;
  int per_wg, total;
  // segments of a composite step (a ray longer than a step runs as nseg
  // segments of M points, one ray a step; 1: whole rays), floats of a
  // warp's view-head scratch, columns of a streamed V_WIDE weight unit (0:
  // a whole chunk of rows), chunks of a V_WIDE layer parked in the park
  // buffer (all but the first and the last of the widest layer's)
  int nseg, vld, unit_k, park_chunks;
  // the kernel: its variant (Variant), the proposal nets' small_kernel
  // (run_tmlp), the general composite epilogue
  int variant, small, general;
};

// ---------------------------------------------------------------------------
// the chain of a net wider than 128 (V_WIDE kernels): the hidden activations
// of the tile in shared memory (hb), each layer in chunks of <= CHUNK
// outputs; the last layer's chunks go straight to outb. A layer of more
// than two chunks keeps its first chunk's activations in registers and
// parks the ones between in device memory (a slot per warpgroup of the
// grid, each thread its own words, coalesced) until every chunk has read
// the previous activations.
// ---------------------------------------------------------------------------

// Copies the core matrices of k blocks [kb0, kb1) and rows [n0, n0 + nw) of
// a W^T slab (kout rows, core matrices) to dst as a slab nw rows wide, with
// the whole block, visible to wgmma: for each k block, nw / 8 core
// matrices, contiguous in both.
__device__ void block_copy_chunk(bf16* dst, const bf16* slab, int kout,
                                 int kb0, int kb1, int n0, int nw) {
  const int per_k = nw;  // 16-byte pieces of one k column: nw rows of 16 B
  for (int i = threadIdx.x; i < (kb1 - kb0) * per_k; i += blockDim.x) {
    const int kb = i / per_k, j = i - kb * per_k;
    reinterpret_cast<uint4*>(dst + kb * nw * 8)[j] =
        reinterpret_cast<const uint4*>(
            slab + ((kb0 + kb) * kout / 8 + n0 / 8) * 64)[j];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// a chunk's accumulators, activated, as bf16 pairs: v[2 nt] = row g,
// v[2 nt + 1] = row g + 8, columns 8 nt + 2t, 8 nt + 2t + 1
__device__ __forceinline__ void pack_act(const float (&acc)[NA],
                                         uint32_t (&v)[NA / 2], int leaky) {
#pragma unroll
  for (int nt = 0; nt < NA / 4; ++nt) {
    v[2 * nt] = pack_bf16(act(acc[4 * nt], leaky), act(acc[4 * nt + 1], leaky));
    v[2 * nt + 1] =
        pack_bf16(act(acc[4 * nt + 2], leaky), act(acc[4 * nt + 3], leaky));
  }
}

// v (pack_act) into hb's columns [n0, n0 + nw) of this warp's rows, in the
// core-matrix layout of the encoding (enc_index)
__device__ __forceinline__ void put_hidden(bf16* hb,
                                           const uint32_t (&v)[NA / 2],
                                           int n0, int nw, int warp,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3, p = 16 * warp + g;
#pragma unroll
  for (int nt = 0; nt < NA / 4; ++nt) {
    if (nt < nw / 8) {
      const int c = n0 + 8 * nt + 2 * t;
      *reinterpret_cast<uint32_t*>(hb + enc_index<bf16>(p, c, 0)) = v[2 * nt];
      *reinterpret_cast<uint32_t*>(hb + enc_index<bf16>(p + 8, c, 0)) =
          v[2 * nt + 1];
    }
  }
}

// This thread's NW words of parked chunk j: word i at i * 128 of the slot
// (the warpgroup's 128 threads side by side)
template <int NW>
__device__ __forceinline__ uint32_t* park_slot(uint32_t* park, const Plan& pl,
                                               int j) {
  const long wg = (long)blockIdx.x * pl.wgs + (threadIdx.x >> 7);
  return park + ((wg * pl.park_chunks + j) * NW) * 128 + (threadIdx.x & 127);
}

template <int NW>
__device__ __forceinline__ void park_put(uint32_t* park, const Plan& pl, int j,
                                         const uint32_t (&v)[NW]) {
  uint32_t* p = park_slot<NW>(park, pl, j);
#pragma unroll
  for (int i = 0; i < NW; ++i) p[i * 128] = v[i];
}

template <int NW>
__device__ __forceinline__ void park_get(const uint32_t* park, const Plan& pl,
                                         int j, uint32_t (&v)[NW]) {
  const uint32_t* p = park_slot<NW>(const_cast<uint32_t*>(park), pl, j);
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = p[i * 128];
}

// bf16: A from shared memory for every layer (the encoding, then hb), B
// from W: every layer in shared memory, or (W_STREAM) the block's
// one-chunk buffer, refilled per chunk, or with pl.unit_k its one-unit
// buffer (a chunk's rows over unit_k columns), refilled per unit.
__device__ void chain_wide(const Net& net, const bf16* W, const Plan& pl,
                           const bf16* enc, bf16* hb, float (&acc)[NA],
                           const float* sig, float* outb, int ldo, int warp,
                           int lane, uint32_t* park) {
  uint32_t held[NA / 2];  // chunk 0 of a layer of two chunks or more
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const bool last = l == net.n_layers - 1;
    const int nch = (L.kout + CHUNK - 1) / CHUNK;
    const bf16* A = l == 0 ? enc : hb;
    for (int c = 0; c < nch; ++c) {
      const int n0 = CHUNK * c, nw = min(CHUNK, L.kout - n0);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
      if (pl.w_mode == W_STREAM && pl.unit_k) {
        const bf16* slab = reinterpret_cast<const bf16*>(net.w) + L.w_off;
        for (int k0 = 0; k0 < L.w_ld; k0 += pl.unit_k) {
          const int k1 = min(k0 + pl.unit_k, L.w_ld);
          const int h1 = min(k1, L.kin_h), e0 = max(k0, L.kin_h);
          __syncthreads();  // the previous unit's products are done
          block_copy_chunk(const_cast<bf16*>(W), slab, L.kout, k0 / 8,
                           k1 / 8, n0, nw);
          wg::keep(acc);
          wg::fence();
          if (k0 < h1) ss_part(acc, W, nw, nw, 0, A + k0 * TILE, h1 - k0);
          if (e0 < k1)
            ss_part(acc, W, nw, nw, e0 - k0, enc + (e0 - L.kin_h) * TILE,
                    k1 - e0);
          wg::commit();
          wg::wait_all();
          wg::keep(acc);
        }
      } else {
        const bf16* Wc = W + L.w_off + n0 * 8;
        int ldn = L.kout;
        if (pl.w_mode == W_STREAM) {
          __syncthreads();  // the previous chunk's products are done
          block_copy_chunk(const_cast<bf16*>(W),
                           reinterpret_cast<const bf16*>(net.w) + L.w_off,
                           L.kout, 0, L.w_ld / 8, n0, nw);
          Wc = W;
          ldn = nw;
        }
        wg::keep(acc);
        wg::fence();
        ss_part(acc, Wc, ldn, nw, 0, A, L.kin_h);
        if (L.kin_e) ss_part(acc, Wc, ldn, nw, L.kin_h, enc, L.kin_e);
        wg::commit();
        wg::wait_all();
        wg::keep(acc);
      }
      if (net.bias) add_bias(acc, net.bias + l * BIAS_LD + n0, nw, lane);
      if (last) {
        store_last(acc, nw, c == 0 ? sig : nullptr, outb + n0, ldo, warp,
                   lane);
      } else if (c == 0) {
        if (nch > 1) pack_act(acc, held, net.leaky);
      } else if (c + 1 < nch) {
        uint32_t v[NA / 2];
        pack_act(acc, v, net.leaky);
        park_put<NA / 2>(park, pl, c - 1, v);
      }
    }
    if (last) break;
    // every wgmma that read hb is done (wait_all): the layer's
    // activations replace the previous ones
    const int n_last = CHUNK * (nch - 1);
    if (nch > 1) put_hidden(hb, held, 0, CHUNK, warp, lane);
    for (int c = 1; c + 1 < nch; ++c) {
      park_get<NA / 2>(park, pl, c - 1, held);
      put_hidden(hb, held, CHUNK * c, CHUNK, warp, lane);
    }
    pack_act(acc, held, net.leaky);
    put_hidden(hb, held, n_last, L.kout - n_last, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(threadIdx.x >> 7);
  }
}

// Copies the W^T blocks of k steps [s0, s1) and n-tiles [nt0, nt0 + nt_n)
// of a layer slab (kout / 8 n-tiles a k step) to dst, nt_n blocks a k step,
// with the whole block (cp.async). The float32 V_WIDE weights stream in
// such units of one chunk's rows over pl.unit_k columns (32 KB at 128 x
// 64), as a 256 x 320 float32 skip layer (320 KB) does not fit; 64 columns
// leave room for 2 warpgroups beside a unit at an encoding of 64 (each
// 67.6 KB of hidden activations at width 256; read through L2, or streamed
// in units of 128 columns beside one warpgroup, the weights left the
// composite slower than cuBLAS, PERF.md).
__device__ void block_copy_unit(float* dst, const float* slab, int kout,
                                int s0, int s1, int nt0, int nt_n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int per_s = nt_n * 16;  // 16-byte pieces of one k step's blocks
  for (int i = threadIdx.x; i < (s1 - s0) * per_s; i += blockDim.x) {
    const int s = i / per_s, j = i - s * per_s;
    const float* src = slab + ((s0 + s) * (kout / 8) + nt0) * 64 + 4 * j;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     d + 16 * i),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the activated accumulators of a chunk (or their parked bits) into this
// warp's rows of hb, columns [8 nt0, 8 nt0 + 8 nt_n)
__device__ __forceinline__ void put_rows_f32(float* h, int ldh,
                                             const float (&v)[NA], int nt0,
                                             int nt_n) {
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    if (nt < nt_n) {
      float* r = h + 8 * (nt0 + nt);
      *reinterpret_cast<float2*>(r) = make_float2(v[4 * nt], v[4 * nt + 1]);
      *reinterpret_cast<float2*>(r + 8 * ldh) =
          make_float2(v[4 * nt + 2], v[4 * nt + 3]);
    }
  }
}

// float32: each warp its 16 rows of hb, row-major [64][ldh] as the
// encoding; B from W: every layer in shared memory, global memory, or
// (W_STREAM) the block's one-unit buffer, refilled per unit.
__device__ void chain_wide(const Net& net, const float* W, const Plan& pl,
                           const float* enc, float* hb, float (&acc)[NA],
                           const float* sig, float* outb, int ldo, int warp,
                           int lane, uint32_t* park) {
  const int lde = pl.lde, ldh = pl.ldh;
  const int g = lane >> 2, t = lane & 3;
  const float* e = enc + (16 * warp + g) * lde + 2 * t;
  float* h = hb + (16 * warp + g) * ldh + 2 * t;
  float held[NA];  // chunk 0 of a layer of two chunks or more, activated
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const float* Wl = W + L.w_off;
    const bool last = l == net.n_layers - 1;
    const int nch = (L.kout + CHUNK - 1) / CHUNK;
    const int kst = L.kout / 8 * 64;  // one k step's blocks of W^T
    // A of the columns before kin_h: the encoding (layer 0) or hb
    const float* A = l == 0 ? e : h;
    const int lda = l == 0 ? lde : ldh;
    for (int c = 0; c < nch; ++c) {
      const int nt0 = MAX_NT * c, nt_n = min(MAX_NT, L.kout / 8 - nt0);
      const float* Wc = Wl + nt0 * 64;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
      if (pl.w_mode != W_STREAM) {
        enc_steps<MAX_NT>(acc, A, lda, Wc, L.kin_h, lane, nt_n, kst);
        if (L.kin_e)
          enc_steps<MAX_NT>(acc, e, lde, Wc + L.kin_h / 8 * kst, L.kin_e,
                            lane, nt_n, kst);
      }
      for (int k0 = 0; pl.w_mode == W_STREAM && k0 < L.w_ld;
           k0 += pl.unit_k) {
        const int k1 = min(k0 + pl.unit_k, L.w_ld), ust = nt_n * 64;
        __syncthreads();  // the previous unit's products are done
        block_copy_unit(const_cast<float*>(W),
                        reinterpret_cast<const float*>(net.w) + L.w_off,
                        L.kout, k0 / 8, k1 / 8, nt0, nt_n);
        const int h1 = min(k1, L.kin_h), e0 = max(k0, L.kin_h);
        if (k0 < h1)
          enc_steps<MAX_NT>(acc, A + k0, lda, W, h1 - k0, lane, nt_n, ust);
        if (e0 < k1)
          enc_steps<MAX_NT>(acc, e + (e0 - L.kin_h), lde,
                            W + (e0 - k0) / 8 * ust, k1 - e0, lane, nt_n,
                            ust);
      }
      if (net.bias) add_bias(acc, net.bias + l * BIAS_LD + 8 * nt0, 8 * nt_n,
                             lane);
      if (last) {
        store_last(acc, 8 * nt_n, c == 0 ? sig : nullptr, outb + 8 * nt0,
                   ldo, warp, lane);
      } else if (c == 0) {
        if (nch > 1) {
#pragma unroll
          for (int i = 0; i < NA; ++i) held[i] = act(acc[i], net.leaky);
        }
      } else if (c + 1 < nch) {
        uint32_t v[NA];
#pragma unroll
        for (int i = 0; i < NA; ++i)
          v[i] = __float_as_uint(act(acc[i], net.leaky));
        park_put<NA>(park, pl, c - 1, v);
      }
    }
    if (last) break;
    __syncwarp();  // the warp's reads of its rows of hb are done
    const int nt_last = MAX_NT * (nch - 1);
    if (nch > 1) put_rows_f32(h, ldh, held, 0, MAX_NT);
    for (int c = 1; c + 1 < nch; ++c) {
      uint32_t v[NA];
      park_get<NA>(park, pl, c - 1, v);
#pragma unroll
      for (int i = 0; i < NA; ++i) held[i] = __uint_as_float(v[i]);
      put_rows_f32(h, ldh, held, MAX_NT * c, MAX_NT);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = act(acc[i], net.leaky);
    put_rows_f32(h, ldh, acc, nt_last, L.kout / 8 - nt_last);
    __syncwarp();
  }
}

struct Bufs {
  void *enc, *hb;
  float *outb, *sig, *wts, *tsb, *vin;
};

// Stages the weights (and the view head's) in shared memory as the plan
// says and carves out this warpgroup's buffers; -> the chain's weights.
template <typename T>
__device__ const T* block_setup(const Net& net, const View* view,
                                const Plan& pl, unsigned char* smem,
                                const T** vw, Bufs& b) {
  const T* W = reinterpret_cast<const T*>(net.w);
  if (pl.w_mode != W_GLOBAL) W = reinterpret_cast<const T*>(smem);
  if (pl.w_mode == W_ALL) block_copy(smem, net.w, pl.w_bytes);
  unsigned char* base = smem + pl.w_bytes;
  if (view) {
    *vw = reinterpret_cast<const T*>(view->w);
    if (pl.v_bytes) {
      block_copy(base, view->w, pl.v_bytes);
      *vw = reinterpret_cast<const T*>(base);
    }
  }
  base += pl.v_bytes + (threadIdx.x >> 7) * pl.per_wg;
  b.enc = base;
  base += pl.enc_b;
  b.hb = base;
  base += pl.h_b;
  b.outb = reinterpret_cast<float*>(base);
  base += pl.out_b;
  b.sig = reinterpret_cast<float*>(base);
  base += pl.sig_b;
  b.wts = reinterpret_cast<float*>(base);
  base += pl.wts_b;
  b.tsb = reinterpret_cast<float*>(base);
  base += pl.ts_b;
  b.vin = reinterpret_cast<float*>(base);
  // zero the encoding buffer once: its padding columns stay zero
  T* enc = reinterpret_cast<T*>(b.enc);
  for (int i = threadIdx.x & 127; i < TILE * pl.lde; i += 128)
    enc[i] = fromf<T>(0.0f);
  __syncthreads();
  return W;
}

// Encode + chain of a 64-point tile, this thread's point (row lt / 2)
// at x; the last layer lands in outb rows [0, 64) (each warp its 16).
template <typename T, int V>
__device__ __forceinline__ void tile(const Net& net, const Plan& pl,
                                     const T* W, const Bufs& b,
                                     const float (&x)[3], float* outb,
                                     int ncols, uint32_t* park = nullptr) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  T* enc = reinterpret_cast<T*>(b.enc);
  const int row = lt >> 1;
  const float sg = encode_point<T, V != V_SERVED>(
      net, x, lt & 1,
      [&](int c, float v) { enc[enc_index<T>(row, c, pl.lde)] = fromf<T>(v); });
  if (!(lt & 1)) b.sig[row] = sg;
  if (sizeof(T) == 2) {
    // the whole tile is wgmma's A: visible to the async proxy, all warps
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(threadIdx.x >> 7);
  } else {
    __syncwarp();
  }
  float acc[NA];
  if constexpr (V == V_WIDE) {
    chain_wide(net, W, pl, enc, reinterpret_cast<T*>(b.hb), acc,
               has_sigma(net) ? b.sig : nullptr, outb, pl.ldo, warp, lane,
               park);
  } else {
    chain<V == V_BRANCHES>(net, W, pl.w_mode == W_STREAM, enc, pl.lde, acc,
                           warp, lane);
    store_last(acc, ncols, has_sigma(net) ? b.sig : nullptr, outb, pl.ldo,
               warp, lane);
  }
  __syncwarp();
}

// The block's warpgroups walk the work items in step (so that a streamed
// layer's __syncthreads meets every thread): items base + wg.
template <typename T, int V>
__global__ void __launch_bounds__(wgs_of<T>(false, V) * 128, 1)
tmlp_kernel(Net net, Plan pl, const float* __restrict__ x3, long np,
            float* __restrict__ out, int out_rows, uint32_t* park) {
  extern __shared__ __align__(128) unsigned char smem[];
  Bufs b;
  const T* W = block_setup<T>(net, nullptr, pl, smem, nullptr, b);
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int kout = net.layer[net.n_layers - 1].kout;
  const long n_tiles = (np + TILE - 1) / TILE;
  const long stride = (long)gridDim.x * pl.wgs * TILE;
  const int row = (threadIdx.x & 127) >> 1;
  float x[3];
  load_point(x3, np, ((long)blockIdx.x * pl.wgs + (threadIdx.x >> 7)) * TILE
                         + row, x);
  for (long base = (long)blockIdx.x * pl.wgs; base < n_tiles;
       base += (long)gridDim.x * pl.wgs) {
    const long p0 = (base + (threadIdx.x >> 7)) * TILE;
    float xn[3];
    load_point(x3, np, p0 + stride + row, xn);
    tile<T, V>(net, pl, W, b, x, b.outb, kout, park);
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = xn[a];
    for (int i = lane; i < out_rows * 16; i += 32) {
      const int r = i >> 4, p = 16 * warp + (i & 15);
      if (p0 + p < np) out[(long)r * np + p0 + p] = b.outb[p * pl.ldo + r];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the proposal nets (bf16, two layers, no CP tables, no bias, angle
// doubling, an encoding <= 64 and layers <= 32 wide): bound by their 12 B
// in and 4 B out per point, they take one warp per 16-point tile with
// mma.sync m16n8k16, the weights held in registers as B fragments, the
// encoding staged through a 16-row buffer of the warp, the hidden layer in
// registers.
// ---------------------------------------------------------------------------

constexpr int SMALL_K = 64, SMALL_N = 32, SMALL_WARPS = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 of W^T (row n, columns k, k + 1) from the core-matrix slab
__device__ __forceinline__ uint32_t w_pair(const bf16* Wl, int kout, int n,
                                           int k) {
  return *reinterpret_cast<const uint32_t*>(
      Wl + ((k >> 3) * (kout >> 3) + (n >> 3)) * 64 + (n & 7) * 8 + (k & 7));
}

bool small_net(const Net& net) {
  const Layer& a = net.layer[0];
  const Layer& b = net.layer[1];
  return net.n_layers == 2 && !net.g.n_cp && !net.g.n_vm && !has_sigma(net) &&
         !net.bias && net.angle_double && a.kin_h <= SMALL_K &&
         a.kout <= SMALL_N && !b.kin_e && b.kout <= SMALL_N;
}

__global__ void __launch_bounds__(SMALL_WARPS * 32, 2)
small_kernel(Net net, const float* __restrict__ x3, long np,
             float* __restrict__ out, int out_rows) {
  constexpr int LD = SMALL_K + 8;  // padded rows: conflict-free A loads
  __shared__ __align__(16) bf16 encs[SMALL_WARPS][16 * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Layer L0 = net.layer[0], L1 = net.layer[1];
  const bf16* W = reinterpret_cast<const bf16*>(net.w);
  // B fragments: b[s][nt] = W^T[8 nt + g][16 s + 2t (+1)], [.. + 8 (+9)]
  uint32_t b0[SMALL_K / 16][SMALL_N / 8][2], b1[SMALL_N / 16][SMALL_N / 8][2];
#pragma unroll
  for (int s = 0; s < SMALL_K / 16; ++s)
#pragma unroll
    for (int nt = 0; nt < SMALL_N / 8; ++nt)
      if (s < L0.kin_h / 16 && nt < L0.kout / 8) {
        const bf16* w = W + L0.w_off;
        b0[s][nt][0] = w_pair(w, L0.kout, 8 * nt + g, 16 * s + 2 * t);
        b0[s][nt][1] = w_pair(w, L0.kout, 8 * nt + g, 16 * s + 2 * t + 8);
      }
#pragma unroll
  for (int s = 0; s < SMALL_N / 16; ++s)
#pragma unroll
    for (int nt = 0; nt < SMALL_N / 8; ++nt)
      if (s < L1.kin_h / 16 && nt < L1.kout / 8) {
        const bf16* w = W + L1.w_off;
        b1[s][nt][0] = w_pair(w, L1.kout, 8 * nt + g, 16 * s + 2 * t);
        b1[s][nt][1] = w_pair(w, L1.kout, 8 * nt + g, 16 * s + 2 * t + 8);
      }
  bf16* enc = encs[warp];
  for (int i = lane; i < 16 * LD; i += 32) enc[i] = fromf<bf16>(0.0f);
  __syncwarp();
  const long n_tiles = (np + 15) / 16;
  const long stride = (long)gridDim.x * SMALL_WARPS * 16;
  const int row = lane >> 1;
  float x[3];
  load_point(x3, np, ((long)blockIdx.x * SMALL_WARPS + warp) * 16 + row, x);
  for (long tile = (long)blockIdx.x * SMALL_WARPS + warp; tile < n_tiles;
       tile += (long)gridDim.x * SMALL_WARPS) {
    const long p0 = tile * 16;
    float xn[3];
    load_point(x3, np, p0 + stride + row, xn);
    encode_point<bf16, false, false>(net, x, lane & 1,
                       [&](int c, float v) {
                         enc[row * LD + c] = fromf<bf16>(v);
                       });
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = xn[a];
    __syncwarp();
    float acc[SMALL_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < SMALL_N / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < SMALL_K / 16; ++s) {
      if (s < L0.kin_h / 16) {
        const bf16* r0 = enc + g * LD + 16 * s + 2 * t;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(r0),
            *reinterpret_cast<const uint32_t*>(r0 + 8 * LD),
            *reinterpret_cast<const uint32_t*>(r0 + 8),
            *reinterpret_cast<const uint32_t*>(r0 + 8 * LD + 8)};
#pragma unroll
        for (int nt = 0; nt < SMALL_N / 8; ++nt)
          if (nt < L0.kout / 8)
            mma_bf16(acc[nt], a, b0[s][nt][0], b0[s][nt][1]);
      }
    }
    __syncwarp();  // the next tile's encode overwrites enc
    // layer 0's accumulators, activated and rounded, are layer 1's A
    float acc1[SMALL_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < SMALL_N / 8; ++nt)
      acc1[nt][0] = acc1[nt][1] = acc1[nt][2] = acc1[nt][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < SMALL_N / 16; ++s) {
      if (s < L1.kin_h / 16) {
        const float* c0 = acc[2 * s];
        const float* c1 = acc[2 * s + 1];
        const uint32_t a[4] = {
            pack_bf16(act(c0[0], net.leaky), act(c0[1], net.leaky)),
            pack_bf16(act(c0[2], net.leaky), act(c0[3], net.leaky)),
            pack_bf16(act(c1[0], net.leaky), act(c1[1], net.leaky)),
            pack_bf16(act(c1[2], net.leaky), act(c1[3], net.leaky))};
#pragma unroll
        for (int nt = 0; nt < SMALL_N / 8; ++nt)
          if (nt < L1.kout / 8)
            mma_bf16(acc1[nt], a, b1[s][nt][0], b1[s][nt][1]);
      }
    }
    // output row r: column r of this lane's fragment
#pragma unroll
    for (int nt = 0; nt < SMALL_N / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 8 * nt + 2 * t + j;
        if (r < out_rows) {
          if (p0 + g < np) out[(long)r * np + p0 + g] = acc1[nt][j];
          if (p0 + g + 8 < np) out[(long)r * np + p0 + g + 8] = acc1[nt][2 + j];
        }
      }
    }
  }
}

__device__ __forceinline__ float sh_component(int k, float x, float y,
                                              float z) {
  const float xy = x * y, xz = x * z, yz = y * z;
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  switch (k) {
    case 0: return 0.28209479177387814f;
    case 1: return -0.48860251190291987f * y;
    case 2: return 0.48860251190291987f * z;
    case 3: return -0.48860251190291987f * x;
    case 4: return 1.0925484305920792f * xy;
    case 5: return -1.0925484305920792f * yz;
    case 6: return 0.94617469575755997f * z2 - 0.31539156525251999f;
    case 7: return -1.0925484305920792f * xz;
    case 8: return 0.54627421529603959f * x2 - 0.54627421529603959f * y2;
    case 9: return 0.59004358992664352f * y * (-3.0f * x2 + y2);
    case 10: return 2.8906114426405538f * xy * z;
    case 11: return 0.45704579946446572f * y * (1.0f - 5.0f * z2);
    case 12: return 0.3731763325901154f * z * (5.0f * z2 - 3.0f);
    case 13: return 0.45704579946446572f * x * (1.0f - 5.0f * z2);
    case 14: return 1.4453057213202769f * z * (x2 - y2);
    default: return 0.59004358992664352f * x * (-x2 + 3.0f * y2);
  }
}
// offset of ray n's first sample in dl / ts: rows of Ts, or with pack_q > 1
// the packed rows of q * Ts (slot n % q of row n / q)
__device__ __forceinline__ long ray_offset(long n, int Ts, int pack_q) {
  return (n / pack_q) * ((long)pack_q * Ts) + (n % pack_q) * Ts;
}

// The composite: each warpgroup takes steps of R whole rays, M points (the
// rays' R T points rounded up to whole tiles, the pad encoded from x = 0 and
// never read), runs their tiles, then its warps the per-ray epilogue, a warp
// a ray. GEN = false is the served nets' composite (16 outputs, a view head
// of at most 32, whole rays of T <= 128 a step): each GEN test below folds
// at compile time to its code. GEN = true takes what that one does not: a
// step may run as nseg segments of M points (one ray a step, for rays longer
// than a step holds: warp 0 carries the ray's transmittance and its partial
// sums from segment to segment, so every sum runs in index order as in one
// pass), up to MAX_GSUM outputs (16 lanes, one column of each 16-column
// group a lane), a view head of up to MAX_VIEW hidden units (each lane its
// units lane + 32 q), and the V_WIDE nets' parked chunks.
template <typename T, int V, bool GEN>
__global__ void __launch_bounds__(wgs_of<T>(true, V) * 128, 1)
composite_kernel(Net net, View view, Plan pl, const float* __restrict__ x3,
                 const float* __restrict__ dl, const float* __restrict__ ts,
                 const float* __restrict__ rays8, int N, int Ts, int pack_q,
                 int opaque, float* __restrict__ gsum,
                 float* __restrict__ depth, float* __restrict__ wsum,
                 float* __restrict__ rgb, uint32_t* park) {
  extern __shared__ __align__(128) unsigned char smem[];
  Bufs b;
  const T* VW = nullptr;
  const T* W = block_setup<T>(net, view.H ? &view : nullptr, pl, smem, &VW,
                              b);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x & 127) >> 5,
            lane = threadIdx.x & 31;
  const int G = net.layer[net.n_layers - 1].kout_real;  // gsum columns
  // the tiles' output columns, and the segments of a step
  const int kout = GEN ? net.layer[net.n_layers - 1].kout : 16;
  const int nseg = GEN ? pl.nseg : 1;
  const int M = pl.M, rays_per_step = pl.R, RT = pl.R * Ts;
  const long np = (long)N * Ts;
  // view weights: VG [G][H] (row 0 zero), VS [sh_dim][H], VR [n_rest][H][H]
  const int H = view.H;
  const T* VG = VW;
  const T* VS = VW + G * H;
  const T* VR = VS + view.sh_dim * H;
  // a warp's scratch (GEN: pl.vld floats, ops/fused_mlp_t.py:_view_scratch;
  // else 128): rounded gsum, rounded wsum * sh, hidden activations, wsum
  float* vin = b.vin + warp * (GEN ? pl.vld : 128);
  float* vsh = vin + (GEN && G > 32 ? 64 : 32);
  float* vh = vsh + 32;
  float* misc = vh + (GEN && H > 48 ? H : 48);
  const long n_steps = ((long)N + rays_per_step - 1) / rays_per_step;
  const long steps_apart = (long)gridDim.x * pl.wgs;  // a warpgroup's steps
  const int row = (threadIdx.x & 127) >> 1;
  // point `local` of segment k of step s: np (zeros) past the step's rays
  auto point = [&](long s, int k, int local) {
    const int i = k * M + local;
    return i < RT ? s * RT + i : np;
  };
  float x[3];
  load_point(x3, np, point((long)blockIdx.x * pl.wgs + wg, 0, row), x);
  for (long base = (long)blockIdx.x * pl.wgs; base < n_steps;
       base += steps_apart) {
    const long s = base + wg;
    // the running state of the ray a warp works on, carried across
    // segments: transmittance, and (lanes 0-15) a column of each 16-column
    // group of gsum, (16) depth, (17) weights_sum
    float carry = 0.0f, part[MAX_GSUM / 16] = {};
    for (int k = 0; k < nseg; ++k) {
      for (int tt = 0; tt < M / TILE; ++tt) {
        float xn[3];  // the next tile's point: this step's or the next one's
        const long nxt = tt + 1 < M / TILE ? point(s, k, (tt + 1) * TILE + row)
                         : k + 1 < nseg    ? point(s, k + 1, row)
                                           : point(s + steps_apart, 0, row);
        load_point(x3, np, nxt, xn);
        tile<T, V>(net, pl, W, b, x, b.outb + tt * TILE * pl.ldo, kout,
                   GEN ? park : nullptr);
#pragma unroll
        for (int a = 0; a < 3; ++a) x[a] = xn[a];
      }
      wg_sync(wg);
      for (int r = warp; r < rays_per_step; r += 4) {
        const long n = s * rays_per_step + r;
        if (n >= N) break;
        // this segment's samples [t_lo, t_hi) of ray r, at local row
        // r Ts + t - k M of the buffers (without GEN the whole ray)
        const int t_lo = GEN ? max(0, k * M - r * Ts) : 0;
        const int t_hi = GEN ? min(Ts, (k + 1) * M - r * Ts) : Ts;
        if (GEN && t_lo >= t_hi) continue;
        const int row0 = r * Ts + t_lo - k * M;
        const float* ob = b.outb + row0 * pl.ldo;
        float* wts = b.wts + row0;
        float* tsb = b.tsb + row0;
        const long roff = ray_offset(n, Ts, pack_q);
        if (t_lo == 0) {  // the ray's first segment
          carry = 0.0f;
#pragma unroll
          for (int j = 0; j < MAX_GSUM / 16; ++j) part[j] = 0.0f;
        }
        for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
          const int t = t0 + lane;
          const bool valid = t < t_hi;
          float ds = 0.0f, alpha = 0.0f;
          if (valid) {
            const float s = ob[(t - t_lo) * pl.ldo] - 1.0f;
            const float sigma = fmaxf(s, 0.0f) + log1pf(expf(-fabsf(s)));
            ds = dl[roff + t] * sigma;
            const float ds_a =
                (opaque && t == Ts - 1) ? __int_as_float(0x7f800000) : ds;
            alpha = 1.0f - expf(-ds_a);
            tsb[t - t_lo] = ts[roff + t];
          }
          float incl = ds;
          for (int off = 1; off < 32; off <<= 1) {
            const float v = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += v;
          }
          float excl = __shfl_up_sync(FULL, incl, 1);
          if (lane == 0) excl = 0.0f;
          float w = alpha * expf(-(carry + excl));
          if (isnan(w)) w = 0.0f;
          if (valid) wts[t - t_lo] = w;
          carry += __shfl_sync(FULL, incl, 31);
        }
        __syncwarp();
        if constexpr (GEN) {
          // the per-ray sums, each in index order across the segments
          const int nt = t_hi - t_lo;
          if (lane < 16) {
#pragma unroll
            for (int j = 0; j < MAX_GSUM / 16; ++j) {
              const int c = lane + 16 * j;
              if (c < G) {
                float a = part[j];
#pragma unroll 4
                for (int t = 0; t < nt; ++t) a += wts[t] * ob[t * pl.ldo + c];
                part[j] = a;
              }
            }
          } else if (lane < 18) {
            float a = part[0];
#pragma unroll 4
            for (int t = 0; t < nt; ++t)
              a += wts[t] * (lane == 16 ? tsb[t] : 1.0f);
            part[0] = a;
          }
          if (t_hi < Ts) {  // the ray goes on in the next segment
            __syncwarp();
            continue;
          }
          if (lane < 16) {
#pragma unroll
            for (int j = 0; j < MAX_GSUM / 16; ++j) {
              const int c = lane + 16 * j;
              if (c < G) {
                gsum[n * G + c] = part[j];
                vin[c] = rnd<T>(part[j]);
              }
            }
          } else if (lane == 16) {
            depth[n] = part[0];
          } else if (lane == 17) {
            wsum[n] = part[0];
            misc[0] = part[0];
          }
        } else {
          if (lane < G) {
            float a = 0.0f;
#pragma unroll 4
            for (int t = 0; t < Ts; ++t) a += wts[t] * ob[t * pl.ldo + lane];
            gsum[n * G + lane] = a;
            vin[lane] = rnd<T>(a);
          } else if (lane == 16) {
            float a = 0.0f;
#pragma unroll 4
            for (int t = 0; t < Ts; ++t) a += wts[t] * tsb[t];
            depth[n] = a;
          } else if (lane == 17) {
            float a = 0.0f;
#pragma unroll 4
            for (int t = 0; t < Ts; ++t) a += wts[t];
            wsum[n] = a;
            misc[0] = a;
          }
        }
        __syncwarp();
        if (H) {
          const float* rr = rays8 + n * 8;
          const float dx = rr[3], dy = rr[4], dz = rr[5];
          const float inv = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
          if (lane < view.sh_dim)
            vsh[lane] = rnd<T>(misc[0] * sh_component(lane, dx * inv,
                                                      dy * inv, dz * inv));
          __syncwarp();
          // hidden unit lane + 32 q in hj[q], each sum in index order
          constexpr int NQ = GEN ? MAX_VIEW / 32 : 1;
          float hj[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int j = lane + 32 * q;
            hj[q] = 0.0f;
            if (j < H) {
              float a = 0.0f, c = 0.0f;
#pragma unroll 4
              for (int k2 = 0; k2 < G; ++k2)
                a += vin[k2] * tof<T>(VG[k2 * H + j]);
#pragma unroll 4
              for (int k2 = 0; k2 < view.sh_dim; ++k2)
                c += vsh[k2] * tof<T>(VS[k2 * H + j]);
              hj[q] = a + c;
            }
          }
          for (int l = 0; l < view.n_rest; ++l) {
            __syncwarp();
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const int j = lane + 32 * q;
              if (j < H) vh[j] = rnd<T>(fmaxf(hj[q], 0.0f));
            }
            __syncwarp();
            const T* vr = VR + (size_t)l * H * H;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const int j = lane + 32 * q;
              if (j < H) {
                float a = 0.0f;
#pragma unroll 8
                for (int i = 0; i < H; ++i) a += vh[i] * tof<T>(vr[i * H + j]);
                hj[q] = a;
              }
            }
          }
          if (lane < 3) rgb[n * 3 + lane] = 1.0f / (1.0f + expf(-hj[0]));
        }
        __syncwarp();
      }
      wg_sync(wg);
    }
  }
}

Net make_net(const int* desc, const void* w, int w_elems, float enc_scale,
             int angle_double, const float* bias, const Grids& grids) {
  Net net = {};
  net.n_layers = desc[0];
  net.leaky = desc[1];
  net.enc_freqs = desc[2];
  net.F = desc[3];
  net.ke = desc[4];
  net.hmax = desc[5];
  net.angle_double = angle_double;
  for (int l = 0; l < net.n_layers && l < MAX_LAYERS; ++l) {
    const int* d = desc + 6 + 6 * l;
    net.layer[l] = Layer{d[0], d[1], d[2], d[3], d[4], d[5]};
  }
  net.enc_scale = enc_scale;
  net.w = w;
  net.w_elems = w_elems;
  net.bias = bias;
  net.g = grids;
  return net;
}

int launch_small(const Net& net, const float* x3, long np, float* out,
                 int out_rows, cudaStream_t stream) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small_kernel,
                                                SMALL_WARPS * 32, 0);
  const long want = ((np + 15) / 16 + SMALL_WARPS - 1) / SMALL_WARPS;
  const long cap = (long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  small_kernel<<<grid, SMALL_WARPS * 32, 0, stream>>>(net, x3, np, out,
                                                      out_rows);
  return (int)cudaGetLastError();
}

// the blocks of `kernel` resident on the card at the plan's block size and
// shared memory: the persistent grid's size, and the slots of the park
// buffer (park_blocks)
template <typename K>
long resident_blocks(K kernel, const Plan& pl) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pl.total);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                pl.wgs * 128, pl.total);
  return (long)n_sm * (per_sm < 1 ? 1 : per_sm);
}

// the persistent grid: the resident blocks, at most one a work_items / wgs;
// 0 where the park buffer (sized by park_blocks) has too few slots
template <typename K>
int grid_size(K kernel, const Plan& pl, long work_items, int park_words,
              long park_bytes) {
  const long want = (work_items + pl.wgs - 1) / pl.wgs;
  long grid = resident_blocks(kernel, pl);
  if (want < grid) grid = want > 0 ? want : 1;
  if (pl.park_chunks &&
      park_bytes < grid * pl.wgs * pl.park_chunks * park_words * 128 * 4L)
    return 0;
  return (int)grid;
}

// the plan's own checks: the kernels trust it for every buffer they carve
bool plan_ok(const Net& net, const Plan& pl, int max_wgs) {
  if (pl.total > SMEM_LIMIT || pl.wgs < 1 || pl.wgs > max_wgs) return false;
  if (pl.M < TILE || pl.M % TILE || pl.nseg < 1) return false;
  if (pl.unit_k < 0 || pl.unit_k % 16 || pl.park_chunks < 0) return false;
  if (net.ke % 16 || net.hmax > MAX_WIDTH) return false;
  if (pl.variant != V_WIDE && net.hmax > CHUNK) return false;
  // the served variant has no loop over a ladder's levels past the slots
  if (pl.variant == V_SERVED && (net.g.n_cp_more || net.g.n_vm_more))
    return false;
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer& L = net.layer[l];
    if (L.kout > MAX_WIDTH || L.kout % 16 || L.kin_h % 16 || L.kin_e % 16)
      return false;
  }
  return true;
}

template <typename T, int V>
int launch_tmlp(const Net& net, const Plan& pl, const float* x3, long np,
                float* out, int out_rows, uint32_t* park, long park_bytes,
                cudaStream_t stream) {
  if (!plan_ok(net, pl, wgs_of<T>(false, V)) || pl.M != TILE) return -1;
  if (V == V_WIDE && sizeof(T) == 4 && pl.w_mode == W_STREAM && !pl.unit_k)
    return -1;
  const int grid = grid_size(tmlp_kernel<T, V>, pl, (np + TILE - 1) / TILE,
                             sizeof(T) == 2 ? NA / 2 : NA, park_bytes);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  tmlp_kernel<T, V><<<grid, pl.wgs * 128, pl.total, stream>>>(
      net, pl, x3, np, out, out_rows, park);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tmlp_of(const Net& net, const Plan& pl, const float* x3, long np,
                   float* out, int out_rows, uint32_t* park, long park_bytes,
                   cudaStream_t stream) {
  switch (pl.variant) {
    case V_SERVED:
      return launch_tmlp<T, V_SERVED>(net, pl, x3, np, out, out_rows, park,
                                      park_bytes, stream);
    case V_BRANCHES:
      return launch_tmlp<T, V_BRANCHES>(net, pl, x3, np, out, out_rows, park,
                                        park_bytes, stream);
    default:
      return launch_tmlp<T, V_WIDE>(net, pl, x3, np, out, out_rows, park,
                                    park_bytes, stream);
  }
}

// the composite a plan runs: the general one (GEN) or the served one
template <typename T, int V>
auto composite_of(const Plan& pl) {
  return pl.general ? &composite_kernel<T, V, true>
                    : &composite_kernel<T, V, false>;
}

struct CompositeArgs {
  const float *x3, *dl, *ts, *rays8;
  int N, Ts, pack_q, opaque;
  float *gsum, *depth, *wsum, *rgb;
};

template <typename T, int V>
int launch_composite(const Net& net, View view, const Plan& pl,
                     const CompositeArgs& c, uint32_t* park, long park_bytes,
                     cudaStream_t stream) {
  if (!plan_ok(net, pl, wgs_of<T>(true, V))) return -1;
  if (c.Ts < 1 || c.pack_q < 1 || c.N % c.pack_q || pl.R < 1)
    return (int)cudaErrorInvalidValue;
  // the steps' buffers hold their rays: whole rays of R T <= M points, or
  // (general) one ray in nseg segments of M
  if ((pl.nseg == 1 && pl.R * c.Ts > pl.M) ||
      (pl.nseg > 1 && (pl.R != 1 || pl.nseg * pl.M < c.Ts)))
    return (int)cudaErrorInvalidValue;
  const Layer& last = net.layer[net.n_layers - 1];
  if (view.sh_dim > 16) return (int)cudaErrorInvalidValue;
  if (pl.general ? (last.kout_real > MAX_GSUM || view.H > MAX_VIEW)
                 : (last.kout != 16 || view.H > 32 || pl.nseg != 1 ||
                    c.Ts > 128 || pl.park_chunks))
    return (int)cudaErrorInvalidValue;
  if (V == V_WIDE && sizeof(T) == 4 && pl.w_mode == W_STREAM && !pl.unit_k)
    return -1;
  const long n_steps = ((long)c.N + pl.R - 1) / pl.R;
  auto* kernel = composite_of<T, V>(pl);
  const int grid = grid_size(kernel, pl, n_steps,
                             sizeof(T) == 2 ? NA / 2 : NA, park_bytes);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<grid, pl.wgs * 128, pl.total, stream>>>(
      net, view, pl, c.x3, c.dl, c.ts, c.rays8, c.N, c.Ts, c.pack_q, c.opaque,
      c.gsum, c.depth, c.wsum, c.rgb, park);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_composite_of(const Net& net, View view, const Plan& pl,
                        const CompositeArgs& c, uint32_t* park,
                        long park_bytes, cudaStream_t stream) {
  switch (pl.variant) {
    case V_SERVED:
      return launch_composite<T, V_SERVED>(net, view, pl, c, park,
                                           park_bytes, stream);
    case V_BRANCHES:
      return launch_composite<T, V_BRANCHES>(net, view, pl, c, park,
                                             park_bytes, stream);
    default:
      return launch_composite<T, V_WIDE>(net, view, pl, c, park, park_bytes,
                                         stream);
  }
}

}  // namespace

// sizeof(Grids) and sizeof(Plan), which ops/fused_mlp_t.py checks its
// mirrors against
extern "C" int grids_size() { return (int)sizeof(Grids); }
extern "C" int plan_size() { return (int)sizeof(Plan); }

// the blocks a launch of `plan` keeps resident (its persistent grid at
// most), for which the host sizes the park buffer: a slot of
// plan.park_chunks chunks a warpgroup (0 when the plan parks none)
extern "C" long park_blocks(int use_bf16, int composite, const void* plan) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  if (!pl.park_chunks || pl.variant != V_WIDE) return 0;
  if (composite)
    return use_bf16 ? resident_blocks(composite_of<bf16, V_WIDE>(pl), pl)
                    : resident_blocks(composite_of<float, V_WIDE>(pl), pl);
  return use_bf16 ? resident_blocks(tmlp_kernel<bf16, V_WIDE>, pl)
                  : resident_blocks(tmlp_kernel<float, V_WIDE>, pl);
}

// `grids` points to a Grids and `plan` to a Plan (void pointers: a type of
// this file's unnamed namespace in the signature would keep the symbol
// from being exported); `bias` is null for a net without biases; `park`
// holds park_bytes for the V_WIDE kernels' parked chunks (null when the
// plan parks none)
extern "C" int tmlp_launch(int use_bf16, const int* desc, const void* w,
                           int w_elems, float enc_scale, int angle_double,
                           const float* bias, const void* grids,
                           const void* plan, const float* x3, long np,
                           float* out, int out_rows, void* park,
                           long park_bytes, void* stream) {
  const Grids& g = *static_cast<const Grids*>(grids);
  const Plan& pl = *static_cast<const Plan*>(plan);
  if (desc[0] < 1 || desc[0] > MAX_LAYERS) return -1;
  Net net = make_net(desc, w, w_elems, enc_scale, angle_double, bias, g);
  if (pl.small) {
    if (!use_bf16 || !small_net(net)) return -1;
    return launch_small(net, x3, np, out, out_rows, (cudaStream_t)stream);
  }
  auto* fn = use_bf16 ? &launch_tmlp_of<bf16> : &launch_tmlp_of<float>;
  return fn(net, pl, x3, np, out, out_rows, static_cast<uint32_t*>(park),
            park_bytes, (cudaStream_t)stream);
}

extern "C" int tmlp_composite_launch(
    int use_bf16, const int* desc, const void* w, int w_elems, float enc_scale,
    int angle_double, const float* bias, const void* grids, const void* plan,
    const void* vw, int v_elems, const int* vdesc, const float* x3,
    const float* dl, const float* ts, const float* rays8, int N, int Ts,
    int pack_q, int opaque, float* gsum, float* depth, float* wsum,
    float* rgb, void* park, long park_bytes, void* stream) {
  const Grids& g = *static_cast<const Grids*>(grids);
  const Plan& pl = *static_cast<const Plan*>(plan);
  if (desc[0] < 1 || desc[0] > MAX_LAYERS || pl.small) return -1;
  Net net = make_net(desc, w, w_elems, enc_scale, angle_double, bias, g);
  View view{vw, v_elems, 0, 0, 0, 0};
  if (vw && vdesc) {
    view.H = vdesc[0];
    view.n_rest = vdesc[1];
    view.sh_dim = vdesc[2];
    view.degree = vdesc[3];
  }
  const CompositeArgs c{x3, dl, ts, rays8, N, Ts, pack_q, opaque,
                        gsum, depth, wsum, rgb};
  auto* fn =
      use_bf16 ? &launch_composite_of<bf16> : &launch_composite_of<float>;
  return fn(net, view, pl, c, static_cast<uint32_t*>(park), park_bytes,
            (cudaStream_t)stream);
}
