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
// 131,072 samples of a 64^2 frame take 0.185 ms as 3xTF32 at 495 TFLOP/s;
// at width 256 (429,568 MAC a point) a 512^2 frame at (32, 16) takes
// 21.86 ms so (the V_WIDE32 composite's bound, with its view head).
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
//     tmlp_kernel and the composites in bf16, V_WIDE32 in float32) keep the hidden activations of a
//     tile in shared memory, since a 64 x 256 accumulator and the next
//     layer's A fragments would not fit in a thread's registers: each
//     layer runs as chunks of at most 128 outputs (one 64-register
//     accumulator), chunk 0 held in registers (bf16), activated, the chunks
//     between the first and the last parked in device memory (a slot per
//     warpgroup of the persistent grid, each thread its own words,
//     coalesced), until the last chunk has read the previous activations,
//     then all written back. bf16: A comes from shared memory for every
//     layer (wgmma_ss), B from a ring of weight units in shared memory (a
//     unit: one chunk's rows over 64 columns, 16 KB), which one warp of a
//     producer warpgroup fills with bulk copies (cp.async.bulk on
//     mbarriers) ahead of up to three consumer warpgroups: one copy serves
//     three tiles (192 points), a unit's products run while the next units
//     are copied, and a chunk's products are one wgmma pipeline of one
//     shape with no branch in it (the earlier design waited for each copy,
//     and ptxas serialized its wgmmas; PERF.md);
//     float32 (V_WIDE32, the Trainer's evaluation of such nets): 3xTF32 on
//     wgmma, B from a ring as in bf16 (units of a chunk's rows over 8
//     columns, the weights split on the host into tf32 hi and lo slabs, 8
//     KB, up to two consumer warpgroups), A the float32 activations of the
//     warp's rows (row-major, as the encoding) split in registers, each
//     group of 64 columns into a fresh accumulator added in float32, every
//     chunk of a layer but the last parked (chain_wide's float32
//     overload; it replaced a chain of mma.sync whose block copied each
//     unit and waited, PERF.md);
//   - the bf16 nets of the grid family (VM planes, CP ladders of two levels
//     or more, sigma-VM; no layer over 128) whose weights fit shared
//     memory whole (grid_student; the ladders' stream and keep V_SERVED:
//     ops/fused_mlp_t.py:_grid_net) take the V_GRID variant of
//     tmlp_kernel and the composites (the same TPU kernels and their grid
//     branches _grid_blocks :323, _cp_level :235, _vm_block :263), which
//     splits the encode from the chain: seven encoder warps write the tiles'
//     encodings (a quarter tile a task, a thread pair a point, the
//     arithmetic of encode_point) into a ring of encoding slots in shared
//     memory, in the core-matrix layout wgmma reads A from, while two
//     consumer warpgroups run the ring chain above (chain_wide: A from
//     shared memory, the hidden activations there, each chunk's products
//     one wgmma pipeline) on the slots filled and release them, and the
//     eighth warp fills the weight ring; the table reads of later tiles
//     run under the products of earlier ones (grid_encode). Bound: the
//     operations (grid_student 71,680 MAC a point, 0.607 ms for the 4.19 M
//     points of a 512^2 frame at (32, 16)) beside the table rows each
//     point reads through L1 and L2 (2,112 B);
//     what binds it is in PERF.md (section 6, V_GRID);
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
//     fragments; such nets with more layers or layers up to 64 wide
//     (ModelConfig's default w64 d4) take prop_kernel: a warp per 32
//     points carried through the chain alone, mma.sync with the weights in
//     shared memory read by ldmatrix (see its note).
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
// Each kernel comes in five variants, picked per net by the host's plan
// (ops/fused_mlp_t.py:kernel_plan): V_SERVED, the nets every served
// configuration has (no bias, angle doubling, no layer over 128, ladders
// of at most INLINE_LEVELS levels), whose code holds no test for the
// branches below (a run-time test of either cost the asset's float32
// launches 3-7 %, PERF.md); V_BRANCHES, such nets with biases, the
// dense-sin encode or longer ladders; V_WIDE (bf16 only), nets with a
// layer over 128 (each branch at run time); V_GRID (bf16 only), the nets of the grid
// family, no layer over 128 and the factorized grids past the asset's one
// CP line table: VM planes, CP ladders of two levels or more, sigma-VM,
// whose weights fit shared memory whole (their encode in warps of its own
// beside the chain, see grid_encode); V_WIDE32 (float32 only), the float32
// nets with a layer over 128, on the weight ring with 3xTF32 on wgmma
// (chain_wide's float32 overload).
enum Variant {
  V_SERVED = 0, V_BRANCHES = 1, V_WIDE = 2, V_GRID = 3, V_WIDE32 = 4
};
// consumer warpgroups a block, which share each weight unit of the ring:
// 3 in V_WIDE, 2 in V_WIDE32 (the plan takes fewer where the buffers do
// not fit)
constexpr int WIDE_WGS = 3, WIDE_F32_WGS = 2;
// V_GRID kernels: GRID_WGS consumer warpgroups (the chain and the
// epilogue), then GRID_ENC_WGS encoder warpgroups, whose warps encode the
// tiles but the last one, which fills the weight ring
// (ops/fused_mlp_t.py: GRID_WGS, GRID_ENC_WGS)
constexpr int GRID_WGS = 2, GRID_ENC_WGS = 2;
template <typename T>
constexpr int wgs_of(bool composite, int v) {
  return v == V_WIDE     ? WIDE_WGS
         : v == V_WIDE32 ? WIDE_F32_WGS
         : v == V_GRID   ? GRID_WGS
                         : wgs_of<T>(composite);
}
// The bf16 V_WIDE and V_GRID kernels and the V_WIDE32 ones stream the
// weights through a ring of units in shared memory: a unit is one chunk's
// rows (<= CHUNK) over UNIT_K columns of W^T (16 KB; V_WIDE32: over
// F32_UNIT_K columns as tf32 hi and lo slabs, 8 KB), the ring
// 2..MAX_STAGES of them, each with a full and an empty mbarrier (RING_BAR_B
// bytes after the ring), filled with bulk copies by one warp (V_WIDE,
// V_WIDE32: of a producer warpgroup, the block's last; V_GRID: the last
// warp of the encoder warpgroups).
template <typename T>
__host__ __device__ constexpr bool ring_of(int v) {
  return (sizeof(T) == 2 && (v == V_WIDE || v == V_GRID)) || v == V_WIDE32;
}
constexpr int UNIT_K = 64, UNIT_B = 128 * UNIT_K * 2;
// A V_WIDE32 unit: one chunk's nw rows over F32_UNIT_K columns (one k8
// step of tf32 wgmma), split on the host (TransposedFieldMLP.packed with
// `split`) into hi, the tf32 rounding of each weight (tf32_rna), and lo =
// w - hi: [hi][lo], each two core-matrix k blocks of nw / 8 core matrices
// of 8 rows x 4 floats (128 B), the W^T columns of each 8-column step in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (k slot j <- column 2j, slot j + 4 <-
// column 2j + 1), so that a lane's A fragment of slots t and t + 4 is its
// float2 at columns 2t and 2t + 1 of the row-major activations, and the
// accumulators of a layer are the next layer's A in the same order; nw *
// 64 B, a stage F32_UNIT_B; a layer's units contiguous, chunk by chunk, in
// ascending k (one bulk copy a unit). The products of F32_GROUP units (64
// columns; a chunk's last group may be shorter, an even number of units)
// go into one fresh accumulator, then one float32 add into the chunk's.
constexpr int F32_UNIT_K = 8, F32_UNIT_B = 128 * F32_UNIT_K * 4 * 2;
constexpr int F32_GROUP = 8;
template <int V>
__host__ __device__ constexpr int unit_bytes() {
  return V == V_WIDE32 ? F32_UNIT_B : UNIT_B;
}
// after the barriers, ZERO_B bytes of zeros where a layer's last unit is
// short of UNIT_K columns: one k16 step of B for 128 rows, which its k
// steps past the layer's columns read
constexpr int MAX_STAGES = 8, RING_BAR_B = 16 * MAX_STAGES, ZERO_B = 4096;
constexpr int PRODUCER_THREADS = 128;
template <typename T>
constexpr int threads_of(bool composite, int v) {
  return wgs_of<T>(composite, v) * 128 +
         (v == V_GRID ? GRID_ENC_WGS * 128
                      : ring_of<T>(v) ? PRODUCER_THREADS : 0);
}
// Registers a thread of a ring kernel (setmaxnreg): it starts with
// RING_ENTRY_REGS, as many as one block of WIDE_WGS + 1 warpgroups an SM
// leaves (ptxas takes them all when the kernel sets its registers; the
// launch checks it, or the increase below could wait for ever); the
// producer warpgroup gives them back down to PRODUCER_REGS, and the
// consumers take what that frees, RING_REGS each (128 -> 160 at three
// consumers: the chain's accumulators, the held chunk and the composite's
// state spilled at 128).
constexpr int RING_ENTRY_REGS = (65536 / ((WIDE_WGS + 1) * 128)) & ~7;
constexpr int PRODUCER_REGS = 32;
constexpr int RING_REGS =
    (RING_ENTRY_REGS + (RING_ENTRY_REGS - PRODUCER_REGS) / WIDE_WGS) & ~7;
static_assert(RING_REGS <= 256 && PRODUCER_REGS >= 24,
              "setmaxnreg takes 24..256 registers");
// The same budget for V_WIDE32: one block of WIDE_F32_WGS + 1 warpgroups
// an SM starts with F32_RING_ENTRY_REGS (168), the consumers take what the
// producer gives back, F32_RING_REGS (232: a chunk's accumulators, a
// group's fresh ones and two units' A). A producer warp in its place (288
// threads) left every thread 168 registers, not 224 (nine warps: three on
// one of the SM's four register files), and the chain spilled (PERF.md).
constexpr int F32_RING_ENTRY_REGS =
    (65536 / ((WIDE_F32_WGS + 1) * 128)) & ~7;
constexpr int F32_RING_REGS =
    (F32_RING_ENTRY_REGS + (F32_RING_ENTRY_REGS - PRODUCER_REGS) /
                               WIDE_F32_WGS) & ~7;
static_assert(F32_RING_REGS <= 256, "setmaxnreg takes 24..256 registers");
// The same budget for V_GRID: GRID_ENTRY_REGS at entry (one block of
// GRID_WGS + GRID_ENC_WGS warpgroups an SM), the encoder warpgroups give
// theirs down to GRID_ENC_REGS and the consumers take what that frees,
// GRID_REGS each (128 -> 104 / 152 at two and two; 96 / 160 measured
// slower, the encoders' spills, PERF.md); the general composite, whose
// consumers carry a ray's sums across segments, at GRID_GEN_ENC_REGS /
// GRID_GEN_REGS (88 / 168: at 152 and 160 ptxas serialized its wgmmas,
// C7511).
constexpr int GRID_ENTRY_REGS =
    (65536 / ((GRID_WGS + GRID_ENC_WGS) * 128)) & ~7;
constexpr int GRID_ENC_REGS = 104, GRID_GEN_ENC_REGS = GRID_ENC_REGS - 16;
constexpr int grid_regs(int enc) {
  return (GRID_ENTRY_REGS + (GRID_ENTRY_REGS - enc) * GRID_ENC_WGS / GRID_WGS)
         & ~7;
}
constexpr int GRID_REGS = grid_regs(GRID_ENC_REGS);
constexpr int GRID_GEN_REGS = grid_regs(GRID_GEN_ENC_REGS);
static_assert(GRID_GEN_REGS <= 256 && GRID_GEN_ENC_REGS >= 24 &&
                  GRID_ENC_REGS <= GRID_ENTRY_REGS,
              "setmaxnreg takes 24..256 registers");
// V_GRID's ring of encoding slots: 1..MAX_SLOTS tiles' encodings (and
// their sigma sums), a multiple of the block's consumers, each with a full
// barrier (ENC_ARRIVALS arrivals: every lane of the four encoder warps that
// write its quarters) and a release count (one a warp of the consumer that
// read it), SLOT_BAR_B bytes after the slots
constexpr int MAX_SLOTS = 8, SLOT_BAR_B = 16 * MAX_SLOTS, ENC_ARRIVALS = 128;
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
// L2; float32 only), all of them staged in shared memory, one layer at a
// time, or (V_WIDE, V_WIDE32, V_GRID) the ring
enum WeightMode { W_GLOBAL = 0, W_ALL = 1, W_STREAM = 2, W_RING = 3 };

// ---------------------------------------------------------------------------
// the launch plan: made on the host by ops/fused_mlp_t.py:kernel_plan (its
// ctypes mirror KernelPlan; plan_size() checks the two agree) and passed to
// the kernels as it is
// ---------------------------------------------------------------------------

struct Plan {
  int lde, ldo, M, R;  // M: points per warpgroup step, R of them rays'
  int ldh;             // hb row stride (V_WIDE, V_WIDE32, V_GRID)
  int wgs, w_mode, w_bytes, v_bytes;
  int enc_b, h_b, out_b, sig_b, wts_b, ts_b, vin_b;
  int per_wg, total;
  // segments of a composite step (a ray longer than a step runs as nseg
  // segments of M points, one ray a step; 1: whole rays), floats of a
  // warp's view-head scratch, columns of a V_WIDE32 ring unit
  // (F32_UNIT_K; 0 in every other plan), chunks of a V_WIDE layer parked
  // in the park buffer (all but the first and the last of the widest
  // layer's; V_WIDE32: all but the last)
  int nseg, vld, unit_k, park_chunks;
  // the kernel: its variant (Variant), the proposal nets' small_kernel
  // (run_tmlp), the general composite epilogue, the wider proposal nets'
  // prop_kernel (run_tmlp: w_bytes of staged weights, then per warp enc_b
  // bytes of buffer, rows lde = ke + 8 wide)
  int variant, small, general, prop;
  // W_RING: the ring's stages of unit_b bytes (w_bytes = stages unit_b +
  // RING_BAR_B, + ZERO_B where a layer is not whole units: the barriers
  // and the zero block after them)
  int stages, unit_b;
  // V_GRID: the encoding slots of slot_b bytes each (a tile's encoding,
  // enc_b, then its sigma sums, sig_b), after the view head, then
  // SLOT_BAR_B of their barriers; the warpgroups' buffers then hold no
  // encoding nor sigma sums of their own
  int slots, slot_b;
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

// The ring of a bf16 V_WIDE block (W_RING): pl.stages units of UNIT_B
// bytes from the start of shared memory, then the stages' full barriers
// (one arrival, the producer's, and the unit's bytes) and empty barriers
// (one arrival a consumer warp), then the zero block. The producer and
// every consumer warpgroup walk the same sequence of units, each with its
// own stage and phase: for each tile the block's warpgroups take together,
// layer by layer, chunk by chunk, UNIT_K columns at a time in ascending k.
// A unit is a chunk's nw rows over its k blocks, as the slab keeps them:
// for each k block nw / 8 contiguous core matrices, so it lands as a slab
// nw rows wide (nw * 16 B from one k block to the next) with one bulk copy
// a k block. A V_WIDE32 block's ring alike, its stages F32_UNIT_B bytes
// (unit_bytes), each unit one bulk copy of the split slab (f32_unit,
// ring_fill_tile_f32), no zero block.
struct Ring {
  const bf16* w;     // stage 0
  const bf16* zero;  // the zero block
  uint32_t bars;     // the full barrier of stage 0; empty ones MAX_STAGES on
  int stages, stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (MAX_STAGES + s);
  }
  __device__ __forceinline__ const bf16* unit() const {
    return w + stage * (UNIT_B / 2);
  }
  // the next stage, without a branch
  __device__ __forceinline__ void next() {
    const int s = stage + 1;
    phase ^= (uint32_t)(s == stages);
    stage = s == stages ? 0 : s;
  }
};

template <int V>
__device__ __forceinline__ Ring ring_at(unsigned char* smem, const Plan& pl) {
  unsigned char* bars = smem + pl.stages * unit_bytes<V>();
  return Ring{reinterpret_cast<const bf16*>(smem),
              reinterpret_cast<const bf16*>(bars + RING_BAR_B),
              wg::smem(bars), pl.stages, 0, 0u};
}

// The producer's part of one tile (one warp): every unit of the chain in
// the consumers' order, each into the next stage once every consumer warp
// has released it (the first round of stages is free), lane j copying k
// block j of the unit. It runs on across chunks, layers and tiles: only a
// full ring holds it.
__device__ void ring_fill_tile(const Net& net, Ring& r, int lane) {
  const bf16* w = reinterpret_cast<const bf16*>(net.w);
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    for (int n0 = 0; n0 < L.kout; n0 += CHUNK) {
      const int nw = min(CHUNK, L.kout - n0);
      for (int k0 = 0; k0 < L.w_ld; k0 += UNIT_K) {
        const int nkb = (min(k0 + UNIT_K, L.w_ld) - k0) / 8;
        const uint32_t full = r.full(), bytes = nkb * nw * 16;
        wg::mbar_wait(r.empty(r.stage), r.phase ^ 1u);
        if (lane == 0) wg::mbar_expect_tx(full, bytes);
        __syncwarp();
        if (lane < nkb)
          wg::bulk_copy(
              wg::smem(r.unit()) + lane * nw * 16,
              w + L.w_off + ((k0 / 8 + lane) * (L.kout / 8) + n0 / 8) * 64,
              nw * 16, full);
        r.next();
      }
    }
  }
}

// The products of one unit of a chunk NW rows wide: its UNIT_K / 16 k
// steps, one wgmma of one shape each and no branch between them, so that
// ptxas keeps the pipeline asynchronous (a branch among a chunk's wgmmas,
// or several shapes on its accumulators, and it waits for each). Step s
// is W^T column kc = k0 + 16 s: A from the hidden activations (kc <
// kin_h) or, past them, the encoding (the skip layer's columns); past the
// layer's last column (a last unit short of UNIT_K) B is the zero block,
// A any finite columns.
template <int NW>
__device__ __forceinline__ void unit_products(float (&acc)[NA], const Ring& r,
                                              const bf16* A, const bf16* enc,
                                              int k0, int kin_h, int w_ld,
                                              int nw) {
  const bf16* U = r.unit();
#pragma unroll
  for (int s = 0; s < UNIT_K / 16; ++s) {
    const int kc = k0 + 16 * s;
    const bf16* a = kc < kin_h ? A + kc * TILE
                               : enc + (kc < w_ld ? kc - kin_h : 0) * TILE;
    const bf16* b = kc < w_ld ? U + s * 2 * nw * 8 : r.zero;
    const uint64_t da = wg::desc(a, TILE * 16, 128);
    const uint64_t db = wg::desc(b, nw * 16, 128);
    if constexpr (NW == 128)
      wg::wgmma_ss_n128<0>(acc, da, db);
    else if constexpr (NW == 64)
      wg::wgmma_ss_n64<0>(acc, da, db);
    else
      wg::wgmma_ss_n16<0>(acc, da, db);
  }
}

// One chunk's products, unit by unit in ascending k: each unit's wgmmas
// are issued once it has arrived and committed as a group, and the unit
// before is released when its group is done (wgmma.wait_group 1: a unit's
// products run while the next units arrive); the accumulators stay in
// registers across the units. A consumer warp releases a stage with one
// arrival of its lane 0, predicated (no branch).
template <int NW>
__device__ __forceinline__ void chunk_units(float (&acc)[NA], Ring& r,
                                            const Layer& L, const bf16* A,
                                            const bf16* enc, int nw,
                                            int lane) {
  int prev = r.stage;
  wg::mbar_wait(r.full(), r.phase);
  wg::keep(acc);
  wg::fence();
  unit_products<NW>(acc, r, A, enc, 0, L.kin_h, L.w_ld, nw);
  wg::commit();
  r.next();
  for (int k0 = UNIT_K; k0 < L.w_ld; k0 += UNIT_K) {
    wg::mbar_wait(r.full(), r.phase);
    wg::keep(acc);
    wg::fence();
    unit_products<NW>(acc, r, A, enc, k0, L.kin_h, L.w_ld, nw);
    wg::commit();
    wg::wait<1>();
    wg::keep(acc);
    wg::mbar_arrive_if(r.empty(prev), lane == 0);
    prev = r.stage;
    r.next();
  }
  wg::wait<0>();
  wg::keep(acc);
  wg::mbar_arrive_if(r.empty(prev), lane == 0);
}

// bf16: A from shared memory for every layer (the encoding, then hb), B
// from the ring (chunk_units, one instance a chunk width); the sums in k
// order.
__device__ void chain_wide(const Net& net, Ring& r, const Plan& pl,
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
      // three shapes (more instances, and ptxas serialized the wgmmas of
      // one kernel or another, PERF.md): a chunk of 80-112 rows on the
      // 128-row one, of 32-48 on the 64-row one, its extra accumulators
      // unused (its B rows past nw whatever the ring holds there)
      switch (nw) {
        case 128: chunk_units<128>(acc, r, L, A, enc, nw, lane); break;
        case 112: case 96: case 80:
          chunk_units<128>(acc, r, L, A, enc, nw, lane); break;
        case 64: case 48: case 32:
          chunk_units<64>(acc, r, L, A, enc, nw, lane); break;
        default: chunk_units<16>(acc, r, L, A, enc, nw, lane);
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
    // every wgmma that read hb is done (wait_group 0): the layer's
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

// ---------------------------------------------------------------------------
// the float32 chain of a net wider than 128 on the ring (V_WIDE32): 3xTF32
// on wgmma. Each k8 step of a chunk is three m64nNk8 tf32 products with A
// from registers, a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms first;
// the lo lo term dropped, as mma.sync's chain did): A, this warp's rows of
// the float32 activations (the encoding, or hb: row-major, each warp its
// 16 rows, as the chain before it kept them), read as float2 at columns 2t
// and 2t + 1 of the step (the unit's permuted k slots t and t + 4) and split
// in registers (split_tf32); B, the unit's hi and lo slabs from the ring.
// A group of F32_GROUP units (64 columns) goes into a fresh accumulator
// (its first product with D zeroed), then one float32 add into the
// chunk's (the tensor core truncates the sums it writes: summed into the
// chunk's accumulator itself, that error would be of its size at every
// product). Measured (PERF.md): 0.96-1.03x cuBLAS float32's error against
// float64; summed into the chunk's accumulator, 0.79x the time and up to
// 1.35x the error; a group of 16 columns 0.90-1.54x the time (ptxas
// serializes one kernel or the other). Each unit's products are one commit
// group, its stage released once they are done, by one predicated arrival
// a consumer warp.
// ---------------------------------------------------------------------------

// the stage of the ring r is at, as bytes
__device__ __forceinline__ const unsigned char* f32_unit(const Ring& r) {
  return reinterpret_cast<const unsigned char*>(r.w) + r.stage * F32_UNIT_B;
}

// The producer's part of one tile (V_WIDE32; one warp): every unit of the
// chain in the consumers' order, one bulk copy each (lane 0) from the split
// slab (net.w: two floats a weight, a layer's units from twice its w_off),
// into the next stage once every consumer warp has released it.
__device__ void ring_fill_tile_f32(const Net& net, Ring& r, int lane) {
  const unsigned char* w = reinterpret_cast<const unsigned char*>(net.w);
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const unsigned char* src = w + 8L * L.w_off;
    for (int n0 = 0; n0 < L.kout; n0 += CHUNK) {
      const uint32_t bytes = min(CHUNK, L.kout - n0) * F32_UNIT_K * 8;
      for (int k0 = 0; k0 < L.w_ld; k0 += F32_UNIT_K, src += bytes) {
        const uint32_t full = r.full();
        wg::mbar_wait(r.empty(r.stage), r.phase ^ 1u);
        if (lane == 0) {
          wg::mbar_expect_tx(full, bytes);
          wg::bulk_copy(wg::smem(f32_unit(r)), src, bytes, full);
        }
        __syncwarp();
        r.next();
      }
    }
  }
}

// The three products of one unit (a k8 step) of a chunk NW rows wide into
// f: B's hi slab at u, its lo slab nw * 32 B further; core matrices SBO =
// 128 B apart along N, the two k blocks LBO = nw * 16 B apart. FIRST: the
// group's first unit, whose first product zeroes f.
template <int NW, int FIRST>
__device__ __forceinline__ void unit_tf32(float (&f)[NA], const unsigned char* u,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], int nw) {
  const uint32_t lbo = (uint32_t)nw * 16;
  const uint64_t hi = wg::desc(u, lbo, 128);
  const uint64_t lo = wg::desc(u + nw * 32, lbo, 128);
  if constexpr (NW == 128) {
    wg::wgmma_tf32_n128<1 - FIRST>(f, al, hi);
    wg::wgmma_tf32_n128<1>(f, ah, lo);
    wg::wgmma_tf32_n128<1>(f, ah, hi);
  } else if constexpr (NW == 64) {
    wg::wgmma_tf32_n64<1 - FIRST>(f, al, hi);
    wg::wgmma_tf32_n64<1>(f, ah, lo);
    wg::wgmma_tf32_n64<1>(f, ah, hi);
  } else {
    wg::wgmma_tf32_n16<1 - FIRST>(f, al, hi);
    wg::wgmma_tf32_n16<1>(f, ah, lo);
    wg::wgmma_tf32_n16<1>(f, ah, hi);
  }
}

// This lane's A of a unit: rows g and g + 8 of the warp's 16, columns 2t
// and 2t + 1 of the unit's 8 (its k slots t and t + 4) at src, rows ld
// apart; a[0] its tf32 hi, a[1] the rest (split_tf32).
__device__ __forceinline__ void unit_a(const float* src, int ld,
                                       uint32_t (&a)[2][4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(src);
  const float2 r1 = *reinterpret_cast<const float2*>(src + 8 * ld);
  split_tf32(r0.x, a[0][0], a[1][0]);
  split_tf32(r1.x, a[0][1], a[1][1]);
  split_tf32(r0.y, a[0][2], a[1][2]);
  split_tf32(r1.y, a[0][3], a[1][3]);
}

// Waits for the ring's next unit, issues its three products into f (FIRST:
// f zeroed) and commits them as a group; -> the empty barrier of its stage,
// to release once they are done.
template <int NW, int FIRST>
__device__ __forceinline__ uint32_t unit_issue(float (&f)[NA], Ring& r,
                                               const uint32_t (&a)[2][4],
                                               int nw) {
  const uint32_t empty = r.empty(r.stage);
  const unsigned char* u = f32_unit(r);
  wg::mbar_wait(r.full(), r.phase);
  r.next();
  wg::fence();
  unit_tf32<NW, FIRST>(f, u, a[0], a[1], nw);
  wg::commit();
  return empty;
}

// One chunk's products, group by group in ascending k, into acc (zeroed by
// the caller): A of column k from the hidden activations (this lane's row
// g, column 2t of them at A, rows lda apart) below kin_h, from the encoding
// (e, lde) past it (the skip layer's columns). The units of a group are
// issued two by two, their A in two sets of registers x and y that
// alternate: a unit's products wait for its stage (A loaded before the
// wait), and once the next unit's are issued, wgmma.wait_group 1 says they
// are done: the stage is released and its A registers are free for the
// unit after next. The group's last products are waited on whole
// (wait_group 0), then f goes into acc. One wgmma shape and no branch among
// a chunk's products (a loop of the same shape, as the bf16 ring's).
template <int NW>
__device__ __forceinline__ void chunk_units_f32(float (&acc)[NA], Ring& r,
                                                const Layer& L, const float* A,
                                                int lda, const float* e,
                                                int lde, int nw, int lane) {
  float f[NA];
  uint32_t x[2][4], y[2][4];
  const int kin_h = L.kin_h;
  auto src = [&](int k) { return k < kin_h ? A + k : e + (k - kin_h); };
  auto ld = [&](int k) { return k < kin_h ? lda : lde; };
  for (int g0 = 0; g0 < L.w_ld; g0 += F32_GROUP * F32_UNIT_K) {
    const int g1 = min(g0 + F32_GROUP * F32_UNIT_K, L.w_ld);
    unit_a(src(g0), ld(g0), x);
    uint32_t ex = unit_issue<NW, 1>(f, r, x, nw);
    unit_a(src(g0 + F32_UNIT_K), ld(g0 + F32_UNIT_K), y);
    uint32_t ey = unit_issue<NW, 0>(f, r, y, nw);
    wg::wait<1>();
    wg::keep(x);
    wg::mbar_arrive_if(ex, lane == 0);
    for (int k = g0 + 2 * F32_UNIT_K; k < g1; k += 2 * F32_UNIT_K) {
      unit_a(src(k), ld(k), x);
      ex = unit_issue<NW, 0>(f, r, x, nw);
      wg::wait<1>();
      wg::keep(y);
      wg::mbar_arrive_if(ey, lane == 0);
      unit_a(src(k + F32_UNIT_K), ld(k + F32_UNIT_K), y);
      ey = unit_issue<NW, 0>(f, r, y, nw);
      wg::wait<1>();
      wg::keep(x);
      wg::mbar_arrive_if(ex, lane == 0);
    }
    wg::wait<0>();
    wg::keep(f);
    wg::keep(y);
    wg::mbar_arrive_if(ey, lane == 0);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] += f[i];
  }
}

// float32 on the ring: each warp its 16 rows of hb, row-major [64][ldh] as
// the float32 encoding; each layer in chunks of at most CHUNK outputs, each
// chunk's products chunk_units_f32 (one instance a wgmma shape, the bf16
// ring's shapes). Every chunk of a layer but the
// last is parked in device memory (slot c of the warpgroup's park slot,
// Plan.park_chunks = chunks - 1), not held in registers: beside a chunk's
// accumulators and the group's fresh ones, 64 more held ones spilled in
// the group loop (PERF.md).
__device__ void chain_wide(const Net& net, Ring& r, const Plan& pl,
                           const float* enc, float* hb, float (&acc)[NA],
                           const float* sig, float* outb, int ldo, int warp,
                           int lane, uint32_t* park) {
  const int lde = pl.lde, ldh = pl.ldh;
  const int g = lane >> 2, t = lane & 3;
  const float* e = enc + (16 * warp + g) * lde + 2 * t;
  float* h = hb + (16 * warp + g) * ldh + 2 * t;
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const bool last = l == net.n_layers - 1;
    const int nch = (L.kout + CHUNK - 1) / CHUNK;
    const float* A = l == 0 ? e : h;
    const int lda = l == 0 ? lde : ldh;
    for (int c = 0; c < nch; ++c) {
      const int n0 = CHUNK * c, nw = min(CHUNK, L.kout - n0);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
      switch (nw) {
        case 128: case 112: case 96: case 80:
          chunk_units_f32<128>(acc, r, L, A, lda, e, lde, nw, lane); break;
        case 64: case 48: case 32:
          chunk_units_f32<64>(acc, r, L, A, lda, e, lde, nw, lane); break;
        default: chunk_units_f32<16>(acc, r, L, A, lda, e, lde, nw, lane);
      }
      if (net.bias) add_bias(acc, net.bias + l * BIAS_LD + n0, nw, lane);
      if (last) {
        store_last(acc, nw, c == 0 ? sig : nullptr, outb + n0, ldo, warp,
                   lane);
      } else if (c + 1 < nch) {
        uint32_t v[NA];
#pragma unroll
        for (int i = 0; i < NA; ++i)
          v[i] = __float_as_uint(act(acc[i], net.leaky));
        park_put<NA>(park, pl, c, v);
      }
    }
    if (last) break;
    __syncwarp();  // the warp's reads of its rows of hb are done
    const int nt_last = MAX_NT * (nch - 1);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = act(acc[i], net.leaky);
    put_rows_f32(h, ldh, acc, nt_last, L.kout / 8 - nt_last);
    for (int c = 0; c + 1 < nch; ++c) {
      uint32_t v[NA];
      park_get<NA>(park, pl, c, v);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = __uint_as_float(v[i]);
      put_rows_f32(h, ldh, acc, MAX_NT * c, MAX_NT);
    }
    __syncwarp();
  }
}

struct Bufs {
  void *enc, *hb;
  float *outb, *sig, *wts, *tsb, *vin;
};

// The warpgroups of a block after its consumers in a kernel of variant V:
// V_GRID's encoders, a V_WIDE or V_WIDE32 ring's producer
template <int V>
__host__ __device__ __forceinline__ int aux_wgs(const Plan& pl) {
  return V == V_GRID ? GRID_ENC_WGS : pl.w_mode == W_RING ? 1 : 0;
}

// The block's consumer warpgroups: the launch may take fewer than pl.wgs
// (launch_size), and the aux warpgroups come after them. V_GRID reads its
// aux warpgroups from the plan's variant, and its composite computes np
// before the ring: so ptxas does not serialize the V_GRID composites'
// wgmmas; with np where the other variants compute it, it did (C7511),
// whether the count here was read from the plan or a constant (PERF.md).
template <int V>
__device__ __forceinline__ int block_wgs(const Plan& pl) {
  return (blockDim.x >> 7) -
         (V == V_GRID ? (pl.variant == V_GRID ? GRID_ENC_WGS
                         : pl.w_mode == W_RING ? 1 : 0)
                      : aux_wgs<V>(pl));
}

// The encoding slots of a V_GRID block (Plan.slots): consumer c of the
// block's C takes the tiles its tile calls encode, call n the block's
// (n C + c)-th, in slot (n C + c) % slots, its use (n C + c) / slots; the
// encoder warps fill the same sequence. With slots a multiple of C every
// use of a slot is one consumer's, which so waits on every phase of the
// slot's full barrier in turn (a parity wait is then exact); an encoder
// warp writes a use of a slot whose previous uses other warps wrote, so it
// waits on the slot's release count instead (4 a use: the consumer's
// warps), not on a parity (one that ran two uses ahead would pass it).
struct Slots {
  unsigned char* base;  // slot 0
  uint32_t bars;        // the full barrier of slot 0; release counts after
  int n, slot_b, sig_off, step;  // slots, bytes a slot, consumers a block
  int slot;             // a consumer's next slot, and its parity
  uint32_t phase;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t released(int s) const {
    return bars + 8 * MAX_SLOTS + 4 * s;
  }
  __device__ __forceinline__ bf16* enc(int s) const {
    return reinterpret_cast<bf16*>(base + (long)s * slot_b);
  }
  __device__ __forceinline__ float* sig(int s) const {
    return reinterpret_cast<float*>(base + (long)s * slot_b + sig_off);
  }
  // the consumer's next slot (step <= n: at most one wrap), no branch
  __device__ __forceinline__ void next() {
    const int s = slot + step, wrap = s >= n;
    phase ^= (uint32_t)wrap;
    slot = wrap ? s - n : s;
  }
};

// the slots of a V_GRID block, after its weights and view head
__device__ __forceinline__ Slots slots_at(unsigned char* smem, const Plan& pl,
                                          int consumers, int c) {
  unsigned char* base = smem + pl.w_bytes + pl.v_bytes;
  return Slots{base, wg::smem(base + (long)pl.slots * pl.slot_b), pl.slots,
               pl.slot_b, pl.enc_b, consumers, pl.slots ? c % pl.slots : 0,
               0u};
}

// Stages the weights (and the view head's) in shared memory as the plan
// says, or sets up the ring's barriers (W_RING: an empty barrier takes an
// arrival from each consumer warp, all but the producer's) and V_GRID's
// encoding slots, and carves out this warpgroup's buffers; -> the chain's
// weights.
template <typename T, int V>
__device__ const T* block_setup(const Net& net, const View* view,
                                const Plan& pl, unsigned char* smem,
                                const T** vw, Bufs& b) {
  const T* W = reinterpret_cast<const T*>(net.w);
  if (pl.w_mode != W_GLOBAL) W = reinterpret_cast<const T*>(smem);
  if (pl.w_mode == W_ALL) block_copy(smem, net.w, pl.w_bytes);
  if (pl.w_mode == W_RING) {
    const Ring r = ring_at<V>(smem, pl);
    const bool zero = pl.w_bytes > pl.stages * unit_bytes<V>() + RING_BAR_B;
    for (int i = threadIdx.x; zero && i < ZERO_B / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(const_cast<bf16*>(r.zero))[i] =
          make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < pl.stages; ++s) {
        wg::mbar_init(r.bars + 8 * s, 1);
        wg::mbar_init(r.empty(s), block_wgs<V>(pl) * 4);
      }
      wg::mbar_init_fence();
    }
  }
  unsigned char* base = smem + pl.w_bytes;
  if (view) {
    *vw = reinterpret_cast<const T*>(view->w);
    if (pl.v_bytes) {
      block_copy(base, view->w, pl.v_bytes);
      *vw = reinterpret_cast<const T*>(base);
    }
  }
  constexpr bool grid = V == V_GRID;
  if constexpr (grid) {
    // the slots zeroed once (the encoding's padding columns stay zero, and
    // visible to wgmma), their barriers set up
    const Slots sl = slots_at(smem, pl, 1, 0);
    for (int i = threadIdx.x; i < pl.slots * pl.slot_b / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(sl.base)[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < pl.slots; ++s) {
        wg::mbar_init(sl.full(s), ENC_ARRIVALS);
        *reinterpret_cast<uint32_t*>(sl.base + (long)pl.slots * pl.slot_b +
                                     8 * MAX_SLOTS + 4 * s) = 0u;
      }
      wg::mbar_init_fence();
    }
  }
  // V_GRID: the slots and their barriers after the view head, and no
  // encoding nor sigma sums of a warpgroup's own (the slots')
  const int slots_b = grid ? pl.slots * pl.slot_b + SLOT_BAR_B : 0;
  base += pl.v_bytes + slots_b + (threadIdx.x >> 7) * pl.per_wg;
  b.enc = base;
  base += grid ? 0 : pl.enc_b;
  b.hb = base;
  base += pl.h_b;
  b.outb = reinterpret_cast<float*>(base);
  base += pl.out_b;
  b.sig = reinterpret_cast<float*>(base);
  base += grid ? 0 : pl.sig_b;
  b.wts = reinterpret_cast<float*>(base);
  base += pl.wts_b;
  b.tsb = reinterpret_cast<float*>(base);
  base += pl.ts_b;
  b.vin = reinterpret_cast<float*>(base);
  // zero the encoding buffer once: its padding columns stay zero (a
  // warpgroup's; the ring's producer warp has none)
  T* enc = reinterpret_cast<T*>(b.enc);
  if (!grid && (threadIdx.x >> 7) < block_wgs<V>(pl))
    for (int i = threadIdx.x & 127; i < TILE * pl.lde; i += 128)
      enc[i] = fromf<T>(0.0f);
  __syncthreads();
  return W;
}

// Encode + chain of a 64-point tile, this thread's point (row lt / 2)
// at x; the last layer lands in outb rows [0, 64) (each warp its 16).
// V_GRID: the chain of the consumer's next slot, which the encoder warps
// fill (x unused), released once its products and sigma sums are read.
template <typename T, int V>
__device__ __forceinline__ void tile(const Net& net, const Plan& pl,
                                     const T* W, const Bufs& b,
                                     const float (&x)[3], float* outb,
                                     int ncols, uint32_t* park, Ring& ring,
                                     Slots& sl) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  static_assert(V != V_WIDE || sizeof(T) == 2,
                "V_WIDE is bf16 only; float32 nets that wide are V_WIDE32");
  if constexpr (V == V_GRID) {
    float acc[NA];
    wg::mbar_wait(sl.full(sl.slot), sl.phase);
    chain_wide(net, ring, pl, sl.enc(sl.slot), reinterpret_cast<bf16*>(b.hb),
               acc, has_sigma(net) ? sl.sig(sl.slot) : nullptr, outb, pl.ldo,
               warp, lane, park);
    __syncwarp();
    wg::count_add_if(sl.released(sl.slot), lane == 0);
    sl.next();
    __syncwarp();
    return;
  }
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
  if constexpr (ring_of<T>(V)) {
    chain_wide(net, ring, pl, enc, reinterpret_cast<T*>(b.hb), acc,
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

// The ring's producer warpgroup (bf16 V_WIDE, V_WIDE32): it gives back
// registers for the consumers, and its first warp fills the ring for
// `tiles` tile calls of the block's warpgroups.
template <int V>
__device__ __forceinline__ void produce(const Net& net, Ring& r, long tiles) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
  if ((threadIdx.x & 127) >= 32) return;
  for (long i = 0; i < tiles; ++i) {
    if constexpr (V == V_WIDE32)
      ring_fill_tile_f32(net, r, threadIdx.x & 31);
    else
      ring_fill_tile(net, r, threadIdx.x & 31);
  }
}

// a consumer warpgroup of a ring kernel takes the registers the producer
// (V_GRID: the encoders) gave back
template <int V, bool GEN = false>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      V == V_WIDE32 ? F32_RING_REGS
      : V != V_GRID ? RING_REGS
      : GEN         ? GRID_GEN_REGS
                    : GRID_REGS));
}

// The tile calls of a block's consumers (V_GRID), as the kernels' loops
// make them: work items (run_tmlp's tiles, the composite's steps) first,
// first + apart, ... below `items`, consumer c taking item + c of each;
// `calls` tile calls an item (the composite's nseg segments of mt tiles of
// a step's M points, of which the first RT are its rays'); past them the
// points are np (zeros).
struct Walk {
  long first, apart, items, np;
  int calls, mt, M, RT;
  __device__ __forceinline__ long passes() const {
    return first < items ? (items - first + apart - 1) / apart : 0;
  }
  // the point of row `row` of consumer c's tile call n
  __device__ __forceinline__ long point(int c, long n, int row) const {
    const long item = first + (n / calls) * apart + c;
    const int rem = (int)(n % calls), k = rem / mt;
    const int i = k * M + (rem - k * mt) * TILE + row;
    return i < RT ? item * RT + i : np;
  }
};

// The encoder warpgroups of a V_GRID block. They give registers back for
// the consumers; their last warp fills the weight ring for every tile call
// of the block's consumers (as V_WIDE's producer); the others encode the
// tiles those calls take, in their order (Slots): task t is rows [16 r,
// 16 r + 16) of tile q = t / 4, r = t % 4 (a thread pair a point, as
// encode_point splits it), warp w taking tasks w, w + NE, ...; each waits
// until the slot's previous uses are released (its release count), writes
// the rows' encoding in the core-matrix layout wgmma reads A from and
// their sigma sums, makes them visible to the async proxy and arrives (all
// 32 lanes) on the slot's full barrier. Each lane loads the point of its
// next task while it encodes this one. No deadlock with slots >= the
// block's consumers: a task waits only on tiles before its own, which
// earlier tasks encode.
template <int REGS>
__device__ void grid_encode(const Net& net, const Slots& sl, Ring& ring,
                            const Walk& wk, const float* __restrict__ x3,
                            int consumers) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
  constexpr int NE = 4 * GRID_ENC_WGS - 1;  // encoder warps
  const int ew = (threadIdx.x >> 5) - 4 * consumers, lane = threadIdx.x & 31;
  const long calls = wk.passes() * wk.calls;
  if (ew == NE) {
    for (long i = 0; i < calls; ++i) ring_fill_tile(net, ring, lane);
    return;
  }
  const long tasks = calls * consumers * 4;
  const int half = lane & 1, hrow = lane >> 1;
  auto point = [&](long t) {
    const long q = t >> 2;
    return t < tasks ? wk.point((int)(q % consumers), q / consumers,
                                16 * (int)(t & 3) + hrow)
                     : wk.np;
  };
  float x[3];
  load_point(x3, wk.np, point(ew), x);
  for (long t = ew; t < tasks; t += NE) {
    float xn[3];
    load_point(x3, wk.np, point(t + NE), xn);
    const long q = t >> 2;
    const int s = (int)(q % sl.n), row = 16 * (int)(t & 3) + hrow;
    wg::count_wait(sl.released(s), 4u * (uint32_t)(q / sl.n));
    bf16* enc = sl.enc(s);
    const float sg = encode_point<bf16, true>(
        net, x, half,
        [&](int c, float v) { enc[enc_index<bf16>(row, c, 0)] = fromf<bf16>(v); });
    if (!half) sl.sig(s)[row] = sg;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg::mbar_arrive_if(sl.full(s), true);
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = xn[a];
  }
}

// The block's warpgroups walk the work items in step, items base + wg (so
// that a streamed layer's __syncthreads meets every thread, and every
// warpgroup consumes every unit of the ring, padding tiles included).
template <typename T, int V>
__global__ void __launch_bounds__(threads_of<T>(false, V), 1)
tmlp_kernel(Net net, Plan pl, const float* __restrict__ x3, long np,
            float* __restrict__ out, int out_rows, uint32_t* park) {
  extern __shared__ __align__(128) unsigned char smem[];
  Bufs b;
  const T* W = block_setup<T, V>(net, nullptr, pl, smem, nullptr, b);
  const int wgs = block_wgs<V>(pl);
  const long n_tiles = (np + TILE - 1) / TILE;
  Ring ring = ring_at<V>(smem, pl);
  // V_GRID: the slot sequence (a consumer's; the encoders' walk it whole)
  Slots sl =
      V == V_GRID ? slots_at(smem, pl, wgs, threadIdx.x >> 7) : Slots{};
  if constexpr (V == V_GRID) {
    if ((threadIdx.x >> 7) >= wgs) {
      grid_encode<GRID_ENC_REGS>(net, sl, ring,
                  Walk{(long)blockIdx.x * wgs, (long)gridDim.x * wgs, n_tiles,
                       np, 1, 1, TILE, TILE},
                  x3, wgs);
      return;
    }
    consumer_regs<V>();
  } else if constexpr (ring_of<T>(V)) {
    if ((threadIdx.x >> 7) == wgs) {
      const long apart = (long)gridDim.x * wgs, first = (long)blockIdx.x * wgs;
      produce<V>(net, ring, first < n_tiles ? (n_tiles - first + apart - 1) /
                                                  apart : 0);
      return;
    }
    consumer_regs<V>();
  }
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int kout = net.layer[net.n_layers - 1].kout;
  const long stride = (long)gridDim.x * wgs * TILE;
  const int row = (threadIdx.x & 127) >> 1;
  float x[3];
  load_point(x3, np, ((long)blockIdx.x * wgs + (threadIdx.x >> 7)) * TILE
                         + row, x);
  for (long base = (long)blockIdx.x * wgs; base < n_tiles;
       base += (long)gridDim.x * wgs) {
    const long p0 = (base + (threadIdx.x >> 7)) * TILE;
    float xn[3];
    load_point(x3, np, p0 + stride + row, xn);
    tile<T, V>(net, pl, W, b, x, b.outb, kout, park, ring, sl);
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

// ---------------------------------------------------------------------------
// the proposal nets past small_kernel: bf16, ReLU, no tables, no bias,
// angle doubling, an encoding of at most PROP_K and every layer at most
// PROP_N wide, any depth whose weights fit in shared memory beside the
// warps' buffers (ModelConfig's default w64 d4 over 33 Fourier features, which
// every grid configuration and the students of distill_serving keep).
// Replaces the same TPU kernel as tmlp_kernel for these nets
// (sanerf_tpu/ops/fused_mlp_t.py:1077 _run_tmlp, body _encode_and_chain
// :549), which ran them at 6 % of their bound on the card (PERF.md §6).
// Bound: operations, 10,368 MAC a point (33 -> 64, 64 -> 64 twice, 64 -> 1)
// at 989 TFLOP/s, 0.176 ms for the 8.39 M points of a 512^2 frame at
// (32, 16); the bytes (12 B in, 4 B out a point) take 0.040 ms.
// tmlp_kernel ran them at 2.85 ms there, 2.1 ms of it the chain: a row of
// four m64n16 wgmmas a k step, each layer waited on, 3 warpgroups an SM
// (PERF.md; port_tools/prop_variants.py).
// Design: each warp carries PROP_PTS points (PROP_MT m16 tiles, a lane a
// point) through the whole chain alone, with mma.sync.m16n8k16: no
// block-wide sync after the weights are staged, and PROP_WARPS independent
// warps an SM (one block: 161 registers a thread, no spill; 16 warps at 128
// registers spill), so that one warp's encode (the SFU and the ALUs) runs
// beside other warps' products (the tensor cores). The weights are staged
// once a block with cp.async, in the core-matrix slabs the wgmma kernels
// read (each 8 x 8 core matrix 128 contiguous bytes), and read as B
// fragments by ldmatrix.x4 without bank conflicts, each fragment feeding
// both m-tiles of the warp. Each lane encodes its point (the arithmetic of
// encode_point, the frequencies a template argument so every column lands
// in a register known at compile time) into the warp's buffer, 8 columns a
// 16-byte store, rows ke + 8 wide (16 B times an odd number: no conflict
// for the stores nor for ldmatrix's reads of layer 0's A fragments). The
// default net's layers are straight-line code (a k step's B fragments all
// loaded before its products, the first k step's products into zero
// accumulators); layer l's accumulators, activated and rounded to bf16 in
// one instruction a pair, are layer l + 1's A fragments in registers. The
// last layer's rows go out from registers, the warp's points shuffled into
// lane order, one coalesced store a row. K is padded to the instruction's
// 16 (33 -> 48), the last layer's outputs to its n8 (1 -> 8). What binds
// it now is the chain: at (32, 16) the kernel takes 0.57 ms, without its
// encode 0.45, without its chain 0.12, with half its products 0.43, so
// the products are about two thirds of the chain and the activations and
// B loads between them the rest (PERF.md; port_tools/prop_variants.py).
// ---------------------------------------------------------------------------

constexpr int PROP_K = 64, PROP_N = 64;  // ops/fused_mlp_t.py: PROP_K, PROP_N
constexpr int PROP_MT = 2, PROP_PTS = 16 * PROP_MT;
// warps a block (ops/fused_mlp_t.py: PROP_WARPS) and blocks an SM
constexpr int PROP_WARPS = 12, PROP_BLOCKS = 1;
constexpr int PROP_MAXF = (PROP_K / 3 - 1) / 2;  // frequencies: F <= PROP_K

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Point x's Fourier features by angle doubling into its row of the tile
// buffer in the tight column order (z_d; per frequency s_d, c_d), the
// columns from F to the 16-padded width zero: the base frequency's sines
// and cosines once, then the doubling recurrence with NF, the frequencies,
// a template argument, so that every column lands in a register known at
// compile time and 8 go out in one 16-byte store. The arithmetic of
// encode_point.
template <int NF>
__device__ __forceinline__ void prop_encode(const float (&z)[3], float (&s)[3],
                                            float (&c)[3], bf16* row) {
  constexpr int F = 3 * (1 + 2 * NF), KE = (F + 15) / 16 * 16;
  float v[KE];
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = z[d];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (f) {
        const float s2 = 2.0f * s[d] * c[d];
        const float c2 = c[d] * c[d] - s[d] * s[d];
        s[d] = s2;
        c[d] = c2;
      }
      v[3 + 6 * f + d] = s[d];
      v[6 + 6 * f + d] = c[d];
    }
  }
#pragma unroll
  for (int k = F; k < KE; ++k) v[k] = 0.0f;
  uint4* dst = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int k = 0; k < KE / 8; ++k)
    dst[k] = make_uint4(pack_bf16(v[8 * k], v[8 * k + 1]),
                        pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                        pack_bf16(v[8 * k + 4], v[8 * k + 5]),
                        pack_bf16(v[8 * k + 6], v[8 * k + 7]));
}

template <int NF = 0>
__device__ __forceinline__ void prop_encode_nf(int nf, const float (&z)[3],
                                               float (&s)[3], float (&c)[3],
                                               bf16* row) {
  if constexpr (NF <= PROP_MAXF) {
    if (nf == NF) {
      prop_encode<NF>(z, s, c, row);
      return;
    }
    prop_encode_nf<NF + 1>(nf, z, s, c, row);
  }
}

__device__ __forceinline__ void prop_encode_of(int nf, float scale,
                                               const float (&x)[3],
                                               bf16* row) {
  float z[3], s[3], c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    z[d] = x[d] * scale;
    s[d] = sinf(z[d]);
    c[d] = sinf(z[d] + HALF_PI);
  }
  prop_encode_nf(nf, z, s, c, row);
}

bool prop_net(const Net& net) {
  if (net.g.n_cp || net.g.n_vm || net.g.n_cp_more || net.g.n_vm_more ||
      has_sigma(net) || net.bias || !net.angle_double || net.leaky)
    return false;
  if (net.enc_freqs < 0 || net.enc_freqs > PROP_MAXF ||
      net.F != 3 * (1 + 2 * net.enc_freqs) || net.ke != align16(net.F) ||
      net.ke > PROP_K)
    return false;
  int kin = net.ke;
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer& L = net.layer[l];
    if (L.kin_h != kin || L.kin_e || L.kout > PROP_N || L.kout % 16 ||
        L.kout_real < 1 || L.kout_real > L.kout)
      return false;
    kin = L.kout;
  }
  return true;
}

// c = A * B, the products of mma_bf16 into a zero accumulator (the first k
// step of a layer: no instruction to zero it)
__device__ __forceinline__ void mma_bf16_z(float (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// The accumulators of a layer, activated and rounded to bf16
// (fused_mlp_t.py:616), as the next layer's A fragments: n-tiles 2s and
// 2s + 1 are its k step s. ReLU rounds and clamps in one instruction
// (cvt.rn.relu: the rounding keeps the sign, so clamping after it is
// clamping before).
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void prop_act(
    const float (&acc)[PROP_MT][PROP_N / 8][4],
    uint32_t (&hA)[PROP_MT][PROP_N / 16][4], int ks) {
#pragma unroll
  for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
    for (int s = 0; s < PROP_N / 16; ++s)
      if (s < ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* c = acc[i][2 * s + (j >> 1)] + 2 * (j & 1);
          hA[i][s][j] = pack_relu_bf16(c[0], c[1]);
        }
}

// One layer of the warp's tile: acc[i][nt] = A (m-tile i) W^T over KS k
// steps of 16 and NT n-tiles of 8, A from the tile buffer (BUF: ldmatrix.x4
// of rows 16 i + (lane & 15), columns 16 s + 8 (lane >> 4), as mma's
// fragment) or from hA, the B fragments of two n-tiles by one ldmatrix.x4
// (core matrices (2s, n) and (2s + 1, n) of the pair), every B fragment of
// a k step loaded before its products. EXACT: KS and NT are the layer's, so
// the layer is one block of straight-line code that the compiler schedules
// as a whole; else they are the most a layer has and ks, nt_n bound it.
template <int KS, int NT, bool BUF, bool EXACT>
__device__ __forceinline__ void prop_layer(
    float (&acc)[PROP_MT][PROP_N / 8][4],
    const uint32_t (&hA)[PROP_MT][PROP_N / 16][4], const bf16* buf, int lde,
    const bf16* Wl, int kout, int ks, int nt_n, int lane) {
  constexpr int NP = (NT + 1) / 2;
  const int q = lane >> 3;
  const bf16* w = Wl + ((q & 1) * (kout >> 3) + (q >> 1)) * 64 + (lane & 7) * 8;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (!EXACT && s >= ks) break;
    uint32_t a[PROP_MT][4];
#pragma unroll
    for (int i = 0; i < PROP_MT; ++i) {
      if constexpr (BUF) {
        ldsm_x4(a[i], buf + (16 * i + (lane & 15)) * lde + 16 * s +
                          8 * (lane >> 4));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = hA[i][s][j];
      }
    }
    uint32_t b[NP][4];
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
      if (EXACT || 2 * jp < nt_n)
        ldsm_x4(b[jp], w + (2 * s * (kout >> 3) + 2 * jp) * 64);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
#pragma unroll
      for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * jp + h;
          if (nt >= NT || (!EXACT && nt >= nt_n)) continue;
          if (s == 0)
            mma_bf16_z(acc[i][nt], a[i], b[jp][2 * h], b[jp][2 * h + 1]);
          else
            mma_bf16(acc[i][nt], a[i], b[jp][2 * h], b[jp][2 * h + 1]);
        }
  }
}

__global__ void __launch_bounds__(PROP_WARPS * 32, PROP_BLOCKS)
prop_kernel(Net net, Plan pl, const float* __restrict__ x3, long np,
            float* __restrict__ out, int out_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* W = reinterpret_cast<const bf16*>(smem);
  bf16* buf = reinterpret_cast<bf16*>(smem + pl.w_bytes + warp * pl.enc_b);
  block_copy_async(smem, net.w, pl.w_bytes);
  const int last = net.n_layers - 1;
  const long n_tiles = (np + PROP_PTS - 1) / PROP_PTS;
  const long step = (long)gridDim.x * PROP_WARPS;
  long tile = (long)blockIdx.x * PROP_WARPS + warp;
  float x[3];
  load_point(x3, np, tile * PROP_PTS + lane, x);
  for (; tile < n_tiles; tile += step) {
    const long p0 = tile * PROP_PTS;
    float xn[3];
    load_point(x3, np, p0 + step * PROP_PTS + lane, xn);
    __syncwarp();  // the last tile's layer 0 has read the buffer
    prop_encode_of(net.enc_freqs, net.enc_scale, x, buf + lane * pl.lde);
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = xn[a];
    __syncwarp();
    // a layer writes the n-tiles it computes (its first k step's products
    // into zero accumulators), and reads no other
    float acc[PROP_MT][PROP_N / 8][4];
    uint32_t hA[PROP_MT][PROP_N / 16][4];
    for (int l = 0; l <= last; ++l) {
      const Layer L = net.layer[l];
      const bf16* Wl = W + L.w_off;
      const int ks = L.kin_h >> 4;
      // the last layer: only the n8 tiles of its real outputs
      const int nt_n = l == last ? (L.kout_real + 7) >> 3 : L.kout >> 3;
      // straight-line code for the default net's layers (33 -> 64, 64 -> 64,
      // 64 -> 1), a loop with bounds for any other
      if (l == 0 && nt_n == PROP_N / 8 && ks == 3) {
        prop_layer<3, PROP_N / 8, true, true>(acc, hA, buf, pl.lde, Wl,
                                              L.kout, ks, nt_n, lane);
      } else if (l == 0) {
        prop_layer<PROP_K / 16, PROP_N / 8, true, false>(
            acc, hA, buf, pl.lde, Wl, L.kout, ks, nt_n, lane);
      } else if (ks == PROP_N / 16 && nt_n == PROP_N / 8) {
        prop_layer<PROP_N / 16, PROP_N / 8, false, true>(
            acc, hA, buf, pl.lde, Wl, L.kout, ks, nt_n, lane);
      } else if (ks == PROP_N / 16 && nt_n == 1) {
        prop_layer<PROP_N / 16, 1, false, true>(acc, hA, buf, pl.lde, Wl,
                                                L.kout, ks, nt_n, lane);
      } else {
        prop_layer<PROP_N / 16, PROP_N / 8, false, false>(
            acc, hA, buf, pl.lde, Wl, L.kout, ks, nt_n, lane);
      }
      if (l < last) prop_act(acc, hA, L.kout >> 4);
    }
    // output row r: point lane (m-tile lane >> 4, row lane & 15 = g + 8 h)
    // sits in lane 4 g + (r & 7) / 2 of the fragment, acc[i][r / 8][2 h +
    // r % 2]; every (i, h) shuffled in turn, the lane keeps its own
    const int gl = lane & 7, hl = (lane >> 3) & 1, il = lane >> 4;
    for (int r = 0; r < out_rows; ++r) {
      const int nt = r >> 3, odd = r & 1, src = 4 * gl + ((r & 7) >> 1);
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mine = 0.0f;
#pragma unroll
          for (int n = 0; n < PROP_N / 8; ++n)
            if (n == nt) mine = odd ? acc[i][n][2 * h + 1] : acc[i][n][2 * h];
          const float got = __shfl_sync(FULL, mine, src);
          if (i == il && h == hl) v = got;
        }
      if (p0 + lane < np) out[(long)r * np + p0 + lane] = v;
    }
  }
}

// SH component k (0-15) of the unit direction (x, y, z), without a
// branch: every component computed and k's selected, so that a warp's
// lanes 0-15 take no divergent paths (a switch over k cost the asset's
// composite 3 %; in V_GRID's general composite, with the direction loaded
// where it is used, ptxas serialized the wgmmas, C7511; PERF.md)
__device__ __forceinline__ float sh_component(int k, float x, float y,
                                              float z) {
  const float xy = x * y, xz = x * z, yz = y * z;
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  float v = 0.59004358992664352f * x * (-x2 + 3.0f * y2);
  v = k == 0 ? 0.28209479177387814f : v;
  v = k == 1 ? -0.48860251190291987f * y : v;
  v = k == 2 ? 0.48860251190291987f * z : v;
  v = k == 3 ? -0.48860251190291987f * x : v;
  v = k == 4 ? 1.0925484305920792f * xy : v;
  v = k == 5 ? -1.0925484305920792f * yz : v;
  v = k == 6 ? 0.94617469575755997f * z2 - 0.31539156525251999f : v;
  v = k == 7 ? -1.0925484305920792f * xz : v;
  v = k == 8 ? 0.54627421529603959f * x2 - 0.54627421529603959f * y2 : v;
  v = k == 9 ? 0.59004358992664352f * y * (-3.0f * x2 + y2) : v;
  v = k == 10 ? 2.8906114426405538f * xy * z : v;
  v = k == 11 ? 0.45704579946446572f * y * (1.0f - 5.0f * z2) : v;
  v = k == 12 ? 0.3731763325901154f * z * (5.0f * z2 - 3.0f) : v;
  v = k == 13 ? 0.45704579946446572f * x * (1.0f - 5.0f * z2) : v;
  v = k == 14 ? 1.4453057213202769f * z * (x2 - y2) : v;
  return v;
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
// units lane + 32 q), and the V_WIDE nets' parked chunks (V_WIDE32 parks
// in both).
template <typename T, int V, bool GEN>
__global__ void __launch_bounds__(threads_of<T>(true, V), 1)
composite_kernel(Net net, View view, Plan pl, const float* __restrict__ x3,
                 const float* __restrict__ dl, const float* __restrict__ ts,
                 const float* __restrict__ rays8, int N, int Ts, int pack_q,
                 int opaque, float* __restrict__ gsum,
                 float* __restrict__ depth, float* __restrict__ wsum,
                 float* __restrict__ rgb, uint32_t* park) {
  extern __shared__ __align__(128) unsigned char smem[];
  Bufs b;
  const T* VW = nullptr;
  const T* W = block_setup<T, V>(net, view.H ? &view : nullptr, pl, smem,
                                 &VW, b);
  const int wgs = block_wgs<V>(pl);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x & 127) >> 5,
            lane = threadIdx.x & 31;
  // the segments of a step
  const int nseg = GEN ? pl.nseg : 1;
  const int M = pl.M, rays_per_step = pl.R, RT = pl.R * Ts;
  const long n_steps = ((long)N + rays_per_step - 1) / rays_per_step;
  const long steps_apart = (long)gridDim.x * wgs;  // a warpgroup's steps
  const long np_grid = (long)N * Ts;  // V_GRID's np (see block_wgs)
  Ring ring = ring_at<V>(smem, pl);
  Slots sl = V == V_GRID ? slots_at(smem, pl, wgs, wg) : Slots{};
  if constexpr (V == V_GRID) {
    if (wg >= wgs) {
      grid_encode<GEN ? GRID_GEN_ENC_REGS : GRID_ENC_REGS>(
          net, sl, ring,
          Walk{(long)blockIdx.x * wgs, steps_apart, n_steps, np_grid,
               nseg * (M / TILE), M / TILE, M, RT},
          x3, wgs);
      return;
    }
    consumer_regs<V, GEN>();
  } else if constexpr (ring_of<T>(V)) {
    if (wg == wgs) {  // a step's tiles: nseg segments of M / TILE
      const long first = (long)blockIdx.x * wgs;
      produce<V>(net, ring, (first < n_steps ? (n_steps - first + steps_apart
                                                - 1) / steps_apart : 0) *
                                nseg * (M / TILE));
      return;
    }
    consumer_regs<V>();
  }
  const int G = net.layer[net.n_layers - 1].kout_real;  // gsum columns
  // the tiles' output columns
  const int kout = GEN ? net.layer[net.n_layers - 1].kout : 16;
  const long np = V == V_GRID ? np_grid : (long)N * Ts;
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
  const int row = (threadIdx.x & 127) >> 1;
  // point `local` of segment k of step s: np (zeros) past the step's rays
  auto point = [&](long s, int k, int local) {
    const int i = k * M + local;
    return i < RT ? s * RT + i : np;
  };
  float x[3];
  load_point(x3, np, point((long)blockIdx.x * wgs + wg, 0, row), x);
  for (long base = (long)blockIdx.x * wgs; base < n_steps;
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
                   GEN || V == V_WIDE32 ? park : nullptr, ring, sl);
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
        // the ray's direction, loaded first (see sh_component)
        float pdir[3] = {0.0f, 0.0f, 0.0f};
        if (H)
#pragma unroll
          for (int c = 0; c < 3; ++c) pdir[c] = rays8[n * 8 + 3 + c];
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
          const float dx = pdir[0], dy = pdir[1], dz = pdir[2];
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

// the plan of prop_kernel: the weights whole, then each warp's buffer of
// PROP_PTS rows of ke + 8 columns
bool prop_plan_ok(const Net& net, const Plan& pl) {
  return pl.lde == net.ke + 8 && pl.enc_b == PROP_PTS * pl.lde * 2 &&
         pl.w_bytes == align16(net.w_elems * 2) &&
         pl.total == pl.w_bytes + PROP_WARPS * pl.enc_b &&
         pl.total <= SMEM_LIMIT;
}

int launch_prop(const Net& net, const Plan& pl, const float* x3, long np,
                float* out, int out_rows, cudaStream_t stream) {
  if (!prop_net(net) || !prop_plan_ok(net, pl) ||
      out_rows != net.layer[net.n_layers - 1].kout_real)
    return -1;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(prop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pl.total);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prop_kernel,
                                                PROP_WARPS * 32, pl.total);
  const long want =
      ((np + PROP_PTS - 1) / PROP_PTS + PROP_WARPS - 1) / PROP_WARPS;
  const long cap = (long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  prop_kernel<<<grid, PROP_WARPS * 32, pl.total, stream>>>(net, pl, x3, np,
                                                           out, out_rows);
  return (int)cudaGetLastError();
}

// the blocks of `kernel` resident on the card at the plan's block size
// (pl.wgs warpgroups and the aux ones) and shared memory: the persistent
// grid's size, and the slots of the park buffer (park_blocks)
template <int V, typename K>
long resident_blocks(K kernel, const Plan& pl) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pl.total);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, (pl.wgs + aux_wgs<V>(pl)) * 128, pl.total);
  return (long)n_sm * (per_sm < 1 ? 1 : per_sm);
}

// a launch of a persistent kernel: its blocks, the warpgroups of a block
// and its threads
struct Launch {
  int grid, wgs, threads;
};

// The persistent grid: the resident blocks, at most one a work_items /
// wgs. With the ring, wgs is the fewest warpgroups a block that take as
// few passes over the work items as pl.wgs would: a small launch is spread
// over the resident blocks (one an SM), not packed into fewer full ones.
// grid 0 where the park buffer (sized by park_blocks, slots for pl.wgs
// warpgroups a block) has too few slots.
template <int V, typename K>
Launch launch_size(K kernel, const Plan& pl, bool ring, long work_items,
                   int park_words, long park_bytes) {
  const long resident = resident_blocks<V>(kernel, pl);
  auto passes = [&](int w) {
    return (work_items + resident * w - 1) / (resident * w);
  };
  int wgs = pl.wgs;
  while (ring && wgs > 1 && passes(wgs - 1) == passes(pl.wgs)) --wgs;
  const long want = (work_items + wgs - 1) / wgs;
  long grid = want < resident ? (want > 0 ? want : 1) : resident;
  if (pl.park_chunks &&
      park_bytes < grid * pl.wgs * pl.park_chunks * park_words * 128 * 4L)
    grid = 0;
  return Launch{(int)grid, wgs, (wgs + aux_wgs<V>(pl)) * 128};
}

// The ring's plan (the bf16 V_WIDE and V_GRID kernels, which run on
// nothing else): 2..MAX_STAGES stages of UNIT_B bytes, the barriers after
// them, and the zero block where a layer's columns are not whole units;
// V_WIDE32's: stages of F32_UNIT_B bytes, unit_k F32_UNIT_K, no zero block
// (a layer's columns are a multiple of 16: whole groups of units). A ring
// kernel's plan without it, or another plan with it, is refused; so is a
// V_GRID plan without its encoding slots (a multiple of its consumers,
// each a tile's encoding and sigma sums), or another plan with them.
bool ring_plan_ok(const Net& net, const Plan& pl, bool ring) {
  if (pl.variant != V_GRID) {
    if (pl.slots || pl.slot_b) return false;
  } else if (pl.slots < pl.wgs || pl.slots > MAX_SLOTS ||
             pl.slots % pl.wgs ||
             pl.enc_b != align16(TILE * pl.lde * 2) ||
             pl.sig_b != align16(TILE * 4) ||
             pl.slot_b != pl.enc_b + pl.sig_b || pl.lde != net.ke) {
    return false;
  }
  if (pl.variant == V_WIDE32)
    return ring && pl.w_mode == W_RING && pl.unit_b == F32_UNIT_B &&
           pl.unit_k == F32_UNIT_K && pl.stages >= 2 &&
           pl.stages <= MAX_STAGES &&
           pl.w_bytes == pl.stages * F32_UNIT_B + RING_BAR_B;
  if (!ring) return pl.w_mode != W_RING;
  bool zero = false;
  for (int l = 0; l < net.n_layers; ++l) zero |= net.layer[l].w_ld % UNIT_K;
  return pl.w_mode == W_RING && pl.unit_b == UNIT_B && pl.stages >= 2 &&
         pl.stages <= MAX_STAGES &&
         pl.w_bytes == pl.stages * UNIT_B + RING_BAR_B + (zero ? ZERO_B : 0);
}

// A ring kernel starts with the registers its setmaxnreg budget counts on
// (RING_ENTRY_REGS; V_GRID: GRID_ENTRY_REGS; V_WIDE32:
// F32_RING_ENTRY_REGS), or it is refused (-2): its
// consumers' increase would wait for registers the producer (the
// encoders) cannot give back.
template <int V, typename K>
bool ring_regs_ok(K kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess &&
         a.numRegs == (V == V_GRID     ? GRID_ENTRY_REGS
                       : V == V_WIDE32 ? F32_RING_ENTRY_REGS
                                       : RING_ENTRY_REGS);
}

// the plan's own checks: the kernels trust it for every buffer they carve
bool plan_ok(const Net& net, const Plan& pl, int max_wgs) {
  if (pl.total > SMEM_LIMIT || pl.wgs < 1 || pl.wgs > max_wgs) return false;
  if (pl.M < TILE || pl.M % TILE || pl.nseg < 1) return false;
  if (pl.unit_k != (pl.variant == V_WIDE32 ? F32_UNIT_K : 0) ||
      pl.park_chunks < 0)
    return false;
  if (net.ke % 16 || net.hmax > MAX_WIDTH) return false;
  if (pl.variant != V_WIDE && pl.variant != V_WIDE32 && net.hmax > CHUNK)
    return false;
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
  constexpr bool ring = ring_of<T>(V);
  if (!plan_ok(net, pl, wgs_of<T>(false, V)) || pl.M != TILE ||
      !ring_plan_ok(net, pl, ring))
    return -1;
  if (ring && !ring_regs_ok<V>(tmlp_kernel<T, V>)) return -2;
  const Launch ln =
      launch_size<V>(tmlp_kernel<T, V>, pl, ring, (np + TILE - 1) / TILE,
                  sizeof(T) == 2 ? NA / 2 : NA, park_bytes);
  if (ln.grid < 1) return (int)cudaErrorInvalidValue;
  if (V == V_GRID && pl.slots % ln.wgs) return -1;
  tmlp_kernel<T, V><<<ln.grid, ln.threads, pl.total, stream>>>(
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
    case V_GRID:  // bf16 only
      if constexpr (sizeof(T) == 2)
        return launch_tmlp<T, V_GRID>(net, pl, x3, np, out, out_rows, park,
                                      park_bytes, stream);
      return -1;
    case V_WIDE32:  // float32 only
      if constexpr (sizeof(T) == 4)
        return launch_tmlp<T, V_WIDE32>(net, pl, x3, np, out, out_rows, park,
                                        park_bytes, stream);
      return -1;
    case V_WIDE:  // bf16 only
      if constexpr (sizeof(T) == 2)
        return launch_tmlp<T, V_WIDE>(net, pl, x3, np, out, out_rows, park,
                                      park_bytes, stream);
      return -1;
    default:
      return -1;
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
  constexpr bool ring = ring_of<T>(V);
  if (!plan_ok(net, pl, wgs_of<T>(true, V)) ||
      !ring_plan_ok(net, pl, ring))
    return -1;
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
                    c.Ts > 128 || (pl.park_chunks && V != V_WIDE32)))
    return (int)cudaErrorInvalidValue;
  const long n_steps = ((long)c.N + pl.R - 1) / pl.R;
  auto* kernel = composite_of<T, V>(pl);
  if (ring && !ring_regs_ok<V>(kernel)) return -2;
  const Launch ln = launch_size<V>(kernel, pl, ring, n_steps,
                                sizeof(T) == 2 ? NA / 2 : NA, park_bytes);
  if (ln.grid < 1) return (int)cudaErrorInvalidValue;
  if (V == V_GRID && pl.slots % ln.wgs) return -1;
  kernel<<<ln.grid, ln.threads, pl.total, stream>>>(
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
    case V_GRID:  // bf16 only
      if constexpr (sizeof(T) == 2)
        return launch_composite<T, V_GRID>(net, view, pl, c, park,
                                           park_bytes, stream);
      return -1;
    case V_WIDE32:  // float32 only
      if constexpr (sizeof(T) == 4)
        return launch_composite<T, V_WIDE32>(net, view, pl, c, park,
                                             park_bytes, stream);
      return -1;
    case V_WIDE:  // bf16 only
      if constexpr (sizeof(T) == 2)
        return launch_composite<T, V_WIDE>(net, view, pl, c, park,
                                           park_bytes, stream);
      return -1;
    default:
      return -1;
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
  if (!pl.park_chunks || (pl.variant != V_WIDE && pl.variant != V_WIDE32))
    return 0;
  if (use_bf16 != (pl.variant == V_WIDE)) return 0;
  if (pl.variant == V_WIDE32)
    return composite
               ? resident_blocks<V_WIDE32>(composite_of<float, V_WIDE32>(pl),
                                           pl)
               : resident_blocks<V_WIDE32>(tmlp_kernel<float, V_WIDE32>, pl);
  return composite
             ? resident_blocks<V_WIDE>(composite_of<bf16, V_WIDE>(pl), pl)
             : resident_blocks<V_WIDE>(tmlp_kernel<bf16, V_WIDE>, pl);
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
  if (pl.prop) {
    if (!use_bf16) return -1;
    return launch_prop(net, pl, x3, np, out, out_rows, (cudaStream_t)stream);
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
  if (desc[0] < 1 || desc[0] > MAX_LAYERS || pl.small || pl.prop) return -1;
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
