// Fused encode + MLP chain of the MLP-family NeRF field, Hopper (sm_90a).
//
// Replaces the TPU kernels sanerf_tpu/ops/fused_mlp_t.py:1077 _run_tmlp
// (reached by run_tmlp :481; body _encode_and_chain :549, _ad_encode :108,
// _grid_blocks :323, _cp_level :235) and :885 _run_tmlp_composite (reached
// by run_tmlp_composite :978; kernel _tmlp_composite_kernel :707, view
// epilogue :835-874, packed epilogue pack_q > 1 :757-796). Plain PyTorch
// versions of the same functions:
// sanerf_tpu_torch/ops/fused_mlp_t.py (forward_plain, *_plain).
//
// Bound on an H100: the field chain of the serving asset is 50,944 MAC per
// point (127->128, 255->128, 128->16); a 512^2 frame at the (32, 16)
// hierarchy has 4.19 M final points, 0.43 TFLOP, ~0.43 ms on the bf16
// tensor cores at 989 TFLOP/s. The proposal chain (33->32->1) is ~1.1 k
// MAC per point and bound by its 12 B in + 4 B out per point.
//
// Design: every warp owns tiles of 16 points (the M of mma.m16n8k16). Per
// tile it
//   - encodes into shared memory: the angle-doubling Fourier features (one
//     sinf pair per coordinate, then s' = 2sc, c' = c^2 - s^2, the JAX
//     recurrence) and the CP line features as 2-tap linear interpolation of
//     the [3, R, K] tables read through L1/L2 (lanes take consecutive
//     features, so each table row read is one coalesced segment); the
//     sigma-CP products are summed over the rank by a warp reduction;
//   - runs the chain from shared memory: bf16 weights are copied once per
//     block into shared memory as W^T rows padded by 8 elements (conflict-free
//     32-bit fragment loads), and each layer is a row of mma.sync m16n8k16
//     bf16 products with float32 accumulators held in registers (at most 16
//     n-tiles = 128 outputs). The skip layer is a second product over the
//     encoding. Activations are rounded to the weight type between layers,
//     as the TPU kernel does (fused_mlp_t.py:616). float32 weights (the
//     parity path) take the same data layout with CUDA-core FMAs.
// The composite kernel gathers whole rays (lcm(16, T) points per step) and
// runs the epilogue per ray in one warp: softplus density, alpha with the
// optional opaque last sample, a warp scan for the exclusive transmittance
// sum of the finite optical depths, NaN weights -> 0, per-ray sums, then the
// SH (degree <= 4) + view MLP head on one lane per output and the sigmoid.
// With pack_q > 1 the composite reads dl and ts through the packed layout
// of the ray kernels, [N/q, q*T, 1] with ray n in slot n % q of row n / q
// (the TPU fills 128-lane rows with q rays; the per-ray warp epilogue here
// has no lanes to fill, so the option computes the same function from the
// packed operands at the same cost).
// Built with -fmad=false so the encode and the epilogue round like the
// PyTorch versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 16;
constexpr int MAX_LAYERS = 8;
constexpr int MAX_NT = 16;  // n-tiles of 8 outputs
constexpr int PAD = 8;      // row padding (elements) of the A/W^T buffers
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr float HALF_PI = 1.57079632679489661923f;

struct Layer {
  int kin_h, kin_e, kout, kout_real, w_off, w_ld;
};

struct Grid {
  const void* table;  // [3, R, K] in the weight type
  int R, K;
  float s, o;  // u = x * s + o
};

struct Net {
  int n_layers, leaky, enc_freqs, F, ke, hmax;
  Layer layer[MAX_LAYERS];
  float enc_scale;
  const void* w;
  int w_elems;
  int w_in_smem;
  Grid cp, scp;
};

struct View {
  const void* w;
  int elems, H, n_rest, sh_dim, degree, in_smem;
};

template <typename T>
__device__ __forceinline__ float tof(T v);
template <>
__device__ __forceinline__ float tof<float>(float v) { return v; }
template <>
__device__ __forceinline__ float tof<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float v) { return tof<T>(fromf<T>(v)); }

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// ---------------------------------------------------------------------------
// one layer's products into C-fragment accumulators
//   acc[nt][0,1] = out[row g][col nt*8 + 2t + {0,1}],
//   acc[nt][2,3] = out[row g+8][...]   (g = lane / 4, t = lane % 4)
// A: [16][lda] activations, W: [kout][w_ld] transposed weights; the part
// covers A columns [0, kA) against W columns [wcol0, wcol0 + kA).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void layer_part(
    float (&acc)[MAX_NT][4], const __nv_bfloat16* W, int w_ld, int wcol0,
    const __nv_bfloat16* A, int lda, int kA, int ntiles, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < kA; k0 += 16) {
    const __nv_bfloat16* ar0 = A + g * lda + k0 + 2 * t;
    const __nv_bfloat16* ar1 = ar0 + 8 * lda;
    const uint32_t a0 = ld32(ar0), a1 = ld32(ar1), a2 = ld32(ar0 + 8),
                   a3 = ld32(ar1 + 8);
    const __nv_bfloat16* wb = W + g * w_ld + wcol0 + k0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt < ntiles) {
        const __nv_bfloat16* wr = wb + nt * 8 * w_ld;
        mma_bf16(acc[nt], a0, a1, a2, a3, ld32(wr), ld32(wr + 8));
      }
    }
  }
}

__device__ __forceinline__ void layer_part(float (&acc)[MAX_NT][4],
                                           const float* W, int w_ld,
                                           int wcol0, const float* A, int lda,
                                           int kA, int ntiles, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ar0 = A + g * lda;
  const float* ar1 = ar0 + 8 * lda;
  for (int k = 0; k < kA; ++k) {
    const float x0 = ar0[k], x1 = ar1[k];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt < ntiles) {
        const float* w0 = W + (nt * 8 + 2 * t) * w_ld + wcol0 + k;
        const float wa = w0[0], wb = w0[w_ld];
        acc[nt][0] += x0 * wa;
        acc[nt][1] += x0 * wb;
        acc[nt][2] += x1 * wa;
        acc[nt][3] += x1 * wb;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0,
                                                  float v1) {
  p[0] = v0;
  p[1] = v1;
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float v0,
                                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float act(float v, int leaky) {
  return leaky ? (v >= 0.0f ? v : 0.01f * v) : fmaxf(v, 0.0f);
}

// The chain over one tile. enc [16][lde] holds the encoding; h [16][ldh] the
// hidden activations; the last layer (float32, plus `sig` on column 0)
// lands in outb [16][ldo].
template <typename T>
__device__ void chain(const Net& net, const T* W, const T* enc, int lde, T* h,
                      int ldh, float* outb, int ldo, const float* sig,
                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const int ntiles = L.kout / 8;
    float acc[MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    const T* Wl = W + L.w_off;
    if (l == 0)
      layer_part(acc, Wl, L.w_ld, 0, enc, lde, L.kin_h, ntiles, lane);
    else
      layer_part(acc, Wl, L.w_ld, 0, (const T*)h, ldh, L.kin_h, ntiles, lane);
    if (L.kin_e)
      layer_part(acc, Wl, L.w_ld, L.kin_h, enc, lde, L.kin_e, ntiles, lane);
    __syncwarp();
    const bool last = l == net.n_layers - 1;
    if (last && sig && t == 0) {
      acc[0][0] += sig[g];
      acc[0][2] += sig[g + 8];
    }
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt < ntiles) {
        const int col = nt * 8 + 2 * t;
        if (last) {
          outb[g * ldo + col] = acc[nt][0];
          outb[g * ldo + col + 1] = acc[nt][1];
          outb[(g + 8) * ldo + col] = acc[nt][2];
          outb[(g + 8) * ldo + col + 1] = acc[nt][3];
        } else {
          store_pair<T>(h + g * ldh + col, act(acc[nt][0], net.leaky),
                        act(acc[nt][1], net.leaky));
          store_pair<T>(h + (g + 8) * ldh + col, act(acc[nt][2], net.leaky),
                        act(acc[nt][3], net.leaky));
        }
      }
    }
    __syncwarp();
  }
}

// per-axis 2-tap interpolation setup
struct Taps {
  int i0[3], i1[3];
  float f[3];
};

__device__ __forceinline__ Taps taps(const Grid& gr, const float* x) {
  Taps tp;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(x[a] * gr.s + gr.o, 0.0f), (float)(gr.R - 1));
    const float fl = floorf(u);
    tp.f[a] = u - fl;
    tp.i0[a] = (int)fl;
    tp.i1[a] = min(tp.i0[a] + 1, gr.R - 1);
  }
  return tp;
}

template <typename T>
__device__ __forceinline__ float cp_feature(const Grid& gr, const Taps& tp,
                                            int k) {
  const T* L = reinterpret_cast<const T*>(gr.table);
  float v = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T* la = L + (size_t)a * gr.R * gr.K;
    const float fa = tof<T>(la[tp.i0[a] * gr.K + k]) * (1.0f - tp.f[a]) +
                     tof<T>(la[tp.i1[a] * gr.K + k]) * tp.f[a];
    v = a == 0 ? fa : v * fa;
  }
  return v;
}

// Encodes the tile of points [p0, p0 + 16) into enc; sig[p] gets the
// sigma-CP sum. xs is [16][3] scratch.
template <typename T>
__device__ void encode_tile(const Net& net, const float* __restrict__ x3,
                            long np, long p0, T* enc, int lde, float* xs,
                            float* sig, int lane) {
  if (lane < TILE) {
    const long p = p0 + lane;
#pragma unroll
    for (int a = 0; a < 3; ++a) xs[lane * 3 + a] = p < np ? x3[a * np + p] : 0.0f;
  }
  __syncwarp();
  for (int j = lane; j < TILE * 3; j += 32) {
    const int p = j / 3, d = j - 3 * (j / 3);
    T* e = enc + p * lde;
    const float z = xs[p * 3 + d] * net.enc_scale;
    e[d] = fromf<T>(z);
    float s = sinf(z), c = sinf(z + HALF_PI);
    for (int f = 0; f < net.enc_freqs; ++f) {
      if (f) {
        const float s2 = 2.0f * s * c;
        const float c2 = c * c - s * s;
        s = s2;
        c = c2;
      }
      e[3 + 6 * f + d] = fromf<T>(s);
      e[6 + 6 * f + d] = fromf<T>(c);
    }
  }
  if (net.cp.table || net.scp.table) {
    for (int p = 0; p < TILE; ++p) {
      const float* x = xs + p * 3;
      if (net.cp.table) {
        const Taps tp = taps(net.cp, x);
        for (int k = lane; k < net.cp.K; k += 32)
          enc[p * lde + net.F + k] = fromf<T>(cp_feature<T>(net.cp, tp, k));
      }
      if (net.scp.table) {
        const Taps tp = taps(net.scp, x);
        float part = 0.0f;
        for (int k = lane; k < net.scp.K; k += 32)
          part += cp_feature<T>(net.scp, tp, k);
        for (int off = 16; off; off >>= 1)
          part += __shfl_xor_sync(FULL, part, off);
        if (lane == 0) sig[p] = part;
      }
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// shared-memory plan (identical on host and device)
// ---------------------------------------------------------------------------

struct Plan {
  int lde, ldh, ldo, M;  // M: points per warp step
  int w_bytes, v_bytes;  // weight copies (0 when read from global)
  int enc_b, h_b, out_b, xs_b, sig_b, wts_b, ts_b, vin_b;
  int per_warp, total;
};

template <typename T>
__host__ __device__ Plan make_plan(const Net& net, const View* view, int M,
                                   int ldo, bool composite, bool w_smem,
                                   bool v_smem) {
  Plan p;
  p.lde = net.ke + PAD;
  p.ldh = net.hmax + PAD;
  p.ldo = ldo;
  p.M = M;
  p.w_bytes = w_smem ? align16(net.w_elems * (int)sizeof(T)) : 0;
  p.v_bytes = (view && v_smem) ? align16(view->elems * (int)sizeof(T)) : 0;
  p.enc_b = align16(TILE * p.lde * (int)sizeof(T));
  p.h_b = align16(TILE * p.ldh * (int)sizeof(T));
  p.out_b = align16(M * ldo * 4);
  p.xs_b = align16(TILE * 3 * 4);
  p.sig_b = align16(TILE * 4);
  p.wts_b = composite ? align16(M * 4) : 0;
  p.ts_b = composite ? align16(M * 4) : 0;
  p.vin_b = composite ? align16(128 * 4) : 0;
  p.per_warp = p.enc_b + p.h_b + p.out_b + p.xs_b + p.sig_b + p.wts_b +
               p.ts_b + p.vin_b;
  p.total = p.w_bytes + p.v_bytes + WARPS * p.per_warp;
  return p;
}

struct WarpBufs {
  void* enc;
  void* h;
  float *outb, *xs, *sig, *wts, *tsb, *vin;
};

template <typename T>
__device__ const T* block_setup(const Net& net, const View* view,
                                const Plan& pl, unsigned char* smem,
                                const T** vw, WarpBufs& wb) {
  const T* W = reinterpret_cast<const T*>(net.w);
  if (pl.w_bytes) {
    const int words = pl.w_bytes / 4;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(net.w);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    const int n_src = (net.w_elems * (int)sizeof(T)) / 4;
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      dst[i] = i < n_src ? src[i] : 0u;
    W = reinterpret_cast<const T*>(smem);
  }
  if (view) {
    *vw = reinterpret_cast<const T*>(view->w);
    if (pl.v_bytes) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(smem + pl.w_bytes);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(view->w);
      const int n_src = (view->elems * (int)sizeof(T)) / 4;
      for (int i = threadIdx.x; i < pl.v_bytes / 4; i += blockDim.x)
        dst[i] = i < n_src ? src[i] : 0u;
      *vw = reinterpret_cast<const T*>(smem + pl.w_bytes);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* base = smem + pl.w_bytes + pl.v_bytes + warp * pl.per_warp;
  wb.enc = base;
  base += pl.enc_b;
  wb.h = base;
  base += pl.h_b;
  wb.outb = reinterpret_cast<float*>(base);
  base += pl.out_b;
  wb.xs = reinterpret_cast<float*>(base);
  base += pl.xs_b;
  wb.sig = reinterpret_cast<float*>(base);
  base += pl.sig_b;
  wb.wts = reinterpret_cast<float*>(base);
  base += pl.wts_b;
  wb.tsb = reinterpret_cast<float*>(base);
  base += pl.ts_b;
  wb.vin = reinterpret_cast<float*>(base);
  // zero the encoding buffer once: its padding columns stay zero
  T* enc = reinterpret_cast<T*>(wb.enc);
  for (int i = lane; i < TILE * pl.lde; i += 32) enc[i] = fromf<T>(0.0f);
  __syncthreads();
  return W;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
tmlp_kernel(Net net, Plan pl, const float* __restrict__ x3, long np,
            float* __restrict__ out, int out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpBufs wb;
  const T* W = block_setup<T>(net, nullptr, pl, smem, nullptr, wb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* enc = reinterpret_cast<T*>(wb.enc);
  T* h = reinterpret_cast<T*>(wb.h);
  const float* sig = net.scp.table ? wb.sig : nullptr;
  const long n_tiles = (np + TILE - 1) / TILE;
  for (long tile = (long)blockIdx.x * WARPS + warp; tile < n_tiles;
       tile += (long)gridDim.x * WARPS) {
    const long p0 = tile * TILE;
    encode_tile<T>(net, x3, np, p0, enc, pl.lde, wb.xs, wb.sig, lane);
    chain<T>(net, W, enc, pl.lde, h, pl.ldh, wb.outb, pl.ldo, sig, lane);
    for (int i = lane; i < out_rows * TILE; i += 32) {
      const int r = i / TILE, p = i - r * TILE;
      if (p0 + p < np) out[(long)r * np + p0 + p] = wb.outb[p * pl.ldo + r];
    }
    __syncwarp();
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
composite_kernel(Net net, View view, Plan pl, const float* __restrict__ x3,
                 const float* __restrict__ dl, const float* __restrict__ ts,
                 const float* __restrict__ rays8, int N, int Ts, int pack_q,
                 int opaque, float* __restrict__ gsum,
                 float* __restrict__ depth,
                 float* __restrict__ wsum, float* __restrict__ rgb) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpBufs wb;
  const T* VW = nullptr;
  const T* W = block_setup<T>(net, view.H ? &view : nullptr, pl, smem, &VW,
                              wb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* enc = reinterpret_cast<T*>(wb.enc);
  T* h = reinterpret_cast<T*>(wb.h);
  const float* sig = net.scp.table ? wb.sig : nullptr;
  const int G = net.layer[net.n_layers - 1].kout_real;  // gsum columns
  const int M = pl.M, rays_per_step = M / Ts;
  const long np = (long)N * Ts;
  const long n_steps = (np + M - 1) / M;
  // view weights: VG [G][H] (row 0 zero), VS [sh_dim][H], VR [n_rest][H][H]
  const int H = view.H;
  const T* VG = VW;
  const T* VS = VW + G * H;
  const T* VR = VS + view.sh_dim * H;
  float* vin = wb.vin;        // [0, 16): rounded gsum
  float* vsh = wb.vin + 32;   // [0, 16): rounded wsum * sh
  float* vh = wb.vin + 64;    // hidden activations
  float* misc = wb.vin + 112; // wsum
  for (long step = (long)blockIdx.x * WARPS + warp; step < n_steps;
       step += (long)gridDim.x * WARPS) {
    const long c0 = step * M;
    for (int tt = 0; tt < M / TILE; ++tt) {
      encode_tile<T>(net, x3, np, c0 + tt * TILE, enc, pl.lde, wb.xs, wb.sig,
                     lane);
      chain<T>(net, W, enc, pl.lde, h, pl.ldh, wb.outb + tt * TILE * pl.ldo,
               pl.ldo, sig, lane);
    }
    for (int r = 0; r < rays_per_step; ++r) {
      const long n = c0 / Ts + r;
      if (n >= N) break;
      const float* ob = wb.outb + r * Ts * pl.ldo;
      float* wts = wb.wts + r * Ts;
      float* tsb = wb.tsb + r * Ts;
      const long roff = ray_offset(n, Ts, pack_q);
      float carry = 0.0f;
      for (int t0 = 0; t0 < Ts; t0 += 32) {
        const int t = t0 + lane;
        const bool valid = t < Ts;
        float ds = 0.0f, alpha = 0.0f;
        if (valid) {
          const float s = ob[t * pl.ldo] - 1.0f;
          const float sigma = fmaxf(s, 0.0f) + log1pf(expf(-fabsf(s)));
          ds = dl[roff + t] * sigma;
          const float ds_a = (opaque && t == Ts - 1) ? __int_as_float(0x7f800000) : ds;
          alpha = 1.0f - expf(-ds_a);
          tsb[t] = ts[roff + t];
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
        if (valid) wts[t] = w;
        carry += __shfl_sync(FULL, incl, 31);
      }
      __syncwarp();
      if (lane < G) {
        float a = 0.0f;
        for (int t = 0; t < Ts; ++t) a += wts[t] * ob[t * pl.ldo + lane];
        gsum[n * G + lane] = a;
        vin[lane] = rnd<T>(a);
      } else if (lane == 16) {
        float a = 0.0f;
        for (int t = 0; t < Ts; ++t) a += wts[t] * tsb[t];
        depth[n] = a;
      } else if (lane == 17) {
        float a = 0.0f;
        for (int t = 0; t < Ts; ++t) a += wts[t];
        wsum[n] = a;
        misc[0] = a;
      }
      __syncwarp();
      if (H) {
        const float* rr = rays8 + n * 8;
        const float dx = rr[3], dy = rr[4], dz = rr[5];
        const float inv = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
        if (lane < view.sh_dim)
          vsh[lane] = rnd<T>(misc[0] * sh_component(lane, dx * inv, dy * inv,
                                                    dz * inv));
        __syncwarp();
        float hj = 0.0f;
        if (lane < H) {
          float a = 0.0f, b = 0.0f;
          for (int c = 0; c < G; ++c) a += vin[c] * tof<T>(VG[c * H + lane]);
          for (int k = 0; k < view.sh_dim; ++k)
            b += vsh[k] * tof<T>(VS[k * H + lane]);
          hj = a + b;
        }
        for (int l = 0; l < view.n_rest; ++l) {
          __syncwarp();
          if (lane < H) vh[lane] = rnd<T>(fmaxf(hj, 0.0f));
          __syncwarp();
          if (lane < H) {
            const T* vr = VR + (size_t)l * H * H;
            float a = 0.0f;
            for (int i = 0; i < H; ++i) a += vh[i] * tof<T>(vr[i * H + lane]);
            hj = a;
          }
        }
        if (lane < 3) rgb[n * 3 + lane] = 1.0f / (1.0f + expf(-hj));
      }
      __syncwarp();
    }
  }
}

Net make_net(const int* desc, const void* w, int w_elems, float enc_scale,
             const void* cp, int cpR, int cpK, float cps, float cpo,
             const void* scp, int sR, int sK, float ss, float so) {
  Net net;
  net.n_layers = desc[0];
  net.leaky = desc[1];
  net.enc_freqs = desc[2];
  net.F = desc[3];
  net.ke = desc[4];
  net.hmax = desc[5];
  for (int l = 0; l < net.n_layers && l < MAX_LAYERS; ++l) {
    const int* d = desc + 6 + 6 * l;
    net.layer[l] = Layer{d[0], d[1], d[2], d[3], d[4], d[5]};
  }
  net.enc_scale = enc_scale;
  net.w = w;
  net.w_elems = w_elems;
  net.cp = Grid{cp, cpR, cpK, cps, cpo};
  net.scp = Grid{scp, sR, sK, ss, so};
  return net;
}

// Picks where the weights live (shared memory when they fit) and the
// shared-memory plan; returns false when even the per-warp buffers do not
// fit.
template <typename T>
bool plan_for(Net& net, View* view, int M, int ldo, bool composite,
              Plan& pl) {
  const bool ok_layers = net.n_layers >= 1 && net.n_layers <= MAX_LAYERS;
  if (!ok_layers) return false;
  for (int l = 0; l < net.n_layers; ++l)
    if (net.layer[l].kout > 8 * MAX_NT) return false;
  bool w_smem = true, v_smem = view != nullptr;
  pl = make_plan<T>(net, view, M, ldo, composite, w_smem, v_smem);
  if (pl.total > SMEM_LIMIT) {
    v_smem = false;
    pl = make_plan<T>(net, view, M, ldo, composite, w_smem, v_smem);
  }
  if (pl.total > SMEM_LIMIT) {
    w_smem = false;
    pl = make_plan<T>(net, view, M, ldo, composite, w_smem, v_smem);
  }
  net.w_in_smem = w_smem;
  if (view) view->in_smem = v_smem;
  return pl.total <= SMEM_LIMIT;
}

template <typename K>
int grid_size(K kernel, int smem, long work_items) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32,
                                                smem);
  if (per_sm < 1) per_sm = 1;
  const long want = (work_items + WARPS - 1) / WARPS;
  const long cap = (long)n_sm * per_sm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch_tmlp(Net net, const float* x3, long np, float* out, int out_rows,
                cudaStream_t stream) {
  Plan pl;
  const int ldo = net.layer[net.n_layers - 1].kout + 1;
  if (!plan_for<T>(net, nullptr, TILE, ldo, false, pl)) return -1;
  const int grid = grid_size(tmlp_kernel<T>, pl.total, (np + TILE - 1) / TILE);
  tmlp_kernel<T><<<grid, WARPS * 32, pl.total, stream>>>(net, pl, x3, np, out,
                                                         out_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_composite(Net net, View view, const float* x3, const float* dl,
                     const float* ts, const float* rays8, int N, int Ts,
                     int pack_q, int opaque, float* gsum, float* depth,
                     float* wsum, float* rgb, cudaStream_t stream) {
  const int M = Ts > TILE ? Ts : TILE;
  if (M % TILE || M % Ts || M > 128) return (int)cudaErrorInvalidValue;
  if (pack_q < 1 || N % pack_q) return (int)cudaErrorInvalidValue;
  if (net.layer[net.n_layers - 1].kout != TILE) return (int)cudaErrorInvalidValue;
  if (view.H > 32 || view.sh_dim > 16) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!plan_for<T>(net, view.H ? &view : nullptr, M, TILE + 1, true, pl))
    return -1;
  const long n_steps = ((long)N * Ts + M - 1) / M;
  const int grid = grid_size(composite_kernel<T>, pl.total, n_steps);
  composite_kernel<T><<<grid, WARPS * 32, pl.total, stream>>>(
      net, view, pl, x3, dl, ts, rays8, N, Ts, pack_q, opaque, gsum, depth,
      wsum, rgb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmlp_launch(int bf16, const int* desc, const void* w,
                           int w_elems, float enc_scale, const void* cp,
                           int cpR, int cpK, float cps, float cpo,
                           const void* scp, int sR, int sK, float ss,
                           float so, const float* x3, long np, float* out,
                           int out_rows, void* stream) {
  Net net = make_net(desc, w, w_elems, enc_scale, cp, cpR, cpK, cps, cpo, scp,
                     sR, sK, ss, so);
  if (net.n_layers < 1 || net.n_layers > MAX_LAYERS) return -1;
  return bf16 ? launch_tmlp<__nv_bfloat16>(net, x3, np, out, out_rows,
                                           (cudaStream_t)stream)
              : launch_tmlp<float>(net, x3, np, out, out_rows,
                                   (cudaStream_t)stream);
}

extern "C" int tmlp_composite_launch(
    int bf16, const int* desc, const void* w, int w_elems, float enc_scale,
    const void* cp, int cpR, int cpK, float cps, float cpo, const void* scp,
    int sR, int sK, float ss, float so, const void* vw, int v_elems,
    const int* vdesc, const float* x3, const float* dl, const float* ts,
    const float* rays8, int N, int Ts, int pack_q, int opaque, float* gsum,
    float* depth, float* wsum, float* rgb, void* stream) {
  Net net = make_net(desc, w, w_elems, enc_scale, cp, cpR, cpK, cps, cpo, scp,
                     sR, sK, ss, so);
  if (net.n_layers < 1 || net.n_layers > MAX_LAYERS) return -1;
  View view{vw, v_elems, 0, 0, 0, 0, 0};
  if (vw && vdesc) {
    view.H = vdesc[0];
    view.n_rest = vdesc[1];
    view.sh_dim = vdesc[2];
    view.degree = vdesc[3];
  }
  return bf16 ? launch_composite<__nv_bfloat16>(
                    net, view, x3, dl, ts, rays8, N, Ts, pack_q, opaque, gsum,
                    depth, wsum, rgb, (cudaStream_t)stream)
              : launch_composite<float>(net, view, x3, dl, ts, rays8, N, Ts,
                                        pack_q, opaque, gsum, depth, wsum,
                                        rgb, (cudaStream_t)stream);
}
