"""Where the default proposal nets' time goes on the card: the bf16 w64 d4
net of ModelConfig() (33 Fourier columns -> 64 -> 64 -> 64 -> 1, ReLU) on
prop_kernel and on the tmlp_kernel route it replaced, each also built from
variants of csrc/fused_mlp_t.cu: parts left out, other constants, and the
designs measured before prop_kernel's own.

    python3 port_tools/prop_variants.py            (needs a CUDA card)
    python3 port_tools/prop_variants.py NAME ...   (those variants only)

A NAME joins variants with "+" (their substitutions in turn: prop_v2+
prop_half_mma is the second design with half its products). Builds every
variant's copy of the source first (build/variants/prop_<name>, one nvcc
each, all started together), then times each in a process of its own,
`orig` (the source as it is) first and last. Each process prints the
ptxas lines of prop_kernel and of the served bf16 tmlp_kernel, then one JSON
line: for each route (`prop`: kernel_plan's; `tmlp`: the plan with
prop_kernel's route taken away) and each launch shape of SHAPES, the median
and 10th / 90th percentile ms of REPS launches queued behind a backlog
(chip_smoke.interleaved_ms, the two routes interleaved), a digest of the
outputs; the plain version's median ms at the (32, 16) shape; the largest
|d| against the plain version at PLAIN_SHAPES (in slices of 2^21 points)
and the outputs past chip_smoke's GRID_TOL + GRID_TOL |ref|.

VARIANTS (text substitutions, as port_tools/kernel_variants.py applies them;
an old text given as a pair of markers is the source between them):
  tmlp_no_encode  tmlp_kernel's tiles without the encode (the chain reads
                  the zeroed buffer);
  tmlp_no_chain   its tiles without the chain (zero accumulators out);
  tmlp_no_out     without the copy of the output rows to device memory;
  prop_no_encode  prop_kernel without its encode (the chain reads whatever
                  the buffer holds);
  prop_no_chain   prop_kernel without the layers (encode and output);
  prop_16x1       16 warps a block (12 as it is; 128 registers: spills);
  prop_8x2        8 warps a block, 2 blocks an SM;
  prop_b_pairs    each n-tile pair's B fragments loaded right before its
                  products (as it is: a k step's all first);
  prop_v1         the first design: every layer a loop with run-time
                  bounds, B per n-tile pair, the activation's leaky test a
                  value, 8 x 2 warps;
  prop_v2         the second: the default net's layers straight-line as
                  now, the accumulators zeroed once before the tile loop
                  (live across the encode: spills), the activation as in
                  v1, 8 x 2 warps;
  prop_half_mma   the products of one m-tile of the two (the same loads);
  prop_no_ldsm_b  no B loads from shared memory (the fragments made from
                  the lane: wrong outputs, the same products);
  prop_no_act     (after prop_v2) the hidden activations handed on
                  without the ReLU;
  prop_nv         the products as non-volatile asm;
  prop_wg         the chain on wgmma instead: a warpgroup's two 64-point
                  tiles, m64nNk16 with A from registers (layer 0's by
                  ldmatrix from the warps' buffers) and B from the staged
                  slabs, one commit and wait a layer.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

#: the launch shapes of the default proposal net: points of a 512^2 frame's
#: proposal levels at (32, 16) and (128, 64, 32), and of ModelConfig()'s
#: (512, 256) 64^2 frame
SHAPES = {"32,16": 512 * 512 * 32, "128,64,32 level 0": 512 * 512 * 128,
          "128,64,32 level 1": 512 * 512 * 64,
          "64^2 (512, 256)": 64 * 64 * 512}
PLAIN_SHAPES = ("32,16", "64^2 (512, 256)")
REPS = 11

_TILE = ("  const float sg = encode_point<T, V != V_SERVED>(\n"
         "      net, x, lt & 1,\n"
         "      [&](int c, float v) { enc[enc_index<T>(row, c, pl.lde)] = "
         "fromf<T>(v); });")
_CHAIN_CALL = ("    chain<V == V_BRANCHES>(net, W, pl.w_mode == W_STREAM, enc, "
          "pl.lde, acc,\n                           warp, lane);")
_B_ALL = ("    uint32_t b[NP][4];\n#pragma unroll\n"
          "    for (int jp = 0; jp < NP; ++jp)\n"
          "      if (EXACT || 2 * jp < nt_n)\n"
          "        ldsm_x4(b[jp], w + (2 * s * (kout >> 3) + 2 * jp) * 64);\n"
          "#pragma unroll\n    for (int jp = 0; jp < NP; ++jp)\n")
_B_PAIRS = ("    uint32_t b[NP][4];\n#pragma unroll\n"
            "    for (int jp = 0; jp < NP; ++jp) {\n"
            "      if (EXACT || 2 * jp < nt_n)\n"
            "        ldsm_x4(b[jp], w + (2 * s * (kout >> 3) + 2 * jp) * 64);"
            "\n")
_B_END = ("            mma_bf16(acc[i][nt], a[i], b[jp][2 * h], "
          "b[jp][2 * h + 1]);\n        }\n  }\n}")
_B_PAIRS_END = ("            mma_bf16(acc[i][nt], a[i], b[jp][2 * h], "
                "b[jp][2 * h + 1]);\n        }\n    }\n  }\n}")
_NV = ("__device__ __forceinline__ void mma_bf16_nv(float (&c)[4], "
       "const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {\n"
       "  asm(\"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
       "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n\"\n"
       "      : \"+f\"(c[0]), \"+f\"(c[1]), \"+f\"(c[2]), \"+f\"(c[3])\n"
       "      : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
       "\"r\"(b0), \"r\"(b1));\n}\n\n")
# the earlier designs' code, in place of the blocks of the source between
# these markers
_CHAIN = ("// c = A * B, the products of mma_bf16 into a zero",
          "__global__ void __launch_bounds__(PROP_WARPS * 32")
_LAYERS = ("    // a layer writes the n-tiles it computes",
           "    // output row r: point lane")
_HEAD = ("  load_point(x3, np, tile * PROP_PTS + lane, x);\n"
         "  for (; tile < n_tiles; tile += step) {")
_8X2 = ["constexpr int PROP_WARPS = 12, PROP_BLOCKS = 1;",
        "constexpr int PROP_WARPS = 8, PROP_BLOCKS = 2;"]
_V1_CHAIN = r'''// acc[i][nt] += A (m-tile i, k step) * W^T's k step of Wl (kout rows of
// core matrices) over the first nt_n n-tiles; the B fragments of two
// n-tiles by one ldmatrix.x4 (core matrices (2s, n), (2s + 1, n) of the
// n-tile pair), shared by the m-tiles
__device__ __forceinline__ void prop_k_step(float (&acc)[PROP_MT][PROP_N / 8][4],
                                            const uint32_t (&a)[PROP_MT][4],
                                            const bf16* Wl, int kout, int s,
                                            int nt_n, int lane) {
  const int q = lane >> 3;
  const bf16* w = Wl + ((2 * s + (q & 1)) * (kout >> 3) + (q >> 1)) * 64 +
                  (lane & 7) * 8;
#pragma unroll
  for (int jp = 0; jp < PROP_N / 16; ++jp) {
    if (2 * jp < nt_n) {
      uint32_t b[4];
      ldsm_x4(b, w + 2 * jp * 64);
#pragma unroll
      for (int i = 0; i < PROP_MT; ++i) {
        mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
        if (2 * jp + 1 < nt_n) mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

'''
_V1_LAYERS = r'''    float acc[PROP_MT][PROP_N / 8][4];
    uint32_t hA[PROP_MT][PROP_N / 16][4];
    for (int l = 0; l <= last; ++l) {
      const Layer L = net.layer[l];
      const bf16* Wl = W + L.w_off;
      // the last layer: only the n8 tiles of its real outputs
      const int nt_n = l == last ? (L.kout_real + 7) >> 3 : L.kout >> 3;
#pragma unroll
      for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
        for (int nt = 0; nt < PROP_N / 8; ++nt)
          acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] =
              0.0f;
      if (l == 0) {
        // A from the buffer: ldmatrix.x4 of rows 16 i + (lane & 15), columns
        // 16 s + 8 (lane >> 4): a[0..3] as mma's fragment
#pragma unroll
        for (int s = 0; s < PROP_K / 16; ++s) {
          if (s < L.kin_h >> 4) {
            uint32_t a[PROP_MT][4];
#pragma unroll
            for (int i = 0; i < PROP_MT; ++i)
              ldsm_x4(a[i], buf + (16 * i + (lane & 15)) * pl.lde + 16 * s +
                                8 * (lane >> 4));
            prop_k_step(acc, a, Wl, L.kout, s, nt_n, lane);
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < PROP_N / 16; ++s) {
          if (s < L.kin_h >> 4) {
            uint32_t a[PROP_MT][4];
#pragma unroll
            for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) a[i][j] = hA[i][s][j];
            prop_k_step(acc, a, Wl, L.kout, s, nt_n, lane);
          }
        }
      }
      if (l < last) {
        // activated and rounded to bf16 (fused_mlp_t.py:616): n-tiles 2s
        // and 2s + 1 are k step s of the next layer
#pragma unroll
        for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
          for (int s = 0; s < PROP_N / 16; ++s) {
            if (s >= L.kout >> 4) continue;
            const float* c0 = acc[i][2 * s];
            const float* c1 = acc[i][2 * s + 1];
            hA[i][s][0] = pack_bf16(act(c0[0], net.leaky), act(c0[1], net.leaky));
            hA[i][s][1] = pack_bf16(act(c0[2], net.leaky), act(c0[3], net.leaky));
            hA[i][s][2] = pack_bf16(act(c1[0], net.leaky), act(c1[1], net.leaky));
            hA[i][s][3] = pack_bf16(act(c1[2], net.leaky), act(c1[3], net.leaky));
          }
      }
    }
'''
_V2_CHAIN = r'''// c = A * B, the products of mma_bf16 into a zero accumulator (the first k
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

'''
_V2_LAYERS = r'''    for (int l = 0; l <= last; ++l) {
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
      if (l < last) {
        // activated and rounded to bf16 (fused_mlp_t.py:616): n-tiles 2s
        // and 2s + 1 are k step s of the next layer
#pragma unroll
        for (int i = 0; i < PROP_MT; ++i)
#pragma unroll
          for (int s = 0; s < PROP_N / 16; ++s) {
            if (s >= L.kout >> 4) continue;
            const float* c0 = acc[i][2 * s];
            const float* c1 = acc[i][2 * s + 1];
            hA[i][s][0] = pack_bf16(act(c0[0], net.leaky), act(c0[1], net.leaky));
            hA[i][s][1] = pack_bf16(act(c0[2], net.leaky), act(c0[3], net.leaky));
            hA[i][s][2] = pack_bf16(act(c1[0], net.leaky), act(c1[1], net.leaky));
            hA[i][s][3] = pack_bf16(act(c1[2], net.leaky), act(c1[3], net.leaky));
          }
      }
    }
'''
_V2_HEAD = r'''  load_point(x3, np, tile * PROP_PTS + lane, x);
  // a layer writes the n-tiles it computes; the rest keep what they held
  float acc[PROP_MT][PROP_N / 8][4] = {};
  uint32_t hA[PROP_MT][PROP_N / 16][4];
  for (; tile < n_tiles; tile += step) {'''


def _wgmma_rs(N):
    """wgmma m64nNk16, A from registers, the accumulators as mma.sync's
    n-tiles d[j][4]."""
    nd = N // 2
    outs = ", ".join(f"%{i}" for i in range(nd))
    cons = ", ".join(f'"+f"(d[{i // 4}][{i % 4}])' for i in range(nd))
    return (f"template <>\n__device__ __forceinline__ void wgmma_rs<{N}>("
            f"float (&d)[PROP_N / 8][4], const uint32_t (&a)[4], uint64_t "
            f"desc, int scale_d) {{\n  asm volatile(\"{{\\n.reg .pred p;"
            f"\\nsetp.ne.b32 p, %{nd + 5}, 0;\\nwgmma.mma_async.sync."
            f"aligned.m64n{N}k16.f32.bf16.bf16 {{{outs}}}, {{%{nd}, "
            f"%{nd + 1}, %{nd + 2}, %{nd + 3}}}, %{nd + 4}, p, 1, 1, 0;"
            f"\\n}}\\n\"\n      : {cons}\n      : \"r\"(a[0]), \"r\"(a[1]), "
            f"\"r\"(a[2]), \"r\"(a[3]), \"l\"(desc), \"r\"(scale_d));\n}}\n")


_WG_LAYER = r'''
// one layer of the warpgroup's two 64-point tiles: acc[i] = A (tile i,
// this warp's 16 rows) W^T over ks k steps on wgmma m64nNk16, B the staged
// slab (LBO kout x 16 B, SBO 128 B), A from registers (layer 0's from the
// warp's buffer by ldmatrix, held until the products are done); one
// commit and wait a layer
template <int N, bool BUF>
__device__ __forceinline__ void prop_wg_layer(
    float (&acc)[PROP_MT][PROP_N / 8][4],
    uint32_t (&hA)[PROP_MT][PROP_N / 16][4], const bf16* buf, int lde,
    const bf16* Wl, int kout, int ks, int lane) {
  uint32_t a[PROP_MT][PROP_K / 16][4];
  if constexpr (BUF) {
#pragma unroll
    for (int s = 0; s < PROP_K / 16; ++s)
      if (s < ks)
#pragma unroll
        for (int i = 0; i < PROP_MT; ++i)
          ldsm_x4(a[i][s], buf + (16 * i + (lane & 15)) * lde + 16 * s +
                               8 * (lane >> 4));
  }
  wg::fence();
#pragma unroll
  for (int s = 0; s < PROP_K / 16; ++s) {
    if (s >= ks) break;
    const uint64_t d = wg::desc(Wl + 2 * s * kout * 8, (uint32_t)kout * 16,
                                128);
#pragma unroll
    for (int i = 0; i < PROP_MT; ++i) {
      if constexpr (BUF)
        wgmma_rs<N>(acc[i], a[i][s], d, s);
      else
        wgmma_rs<N>(acc[i], hA[i][s], d, s);
    }
  }
  wg::commit();
  wg::wait_all();
#pragma unroll
  for (int i = 0; i < PROP_MT; ++i) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][j][e])::"memory");
#pragma unroll
    for (int s = 0; s < PROP_K / 16; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (BUF)
          asm volatile("" : "+r"(a[i][s][e])::"memory");
        else
          asm volatile("" : "+r"(hA[i][s][e])::"memory");
      }
  }
}

template <bool BUF>
__device__ __forceinline__ void prop_wg_layer_n(
    int n, float (&acc)[PROP_MT][PROP_N / 8][4],
    uint32_t (&hA)[PROP_MT][PROP_N / 16][4], const bf16* buf, int lde,
    const bf16* Wl, int kout, int ks, int lane) {
  switch (n) {
''' + "".join(
    f"    case {n}: prop_wg_layer<{n}, BUF>(acc, hA, buf, lde, Wl, kout, ks, "
    f"lane); break;\n" for n in range(8, 64, 8)) + r'''    default: prop_wg_layer<64, BUF>(acc, hA, buf, lde, Wl, kout, ks, lane);
  }
}

'''
_WG = [
    [("// One layer of the warp's tile:", "__global__ void __launch_bounds__("
      "PROP_WARPS * 32"),
     "template <int N>\n__device__ __forceinline__ void wgmma_rs(float (&d)"
     "[PROP_N / 8][4], const uint32_t (&a)[4], uint64_t desc, int "
     "scale_d);\n" + "".join(_wgmma_rs(n) for n in range(8, 72, 8))
     + _WG_LAYER],
    [("      // straight-line code for the default net",
      "      if (l < last) prop_act("),
     "      if (l == 0)\n        prop_wg_layer_n<true>(8 * nt_n, acc, hA, buf, "
     "pl.lde, Wl, L.kout, ks, lane);\n      else\n        prop_wg_layer_n<"
     "false>(8 * nt_n, acc, hA, buf, pl.lde, Wl, L.kout, ks, lane);\n"],
    ["  const long n_tiles = (np + PROP_PTS - 1) / PROP_PTS;\n"
     "  const long step = (long)gridDim.x * PROP_WARPS;\n"
     "  long tile = (long)blockIdx.x * PROP_WARPS + warp;\n"
     "  float x[3];\n"
     "  load_point(x3, np, tile * PROP_PTS + lane, x);",
     "  const long n_tiles = (np + 127) / 128;\n"
     "  const long step = (long)gridDim.x * (PROP_WARPS / 4);\n"
     "  long tile = (long)blockIdx.x * (PROP_WARPS / 4) + (warp >> 2);\n"
     "  const int prow = (lane >> 4) * 64 + 16 * (warp & 3) + (lane & 15);\n"
     "  float x[3];\n"
     "  load_point(x3, np, tile * 128 + prow, x);"],
    ["    const long p0 = tile * PROP_PTS;\n"
     "    float xn[3];\n"
     "    load_point(x3, np, p0 + step * PROP_PTS + lane, xn);",
     "    const long p0 = tile * 128;\n"
     "    float xn[3];\n"
     "    load_point(x3, np, p0 + step * 128 + prow, xn);"],
    ["      if (p0 + lane < np) out[(long)r * np + p0 + lane] = v;",
     "      if (p0 + prow < np) out[(long)r * np + p0 + prow] = v;"],
    ["      ((np + PROP_PTS - 1) / PROP_PTS + PROP_WARPS - 1) / PROP_WARPS;",
     "      ((np + 127) / 128 + PROP_WARPS / 4 - 1) / (PROP_WARPS / 4);"],
]
VARIANTS = {
    "tmlp_no_encode": [[_TILE, "  const float sg = 0.0f * x[0];"]],
    "tmlp_no_chain": [[_CHAIN_CALL, "    for (int i = 0; i < NA; ++i) acc[i] = "
                                    "0.0f;"]],
    "tmlp_no_out": [["if (p0 + p < np) out[(long)r * np + p0 + p] = "
                     "b.outb[p * pl.ldo + r];",
                     "if (p0 + p < 0) out[(long)r * np + p0 + p] = "
                     "b.outb[p * pl.ldo + r];"]],
    "prop_no_encode": [["    prop_encode_of(net.enc_freqs, net.enc_scale, x, "
                        "buf + lane * pl.lde);", ""]],
    "prop_no_chain": [["    for (int l = 0; l <= last; ++l) {",
                       "    for (int l = 0; l <= last && l < 0; ++l) {"]],
    "prop_16x1": [["constexpr int PROP_WARPS = 12, PROP_BLOCKS = 1;",
                   "constexpr int PROP_WARPS = 16, PROP_BLOCKS = 1;"]],
    "prop_8x2": [_8X2],
    "prop_b_pairs": [[_B_ALL, _B_PAIRS], [_B_END, _B_PAIRS_END]],
    "prop_v1": [[_CHAIN, _V1_CHAIN], [_LAYERS, _V1_LAYERS], _8X2],
    "prop_v2": [[_CHAIN, _V2_CHAIN], [_LAYERS, _V2_LAYERS], [_HEAD, _V2_HEAD],
                _8X2],
    "prop_half_mma": [["      for (int i = 0; i < PROP_MT; ++i)\n"
                       "#pragma unroll\n"
                       "        for (int h = 0; h < 2; ++h) {\n"
                       "          const int nt",
                       "      for (int i = 0; i < 1; ++i)\n"
                       "#pragma unroll\n"
                       "        for (int h = 0; h < 2; ++h) {\n"
                       "          const int nt"]],
    "prop_no_ldsm_b": [["        ldsm_x4(b[jp], w + (2 * s * (kout >> 3) + "
                        "2 * jp) * 64);",
                        "        b[jp][0] = lane + s, b[jp][1] = lane * 3u, "
                        "b[jp][2] = lane ^ jp, b[jp][3] = s;"]],
    "prop_no_act": [["hA[i][s][%d] = pack_bf16(act(c%d[%d], net.leaky), "
                     "act(c%d[%d], net.leaky));" % (r, r // 2, e, r // 2, e + 1),
                     "hA[i][s][%d] = pack_bf16(c%d[%d], c%d[%d]);"
                     % (r, r // 2, e, r // 2, e + 1)]
                    for r, e in ((0, 0), (1, 2), (2, 0), (3, 2))],
    "prop_nv": [["// One layer of the warp's tile:", _NV + "// One layer of "
                 "the warp's tile:"],
                ["            mma_bf16(acc[i][nt], a[i]",
                 "            mma_bf16_nv(acc[i][nt], a[i]"]],
    "prop_wg": _WG,
}


#: what a run without NAME times: every variant that applies alone, and the
#: second design's experiments
DEFAULT = [n for n in VARIANTS if n != "prop_no_act"] + [
    "prop_v2+" + n for n in ("prop_half_mma", "prop_no_ldsm_b", "prop_no_act",
                             "prop_nv")]


def _subs(name, text):
    """The substitutions of `name` (variants joined by "+"), markers
    resolved to the blocks of `text` they bound, each applied in turn."""
    out = []
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if isinstance(old, tuple):
                i = text.index(old[0])
                old = text[i:text.index(old[1], i)]
            out.append([old, new])
            text = text.replace(old, new)
    return out


def _prepare(name):
    """Points the build at the variant's copy of csrc (`orig`: csrc)."""
    import kernel_variants as kv
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm

    if name != "orig":
        text = (_build.CSRC / "fused_mlp_t.cu").read_text()
        kv.use_variant("prop_" + name, {"fused_mlp_t.cu": _subs(name, text)})
    src = (_build.CSRC / "fused_mlp_t.cu").read_text()
    fm.PROP_WARPS = int(re.search(r"PROP_WARPS = (\d+)", src).group(1))
    return _build, fm


def _ptxas(log):
    """The register and spill lines of prop_kernel and the served bf16
    tmlp_kernel from nvcc's -Xptxas -v log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            entry = m.group(1)
        elif entry and ("prop_kernel" in entry or (
                "tmlp_kernel" in entry and "13__nv_bfloat16Li0E" in entry)) \
                and ("registers" in line or "spill" in line):
            out.append(f"{entry[:60]}: {line.strip()}")
    return out


def one(name):
    import torch

    import chip_smoke as cs

    _build, fm = _prepare(name)
    t0 = time.perf_counter()
    fm._lib()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "fused_mlp_t.log")
    ptxas = _ptxas(log.read_text()) if log.exists() else []
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sizes = [(33, 64), (64, 64), (64, 64), (64, 1)]

    def net():
        return fm.TransposedFieldMLP(
            [{"w": (torch.randn(i, o, generator=g, device=dev) / i ** 0.5)
              .to(torch.bfloat16)} for i, o in sizes], 5, 2.0)

    routes = {"prop": net()}
    routes["tmlp"] = fm.TransposedFieldMLP([{"w": w} for w in
                                            routes["prop"].ws], 5, 2.0)
    real = fm._prop_plan
    fm._prop_plan = lambda *a, **k: None
    try:
        fm.kernel_plan(routes["tmlp"])
    finally:
        fm._prop_plan = real
    got_routes = {r: fm.route(tm) for r, tm in routes.items()}
    res = {"variant": name, "build_s": build_s, "ptxas": ptxas,
           "routes": got_routes, "ms": {}, "digest": {}, "plain": {}}
    for shape, P in SHAPES.items():
        x = (torch.rand(3, P, generator=g, device=dev) * 4 - 2).contiguous()
        fns = [lambda tm=tm: fm.run_tmlp(x, tm, True)
               for tm in routes.values()]
        for r, t in zip(routes, cs.interleaved_ms(fns, REPS)):
            res["ms"].setdefault(r, {})[shape] = list(t)
        for r, tm in routes.items():
            out = fm.run_tmlp(x, tm, True)
            res["digest"].setdefault(r, {})[shape] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
            if shape in PLAIN_SHAPES:
                ref = torch.cat([fm.run_tmlp_plain(x[:, i:i + (1 << 21)], tm)
                                 for i in range(0, P, 1 << 21)], 1)
                d = (out - ref).abs()
                res["plain"].setdefault(r, {})[shape] = {
                    "max_abs_err": float(d.max()),
                    "past_grid_tol": int((d > cs.GRID_TOL + cs.GRID_TOL
                                          * ref.abs()).sum())}
                del ref, d
            del out
        if shape == "32,16":
            res["plain_ms_32_16"] = cs.interleaved_ms(
                [lambda: fm.run_tmlp_plain(x, routes["prop"])], 3)[0][0]
        del x
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main(names):
    from sanerf_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    jobs = []
    csrc, bdir = _build.CSRC, _build.BUILD_DIR
    for name in ["orig"] + names:
        _prepare(name)
        jobs.append(_build._start("fused_mlp_t", _build.CSRC,
                                  _build.BUILD_DIR))
        _build.CSRC, _build.BUILD_DIR = csrc, bdir
    t0 = time.perf_counter()
    for out, job in jobs:
        _build._finish("fused_mlp_t", out, job)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ["orig"] + names + ["orig"]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", name], capture_output=True, text=True,
                           timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode:
            print(json.dumps({"variant": name, "rc": r.returncode,
                              "stderr": r.stderr[-2000:]}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
    else:
        main(sys.argv[1:] or list(DEFAULT))
