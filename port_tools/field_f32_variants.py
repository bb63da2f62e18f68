"""The float32 chains of csrc/fused_mlp_t.cu measured against the one it
ships (3xTF32 on mma.sync, each k step's three products into a zeroed
fragment added to the accumulator in float32, the tf32 rounding as
integer instructions, lo left to the tensor core, warpgroups a block as
wgs_of says, weights streamed with cp.async, a loop of constant n-tile
count for the widths 16, 32, 64 and 128), as text substitutions in that
source, for `port_tools/kernel_variants.py` (one process a variant, `orig`
at both ends):

    python3 port_tools/kernel_variants.py port_tools/field_f32_variants.py \
        NAME t2,asset32

  one_pass     one tf32 product a_hi b_hi, without the two small terms: the
               planted fault that chip_smoke's F32_FAITHFUL and float64
               holds must catch (about 10 bits of mantissa a product);
  running_acc  the three products summed into the accumulator itself (the
               tensor core's truncation at the accumulator's size);
  lo_rna       lo rounded to tf32 as well, not left to the tensor core;
  cvt_rna      the rounding by cvt.rna.tf32.f32 (four instructions where
               the source has two);
  ffma         the fallback design: CUDA-core FMAs (__fmaf_rn, one rounding
               each, whatever -fmad says) in the same register layout, each
               lane the 2 x 2 outputs of every n-tile, its rows' 8 columns
               of the k step gathered from the quad by shuffles, W^T rows
               read as float4 from the core matrices;
  sync_copy    a streamed layer copied through registers (block_copy), not
               by cp.async;
  w_global     weights that do not all fit in shared memory read through
               L2 instead of streamed a layer at a time (the plan's
               streaming buffer left unused);
  no_mma       the chain without its products (wrong outputs): the time of
               everything else;
  s_pairs      the hidden k steps two to a branch (kin_h is a multiple of
               16);
  enc_pairs    the encoding's k steps two at a time;
  wgs2         2 warpgroups a block in run_tmlp too (3 in the source);
  comp3        3 in the composite (2 in the source);
  nt_all       a loop of constant length for each of the eight n-tile
               counts (2, 4, ..., 16);
  nt_runtime   one loop for every width, its length read at run time;
  parent       the port of commit 664f5a2, unpacked under build/parent
               (`git archive 664f5a2 sanerf_tpu_torch | tar -x -C
               build/parent`): the CUDA-core chain of FMUL and FADD with
               its row-major weights.
"""

_MMA3 = """    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * nt + i] += c[i];"""

_K8_BODY = """  uint32_t ah[4], al[4];
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
""" + _MMA3 + """
  }"""

# rows g and g + 8 at the step's columns 0..7 from the quad's lanes; W^T
# rows 8 nt + 2t and 8 nt + 2t + 1 of the block: 16 contiguous floats
_FFMA_BODY = """  float x0[8], x1[8];
  const int q = lane & ~3, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x0[2 * j] = __shfl_sync(FULL, a[0], q | j);
    x0[2 * j + 1] = __shfl_sync(FULL, a[2], q | j);
    x1[2 * j] = __shfl_sync(FULL, a[1], q | j);
    x1[2 * j + 1] = __shfl_sync(FULL, a[3], q | j);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_n) break;
    const float4* r = reinterpret_cast<const float4*>(wb + nt * 64 + 16 * t);
    const float4 p0 = r[0], p1 = r[1], q0 = r[2], q1 = r[3];
    const float u[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    float* c = acc + 4 * nt;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[0] = __fmaf_rn(x0[k], u[k], c[0]);
      c[1] = __fmaf_rn(x0[k], v[k], c[1]);
      c[2] = __fmaf_rn(x1[k], u[k], c[2]);
      c[3] = __fmaf_rn(x1[k], v[k], c[3]);
    }
  }"""

_WGS = "F32_WGS = 3, F32_COMPOSITE_WGS = 2;"

_HID = """#pragma unroll
  for (int s = 0; s < NA / 4; ++s) {
    if (s < L.kin_h / 8) {
      const float a[4] = {hid[4 * s], hid[4 * s + 2], hid[4 * s + 1],
                          hid[4 * s + 3]};
      k8_step<NT>(acc, a, Wl + s * nt_n * 64, lane, nt_n);
    }
  }"""

_ENC = """  for (int k0 = 0; k0 < kA; k0 += 8, wb += kst) {
    const float2 r0 = *reinterpret_cast<const float2*>(e + k0);
    const float2 r1 = *reinterpret_cast<const float2*>(e + 8 * lde + k0);
    const float a[4] = {r0.x, r1.x, r0.y, r1.y};
    k8_step<NT>(acc, a, wb, lane, nt_n);
  }"""

_SWITCH = """    switch (L.kout) {
      case 16: layer_f32<2>(acc, hid, e, lde, Wl, L, l, lane, 2); break;
      case 32: layer_f32<4>(acc, hid, e, lde, Wl, L, l, lane, 4); break;
      case 64: layer_f32<8>(acc, hid, e, lde, Wl, L, l, lane, 8); break;
      case 128: layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, 16); break;
      default: layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, L.kout / 8);
    }"""

_NT_ALL = "    switch (L.kout / 16) {\n" + "".join(
    f"      case {c}: layer_f32<{2 * c}>(acc, hid, e, lde, Wl, L, l, lane, "
    f"{2 * c}); break;\n" for c in range(1, 8)) + (
    "      default: layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, 16);\n"
    "    }")

_STREAM = """      block_copy_async((void*)W,
                       reinterpret_cast<const float*>(net.w) + L.w_off,
                       L.kout * L.w_ld * 4);"""

VARIANTS = {
    "one_pass": [[_MMA3, """    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(c, ah, bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * nt + i] += c[i];"""]],
    "running_acc": [[_MMA3, """    mma_tf32(acc + 4 * nt, al, bh0, bh1);
    mma_tf32(acc + 4 * nt, ah, bl0, bl1);
    mma_tf32(acc + 4 * nt, ah, bh0, bh1);"""]],
    "lo_rna": [["  lo = __float_as_uint(v - __uint_as_float(hi));",
                "  lo = tf32_rna(v - __uint_as_float(hi));"]],
    "cvt_rna": [["  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                 """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));
  return r;"""]],
    "ffma": [[_K8_BODY, _FFMA_BODY]],
    "sync_copy": [[_STREAM, """      block_copy((void*)W, reinterpret_cast<const float*>(net.w) + L.w_off,
                 L.kout * L.w_ld * 4);"""]],
    "w_global": [["""    chain<V == V_BRANCHES>(net, W, pl.w_mode == W_STREAM, enc, pl.lde, acc,
                           warp, lane);""", """    const bool f32_stream = sizeof(T) == 4 && pl.w_mode == W_STREAM;
    chain<V == V_BRANCHES>(
        net, f32_stream ? reinterpret_cast<const T*>(net.w) : W,
        pl.w_mode == W_STREAM && !f32_stream, enc, pl.lde, acc, warp, lane);"""]],
    "no_mma": [[_MMA3, ""]],
    "s_pairs": [[_HID, """#pragma unroll
  for (int s = 0; s < NA / 4; s += 2) {
    if (s < L.kin_h / 8) {
#pragma unroll
      for (int j = s; j < s + 2; ++j) {
        const float a[4] = {hid[4 * j], hid[4 * j + 2], hid[4 * j + 1],
                            hid[4 * j + 3]};
        k8_step<NT>(acc, a, Wl + j * nt_n * 64, lane, nt_n);
      }
    }
  }"""]],
    "enc_pairs": [[_ENC, """  for (int k0 = 0; k0 < kA; k0 += 16, wb += 2 * kst) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 r0 = *reinterpret_cast<const float2*>(e + k0 + 8 * j);
      const float2 r1 =
          *reinterpret_cast<const float2*>(e + 8 * lde + k0 + 8 * j);
      const float a[4] = {r0.x, r1.x, r0.y, r1.y};
      k8_step<NT>(acc, a, wb + j * kst, lane, nt_n);
    }
  }"""]],
    "wgs2": [[_WGS, "F32_WGS = 2, F32_COMPOSITE_WGS = 2;"]],
    "comp3": [[_WGS, "F32_WGS = 3, F32_COMPOSITE_WGS = 3;"]],
    "nt_all": [[_SWITCH, _NT_ALL]],
    "nt_runtime": [[_SWITCH, """    layer_f32<16>(acc, hid, e, lde, Wl, L, l, lane, L.kout / 8);"""]],
    "parent": "build/parent",
}
