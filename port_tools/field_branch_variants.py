"""What the branches that csrc/fused_mlp_t.cu gained for biases, the
dense-sin encode and composites of any T cost the asset's own launches, as
text substitutions in that source, for `port_tools/kernel_variants.py`
(one process a variant; `orig` and the parent tree at both ends):

    python3 port_tools/kernel_variants.py port_tools/field_branch_variants.py \\
        NAME serve,asset32

  runtime_tests  the V_SERVED kernels (every served net) with the bias and
                 dense-sin tests at run time, as the V_BRANCHES ones have
                 them: the first design, one kernel for both;
  runtime_bias   the bias test alone at run time;
  runtime_dense  the dense-sin test alone at run time;
  old_point      the composite's step points without the padded-ray test
                 (right only where whole rays fill whole tiles, as at the
                 asset's T = 16 and 32);
  drop_carry     planted fault: the general composite's transmittance and
                 partial sums reset at every segment, not at a ray's first
                 (a ray longer than a step keeps its last segment's alone);
  lost_park      planted fault: the V_WIDE kernels' parked chunks read back
                 as zeros (what a lost park slot gives);
  prop_lost_k    planted fault: prop_kernel's layers past the first skip
                 the last k step of 16 inputs that their code has (a 64-wide
                 layer's last quarter);
  ring_lost_k    planted fault: the bf16 V_WIDE ring's producer leaves out
                 the last k block of every unit but a chunk's first (no
                 copy, no bytes expected: the consumers' products read
                 whatever that stage held before);
  grid_lost_vm   planted fault: the V_GRID encoders mark a slot full
                 without the last mode of the last VM level (its K
                 columns, the encoding's last): the consumer's chain reads
                 whatever the slot held there, the previous tile's
                 columns (zeros at a slot's first use);
  f32_ring_lost_k planted fault: the float32 V_WIDE32 ring's producer
                 leaves out the copy of every unit at an odd multiple of
                 8 columns past a chunk's first 16 (it arrives on the full
                 barrier with no bytes: the consumers' products read
                 whatever that stage held before);
  parent         the port of the commit before these branches, unpacked
                 under build/parent10 (`git archive d830384
                 sanerf_tpu_torch | tar -x -C build/parent10`).
"""

_BIAS = [["if (EXTRA && net.bias) add_bias(", "if (net.bias) add_bias("]]
_DENSE = [["if (EXTRA && !net.angle_double) {", "if (!net.angle_double) {"]]

VARIANTS = {
    "runtime_tests": _BIAS + _DENSE,
    "runtime_bias": _BIAS,
    "runtime_dense": _DENSE,
    "old_point": [["    return i < RT ? s * RT + i : np;",
                   "    return s * RT + i;"]],
    "drop_carry": [["        if (t_lo == 0) {  // the ray's first segment",
                    "        if (true) {"]],
    "lost_park": [["  for (int i = 0; i < NW; ++i) v[i] = p[i * 128];",
                   "  for (int i = 0; i < NW; ++i) v[i] = 0u * p[i * 128];"]],
    "prop_lost_k": [["  for (int s = 0; s < KS; ++s) {\n"
                     "    if (!EXACT && s >= ks) break;",
                     "  for (int s = 0; s < KS - (BUF ? 0 : 1); ++s) {\n"
                     "    if (!EXACT && s >= ks) break;"]],
    "ring_lost_k": [["        const int nkb = (min(k0 + UNIT_K, L.w_ld) - k0) / 8;",
                     "        const int nkb = (min(k0 + UNIT_K, L.w_ld) - k0) / 8"
                     " - (k0 > 0);"]],
    "grid_lost_vm": [
        ["    bf16* enc = sl.enc(s);\n",
         "    bf16* enc = sl.enc(s);\n"
         "    int lost = net.F;\n"
         "    for (int i = 0; i < net.g.n_cp; ++i) lost += net.g.cp[i].K;\n"
         "    for (int i = 0; i < net.g.n_vm; ++i) lost += 3 * net.g.vm[i].K;\n"
         "    lost = net.g.n_vm ? lost - net.g.vm[net.g.n_vm - 1].K : 1 << 30;\n"],
        ["        [&](int c, float v) { enc[enc_index<bf16>(row, c, 0)] = "
         "fromf<bf16>(v); });",
         "        [&](int c, float v) { if (c < lost) "
         "enc[enc_index<bf16>(row, c, 0)] = fromf<bf16>(v); });"]],
    "f32_ring_lost_k": [[
        "        if (lane == 0) {\n"
        "          wg::mbar_expect_tx(full, bytes);\n"
        "          wg::bulk_copy(wg::smem(f32_unit(r)), src, bytes, full);\n"
        "        }\n",
        "        const bool lost = k0 >= 16 && (k0 / 8) % 2;\n"
        "        wg::mbar_arrive_if(full, lane == 0 && lost);\n"
        "        if (lane == 0 && !lost) {\n"
        "          wg::mbar_expect_tx(full, bytes);\n"
        "          wg::bulk_copy(wg::smem(f32_unit(r)), src, bytes, full);\n"
        "        }\n"]],
    "parent": "build/parent10",
}
