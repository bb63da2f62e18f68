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
    "parent": "build/parent10",
}
