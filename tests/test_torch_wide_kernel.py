"""The chains of the nets wider than 128 (the V_WIDE kernels of
csrc/fused_mlp_t.cu in bf16, the V_WIDE32 kernels in float32), which
stream the weights through a ring of units in shared memory: one producer
warp fills it with bulk copies, up to three consumer warpgroups run their
products on each unit and release it. The float32 ring's units are the
weights split on the host into tf32 hi and lo slabs, and its products are
3xTF32 on wgmma, each group of eight units (64 columns) into a fresh
accumulator.

On the CPU (the kernels run only on the card; tests/test_torch_cuda.py and
chip_smoke.py hold them against the plain version there):
  - the plans: every bf16 and float32 launch of widths 144-512 takes the
    ring and fits SMEM_LIMIT, and every other plan is the one the port had
    before the ring (a frozen table; the float32 nets wider than 128 on
    the route before the ring, kernel_plan's f32_ring False);
  - the host split of the float32 weights (hi + lo exactly the weight, hi
    the kernel's tf32 rounding) and its units at their offsets;
  - a model of the ring's schedule: a producer and consumer warpgroups
    that interleave at random, with the kernels' barrier protocol (full and
    empty barriers, parities, wgmma.wait_group 1 before a release): every
    (layer, chunk, k unit) of every tile reaches every warpgroup once, in
    ascending k, no stage is refilled before every warpgroup has released
    it, and a tail pass with fewer tiles than warpgroups ends; and three
    faults (a stage released before its products have waited, a
    warpgroup that skips a tail pass, a unit the producer leaves out) are
    caught by it; the float32 ring's schedule (units of 8 columns, two a
    group, the first released at wgmma.wait_group 1) alike;
  - the chain computed unit by unit in the ring's order, from the packed
    weights at the units' offsets, against run_tmlp_plain in float64, and
    at width 256 against the JAX package's run_tmlp in interpret mode; the
    float32 ring's chain as a numpy model of its products (each operand
    as the tensor core reads it, a group's sum fresh, then a float32 add)
    alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models import fields as jfields
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu_torch.ops import fused_mlp_t as tfm

torch.set_num_threads(1)

WIDTHS = (144, 192, 256, 320, 512)


def _net(width, dtype, depth=8, cp=32, seed=0):
    """The default field's shape at `width`: 63 Fourier columns (and a CP
    table of `cp` columns) -> width x depth - 1, the skip at depth / 2 ->
    16, leaky."""
    rng = np.random.default_rng(seed + width)
    F = 63
    sizes = ([(F + cp, width)]
             + [(width + (F + cp if l == depth // 2 else 0), width)
                for l in range(1, depth - 1)] + [(width, 16)])
    layers = [{"w": torch.from_numpy(rng.uniform(
        -1, 1, s).astype(np.float32) / np.sqrt(s[0])).to(dtype)}
        for s in sizes]
    tables = {}
    if cp:
        tables["cp_lines"] = torch.from_numpy(rng.uniform(
            0.5, 1.0, (3, 128, cp)).astype(np.float32)).to(dtype)
    return tfm.TransposedFieldMLP(layers, 10, 4.0, (depth // 2,), leaky=True,
                                  **tables)


def _view(H, dtype, seed=0):
    rng = np.random.default_rng(seed + H)
    return tfm.ViewMLP([{"w": torch.from_numpy(rng.uniform(
        -1, 1, s).astype(np.float32) / np.sqrt(s[0])).to(dtype)}
        for s in ((15 + 16, H), (H, H), (H, 3))], 16, 4)


# -- the plans ----------------------------------------------------------------


@pytest.mark.parametrize("T,H", [(None, None), (16, 32), (32, 32), (64, 32),
                                 (128, 32), (16, 48), (32, 48), (64, 48),
                                 (128, 48)])
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_wide_plans_take_the_ring(width, T, H):
    """run_tmlp (T None) and the composite at T 16-128, with the served
    epilogue (a view head 32 wide) and the general one (48): the ring of
    2-8 units of 16 KB, its barriers and (an encoding of 96 columns is not
    whole units) the zero block, then the view head and the warpgroups'
    buffers, within SMEM_LIMIT; no float32 unit; as many
    consumer warpgroups as fit, three up to width 256."""
    tm = _net(width, torch.bfloat16)
    p = tfm.kernel_plan(tm, T, None if H is None else _view(H,
                                                            torch.bfloat16))
    assert p.variant == tfm.V_WIDE and p.w_mode == tfm.W_RING
    assert p.unit_b == tfm.UNIT_B == 128 * 64 * 2 and p.unit_k == 0
    assert tfm.MIN_STAGES <= p.stages <= tfm.MAX_STAGES
    # the zero block: _net's encoding of 96 columns is not whole units
    assert p.w_bytes == (p.stages * tfm.UNIT_B + tfm.RING_BAR_B
                         + tfm.ZERO_B)
    assert p.total == p.w_bytes + p.v_bytes + p.wgs * p.per_wg
    assert p.total <= tfm.SMEM_LIMIT
    assert 1 <= p.wgs <= tfm.WIDE_WGS
    if width <= 256:
        assert p.wgs == tfm.WIDE_WGS
    assert p.general == (0 if T is None else int(H > 32 or width > 256))
    assert p.park_chunks == max(0, -(-width // 128) - 2)
    # one stage more would not fit (the most stages are taken)
    if p.stages < tfm.MAX_STAGES:
        assert p.total + tfm.UNIT_B > tfm.SMEM_LIMIT


def test_width_256_plans_of_the_served_field():
    """ModelConfig(mlp_field_width=256)'s field (63 Fourier columns, no
    table) and view head: three consumer warpgroups, five stages in
    run_tmlp, four in the composite of the served epilogue."""
    tm = _net(256, torch.bfloat16, cp=0)
    p = tfm.kernel_plan(tm)
    assert (p.wgs, p.stages) == (3, 5)
    assert p.w_bytes == 5 * tfm.UNIT_B + tfm.RING_BAR_B  # whole units
    for T in (16, 32):
        p = tfm.kernel_plan(tm, T, _view(32, torch.bfloat16))
        assert (p.wgs, p.stages, p.general) == (3, 4, 0)


@pytest.mark.parametrize("T,H", [(None, None), (16, 32), (32, 32), (64, 32),
                                 (128, 32), (16, 48), (32, 48), (64, 48),
                                 (128, 48)])
@pytest.mark.parametrize("width", WIDTHS)
def test_f32_wide_plans_take_the_ring(width, T, H):
    """float32, as the bf16 test above: the V_WIDE32 ring of 2-8 units of
    8 KB (hi and lo slabs of 128 rows over 8 columns), its barriers and no
    zero block (a layer's columns are whole pairs of units), then the
    view head and the warpgroups' buffers, within SMEM_LIMIT; two consumer
    warpgroups up to width 256, one past it; the most stages that fit;
    every chunk of a layer but the last parked. The steps and each
    warpgroup's buffers are those of the plan the port made before the
    ring (FROZEN): only where the weights live changed."""
    tm = _net(width, torch.float32)
    p = tfm.kernel_plan(tm, T, None if H is None else _view(H,
                                                            torch.float32))
    assert p.variant == tfm.V_WIDE32 and p.w_mode == tfm.W_RING
    assert p.unit_b == tfm.F32_UNIT_B == 128 * 8 * 4 * 2
    assert p.unit_k == tfm.F32_UNIT_K == 8
    assert tfm.MIN_STAGES <= p.stages <= tfm.MAX_STAGES
    assert p.w_bytes == p.stages * tfm.F32_UNIT_B + tfm.RING_BAR_B
    assert p.total == p.w_bytes + p.v_bytes + p.wgs * p.per_wg
    assert p.total <= tfm.SMEM_LIMIT
    assert p.wgs == (tfm.WIDE_F32_WGS if width <= 256 else 1)
    assert p.general == (0 if T is None else int(H > 32 or width > 256))
    assert p.park_chunks == -(-width // 128) - 1  # all chunks but the last
    if p.stages < tfm.MAX_STAGES:
        assert p.total + tfm.F32_UNIT_B > tfm.SMEM_LIMIT
    before = dict(zip(OLD_FIELDS, FROZEN[("f32", width, T, H)]))
    assert {f: getattr(p, f) for f in STEP_FIELDS} == {
        f: before[f] for f in STEP_FIELDS}


def test_width_256_f32_plans_of_the_served_field():
    """ModelConfig(mlp_field_width=256)'s field in float32 (the Trainer's
    evaluation weights) and view head on the ring: two consumer
    warpgroups, six stages in run_tmlp, four in the composite of the served
    epilogue (the view head in shared memory)."""
    tm = _net(256, torch.float32, cp=0)
    p = tfm.kernel_plan(tm)
    assert (p.variant, p.wgs, p.stages) == (tfm.V_WIDE32, 2, 6)
    for T in (16, 32):
        p = tfm.kernel_plan(tm, T, _view(32, torch.float32))
        assert (p.variant, p.wgs, p.stages, p.general) == (tfm.V_WIDE32, 2,
                                                           4, 0)
        assert p.v_bytes > 0


#: KernelPlan's fields before the ring, and the plans the port made before
#: it for the float32 nets at every width and the bf16 nets up to 128 wide:
#: (dtype, width, T, view width) -> those fields' values (_net(width,
#: dtype), _view(H, dtype); T None: run_tmlp). Past 128 the float32 nets
#: are on the V_WIDE32 ring since, which keeps STEP_FIELDS.
OLD_FIELDS = ('lde', 'ldo', 'M', 'R', 'ldh', 'wgs', 'w_mode', 'w_bytes',
              'v_bytes', 'enc_b', 'h_b', 'out_b', 'sig_b', 'wts_b', 'ts_b',
              'vin_b', 'per_wg', 'total', 'nseg', 'vld', 'unit_k',
              'park_chunks', 'variant', 'small', 'general', 'prop')
#: the steps and a warpgroup's buffers, which the float32 ring did not change
STEP_FIELDS = ('lde', 'ldo', 'M', 'R', 'ldh', 'enc_b', 'h_b', 'out_b',
               'sig_b', 'wts_b', 'ts_b', 'vin_b', 'per_wg', 'nseg', 'vld',
               'small', 'general', 'prop')
FROZEN = {
    ('bf16', 64, None, None): (
        96, 17, 64, 0, 64, 3, 1, 75776, 0, 12288, 0, 4352, 256, 0, 0, 0,
        16896, 126464, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 64, 16, 32): (
        96, 17, 64, 4, 64, 4, 1, 75776, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 159744, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 64, 16, 48): (
        96, 17, 64, 4, 64, 4, 1, 75776, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 165888, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 64, 32, 32): (
        96, 17, 64, 2, 64, 4, 1, 75776, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 159744, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 64, 32, 48): (
        96, 17, 64, 2, 64, 4, 1, 75776, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 165888, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 64, 64, 32): (
        96, 17, 64, 1, 64, 4, 1, 75776, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 159744, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 64, 64, 48): (
        96, 17, 64, 1, 64, 4, 1, 75776, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 165888, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 64, 128, 32): (
        96, 17, 128, 1, 64, 4, 1, 75776, 6144, 12288, 0, 8704, 256, 512, 512,
        2048, 24320, 179200, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 64, 128, 48): (
        96, 17, 128, 1, 64, 4, 1, 75776, 12288, 12288, 0, 8704, 256, 512, 512,
        2048, 24320, 185344, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 128, None, None): (
        96, 17, 64, 0, 128, 3, 2, 57344, 0, 12288, 0, 4352, 256, 0, 0, 0,
        16896, 108032, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 128, 16, 32): (
        96, 17, 64, 4, 128, 4, 2, 57344, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 141312, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 128, 16, 48): (
        96, 17, 64, 4, 128, 4, 2, 57344, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 147456, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 128, 32, 32): (
        96, 17, 64, 2, 128, 4, 2, 57344, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 141312, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 128, 32, 48): (
        96, 17, 64, 2, 128, 4, 2, 57344, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 147456, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 128, 64, 32): (
        96, 17, 64, 1, 128, 4, 2, 57344, 6144, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 141312, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 128, 64, 48): (
        96, 17, 64, 1, 128, 4, 2, 57344, 12288, 12288, 0, 4352, 256, 256, 256,
        2048, 19456, 147456, 1, 128, 0, 0, 0, 0, 1, 0),
    ('bf16', 128, 128, 32): (
        96, 17, 128, 1, 128, 4, 2, 57344, 6144, 12288, 0, 8704, 256, 512, 512,
        2048, 24320, 160768, 1, 128, 0, 0, 0, 0, 0, 0),
    ('bf16', 128, 128, 48): (
        96, 17, 128, 1, 128, 4, 2, 57344, 12288, 12288, 0, 8704, 256, 512,
        512, 2048, 24320, 166912, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 64, None, None): (
        104, 17, 64, 0, 72, 3, 2, 40960, 0, 26624, 0, 4352, 256, 0, 0, 0,
        31232, 134656, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 64, 16, 32): (
        104, 17, 64, 4, 72, 2, 1, 151552, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 231424, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 64, 16, 48): (
        104, 17, 64, 4, 72, 2, 1, 151552, 0, 26624, 0, 4352, 256, 256, 256,
        2048, 33792, 219136, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 64, 32, 32): (
        104, 17, 64, 2, 72, 2, 1, 151552, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 231424, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 64, 32, 48): (
        104, 17, 64, 2, 72, 2, 1, 151552, 0, 26624, 0, 4352, 256, 256, 256,
        2048, 33792, 219136, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 64, 64, 32): (
        104, 17, 64, 1, 72, 2, 1, 151552, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 231424, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 64, 64, 48): (
        104, 17, 64, 1, 72, 2, 1, 151552, 0, 26624, 0, 4352, 256, 256, 256,
        2048, 33792, 219136, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 64, 128, 32): (
        104, 17, 128, 1, 72, 2, 1, 151552, 0, 26624, 0, 8704, 256, 512, 512,
        2048, 38656, 228864, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 64, 128, 48): (
        104, 17, 128, 1, 72, 2, 1, 151552, 0, 26624, 0, 8704, 256, 512, 512,
        2048, 38656, 228864, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 128, None, None): (
        104, 17, 64, 0, 136, 3, 2, 114688, 0, 26624, 0, 4352, 256, 0, 0, 0,
        31232, 208384, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 128, 16, 32): (
        104, 17, 64, 4, 136, 2, 2, 114688, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 194560, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 128, 16, 48): (
        104, 17, 64, 4, 136, 2, 2, 114688, 24576, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 206848, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 128, 32, 32): (
        104, 17, 64, 2, 136, 2, 2, 114688, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 194560, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 128, 32, 48): (
        104, 17, 64, 2, 136, 2, 2, 114688, 24576, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 206848, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 128, 64, 32): (
        104, 17, 64, 1, 136, 2, 2, 114688, 12288, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 194560, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 128, 64, 48): (
        104, 17, 64, 1, 136, 2, 2, 114688, 24576, 26624, 0, 4352, 256, 256,
        256, 2048, 33792, 206848, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 128, 128, 32): (
        104, 17, 128, 1, 136, 2, 2, 114688, 12288, 26624, 0, 8704, 256, 512,
        512, 2048, 38656, 204288, 1, 128, 0, 0, 0, 0, 0, 0),
    ('f32', 128, 128, 48): (
        104, 17, 128, 1, 136, 2, 2, 114688, 24576, 26624, 0, 8704, 256, 512,
        512, 2048, 38656, 216576, 1, 128, 0, 0, 0, 0, 1, 0),
    ('f32', 144, None, None): (
        104, 17, 64, 0, 152, 2, 2, 32768, 0, 26624, 38912, 4352, 256, 0, 0, 0,
        70144, 173056, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 144, 16, 32): (
        104, 17, 64, 4, 152, 2, 2, 32768, 12288, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 190464, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 144, 16, 48): (
        104, 17, 64, 4, 152, 2, 2, 32768, 24576, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 202752, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 144, 32, 32): (
        104, 17, 64, 2, 152, 2, 2, 32768, 12288, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 190464, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 144, 32, 48): (
        104, 17, 64, 2, 152, 2, 2, 32768, 24576, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 202752, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 144, 64, 32): (
        104, 17, 64, 1, 152, 2, 2, 32768, 12288, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 190464, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 144, 64, 48): (
        104, 17, 64, 1, 152, 2, 2, 32768, 24576, 26624, 38912, 4352, 256, 256,
        256, 2048, 72704, 202752, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 144, 128, 32): (
        104, 17, 128, 1, 152, 2, 2, 32768, 12288, 26624, 38912, 8704, 256,
        512, 512, 2048, 77568, 200192, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 144, 128, 48): (
        104, 17, 128, 1, 152, 2, 2, 32768, 24576, 26624, 38912, 8704, 256,
        512, 512, 2048, 77568, 212480, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 192, None, None): (
        104, 17, 64, 0, 200, 2, 2, 32768, 0, 26624, 51200, 4352, 256, 0, 0, 0,
        82432, 197632, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 192, 16, 32): (
        104, 17, 64, 4, 200, 2, 2, 32768, 12288, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 215040, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 192, 16, 48): (
        104, 17, 64, 4, 200, 2, 2, 32768, 24576, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 227328, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 192, 32, 32): (
        104, 17, 64, 2, 200, 2, 2, 32768, 12288, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 215040, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 192, 32, 48): (
        104, 17, 64, 2, 200, 2, 2, 32768, 24576, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 227328, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 192, 64, 32): (
        104, 17, 64, 1, 200, 2, 2, 32768, 12288, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 215040, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 192, 64, 48): (
        104, 17, 64, 1, 200, 2, 2, 32768, 24576, 26624, 51200, 4352, 256, 256,
        256, 2048, 84992, 227328, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 192, 128, 32): (
        104, 17, 128, 1, 200, 2, 2, 32768, 12288, 26624, 51200, 8704, 256,
        512, 512, 2048, 89856, 224768, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 192, 128, 48): (
        104, 17, 128, 1, 200, 2, 2, 32768, 0, 26624, 51200, 8704, 256, 512,
        512, 2048, 89856, 212480, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 256, None, None): (
        104, 17, 64, 0, 264, 2, 2, 32768, 0, 26624, 67584, 4352, 256, 0, 0, 0,
        98816, 230400, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 256, 16, 32): (
        104, 17, 64, 4, 264, 1, 2, 32768, 12288, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 146432, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 256, 16, 48): (
        104, 17, 64, 4, 264, 1, 2, 32768, 24576, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 158720, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 256, 32, 32): (
        104, 17, 64, 2, 264, 1, 2, 32768, 12288, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 146432, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 256, 32, 48): (
        104, 17, 64, 2, 264, 1, 2, 32768, 24576, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 158720, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 256, 64, 32): (
        104, 17, 64, 1, 264, 1, 2, 32768, 12288, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 146432, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 256, 64, 48): (
        104, 17, 64, 1, 264, 1, 2, 32768, 24576, 26624, 67584, 4352, 256, 256,
        256, 2048, 101376, 158720, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 256, 128, 32): (
        104, 17, 128, 1, 264, 1, 2, 32768, 12288, 26624, 67584, 8704, 256,
        512, 512, 2048, 106240, 151296, 1, 128, 64, 0, 2, 0, 0, 0),
    ('f32', 256, 128, 48): (
        104, 17, 128, 1, 264, 1, 2, 32768, 24576, 26624, 67584, 8704, 256,
        512, 512, 2048, 106240, 163584, 1, 128, 64, 0, 2, 0, 1, 0),
    ('f32', 320, None, None): (
        104, 17, 64, 0, 328, 1, 2, 32768, 0, 26624, 83968, 4352, 256, 0, 0, 0,
        115200, 147968, 1, 128, 64, 1, 2, 0, 0, 0),
    ('f32', 320, 16, 32): (
        104, 17, 64, 4, 328, 1, 2, 32768, 12288, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 162816, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 16, 48): (
        104, 17, 64, 4, 328, 1, 2, 32768, 24576, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 175104, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 32, 32): (
        104, 17, 64, 2, 328, 1, 2, 32768, 12288, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 162816, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 32, 48): (
        104, 17, 64, 2, 328, 1, 2, 32768, 24576, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 175104, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 64, 32): (
        104, 17, 64, 1, 328, 1, 2, 32768, 12288, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 162816, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 64, 48): (
        104, 17, 64, 1, 328, 1, 2, 32768, 24576, 26624, 83968, 4352, 256, 256,
        256, 2048, 117760, 175104, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 128, 32): (
        104, 17, 128, 1, 328, 1, 2, 32768, 12288, 26624, 83968, 8704, 256,
        512, 512, 2048, 122624, 167680, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 320, 128, 48): (
        104, 17, 128, 1, 328, 1, 2, 32768, 24576, 26624, 83968, 8704, 256,
        512, 512, 2048, 122624, 179968, 1, 128, 64, 1, 2, 0, 1, 0),
    ('f32', 512, None, None): (
        104, 17, 64, 0, 520, 1, 2, 32768, 0, 26624, 133120, 4352, 256, 0, 0,
        0, 164352, 197120, 1, 128, 64, 2, 2, 0, 0, 0),
    ('f32', 512, 16, 32): (
        104, 17, 64, 4, 520, 1, 2, 32768, 12288, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 211968, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 16, 48): (
        104, 17, 64, 4, 520, 1, 2, 32768, 24576, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 224256, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 32, 32): (
        104, 17, 64, 2, 520, 1, 2, 32768, 12288, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 211968, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 32, 48): (
        104, 17, 64, 2, 520, 1, 2, 32768, 24576, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 224256, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 64, 32): (
        104, 17, 64, 1, 520, 1, 2, 32768, 12288, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 211968, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 64, 48): (
        104, 17, 64, 1, 520, 1, 2, 32768, 24576, 26624, 133120, 4352, 256,
        256, 256, 2048, 166912, 224256, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 128, 32): (
        104, 17, 128, 1, 520, 1, 2, 32768, 12288, 26624, 133120, 8704, 256,
        512, 512, 2048, 171776, 216832, 1, 128, 64, 2, 2, 0, 1, 0),
    ('f32', 512, 128, 48): (
        104, 17, 128, 1, 520, 1, 2, 32768, 24576, 26624, 133120, 8704, 256,
        512, 512, 2048, 171776, 229120, 1, 128, 64, 2, 2, 0, 1, 0),
}


@pytest.mark.parametrize("dtype,width", [
    ("bf16", 64), ("bf16", 128), ("f32", 64), ("f32", 128)])
def test_other_plans_as_before(dtype, width):
    """Every plan but the rings' is the one the port made before the ring,
    field for field, with no ring (stages, unit_b 0)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    keys = [k for k in FROZEN if k[:2] == (dtype, width)]
    assert len(keys) == 9
    for _, _, T, H in keys:
        p = tfm.kernel_plan(_net(width, dt), T,
                            None if H is None else _view(H, dt))
        assert tuple(getattr(p, f) for f in OLD_FIELDS) == FROZEN[
            (dtype, width, T, H)], (dtype, width, T, H)
        assert (p.stages, p.unit_b) == (0, 0) and p.w_mode != tfm.W_RING


# -- a model of the ring's schedule ------------------------------------------


def _ring_units(tm, split=False):
    """The weight units of one tile's chain in the order the bf16 V_WIDE
    kernels stream them through their ring (csrc/fused_mlp_t.cu:
    ring_fill_tile, chain_wide): layer by layer, chunk by chunk of CHUNK
    outputs, UNIT_K columns at a time in ascending k. Each is (layer, n0,
    nw, k0, k1, offsets): W^T rows [n0, n0 + nw) over columns [k0, k1),
    and for each of its k blocks the element offset in packed()'s flat
    weights of its nw / 8 contiguous core matrices (nw * 8 elements; the
    unit's bulk copies). With `split`, the V_WIDE32 ring's (ring_fill_tile
    _f32): F32_UNIT_K columns a unit, one offset, the unit's start in
    packed(split=True)'s flat weights (16 nw elements: its hi slab, then
    its lo slab; a layer's units from twice its w_off, in this order)."""
    desc, _ = tm.layout()
    out = []
    unit_k = tfm.F32_UNIT_K if split else tfm.UNIT_K
    for l, (_, _, kout, _, w_off, w_ld) in enumerate(tfm._layer_rows(desc)):
        for n0 in range(0, kout, tfm.CHUNK):
            nw = min(tfm.CHUNK, kout - n0)
            for k0 in range(0, w_ld, unit_k):
                k1 = min(k0 + unit_k, w_ld)
                offs = ([2 * w_off + 2 * n0 * w_ld + 2 * nw * k0] if split
                        else [w_off + (kb * (kout // 8) + n0 // 8) * 64
                              for kb in range(k0 // 8, k1 // 8)])
                out.append((l, n0, nw, k0, k1, offs))
    return out


class _Barrier:
    """An mbarrier: `count` arrivals complete a phase."""

    def __init__(self, count):
        self.count, self.arrived, self.done = count, 0, 0

    def arrive(self, n=1):
        self.arrived += n
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.arrived, self.done = 0, self.done + 1

    def passes(self, parity):
        """mbarrier.try_wait.parity: the phase of this parity completed
        (the current phase's parity differs)."""
        return self.done % 2 != parity


class _Sim:
    """The producer warp and `wgs` consumer warpgroups of one block, over
    `passes` passes of `units` (_ring_units of one tile), as
    csrc/fused_mlp_t.cu runs them: the producer waits on a stage's empty
    barrier (parity phase ^ 1), arrives on its full barrier and starts the
    copy; a copy lands later; a warpgroup waits on the full barrier (parity
    phase), issues its products on the unit, and at its next
    wgmma.wait_group 1 (or a chunk's wait_group 0) they are done and its
    four warps release the stage. With `group` (the V_WIDE32 ring,
    chunk_units_f32: a fresh accumulator every `group` units) the
    wait_group 0 comes at a group's last unit, not only at a chunk's.
    Faults: "early_release" (a stage released when its products are
    issued), "skip_tail" (warpgroups past the real tiles skip the last
    pass), "skip_unit" (the producer leaves out one unit)."""

    def __init__(self, units, wgs, stages, passes, rng, fault=None,
                 group=None):
        self.units, self.wgs, self.S, self.rng = units, wgs, stages, rng
        self.fault, self.group = fault, group
        # a full barrier's phase: the producer's arrival and its copy's
        # bytes (arrive.expect_tx, complete_tx), in either order
        self.full = [_Barrier(2) for _ in range(stages)]
        self.empty = [_Barrier(4 * wgs) for _ in range(stages)]
        self.tag = [None] * stages  # the unit a stage holds (sequence no.)
        self.readers = [set() for _ in range(stages)]
        self.in_flight = []  # (stage, unit) copies that have not landed
        seq = [u for _ in range(passes) for u in range(len(units))]
        self.todo = len(seq)
        self.p = dict(i=0, stage=0, phase=0, seq=list(range(len(seq))))
        if fault == "skip_unit":
            del self.p["seq"][len(units) + 3]
        self.c = []
        for w in range(wgs):
            n = len(seq) - (len(units) if fault == "skip_tail" and w else 0)
            self.c.append(dict(i=0, n=n, stage=0, phase=0, prev=None,
                               issued=None, got=[]))
        self.errors = []

    def _chunk_end(self, i):
        """Unit i's products end with wait_group 0: a chunk's last unit,
        or with `group` a group's (its columns end at a multiple of
        group units)."""
        u, v = self.units[i % len(self.units)], None
        if (i + 1) % len(self.units):
            v = self.units[(i + 1) % len(self.units)]
        if self.group and u[4] % (self.group * (u[4] - u[3])) == 0:
            return True
        return v is None or v[:2] != u[:2]

    def steps(self):
        """The actions that can run now."""
        out = []
        p = self.p
        if p["i"] < len(p["seq"]) and self.empty[p["stage"]].passes(
                p["phase"] ^ 1):
            out.append(("fill", None))
        if self.in_flight:
            out.append(("land", None))
        for w, c in enumerate(self.c):
            if c["issued"] is not None:
                out.append(("wait", w))
            elif c["i"] < c["n"] and self.full[c["stage"]].passes(
                    c["phase"]):
                out.append(("issue", w))
        return out

    def fill(self, _):
        p = self.p
        s = p["stage"]
        if self.readers[s]:
            self.errors.append(f"stage {s} refilled while read")
        self.full[s].arrive()
        self.in_flight.append((s, p["seq"][p["i"]]))
        p["i"] += 1
        p["stage"] = (s + 1) % self.S
        if p["stage"] == 0:
            p["phase"] ^= 1

    def land(self, _):
        s, unit = self.in_flight.pop(self.rng.integers(len(self.in_flight)))
        self.tag[s] = unit
        self.full[s].arrive()

    def issue(self, w):
        c = self.c[w]
        s = c["stage"]
        if self.tag[s] != c["i"]:
            self.errors.append(f"wg {w} read unit {self.tag[s]} as {c['i']}")
        c["got"].append(self.tag[s])
        self.readers[s].add(w)
        c["issued"] = s
        if self.fault == "early_release":
            self.empty[s].arrive(4)

    def wait(self, w):
        c = self.c[w]
        s = c["issued"]
        release = []
        if c["prev"] is not None:  # wait_group 1: the unit before is done
            release.append(c["prev"])
        c["prev"] = s
        if self._chunk_end(c["i"]):  # wait_group 0 at a chunk's end
            release.append(s)
            c["prev"] = None
        for r in release:
            self.readers[r].discard(w)
            if self.fault != "early_release":
                self.empty[r].arrive(4)
        c["issued"] = None
        c["i"] += 1
        c["stage"] = (s + 1) % self.S
        if c["stage"] == 0:
            c["phase"] ^= 1

    def run(self):
        """-> True when every actor ended, False at a deadlock."""
        while True:
            acts = self.steps()
            if not acts:
                return (self.p["i"] == len(self.p["seq"])
                        and all(c["i"] == c["n"] for c in self.c))
            kind, arg = acts[self.rng.integers(len(acts))]
            getattr(self, kind)(arg)


def _passes(n_tiles, grid, wgs, block):
    """The passes block `block` makes over n_tiles (tmlp_kernel's loop,
    and the count its producer fills for)."""
    first, apart = block * wgs, grid * wgs
    return (n_tiles - first + apart - 1) // apart if first < n_tiles else 0


@pytest.mark.parametrize("width,wgs,stages,n_tiles,grid", [
    (256, 3, 4, 7, 2), (256, 3, 2, 4, 1), (144, 2, 5, 3, 1),
    (512, 2, 3, 5, 2), (320, 3, 3, 1, 1), (256, 1, 2, 3, 2)])
def test_ring_schedule(width, wgs, stages, n_tiles, grid):
    """Random interleavings of the ring's producer and consumers (tail
    passes included: 7 tiles over 2 blocks of 3 warpgroups, 1 tile for 3):
    the run ends, every warpgroup reads every unit of every pass once in
    the producer's order, which is _ring_units' (layer, chunk, ascending
    k), and no stage is refilled while a warpgroup's products read it."""
    tm = _net(width, torch.bfloat16)
    units = _ring_units(tm)
    rows = tfm._layer_rows(tm.layout()[0])
    for u, v in zip(units, units[1:] + [None]):
        if v is not None and u[:2] == v[:2]:
            assert v[3] == u[4]  # the next unit of a chunk: ascending k
        else:  # a chunk's last unit ends at the layer's last column
            assert u[4] == rows[u[0]][5] and (v is None or v[3] == 0)
    for block in range(grid):
        passes = _passes(n_tiles, grid, wgs, block)
        for seed in range(3):
            sim = _Sim(units, wgs, stages, passes,
                       np.random.default_rng(seed))
            assert sim.run(), "deadlock"
            assert not sim.errors, sim.errors[:3]
            for c in sim.c:
                assert c["got"] == list(range(passes * len(units)))
            assert all(not r for r in sim.readers)


@pytest.mark.parametrize("fault", ["early_release", "skip_tail",
                                   "skip_unit"])
def test_ring_schedule_faults(fault):
    """The model catches the protocol's faults: a stage released when its
    products are issued (refilled while they read it, in some
    interleaving), warpgroups that skip a tail pass in which they have no
    tile (the producer waits for their release for ever), a unit the
    producer leaves out (a warpgroup reads the wrong unit)."""
    units = _ring_units(_net(256, torch.bfloat16))
    caught = 0
    for seed in range(20):
        sim = _Sim(units, 3, 2, 2, np.random.default_rng(seed), fault)
        ended = sim.run()
        caught += (not ended) or bool(sim.errors)
    assert caught >= 10


@pytest.mark.parametrize("width,wgs,stages,n_tiles,grid", [
    (256, 2, 4, 7, 2), (256, 2, 2, 4, 1), (144, 2, 8, 3, 1),
    (512, 1, 3, 5, 2), (320, 1, 8, 1, 1), (192, 1, 2, 3, 2)])
def test_f32_ring_schedule(width, wgs, stages, n_tiles, grid):
    """The V_WIDE32 ring's units (8 columns each, an even number a chunk:
    the kernel issues them two by two) and its protocol (a fresh
    accumulator every F32_GROUP units): in random interleavings the run
    ends, every warpgroup reads every unit of every pass once in the
    producer's order, and no stage is refilled while a warpgroup's
    products read it, with two stages too."""
    tm = _net(width, torch.float32)
    units = _ring_units(tm, split=True)
    rows = tfm._layer_rows(tm.layout()[0])
    n_chunk = {}
    for u in units:
        assert u[4] - u[3] == tfm.F32_UNIT_K
        n_chunk[u[:2]] = n_chunk.get(u[:2], 0) + 1
    assert all(n % 2 == 0 for n in n_chunk.values())
    assert sum(n_chunk.values()) == sum(
        -(-r[2] // tfm.CHUNK) * r[5] // tfm.F32_UNIT_K for r in rows)
    for block in range(grid):
        passes = _passes(n_tiles, grid, wgs, block)
        for seed in range(3):
            sim = _Sim(units, wgs, stages, passes,
                       np.random.default_rng(seed), group=tfm.F32_GROUP)
            assert sim.run(), "deadlock"
            assert not sim.errors, sim.errors[:3]
            for c in sim.c:
                assert c["got"] == list(range(passes * len(units)))
            assert all(not r for r in sim.readers)


@pytest.mark.parametrize("fault", ["early_release", "skip_tail",
                                   "skip_unit"])
def test_f32_ring_schedule_faults(fault):
    """The float32 ring's model catches the same faults."""
    units = _ring_units(_net(256, torch.float32), split=True)
    caught = 0
    for seed in range(20):
        sim = _Sim(units, 2, 3, 2, np.random.default_rng(seed), fault,
                   group=tfm.F32_GROUP)
        ended = sim.run()
        caught += (not ended) or bool(sim.errors)
    assert caught >= 10


# -- the chain in the ring's order -------------------------------------------


def _chain_in_ring_order(tm, xT):
    """tm's chain in float64, each layer's sums taken unit by unit in
    _ring_units' order from the packed bf16 weights at the units' offsets
    (the bulk copies' sources), the activations rounded to bf16."""
    flat, desc = tm.packed(torch.device("cpu"))
    w = flat.double()
    enc, sig = tm.encode_plain(xT, torch.float64)
    rows = tfm._layer_rows(desc)
    P, ke = enc.shape[0], int(desc[4])
    e = torch.zeros(P, ke, dtype=torch.float64)
    e[:, :enc.shape[1]] = enc
    h, acc = e, None
    units = _ring_units(tm)
    for i, (l, n0, nw, k0, k1, offs) in enumerate(units):
        kin_h, kin_e, kout, fout, _, _ = rows[l]
        if acc is None:
            acc = torch.zeros(P, kout, dtype=torch.float64)
        for j, off in enumerate(offs):
            col = k0 + 8 * j
            wt = w[off:off + nw * 8].reshape(nw, 8)  # W^T rows, 8 columns
            a = h[:, col:col + 8] if col < kin_h else e[:, col - kin_h:
                                                        col - kin_h + 8]
            acc[:, n0:n0 + nw] += a @ wt.T
        if i + 1 < len(units) and units[i + 1][0] == l:
            continue
        if l == len(rows) - 1:
            out = acc[:, :fout]
            if sig is not None:
                out[:, 0] += sig
            return out
        act = torch.where(acc >= 0, acc, 0.01 * acc) if tm.leaky else \
            acc.clamp(min=0.0)
        h, acc = act.to(tm.dtype).double(), None
    raise AssertionError("unreachable")


@pytest.mark.parametrize("width", [256, 512])
def test_chain_in_ring_order_matches_plain(width):
    """Every weight of the chain reaches its products through exactly one
    unit at the offsets the producer copies from: the chain summed unit by
    unit equals run_tmlp_plain's (both float64, activations rounded to
    bf16 between layers)."""
    tm = _net(width, torch.bfloat16)
    xT = torch.from_numpy(np.random.default_rng(width).uniform(
        -4, 4, (3, 48)).astype(np.float32))
    got = _chain_in_ring_order(tm, xT)
    ref = tm.forward_plain(xT, torch.float64)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def test_chain_in_ring_order_matches_jax():
    """At width 256 (4 layers, the skip at 2) the chain in the ring's order
    against the JAX package's run_tmlp (the Pallas kernel in interpret
    mode) at its suite's chain bound, 2e-4."""
    import jax

    layers = jfields.init_skip_mlp(jax.random.key(256), 27, 16, 256, 4,
                                   (2,), bias=False)
    x = np.random.default_rng(256).uniform(-2, 2, (40, 3)).astype(np.float32)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), layers, 4, 2.0, (2,),
                                  leaky=True, block=16, interpret=True))
    tm = tfm.TransposedFieldMLP(
        [{"w": torch.tensor(np.asarray(p["w"], np.float32))} for p in layers],
        4, 2.0, (2,), leaky=True)
    got = _chain_in_ring_order(tm, torch.from_numpy(x.T.copy()))
    np.testing.assert_allclose(got.T.numpy(), ref[:16], rtol=2e-4,
                               atol=2e-4)


# -- the float32 ring: the host split and a model of its products -----------


def _tf32_rna(v):
    """float32 -> its tf32 rounding as csrc/fused_mlp_t.cu:tf32_rna gives
    it (to nearest, ties away from zero: the low 13 bits zero)."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _tf32_read(v):
    """float32 as the tensor core reads a tf32 operand: its low 13 bits
    dropped."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return (b & np.uint32(0xffffe000)).view(np.float32)


def _unit_slabs(flat, off, nw):
    """(hi, lo), each [nw, 8] in the unit's k-slot order (F32_SLOTS), from
    the split unit at element `off`: [hi | lo] x [k block 0 | 1] x nw / 8
    core matrices of 8 rows x 4 floats."""
    b = flat[off:off + 16 * nw].reshape(2, 2, nw // 8, 8, 4)
    return tuple(b[i].transpose(1, 2, 0, 3).reshape(nw, 8) for i in (0, 1))


def test_f32_split_units():
    """TransposedFieldMLP.packed(split=True), the V_WIDE32 ring's weights:
    at each unit's offset (_ring_units with split) its hi and lo slabs
    hold W^T's rows [n0, n0 + nw) over the unit's 8 columns in the order
    F32_SLOTS; hi + lo is W^T exactly, hi's low 13 bits are zero and hi is
    the kernel's tf32 rounding (tf32_rna; weights on a tie round away from
    zero); every other element of the flat weights is padding (zero).
    Width 320: chunks of 128, 128 and 64 rows."""
    tm = _net(320, torch.float32)
    w0 = tm.ws[0].clone()
    ties = np.asarray([0x3f801000, 0xbf801000, 0x3e00f000, 0x40fff000],
                      np.uint32).view(np.float32)
    w0.view(-1)[:4] = torch.from_numpy(ties)
    tm = tfm.TransposedFieldMLP([{"w": w0}] + [{"w": w} for w in tm.ws[1:]],
                                10, 4.0, (4,), leaky=True, cp_lines=tm.cp[0])
    flat, desc = tm.packed(torch.device("cpu"), split=True)
    f = flat.numpy()
    assert f.size == 2 * tm.layout()[1]
    seen = np.zeros(f.size, bool)
    for l, n0, nw, k0, k1, (off,) in _ring_units(tm, split=True):
        wt = tm.transposed(l).numpy()[n0:n0 + nw, k0:k1][
            :, list(tfm.F32_SLOTS)]
        hi, lo = _unit_slabs(f, off, nw)
        np.testing.assert_array_equal(hi + lo, wt)
        assert not (hi.view(np.uint32) & np.uint32(0x1fff)).any()
        np.testing.assert_array_equal(hi, _tf32_rna(wt))
        assert not seen[off:off + 16 * nw].any()
        seen[off:off + 16 * nw] = True
    assert not f[~seen].any()
    hi_t, _ = tfm.tf32_split(torch.from_numpy(ties))
    np.testing.assert_array_equal(
        hi_t.numpy().view(np.uint32),
        np.asarray([0x3f802000, 0xbf802000, 0x3e010000, 0x41000000],
                   np.uint32))


def _chain_f32_model(tm, xT):
    """The V_WIDE32 kernels' chain as a numpy model (csrc/fused_mlp_t.cu:
    chunk_units_f32): from the split weights unit by unit at the ring's
    offsets, each k step's products a_lo b_hi + a_hi b_lo + a_hi b_hi with
    every operand as the tensor core reads it (a_hi the tf32 rounding of
    the float32 activation, a_lo the rest, each truncated to tf32), a
    group's products summed fresh (float64), then one float32 add into
    the chunk's sums; biases and the sigma sum added in float32, the
    activations kept in float32 between layers."""
    flat, desc = tm.packed(torch.device("cpu"), split=True)
    f = flat.numpy()
    enc, sig = tm.encode_plain(xT)
    enc = enc.numpy()
    rows = tfm._layer_rows(desc)
    P, ke = enc.shape[0], int(desc[4])
    e = np.zeros((P, ke), np.float32)
    e[:, :enc.shape[1]] = enc
    h, acc = e, None
    units = _ring_units(tm, split=True)
    slots = np.asarray(tfm.F32_SLOTS)
    fresh = None
    for i, (l, n0, nw, k0, _, (off,)) in enumerate(units):
        kin_h, _, kout, fout, _, _ = rows[l]
        if acc is None:
            acc = np.zeros((P, kout), np.float32)
        bhi, blo = _unit_slabs(f, off, nw)
        cols = k0 + slots
        a = h[:, cols] if k0 < kin_h else e[:, cols - kin_h]
        ahi = _tf32_rna(a)
        alo = a - ahi
        part = (_tf32_read(alo).astype(np.float64) @ bhi.T.astype(np.float64)
                + ahi.astype(np.float64) @ _tf32_read(blo).T.astype(
                    np.float64)
                + ahi.astype(np.float64) @ bhi.T.astype(np.float64))
        fresh = part if fresh is None else fresh + part
        group_k = tfm.F32_GROUP * tfm.F32_UNIT_K
        if (k0 + tfm.F32_UNIT_K) % group_k == 0 or (
                i + 1 == len(units) or units[i + 1][:2] != (l, n0)):
            acc[:, n0:n0 + nw] = acc[:, n0:n0 + nw] + fresh.astype(np.float32)
            fresh = None
        if i + 1 < len(units) and units[i + 1][0] == l:
            continue
        if tm.bs is not None and tm.bs[l] is not None:
            b = np.zeros(kout, np.float32)
            b[:fout] = tm.bs[l].float().numpy()
            acc = acc + b
        if l == len(rows) - 1:
            out = acc[:, :fout].copy()
            if sig is not None:
                out[:, 0] += sig.numpy()
            return out
        act = np.where(acc >= 0, acc, np.float32(0.01) * acc) if tm.leaky \
            else np.maximum(acc, 0)
        h, acc = act.astype(np.float32), None
    raise AssertionError("unreachable")


@pytest.mark.parametrize("width", [256, 512])
def test_f32_chain_model_matches_float64(width):
    """The float32 ring's order of products and sums on the seeded nets
    (_net: a CP table beside the Fourier features; width 512 parks chunks)
    against run_tmlp_plain in float64 at chip_smoke.py's F32_FAITHFUL (1e-5
    + 1e-5 |ref|), the bound the kernels are held to on the card."""
    tm = _net(width, torch.float32)
    xT = torch.from_numpy(np.random.default_rng(width + 1).uniform(
        -4, 4, (3, 48)).astype(np.float32))
    got = _chain_f32_model(tm, xT)
    ref = tm.forward_plain(xT, torch.float64).numpy()
    d = np.abs(got - ref)
    assert (d <= 1e-5 + 1e-5 * np.abs(ref)).all(), float(
        (d / (1 + np.abs(ref))).max())


def test_f32_chain_model_matches_jax():
    """At width 256 (4 layers, the skip at 2) the float32 ring's model
    against the JAX package's run_tmlp (the Pallas kernel in interpret
    mode, float32) at its suite's float32 bound, 3e-4."""
    import jax

    layers = jfields.init_skip_mlp(jax.random.key(257), 27, 16, 256, 4,
                                   (2,), bias=False)
    x = np.random.default_rng(257).uniform(-2, 2, (40, 3)).astype(np.float32)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), layers, 4, 2.0, (2,),
                                  leaky=True, block=16, interpret=True))
    tm = tfm.TransposedFieldMLP(
        [{"w": torch.tensor(np.asarray(p["w"], np.float32))} for p in layers],
        4, 2.0, (2,), leaky=True)
    got = _chain_f32_model(tm, torch.from_numpy(x.T.copy()))
    np.testing.assert_allclose(got.T, ref[:16], rtol=3e-4, atol=3e-4)
