"""The bf16 field kernels of the grid family (the V_GRID kernels of
csrc/fused_mlp_t.cu): the weights stream through the V_WIDE kernels' ring
of units, filled by one warp, and the encode runs in warps of its own,
which write each tile's encoding into a ring of slots that the consumer
warpgroups' chains read.

On the CPU (the kernels run only on the card; tests/test_torch_cuda.py and
chip_smoke.py hold them against the plain version there):
  - the plans: every bf16 net of the grid family whose weights the
    kernels before V_GRID held whole in shared memory takes V_GRID and
    fits SMEM_LIMIT (grid_student, SIGMA, SIGMA_VM, the quality recipe's
    tables, and their encode probes), and every other plan is the one the
    port had before (a frozen table: the asset's, the grid configurations'
    float32 twins, the bf16 ladders whose weights stream, cp_ladder,
    vm_ladder and the 16-level ladders, the default field's);
  - a model of the schedule: encoder warps, a weight producer and consumer
    warpgroups that interleave at random under the kernels' protocol
    (the slots' full barriers and release counts, the stages' barriers,
    parities, wgmma.wait_group 1 before a stage's release): every tile is
    encoded once and consumed once, every unit reaches every consumer, no
    slot or stage is refilled before its readers have released it, and a
    tail pass ends; four faults (a slot released early, a consumer that
    skips a tail pass, a unit the producer leaves out, encoders that wait
    on a release parity as on an mbarrier's) are caught by it;
  - the chain in the ring's order from the packed weights over the
    encoding the slots hold, against run_tmlp_plain in float64 and
    against the JAX package's run_tmlp / run_tmlp_composite in interpret
    mode, for the three served configurations.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                           params_from_jax)
from sanerf_tpu_torch.ops import fused_mlp_t as tfm
from test_torch_wide_kernel import _Barrier, _chain_in_ring_order, _ring_units

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))
import grid_params as gp  # noqa: E402  (the served grid configurations)

torch.set_num_threads(1)
SERVED = ("grid_student", "cp_ladder", "vm_ladder")


def _model(name, steps=None, **render):
    """The model of a configuration: the asset's ("asset"), the default
    field's ("default"), port_tools/grid_params.py's (CONFIGS, "sigma",
    "sigma_vm", or a LIMITS entry)."""
    if name == "asset":
        mc, rc, _ = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                               device="cpu")
        return fields.make_model(mc, rc)
    if name in gp.LIMITS:
        mkw, rkw = gp.LIMITS[name]
        return fields.make_model(ModelConfig(**mkw),
                                 RenderConfig(**{**rkw, **render}))
    cfg = {"default": {}, "sigma": gp.SIGMA, "sigma_vm": gp.SIGMA_VM}.get(
        name, gp.CONFIGS.get(name))
    rc = RenderConfig(**render) if steps is None else RenderConfig(
        num_steps=steps, **render)
    return fields.make_model(ModelConfig(**cfg), rc)


def _nets(name, dtype, **kw):
    """KernelNets of a configuration with the numpy-seeded weights of
    grid_params.make_flat (the asset: its own), in `dtype`."""
    model = _model(name, **kw)
    if name == "asset":
        _, _, p = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                             device="cpu")
    else:
        p = params_from_jax(gp.make_flat(expected_shapes(model), 0), model,
                            "cpu")
    if dtype == torch.bfloat16:
        p = fields.cast_params(p, torch.bfloat16)
    return fields.KernelNets(model, p)


# -- the plans ----------------------------------------------------------------


#: the bf16 nets of the grid family on V_GRID, and those whose weights
#: stream (W_STREAM before V_GRID), which keep their route
GRID_NETS = ("grid_student", "sigma", "sigma_vm", "L7 quality recipe")
STREAMED = ("cp_ladder", "vm_ladder", "L6 CP x 16", "L6 VM x 16")


def _grid_plan_ok(p, tm):
    ke = int(tm.layout()[0][4])
    hw = max([int(w.shape[1]) for w in tm.ws[:-1]], default=0)
    assert p.variant == tfm.V_GRID and p.w_mode == tfm.W_RING
    assert not (p.small or p.prop)
    assert p.unit_b == tfm.UNIT_B and tfm.MIN_STAGES <= p.stages <= \
        tfm.GRID_STAGES
    zero = any(int(r[5]) % tfm.UNIT_K for r in tfm._layer_rows(
        tm.layout()[0]))
    assert p.w_bytes == (p.stages * tfm.UNIT_B + tfm.RING_BAR_B
                         + (tfm.ZERO_B if zero else 0))
    # the slots: a multiple of the consumers, each a tile's encoding (the
    # core-matrix layout, ke columns) and its sigma sums
    assert p.wgs <= p.slots <= min(tfm.GRID_SLOTS, tfm.MAX_SLOTS)
    assert p.slots % p.wgs == 0
    assert p.lde == ke and p.enc_b == 64 * ke * 2 and p.sig_b == 256
    assert p.slot_b == p.enc_b + p.sig_b
    # a consumer's buffers: the hidden activations, no encoding of its own
    assert p.h_b == 64 * hw * 2 and p.ldh == hw
    assert p.per_wg == p.h_b + p.out_b + p.wts_b + p.ts_b + p.vin_b
    assert p.total == (p.w_bytes + p.v_bytes + p.slots * p.slot_b
                       + tfm.SLOT_BAR_B + p.wgs * p.per_wg)
    assert p.total <= tfm.SMEM_LIMIT and p.park_chunks == 0


@pytest.mark.parametrize("name", GRID_NETS)
def test_grid_plans_take_v_grid(name):
    """run_tmlp, the composite at T 16 and 32 with the view head (and the
    hierarchy's own T), and every encode probe of the field: V_GRID, its
    ring and slots within SMEM_LIMIT, two consumer warpgroups."""
    nets = _nets(name, torch.bfloat16)
    f = nets.field
    assert tfm._grid_net(f)
    T = _model(name).render_cfg.num_steps[-1]
    plans = [tfm.kernel_plan(f)] + [tfm.kernel_plan(f, t, nets.view)
                                    for t in sorted({16, 32, T})]
    for p in plans:
        _grid_plan_ok(p, f)
        assert p.wgs == tfm.GRID_WGS
    for probe in tfm.encode_probes(f):
        p = tfm.kernel_plan(probe)
        _grid_plan_ok(p, probe)
    # grid_student: four slots, and four stages or more (the most that fit
    # beside them)
    if name in SERVED:
        assert all(p.slots == 4 and p.stages >= 4 for p in plans)
        assert all(p.total + tfm.UNIT_B > tfm.SMEM_LIMIT for p in plans
                   if p.stages < tfm.GRID_STAGES)


@pytest.mark.parametrize("name", STREAMED)
def test_streamed_grid_nets_keep_their_route(name):
    """The bf16 nets of the grid family whose weights stream (cp_ladder,
    vm_ladder, the 16-level ladders: 283 KB or 266 KB of weights) stay off
    V_GRID, at run_tmlp, the composite and every encode probe (their plans
    are in FROZEN, test_other_plans_as_before)."""
    nets = _nets(name, torch.bfloat16)
    f = nets.field
    assert not tfm._grid_net(f)
    assert tfm.kernel_plan(f).w_mode == tfm.W_STREAM
    for T in (None, 16, 32):
        p = tfm.kernel_plan(f, T, None if T is None else nets.view)
        assert p.variant in (tfm.V_SERVED, tfm.V_BRANCHES) and not p.slots
    for probe in tfm.encode_probes(f):
        assert tfm.kernel_plan(probe).variant == tfm.kernel_plan(f).variant


def test_only_the_grid_family_takes_v_grid():
    """The asset's field (one CP line table and a sigma-CP table), its
    float32 twin, the grid configurations' float32 twins, a single-CP net
    and the table-free default field keep their variants; so do the
    proposal nets of every grid configuration (prop_kernel)."""
    for name, dt in (("asset", torch.bfloat16), ("asset", torch.float32),
                     ("grid_student", torch.float32),
                     ("default", torch.bfloat16)):
        nets = _nets(name, dt)
        assert not tfm._grid_net(nets.field)
        assert tfm.kernel_plan(nets.field).variant != tfm.V_GRID
        assert tfm.kernel_plan(nets.field, 16, nets.view).variant != \
            tfm.V_GRID
    nets = _nets("grid_student", torch.bfloat16)
    assert all(tfm.kernel_plan(p).prop for p in nets.props)


#: KernelPlan's fields before V_GRID, and the plans the port made before it
#: (name, dtype, T) -> those fields' values (_nets(name, dtype); T None:
#: run_tmlp, else the composite with the view head), from the parent
#: commit's kernel_plan
OLD_FIELDS = ('lde', 'ldo', 'M', 'R', 'ldh', 'wgs', 'w_mode', 'w_bytes',
              'v_bytes', 'enc_b', 'h_b', 'out_b', 'sig_b', 'wts_b', 'ts_b',
              'vin_b', 'per_wg', 'total', 'nseg', 'vld', 'unit_k',
              'park_chunks', 'variant', 'small', 'general', 'prop', 'stages',
              'unit_b')
FROZEN = {
    ('asset', 'bf16', None): (
        128, 17, 64, 0, 128, 3, 1, 102400, 0, 16384, 0, 4352, 256, 0, 0, 0,
        20992, 165376, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 4): (
        128, 17, 64, 16, 128, 4, 1, 102400, 6144, 16384, 0, 4352, 256, 256,
        256, 2048, 23552, 202752, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 12): (
        128, 17, 192, 16, 128, 3, 1, 102400, 6144, 16384, 0, 13056, 256, 768,
        768, 2048, 33280, 208384, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 16): (
        128, 17, 64, 4, 128, 4, 1, 102400, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 202752, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 24): (
        128, 17, 192, 8, 128, 3, 1, 102400, 6144, 16384, 0, 13056, 256, 768,
        768, 2048, 33280, 208384, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 32): (
        128, 17, 64, 2, 128, 4, 1, 102400, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 202752, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'bf16', 64): (
        128, 17, 64, 1, 128, 4, 1, 102400, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 202752, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', None): (
        136, 17, 64, 0, 136, 3, 0, 0, 0, 34816, 0, 4352, 256, 0, 0, 0, 39424,
        118272, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 4): (
        136, 17, 64, 16, 136, 2, 2, 131072, 12288, 34816, 0, 4352, 256, 256,
        256, 2048, 41984, 227328, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 12): (
        136, 17, 192, 16, 136, 2, 0, 0, 12288, 34816, 0, 13056, 256, 768, 768,
        2048, 51712, 115712, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 16): (
        136, 17, 64, 4, 136, 2, 2, 131072, 12288, 34816, 0, 4352, 256, 256,
        256, 2048, 41984, 227328, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 24): (
        136, 17, 192, 8, 136, 2, 0, 0, 12288, 34816, 0, 13056, 256, 768, 768,
        2048, 51712, 115712, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 32): (
        136, 17, 64, 2, 136, 2, 2, 131072, 12288, 34816, 0, 4352, 256, 256,
        256, 2048, 41984, 227328, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('asset', 'f32', 64): (
        136, 17, 64, 1, 136, 2, 2, 131072, 12288, 34816, 0, 4352, 256, 256,
        256, 2048, 41984, 227328, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', None): (
        168, 17, 64, 0, 136, 3, 0, 0, 0, 43008, 0, 4352, 256, 0, 0, 0, 47616,
        142848, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 4): (
        168, 17, 64, 16, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 12): (
        168, 17, 192, 16, 136, 2, 0, 0, 12288, 43008, 0, 13056, 256, 768, 768,
        2048, 59904, 132096, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 16): (
        168, 17, 64, 4, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 24): (
        168, 17, 192, 8, 136, 2, 0, 0, 12288, 43008, 0, 13056, 256, 768, 768,
        2048, 59904, 132096, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 32): (
        168, 17, 64, 2, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'f32', 64): (
        168, 17, 64, 1, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', None): (
        64, 17, 64, 0, 128, 3, 2, 49152, 0, 8192, 0, 4352, 256, 0, 0, 0, 12800,
        87552, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 4): (
        64, 17, 64, 16, 128, 4, 2, 49152, 6144, 8192, 0, 4352, 256, 256, 256,
        2048, 15360, 116736, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 12): (
        64, 17, 192, 16, 128, 4, 2, 49152, 6144, 8192, 0, 13056, 256, 768, 768,
        2048, 25088, 155648, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 16): (
        64, 17, 64, 4, 128, 4, 2, 49152, 6144, 8192, 0, 4352, 256, 256, 256,
        2048, 15360, 116736, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 24): (
        64, 17, 192, 8, 128, 4, 2, 49152, 6144, 8192, 0, 13056, 256, 768, 768,
        2048, 25088, 155648, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 32): (
        64, 17, 64, 2, 128, 4, 2, 49152, 6144, 8192, 0, 4352, 256, 256, 256,
        2048, 15360, 116736, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'bf16', 64): (
        64, 17, 64, 1, 128, 4, 2, 49152, 6144, 8192, 0, 4352, 256, 256, 256,
        2048, 15360, 116736, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', None): (
        72, 17, 64, 0, 136, 3, 2, 98304, 0, 18432, 0, 4352, 256, 0, 0, 0,
        23040, 167424, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 4): (
        72, 17, 64, 16, 136, 2, 2, 98304, 12288, 18432, 0, 4352, 256, 256, 256,
        2048, 25600, 161792, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 12): (
        72, 17, 192, 16, 136, 2, 2, 98304, 12288, 18432, 0, 13056, 256, 768,
        768, 2048, 35328, 181248, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 16): (
        72, 17, 64, 4, 136, 2, 2, 98304, 12288, 18432, 0, 4352, 256, 256, 256,
        2048, 25600, 161792, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 24): (
        72, 17, 192, 8, 136, 2, 2, 98304, 12288, 18432, 0, 13056, 256, 768,
        768, 2048, 35328, 181248, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 32): (
        72, 17, 64, 2, 136, 2, 2, 98304, 12288, 18432, 0, 4352, 256, 256, 256,
        2048, 25600, 161792, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('default', 'f32', 64): (
        72, 17, 64, 1, 136, 2, 2, 98304, 12288, 18432, 0, 4352, 256, 256, 256,
        2048, 25600, 161792, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', None): (
        216, 17, 64, 0, 136, 3, 0, 0, 0, 55296, 0, 4352, 256, 0, 0, 0, 59904,
        179712, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 4): (
        216, 17, 64, 16, 136, 2, 0, 0, 12288, 55296, 0, 4352, 256, 256, 256,
        2048, 62464, 137216, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 12): (
        216, 17, 192, 16, 136, 2, 0, 0, 12288, 55296, 0, 13056, 256, 768, 768,
        2048, 72192, 156672, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 16): (
        216, 17, 64, 4, 136, 2, 0, 0, 12288, 55296, 0, 4352, 256, 256, 256,
        2048, 62464, 137216, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 24): (
        216, 17, 192, 8, 136, 2, 0, 0, 12288, 55296, 0, 13056, 256, 768, 768,
        2048, 72192, 156672, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 32): (
        216, 17, 64, 2, 136, 2, 0, 0, 12288, 55296, 0, 4352, 256, 256, 256,
        2048, 62464, 137216, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('grid_student', 'f32', 64): (
        216, 17, 64, 1, 136, 2, 0, 0, 12288, 55296, 0, 4352, 256, 256, 256,
        2048, 62464, 137216, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', None): (
        56, 17, 64, 0, 24, 3, 1, 9216, 0, 14336, 0, 4352, 256, 0, 0, 0, 18944,
        66048, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 4): (
        56, 17, 64, 16, 24, 2, 1, 9216, 12288, 14336, 0, 4352, 256, 256, 256,
        2048, 21504, 64512, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 12): (
        56, 17, 192, 16, 24, 2, 1, 9216, 12288, 14336, 0, 13056, 256, 768, 768,
        2048, 31232, 83968, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 16): (
        56, 17, 64, 4, 24, 2, 1, 9216, 12288, 14336, 0, 4352, 256, 256, 256,
        2048, 21504, 64512, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 24): (
        56, 17, 192, 8, 24, 2, 1, 9216, 12288, 14336, 0, 13056, 256, 768, 768,
        2048, 31232, 83968, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 32): (
        56, 17, 64, 2, 24, 2, 1, 9216, 12288, 14336, 0, 4352, 256, 256, 256,
        2048, 21504, 64512, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('sigma_vm', 'f32', 64): (
        56, 17, 64, 1, 24, 2, 1, 9216, 12288, 14336, 0, 4352, 256, 256, 256,
        2048, 21504, 64512, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', None): (
        168, 17, 64, 0, 136, 3, 0, 0, 0, 43008, 0, 4352, 256, 0, 0, 0, 47616,
        142848, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 4): (
        168, 17, 64, 16, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 12): (
        168, 17, 192, 16, 136, 2, 0, 0, 12288, 43008, 0, 13056, 256, 768, 768,
        2048, 59904, 132096, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 16): (
        168, 17, 64, 4, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 24): (
        168, 17, 192, 8, 136, 2, 0, 0, 12288, 43008, 0, 13056, 256, 768, 768,
        2048, 59904, 132096, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 32): (
        168, 17, 64, 2, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'f32', 64): (
        168, 17, 64, 1, 136, 2, 0, 0, 12288, 43008, 0, 4352, 256, 256, 256,
        2048, 50176, 112640, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', None): (
        160, 17, 64, 0, 128, 3, 2, 73728, 0, 20480, 0, 4352, 256, 0, 0, 0,
        25088, 148992, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 4): (
        160, 17, 64, 16, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 12): (
        160, 17, 192, 16, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 16): (
        160, 17, 64, 4, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 24): (
        160, 17, 192, 8, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 32): (
        160, 17, 64, 2, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('cp_ladder', 'bf16', 64): (
        160, 17, 64, 1, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', None): (
        160, 17, 64, 0, 128, 3, 2, 73728, 0, 20480, 0, 4352, 256, 0, 0, 0,
        25088, 148992, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 4): (
        160, 17, 64, 16, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 12): (
        160, 17, 192, 16, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 16): (
        160, 17, 64, 4, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 24): (
        160, 17, 192, 8, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 32): (
        160, 17, 64, 2, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('vm_ladder', 'bf16', 64): (
        160, 17, 64, 1, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 0, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', None): (
        128, 17, 64, 0, 128, 3, 2, 65536, 0, 16384, 0, 4352, 256, 0, 0, 0,
        20992, 128512, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 4): (
        128, 17, 64, 16, 128, 4, 2, 65536, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 165888, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 12): (
        128, 17, 192, 16, 128, 4, 2, 65536, 6144, 16384, 0, 13056, 256, 768,
        768, 2048, 33280, 204800, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 16): (
        128, 17, 64, 4, 128, 4, 2, 65536, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 165888, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 24): (
        128, 17, 192, 8, 128, 4, 2, 65536, 6144, 16384, 0, 13056, 256, 768,
        768, 2048, 33280, 204800, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 32): (
        128, 17, 64, 2, 128, 4, 2, 65536, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 165888, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 CP x 16', 'bf16', 64): (
        128, 17, 64, 1, 128, 4, 2, 65536, 6144, 16384, 0, 4352, 256, 256, 256,
        2048, 23552, 165888, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', None): (
        160, 17, 64, 0, 128, 3, 2, 73728, 0, 20480, 0, 4352, 256, 0, 0, 0,
        25088, 148992, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 4): (
        160, 17, 64, 16, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 12): (
        160, 17, 192, 16, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 16): (
        160, 17, 64, 4, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 24): (
        160, 17, 192, 8, 128, 4, 2, 73728, 6144, 20480, 0, 13056, 256, 768,
        768, 2048, 37376, 229376, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 32): (
        160, 17, 64, 2, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
    ('L6 VM x 16', 'bf16', 64): (
        160, 17, 64, 1, 128, 4, 2, 73728, 6144, 20480, 0, 4352, 256, 256, 256,
        2048, 27648, 190464, 1, 128, 0, 0, 1, 0, 0, 0, 0, 0),
}


@pytest.mark.parametrize("name", ["asset", "grid_student", "cp_ladder",
                                  "vm_ladder", "sigma_vm", "default",
                                  "L6 CP x 16", "L6 VM x 16"])
def test_other_plans_as_before(name):
    """Every plan but V_GRID's is the one the port made before it, field
    for field, with no slots: the asset's (bf16 and float32), the grid
    configurations' float32 twins, the bf16 ladders whose weights stream,
    the default field's (bf16 and float32), at run_tmlp and the composite
    at T 4-64."""
    keys = [k for k in FROZEN if k[0] == name]
    assert len(keys) == (14 if name in ("asset", "default", "cp_ladder",
                                        "vm_ladder") else 7)
    for _, dt, T in keys:
        nets = _nets(name, torch.bfloat16 if dt == "bf16" else torch.float32)
        p = tfm.kernel_plan(nets.field, T, None if T is None else nets.view)
        assert tuple(getattr(p, f) for f in OLD_FIELDS) == FROZEN[
            (name, dt, T)], (name, dt, T)
        assert (p.slots, p.slot_b) == (0, 0) and p.variant != tfm.V_GRID


# -- a model of the schedule --------------------------------------------------


class _GridSim:
    """One V_GRID block as csrc/fused_mlp_t.cu runs it: `ne` encoder warps,
    the weight producer warp and `wgs` consumer warpgroups over `calls`
    tile calls each (every pass's padding tiles included), `slots`
    encoding slots and `stages` ring stages, `units` (_ring_units of one
    tile) a call.

    Encoder warp w takes tasks w, w + ne, ...: task t is quarter t % 4 of
    tile q = t / 4, the (n C + c)-th of the block (consumer c's call n), in
    slot q % slots; it waits until the slot's release count reaches 4
    (q / slots) (its previous uses released), writes its quarter and
    arrives on the full barrier (4 quarters a phase). Consumer c waits on
    its slot's full barrier (parity of the use), then runs the call's
    units as the ring's consumers do (a unit's products issued once it has
    landed, the unit before released at the next wgmma.wait_group 1, a
    chunk's last at wait_group 0), then adds 4 to the slot's release
    count. The producer fills the stages as the ring's does. Faults:
    "early_release" (a slot released as soon as its consumer has taken
    it), "skip_tail" (consumers past the first skip the last call),
    "skip_unit" (the producer leaves out one unit), "parity_release" (the
    encoders wait on a release barrier's parity, as on an mbarrier: one
    that runs two uses of a slot ahead of the others passes it)."""

    def __init__(self, units, wgs, ne, slots, stages, calls, rng,
                 fault=None):
        self.units, self.C, self.ne, self.S = units, wgs, ne, slots
        self.U, self.rng, self.fault = len(units), rng, fault
        self.calls = calls
        self.sfull = [_Barrier(4) for _ in range(slots)]
        self.released = [0] * slots
        self.sempty = [_Barrier(4) for _ in range(slots)]  # parity_release
        self.content = [[None] * 4 for _ in range(slots)]
        self.sreaders = [set() for _ in range(slots)]
        self.encoded, self.consumed = {}, {}
        self.full = [_Barrier(2) for _ in range(stages)]
        self.empty = [_Barrier(4 * wgs) for _ in range(stages)]
        self.tag, self.readers = [None] * stages, [set() for _ in
                                                   range(stages)]
        self.in_flight, self.stages = [], stages
        seq = list(range(calls * self.U))
        if fault == "skip_unit":
            del seq[self.U + 3]
        self.p = dict(i=0, stage=0, phase=0, seq=seq)
        self.tasks = 4 * wgs * calls
        self.e = [dict(t=w) for w in range(ne)]
        self.c = []
        for w in range(wgs):
            n = calls - (1 if fault == "skip_tail" and w else 0)
            self.c.append(dict(n=0, end=n, taken=False, i=0, stage=0,
                               phase=0, prev=None, issued=None, got=[]))
        self.errors = []

    def _q(self, c):
        return self.c[c]["n"] * self.C + c

    def steps(self):
        out = []
        p = self.p
        if p["i"] < len(p["seq"]) and self.empty[p["stage"]].passes(
                p["phase"] ^ 1):
            out.append(("fill", None))
        if self.in_flight:
            out.append(("land", None))
        for w, e in enumerate(self.e):
            q = e["t"] // 4
            s, use = q % self.S, q // self.S
            free = (self.sempty[s].passes((use & 1) ^ 1)
                    if self.fault == "parity_release"
                    else self.released[s] >= 4 * use)
            if e["t"] < self.tasks and free:
                out.append(("encode", w))
        for w, c in enumerate(self.c):
            if c["n"] >= c["end"]:
                continue
            q = self._q(w)
            if not c["taken"]:
                if self.sfull[q % self.S].passes(q // self.S & 1):
                    out.append(("take", w))
            elif c["i"] == (c["n"] + 1) * self.U and c["issued"] is None:
                out.append(("release", w))
            elif c["issued"] is not None:
                out.append(("wait", w))
            elif self.full[c["stage"]].passes(c["phase"]):
                out.append(("issue", w))
        return out

    def encode(self, w):
        e = self.e[w]
        q, r = divmod(e["t"], 4)
        s = q % self.S
        if self.sreaders[s]:
            self.errors.append(f"slot {s} refilled while read")
        self.content[s][r] = q
        self.encoded[(q, r)] = self.encoded.get((q, r), 0) + 1
        self.sfull[s].arrive()
        e["t"] += self.ne

    def take(self, w):
        c, q = self.c[w], self._q(w)
        s = q % self.S
        if self.content[s] != [q] * 4:
            self.errors.append(f"wg {w} took tile {q} as {self.content[s]}")
        self.sreaders[s].add(w)
        c["taken"] = True
        if self.fault == "early_release":
            self._release(s)

    def release(self, w):
        c, q = self.c[w], self._q(w)
        s = q % self.S
        if self.content[s] != [q] * 4:
            self.errors.append(f"slot {s} overwritten under tile {q}")
        self.sreaders[s].discard(w)
        self.consumed[q] = self.consumed.get(q, 0) + 1
        if self.fault != "early_release":
            self._release(s)
        c["taken"], c["n"] = False, c["n"] + 1

    def _release(self, s):
        self.released[s] += 4
        self.sempty[s].arrive(4)

    def fill(self, _):
        p = self.p
        s = p["stage"]
        if self.readers[s]:
            self.errors.append(f"stage {s} refilled while read")
        self.full[s].arrive()
        self.in_flight.append((s, p["seq"][p["i"]]))
        p["i"] += 1
        p["stage"] = (s + 1) % self.stages
        p["phase"] ^= int(p["stage"] == 0)

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

    def wait(self, w):
        c = self.c[w]
        s, release = c["issued"], []
        if c["prev"] is not None:
            release.append(c["prev"])
        c["prev"] = s
        u, v = self.units[c["i"] % self.U], None
        if (c["i"] + 1) % self.U:
            v = self.units[(c["i"] + 1) % self.U]
        if v is None or v[:2] != u[:2]:  # a chunk's end: wait_group 0
            release.append(s)
            c["prev"] = None
        for r in release:
            self.readers[r].discard(w)
            self.empty[r].arrive(4)
        c["issued"] = None
        c["i"] += 1
        c["stage"] = (s + 1) % self.stages
        c["phase"] ^= int(c["stage"] == 0)

    def run(self):
        """-> True when every actor ended, False at a deadlock."""
        while True:
            acts = self.steps()
            if not acts:
                return (self.p["i"] == len(self.p["seq"])
                        and all(e["t"] >= self.tasks for e in self.e)
                        and all(c["n"] == c["end"] for c in self.c))
            kind, arg = acts[self.rng.integers(len(acts))]
            getattr(self, kind)(arg)


def _calls(items, grid, wgs, block, per_item=1):
    """Tile calls a consumer of block `block` makes (Walk.passes() x
    calls an item), as its encoders and producer count them."""
    first, apart = block * wgs, grid * wgs
    passes = (items - first + apart - 1) // apart if first < items else 0
    return passes * per_item


@pytest.mark.parametrize("name,wgs,slots,stages,items,grid,per_item", [
    ("grid_student", 2, 4, 4, 7, 2, 1), ("grid_student", 2, 2, 2, 3, 1, 1),
    ("cp_ladder", 2, 4, 5, 5, 2, 1), ("sigma_vm", 1, 1, 2, 3, 2, 1),
    ("grid_student", 2, 4, 3, 3, 1, 3), ("vm_ladder", 1, 4, 4, 1, 1, 2),
    ("sigma_vm", 2, 2, 4, 24, 1, 1), ("sigma_vm", 2, 4, 2, 40, 1, 1)])
def test_grid_schedule(name, wgs, slots, stages, items, grid, per_item):
    """Random interleavings of 7 encoder warps, the producer and the
    consumers (tail passes included: 7 items over 2 blocks of 2 consumers;
    composite steps of 2-3 tile calls; 12 and 20 calls a consumer, each
    slot used many times over): the run ends, every tile of every call is
    encoded once (its four quarters) and consumed once, every consumer
    reads every unit of every call once in the producer's order, no slot
    or stage is refilled while read, and nothing is left read."""
    units = _ring_units(_nets(name, torch.bfloat16).field)
    ne = 4 * tfm.GRID_ENC_WGS - 1
    for block in range(grid):
        calls = _calls(items, grid, wgs, block, per_item)
        for seed in range(3):
            sim = _GridSim(units, wgs, ne, slots, stages, calls,
                           np.random.default_rng(seed))
            assert sim.run(), "deadlock"
            assert not sim.errors, sim.errors[:3]
            tiles = range(wgs * calls)
            assert sim.encoded == {(q, r): 1 for q in tiles for r in range(4)}
            assert sim.consumed == {q: 1 for q in tiles}
            for c in sim.c:
                assert c["got"] == list(range(calls * len(units)))
            assert all(not r for r in sim.readers + sim.sreaders)


@pytest.mark.parametrize("fault", ["early_release", "skip_tail",
                                   "skip_unit", "parity_release"])
def test_grid_schedule_faults(fault):
    """The model catches the protocol's faults: a slot released when its
    consumer takes it (refilled under its products, in some
    interleaving), consumers that skip a tail call (the producer and the
    encoders wait for their releases for ever), a unit the producer leaves
    out (a consumer reads the wrong unit), encoders that wait on a release
    parity (the first design's empty mbarrier: a warp two uses of a slot
    ahead passes it and overwrites the slot)."""
    units = _ring_units(_nets("sigma_vm", torch.bfloat16).field)
    caught = 0
    for seed in range(20):
        sim = _GridSim(units, 2, 7, 2, 2, 12, np.random.default_rng(seed),
                       fault)
        caught += (not sim.run()) or bool(sim.errors)
    assert caught >= 10


# -- the chain in the kernels' order ------------------------------------------


def _points(n, bound, seed):
    x = np.random.default_rng(seed).uniform(-1.1 * bound, 1.1 * bound,
                                            (n, 3))
    x[0] = [-bound, bound, 0.0]
    return x.astype(np.float32)


def _jax_grids(tm):
    """tm's tables as the JAX kernels' keyword arguments."""
    a = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    kw = dict(cp_lines=[a(t) for t in tm.cp] or None,
              vm_planes=[a(p) for p, _ in tm.vm] or None,
              vm_lines=[a(l) for _, l in tm.vm] or None)
    if tm.scp is not None:
        kw["sigma_cp_lines"] = a(tm.scp)
    if tm.svm is not None:
        kw["sigma_vm_planes"], kw["sigma_vm_lines"] = map(a, tm.svm)
    return kw


@pytest.mark.parametrize("name", SERVED)
def test_grid_chain_in_kernel_order_matches_plain(name):
    """The bf16 field of each served configuration summed unit by unit in
    the ring's order from the packed weights over the encoding the slots
    hold (every column a quarter task writes, and the sigma sums), against
    run_tmlp_plain, both in float64 with the activations rounded to
    bf16; and each encode probe's one layer in that order reads its
    columns back."""
    f = _nets(name, torch.bfloat16).field
    xT = torch.from_numpy(_points(48, f.bound, 3).T.copy())
    ref = f.forward_plain(xT, torch.float64)
    torch.testing.assert_close(_chain_in_ring_order(f, xT), ref, rtol=1e-10,
                               atol=1e-10)
    enc, sig = f.encode_plain(xT, torch.float64)
    for i, probe in enumerate(tfm.encode_probes(f)):
        got = _chain_in_ring_order(probe, xT)
        cols = enc[:, 15 * i:15 * i + 15]
        torch.testing.assert_close(got[:, 1:1 + cols.shape[1]], cols,
                                   rtol=0, atol=0)
        torch.testing.assert_close(got[:, 0], torch.zeros_like(got[:, 0])
                                   if sig is None else sig, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", SERVED)
def test_grid_chain_in_kernel_order_matches_jax(name):
    """The float32 twin of each served configuration's field in the
    kernels' order against the JAX package's run_tmlp (its Pallas kernel
    in interpret mode) at 3e-4, and the composite built on it against
    run_tmlp_composite at 1e-3 (tests/test_torch_grids.py's bounds)."""
    nets = _nets(name, torch.float32)
    f, v = nets.field, nets.view
    x = _points(40, f.bound, 4)
    jl = [{"w": jnp.asarray(w.numpy())} for w in f.ws]
    kw = dict(leaky=f.leaky, interpret=True, **_jax_grids(f))
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x.T), jl, f.enc_freqs, f.bound,
                                  f.skip, block=16, transposed=True, **kw))
    xT = torch.from_numpy(x.T.copy())
    got = _chain_in_ring_order(f, xT)
    np.testing.assert_allclose(got.T.numpy(), ref[:f.kout], rtol=3e-4,
                               atol=3e-4)
    # the composite's epilogue over the same chain: N = 5 rays of T = 8
    N, T = 5, 8
    rng = np.random.default_rng(5)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = np.concatenate([rng.normal(0, 0.5, (N, 3)), rng.normal(0, 1, (N, 3)),
                         np.zeros((N, 2))], 1).astype(np.float32)
    vl = [{"w": jnp.asarray(w.numpy())} for w in [v.w1] + v.rest]
    jref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), jl, f.enc_freqs,
        f.bound, f.skip, opaque=True, rays8=jnp.asarray(r8), view_layers=vl,
        sh_degree=v.degree, **kw)
    f.forward_plain = lambda xT_, dtype: _chain_in_ring_order(
        f, xT_).to(dtype)
    out = tfm.run_tmlp_composite_plain(xT, torch.from_numpy(dl),
                                       torch.from_numpy(ts), f, True, v,
                                       torch.from_numpy(r8))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jref[0])[:, :16],
                               rtol=1e-3, atol=1e-3, err_msg="gsum")
    for what, g, r in zip(("depth", "wsum", "rgb"), out[1:], jref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3, err_msg=what)
