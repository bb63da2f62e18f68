"""The hash grid's encode in one launch a grid (ops/hashgrid.py:
hash_grid_forward, csrc/hashgrid.cu) on the CPU, where the wrapper takes its
plain version (the level route), against the JAX package; the CUDA source
itself, built for the CPU by g++ (tests/cuda_cpu_stub/cuda_runtime.h: a
thread a CUDA thread), against the level route; and the routing.

Tolerances, each with its reason:
  - against sanerf_tpu/ops/hashgrid.py:hash_encode_01: 1e-5 + 1e-5 |ref|,
    the suite's bound (tests/test_torch_hashgrid.py). The port rounds
    x res - 0.5 once, as the card does; XLA on the CPU may round it twice,
    which moves a weight by an ulp of x res;
  - the CUDA source against the level route: bit for bit. The kernel
    rounds as the plain version: x res - 0.5 one fused multiply-add, each
    product w * row one float32 product (a bf16 row widened exactly), the
    sums in corner order;
  - the encode on its routes (no gradient, the table's gradient, the level
    route): bit for bit (the same function).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import HashGridConfig as JHashGridConfig
from sanerf_tpu.ops import hashgrid as jhg
from sanerf_tpu_torch.config import (HashGridConfig, ModelConfig,
                                     RenderConfig, TrainConfig)
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.ops import hashgrid
from sanerf_tpu_torch.train import state

from tests.test_torch_hashgrid import tiny_hashgrid

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "sanerf_tpu_torch" / "csrc" / "hashgrid.cu"

#: (gridtype, interpolation, align_corners, D, C, max_level): every value of
#: each option at least twice, in a covering set rather than the product
CASES = [
    ("hash", "linear", False, 3, 2, None),
    ("hash", "linear", False, 3, 1, None),
    ("hash", "smoothstep", False, 3, 8, None),
    ("tiled", "linear", True, 3, 2, None),
    ("tiled", "smoothstep", True, 2, 1, None),
    ("hash", "linear", True, 2, 8, 2),
    ("hash", "smoothstep", False, 2, 2, 3),
    ("tiled", "linear", False, 3, 8, 2),
    ("hash", "linear", True, 3, 4, None),
    ("tiled", "smoothstep", False, 2, 3, None),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cfg(gridtype, interp, align, D, C, levels=5):
    return dict(input_dim=D, num_levels=levels, level_dim=C,
                base_resolution=4, log2_hashmap_size=9 if D == 3 else 7,
                desired_resolution=48, gridtype=gridtype,
                interpolation=interp, align_corners=align)


def _id(case):
    return "-".join(str(v) for v in case)


def _inputs(spec, n, seed, dtype):
    """numpy points (some outside the unit cube, some on its faces) and a
    table of `dtype`, as (x, table) tensors."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, spec.input_dim)).astype(np.float32)
    x[:2] = [[0.0] * spec.input_dim, [1.0] * spec.input_dim]
    table = rng.random((spec.total_params, spec.level_dim), np.float32)
    return torch.from_numpy(x), torch.from_numpy(table * 2 - 1).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_forward_matches_jax(case, dtype):
    *kw, max_level = case
    spec = hashgrid.build_spec(HashGridConfig(**_cfg(*kw)))
    jspec = jhg.build_spec(JHashGridConfig(**_cfg(*kw)))
    x, table = _inputs(spec, 333, 1, DTYPES[dtype])
    n = spec.num_levels if max_level is None else max_level
    jt = jnp.asarray(table.float().numpy())
    if dtype == "bf16":
        jt = jt.astype(jnp.bfloat16)
    want = np.asarray(jhg.hash_encode_01(jnp.asarray(x.numpy()), jt, jspec,
                                         max_level))
    before = hashgrid.hash_grid_forward.launches
    got = hashgrid.hash_grid_forward(x, table, spec, n)
    assert hashgrid.hash_grid_forward.launches == before  # the CPU's
    assert got.dtype == torch.float32 and got.shape == (333, spec.output_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and not got[oob].any()
    assert not got[:, n * spec.level_dim:].any()


@pytest.mark.parametrize("case", CASES[:5], ids=[_id(c) for c in CASES[:5]])
def test_encode_routes_are_one_function(case, monkeypatch):
    """hash_encode_01 without a gradient, with the table's gradient and on
    the level route (forward_takes refused) give the same bits."""
    *kw, max_level = case
    spec = hashgrid.build_spec(HashGridConfig(**_cfg(*kw)))
    x, table = _inputs(spec, 129, 2, torch.float32)
    with torch.no_grad():
        plain = hashgrid.hash_encode_01(x, table, spec, max_level)
    grad = hashgrid.hash_encode_01(x, table.clone().requires_grad_(True),
                                   spec, max_level)
    monkeypatch.setattr(hashgrid, "forward_takes", lambda s, n: False)
    with torch.no_grad():
        level = hashgrid.hash_encode_01(x, table, spec, max_level)
    assert torch.equal(plain, grad.detach()) and torch.equal(plain, level)


def _model_grids():
    """Every grid models/fields.py:make_model builds at full width: the
    field, both proposals, the SAM grid and both mask grids."""
    specs = {}
    for kw in (dict(with_sam=True, with_mask=True),
               dict(with_mask=True, mask_mlp_type="lightweight_mask")):
        m = fields.make_model(ModelConfig(field_type="hashgrid", **kw),
                              RenderConfig())
        specs.update({"grid": m.grid_spec,
                      **{f"prop{i}": s for i, s in enumerate(m.prop_specs)}})
        if m.s_grid_spec is not None:
            specs["s_grid"] = m.s_grid_spec
        specs[f"m_grid/{kw.get('mask_mlp_type', 'default')}"] = \
            m.m_grid_spec
    return specs


def test_forward_takes_every_model_grid():
    specs = _model_grids()
    assert len(specs) == 6
    assert {(s.level_dim, s.num_levels) for s in specs.values()} == {
        (2, 16), (2, 5), (8, 16)}
    for name, spec in specs.items():
        assert hashgrid.forward_takes(spec, spec.num_levels), name


def test_wrapper_refuses_past_its_limits_and_takes_plain_on_the_cpu():
    spec = hashgrid.build_spec(HashGridConfig(**_cfg("hash", "linear",
                                                     False, 3, 2)))
    x, table = _inputs(spec, 50, 3, torch.float32)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x[:, :2], table, spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x.double(), table, spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x, table[:-8], spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x, table.half(), spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(
            x, torch.cat([table, table], 1)[:, ::2], spec)
    assert hashgrid.hash_grid_forward(x[:0], table, spec).shape == (
        0, spec.output_dim)
    for kw in (dict(level_dim=16), dict(input_dim=4, log2_hashmap_size=8),
               dict(num_levels=40, per_level_scale=1.05,
                    log2_hashmap_size=8)):
        wide = hashgrid.build_spec(HashGridConfig(**kw))
        xw = torch.rand(20, wide.input_dim)
        tw = torch.randn(wide.total_params, wide.level_dim)
        assert not hashgrid.forward_takes(wide, wide.num_levels)
        with pytest.raises(NotImplementedError, match="queue B"):
            hashgrid.hash_grid_forward(xw, tw, wide)
        # the encode routes such a grid to the level route, which takes it
        assert torch.equal(hashgrid.hash_encode_01(xw, tw, wide),
                           hashgrid.hash_grid_forward_plain(xw, tw, wide))
    # the first 32 levels of the 40 are the kernel's again
    assert hashgrid.forward_takes(wide, 32)


class _Spy:
    """Counts hash_grid_forward calls by grid, and gather_rows calls made
    outside hash_grid_forward (its plain version reaches gather_rows on the
    CPU)."""

    def __init__(self, monkeypatch):
        self.grids, self.gathers, self.inside = [], 0, False
        real_f, real_g = hashgrid.hash_grid_forward, hashgrid.gather_rows

        def forward(x01, table, spec, n=None):
            self.grids.append(spec)
            self.inside = True
            try:
                return real_f(x01, table, spec, n)
            finally:
                self.inside = False

        def gather(*a, **k):
            self.gathers += not self.inside
            return real_g(*a, **k)

        monkeypatch.setattr(hashgrid, "hash_grid_forward", forward)
        monkeypatch.setattr(hashgrid, "gather_rows", gather)


def test_render_one_forward_a_grid(monkeypatch):
    """A render: one hash_grid_forward call for each grid it encodes
    (proposals, field; the SAM grid with features, the mask grid with
    the mask), no gather_rows call of its own."""
    _, tm, _, tp = tiny_hashgrid("lightweight_mask")
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.normal(0, 0.5, (40, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(0, 1, (40, 3)).astype(np.float32))
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        renderer.run_rays(tm, tp, o, d, return_feats=True)
    assert sorted(map(id, spy.grids)) == sorted(map(id, [
        *tm.prop_specs, tm.grid_spec, tm.s_grid_spec]))
    spy.grids.clear()
    with torch.no_grad():
        renderer.run_rays(tm, tp, o, d, return_mask=True)
    assert sorted(map(id, spy.grids)) == sorted(map(id, [
        *tm.prop_specs, tm.grid_spec, tm.m_grid_spec]))
    assert spy.gathers == 0


def test_training_step_one_forward_a_grid(monkeypatch):
    """A hash-grid training step with proposal updates: one
    hash_grid_forward call for each of its three grids and no gather_rows
    call of its own; without updates the same three encodes."""
    model = fields.make_model(
        ModelConfig(field_type="hashgrid", grid_num_levels=6,
                    grid_log2_hashmap=12, grid_desired_resolution=128,
                    prop_num_levels=3, prop_log2_hashmap=10,
                    prop_resolutions=(32, 64)),
        RenderConfig(num_steps=(12, 8, 6), bound=2.0))
    tc = TrainConfig(num_rays=48, adaptive_num_rays=False)
    params = fields.init_params(model, torch.Generator().manual_seed(0),
                                "cpu")
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(2)
    batch = {"rays_o": torch.from_numpy(rng.normal(0, 0.2, (48, 3))
                                        .astype(np.float32)),
             "rays_d": torch.from_numpy(rng.normal(0, 1, (48, 3))
                                        .astype(np.float32)),
             "images": torch.from_numpy(rng.uniform(0, 1, (48, 3))
                                        .astype(np.float32))}
    spy = _Spy(monkeypatch)
    for update in (True, False):
        spy.grids.clear()
        draws = state.draw_step(model, tc, 48, gen)
        _, _, grads = state.loss_and_grads(model, tc, params, batch, draws,
                                           0, update)
        assert sorted(map(id, spy.grids)) == sorted(map(id, [
            *model.prop_specs, model.grid_spec]))
        assert bool(grads["grid"].abs().sum() > 0)
    assert spy.gathers == 0


# -- the CUDA source on the CPU ---------------------------------------------

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    """csrc/hashgrid.cu built for the CPU by g++ with the stand-in header,
    each launch's blocks run one after another, a block's threads as
    threads: {slab: library}, the source as it is ("source") and with
    slabs of 32 floats a point ("32": a slab that holds a C = 2 grid's
    whole row of 16 levels, 4 levels of a C = 8 grid)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    d = tmp_path_factory.mktemp("hashgrid_cpu")
    text = re.sub(r"(\w+)<<<([^,]+),\s*(\w+),\s*0,\s*stream>>>\(",
                  r"emu_launch(\1, \2, \3, 0, stream, ", CSRC.read_text())
    slab = "constexpr int FWD_SLAB = "
    assert text.count(slab) == 1 and "emu_launch(kernel" in text
    libs = {}
    for name, src in (("source", text), ("32", re.sub(
            slab + r"\d+;", slab + "32;", text))):
        (d / f"{name}.cpp").write_text(src)
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-Wno-unknown-pragmas",
                        f"-I{ROOT / 'tests' / 'cuda_cpu_stub'}",
                        str(d / f"{name}.cpp"), "-o", str(d / f"{name}.so")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        lib.hash_grid_forward_launch.argtypes = _ARGS
        lib.hash_grid_forward_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _source_forward(lib, x, table, spec, n):
    B, L, C = x.shape[0], spec.num_levels, spec.level_dim
    out = torch.full((B, L * C), float("nan"))
    arrays = hashgrid._level_arrays(spec, n)
    code = lib.hash_grid_forward_launch(
        out.data_ptr(), table.data_ptr(), table.element_size(), C,
        x.data_ptr(), spec.input_dim, B, L, n,
        *(ctypes.addressof(a) for a in arrays), int(spec.align_corners),
        int(spec.interpolation == "smoothstep"), None)
    assert code == 0
    return out


@pytest.mark.parametrize("slab", ["source", "32"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_source_matches_the_level_route(source_lib, case, dtype, slab):
    """The kernel's arithmetic, staging and stores at ragged point counts
    (a last tile of 1 point, of 127), with rows of one slab and of several
    (C = 8: 2 levels a slab of 16 floats), against the level route bit for
    bit; every output element written."""
    *kw, max_level = case
    for levels, B in ((5, 257), (9, 383)):
        spec = hashgrid.build_spec(HashGridConfig(**_cfg(*kw, levels)))
        x, table = _inputs(spec, B, 4 + levels, DTYPES[dtype])
        n = spec.num_levels if max_level is None else max_level
        got = _source_forward(source_lib[slab], x, table, spec, n)
        ref = hashgrid.hash_grid_forward_plain(x, table, spec, n)
        assert torch.equal(got, ref), (levels, B)


def test_source_at_a_full_width_grid(source_lib):
    """The field's grid of ModelConfig(field_type="hashgrid") (16 levels,
    hashed past the 6th, two slabs a row) with a bf16 table, against the
    level route bit for bit."""
    spec = _model_grids()["grid"]
    x, table = _inputs(spec, 300, 9, torch.bfloat16)
    got = _source_forward(source_lib["source"], x, table, spec,
                          spec.num_levels)
    assert torch.equal(got, hashgrid.hash_grid_forward_plain(x, table, spec))
