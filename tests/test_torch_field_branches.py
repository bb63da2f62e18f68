"""Parity: the branches of the port's fused field kernels beyond the served
asset (sanerf_tpu_torch/ops/fused_mlp_t.py) vs the JAX Pallas kernels in
interpret mode, with the same weights: biased layers (float32 at 2e-4,
bf16 weights at 0.05, the bounds of the JAX suite's
test_tmlp_bias_and_bf16), the dense-sin encode (3e-4, as
test_run_tmlp_angle_double_parity), layer chains 160 and 256 wide (2e-4),
composites at ragged T with and without the view head and packed (the JAX
composite suite's 1e-3), and a run_rays frame of composites at T = 12
(2e-3, as the renderer parity tests).

On the CPU the port's wrappers take their plain versions; the kernels
themselves are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.ops import fused_mlp_t as tfm

torch.set_num_threads(1)


def _to_torch(layers, dtype=torch.float32):
    """JAX layers -> the port's: weights in `dtype`, biases float32."""
    out = []
    for p in layers:
        q = {"w": torch.tensor(np.asarray(p["w"], np.float32)).to(dtype)}
        if "b" in p:
            q["b"] = torch.tensor(np.asarray(p["b"], np.float32))
        out.append(q)
    return out


def _points(n, bound, seed):
    x = np.random.default_rng(seed).uniform(-bound, bound, (n, 3))
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 0.05)])
def test_biased_run_tmlp_matches_jax(dtype, tol):
    """test_tmlp_bias_and_bf16's net: 21 -> 32 -> 32 -> 8, ReLU, biased."""
    enc_freqs, bound = 3, 2.0
    layers = jfields.init_mlp(jax.random.key(1), 21, 8, 32, 3, bias=True)
    # biases of a visible size (init_mlp draws them zero)
    rng = np.random.default_rng(2)
    layers = [dict(p, b=jnp.asarray(rng.normal(0, 0.3, p["b"].shape),
                                    jnp.float32)) for p in layers]
    jl = layers if dtype == torch.float32 else [
        dict(p, w=p["w"].astype(jnp.bfloat16)) for p in layers]
    x = _points(40, bound, seed=3)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), jl, enc_freqs, bound,
                                  block=16, interpret=True))
    tm = tfm.TransposedFieldMLP(_to_torch(layers, dtype), enc_freqs, bound)
    got = tfm.run_tmlp(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), ref[:8], rtol=tol, atol=tol)
    # the biases move the output: a bias-free chain is far from it
    bare = tfm.TransposedFieldMLP([{"w": p["w"]} for p in
                                   _to_torch(layers, dtype)], enc_freqs,
                                  bound)
    assert float((tfm.run_tmlp(torch.from_numpy(x), bare) - got).abs().max()
                 ) > 10 * tol


def test_biased_skip_composite_matches_jax():
    """Biases on a skip net through the composite, with the view head."""
    layers = jfields.init_skip_mlp(jax.random.key(4), 27, 16, 32, 4, (2,),
                                   bias=True)
    rng = np.random.default_rng(5)
    layers = [dict(p, b=jnp.asarray(rng.normal(0, 0.3, p["b"].shape),
                                    jnp.float32)) for p in layers]
    view = jfields.init_mlp(jax.random.key(6), 31, 3, 32, 3, bias=False)
    N, T = 12, 8
    x = _points(N * T, 2.0, seed=7)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = np.concatenate([rng.normal(0, 1, (N, 6)), np.zeros((N, 2))],
                        1).astype(np.float32)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers, 4, 2.0,
        (2,), leaky=True, interpret=True, rays8=jnp.asarray(r8),
        view_layers=view)
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 4, 2.0, (2,), leaky=True)
    vm = tfm.ViewMLP(_to_torch(view), 16, 4)
    got = tfm.run_tmlp_composite(torch.from_numpy(x.T.copy()),
                                 torch.from_numpy(dl), torch.from_numpy(ts),
                                 tm, view=vm, rays8=torch.from_numpy(r8))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :16],
                               rtol=1e-3, atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("angle_double", [True, False])
@pytest.mark.parametrize("transposed", [False, True])
def test_dense_sin_encode_matches_jax(angle_double, transposed):
    """test_run_tmlp_angle_double_parity's net: 39 -> 32 x 3 (skip at 2) ->
    16, leaky, 6 frequencies."""
    layers = jfields.init_skip_mlp(jax.random.key(5), 39, 16, 32, 4, (2,),
                                   bias=False)
    x = _points(64, 2.0, seed=8)
    feed = x.T.copy() if transposed else x
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(feed), layers, 6, 2.0, (2,),
                                  leaky=True, block=32, interpret=True,
                                  angle_double=angle_double,
                                  transposed=transposed))
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 6, 2.0, (2,), leaky=True,
                                angle_double=angle_double)
    got = tfm.run_tmlp(torch.from_numpy(feed), tm, transposed=transposed)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=3e-4, atol=3e-4)


def test_dense_sin_columns():
    """The dense-sin encoding read back column by column (one-layer probe
    nets) is sin(z 2^f), sin(z 2^f + pi/2) in make_enc_consts' order; grid
    tables refuse it, as the JAX kernels assert."""
    tm = tfm.TransposedFieldMLP([{"w": torch.zeros(27, 16)}], 4, 2.0,
                                angle_double=False)
    x = torch.from_numpy(_points(50, 2.0, seed=9))
    z = x * tm.scale
    want = [z]
    for f in range(4):
        want += [torch.sin(z * 2.0 ** f), torch.sin(z * 2.0 ** f
                                                    + tfm.HALF_PI)]
    want = torch.cat(want, 1)
    got = torch.cat([tfm.run_tmlp(x, p)[1:].T for p in tfm.encode_probes(tm)],
                    1)[:, :27]
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tfm.TransposedFieldMLP([{"w": torch.zeros(27 + 4, 16)}], 4, 2.0,
                               angle_double=False,
                               cp_lines=torch.zeros(3, 8, 4))


@pytest.mark.parametrize("width", [160, 256])
def test_wide_chain_matches_jax(width):
    """A skip net of layers 160 or 256 wide (two accumulator chunks in the
    kernels), float32."""
    layers = jfields.init_skip_mlp(jax.random.key(width), 27, 16, width, 4,
                                   (2,), bias=False)
    x = _points(48, 2.0, seed=10)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), layers, 4, 2.0, (2,),
                                  leaky=True, block=16, interpret=True))
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 4, 2.0, (2,), leaky=True)
    got = tfm.run_tmlp(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,pack_q", [(3, 1), (12, 1), (24, 1), (40, 1),
                                      (100, 1), (24, 4)])
@pytest.mark.parametrize("with_view", [True, False])
def test_ragged_T_composite_matches_jax(T, pack_q, with_view):
    """Rays of T samples that are neither a divisor nor a multiple of 16;
    the packed epilogue at T = 24, q = 4 (the ray kernels' pick there)."""
    layers = jfields.init_skip_mlp(jax.random.key(11), 27, 16, 32, 3, (1,),
                                   bias=False)
    view = jfields.init_mlp(jax.random.key(12), 31, 3, 32, 3, bias=False)
    N = 8
    rng = np.random.default_rng(T)
    x = _points(N * T, 2.0, seed=T + 1)
    rows = (N, T) if pack_q == 1 else (N // pack_q, pack_q * T, 1)
    dl = rng.uniform(0.01, 0.1, rows).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = np.concatenate([rng.normal(0, 1, (N, 6)), np.zeros((N, 2))],
                        1).astype(np.float32)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers, 4, 2.0,
        (1,), leaky=True, interpret=True,
        rays8=jnp.asarray(r8) if with_view else None,
        view_layers=view if with_view else None, pack_q=pack_q,
        T=T if pack_q > 1 else None)
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 4, 2.0, (1,), leaky=True)
    vm = tfm.ViewMLP(_to_torch(view), 16, 4) if with_view else None
    got = tfm.run_tmlp_composite(
        torch.from_numpy(x.T.copy()), torch.from_numpy(dl),
        torch.from_numpy(ts), tm, view=vm,
        rays8=torch.from_numpy(r8) if with_view else None, pack_q=pack_q,
        T=T)
    assert len(got) == len(ref) == (4 if with_view else 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :16],
                               rtol=1e-3, atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3)


def test_run_rays_at_16_12_matches_jax():
    """A tiny MLP field through run_rays at (16, 12): the final level's
    composite takes rays of 12 samples."""
    jmc = JModelConfig(field_type="mlp", mlp_field_width=32,
                       mlp_field_depth=4, mlp_prop_width=16,
                       mlp_prop_depth=2, mlp_enc_freqs=4,
                       mlp_prop_enc_freqs=3)
    jrc = JRenderConfig(num_steps=(16, 12), bound=4.0, contract=True)
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    rng = np.random.default_rng(17)
    o = rng.normal(0, 0.5, (24, 3)).astype(np.float32)
    d = (-o + 0.3 * rng.normal(0, 1, (24, 3))).astype(np.float32)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    calls = []
    real = fields.run_tmlp_composite

    def spy(*a, **k):
        calls.append(a[1].shape[-1] if k.get("pack_q", 1) == 1 else k["T"])
        return real(*a, **k)

    fields.run_tmlp_composite = spy
    try:
        got = renderer.run_rays(tm, tp, torch.from_numpy(o),
                                torch.from_numpy(d))
    finally:
        fields.run_tmlp_composite = real
    assert renderer.uses_kernels(tm) and calls == [12]
    for k in ("weights_sum", "depth", "image"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


def test_branch_variants_apply_to_the_source():
    """Every text substitution of port_tools/field_branch_variants.py finds
    its text in csrc/fused_mlp_t.cu (kernel_variants exits where one does
    not)."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "field_branch_variants",
        root / "port_tools" / "field_branch_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "sanerf_tpu_torch" / "csrc" / "fused_mlp_t.cu").read_text()
    for name, subs in mod.VARIANTS.items():
        if isinstance(subs, str):
            continue  # a tree, unpacked before the chip run
        for old, new in subs:
            assert old in src and old != new, name
