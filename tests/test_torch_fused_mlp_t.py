"""Parity: the plain versions of the port's fused MLP kernels
(sanerf_tpu_torch/ops/fused_mlp_t.py) vs the JAX Pallas kernels in
interpret mode, with the same weights: run_tmlp at 3e-4 in float32 (0.05
with bf16 weights, the JAX suite's bf16 bound), run_tmlp_composite at
1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models import fields as jfields
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu.ops.cpgrid import init_lines
from sanerf_tpu_torch.ops import fused_mlp_t as tfm

torch.set_num_threads(1)

BOUND = 2.0


def _to_torch(layers, dtype=torch.float32):
    return [{"w": torch.tensor(np.asarray(p["w"], np.float32)).to(dtype)}
            for p in layers]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _prop_net():
    layers = jfields.init_mlp(jax.random.key(0), 33, 1, 32, 2, bias=False)
    return layers, dict(enc_freqs=5, skip=(), leaky=False, cp=None, scp=None)


def _field_net(K=8, Ks=4, R=16, L=4, width=32, depth=3):
    F = 3 * (1 + 2 * L)
    layers = jfields.init_skip_mlp(jax.random.key(1), F + K, 16, width, depth,
                                   (depth // 2,), bias=False)
    cp = init_lines(jax.random.key(2), R, K)
    scp = init_lines(jax.random.key(3), R, Ks)
    return layers, dict(enc_freqs=L, skip=(depth // 2,), leaky=True, cp=cp,
                        scp=scp)


def _tm(layers, cfg, dtype=torch.float32):
    return tfm.TransposedFieldMLP(
        _to_torch(layers, dtype), cfg["enc_freqs"], BOUND, cfg["skip"],
        cfg["leaky"],
        cp_lines=None if cfg["cp"] is None else _t(cfg["cp"], dtype),
        sigma_cp_lines=None if cfg["scp"] is None else _t(cfg["scp"], dtype))


def _points(n, seed):
    x = np.random.default_rng(seed).uniform(-BOUND, BOUND, (n, 3))
    x[0] = [-BOUND, BOUND, 0.0]  # grid ends
    return x.astype(np.float32)


@pytest.mark.parametrize("net", ["prop", "field"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 0.05)])
def test_run_tmlp_matches_jax(net, dtype, tol):
    layers, cfg = _prop_net() if net == "prop" else _field_net()
    x = _points(45, seed=4)
    jl = layers if dtype == torch.float32 else jfields.cast_params(
        layers, jnp.bfloat16)
    ref = np.asarray(jfm.run_tmlp(
        jnp.asarray(x.T), jl, cfg["enc_freqs"], BOUND, cfg["skip"],
        leaky=cfg["leaky"], block=16, interpret=True, transposed=True,
        cp_lines=None if cfg["cp"] is None else (
            cfg["cp"].astype(jl[0]["w"].dtype)),
        sigma_cp_lines=None if cfg["scp"] is None else (
            cfg["scp"].astype(jl[0]["w"].dtype))))
    tm = _tm(layers, cfg, dtype)
    got = tfm.run_tmlp(torch.from_numpy(x.T.copy()), tm, transposed=True)
    assert got.shape == (tm.kout, 45)
    np.testing.assert_allclose(got.numpy(), ref[:tm.kout], rtol=tol, atol=tol)
    got_pm = tfm.run_tmlp(torch.from_numpy(x), tm)  # point-major feed
    assert torch.equal(got_pm, got)


def _rays8(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3))
    d = rng.normal(0, 1.0, (n, 3))
    return np.concatenate([o, d, np.zeros((n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("with_view", [True, False])
def test_run_tmlp_composite_matches_jax(opaque, with_view):
    layers, cfg = _field_net()
    view = jfields.init_mlp(jax.random.key(5), 31, 3, 32, 3, bias=False)
    N, T = 8, 4
    rng = np.random.default_rng(6)
    x = _points(N * T, seed=7)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = _rays8(N, seed=8)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers,
        cfg["enc_freqs"], BOUND, cfg["skip"], leaky=True, opaque=opaque,
        interpret=True, rays8=jnp.asarray(r8) if with_view else None,
        view_layers=view if with_view else None, sh_degree=4,
        cp_lines=cfg["cp"], sigma_cp_lines=cfg["scp"])
    tm = _tm(layers, cfg)
    vm = tfm.ViewMLP(_to_torch(view), 16, 4) if with_view else None
    got = tfm.run_tmlp_composite(
        torch.from_numpy(x.T.copy()), _t(dl), _t(ts), tm, opaque=opaque,
        view=vm, rays8=_t(r8) if with_view else None)
    assert len(got) == (4 if with_view else 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :16],
                               rtol=1e-3, atol=1e-3, err_msg="gsum")
    for name, g, r in zip(("depth", "wsum", "rgb"), got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_packing_layout():
    """The kernel operands: transposed layers padded to 16 outputs, rows
    of kin_h + kin_e + 8, the skip layer's encoding block at column kin_h."""
    layers, cfg = _field_net()
    tm = _tm(layers, cfg)
    flat, desc = tm.packed(torch.device("cpu"))
    n, leaky, L, F, ke, hmax = desc[:6]
    assert (n, leaky, L, F) == (3, 1, 4, 27)
    assert ke == 48 and hmax == 32  # 27 + 8 CP columns -> 48
    lay = desc[6:].reshape(n, 6)
    assert lay[1].tolist()[:4] == [32, 48, 32, 32]  # skip layer
    kin_h, kin_e, kout, kreal, off, ld = lay[1]
    w1 = flat[off:off + kout * ld].reshape(kout, ld)
    ref = torch.from_numpy(np.array(layers[1]["w"]))
    assert torch.equal(w1[:32, :32], ref[:32].T)
    assert torch.equal(w1[:32, kin_h:kin_h + F + 8], ref[32:].T)
    assert float(w1[:, kin_h + F + 8:].abs().sum()) == 0.0


@pytest.mark.parametrize("T,q", [(4, 4), (8, 2)])
def test_packed_composite_matches_jax(T, q):
    """The pack_q > 1 composite reads dl/ts as [N/q, q*T, 1] rows: against
    the JAX packed kernel (interpret) at 1e-3, and bit for bit against the
    port's unpacked version on the same operands."""
    layers, cfg = _field_net()
    view = jfields.init_mlp(jax.random.key(5), 31, 3, 32, 3, bias=False)
    N = 8
    rng = np.random.default_rng(9)
    x = _points(N * T, seed=10)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = _rays8(N, seed=11)
    pk = lambda a: a.reshape(N // q, q * T, 1)  # noqa: E731
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(pk(dl)), jnp.asarray(pk(ts)), layers,
        cfg["enc_freqs"], BOUND, cfg["skip"], leaky=True, opaque=True,
        interpret=True, block=N * T, rays8=jnp.asarray(r8), view_layers=view,
        sh_degree=4, cp_lines=cfg["cp"], sigma_cp_lines=cfg["scp"],
        pack_q=q, T=T)
    tm = _tm(layers, cfg)
    vm = tfm.ViewMLP(_to_torch(view), 16, 4)
    xt = torch.from_numpy(x.T.copy())
    got = tfm.run_tmlp_composite(xt, _t(pk(dl)), _t(pk(ts)), tm, view=vm,
                                 rays8=_t(r8), pack_q=q, T=T)
    flat = tfm.run_tmlp_composite(xt, _t(dl), _t(ts), tm, view=vm,
                                  rays8=_t(r8))
    for g, f in zip(got, flat):
        assert torch.equal(g, f)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :16],
                               rtol=1e-3, atol=1e-3, err_msg="gsum")
    for name, g, r in zip(("depth", "wsum", "rgb"), got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    with pytest.raises(ValueError, match="needs T"):
        tfm.run_tmlp_composite(xt, _t(pk(dl)), _t(pk(ts)), tm, pack_q=q)


def _from_core_matrices(flat, N, K):
    """W^T [N, K] from its 8x8 core matrices: the block of rows 8n.. and
    columns 8k.. at (k * N/8 + n) * 64, each block row-major."""
    out = torch.empty(N, K, dtype=flat.dtype)
    for k in range(K // 8):
        for n in range(N // 8):
            b = flat[(k * (N // 8) + n) * 64:][:64].reshape(8, 8)
            out[8 * n:8 * n + 8, 8 * k:8 * k + 8] = b
    return out


def test_packing_layout_bf16():
    """bfloat16 operands: each layer's W^T [kout_pad][kin_h + kin_e] as the
    8x8 core matrices wgmma reads B from, 128-byte aligned, unpacking back
    to the layer weights exactly (the skip layer's encoding block at
    column kin_h, zeros in the padding)."""
    layers, cfg = _field_net()
    tm = _tm(layers, cfg, torch.bfloat16)
    flat, desc = tm.packed(torch.device("cpu"))
    assert flat.dtype == torch.bfloat16
    n, F, ke = desc[0], desc[3], desc[4]
    lay = desc[6:].reshape(n, 6)
    for l, (kin_h, kin_e, kout, kreal, off, ld) in enumerate(lay):
        assert off % 64 == 0 and ld == kin_h + kin_e
        wt = _from_core_matrices(flat[off:off + kout * ld], kout, ld)
        ref = _to_torch(layers, torch.bfloat16)[l]["w"]
        want = torch.zeros(kout, ld, dtype=torch.bfloat16)
        if kin_e:
            hid = ref.shape[0] - (F + 8)
            want[:kreal, :hid] = ref[:hid].T
            want[:kreal, kin_h:kin_h + F + 8] = ref[hid:].T
        else:
            want[:kreal, :ref.shape[0]] = ref.T
        assert torch.equal(wt, want), l
    assert ke == 48
    w = torch.randn(32, 48)
    core = tfm.core_matrices(w)
    assert torch.equal(core[:8], w[0, :8]) and torch.equal(core[8:16], w[1, :8])
    assert torch.equal(core[64:72], w[8, :8])  # the next 8 rows of N
    assert torch.equal(core[4 * 64:4 * 64 + 8], w[0, 8:16])  # the next 8 of K
    assert torch.equal(_from_core_matrices(core, 32, 48), w)
