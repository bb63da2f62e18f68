"""Parity: the plain versions of the port's fused MLP kernels
(sanerf_tpu_torch/ops/fused_mlp_t.py) vs the JAX Pallas kernels in
interpret mode, with the same weights: run_tmlp at 3e-4 in float32 (0.05
with bf16 weights, the JAX suite's bf16 bound), run_tmlp_composite at
1e-3."""

import copy

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
    """The float32 kernel operands: transposed layers padded to 16 outputs,
    the skip layer's encoding block at column kin_h, each W^T [kout][kin_h
    + kin_e] as 8x8 core matrices (as in bf16), 256-byte aligned. The
    3xTF32 chain's lane 4g + t reads its mma B fragment of k step s and
    n-tile nt, W^T[8 nt + g][8 s + 2t] and [8 s + 2t + 1], as the float2 at
    2 lane of core matrix (s, nt): the 32 lanes read 256 contiguous bytes."""
    layers, cfg = _field_net()
    tm = _tm(layers, cfg)
    flat, desc = tm.packed(torch.device("cpu"))
    assert flat.dtype == torch.float32
    n, leaky, L, F, ke, hmax = desc[:6]
    assert (n, leaky, L, F) == (3, 1, 4, 27)
    assert ke == 48 and hmax == 32  # 27 + 8 CP columns -> 48
    lay = desc[6:].reshape(n, 6)
    assert lay[1].tolist()[:4] == [32, 48, 32, 32]  # skip layer
    for l, (kin_h, kin_e, kout, kreal, off, ld) in enumerate(lay):
        assert ld == kin_h + kin_e and off % 64 == 0
        slab = flat[off:off + kout * ld]
        wt = _from_core_matrices(slab, kout, ld)
        ref = torch.from_numpy(np.array(layers[l]["w"]))
        want = torch.zeros(kout, ld)
        if kin_e:
            want[:kreal, :32] = ref[:32].T
            want[:kreal, kin_h:kin_h + F + 8] = ref[32:].T
        else:
            want[:kreal, :ref.shape[0]] = ref.T
        assert torch.equal(wt, want), l
        for s_ in range(ld // 8):
            for nt in range(kout // 8):
                blk = slab[(s_ * (kout // 8) + nt) * 64:][:64]
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    assert torch.equal(
                        blk[2 * lane:2 * lane + 2],
                        want[8 * nt + g, 8 * s_ + 2 * t:8 * s_ + 2 * t + 2])


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


# -- the float32 chain's arithmetic: 3xTF32 ---------------------------------
#: chip_smoke.py's float32-faithful hold: |d| <= F32_FAITHFUL (1 + |ref|)
F32_FAITHFUL = 1e-5


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits of the float32 zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x):
    """x as a tf32 mma operand reads it: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split_tf32: hi the tf32 rounding of x, lo = x - hi
    (exact), as the tensor core reads them."""
    hi = _tf32(x)
    return hi, _tf32_read(x - hi)


def _default_field():
    """ModelConfig()'s field and view head at full width: 63 -> 128 x 8
    with the skip at 4 -> 16, view 31 -> 32 -> 32 -> 3."""
    return (jfields.init_skip_mlp(jax.random.key(11), 63, 16, 128, 8, (4,),
                                  bias=False),
            jfields.init_mlp(jax.random.key(12), 31, 3, 32, 3, bias=False),
            dict(enc_freqs=10, skip=(4,), leaky=True, cp=None, scp=None))


def _split_values():
    """The default field's weights, plus values at rounding ties."""
    layers, _, _ = _default_field()
    w = torch.cat([_t(p["w"]).reshape(-1) for p in layers])
    ties = torch.tensor([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    return torch.cat([w, ties, torch.randn(1000, generator=torch.Generator()
                                           .manual_seed(0)) * 1e3])


def test_tf32_split_hi_has_its_low_13_bits_zero():
    v = _split_values()
    hi, lo = _split(v)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(hi + (v - hi), v)  # the rest is exact
    # ties go away from zero; below a tie rounds down
    assert hi[-1004:-1000].view(torch.int32).tolist() == [
        0x3F802000, 0xBF802000 - 2 ** 32, 0x3F804000, 0x3F800000]


def test_tf32_split_hi_lo_reproduce_the_value():
    """hi + lo, as the tensor core reads lo, is v to within 2^-21 |v| (lo
    rounded as well would be 2^-22); hi alone only to 2^-11 |v|."""
    v = _split_values()
    hi, lo = _split(v)
    assert bool(((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all())
    assert bool(((hi - v).abs() <= 2.0 ** -11 * v.abs()).all())
    nz = v != 0
    assert float(((hi - v).abs()[nz] / v.abs()[nz]).max()) > 2.0 ** -13


def _rz32(x):
    """float64 -> float32 toward zero (the tensor core's truncation of the
    sum it writes, modelled on an exact sum)."""
    return (x.contiguous().view(torch.int64) & ~((1 << 29) - 1)).view(
        torch.float64).to(torch.float32)


def _mma_products(a, w, passes, acc):
    """a [P, K] times w [K, N] as the chain's k steps of 8 on the tensor
    core: each step's tf32 products (exact, summed exactly) truncated to
    float32 once an mma, into a zeroed fragment added to the accumulator
    in float32 (acc="fresh", the kernel) or into the accumulator itself
    (acc="running")."""
    K = a.shape[1]
    a = torch.nn.functional.pad(a, (0, -K % 8))
    w = torch.nn.functional.pad(w, (0, 0, 0, -K % 8))
    out = torch.zeros(a.shape[0], w.shape[1])
    for k in range(0, a.shape[1], 8):
        (ah, al), (wh, wl) = _split(a[:, k:k + 8]), _split(w[k:k + 8])
        pairs = [(ah, wh)] if passes == 1 else [(al, wh), (ah, wl), (ah, wh)]
        c = out if acc == "running" else torch.zeros_like(out)
        for u, v in pairs:
            c = _rz32(c.double() + u.double() @ v.double())
        out = c if acc == "running" else out + c
    return out


def _chain_emulated(tm, xT, passes, acc=None):
    """The kernel's float32 chain in plain torch: every product of a layer
    as a_lo b_hi + a_hi b_lo + a_hi b_hi of the split operands (passes=3;
    each exact in float32), or a_hi b_hi alone (passes=1, one-pass TF32),
    summed in float32 (acc=None) or as the tensor core sums them
    (_mma_products). The encoding and the sigma tables' sum come from the
    plain version through tm's encode probes (exact: one-hot weights).
    -> [P, kout]"""
    outs = [tfm.run_tmlp_plain(xT, p) for p in tfm.encode_probes(tm)]
    enc = torch.cat([o[1:16] for o in outs])[:tm.F + tm.kc].T

    def product(a, w):
        if acc is not None:
            return _mma_products(a, w, passes, acc)
        (ah, al), (wh, wl) = _split(a), _split(w)
        return ah @ wh if passes == 1 else al @ wh + ah @ wl + ah @ wh

    h = enc
    for l, w in enumerate(tm.ws):
        acc_ = product(torch.cat([h, enc], 1) if l in tm.skip and l else h,
                       w.float())
        if l == len(tm.ws) - 1:
            if tm.scp is not None or tm.svm is not None:
                acc_[:, 0] += outs[0][0]
            return acc_
        h = torch.where(acc_ >= 0, acc_, 0.01 * acc_) if tm.leaky else \
            torch.clamp(acc_, min=0.0)
    raise AssertionError("unreachable")


def _faithful(got, ref):
    """max |got - ref| / (1 + |ref|): the F32_FAITHFUL hold passes at or
    below F32_FAITHFUL."""
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


def test_3xtf32_chain_is_float32_faithful_at_the_default_width():
    """The 3xTF32 arithmetic of the kernel's float32 chain, emulated, holds
    the JAX package's float32 run_tmlp (interpret mode) to F32_FAITHFUL at
    the default field's width; one-pass TF32 does not (the planted fault
    chip_smoke's hold must catch)."""
    layers, _, cfg = _default_field()
    x = _points(256, seed=13)
    ref = np.asarray(jfm.run_tmlp(
        jnp.asarray(x.T), layers, cfg["enc_freqs"], BOUND, cfg["skip"],
        leaky=True, block=64, interpret=True, transposed=True))[:16].T
    tm = _tm(layers, cfg)
    xt = torch.from_numpy(x.T.copy())
    assert _faithful(_chain_emulated(tm, xt, 3).numpy(), ref) <= F32_FAITHFUL
    assert _faithful(_chain_emulated(tm, xt, 1).numpy(), ref) > F32_FAITHFUL
    # and the plain version itself, the kernel's reference on the card
    assert _faithful(tm.forward_plain(xt).numpy(), ref) <= F32_FAITHFUL


def test_3xtf32_composite_is_float32_faithful_at_the_default_width():
    """The same through the composite with the view head: gsum, depth,
    weights_sum and rgb of 16 rays of 16 samples against the JAX package's
    float32 run_tmlp_composite (interpret mode)."""
    layers, view, cfg = _default_field()
    N, T = 16, 16
    rng = np.random.default_rng(14)
    x = _points(N * T, seed=15)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = _rays8(N, seed=16)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers,
        cfg["enc_freqs"], BOUND, cfg["skip"], leaky=True, opaque=True,
        interpret=True, rays8=jnp.asarray(r8), view_layers=view, sh_degree=4)
    ref = [np.asarray(ref[0])[:, :16]] + [np.asarray(r) for r in ref[1:]]
    tm = _tm(layers, cfg)
    vm = tfm.ViewMLP(_to_torch(view), 16, 4)
    xt = torch.from_numpy(x.T.copy())
    ratio = {}
    for passes in (3, 1):
        em = copy.copy(tm)
        em.forward_plain = lambda xT, dtype, p=passes: _chain_emulated(tm, xT, p)
        got = tfm.run_tmlp_composite_plain(xt, _t(dl), _t(ts), em, True, vm,
                                           _t(r8))
        ratio[passes] = max(_faithful(g.numpy(), r) for g, r in zip(got, ref))
    assert ratio[3] <= F32_FAITHFUL < ratio[1], ratio


def test_f32_variants_apply_to_the_source():
    """Every text substitution of port_tools/field_f32_variants.py finds
    its text in csrc/fused_mlp_t.cu (kernel_variants exits where one does
    not)."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "field_f32_variants", root / "port_tools" / "field_f32_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "sanerf_tpu_torch" / "csrc" / "fused_mlp_t.cu").read_text()
    for name, subs in mod.VARIANTS.items():
        if isinstance(subs, str):
            continue  # a whole file, unpacked before the chip run
        for old, new in subs:
            assert old in src and old != new, name


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("q", [1, 2])
def test_plain_f64_in_slices_is_the_whole_float64_plain_version(q):
    """chip_smoke.plain_f64 (the float64 plain version in slices of whole
    rays, packed operands unpacked) gives the float64 plain version of the
    whole launch; the float32 plain version is the same function within
    float32 rounding."""
    cs = _chip_smoke()
    layers, cfg = _field_net(width=32, depth=3)
    _, view, _ = _default_field()
    tm, vm = _tm(layers, cfg), tfm.ViewMLP(_to_torch(view), 16, 4)
    N, T = 24, 8
    rng = np.random.default_rng(21)
    xt = torch.from_numpy(_points(N * T, seed=22).T.copy())
    dl = _t(rng.uniform(0.05, 0.3, (N, T)))
    ts = torch.cumsum(dl, 1)
    k = {"opaque": True, "view": vm, "rays8": _t(_rays8(N, seed=23))}
    whole = tfm.run_tmlp_composite_plain(xt, dl, ts, tm, **k,
                                         dtype=torch.float64)
    pk = (lambda v: v.reshape(N // q, q * T, 1)) if q > 1 else (lambda v: v)
    kq = dict(k, pack_q=q, T=T) if q > 1 else k
    got = cs.plain_f64("run_tmlp_composite", (xt, pk(dl), pk(ts), tm), kq,
                       chunk=5 * T)
    f32 = tfm.run_tmlp_composite_plain(xt, dl, ts, tm, **k)
    for g, w, f in zip(got, whole, f32):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert torch.allclose(g, w, rtol=1e-12, atol=1e-12)
        assert torch.allclose(f.double(), w, rtol=1e-5, atol=1e-5)
    run = cs.plain_f64("run_tmlp", (xt, tm), {"transposed": True}, chunk=50)
    assert torch.allclose(run[0], tfm.run_tmlp_plain(xt, tm, torch.float64),
                          rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def asset_launches():
    """The field launches of a 32^2 (32, 16) frame of the shipped asset
    with its float32 weights (chip_smoke's phase 2 at 512^2), on the CPU."""
    import dataclasses
    from pathlib import Path

    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    cs = _chip_smoke()
    root = Path(__file__).resolve().parents[1]
    mc, rc, p32 = load_asset(str(root / "assets" / "serving_student"),
                             device="cpu")
    size = 32
    model = fields.make_model(mc, dataclasses.replace(
        rc, num_steps=(32, 16), max_ray_batch=size * size))
    f = fov_to_focal(60.0, size)
    o, d = full_frame_rays(torch.tensor(cs.SERVE_POSE),
                           torch.tensor([f, f, size / 2, size / 2]), size,
                           size, device="cpu")
    kern_fn = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
               "run_tmlp": tfm.run_tmlp,
               "run_tmlp_composite": tfm.run_tmlp_composite}
    calls = {}
    with cs.spying(renderer, fields, kern_fn, calls, None), torch.no_grad():
        renderer.render_frame(model, p32, o, d, chunk=size * size)
    return cs, [(name, a, k) for (_, name), ls in sorted(calls.items())
                if name.startswith("run_tmlp") for a, k in ls]


@pytest.mark.parametrize("launch", ["run_tmlp", "run_tmlp_composite"])
def test_float64_hold_on_the_asset_weights(asset_launches, launch):
    """chip_smoke's hold of the asset's float32 launches, against the
    float64 plain version, on the emulated tensor-core chain: 3xTF32 into a
    fresh fragment a k step (the kernel) within F32_F64_MULT times the
    float32 plain version's own error, one-pass TF32 far past it, and the
    products summed into the accumulator itself further off than the
    fresh fragment."""
    cs, launches = asset_launches
    (name, a, k), = [c for c in launches if c[0] == launch]
    tm = cs.field_of(name, a)
    assert tm.dtype == torch.float32

    def run(fwd):
        em = copy.copy(tm)
        em.forward_plain = fwd
        if name == "run_tmlp":
            return (tfm.run_tmlp_plain(a[0], em),)
        return tfm.run_tmlp_composite_plain(*a[:3], em, **k)

    ref = run(tm.forward_plain)
    r64 = cs.plain_f64(name, a, k)
    err = {}
    for key, passes, acc in (("fresh", 3, "fresh"), ("running", 3, "running"),
                             ("one_pass", 1, "fresh")):
        got = run(lambda xT, dtype, p=passes, c=acc:
                  _chain_emulated(tm, xT, p, c))
        err[key], e_p = cs.f64_errors(got, ref, r64)
    bound = cs.F32_F64_MULT * e_p + cs.F32_ULP
    assert err["fresh"] <= bound < err["one_pass"], (err, e_p)
    assert err["fresh"] < err["running"], (err, e_p)
