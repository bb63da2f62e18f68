"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (the kernels are built
by nvcc at first use and have no CPU mode). This file imports neither jax
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: 1e-5 for the ray kernels, the JAX suite's
float32 bounds for the MLP kernels with float32 weights (3e-4 and 1e-3);
flatten3_nt and the packed ts/dl rows bit for bit; the packed composite
within 1e-6 of the unpacked one on the same operands.
"""

import pytest
import torch

from sanerf_tpu_torch.ops import fused_mlp_t as fm
from sanerf_tpu_torch.ops import ray_kernels as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=tol, atol=tol)


def _rays8(n, g, dev):
    o = torch.randn(n, 3, generator=g, device=dev) * 0.5
    d = torch.randn(n, 3, generator=g, device=dev)
    near = torch.rand(n, 1, generator=g, device=dev) * 0.4 + 0.2
    far = near + 1.0 + 7.0 * torch.rand(n, 1, generator=g, device=dev)
    sp = lambda x: torch.where(x < 1, x / 2, 1 - 1 / (2 * x))  # noqa: E731
    return torch.cat([o, d, sp(near), sp(far)], 1).contiguous()


@pytest.mark.parametrize("T,jittered", [(32, False), (7, True)])
def test_ray_level0_kernel(dev, T, jittered):
    g = torch.Generator(device=dev).manual_seed(T)
    r8 = _rays8(301, g, dev)
    jit = ((torch.rand(301, T + 1, generator=g, device=dev) - 0.5) / T
           if jittered else None)
    before = rk.ray_level0.launches
    got = rk.ray_level0(r8, T, True, jitter=jit)
    assert rk.ray_level0.launches == before + 1
    _close(got, rk.ray_level0_plain(r8, T, True, jitter=jit), 1e-5)


@pytest.mark.parametrize("uniform_prev", [False, True])
def test_ray_level_kernel(dev, uniform_prev):
    g = torch.Generator(device=dev).manual_seed(1)
    r8 = _rays8(257, g, dev)
    b0 = rk.ray_level0(r8, 32, True)[0]
    w = torch.rand(257, 32, generator=g, device=dev)
    w[::5] = 0.0  # degenerate rows: the +0.01 floor alone
    jit = (torch.rand(257, 17, generator=g, device=dev) - 0.5) / 17
    before = rk.ray_level.launches
    got = rk.ray_level(r8, w, b0, 16, True, uniform_prev=uniform_prev,
                       jitter=None if uniform_prev else jit)
    assert rk.ray_level.launches == before + 1
    _close(got, rk.ray_level_plain(r8, w, b0, 16, True, uniform_prev,
                                   None if uniform_prev else jit), 1e-5)


def _layers(sizes, g, dev):
    return [{"w": torch.randn(i, o, generator=g, device=dev) / i ** 0.5}
            for i, o in sizes]


def _field(g, dev, L=4, K=8, Ks=4, R=16, W=32):
    F = 3 * (1 + 2 * L)
    layers = _layers([(F + K, W), (W + F + K, W), (W, 16)], g, dev)
    cp = torch.randn(3, R, K, generator=g, device=dev) * 0.5 + 0.5
    scp = torch.randn(3, R, Ks, generator=g, device=dev) * 0.5
    return fm.TransposedFieldMLP(layers, L, 2.0, (1,), leaky=True,
                                 cp_lines=cp, sigma_cp_lines=scp)


@pytest.mark.parametrize("net", ["prop", "field"])
def test_run_tmlp_kernel(dev, net):
    g = torch.Generator(device=dev).manual_seed(2)
    tm = (fm.TransposedFieldMLP(_layers([(33, 32), (32, 1)], g, dev), 5, 2.0)
          if net == "prop" else _field(g, dev))
    x = torch.rand(3, 1001, generator=g, device=dev) * 4 - 2
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _close(got, fm.run_tmlp_plain(x, tm), 3e-4)


@pytest.mark.parametrize("T,opaque,with_view", [(16, True, True),
                                                (32, False, True),
                                                (4, True, False)])
def test_run_tmlp_composite_kernel(dev, T, opaque, with_view):
    g = torch.Generator(device=dev).manual_seed(3)
    tm = _field(g, dev)
    view = (fm.ViewMLP(_layers([(15 + 16, 32), (32, 32), (32, 3)], g, dev),
                       16, 4) if with_view else None)
    n = 67
    x = torch.rand(3, n * T, generator=g, device=dev) * 4 - 2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    r8 = _rays8(n, g, dev)
    before = fm.run_tmlp_composite.launches
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=opaque, view=view,
                                rays8=r8)
    assert fm.run_tmlp_composite.launches == before + 1
    _close(got, fm.run_tmlp_composite_plain(x, dl, ts, tm, opaque, view, r8),
           1e-3)


@pytest.mark.parametrize("N,T", [(301, 16), (1000, 7), (4, 1)])
def test_flatten3_nt_kernel(dev, N, T):
    g = torch.Generator(device=dev).manual_seed(N)
    x3 = torch.randn(3, N, T, generator=g, device=dev)
    before = rk.flatten3_nt.launches
    got = rk.flatten3_nt(x3)
    torch.cuda.synchronize()
    assert rk.flatten3_nt.launches == before + 1
    assert torch.equal(got, rk.flatten3_nt_plain(x3))


@pytest.mark.parametrize("level,pack_q", [(0, 8), (1, 4), (1, 2)])
def test_packed_rows_kernel(dev, level, pack_q):
    g = torch.Generator(device=dev).manual_seed(level + pack_q)
    n, T = 256, 16
    r8 = _rays8(n, g, dev)
    if level == 0:
        fn = lambda **k: rk.ray_level0(r8, T, True, **k)  # noqa: E731
    else:
        b0 = rk.ray_level0(r8, 32, True)[0]
        w = torch.rand(n, 32, generator=g, device=dev)
        fn = lambda **k: rk.ray_level(r8, w, b0, T, True, **k)  # noqa: E731
    flat = fn()
    before = (rk.ray_level0.packed_launches, rk.ray_level.packed_launches)
    got = fn(pack_q=pack_q)
    torch.cuda.synchronize()
    after = (rk.ray_level0.packed_launches, rk.ray_level.packed_launches)
    assert after[level] == before[level] + 1
    assert len(got) == 6
    for a, b in zip(got[:4], flat):
        assert torch.equal(a, b)
    assert got[4].shape == (n // pack_q, pack_q * T, 1)
    assert torch.equal(got[4].reshape(n, T), flat[1])
    assert torch.equal(got[5].reshape(n, T), flat[2])
    with pytest.raises(ValueError):
        fn(pack_q=3)


@pytest.mark.parametrize("T,pack_q", [(16, 8), (32, 4)])
def test_packed_composite_kernel(dev, T, pack_q):
    g = torch.Generator(device=dev).manual_seed(T)
    tm = _field(g, dev)
    view = fm.ViewMLP(_layers([(15 + 16, 32), (32, 32), (32, 3)], g, dev),
                      16, 4)
    n = 72
    x = torch.rand(3, n * T, generator=g, device=dev) * 4 - 2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    r8 = _rays8(n, g, dev)
    ref = fm.run_tmlp_composite(x, dl, ts, tm, view=view, rays8=r8)
    before = fm.run_tmlp_composite.packed_launches
    pk = lambda v: v.reshape(n // pack_q, pack_q * T, 1)  # noqa: E731
    got = fm.run_tmlp_composite(x, pk(dl), pk(ts), tm, view=view, rays8=r8,
                                pack_q=pack_q, T=T)
    assert fm.run_tmlp_composite.packed_launches == before + 1
    _close(got, ref, 1e-6)
    _close(got, fm.run_tmlp_composite_plain(x, pk(dl), pk(ts), tm, True,
                                            view, r8, pack_q, T), 1e-3)
