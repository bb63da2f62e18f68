"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (the kernels are built
by nvcc at first use and have no CPU mode). This file imports neither jax
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: 1e-5 for the ray kernels (ray_level at
the served launch shapes, with adversarial weight rows and jitter), the JAX suite's
float32 bounds for the MLP kernels with float32 weights (3e-4 and 1e-3),
and at the full widths also F32_FAITHFUL (1e-5 + 1e-5 |ref|);
the grid branches in bf16 at 5e-3 and their encode probes at 1e-2, element
by element; ray_level0 (both of its kernels at every T, N, jitter and
pack_q), flatten3_nt, the packed ts/dl rows, gather_rows and
hash_grid_forward (against the level route on the plain gather) bit for bit;
the packed composite within 1e-6 of the unpacked one on the same operands;
gather_rows_backward against index_add_ and hash_grid_backward against
its plain version at |d| <= 1e-5 S + 1e-5 |ref| (chip_smoke.py's
SCATTER_MAG; their atomics sum in another order), S the sum of the
magnitudes of the adds into an element. The configurations past the kernels' former
limits (rays past 128 samples, 12 to 32 layers, widths to 512, view heads
to 128, 20 to 64 composite outputs, ladders of 16 levels, 94 MB of tables,
sum_after_mlp) at the same bounds, and through run_rays against the plain
path at chip_smoke.py's PATH_TOL.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from sanerf_tpu_torch.config import HashGridConfig
from sanerf_tpu_torch.ops import fused_mlp_t as fm
from sanerf_tpu_torch.ops import gather, hashgrid
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


def _bits(t):
    return t.view(torch.int32)


def _offset_view(t, offset):
    """t's values in a contiguous view that starts `offset` floats into a
    larger buffer (offset 1: not 16 B-aligned)."""
    buf = torch.empty(t.numel() + offset, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# ray_level0 runs its tile kernel from 4 samples a resident thread (at most
# 1.1 M samples on an H100) and one warp a ray below that: 1,200,003 // T
# rays take the tile kernel at any T, are not a multiple of the tiles' R (a
# multiple of 4 chosen from T and N) and leave a ragged last tile. N = 1, 3
# and 997 (fewer rays than a tile, ragged), the 1,024 rays of the feature
# render and the 512^2 RGB frame's 262,144; with and without jitter;
# pack_q 0, 2 and 8; rays8 and jitter 16 B-aligned or not (offset 1).
LEVEL0_CASES = (
    [(1_200_003 // T, T, j, 0, 0) for T in (1, 7, 16, 32, 33, 64, 128)
     for j in (False, True)]
    + [(N, T, j, 0, 0) for N, T in ((1, 32), (3, 32), (301, 32), (301, 7),
                                    (997, 1), (997, 33), (997, 128),
                                    (1024, 32), (1024, 128), (262144, 32),
                                    (262144, 128))
       for j in (False, True)]
    + [(N, T, True, q, 0) for N in (1000, 200000) for T in (7, 16, 32)
       for q in (2, 8)]
    + [(1001, 16, True, 0, 1), (100001, 16, True, 0, 1)])


@pytest.mark.parametrize("N,T,jittered,pack_q,offset", LEVEL0_CASES)
def test_ray_level0_kernel(dev, N, T, jittered, pack_q, offset):
    """Bit for bit against the plain version, every output."""
    g = torch.Generator(device=dev).manual_seed(N + T + jittered + pack_q)
    r8 = _offset_view(_rays8(N, g, dev), offset)
    jit = (_offset_view((torch.rand(N, T + 1, generator=g, device=dev)
                         - 0.5) / T, offset) if jittered else None)
    assert (r8.data_ptr() % 16 == 0) == (offset == 0)
    before = rk.ray_level0.launches
    got = rk.ray_level0(r8, T, True, jitter=jit, pack_q=pack_q)
    assert rk.ray_level0.launches == before + 1
    ref = rk.ray_level0_plain(r8, T, True, jitter=jit, pack_q=pack_q)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


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


def _prev_level(N, T0, g, dev):
    """Rays, previous weights and edges, with adversarial rows every 97:
    all-zero weights (the 0.01 floor alone), one-hot, and a CDF that
    reaches 1 early (zero-width intervals at the end)."""
    r8 = _rays8(N, g, dev)
    b0 = rk.ray_level0(r8, T0, True)[0]
    w = torch.rand(N, T0, generator=g, device=dev) ** 4
    w[0::97] = 0.0
    w[1::97] = 0.0
    w[1::97, T0 // 3] = 1.0
    w[2::97] = 0.0
    w[2::97, :3] = 1e4
    return r8, w, b0


def _cdf(w):
    """ray_level's CDF of each row: index-order sums, clipped at 1."""
    wf = w + 0.01
    total = torch.zeros_like(wf[:, 0])
    for i in range(wf.shape[1]):
        total = total + wf[:, i]
    acc, cols = torch.zeros_like(total), [torch.zeros_like(total)]
    for i in range(wf.shape[1]):
        acc = acc + wf[:, i] / total
        cols.append(torch.clamp(acc, max=1.0))
    return torch.stack(cols, 1)


# (N, T0, T, uniform_prev): the launches of the asset's 512^2 RGB frames
# at (32, 16) and (128, 64, 32) (the thread-per-ray kernel), of the 32^2
# feature render (warp per ray), and N that are not a multiple of a
# block's rays on both sides of THREAD_RAYS_FROM (16,384)
RAY_LEVEL_SHAPES = [
    (262144, 32, 16, True), (262144, 128, 64, True), (262144, 64, 32, False),
    (1024, 32, 16, True), (1024, 128, 64, True), (1024, 64, 32, False),
    (1000, 128, 64, False), (33, 32, 16, True), (16385, 64, 32, False),
    (20001, 128, 64, True), (16383, 32, 16, False)]


@pytest.mark.parametrize("N,T0,T,uniform_prev", RAY_LEVEL_SHAPES)
def test_ray_level_served_shapes(dev, N, T0, T, uniform_prev):
    g = torch.Generator(device=dev).manual_seed(N + T0)
    r8, w, b0 = _prev_level(N, T0, g, dev)
    got = rk.ray_level(r8, w, b0, T, True, uniform_prev=uniform_prev)
    _close(got, rk.ray_level_plain(r8, w, b0, T, True, uniform_prev), 1e-5)


@pytest.mark.parametrize("N", [1000, 20000])
@pytest.mark.parametrize("jitter", ["renderer", "exact", "falling"])
@pytest.mark.parametrize("T0,T,uniform_prev", [(32, 16, False),
                                               (128, 64, True),
                                               (64, 32, False)])
def test_ray_level_jitter_and_packing(dev, N, jitter, T0, T, uniform_prev):
    """jitter as the renderer draws it ((u - 0.5) / (T + 1)), jitter that
    puts edges exactly on CDF values, and jitter of +-2 / K that makes
    edges fall (the walk restarts); with the packed rows of pick_pack_q."""
    K = T + 1
    g = torch.Generator(device=dev).manual_seed(T0 + T + N)
    r8, w, b0 = _prev_level(N, T0, g, dev)
    draw = torch.rand(N, K, generator=g, device=dev)
    u = rk._div(torch.arange(K, dtype=torch.float32, device=dev) + 0.5, K)
    if jitter == "renderer":
        jit = (draw - 0.5) / (T + 1)
    elif jitter == "exact":
        cdf = _cdf(w)
        near = cdf.gather(1, (cdf[:, None, :] - u[None, :, None]).abs()
                          .argmin(2))
        jit = near - u
        assert bool(((u + jit)[:, :, None] == cdf[:, None, :]).any())
    else:
        jit = (draw - 0.5) * 4 / K
        assert bool(((u + jit).diff(dim=1) < 0).any())
    q = rk.pick_pack_q(T, N)
    got = rk.ray_level(r8, w, b0, T, True, uniform_prev=uniform_prev,
                       jitter=jit, pack_q=q)
    _close(got, rk.ray_level_plain(r8, w, b0, T, True, uniform_prev, jit, q),
           1e-5)


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


# offset 1: a contiguous view one float into a larger buffer (not 16 B-
# aligned); N T not a multiple of 4; chip_smoke's shape, the (32, 16)
# frame's first level
@pytest.mark.parametrize("N,T,offset", [(301, 16, 0), (1000, 7, 0), (4, 1, 0),
                                        (301, 16, 1), (1001, 7, 1),
                                        (1001, 7, 0), (3, 1, 0),
                                        (262144, 32, 0), (262144, 32, 1)])
def test_flatten3_nt_kernel(dev, N, T, offset):
    g = torch.Generator(device=dev).manual_seed(N + offset)
    x3 = _offset_view(torch.randn(3, N, T, generator=g, device=dev), offset)
    assert (x3.data_ptr() % 16 == 0) == (offset == 0)
    before = rk.flatten3_nt.launches
    got = rk.flatten3_nt(x3)
    torch.cuda.synchronize()
    assert rk.flatten3_nt.launches == before + 1
    assert torch.equal(_bits(got), _bits(rk.flatten3_nt_plain(x3)))


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


@pytest.mark.parametrize("C,block_rows,M,first", [
    (2, 1, 1 << 16, 0), (8, 1, 1001, 0), (128, 1, 777, 0), (2, 8, 4099, 0),
    (3, 1, 999, 0), (3, 1, 1000, 1), (1, 8, 65, 0), (5, 1, 33, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_kernel(dev, C, block_rows, M, first, dtype):
    """Every vector width of the kernel (16 B down to 2 B pieces), the
    8-row blocks, ragged index counts, a table starting at an odd row
    (`first`: a less aligned base), and indices out of range at both
    ends (zeros), bit for bit against the plain version."""
    g = torch.Generator(device=dev).manual_seed(C * 10 + block_rows)
    R = 8 * 512
    base = torch.randn(R + 8, C, generator=g, device=dev).to(dtype)
    table = base[first:first + R]
    n = R // block_rows
    idx = torch.randint(-2, n + 2, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([-1, n], dtype=torch.int32)
    before = gather.gather_rows.launches
    got = gather.gather_rows(table, idx, block_rows)
    torch.cuda.synchronize()
    assert gather.gather_rows.launches == before + 1
    ref = gather.gather_rows_plain(table, idx, block_rows)
    assert got.shape == ref.shape == (M, block_rows * C)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))
    assert not got[:2].any()
    got2 = gather.gather_rows(table, idx.reshape(-1, 1), block_rows)
    assert torch.equal(got2.reshape(got.shape), got)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 128])
@pytest.mark.parametrize("M,off", [(1 << 21, 0), (100003, 0), (100003, 1),
                                   (4099, 2), (13, 3), (7, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_tails_and_offsets(dev, C, M, off, dtype):
    """Rows of 2-16 B (the vector path) and wider: index counts that are
    not a multiple of a unit's rows, index tensors `off` int32 into their
    storage (not 16 B aligned), out-of-range fills; bit for bit."""
    g = torch.Generator(device=dev).manual_seed(C + M + off)
    R = 1 << 15
    table = torch.randn(R, C, generator=g, device=dev).to(dtype)
    store = torch.randint(-3, R + 3, (M + off,), generator=g, device=dev,
                          dtype=torch.int32)
    idx = store[off:]
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4 * off
    got = gather.gather_rows(table, idx)
    ref = gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    w = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(w), ref.view(w))
    assert not got[(idx < 0) | (idx >= R)].any()


def test_gather_rows_refuses_on_the_card(dev):
    t = torch.zeros(64, 2, device=dev)
    with pytest.raises(ValueError):
        gather.gather_rows(t, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        gather.gather_rows(t, torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_encode_kernel_matches_plain_gather(dev, dtype, monkeypatch):
    """The encode is one hash_grid_forward launch and no gather_rows
    launch, bit for bit the level route on the plain gather."""
    spec = hashgrid.build_spec(HashGridConfig(
        num_levels=6, level_dim=4, base_resolution=8, log2_hashmap_size=12,
        desired_resolution=256))
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(spec.total_params, 4, generator=g, device=dev
                        ).to(dtype)
    x = torch.rand(5000, 3, generator=g, device=dev) * 4.4 - 2.2
    before = (hashgrid.hash_grid_forward.launches,
              gather.gather_rows.launches)
    got = hashgrid.hash_encode(x, table, spec, bound=2.0)
    torch.cuda.synchronize()
    assert (hashgrid.hash_grid_forward.launches,
            gather.gather_rows.launches) == (before[0] + 1, before[1])
    monkeypatch.setattr(hashgrid, "gather_rows", gather.gather_rows_plain)
    monkeypatch.setattr(hashgrid, "forward_takes", lambda spec, n: False)
    ref = hashgrid.hash_encode(x, table, spec, bound=2.0)
    assert torch.equal(got, ref)


# -- the field kernels at the serving asset's full widths --------------------
# bf16 weights: chip_smoke.py's bound, |d| <= MLP_TOL + MLP_TOL |ref| on all
# but FLIP_SHARE of the outputs and those within MLP_TOL * max|ref| (the
# kernel and the plain version round the hidden activations to bf16 after
# float32 sums taken in different orders); float32 weights element by
# element at 3e-4 (run_tmlp) and 1e-3 (the composite).
MLP_TOL, FLIP_SHARE = 0.05, 1e-5
#: bf16 grid branches: chip_smoke.py's GRID_TOL, element by element (MLP_TOL
#: passes a deep net whose grid reads are left out); the encode probes:
#: one bf16 step of a feature (PROBE_TOL)
GRID_TOL, PROBE_TOL = 5e-3, 1e-2
#: float32 weights also at chip_smoke.py's F32_FAITHFUL: |d| <= 1e-5 + 1e-5
#: |ref| (the float32 bounds above would pass a one-pass TF32 chain)
F32_FAITHFUL = 1e-5


def _faithful(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        d = (g - r).abs()
        assert bool((d <= F32_FAITHFUL * (1.0 + r.abs())).all()), float(
            (d / (1.0 + r.abs())).max())


def _held(got, ref, dtype, tol32, tol16=None):
    """float32 weights at tol32 and at F32_FAITHFUL element by element;
    bf16 at tol16 element by element when given, else at MLP_TOL with
    FLIP_SHARE."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert bool(torch.isfinite(g).all())
        if dtype == torch.float32 or tol16 is not None:
            tol = tol32 if dtype == torch.float32 else tol16
            torch.testing.assert_close(g, r, rtol=tol, atol=tol)
            if dtype == torch.float32:
                _faithful(g, r)
            continue
        d = (g - r).abs()
        n_over = int((d > MLP_TOL + MLP_TOL * r.abs()).sum())
        assert n_over <= -(-FLIP_SHARE * r.numel() // 1), (n_over, r.numel())
        assert float(d.max()) <= MLP_TOL * max(1.0, float(r.abs().max()))


def _asset_field(g, dev, dtype):
    """127 -> 128, 255 -> 128 (skip), 128 -> 16; CP 64 @ 128, sigma-CP
    32 @ 128; Fourier 10 frequencies, bound 4 (assets/serving_student)."""
    layers = _layers([(127, 128), (255, 128), (128, 16)], g, dev)
    cp = torch.rand(3, 128, 64, generator=g, device=dev) * 0.5 + 0.5
    scp = torch.randn(3, 128, 32, generator=g, device=dev) * 0.5
    return fm.TransposedFieldMLP(
        [{"w": p["w"].to(dtype)} for p in layers], 10, 4.0, (1,), leaky=True,
        cp_lines=cp.to(dtype), sigma_cp_lines=scp.to(dtype))


def _asset_view(g, dev, dtype):
    """31 -> 32 -> 32 -> 3 on [geo 15, SH degree 4]."""
    return fm.ViewMLP([{"w": p["w"].to(dtype)} for p in
                       _layers([(31, 32), (32, 32), (32, 3)], g, dev)], 16, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("net", ["prop", "field"])
def test_run_tmlp_asset_widths(dev, net, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    tm = (fm.TransposedFieldMLP(
        [{"w": p["w"].to(dtype)} for p in _layers([(33, 32), (32, 1)], g,
                                                   dev)], 5, 4.0)
          if net == "prop" else _asset_field(g, dev, dtype))
    x = torch.rand(3, 1001, generator=g, device=dev) * 8 - 4
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), dtype, 3e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,pack_q", [(16, 1), (32, 1), (4, 1), (16, 8),
                                      (4, 8), (80, 1), (112, 1), (1, 1),
                                      (3, 1), (12, 1), (24, 1), (40, 1),
                                      (100, 1), (127, 1), (24, 4)])
def test_run_tmlp_composite_asset_widths(dev, T, pack_q, dtype):
    """T = 80 and 112 step lcm(64, T) = 320 and 448 points: their buffers
    leave room for fewer warpgroups beside the weights. T that neither
    divides 16 nor is a multiple of it step whole rays, the last tile
    padded where no whole number of rays fills whole tiles (12, 24 and 40
    fill 192, 192 and 320 points; 3 rays of 100 take 320, one of 127 128);
    67 rays leave a ragged last step; the packed epilogue at T = 24, q = 4
    (the ray kernels' pick)."""
    g = torch.Generator(device=dev).manual_seed(12 + T + pack_q)
    tm, view = _asset_field(g, dev, dtype), _asset_view(g, dev, dtype)
    n = 67 if pack_q == 1 else 72
    x = torch.rand(3, n * T, generator=g, device=dev) * 8 - 4
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    r8 = _rays8(n, g, dev)
    if pack_q > 1:
        dl, ts = (v.reshape(n // pack_q, pack_q * T, 1) for v in (dl, ts))
    kw = {"view": view, "rays8": r8, "pack_q": pack_q, "T": T}
    before = fm.run_tmlp_composite.launches
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=True, **kw)
    assert fm.run_tmlp_composite.launches == before + 1
    _held(got, fm.run_tmlp_composite_plain(x, dl, ts, tm, True, **kw), dtype,
          1e-3)


@pytest.mark.parametrize("T", [1, 2, 8, 48, 64, 128])
def test_run_tmlp_composite_every_T(dev, T):
    """Rays of T samples in 64-point tiles: T dividing 64, T = 48 (three
    tiles hold four rays) and T = 128 (two tiles a ray); float32 weights."""
    g = torch.Generator(device=dev).manual_seed(40 + T)
    tm = _field(g, dev)
    n = 37
    x = torch.rand(3, n * T, generator=g, device=dev) * 4 - 2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=False)
    _close(got, fm.run_tmlp_composite_plain(x, dl, ts, tm, False), 1e-3)


def test_field_kernels_stream_deep_nets(dev):
    """bf16 weights too large for shared memory (seven 128-wide layers
    and a skip, ~260 KB): the block stages one layer at a time."""
    g = torch.Generator(device=dev).manual_seed(13)
    F, K, Ks = 27, 8, 4
    sizes = [(F + K, 128)] + [(128, 128)] * 2 + [(128 + F + K, 128)] \
        + [(128, 128)] * 3 + [(128, 16)]
    layers = [{"w": p["w"].bfloat16()} for p in _layers(sizes, g, dev)]
    cp = (torch.rand(3, 16, K, generator=g, device=dev) + 0.5).bfloat16()
    scp = torch.randn(3, 16, Ks, generator=g, device=dev).bfloat16()
    tm = fm.TransposedFieldMLP(layers, 4, 2.0, (3,), leaky=True, cp_lines=cp,
                               sigma_cp_lines=scp)
    # with the warpgroups' tile buffers, past fm.SMEM_LIMIT
    assert tm.packed(dev)[0].numel() * 2 > 200_000
    x = torch.rand(3, 999, generator=g, device=dev) * 4 - 2
    _held(fm.run_tmlp(x, tm, transposed=True), fm.run_tmlp_plain(x, tm),
          torch.bfloat16, None)
    n, T = 61, 16
    x = torch.rand(3, n * T, generator=g, device=dev) * 4 - 2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    _held(fm.run_tmlp_composite(x, dl, ts, tm),
          fm.run_tmlp_composite_plain(x, dl, ts, tm), torch.bfloat16, None)


# -- the factorized-grid branches: CP ladders, VM levels, sigma-VM ------------
# name -> CP levels [(R, K)], VM levels [(R, Rl, K)], sigma-CP (R, K),
# sigma-VM (R, Rl, K), depth: the served widths of grid_student and of the
# ladders (port_tools/grid_params.py), VM levels of K = 8 (one bf16 vector),
# lines at another resolution than their planes (Rl != R), and K = 3 / 6
# (the scalar reads)
GRID_NETS = {
    "grid_student": ([(256, 96)], [(64, 64, 16)], (256, 32), None, 3),
    "cp_ladder": ([(128, 48), (256, 48)], [], None, None, 8),
    "vm_ladder": ([(128, 48)], [(32, 32, 8), (64, 64, 8)], None, None, 8),
    "vm_rl": ([], [(16, 24, 8)], None, None, 3),
    "sigma_vm": ([(64, 8)], [(32, 32, 16)], (24, 6), (16, 12, 3), 4),
}


def _grid_net(name, g, dev, dtype, L=10, width=128):
    cps, vms, scp, svm, depth = GRID_NETS[name]
    tab = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    kc = sum(K for _, K in cps) + sum(3 * K for _, _, K in vms)
    F = 3 * (1 + 2 * L)
    sizes = ([(F + kc, width)]
             + [(width + (F + kc if l == depth // 2 else 0), width)
                for l in range(1, depth - 1)] + [(width, 16)])
    layers = [{"w": p["w"].to(dtype)} for p in _layers(sizes, g, dev)]
    vm = [(tab(3, R, R, K), tab(3, Rl, K)) for R, Rl, K in vms]
    kw = {"cp_lines": [tab(3, R, K) for R, K in cps] or None,
          "vm_planes": [p for p, _ in vm] or None,
          "vm_lines": [l for _, l in vm] or None}
    if scp is not None:
        kw["sigma_cp_lines"] = tab(3, *scp)
    if svm is not None:
        R, Rl, K = svm
        kw["sigma_vm_planes"], kw["sigma_vm_lines"] = (tab(3, R, R, K),
                                                       tab(3, Rl, K))
    return fm.TransposedFieldMLP(layers, L, 2.0, (depth // 2,), leaky=True,
                                 **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(GRID_NETS))
def test_run_tmlp_grid_branches(dev, name, dtype):
    g = torch.Generator(device=dev).manual_seed(21)
    tm = _grid_net(name, g, dev, dtype)
    x = torch.rand(3, 1001, generator=g, device=dev) * 4.4 - 2.2
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), dtype, 3e-4, GRID_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(GRID_NETS))
def test_grid_encode_probes(dev, name, dtype):
    """Every encoding column and the sigma sum, read back through one-layer
    probe nets (fused_mlp_t.encode_probes), element by element: the thread
    pair's split of each CP and VM level, each level's columns in place."""
    g = torch.Generator(device=dev).manual_seed(23)
    tm = _grid_net(name, g, dev, dtype)
    x = torch.rand(3, 4099, generator=g, device=dev) * 4.4 - 2.2
    for p in fm.encode_probes(tm):
        _held(fm.run_tmlp(x, p, transposed=True), fm.run_tmlp_plain(x, p),
              dtype, 3e-4, PROBE_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("name", sorted(GRID_NETS))
def test_run_tmlp_composite_grid_branches(dev, name, T, dtype):
    g = torch.Generator(device=dev).manual_seed(22 + T)
    tm = _grid_net(name, g, dev, dtype)
    view = _asset_view(g, dev, dtype)
    n = 67
    x = torch.rand(3, n * T, generator=g, device=dev) * 4.4 - 2.2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    r8 = _rays8(n, g, dev)
    before = fm.run_tmlp_composite.launches
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=True, view=view,
                                rays8=r8)
    assert fm.run_tmlp_composite.launches == before + 1
    _held(got, fm.run_tmlp_composite_plain(x, dl, ts, tm, True, view, r8),
          dtype, 1e-3, GRID_TOL)


# gather_rows_backward against index_add_ on the same views: the atomics sum
# in another order than index_add_, so a float32 sum of n terms moves by
# ~2^-24 sqrt(n) S: held at |d| <= 1e-5 S + 1e-5 |ref| (_scatter_held, as
# chip_smoke.py holds the same kernel), S the sum of the magnitudes of the
# adds into an element (an element no add reaches must keep its value).
# Ragged index counts, rows of 1-8 floats (float4 / float2 / scalar
# pieces), an unaligned gradient view, out-of-range indices (they add
# nothing).
@pytest.mark.parametrize("R,C,M,offset", [(2 ** 19, 2, 2 ** 20 + 7, 0),
                                          (4096, 2, 8 * 997, 1),
                                          (1000, 4, 12345, 0),
                                          (1000, 4, 12345, 2),
                                          (77, 3, 999, 0), (513, 1, 5001, 0),
                                          (300, 8, 2049, 0), (5, 2, 1, 0)])
def test_gather_rows_backward_kernel(dev, R, C, M, offset):
    g = torch.Generator(device=dev).manual_seed(R + C + M + offset)
    idx = torch.randint(-3, R + 3, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    go = torch.randn(M, C, generator=g, device=dev)
    base = torch.randn(R * C + offset, generator=g, device=dev)
    got = base.clone()[offset:].view(R, C)
    ref = base.clone()[offset:].view(R, C)
    before = gather.gather_rows_backward.launches
    out = gather.gather_rows_backward(got, idx, go)
    assert out is got and gather.gather_rows_backward.launches == before + 1
    gather.gather_rows_backward_plain(ref, idx, go)
    torch.cuda.synchronize()
    assert _scatter_held(got, ref, _magnitudes(R, C, idx, go))


def _scatter_held(got, ref, mag):
    """chip_smoke.py's hold of the scatter-add with its floor scaled to the
    terms: |d| <= 1e-5 S + 1e-5 |ref| at every element, S the sum of the
    magnitudes of the adds into it."""
    return bool(((got - ref).abs() <= 1e-5 * mag + 1e-5 * ref.abs()).all())


def _magnitudes(R, C, idx, go):
    return gather.gather_rows_backward_plain(
        torch.zeros(R, C, device=go.device), idx, go.abs())


# Gradients of a training step's size (a mean over thousands of rays: 1e-9
# to 1e-8), where the absolute floor of 1e-6 would pass a table with no
# adds at all: held at the floor scaled by the adds' magnitudes, and a
# launch with every other index dropped must fail that hold.
@pytest.mark.parametrize("R,C,M,scale", [(2 ** 19, 2, 2 ** 20 + 7, 1e-8),
                                         (4096, 2, 8 * 997 * 64, 1e-9),
                                         (1000, 4, 12345, 1e-8)])
def test_gather_rows_backward_small_gradients(dev, R, C, M, scale):
    g = torch.Generator(device=dev).manual_seed(R + C + M)
    idx = torch.randint(0, R, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    go = torch.randn(M, C, generator=g, device=dev) * scale
    ref = gather.gather_rows_backward_plain(torch.zeros(R, C, device=dev),
                                            idx, go)
    mag = _magnitudes(R, C, idx, go)
    got = gather.gather_rows_backward(torch.zeros(R, C, device=dev), idx, go)
    assert _scatter_held(got, ref, mag)
    assert float(ref.abs().max()) < 1e-6  # all under the absolute floor
    half = idx.clone()
    half[1::2] = -1
    bad = gather.gather_rows_backward(torch.zeros(R, C, device=dev), half, go)
    assert not _scatter_held(bad, ref, mag)


def test_gather_rows_backward_counts_on_itself(dev, monkeypatch):
    """A recorder patched in under the module's name neither moves the
    kernel's count nor breaks it."""
    real, seen = gather.gather_rows_backward, []

    def recording(gt, idx, go):
        seen.append(idx)
        return real(gt, idx, go)

    monkeypatch.setattr(gather, "gather_rows_backward", recording)
    idx = torch.arange(8, device=dev, dtype=torch.int32)
    before = real.launches
    gather.gather_rows_backward(torch.zeros(8, 2, device=dev), idx,
                                torch.ones(8, 2, device=dev))
    assert len(seen) == 1 and real.launches == before + 1
    assert not hasattr(recording, "launches")


def test_hash_encode_table_grad_kernel_matches_plain(dev, monkeypatch):
    """The encoder's table gradient in training (the points need no
    gradient): one hash_grid_backward launch and no gather_rows_backward
    launch, against the plain gather and hash_grid_backward_plain at
    |d| <= 1e-5 S + 1e-5 |ref| (_scatter_held), S the sum of the
    magnitudes of the adds into an element."""
    spec = hashgrid.build_spec(HashGridConfig(num_levels=6, level_dim=2,
                                              log2_hashmap_size=14,
                                              desired_resolution=256))
    g = torch.Generator(device=dev).manual_seed(9)
    table = torch.rand(spec.total_params, 2, generator=g, device=dev) - 0.5
    x = torch.rand(40_000, 3, generator=g, device=dev)
    r = torch.randn(40_000, spec.output_dim, generator=g, device=dev)

    def grad():
        t = table.clone().requires_grad_(True)
        (hashgrid.hash_encode_01(x, t, spec) * r).sum().backward()
        return t.grad

    before = (hashgrid.hash_grid_backward.launches,
              gather.gather_rows_backward.launches)
    got = grad()
    assert (hashgrid.hash_grid_backward.launches,
            gather.gather_rows_backward.launches) == (before[0] + 1,
                                                      before[1])
    monkeypatch.setattr(hashgrid, "gather_rows", gather.gather_rows_plain)
    monkeypatch.setattr(hashgrid, "hash_grid_backward",
                        hashgrid.hash_grid_backward_plain)
    ref = grad()
    monkeypatch.setattr(hashgrid, "hash_grid_backward",
                        lambda x01, go, sp, n: hashgrid.hash_grid_backward_plain(
                            x01, go.abs(), sp, n))
    mag = grad()
    torch.cuda.synchronize()
    assert _scatter_held(got, ref, mag)


def test_hash_encode_point_grad_keeps_the_level_route(dev):
    """Points that need a gradient keep the route of one gather_rows_backward
    launch a level; its table gradient is the fused kernel's."""
    spec = hashgrid.build_spec(HashGridConfig(num_levels=6, level_dim=2,
                                              log2_hashmap_size=14,
                                              desired_resolution=256))
    g = torch.Generator(device=dev).manual_seed(10)
    table = torch.rand(spec.total_params, 2, generator=g, device=dev) - 0.5
    x = torch.rand(20_000, 3, generator=g, device=dev)
    r = torch.randn(20_000, spec.output_dim, generator=g, device=dev)
    t = table.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    before = (hashgrid.hash_grid_backward.launches,
              gather.gather_rows_backward.launches)
    (hashgrid.hash_encode_01(xg, t, spec) * r).sum().backward()
    assert (hashgrid.hash_grid_backward.launches,
            gather.gather_rows_backward.launches) == (before[0],
                                                      before[1] + 6)
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    fused = hashgrid.hash_grid_backward(x, r, spec)
    mag = hashgrid.hash_grid_backward_plain(x, r.abs(), spec)
    torch.cuda.synchronize()
    assert _scatter_held(t.grad, fused, 2 * mag)


def _ray_points(n_rays, T, D, g, dev):
    """Points along n_rays rays of T samples, consecutive samples of a ray
    next to each other (the training step's layout), some outside the
    unit cube."""
    o = torch.rand(n_rays, 1, D, generator=g, device=dev) * 0.6 + 0.2
    d = torch.randn(n_rays, 1, D, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(-0.45, 0.45, T, device=dev)[None, :, None]
    return (o + d * t).reshape(-1, D).contiguous()


# hash_grid_backward against hash_grid_backward_plain over the encoder's
# options, ragged point counts (rays of 37 samples): C = 1 and 2 with their
# corner pairs added as one piece at hashed and dense levels, C = 3, 4 and
# 8 a row at a time: |d| <= 1e-5 S + 1e-5 |ref| (_scatter_held).
HASH_BACKWARD_SPECS = {
    "hash_c2": dict(num_levels=8, level_dim=2, log2_hashmap_size=15,
                    desired_resolution=512),
    "hash_c2_smooth_max5": dict(num_levels=8, level_dim=2,
                                log2_hashmap_size=15, desired_resolution=512,
                                interpolation="smoothstep"),
    "tiled_c4_align": dict(num_levels=6, level_dim=4, log2_hashmap_size=14,
                           desired_resolution=128, gridtype="tiled",
                           align_corners=True),
    "hash_c8": dict(num_levels=6, level_dim=8, log2_hashmap_size=12,
                    desired_resolution=256),
    "hash_c1_d2": dict(input_dim=2, num_levels=8, level_dim=1,
                       log2_hashmap_size=12, desired_resolution=1024),
    "hash_c3_d2_smooth": dict(input_dim=2, num_levels=5, level_dim=3,
                              log2_hashmap_size=10, desired_resolution=256,
                              interpolation="smoothstep", align_corners=True),
}


@pytest.mark.parametrize("name", sorted(HASH_BACKWARD_SPECS))
@pytest.mark.parametrize("n_rays", [1, 3001])
def test_hash_grid_backward_kernel(dev, name, n_rays):
    spec = hashgrid.build_spec(HashGridConfig(**HASH_BACKWARD_SPECS[name]))
    g = torch.Generator(device=dev).manual_seed(n_rays + len(name))
    x = _ray_points(n_rays, 37, spec.input_dim, g, dev)
    go = torch.randn(x.shape[0], spec.output_dim, generator=g, device=dev)
    n = 5 if name.endswith("max5") else None
    before = hashgrid.hash_grid_backward.launches
    got = hashgrid.hash_grid_backward(x, go, spec, n)
    assert hashgrid.hash_grid_backward.launches == before + 1
    ref = hashgrid.hash_grid_backward_plain(x, go, spec, n)
    mag = hashgrid.hash_grid_backward_plain(x, go.abs(), spec, n)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and bool((mag > 0).any())
    assert _scatter_held(got, ref, mag)
    if n_rays == 1:
        return
    # a planted fault: every other point's gradient at one level dropped
    C = spec.level_dim
    for level in (0, (n or spec.num_levels) - 1):
        bad = go.clone()
        bad[::2, level * C:(level + 1) * C] = 0
        assert not _scatter_held(hashgrid.hash_grid_backward(x, bad, spec, n),
                                 ref, mag)


def test_hash_grid_backward_refuses(dev):
    spec = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=2,
                                              log2_hashmap_size=10))
    x = torch.rand(100, 3, device=dev)
    go = torch.randn(100, spec.output_dim, device=dev)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_backward(x, go.bfloat16(), spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_backward(x[:, :2].contiguous(), go, spec)
    wide = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=16,
                                              log2_hashmap_size=10))
    with pytest.raises(NotImplementedError, match="queue B"):
        hashgrid.hash_grid_backward(
            x, torch.randn(100, wide.output_dim, device=dev), wide)


def test_hash_grid_backward_counts_on_itself(dev, monkeypatch):
    """A recorder patched in under the module's name neither moves the
    kernel's count nor breaks it."""
    real, seen = hashgrid.hash_grid_backward, []

    def recording(x01, go, spec, n=None):
        seen.append(x01)
        return real(x01, go, spec, n)

    monkeypatch.setattr(hashgrid, "hash_grid_backward", recording)
    spec = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=2,
                                              log2_hashmap_size=10))
    before = real.launches
    hashgrid.hash_grid_backward(torch.rand(64, 3, device=dev),
                                torch.ones(64, spec.output_dim, device=dev),
                                spec)
    assert len(seen) == 1 and real.launches == before + 1
    assert not hasattr(recording, "launches")


# hash_grid_forward against hash_grid_forward_plain over the encoder's
# options, point counts that leave a ragged last tile (rays of 37 samples),
# float32 and bf16 tables, in both of the kernel's orders where the table's
# bytes pick them: bit for bit (the same products and sums in the same
# order)
HASH_FORWARD_SPECS = {
    **HASH_BACKWARD_SPECS,
    "hash_c8_d3_smooth_align": dict(num_levels=16, level_dim=8,
                                    log2_hashmap_size=12,
                                    desired_resolution=512,
                                    interpolation="smoothstep",
                                    align_corners=True),
    "tiled_c6_d2": dict(input_dim=2, num_levels=7, level_dim=6,
                        log2_hashmap_size=11, desired_resolution=300,
                        gridtype="tiled"),
    "hash_c5_d3_max3": dict(num_levels=9, level_dim=5, log2_hashmap_size=11,
                            desired_resolution=256),
    "hash_c7_d2": dict(input_dim=2, num_levels=6, level_dim=7,
                       log2_hashmap_size=10, desired_resolution=128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HASH_FORWARD_SPECS))
@pytest.mark.parametrize("n_rays", [1, 3001])
def test_hash_grid_forward_kernel(dev, name, n_rays, dtype, monkeypatch):
    spec = hashgrid.build_spec(HashGridConfig(**HASH_FORWARD_SPECS[name]))
    g = torch.Generator(device=dev).manual_seed(n_rays + len(name))
    x = _ray_points(n_rays, 37, spec.input_dim, g, dev)
    table = (torch.rand(spec.total_params, spec.level_dim, generator=g,
                        device=dev) * 2 - 1).to(dtype)
    n = 5 if name.endswith("max5") else (3 if name.endswith("max3")
                                         else None)
    before = hashgrid.hash_grid_forward.launches
    got = hashgrid.hash_grid_forward(x, table, spec, n)
    assert hashgrid.hash_grid_forward.launches == before + 1
    monkeypatch.setattr(hashgrid, "gather_rows", gather.gather_rows_plain)
    ref = hashgrid.hash_grid_forward_plain(x, table, spec, n)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (x.shape[0], spec.output_dim)
    assert torch.equal(got, ref)
    assert bool(got.abs().sum() > 0)


def test_hash_grid_forward_at_full_width(dev, monkeypatch):
    """The grids of ModelConfig(field_type="hashgrid", with_sam=True) at
    their full tables (the field's 2^19-row levels; the SAM grid at C = 8),
    bf16 and float32, on 2^18 points: bit for bit."""
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields

    model = fields.make_model(ModelConfig(field_type="hashgrid",
                                          with_sam=True), RenderConfig())
    g = torch.Generator(device=dev).manual_seed(11)
    x = _ray_points(1 << 12, 64, 3, g, dev)
    monkeypatch.setattr(hashgrid, "gather_rows", gather.gather_rows_plain)
    for spec in (model.grid_spec, model.s_grid_spec, *model.prop_specs):
        table = torch.rand(spec.total_params, spec.level_dim, generator=g,
                           device=dev) * 4 - 2
        for t in (table, table.bfloat16()):
            got = hashgrid.hash_grid_forward(x, t, spec)
            ref = hashgrid.hash_grid_forward_plain(x, t, spec)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (spec.level_dim, t.dtype)


def test_hash_grid_forward_refuses(dev):
    spec = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=2,
                                              log2_hashmap_size=10))
    x = torch.rand(100, 3, device=dev)
    table = torch.rand(spec.total_params, 2, device=dev)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x, table.half(), spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x[:, :2].contiguous(), table, spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x.cpu(), table, spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_forward(x, table[:-8], spec)
    wide = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=16,
                                              log2_hashmap_size=10))
    with pytest.raises(NotImplementedError, match="queue B"):
        hashgrid.hash_grid_forward(
            x, torch.rand(wide.total_params, 16, device=dev), wide)


def test_hash_grid_forward_counts_on_itself(dev, monkeypatch):
    """A recorder patched in under the module's name neither moves the
    kernel's count nor breaks it."""
    real, seen = hashgrid.hash_grid_forward, []

    def recording(x01, table, spec, n=None):
        seen.append(x01)
        return real(x01, table, spec, n)

    monkeypatch.setattr(hashgrid, "hash_grid_forward", recording)
    spec = hashgrid.build_spec(HashGridConfig(num_levels=4, level_dim=2,
                                              log2_hashmap_size=10))
    before = real.launches
    hashgrid.hash_encode_01(torch.rand(64, 3, device=dev),
                            torch.ones(spec.total_params, 2, device=dev),
                            spec)
    torch.cuda.synchronize()
    assert len(seen) == 1 and real.launches == before + 1
    assert hashgrid._HASH_GRID_FORWARD is real


@pytest.mark.parametrize("T", [32, 64])
def test_run_tmlp_composite_default_field_f32(dev, T):
    """The default ModelConfig's field at its full width in float32, as the
    trainer's evaluation renders it: 63 -> 128 x 8 with the skip at 4
    (191 in), -> 16, the weights streamed one layer at a time; and a w64 d4
    proposal net, its weights all in shared memory. Both at the JAX
    suite's float32 bounds and at F32_FAITHFUL."""
    g = torch.Generator(device=dev).manual_seed(60 + T)
    sizes = ([(63, 128)] + [(128, 128)] * 3 + [(191, 128)] + [(128, 128)] * 2
             + [(128, 16)])
    tm = fm.TransposedFieldMLP(_layers(sizes, g, dev), 10, 2.0, (4,),
                               leaky=True)
    view = fm.ViewMLP(_layers([(31, 32), (32, 32), (32, 3)], g, dev), 16, 4)
    n = 1003
    x = torch.rand(3, n * T, generator=g, device=dev) * 4 - 2
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    ts = torch.cumsum(dl, 1) + 0.5
    r8 = _rays8(n, g, dev)
    before = fm.run_tmlp_composite.launches
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=True, view=view,
                                rays8=r8)
    assert fm.run_tmlp_composite.launches == before + 1
    ref = fm.run_tmlp_composite_plain(x, dl, ts, tm, True, view, r8)
    _close(got, ref, 1e-3)
    _faithful(got, ref)
    p = fm.TransposedFieldMLP(_layers([(33, 64)] + [(64, 64)] * 2
                                      + [(64, 1)], g, dev), 5, 2.0)
    got, ref = fm.run_tmlp(x, p, transposed=True), fm.run_tmlp_plain(x, p)
    _close(got, ref, 3e-4)
    _faithful(got, ref)


# -- the branches beyond the served asset: ragged T, layers up to 256 wide,
# biases, the dense-sin encode; each at _held's bounds, and a planted fault
# of each kind must fail that hold ------------------------------------------


def _fails_hold(*args):
    try:
        _held(*args)
    except AssertionError:
        return True
    return False


def _rays_of(n, T, g, dev):
    x = torch.rand(3, n * T, generator=g, device=dev) * 8 - 4
    dl = torch.rand(n, T, generator=g, device=dev) * 0.1
    return x, dl, torch.cumsum(dl, 1) + 0.5, _rays8(n, g, dev)


def _composite_held(tm, view, n, T, g, dev, dtype, pack_q=1):
    x, dl, ts, r8 = _rays_of(n, T, g, dev)
    if pack_q > 1:
        dl, ts = (v.reshape(n // pack_q, pack_q * T, 1) for v in (dl, ts))
    kw = {"view": view, "rays8": r8, "pack_q": pack_q, "T": T}
    before = fm.run_tmlp_composite.launches
    got = fm.run_tmlp_composite(x, dl, ts, tm, opaque=True, **kw)
    assert fm.run_tmlp_composite.launches == before + 1
    ref = fm.run_tmlp_composite_plain(x, dl, ts, tm, True, **kw)
    _held(got, ref, dtype, 1e-3)
    return got, ref


def test_composite_T24_unwritten_ray_fails(dev):
    """Planted fault: the last whole ray of every T = 24 step (8 rays of 24
    points) left unwritten (zero) must fail the hold that the kernel's own
    outputs pass."""
    g = torch.Generator(device=dev).manual_seed(78)
    dtype = torch.float32
    got, ref = _composite_held(_asset_field(g, dev, dtype),
                               _asset_view(g, dev, dtype), 1003, 24, g, dev,
                               dtype)
    bad = tuple(v.clone() for v in got)
    for v in bad:
        v[7::8] = 0.0
    assert _fails_hold(bad, ref, dtype, 1e-3)


def _wide_field(g, dev, dtype, width, depth=8, bias=False):
    """The default field's shape at `width`: 63 -> width x depth - 1 (the
    skip at depth / 2) -> 16, leaky; a CP table of 32 columns beside the
    Fourier features, seeded biases of a visible size with `bias`."""
    F, K = 63, 32
    sizes = ([(F + K, width)]
             + [(width + (F + K if l == depth // 2 else 0), width)
                for l in range(1, depth - 1)] + [(width, 16)])
    layers = _layers(sizes, g, dev)
    for p in layers:
        p["w"] = p["w"].to(dtype)
        if bias:
            p["b"] = torch.randn(p["w"].shape[1], generator=g,
                                 device=dev) * 0.3
    cp = torch.rand(3, 128, K, generator=g, device=dev) * 0.5 + 0.5
    return fm.TransposedFieldMLP(layers, 10, 4.0, (depth // 2,), leaky=True,
                                 cp_lines=cp.to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [144, 192, 256])
def test_field_kernels_wide_layers(dev, width, dtype):
    """Layers over 128 wide (two accumulator chunks: 128 + 16, 128 + 64,
    128 + 128), depth 8 with the skip: run_tmlp, and the composite at
    T = 32 and 24 with the view head."""
    g = torch.Generator(device=dev).manual_seed(80 + width)
    tm = _wide_field(g, dev, dtype, width)
    x = torch.rand(3, 20011, generator=g, device=dev) * 8 - 4
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), dtype, 3e-4)
    for T in (32, 24):
        _composite_held(tm, _asset_view(g, dev, dtype), 701, T, g, dev,
                        dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [128, 256])
def test_field_kernels_biased(dev, width, dtype):
    """Biased layers (float32 biases added before the activation, the
    last layer's before the sigma sum), at the asset's widths (a sigma-CP
    table too) and 256 wide; a planted fault, the biases left out of the
    kernel's net, must fail the hold."""
    g = torch.Generator(device=dev).manual_seed(90 + width)
    if width == 128:
        tm = _asset_field(g, dev, dtype)
        layers = [{"w": w, "b": torch.randn(w.shape[1], generator=g,
                                            device=dev) * 0.3}
                  for w in tm.ws]
        tm = fm.TransposedFieldMLP(layers, 10, 4.0, (1,), leaky=True,
                                   cp_lines=tm.cp, sigma_cp_lines=tm.scp)
    else:
        tm = _wide_field(g, dev, dtype, width, bias=True)
    bare = fm.TransposedFieldMLP(
        [{"w": w} for w in tm.ws], 10, 4.0, tm.skip, leaky=True,
        cp_lines=tm.cp, sigma_cp_lines=tm.scp)
    x = torch.rand(3, 20011, generator=g, device=dev) * 8 - 4
    ref = fm.run_tmlp_plain(x, tm)
    _held(fm.run_tmlp(x, tm, transposed=True), ref, dtype, 3e-4)
    assert _fails_hold(fm.run_tmlp(x, bare, transposed=True), ref, dtype,
                       3e-4)
    got, ref = _composite_held(tm, _asset_view(g, dev, dtype), 701, 24, g,
                               dev, dtype)
    xr, dl, ts, r8 = _rays_of(701, 24, g, dev)
    kw = {"view": _asset_view(g, dev, dtype), "rays8": r8}
    assert _fails_hold(fm.run_tmlp_composite(xr, dl, ts, bare, **kw),
                       fm.run_tmlp_composite_plain(xr, dl, ts, tm, **kw),
                       dtype, 1e-3)


def _dense(tm, angle_double=False):
    """tm's chain (no grid tables) with the given encode."""
    return fm.TransposedFieldMLP([{"w": w} for w in tm.ws], tm.enc_freqs,
                                 tm.bound, tm.skip, leaky=tm.leaky,
                                 angle_double=angle_double)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_field_kernels_dense_sin(dev, dtype):
    """The dense-sin encode at the asset's field widths (127 -> 128, 255 ->
    128, 128 -> 16 over Fourier features only, 10 frequencies): run_tmlp,
    the composite at T = 16 and 24, every encoding column through the
    probes. Planted fault: the kernel's encode by angle doubling, whose
    features drift from sin(z 2^f) by up to 1e-4 at 2^9, must fail the
    float32 probes' hold."""
    g = torch.Generator(device=dev).manual_seed(95)
    layers = _layers([(63, 128), (191, 128), (128, 16)], g, dev)
    tm = fm.TransposedFieldMLP([{"w": p["w"].to(dtype)} for p in layers], 10,
                               2.0, (1,), leaky=True, angle_double=False)
    x = torch.rand(3, 20011, generator=g, device=dev) * 4.4 - 2.2
    _held(fm.run_tmlp(x, tm, transposed=True), fm.run_tmlp_plain(x, tm),
          dtype, 3e-4)
    for T in (16, 24):
        _composite_held(tm, _asset_view(g, dev, dtype), 701, T, g, dev,
                        dtype)
    ad = _dense(tm, angle_double=True)
    faults = 0
    for p, q in zip(fm.encode_probes(tm), fm.encode_probes(ad)):
        ref = fm.run_tmlp_plain(x, p)
        _held(fm.run_tmlp(x, p, transposed=True), ref, dtype, 3e-4,
              PROBE_TOL)
        faults += _fails_hold(fm.run_tmlp(x, q, transposed=True), ref,
                              dtype, 3e-4, PROBE_TOL)
    if dtype == torch.float32:
        assert faults > 0


# -- the lifted limits: rays past 128 samples (L1), more than 8 layers (L2),
# layers past 256 wide (L3), view heads past 32 (L4), composites of more
# than 16 outputs (L5), ladders past 8 levels (L6), tables past 25 MB (L7);
# each at _held's bounds (the ray kernels at 1e-5, ray_level0 bit for bit)

LONG_T = (129, 200, 256, 512, 1024)


@pytest.mark.parametrize("jittered", [False, True])
@pytest.mark.parametrize("N", ["warp", "tile"])
@pytest.mark.parametrize("T", LONG_T)
def test_ray_level0_long_rays(dev, T, N, jittered):
    """L1: both of ray_level0's kernels past 128 samples a ray (the tile
    kernel's tile shrinks to 4 rays from T = 256 on), bit for bit."""
    N = 997 if N == "warp" else 1_200_003 // T
    g = torch.Generator(device=dev).manual_seed(T + N + jittered)
    r8 = _rays8(N, g, dev)
    jit = ((torch.rand(N, T + 1, generator=g, device=dev) - 0.5) / T
           if jittered else None)
    assert rk.ray_plan(T, jittered=jittered)["R"] == max(
        4, min(256, 1024 // T) & ~3)
    got = rk.ray_level0(r8, T, True, jitter=jit)
    ref = rk.ray_level0_plain(r8, T, True, jitter=jit)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


# (T0, T): longer and shorter than 128 on either side
LONG_LEVELS = [(128, 129), (129, 200), (200, 256), (256, 512), (512, 256),
               (1024, 1024), (64, 1024), (1024, 64)]


@pytest.mark.parametrize("uniform_prev", [False, True])
@pytest.mark.parametrize("N", [997, 20001])
@pytest.mark.parametrize("T0,T", LONG_LEVELS)
def test_ray_level_long_rays(dev, T0, T, N, uniform_prev):
    """L1: ray_level's warp kernel (997 rays) and thread kernel (20,001:
    fewer rays a block where 32 rays' rows do not fit) past 128 samples,
    with adversarial weight rows and the renderer's jitter."""
    g = torch.Generator(device=dev).manual_seed(T0 + T + N)
    r8, w, b0 = _prev_level(N, T0, g, dev)
    jit = None if uniform_prev else (
        torch.rand(N, T + 1, generator=g, device=dev) - 0.5) / (T + 1)
    before = rk.ray_level.launches
    got = rk.ray_level(r8, w, b0, T, True, uniform_prev=uniform_prev,
                       jitter=jit)
    assert rk.ray_level.launches == before + 1
    _close(got, rk.ray_level_plain(r8, w, b0, T, True, uniform_prev, jit),
           1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", LONG_T)
def test_run_tmlp_composite_long_rays(dev, T, dtype):
    """L1: the composite of rays longer than a step: one ray a step in
    segments of up to 256 points, its transmittance and sums carried from
    segment to segment; the asset's field and view head, 37 rays."""
    g = torch.Generator(device=dev).manual_seed(100 + T)
    plan = fm.kernel_plan(_asset_field(g, dev, dtype), T,
                          _asset_view(g, dev, dtype))
    assert plan.general and plan.R == 1 and plan.nseg * plan.M >= T
    _composite_held(_asset_field(g, dev, dtype), _asset_view(g, dev, dtype),
                    37, T, g, dev, dtype)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """-> a context in which the field kernels carry the planted faults of
    port_tools/field_branch_variants.py, drop_carry, lost_park, prop_lost_k,
    ring_lost_k, grid_lost_vm and f32_ring_lost_k (each fires on a path the
    others' tests do not take):
    csrc/fused_mlp_t.cu with their text substitutions
    (chip_smoke.planted_tree), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cs = _chip_smoke()
    tree = cs.planted_tree(tmp_path_factory.mktemp("planted"),
                           ("drop_carry", "lost_park", "prop_lost_k",
                            "ring_lost_k", "grid_lost_vm",
                            "f32_ring_lost_k"))
    return lambda: cs.kernels_from(tree)


def test_composite_long_rays_dropped_segment_fails(dev, planted):
    """Planted fault in the kernel: the general composite with the
    transmittance and the partial sums reset at every segment
    (field_branch_variants.py: drop_carry) must fail the hold that the
    kernel passes on the same rays of T = 512, two segments of 256."""
    dtype = torch.float32

    def held():
        g = torch.Generator(device=dev).manual_seed(109)
        tm, view = _asset_field(g, dev, dtype), _asset_view(g, dev, dtype)
        assert fm.kernel_plan(tm, 512, view).nseg == 2
        _composite_held(tm, view, 37, 512, g, dev, dtype)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()


def _deep_field(g, dev, dtype, depth, width=128):
    """L2: the default field at `depth` layers (skip at depth // 2)."""
    sizes = ([(63 + 32, width)]
             + [(width + (95 if l == depth // 2 else 0), width)
                for l in range(1, depth - 1)] + [(width, 16)])
    cp = torch.rand(3, 128, 32, generator=g, device=dev) * 0.5 + 0.5
    return fm.TransposedFieldMLP(
        [{"w": p["w"].to(dtype)} for p in _layers(sizes, g, dev)], 10, 4.0,
        (depth // 2,), leaky=True, cp_lines=cp.to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("depth", [12, 16, 32])
def test_field_kernels_deep_nets(dev, depth, dtype):
    """L2: 12, 16 and 32 layers (the layer table's size), run_tmlp and the
    composite at T = 32 and 200."""
    g = torch.Generator(device=dev).manual_seed(110 + depth)
    tm = _deep_field(g, dev, dtype, depth)
    x = torch.rand(3, 20011, generator=g, device=dev) * 8 - 4
    _held(fm.run_tmlp(x, tm, transposed=True), fm.run_tmlp_plain(x, tm),
          dtype, 3e-4)
    for T in (32, 200):
        _composite_held(tm, _asset_view(g, dev, dtype), 301, T, g, dev,
                        dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [272, 320, 384, 512])
def test_field_kernels_wider_layers(dev, width, dtype):
    """L3: layers of three and four 128-output chunks (272 = 128 + 128 +
    16), the middle chunks parked in device memory, bf16 weights streamed
    in units of 64 columns where a chunk does not fit; run_tmlp and the
    composite at T = 32 and 24."""
    g = torch.Generator(device=dev).manual_seed(120 + width)
    tm = _wide_field(g, dev, dtype, width)
    plan = fm.kernel_plan(tm)
    # the middle chunks (float32, on the V_WIDE32 ring: all but the last)
    assert plan.park_chunks == -(-width // 128) - (
        1 if dtype == torch.float32 else 2)
    x = torch.rand(3, 20011, generator=g, device=dev) * 8 - 4
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), dtype, 3e-4)
    for T in (32, 24):
        _composite_held(tm, _asset_view(g, dev, dtype), 301, T, g, dev,
                        dtype)


def test_wide_parked_chunk_lost_fails(dev, planted):
    """Planted fault in the kernel: a 512-wide float32 net's parked chunks
    (on the V_WIDE32 ring every chunk but the last) read back as zeros (field_branch_variants.py: lost_park, what a lost
    park slot gives) must fail the hold that the kernel passes on the same
    points."""
    dtype = torch.float32

    def held():
        g = torch.Generator(device=dev).manual_seed(129)
        tm = _wide_field(g, dev, dtype, 512)
        assert fm.kernel_plan(tm).park_chunks == 3  # all but the last
        x = torch.rand(3, 4001, generator=g, device=dev) * 8 - 4
        _held(fm.run_tmlp(x, tm, transposed=True), fm.run_tmlp_plain(x, tm),
              dtype, 3e-4)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()


# -- the bf16 V_WIDE kernels' weight ring -------------------------------------


def _seeded_wide(g, dev, width, depth=8):
    """_wide_field's shape in bf16 with weights U(+-1 / sqrt(fan_in)), as
    chip_smoke.py's seeded configurations draw them (port_tools/
    grid_params.py:make_flat), held like them at GRID_TOL."""
    tm = _wide_field(g, dev, torch.bfloat16, width, depth)
    ws = [((torch.rand(w.shape, generator=g, device=dev) * 2 - 1)
           / w.shape[0] ** 0.5).to(torch.bfloat16) for w in tm.ws]
    return fm.TransposedFieldMLP([{"w": w} for w in ws], tm.enc_freqs,
                                 tm.bound, tm.skip, leaky=True,
                                 cp_lines=tm.cp)


def _ring_held(tm, g, dev, P=20011):
    x = torch.rand(3, P, generator=g, device=dev) * 8 - 4
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), torch.bfloat16, None, GRID_TOL)


@pytest.mark.parametrize("width", [144, 160, 192, 224, 256, 320, 512])
def test_ring_kernels(dev, width):
    """The ring at every chunk count (144-256: two chunks; 320: three, one
    parked; 512: four) and every wgmma shape of a chunk (16, 64, 128 rows;
    160's last chunk of 32 rows on the 64-row shape, 224's of 96 on the
    128-row one): run_tmlp (20,011 points, a ragged last pass) and the
    composite at T = 16 and 32 with the view head, each launch on the ring
    (its plan) and held at GRID_TOL element by element."""
    g = torch.Generator(device=dev).manual_seed(140 + width)
    tm = _seeded_wide(g, dev, width)
    assert fm.kernel_plan(tm).w_mode == fm.W_RING
    _ring_held(tm, g, dev)
    view = _asset_view(g, dev, torch.bfloat16)
    for T in (16, 32):
        assert fm.kernel_plan(tm, T, view).w_mode == fm.W_RING
        x, dl, ts, r8 = _rays_of(701, T, g, dev)
        kw = {"view": view, "rays8": r8}
        before = fm.run_tmlp_composite.launches
        got = fm.run_tmlp_composite(x, dl, ts, tm, True, **kw)
        assert fm.run_tmlp_composite.launches == before + 1
        _held(got, fm.run_tmlp_composite_plain(x, dl, ts, tm, True, **kw),
              torch.bfloat16, None, GRID_TOL)


def test_ring_small_launches(dev):
    """Launches of 1, 64, 65 and 16,384 points (the feature render's, 256
    tiles spread over the SMs at fewer warpgroups a block) on the ring."""
    g = torch.Generator(device=dev).manual_seed(150)
    tm = _seeded_wide(g, dev, 256)
    for P in (1, 64, 65, 16384):
        _ring_held(tm, g, dev, P)


def test_ring_lost_unit_fails(dev, planted):
    """Planted fault in the ring: its producer leaves out the last k block
    of every unit but a chunk's first (field_branch_variants.py:
    ring_lost_k), so the products read what the stage held before: the
    hold that the kernel passes on the same points must fail."""

    def held():
        g = torch.Generator(device=dev).manual_seed(151)
        _ring_held(_seeded_wide(g, dev, 256), g, dev, 4001)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()


def test_ring_refused_plan_raises(dev):
    """A bf16 V_WIDE launch without the ring (the streamed chunks of the
    design before it) or with a ring past MAX_STAGES is refused by the C
    side and raises: nothing falls back to another chain or to the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(152)
    tm = _seeded_wide(g, dev, 256)
    x = torch.rand(3, 1000, generator=g, device=dev) * 8 - 4
    good = fm.kernel_plan(tm)
    for field, value in (("w_mode", fm.W_STREAM), ("stages", 9)):
        bad = fm.KernelPlan.from_buffer_copy(good)
        setattr(bad, field, value)
        tm._plans[(None, None)] = bad
        before = fm.run_tmlp.launches
        with pytest.raises(RuntimeError, match="refused its plan"):
            fm.run_tmlp(x, tm, transposed=True)
        assert fm.run_tmlp.launches == before
    tm._plans[(None, None)] = good
    _ring_held(tm, g, dev, 1000)


# -- the float32 nets wider than 128 on the ring (V_WIDE32: 3xTF32 on wgmma,
# the weights split into tf32 hi and lo slabs on the host) ------------------


def _f32_ring_held(tm, g, dev, P):
    assert fm.kernel_plan(tm).variant == fm.V_WIDE32
    x = torch.rand(3, P, generator=g, device=dev) * 8 - 4
    before = fm.run_tmlp.launches
    got = fm.run_tmlp(x, tm, transposed=True)
    assert fm.run_tmlp.launches == before + 1
    _held(got, fm.run_tmlp_plain(x, tm), torch.float32, 3e-4)


@pytest.mark.parametrize("width", [144, 256, 320, 512])
def test_f32_ring_kernels(dev, width):
    """The float32 ring at two chunks (144: 128 + 16 rows; 256), three (320,
    one parked) and four (512): run_tmlp at 1, 17, 1,001 and 4,099 points,
    and the composite at T = 16, 32 and 128 with view heads 32 (the served
    epilogue up to 256) and 48 (the general one), every launch on V_WIDE32
    and held at the JAX suite's float32 bounds and F32_FAITHFUL."""
    g = torch.Generator(device=dev).manual_seed(200 + width)
    tm = _wide_field(g, dev, torch.float32, width)
    for P in (1, 17, 1001, 4099):
        _f32_ring_held(tm, g, dev, P)
    for H in (32, 48):
        view = _view_of(g, dev, torch.float32, 15, H)
        for T in (16, 32, 128):
            assert fm.kernel_plan(tm, T, view).variant == fm.V_WIDE32
            _composite_held(tm, view, 301, T, g, dev, torch.float32)


def test_f32_ring_biases_and_runtime_shapes(dev):
    """Biased layers (added before the activation) and the general
    composite of rays past 128 samples (segments of 256) on the float32
    ring, and T = None without the view head."""
    g = torch.Generator(device=dev).manual_seed(210)
    tm = _wide_field(g, dev, torch.float32, 256, bias=True)
    _f32_ring_held(tm, g, dev, 4099)
    view = _asset_view(g, dev, torch.float32)
    for T in (24, 200):
        assert fm.kernel_plan(tm, T, view).variant == fm.V_WIDE32
        _composite_held(tm, view, 101, T, g, dev, torch.float32)


def test_f32_ring_lost_unit_fails(dev, planted):
    """Planted fault in the float32 ring: its producer leaves out every
    other unit's copy past a chunk's first group (field_branch_variants.py:
    f32_ring_lost_k; no bytes expected, the products read what the stage
    held before): the hold that the kernel passes must fail."""

    def held():
        g = torch.Generator(device=dev).manual_seed(212)
        _f32_ring_held(_wide_field(g, dev, torch.float32, 256), g, dev, 4001)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()


def test_f32_ring_refused_plan_raises(dev):
    """A V_WIDE32 launch without the ring, with the bf16 ring's unit or
    past MAX_STAGES is refused by the C side and raises."""
    g = torch.Generator(device=dev).manual_seed(213)
    tm = _wide_field(g, dev, torch.float32, 256)
    x = torch.rand(3, 1000, generator=g, device=dev) * 8 - 4
    good = fm.kernel_plan(tm)
    for field, value in (("w_mode", fm.W_STREAM), ("unit_b", fm.UNIT_B),
                         ("stages", 9)):
        bad = fm.KernelPlan.from_buffer_copy(good)
        setattr(bad, field, value)
        tm._plans[(None, None)] = bad
        before = fm.run_tmlp.launches
        with pytest.raises(RuntimeError, match="refused its plan"):
            fm.run_tmlp(x, tm, transposed=True)
        assert fm.run_tmlp.launches == before
    tm._plans[(None, None)] = good
    _f32_ring_held(tm, g, dev, 1000)


# the V_GRID kernels (the bf16 nets of the grid family whose weights fit
# shared memory whole): those GRID_NETS nets on them, small launches, the
# planted fault, a refused plan ----------------------------------------------


def test_grid_kernels_take_v_grid(dev):
    """Every bf16 net of GRID_NETS but the ladders launches on V_GRID (its
    counters) in run_tmlp and the composite; the ladders (their 283 KB of
    weights stream) and the float32 twins do not."""
    g = torch.Generator(device=dev).manual_seed(160)
    for name in sorted(GRID_NETS):
        for dtype in (torch.bfloat16, torch.float32):
            tm = _grid_net(name, g, dev, dtype)
            x, dl, ts, r8 = _rays_of(33, 16, g, dev)
            before = (fm.run_tmlp.grid_launches,
                      fm.run_tmlp_composite.grid_launches)
            fm.run_tmlp(x, tm, transposed=True)
            fm.run_tmlp_composite(x, dl, ts, tm, True)
            on = dtype == torch.bfloat16 and "ladder" not in name
            assert fm._grid_net(tm) == on, (name, dtype)
            assert (fm.run_tmlp.grid_launches,
                    fm.run_tmlp_composite.grid_launches) == (
                before[0] + on, before[1] + on), (name, dtype)


def test_grid_small_launches(dev):
    """Launches of 1, 64, 65, 16,384 and 1,000,003 points on V_GRID (fewer
    consumers a block for the small ones, ragged last passes)."""
    g = torch.Generator(device=dev).manual_seed(161)
    tm = _grid_net("grid_student", g, dev, torch.bfloat16)
    for P in (1, 64, 65, 16384, 1000003):
        _ring_held(tm, g, dev, P)


def test_grid_lost_vm_mode_fails(dev, planted):
    """Planted fault in the encoders: a slot marked full without the last
    VM mode's columns (field_branch_variants.py: grid_lost_vm), so the
    chain reads the previous tile's there: the hold that the kernel passes
    on the same points must fail."""

    def held():
        g = torch.Generator(device=dev).manual_seed(162)
        _ring_held(_grid_net("grid_student", g, dev, torch.bfloat16), g, dev,
                   20011)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()


def test_grid_refused_plan_raises(dev):
    """A V_GRID launch with fewer slots than consumers, or without the
    ring, is refused by the C side and raises."""
    g = torch.Generator(device=dev).manual_seed(163)
    tm = _grid_net("sigma_vm", g, dev, torch.bfloat16)
    assert fm.kernel_plan(tm).variant == fm.V_GRID
    x = torch.rand(3, 1000, generator=g, device=dev) * 4 - 2
    good = fm.kernel_plan(tm)
    for field, value in (("slots", 1), ("w_mode", fm.W_STREAM)):
        bad = fm.KernelPlan.from_buffer_copy(good)
        setattr(bad, field, value)
        tm._plans[(None, None)] = bad
        before = fm.run_tmlp.launches
        with pytest.raises(RuntimeError, match="refused its plan"):
            fm.run_tmlp(x, tm, transposed=True)
        assert fm.run_tmlp.launches == before
    tm._plans[(None, None)] = good
    _ring_held(tm, g, dev, 1000)


def _view_of(g, dev, dtype, geo, H):
    return fm.ViewMLP([{"w": p["w"].to(dtype)} for p in _layers(
        [(geo + 16, H), (H, H), (H, 3)], g, dev)], geo + 1, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [48, 96, 128])
def test_composite_wide_view_heads(dev, H, dtype):
    """L4: view heads 48, 96 and 128 wide (each lane its units lane + 32
    q) at T = 16, 24 and 256."""
    g = torch.Generator(device=dev).manual_seed(130 + H)
    tm = _asset_field(g, dev, dtype)
    for T in (16, 24, 256):
        _composite_held(tm, _view_of(g, dev, dtype, 15, H), 301, T, g, dev,
                        dtype)


def _geo_field(g, dev, dtype, kout):
    """The asset's field with kout outputs (geom_feat_dim = kout - 1)."""
    layers = _layers([(127, 128), (255, 128), (128, kout)], g, dev)
    cp = torch.rand(3, 128, 64, generator=g, device=dev) * 0.5 + 0.5
    scp = torch.randn(3, 128, 32, generator=g, device=dev) * 0.5
    return fm.TransposedFieldMLP(
        [{"w": p["w"].to(dtype)} for p in layers], 10, 4.0, (1,), leaky=True,
        cp_lines=cp.to(dtype), sigma_cp_lines=scp.to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kout", [20, 32, 64])
def test_composite_many_outputs(dev, kout, dtype):
    """L5: composites of 20, 32 and 64 outputs (one column of each
    16-column group a lane), with the view head (geo kout - 1) and
    without, at T = 16, 24 and 200."""
    g = torch.Generator(device=dev).manual_seed(140 + kout)
    tm = _geo_field(g, dev, dtype, kout)
    for T in (16, 24, 200):
        _composite_held(tm, _view_of(g, dev, dtype, kout - 1, 32), 301, T,
                        g, dev, dtype)
        x, dl, ts, _ = _rays_of(301, T, g, dev)
        _held(fm.run_tmlp_composite(x, dl, ts, tm),
              fm.run_tmlp_composite_plain(x, dl, ts, tm), dtype, 1e-3)


def _ladder_field(g, dev, dtype, cp_levels, vm_levels, big=False):
    """L6 / L7: CP and VM ladders of the given levels at the config's
    resolutions (cpgrid.level_resolutions); `big`: the quality recipe's
    tables (CP96@2048 x 4, VM32@1024 x 4, sigma-CP96@2048, sigma-VM16@512:
    93,886,464 B in bf16)."""
    from sanerf_tpu_torch.ops.cpgrid import level_resolutions

    tab = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    if big:
        cps = [(r, 24) for r in level_resolutions(2048, 4)]
        vms = [(r, 8) for r in level_resolutions(1024, 4)]
    else:
        cps = [(r, 64 // cp_levels) for r in level_resolutions(256,
                                                               cp_levels)]
        vms = [(r, 32 // vm_levels) for r in level_resolutions(64, vm_levels)]
    kc = sum(K for _, K in cps) + sum(3 * K for _, K in vms)
    sizes = [(63 + kc, 128), (128 + 63 + kc, 128), (128, 16)]
    kw = {"cp_lines": [tab(3, r, K) for r, K in cps],
          "vm_planes": [tab(3, r, r, K) for r, K in vms],
          "vm_lines": [tab(3, r, K) for r, K in vms]}
    if big:
        kw.update(sigma_cp_lines=tab(3, 2048, 96),
                  sigma_vm_planes=tab(3, 512, 512, 16),
                  sigma_vm_lines=tab(3, 512, 16))
    return fm.TransposedFieldMLP(
        [{"w": p["w"].to(dtype)} for p in _layers(sizes, g, dev)], 10, 2.0,
        (1,), leaky=True, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("levels", [(16, 1), (1, 16), (16, 16), "big"])
def test_field_kernels_ladders_and_large_tables(dev, levels, dtype):
    """L6 / L7: CP and VM ladders of 16 levels (the levels' descriptors in
    device memory), and the quality recipe's 94 MB of tables read from
    device memory: run_tmlp, every encoding column through the probes,
    and the composite at T = 32."""
    g = torch.Generator(device=dev).manual_seed(150 + len(str(levels)))
    big = levels == "big"
    tm = _ladder_field(g, dev, dtype, *((4, 4) if big else levels), big=big)
    if big:
        assert tm.table_bytes == 93_886_464 * (4 if dtype == torch.float32
                                                else 2) // 2
    x = torch.rand(3, 20011, generator=g, device=dev) * 4.4 - 2.2
    _held(fm.run_tmlp(x, tm, transposed=True), fm.run_tmlp_plain(x, tm),
          dtype, 3e-4, GRID_TOL)
    for p in fm.encode_probes(tm):
        _held(fm.run_tmlp(x, p, transposed=True), fm.run_tmlp_plain(x, p),
              dtype, 3e-4, PROBE_TOL)
    x, dl, ts, r8 = _rays_of(301, 32, g, dev)
    _held(fm.run_tmlp_composite(x, dl, ts, tm),
          fm.run_tmlp_composite_plain(x, dl, ts, tm), dtype, 1e-3, GRID_TOL)


# the lifted configurations of the JAX package's flags and config fields,
# rendered through run_rays on the kernels against the plain path: image
# and weights_sum at chip_smoke.py's PATH_TOL, depth within DEPTH_MAX
PATH_TOL, DEPTH_MAX = 2e-3, 0.05


def _lifted():
    """port_tools/grid_params.py:LIMITS (numpy alone, as this file)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "port_tools"))
    import grid_params

    return grid_params.LIMITS


LIFTED = _lifted()


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_configs_render_on_the_kernels(dev, name):
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer

    mkw, rkw = LIFTED[name]
    model = fields.make_model(ModelConfig(**mkw), RenderConfig(**rkw))
    plain = fields.make_model(ModelConfig(**mkw),
                              RenderConfig(use_fused_mlp=False, **rkw))
    assert renderer.uses_kernels(model)
    g = torch.Generator().manual_seed(7)
    params = fields.init_params(model, g, dev)
    n = 1024
    o = torch.randn(n, 3, generator=g).mul(0.1).add(
        torch.tensor([0.0, 0.0, 2.0])).to(dev)
    d = torch.randn(n, 3, generator=g).mul(0.2).add(
        torch.tensor([0.0, 0.0, -1.0])).to(dev)
    counters = (rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite)
    before = [c.launches for c in counters]
    got = renderer.run_rays(model, params, o, d)
    assert all(c.launches > b for c, b in zip(counters, before))
    ref = renderer.run_rays(plain, params, o, d)
    torch.cuda.synchronize()
    for k in ("image", "weights_sum"):
        assert bool(torch.isfinite(got[k]).all())
        torch.testing.assert_close(got[k], ref[k], rtol=PATH_TOL,
                                   atol=PATH_TOL)
    assert float((got["depth"] - ref["depth"]).abs().max()) <= DEPTH_MAX


def test_sum_after_mlp_runs_the_field_kernel(dev):
    """sum_after_mlp on the card: the final level's field through run_tmlp
    (the proposal nets' two launches and the field's), no composite
    launch, then the per-sample view MLP and the composite as plain ops;
    the frame against the plain path at PATH_TOL, depth within
    DEPTH_MAX."""
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer

    mc = ModelConfig(sum_after_mlp=True)
    model = fields.make_model(mc, RenderConfig())
    plain = fields.make_model(mc, RenderConfig(use_fused_mlp=False))
    assert renderer.uses_kernels(model)
    g = torch.Generator().manual_seed(8)
    params = fields.init_params(model, g, dev)
    n = 1024
    o = torch.randn(n, 3, generator=g).mul(0.1).add(
        torch.tensor([0.0, 0.0, 2.0])).to(dev)
    d = torch.randn(n, 3, generator=g).mul(0.2).add(
        torch.tensor([0.0, 0.0, -1.0])).to(dev)
    before = (fm.run_tmlp.launches, fm.run_tmlp_composite.launches)
    got = renderer.run_rays(model, params, o, d)
    assert (fm.run_tmlp.launches - before[0],
            fm.run_tmlp_composite.launches - before[1]) == (3, 0)
    ref = renderer.run_rays(plain, params, o, d)
    torch.cuda.synchronize()
    for k in ("image", "weights_sum"):
        torch.testing.assert_close(got[k], ref[k], rtol=PATH_TOL,
                                   atol=PATH_TOL)
    assert float((got["depth"] - ref["depth"]).abs().max()) <= DEPTH_MAX


# -- prop_kernel: the bf16 proposal nets past small_kernel (layers up to 64
# wide, any depth whose weights fit in shared memory), held element by
# element at GRID_TOL (seeded weights), with a planted fault ---------------


def _prop_net(g, dev, width, depth, nf=5):
    F = 3 * (1 + 2 * nf)
    sizes = [(F if l == 0 else width, 1 if l == depth - 1 else width)
             for l in range(depth)]
    return fm.TransposedFieldMLP(
        [{"w": p["w"].to(torch.bfloat16)} for p in _layers(sizes, g, dev)],
        nf, 2.0)


def _prop_held(tm, n, g, dev):
    x = torch.rand(3, n, generator=g, device=dev) * 4 - 2
    assert fm.kernel_plan(tm).prop
    before = (fm.run_tmlp.launches, fm.run_tmlp.prop_launches)
    got = fm.run_tmlp(x, tm, transposed=True)
    assert (fm.run_tmlp.launches, fm.run_tmlp.prop_launches) == (
        before[0] + 1, before[1] + 1)
    _held(got, fm.run_tmlp_plain(x, tm), torch.bfloat16, 3e-4, GRID_TOL)


@pytest.mark.parametrize("n", [1001, 4099, 17, 1])
@pytest.mark.parametrize("width,depth", [(64, 4), (16, 3), (32, 5), (40, 6),
                                         (48, 8), (64, 3), (64, 8)])
def test_prop_kernel(dev, width, depth, n):
    """Widths 16 to 64 (40: hidden layers padded to 48), depths 3 to 8,
    point counts that fill no whole 32-point warp tile."""
    g = torch.Generator(device=dev).manual_seed(140 + width + depth + n)
    _prop_held(_prop_net(g, dev, width, depth), n, g, dev)


@pytest.mark.parametrize("nf", [2, 4, 10])
def test_prop_kernel_frequencies(dev, nf):
    """The encode's other frequency counts (15, 27 and 63 columns)."""
    g = torch.Generator(device=dev).manual_seed(150 + nf)
    _prop_held(_prop_net(g, dev, 64, 4, nf), 20011, g, dev)


def test_prop_kernel_default_net_at_2_20_points(dev):
    """ModelConfig()'s proposal net, w64 d4 over 33 columns, at 2^20
    points (a persistent grid walking many tiles a warp)."""
    g = torch.Generator(device=dev).manual_seed(160)
    _prop_held(_prop_net(g, dev, 64, 4), 1 << 20, g, dev)


def test_prop_kernel_lost_k_step_fails(dev, planted):
    """Planted fault in the kernel: prop_kernel's layers past the first
    without their last k step of 16 inputs (field_branch_variants.py:
    prop_lost_k) must fail the hold that the kernel passes on the same
    points."""
    def held():
        g = torch.Generator(device=dev).manual_seed(161)
        _prop_held(_prop_net(g, dev, 64, 4), 20011, g, dev)

    held()
    with planted():
        with pytest.raises(AssertionError):
            held()
