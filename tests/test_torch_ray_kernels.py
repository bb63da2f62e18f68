"""Parity: the plain versions of the port's ray-geometry kernels
(sanerf_tpu_torch/ops/ray_kernels.py) vs the JAX Pallas kernels in
interpret mode, on the same numpy inputs (jitter included), at 1e-5."""

import numpy as np
import pytest
import torch

from sanerf_tpu.ops import ray_kernels as jrk
from sanerf_tpu_torch.ops import ray_kernels as trk

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rays8(n, seed):
    """Rays from inside a bound-4 box, with s_near/s_far as run_rays
    builds them."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    near = rng.uniform(0.2, 0.6, (n, 1))
    far = near + rng.uniform(1.0, 8.0, (n, 1))
    sn = np.where(near < 1, near / 2, 1 - 1 / (2 * near))
    sf = np.where(far < 1, far / 2, 1 - 1 / (2 * far))
    return np.concatenate([o, d, sn, sf], 1).astype(np.float32)


def _check(got, ref):
    names = ("bins", "ts", "dl", "x3")
    for name, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("T", [8, 32])
@pytest.mark.parametrize("jittered", [False, True])
def test_ray_level0_matches_jax(T, jittered):
    r8 = _rays8(37, seed=T)
    jit = None
    if jittered:
        u = np.random.default_rng(1).uniform(0, 1, (37, T + 1))
        jit = ((u - 0.5) / T).astype(np.float32)
    ref = jrk.ray_level0(r8, T, True, block_rays=37, interpret=True,
                         jitter=jit)
    got = trk.ray_level0(torch.from_numpy(r8), T, True,
                         jitter=None if jit is None else torch.from_numpy(jit))
    _check(got, ref)


@pytest.mark.parametrize("T0,T", [(32, 16), (16, 8)])
@pytest.mark.parametrize("uniform_prev,jittered",
                         [(False, False), (True, False), (False, True)])
def test_ray_level_matches_jax(T0, T, uniform_prev, jittered):
    n = 24
    rng = np.random.default_rng(T0 + T)
    r8 = _rays8(n, seed=3)
    w = rng.uniform(0, 1, (n, T0)).astype(np.float32)
    w[2] = 0.0  # degenerate row: pdf of the +0.01 floor alone
    if uniform_prev:
        b = np.broadcast_to(np.linspace(0, 1, T0 + 1, dtype=np.float32),
                            (n, T0 + 1)).copy()
    else:
        b = np.sort(rng.uniform(0, 1, (n, T0 + 1)), axis=1).astype(np.float32)
        b[:, 0], b[:, -1] = 0.0, 1.0
    jit = None
    if jittered:
        u = rng.uniform(0, 1, (n, T + 1))
        jit = ((u - 0.5) / (T + 1)).astype(np.float32)
    ref = jrk.ray_level(r8, w, b, T, True, uniform_prev=uniform_prev,
                        block_rays=n, interpret=True, jitter=jit)
    got = trk.ray_level(torch.from_numpy(r8), torch.from_numpy(w),
                        torch.from_numpy(b), T, True, uniform_prev=uniform_prev,
                        jitter=None if jit is None else torch.from_numpy(jit))
    _check(got, ref)


def test_cpu_tensors_take_the_plain_version():
    r8 = torch.from_numpy(_rays8(5, seed=9))
    before = (trk.ray_level0.launches, trk.ray_level.launches)
    a = trk.ray_level0(r8, 8, False)
    b = trk.ray_level0_plain(r8, 8, False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[3].shape == (3, 5, 8)
    assert (trk.ray_level0.launches, trk.ray_level.launches) == before


@pytest.mark.parametrize("N,T", [(64, 24), (48, 7)])
def test_flatten3_nt_matches_jax(N, T):
    """Bit for bit against the JAX kernel (interpret mode)."""
    x3 = np.random.default_rng(11).normal(0, 2, (3, N, T)).astype(np.float32)
    ref = jrk.flatten3_nt(x3, block_rays=16, interpret=True)
    got = trk.flatten3_nt(torch.from_numpy(x3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.data_ptr() != torch.from_numpy(x3).data_ptr()


def test_pick_pack_q_matches_jax():
    for T in (4, 7, 16, 24, 32, 64, 128):
        for n in (24, 1000, 4096, 512 * 512):
            assert trk.pick_pack_q(T, n) == jrk.pick_pack_q(T, n), (T, n)
    assert trk.pick_pack_q(16, 512 * 512) == 8
    assert trk.pick_pack_q(32, 512 * 512) == 4


@pytest.mark.parametrize("level", [0, 1])
def test_packed_rows_match_jax(level):
    """ts_p/dl_p: bit for bit the flat ts/dl, and against JAX's packed
    outputs at 1e-5; q must divide N."""
    n, T, q = 32, 8, 4
    r8 = _rays8(n, seed=12)
    if level == 0:
        ref = jrk.ray_level0(r8, T, True, block_rays=n, interpret=True,
                             pack_q=q)
        got = trk.ray_level0(torch.from_numpy(r8), T, True, pack_q=q)
    else:
        rng = np.random.default_rng(13)
        w = rng.uniform(0, 1, (n, 16)).astype(np.float32)
        b = np.sort(rng.uniform(0, 1, (n, 17)), 1).astype(np.float32)
        b[:, 0], b[:, -1] = 0.0, 1.0
        ref = jrk.ray_level(r8, w, b, T, True, block_rays=n, interpret=True,
                            pack_q=q)
        got = trk.ray_level(torch.from_numpy(r8), torch.from_numpy(w),
                            torch.from_numpy(b), T, True, pack_q=q)
    assert len(got) == 6 and got[4].shape == (n // q, q * T, 1)
    assert torch.equal(got[4].reshape(-1), got[1].reshape(-1))
    assert torch.equal(got[5].reshape(-1), got[2].reshape(-1))
    _check(got[:4], ref[:4])
    for g, r in zip(got[4:], ref[4:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    with pytest.raises(ValueError, match="divide"):
        trk.ray_level0(torch.from_numpy(r8[:30]), T, True, pack_q=4)


# -- the inverse-CDF walk of csrc/ray_kernels.cu:walk -------------------------
# A numpy float32 model of the kernel's algorithm, one IEEE operation a step
# and no fused multiply-add (the kernel builds with -fmad=false), held bit
# for bit against the plain `_resample` (and through it against the JAX
# `_resample` at 1e-5): index-order pdf total and CDF, then one walk along
# the CDF for all K edges: each edge adds, to the index-order sum of the
# prefix of ramps that are exactly 1, the terms from there to the first
# exact 0, and the prefix grows while those terms are exactly 1.

F32 = np.float32


def _walk_model(w, b, K, jit, uniform_prev):
    """-> (new edges [N, K], ramps evaluated per ray) as the kernel does."""
    N, T0 = w.shape
    out = np.zeros((N, K), F32)
    steps = np.zeros(N, np.int64)
    for n in range(N):
        row = (w[n] + F32(0.01)).astype(F32)
        total = F32(0)
        for v in row:
            total = F32(total + v)
        c, acc = [F32(0)], F32(0)
        for v in row:
            acc = F32(acc + F32(v / total))
            c.append(min(acc, F32(1)))
        bp = None if uniform_prev else b[n]
        db = (lambda i: F32(1)) if uniform_prev else (
            lambda i: F32(bp[i + 1] - bp[i]))
        r = [F32(1) / max(F32(c[i + 1] - c[i]), F32(1e-12))
             for i in range(T0)]
        m, P, u_last = 0, F32(0), None
        for j in range(K):
            u = F32(F32(F32(j) + F32(0.5)) / F32(K))
            if jit is not None:
                u = F32(u + jit[n, j])
            if u_last is not None and u < u_last:
                m, P = 0, F32(0)
            u_last = u
            a, i, prefix = P, m, True
            while i < T0 and u > c[i]:
                fr = min(max(F32((u - c[i]) * r[i]), F32(0)), F32(1))
                a = F32(a + (fr if uniform_prev else F32(fr * db(i))))
                prefix = prefix and fr == F32(1)
                if prefix:
                    P, m = a, i + 1
                i += 1
                steps[n] += 1
            out[n, j] = (F32(a / F32(T0)) if uniform_prev
                         else F32(bp[0] + a))
    return out, steps


def _cdf(w):
    """The kernel's CDF of each row (index order, clipped at 1)."""
    row = (w + F32(0.01)).astype(F32)
    total = np.zeros(w.shape[0], F32)
    for i in range(w.shape[1]):
        total = (total + row[:, i]).astype(F32)
    acc, cols = np.zeros_like(total), [np.zeros_like(total)]
    for i in range(w.shape[1]):
        acc = (acc + (row[:, i] / total).astype(F32)).astype(F32)
        cols.append(np.minimum(acc, F32(1)))
    return np.stack(cols, 1)


def _walk_inputs(T0, T, uniform_prev, jittered, seed):
    """Random rows and the adversarial ones: 0 all-zero weights (the 0.01
    floor alone), 1 one-hot, 2 a CDF that reaches 1 early (zero-width
    intervals at the end), 3 (jittered) edges landing exactly on CDF
    values, 4 (jittered) one-hot with an edge one float below the end of
    its wide interval (a ramp just under 1 that the next edge saturates)."""
    n, K = 12, T + 1
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (n, T0)).astype(F32) ** 4
    w[0] = 0.0
    w[1] = 0.0
    w[1, T0 // 3] = 1.0
    w[2] = 0.0
    w[2, :3] = 1e4
    b = np.sort(rng.uniform(0, 1, (n, T0 + 1)), axis=1).astype(F32)
    b[:, 0], b[:, -1] = 0.0, 1.0
    jit = None
    if jittered:
        jit = ((rng.uniform(0, 1, (n, K)) - 0.5) / K).astype(F32)
        c = _cdf(w[3:4])[0]
        u = ((np.arange(K, dtype=F32) + F32(0.5)) / F32(K)).astype(F32)
        near = c[np.abs(c[None, :] - u[:, None]).argmin(1)]
        jit[3] = (near - u).astype(F32)
        w[4] = 0.0
        w[4, T0 // 2] = 1.0
        end = np.nextafter(_cdf(w[4:5])[0][T0 // 2 + 1], F32(0))
        j = int(np.abs(u - end).argmin())
        jit[4, j] = F32(end - u[j])
    return w, b, jit


@pytest.mark.parametrize("T0,T", [(32, 16), (128, 64), (64, 32)])
@pytest.mark.parametrize("uniform_prev", [False, True])
@pytest.mark.parametrize("jittered", [False, True])
def test_cdf_walk_is_the_ramp_sum(T0, T, uniform_prev, jittered):
    w, b, jit = _walk_inputs(T0, T, uniform_prev, jittered, seed=T0 + T)
    K = T + 1
    cdf = _cdf(w)
    assert (cdf[2, :-1] >= 1).any()  # row 2 reaches 1 before its end
    got, steps = _walk_model(w, b, K, jit, uniform_prev)
    if jittered:  # row 3: some u falls exactly on a CDF value
        u = (((np.arange(K, dtype=F32) + F32(0.5)) / F32(K)).astype(F32)
             + jit[3]).astype(F32)
        assert np.isin(u, cdf[3]).any()
        u4 = (((np.arange(K, dtype=F32) + F32(0.5)) / F32(K)).astype(F32)
              + jit[4]).astype(F32)
        lo, hi = cdf[4, T0 // 2], cdf[4, T0 // 2 + 1]
        assert ((u4 > lo) & (u4 < hi) & (u4 >= np.nextafter(hi, F32(0)))
                ).any()
    # O(K + T0) ramps a ray, where the plain sum takes K * T0
    assert steps.max() <= 2 * (K + T0)
    tj = None if jit is None else torch.from_numpy(jit)
    ref = trk._resample(torch.from_numpy(w),
                        None if uniform_prev else torch.from_numpy(b), K, tj)
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref.numpy().view(np.int32))
    jref = jrk._resample(w, None if uniform_prev else b, K, jit)
    np.testing.assert_allclose(got, np.asarray(jref), **TOL)


@pytest.mark.parametrize("uniform_prev", [False, True])
def test_cdf_walk_restarts_on_a_falling_edge(uniform_prev):
    """Jitter of +-2/K makes some u_j fall below u_{j-1}: the walk starts
    again from the first interval and stays bit for bit."""
    T0, T = 64, 32
    w, b, _ = _walk_inputs(T0, T, uniform_prev, False, seed=5)
    K = T + 1
    rng = np.random.default_rng(6)
    jit = ((rng.uniform(0, 1, (w.shape[0], K)) - 0.5) * 4 / K).astype(F32)
    u = ((np.arange(K, dtype=F32) + F32(0.5)) / F32(K)).astype(F32) + jit
    assert (np.diff(u, axis=1) < 0).any()
    got, _ = _walk_model(w, b, K, jit, uniform_prev)
    ref = trk._resample(torch.from_numpy(w),
                        None if uniform_prev else torch.from_numpy(b), K,
                        torch.from_numpy(jit))
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref.numpy().view(np.int32))
