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
