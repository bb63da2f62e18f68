"""The proposal nets' prop_kernel (csrc/fused_mlp_t.cu), on the CPU.

kernel_plan's routing (bf16 proposal nets past small_kernel's two layers of
32 take prop_kernel; small_kernel, the float32 route and every net with
tables, skips or wider layers keep theirs), the plain chain of such nets
against the JAX package's run_tmlp in interpret mode (the JAX suite's
0.05 in bf16, 3e-4 in float32), and a numpy model of the kernel's fragment
addressing (its encode's columns, ldmatrix's lane addresses into the
core-matrix slabs and the tile buffer, mma.sync's fragments, the hidden
activations handed on in registers, the output shuffle) against the plain
chain in float64. The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models import fields as jfields
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu_torch.ops import fused_mlp_t as tfm

torch.set_num_threads(1)

BOUND = 2.0


def _net(width, depth, dtype=torch.bfloat16, enc_freqs=5, seed=0, **kw):
    """A proposal net: 3 (1 + 2 enc_freqs) -> width x (depth - 1) -> 1,
    ReLU, weights N(0, 1 / fan_in)."""
    g = torch.Generator().manual_seed(seed)
    F = 3 * (1 + 2 * enc_freqs)
    sizes = [(F if l == 0 else width, 1 if l == depth - 1 else width)
             for l in range(depth)]
    layers = [{"w": (torch.randn(i, o, generator=g) / i ** 0.5).to(dtype)}
              for i, o in sizes]
    return tfm.TransposedFieldMLP(layers, enc_freqs, BOUND, **kw)


@pytest.mark.parametrize("width,depth", [(64, 4), (48, 3), (64, 6), (64, 2),
                                         (32, 3), (16, 8), (64, 1)])
def test_plan_routes_the_proposal_nets_to_prop_kernel(width, depth):
    """bf16, no tables, no bias, angle doubling, layers <= 64 wide past
    small_kernel's two of <= 32: prop_kernel, with its shared-memory carve
    (the weights whole, then PROP_WARPS buffers of PROP_PTS rows of ke + 8
    bf16: 16 B times an odd number)."""
    tm = _net(width, depth)
    p = tfm.kernel_plan(tm)
    assert p.prop and not p.small and tfm.route(tm) == "prop_kernel"
    desc, w_elems = tm.layout()
    ke = int(desc[4])
    assert ke == 48 and p.lde == ke + 8 and (p.lde * 2 // 16) % 2 == 1
    assert p.w_bytes == w_elems * 2 and p.w_bytes % 16 == 0
    assert p.enc_b == tfm.PROP_PTS * p.lde * 2
    assert p.total == p.w_bytes + tfm.PROP_WARPS * p.enc_b <= tfm.SMEM_LIMIT


def test_plan_keeps_the_other_routes():
    """small_kernel keeps w <= 32 d2; float32 nets, nets with CP tables,
    biases, the dense-sin encode, leaky ReLU or a skip, layers wider than
    64, an encoding past 64 and weights past the shared memory keep
    tmlp_kernel."""
    assert tfm.kernel_plan(_net(32, 2)).small
    assert tfm.route(_net(32, 2)) == "small_kernel"
    cp = torch.rand(3, 16, 8).to(torch.bfloat16)
    w = _net(64, 4).ws
    others = {
        "float32": _net(64, 4, torch.float32),
        "cp tables": tfm.TransposedFieldMLP(
            [{"w": torch.zeros(33 + 8, 64, dtype=torch.bfloat16)}]
            + [{"w": v} for v in w[1:]], 5, BOUND, cp_lines=cp),
        "bias": tfm.TransposedFieldMLP(
            [{"w": v, "b": torch.zeros(v.shape[1])} for v in w], 5, BOUND),
        "dense sin": _net(64, 4, angle_double=False),
        "leaky": _net(64, 4, leaky=True),
        "skip": tfm.TransposedFieldMLP(
            [{"w": w[0]}, {"w": w[1]},
             {"w": torch.zeros(64 + 33, 64, dtype=torch.bfloat16)},
             {"w": w[3]}], 5, BOUND, skip_layers=(2,)),
        "w80": _net(80, 4),
        "w128": _net(128, 4),
        "11 frequencies": _net(64, 4, enc_freqs=11),
        "depth 32": _net(64, 32),
    }
    for name, tm in others.items():
        p = tfm.kernel_plan(tm)
        assert not p.prop and not p.small, name
        assert tfm.route(tm) == "tmlp_kernel", name
    # just inside: 10 frequencies (63 columns), the deepest that fits
    assert tfm.kernel_plan(_net(64, 4, enc_freqs=10)).prop
    deep = max(d for d in range(2, 33) if tfm.kernel_plan(_net(64, d)).prop)
    assert 20 <= deep < 32


def _points(n, seed):
    x = np.random.default_rng(seed).uniform(-BOUND, BOUND, (n, 3))
    x[0] = [-BOUND, BOUND, 0.0]
    return x.astype(np.float32)


@pytest.mark.parametrize("depth", [4, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 0.05)])
def test_proposal_chain_matches_jax(depth, dtype, tol):
    """The plain chain that prop_kernel is held against on the card, w64
    at depths 4 (ModelConfig's default) and 3, against JAX run_tmlp in
    interpret mode on the same weights."""
    layers = jfields.init_mlp(jax.random.key(depth), 33, 1, 64, depth,
                              bias=False)
    jl = layers if dtype == torch.float32 else jfields.cast_params(
        layers, jnp.bfloat16)
    x = _points(45, seed=depth)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x.T), jl, 5, BOUND, (),
                                  leaky=False, block=16, interpret=True,
                                  transposed=True))
    tm = tfm.TransposedFieldMLP(
        [{"w": torch.tensor(np.asarray(p["w"], np.float32)).to(dtype)}
         for p in layers], 5, BOUND)
    if dtype == torch.bfloat16:
        assert tfm.route(tm) == "prop_kernel"
    got = tfm.run_tmlp(torch.from_numpy(x.T.copy()), tm, transposed=True)
    assert got.shape == (1, 45)
    np.testing.assert_allclose(got.numpy(), ref[:1], rtol=tol, atol=tol)


# -- a numpy model of prop_kernel's fragments --------------------------------


def _ldsm_x4(mem, addrs):
    """ldmatrix.x4 of bf16 `mem` (flat): lane l gives the row address
    addrs[l] of row l % 8 of matrix l // 8 -> regs [32 lanes, 4, 2], lane
    T's register q the two elements at addrs[8 q + T // 4] + 2 (T % 4)."""
    out = np.zeros((32, 4, 2))
    for T in range(32):
        for q in range(4):
            a = addrs[8 * q + T // 4] + 2 * (T % 4)
            out[T, q] = mem[a:a + 2]
    return out


def _mma(c, a, b):
    """mma.m16n8k16 on fragments: c [32, 4], a [32, 4, 2], b [32, 2, 2]
    (lane 4 g + t: a = A rows g, g + 8 at columns 2t, 2t + 8; b = B rows
    2t, 2t + 8 at column g) -> c + A B."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, k:k + 2] = a[lane, q]
        for q, k in enumerate((2 * t, 2 * t + 8)):
            B[k:k + 2, g] = b[lane, q]
    C = A @ B
    out = c.copy()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                      C[g + 8, 2 * t + 1]]
    return out


def _bf16(v):
    return torch.tensor(v, dtype=torch.float64).to(torch.bfloat16).double() \
        .numpy()


def _model_encode(x, nf, scale, ke):
    """prop_encode: the tight columns (z_d; per frequency s_d, c_d), zero
    to ke, by angle doubling in float32."""
    v = np.zeros(ke, np.float32)
    s, c = np.zeros(3, np.float32), np.zeros(3, np.float32)
    for d in range(3):
        z = np.float32(x[d] * scale)
        v[d] = z
        s[d] = np.sin(z)
        c[d] = np.sin(np.float32(z + np.float32(np.pi / 2)))
    for f in range(nf):
        for d in range(3):
            if f:
                s[d], c[d] = (np.float32(2.0) * s[d] * c[d],
                              c[d] * c[d] - s[d] * s[d])
            v[3 + 6 * f + d], v[6 + 6 * f + d] = s[d], c[d]
    return v


def _model_tile(tm, x32):
    """One warp's 32 points through prop_kernel's addressing -> the output
    rows [kout, 32] as the warp stores them (float64 sums)."""
    flat, desc = tm.packed(torch.device("cpu"))
    W = flat.double().numpy()
    n, ke = int(desc[0]), int(desc[4])
    lde = ke + 8
    layers = [tuple(int(v) for v in desc[6 + 6 * l:12 + 6 * l])
              for l in range(n)]
    buf = np.zeros(32 * lde)
    for lane in range(32):
        buf[lane * lde:lane * lde + ke] = _bf16(_model_encode(
            x32[lane], tm.enc_freqs, tm.scale, ke))
    hA = None
    for l, (kin_h, _, kout, kout_real, w_off, _) in enumerate(layers):
        last = l == n - 1
        nt_n = (kout_real + 7) // 8 if last else kout // 8
        acc = np.zeros((2, kout // 8, 32, 4))
        for s in range(kin_h // 16):
            if l == 0:
                a = [_ldsm_x4(buf, [(16 * i + (lane & 15)) * lde + 16 * s
                                    + 8 * (lane >> 4) for lane in range(32)])
                     for i in range(2)]
            else:
                a = [hA[i][s] for i in range(2)]
            for jp in range((nt_n + 1) // 2):
                base = [w_off + ((2 * s + ((lane >> 3) & 1)) * (kout >> 3)
                                 + (lane >> 4) + 2 * jp) * 64
                        + (lane & 7) * 8 for lane in range(32)]
                b = _ldsm_x4(W, base)
                for i in range(2):
                    acc[i, 2 * jp] = _mma(acc[i, 2 * jp], a[i], b[:, 0:2])
                    if 2 * jp + 1 < nt_n:
                        acc[i, 2 * jp + 1] = _mma(acc[i, 2 * jp + 1], a[i],
                                                  b[:, 2:4])
        if not last:
            act = _bf16(np.maximum(acc, 0.0))
            hA = [[np.stack([act[i, 2 * s][:, 0:2], act[i, 2 * s][:, 2:4],
                             act[i, 2 * s + 1][:, 0:2],
                             act[i, 2 * s + 1][:, 2:4]], 1)
                   for s in range(kout // 16)] for i in range(2)]
    out = np.zeros((kout_real, 32))
    for r in range(kout_real):
        for lane in range(32):
            g, h, i = lane & 7, (lane >> 3) & 1, lane >> 4
            src = 4 * g + ((r & 7) >> 1)
            out[r, lane] = acc[i, r >> 3, src, 2 * h + (r & 1)]
    return out


def _chain64(tm, enc):
    """The plain chain in float64 from a bf16 encoding [P, ke]: hidden
    activations rounded to bf16 (as forward_plain)."""
    h = enc
    for l, w in enumerate(tm.ws):
        w = w.double().numpy()
        h = h[:, :w.shape[0]] @ w
        if l < len(tm.ws) - 1:
            h = _bf16(np.maximum(h, 0.0))
    return h


@pytest.mark.parametrize("width,depth", [(64, 4), (48, 3)])
def test_fragment_model_is_the_plain_chain(width, depth):
    """prop_kernel's addressing, modelled lane by lane in numpy, computes
    the plain chain on the same encoding (float64 sums: equal within their
    rounding), and its encode's columns are the plain version's."""
    tm = _net(width, depth, seed=width + depth)
    x = _points(32, seed=7)
    got = _model_tile(tm, x)
    ke = int(tm.layout()[0][4])
    enc = np.stack([_model_encode(p, tm.enc_freqs, tm.scale, ke) for p in x])
    np.testing.assert_allclose(got.T, _chain64(tm, _bf16(enc)), rtol=1e-9,
                               atol=1e-9)
    # the plain version's encoding, read through an identity layer
    eye = tfm.TransposedFieldMLP([{"w": torch.eye(tm.F)}], tm.enc_freqs,
                                 BOUND)
    plain = eye.forward_plain(torch.from_numpy(x.T.copy())).numpy()
    np.testing.assert_allclose(enc[:, :tm.F], plain, rtol=0, atol=1e-5)
    assert not enc[:, tm.F:].any()
