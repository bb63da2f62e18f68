"""Parity: the port's SAM decode side (sanerf_tpu_torch/models/sam/)
against the JAX package's, module by module, on the same numpy inputs and
the JAX weights carried across by `predictor.params_from_jax`.

Tolerances: 1e-5 for float32 modules; 1e-4 for the whole decoder (a few
dozen float32 products and softmaxes in series); resizes 1e-5 (the
antialiased downsample of `jax.image.resize` against `interpolate(...,
antialias=True)`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models.fields import cast_params as jcast
from sanerf_tpu.models.sam import common as jcommon
from sanerf_tpu.models.sam import mask_decoder as jdec
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.models.sam import prompt_encoder as jpe
from sanerf_tpu.models.sam import transformer as jtw
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.models import fields as tfields
from sanerf_tpu_torch.models.sam import common, mask_decoder, predictor
from sanerf_tpu_torch.models.sam import prompt_encoder, transformer
from sanerf_tpu_torch.models.sam.mask_decoder import DecoderConfig
from sanerf_tpu_torch.models.sam.prompt_encoder import PromptConfig
from sanerf_tpu_torch.models.sam.transformer import TwoWayConfig

from tests.test_sam import TINY_SAM

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
DEC_TOL = dict(rtol=1e-4, atol=1e-4)


def port_cfg(jc) -> predictor.SamConfig:
    d = jc.decoder
    return predictor.SamConfig(
        vit=predictor.ViTConfig(**dataclasses.asdict(jc.vit)),
        prompt=PromptConfig(**dataclasses.asdict(jc.prompt)),
        decoder=DecoderConfig(
            transformer=TwoWayConfig(**dataclasses.asdict(d.transformer)),
            num_multimask_outputs=d.num_multimask_outputs,
            embed_dim=d.embed_dim, iou_head_depth=d.iou_head_depth,
            iou_head_hidden=d.iou_head_hidden),
        mask_threshold=jc.mask_threshold)


CFG = port_cfg(TINY_SAM)


@pytest.fixture(scope="module")
def sam():
    """(JAX params, port params) of TINY_SAM; biases and norms drawn
    non-trivially so they count."""
    jp = jpred.init_params(TINY_SAM, jax.random.key(1))
    flat = flatten_tree(jp, "")
    rng = np.random.default_rng(0)
    for k in flat:
        if k.endswith("/b") or "norm" in k or k.split("/")[-2:-1] == ["ln1"]:
            flat[k] = rng.normal(0.5 if k.endswith("/w") else 0.0, 0.2,
                                 flat[k].shape).astype(np.float32)
    from sanerf_tpu.train.checkpoints import unflatten_like

    jp = unflatten_like(jp, flat, "")
    return jp, predictor.params_from_jax(flat, CFG)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_common_blocks_match_jax():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 5, 8)
    lin = {"w": _np(rng, 8, 6), "b": _np(rng, 6)}
    tl = {k: _t(v) for k, v in lin.items()}
    np.testing.assert_allclose(common.linear(tl, _t(x)).numpy(),
                               np.asarray(jcommon.linear(lin, x)), **TOL)
    ln = {"w": _np(rng, 8), "b": _np(rng, 8)}
    tln = {k: _t(v) for k, v in ln.items()}
    np.testing.assert_allclose(common.layer_norm(tln, _t(x)).numpy(),
                               np.asarray(jcommon.layer_norm(ln, x)), **TOL)
    np.testing.assert_allclose(
        common.layer_norm_2d(tln, _t(x[None])).numpy(),
        np.asarray(jcommon.layer_norm_2d(ln, x[None])), **TOL)
    blk = {"lin1": {"w": _np(rng, 8, 16), "b": _np(rng, 16)},
           "lin2": {"w": _np(rng, 16, 8), "b": _np(rng, 8)}}
    tblk = {n: {k: _t(v) for k, v in p.items()} for n, p in blk.items()}
    np.testing.assert_allclose(common.mlp_block(tblk, _t(x)).numpy(),
                               np.asarray(jcommon.mlp_block(blk, x)), **TOL)
    m = {"layers": [{"w": _np(rng, 8, 8), "b": _np(rng, 8)},
                    {"w": _np(rng, 8, 3), "b": _np(rng, 3)}]}
    tm = {"layers": [{k: _t(v) for k, v in p.items()} for p in m["layers"]]}
    for sig in (False, True):
        np.testing.assert_allclose(
            common.mlp(tm, _t(x), sig).numpy(),
            np.asarray(jcommon.mlp(m, x, sig)), **TOL)


def test_conv_transpose_matches_jax_and_torch():
    """The [c_in, k, k, c_out] weight against JAX and against torch's
    ConvTranspose2d with the same weights permuted (the mapping
    tests/test_sam.py:test_conv_transpose_equals_torch pins)."""
    rng = np.random.default_rng(2)
    w_t = _np(rng, 6, 4, 2, 2)
    b = _np(rng, 4)
    x = _np(rng, 1, 5, 7, 6)
    p = {"w": w_t.transpose(0, 2, 3, 1), "b": b}
    got = common.conv_transpose2d({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jcommon.conv_transpose2d(p, x)),
                               **TOL)
    ref = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(w_t), _t(b), stride=2)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_attention_and_two_way_transformer_match_jax(sam):
    jp, tp = sam
    jt, tt = jp["mask_decoder"]["transformer"], tp["mask_decoder"][
        "transformer"]
    rng = np.random.default_rng(3)
    tok, img, pe = _np(rng, 2, 5, 32), _np(rng, 2, 16, 32), _np(rng, 2, 16, 32)
    blk_j, blk_t = jt["blocks"][1]["cross_t2i"], tt["blocks"][1]["cross_t2i"]
    np.testing.assert_allclose(
        transformer.attn(blk_t, _t(tok), _t(img), _t(img), 2).numpy(),
        np.asarray(jtw.attn(blk_j, tok, img, img, 2)), **TOL)
    cfg = CFG.decoder.transformer
    got = transformer.apply(cfg, tt, _t(img), _t(pe), _t(tok))
    ref = jtw.apply(TINY_SAM.decoder.transformer, jt, img, pe, tok)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **DEC_TOL)


def test_prompt_encoder_matches_jax(sam):
    jp, tp = sam
    j, t = jp["prompt_encoder"], tp["prompt_encoder"]
    np.testing.assert_allclose(
        prompt_encoder.dense_pe(t, CFG.prompt).numpy(),
        np.asarray(jpe.dense_pe(j, TINY_SAM.prompt)), **TOL)
    coords = np.float32([[[10.0, 20.0], [30.5, 40.0], [3.0, 60.0]],
                         [[1.0, 2.0], [63.0, 0.0], [5.0, 5.0]]])
    labels = np.int32([[1, 0, -1], [1, 1, 0]])
    got = prompt_encoder.encode_points(t, CFG.prompt, _t(coords),
                                       torch.from_numpy(labels.astype(
                                           np.int64)))
    ref = jpe.encode_points(j, TINY_SAM.prompt, coords, labels)
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        prompt_encoder.no_mask_dense(t, CFG.prompt, 2).numpy(),
        np.asarray(jpe.no_mask_dense(j, TINY_SAM.prompt, 2)), **TOL)


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(sam, multimask):
    jp, tp = sam
    rng = np.random.default_rng(4)
    feats = _np(rng, 1, 4, 4, 32)
    pe, sparse, dense = _np(rng, 16, 32), _np(rng, 1, 3, 32), _np(rng, 1, 16,
                                                                  32)
    ref = jdec.predict_masks(TINY_SAM.decoder, jp["mask_decoder"], feats, pe,
                             sparse, dense)
    got = mask_decoder.predict_masks(CFG.decoder, tp["mask_decoder"],
                                     _t(feats), _t(pe), _t(sparse), _t(dense))
    assert got[0].shape == (1, 4, 16, 16) and got[1].shape == (1, 4)
    ref = jdec.select_masks(*ref, multimask)
    got = mask_decoder.select_masks(*got, multimask)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **DEC_TOL)


@pytest.mark.parametrize("hw,size", [((32, 32), (64, 64)),
                                     ((1024, 1024), (512, 512)),
                                     ((256, 256), (1024, 1024)),
                                     ((12, 20), (7, 30))])
def test_resize_matches_jax_image_resize(hw, size):
    x = np.random.default_rng(5).normal(0, 1, (2, *hw)).astype(np.float32)
    ref = jax.image.resize(x, (2, *size), "bilinear")
    got = predictor.resize_bilinear(_t(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_fused_matches_jax(sam, dtype):
    """Mask logits and IoU of the whole interactive decode at 1e-4, with
    float32 and with bf16 weights (both frameworks round the same inputs of
    each product to bf16 and sum in float32); the boolean masks agree
    wherever the logit is clear of the threshold by twice that."""
    jp, tp = sam
    if dtype == "bfloat16":
        jp = jcast(jp, jnp.bfloat16)
        tp = tfields.cast_params(tp, torch.bfloat16)
    tol = 1e-4
    rng = np.random.default_rng(6)
    feats = _np(rng, 8, 6, 32)
    coords = np.float32([[[5.0, 7.0], [2.0, 3.0]]])
    labels = np.int32([[1, -1]])
    kw = dict(feat_hw=(8, 6), out_hw=(16, 12), input_hw=(64, 48))
    ref_m, ref_iou = jpred.decode_fused(TINY_SAM, jp, feats, coords, labels,
                                        **kw)
    got_m, got_iou = predictor.decode_fused(
        CFG, tp, _t(feats), _t(coords), torch.from_numpy(labels.astype(
            np.int64)), **kw)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou,
                                                            np.float32),
                               rtol=tol, atol=tol)
    # the logits behind the masks
    scale = np.float32([48 / 12, 64 / 16])
    f, _ = predictor._inject(CFG, _t(feats))
    lr, _ = predictor.decode(CFG, tp, f, _t(coords * scale),
                             torch.from_numpy(labels.astype(np.int64)))
    logits = predictor._to_frame(CFG, lr, (64, 48), (16, 12))
    jl, _ = jpred.decode(TINY_SAM, jp, _jax_inject(feats), coords * scale,
                         labels)
    up = jax.image.resize(jl, (1, 1, 64, 64), "bilinear")[:, :, :64, :48]
    jlog = np.asarray(jax.image.resize(up, (1, 1, 16, 12), "bilinear"),
                      np.float32)
    np.testing.assert_allclose(logits.numpy(), jlog, rtol=tol, atol=tol)
    clear = np.abs(jlog) > 2 * tol * (1 + np.abs(jlog))
    assert got_m.shape == (1, 1, 16, 12) and got_m.dtype == torch.bool
    np.testing.assert_array_equal(got_m.numpy()[clear],
                                  np.asarray(ref_m)[clear])
    np.testing.assert_array_equal(got_m.numpy(), logits.numpy() > 0)
    assert clear.mean() > 0.9


def _jax_inject(feats):
    grid = TINY_SAM.prompt.image_embedding_size[0]
    h, w = feats.shape[:2]
    s = grid / max(h, w)
    nh, nw = int(round(h * s)), int(round(w * s))
    f = jax.image.resize(feats, (nh, nw, feats.shape[-1]), "bilinear")
    return jnp.pad(f, ((0, grid - nh), (0, grid - nw), (0, 0)))[None]


def test_predictor_matches_jax(sam):
    jp, tp = sam
    feats = np.random.default_rng(7).normal(0, 1, (8, 8, 32)).astype(
        np.float32)
    a = jpred.SamPredictor(TINY_SAM, jp)
    b = predictor.SamPredictor(CFG, tp, device="cpu")
    a.set_features(feats, 16, 16)
    b.set_features(feats, 16, 16)
    assert a.input_size == b.input_size and a.original_size == b.original_size
    np.testing.assert_allclose(b.features.numpy(), np.asarray(a.features),
                               **TOL)
    pts, lab = np.float32([[4.0, 9.0]]), np.int32([1])
    ra = a.predict(pts, lab, return_logits=True)
    rb = b.predict(pts, lab, return_logits=True)
    for g, r in zip(rb, ra):
        np.testing.assert_allclose(g, np.asarray(r), **DEC_TOL)
    ma, ia = a.predict_batch(np.float32([[[4.0, 9.0]], [[12.0, 3.0]]]))
    mb, ib = b.predict_batch(np.float32([[[4.0, 9.0]], [[12.0, 3.0]]]),
                             chunk=1)
    assert mb.shape == ma.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(mb, ma, **DEC_TOL)
    np.testing.assert_allclose(ib, ia, **DEC_TOL)
    # set_image: the tiny ViT encoder on a non-square uint8 image, at the
    # encoder's bounds of tests/test_sam_torch_parity.py
    img = np.random.default_rng(3).integers(0, 256, (12, 20, 3), np.uint8)
    a.set_image(img)
    b.set_image(img)
    assert a.input_size == b.input_size and a.original_size == b.original_size
    np.testing.assert_allclose(b.features.numpy(), np.asarray(a.features),
                               rtol=2e-3, atol=2e-4)


def test_params_from_jax_checks_every_key(sam):
    jp, _ = sam
    flat = flatten_tree(jp, "")
    assert any(k.startswith("image_encoder/") for k in flat)
    tp = predictor.params_from_jax(flat, CFG)
    np.testing.assert_array_equal(
        tp["mask_decoder"]["hyper_mlps"][2]["layers"][1]["w"].numpy(),
        flat["mask_decoder/hyper_mlps/2/layers/1/w"])
    bad = dict(flat)
    bad["mask_decoder/extra/w"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="failed to map"):
        predictor.params_from_jax(bad, CFG)
    bad = dict(flat)
    bad["mask_decoder/iou_token"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="failed to map"):
        predictor.params_from_jax(bad, CFG)
    del bad["mask_decoder/iou_token"]
    with pytest.raises(ValueError, match="missing"):
        predictor.params_from_jax(bad, CFG)
