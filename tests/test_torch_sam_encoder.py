"""The port's SAM image encoder, checkpoint converter and set_image against
the JAX package (sanerf_tpu/models/sam/image_encoder.py, convert.py,
predictor.py) on the same weights and inputs.

Tolerances are tests/test_sam_torch_parity.py's: rtol 1e-4 / atol 5e-5
for attention (1e-5 for the windowed block, whose grid pads), rtol 2e-3 /
atol 2e-4 for the whole encoder, the relative-position tables 1e-5 /
1e-6; the converter's arrays exactly; the uint8 resize of set_image bit
for bit (it is cv2's), its features at the encoder's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models.sam import convert as jconvert
from sanerf_tpu.models.sam import image_encoder as jenc
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.train.checkpoints import flatten_tree as jflat
from sanerf_tpu_torch.models.sam import convert, image_encoder, predictor
from sanerf_tpu_torch.models.sam.predictor import _flatten

from tests.test_sam import TINY_SAM, _synthetic_torch_sd
from tests.test_torch_sam import port_cfg

torch.set_num_threads(1)

# depth 2 with one global block, width 64, window 4 over a 6 x 6 grid
# (padded to 8 x 8), relative positions on
JVIT = jenc.ViTConfig(img_size=96, patch_size=16, embed_dim=64, depth=2,
                      num_heads=2, window_size=4, global_attn_indexes=(1,),
                      out_chans=32)
JSAM = dataclasses.replace(TINY_SAM, vit=JVIT, prompt=dataclasses.replace(
    TINY_SAM.prompt, image_embedding_size=(6, 6), input_image_size=(96, 96)))
CFG = port_cfg(JSAM)
ATTN_TOL = dict(rtol=1e-4, atol=5e-5)
ENC_TOL = dict(rtol=2e-3, atol=2e-4)


def _scaled_sd(rng):
    """tests/test_sam_torch_parity.py's synthetic state dict: tables x 0.1
    and weights / sqrt(fan_in), so the softmaxes stay soft."""
    sd = _synthetic_torch_sd(JSAM, rng)
    for k in list(sd):
        if "rel_pos" in k or "pos_embed" in k:
            sd[k] = (0.1 * sd[k]).astype(np.float32)
        if (k.startswith("image_encoder") and k.endswith(".weight")
                and sd[k].ndim >= 2):
            sd[k] = (sd[k] / np.sqrt(sd[k][0].size)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def weights():
    sd = _scaled_sd(np.random.default_rng(0))
    jp = jconvert.convert_state_dict(sd, JSAM)
    tp = convert.convert_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG)
    return sd, jp, tp


def test_convert_equals_jax_and_covers_every_key(weights):
    sd, jp, tp = weights
    ref, got = jflat(jp, ""), {k: v.numpy() for k, v in _flatten(tp).items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    keys = convert.export_reference_keys(CFG)
    assert keys == jconvert.export_reference_keys(JSAM)
    enc = {k for k in sd if k.startswith("image_encoder.")}
    assert enc == set(keys)
    # every key of the state dict lands in the tree: a leaf per key, or
    # one row of a point / token embedding
    n_leaves = sum(v.numel() for v in _flatten(tp).values())
    assert n_leaves == sum(v.size for v in sd.values())


@pytest.mark.parametrize("variant", ["vit_h", "vit_l", "vit_b"])
def test_variants_consume_the_official_keys(variant):
    cfg = convert.sam_config_for(variant)
    jcfg = jconvert.sam_config_for(variant)
    assert dataclasses.asdict(cfg.vit) == dataclasses.asdict(jcfg.vit)
    assert (convert.export_reference_keys(cfg)
            == jconvert.export_reference_keys(jcfg))


def test_convert_checkpoint_reads_a_pth(tmp_path, weights):
    sd, _, tp = weights
    path = str(tmp_path / "sam.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    import sanerf_tpu_torch.models.sam.convert as mod

    real = mod.sam_config_for
    try:
        mod.sam_config_for = lambda v: CFG
        cfg, p = convert.convert_checkpoint(path, "vit_h")
    finally:
        mod.sam_config_for = real
    assert cfg is CFG
    for k, v in _flatten(p).items():
        np.testing.assert_array_equal(v.numpy(), _flatten(tp)[k].numpy())


@pytest.mark.parametrize("q_size,k_size,n_rel", [(4, 4, 7), (6, 6, 11),
                                                  (5, 5, 13), (3, 6, 9)])
def test_get_rel_pos_equals_jax(q_size, k_size, n_rel):
    rel = np.random.default_rng(n_rel).standard_normal((n_rel, 8)).astype(
        np.float32)
    ref = np.asarray(jenc._get_rel_pos(q_size, k_size, jnp.asarray(rel)))
    got = image_encoder.get_rel_pos(q_size, k_size, torch.from_numpy(rel))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def _attn_params(rng, C, hd, n_rel):
    p = {"qkv": {"w": rng.standard_normal((C, 3 * C)).astype(np.float32)
                 / np.sqrt(C),
                 "b": rng.standard_normal(3 * C).astype(np.float32)},
         "proj": {"w": rng.standard_normal((C, C)).astype(np.float32),
                  "b": rng.standard_normal(C).astype(np.float32)},
         "rel_pos_h": rng.standard_normal((n_rel, hd)).astype(np.float32),
         "rel_pos_w": rng.standard_normal((n_rel, hd)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    return jp, tp


@pytest.mark.parametrize("rel", [True, False])
def test_attention_equals_jax(rel):
    rng = np.random.default_rng(1)
    jp, tp = _attn_params(rng, 16, 8, 7)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ref = np.asarray(jenc.attention(jp, jnp.asarray(x), 2, rel))
    got = image_encoder.attention(tp, torch.from_numpy(x), 2, rel)
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)


def test_windowed_attention_block_equals_jax():
    """partition -> attention -> unpartition on a 5 x 7 grid, window 4."""
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(rng, 8, 4, 7)
    x = rng.standard_normal((1, 5, 7, 8)).astype(np.float32)
    hj, padded = jenc.window_partition(jnp.asarray(x), 4)
    ref = np.asarray(jenc.window_unpartition(
        jenc.attention(jp, hj, 2, True), 4, padded, (5, 7)))
    ht, tpad = image_encoder.window_partition(torch.from_numpy(x), 4)
    assert tpad == padded
    got = image_encoder.window_unpartition(
        image_encoder.attention(tp, ht, 2, True), 4, tpad, (5, 7))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_tiny_encoder_equals_jax(weights):
    _, jp, tp = weights
    x = np.random.default_rng(3).standard_normal((1, 96, 96, 3)).astype(
        np.float32)
    ref = np.asarray(jenc.encode(JVIT, jp["image_encoder"], jnp.asarray(x)))
    got = image_encoder.encode(CFG.vit, tp["image_encoder"],
                               torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 6, 6, 32)
    np.testing.assert_allclose(got.numpy(), ref, **ENC_TOL)


def test_init_params_has_the_jax_tree():
    tp = image_encoder.init_params(CFG.vit, torch.Generator().manual_seed(0))
    jp = jenc.init_params(JVIT, jax.random.key(0))
    assert ({k: tuple(v.shape) for k, v in _flatten(tp).items()}
            == {k: tuple(v.shape) for k, v in jflat(jp, "").items()})


@pytest.mark.parametrize("hw", [(40, 70), (70, 40), (96, 96), (13, 29)])
def test_set_image_equals_jax(weights, hw):
    """A non-square uint8 image: resized (cv2's uint8 bilinear, bit for
    bit), normalized, padded and encoded as the JAX predictor does."""
    _, jp, tp = weights
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(
        np.uint8)
    a = jpred.SamPredictor(JSAM, jp)
    b = predictor.SamPredictor(CFG, tp, device="cpu")
    a.set_image(img)
    b.set_image(img)
    assert a.input_size == b.input_size and a.original_size == b.original_size
    x = image_encoder.preprocess(torch.from_numpy(img), 96)
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jenc.preprocess(jnp.asarray(img), 96)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.features.numpy(), np.asarray(a.features),
                               **ENC_TOL)
    # the decode of a click on the encoded image, as in set_features' test
    pts, lab = np.float32([[5.0, 9.0]]), np.int32([1])
    ra = a.predict(pts, lab, return_logits=True)
    rb = b.predict(pts, lab, return_logits=True)
    np.testing.assert_allclose(rb[1], np.asarray(ra[1]), rtol=1e-3,
                               atol=1e-3)


def test_params_from_jax_maps_the_encoder(weights):
    _, jp, tp = weights
    got = predictor.params_from_jax(jflat(jp, ""), CFG)
    for k, v in _flatten(tp).items():
        np.testing.assert_array_equal(_flatten(got)[k].numpy(), v.numpy())
    no_enc = {k: v for k, v in jflat(jp, "").items()
              if not k.startswith("image_encoder/")}
    dec = predictor.SamPredictor(CFG, predictor.params_from_jax(no_enc, CFG),
                                 device="cpu")
    with pytest.raises(ValueError, match="image_encoder"):
        dec.set_image(np.zeros((8, 8, 3), np.uint8))


def test_seeded_state_dict_has_the_official_layout():
    """port_tools/sam_weights.py: the keys and shapes the JAX suite's
    synthetic checkpoint has, converted to the port's tree."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "port_tools"))
    from sam_weights import seeded_state_dict

    sd = seeded_state_dict(CFG, seed=0)
    ref = _synthetic_torch_sd(JSAM, np.random.default_rng(0))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in ref.items()}
    tree = convert.convert_state_dict(sd, CFG)
    tmpl = predictor.init_params(CFG, torch.Generator().manual_seed(0),
                                 with_encoder=True)
    assert ({k: tuple(v.shape) for k, v in _flatten(tree).items()}
            == {k: tuple(v.shape) for k, v in _flatten(tmpl).items()})
    again = seeded_state_dict(CFG, seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
