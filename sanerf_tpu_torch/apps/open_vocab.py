"""Open-vocabulary 3D segmentation: type a phrase, get a 3D-consistent
mask (JAX: sanerf_tpu/apps/open_vocab.py).

1. `LangDistillTrainer` distills a pixel-aligned language-embedding field
   into the NeRF. It is stage 2 (train/distill.py:SamDistillTrainer:
   teacher cache, frozen backbone, low-res student render, MSE) with a
   teacher that maps a rendered uint8 frame to a [h, w, D] map of
   language-aligned embeddings, L2-normalised here; the field's head is
   the samvit head at `ModelConfig(with_sam=True, sam_feat_dim=D)`.
2. `relevancy` scores a rendered embedding map against a text embedding
   with LERF's pairwise softmax (Kerr et al. 2023, eq. 2): the minimum
   over canonical negatives of softmax(phi.t / T, phi.neg_i / T), T = 0.1.
3. `text_query_mask` thresholds the relevancy map, or, given SAM and a
   SAM feature map, prompts SAM at the relevancy peak (the rendered-feature
   decode of the interactive frame) and returns SAM's mask.
4. Text encoders: `PrecomputedTextEncoder` reads an .npz vocabulary
   ({phrase: [D]}); `HFClipTextEncoder` a local HuggingFace CLIP
   checkpoint directory (`SANERF_CLIP_DIR`; transformers imported in its
   constructor).

    python -m sanerf_tpu_torch.apps.open_vocab <scene> --workspace W \\
        --vocab vocab.npz --phrase "a wooden chair" [--threshold 0.5]

renders each test view's embedding map from W's checkpoint (the proposal
nets and the field on the CUDA kernels; the D-wide samvit head in plain
ops) and writes `<i>_relevancy.npy` and `<i>_mask.npy`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sanerf_tpu_torch.train.distill import SamDistillTrainer
from sanerf_tpu_torch.utils.image import resize

#: LERF's canonical negatives: "relevant" means closer than any of these
CANONICAL_NEGATIVES = ("object", "things", "stuff", "texture")


class PrecomputedTextEncoder:
    """Text embeddings from an .npz vocabulary ({phrase: [D]}), looked up by
    the stripped, lower-cased phrase and L2-normalised."""

    def __init__(self, path: str):
        self.table = {k: np.asarray(v, np.float32)
                      for k, v in np.load(path).items()}

    def encode(self, phrases: Sequence[str]) -> np.ndarray:
        out = []
        for p in phrases:
            key = p.strip().lower()
            if key not in self.table:
                raise KeyError(
                    f"phrase {p!r} not in the precomputed vocabulary "
                    f"({len(self.table)} entries)")
            v = self.table[key]
            out.append(v / max(np.linalg.norm(v), 1e-8))
        return np.stack(out)


class HFClipTextEncoder:
    """CLIP's text tower from a local HuggingFace checkpoint directory
    (`model_dir` or SANERF_CLIP_DIR), on the CPU."""

    def __init__(self, model_dir: Optional[str] = None):
        model_dir = model_dir or os.environ.get("SANERF_CLIP_DIR")
        if not model_dir or not os.path.isdir(model_dir):
            raise FileNotFoundError(
                "no local CLIP checkpoint (set SANERF_CLIP_DIR)")
        from transformers import CLIPTextModelWithProjection, CLIPTokenizer

        self.tok = CLIPTokenizer.from_pretrained(model_dir)
        self.model = CLIPTextModelWithProjection.from_pretrained(model_dir)

    def encode(self, phrases: Sequence[str]) -> np.ndarray:
        with torch.no_grad():
            toks = self.tok(list(phrases), padding=True, return_tensors="pt")
            emb = self.model(**toks).text_embeds
            emb = emb / emb.norm(dim=-1, keepdim=True)
        return emb.cpu().numpy().astype(np.float32)


def relevancy(feats, text, negatives, temperature: float = 0.1
              ) -> torch.Tensor:
    """feats [..., D] (normalised here), text [D], negatives [K, D] ->
    [...] in (0, 1); above 0.5 means closer to the text than to every
    negative."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    text = torch.as_tensor(text, dtype=torch.float32, device=feats.device)
    negatives = torch.as_tensor(negatives, dtype=torch.float32,
                                device=feats.device)
    f = feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True),
                            min=1e-8)
    pos = torch.exp((f @ text)[..., None] / temperature)  # [..., 1]
    neg = torch.exp((f @ negatives.T) / temperature)  # [..., K]
    return torch.min(pos / (pos + neg), dim=-1).values


def text_query_mask(feat_map, text, negatives, threshold: float = 0.5,
                    sam_predictor=None, samvit_map=None,
                    frame_hw: Optional[tuple] = None):
    """[H, W, D] embedding map and a text -> (mask [H, W] bool, relevancy
    [H, W] float32, peak (x, y)); with `sam_predictor` and a SAM feature
    map `samvit_map` [h, w, 256] of a `frame_hw` frame, the mask is SAM's
    for a point prompt at the peak."""
    rel_np = relevancy(feat_map, text, negatives).cpu().numpy().astype(
        np.float32)
    py, px = np.unravel_index(int(np.argmax(rel_np)), rel_np.shape)
    mask = rel_np > threshold
    if sam_predictor is not None and samvit_map is not None:
        H, W = frame_hw or rel_np.shape
        sx = W / rel_np.shape[1]
        sy = H / rel_np.shape[0]
        sam_predictor.set_features(samvit_map, H, W)
        sam_mask, _, _ = sam_predictor.predict(
            np.array([[px * sx, py * sy]], np.float32),
            np.array([1], np.int32))
        mask = np.asarray(sam_mask[0] if sam_mask.ndim == 3 else sam_mask)
    return mask, rel_np, (float(px), float(py))


class LangDistillTrainer(SamDistillTrainer):
    """Stage 2 with a language-embedding teacher (module docstring): its
    [h, w, D] maps L2-normalised, so the field lives on the unit sphere
    that cosine relevancy assumes."""

    def teacher_features(self, image_uint8: np.ndarray) -> torch.Tensor:
        feats = super().teacher_features(image_uint8)
        return feats / torch.clamp(
            torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-8)


def make_region_teacher(regions: Callable[[np.ndarray], np.ndarray],
                        vocabulary: np.ndarray, grid: int = 64):
    """A teacher for tests and demos: the frame resized nearest to grid^2,
    `regions(small) -> [grid, grid]` region ids, each pixel its region's
    row of `vocabulary` [R, D]."""

    def teacher(image_uint8: np.ndarray) -> np.ndarray:
        small = resize(np.ascontiguousarray(image_uint8), (grid, grid),
                       "nearest")
        return vocabulary[regions(small)]

    return teacher


def main(argv=None, device=None):
    """The offline query of the module docstring, on `device` (the CUDA
    card by default) -> the output directory."""
    from sanerf_tpu_torch.apps.main import build_parser, config_from_args
    from sanerf_tpu_torch.data.provider import SceneDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.models.renderer import run_rays
    from sanerf_tpu_torch.train.trainer import Trainer

    p = build_parser()
    p.add_argument("--vocab", required=True,
                   help=".npz phrase->embedding table (or set "
                        "SANERF_CLIP_DIR for a local HF CLIP)")
    p.add_argument("--phrase", required=True)
    p.add_argument("--negatives", nargs="*",
                   default=list(CANONICAL_NEGATIVES))
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    try:
        enc = HFClipTextEncoder()
    except FileNotFoundError:
        enc = PrecomputedTextEncoder(args.vocab)
    text = enc.encode([args.phrase])[0]
    negs = enc.encode(args.negatives)

    model = fields.make_model(cfg.model, cfg.render)
    trainer = Trainer("ngp", cfg, model, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=device)
    dev = trainer.device
    ds = SceneDataset(cfg, "test")
    out_dir = args.out_dir or os.path.join(cfg.workspace, "open_vocab")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for idx in range(len(ds)):
        batch = ds.collate_sam(rng, index=idx)
        with torch.no_grad():
            out = run_rays(model, trainer.eval_params(),
                           torch.as_tensor(batch["rays_o_lr"], device=dev),
                           torch.as_tensor(batch["rays_d_lr"], device=dev),
                           return_feats=True)
        fmap = out["samvit"].reshape(batch["h"], batch["w"], -1)
        mask, rel, _ = text_query_mask(
            fmap, torch.as_tensor(text, device=dev),
            torch.as_tensor(negs, device=dev), threshold=args.threshold)
        np.save(os.path.join(out_dir, f"{idx:04d}_relevancy.npy"), rel)
        np.save(os.path.join(out_dir, f"{idx:04d}_mask.npy"), mask)
    print(f"wrote {len(ds)} relevancy/mask pairs to {out_dir} "
          f"(phrase: {args.phrase!r})")
    return out_dir


if __name__ == "__main__":
    main()
