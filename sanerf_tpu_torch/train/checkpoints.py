"""Checkpoints: flat-npz snapshots with rolling retention, the best-by-
metric file and the cross-stage partial load + freeze
(JAX: sanerf_tpu/train/checkpoints.py:31-179).

The format is the JAX package's, so that a checkpoint of either framework
loads into the other: one .npz whose keys are '/'-joined tree paths
(train/tree.py) under `params/` and `ema/`, plus `__meta__`, the bytes of
a JSON object {"step": int, "stats": {...}}. The optimizer's entries under
`opt/` are the port's own layout: `opt/count`, `opt/mu/<path>`,
`opt/nu/<path>` (train/state.py:AdamState; frozen leaves have none). A
JAX-written `opt/` (optax's nested state) matches none of those keys, so
the port restores the weights of such a file and starts its optimizer
fresh, and the JAX package does the same with the port's.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.models.fields import Params
from sanerf_tpu_torch.train.state import AdamState
from sanerf_tpu_torch.train.tree import leaves_with_paths, map_with_path


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{prefix + path: numpy array} of every leaf."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in leaves_with_paths(tree, prefix)}


def unflatten_like(template: Any, flat: Dict[str, np.ndarray],
                   prefix: str = "") -> Any:
    """`template` with each leaf whose path (under `prefix`) is in `flat`
    replaced by that array, reshaped to the leaf's shape, as a tensor of the
    leaf's type on its device; leaves not in `flat` are kept."""

    def leaf(path, t):
        v = flat.get(prefix + path)
        if v is None:
            return t
        return torch.tensor(np.asarray(v).reshape(tuple(t.shape)),
                            dtype=t.dtype, device=t.device)

    return map_with_path(leaf, template)


def _opt_flat(opt: AdamState) -> Dict[str, np.ndarray]:
    flat = {"opt/count": np.asarray(opt.count, np.int64)}
    flat.update(flatten_tree(opt.mu, "opt/mu/"))
    flat.update(flatten_tree(opt.nu, "opt/nu/"))
    return flat


class CheckpointManager:
    """A workspace's checkpoint directory with the reference's retention
    and resume modes (`latest | latest_model | best | scratch | <path>`)."""

    def __init__(self, workspace: str, name: str = "ngp", max_keep: int = 2):
        self.dir = os.path.join(workspace, "checkpoints")
        self.name = name
        self.max_keep = max_keep
        os.makedirs(self.dir, exist_ok=True)

    def save(self, step: int, params: Params,
             ema_params: Optional[Params] = None,
             opt_state: Optional[AdamState] = None,
             stats: Optional[Dict] = None, full: bool = True,
             best: bool = False) -> str:
        """Write params (and EMA, and with `full` the optimizer) at `step`;
        `best` writes <name>_best.npz, else <name>_step<step>.npz and drops
        all but the newest max_keep of those. -> the path."""
        flat = flatten_tree(params, "params/")
        if ema_params is not None:
            flat.update(flatten_tree(ema_params, "ema/"))
        if full and opt_state is not None:
            flat.update(_opt_flat(opt_state))
        meta = {"step": int(step), "stats": stats or {}}
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
        path = os.path.join(self.dir, f"{self.name}_best.npz" if best else
                            f"{self.name}_step{step:08d}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
        if not best:
            for old in self.list_checkpoints()[:-self.max_keep]:
                os.remove(old)
        return path

    def list_checkpoints(self):
        return sorted(glob(os.path.join(self.dir, f"{self.name}_step*.npz")))

    def resolve(self, mode: str = "latest") -> Optional[str]:
        if mode in ("latest", "latest_model"):
            ckpts = self.list_checkpoints()
            return ckpts[-1] if ckpts else None
        if mode == "best":
            best = os.path.join(self.dir, f"{self.name}_best.npz")
            if os.path.exists(best):
                return best
            ckpts = self.list_checkpoints()
            return ckpts[-1] if ckpts else None
        if mode == "scratch":
            return None
        return mode if os.path.exists(mode) else None

    @staticmethod
    def load_file(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        meta = {}
        if "__meta__" in flat:
            meta = json.loads(flat.pop("__meta__").tobytes().decode())
        return flat, meta

    def load(self, mode: str, params_template: Params,
             opt_template: Optional[AdamState] = None,
             model_only: bool = False):
        """-> (params, ema, opt_state or None, meta), or None when `mode`
        resolves to no file. A key the file lacks keeps the template's
        value (a non-strict load); the optimizer is restored only when the
        file holds the port's `opt/` layout."""
        path = self.resolve(mode)
        if path is None:
            return None
        flat, meta = self.load_file(path)
        params = unflatten_like(params_template, flat, "params/")
        ema = (unflatten_like(params_template, flat, "ema/")
               if any(k.startswith("ema/") for k in flat) else params)
        opt = None
        if (not model_only and opt_template is not None
                and "opt/count" in flat):
            opt = AdamState(int(flat["opt/count"]),
                            unflatten_like(opt_template.mu, flat, "opt/mu/"),
                            unflatten_like(opt_template.nu, flat, "opt/nu/"))
        return params, ema, opt, meta


def load_partial_and_freeze(init_ckpt: str,
                            params: Params) -> Tuple[Params, Params]:
    """The stage handoff: every leaf of `params` that the checkpoint holds
    under `params/` is loaded and frozen. -> (merged params, trainable
    mask: False exactly at the loaded leaves)."""
    flat, _ = CheckpointManager.load_file(init_ckpt)
    merged = unflatten_like(params, flat, "params/")
    trainable = map_with_path(lambda path, _: "params/" + path not in flat,
                              params)
    return merged, trainable
