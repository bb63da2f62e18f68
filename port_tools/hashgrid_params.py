"""Seeded float32 parameters of a hash-grid model, made with numpy alone.

Both sides of the hash-grid reference check load the same weights from
here: `port_tools/jax_hashgrid_reference.py` (the JAX package, on the CPU)
and `chip_smoke.py` (the port, on the card). Neither JAX nor torch is
imported, so the card's machine can run it.

    flat = make_flat(shapes, seed=0)
    rays_o, rays_d = frame_rays(64)

`shapes` maps parameter paths (`grid`, `grid_mlp/0/w`, `prop/1/grid`,
`samvit_norm/w`, ...) to shapes; the result maps `params/<path>` to
arrays, drawn in sorted path order from one `np.random.default_rng(seed)`:
hash tables U(-TABLE_STD, TABLE_STD), large enough that densities and
features vary across a frame (the reference's U(-1e-4, 1e-4) init gives a
flat image); linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(nn.Linear's init); the LayerNorm scale 1 and shift 0. `frame_rays` gives
the rays of a square frame seen from the serving pose (the camera at
z = 2 looking down -z, 60 degree field of view), in the port's ray
convention (sanerf_tpu_torch/data/rays.py). `reference_state_dict` lays
such a dict out as the reference's `NeRFNetwork` state dict
(nerf/network.py:102-219), the input of a reference `.pth`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

TABLE_STD = 2.0
TABLES = ("grid", "s_grid", "m_grid")
SERVE_POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0],
                       [0, 0, 0, 1]], np.float32)


def make_flat(shapes: Dict[str, Tuple[int, ...]], seed: int = 0,
              table_std: float = TABLE_STD) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        leaf = path.rsplit("/", 1)[-1]
        if path in TABLES or path.endswith("/grid"):
            v = rng.uniform(-table_std, table_std, shape)
        elif path.startswith("samvit_norm/"):
            v = np.full(shape, 1.0 if leaf == "w" else 0.0)
        elif leaf in ("w", "b"):
            fan_in = shapes[path[:-1] + "w"][0]
            bound = 1.0 / np.sqrt(fan_in)
            v = rng.uniform(-bound, bound, shape)
        else:
            raise ValueError(f"no rule for parameter {path!r}")
        out["params/" + path] = v.astype(np.float32)
    return out


def frame_rays(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rays_o, rays_d) [size^2, 3] float32, scanline order."""
    f = np.float32(0.5 * size / np.tan(0.5 * np.deg2rad(60.0)))
    c = np.float32(size / 2)
    jj, ii = np.divmod(np.arange(size * size), size)
    i = ii.astype(np.float32) + np.float32(0.5)
    j = jj.astype(np.float32) + np.float32(0.5)
    dirs = np.stack([(i - c) / f, -(j - c) / f, -np.ones_like(i)], axis=-1)
    rays_d = (dirs @ SERVE_POSE[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(SERVE_POSE[:3, 3], rays_d.shape).astype(
        np.float32)
    return rays_o, rays_d


def reference_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`params/<path>` arrays of a hash-grid model (RGB heads, SAM head,
    default mask head) -> the reference's state-dict keys: tables as
    `*.embeddings`, linears as `*.net.<l>.weight` [out, in] (the
    transpose), the SAM head's LayerNorm as `samvit_mlp.1.*`."""
    out = {}
    for key, v in flat.items():
        parts = key[len("params/"):].split("/")
        head = parts[0]
        if parts[-1] == "grid" or head in TABLES:
            name = (f"prop_encoders.{parts[1]}" if head == "prop" else head)
            out[name + ".embeddings"] = v
        elif head == "samvit_norm":
            out[f"samvit_mlp.1.{'weight' if parts[1] == 'w' else 'bias'}"] = v
        else:
            mlp = {"prop": f"prop_mlp.{parts[1]}", "samvit_mlp": "samvit_mlp.0",
                   "mask_mlp": "mask_mlp.0"}.get(head, head)
            layer, leaf = parts[-2], parts[-1]
            out[f"{mlp}.net.{layer}.{'weight' if leaf == 'w' else 'bias'}"] = (
                np.ascontiguousarray(v.T) if leaf == "w" else v)
    return out
