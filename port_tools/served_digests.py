"""Digests and times of the asset's served bf16 kernel launches, for the
port in a given tree: holds a change to the kernels to the launches of
another commit bit for bit, and compares their times within one run.

    python3 port_tools/served_digests.py [TREE] [REPS]
    (needs a CUDA card)

TREE is the root of a checkout whose `sanerf_tpu_torch` is imported
(default: this one's), e.g. the parent commit unpacked under a directory
that .gitignore lists (`git archive HEAD~1 | tar -x -C build/parent`);
its kernels build into TREE/build/kernels. The script renders the 512^2
frame of `assets/serving_student` at the (32, 16) and (128, 64, 32)
hierarchies with bf16 params through `render_frame`, records every launch
of ray_level0, ray_level, run_tmlp and run_tmlp_composite, and relaunches
each: the SHA-256 of its outputs' bytes, and its time as the mean of REPS
launches (default 20) queued behind a sleep kernel (CUDA events). Prints
one JSON line: the card, the tree, {hierarchy: [{kernel, digest, ms}]}
in launch order, and one digest of them all. chip_smoke.py holds the
digests against SERVED_DIGESTS.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("ray_level0", "ray_level", "run_tmlp", "run_tmlp_composite")
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}
SIZE = 512
SERVE_POSE = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]


def digest(outs) -> str:
    """SHA-256 of the bytes of a launch's outputs, in order."""
    import torch

    h = hashlib.sha256()
    for t in outs if isinstance(outs, tuple) else (outs,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def served_launches(root: str, reps: int = 20, dev=None) -> dict:
    """{hierarchy: [{kernel, digest, ms}]} of the port at `root` (its
    sanerf_tpu_torch imported; only one port can be imported a process);
    reps = 0: digests only."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, root)
    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    dev = dev or torch.device("cuda")
    kern = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
            "run_tmlp": fm.run_tmlp,
            "run_tmlp_composite": fm.run_tmlp_composite}
    owner = {"ray_level0": renderer, "ray_level": renderer,
             "run_tmlp": fields, "run_tmlp_composite": fields}
    mc, rc, p32 = load_asset(os.path.join(root, "assets", "serving_student"),
                             device=dev)
    params = fields.cast_params(p32, torch.bfloat16)
    focal = fov_to_focal(60.0, SIZE)
    rays_o, rays_d = full_frame_rays(
        np.asarray(SERVE_POSE, np.float32),
        np.asarray([focal, focal, SIZE / 2, SIZE / 2], np.float32), SIZE,
        SIZE, device=dev)

    @contextlib.contextmanager
    def spying(calls):
        def spy(name, fn):
            def wrapped(*a, **k):
                calls.append((name, a, k))
                return fn(*a, **k)
            return wrapped
        for n, m in owner.items():
            setattr(m, n, spy(n, kern[n]))
        try:
            yield
        finally:
            for n, m in owner.items():
                setattr(m, n, kern[n])

    def mean_ms(fn):
        sys.path.insert(0, HERE)
        from chip_smoke import backlog

        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        backlog(0.5 * reps)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    out = {}
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE))
        nets = fields.KernelNets(model, params)
        calls = []
        with spying(calls):
            renderer.render_frame(model, params, rays_o, rays_d,
                                  chunk=SIZE * SIZE, nets=nets)
        torch.cuda.synchronize()
        rows = []
        for name, a, k in calls:
            got = kern[name](*a, **k)
            torch.cuda.synchronize()
            rows.append({"kernel": name, "digest": digest(got),
                         "ms": (mean_ms(lambda: kern[name](*a, **k))
                                if reps else None)})
        out[h] = rows
        del calls
        torch.cuda.empty_cache()
    return out


def main():
    import torch

    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    if not torch.cuda.is_available():
        sys.exit("served_digests: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    launches = served_launches(root, reps)
    whole = hashlib.sha256(json.dumps(
        {h: [r["digest"] for r in rows] for h, rows in launches.items()},
        sort_keys=True).encode()).hexdigest()
    print(json.dumps({"card": card, "tree": root, "reps": reps,
                      "launches": launches, "digest": whole}))


if __name__ == "__main__":
    main()
