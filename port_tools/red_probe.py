"""The card's rate of vector atomic adds into a float32 table
(port_tools/red_probe.cu): G adds a second for pieces of 1, 2 and 4 floats
at pseudo-random rows of a 4 MB table (L2-resident, few adds a row at a
time) and of a 64 KB one (4,096 rows: many adds on each row, as at the
hash grid's coarse levels). Used by chip_smoke.py's phase T3 and
port_tools/hash_backward_variants.py for the time a scatter-add's adds
take at that rate; needs a CUDA card.

    from red_probe import rates; rates(torch.device("cuda"))
"""

import ctypes
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: (rows_log2, name) of the tables: rows of 16 bytes
TABLES = ((18, "4 MB"), (12, "64 KB"))


def rates(dev, reps=10, iters=64):
    """{table: {"f32": G adds/s, "f32x2": ..., "f32x4": ...}}: medians of
    5 timings of `reps` launches of 8 blocks an SM x 256 threads x `iters`
    adds, CUDA events around them."""
    import sys

    import torch

    sys.path.insert(0, str(ROOT))
    from sanerf_tpu_torch.ops import _build

    out, job = _build._start("red_probe", ROOT / "port_tools",
                             ROOT / "build" / "variants" / "red_probe")
    _build._finish("red_probe", out, job)
    lib = ctypes.CDLL(str(out))
    lib.red_probe.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.red_probe.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    threads = 256
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rows_log2, name in TABLES:
        table = torch.zeros((1 << rows_log2) * 4, device=dev)
        for width, key in ((1, "f32"), (2, "f32x2"), (4, "f32x4")):
            def launch():
                code = lib.red_probe(table.data_ptr(), rows_log2, iters,
                                     width, blocks, threads, stream)
                if code:
                    raise RuntimeError(f"red_probe: CUDA error {code}")
            for _ in range(3):
                launch()
            ts = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize()
                a.record()
                for _ in range(reps):
                    launch()
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b) / reps)
            res.setdefault(name, {})[key] = (
                blocks * threads * iters / statistics.median(ts) / 1e6)
        del table
    res["card"] = torch.cuda.get_device_name(dev)
    return res
