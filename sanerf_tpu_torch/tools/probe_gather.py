"""Hash-table gather throughput probes on the CUDA card (JAX:
tools/probe_gather.py).

Every formulation of the per-point table gather the instant-ngp hash
encoder needs, as the TPU tool measured them: its seven XLA formulations
run here as the PyTorch call each names (`index_select`, advanced
indexing, `take` on the flat table), and its eight Pallas kernels as
launches of the port's gather kernel (`ops/gather.py:gather_rows`,
`csrc/gather.cu`), each with its own semantics: `p2_take` gives rows of
zeros for indices outside the table, `pallas_take_small` reads
`table[:4096][idx % 4096]` of the 128-wide table, `p_blk` copies 8-row
blocks. A table of 2^19 rows, 2^21 int32 indices, C = 2, 8 and 128.

Two of the TPU kernels cannot run as written (`pallas_take_small` passes
its operands in the reverse order of its in_specs; `p_blk` reads a 1-D
index as `i[:n, 0]`), and the `p_*` kernels take an index of shape
[M, 1]: these probes compute their evident intent. Each kernel probe is
checked bit for bit against its plain version (`p2_take`'s on indices of
which some lie outside the table) before it is timed. The times are
CUDA-event medians of `--reps` launches queued behind a sleep kernel,
the card's time; the TPU tool's relay correction has no counterpart.

    python -m sanerf_tpu_torch.tools.probe_gather [--reps 21]

About 20 s on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.ops.gather import gather_rows
from sanerf_tpu_torch.tools import queued_ms

T = 2 ** 19          # table rows (reference RGB grid level size)
M = 2 ** 21          # lookups per call (2M)
C = 2                # channels
BLK = 2 ** 15        # lookups per grid step of the TPU kernels
SMALL = 4096         # pallas_take_small's table rows


@dataclasses.dataclass
class Probe:
    """One formulation: `fn` the call timed; a kernel probe's `plain` its
    plain version (on `check_args`, else the probe's own inputs); `rows`
    the rows one call moves (M, or M / 8 blocks for p_blk)."""

    name: str                 # the JAX tool's function or printed name
    label: str                # the JAX tool's printed line
    fn: Callable[..., torch.Tensor]
    args: tuple
    rows: int
    plain: Optional[Callable[..., torch.Tensor]] = None
    check_args: Optional[tuple] = None
    replaces: str = ""

    @property
    def kernel(self) -> bool:
        return self.plain is not None


def operands(device, t: int = T, m: int = M, c: int = C, seed: int = 0
             ) -> Dict[str, torch.Tensor]:
    """The seeded tables ([t, c], [t, 8], [t, 128] float32 normal draws)
    and indices (int32 uniform in [0, t))."""
    g = torch.Generator().manual_seed(seed)
    ops = {"table": torch.randn(t, c, generator=g),
           "table8": torch.randn(t, 8, generator=g),
           "table128": torch.randn(t, 128, generator=g),
           "idx": torch.randint(0, t, (m,), generator=g, dtype=torch.int32)}
    return {k: v.to(device) for k, v in ops.items()}


def with_outside(idx: torch.Tensor, t: int) -> torch.Tensor:
    """idx with every 16th index -1 and every 16th from the 8th t + 5:
    p2_take's check of its fill."""
    out = idx.clone()
    out[::16] = -1
    out[8::16] = t + 5
    return out


# -- the plain versions of the kernel probes ---------------------------------

def rows_plain(tab: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """tab[i] (every index inside the table)."""
    return tab[i.long()]


def fill_plain(tab: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """tab[i], rows of zeros for an index outside the table (jnp.take's
    mode="fill", fill_value=0)."""
    i = i.long()
    ok = (i >= 0) & (i < tab.shape[0])
    rows = tab[torch.where(ok, i, torch.zeros_like(i))]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def small_plain(tab: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """tab[:SMALL][i % SMALL]."""
    return tab[:SMALL][i.long() % SMALL]


def blk_plain(tab: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """The 8-row blocks i[:M/8] // 8 of tab, one after another: [M, C]."""
    m, c = i.shape[0], tab.shape[1]
    si = i[:m // 8].long() // 8
    return tab.reshape(-1, 8 * c)[si].reshape(m, c)


# -- the kernel probes -------------------------------------------------------

def dynloop(tab: torch.Tensor, i: torch.Tensor, blk: int = BLK):
    """pallas_dynloop / _vmem / pallas_take: [M / BLK, BLK, C]."""
    return gather_rows(tab, i.reshape(-1, blk))


def take_small(tab: torch.Tensor, i: torch.Tensor, blk: int = BLK):
    """pallas_take_small: [M / BLK, BLK, 128] of tab[:SMALL][i % SMALL]
    (the modulus taken in the call, as the TPU tool's jitted function
    does)."""
    return gather_rows(tab[:SMALL], torch.remainder(i, SMALL).reshape(-1, blk))


def loop(tab: torch.Tensor, i: torch.Tensor):
    """p_loop / p2_take / p_loop8: [M, C] (zeros outside the table)."""
    return gather_rows(tab, i)


def blocks(tab: torch.Tensor, i: torch.Tensor):
    """p_blk: [M, C] of 8-row blocks (the block indices i[:M/8] // 8
    taken in the call)."""
    m, c = i.shape[0], tab.shape[1]
    return gather_rows(tab, torch.div(i[:m // 8], 8, rounding_mode="floor"),
                       block_rows=8).reshape(m, c)


def probes(ops: Dict[str, torch.Tensor], blk: int = BLK) -> List[Probe]:
    """The fifteen probes in the JAX tool's order."""
    tab, tab8, tab128, idx = (ops[k] for k in ("table", "table8",
                                               "table128", "idx"))
    t, m = tab.shape[0], idx.shape[0]
    srt = torch.sort(idx).values
    c = tab.shape[1]
    P = Probe
    out = [
        P("xla_take", f"xla take [2^19,{c}]",
          lambda a, i: torch.index_select(a, 0, i), (tab, idx), m),
        P("xla_index", f"xla index [2^19,{c}]", lambda a, i: a[i],
          (tab, idx), m),
        P("xla_take_unsafe", f"xla take unsafe [2^19,{c}]", fill_plain,
          (tab, idx), m),
        P("xla_take8", "xla take [2^19,8]",
          lambda a, i: torch.index_select(a, 0, i), (tab8, idx), m),
        P("xla_take128", "xla take [2^19,128]",
          lambda a, i: torch.index_select(a, 0, i), (tab128, idx), m),
        P("xla_take_sorted", "xla take sorted idx",
          lambda a, i: torch.index_select(a, 0, i), (tab, srt), m),
        P("xla_flat", f"xla flat [2^19*{c}] x2",
          lambda a, i: torch.take(a, torch.stack([2 * i, 2 * i + 1], -1)),
          (tab, idx.long()), m),
    ]
    kern = [
        ("pallas_dynloop", "pallas dynslice loop (ANY tab)", 90,
         lambda a, i: dynloop(a, i, blk), tab,
         lambda a, i: rows_plain(a, i).reshape(-1, blk, a.shape[1])),
        ("pallas_dynloop_vmem", "pallas dynslice loop (VMEM tab)", 109,
         lambda a, i: dynloop(a, i, blk), tab,
         lambda a, i: rows_plain(a, i).reshape(-1, blk, a.shape[1])),
        ("pallas_take", "pallas jnp.take (VMEM tab 2^19)", 125,
         lambda a, i: dynloop(a, i, blk), tab,
         lambda a, i: rows_plain(a, i).reshape(-1, blk, a.shape[1])),
        ("pallas_take_small", "pallas jnp.take (VMEM tab 4096x128)", 142,
         lambda a, i: take_small(a, i, blk), tab128,
         lambda a, i: small_plain(a, i).reshape(-1, blk, a.shape[1])),
        ("p_loop", "pallas dynslice loop (VMEM tab)", 185, loop, tab,
         rows_plain),
        ("p_loop8", "pallas dynslice loop unroll8", 226, loop, tab,
         rows_plain),
        ("p2_take", "pallas jnp.take vector (VMEM tab)", 202, loop, tab,
         fill_plain),
        ("p_blk", "pallas prefetch row-block (8 rows)", 244, blocks, tab,
         blk_plain),
    ]
    for name, label, line, fn, a, plain in kern:
        out.append(P(name, label, fn, (a, idx),
                     m // 8 if name == "p_blk" else m, plain=plain,
                     check_args=((a, with_outside(idx, t))
                                 if name == "p2_take" else None),
                     replaces=f"tools/probe_gather.py:{line}"))
    return out


def check(p: Probe) -> bool:
    """A kernel probe bit for bit against its plain version."""
    args = p.check_args or p.args
    got, ref = p.fn(*args), p.plain(*args)
    return (got.shape == ref.shape and got.dtype == ref.dtype
            and torch.equal(got, ref))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=21,
                    help="launches whose median times each probe")
    return ap


def main(argv=None, *, device=None) -> List[Dict]:
    """-> one record a probe (name, ms, M rows/s, bit_exact, launches of
    gather_rows); raises if a kernel probe differs from its plain
    version."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    ops = operands(dev)
    rows = []
    for p in probes(ops):
        rec = {"name": p.name, "label": p.label, "rows": p.rows,
               "kernel": p.kernel, "replaces": p.replaces}
        if p.kernel:
            rec["bit_exact"] = check(p)
            if not rec["bit_exact"]:
                raise RuntimeError(f"probe_gather: {p.name} differs from "
                                   f"its plain version")
        before = gather_rows.launches
        if dev.type == "cuda":
            ms = queued_ms(lambda: p.fn(*p.args), args.reps)
            rec["ms"] = ms
            rec["m_rows_per_s"] = p.rows / (ms * 1e-3) / 1e6
            rec["launches"] = gather_rows.launches - before
            print(f"{p.label:40s} {ms:8.4f} ms  {rec['m_rows_per_s']:10.1f} "
                  f"M rows/s" + ("  (bit for bit)" if p.kernel else ""),
                  flush=True)
        else:  # no card: the plain versions, untimed
            p.fn(*p.args)
            print(f"{p.label:40s} (cpu, not timed)"
                  + ("  (bit for bit)" if p.kernel else ""), flush=True)
        rows.append(rec)
    return rows


if __name__ == "__main__":
    main()
