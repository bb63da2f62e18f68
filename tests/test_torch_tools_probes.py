"""The port's probes of the kernels (sanerf_tpu_torch/tools/hw_parity.py,
probe_gather.py, kbench.py) against the JAX tools (tools/hw_parity.py,
tools/probe_gather.py, tools/kbench.py), on the CPU at small sizes:

- hw_parity's SHAPES are the JAX tool's, and the serving shape's fast
  path renders JAX's `run_rays` (Pallas in interpret mode) within 2e-3 on
  the same weights (carried across by models/asset.py:params_from_jax);
  the tool's parity run on the CPU passes every shape;
- each probe_gather probe equals its JAX formulation: the seven XLA
  lambdas and four of the Pallas kernels (p_loop, p2_take, p_loop8,
  p_blk) run from the JAX tool's own source in interpret mode (their
  index as [M, 1], as their BlockSpecs read it); pallas_dynloop,
  pallas_dynloop_vmem, pallas_take and pallas_take_small cannot run as
  written in interpret mode (their stores and in_specs do not match
  their operands) and are held against the numpy functions of PERF.md
  rows 7-14 instead: table[idx] in BLK blocks, and table[:4096][idx % 4096];
- kbench's variants on the plain route equal JAX's run_tmlp_composite /
  run_tmlp on the same operands within the JAX suite's bf16 bound, 0.05.
"""

import argparse
import ast
import dataclasses
import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.config import config_from_dict as jcfd
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.tools import hw_parity, kbench, probe_gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the fast path against JAX's run_rays (tests/test_ray_kernels.py:74-148)
PATH_TOL = 2e-3
#: bf16 kernels against their reference (tests/test_fused_mlp_t.py)
BF16_TOL = 0.05


def _jax_tool(name):
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- hw_parity -----------------------------------------------------------------

def test_hw_parity_shapes_are_the_jax_tools():
    assert hw_parity.SHAPES == _jax_tool("hw_parity").SHAPES


def test_hw_parity_flags_are_the_jax_tools():
    """The JAX tool builds its parser inside main: its flags are read from
    its source, the port's from build_parser."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "hw_parity.py")).read())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            want[node.args[0].value] = kw.get("default", kw.get("action"))
    got = {}
    for a in hw_parity.build_parser()._actions:
        if a.option_strings:
            flag = a.option_strings[0]
            got[flag] = ("store_true"
                         if isinstance(a, argparse._StoreTrueAction)
                         else a.default)
    got.pop("-h")
    assert got == want


def test_hw_parity_serving_fast_path_matches_jax():
    """The serving shape at (32, 24) on 32 of the tool's rays: the port's
    fast path against JAX's (cp_fused, Pallas in interpret mode) on the
    same weights, within PATH_TOL."""
    mc, rc, _ = hw_parity.configs("serving", (32, 24))
    tm = fields.make_model(mc, rc)
    jm = jfields.make_model(jcfd(JModelConfig, dataclasses.asdict(mc)),
                            jcfd(JRenderConfig, dataclasses.asdict(rc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    assert renderer.uses_kernels(tm)
    o, d = hw_parity.rays(32, "cpu")
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()))
    got = renderer.run_rays(tm, tp, o, d)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=PATH_TOL, atol=PATH_TOL, err_msg=k)


def test_hw_parity_passes_on_the_cpu(capsys, monkeypatch):
    """Every shape agrees (plain versions on both sides), one line a
    shape with its launches, exit code 0; with --packed --flatten too.
    The kernel counters are the caller's: the tool reads them and never
    sets them (chip_smoke counts each step's launches around it)."""
    for c in hw_parity.COUNTERS.values():
        monkeypatch.setattr(c, "launches", 7)
    for extra in ([], ["--packed", "--flatten"]):
        assert hw_parity.main(["--rays", "48", "--steps", "8,4", *extra],
                              device="cpu") == 0
        out = capsys.readouterr().out
        for name in hw_parity.SHAPES:
            assert f"{name:12s} OK " in out
        assert set(hw_parity.main.results) == set(hw_parity.SHAPES)
        assert all(r["fast_path"] for r in hw_parity.main.results.values())
        assert "launches ray_level0=0" in out  # no kernel on the CPU
        assert all(c.launches == 7 for c in hw_parity.COUNTERS.values())


def test_hw_parity_errors_are_the_jax_tools():
    """Max abs errors, depth relative to the plain depth's max."""
    fast = {"image": torch.tensor([[0.5, 0.2]]),
            "depth": torch.tensor([2.0, 4.0]),
            "weights_sum": torch.tensor([1.0, 0.0])}
    slow = {"image": torch.tensor([[0.4, 0.2]]),
            "depth": torch.tensor([2.0, 3.0]),
            "weights_sum": torch.tensor([1.0, 0.25])}
    e = hw_parity.errors(fast, slow)
    assert e["image"] == pytest.approx(0.1)
    assert e["depth"] == pytest.approx(1.0 / 3.0)
    assert e["weights_sum"] == pytest.approx(0.25)


# -- probe_gather --------------------------------------------------------------

#: the small sizes the JAX tool's source is rebound to
SMALL = dict(T=8192, M=8192, C=2, BLK=512)


@pytest.fixture(scope="module")
def jax_probes():
    """The JAX tool's function definitions and its module-level bench
    lambdas, read from its source with ast (the tool runs its probes at
    import), T / M / C / BLK rebound small and pallas_call in interpret
    mode."""
    src = open(os.path.join(ROOT, "tools", "probe_gather.py")).read()
    tree = ast.parse(src)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("bench")]
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(jax=jax, jnp=jnp, pl=shim, pltpu=pltpu, **SMALL)
    exec(compile(ast.Module(body=defs, type_ignores=[]), "probe_gather",
                 "exec"), ns)
    lambdas = []
    for node in tree.body:
        call = getattr(node, "value", None)
        if (isinstance(node, ast.Expr) and isinstance(call, ast.Call)
                and getattr(call.func, "id", "") == "bench"
                and isinstance(call.args[1], ast.Lambda)):
            fn = eval(compile(ast.Expression(call.args[1]), "probe_gather",
                              "eval"), ns)
            lambdas.append((call.args[0].value, fn,
                            [ast.unparse(a) for a in call.args[2:]]))
    return ns, lambdas


@pytest.fixture(scope="module")
def small_ops():
    ops = probe_gather.operands("cpu", t=SMALL["T"], m=SMALL["M"],
                                c=SMALL["C"])
    probes = {p.name: p for p in probe_gather.probes(ops, blk=SMALL["BLK"])}
    jops = {k: jnp.asarray(v.numpy()) for k, v in ops.items()}
    return ops, probes, jops


def test_probe_gather_has_the_jax_tools_probes(jax_probes, small_ops):
    """Seven XLA formulations, then the eight Pallas kernels, in the JAX
    tool's order, with its printed labels (C = 2 in the labels' 2^19,C)."""
    _, lambdas = jax_probes
    _, probes, _ = small_ops
    names = list(probes)
    assert [p.label for p in list(probes.values())[:7]] == [
        label for label, _, _ in lambdas]
    assert names[7:] == ["pallas_dynloop", "pallas_dynloop_vmem",
                         "pallas_take", "pallas_take_small", "p_loop",
                         "p_loop8", "p2_take", "p_blk"]
    assert all(p.kernel for p in list(probes.values())[7:])
    assert not any(p.kernel for p in list(probes.values())[:7])


def test_probe_gather_xla_probes_equal_the_jax_lambdas(jax_probes,
                                                       small_ops):
    """Each XLA formulation's PyTorch call gives the JAX lambda's output
    on the same table and indices (a gather: bit for bit)."""
    _, lambdas = jax_probes
    _, probes, jops = small_ops
    env = dict(table=jops["table"], table8=jops["table8"],
               table128=jops["table128"], idx=jops["idx"], jnp=jnp)
    for (label, fn, args), p in zip(lambdas, list(probes.values())[:7]):
        want = np.asarray(fn(*[eval(a, env) for a in args]))
        got = p.fn(*p.args).numpy()
        assert got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("name", ["p_loop", "p2_take", "p_loop8", "p_blk"])
def test_probe_gather_kernel_probes_equal_interpret_mode(jax_probes,
                                                         small_ops, name):
    """The four probes that run in interpret mode (index [M, 1]): the
    port's probe, on the CPU its plain version, equals JAX's bit for
    bit."""
    ns, _ = jax_probes
    ops, probes, jops = small_ops
    want = np.asarray(ns[name](jops["table"], jops["idx"][:, None]))
    p = probes[name]
    np.testing.assert_array_equal(p.fn(*p.args).numpy(), want)
    assert probe_gather.check(p)


@pytest.mark.parametrize("name", ["pallas_dynloop", "pallas_dynloop_vmem",
                                  "pallas_take", "pallas_take_small"])
def test_probe_gather_kernel_probes_equal_numpy(small_ops, name):
    """The four probes whose TPU kernels do not run as written, against
    the numpy function of PERF.md rows 7-14: table[idx] in blocks of BLK
    rows, and table128[:4096][idx % 4096]."""
    ops, probes, _ = small_ops
    idx = ops["idx"].numpy()
    if name == "pallas_take_small":
        want = ops["table128"].numpy()[:4096][idx % 4096]
    else:
        want = ops["table"].numpy()[idx]
    want = want.reshape(-1, SMALL["BLK"], want.shape[-1])
    p = probes[name]
    np.testing.assert_array_equal(p.fn(*p.args).numpy(), want)
    assert probe_gather.check(p)


def test_probe_gather_fill_and_blocks(small_ops):
    """p2_take's check runs on indices of which some lie outside the
    table: rows of zeros there; p_blk moves M / 8 blocks of 8 rows."""
    ops, probes, _ = small_ops
    p = probes["p2_take"]
    out = p.fn(*p.check_args)
    assert not out[::16].any() and not out[8::16].any()
    assert out[1::16].abs().sum() > 0
    assert probes["p_blk"].rows == SMALL["M"] // 8
    assert probes["pallas_dynloop"].replaces == "tools/probe_gather.py:90"
    assert probes["p_blk"].replaces == "tools/probe_gather.py:244"


def test_probe_gather_runs_on_the_cpu(capsys, monkeypatch):
    """main() at small sizes on the CPU: every kernel probe bit for bit,
    nothing timed."""
    for k, v in SMALL.items():
        monkeypatch.setattr(probe_gather, k, v)
    real = probe_gather.operands
    monkeypatch.setattr(probe_gather, "operands", lambda dev: real(
        dev, t=SMALL["T"], m=SMALL["M"], c=SMALL["C"]))
    monkeypatch.setattr(probe_gather, "probes",
                        functools.partial(probe_gather.probes,
                                          blk=SMALL["BLK"]))
    rows = probe_gather.main([], device="cpu")
    assert len(rows) == 15
    assert all(r["bit_exact"] for r in rows if r["kernel"])
    assert "not timed" in capsys.readouterr().out


# -- kbench --------------------------------------------------------------------

def _kbench_args(**kw):
    args = kbench.build_parser().parse_args(["--rays", "48", "--t", "8"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_kbench_flags_are_the_jax_tools():
    tree = ast.parse(open(os.path.join(ROOT, "tools", "kbench.py")).read())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            d = kw["default"]
            want[node.args[0].value] = (eval(ast.unparse(d))
                                        if not isinstance(d, ast.Constant)
                                        else d.value)
    got = {a.option_strings[0]: a.default
           for a in kbench.build_parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert got == want


@pytest.mark.parametrize("depth", [3, 4])
def test_kbench_variants_match_jax(depth):
    """Each variant's plain-route outputs (gsum, depth, weights_sum, rgb;
    tmlp_nocomp's rows) against JAX's kernels (interpret mode) on the
    same bf16 operands, within BF16_TOL. JAX's no-grid variants keep the
    decoder whose layer 0 takes the CP columns: the encoding there is
    zero-padded, which the port's field without those columns computes."""
    args = _kbench_args(depth=depth, width=32, cp=16, cp_res=32, sig=8)
    ops = kbench.operands(args, "cpu")
    got = {name: fn(*a) for name, (fn, a) in
           kbench.variants(ops, args).items()}
    def j(t):  # the same values as a JAX array of the same type
        return jnp.asarray(t.float().numpy(), jnp.bfloat16
                           if t.dtype == torch.bfloat16 else jnp.float32)

    layers = [{"w": j(p["w"])} for p in ops["layers"]]
    view = [{"w": j(p["w"])} for p in ops["view_layers"]]
    xT, dl, ts, r8 = (j(ops[k]) for k in ("xT", "dl", "ts", "rays8"))
    grids = dict(cp_lines=j(ops["cp_lines"]),
                 sigma_cp_lines=j(ops["sigma_cp_lines"]))
    common = dict(enc_freqs=args.freqs, bound=args.bound,
                  skip_layers=ops["skip"], leaky=True, opaque=True,
                  block=args.block, interpret=True)
    want = {
        "full(grids+view)": jfm.run_tmlp_composite(
            xT, dl, ts, layers, rays8=r8, view_layers=view, **grids,
            **common),
        "no_view(grids)": jfm.run_tmlp_composite(xT, dl, ts, layers,
                                                 **grids, **common),
        "no_grids(view)": jfm.run_tmlp_composite(
            xT, dl, ts, layers, rays8=r8, view_layers=view, **common),
        "mlp_only": jfm.run_tmlp_composite(xT, dl, ts, layers, **common),
    }
    for name, w in want.items():
        for g, r in zip(got[name], w):
            r = np.asarray(r, np.float32)
            np.testing.assert_allclose(g.float().numpy(), r, atol=BF16_TOL,
                                       rtol=BF16_TOL, err_msg=name)
    w = np.asarray(jfm.run_tmlp(xT, layers, args.freqs, args.bound,
                                skip_layers=ops["skip"], leaky=True,
                                block=args.block, transposed=True,
                                interpret=True, **grids), np.float32)
    g = got["tmlp_nocomp(grids)"].numpy()
    np.testing.assert_allclose(g, w[:g.shape[0]], atol=BF16_TOL,
                               rtol=BF16_TOL, err_msg="tmlp_nocomp")


def test_kbench_runs_on_the_cpu(capsys):
    """The JAX tool's rows, the block sweep saying the port takes no
    block, and its JSON line last."""
    rec = kbench.main(["--rays", "16", "--t", "4", "--width", "32",
                       "--cp", "16", "--cp_res", "32", "--sig", "8"],
                      device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    import json

    assert json.loads(out[-1]) == rec
    assert list(rec) == ["rays", "T", "full(grids+view)", "no_view(grids)",
                         "no_grids(view)", "mlp_only", "tmlp_nocomp(grids)",
                         "full@block2048", "full@block8192",
                         "full@block16384"]
    assert all("no block in the port's kernel" in line
               for line in out if line.startswith("full@block"))
