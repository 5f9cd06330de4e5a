"""Stage attribution: the port of the JAX package's four attribution tools
(``tools/attr.py``, ``tools/swinattr.py``, ``tools/encattr.py`` and
``tools/membench.py``) as the four subcommands of one tool.

    python -m codetr_torch.tools.attr model [height width] [--iters 5 --trials 6]
        [--verify] [--trace DIR]
    python -m codetr_torch.tools.attr swin [--height 1920 --width 1280]
        [--stages 0 1 2 3] [--skip-features] [--iters 5 --trials 5]
    python -m codetr_torch.tools.attr encoder [height width] [--iters 10 --trials 6]
        [--only vp ...] [--verify] [--trace DIR]
    python -m codetr_torch.tools.attr mem [--height 1920 --width 1280]
        [--iters 20 --trials 5] [--only scale ...]

each also with ``--device cuda`` (the default; raises without a card, as
``models.codetr.check_device`` does; ``cpu`` for the tests), ``--dtype
bfloat16`` (the JAX tools' dtype; ``float32`` runs under
``models.codetr.fp32_scope``: full fp32, no TF32), ``--config swin-l``
(``config.CONFIGS``), ``--ceiling-tflops`` and ``--ceiling-gbs``.  Note the
order of the positional size: ``height width``, whose defaults (1920 1280)
are the JAX tools' portrait image.

Stages:

- ``model``: ``features`` (backbone + neck), ``detect`` (the head) and
  ``full`` of the config's model (``build_codetr``, seed 0) on a zero
  image; the summary's ``table`` has the JAX keys and its ``derived``
  record ``head_minus_features_ms`` (full - features) beside
  ``features_plus_detect_over_full``.
- ``swin``: ``features``, then for each stage i of ``--stages`` at the JAX
  tool's shapes (``ceil(H/4) >> i`` by ``ceil(W/4) >> i``, ``embed_dims <<
  i`` channels; windows of the config's size): ``stage{i}-pair`` (two port
  ``SwinBlock``s, unshifted then shifted; ``scaled_ms`` = ms x depths[i] /
  2), ``wmsa{i}`` (one ``ShiftWindowMSA``, shift 0), ``ffn{i}``,
  ``part{i}`` (``window_partition`` then ``window_reverse`` on the padded
  map) and ``roll{i}`` (``torch.roll`` by -shift then +shift).
- ``encoder``: the first encoder layer's and decoder layer's modules of the
  config's model at the level shapes of ``height x width`` (widths, heads,
  levels, points, proposals and classes from the config): ``vp``
  (``project_value``), ``proj`` (sampling offsets and attention weights),
  ``coord`` (``packed_coords``), ``emsda`` (the whole encoder MSDA module on
  the encoder's own grid reference points: K1's encoder entry), ``outp``,
  ``ffn``, ``ln``, ``topk`` (top proposals over K), ``prop``
  (``CoDinoTransformer.select_proposals``), ``mha900`` (the decoder's
  self-attention over the proposals) and ``dmsda`` (the decoder's MSDA
  cross-attention: K1's decoder entry); ``dtab`` and ``dmsda_tab`` print
  an n/a record (the decoder corner table is not ported).
- ``mem``: memory-bound ops at (1, K, C): ``scale`` and ``scalef32`` (x *
  1.0000001 in the run's dtype and in fp32), ``lnflax`` (the model's
  ``nn.LayerNorm``), ``lnhand`` (a two-pass LayerNorm in fp32 math),
  ``lnaffine`` (with a scale and bias), ``dense`` (Linear C -> C) and
  ``add``, each with the JAX tool's traffic in MB and its GB/s.

Each stage is timed as ``make_loop_timer(graph=True)`` times a forward: on
the card warmed up, captured once in a CUDA graph and replayed ``--iters``
times between CUDA events, for ``--trials`` trials; on the CPU, eager calls
on the host clock.  Each record keeps the JAX keys ``stage`` and
``best_sane_ms`` (the fastest trial) and adds ``median_ms``, ``spread``
(slowest trial over fastest), its FLOPs (``utils.profiling.cost_analysis``,
counted on one eager call with autograd on and no parameter requiring a
gradient) and its bytes (each input, parameter, buffer and output read or
written once: a lower bound, counted by this tool), and ``floor_ms`` =
max(FLOPs / the GEMM ceiling, bytes / the copy ceiling) with
``x_over_floor`` = ``best_sane_ms`` / ``floor_ms`` and the ceiling that set
it.  The ceilings are measured in the same run unless given: the GEMM
ceiling is a 4096^3 ``torch.matmul`` in the run's dtype, replayed (fp32
under ``fp32_scope``: the SIMT rate the port's fp32 forward gets); the copy
ceiling is the ``scale`` op at the run's (1, K, C).  On the CPU the GEMM is
256^3 and every figure is a host one.

With ``--trace DIR`` each ``model`` and ``encoder`` stage gets a traced
replay (``utils.profiling.trace``, into ``DIR/<stage>``; two replays, the
figures per replay): the share of the span (first kernel's start to last
kernel's end) in which a kernel ran, the five kernels with the most time,
the time by kernel class (the port's kernels, GEMMs, LayerNorm, softmax,
reductions, copies, other elementwise) and the port's kernels by name
(``utils.profiling.PORT_KERNELS``); on the card only the kernels that the
graph launches started count, and a trace that lost some is taken again.  With ``--verify`` the encoder MSDA
module (K1's encoder entry, ``msda_packed_fwd``) and the decoder's
(``msda_fwd``) run once on the ``emsda`` and ``dmsda`` inputs and each
kernel's output is held against the plain version (``ops/msda.py:msda_plain``)
on the inputs the module gave it: fp32 within 1e-5 of the output's scale,
bf16 within 2^-7 of each element + 1e-5 of the scale.  The command exits 1
when a check fails; a kernel that does not build or launch raises.

The JAX tools' canary probes and their ``_perturb`` / ``_fold`` loop guards
are n/a: a chip call holds a dedicated card, and each replay of a captured
graph runs every kernel it recorded (``runtime/aot.py:make_loop_timer``).
The last JSON line of each subcommand is its summary: ``summary_best_sane_ms``,
the ceilings and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from codetr_torch.config import CONFIGS
from codetr_torch.models import msda_module
from codetr_torch.models.codetr import build_codetr, check_device, fp32_scope, init_module_weights
from codetr_torch.models.layers import FFN, LN_EPS
from codetr_torch.models.swin import ShiftWindowMSA, SwinBlock, window_partition, window_reverse
from codetr_torch.models.transformer import _layer_norm, get_reference_points
from codetr_torch.ops import msda
from codetr_torch.runtime.aot import DTYPES, make_loop_timer
from codetr_torch.tools.trainbench import card
from codetr_torch.utils.profiling import PORT_KERNELS, cost_analysis, trace

STRIDES = (4, 8, 16, 32, 64)
GEMM_N = 4096  # the GEMM ceiling's M = N = K on the card
CPU_GEMM_N = 256  # on the CPU: a host figure, kept small for the tests
DECTAB_NA = "n/a: ops/msda_dectab.py is not ported (ROADMAP §1 item 8)"
# the kernel entries --verify holds against the plain version: the stage,
# the module-level function its module calls, the plain version
VERIFIED = (("emsda", "msda_grid_packed", msda.msda_grid_packed_plain, "msda_packed_fwd (K1, encoder entry)"),
            ("dmsda", "multi_scale_deformable_attention", msda.multi_scale_deformable_attention_plain,
             "msda_fwd (K1, decoder entry)"))


@dataclass
class Stage:
    name: str
    fn: Callable
    args: tuple
    modules: tuple = ()  # whose parameters and buffers the stage reads
    scale: Optional[float] = None  # a Swin block pair: the stage's depth / 2
    traffic: Optional[int] = None  # the mem suite: the JAX tool's bytes


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="suite", required=True)
    defaults = {"model": (5, 6), "swin": (5, 5), "encoder": (10, 6), "mem": (20, 5)}
    for name, (iters, trials) in defaults.items():
        p = sub.add_parser(name)
        if name in ("model", "encoder"):
            p.add_argument("height", type=int, nargs="?", default=1920)
            p.add_argument("width", type=int, nargs="?", default=1280)
            p.add_argument("--verify", action="store_true",
                           help="hold the emsda and dmsda kernels against the plain version first")
            p.add_argument("--trace", default=None, metavar="DIR", help="a traced replay per stage into DIR")
        else:
            p.add_argument("--height", type=int, default=1920)
            p.add_argument("--width", type=int, default=1280)
        if name in ("encoder", "mem"):
            p.add_argument("--only", nargs="*", default=[])
        if name == "swin":
            p.add_argument("--stages", type=int, nargs="*", default=[0, 1, 2, 3])
            p.add_argument("--skip-features", action="store_true")
        p.add_argument("--iters", type=int, default=iters, help="replays between two events, per trial")
        p.add_argument("--trials", type=int, default=trials)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
        p.add_argument("--config", default="swin-l", choices=sorted(CONFIGS))
        p.add_argument("--ceiling-tflops", type=float, default=None,
                       help="GEMM ceiling to use instead of measuring it")
        p.add_argument("--ceiling-gbs", type=float, default=None,
                       help="copy ceiling (GB/s) to use instead of measuring it")
    ap.set_defaults(verify=False, trace=None, only=[], stages=[], skip_features=False)  # suites without them
    return ap.parse_args(argv)


class Context:
    """What every stage of a run shares: device, dtype, config, sizes and
    the ceilings."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = check_device(args.device)
        self.dtype = DTYPES[args.dtype]
        self.cfg = CONFIGS[args.config]()
        self.H, self.W = args.height, args.width
        tc = self.cfg.head.transformer
        self.C = tc.embed_dims
        self.shapes = level_shapes(self.H, self.W, tc.num_feature_levels)
        self.K = sum(hh * ww for hh, ww in self.shapes)
        self.ceilings = {"gemm": gemm_ceiling(self), "copy": copy_ceiling(self)}

    def shape_text(self) -> str:
        return f"{self.H}x{self.W} {self.args.dtype}"


def level_shapes(height: int, width: int, levels: int = len(STRIDES)):
    """The neck's level sizes: strides 4, 8, ..., each a ceiling."""
    return tuple((-(-height // s), -(-width // s)) for s in (4 << i for i in range(levels)))


def tensors(obj):
    """Every tensor in a nest of tuples, lists and dicts."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors(o)


def nbytes(obj) -> int:
    """The bytes of the distinct tensors in ``obj`` (one passed twice, as
    ``add``'s, is read once)."""
    seen = {(t.data_ptr(), t.numel(), t.dtype): t for t in tensors(obj)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def state_tensors(modules) -> list:
    """The parameters and buffers of ``modules``, each once."""
    seen = {}
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            seen[id(t)] = t
    return list(seen.values())


def count_flops(stage: Stage, dtype: torch.dtype) -> float:
    """``cost_analysis`` of one eager call, autograd on (its module tracker
    needs it) and no parameter requiring a gradient (nothing is saved)."""
    held = [p for m in stage.modules for p in m.parameters() if p.requires_grad]
    for p in held:
        p.requires_grad_(False)
    try:
        with torch.enable_grad(), fp32_scope(dtype):
            return cost_analysis(stage.fn, stage.args)["flops"]
    finally:
        for p in held:
            p.requires_grad_(True)


def timed(ctx: Context, fn, args, iters: int, trials: int, traced_dir: Optional[str] = None):
    """ms per call of each trial (``make_loop_timer``: a captured graph
    replayed between CUDA events on the card, eager calls on the host
    clock on the CPU) and, with ``traced_dir``, a traced replay.  The
    graph is dropped before returning."""
    on_card = ctx.device.type == "cuda"
    with torch.no_grad(), fp32_scope(ctx.dtype):
        run = make_loop_timer(fn, args, graph=on_card)
        per_trial = [run(iters) for _ in range(trials)]
        traced = traced_replay(run, traced_dir, on_card) if traced_dir else None
    del run
    return per_trial, traced


def union_us(spans) -> float:
    """The time covered by the union of (start, end) spans."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# kernel classes of a traced replay, by CUDA function name (first match)
KERNEL_CLASSES = (("port", "|".join(PORT_KERNELS)), ("gemm", r"nvjet|gemm|cutlass|xmma|cublas"),
                  ("norm", r"layer_norm"), ("softmax", r"softmax"), ("reduce", r"reduce_kernel|topk|radix|Scan|cub::"),
                  ("copy", r"copy|Cat|index|gather|roll"), ("elementwise", r"elementwise"))
TRACED_REPLAYS = 2  # replays per trace; its figures are per replay
TRACE_ATTEMPTS = 3


def replay_kernels(logdir: str, on_card: bool) -> list:
    """(start us, end us, name, correlation) of a trace's kernels; on the
    card only those that a graph launch started."""
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    launches = {e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in e.get("name", "")}
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["args"].get("correlation"))
            for e in events if e.get("cat") == "kernel" and "dur" in e
            and (not on_card or e.get("args", {}).get("correlation") in launches)]


def traced_replay(run, logdir: str, on_card: bool) -> dict:
    """``TRACED_REPLAYS`` replays under ``utils.profiling.trace``, their
    figures per replay: the kernel share of the replays' span, the five
    kernels with the most time, the time by kernel class, the port's
    kernels by name.  The profiler has been seen to drop some of a
    replay's kernel records, so a trace counts as complete when each
    graph launch shows the same number of kernels; an incomplete one is
    taken again, up to ``TRACE_ATTEMPTS`` times, and ``complete`` says
    whether the last was."""
    n = TRACED_REPLAYS
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with trace(logdir):
            run(n)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda._sleep(100_000)  # eager work after the replays, outside their launches
                torch.cuda.synchronize()
        kernels = replay_kernels(logdir, on_card)
        per_launch = collections.Counter(c for *_, c in kernels)
        complete = not on_card or (len(per_launch) == n and len(set(per_launch.values())) == 1)
        if complete:
            break
    base = {"trace": logdir, "replays": n, "attempts": attempt, "complete": complete}
    if not kernels:
        return {**base, "kernels": 0, "kernel_share": None, "top_kernels": [], "by_class_ms": {}, "port_kernels": {}}
    span = max(k[1] for k in kernels) - min(k[0] for k in kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_class = collections.Counter()
    for a, b, name, _ in kernels:
        by_name[name][0] += b - a
        by_name[name][1] += 1
        by_class[next((c for c, pat in KERNEL_CLASSES if re.search(pat, name)), "other")] += (b - a) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    port = {k: sum(c for name, (_, c) in by_name.items() if re.search(rf"\b{k}\b", name)) / n for k in PORT_KERNELS}
    return {**base, "kernels": len(kernels) / n, "span_ms": span / 1e3 / n,
            "kernel_share": union_us([(k[0], k[1]) for k in kernels]) / max(span, 1e-9),
            "top_kernels": [{"name": k, "ms": t / 1e3 / n, "calls": c / n} for k, (t, c) in top],
            "by_class_ms": dict(by_class.most_common()),
            "port_kernels": {k: v for k, v in port.items() if v}}


def floor_of(ctx: Context, flops: float, moved: int) -> dict:
    """The least time at the ceilings: FLOPs over the GEMM ceiling, bytes
    over the copy ceiling, the larger."""
    gemm, copy = ctx.ceilings["gemm"], ctx.ceilings["copy"]
    t_ops = flops / (gemm["tflops"] * 1e12) * 1e3
    t_bytes = moved / (copy["gbs"] * 1e9) * 1e3
    by_ops = t_ops >= t_bytes
    return {"floor_ms": max(t_ops, t_bytes), "flop_floor_ms": t_ops, "byte_floor_ms": t_bytes,
            "bound_by": "operations" if by_ops else "bytes",
            "ceiling": dict(gemm if by_ops else copy, name="gemm" if by_ops else "copy")}


def run_stage(ctx: Context, stage: Stage, iters: int, trials: int, trace_root: Optional[str] = None) -> dict:
    """Time one stage and set it against its floor; the record."""
    flops = count_flops(stage, ctx.dtype)
    with torch.no_grad(), fp32_scope(ctx.dtype):
        out = stage.fn(*stage.args)
    moved = nbytes((stage.args, state_tensors(stage.modules), out))
    del out
    per_trial, traced = timed(ctx, stage.fn, stage.args, iters, trials,
                              os.path.join(trace_root, stage.name) if trace_root else None)
    best = min(per_trial)
    floor = floor_of(ctx, flops, moved)
    rec = {"stage": stage.name, "best_sane_ms": best, "median_ms": statistics.median(per_trial),
           "spread": max(per_trial) / best, "ms_per_trial": per_trial, "gflop": flops / 1e9, "mb": moved / 1e6,
           **floor, "x_over_floor": best / floor["floor_ms"], "shape": ctx.shape_text()}
    if stage.scale is not None:
        rec["scaled_ms"] = best * stage.scale
    if stage.traffic is not None:
        rec["traffic_mb"] = stage.traffic / 1e6
        rec["eff_gb_s"] = stage.traffic / 1e9 / (best / 1e3)
    if traced is not None:
        rec["traced"] = traced
    print(json.dumps(rec), flush=True)
    return rec


def gemm_ceiling(ctx: Context) -> dict:
    args = ctx.args
    if args.ceiling_tflops is not None:
        return {"tflops": args.ceiling_tflops, "source": "given"}
    n = GEMM_N if ctx.device.type == "cuda" else CPU_GEMM_N
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn(n, n, generator=g).to(ctx.device, ctx.dtype) for _ in range(2))
    per_trial, _ = timed(ctx, torch.matmul, (a, b), max(args.iters, 10), max(args.trials, 3))
    return {"tflops": 2 * n**3 / (min(per_trial) / 1e3) / 1e12, "source": "measured",
            "op": f"torch.matmul {n}^3 {args.dtype}" + (", full fp32" if ctx.dtype == torch.float32 else "")}


def copy_ceiling(ctx: Context) -> dict:
    args = ctx.args
    if args.ceiling_gbs is not None:
        return {"gbs": args.ceiling_gbs, "source": "given"}
    x = torch.randn(1, ctx.K, ctx.C, generator=torch.Generator().manual_seed(0)).to(ctx.device, ctx.dtype)
    per_trial, _ = timed(ctx, scale_op, (x,), max(args.iters, 10), max(args.trials, 3))
    return {"gbs": 2 * nbytes(x) / (min(per_trial) / 1e3) / 1e9, "source": "measured",
            "op": f"scale (1, {ctx.K}, {ctx.C}) {args.dtype}"}


def scale_op(t):
    return t * 1.0000001


def seeded(module: nn.Module, seed: int) -> nn.Module:
    """A standalone module with ``init_weights``' draws from ``seed``."""
    init_module_weights(module, torch.Generator().manual_seed(seed))
    return module


def on(ctx: Context, a: np.ndarray, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(ctx.device, dtype or ctx.dtype)


def seeded_model(ctx: Context, model=None):
    return model if model is not None else build_codetr(ctx.cfg, dtype=ctx.dtype, device=ctx.device, seed=0)


# --- model: features, detect, full ---

def model_stages(ctx: Context, model) -> list:
    """The JAX ``tools/attr.py``'s stages on a zero image."""
    x = torch.zeros(1, ctx.H, ctx.W, 3, dtype=ctx.dtype, device=ctx.device)
    mask = torch.zeros(1, ctx.H, ctx.W, device=ctx.device)
    with torch.no_grad():
        feats = model.features(x)
    return [Stage("features", model.features, (x,), (model.backbone, model.neck)),
            Stage("detect", model.detect, (feats, mask), (model.query_head,)),
            Stage("full", model, (x, mask), (model,))]


def model_table(ctx: Context, recs: dict) -> dict:
    """The JAX tool's table (``floor_ms_at_ceiling``: the FLOP floor at
    the GEMM ceiling) with the derived record."""
    table = {n: {"best_sane_ms": r["best_sane_ms"], "gflops": r["gflop"],
                 "floor_ms_at_ceiling": r["flop_floor_ms"], "floor_ms": r["floor_ms"],
                 "x_over_floor": r["x_over_floor"]} for n, r in recs.items()}
    ms = {n: r["best_sane_ms"] for n, r in recs.items()}
    table["derived"] = {
        "head_minus_features_ms": ms["full"] - ms["features"] if {"full", "features"} <= set(ms) else None,
        "features_plus_detect_over_full": ((ms["features"] + ms["detect"]) / ms["full"]
                                           if {"full", "features", "detect"} <= set(ms) else None),
        "ceiling_tflops": ctx.ceilings["gemm"]["tflops"],
    }
    return table


# --- swin: features, and per stage a block pair, W-MSA, FFN, partition, roll ---

def swin_stage_shapes(height: int, width: int, sc):
    """Per Swin stage (Hs, Ws, C) as the JAX tool takes them: the patch
    grid ``ceil(H/4)`` halved by a shift per stage, ``embed_dims << i``."""
    H0, W0 = -(-height // sc.patch_size), -(-width // sc.patch_size)
    return [(H0 >> i, W0 >> i, sc.embed_dims << i) for i in range(len(sc.depths))]


def part_roundtrip(a: torch.Tensor, window: int) -> torch.Tensor:
    Hp, Wp = a.shape[1], a.shape[2]
    return window_reverse(window_partition(a, window), window, Hp, Wp)


def roll_roundtrip(a: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(torch.roll(a, shifts=(-shift, -shift), dims=(1, 2)), shifts=(shift, shift), dims=(1, 2))


def swin_stages(ctx: Context, model=None) -> list:
    sc = ctx.cfg.swin
    if sc is None:
        raise ValueError(f"the swin suite needs a Swin backbone; config {ctx.args.config!r} has none")
    a, rng = ctx.args, np.random.default_rng(0)
    stages = []
    if not a.skip_features:
        model = seeded_model(ctx, model)
        xin = on(ctx, rng.standard_normal((1, ctx.H, ctx.W, 3)) * 0.1)
        stages.append(Stage("features", model.features, (xin,), (model.backbone, model.neck)))
    ws, shift = sc.window_size, sc.window_size // 2
    for i, (Hs, Ws, C) in enumerate(swin_stage_shapes(ctx.H, ctx.W, sc)):
        if i not in a.stages:
            continue
        x = on(ctx, rng.standard_normal((1, Hs, Ws, C)) * 0.1)
        heads, ff = sc.num_heads[i], sc.mlp_ratio * C

        def build(module, seed=i):
            return seeded(module, seed).to(ctx.device, ctx.dtype).eval()

        pair = build(nn.Sequential(*(SwinBlock(C, heads, ff, ws, shift=s, qkv_bias=sc.qkv_bias,
                                               qk_scale=sc.qk_scale) for s in (False, True))))
        msa = build(ShiftWindowMSA(C, heads, ws, 0, sc.qkv_bias, sc.qk_scale))
        ffn = build(FFN(C, ff, activation="gelu", add_identity=False))
        Hp, Wp = -(-Hs // ws) * ws, -(-Ws // ws) * ws
        xp = on(ctx, rng.standard_normal((1, Hp, Wp, C)) * 0.1)
        stages += [
            Stage(f"stage{i}-pair", pair, (x,), (pair,), scale=sc.depths[i] / 2),
            Stage(f"wmsa{i}", msa, (x,), (msa,)),
            Stage(f"ffn{i}", ffn, (x.reshape(1, Hs * Ws, C),), (ffn,)),
            Stage(f"part{i}", lambda t, w=ws: part_roundtrip(t, w), (xp,)),
            Stage(f"roll{i}", lambda t, s=shift: roll_roundtrip(t, s), (xp,)),
        ]
    return stages


# --- encoder: the encoder layer's, proposal stage's and decoder's parts ---

def encoder_inputs(ctx: Context) -> dict:
    """The JAX ``tools/encattr.py``'s inputs, drawn in its order from seed
    0, at the config's widths."""
    tc = ctx.cfg.head.transformer
    a = tc.encoder_layer.attn
    h, L, P, C, K = a.num_heads, a.num_levels, a.num_points, ctx.C, ctx.K
    nq = tc.two_stage_num_proposals
    rng = np.random.default_rng(0)
    query = on(ctx, rng.standard_normal((1, K, C)) * 0.02)
    raw_off = on(ctx, rng.standard_normal((1, K, h * L * P * 2)))
    raw_attn = on(ctx, rng.standard_normal((1, K, h * L * P)))
    ref = on(ctx, rng.uniform(0.05, 0.95, (1, K, L, 2)), torch.float32)
    cls_max = on(ctx, rng.standard_normal((1, K)), torch.float32)
    q900 = on(ctx, rng.standard_normal((1, nq, C)) * 0.02)
    ref900 = on(ctx, rng.uniform(0.1, 0.9, (1, nq, L, 2)), torch.float32)
    # the encoder's own grid reference points: random ones would time taps
    # that no encoder makes
    eref = get_reference_points(ctx.shapes, torch.ones(1, L, 2, device=ctx.device))
    eref = eref[:, :, None, :].expand(1, K, L, 2).contiguous()
    return {"query": query, "mask": torch.zeros(1, K, dtype=torch.bool, device=ctx.device),
            "raw_off": raw_off, "raw_attn": raw_attn, "ref": ref, "eref": eref, "cls_max": cls_max,
            "q900": q900, "ref900": ref900, "hLP": (h, L, P), "nq": nq}


def encoder_stages(ctx: Context, model, inputs: dict) -> list:
    head = model.query_head
    tf = head.transformer
    layer, dec = tf.encoder.layers[0], tf.decoder.layers[0]
    attn, mha, cross = layer.attentions[0], dec.attentions[0], dec.attentions[1]
    nd = tf.cfg.num_decoder_layers
    shapes, (h, L, P), nq, K = ctx.shapes, inputs["hLP"], inputs["nq"], ctx.K
    i = inputs
    return [
        Stage("vp", attn.project_value, (i["query"], i["mask"]), (attn.value_proj,)),
        Stage("proj", lambda q: (attn.sampling_offsets(q), attn.attention_weights(q)), (i["query"],),
              (attn.sampling_offsets, attn.attention_weights)),
        Stage("coord", lambda ro, ra, rf: attn.packed_coords(ro.float().reshape(1, K, h, L, P, 2), ra.float(),
                                                             rf, shapes),
              (i["raw_off"], i["raw_attn"], i["ref"])),
        Stage("emsda", lambda q, rf: attn(q, q, None, None, rf, shapes), (i["query"], i["eref"]), (attn,)),
        Stage("outp", lambda o, ident: attn.output_proj(o) + ident, (i["query"], i["query"]),
              (attn.output_proj,)),
        Stage("ffn", layer.ffns[0], (i["query"],), (layer.ffns[0],)),
        Stage("ln", layer.norms[0], (i["query"],), (layer.norms[0],)),
        Stage("topk", lambda cm: torch.topk(cm, nq, dim=1)[1], (i["cls_max"],)),
        Stage("prop", lambda mem, m, rf: tf.select_proposals(mem, m, rf[:, :, 0, :], shapes, head.reg_branches,
                                                             head.cls_branches)[0],
              (i["query"], i["mask"], i["ref"]),
              (tf.enc_output, tf.enc_output_norm, head.cls_branches[nd], head.reg_branches[nd])),
        Stage("mha900", mha, (i["q900"],), (mha,)),
        Stage("dmsda", lambda q, mem, rf: cross(q, mem, None, None, rf, shapes), (i["q900"], i["query"], i["ref900"]),
              (cross,)),
    ]


@contextlib.contextmanager
def recording(name: str):
    """``msda_module.<name>`` swapped, inside the scope, for a function
    that records each call's arguments and result; restored on exit."""
    real = getattr(msda_module, name)
    calls = []

    def record(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    setattr(msda_module, name, record)
    try:
        yield calls
    finally:
        setattr(msda_module, name, real)


def verify_kernels(ctx: Context, stages: dict) -> list:
    """Each verified stage once, its kernel's output against the plain
    version on the module's own kernel inputs (the fp32 value)."""
    recs = []
    for stage_name, entry, plain, kernel in VERIFIED:
        stage = stages[stage_name]
        before = msda.launches
        with recording(entry) as calls, torch.no_grad(), fp32_scope(ctx.dtype):
            stage.fn(*stage.args)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        (value, shapes, *coords), got = calls[0]
        want = plain(value.float(), shapes, *coords)
        diff = (got.float() - want).abs()
        scale = max(want.abs().max().item(), 1.0)
        if got.dtype == torch.float32:
            rel, tol = diff.max().item() / scale, "1e-5 of scale"
            ok = rel < 1e-5
        else:
            rel = (diff / (want.abs() * 2.0**-7 + 1e-5 * scale)).max().item()
            tol, ok = "<= 1 (2^-7 of each element + 1e-5 of scale)", rel <= 1.0
        ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape
        rec = {"verify": stage_name, "kernel": kernel if ctx.device.type == "cuda" else "plain version (CPU)",
               "launches": msda.launches - before, "value": list(value.shape), "dtype": str(got.dtype),
               "max_abs_err": diff.max().item(), "rel": rel, "tolerance": tol, "ok": ok, "shape": ctx.shape_text()}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


# --- mem: memory-bound ops against the copy ceiling ---

def ln_hand(t: torch.Tensor) -> torch.Tensor:
    """Two-pass LayerNorm in fp32 math, no affine: mean and mean square."""
    tf = t.float()
    m = tf.mean(-1, keepdim=True)
    v = tf.square().mean(-1, keepdim=True) - m.square()
    return ((tf - m) * torch.rsqrt(v + LN_EPS)).to(t.dtype)


def ln_affine(t: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ln_hand`` with a learned scale and bias (the model's semantics)."""
    tf = t.float()
    m = tf.mean(-1, keepdim=True)
    v = tf.square().mean(-1, keepdim=True) - m.square()
    return ((tf - m) * (torch.rsqrt(v + LN_EPS) * g) + b).to(t.dtype)


def add_op(t, u):
    return t + u


def mem_stages(ctx: Context) -> list:
    rng = np.random.default_rng(0)
    x = on(ctx, rng.standard_normal((1, ctx.K, ctx.C)))
    xf = x.float()
    ln = _layer_norm(ctx.C).to(ctx.device, ctx.dtype)
    g, b = (on(ctx, rng.standard_normal(ctx.C), torch.float32) for _ in range(2))
    dense = seeded(nn.Linear(ctx.C, ctx.C), 1).to(ctx.device, ctx.dtype)
    one = nbytes(x)
    return [
        Stage("scale", scale_op, (x,), traffic=2 * one),
        Stage("scalef32", scale_op, (xf,), traffic=2 * nbytes(xf)),
        Stage("lnflax", ln, (x,), (ln,), traffic=2 * one),
        Stage("lnhand", ln_hand, (x,), traffic=2 * one),
        Stage("lnaffine", ln_affine, (x, g, b), traffic=2 * one),
        Stage("dense", dense, (x,), (dense,), traffic=2 * one),
        Stage("add", add_op, (x, x), traffic=3 * one),
    ]


def main(argv=None, model=None) -> dict:
    """Run one suite; print a JSON line per stage and the summary last.
    ``model``: a built model of the run's config, dtype and device to use
    instead of building one (seed 0)."""
    args = parse_args(argv)
    ctx = Context(args)
    stamp = card(ctx.device)
    print(json.dumps({"suite": args.suite, "shape": ctx.shape_text(), "ceilings": ctx.ceilings, "card": stamp}),
          flush=True)

    def want(name: str) -> bool:
        return not args.only or name in args.only

    recs, verified, extra = {}, [], {}
    if args.suite == "model":
        model = seeded_model(ctx, model)
        if args.verify:
            verified = verify_kernels(ctx, {s.name: s for s in encoder_stages(ctx, model, encoder_inputs(ctx))})
        stages = model_stages(ctx, model)
    elif args.suite == "swin":
        stages = swin_stages(ctx, model)
    elif args.suite == "encoder":
        model = seeded_model(ctx, model)
        stages = encoder_stages(ctx, model, encoder_inputs(ctx))
        if args.verify:
            verified = verify_kernels(ctx, {s.name: s for s in stages})
        stages = [s for s in stages if want(s.name)]
        extra = {"K": ctx.K, "shapes": [list(s) for s in ctx.shapes]}
    else:
        stages = [s for s in mem_stages(ctx) if want(s.name)]
        extra = {"K": ctx.K}
    for stage in stages:
        recs[stage.name] = run_stage(ctx, stage, args.iters, args.trials, args.trace)
    if args.suite == "encoder":
        for name in ("dtab", "dmsda_tab"):
            if want("dmsda_tab") or want(name):
                rec = {"stage": name, "best_sane_ms": None, "reason": DECTAB_NA, "shape": ctx.shape_text()}
                print(json.dumps(rec), flush=True)
                recs[name] = rec
    summary = {"suite": args.suite, "H": ctx.H, "W": ctx.W, "config": args.config, "dtype": args.dtype,
               "device": str(ctx.device), **extra,
               "summary_best_sane_ms": {n: r["best_sane_ms"] for n, r in recs.items()},
               "x_over_floor": {n: r.get("x_over_floor") for n, r in recs.items()},
               "ceilings": ctx.ceilings, "card": stamp}
    if args.suite == "model":
        summary["table"] = model_table(ctx, recs)
    if verified:
        summary["verify_ok"] = all(v["ok"] for v in verified)
    print(json.dumps(summary), flush=True)
    return {"records": recs, "verify": verified, "summary": summary}


if __name__ == "__main__":
    sys.exit(0 if main()["summary"].get("verify_ok", True) else 1)
