"""Stage attribution (``codetr_torch/tools/attr.py``) against the JAX
package's attribution tools (``tools/attr.py``, ``swinattr.py``,
``encattr.py``, ``membench.py``) and their functions, on the tiny config at
64x96 on the CPU (where every figure is a host one).

- every subcommand runs with ``--device cpu`` and prints each JAX stage
  name (``dtab`` / ``dmsda_tab`` included: the decoder's corner table), a
  time, a floor and ``x_over_floor`` for each stage, and a summary line
  last; ``--verify`` runs, and ``--trace`` (``model``); the default device raises
  without a card;
- FLOPs: ``full`` = ``features`` + ``detect`` exactly, and ``ffn``,
  ``proj`` and ``mha900`` at their closed forms (2 M N K a product);
- ``coord``: the port's packed coordinates against the JAX tool's pipeline
  (reference plus offset over the level sizes, softmax) packed by
  ``codetr_tpu.ops.msda_win.pack_coords_qmajor``, 1e-6;
- ``prop``: ``CoDinoTransformer.select_proposals`` against the JAX
  ``make_encoder_output_proposals`` + ``apply_mask_to_proposal_and_memory``
  + the branches + ``lax.top_k``, the JAX modules' weights carried by the
  port's converter (``utils/checkpoint._Out``), with padded keys and
  proposals out of range: the same keys, the coordinates 1e-5;
- ``part{i}`` / ``roll{i}``: the port's ``window_partition`` /
  ``window_reverse`` / ``torch.roll`` equal the JAX ones bit for bit at the
  tool's per-stage shapes;
- ``lnhand`` / ``lnaffine`` against the port's ``nn.LayerNorm`` and the
  JAX ``layer_norm``: fp32 within 1e-5, bf16 within 2^-7 of each element +
  1e-5 of the scale.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from codetr_tpu.models import layers as jax_layers
from codetr_tpu.models import swin as jax_swin
from codetr_tpu.models import transformer as jax_transformer
from codetr_tpu.ops.msda_win import pack_coords_qmajor
from codetr_torch.models import swin as port_swin
from codetr_torch.models.codetr import build_codetr
from codetr_torch.tools import attr
from codetr_torch.utils import checkpoint
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

HW = ("64", "96")
CPU = ["--device", "cpu", "--config", "tiny", "--iters", "1", "--trials", "1"]
GIVEN = ["--ceiling-tflops", "1", "--ceiling-gbs", "1"]
# the JAX tools' stage names
EXPECTED = {
    "model": ("features", "detect", "full"),
    "swin": ("features",) + tuple(n for i in range(4)
                                  for n in (f"stage{i}-pair", f"wmsa{i}", f"ffn{i}", f"part{i}", f"roll{i}")),
    "encoder": ("vp", "proj", "coord", "emsda", "outp", "ffn", "ln", "topk", "prop", "mha900", "dmsda",
                "dtab", "dmsda_tab"),
    "mem": ("scale", "scalef32", "lnflax", "lnhand", "lnaffine", "dense", "add"),
}
ARGV = {
    "model": ["model", *HW, "--verify", "--trace"],
    "swin": ["swin", "--height", HW[0], "--width", HW[1]],
    "encoder": ["encoder", *HW, "--verify"],
    "mem": ["mem", "--height", HW[0], "--width", HW[1]],
}


def context(suite="encoder", dtype="float32"):
    argv = [suite, *HW] if suite in ("model", "encoder") else [suite, "--height", HW[0], "--width", HW[1]]
    return attr.Context(attr.parse_args(argv + CPU + GIVEN + ["--dtype", dtype]))


@pytest.fixture(scope="module")
def tiny_model():
    return build_codetr(attr.CONFIGS["tiny"](), device="cpu", seed=0)


@pytest.mark.parametrize("suite", sorted(ARGV))
def test_every_suite_runs_on_the_cpu(suite, capsys, tmp_path):
    argv = ARGV[suite] + ([str(tmp_path)] if ARGV[suite][-1] == "--trace" else []) + CPU
    result = attr.main(argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    staged = [r["stage"] for r in lines if "stage" in r]
    assert staged == list(EXPECTED[suite])
    for r in lines:
        if "stage" not in r:
            continue
        assert "reason" not in r
        assert r["best_sane_ms"] > 0 and r["floor_ms"] > 0 and r["x_over_floor"] > 0, r
        assert r["ceiling"]["source"] == "measured" and r["shape"] == "64x96 bfloat16"
        assert r["median_ms"] >= r["best_sane_ms"] and r["spread"] >= 1
        if suite == "model":
            assert r["traced"]["trace"].startswith(str(tmp_path))
    summary = lines[-1]
    assert summary["suite"] == suite and summary["card"] == "cpu"
    assert set(summary["summary_best_sane_ms"]) == set(EXPECTED[suite])
    if suite == "model":
        assert set(summary["table"]) == {"features", "detect", "full", "derived"}
        ms = summary["summary_best_sane_ms"]
        assert summary["table"]["derived"]["head_minus_features_ms"] == pytest.approx(ms["full"] - ms["features"])
    if suite == "swin":
        for i, depth in enumerate(attr.CONFIGS["tiny"]().swin.depths):
            pair = result["records"][f"stage{i}-pair"]
            assert pair["scaled_ms"] == pytest.approx(pair["best_sane_ms"] * depth / 2)
    if suite == "mem":
        for r in result["records"].values():
            assert r["eff_gb_s"] == pytest.approx(r["traffic_mb"] / 1e3 / (r["best_sane_ms"] / 1e3))
    if suite in ("model", "encoder"):
        assert summary["verify_ok"] and [v["verify"] for v in result["verify"]] == ["emsda", "dmsda"]


@pytest.mark.parametrize("only,stages", [("dtab", ["dtab"]), ("dmsda_tab", ["dtab", "dmsda_tab"])])
def test_only_selects_the_table_stages(only, stages, capsys, tiny_model):
    """``--only dtab`` times the table build alone; ``--only dmsda_tab``
    brings the build along (its table), as the JAX tool's switch does."""
    result = attr.main(["encoder", *HW, "--only", only] + CPU + ["--dtype", "float32"], model=tiny_model)
    assert list(result["records"]) == stages
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["stage"] for r in lines if "stage" in r] == stages
    for r in result["records"].values():
        assert r["best_sane_ms"] > 0 and r["mb"] > 0 and r["floor_ms"] > 0
    if only == "dmsda_tab":  # the cross-attention on the table computes products
        assert result["records"]["dmsda_tab"]["gflop"] > 0


@pytest.mark.parametrize("suite", sorted(ARGV))
def test_the_default_device_raises_without_a_card(suite):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attr.main([suite, "--config", "tiny"])


def test_full_flops_are_features_plus_detect(tiny_model):
    ctx = context("model")
    flops = {s.name: attr.count_flops(s, ctx.dtype) for s in attr.model_stages(ctx, tiny_model)}
    assert flops["features"] > 0 and flops["detect"] > 0
    assert flops["full"] == flops["features"] + flops["detect"]


@pytest.mark.parametrize("name", ["ffn", "proj", "mha900"])
def test_closed_form_flops(name, tiny_model):
    ctx = context()
    tc = ctx.cfg.head.transformer
    inputs = attr.encoder_inputs(ctx)
    h, L, P = inputs["hLP"]
    K, C, nq, F_ = ctx.K, ctx.C, inputs["nq"], tc.encoder_layer.feedforward_channels
    HLP = h * L * P
    want = {
        "ffn": 2 * K * C * F_ + 2 * K * F_ * C,
        "proj": 2 * K * C * (2 * HLP) + 2 * K * C * HLP,
        # q, k, v and out projections; q k^T and attn v over all heads
        "mha900": 4 * (2 * nq * C * C) + 2 * (2 * nq * nq * C),
    }[name]
    stage = {s.name: s for s in attr.encoder_stages(ctx, tiny_model, inputs)}[name]
    assert attr.count_flops(stage, ctx.dtype) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coord_matches_the_jax_packed_pipeline(dtype, tiny_model):
    ctx = context(dtype=dtype)
    a = ctx.cfg.head.transformer.encoder_layer.attn
    h, L, P, K, shapes = a.num_heads, a.num_levels, a.num_points, ctx.K, ctx.shapes
    HLP = h * L * P
    rng = np.random.default_rng(3)
    # the JAX tool's raw offsets: [x(HLP) | y(HLP)], each (h, L, P)-major
    off_xy = torch.from_numpy(rng.standard_normal((1, K, 2 * HLP)).astype(np.float32)).to(ctx.dtype)
    raw_attn = torch.from_numpy(rng.standard_normal((1, K, HLP)).astype(np.float32)).to(ctx.dtype)
    ref = rng.uniform(0.05, 0.95, (1, K, L, 2)).astype(np.float32)
    # the port's sampling_offsets output: (h, L, P, 2) interleaved
    off_port = torch.from_numpy(checkpoint._interleave_xy(off_xy.float().numpy(), axis=2)).to(ctx.dtype)
    inputs = dict(attr.encoder_inputs(ctx), raw_off=off_port, raw_attn=raw_attn, ref=torch.from_numpy(ref))
    stage = {s.name: s for s in attr.encoder_stages(ctx, tiny_model, inputs)}["coord"]
    got = stage.fn(*stage.args).numpy()

    # encattr.py's f_coord, then the q-minor tensors packed by the JAX package
    inv_w = np.tile(np.repeat([1.0 / ww for _, ww in shapes], P), h)
    inv_h = np.tile(np.repeat([1.0 / hh for hh, _ in shapes], P), h)
    sxy = jnp.asarray(np.concatenate([inv_w, inv_h]), jnp.float32)

    def qminor(t):
        return jnp.moveaxis(t.reshape(1, K, h, L, P), 1, -1)

    @jax.jit
    def f_coord(ro, ra, rf):
        ref_rep = jnp.tile(jnp.repeat(jnp.moveaxis(rf, -1, 2).reshape(1, K, 2 * L), P, axis=-1)
                           .reshape(1, K, 2, L * P), (1, 1, 1, h)).reshape(1, K, 2 * HLP)
        xy = ref_rep + ro * sxy
        w = jax.nn.softmax(ra.reshape(1, K, h, L * P), axis=-1).reshape(1, K, HLP)
        return pack_coords_qmajor(qminor(xy[..., :HLP]), qminor(xy[..., HLP:]), qminor(w), interpret=True)

    want = np.asarray(f_coord(jnp.asarray(off_xy.float().numpy()), jnp.asarray(raw_attn.float().numpy()),
                              jnp.asarray(ref)))
    assert got.shape == want.shape == (1, K, 3 * HLP)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _Norm(fnn.Module):
    dtype: object

    @fnn.compact
    def __call__(self, x):
        return jax_layers.layer_norm(x, dtype=self.dtype, name="ln")


def test_prop_matches_jax(tiny_model):
    ctx = context()
    tc = ctx.cfg.head.transformer
    C, K, nd, ncls = ctx.C, ctx.K, tc.num_decoder_layers, ctx.cfg.head.num_classes
    L, nq, shapes = tc.num_feature_levels, tc.two_stage_num_proposals, ctx.shapes
    rng = np.random.default_rng(5)
    n_lin = ctx.cfg.head.num_reg_fcs + 1

    def dense(n_in, n_out):
        return {"kernel": rng.standard_normal((n_in, n_out)).astype(np.float32) * n_in**-0.5,
                "bias": rng.standard_normal(n_out).astype(np.float32) * 0.1}

    params = {
        "enc_output": {"params": dense(C, C)},
        "enc_output_norm": {"params": {"ln": {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
                                              "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}}},
        "cls": {"params": dense(C, ncls)},
        "reg": {"params": {f"layers_{li}": dense(C, C if li < n_lin - 1 else 4) for li in range(n_lin)}},
    }
    jax_mods = {"enc_output": fnn.Dense(C, param_dtype=jnp.float32), "enc_output_norm": _Norm(jnp.float32),
                "cls": fnn.Dense(ncls, param_dtype=jnp.float32),
                "reg": jax_layers.Mlp(hidden_dim=C, output_dim=4, num_layers=n_lin)}

    # the weights into the port's model through the converter's own helpers
    out = checkpoint._Out()
    out.dense("query_head.transformer.enc_output", params["enc_output"]["params"])
    out.norm("query_head.transformer.enc_output_norm", params["enc_output_norm"]["params"]["ln"])
    out.dense(f"query_head.cls_branches.{nd}", params["cls"]["params"])
    for li in range(n_lin):
        out.dense(f"query_head.reg_branches.{nd}.{2 * li}", params["reg"]["params"][f"layers_{li}"])
    model = build_codetr(ctx.cfg, device="cpu", seed=0)
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in out.sd.items()}, strict=False)
    assert not unexpected and len(missing) == len(model.state_dict()) - len(out.sd)

    mem = rng.standard_normal((1, K, C)).astype(np.float32)
    mask = rng.random((1, K)) < 0.1  # padded keys
    ref = rng.uniform(0.005, 0.995, (1, K, L, 2)).astype(np.float32)  # some proposals out of range
    inputs = dict(attr.encoder_inputs(ctx), query=torch.from_numpy(mem), mask=torch.from_numpy(mask),
                  ref=torch.from_numpy(ref))
    stage = {s.name: s for s in attr.encoder_stages(ctx, model, inputs)}["prop"]
    with torch.no_grad():
        got = stage.fn(*stage.args).numpy()
        idx = model.query_head.transformer.select_proposals(
            *stage.args[:2], stage.args[2][:, :, 0, :], shapes, model.query_head.reg_branches,
            model.query_head.cls_branches)[1].numpy()

    @jax.jit
    def f_prop(mem, m, rf):  # encattr.py's f_prop, with the index
        props = jax_transformer.make_encoder_output_proposals(rf[:, :, 0, :], shapes)
        props, out_mem = jax_transformer.apply_mask_to_proposal_and_memory(props, mem, m)
        out_mem = jax_mods["enc_output_norm"].apply(params["enc_output_norm"],
                                                    jax_mods["enc_output"].apply(params["enc_output"], out_mem))
        ec = jax_mods["cls"].apply(params["cls"], out_mem)
        ecoord = jax_mods["reg"].apply(params["reg"], out_mem) + props
        _, jidx = jax.lax.top_k(jnp.max(ec, axis=-1), nq)
        return jnp.take_along_axis(ecoord, jidx[..., None], axis=1), jidx, props

    want, jidx, props = (np.asarray(a) for a in f_prop(jnp.asarray(mem), jnp.asarray(mask.astype(np.float32)),
                                                        jnp.asarray(ref)))
    assert mask[0, idx[0]].sum() == 0 and (np.abs(want) > 1e30).sum() == 0, "pick data whose top keys are valid"
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the masked proposals themselves: float32 max, as in JAX
    assert props[mask].min() == np.finfo(np.float32).max


def test_part_and_roll_match_jax():
    ctx = context("swin")
    sc = ctx.cfg.swin
    ws, shift = sc.window_size, sc.window_size // 2
    rng = np.random.default_rng(7)
    stages = {s.name: s for s in attr.swin_stages(attr.Context(attr.parse_args(
        ["swin", "--height", HW[0], "--width", HW[1], "--skip-features"] + CPU + GIVEN + ["--dtype", "float32"])))}
    for i, (Hs, Ws, C) in enumerate(attr.swin_stage_shapes(ctx.H, ctx.W, sc)):
        Hp, Wp = -(-Hs // ws) * ws, -(-Ws // ws) * ws
        assert stages[f"part{i}"].args[0].shape == (1, Hp, Wp, C)
        xp = rng.standard_normal((1, Hp, Wp, C)).astype(np.float32)

        @jax.jit
        def jax_pieces(j):
            wins = jax_swin.window_partition(j, ws)
            rolled = jnp.roll(j, shift=(-shift, -shift), axis=(1, 2))
            return (wins, jax_swin.window_reverse(wins, ws, Hp, Wp), rolled,
                    jnp.roll(rolled, shift=(shift, shift), axis=(1, 2)))

        t = torch.from_numpy(xp)
        port_pieces = (port_swin.window_partition(t, ws), stages[f"part{i}"].fn(t),
                       torch.roll(t, shifts=(-shift, -shift), dims=(1, 2)), stages[f"roll{i}"].fn(t))
        for got, want in zip(port_pieces, jax_pieces(jnp.asarray(xp))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@torch.no_grad()
def test_layer_norms_match_the_port_and_jax(dtype):
    ctx = context("mem", dtype)
    stages = {s.name: s for s in attr.mem_stages(ctx)}
    x, g, b = stages["lnaffine"].args
    C = ctx.C

    def within(got, want):
        got, want = got.float(), want.float()
        scale = max(want.abs().max().item(), 1.0)
        tol = want.abs() * 1e-5 + 1e-5 * scale if dtype == "float32" else want.abs() * 2.0**-7 + 1e-5 * scale
        excess = ((got - want).abs() - tol).max().item()
        assert excess <= 0, f"off by {excess:.2e} beyond the tolerance"

    jx = jnp.asarray(x.float().numpy()).astype(jnp.dtype(dtype))
    for name, w, bias in (("lnhand", torch.ones(C), torch.zeros(C)), ("lnaffine", g, b)):
        got = stages[name].fn(*stages[name].args)
        assert got.dtype == ctx.dtype
        port_ln = F.layer_norm(x.float(), (C,), w, bias, eps=attr.LN_EPS)  # the port's nn.LayerNorm, fp32
        jax_out = _Norm(jnp.dtype(dtype)).apply(
            {"params": {"ln": {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(bias.numpy())}}}, jx)
        within(got, port_ln)
        within(torch.from_numpy(np.array(jax_out, np.float32)), port_ln)
    # lnflax is the model's LayerNorm in the run's dtype, and lnhand its function
    within(stages["lnhand"].fn(x), stages["lnflax"].fn(x))
