"""bf16 mixed-precision training in the port against the JAX package, on
the CPU: fp32 master weights, bf16 compute (the JAX package's
``dtype=bfloat16`` with ``param_dtype=float32`` and ``optax.adamw``).

- ``run_in_dtype(model, bf16, ...)`` casts what the JAX bf16 model casts
  and leaves ``fp32_parameter_names`` (the norms' affine parameters, Swin's
  relative-position bias tables) float32, so the bf16 step's forward is
  the served bf16 model's (``to_compute_dtype``) bit for bit, in train and
  in eval mode, on the tiny config at 96x96 with a padded mask.  Its
  parent cast every floating tensor: ``all_cls_logits`` moved by ~1 on a
  scale of ~3.
- One ``make_train_step(..., compute_dtype=torch.bfloat16)`` step of the
  tiny model leaves every parameter and every AdamW state tensor fp32 and
  moves an entry exactly where ``adamw_moves`` (the same AdamW step in
  float64, rounded to float32) moves it.  This rule was "every entry with
  a nonzero gradient moves", which a step of ``optax.adamw`` breaks too:
  the shifted window attention's masked logits give a bias table
  gradients of ~1e-44, which move a weight by ~1e-40.  With bf16
  parameters (the port's former way to train in bf16) AdamW's first step,
  ~lr = 1e-4, is below half a bf16 ulp of most weights and rounds away;
  such a model is refused with a ``ValueError``.
- Against JAX: the tiny config at 128x128 with a padded mask, the params
  of ``test_torch_port_train.py`` (``perturbed_jax_params(seed=4)``)
  carried by ``state_dict_from_jax``.  The JAX bf16 step is compiled once
  with XLA's excess precision off (``test_torch_port_bf16.STRICT``), so it
  rounds after every operation as its code reads, and the port runs under
  ``FlaxRoundings`` (flax's two roundings of a biased ``Dense`` / ``Conv``,
  ``jax.nn.gelu``'s four); see ``test_torch_port_bf16.py``.  The noise is
  JAX's own bf16 distance from the float32 result, the float32 result
  being the port's fp32 step (``test_torch_port_train.py`` holds it to
  JAX's within 1e-5 of the loss and 1e-4 of each leaf).  Held: the
  matches of every stage on the valid gts equal (were they not, a loss
  gap would be the two roundings picking different optima, not the loss);
  the loss within ``LOSS_NOISE_SHARE`` of the noise (measured 0.134; the
  parent 1.409); each leaf's gradient by root mean square over its
  entries not zero in exact arithmetic (``zero_in_exact_arithmetic``, the
  rounding noise) within ``GRAD_NOISE_SHARE`` of the leaf's noise
  (measured at most 1.027, median 0.310 over the 206 leaves; the parent
  at most 3.948, median 1.341), and the median within
  ``GRAD_MEDIAN_SHARE``; over the whole gradient, the port's distance
  from JAX's within 5e-2 of its norm (measured 1.1%; the parent 1.5%)
  and the port's distance from the fp32 gradient at most 1.5 times JAX's
  (measured 0.70 times; the parent 0.96).  ``FlaxRoundings`` reaches the
  forward only (a ``TorchFunctionMode`` does not see autograd's own ops):
  where a leaf's
  gradient is one sum rounded once to bf16 (the biases of the
  patch embedding, ``enc_output``, ``cls_branches_2``), the two sums in
  other orders land a bf16 step apart about as often as JAX's sum and the
  float32 one, so that share is ~1 and the leaf share is set from the
  measurement, not a tenth as for the forward's stages.  On the parent
  111 of the 206 leaves fail it: every Swin block's LayerNorm scales and
  biases, its bias tables (stages 0-3), its ``qkv``, ``proj``, ``fc1``
  and ``fc2``, the patch embedding, the downsamplings' norms and
  reductions, ``norm0`` and ``norm2`` / ``norm3``, the neck's extra
  convolution and GroupNorm, ``cls_branches_2`` and ``enc_output``
  (largest: ``stages_0_blocks.block1.norm2.bias``, 3.948).
- One ``adamw`` step and one ``optax.adamw`` step from those fp32 params,
  fed JAX's bf16 gradients (and a planted row of tiny and denormal ones,
  which XLA:CPU flushes to zero and the port's float32 steps round away):
  every entry, kept leaves included, within one float32 ulp of the
  weight plus optax's own error (its float32 bias corrections make its
  first update 6.68e-6 smaller than the exact one: up to 188 ulps of a
  weight that the step takes near zero) and 16 ulps of the update; the
  port moves an entry exactly where ``adamw_moves`` does.
- ``SwinConfig.with_cp`` with bf16 compute gives the same loss and
  gradients (1e-6) as without it: the recompute sees the bf16 casts.
- ``python -m codetr_torch.tools.trainbench --device cpu`` on the tiny
  config parses the JAX script's flags and prints its keys.
"""

import copy
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.parallel import losses as jl
from codetr_torch import build_codetr
from codetr_torch.config import tiny_test_config
from codetr_torch.models.codetr import fp32_parameter_names, to_compute_dtype
from codetr_torch.parallel import losses as tl
from codetr_torch.parallel.train import adamw, adamw_moves, make_train_step, run_in_dtype, train_loss
from codetr_torch.tools import trainbench
from codetr_torch.utils.checkpoint import state_dict_from_jax

from test_torch_port_bf16 import STRICT, FlaxRoundings
from test_torch_port_bf16 import model_inputs as served_inputs
from test_torch_port_model import perturbed_jax_params, port_from_jax
from test_torch_port_train import LR, _leaves, port_grads, port_params, rel, train_inputs, zero_in_exact_arithmetic
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
LOSS_NOISE_SHARE = 0.5  # the loss's distance from JAX's, over JAX's own bf16 distance from fp32
GRAD_NOISE_SHARE = 1.25  # each leaf's, by root mean square
GRAD_MEDIAN_SHARE = 0.5  # the median over the leaves


def port_batch():
    args = [torch.from_numpy(a) for a in train_inputs()]
    args[3] = args[3].long()
    return args


@pytest.fixture(scope="module")
def params():
    return perturbed_jax_params(seed=4)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_bf16_step_forward_is_the_served_bf16_models(params, mode):
    """``run_in_dtype`` leaves ``fp32_parameter_names`` float32 and casts
    every other floating tensor: ``train_outputs`` equal bit for bit to the
    served bf16 model's (``to_compute_dtype``), and the model's precision
    scope (``CoDETR.dtype``, the level embeddings' dtype) bf16."""
    model = port_from_jax(params).train(mode == "train")
    served = to_compute_dtype(copy.deepcopy(model), BF16)
    x, mk = (torch.from_numpy(a) for a in served_inputs())
    keep = fp32_parameter_names(model)
    seen = {}

    def outputs(m, x, mk):
        tensors = dict(m.named_parameters())
        tensors.update(m.named_buffers())
        seen.update((n, t.dtype) for n, t in tensors.items() if t.is_floating_point())
        seen["<scope>"] = m.dtype
        return m.train_outputs(x, mk)

    with torch.no_grad():
        got = run_in_dtype(model, BF16, outputs, x, mk)
        want = served.train_outputs(x, mk)
    assert keep and seen.pop("<scope>") == BF16
    for n, dt in seen.items():
        assert dt == (torch.float32 if n in keep else BF16), n
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_step_keeps_fp32_master_weights_and_moves_every_one():
    """Every entry that the step moves in float64 arithmetic (``adamw_moves``)
    moves, and no other."""
    model = build_codetr(tiny_test_config(), device="cpu", seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(model)
    loss = make_train_step(model, opt, compute_dtype=BF16)(*port_batch())
    assert torch.isfinite(loss)
    nonzero = moved = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        nonzero += int((p.grad != 0).sum())
        got, want = p.detach() != start[n], adamw_moves(start[n], p.grad)
        moved += int(got.sum())
        assert torch.equal(got, want), f"{n}: {int((got & ~want).sum())} moved, {int((want & ~got).sum())} stuck"
    total = sum(p.numel() for p in model.parameters())
    assert nonzero > 0.9 * total and moved > 0.9 * total
    state = [t for s in opt.state.values() for t in s.values() if torch.is_tensor(t) and t.dim()]
    assert state and all(t.dtype == torch.float32 for t in state)


def test_train_step_refuses_bf16_parameters():
    model = build_codetr(tiny_test_config(), device="cpu", dtype=BF16, seed=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(model, adamw(model))
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(model, adamw(model), compute_dtype=BF16)
    fp32 = build_codetr(tiny_test_config(), device="cpu", seed=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(fp32, adamw(fp32), compute_dtype=torch.float16)


@pytest.fixture(scope="module")
def jax_bf16(params):
    """JAX: the bf16 model's loss, gradients (fp32 leaves) and each stage's
    matches (nl + 1, bs, max_gt), from one call compiled with excess
    precision off."""
    img, mask, boxes, labels, valid = (jnp.asarray(a) for a in train_inputs())
    model = JaxCoDETR(cfg=jax_tiny_test_config(), dtype=jnp.bfloat16, msda_impl="reference")

    def loss_fn(p):
        out = model.apply(p, img, mask, method=model.train_outputs)
        stages = [(out["all_cls_logits"][i], out["all_coords"][i])
                  for i in range(out["all_cls_logits"].shape[0])]
        stages.append((out["enc_cls_logits"], out["enc_coords"]))
        match = jax.vmap(jl.hungarian_match)
        matches = jnp.stack([match(*jax.lax.stop_gradient((cl, co)), boxes, labels, valid)[0]
                             for cl, co in stages])
        return jl.dino_detection_loss(out, boxes, labels, valid)[0], matches

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(compiler_options=STRICT)
    (loss, matches), grads = step(params)
    return params, float(loss), jax.tree.map(np.asarray, grads), np.asarray(matches)


def test_bf16_step_matches_jax(jax_bf16):
    params, want_loss, want_grads, want_matches = jax_bf16
    model = port_from_jax(params)
    batch = port_batch()
    with torch.no_grad(), FlaxRoundings():
        out = run_in_dtype(model, BF16, lambda m, x, mk: m.train_outputs(x, mk), *batch[:2])
    dec, enc = tl.match_stages(out, *batch[2:])
    valid = batch[4].numpy()
    got_matches = torch.cat([dec, enc[None]]).numpy()
    for s in range(len(got_matches)):
        np.testing.assert_array_equal(got_matches[s][valid], want_matches[s][valid],
                                      err_msg=f"stage {s}: the two roundings picked different optima")

    with FlaxRoundings():
        loss = train_loss(model, batch, compute_dtype=BF16, backward=True).item()
    fp32 = port_from_jax(params)  # the fp32 step: test_torch_port_train.py holds it to JAX's
    exact_loss = train_loss(fp32, batch, backward=True).item()
    share = abs(loss - want_loss) / abs(want_loss - exact_loss)
    assert share <= LOSS_NOISE_SHARE, (loss, want_loss, exact_loss, share)
    got, want, exact = _leaves(port_grads(model)), _leaves(want_grads), _leaves(port_grads(fp32))
    assert sorted(got) == sorted(want) == sorted(exact)
    shares = {}
    for k in sorted(want):  # each leaf, on its entries that are not zero in exact arithmetic
        m = ~zero_in_exact_arithmetic(k, want[k].shape)
        if not m.any():
            continue
        noise = np.sqrt(np.mean((want[k][m].astype(np.float64) - exact[k][m]) ** 2))
        assert noise > 0, k
        shares[k] = np.sqrt(np.mean((got[k][m].astype(np.float64) - want[k][m]) ** 2)) / noise
    over = {k: round(v, 3) for k, v in shares.items() if v > GRAD_NOISE_SHARE}
    assert not over, f"{len(over)} of {len(shares)} leaves over {GRAD_NOISE_SHARE} x the JAX bf16 noise: {over}"
    assert np.median(list(shares.values())) <= GRAD_MEDIAN_SHARE, np.median(list(shares.values()))
    keys = sorted(want)
    kept = {k: ~zero_in_exact_arithmetic(k, want[k].shape) for k in keys}
    flat = {n: np.concatenate([d[k][kept[k]].ravel() for k in keys]).astype(np.float64)
            for n, d in (("got", got), ("want", want), ("exact", exact))}
    norm = np.linalg.norm
    assert norm(flat["got"] - flat["want"]) <= 5e-2 * norm(flat["want"])
    # the port's bf16 gradient is no farther from the exact one than JAX's
    assert norm(flat["got"] - flat["exact"]) <= 1.5 * norm(flat["want"] - flat["exact"])


def optax_update_scale() -> float:
    """The factor by which ``optax.adamw``'s first update is off the exact
    one: optax takes the bias corrections ``1 - b ** t`` in float32, where
    0.9 and 0.999 round (0.999 to 0.99900001), while the moments' factors
    ``1 - b`` are Python floats rounded once; ``torch.optim.AdamW`` takes
    the corrections in float64.  m / (sqrt(v) + eps) with m = (1 - b1) g /
    c1 and v = (1 - b2) g^2 / c2: 1 - 6.68e-6."""
    f32 = np.float32
    c1, c2 = f32(1) - f32(0.9), f32(1) - f32(0.999)
    return float(np.float64(f32(1 - 0.9)) / np.float64(c1) / np.sqrt(np.float64(f32(1 - 0.999)) / np.float64(c2)))


def test_adamw_step_on_the_jax_bf16_gradients_matches_optax(jax_bf16):
    """``adamw`` and ``optax.adamw`` one step from the same fp32 params
    with the same gradients.  Each entry within one float32 ulp of the
    larger of the weight before and after, plus what optax's own float32
    bias correction takes off its update (``optax_update_scale``: up to
    188 ulps of a weight that the step takes near zero) and 16 float32
    ulps of the update (each side rounds ~6 times computing it)."""
    params, _, grads, _ = jax_bf16
    grads = jax.tree.map(np.copy, grads)
    planted = np.array([1.4e-45, 4.2e-45, 1e-44, 1e-40, 1e-38, 1e-30, 1e-20, 1e-13, 1e-12, 1e-10], np.float32)
    table = grads["params"]["backbone"]["stages_0_blocks"]["block0"]["attn"]["w_msa"]["relative_position_bias_table"]
    n = len(planted)  # (scanned blocks, (2 Wh - 1)(2 Ww - 1), heads)
    table[0, :2 * n, 0] = np.concatenate([planted, -planted])
    model = port_from_jax(params)
    for name, g in state_dict_from_jax(grads, tiny_test_config()).items():
        model.get_parameter(name).grad = torch.from_numpy(np.ascontiguousarray(g))
    start = {name: p.detach().clone() for name, p in model.named_parameters()}
    adamw(model, LR).step()
    tx = optax.adamw(LR)
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want, got, before = _leaves(step(grads, params)), _leaves(port_params(model)), _leaves(params)
    assert sorted(got) == sorted(want) == sorted(before)
    bias = 1 - optax_update_scale()
    assert 6e-6 < bias < 7e-6
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        w, update = w.astype(np.float64), np.abs(w.astype(np.float64) - before[k])
        ulp = np.spacing(np.maximum(np.abs(before[k]), np.abs(w)).astype(np.float32))
        off = np.abs(got[k] - w) > ulp + (bias + 2.0**-20) * update
        assert not off.any(), f"{k}: {int(off.sum())} entries off optax's"
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert torch.equal(p.detach() != start[name], adamw_moves(start[name], p.grad, LR)), name
    name = "backbone.stages.0.blocks.0.attn.w_msa.relative_position_bias_table"
    tiny = torch.tensor([i for i in range(2 * n) if abs(planted[i % n]) <= 1e-20])
    assert torch.equal(model.get_parameter(name)[tiny], start[name][tiny])  # their updates round away


def test_with_cp_bf16_gives_the_same_loss_and_gradients(jax_bf16):
    """Deterministic algorithms on, as in the fp32 ``with_cp`` test."""
    batch = port_batch()
    results = []
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for with_cp in (False, True):
            cfg = tiny_test_config()
            cfg = replace(cfg, swin=replace(cfg.swin, with_cp=with_cp))
            model = port_from_jax(jax_bf16[0], cfg)
            loss = train_loss(model, batch, compute_dtype=BF16, backward=True)
            results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (l0, g0), (l1, g1) = results
    assert rel(l1, l0) < 1e-6
    for n in g0:
        assert g1[n].dtype == torch.float32
        assert rel(g1[n].numpy(), g0[n].numpy()) < 1e-6, n


def test_trainbench_cli_on_the_cpu(capsys):
    args = trainbench.parse_args([])
    assert (args.height, args.width, args.iters, args.trials, args.gradcheck_hw) == (608, 608, 3, 6, 320)
    assert (args.dtype, args.config, args.device, args.gradcheck) == ("bfloat16", "swin-l", "cuda", False)
    result = trainbench.main(["--device", "cpu", "--config", "tiny", "--height", "96", "--width", "96",
                              "--iters", "1", "--trials", "1", "--gradcheck", "--gradcheck-hw", "64"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0]["gradcheck"]["pass"] and lines[0]["gradcheck"]["resolution"] == [64, 64]
    assert [d["stage"] for d in lines[1:4]] == ["fwd", "fwd+bwd", "step"]
    assert {d["mode"] for d in lines[1:4]} == {"eager"} and "stage" not in lines[4]  # no graph on the CPU
    last = lines[-1]
    for key in ("fwd_ms", "fwdbwd_ms", "step_ms", "bwd_over_fwd", "median_ms", "spread", "peak_gib",
                "peak_captured_gib", "pool_captured_gib"):
        assert key in last and last[key] is None, key  # the replays' keys, and the card's memory
    assert last["matching_ms_per_step"] > 0 and last["card"] == "cpu" and last["kernels_fwdbwd"] is None
    for key in ("fwd_eager_ms", "fwdbwd_eager_ms", "step_eager_ms"):
        assert last[key] > 0, key
    assert set(last["median_eager_ms"]) == set(last["spread_eager"]) == {"fwd", "fwd+bwd", "step"}
    assert last["device"] == "cpu" and last["dtype"] == "bfloat16" and isinstance(last["bwd_over_fwd_eager"], float)
    assert last == {k: v for k, v in result.items() if k != "gradcheck"}


@pytest.mark.parametrize("config", ["swin-l", "tiny"])
def test_trainbench_inputs_are_the_jax_scripts(config):
    """max_gt 32 with 7 valid for every config, as ``tools/trainbench.py``
    draws them (seed 0, in its order); the tiny config's 12 queries no
    longer cap max_gt.  Swin-L's draws equal the JAX script's."""
    cfg = trainbench.CONFIGS[config]()
    x, mask, boxes, labels, valid = trainbench.train_inputs(16, 24, cfg, torch.device("cpu"))
    assert boxes.shape == (1, 32, 4) and labels.shape == (1, 32) and valid.shape == (1, 32)
    assert valid.sum().item() == 7 and valid[0, :7].all() and not mask.any()
    if config == "swin-l":
        rng = np.random.default_rng(0)
        np.testing.assert_array_equal(x.numpy(), (rng.standard_normal((1, 16, 24, 3)) * 0.1).astype(np.float32))
        np.testing.assert_array_equal(boxes.numpy(), np.clip(rng.uniform(0.1, 0.9, (1, 32, 4)), 0.05, 0.3)
                                      .astype(np.float32))
        np.testing.assert_array_equal(labels.numpy(), rng.integers(0, 80, (1, 32)))
