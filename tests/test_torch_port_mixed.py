"""bf16 mixed-precision training in the port against the JAX package, on
the CPU: fp32 master weights, bf16 compute (the JAX package's
``dtype=bfloat16`` with ``param_dtype=float32`` and ``optax.adamw``).

- One ``make_train_step(..., compute_dtype=torch.bfloat16)`` step of the
  tiny model leaves every parameter and every AdamW state tensor fp32 and
  moves every parameter entry whose gradient is nonzero.  With bf16
  parameters (the port's former way to train in bf16) AdamW's first step,
  ~lr = 1e-4, is below half a bf16 ulp of most weights and rounds away;
  such a model is now refused with a ``ValueError``.
- Against JAX, the tiny config at 128x128 with a padded mask, the params of
  ``test_torch_port_train.py`` (``perturbed_jax_params(seed=4)``) carried
  by ``state_dict_from_jax``: the matches of every stage and image first
  (equal on the valid gts: were they not, a loss gap would be the two
  roundings picking different optima, not the loss), then the loss within
  1e-2 relative, then the gradients against JAX's bf16 gradients and the
  fp32 ones (the port's, which ``test_torch_port_train.py`` holds to JAX's
  within 1e-4 of each leaf).  Both sides round to bf16 at other places
  (XLA:CPU fuses elementwise chains in fp32, PyTorch rounds after each op),
  and bilinear sampling's derivative jumps where a rounded tap crosses a
  grid line, so a bf16 gradient of this random tiny model is far from the
  fp32 one: JAX's own leaves are a median 7% and up to 52% of their scale
  off (measured).  So each leaf's max |difference| from JAX's bf16 gradient
  must be within 5e-2 of the leaf's max |JAX gradient| plus twice JAX's own
  bf16 deviation from fp32 for that leaf (both bf16 results may lie that
  far from the exact one); over the whole gradient, the port's distance
  from JAX's must be within 5e-2 of its norm (measured 1.4%), and the
  port's distance from the fp32 gradient at most 1.5 times JAX's (measured
  1.0% against 1.2%).  The entries zero in exact arithmetic
  (``zero_in_exact_arithmetic``) are rounding noise and left out.
- ``SwinConfig.with_cp`` with bf16 compute gives the same loss and
  gradients (1e-6) as without it: the recompute sees the bf16 casts.
- ``python -m codetr_torch.tools.trainbench --device cpu`` on the tiny
  config parses the JAX script's flags and prints its keys.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.parallel import losses as jl
from codetr_torch import build_codetr
from codetr_torch.config import tiny_test_config
from codetr_torch.parallel import losses as tl
from codetr_torch.parallel.train import adamw, make_train_step, run_in_dtype, train_loss
from codetr_torch.tools import trainbench

from test_torch_port_model import perturbed_jax_params, port_from_jax
from test_torch_port_train import _leaves, port_grads, rel, train_inputs, zero_in_exact_arithmetic
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16


def port_batch():
    args = [torch.from_numpy(a) for a in train_inputs()]
    args[3] = args[3].long()
    return args


def test_bf16_step_keeps_fp32_master_weights_and_moves_every_one():
    model = build_codetr(tiny_test_config(), device="cpu", seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(model)
    loss = make_train_step(model, opt, compute_dtype=BF16)(*port_batch())
    assert torch.isfinite(loss)
    nonzero = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        g = p.grad != 0
        nonzero += int(g.sum())
        stuck = g & (p.detach() == start[n])
        assert not stuck.any(), f"{n}: {int(stuck.sum())} of {int(g.sum())} updates lost"
    assert nonzero > 0.9 * sum(p.numel() for p in model.parameters())
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
def jax_bf16():
    """JAX: the bf16 model's loss, gradients (fp32 leaves) and each stage's
    matches (nl + 1, bs, max_gt), from one jitted call."""
    params = perturbed_jax_params(seed=4)
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

    (loss, matches), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), jax.tree.map(np.asarray, grads), np.asarray(matches)


def test_bf16_step_matches_jax(jax_bf16):
    params, want_loss, want_grads, want_matches = jax_bf16
    model = port_from_jax(params)
    batch = port_batch()
    with torch.no_grad():
        out = run_in_dtype(model, BF16, lambda m, x, mk: m.train_outputs(x, mk), *batch[:2])
    dec, enc = tl.match_stages(out, *batch[2:])
    valid = batch[4].numpy()
    got_matches = torch.cat([dec, enc[None]]).numpy()
    for s in range(len(got_matches)):
        np.testing.assert_array_equal(got_matches[s][valid], want_matches[s][valid],
                                      err_msg=f"stage {s}: the two roundings picked different optima")

    loss = train_loss(model, batch, compute_dtype=BF16, backward=True).item()
    assert rel(loss, want_loss) < 1e-2, (loss, want_loss)
    got = _leaves(port_grads(model))
    fp32 = port_from_jax(params)  # the fp32 gradient: test_torch_port_train.py holds it to JAX's
    train_loss(fp32, batch, backward=True)
    exact, want = _leaves(port_grads(fp32)), _leaves(want_grads)
    assert sorted(got) == sorted(want) == sorted(exact)
    keys = sorted(want)
    kept = {k: ~zero_in_exact_arithmetic(k, want[k].shape) for k in keys}
    for k in keys:  # each leaf, on its entries that are not zero in exact arithmetic
        m = kept[k]
        if not m.any():
            continue
        scale = np.abs(want[k][m]).max()
        gap = np.abs(got[k] - want[k])[m].max() / scale
        jax_noise = np.abs(want[k] - exact[k])[m].max() / scale
        assert gap <= 5e-2 + 2 * jax_noise, (k, gap, jax_noise)
    flat = {n: np.concatenate([d[k][kept[k]].ravel() for k in keys]).astype(np.float64)
            for n, d in (("got", got), ("want", want), ("exact", exact))}
    norm = np.linalg.norm
    assert norm(flat["got"] - flat["want"]) <= 5e-2 * norm(flat["want"])
    # the port's bf16 gradient is no farther from the exact one than JAX's
    assert norm(flat["got"] - flat["exact"]) <= 1.5 * norm(flat["want"] - flat["exact"])


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
    assert last["matching_ms_per_step"] > 0 and last["card"] == "cpu"
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
