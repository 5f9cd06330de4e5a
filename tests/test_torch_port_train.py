"""The port's training path against the JAX package, on the CPU.

- Losses: the same seeded logits, boxes and padded ground truth (some gts
  invalid) go to both packages' ``parallel/losses.py``; the matched queries
  of the valid gts must be equal, and the loss values within 1e-6
  relative (the same float32 arithmetic), their gradients within 1e-5 of
  each gradient's scale.
- The train step: the tiny config at 128x128 with a padded mask, the JAX
  package's params perturbed by seeded noise and carried into the port by
  ``state_dict_from_jax``, max_gt 8 with 3 valid.  The port's
  ``make_train_step`` with ``adamw`` against ``jax.value_and_grad`` of the
  JAX loss (its ``parallel/train.py`` loss_fn) and ``optax.adamw(1e-4)``:
  loss 1e-5 relative, each parameter's gradient 1e-4 of its leaf's scale
  (leaves whose JAX gradient is exactly zero: 1e-7 absolute; entries whose
  gradient is zero in exact arithmetic, see ``zero_in_exact_arithmetic``:
  float32 rounding noise below 1e-5 of the largest gradient in both), and
  the parameters after 3 steps within 3 lr absolute, their updates within
  1e-2 lr where the gradients are above noise.  The port's gradients
  are mapped to flax paths with ``convert_state_dict``, a relabelling and
  transpose that applies to gradients as to parameters.  The JAX side runs
  its exact MSDA oracle (``msda_impl="reference"``) and differentiates it
  with AD; kernel K2 itself is held against the port's MSDA gradient in
  ``test_torch_port_msda.py``.
- ``adamw``'s weight decay and eps against ``optax.adamw``'s, on gradients
  where each shows (zero, and near eps).
- ``SwinConfig.with_cp`` gives the same loss and gradients (1e-6).
"""

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
from codetr_tpu.utils.checkpoint import convert_state_dict
from codetr_torch.config import tiny_test_config
from codetr_torch.parallel import losses as tl
from codetr_torch.parallel.train import adamw, make_train_step

from test_torch_port_model import perturbed_jax_params, port_from_jax

H = W = 128
LR = 1e-4
STEPS = 3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def loss_inputs(seed=0, nl=2, bs=2, nq=30, ncls=7, max_gt=8, K=50):
    """Seeded predictions and padded targets, numpy float32 / int32 / bool;
    image b has 3 + b valid gts."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.15, 0.85, (nl + 1, bs, max(nq, K), 2))
    wh = rng.uniform(0.05, 0.4, (nl + 1, bs, max(nq, K), 2))
    coords = np.concatenate([cxcy, wh], -1).astype(np.float32)
    logits = rng.normal(0, 2, (nl + 1, bs, max(nq, K), ncls)).astype(np.float32)
    outputs = {
        "all_cls_logits": logits[:nl, :, :nq],
        "all_coords": coords[:nl, :, :nq],
        "enc_cls_logits": logits[nl, :, :K],
        "enc_coords": coords[nl, :, :K],
    }
    gt = np.concatenate(
        [rng.uniform(0.2, 0.8, (bs, max_gt, 2)), rng.uniform(0.05, 0.3, (bs, max_gt, 2))], -1
    ).astype(np.float32)
    labels = rng.integers(0, ncls, (bs, max_gt)).astype(np.int32)
    valid = np.arange(max_gt)[None] < 3 + np.arange(bs)[:, None]
    gt[~valid] = 0.0  # padding rows, as a data loader pads them
    return outputs, gt, labels, valid


def as_torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def test_hungarian_match_giou_and_qfl_match_jax():
    outputs, gt, labels, valid = loss_inputs()
    cls, coords = outputs["all_cls_logits"][0, 0], outputs["all_coords"][0, 0]
    got_m, got_v = tl.hungarian_match(*(torch.from_numpy(a) for a in (cls, coords, gt[0])),
                                      torch.from_numpy(labels[0]).long(), torch.from_numpy(valid[0]))
    want_m, want_v = jl.hungarian_match(*(jnp.asarray(a) for a in (cls, coords, gt[0], labels[0], valid[0])))
    v = valid[0]
    np.testing.assert_array_equal(got_m.numpy()[v], np.asarray(want_m)[v])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    b1, b2 = (tl.cxcywh_to_xyxy(torch.from_numpy(outputs["all_coords"][i, 0])) for i in range(2))
    want_g = jl.giou(*(jl.cxcywh_to_xyxy(jnp.asarray(outputs["all_coords"][i, 0])) for i in range(2)))
    assert rel(tl.giou(b1, b2).numpy(), want_g) < 1e-6
    assert rel(tl.giou_matrix(b1[:5], b2[:7]).numpy(),
               jl.giou_matrix(jnp.asarray(b1[:5].numpy()), jnp.asarray(b2[:7].numpy()))) < 1e-6
    assert rel(tl.iou_aligned(b1, b2).numpy(),
               jl.iou_aligned(jnp.asarray(b1.numpy()), jnp.asarray(b2.numpy()))) < 1e-6

    quality = np.random.default_rng(1).uniform(0, 1, labels.shape[1]).astype(np.float32)
    m = np.array(want_m)
    got_q = tl.quality_focal_loss(torch.from_numpy(cls), torch.from_numpy(m).long(),
                                  torch.from_numpy(labels[0]).long(), torch.from_numpy(quality),
                                  torch.from_numpy(v))
    want_q = jl.quality_focal_loss(jnp.asarray(cls), jnp.asarray(m), jnp.asarray(labels[0]),
                                   jnp.asarray(quality), jnp.asarray(v))
    assert rel(got_q.item(), want_q) < 1e-6


def test_dino_detection_loss_and_its_gradients_match_jax():
    outputs, gt, labels, valid = loss_inputs(seed=2)
    t_out = {k: v.requires_grad_() for k, v in as_torch(outputs).items()}
    total, logs = tl.dino_detection_loss(t_out, torch.from_numpy(gt), torch.from_numpy(labels).long(),
                                         torch.from_numpy(valid))
    total.backward()

    def f(out):
        return jl.dino_detection_loss(out, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))

    (want_total, want_logs), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    assert rel(total.item(), want_total) < 1e-6
    assert sorted(logs) == sorted(want_logs)
    for k in logs:
        assert rel(logs[k].item(), want_logs[k]) < 1e-6, k
    for k, t in t_out.items():
        assert rel(t.grad.numpy(), grads[k]) < 1e-5, k


def train_inputs():
    rng = np.random.default_rng(11)
    img = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    mask = np.zeros((1, H, W), np.float32)
    mask[:, int(H * 0.75):, :] = 1.0
    mask[:, :, int(W * 0.875):] = 1.0
    max_gt, ncls = 8, jax_tiny_test_config().head.num_classes
    boxes = np.concatenate(
        [rng.uniform(0.2, 0.7, (1, max_gt, 2)), rng.uniform(0.05, 0.3, (1, max_gt, 2))], -1
    ).astype(np.float32)
    labels = rng.integers(0, ncls, (1, max_gt)).astype(np.int32)
    valid = np.arange(max_gt)[None] < 3
    boxes[~valid] = 0.0
    return img, mask, boxes, labels, valid


def port_grads(model):
    """The port's gradients as a flax tree (via ``convert_state_dict``)."""
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for n, p in model.named_parameters()}
    return convert_state_dict(sd, jax_tiny_test_config())


def port_params(model):
    return convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                              jax_tiny_test_config())


@pytest.fixture(scope="module")
def jax_run():
    """JAX: the losses and gradients of STEPS steps of optax.adamw(LR) and
    the params after them; the loss is ``parallel/train.py``'s loss_fn."""
    params = perturbed_jax_params(seed=4)
    img, mask, boxes, labels, valid = (jnp.asarray(a) for a in train_inputs())
    model = JaxCoDETR(cfg=jax_tiny_test_config(), msda_impl="reference")
    tx = optax.adamw(LR)

    def loss_fn(p):
        out = model.apply(p, img, mask, method=model.train_outputs)
        return jl.dino_detection_loss(out, boxes, labels, valid)[0]

    @jax.jit
    def step(p, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, grads

    p, opt_state = params, tx.init(params)
    losses, all_grads = [], []
    for _ in range(STEPS):
        p, opt_state, loss, grads = step(p, opt_state)
        losses.append(float(loss))
        all_grads.append(jax.tree.map(np.asarray, grads))
    return params, losses, all_grads, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def port_run(jax_run):
    params = jax_run[0]
    model = port_from_jax(params)
    step = make_train_step(model, adamw(model, LR))
    args = [torch.from_numpy(a) for a in train_inputs()]
    args[3] = args[3].long()
    losses, all_grads = [], []
    for _ in range(STEPS):
        losses.append(step(*args).item())
        all_grads.append(port_grads(model))
    return losses, all_grads, port_params(model)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_loss_matches_jax(jax_run, port_run):
    assert rel(port_run[0][0], jax_run[1][0]) < 1e-5
    assert np.isfinite(port_run[0]).all()


def zero_in_exact_arithmetic(path: str, shape) -> np.ndarray:
    """Mask of the gradient entries that are zero in exact arithmetic, so
    that float32 gives rounding noise in both packages: the neck's conv
    biases (each GroupNorm group is one channel in the tiny config, so a
    per-channel constant is normalised away), the backbone's output-norm
    biases of the levels that reach the neck only through a 1x1 conv (the
    same; level 3 also feeds the padded 3x3 extra conv), and the key biases
    of the Swin window attention and the decoder self-attention (a softmax
    over keys ignores q.b)."""
    mask = np.zeros(shape, bool)
    if ((path.startswith("['params']['neck']") and path.endswith("_conv']['bias']"))
            or path in {f"['params']['backbone']['norm{i}']['bias']" for i in range(3)}
            or path.endswith("['self_attn']['k_proj']['bias']")):
        mask[...] = True
    elif path.endswith("['w_msa']['qkv']['bias']"):  # [q | k | v]
        C = shape[-1] // 3
        mask[..., C:2 * C] = True
    return mask


def assert_grads_match(got_tree, want_tree, prefix="", skip=()):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    noise = 1e-5 * max(np.abs(w).max() for w in want.values())
    checked = 0
    for k, w in want.items():
        if not k.startswith(prefix) or k in skip:
            continue
        checked += 1
        g, m = got[k], zero_in_exact_arithmetic(k, w.shape)
        assert max(np.abs(g[m]).max(initial=0), np.abs(w[m]).max(initial=0)) <= noise, k
        if not np.any(w[~m]):
            assert np.abs(g[~m]).max(initial=0) <= 1e-7, k
        else:
            assert rel(g[~m], w[~m]) < 1e-4, (k, rel(g[~m], w[~m]))
    assert checked


def test_train_step_gradients_match_jax(jax_run, port_run):
    assert_grads_match(port_run[1][0], jax_run[2][0])


def test_encoder_stage_branch_gradient_matches_jax(jax_run, port_run):
    """The last regression branch (``reg_branches.6`` in Swin-L, ``.2`` in
    the tiny config) serves the encoder stage; its gradient comes from the
    encoder-stage box losses alone, because the decoder's proposals are
    detached from it (as ``jax.lax.stop_gradient`` does in the JAX
    package)."""
    nd = jax_tiny_test_config().head.transformer.num_decoder_layers
    assert_grads_match(port_run[1][0], jax_run[2][0], prefix=f"['params']['query_head']['reg_branches_{nd}']")


def test_params_after_adamw_steps_match_jax(jax_run, port_run):
    """Within 3 lr after 3 steps.  Adam moves a parameter by at most ~lr a
    step whatever its gradient's size, so on the entries whose gradient is
    rounding noise the two packages may step in opposite directions: there
    the bound is 2 x 3 lr (x 1.01 for Adam's bias correction).

    That bound would pass a port that never stepped, so the update itself
    (params after minus before) is held to 1e-2 lr, plus one float32 ulp of
    the parameter, on the entries whose JAX gradient is at least 1e-2 of its
    leaf's scale at every step (there the two gradients agree to ~1e-3 of
    themselves, so the two Adam steps agree)."""
    start, got, want = _leaves(jax_run[0]), _leaves(port_run[2]), _leaves(jax_run[3])
    assert sorted(got) == sorted(want)
    grads = [_leaves(g) for g in jax_run[2]]
    checked = 0
    for k, w in want.items():
        tol = np.where(zero_in_exact_arithmetic(k, w.shape), 2 * 1.01 * STEPS * LR, STEPS * LR)
        assert np.all(np.abs(got[k] - w) <= tol), k
        above_noise = ~zero_in_exact_arithmetic(k, w.shape)
        for g in grads:
            above_noise &= np.abs(g[k]) >= 1e-2 * np.abs(g[k]).max()
        err = np.abs((got[k] - start[k]) - (w - start[k]))[above_noise]
        assert np.all(err <= 1e-2 * LR + np.spacing(np.abs(w[above_noise]))), k
        checked += above_noise.sum()
    assert checked > 0.1 * sum(w.size for w in want.values())
    assert rel(port_run[0][-1], jax_run[1][-1]) < 1e-4


def test_adamw_weight_decay_and_eps_match_optax():
    """``adamw`` against ``optax.adamw`` over 3 steps where each setting
    shows: a row with zero gradients, whose update is pure weight decay
    (lr * 1e-4 * p a step; torch's default of 0.01 would be 100x), within
    1e-2 of itself; a row with gradients near eps = 1e-8, whose update
    lr * g / (|g| + eps) depends on eps, and rows of ordinary gradients,
    within 1e-2 lr.  A large lr makes the decay visible in float32 (at
    1e-4, lr * wd = 1e-8 a step is below its resolution)."""
    lr = 1.0
    rng = np.random.default_rng(5)
    p0 = rng.uniform(1.0, 2.0, (4, 64)).astype(np.float32)
    grads = rng.standard_normal((STEPS, 4, 64)).astype(np.float32)
    grads[:, 0] = 0.0
    grads[:, 1] *= 1e-8
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adamw(torch.nn.ParameterList([p]), lr)
    tx = optax.adamw(lr)
    q, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, q)
        q = optax.apply_updates(q, updates)
    got, want = p.detach().numpy() - p0, np.asarray(q) - p0
    np.testing.assert_allclose(want[0], p0[0] * ((1 - lr * 1e-4) ** STEPS - 1), rtol=1e-2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2)
    assert 0.1 * lr < np.abs(want[1]).mean() < 2 * lr  # eps shapes these updates
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-2 * lr)


def test_with_cp_gives_the_same_loss_and_gradients(jax_run):
    """Recomputing the Swin blocks in the backward pass changes nothing:
    loss and gradients within 1e-6.  Deterministic algorithms are on, since
    the CPU's scatter-adds otherwise differ from run to run by ~3e-6."""
    args = [torch.from_numpy(a) for a in train_inputs()]
    args[3] = args[3].long()
    results = []
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for with_cp in (False, True):
            cfg = tiny_test_config()
            cfg = replace(cfg, swin=replace(cfg.swin, with_cp=with_cp))
            model = port_from_jax(jax_run[0], cfg)
            outputs = model.train_outputs(*args[:2])
            total, _ = tl.dino_detection_loss(outputs, *args[2:])
            total.backward()
            results.append((total.item(), {n: p.grad for n, p in model.named_parameters()}))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (l0, g0), (l1, g1) = results
    assert rel(l1, l0) < 1e-6
    for n in g0:
        assert rel(g1[n].numpy(), g0[n].numpy()) < 1e-6, n

