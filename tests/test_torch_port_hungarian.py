"""The port's batched Hungarian matching (``codetr_torch/ops/hungarian.py``)
on the CPU, where ``linear_assignment`` runs its plain version.

- ``linear_assignment_plain`` against ``scipy.optimize.linear_sum_assignment``
  (an oracle independent of both packages) on 200 seeded problems in six
  kinds: square and wide continuous costs, masks with holes, all rows
  invalid, integer costs and duplicated columns (many optimal
  assignments).  The valid rows' total cost must equal scipy's within
  1e-6 relative (float64 sums of the float32 costs); on continuous costs,
  whose optimum is unique, the assignment itself must too, and invalid
  rows get column 0.
- Continuous problems of three kinds through optax's ``hungarian_algorithm``,
  the JAX package's solver, on the valid rows: the same assignment.
- The port's ``hungarian_match`` against the JAX one on seeded predictions
  with holes in the gt mask, and ``dino_detection_loss`` against the JAX
  one on a batch with a holed mask and an image without gts (losses 1e-6
  relative, as ``test_torch_port_train.py`` holds them).
- ``codetr_torch/parallel/losses.py`` imports no scipy: on the card the
  matching never leaves the device.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from codetr_tpu.parallel import losses as jl
from codetr_torch.ops import hungarian
from codetr_torch.parallel import losses as tl

from test_torch_port_train import loss_inputs, rel
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("square", "wide", "holes", "all_invalid", "integer_ties", "duplicated_columns")
PER_KIND = -(-200 // len(KINDS))


def problems(kind: str, seed: int):
    """PER_KIND seeded (cost (P, R, C) float32, row_valid (P, R)) batches."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    out = []
    for _ in range(PER_KIND):
        P = int(rng.integers(1, 4))
        R = int(rng.integers(1, 13))
        C = R if kind == "square" else int(rng.integers(R, 40))
        if kind == "integer_ties":
            cost = rng.integers(0, 4, (P, R, C)).astype(np.float32)
        else:
            cost = (rng.standard_normal((P, R, C)) * 3).astype(np.float32)
        if kind == "duplicated_columns":
            cost[..., 1::2] = cost[..., 0::2][..., :C // 2]
        valid = np.ones((P, R), bool)
        if kind == "holes":
            valid = rng.random((P, R)) < 0.6
        elif kind == "all_invalid":
            valid[:] = False
        elif kind in ("integer_ties", "duplicated_columns"):
            valid = rng.random((P, R)) < 0.8
        out.append((cost, valid))
    return out


def valid_cost(cost, rows, cols) -> float:
    return float(cost[rows, cols].sum(dtype=np.float64))


def transposed_scipy(cost, valid):
    """scipy's answer in ``linear_assignment``'s form for one (R, C) problem
    with more valid rows than columns: each column takes one row of the
    transposed problem, invalid rows at ``INVALID_COST``; rows no column
    takes get 0."""
    c = np.where(valid[:, None], cost, np.float32(hungarian.INVALID_COST)).astype(np.float64)
    q, g = linear_sum_assignment(c.T)
    out = np.zeros(len(cost), np.int64)
    out[g] = q
    return out


def tall_problems(seed, few_valid):
    """Seeded (cost (P, R, C) float32, row_valid) batches with R > C: V <= C
    valid rows (holed), or V > C."""
    rng = np.random.default_rng([seed, int(few_valid)])
    out = []
    for _ in range(12):
        P, C = int(rng.integers(1, 4)), int(rng.integers(1, 13))
        R = C + int(rng.integers(1, 25))
        cost = (rng.standard_normal((P, R, C)) * 3).astype(np.float32)
        valid = np.zeros((P, R), bool)
        for v in valid:
            n = int(rng.integers(0, C + 1)) if few_valid else int(rng.integers(C + 1, R + 1))
            v[rng.permutation(R)[:n]] = True
        out.append((cost, valid))
    return out


@pytest.mark.parametrize("few_valid", [True, False], ids=["valid_le_columns", "valid_gt_columns"])
def test_plain_assignment_of_tall_problems_matches_scipy(few_valid):
    """R > C.  V <= C: the valid rows solved alone, as scipy solves them;
    V > C: scipy on the transposed problem with padding rows at 1e6."""
    for cost, valid in tall_problems(0, few_valid):
        got = hungarian.linear_assignment(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
        for c, v, g in zip(cost, valid, got):
            if v.sum() > c.shape[1]:
                np.testing.assert_array_equal(g, transposed_scipy(c, v))
                continue
            rows = np.nonzero(v)[0]
            r, k = linear_sum_assignment(c[rows].astype(np.float64))
            want = np.zeros(len(v), np.int64)
            want[rows[r]] = k
            np.testing.assert_array_equal(g, want)


def test_a_search_with_no_finite_free_column_stops():
    """Non-finite costs: the search stops rather than loop, and its problem
    gets -1 in every row; the others are solved."""
    cost = np.random.default_rng(3).standard_normal((2, 3, 4)).astype(np.float32)
    cost[0, 1] = np.inf
    got = hungarian.linear_assignment(torch.from_numpy(cost), torch.ones(2, 3, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(got[0], [-1, -1, -1])
    np.testing.assert_array_equal(got[1], linear_sum_assignment(cost[1].astype(np.float64))[1])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_assignment_matches_scipy(kind):
    unique = kind in ("square", "wide", "holes", "all_invalid")  # continuous costs
    for cost, valid in problems(kind, seed=0):
        got = hungarian.linear_assignment(torch.from_numpy(cost), torch.from_numpy(valid))
        assert got.dtype == torch.int64 and got.shape == valid.shape
        got = got.numpy()
        for c, v, g in zip(cost, valid, got):
            rows = np.nonzero(v)[0]
            assert np.all(g[~v] == 0)
            assert len(set(g[rows])) == len(rows)  # one row a column
            r, want = linear_sum_assignment(c[rows].astype(np.float64))
            best = valid_cost(c, rows[r], want)
            assert abs(valid_cost(c, rows, g[rows]) - best) <= 1e-6 * max(abs(best), 1.0)
            if unique:
                np.testing.assert_array_equal(g[rows], want)


@pytest.mark.parametrize("kind", ("square", "wide", "holes"))
def test_plain_assignment_matches_optax(kind):
    for cost, valid in problems(kind, seed=1)[:4]:
        got = hungarian.linear_assignment_plain(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
        for c, v, g in zip(cost, valid, got):
            rows = np.nonzero(v)[0]
            if len(rows) == 0:
                continue
            r, want = optax.assignment.hungarian_algorithm(jnp.asarray(c[rows]))
            np.testing.assert_array_equal(g[rows][np.asarray(r)], np.asarray(want))


def test_assignment_checks_its_inputs():
    cost, valid = torch.zeros(2, 3, 5), torch.ones(2, 3, dtype=torch.bool)
    # more rows than columns, all valid: no longer refused, the transposed
    # problem is solved (each column takes a row; the row left over gets 0)
    tall = np.random.default_rng(5).standard_normal((1, 6, 5)).astype(np.float32)
    got = hungarian.linear_assignment(torch.from_numpy(tall), torch.ones(1, 6, dtype=torch.bool))[0].numpy()
    np.testing.assert_array_equal(got, transposed_scipy(tall[0], np.ones(6, bool)))
    with pytest.raises(TypeError, match="float32"):
        hungarian.linear_assignment(cost.double(), valid)
    with pytest.raises(ValueError, match="row_valid"):
        hungarian.linear_assignment(cost, valid[:, :2])
    with pytest.raises(ValueError, match="CPU .plain version. or CUDA"):
        hungarian.linear_assignment(cost.to("meta"), valid.to("meta"))
    assert hungarian.linear_assignment(torch.zeros(0, 3, 5), torch.ones(0, 3, dtype=torch.bool)).shape == (0, 3)


@pytest.mark.parametrize("seed", range(4))
def test_hungarian_match_with_holes_matches_jax(seed):
    outputs, gt, labels, valid = loss_inputs(seed=10 + seed, max_gt=12)
    valid = np.random.default_rng(seed).random(valid.shape) < 0.6  # holes, not a prefix
    for stage, b in ((0, 0), (1, 1)):
        cls, coords = outputs["all_cls_logits"][stage, b], outputs["all_coords"][stage, b]
        got_m, got_v = tl.hungarian_match(*(torch.from_numpy(a) for a in (cls, coords, gt[b])),
                                          torch.from_numpy(labels[b]).long(), torch.from_numpy(valid[b]))
        want_m, _ = jl.hungarian_match(*(jnp.asarray(a) for a in (cls, coords, gt[b], labels[b], valid[b])))
        v = valid[b]
        np.testing.assert_array_equal(got_m.numpy()[v], np.asarray(want_m)[v])
        assert np.all(got_m.numpy()[~v] == 0) and torch.equal(got_v, torch.from_numpy(v))


def test_dino_detection_loss_with_holes_and_an_empty_image_matches_jax():
    outputs, gt, labels, _ = loss_inputs(seed=7, bs=3)
    valid = np.array([[1, 0, 1, 1, 0, 0, 1, 0], [0] * 8, [0, 1, 1, 0, 1, 0, 0, 1]], bool)
    total, logs = tl.dino_detection_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                                         torch.from_numpy(gt), torch.from_numpy(labels).long(),
                                         torch.from_numpy(valid))
    want_total, want_logs = jax.jit(jl.dino_detection_loss)(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))
    assert rel(total.item(), want_total) < 1e-6
    for k in want_logs:
        assert rel(logs[k].item(), want_logs[k]) < 1e-6, k
    dec, enc = tl.match_stages({k: torch.from_numpy(v) for k, v in outputs.items()},
                               torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(valid))
    assert dec.shape == (2, 3, 8) and enc.shape == (3, 8)
    assert not dec[:, 1].any() and not enc[1].any()  # the image without gts: zeros


def test_dino_detection_loss_names_non_finite_costs():
    """An image whose decoder outputs are all NaN: its matching problems
    get -1 in every row, and the loss stops with an error that names the
    costs instead of gathering at -1."""
    outputs, gt, labels, _ = loss_inputs(seed=7, bs=3)
    outputs = {k: torch.from_numpy(v) for k, v in outputs.items()}
    outputs["all_cls_logits"][:, 1] = float("nan")
    outputs["all_coords"][:, 1] = float("nan")
    valid = torch.ones(gt.shape[:2], dtype=torch.bool)
    with pytest.raises(RuntimeError, match="matching costs are not finite"):
        tl.dino_detection_loss(outputs, torch.from_numpy(gt), torch.from_numpy(labels).long(), valid)


def repro_inputs(n_valid, nq=12, ncls=7, max_gt=32):
    """12 queries, max_gt 32 of which ``n_valid`` valid: seeded logits,
    boxes and labels."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((nq, ncls)).astype(np.float32)
    coords = np.concatenate([rng.uniform(0.2, 0.8, (nq, 2)), rng.uniform(0.05, 0.4, (nq, 2))], -1)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (max_gt, 2)), rng.uniform(0.05, 0.3, (max_gt, 2))], -1)
    labels = rng.integers(0, ncls, max_gt).astype(np.int32)
    valid = np.arange(max_gt) < n_valid
    return logits, coords.astype(np.float32), gt.astype(np.float32), labels, valid


@pytest.mark.parametrize("n_valid", [7, 12, 15, 32])
def test_more_padded_gts_than_queries_matches_jax(n_valid):
    """max_gt 32 over 12 queries.  Up to 12 valid: each valid gt gets JAX's
    query.  More: JAX (optax on the transposed problem) gives each query a
    gt and leaves the other valid gts on query 0 with match_valid True;
    the port does the same, so every valid gt's query and the mask are
    equal.  Invalid gts get query 0 in the port (JAX gives them the queries
    its padding rows took), with match_valid False in both."""
    logits, coords, gt, labels, valid = repro_inputs(n_valid)
    got_m, got_v = tl.hungarian_match(*(torch.from_numpy(a) for a in (logits, coords, gt)),
                                      torch.from_numpy(labels).long(), torch.from_numpy(valid))
    want_m, want_v = jl.hungarian_match(*(jnp.asarray(a) for a in (logits, coords, gt, labels, valid)))
    np.testing.assert_array_equal(got_m.numpy()[valid], np.asarray(want_m)[valid])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.all(got_m.numpy()[~valid] == 0)
    taken = set(got_m.numpy()[valid].tolist())
    assert taken == set(range(12)) if n_valid >= 12 else len(taken) == n_valid  # each query once


@pytest.fixture(scope="module")
def tiny_outputs():
    """The tiny config's training outputs (6 decoder layers over 12 queries,
    the encoder stage over its tokens) from the JAX model at 64x64, batch 3."""
    from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
    from codetr_tpu.models.codetr import CoDETR as JaxCoDETR

    from test_torch_port_model import perturbed_jax_params

    params = perturbed_jax_params(seed=6)
    rng = np.random.default_rng(12)
    img = jnp.asarray(rng.standard_normal((3, 64, 64, 3)).astype(np.float32))
    mask = jnp.zeros((3, 64, 64), jnp.float32)
    model = JaxCoDETR(cfg=jax_tiny_test_config(), msda_impl="reference")
    out = jax.jit(lambda p, x, m: model.apply(p, x, m, method=model.train_outputs))(params, img, mask)
    return {k: np.array(v) for k, v in out.items()}


def test_dino_detection_loss_with_max_gt_32_at_the_tiny_config_matches_jax(tiny_outputs):
    """max_gt 32 over the tiny config's 12 queries, with 7, 15 and 32 valid
    gts in the three images: the total loss and each logged loss equal the
    JAX package's (1e-6 relative), and the decoder stages' matches of the
    valid gts equal JAX's ``hungarian_match``."""
    nq = tiny_outputs["all_cls_logits"].shape[2]
    assert nq == 12
    rng = np.random.default_rng(13)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (3, 32, 2)), rng.uniform(0.05, 0.3, (3, 32, 2))], -1)
    gt = gt.astype(np.float32)
    labels = rng.integers(0, tiny_outputs["all_cls_logits"].shape[-1], (3, 32)).astype(np.int32)
    valid = np.arange(32)[None] < np.array([7, 15, 32])[:, None]
    gt[~valid] = 0.0
    total, logs = tl.dino_detection_loss({k: torch.from_numpy(v) for k, v in tiny_outputs.items()},
                                         torch.from_numpy(gt), torch.from_numpy(labels).long(),
                                         torch.from_numpy(valid))
    want_total, want_logs = jax.jit(jl.dino_detection_loss)(
        {k: jnp.asarray(v) for k, v in tiny_outputs.items()}, jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(valid))
    assert rel(total.item(), want_total) < 1e-6
    for k in want_logs:
        assert rel(logs[k].item(), want_logs[k]) < 1e-6, k
    dec, _ = tl.match_stages({k: torch.from_numpy(v) for k, v in tiny_outputs.items()},
                             torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(valid))
    for layer in (0, dec.shape[0] - 1):
        for b in range(3):
            want_m, _ = jl.hungarian_match(*(jnp.asarray(a) for a in (
                tiny_outputs["all_cls_logits"][layer, b], tiny_outputs["all_coords"][layer, b],
                gt[b], labels[b], valid[b])))
            np.testing.assert_array_equal(dec[layer, b].numpy()[valid[b]], np.asarray(want_m)[valid[b]])


def test_losses_module_imports_no_scipy():
    src = Path(tl.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "scipy" not in names, names
    assert "torch" in names
