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
    with pytest.raises(ValueError, match="rows <= columns"):
        hungarian.linear_assignment(torch.zeros(1, 6, 5), torch.ones(1, 6, dtype=torch.bool))
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
