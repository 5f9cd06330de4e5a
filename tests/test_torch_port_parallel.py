"""The port's sharded (dp x tp) train step, sharded forward and dry run
(``codetr_torch/parallel/mesh.py``, ``dryrun.py``, ``train.py``'s
``init_sharded_state`` / ``jit_train_step``) against the JAX package's
``parallel/``, on the CPU.

- The layout: over the whole tiny model, each port parameter's tp
  placement against the JAX ``param_sharding_rule`` on the flax leaf or
  leaves ``convert_state_dict`` makes of it (JAX side: ``shard_params`` on
  the virtual 8-device mesh of ``tests/conftest.py``, ``device_put``
  only).  A flax kernel is the (in, out) transpose of torch's (out, in)
  weight, and the packed ``in_proj_weight`` becomes three leaves.  The
  JAX package stacks repeated layers on a leading axis, so a stacked
  layer's bias or norm parameter is a 2-D leaf there: the rule then
  splits some on the layer axis (value_proj / output_proj / out_proj
  biases at an even depth), which has no counterpart in the port's
  per-layer parameters (they stay whole), and ``assert_tp_sharded``
  counts them among the 2-D leaves.  So the fractions are held equal on
  the leaves that hold the port's 2-D parameters, and the JAX report on
  the whole tree is shown to differ from that by exactly those stacked
  1-D leaves.
- The JAX unit cases of ``tests/test_parallel.py:17-54`` (mesh, layout,
  refusal of a replicated tree), in one process on a fake 8-rank group.
- One spawned gloo group of 4 CPU processes (``torch_parallel_ranks.py``)
  runs the dry run: the train step at dp = 2, tp = 2 and the forward at
  (2, 2) and (4, 1), then the MSDA entries on DTensors.  The step is held
  against the port's one-device ``make_train_step`` on the same 2-image
  batch, which ``test_torch_port_train.py`` holds against the JAX step:
  the loss within 1e-5 relative, the parameters within that file's
  bounds for one step (lr; 2 x 1.01 lr where the one-device gradient is
  rounding noise, and the update within 1e-2 lr where the gradient is at
  least 1e-2 of its leaf's scale).  The JAX train step is not compiled
  here.  The forward's boxes and scores are held against the JAX
  ``model.apply`` on the same weights (the port's seeded ones through
  ``convert_state_dict``) at ``test_batch_sharded_inference_matches_single``'s
  atol 1e-3 / 1e-4.  The JAX model runs its exact MSDA oracle
  (``msda_impl="reference"``): the port's ``"auto"`` runs the plain MSDA on
  the CPU, and the JAX ``"auto"`` model's interpret-mode kernels take ~26 s
  to compile at this batch; ``test_torch_port_model.py`` holds the two
  ``"auto"`` models together.  The JAX forward compiles while the group
  runs.
- Refusals: a CUDA group larger than the cards visible raises before it
  starts; a rank's failure fails the launcher.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.multiprocessing import ProcessRaisedException

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.parallel import mesh as jmesh
from codetr_tpu.utils.checkpoint import convert_state_dict
from codetr_torch.config import tiny_test_config
from codetr_torch.models.codetr import build_codetr
from codetr_torch.models.layers import FFN
from codetr_torch.parallel import dryrun, mesh
from codetr_torch.parallel.train import adamw, init_sharded_state, make_train_step

import torch_parallel_ranks

LR = 1e-4


@pytest.fixture(scope="module")
def fake_group():
    """An 8-rank process group in this process whose collectives do
    nothing: enough for meshes and placements."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---- the layout against the JAX rule ----


def flax_leaves_of(model):
    """Port parameter name -> [(flax path, leaf shape, JAX spec on the
    (4, 2) mesh)] of the leaves ``convert_state_dict`` puts it in (each
    parameter tagged by a constant value)."""
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    tagged = {k: np.full(tuple(v.shape), names.index(k) + 1 if k in names else 0, np.float64)
              for k, v in sd.items()}
    tree = convert_state_dict(tagged, jax_tiny_test_config())
    jm = jmesh.make_mesh(dp=4, tp=2)
    placed = jmesh.shard_params(tree, jm)
    out = {n: [] for n in names}
    for kp, leaf in jax.tree_util.tree_leaves_with_path(placed):
        path = jax.tree_util.keystr(kp)
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
        for i in np.unique(np.asarray(leaf)).astype(int):
            if i:
                out[names[i - 1]].append((path, leaf.shape, spec))
    return out, placed, jm


def expected_placement(param, leaves):
    """The port placement the JAX spec of ``leaves`` stands for, on the
    parameter's own axes: a Linear weight's flax axes are (in, out)."""
    want = set()
    for _, shape, spec in leaves:
        own = spec[len(shape) - param.dim():]
        if "tp" not in own:
            want.add(Replicate())
        elif param.dim() == 1:
            want.add(Shard(0))
        else:
            want.add(Shard(0) if own[-1] == "tp" else Shard(1))
    assert len(want) == 1, leaves
    return want.pop()


@pytest.fixture(scope="module")
def layout(fake_group):
    model = build_codetr(tiny_test_config(), device="cpu", seed=0)
    leaves, placed, jm = flax_leaves_of(model)
    plan = mesh.tp_plan(model, 2)
    m = mesh.make_mesh(dp=4, tp=2, device="cpu")
    mesh.shard_params(model, m)
    return model, m, leaves, placed, jm, plan


def test_tp_placement_of_every_parameter_matches_the_jax_rule(layout):
    model, _, leaves, _, _, plan = layout
    counts = {"split": 0, "layer_axis_only": 0}
    for n, p in model.named_parameters():
        assert leaves[n], n
        want = expected_placement(p, leaves[n])
        got = mesh.placement_of(p)
        assert got == want == plan[n], (n, got, want, plan[n], leaves[n])
        counts["split"] += got.is_shard()
        # a stacked leaf split on its layer axis alone: whole in the port
        counts["layer_axis_only"] += any(spec[0] == "tp" and len(s) > p.dim() for _, s, spec in leaves[n])
    # split: every fc1 / fc2, qkv, proj and packed in-proj weight and the
    # fc1, qkv and in-proj biases: 6 in each of the 8 Swin blocks, 5 in
    # each of the 2 encoder layers, 8 in each of the 2 decoder layers; the
    # layer axis only: the value_proj / output_proj biases of those 4
    # layers and the decoder's out_proj biases
    assert counts == {"split": 74, "layer_axis_only": 10}, counts


def test_sharded_fraction_matches_the_jax_report(layout):
    model, m, leaves, placed, jm, _ = layout
    report = mesh.assert_tp_sharded(model, m)
    weight_paths = {path for n, p in model.named_parameters() if p.dim() == 2 for path, _, _ in leaves[n]}
    only_weights = {path: leaf for path, leaf in
                    ((jax.tree_util.keystr(kp), leaf) for kp, leaf in jax.tree_util.tree_leaves_with_path(placed))
                    if path in weight_paths}
    assert report == jmesh.assert_tp_sharded(only_weights, jm)
    # the whole tree's report counts the stacked 1-D parameters' leaves too
    full = jmesh.assert_tp_sharded(placed, jm)
    stacked = {path: (int(np.prod(shape)), "tp" in spec) for n, p in model.named_parameters() if p.dim() == 1
               for path, shape, spec in leaves[n] if len(shape) == 2}
    total = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    split = sum(p.numel() for p in model.parameters() if p.dim() == 2 and mesh.placement_of(p).is_shard())
    frac = (split + sum(s for s, t in stacked.values() if t)) / (total + sum(s for s, _ in stacked.values()))
    assert full["sharded_2d_fraction"] == round(frac, 3) != report["sharded_2d_fraction"]


# ---- the JAX unit cases (tests/test_parallel.py:17-54) ----


def test_mesh_construction(fake_group):
    m = mesh.make_mesh(dp=4, tp=2, device="cpu")
    assert mesh.mesh_shape(m) == {"dp": 4, "tp": 2}
    assert mesh.mesh_shape(mesh.make_mesh(tp=2, device="cpu")) == {"dp": 4, "tp": 2}
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(2\) != devices\(8\)"):
        mesh.make_mesh(dp=3, tp=2, device="cpu")


class _Layers(nn.Module):
    """The JAX case's tree on the port's modules: an FFN (64 -> 256 -> 64),
    six layers of an FFN and a qkv projection (the JAX package's stacked
    leaves), and a norm."""

    def __init__(self):
        super().__init__()
        self.ffn = FFN(64, 256)
        self.enc = nn.ModuleList(nn.ModuleDict({"ffn": FFN(64, 256), "qkv": nn.Linear(64, 192)})
                                 for _ in range(6))
        self.norm = nn.LayerNorm(64)


def test_shard_params_tp_layout(fake_group):
    m = mesh.make_mesh(dp=4, tp=2, device="cpu")
    model = mesh.shard_params(_Layers(), m)
    pl = {n: mesh.placement_of(p) for n, p in model.named_parameters()}
    assert pl["ffn.layers.0.0.weight"] == Shard(0) and pl["ffn.layers.1.weight"] == Shard(1)
    assert pl["ffn.layers.0.0.bias"] == Shard(0) and pl["ffn.layers.1.bias"] == Replicate()
    for i in range(6):
        assert pl[f"enc.{i}.ffn.layers.0.0.weight"] == Shard(0)
        assert pl[f"enc.{i}.qkv.weight"] == Shard(0)
    assert pl["norm.weight"] == Replicate() and type(model.norm.weight) is nn.Parameter
    assert mesh.assert_tp_sharded(model, m)["sharded_2d_fraction"] > 0.9


def test_sharded_optimizer_keeps_dtensors_apart(fake_group):
    """``init_sharded_state``'s AdamW: the DTensors and the ordinary tensors
    in separate groups (a foreach kernel, AdamW's default on the card,
    refuses the two kinds together), every parameter once, optax's
    settings in both."""
    model = build_codetr(tiny_test_config(), device="cpu", seed=0)
    opt = init_sharded_state(model, mesh.make_mesh(dp=4, tp=2, device="cpu"))
    kinds = [{type(p).__name__ for p in g["params"]} for g in opt.param_groups]
    assert kinds == [{"Parameter"}, {"DTensor"}], kinds
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.parameters()))
    assert {(g["lr"], g["betas"], g["eps"], g["weight_decay"]) for g in opt.param_groups} == {
        (LR, (0.9, 0.999), 1e-8, 1e-4)}


def test_assert_tp_sharded_rejects_replicated(fake_group):
    """The round-2 audit hole: a silently-replicated tree must FAIL."""
    m = mesh.make_mesh(dp=4, tp=2, device="cpu")
    with pytest.raises(AssertionError, match="no FFN fc1"):
        mesh.assert_tp_sharded(_Layers(), m)
    assert mesh.assert_tp_sharded(_Layers(), mesh.make_mesh(dp=8, tp=1, device="cpu")) == {
        "tp": 1, "skipped": True}


# ---- the gloo group ----


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The 4-rank dry run's results, and the JAX forward on its batch,
    compiled while the ranks run."""
    out = tmp_path_factory.mktemp("dryrun")
    failure = []

    def run():
        try:
            dryrun.launch(torch_parallel_ranks.dryrun_and_msda, 4, "cpu", (str(out),), store_dir=str(out))
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            failure.append(e)

    ranks = threading.Thread(target=run)
    ranks.start()
    model = build_codetr(tiny_test_config(), device="cpu", seed=0, msda_impl="auto")
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jax_tiny_test_config())
    x, masks = dryrun.inference_batch(4, "cpu")
    apply = jax.jit(JaxCoDETR(cfg=jax_tiny_test_config(), msda_impl="reference").apply)
    want = [np.asarray(a) for a in apply(params, jnp.asarray(x.numpy()), jnp.asarray(masks.numpy()))]
    ranks.join()
    if failure:
        raise failure[0]
    return out, want


def test_dryrun_prints_the_jax_ok_lines(group_run):
    lines = (group_run[0] / "lines.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["train dryrun ok", "inference dryrun ok", "inference dryrun ok",
                                                  "dryrun_multichip ok"]
    assert lines[0].startswith("train dryrun ok: mesh={'dp': 2, 'tp': 2} loss=")
    assert lines[0].endswith("tp={'tp': 2, 'sharded_2d_fraction': 0.806}")
    assert lines[1] == ("inference dryrun ok: mesh={'dp': 2, 'tp': 2} impl=auto "
                        "tp={'tp': 2, 'sharded_2d_fraction': 0.806}")
    assert lines[2] == "inference dryrun ok: mesh={'dp': 4, 'tp': 1} impl=auto tp={'tp': 1, 'skipped': True}"
    assert lines[3] == "dryrun_multichip ok: 4 devices"


def test_sharded_train_step_matches_the_one_device_step(group_run):
    got = torch.load(group_run[0] / "train.pt")
    assert got["mesh"] == {"dp": 2, "tp": 2}
    model = build_codetr(tiny_test_config(), device="cpu", seed=0, msda_impl="reference")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = make_train_step(model, adamw(model, LR))(*dryrun.train_batch(2, "cpu")).item()
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (got["loss"], loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    checked = 0
    for n, p in model.named_parameters():
        want, g, zero = p.detach(), grads[n], zero_in_exact_arithmetic(n, p.shape)
        tol = torch.where(zero, 2 * 1.01 * LR, LR)
        assert ((got["params"][n] - want).abs() <= tol).all(), n
        above = ~zero & (g.abs() >= 1e-2 * g.abs().max())
        err = ((got["params"][n] - start[n]) - (want - start[n])).abs()[above]
        assert (err <= 1e-2 * LR + torch.finfo(torch.float32).eps * want[above].abs()).all(), n
        checked += int(above.sum())
    assert checked > 0.1 * sum(p.numel() for p in model.parameters())


def zero_in_exact_arithmetic(name: str, shape) -> torch.Tensor:
    """``test_torch_port_train.py:zero_in_exact_arithmetic`` on the port's
    names: the entries whose gradient is rounding noise on both sides (the
    neck's conv biases ahead of GroupNorms of one channel a group, the
    backbone's output-norm biases of the levels that reach the neck only
    through a 1x1 conv, the key thirds of the attention biases), and at
    the dry run's 32x32 the GroupNorm scales of the neck's two 1x1 levels
    (a group of one element normalises to 0)."""
    mask = torch.zeros(shape, dtype=torch.bool)
    if ((name.startswith("neck.") and name.endswith("conv.bias"))
            or name in {f"backbone.norm{i}.bias" for i in range(3)}
            or name in {"neck.convs.3.gn.weight", "neck.extra_convs.0.gn.weight"}):
        mask[...] = True
    elif name.endswith("w_msa.qkv.bias") or name.endswith("attn.in_proj_bias"):
        mask[shape[0] // 3:2 * shape[0] // 3] = True
    return mask


@pytest.mark.parametrize("mesh_name,n", [("2x2", 2), ("4x1", 4)])
def test_sharded_forward_matches_jax(group_run, mesh_name, n):
    got = torch.load(group_run[0] / f"inference_{mesh_name}.pt")
    boxes, scores, labels = group_run[1]
    np.testing.assert_allclose(got["boxes"].numpy(), boxes[:n], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), scores[:n], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["labels"].numpy(), labels[:n])


def test_inference_batches_share_their_images():
    """The (2, 2) forward's batch is the first half of the (4, 1) one's, so
    one JAX forward serves both."""
    two, four = dryrun.inference_batch(2, "cpu"), dryrun.inference_batch(4, "cpu")
    for a, b in zip(two, four):
        assert torch.equal(a, b[:2])


def test_msda_entries_on_dtensors_match_plain(group_run):
    """``msda_grid_packed`` and ``multi_scale_deformable_attention`` on
    DTensors (replicated, and split by image) over the 4 ranks: the
    output keeps the inputs' placement, and it and every gradient equal
    the ordinary call's within 1e-6."""
    errs = torch.load(group_run[0] / "msda.pt")
    assert len(errs) == 4
    for key, e in errs.items():
        placement = "Replicate()" if key.endswith("replicated") else "Shard(dim=0)"
        assert e["placements"] == f"({placement},)", (key, e)
        assert e["out"] <= 1e-6 and e["grads"] and max(e["grads"]) <= 1e-6, (key, e)


# ---- refusals ----


def test_cuda_group_needs_a_card_per_rank():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} NCCL ranks need {n} CUDA devices .* {n - 1} visible"):
        dryrun.main(["--nproc", str(n), "--device", "cuda"])


def test_a_failing_rank_fails_the_launcher(tmp_path):
    with pytest.raises(ProcessRaisedException, match=r"dp\(0\) \* tp\(3\) != devices\(2\)"):
        dryrun.launch(dryrun._run, 2, "cpu", (2, "cpu", 3), store_dir=str(tmp_path), timeout=120)
