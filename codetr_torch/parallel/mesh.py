"""The device mesh and the tensor-parallel layout of the parameters.

The port of the JAX package's ``parallel/mesh.py``: a ("dp", "tp") mesh
over the ranks of a ``torch.distributed`` process group, dp splitting the
batch and tp splitting the transformer's wide weights.  Where the JAX
package hands GSPMD a ``NamedSharding`` per leaf and lets XLA insert the
collectives, the port places the same parameters as DTensors on the tp
submesh with ``parallelize_module`` plans whose activations stay ordinary
local tensors, the same on every tp rank:

- a weight split on its output axis (``Shard(0)`` of torch's (out, in)
  Linear weight, the JAX ``P(None, "tp")`` of a flax (in, out) kernel) is
  ``ColwiseParallel``: its bias is split with it, and its output columns
  are gathered (``Replicate``), except for an FFN's fc1 whose fc2 is split
  on its input axis: there fc1's columns stay split through the
  activation and fc2 (``RowwiseParallel`` from ``Shard(-1)``) sums the
  partial products, Megatron's pairing;
- a weight split on its input axis (``Shard(1)``, the JAX ``P("tp",
  None)``) is ``RowwiseParallel``: each rank multiplies its slice of the
  input, the products are summed over tp, the bias stays whole;
- the decoder self-attention's packed ``in_proj_weight`` (3E, E), three
  flax leaves ``q_proj`` / ``k_proj`` / ``v_proj`` in the JAX package, is
  split on its rows: each rank projects its rows (query rows on
  ``query + pos``, value rows on ``query``) and the outputs are gathered
  (``ShardedPackedAttention``);
- every other parameter (norms, biases of input-split weights,
  embeddings, convolutions, tables) stays an ordinary tensor, replicated.

So the MSDA kernels, the matching and the losses see ordinary tensors on
every path this module builds.  ``ops/msda.py``'s two entries that reach
the ``codetr::`` custom ops also take DTensors, through ``local_map``
(the reason is given there).

``make_mesh`` needs an initialised process group (``parallel/dryrun.py``
starts one); NCCL takes one rank per card, so a mesh with tp > 1 on one
card is a gloo group of CPU processes.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

from codetr_torch.models.layers import FFN, _PackedAttention

# mmcv's FFN names: fc1 is ``layers.0.0``, fc2 ``layers.1`` (the
# transformer's ``ffns.0`` and Swin's ``ffn``)
_FC1 = re.compile(r"(^|\.)ffns?(\.\d+)?\.layers\.0\.0\.weight$")
_FC2 = re.compile(r"(^|\.)ffns?(\.\d+)?\.layers\.1\.weight$")


def make_mesh(dp: int | None = None, tp: int = 1, device="cuda") -> DeviceMesh:
    """A (dp, tp) mesh over every rank of the process group."""
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return init_device_mesh(torch.device(device).type, (dp, tp), mesh_dim_names=("dp", "tp"))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{"dp": dp, "tp": tp}``, as the JAX ``dict(mesh.shape)`` prints."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _tp_size(mesh: Union[DeviceMesh, int]) -> int:
    return mesh["tp"].size() if isinstance(mesh, DeviceMesh) else int(mesh)


def param_sharding_rule(name: str, param: torch.Tensor, mesh: Union[DeviceMesh, int]) -> Placement:
    """The tp placement of the weight ``name`` (a mesh, or its tp size):
    the JAX rule (``codetr_tpu/parallel/mesh.py:33-61``) on the port's names
    and torch's (out, in) axes.

    - FFN fc1 (out > in): ``Shard(0)``, the hidden (output) axis;
    - FFN fc2 (in > out): ``Shard(1)``, the hidden (input) axis;
    - Swin's ``qkv`` and the packed ``in_proj_weight``: ``Shard(0)``, the
      head (output) axis; the packed weight when E divides by tp, as the
      JAX rule splits each of its three (E, E) leaves;
    - every other weight whose name holds ``proj`` (Swin's ``proj``, MSDA's
      ``value_proj`` and ``output_proj``, the attention's ``out_proj``):
      ``Shard(1)``, the input axis;

    each only where the split axis divides by tp; anything else, and any
    parameter that is not 2-D, ``Replicate()``.  A bias follows its
    weight (``tp_plan``)."""
    tp = _tp_size(mesh)
    if param.dim() != 2:
        return Replicate()
    d_out, d_in = param.shape
    if _FC1.search(name) and d_out % tp == 0 and d_out > d_in:
        return Shard(0)
    if _FC2.search(name) and d_in % tp == 0 and d_in > d_out:
        return Shard(1)
    if name.endswith("qkv.weight") and d_out % tp == 0:
        return Shard(0)
    if name.endswith("in_proj_weight") and (d_out // 3) % tp == 0:
        return Shard(0)
    if "proj" in name and not name.endswith("in_proj_weight") and d_in % tp == 0:
        return Shard(1)
    return Replicate()


def _split_modules(model: nn.Module, mesh) -> Iterator[Tuple[str, nn.Module, Placement]]:
    """(name, module, weight placement) of every Linear and packed
    attention whose weight the rule splits."""
    for name, module in model.named_modules():
        if isinstance(module, (nn.Linear, _PackedAttention)):
            w = "in_proj_weight" if isinstance(module, _PackedAttention) else "weight"
            placement = param_sharding_rule(f"{name}.{w}", getattr(module, w), mesh)
            if placement != Replicate():
                yield name, module, placement


def tp_plan(model: nn.Module, mesh: Union[DeviceMesh, int]) -> Dict[str, Placement]:
    """Every parameter's tp placement under ``param_sharding_rule``: a
    bias beside a ``Shard(0)`` weight is split with its output axis (the
    JAX rule splits the layer-stacked fc1, qkv and q/k/v biases so), every
    other bias replicated.  ``shard_params`` places the model so."""
    plan = {n: param_sharding_rule(n, p, mesh) for n, p in model.named_parameters()}
    for name, module, placement in _split_modules(model, mesh):
        bias = f"{name}.in_proj_bias" if isinstance(module, _PackedAttention) else f"{name}.bias"
        if bias in plan and placement == Shard(0):
            plan[bias] = Shard(0)
    return plan


class ShardedPackedAttention(_PackedAttention):
    """``_PackedAttention`` with ``in_proj_weight`` / ``in_proj_bias`` split
    on their rows over tp.  Each rank projects its rows, the ones below 2E
    on ``qk_in`` and the rest on ``query``, and the rows' outputs are
    gathered: the split is not head-aligned (a rank of two holds q and
    half of k), so nothing downstream is split."""

    def __init__(self, attn: _PackedAttention, tp_mesh: DeviceMesh):
        nn.Module.__init__(self)
        for n in ("in_proj_weight", "in_proj_bias"):
            setattr(self, n, nn.Parameter(distribute_tensor(getattr(attn, n).detach(), tp_mesh, [Shard(0)])))
        self.out_proj = attn.out_proj

    def project(self, qk_in: torch.Tensor, query: torch.Tensor):
        w, b = self.in_proj_weight, self.in_proj_bias
        mesh, E = w.device_mesh, w.shape[1]
        wl, bl = w.to_local(), b.to_local()
        rows = wl.shape[0]
        split = min(max(2 * E - mesh.get_local_rank() * rows, 0), rows)
        # the identity forward, whose backward sums the ranks' partial input
        # gradients over tp; one tensor, so that every rank's backward
        # reaches the sum whichever input its rows use
        x = DTensor.from_local(torch.stack([qk_in, query]), mesh, replicated(mesh), run_check=False)
        x = x.to_local(grad_placements=[Partial()])
        out = torch.cat([F.linear(x[0], wl[:split], bl[:split]), F.linear(x[1], wl[split:], bl[split:])], -1)
        full = DTensor.from_local(out, mesh, [Shard(out.dim() - 1)], run_check=False).full_tensor()
        return full[..., :E], full[..., E:2 * E], full[..., 2 * E:]


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Places ``model``'s parameters per ``tp_plan`` on the tp submesh, in
    place, and returns it: the split weights (and the biases split with
    them) become DTensors with their ``Shard`` placement, at tp = 1 too (a
    split of one), so that a 1 x 1 mesh runs the tp path's own dispatch;
    the others stay ordinary tensors.  Build the optimizer after."""
    tp_mesh = mesh["tp"]
    split = {name: placement for name, _, placement in _split_modules(model, mesh)}
    # an FFN whose fc1 and fc2 are both split keeps fc1's columns split
    paired = set()
    for name, module in model.named_modules():
        if isinstance(module, FFN):
            fc1, fc2 = f"{name}.layers.0.0", f"{name}.layers.1"
            if split.get(fc1) == Shard(0) and split.get(fc2) == Shard(1):
                paired |= {fc1, fc2}
    plan = {}
    for name, placement in split.items():
        module = model.get_submodule(name)
        if isinstance(module, _PackedAttention):
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent), attr, ShardedPackedAttention(module, tp_mesh))
        elif placement == Shard(0):
            plan[name] = ColwiseParallel(output_layouts=Shard(-1) if name in paired else Replicate())
        else:
            plan[name] = RowwiseParallel(input_layouts=Shard(-1) if name in paired else Replicate())
    parallelize_module(model, tp_mesh, plan)
    return model


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole on this rank: a DTensor gathered, an ordinary tensor as
    it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def placement_of(param: torch.Tensor) -> Placement:
    """A parameter's tp placement: its DTensor placement, else Replicate."""
    return param.placements[-1] if isinstance(param, DTensor) else Replicate()


def sharded_fraction(shapes: Dict[str, Tuple[torch.Size, Placement]]) -> float:
    """The share of 2-D weight elements with a ``Shard`` placement."""
    total = sum(s.numel() for s, _ in shapes.values() if len(s) == 2)
    split = sum(s.numel() for s, p in shapes.values() if len(s) == 2 and p.is_shard())
    return split / max(total, 1)


def assert_tp_sharded(model: nn.Module, mesh: DeviceMesh, *, min_fraction: float = 0.15) -> dict:
    """Fail loudly if the tp rule silently replicated the model, from the
    placed parameters (the JAX ``assert_tp_sharded``): at least one FFN
    fc1 weight ``Shard(0)`` and one fc2 ``Shard(1)``, and at least
    ``min_fraction`` of the 2-D weights' elements split.  Skipped at tp = 1.
    Returns the JAX report dict."""
    tp = mesh["tp"].size()
    if tp == 1:
        return {"tp": 1, "skipped": True}
    placed = {n: (p.shape, placement_of(p)) for n, p in model.named_parameters()}
    assert any(_FC1.search(n) and p == Shard(0) for n, (_, p) in placed.items()), \
        "no FFN fc1 weight sharded Shard(0) — tp rule is a no-op"
    assert any(_FC2.search(n) and p == Shard(1) for n, (_, p) in placed.items()), \
        "no FFN fc2 weight sharded Shard(1) — tp rule is a no-op"
    frac = sharded_fraction(placed)
    assert frac >= min_fraction, (
        f"only {frac:.1%} of 2D-weight elements carry a tp axis (expected >= {min_fraction:.0%})"
    )
    return {"tp": tp, "sharded_2d_fraction": round(frac, 3)}


def batch_sharding(mesh: DeviceMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's slice over dp of a batch (the JAX ``P("dp")``): the
    batch axis in dp equal parts, the part at this rank's dp index."""
    dp = mesh["dp"]
    n, r = dp.size(), dp.get_local_rank()

    def take(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} does not split over dp = {n}")
        k = t.shape[0] // n
        return t[r * k:(r + 1) * k]

    return take


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The placement of a tensor whole on every rank (the JAX ``P()``)."""
    return (Replicate(),) * mesh.ndim


def gather_batch(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole batch from each dp rank's slice: ``batch_sharding``'s
    inverse, an all-gather over dp."""
    return DTensor.from_local(t, mesh["dp"], [Shard(0)], run_check=False).full_tensor()


def sharded_forward(model: nn.Module, mesh: DeviceMesh) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """``forward(batch_inputs, img_masks) -> (boxes, scores, labels)`` of
    the whole batch: each dp rank runs ``model`` (placed by
    ``shard_params``) on its slice, and the detections are gathered over
    dp; the JAX ``jax.jit(model.apply, in_shardings=(None, P("dp"),
    P("dp")))``."""
    take = batch_sharding(mesh)

    @torch.no_grad()
    def forward(batch_inputs: torch.Tensor, img_masks: torch.Tensor):
        return tuple(gather_batch(t, mesh) for t in model(take(batch_inputs), take(img_masks)))

    return forward
