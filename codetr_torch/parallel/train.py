"""The Co-DINO training step with the query-head losses.

The port of the JAX package's ``parallel/train.py`` on one device:
``model.train_outputs`` (the per-layer and encoder-stage predictions before
top-k) -> ``dino_detection_loss`` (Hungarian matching + QFL / L1 / GIoU over
every decoder layer and the encoder stage) -> backward -> AdamW.  The step
runs on the model's device; on the card the MSDA forward and backward are
the hand-written kernels.  An fp32 model's step, backward included, runs in
full fp32 (``models.codetr.full_fp32``: TF32 off for cuDNN and matmuls,
the caller's flags restored after).

Mixed precision is the JAX package's ``dtype=bfloat16, param_dtype=float32``
with ``optax.adamw``: the model holds fp32 parameters, and with
``compute_dtype=torch.bfloat16`` each step runs the forward and backward
on bf16 casts of the parameters and floating buffers
(``torch.func.functional_call``), except ``models.codetr.
fp32_parameter_names``' (the LayerNorm and GroupNorm affine parameters,
the frozen BatchNorm's four tensors, Swin's relative-position bias
tables), which the JAX bf16 model uses in float32 and which reach the
model as their fp32 leaves, uncast: the step's forward is the served bf16
model's (``to_compute_dtype``) bit for bit.  The casts' gradients come
back to the fp32 leaves in fp32, and AdamW updates fp32 leaves with fp32
state.  A model whose parameters are not fp32 is refused: AdamW's first
steps move a weight by ~lr, below half a bf16 ulp of most weights, so
bf16 leaves would lose most updates.

The sharded step is the JAX package's ``init_sharded_state`` /
``jit_train_step`` over a ("dp", "tp") mesh (``parallel/mesh.py``): tp by
the DTensor placements of ``shard_params``, dp by one all-reduce of the
gradients over the dp ranks.  Each dp rank takes its slice of the batch
and divides its losses by the whole batch's valid gts, so the ranks' sums
are the whole batch's loss and gradient, as GSPMD computes them.  It runs
in full fp32.

``capture_train_step`` is the one-device counterpart of the JAX package's
``jax.jit(step)``: the whole step, zero_grad to
``optimizer.step()``, captured once on the card in one CUDA graph and
replayed for each batch.  Its warm-up does not train: the parameters,
buffers and optimizer state are put back in place after the capture, so
the first replay is the first step.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Any, Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from codetr_torch.models.codetr import fp32_parameter_names, full_fp32
from codetr_torch.parallel.losses import dino_detection_loss
from codetr_torch.runtime import aot

if TYPE_CHECKING:  # torch.distributed.tensor takes ~1 s to import: the sharded step imports it
    from torch.distributed.device_mesh import DeviceMesh


# optax.adamw's defaults: its weight decay is 1e-4, not torch's 0.01
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def adamw(model: nn.Module | Iterable, lr: float = 1e-4, *, capturable: bool = False) -> torch.optim.AdamW:
    """The optimizer equal to ``optax.adamw(lr)``: betas (0.9, 0.999), eps
    1e-8 and optax's weight decay of 1e-4 (not torch's default 0.01), over
    a model's parameters (or given parameters or parameter groups).
    ``capturable=True`` keeps its step count on the device, as
    ``capture_train_step`` needs; the arithmetic is the same."""
    return torch.optim.AdamW(
        model.parameters() if isinstance(model, nn.Module) else model, lr=lr, betas=BETAS, eps=EPS,
        weight_decay=WEIGHT_DECAY, capturable=capturable,
    )


@torch.no_grad()
def adamw_moves(param: torch.Tensor, grad: torch.Tensor, lr: float = 1e-4) -> torch.Tensor:
    """Where ``adamw``'s first step (zero moments) on ``param`` with ``grad``
    moves an entry: the step computed in float64 and rounded to
    ``param``'s dtype differs from ``param``.  An entry whose gradient is
    tiny (a denormal ~1e-44 moves a weight by ~lr x 1e-36) stays put in
    float32, under ``optax.adamw`` too; the checks of which entries a step
    moved hold it to this."""
    b1, b2 = BETAS
    p, g = param.double(), grad.double()
    m, v = (1 - b1) * g, (1 - b2) * g * g
    stepped = p * (1 - lr * WEIGHT_DECAY) - (lr / (1 - b1)) * m / (v.sqrt() / (1 - b2) ** 0.5 + EPS)
    return stepped.to(param.dtype) != param


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module, fn: Callable[..., Any]):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def run_in_dtype(model: nn.Module, compute_dtype: torch.dtype, fn: Callable[..., Any], *args):
    """``fn(model, *args)`` with the model's floating parameters and buffers
    replaced by casts to ``compute_dtype`` for the length of the call, but
    for ``fp32_parameter_names(model)``, which stay as they are (the JAX
    model's float32 tensors in every compute dtype).  The casts are autograd
    ops, so a backward pass reaches the fp32 leaves in fp32 (as ``astype``'s
    VJP does in JAX); run it inside ``fn``, so that ``SwinConfig.with_cp``'s
    recompute sees the casts too."""
    keep = fp32_parameter_names(model)
    casts = {f"model.{n}": t.to(compute_dtype)
             for n, t in itertools.chain(model.named_parameters(), model.named_buffers())
             if t.is_floating_point() and n not in keep}
    return torch.func.functional_call(_Bound(model, fn), casts, args)


def _loss(model: nn.Module, batch: Sequence[torch.Tensor], backward: bool,
          num_gts: Optional[torch.Tensor] = None) -> torch.Tensor:
    outputs = model.train_outputs(*batch[:2])
    total, _ = dino_detection_loss(outputs, *batch[2:], num_gts=num_gts)
    if backward:
        total.backward()
    return total.detach()


def _check_master_weights(model: nn.Module, compute_dtype: Optional[torch.dtype]) -> None:
    dtypes = {p.dtype for p in model.parameters()}
    if dtypes != {torch.float32}:
        raise ValueError(
            f"training takes fp32 parameters, got {sorted(map(str, dtypes))}: build the model in "
            "float32 and pass compute_dtype=torch.bfloat16 for bf16 compute"
        )
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None, torch.float32 or torch.bfloat16, got {compute_dtype}")


def train_loss(model: nn.Module, batch: Sequence[torch.Tensor], *,
               compute_dtype: Optional[torch.dtype] = None, backward: bool = False,
               num_gts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The detached training loss of ``model`` on ``batch`` = (batch_inputs,
    img_masks, gt_boxes, gt_labels, gt_valid), with its backward pass into
    the parameters' ``.grad`` when ``backward``: the step's forward and
    backward, without the update.  fp32 parameters only; ``compute_dtype``
    as in ``make_train_step``; ``num_gts`` as in ``dino_detection_loss``."""
    _check_master_weights(model, compute_dtype)
    if compute_dtype in (None, torch.float32):
        with full_fp32():
            return _loss(model, batch, backward, num_gts)
    return run_in_dtype(model, compute_dtype, _loss, batch, backward, num_gts)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable[..., torch.Tensor]:
    """Returns ``step(batch_inputs, img_masks, gt_boxes, gt_labels,
    gt_valid) -> loss``.  Targets: gt_boxes (bs, max_gt, 4) normalised
    cxcywh, gt_labels (bs, max_gt) int, gt_valid (bs, max_gt) bool, all on
    the model's device.  The model's parameters must be fp32 (else
    ``ValueError``); ``compute_dtype=torch.bfloat16`` computes in bf16
    (module docstring), None or float32 in full fp32.

    Unlike the JAX package's pure step, this one updates the model's
    parameters and the optimizer's state in place; each parameter's
    ``.grad`` holds the gradient of the returned (detached) loss until the
    next step."""
    _check_master_weights(model, compute_dtype)

    def step(*batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        total = train_loss(model, batch, compute_dtype=compute_dtype, backward=True)
        optimizer.step()
        return total

    return step


def init_sharded_state(model: nn.Module, mesh: DeviceMesh, lr: float = 1e-4) -> torch.optim.AdamW:
    """Places ``model``'s parameters on ``mesh`` (``shard_params``, in
    place) and returns ``adamw`` over the placed parameters: the JAX
    ``init_sharded_state``'s params and optimizer state.  The DTensors and
    the ordinary tensors are two parameter groups: AdamW's foreach kernels
    (its default on the card) take one kind at a time."""
    from torch.distributed.tensor import DTensor

    from codetr_torch.parallel.mesh import shard_params

    params = list(shard_params(model, mesh).parameters())
    groups = ([p for p in params if not isinstance(p, DTensor)], [p for p in params if isinstance(p, DTensor)])
    return adamw([{"params": g} for g in groups if g], lr)


def _sum_over(group: dist.ProcessGroup, tensors: Sequence[torch.Tensor]) -> None:
    """Sums ``tensors`` (ordinary tensors or DTensors' local shards) over
    ``group`` in place, in one all-reduce."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
        flat = torch._utils._flatten_dense_tensors(local)
        dist.all_reduce(flat, group=group)
        for t, s in zip(local, torch._utils._unflatten_dense_tensors(flat, local)):
            t.copy_(s)


def jit_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                   mesh: DeviceMesh) -> Callable[..., torch.Tensor]:
    """The sharded step (the JAX ``jit_train_step``): ``step(batch_inputs,
    img_masks, gt_boxes, gt_labels, gt_valid) -> loss`` takes the whole
    batch on every rank (as ``make_train_step``'s), runs this rank's dp
    slice (``batch_sharding``) through ``model`` placed by
    ``shard_params`` (``init_sharded_state``), sums the gradients and the
    loss over dp, and steps ``optimizer``.  The loss returned is the whole
    batch's, on every rank.  fp32 only (``make_train_step``'s ValueError
    otherwise); the batch size must divide by dp."""
    from codetr_torch.parallel.mesh import batch_sharding

    _check_master_weights(model, None)
    take, group = batch_sharding(mesh), mesh["dp"].get_group()

    def step(*batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        num_gts = batch[4].sum().float()
        total = train_loss(model, [take(t) for t in batch], backward=True, num_gts=num_gts)
        _sum_over(group, [p.grad for p in model.parameters() if p.grad is not None] + [total])
        optimizer.step()
        return total

    return step


def snapshot_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable[[], None]:
    """Copies of the model's parameters and buffers and of the optimizer's
    state as they are now; returns ``restore()``, which writes them back in
    place (the same storage, so a captured graph's pointers stay valid).
    Optimizer state made after the snapshot is zeroed in place: a fresh
    Adam's or AdamW's (step 0, moments 0)."""
    with torch.no_grad():
        saved = [(t, t.detach().clone())
                 for t in itertools.chain(model.parameters(), model.buffers())]
        held = {p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
                for p, s in optimizer.state.items()}

    def restore() -> None:
        with torch.no_grad():
            for t, copy in saved:
                t.copy_(copy)
            for p, s in optimizer.state.items():
                before = held.get(p, {})
                for k, v in s.items():
                    if not torch.is_tensor(v):
                        continue
                    if k in before:
                        v.copy_(before[k])
                    else:
                        v.zero_()

    return restore


# eager steps before the capture: the first makes AdamW's state, the second
# runs the step as every replay will
WARMUP_STEPS = 2


def _capturable(optimizer: torch.optim.Optimizer) -> bool:
    return (isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))
            and all(g.get("capturable", False) for g in optimizer.param_groups))


def capture_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       example_batch: Sequence[torch.Tensor], *,
                       compute_dtype: Optional[torch.dtype] = None) -> Callable[..., torch.Tensor]:
    """``make_train_step``'s step captured once on the card in one CUDA graph
    (``runtime.aot.Replay``): zero_grad, ``train_outputs``, the losses and
    their two matching launches, the backward with the MSDA backward
    kernels, and ``optimizer.step()``.  Returns ``step(*batch) -> loss``,
    which copies the batch into the graph's static inputs, replays it and
    returns a clone of the loss; like the eager step it updates the
    parameters, their ``.grad`` and the optimizer's state in place.  The
    batch must have ``example_batch``'s shapes and dtypes.

    ``optimizer`` must be an Adam or AdamW built with ``capturable=True``
    (``adamw(model, capturable=True)``), else ``ValueError``; so must a
    model on the CPU (a graph needs the card: there is no eager fallback).
    The ``WARMUP_STEPS`` steps that the capture needs run on a side stream
    and are undone (``snapshot_train_state``): after the capture the model
    and the optimizer are as they were, the gradients zero, and the first
    replay is the first step.  A capture that fails raises, naming the op it
    stopped at, with the model and optimizer put back as well.  The graph's
    memory pool holds one step's activations for as long as the returned
    step lives (``step.replay``); do not call ``torch.cuda.empty_cache()``
    until it is dropped (``runtime/aot.py``)."""
    _check_master_weights(model, compute_dtype)
    if not _capturable(optimizer):
        raise ValueError("capture_train_step needs an Adam or AdamW built with capturable=True "
                         "(adamw(model, capturable=True))")
    if next(model.parameters()).device.type != "cuda":
        raise ValueError("capture_train_step captures a CUDA graph: it needs the model on the card")
    shapes = [(t.shape, t.dtype) for t in example_batch]
    body = make_train_step(model, optimizer, compute_dtype=compute_dtype)
    restore = snapshot_train_state(model, optimizer)
    try:
        replay = aot.Replay(lambda *batch: (body(*batch),), example_batch, warmup=WARMUP_STEPS)
    finally:
        restore()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.zero_()

    def step(*batch) -> torch.Tensor:
        if [(t.shape, t.dtype) for t in batch] != shapes:
            raise ValueError(f"the step was captured for {shapes}, got {[(t.shape, t.dtype) for t in batch]}")
        return replay(*batch)[0]

    step.replay = replay
    return step
