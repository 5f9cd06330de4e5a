"""What each rank of ``test_torch_port_parallel.py``'s gloo group runs.

JAX-free, so that the spawned CPU processes import only torch and the
port: the dry run (``codetr_torch.parallel.dryrun.run_dryrun``, its
results and its printed lines written to ``out``), then the two MSDA
entries that reach the ``codetr::`` custom ops on DTensor arguments.
"""

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from codetr_torch.ops import msda
from codetr_torch.parallel.dryrun import run_dryrun

SHAPES = ((6, 5), (3, 3))
HEADS, DIM, POINTS, QUERIES = 2, 4, 2, 7


def msda_inputs(bs=4, seed=0):
    """Seeded (value, cpk, loc, attn, upstream gradient of each entry)."""
    rng = np.random.default_rng(seed)
    K, L = sum(h * w for h, w in SHAPES), len(SHAPES)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    value = f(bs, K, HEADS, DIM)
    xy = torch.from_numpy(rng.uniform(-0.1, 1.1, (bs, K, HEADS, L, POINTS, 2)).astype(np.float32))
    w = f(bs, K, HEADS, L * POINTS).softmax(-1).reshape(bs, K, HEADS, L, POINTS)
    cpk = msda.pack_coords_qmajor(xy[..., 0].permute(0, 2, 3, 4, 1), xy[..., 1].permute(0, 2, 3, 4, 1),
                                  w.permute(0, 2, 3, 4, 1))
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (bs, QUERIES, HEADS, L, POINTS, 2)).astype(np.float32))
    attn = f(bs, QUERIES, HEADS, L * POINTS).softmax(-1).reshape(bs, QUERIES, HEADS, L, POINTS)
    return value, cpk, loc, attn, f(bs, K, HEADS * DIM), f(bs, QUERIES, HEADS * DIM)


def _entries():
    return {
        "msda_grid_packed": lambda v, c, lo, a: msda.msda_grid_packed(v, SHAPES, c, POINTS),
        "multi_scale_deformable_attention": lambda v, c, lo, a: msda.multi_scale_deformable_attention(
            v, SHAPES, lo, a),
    }


def dtensor_msda_errors() -> dict:
    """Each entry on DTensor arguments (replicated, and split by image)
    over the whole group against the same call on ordinary tensors: the
    largest gaps of the output and of every input's gradient, and the
    output's placements."""
    mesh = init_device_mesh("cpu", (dist.get_world_size(),))
    inputs = msda_inputs()
    errs = {}
    for name, fn in _entries().items():
        g = inputs[4] if name == "msda_grid_packed" else inputs[5]
        plain = [t.clone().requires_grad_() for t in inputs[:4]]
        want = fn(*plain)
        want.backward(g)
        for label, placement in (("replicated", Replicate()), ("split by image", Shard(0))):
            dt = [distribute_tensor(t, mesh, [placement]).requires_grad_() for t in inputs[:4]]
            got = fn(*dt)
            assert isinstance(got, DTensor), name
            got.backward(distribute_tensor(g, mesh, [placement]))
            errs[f"{name}, {label}"] = {
                "placements": str(got.placements),
                "out": (got.full_tensor() - want).abs().max().item(),
                "grads": [(d.grad.full_tensor() - p.grad).abs().max().item()
                          for d, p in zip(dt, plain) if p.grad is not None],
            }
    return errs


def dryrun_and_msda(out: str) -> None:
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        run_dryrun(dist.get_world_size(), device="cpu", out=out)
    errs = dtensor_msda_errors()
    if dist.get_rank() == 0:
        with open(os.path.join(out, "lines.txt"), "w") as f:
            f.write(lines.getvalue())
        torch.save(errs, os.path.join(out, "msda.pt"))
