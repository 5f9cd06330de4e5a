"""Multi-device dry run: one sharded (dp x tp) train step and one sharded
production forward of the tiny model, on tiny shapes.

The port of the JAX package's ``parallel/dryrun.py``, with its mesh
choices, shapes and printed ``... dryrun ok`` lines, run in every rank of
a ``torch.distributed`` group: the sharded step must run, place a tree
that ``assert_tp_sharded`` accepts and give a finite loss; the sharded
forward must give finite boxes.  ``python -m codetr_torch.parallel.dryrun
--nproc N`` is the JAX ``__graft_entry__.dryrun_multichip``: it starts N
processes, one NCCL rank per card (``--device cuda``, the default; N
must not exceed the cards visible) or a gloo group of CPU processes
(``--device cpu``).  NCCL takes one rank per card, so on one card the
mesh is 1 x 1, where ``assert_tp_sharded`` skips itself as the JAX one
does; a mesh with tp > 1 needs several cards or the CPU group.

``run_dryrun(..., out=DIR)`` writes each dry run's results from rank 0
as torch files: ``train.pt`` (the loss and the parameters after the step,
gathered whole) and ``inference_{dp}x{tp}.pt`` (the detections).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from codetr_torch.config import tiny_test_config
from codetr_torch.models.codetr import build_codetr
from codetr_torch.parallel.mesh import (
    assert_tp_sharded,
    make_mesh,
    mesh_shape,
    shard_params,
    sharded_forward,
    whole,
)
from codetr_torch.parallel.train import init_sharded_state, jit_train_step

H = W = 32
MAX_GT = 8
# seconds a group may take to start, and a collective to finish, before a
# rank fails (and with it the launcher): a hung collective raises
TIMEOUT_S = 180


def train_batch(bs: int, device) -> list:
    """The JAX dry run's training batch: N(0, 1) images (seed 0), no
    padding, two boxes tiled over ``MAX_GT`` gts of which 3 are valid."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((bs, H, W, 3)).astype(np.float32))
    masks = torch.zeros(bs, H, W)
    boxes = torch.tensor([[0.3, 0.3, 0.2, 0.2], [0.7, 0.6, 0.3, 0.4]] * (MAX_GT // 2))[None].repeat(bs, 1, 1)
    labels = (torch.arange(MAX_GT) % 3)[None].repeat(bs, 1)
    valid = (torch.arange(MAX_GT) < 3)[None].repeat(bs, 1)
    return [t.to(device) for t in (x, masks, boxes, labels, valid)]


def inference_batch(bs: int, device) -> list:
    """The JAX dry run's inference batch: N(0, 1) images (seed 1), rows
    24: padded (the valid-ratio / padded-key path)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((bs, H, W, 3)).astype(np.float32))
    masks = torch.zeros(bs, H, W)
    masks[:, 24:, :] = 1.0
    return [x.to(device), masks.to(device)]


def _say(line: str) -> None:
    """Rank 0 prints (every rank checked what it says)."""
    if dist.get_rank() == 0:
        print(line, flush=True)


def _train_dryrun(dp: Optional[int], tp: int, device, out: Optional[str]) -> float:
    mesh = make_mesh(dp=dp, tp=tp, device=device)
    model = build_codetr(tiny_test_config(), device=device, seed=0, msda_impl="reference")
    optimizer = init_sharded_state(model, mesh)
    report = assert_tp_sharded(model, mesh)
    step = jit_train_step(model, optimizer, mesh)
    loss = float(step(*train_batch(mesh_shape(mesh)["dp"], device)))
    assert np.isfinite(loss), f"dryrun loss not finite: {loss}"
    if out:  # every rank takes part in the gathers
        params = {n: whole(p.detach()).cpu() for n, p in model.named_parameters()}
        if dist.get_rank() == 0:
            torch.save({"loss": loss, "params": params, "mesh": mesh_shape(mesh)}, os.path.join(out, "train.pt"))
    _say(f"train dryrun ok: mesh={mesh_shape(mesh)} loss={loss:.4f} tp={report}")
    return loss


def _inference_dryrun(dp: Optional[int], tp: int, device, out: Optional[str]) -> None:
    """The production dispatch (``msda_impl="auto"``: the kernels on the
    card, their plain versions on the CPU), dp-sharded batch, tp-placed
    parameters."""
    mesh = make_mesh(dp=dp, tp=tp, device=device)
    model = build_codetr(tiny_test_config(), device=device, seed=0, msda_impl="auto")
    shard_params(model, mesh)
    report = assert_tp_sharded(model, mesh)
    boxes, scores, labels = sharded_forward(model, mesh)(*inference_batch(mesh_shape(mesh)["dp"], device))
    assert torch.isfinite(boxes).all(), "sharded inference produced non-finite boxes"
    shape = mesh_shape(mesh)
    if out and dist.get_rank() == 0:
        torch.save({"boxes": boxes.cpu(), "scores": scores.cpu(), "labels": labels.cpu(), "mesh": shape},
                   os.path.join(out, f"inference_{shape['dp']}x{shape['tp']}.pt"))
    _say(f"inference dryrun ok: mesh={shape} impl=auto tp={report}")


def run_dryrun(n_devices: int, *, dp: Optional[int] = None, tp: Optional[int] = None,
               device="cuda", out: Optional[str] = None) -> None:
    """The JAX ``run_dryrun`` in each rank of a group of ``n_devices``
    ranks: the train step at dp x tp (tp 2 when n is even), then the
    forward at (max(2, n // 4), n // max(2, n // 4)) and (n, 1) when n >= 4
    and tp > 1, else at dp x tp."""
    n = dist.get_world_size()
    if n != n_devices:
        raise RuntimeError(f"the dry run asks for {n_devices} devices, the group has {n} ranks")
    if tp is None:
        tp = 2 if (n % 2 == 0 and n >= 2) else 1
    _train_dryrun(dp, tp, device, out)
    if n >= 4 and tp > 1:
        _inference_dryrun(max(2, n // 4), n // max(2, n // 4), device, out)
        _inference_dryrun(n, 1, device, out)
    else:
        _inference_dryrun(None, tp, device, out)
    _say(f"dryrun_multichip ok: {n} devices")


def _rank_main(rank: int, fn: Callable, nproc: int, device: str, store: str, args: tuple) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"file://{store}",
                            rank=rank, world_size=nproc, timeout=timedelta(seconds=TIMEOUT_S),
                            device_id=torch.device("cuda", rank) if device == "cuda" else None)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nproc: int, device: str = "cuda", args: Sequence = (), *,
           store_dir: Optional[str] = None, timeout: float = TIMEOUT_S) -> None:
    """``fn(*args)`` in each of ``nproc`` spawned ranks of one group: NCCL,
    rank r on ``cuda:r`` (``device="cuda"``; raises if fewer cards are
    visible), or gloo on the CPU, one thread each (``"cpu"``).  The ranks
    meet through a file store in ``store_dir`` (a temporary directory by
    default).  Raises if a rank fails (the others are stopped), or if the
    ranks have not all finished within ``timeout`` seconds."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and nproc > torch.cuda.device_count():
        raise RuntimeError(f"{nproc} NCCL ranks need {nproc} CUDA devices (one rank per card), "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, nproc, device, os.path.join(tmp, "store"), tuple(args)),
                                 nprocs=nproc, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the {nproc} ranks did not finish within {timeout} s")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True, help="ranks (devices) in the group")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one NCCL rank per card; cpu: a gloo group of CPU processes")
    args = ap.parse_args(argv)
    launch(_run, args.nproc, args.device, (args.nproc, args.device))


def _run(nproc: int, device: str, tp: Optional[int] = None) -> None:
    run_dryrun(nproc, tp=tp, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
