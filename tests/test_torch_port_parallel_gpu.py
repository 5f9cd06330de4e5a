"""The sharded train step (``parallel/train.py:jit_train_step``) on the
card, at world 1: an NCCL group of one rank and a 1 x 1 mesh, against the
one-device step of the same weights on the CPU, and the dry run's CLI on
one card.  A 1 x 1 mesh is all one
card holds (NCCL takes one rank per card); its DTensor placements and
collectives are the tp and dp path's own, and the MSDA kernels and the
matching kernel must run under them.

Marked ``gpu``; this file imports neither JAX nor the JAX package, so run
it on the card's machine from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_parallel_gpu.py
"""

import copy
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from test_torch_port_cuda import (  # noqa: F401 - cuda_device is a fixture
    EXACT_ZERO_TOL,
    cuda_device,
    exact_zero_leaves,
    state_gaps,
    tiny_train_batch,
    tiny_train_model,
)


@pytest.fixture
def nccl_rank(cuda_device, tmp_path):
    """This process as the one rank of an NCCL group."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_sharded_train_step_matches_cpu(nccl_rank):
    """One sharded step of the tiny model on the card against the CPU's
    one-device eager step of the same weights: K1 and K2 once per MSDA
    layer (2 encoder + 2 decoder) and the matching twice; the loss within
    1e-4 relative; each gradient leaf within max(1e-4, 3 x its spread) of
    its scale, the spread being how far the card's one-device gradient of
    the leaf moves under 1e-7 moves of every weight (the median of 3, as
    ``test_cuda_captured_train_step_matches_cpu`` measures it); the leaves
    whose gradient is zero in exact arithmetic within ``EXACT_ZERO_TOL`` of
    their module weight's largest gradient."""
    from codetr_torch.ops import hungarian
    from codetr_torch.ops import msda
    from codetr_torch.parallel.mesh import make_mesh, mesh_shape, whole
    from codetr_torch.parallel.train import adamw, init_sharded_state, jit_train_step, make_train_step

    device = nccl_rank
    cpu = tiny_train_model("cpu")
    start = copy.deepcopy(cpu)
    gpu = copy.deepcopy(cpu).to(device)
    mesh = make_mesh(dp=1, tp=1, device="cuda")
    assert mesh_shape(mesh) == {"dp": 1, "tp": 1}
    step = jit_train_step(gpu, init_sharded_state(gpu, mesh), mesh)
    batch = tiny_train_batch(device)
    before = (msda.launches, msda.launches_bwd, hungarian.launches)
    loss_g = step(*batch).item()
    torch.cuda.synchronize()
    launched = (msda.launches - before[0], msda.launches_bwd - before[1], hungarian.launches - before[2])
    assert launched == (4, 4, 2), launched
    grads_g = {n: whole(p.grad).cpu() for n, p in gpu.named_parameters()}

    loss_c = make_train_step(cpu, adamw(cpu))(*(t.cpu() for t in batch)).item()
    grads_c = {n: p.grad for n, p in cpu.named_parameters()}
    moved = {n: [] for n in grads_g}
    for i in range(3):
        m = copy.deepcopy(start).to(device)
        gen = torch.Generator().manual_seed(5 + i)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen).to(device))
        make_train_step(m, adamw(m))(*batch)
        for n, g in state_gaps({n: p.grad.cpu() for n, p in m.named_parameters()}, grads_g).items():
            moved[n].append(g)
    spread = {n: statistics.median(v) for n, v in moved.items()}
    zero = exact_zero_leaves(cpu)
    gaps = state_gaps(grads_g, grads_c)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c), (loss_g, loss_c)
    over = {n: (g, spread[n]) for n, g in gaps.items() if n not in zero and g > max(1e-4, 3 * spread[n])}
    assert not over, over
    noisy = {n: w for n, w in zero.items()
             if max((grads[n].abs().max() / grads[w].abs().max()).item() for grads in (grads_g, grads_c))
             > EXACT_ZERO_TOL}
    assert not noisy, noisy


@pytest.mark.gpu
def test_cuda_dryrun_cli_on_one_card(cuda_device):
    """``python -m codetr_torch.parallel.dryrun --nproc 1`` (NCCL, the
    default): the JAX dry run's ok lines on a 1 x 1 mesh, where
    ``assert_tp_sharded`` skips; one rank more than the cards visible
    raises before any process starts."""
    from codetr_torch.parallel import dryrun

    run = subprocess.run([sys.executable, "-m", "codetr_torch.parallel.dryrun", "--nproc", "1"],
                         capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent.parent)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert lines[0].startswith("train dryrun ok: mesh={'dp': 1, 'tp': 1} loss=")
    assert lines[0].endswith("tp={'tp': 1, 'skipped': True}")
    assert lines[1:] == ["inference dryrun ok: mesh={'dp': 1, 'tp': 1} impl=auto tp={'tp': 1, 'skipped': True}",
                         "dryrun_multichip ok: 1 devices"]
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} NCCL ranks need {n} CUDA devices"):
        dryrun.main(["--nproc", str(n)])
