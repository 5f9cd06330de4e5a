"""The captured train step (``parallel/train.py:capture_train_step``) on the
CPU, at the tiny config: what can be checked without a card.

- The step body, the function that the capture records, dispatches no op
  that reads a tensor's value on the host or makes a tensor from host data
  on each call (a CUDA-graph capture refuses both), for one step after a
  warm-up step (the capture's own order), in fp32 and in bf16 compute, with
  ``SwinConfig.with_cp`` on.  Three calls are exempt by name, each the CPU
  stand-in for what the card runs: the matching's ``linear_assignment`` and
  the MSDA backward's ``msda_backward_plain``, plain versions that read the
  host or make host constants by design where the card makes one kernel
  launch each, and ``optimizer.step``, since AdamW's capturable path runs
  only on the card and its CPU path reads its step count on the host.  (The
  MSDA forward's plain version runs inside its custom op, below the mode.)  A ``torch.tensor([...])`` planted back
  into the MSDA module on each call is caught.
- The warm-up does not train: after two steps and ``restore()``, every
  parameter, buffer and optimizer state tensor keeps its storage, and the
  next 3 steps equal a fresh twin's 3 eager steps bit for bit (deterministic
  algorithms on: the CPU's scatter-adds otherwise differ from run to run).
  ``test_torch_port_train.py:test_restored_steps_match_jax`` holds such
  steps against the JAX ``jax.jit`` step with ``optax.adamw``.
- No fallback: ``capture_train_step`` raises ``ValueError`` on the CPU and
  for an optimizer that is not capturable.

The card's side (3 replays against an eager twin, against the CPU, under
``set_sync_debug_mode("error")``, the kernels a replay launches) is in
``test_torch_port_cuda.py``.
"""

import copy
from dataclasses import replace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from codetr_torch import build_codetr
from codetr_torch.config import tiny_test_config
from codetr_torch.models import msda_module
from codetr_torch.ops import msda
from codetr_torch.parallel import losses
from codetr_torch.parallel.train import adamw, capture_train_step, make_train_step, snapshot_train_state

from test_torch_port_cuda import tiny_train_batch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

STEPS = 3


class HostOps(TorchDispatchMode):
    """Records, by name, the ops that read a tensor back to the host or make
    one from host data, and indexing with a boolean mask (its result's size
    is read from the device); ops inside an exempt call are counted apart."""

    FORBIDDEN = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero",
                 "aten.masked_select", "aten.unique", "aten._unique", "aten._unique2",
                 "aten.unique_consecutive", "aten.unique_dim", "aten.repeat_interleave", "aten.bincount",
                 "aten.lift_fresh", "aten.lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.ops, self.found, self.exempt, self.exempt_ops = 0, [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if self.exempt:
            self.exempt_ops += 1
        else:
            self.ops += 1
            if name in self.FORBIDDEN:
                self.found.append(name)
            if name.startswith("aten.index") and any(
                    torch.is_tensor(t) and t.dtype in (torch.bool, torch.uint8)
                    for a in args if isinstance(a, (list, tuple)) for t in a):
                self.found.append(f"{name} with a boolean mask")
        return func(*args, **(kwargs or {}))

    def exempting(self, fn):
        def call(*args, **kwargs):
            self.exempt += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.exempt -= 1
        return call


def tiny_cp_model(seed=3):
    cfg = tiny_test_config()
    return build_codetr(replace(cfg, swin=replace(cfg.swin, with_cp=True)), device="cpu", seed=seed)


def host_ops_of_step(compute_dtype, monkeypatch):
    """The step body's ops after one warm-up step: (HostOps, losses)."""
    model = tiny_cp_model()
    opt = adamw(model)
    batch = tiny_train_batch("cpu")
    step = make_train_step(model, opt, compute_dtype=compute_dtype)
    first = step(*batch)
    mode = HostOps()
    monkeypatch.setattr(losses, "linear_assignment", mode.exempting(losses.linear_assignment))
    monkeypatch.setattr(msda, "msda_backward_plain", mode.exempting(msda.msda_backward_plain))
    monkeypatch.setattr(opt, "step", mode.exempting(opt.step))
    with mode:
        second = step(*batch)
    return mode, (first, second)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_step_body_reads_nothing_on_the_host(compute_dtype, monkeypatch):
    mode, (first, second) = host_ops_of_step(compute_dtype, monkeypatch)
    assert mode.ops > 2000 and mode.exempt_ops > 0  # forward, recompute and backward seen
    assert not mode.found, sorted(set(mode.found))
    assert torch.isfinite(first) and torch.isfinite(second) and second != first  # the step trained


def test_a_planted_host_constant_is_caught(monkeypatch):
    """The MSDA module's level tables made anew on each call, as before they
    were cached: a host-to-device copy on the card, ``lift_fresh`` here."""
    monkeypatch.setattr(msda_module, "level_table",
                        lambda shapes, kind, device: msda_module._level_table(
                            tuple(map(tuple, shapes)), kind, device))
    mode, _ = host_ops_of_step(torch.float32, monkeypatch)
    assert "aten.lift_fresh" in mode.found


def test_level_tables_cached_under_inference_mode_still_train():
    """A level table first made while serving (under ``inference_mode``) is
    cached for the train step, which saves it for the backward pass."""
    model = build_codetr(tiny_test_config(), device="cpu", seed=3)
    batch = tiny_train_batch("cpu")
    msda_module._level_table_cached.cache_clear()
    with torch.inference_mode():
        model.train_outputs(*batch[:2])
    assert torch.isfinite(make_train_step(model, adamw(model))(*batch))


def state_tensors(model, opt):
    """Every parameter, buffer and optimizer state tensor, in one order."""
    out = [(n, t) for n, t in model.named_parameters()] + [(n, t) for n, t in model.named_buffers()]
    names = {p: n for n, p in model.named_parameters()}
    for p, s in opt.state.items():
        out += [(f"{names[p]}.{k}", v) for k, v in sorted(s.items()) if torch.is_tensor(v)]
    return out


def eager_steps(model, opt, batch, n):
    step = make_train_step(model, opt)
    return [step(*batch) for _ in range(n)]


def restored_steps(model, opt, batch, warmup=2, steps=STEPS):
    """``warmup`` steps undone by ``snapshot_train_state``'s restore, then
    ``steps`` steps: (losses, the state's storage before and after)."""
    restore = snapshot_train_state(model, opt)
    eager_steps(model, opt, batch, warmup)
    before = [(n, t.data_ptr()) for n, t in state_tensors(model, opt)]
    restore()
    after = [(n, t.data_ptr()) for n, t in state_tensors(model, opt)]
    return eager_steps(model, opt, batch, steps), before, after


def test_warm_up_is_undone_in_place():
    batch = tiny_train_batch("cpu")
    model = build_codetr(tiny_test_config(), device="cpu", seed=3)
    twin = copy.deepcopy(model)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        opt, twin_opt = adamw(model), adamw(twin)
        got, before, after = restored_steps(model, opt, batch)
        want = eager_steps(twin, twin_opt, batch, STEPS)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert before == after and len(after) > 3 * len(list(model.parameters()))
    assert [x.item() for x in got] == [x.item() for x in want]
    assert len(set(x.item() for x in got)) == STEPS  # each step moved the model
    twin_state = dict(state_tensors(twin, twin_opt))
    for n, t in state_tensors(model, opt):
        assert torch.equal(t, twin_state[n]), n
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_capture_raises_on_the_cpu_and_for_a_non_capturable_optimizer():
    model = build_codetr(tiny_test_config(), device="cpu", seed=3)
    batch = tiny_train_batch("cpu")
    with pytest.raises(ValueError, match="needs the model on the card"):
        capture_train_step(model, adamw(model, capturable=True), batch)
    for opt in (adamw(model), torch.optim.SGD(model.parameters(), lr=1e-4)):
        with pytest.raises(ValueError, match="capturable=True"):
            capture_train_step(model, opt, batch)


def test_capturable_adamw_keeps_optax_hyperparameters():
    model = build_codetr(tiny_test_config(), device="cpu", seed=3)
    plain, cap = adamw(model, 3e-4).defaults, adamw(model, 3e-4, capturable=True).defaults
    assert cap["capturable"] and not plain["capturable"]
    assert {k: v for k, v in cap.items() if k != "capturable"} == {k: v for k, v in plain.items() if k != "capturable"}
    assert (cap["lr"], cap["betas"], cap["eps"], cap["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)
