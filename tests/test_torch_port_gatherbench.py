"""The port's gather microbenchmarks (kernel K5's counterpart,
``codetr_torch/tools/gatherbench.py``) against the JAX package's Pallas
ops (``tools/gatherbench.py``) in interpret mode, on the CPU.

``tools/gatherbench.py`` is a script, not a package module, so it is loaded
by path, and its ``pl.pallas_call`` is patched to ``interpret=True`` (as
``tests/test_msda_grid.py`` runs K4).  Each op's plain version gives the
same (8, 128) checksum of R = 64 perturbed iterations: the gathers and
idxadd bit for bit; fma1 and splat2 within 1e-6 of the checksum's scale,
since the JAX side's products and sums may round in another order.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codetr_torch.tools import gatherbench as gb

JAX_SCRIPT = Path(__file__).resolve().parent.parent / "tools" / "gatherbench.py"


@pytest.fixture(scope="module")
def jax_gatherbench():
    spec = importlib.util.spec_from_file_location("jax_gatherbench", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec)
    return mod


def as_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("op,size,dtype", [
    ("gather_sub", (256, 256), torch.float32),
    ("gather_sub", (256, 256), torch.bfloat16),
    ("gather_lane", (256, 256), torch.float32),
    ("idxadd", (256, 256), torch.int32),
    ("splat2", (8, 128, 256), torch.float32),
    ("fma1", (256, 256), torch.float32),
], ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_checksum_matches_jax_op(jax_gatherbench, op, size, dtype):
    inputs = gb.make_inputs(op, size, dtype, device="cpu")
    got = gb.KERNEL[op](*inputs)  # a CPU tensor: the plain version
    assert got.shape == (8, 128) and got.dtype == torch.float32
    j = jax_gatherbench
    if op in ("gather_sub", "gather_lane"):
        x = as_jax(inputs[0])
        want = getattr(j, op)(x, as_jax(inputs[1]), *size, x.dtype)[0]
    elif op == "idxadd":
        want = j.idxadd(as_jax(inputs[0]), *size)[0]
    elif op == "splat2":
        want = j.splat2(*(as_jax(t) for t in inputs), *size, jnp.float32)[0]
    else:
        want = j.fma1(*(as_jax(t) for t in inputs), *size, jnp.float32)[0]
    want = np.asarray(want)
    if op in ("splat2", "fma1"):
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_cases_and_bounds():
    """The sweep covers the JAX script's keys, in its order, and each case's
    bound is positive and names what bounds it."""
    keys = [k for k, *_ in gb.cases()]
    want = []
    for n in (256, 704, 1040):
        want += [f"gather_sub_{n}x256_float32", f"gather_lane_{n}x256_float32",
                 f"gather_sub_{n}x256_bfloat16", f"idxadd_{n}x256"]
    want += [f"splat2_{g}_float32" for g in ("26x40x256", "22x32x256", "8x128x256")]
    assert keys == want + ["fma1_1040x256_f32"]
    for _, op, size, dtype in gb.cases():
        ms, by = gb.bound_ms(op, size, dtype)
        assert ms > 0 and by in ("bytes", "operations")
    # the gathers read one element of shared memory per plane element and
    # iteration: 1040 x 256 x 64 x 4 bytes at 128 B a clock on 132 SMs
    ms, by = gb.bound_ms("gather_sub", (1040, 256), torch.float32)
    assert by == "bytes" and ms == pytest.approx(1040 * 256 * 64 * 4 / gb.PEAK_SMEM_BYTES_PER_S * 1e3)


def test_cuda_route_launches_the_kernel_or_raises(monkeypatch):
    """A tensor on the card goes to the kernel's launcher and counts one
    launch; the wrappers reject what the kernels do not take."""
    calls = []

    def fake_launch(fn, tensors, ints, plane_hw):
        calls.append((fn, ints, plane_hw))
        gb.launches += 1
        return torch.zeros(8, 128)

    monkeypatch.setattr(gb, "_route", lambda t: "cuda")
    monkeypatch.setattr(gb, "_launch", fake_launch)
    monkeypatch.setattr(gb, "launches", 0)
    for op, size, dtype in (("gather_sub", (256, 256), torch.bfloat16), ("idxadd", (704, 256), torch.int32),
                            ("splat2", (22, 32, 256), torch.float32)):
        gb.KERNEL[op](*gb.make_inputs(op, size, dtype, device="cpu"))
    assert gb.launches == 3
    assert calls == [("gb_gather_sub", (1, 256, 256, gb.R), (256, 256)),
                     ("gb_idxadd", (704, 256, gb.R), (704, 256)),
                     ("gb_splat2", (22, 32, 256, gb.R), (704, 256))]
    x, idx = gb.make_inputs("gather_lane", (256, 256), device="cpu")
    with pytest.raises(TypeError):
        gb.gather_lane(x.to(torch.bfloat16), idx)
    with pytest.raises(ValueError):
        gb.gather_sub(x, idx.long())
    with pytest.raises(ValueError):
        gb.fma1(x, x, x[:8])
