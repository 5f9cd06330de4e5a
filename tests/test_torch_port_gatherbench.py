"""The port's gather microbenchmarks (kernel K5's counterpart,
``codetr_torch/tools/gatherbench.py``) against the JAX package's Pallas
ops (``tools/gatherbench.py``) in interpret mode, on the CPU.

``tools/gatherbench.py`` is a script, not a package module, so it is loaded
by path, and its ``pl.pallas_call`` is patched to ``interpret=True`` (as
``tests/test_msda_grid.py`` runs K4).  Each op's plain version gives the
same (8, 128) checksum of R = 64 perturbed iterations: the gathers and
idxadd bit for bit; fma1 and splat2 within 1e-6 of the checksum's scale,
since the JAX side's products and sums may round in another order.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``);
here the host-side pieces around them are held: the launch plans' coverage
and shared-memory budget, the wavefront model against a brute-force count,
the identity idxadd's kernel rests on, the SASS report's parser, and the
wrappers' routes.
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
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

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
    sub = gb.gather_sub_plan(256, 256, torch.bfloat16)
    assert calls == [("gb_gather_sub", (1, 256, 256, gb.R, sub.groups, sub.rows, sub.cluster, sub.warps),
                      (256, 256)),
                     ("gb_idxadd", (704, 256, 704, gb.R), (704, 256)),
                     ("gb_splat2", (22, 32, 256, gb.R), (704, 256))]
    x, idx = gb.make_inputs("gather_lane", (256, 256), device="cpu")
    with pytest.raises(TypeError):
        gb.gather_lane(x.to(torch.bfloat16), idx)
    with pytest.raises(ValueError):
        gb.gather_sub(x, idx.long())
    with pytest.raises(ValueError):
        gb.fma1(x, x, x[:8])


@pytest.fixture
def fake_card(monkeypatch):
    """Route every tensor to the kernels and record the launches instead."""
    calls = []

    def fake_launch(fn, tensors, ints, plane_hw):
        calls.append((fn, ints, plane_hw))
        gb.launches += 1
        return torch.zeros(8, 128)

    monkeypatch.setattr(gb, "_route", lambda t: "cuda")
    monkeypatch.setattr(gb, "_launch", fake_launch)
    monkeypatch.setattr(gb, "launches", 0)
    return calls


def test_null_kernel_route_and_launch_count(fake_card):
    """The launch floor goes through ``_launch`` as the ops do, at the
    case's launch geometry, and counts one launch."""
    x, idx = gb.make_inputs("gather_sub", (1040, 256), torch.float32, device="cpu")
    geom = gb.launch_geometry("gather_sub", (1040, 256), torch.float32)
    gb.null(x, *geom)
    assert gb.launches == 1
    assert fake_card == [("gb_null", geom, (8, 128))]
    plan = gb.gather_sub_plan(1040, 256, torch.float32)
    assert geom == (plan.groups * plan.stripes, 32 * plan.warps, plan.smem)
    assert gb.launch_geometry("idxadd", (1040, 256), torch.int32) == (1040, gb.THREADS, 0)


def test_null_kernel_on_cpu_is_zeros():
    x, _ = gb.make_inputs("gather_lane", (8, 128), device="cpu")
    assert torch.equal(gb.null(x, 4, 32), torch.zeros(8, 128))


@pytest.mark.parametrize("n", [256, 704, 1040])
def test_idxadd_int_sum_is_the_fp32_sum(n):
    """idxadd's kernel sums the indices in int32 and converts once: for
    every start index of a sweep size, the fp32 in-order sum of (j + i) % n
    over R iterations equals that conversion (every partial sum is an
    integer below 2**24)."""
    j0 = np.arange(n)
    terms = (j0[:, None] + np.arange(gb.R)[None, :]) % n
    acc = np.zeros(n, np.float32)
    for i in range(gb.R):
        acc = (acc + terms[:, i].astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(acc, terms.sum(axis=1).astype(np.int32).astype(np.float32))
    assert (n - 1) * gb.R < 2**24


def test_idxadd_kernel_raises_past_the_exact_range(fake_card):
    idx, _ = gb.make_inputs("idxadd", (9, 129), torch.int32, device="cpu")
    n_max = 2**24 // gb.R  # (n - 1) * R < 2**24
    gb.idxadd(idx, n_max)
    with pytest.raises(ValueError):
        gb.idxadd(idx, n_max + 1)
    assert [c[0] for c in fake_card] == ["gb_idxadd"]
    assert gb.launches == 1


def all_cases():
    return [(op, size, dt) for _, op, size, dt in gb.cases()] + list(gb.TAIL_CASES)


@pytest.mark.parametrize("op,size,dtype", all_cases(),
                         ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_launch_plan_covers_each_element_once(op, size, dtype):
    """Replaying each kernel's thread-to-element mapping: every element of
    the plane is computed by exactly one thread (so each checksum element is
    written once), and the launch fits a block's shared memory and
    threads."""
    thread, row, col = gb.assignments(op, size, dtype)
    h, w = (size[0] * size[1], size[2]) if op == "splat2" else size
    assert row.min() >= 0 and col.min() >= 0 and row.max() < h and col.max() < w
    counts = np.bincount(row * w + col, minlength=h * w)
    assert counts.min() == 1 and counts.max() == 1
    assert ((row < 8) & (col < 128)).sum() == 8 * 128  # one writer for each checksum element
    blocks, threads, smem = gb.launch_geometry(op, size, dtype)
    assert threads <= 1024 and thread.max() < blocks * threads
    static = gb.SUB_STATIC if op == "gather_sub" else 0
    assert smem + static <= gb.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_sub_plan_limits(dtype):
    """The largest n whose stripe (n + R - 1 rows of 128 bytes) and barrier
    fit 227 KB is planned; one more raises.  Clusters divide the row groups,
    and the sweep's sizes give at most one block for each of the 132 SMs."""
    p = gb.gather_sub_plan(gb.SUB_MAX_N, 256, dtype)
    assert p.smem + gb.SUB_STATIC <= gb.SMEM_LIMIT
    assert (gb.SUB_MAX_N + gb.R) * gb.ROW_BYTES + gb.SUB_STATIC > gb.SMEM_LIMIT
    with pytest.raises(ValueError):
        gb.gather_sub_plan(gb.SUB_MAX_N + 1, 256, dtype)
    for n in (256, 704, 1040):
        p = gb.gather_sub_plan(n, 256, dtype)
        assert p.groups % p.cluster == 0 and p.groups * p.stripes <= gb.NUM_SMS


def brute_wavefronts(op, idx, dtype):
    """Every warp-wide read of every iteration, lane by lane, from the
    plans: the most distinct 4-byte words any bank serves, summed."""
    n, m = idx.shape
    total = 0

    def count(words):
        banks = {}
        for wd in words:
            banks.setdefault(wd % 32, set()).add(wd)
        return max((len(v) for v in banks.values()), default=0)

    if op == "gather_sub":
        p = gb.gather_sub_plan(n, m, dtype)
        per, elt = p.cols // 32, gb.ROW_BYTES // p.cols
        for s in range(p.stripes):
            for r in range(n):
                for q in range(per):
                    cols = [s * p.cols + lane * per + q for lane in range(32)]
                    js = [int(idx[r, c]) % n if c < m else 0 for c in cols]
                    for i in range(gb.R):
                        total += count([((j + i) * gb.ROW_BYTES + (lane * per + q) * elt) // 4
                                        for lane, j in enumerate(js)])
    else:
        for r in range(n):  # block r holds row r alone, a warp reads 32 of its columns
            for c0 in range(0, m, 32):
                js = [int(idx[r, c]) % m for c in range(c0, min(m, c0 + 32))]
                for i in range(gb.R):
                    total += count([j + i for j in js])
    return total


@pytest.mark.parametrize("op,size,dtype", [
    ("gather_sub", (8, 128), torch.float32),
    ("gather_sub", (40, 130), torch.bfloat16),
    ("gather_lane", (12, 256), torch.float32),
    ("gather_lane", (9, 130), torch.float32),
], ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_smem_wavefronts_match_brute_force(op, size, dtype):
    rng = np.random.default_rng(7)
    n, m = size
    idx = rng.integers(-3 * n, 3 * n, size).astype(np.int32)  # negative too: floor mod
    wf = gb.smem_wavefronts(op, idx, dtype)
    assert wf.wavefronts == brute_wavefronts(op, idx, dtype)
    assert wf.ms == pytest.approx(wf.wavefronts / (gb.NUM_SMS * gb.CLOCK_HZ) * 1e3)


def test_smem_wavefronts_at_the_sweep_width():
    """Column per lane: one wavefront a read for gather_sub in fp32 and in
    bf16 whatever the indices (all alike, all in one bank's column, random);
    gather_lane's 32 random columns of a row put about 3.2 distinct words in
    the fullest bank (3.5 balls in 32 bins, less the lanes that share a
    word: 8 words a bank in a 256-word row)."""
    rng = np.random.default_rng(3)
    n = m = 256
    for idx in (np.zeros((n, m), np.int32), np.full((n, m), 32, np.int32),
                rng.integers(0, n, (n, m)).astype(np.int32)):
        for dt in (torch.float32, torch.bfloat16):
            wf = gb.smem_wavefronts("gather_sub", idx, dt)
            assert wf.wavefronts == wf.reads == n * m * gb.R // 32
    wf = gb.smem_wavefronts("gather_lane", rng.integers(0, m, (n, m)).astype(np.int32))
    assert wf.reads == n * m * gb.R // 32
    assert 3.0 < wf.wavefronts / wf.reads < 3.5


@pytest.mark.parametrize("ways", gb.CONFLICT_WAYS)
def test_conflict_indices_give_their_wavefronts(ways):
    """The calibration's indices make every gather_lane read exactly
    ``ways`` wavefronts, as the brute-force count says too."""
    idx = gb.conflict_indices(ways, device="cpu")
    wf = gb.smem_wavefronts("gather_lane", idx)
    assert wf.wavefronts == ways * wf.reads
    small = idx[:3].numpy()
    assert gb.smem_wavefronts("gather_lane", small).wavefronts == brute_wavefronts("gather_lane", small, torch.float32)


def test_parse_sass_counts_i2f_inside_loops():
    text = """
\t\tFunction : _Z13idxadd_kernelPKiPfS1_iif
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   I2F R2, R3 ;
.L_x_0:
        /*0020*/                   I2FP.F32.S32 R4, UR4 ;
        /*0028*/              @!P1 I2F.RP R6, R4 ;
        /*0030*/              @P0 BRA `(.L_x_0) ;
        /*0040*/                   I2F R5, R4 ;
        /*0050*/                   EXIT ;
.L_x_1:
        /*0060*/                   BRA `(.L_x_1);
\t\tFunction : _Z17gather_sub_kernelI13__nv_bfloat16EvPKT_PKiPfS6_iiiif
        /*0000*/                   IADD3 R2, R3, 0x1, RZ ;
        /*0010*/              @!P0 BRA 0x0 ;
        /*0020*/                   I2F.U32 R2, R3 ;
"""
    assert gb.parse_sass(text) == {
        "idxadd_kernel": {"i2f": 4, "in_loops": 2, "loops": 1},
        "gather_sub_kernel<bf16>": {"i2f": 1, "in_loops": 0, "loops": 1},
    }
